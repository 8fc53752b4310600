// Plan-driven block-sparse MV:
//   y[r] = sum_{j < cnt[r]} S[blk[r*maxb + j]] @ x[col[r*maxb + j]]
//
// Replaces: src/repro/kernels/coupling_mv.py, coupling_mv / _fused_kernel
// (the gather-fused scalar-prefetch Pallas kernel of the coupling phase and
// the dense-leaf phase of the HGEMV).
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s fp32): memory.  Every S block is
// read once and used against an nv-wide slice of x: 2*nv flops per 4-byte S
// element (8 flops/byte at nv = 16, against the ~20 at which fp32 FFMA would
// bind).  At N = 2^20 the 12 coupling levels hold 401,344 blocks of 36x36
// (2.08 GB of S: 0.62 ms; x and y add ~0.05 ms) and the dense leaves 81,408
// blocks of 64x64 (1.33 GB: 0.40 ms, 0.44 with x and y).
//
// Two kernels, picked by ``cmv_plan`` in kernels/coupling_mv.py:
//
// * ``cmv_ring_kernel<FmaTile<..>>`` (routes "warp16" for nv % 16 == 0 and
//   "warp1" for nv == 1, k1, k2 <= 64): pipelined and free of block
//   barriers.  A warp, or a SUB-lane part of one, owns one item = (block
//   row r, tile of RT rows of y[r], tile of NVT columns); its lanes split
//   into G column groups of CW columns and L = SUB/G row lanes, and lane
//   (l, g) accumulates rows l, l+L, .., l+(RPL-1)*L of the tile in
//   registers: RPL*CW accumulators (20 at k = 36, nv = 16).  Each item owns
//   a two-stage ring in shared memory: while slot j's FMAs run, slot j+1's
//   S rows and x block are in flight as coalesced cp.async copies (16-byte
//   where k2 % 4 == 0 and the pointers are aligned, 4-byte otherwise), so
//   the up to 17 slots of a row overlap and ~15 warps keep ~100 KB in
//   flight per SM; __syncwarp is the only synchronisation.  Rows are read
//   from the stage with 16-byte shared loads (row stride padded to an odd
//   number of 16-byte units: no bank conflicts); x is a broadcast read.
//   The configuration (bucket of k1: 4, 8, 16, 40, 64 at nv = 16; 8, 16,
//   32 at nv = 1) fixes SUB, G, RPL, CW at compile time; the k2 loop
//   runs over the real k2 in steps of 4 plus a tail, so no padding is
//   multiplied.  At k1 = 64 two warps share a row (row tiles of 32, also
//   at nv = 1 for k1 > 32); a small level takes smaller tiles (down to 8
//   rows), so more warps share its rows.  Tried and dropped (PERF.md §6,
//   on an H100 80GB HBM3 at N = 2^20): streaming S from global memory
//   straight into registers kept too few bytes in flight (l = 14 in 1.83
//   ms against the general kernel's 1.32); tensor-core m16n8k8 products in
//   3xTF32 on the same ring were slower than the FMAs (l = 14 0.633
//   against 0.524 ms, dense leaves 0.752 against 0.564).
// * ``coupling_mv_kernel`` (route "general", the first version): one block
//   of 64 threads per (block row, 16-wide nv tile) staging 64x64 chunks of
//   S and x through shared memory between two barriers; every shape the
//   planner does not fit (k > 64, nv neither 1 nor a multiple of 16).
//
// Both: y[r] is written once by its own owner (one writer per row, no
// atomics; rows with cnt = 0 write zeros).  Padding slots lie at
// j >= cnt[r] and are never visited; a slot holding the sentinel blk == nb
// is skipped as well, so it is never dereferenced.  fp32 accumulation.
#include "common.cuh"

namespace {

constexpr int NT = 64, TR = 4, TC = 4, RC = 16 * TR, BNV = 4 * TC, KC = 64;

__global__ void __launch_bounds__(NT)
coupling_mv_kernel(const float* __restrict__ S, const float* __restrict__ X,
                   const int* __restrict__ blk, const int* __restrict__ col,
                   const int* __restrict__ cnt, float* __restrict__ Y,
                   int nb, int k1, int k2, int nv, int maxb, bool vec) {
  __shared__ float Ss[RC][KC + 1];
  __shared__ __align__(16) float Xs[KC][BNV];
  const long long r = blockIdx.x;
  const int v0 = blockIdx.y * BNV;
  const int t = threadIdx.x, tc = t % 4, tr = t / 4;
  const int c = cnt[r];
  const int* rblk = blk + r * maxb;
  const int* rcol = col + r * maxb;

  for (int r0 = 0; r0 < k1; r0 += RC) {
    const int rows_here = min(RC, k1 - r0);
    float acc[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int jc = 0; jc < TC; ++jc) acc[i][jc] = 0.f;
    for (int j = 0; j < c; ++j) {
      const long long b = rblk[j];
      if (b >= nb) continue;  // sentinel: never dereferenced
      const float* Sb = S + b * k1 * k2;
      const float* Xb = X + static_cast<long long>(rcol[j]) * k2 * nv;
      for (int kc0 = 0; kc0 < k2; kc0 += KC) {
        const int kc = min(KC, k2 - kc0);
        if (vec) {  // 16-byte aligned rows; kc is a multiple of 4 too
          for (int e = t; e < rows_here * (KC / 4); e += NT) {
            const int rr = e / (KC / 4), cc = (e % (KC / 4)) * 4;
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (cc < kc)
              v = *reinterpret_cast<const float4*>(
                  Sb + static_cast<long long>(r0 + rr) * k2 + kc0 + cc);
            Ss[rr][cc] = v.x;
            Ss[rr][cc + 1] = v.y;
            Ss[rr][cc + 2] = v.z;
            Ss[rr][cc + 3] = v.w;
          }
        } else {
          for (int e = t; e < rows_here * KC; e += NT) {
            const int rr = e / KC, cc = e % KC;
            Ss[rr][cc] = cc < kc ? Sb[static_cast<long long>(r0 + rr) * k2 +
                                      kc0 + cc]
                                 : 0.f;
          }
        }
        for (int e = t; e < KC * BNV; e += NT) {
          const int kk = e / BNV, vv = e % BNV;
          Xs[kk][vv] = (kk < kc && v0 + vv < nv)
                           ? Xb[static_cast<long long>(kc0 + kk) * nv + v0 + vv]
                           : 0.f;
        }
        __syncthreads();
        if (tr * TR < rows_here) {
#pragma unroll 4
          for (int kk = 0; kk < kc; ++kk) {
            const float4 xv = *reinterpret_cast<const float4*>(&Xs[kk][tc * TC]);
#pragma unroll
            for (int i = 0; i < TR; ++i) {
              const float sv = Ss[tr * TR + i][kk];
              acc[i][0] = fmaf(sv, xv.x, acc[i][0]);
              acc[i][1] = fmaf(sv, xv.y, acc[i][1]);
              acc[i][2] = fmaf(sv, xv.z, acc[i][2]);
              acc[i][3] = fmaf(sv, xv.w, acc[i][3]);
            }
          }
        }
        __syncthreads();
      }
    }
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int row = tr * TR + i;
      if (row >= rows_here) continue;
#pragma unroll
      for (int jc = 0; jc < TC; ++jc) {
        const int v = v0 + tc * TC + jc;
        if (v < nv) Y[(r * k1 + r0 + row) * nv + v] = acc[i][jc];
      }
    }
  }
}

// ---- pipelined routes ----------------------------------------------------

constexpr int MAX_WARPS = 4;  // warps a block, at most

// Row stride of S in a ring stage: k2 rounded up to 4 floats (16-byte row
// starts) with an odd number of 16-byte units, so that the 8 rows one
// 16-byte shared load touches fall on distinct banks.
__host__ __device__ inline int cmv_row_stride(int k2) {
  int sp = (k2 + 3) & ~3;
  if ((sp / 4) % 2 == 0) sp += 4;
  return sp;
}

// FMA tile: SUB lanes own an item; lane sl = l*G + g accumulates rows
// l + i*L (i < RPL) of the row tile and columns g*CW + c (c < CW) of the
// column tile in registers.
template <int SUB_, int G, int RPL, int CW>
struct FmaTile {
  static constexpr int SUB = SUB_, L = SUB / G, RT = L * RPL, NVT = G * CW;
  static_assert(SUB * (32 / SUB) == 32 && L * G == SUB, "lane split");
  static_assert(CW == 1 || CW == 4, "columns a lane");
  float acc[RPL][CW];
  int g, l;

  __device__ __forceinline__ void init(int sl) {
    g = sl % G;
    l = sl / G;
#pragma unroll
    for (int i = 0; i < RPL; ++i)
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;
  }

  // acc += S tile (trows x k2, row stride sp) @ x (k2 x NVT)
  __device__ __forceinline__ void multiply(const float* st, const float* xs,
                                           int trows, int k2, int sp) {
    const float* Ss = st + l * sp;
    xs += g * CW;
    int kk = 0;
#pragma unroll 2
    for (; kk + 4 <= k2; kk += 4) {
      float sv[RPL][4];
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (l + i * L < trows)
          v = *reinterpret_cast<const float4*>(Ss + i * L * sp + kk);
        sv[i][0] = v.x; sv[i][1] = v.y; sv[i][2] = v.z; sv[i][3] = v.w;
      }
      float xv[4][CW];
      if constexpr (CW == 4) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float4 v =
              *reinterpret_cast<const float4*>(xs + (kk + t) * NVT);
          xv[t][0] = v.x; xv[t][1] = v.y; xv[t][2] = v.z; xv[t][3] = v.w;
        }
      } else {
        const float4 v = *reinterpret_cast<const float4*>(xs + kk);
        xv[0][0] = v.x; xv[1][0] = v.y; xv[2][0] = v.z; xv[3][0] = v.w;
      }
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int i = 0; i < RPL; ++i)
#pragma unroll
          for (int c = 0; c < CW; ++c)
            acc[i][c] = fmaf(sv[i][t], xv[t][c], acc[i][c]);
    }
    for (; kk < k2; ++kk) {  // k2 % 4 columns left
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        if (l + i * L < trows) {
          const float s = Ss[i * L * sp + kk];
#pragma unroll
          for (int c = 0; c < CW; ++c)
            acc[i][c] = fmaf(s, xs[kk * NVT + c], acc[i][c]);
        }
      }
    }
  }

  // y rows of the tile: p = &y[r, r0, nt*NVT] (row stride nv)
  __device__ __forceinline__ void store(float* p, int trows, int nv) const {
    const bool y16 = CW == 4 && (reinterpret_cast<uintptr_t>(p) & 15) == 0 &&
                     nv % 4 == 0;
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      const int row = l + i * L;
      if (row >= trows) continue;
      float* q = p + static_cast<long long>(row) * nv + g * CW;
      if constexpr (CW == 4) {
        if (y16) {
          *reinterpret_cast<float4*>(q) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          continue;
        }
      }
#pragma unroll
      for (int c = 0; c < CW; ++c) q[c] = acc[i][c];
    }
  }
};

// One item = (block row r, row tile rt, column tile nt) per Tile::SUB
// lanes.  Each item has a two-stage ring of its own in shared memory, a
// stage holding the tile's rows of one S block (row stride sp) and the x
// rows of its columns (row stride NVT); slot j+1 is copied in while
// slot j is multiplied.  s16 / x16: 16-byte copies of S / x (aligned and
// k2 % 4 == 0, or whole 16-byte x rows), 4-byte copies otherwise.
template <class Tile>
__global__ void __launch_bounds__(MAX_WARPS * 32)
cmv_ring_kernel(const float* __restrict__ S, const float* __restrict__ X,
                const int* __restrict__ blk, const int* __restrict__ col,
                const int* __restrict__ cnt, float* __restrict__ Y,
                long long items, int nb, int k1, int k2, int nv, int maxb,
                int row_tiles, int nv_tiles, int sp, int stage, bool s16,
                bool x16) {
  constexpr int SUB = Tile::SUB, RT = Tile::RT, NVT = Tile::NVT;
  constexpr int PER_WARP = 32 / SUB;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, sub = lane / SUB, sl = lane % SUB;
  const unsigned mask =
      SUB == 32 ? 0xffffffffu : ((1u << SUB) - 1u) << (sub * SUB);
  const int slot_in_block = (threadIdx.x / 32) * PER_WARP + sub;
  const long long item =
      static_cast<long long>(blockIdx.x) * (blockDim.x / 32) * PER_WARP +
      slot_in_block;
  if (item >= items) return;  // the whole part leaves: its mask is its own
  const int nt = static_cast<int>(item % nv_tiles);
  const long long rest = item / nv_tiles;
  const int rt = static_cast<int>(rest % row_tiles);
  const long long r = rest / row_tiles;
  const int r0 = rt * RT, trows = min(RT, k1 - r0);
  const int xoff = trows * sp;
  const long long sblock = static_cast<long long>(k1) * k2;
  const long long xblock = static_cast<long long>(k2) * nv;
  float* ring = smem + static_cast<long long>(slot_in_block) * 2 * stage;
  const int n = cnt[r];
  const int* rblk = blk + r * maxb;
  const int* rcol = col + r * maxb;
  // exact for the indices here (< 2^12): (i + 0.5) / d is at least 1/(2d)
  // from an integer
  const float inv_q4 = 4.f / k2, inv_k2 = 1.f / k2;

  // copy slot j into stage st: coalesced, asynchronous, one group
  auto fill = [&](int j, float* st) {
    const int b = __ldg(rblk + j), xc = __ldg(rcol + j);
    const float* Sb = S + b * sblock + static_cast<long long>(r0) * k2;
    if (s16 && sp == k2) {  // the tile's rows are one contiguous run
      for (int f = sl; f < trows * k2 / 4; f += SUB)
        cp_async16(smem_u32(st + 4 * f), Sb + 4 * f);
    } else if (s16) {  // padded rows: row = f / q by a float reciprocal
      const int q = k2 / 4, n4 = trows * q;
      for (int f = sl; f < n4; f += SUB) {
        const int rr = static_cast<int>((f + 0.5f) * inv_q4);
        const int cc = (f - rr * q) * 4;
        cp_async16(smem_u32(st + rr * sp + cc), Sb + rr * k2 + cc);
      }
    } else {
      const int n = trows * k2;
      for (int e = sl; e < n; e += SUB) {
        const int rr = static_cast<int>((e + 0.5f) * inv_k2);
        cp_async4(smem_u32(st + rr * sp + e - rr * k2), Sb + e);
      }
    }
    float* xs = st + xoff;
    const float* Xb = X + xc * xblock + nt * NVT;
    if constexpr (NVT % 4 == 0) {  // rows of NVT columns, nv % NVT == 0
      constexpr int Q = NVT / 4;
      if (x16) {
        for (int f = sl; f < k2 * Q; f += SUB) {
          const int kk = f / Q, cc = (f - kk * Q) * 4;
          cp_async16(smem_u32(xs + 4 * f),
                     Xb + static_cast<long long>(kk) * nv + cc);
        }
      } else {
        for (int e = sl; e < k2 * NVT; e += SUB) {
          const int kk = e / NVT;
          cp_async4(smem_u32(xs + e),
                    Xb + static_cast<long long>(kk) * nv + e - kk * NVT);
        }
      }
    } else {  // nv == 1: x[col] is k2 contiguous floats
      if (x16) {
        for (int f = sl; f < k2 / 4; f += SUB)
          cp_async16(smem_u32(xs + 4 * f), Xb + 4 * f);
      } else {
        for (int e = sl; e < k2; e += SUB) cp_async4(smem_u32(xs + e), Xb + e);
      }
    }
    cp_async_commit();
  };

  // the next slot at or after j that holds a block (a sentinel is skipped,
  // never dereferenced; slots at j >= n are never read)
  auto next_block = [&](int j) {
    while (j < n && __ldg(rblk + j) >= nb) ++j;
    return j;
  };
  Tile tile;
  tile.init(sl);
  // cur: the slot multiplied next, from stage st; fj: the slot copied
  // next, into stage fs (one ahead of cur once the first two are started;
  // one call site, so the copy code is inlined once)
  int cur = next_block(0), st = 0, fj = cur, fs = 0;
  while (cur < n) {
    if (fj < n) {
      fill(fj, ring + fs * stage);
      fs ^= 1;
      const bool first = fj == cur;
      fj = next_block(fj + 1);
      if (first) continue;  // the first slot: start the second one too
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp(mask);  // slot cur's copies, from every lane, have landed
    tile.multiply(ring + st * stage, ring + st * stage + xoff, trows, k2, sp);
    __syncwarp(mask);  // every lane is done with this stage before refill
    st ^= 1;
    cur = next_block(cur + 1);
  }
  tile.store(Y + (r * k1 + r0) * nv + nt * NVT, trows, nv);
}

template <class Tile>
int launch_ring(const float* S, const float* X, const int* blk,
                const int* col, const int* cnt, float* Y, int rows, int nb,
                int k1, int k2, int nv, int maxb, bool vec,
                cudaStream_t stream) {
  constexpr int RT = Tile::RT, NVT = Tile::NVT, PER_WARP = 32 / Tile::SUB;
  static int sm_smem = 0, max_smem = 0;
  if (sm_smem == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sm_smem,
                           cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    cudaDeviceGetAttribute(&max_smem,
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  const int row_tiles = (k1 + RT - 1) / RT, nv_tiles = nv / NVT;
  const int sp = cmv_row_stride(k2);
  const int stage = (min(RT, k1) * sp + k2 * NVT + 3) & ~3;
  const long long warp_bytes = 4LL * PER_WARP * 2 * stage;
  // warps a block: the count that keeps the most warps resident by shared
  // memory (1 KB reserved a block), the larger on a tie
  int w = 0, best = -1;
  for (int c = 1; c <= MAX_WARPS; ++c) {
    const long long b = c * warp_bytes;
    if (b > max_smem) break;
    const int resident =
        c * min(static_cast<int>(sm_smem / (b + 1024)), 32);
    if (resident >= best) best = resident, w = c;
  }
  const long long items =
      static_cast<long long>(rows) * row_tiles * nv_tiles;
  const long long per_block = static_cast<long long>(w) * PER_WARP;
  if (w == 0 || nv % NVT != 0 || (items + per_block - 1) / per_block >
                                     0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem_bytes = static_cast<size_t>(w * warp_bytes);
  auto kernel = cmv_ring_kernel<Tile>;
  static size_t opted = 0;  // the opt-in is a runtime call: once per size
  if (smem_bytes > opted) {
    const int err = allow_dynamic_smem(kernel, smem_bytes);
    if (err) return err;
    opted = smem_bytes;
  }
  const bool x16 = (reinterpret_cast<uintptr_t>(X) & 15) == 0 &&
                   (NVT % 4 == 0 || k2 % 4 == 0);
  const dim3 grid(static_cast<unsigned>((items + per_block - 1) / per_block));
  kernel<<<grid, 32 * w, smem_bytes, stream>>>(
      S, X, blk, col, cnt, Y, items, nb, k1, k2, nv, maxb, row_tiles,
      nv_tiles, sp, stage, vec, x16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// S [nb, k1, k2], X [nodes, k2, nv], Y [rows, k1, nv], all contiguous;
// blk/col [rows*maxb], cnt [rows] int32.  The caller never passes rows,
// k1 or nv of zero (a grid of zero blocks is refused).
static int coupling_mv_general(const float* S, const float* X,
                               const int* blk, const int* col,
                               const int* cnt, float* Y, int rows, int nb,
                               int k1, int k2, int nv, int maxb,
                               cudaStream_t stream) {
  dim3 grid(rows, (nv + BNV - 1) / BNV);
  const bool vec = k2 % 4 == 0 && reinterpret_cast<uintptr_t>(S) % 16 == 0;
  coupling_mv_kernel<<<grid, NT, 0, stream>>>(S, X, blk, col, cnt, Y, nb, k1,
                                               k2, nv, maxb, vec);
  return static_cast<int>(cudaGetLastError());
}

// The pipelined routes (``cmv_plan``'s "warp16", "warp1"): ``kb``
// is the planner's configuration, ``vec`` its 16-byte-copy flag for S.
// The configurations here and ``FMA_TILES`` in kernels/coupling_mv.py
// are one table.
static int coupling_mv_ring(const float* S, const float* X, const int* blk,
                            const int* col, const int* cnt, float* Y,
                            int rows, int nb, int k1, int k2, int nv,
                            int maxb, int route, int kb, int vec,
                            cudaStream_t st) {
#define CMV_ARGS S, X, blk, col, cnt, Y, rows, nb, k1, k2, nv, maxb, vec != 0, st
  if (route == 1) {  // warp16
    switch (kb) {
      case 4: return launch_ring<FmaTile<16, 4, 1, 4>>(CMV_ARGS);
      case 8: return launch_ring<FmaTile<32, 4, 1, 4>>(CMV_ARGS);
      case 16: return launch_ring<FmaTile<32, 4, 2, 4>>(CMV_ARGS);
      case 40: return launch_ring<FmaTile<32, 4, 5, 4>>(CMV_ARGS);
      case 64: return launch_ring<FmaTile<32, 4, 4, 4>>(CMV_ARGS);
    }
  } else if (route == 2) {  // warp1
    switch (kb) {
      case 8: return launch_ring<FmaTile<8, 1, 1, 1>>(CMV_ARGS);
      case 16: return launch_ring<FmaTile<16, 1, 1, 1>>(CMV_ARGS);
      case 32: return launch_ring<FmaTile<32, 1, 1, 1>>(CMV_ARGS);
    }
  }
#undef CMV_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// One launch, its arguments packed into one int64 array (one ctypes
// argument): v = {route (0 general, 1 warp16, 2 warp1), S, X,
// blk, col, cnt, Y, rows, nb, k1, k2, nv, maxb, kb, vec, stream}.
extern "C" int coupling_mv_f32(const long long* v) {
  const auto S = reinterpret_cast<const float*>(v[1]);
  const auto X = reinterpret_cast<const float*>(v[2]);
  const auto blk = reinterpret_cast<const int*>(v[3]);
  const auto col = reinterpret_cast<const int*>(v[4]);
  const auto cnt = reinterpret_cast<const int*>(v[5]);
  const auto Y = reinterpret_cast<float*>(v[6]);
  const int rows = static_cast<int>(v[7]), nb = static_cast<int>(v[8]);
  const int k1 = static_cast<int>(v[9]), k2 = static_cast<int>(v[10]);
  const int nv = static_cast<int>(v[11]), maxb = static_cast<int>(v[12]);
  const auto stream = reinterpret_cast<cudaStream_t>(v[15]);
  if (v[0] == 0)
    return coupling_mv_general(S, X, blk, col, cnt, Y, rows, nb, k1, k2, nv,
                               maxb, stream);
  return coupling_mv_ring(S, X, blk, col, cnt, Y, rows, nb, k1, k2, nv, maxb,
                          static_cast<int>(v[0]), static_cast<int>(v[13]),
                          static_cast<int>(v[14]), stream);
}
