// Plan-driven block-sparse MV:
//   y[r] = sum_{j < cnt[r]} S[blk[r*maxb + j]] @ x[col[r*maxb + j]]
//
// Replaces: src/repro/kernels/coupling_mv.py, coupling_mv / _fused_kernel
// (the gather-fused scalar-prefetch Pallas kernel of the coupling phase and
// the dense-leaf phase of the HGEMV).
//
// Bound on the H100: memory.  Every S block is read once and used against
// an nv-wide slice of x (nv = 16 on the main path): 2*nv flops per 4-byte
// S element, 8 flops/byte at most, against the ~20 at which fp32 FFMA
// would bind.  The dense leaves alone are 1.3 GB of S at N = 2^20.
//
// Design: one block of 64 threads per (block row r, 16-wide nv tile).
// The block reads cnt[r] and then blk/col of each slot itself (this
// replaces the TPU's scalar prefetch), stages a [<=64 x <=64] chunk of the
// S block (16 KB for a 64x64 dense block; float4 loads when k2 % 4 == 0)
// and the matching [<=64 x 16] slice of x in shared memory, and
// accumulates y[r] in registers: each thread owns a 4-row x 4-column tile,
// so one float4 read of x and four reads of S feed 16 FMAs.  20 KB of
// shared memory per block lets ~11 blocks share an SM, whose loads overlap
// one another's arithmetic.  y[r] is written once by its own block: one
// writer per row, no atomics; rows with cnt = 0 write zeros.  Padding
// slots lie at j >= cnt[r] and are never visited; a slot holding the
// sentinel blk == nb is skipped as well, so it is never dereferenced.
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

}  // namespace

// S [nb, k1, k2], X [nodes, k2, nv], Y [rows, k1, nv], all contiguous;
// blk/col [rows*maxb], cnt [rows] int32.  The caller never passes rows,
// k1 or nv of zero (a grid of zero blocks is refused).
extern "C" int coupling_mv_f32(const float* S, const float* X, const int* blk,
                               const int* col, const int* cnt, float* Y,
                               int rows, int nb, int k1, int k2, int nv,
                               int maxb, void* stream) {
  dim3 grid(rows, (nv + BNV - 1) / BNV);
  const bool vec = k2 % 4 == 0 && reinterpret_cast<uintptr_t>(S) % 16 == 0;
  coupling_mv_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      S, X, blk, col, cnt, Y, nb, k1, k2, nv, maxb, vec);
  return static_cast<int>(cudaGetLastError());
}
