// Batched GEMM  C[b] = A[b] @ B[b]  (fp32, FFMA accumulation, no TF32).
//
// Replaces: src/repro/kernels/batched_gemm.py, batched_gemm / _gemm_kernel
// (the Pallas TPU kernel behind every dense contraction of the HGEMV).
//
// Bound on the H100: memory.  The HGEMV's GEMMs are skinny -- leaf bases
// [64 x 36] against [64 x nv] panels, transfers [36 x 36] against
// [36 x nv] -- so there are at most ~2*36*64*16 / ((36*64 + 64*16 +
// 36*16)*4) ~ 4.6 flops per byte, far below the ~20 flops/byte where fp32
// FFMA (67 TFLOP/s) would take over from HBM (3.35 TB/s).  The kernel runs
// at HBM speed only if every SM keeps ~20-30 KB of loads in flight.
//
// Two paths, chosen on the host by ``plan_launch`` (kernels/batched_gemm.py)
// from shapes, strides and pointer alignment:
//
// Fast path (M <= 64, K <= 64, N <= 16 with N % 4 == 0, every A[b] and B[b]
// one dense span of memory).  A persistent grid of a few CTAs per SM; each
// CTA walks groups of G consecutive batch entries through a 3-stage ring
// in shared memory, so the next groups load while the current one
// computes.  A group's A matrices are one contiguous span, as are its B
// matrices -- also for the transposed views the upsweep passes (V^T,
// F^T), since v_leaf[b] is dense whichever way it is read -- and each span
// is copied as flat bytes: by the Hopper bulk copy (``cp.async.bulk`` on
// an ``mbarrier``, one thread issues it) when both spans start on 16-byte
// boundaries and are multiples of 16 bytes, else by ``cp.async`` 16- or
// 4-byte copies from every thread.  The transpose is handled by indexing
// shared memory, not by the load pattern.  K is staged whole and N = 16 is
// taken whole, so there is no slab loop.  The compute is templated on an M
// bucket: a thread owns TM rows (1 for M <= 16, 3 for M <= 48 -- the
// rank-36 case -- and 4 for M <= 64), strided by the row-group count so
// that the lanes of a warp read consecutive words, and one 4-column quad
// of C, written with one 16-byte store per row.  Row groups are sized to
// M, so no thread holds an idle row group.
//
// General path: the first version's strided kernel, for everything else
// (K or M above 64, N not a multiple of 4 or above 16, a batch stride that
// is not dense, B transposed).  One block of 64 threads per (batch, 64-row
// tile, 16-column tile), K in 32-deep slabs, each thread a 4x4 tile of C;
// A and B are read through their strides.  The batch rides gridDim.x.
#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// general path (strided)
// ---------------------------------------------------------------------------

constexpr int NT = 64, TM = 4, TN = 4, BM = 16 * TM, BN = 4 * TN, BK = 32;

__global__ void __launch_bounds__(NT)
bgemm_kernel(const float* __restrict__ A, long long sab, long long sam,
             long long sak, const float* __restrict__ B, long long sbb,
             long long sbk, long long sbn, float* __restrict__ C, int M,
             int N, int K) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];
  const long long b = blockIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.z * BN;
  const int t = threadIdx.x, tn = t % 4, tm = t / 4;
  const float* Ab = A + b * sab;
  const float* Bb = B + b * sbb;
  const bool a_rows_fast = (sam == 1), b_cols_fast = (sbn == 1);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = t; e < BM * BK; e += NT) {
      const int mm = a_rows_fast ? e % BM : e / BK;
      const int kk = a_rows_fast ? e / BM : e % BK;
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K) ? Ab[gm * sam + gk * sak] : 0.f;
    }
    for (int e = t; e < BK * BN; e += NT) {
      const int nn = b_cols_fast ? e % BN : e / BK;
      const int kk = b_cols_fast ? e / BN : e % BK;
      const int gk = k0 + kk, gn = n0 + nn;
      Bs[kk][nn] = (gk < K && gn < N) ? Bb[gk * sbk + gn * sbn] : 0.f;
    }
    __syncthreads();
    if (m0 + tm * TM < M) {
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(&As[kk][tm * TM]);
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tn * TN]);
        const float a4[TM] = {av.x, av.y, av.z, av.w};
        const float b4[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a4[i], b4[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + tm * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tn * TN + j;
      if (gm < M && gn < N) C[(b * M + gm) * N + gn] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// fast path (dense spans, staged whole)
// ---------------------------------------------------------------------------

constexpr int STAGES = 3;
constexpr int FAST_THREADS = 128;        // threads a CTA aims for
constexpr int FAST_STAGE_BYTES = 32 << 10;  // a stage's size the G choice aims under

// Layout of A[b] in shared memory (a flat copy of its span).
enum ALayout {
  A_T = 0,    // transposed view: the span is [K][M] (A = V^T, F^T)
  A_N = 1,    // row-major [M][K], read one k at a time
  A_N4 = 2,   // row-major [M][K] with K % 4 == 0, read four k at a time
};

struct FastArgs {
  const float* A;
  const float* B;
  float* C;
  int nb, M, N, K;
  int G;         // batch entries per stage
  int RG;        // row groups per matrix (rows of a thread are RG apart)
  int NQ;        // 4-column quads per matrix (N / 4)
  int a_floats;  // a stage's A block, rounded up to a multiple of 4 floats
  int b_floats;  // a stage's B block
  int ngroups;   // ceil(nb / G)
  int a_vec;     // cp.async path: A may be copied 16 bytes at a time
  int b_vec;     // cp.async path: B likewise
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Hopper bulk copy global -> shared, completion counted on ``bar``; dst,
// src and bytes are multiples of 16.
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ``n`` floats from ``src`` to shared ``dst`` by every thread of the CTA.
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           int n, bool vec) {
  if (vec) {
    for (int e = threadIdx.x * 4; e < n; e += blockDim.x * 4)
      cp_async16(smem_u32(dst + e), src + e);
  } else {
    for (int e = threadIdx.x; e < n; e += blockDim.x)
      cp_async4(smem_u32(dst + e), src + e);
  }
}

template <int TMR, int AL, bool BULK>
__global__ void __launch_bounds__(FAST_THREADS)
bgemm_fast_kernel(const FastArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int stage_floats = p.a_floats + p.b_floats;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + STAGES * stage_floats);
  const int M = p.M, N = p.N, K = p.K, RG = p.RG;
  const int MK = M * K, KN = K * N;
  const int units = RG * p.NQ;
  const int g = threadIdx.x / units, u = threadIdx.x % units;
  const int rg = u / p.NQ, n0 = (u % p.NQ) * 4;
  // this CTA's groups: blockIdx.x + j * gridDim.x, j < count
  const int count = (p.ngroups - 1 - static_cast<int>(blockIdx.x)) /
                        static_cast<int>(gridDim.x) + 1;

  auto batch0 = [&](int j) {
    return (static_cast<int>(blockIdx.x) + j * static_cast<int>(gridDim.x)) *
           p.G;
  };
  auto issue = [&](int j) {     // group j -> stage j % STAGES
    const int b0 = batch0(j);
    const int gn = min(p.G, p.nb - b0);
    float* sa = smem + (j % STAGES) * stage_floats;
    float* sb = sa + p.a_floats;
    const float* ga = p.A + static_cast<long long>(b0) * MK;
    const float* gb = p.B + static_cast<long long>(b0) * KN;
    if (BULK) {
      if (threadIdx.x == 0) {
        const uint32_t bar = smem_u32(&bars[j % STAGES]);
        const uint32_t abytes = gn * MK * 4, bbytes = gn * KN * 4;
        mbar_expect_tx(bar, abytes + bbytes);
        bulk_g2s(smem_u32(sa), ga, abytes, bar);
        bulk_g2s(smem_u32(sb), gb, bbytes, bar);
      }
    } else {
      copy_async(sa, ga, gn * MK, p.a_vec);
      copy_async(sb, gb, gn * KN, p.b_vec);
    }
  };

  if (BULK) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&bars[s]), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  // prologue: STAGES - 1 groups in flight (always STAGES - 1 cp.async
  // commit groups, some possibly empty, so the wait count below holds)
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < count) issue(j);
    if (!BULK) cp_async_commit();
  }

  for (int j = 0; j < count; ++j) {
    if (j + STAGES - 1 < count) issue(j + STAGES - 1);
    if (BULK) {
      mbar_wait(smem_u32(&bars[j % STAGES]), (j / STAGES) & 1);
    } else {
      cp_async_commit();
      cp_async_wait<STAGES - 1>();
      __syncthreads();
    }
    const int b0 = batch0(j);
    if (g < min(p.G, p.nb - b0)) {
      const float* sa = smem + (j % STAGES) * stage_floats + g * MK;
      const float* sb = smem + (j % STAGES) * stage_floats + p.a_floats +
                        g * KN + n0;
      float acc[TMR][4];
#pragma unroll
      for (int i = 0; i < TMR; ++i)
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
      if (AL == A_N4) {
        for (int k = 0; k < K; k += 4) {
          float4 bv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            bv[q] = *reinterpret_cast<const float4*>(sb + (k + q) * N);
#pragma unroll
          for (int i = 0; i < TMR; ++i) {
            const int m = rg + i * RG;
            const float4 av =
                m < M ? *reinterpret_cast<const float4*>(sa + m * K + k)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
            const float a4[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              acc[i][0] = fmaf(a4[q], bv[q].x, acc[i][0]);
              acc[i][1] = fmaf(a4[q], bv[q].y, acc[i][1]);
              acc[i][2] = fmaf(a4[q], bv[q].z, acc[i][2]);
              acc[i][3] = fmaf(a4[q], bv[q].w, acc[i][3]);
            }
          }
        }
      } else {
        for (int k = 0; k < K; ++k) {
          const float4 bv = *reinterpret_cast<const float4*>(sb + k * N);
#pragma unroll
          for (int i = 0; i < TMR; ++i) {
            const int m = rg + i * RG;
            const float a =
                m < M ? sa[AL == A_T ? k * M + m : m * K + k] : 0.f;
            acc[i][0] = fmaf(a, bv.x, acc[i][0]);
            acc[i][1] = fmaf(a, bv.y, acc[i][1]);
            acc[i][2] = fmaf(a, bv.z, acc[i][2]);
            acc[i][3] = fmaf(a, bv.w, acc[i][3]);
          }
        }
      }
      float* cb = p.C + static_cast<long long>(b0 + g) * M * N + n0;
#pragma unroll
      for (int i = 0; i < TMR; ++i) {
        const int m = rg + i * RG;
        if (m < M)
          *reinterpret_cast<float4*>(cb + m * N) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
    __syncthreads();          // stage j % STAGES is free for group j + STAGES
  }
}

int g_num_sms = 0;

// Launch one fast-path instantiation on a persistent grid: as many CTAs as
// fit on the card at once (occupancy, cached per block size and shared
// memory), never more than there are groups.
template <int TMR, int AL, bool BULK>
int launch_fast(const FastArgs& a, int threads, size_t smem,
                cudaStream_t stream) {
  auto kern = bgemm_fast_kernel<TMR, AL, BULK>;
  static bool attr_done = false;
  static int cache_threads[16], cache_occ[16];
  static size_t cache_smem[16];
  static int cached = 0;
  if (!attr_done) {
    const int err = static_cast<int>(cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        repro_max_dynamic_smem()));
    if (err) return err;
    attr_done = true;
  }
  if (g_num_sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&g_num_sms, cudaDevAttrMultiProcessorCount, dev);
  }
  int occ = 0;
  for (int i = 0; i < cached; ++i)
    if (cache_threads[i] == threads && cache_smem[i] == smem)
      occ = cache_occ[i];
  if (occ == 0) {
    const int err = static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, threads,
                                                      smem));
    if (err) return err;
    if (occ < 1) occ = 1;
    if (cached < 16) {
      cache_threads[cached] = threads;
      cache_smem[cached] = smem;
      cache_occ[cached++] = occ;
    }
  }
  const int grid = std::min(a.ngroups, occ * g_num_sms);
  kern<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int TMR>
int dispatch_layout(int layout, bool bulk, const FastArgs& a, int threads,
                    size_t smem, cudaStream_t s) {
  switch (layout * 2 + (bulk ? 1 : 0)) {
    case 0: return launch_fast<TMR, A_T, false>(a, threads, smem, s);
    case 1: return launch_fast<TMR, A_T, true>(a, threads, smem, s);
    case 2: return launch_fast<TMR, A_N, false>(a, threads, smem, s);
    case 3: return launch_fast<TMR, A_N, true>(a, threads, smem, s);
    case 4: return launch_fast<TMR, A_N4, false>(a, threads, smem, s);
    case 5: return launch_fast<TMR, A_N4, true>(a, threads, smem, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C [nb, M, N] contiguous; A and B by element strides.  ``plan`` is the
// path ``plan_launch`` chose: 0 the general strided kernel; otherwise
// 1 + bulk + 2 * layout + 6 * bucket, with bulk 1 for the bulk copy (0 for
// cp.async), layout the ALayout of A, bucket 0/1/2 for M <= 16/48/64.  The
// fast path requires what ``plan_launch`` checked: dense spans, M and K <=
// 64, N <= 16 and a multiple of 4, and for the bulk copy 16-byte aligned
// spans.  The caller never passes a zero-size problem (a grid of zero
// blocks is refused).
static int batched_gemm_launch(int plan, const float* A, long long sab,
                               long long sam, long long sak, const float* B,
                               long long sbb, long long sbk, long long sbn,
                               float* C, int nb, int M, int N, int K,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan == 0) {
    dim3 grid(nb, (M + BM - 1) / BM, (N + BN - 1) / BN);
    bgemm_kernel<<<grid, NT, 0, s>>>(A, sab, sam, sak, B, sbb, sbk, sbn, C,
                                     M, N, K);
    return static_cast<int>(cudaGetLastError());
  }
  const int code = plan - 1;
  const bool bulk = code % 2;
  const int layout = (code / 2) % 3, bucket = code / 6;
  const int tmr = bucket == 0 ? 1 : bucket == 1 ? 3 : 4;
  FastArgs a;
  a.A = A;
  a.B = B;
  a.C = C;
  a.nb = nb;
  a.M = M;
  a.N = N;
  a.K = K;
  a.RG = (M + tmr - 1) / tmr;
  a.NQ = N / 4;
  const int units = a.RG * a.NQ;
  const int per_matrix = (M * K + K * N) * 4;
  a.G = std::max(1, std::min({FAST_THREADS / units,
                              FAST_STAGE_BYTES / per_matrix, nb}));
  a.a_floats = (a.G * M * K + 3) / 4 * 4;
  a.b_floats = a.G * K * N;
  a.ngroups = (nb + a.G - 1) / a.G;
  a.a_vec = (M * K) % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0;
  a.b_vec = (K * N) % 4 == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0;
  const int threads = (a.G * units + 31) / 32 * 32;
  const size_t smem =
      static_cast<size_t>(STAGES) * (a.a_floats + a.b_floats) * 4 +
      STAGES * sizeof(uint64_t);
  switch (tmr) {
    case 1: return dispatch_layout<1>(layout, bulk, a, threads, smem, s);
    case 3: return dispatch_layout<3>(layout, bulk, a, threads, smem, s);
    default: return dispatch_layout<4>(layout, bulk, a, threads, smem, s);
  }
}

// The ctypes entry point: the arguments of ``batched_gemm_launch`` in
// order, packed into one int64 array (pointers and the stream as integers).
extern "C" int batched_gemm_f32(const long long* v) {
  return batched_gemm_launch(
      static_cast<int>(v[0]), reinterpret_cast<const float*>(v[1]), v[2],
      v[3], v[4], reinterpret_cast<const float*>(v[5]), v[6], v[7], v[8],
      reinterpret_cast<float*>(v[9]), static_cast<int>(v[10]),
      static_cast<int>(v[11]), static_cast<int>(v[12]),
      static_cast<int>(v[13]), reinterpret_cast<void*>(v[14]));
}
