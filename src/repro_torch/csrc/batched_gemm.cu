// Batched GEMM  C[b] = A[b] @ B[b]  (fp32, FFMA accumulation, no TF32).
//
// Replaces: src/repro/kernels/batched_gemm.py, batched_gemm / _gemm_kernel
// (the Pallas TPU kernel behind every dense contraction of the HGEMV).
//
// Bound on the H100: memory.  The HGEMV's GEMMs are skinny -- leaf bases
// [64 x 36] against [36 x nv] panels, transfers [36 x 36] against
// [36 x nv] -- so there are at most ~2*64*36*16 / ((64*36 + 36*16 +
// 64*16)*4) ~ 4.6 flops per byte, far below the ~20 flops/byte where fp32
// FFMA (67 TFLOP/s) would take over from HBM (3.35 TB/s).
//
// Design: one block of 64 threads per (batch, 64-row tile, 16-column
// tile).  A and B tiles are staged through shared memory along K in
// 32-deep slabs, A stored k-major; each thread owns a 4-row x 4-column
// tile of C in registers, so two float4 shared-memory reads feed 16 FMAs.
// A and B are read through their batch, row and column strides, so the
// transposed views the upsweep passes (V^T, F^T) are read in place,
// without a copy; the load order follows whichever dimension has unit
// stride so that neighbouring threads read neighbouring addresses.  The
// batch rides gridDim.x (no 65535 limit).
#include "common.cuh"

namespace {

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

}  // namespace

// C [nb, M, N] contiguous; A and B by element strides.  The caller never
// passes a zero-size problem (a grid of zero blocks is refused).
extern "C" int batched_gemm_f32(const float* A, long long sab, long long sam,
                                long long sak, const float* B, long long sbb,
                                long long sbk, long long sbn, float* C,
                                int nb, int M, int N, int K, void* stream) {
  dim3 grid(nb, (M + BM - 1) / BM, (N + BN - 1) / BN);
  bgemm_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      A, sab, sam, sak, B, sbb, sbk, sbn, C, M, N, K);
  return static_cast<int>(cudaGetLastError());
}
