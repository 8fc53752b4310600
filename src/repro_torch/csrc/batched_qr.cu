// Batched reduced Householder QR:  A [n x k] -> Q [n x kn], R [kn x k],
// kn = min(n, k), R with a non-negative diagonal (Q's columns flipped to
// match), a zero reflector for a vanishing column.
//
// Replaces: src/repro/kernels/batched_qr.py, batched_qr / _qr_kernel /
// _qr_body / _wy_apply (the blocked compact-WY Pallas kernel of
// orthogonalization, the compression weights and the SVD polish).
//
// Bound on the H100: memory at the main path's shapes.  A [648 x 36]
// weights stack costs ~2*n*k^2 = 1.7 Mflop for 93 KB read and 5 KB written,
// ~17 flops/byte -- near the fp32 FFMA ridge (~20), and below it for the
// [64 x 36] leaves and [72 x 36] transfer stacks.  In practice a one-block-
// per-matrix Householder is latency-bound: the k steps are sequential.
//
// Design: one block of 256 threads per matrix; the TPU's `bb` batching and
// `panel` compact-WY blocking were VMEM/MXU choices and are dropped.
// Unblocked Householder: step j reduces the column norm in one warp, forms
// the unit reflector v (alpha = -sign(x_j) * sigma), stores it in the
// strictly lower part of column j (the diagonal entry in `vd`), and applies
// H = I - 2 v v^T to the trailing columns with one warp per column (dot by
// shuffles, then the rank-1 update).  Q = H_0 ... H_{kn-1} [I; 0] is built
// backwards, again one warp per column.  The matrix lives in shared memory
// (odd row stride, so column walks are free of bank conflicts) when
// n*k*4 bytes fit -- 93 KB for 648x36, above 48 KB through the dynamic
// shared-memory opt-in.  When it does not fit (a rank-64 3D operator gives
// 1152x64 = 295 KB) the same code runs on a global scratch copy and on the
// Q output directly; both paths do the same arithmetic in the same order.
// An R-only entry (the compression weights) skips forming Q.
#include "common.cuh"

namespace {

constexpr int NT = 256, NW = NT / 32;

__device__ __forceinline__ float refl(const float* W, int ldw,
                                      const float* vd, int i, int j) {
  return i == j ? vd[j] : W[i * ldw + j];
}

// Householder factorization of W (n x k, row stride ldw) in place: R in
// the upper triangle (diagonal in alpha), reflectors below it and in vd.
__device__ void qr_factor(float* W, int ldw, float* vd, float* alpha, int n,
                          int k, int kn) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = 0; j < kn; ++j) {
    if (warp == 0) {
      const float xj = W[j * ldw + j];
      float s = 0.f;
      for (int i = j + lane; i < n; i += 32) {
        const float x = W[i * ldw + j];
        s = fmaf(x, x, s);
      }
      const float sigma = sqrtf(warp_sum(s));
      const float a = xj >= 0.f ? -sigma : sigma;
      const float vj = xj - a;
      float s2 = 0.f;
      for (int i = j + lane; i < n; i += 32) {
        const float v = i == j ? vj : W[i * ldw + j];
        s2 = fmaf(v, v, s2);
      }
      const float vnorm = sqrtf(warp_sum(s2));
      const bool safe = vnorm > 1e-30f;
      __syncwarp();
      for (int i = j + 1 + lane; i < n; i += 32)
        W[i * ldw + j] = safe ? W[i * ldw + j] / vnorm : 0.f;
      if (lane == 0) {
        vd[j] = safe ? vj / vnorm : 0.f;
        alpha[j] = a;
        W[j * ldw + j] = a;
      }
    }
    __syncthreads();
    for (int c = j + 1 + warp; c < k; c += NW) {
      float d = 0.f;
      for (int i = j + lane; i < n; i += 32)
        d = fmaf(refl(W, ldw, vd, i, j), W[i * ldw + c], d);
      d = 2.f * warp_sum(d);
      for (int i = j + lane; i < n; i += 32)
        W[i * ldw + c] = fmaf(-refl(W, ldw, vd, i, j), d, W[i * ldw + c]);
    }
    __syncthreads();
  }
}

// Q = H_0 ... H_{kn-1} [I_kn; 0] into Qw (n x kn, row stride ldq).
__device__ void qr_form_q(const float* W, int ldw, const float* vd,
                          float* Qw, int ldq, int n, int kn) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int e = threadIdx.x; e < n * kn; e += NT) {
    const int i = e / kn, c = e % kn;
    Qw[i * ldq + c] = i == c ? 1.f : 0.f;
  }
  __syncthreads();
  for (int j = kn - 1; j >= 0; --j) {
    for (int c = j + warp; c < kn; c += NW) {
      float d = 0.f;
      for (int i = j + lane; i < n; i += 32)
        d = fmaf(refl(W, ldw, vd, i, j), Qw[i * ldq + c], d);
      d = 2.f * warp_sum(d);
      for (int i = j + lane; i < n; i += 32)
        Qw[i * ldq + c] = fmaf(-refl(W, ldw, vd, i, j), d, Qw[i * ldq + c]);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NT)
qr_kernel(const float* __restrict__ A, long long sab, long long san,
          long long sak, float* Q, float* R, float* work, int n, int k,
          int want_q) {
  extern __shared__ float smem[];
  const long long b = blockIdx.x;
  const int kn = min(n, k);
  float* vd = smem;
  float* alpha = smem + kn;
  float *W, *Qw = nullptr;
  int ldw, ldq;
  if (work != nullptr) {  // global path
    ldw = k;
    W = work + b * n * k;
    ldq = kn;
    if (want_q) Qw = Q + b * n * kn;
  } else {                // shared path
    ldw = k | 1;
    W = smem + 2 * kn;
    ldq = kn | 1;
    if (want_q) Qw = W + n * ldw;
  }
  const float* Ab = A + b * sab;
  for (int e = threadIdx.x; e < n * k; e += NT) {
    const int i = e / k, c = e % k;
    W[i * ldw + c] = Ab[i * san + c * sak];
  }
  __syncthreads();
  qr_factor(W, ldw, vd, alpha, n, k, kn);
  if (want_q) {
    qr_form_q(W, ldw, vd, Qw, ldq, n, kn);
    float* Qb = Q + b * n * kn;
    for (int e = threadIdx.x; e < n * kn; e += NT) {
      const int i = e / kn, c = e % kn;
      Qb[e] = alpha[c] < 0.f ? -Qw[i * ldq + c] : Qw[i * ldq + c];
    }
  }
  float* Rb = R + b * kn * k;
  for (int e = threadIdx.x; e < kn * k; e += NT) {
    const int i = e / k, c = e % k;
    const float v = c >= i ? W[i * ldw + c] : 0.f;
    Rb[e] = alpha[i] < 0.f ? -v : v;
  }
}

size_t smem_bytes(int n, int k, int want_q, bool global) {
  const int kn = std::min(n, k);
  size_t floats = 2 * static_cast<size_t>(kn);
  if (!global)
    floats += static_cast<size_t>(n) * (k | 1) +
              (want_q ? static_cast<size_t>(n) * (kn | 1) : 0);
  return floats * sizeof(float);
}

}  // namespace

// Dynamic shared memory the shared-memory path needs for one [n x k].
extern "C" long long batched_qr_smem_bytes(int n, int k, int want_q) {
  return static_cast<long long>(smem_bytes(n, k, want_q, false));
}

// A [nb, n, k] by element strides; Q [nb, n, kn] (unused unless want_q) and
// R [nb, kn, k] contiguous.  `work` is a [nb, n, k] global scratch (the
// global path) or null (the shared-memory path).  nb, n and k are > 0.
extern "C" int batched_qr_f32(const float* A, long long sab, long long san,
                              long long sak, float* Q, float* R, float* work,
                              int nb, int n, int k, int want_q,
                              void* stream) {
  const size_t smem = smem_bytes(n, k, want_q, work != nullptr);
  const int err = allow_dynamic_smem(qr_kernel, smem);
  if (err) return err;
  qr_kernel<<<nb, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      A, sab, san, sak, Q, R, work, n, k, want_q);
  return static_cast<int>(cudaGetLastError());
}
