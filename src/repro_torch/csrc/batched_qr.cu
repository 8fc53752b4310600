// Batched reduced Householder QR:  A [n x k] -> Q [n x kn], R [kn x k],
// kn = min(n, k), R with a non-negative diagonal (Q's columns flipped to
// match), a zero reflector for a vanishing column.
//
// Replaces: src/repro/kernels/batched_qr.py, batched_qr / _qr_kernel /
// _qr_body / _wy_apply (the blocked compact-WY Pallas kernel of
// orthogonalization, the compression weights and the SVD polish).
//
// Bound on the H100: bytes at the main path's shapes.  The leaf
// [16384, 64, 36] with Q moves 37.7 MB in and out (0.115 ms at 3.35
// TB/s); the weights stack [16384, 648, 36], R only, reads 1.53 GB
// (0.48 ms) for ~2 n k^2 = 1.7 Mflop a matrix, ~17 flops/byte, under the
// fp32 FFMA ridge (~20).  A Householder QR is a chain of k dependent
// steps, so what holds a kernel back from that bound is latency: the
// bytes it keeps in flight and the steps in which threads wait.
//
// Three routes, chosen per shape by ``qr_plan`` in the wrapper:
//
// * ``qr_warp_kernel``, short panels (n <= 128, k <= 64; the leaves,
//   transfer stacks and SVD polishes), Q and R or R only: one warp per
//   matrix, several per block.  The matrix arrives by ``cp.async`` and is
//   transposed on the way in (4-byte copies; lanes read a row's columns,
//   coalesced) into a column-major tile of odd column stride, so that each
//   lane walks its own column at consecutive addresses -- immediate offsets,
//   no index arithmetic -- and lanes on different columns hit different
//   banks.  Step j: the whole warp reduces the column's norm below the
//   diagonal (lanes over rows, one warp sum), every lane forms the same
//   reflector in registers, then lane l updates trailing column j+1+l
//   (+32) by a serial dot over the rows (four FMA chains) and a rank-1
//   update (loads of eight rows issued before their stores).  Only
//   ``__syncwarp`` separates the steps.  Q is formed backwards the same
//   way, lanes over Q's columns.
// * ``qr_tall_kernel``, R only for tall stacks (n > 128, k <= 64; the
//   compression weights, up to 648 rows): the stack streams through in chunks
//   of 32 rows, R <- R of [R; chunk] (TSQR by rows), with a double-buffered
//   ring of ``cp.async`` chunks per warp, so a matrix holds ~15 KB of shared
//   memory instead of 93 KB and 14 matrices are in flight per SM (two warps a
//   block); every input byte is read once.  A chunk lies column by column
//   (stride 36 floats: a lane reads its column with 16-byte loads, and the
//   16-byte loads of consecutive columns fall in distinct banks).  Reflector j
//   touches row j of R and the chunk's rows only (R is upper triangular); the
//   lane holds the reflector and its column of the chunk in registers.  A step
//   whose chunk column is already zero is skipped (the stacks' zero padding
//   slots).  A ragged last chunk is zero-filled.  R is unique once its
//   diagonal is non-negative and A has full column rank, so it equals the full
//   factorization's up to rounding; for a rank-deficient stack both give R^T R
//   = A^T A.
// * ``qr_kernel``, the general path (wider or taller panels with Q, and
//   batches under 512 matrices, where one warp per matrix is slower): one
//   block of 256 threads per matrix, warp 0 forms each reflector, one warp
//   per trailing column; the matrix in shared memory (odd row stride) when
//   n*k*4 bytes fit, else in a global scratch copy with the same arithmetic
//   in the same order (a rank-64 3D operator gives 1152x64 = 295 KB).
//
// The TPU's `bb` batching and `panel` compact-WY blocking were VMEM/MXU
// choices and are dropped.  In every route step j forms the unit reflector
// v (alpha = -sign(x_j) * sigma) in the strictly lower part of column j (the
// diagonal entry apart) and applies H = I - 2 v v^T.
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
  extern __shared__ __align__(16) float smem[];
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

// One warp's asynchronous copy of rows [row0, row0 + nrows) of a matrix
// into a column-major tile (column stride ld), committed as one group.
// Lanes walk the columns of a row, so a row-major source is read in
// coalesced rows; the tile is transposed on the way in (4-byte copies), so
// that each lane later reads its own column at consecutive addresses.
__device__ __forceinline__ void load_cols_async(float* dst, int ld,
                                                const float* Ab,
                                                long long san, long long sak,
                                                int row0, int nrows, int k) {
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < nrows; ++r) {
    const float* src = Ab + (row0 + r) * san;
    for (int c = lane; c < k; c += 32)
      cp_async4(smem_u32(dst + c * ld + r), src + c * sak);
  }
  cp_async_commit();
}

// sum_{i < len} v[i] x[i], in four independent chains over blocks of
// eight rows (the warp routes walk a column serially: one chain would wait
// on each FMA, and short blocks on each load).
__device__ __forceinline__ float dot_col(const float* v, const float* x,
                                         int len) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  int i = 0;
  for (; i + 8 <= len; i += 8) {
    float vv[8], xx[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      vv[t] = v[i + t];
      xx[t] = x[i + t];
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) d[t & 3] = fmaf(vv[t], xx[t], d[t & 3]);
  }
  for (; i < len; ++i) d[0] = fmaf(v[i], x[i], d[0]);
  return (d[0] + d[1]) + (d[2] + d[3]);
}

// x[i] -= v[i] d for i < len: the loads of eight rows are issued before
// their stores (the compiler may not move a load past a store to the same
// array).
__device__ __forceinline__ void axpy_col(const float* v, float* x, float d,
                                         int len) {
  int i = 0;
  for (; i + 8 <= len; i += 8) {
    float vv[8], xx[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      vv[t] = v[i + t];
      xx[t] = x[i + t];
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) x[i + t] = fmaf(-vv[t], d, xx[t]);
  }
  for (; i < len; ++i) x[i] = fmaf(-v[i], d, x[i]);
}

// Floats of one warp's share on the warp route: the tile and Q column by
// column (stride n|1: lanes reading one row of different columns hit
// different banks), the reflectors' diagonal entries and alpha; rounded
// up to 16 bytes.
__host__ __device__ inline int qr_warp_floats(int n, int k, int want_q) {
  const int kn = n < k ? n : k;
  const int f = (k + (want_q ? kn : 0)) * (n | 1) + 2 * kn;
  return (f + 3) & ~3;
}

__global__ void qr_warp_kernel(const float* __restrict__ A, long long sab,
                               long long san, long long sak,
                               float* __restrict__ Q, float* __restrict__ R,
                               int nb, int n, int k, int want_q) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (b >= nb) return;  // the whole warp: no barrier below spans warps
  const int kn = min(n, k), ld = n | 1;
  float* W = smem + warp * qr_warp_floats(n, k, want_q);
  float* Qw = W + k * ld;
  float* vd = Qw + (want_q ? kn * ld : 0);
  float* alpha = vd + kn;
  load_cols_async(W, ld, A + b * sab, san, sak, 0, n, k);
  cp_async_wait<0>();
  __syncwarp();

  for (int j = 0; j < kn; ++j) {
    float* wj = W + j * ld;  // column j; the reflector below row j
    float t = 0.f;
    for (int i = j + 1 + lane; i < n; i += 32) t = fmaf(wj[i], wj[i], t);
    const float tail = warp_sum(t);
    const float xj = wj[j];
    const float sigma = sqrtf(fmaf(xj, xj, tail));
    const float a = xj >= 0.f ? -sigma : sigma;
    const float vj = xj - a;
    const float vnorm = sqrtf(fmaf(vj, vj, tail));
    const bool safe = vnorm > 1e-30f;
    const float v0 = safe ? vj / vnorm : 0.f;
    __syncwarp();  // every lane has read x_j before it is overwritten
    for (int i = j + 1 + lane; i < n; i += 32)
      wj[i] = safe ? wj[i] / vnorm : 0.f;
    if (lane == 0) {
      vd[j] = v0;
      alpha[j] = a;
      wj[j] = a;
    }
    __syncwarp();
    if (!safe) continue;  // a vanishing column: the zero reflector
    for (int c = j + 1 + lane; c < k; c += 32) {
      float* x = W + c * ld;
      const float d =
          2.f * fmaf(v0, x[j], dot_col(wj + j + 1, x + j + 1, n - j - 1));
      x[j] = fmaf(-v0, d, x[j]);
      axpy_col(wj + j + 1, x + j + 1, d, n - j - 1);
    }
    __syncwarp();
  }

  if (want_q) {
    // Q = H_0 ... H_{kn-1} [I_kn; 0], backwards; H_j leaves columns < j
    for (int e = lane; e < kn * ld; e += 32) {
      const int c = e / ld;
      Qw[e] = e - c * ld == c ? 1.f : 0.f;
    }
    __syncwarp();
    for (int j = kn - 1; j >= 0; --j) {
      const float v0 = vd[j];
      const float* wj = W + j * ld;
      for (int c = j + lane; c < kn; c += 32) {
        float* x = Qw + c * ld;
        const float d =
            2.f * fmaf(v0, x[j], dot_col(wj + j + 1, x + j + 1, n - j - 1));
        x[j] = fmaf(-v0, d, x[j]);
        axpy_col(wj + j + 1, x + j + 1, d, n - j - 1);
      }
      __syncwarp();
    }
    float* Qb = Q + b * n * kn;
    for (int e = lane; e < n * kn; e += 32) {
      const int i = e / kn, c = e - i * kn;
      const float v = Qw[c * ld + i];
      Qb[e] = alpha[c] < 0.f ? -v : v;
    }
  }
  float* Rb = R + b * kn * k;
  for (int e = lane; e < kn * k; e += 32) {
    const int i = e / k, c = e - i * k;
    const float v = c >= i ? W[c * ld + i] : 0.f;
    Rb[e] = alpha[i] < 0.f ? -v : v;
  }
}

constexpr int TCH = 32;       // rows per chunk of the tall route (a lane each)
constexpr int TLD = TCH + 4;  // a chunk column's stride: 16-byte reads of
                              // consecutive columns fall in distinct banks

// Floats of one warp's share on the tall route: two column-major chunks
// and R (row-major), each a multiple of 16 bytes.
__host__ __device__ inline int qr_tall_floats(int k) {
  return 2 * k * TLD + ((k * k + 3) & ~3);
}

// R only, n >= k: R <- R of [R; chunk] over chunks of TCH rows.
__global__ void __launch_bounds__(128)
qr_tall_kernel(const float* __restrict__ A, long long sab, long long san,
               long long sak, float* __restrict__ R, int nb, int n, int k) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (b >= nb) return;
  float* buf = smem + warp * qr_tall_floats(k);
  float* Rs = buf + 2 * k * TLD;
  for (int e = lane; e < k * k; e += 32) Rs[e] = 0.f;
  const float* Ab = A + b * sab;
  const int nch = (n + TCH - 1) / TCH;
  load_cols_async(buf, TLD, Ab, san, sak, 0, min(TCH, n), k);
  for (int t = 0; t < nch; ++t) {
    float* X = buf + (t & 1) * k * TLD;
    const int nxt = (t + 1) * TCH;
    if (t + 1 < nch)  // the other buffer's chunk was consumed at t - 1
      load_cols_async(buf + ((t + 1) & 1) * k * TLD, TLD, Ab, san, sak, nxt,
                      min(TCH, n - nxt), k);
    else
      cp_async_commit();  // an empty group keeps the count below uniform
    cp_async_wait<1>();   // chunk t has landed
    __syncwarp();
    const int rv = min(TCH, n - t * TCH);
    if (rv < TCH) {  // ragged last chunk: zero rows leave R unchanged
      for (int c = 0; c < k; ++c)
        if (lane >= rv) X[c * TLD + lane] = 0.f;
      __syncwarp();
    }
    for (int j = 0; j < k; ++j) {
      float* xj_col = X + j * TLD;
      const float xl = xj_col[lane];
      const float tail = warp_sum(xl * xl);
      const float xj = Rs[j * k + j];
      const float sigma = sqrtf(fmaf(xj, xj, tail));
      const float a = xj >= 0.f ? -sigma : sigma;
      const float vj = xj - a;
      const float vnorm = sqrtf(fmaf(vj, vj, tail));
      // the chunk's column is already zero: H_j would only flip row j
      if (tail == 0.f || !(vnorm > 1e-30f)) continue;
      const float v0 = vj / vnorm;
      __syncwarp();
      xj_col[lane] = xl / vnorm;
      if (lane == 0) Rs[j * k + j] = a;
      __syncwarp();
      float vr[TCH];
#pragma unroll
      for (int q = 0; q < TCH / 4; ++q) {
        const float4 u = reinterpret_cast<const float4*>(xj_col)[q];
        vr[4 * q] = u.x;
        vr[4 * q + 1] = u.y;
        vr[4 * q + 2] = u.z;
        vr[4 * q + 3] = u.w;
      }
      for (int c = j + 1 + lane; c < k; c += 32) {
        float4* xc_col = reinterpret_cast<float4*>(X + c * TLD);
        float4 xc[TCH / 4];
        float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
#pragma unroll
        for (int q = 0; q < TCH / 4; ++q) {
          xc[q] = xc_col[q];
          d0 = fmaf(vr[4 * q], xc[q].x, d0);
          d1 = fmaf(vr[4 * q + 1], xc[q].y, d1);
          d2 = fmaf(vr[4 * q + 2], xc[q].z, d2);
          d3 = fmaf(vr[4 * q + 3], xc[q].w, d3);
        }
        const float d =
            2.f * fmaf(v0, Rs[j * k + c], (d0 + d1) + (d2 + d3));
        Rs[j * k + c] = fmaf(-v0, d, Rs[j * k + c]);
#pragma unroll
        for (int q = 0; q < TCH / 4; ++q)
          xc_col[q] = make_float4(fmaf(-vr[4 * q], d, xc[q].x),
                                  fmaf(-vr[4 * q + 1], d, xc[q].y),
                                  fmaf(-vr[4 * q + 2], d, xc[q].z),
                                  fmaf(-vr[4 * q + 3], d, xc[q].w));
      }
      __syncwarp();
    }
  }
  float* Rb = R + b * k * k;
  for (int e = lane; e < k * k; e += 32) {
    const int i = e / k, c = e - i * k;
    const float v = c >= i ? Rs[e] : 0.f;
    Rb[e] = Rs[i * k + i] < 0.f ? -v : v;
  }
}

}  // namespace

// Dynamic shared memory the shared-memory path needs for one [n x k].
extern "C" long long batched_qr_smem_bytes(int n, int k, int want_q) {
  return static_cast<long long>(smem_bytes(n, k, want_q, false));
}

// The general route.  A [nb, n, k] by element strides; Q [nb, n, kn]
// (unused unless want_q) and R [nb, kn, k] contiguous.  `work` is a
// [nb, n, k] global scratch (the global path) or null (the shared-memory
// path).  nb, n and k are > 0.
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

// Floats of one matrix's share on the warp and tall routes.
extern "C" long long batched_qr_warp_floats(int n, int k, int want_q) {
  return qr_warp_floats(n, k, want_q);
}

extern "C" long long batched_qr_tall_floats(int k) {
  return qr_tall_floats(k);
}

// The warp route: ``wpb`` matrices (warps) per block; Q [nb, n, kn] (unused
// unless want_q) and R [nb, kn, k] contiguous.  nb, n, k > 0, k <= 64.
extern "C" int batched_qr_warp_f32(const float* A, long long sab,
                                   long long san, long long sak, float* Q,
                                   float* R, int nb, int n, int k, int want_q,
                                   int wpb, void* stream) {
  const size_t smem =
      static_cast<size_t>(wpb) * 4 * qr_warp_floats(n, k, want_q);
  const int err = allow_dynamic_smem(qr_warp_kernel, smem);
  if (err) return err;
  qr_warp_kernel<<<(nb + wpb - 1) / wpb, 32 * wpb, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      A, sab, san, sak, Q, R, nb, n, k, want_q);
  return static_cast<int>(cudaGetLastError());
}

// The tall route, R only: R [nb, k, k] contiguous.  nb > 0, n >= k > 0,
// k <= 64, wpb <= 4.
extern "C" int batched_qr_tall_f32(const float* A, long long sab,
                                   long long san, long long sak, float* R,
                                   int nb, int n, int k, int wpb,
                                   void* stream) {
  const size_t smem = static_cast<size_t>(wpb) * 4 * qr_tall_floats(k);
  const int err = allow_dynamic_smem(qr_tall_kernel, smem);
  if (err) return err;
  qr_tall_kernel<<<(nb + wpb - 1) / wpb, 32 * wpb, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      A, sab, san, sak, R, nb, n, k);
  return static_cast<int>(cudaGetLastError());
}
