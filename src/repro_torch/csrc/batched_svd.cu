// Batched one-sided Jacobi SVD in Brent-Luk parallel order:
//   A [n x k] -> U [n x kn], sigma [kn] (descending), V^T [kn x k],
//   kn = min(n, k).  The U polish (one QR pass) is a launch of the QR
//   kernel made by the Python wrapper.
//
// Replaces: src/repro/kernels/batched_svd.py, batched_svd / _svd_kernel /
// _brent_luk_schedule (the Pallas kernel of the recompression upsweep).
//
// Bound on the H100: by bytes it would take nanoseconds (a [72 x 36] input
// is 10 KB), by fp32 operations each sweep costs ~6*n*k^2 flops; the
// kernel is in practice latency-bound -- k-1 dependent rounds per sweep,
// each a handful of warp reductions -- so the card is filled only by the
// batch (up to 16384 matrices on the main path, one block each).
//
// Design: one block per matrix, A [n x ke] and V [ke x ke] in shared
// memory (ke = k rounded up to even, the pad column zero), odd row
// strides so that a warp walking a column hits 32 different banks.  The
// Brent-Luk schedule is computed in the kernel.  In each round every
// disjoint pair (p, q) is given to one warp: it reduces app, aqq and apq
// with shuffles, computes the same rotation as the reference (skipped when
// |apq| <= 1e-12 sqrt(app aqq)), and rotates columns p and q of A and V in
// place.  The TPU kernel's one-hot selection matrices and rotation GEMMs
// only fed its matrix unit and are not ported.  The input is Frobenius-
// normalized first; sweeps stop one sweep after the off-diagonal Gram norm
// first falls to <= tol * trace, tested per matrix, or after max_sweeps.
// The confirming sweep matters: the TPU kernel tested `any` over groups of
// up to 16 matrices, which gave most matrices that extra sweep by accident;
// stopping each matrix at the bare test leaves near-singular ones with
// sigma errors of ~1e-4 * sigma_max (16384 random 36x36 inputs), one more
// sweep (quadratic convergence) brings them to ~4e-6.  Sigma is sorted
// descending, stably, with the pad column last; U = A / sigma.
#include "common.cuh"

namespace {

constexpr int MAX_WARPS = 16;

__device__ __forceinline__ float sgn(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

// Brent-Luk lineup of round r for m players: player 0 fixed, the rest
// rotated right by r.
__device__ __forceinline__ int lineup(int idx, int r, int m) {
  if (idx == 0) return 0;
  const int mm = m - 1;
  return 1 + ((idx - 1 - r) % mm + mm) % mm;
}

__global__ void svd_kernel(const float* __restrict__ A, long long sab,
                           long long san, long long sak, float* U, float* S,
                           float* Vt, int n, int k,
                           int max_sweeps, float tol) {
  extern __shared__ float smem[];
  const int ke = k + (k & 1), kn = min(n, k), hp = ke / 2;
  const int lda = ke + 1, ldv = ke + 1;
  float* As = smem;
  float* Vs = As + n * lda;
  float* sig = Vs + ke * ldv;
  int* order = reinterpret_cast<int*>(sig + ke);
  float* red = reinterpret_cast<float*>(order + ke);
  const long long b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;

  const float* Ab = A + b * sab;
  float ss = 0.f;
  for (int e = threadIdx.x; e < n * ke; e += blockDim.x) {
    const int i = e / ke, c = e % ke;
    const float x = c < k ? Ab[i * san + c * sak] : 0.f;
    As[i * lda + c] = x;
    ss = fmaf(x, x, ss);
  }
  for (int e = threadIdx.x; e < ke * ke; e += blockDim.x) {
    const int i = e / ke, c = e % ke;
    Vs[i * ldv + c] = i == c ? 1.f : 0.f;
  }
  const float scale = fmaxf(sqrtf(block_sum(ss, red)), 1e-30f);
  for (int e = threadIdx.x; e < n * ke; e += blockDim.x) {
    const int i = e / ke, c = e % ke;
    As[i * lda + c] /= scale;
  }
  __syncthreads();

  bool settled = false;
  for (int sweep = 0;; ++sweep) {
    // per-matrix convergence: off-diagonal Gram norm against the trace
    float off = 0.f, tot = 0.f;
    for (int pq = warp; pq < ke * ke; pq += nw) {
      const int p = pq / ke, q = pq % ke;
      if (q < p) continue;
      float d = 0.f;
      for (int i = lane; i < n; i += 32)
        d = fmaf(As[i * lda + p], As[i * lda + q], d);
      d = warp_sum(d);
      if (lane == 0) {
        if (p == q) tot += d;
        else off += 2.f * d * d;
      }
    }
    off = block_sum(off, red);
    tot = block_sum(tot, red);
    const bool converged = !(off > (tol * tot) * (tol * tot));
    if (sweep >= max_sweeps || (converged && settled)) break;
    settled = converged;  // one confirming sweep after the test first passes

    for (int r = 0; r < ke - 1; ++r) {
      for (int pi = warp; pi < hp; pi += nw) {
        const int x0 = lineup(pi, r, ke), x1 = lineup(ke - 1 - pi, r, ke);
        const int p = min(x0, x1), q = max(x0, x1);
        float app = 0.f, aqq = 0.f, apq = 0.f;
        for (int i = lane; i < n; i += 32) {
          const float ap = As[i * lda + p], aq = As[i * lda + q];
          app = fmaf(ap, ap, app);
          aqq = fmaf(aq, aq, aqq);
          apq = fmaf(ap, aq, apq);
        }
        app = warp_sum(app);
        aqq = warp_sum(aqq);
        apq = warp_sum(apq);
        if (!(fabsf(apq) > 1e-12f * sqrtf(app * aqq + 1e-30f))) continue;
        const float tau =
            (aqq - app) / (2.f * (fabsf(apq) > 1e-30f ? apq : 1e-30f));
        const float t = sgn(tau) / (fabsf(tau) + sqrtf(1.f + tau * tau));
        const float c = 1.f / sqrtf(1.f + t * t);
        const float s = c * t;
        for (int i = lane; i < n; i += 32) {
          const float ap = As[i * lda + p], aq = As[i * lda + q];
          As[i * lda + p] = c * ap - s * aq;
          As[i * lda + q] = s * ap + c * aq;
        }
        for (int i = lane; i < ke; i += 32) {
          const float vp = Vs[i * ldv + p], vq = Vs[i * ldv + q];
          Vs[i * ldv + p] = c * vp - s * vq;
          Vs[i * ldv + q] = s * vp + c * vq;
        }
      }
      __syncthreads();
    }
  }

  for (int c = warp; c < ke; c += nw) {
    float s = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float x = As[i * lda + c];
      s = fmaf(x, x, s);
    }
    s = warp_sum(s);
    if (lane == 0) sig[c] = sqrtf(s);
  }
  __syncthreads();
  // stable descending rank, pad columns (c >= k) last
  for (int c = threadIdx.x; c < ke; c += blockDim.x) {
    const float kc = c < k ? sig[c] : -1.f;
    int rank = 0;
    for (int j = 0; j < ke; ++j) {
      const float kj = j < k ? sig[j] : -1.f;
      rank += (kj > kc) || (kj == kc && j < c);
    }
    order[rank] = c;
  }
  __syncthreads();
  float* Ub = U + b * n * kn;
  for (int e = threadIdx.x; e < n * kn; e += blockDim.x) {
    const int i = e / kn, j = e % kn, c = order[j];
    Ub[e] = As[i * lda + c] / fmaxf(sig[c], 1e-30f);
  }
  for (int j = threadIdx.x; j < kn; j += blockDim.x)
    S[b * kn + j] = sig[order[j]] * scale;
  float* Vb = Vt + b * kn * k;
  for (int e = threadIdx.x; e < kn * k; e += blockDim.x) {
    const int j = e / k, c = e % k;
    Vb[e] = Vs[c * ldv + order[j]];
  }
}

}  // namespace

extern "C" long long batched_svd_smem_bytes(int n, int k) {
  const long long ke = k + (k & 1);
  return (n * (ke + 1) + ke * (ke + 1) + 2 * ke + 32) * 4;
}

// A [nb, n, k] by element strides; U [nb, n, kn], S [nb, kn],
// Vt [nb, kn, k] contiguous.  nb, n and k are > 0.
extern "C" int batched_svd_f32(const float* A, long long sab, long long san,
                               long long sak, float* U, float* S, float* Vt,
                               int nb, int n, int k, int max_sweeps,
                               float tol, void* stream) {
  const int ke = k + (k & 1);
  const int warps = std::min(std::max(ke / 2, 1), MAX_WARPS);
  const size_t smem = static_cast<size_t>(batched_svd_smem_bytes(n, k));
  const int err = allow_dynamic_smem(svd_kernel, smem);
  if (err) return err;
  svd_kernel<<<nb, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      A, sab, san, sak, U, S, Vt, n, k, max_sweeps, tol);
  return static_cast<int>(cudaGetLastError());
}
