// Batched one-sided Jacobi SVD in Brent-Luk parallel order:
//   A [n x k] -> U [n x kn], sigma [kn] (descending), V^T [kn x k],
//   kn = min(n, k).  The U polish (one QR pass) is a launch of the QR
//   kernel made by the Python wrapper.
//
// Replaces: src/repro/kernels/batched_svd.py, batched_svd / _svd_kernel /
// _brent_luk_schedule (the Pallas kernel of the recompression upsweep).
//
// Bound on the H100: operations.  Counted from the shapes alone (Golub & Van
// Loan fig. 8.6.1: 14 m s^2 + 8 s^3 flops for a thin SVD with U and V, 14 m
// s^2 - 2 s^3 for U and sigma) the leaf R^T [16384, 36, 36] needs 0.251 ms at
// 67 TFLOP/s fp32, 0.137 ms without V, its bytes 0.03 ms.  Jacobi does several
// times those operations (~6 n k^2 per sweep, 8-10 sweeps) and, worse, runs
// them as a chain of k-1 dependent rounds per sweep: what bounds it in
// practice is the latency of each round.
//
// Two designs, chosen per shape by ``svd_plan`` in the wrapper:
//
// * warp-per-matrix (``svd_warp_kernel``; <= 64 Jacobi columns): one warp owns
//   one matrix, a block holds several, so warps and not block barriers fill
//   the SM.  The Jacobi matrix lives in shared memory column by column, V
//   likewise, each column padded with zero rows to an odd number of 16-byte
//   units (16-byte loads of lanes on different columns then spread over the
//   banks).  Lane l takes Brent-Luk pair l of each round (ke/2 <= 32 pairs),
//   forms app, aqq and apq by a serial loop of 16-byte loads over the rows --
//   no shuffles -- and rotates its two columns; the rounds are separated by
//   ``__syncwarp`` only.  The convergence test is folded into the sweep: the
//   off-diagonal Gram norm is the sum of 2 apq^2 over the pairs as they are
//   met (every pair once per sweep), the trace the sum of app + aqq over round
//   0.  Since that reading runs slightly ahead of the state at the start of
//   the sweep, a matrix stops after the second consecutive sweep that passes
//   (<= tol * trace), which is at least the reference's one confirming sweep;
//   or after max_sweeps.  Wide panels (n < k) take the transposed route:
//   Jacobi on A^T (n columns of length k, so [8192, 6, 36] needs 5 rounds of 3
//   pairs instead of 35 of 18), U = V', V^T = (A^T V' / sigma)^T.  V' is a
//   product of rotations and so orthonormal whatever the spectrum: that route
//   needs no polish.  With ``want_vt`` false the square route accumulates no
//   V.
// * block-per-matrix (``svd_kernel``, the general path: more than 64
//   Jacobi columns, or columns longer than 256 rows): A [n x ke] and
//   V in shared memory, one warp per pair, reductions by shuffles, a block
//   barrier per round, an explicit Gram test before each sweep.
//
// Both keep what the TPU kernel computes: Frobenius normalization, the same
// rotation (skipped when |apq| <= 1e-12 sqrt(app aqq)), sigma sorted
// descending, stably, with pad columns last, U = A / sigma; the TPU
// kernel's one-hot selection matrices and rotation GEMMs only fed its
// matrix unit and are not ported.  The per-matrix stop needs its
// confirming sweep: the TPU kernel tested `any` over groups of up to 16
// matrices, which gave most matrices that extra sweep by accident; stopping
// each matrix at the bare test leaves near-singular ones with sigma errors
// of ~1e-4 * sigma_max (16384 random 36x36 inputs), one more sweep
// (quadratic convergence) brings them to ~4e-6.
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
  extern __shared__ __align__(16) float smem[];
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

  const bool want_v = Vt != nullptr;
  const float* Ab = A + b * sab;
  float ss = 0.f;
  for (int e = threadIdx.x; e < n * ke; e += blockDim.x) {
    const int i = e / ke, c = e % ke;
    const float x = c < k ? Ab[i * san + c * sak] : 0.f;
    As[i * lda + c] = x;
    ss = fmaf(x, x, ss);
  }
  for (int e = threadIdx.x; want_v && e < ke * ke; e += blockDim.x) {
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
        for (int i = lane; want_v && i < ke; i += 32) {
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
  if (!want_v) return;
  float* Vb = Vt + b * kn * k;
  for (int e = threadIdx.x; e < kn * k; e += blockDim.x) {
    const int j = e / k, c = e % k;
    Vb[e] = Vs[c * ldv + order[j]];
  }
}

// A column stride for the warp route: rows rounded up to whole 16-byte
// units, and an odd number of them, so that the 16-byte loads of lanes on
// different columns spread over the banks (distinct columns mod 8 never
// collide).  The pad rows hold zeros, which rotations keep.
__host__ __device__ inline int col_stride(int rows) {
  const int u = (rows + 3) >> 2;
  return 4 * (u | 1);
}

// Columns (xp, xq) <- (c xp - s xq, s xp + c xq) over len4 16-byte units;
// the loads of two units are issued before their stores.
__device__ __forceinline__ void rotate_cols(float* xp, float* xq, int len4,
                                            float c, float s) {
  float4* p4 = reinterpret_cast<float4*>(xp);
  float4* q4 = reinterpret_cast<float4*>(xq);
  int i = 0;
  for (; i + 2 <= len4; i += 2) {
    const float4 x0 = p4[i], y0 = q4[i], x1 = p4[i + 1], y1 = q4[i + 1];
    p4[i] = make_float4(c * x0.x - s * y0.x, c * x0.y - s * y0.y,
                        c * x0.z - s * y0.z, c * x0.w - s * y0.w);
    q4[i] = make_float4(s * x0.x + c * y0.x, s * x0.y + c * y0.y,
                        s * x0.z + c * y0.z, s * x0.w + c * y0.w);
    p4[i + 1] = make_float4(c * x1.x - s * y1.x, c * x1.y - s * y1.y,
                            c * x1.z - s * y1.z, c * x1.w - s * y1.w);
    q4[i + 1] = make_float4(s * x1.x + c * y1.x, s * x1.y + c * y1.y,
                            s * x1.z + c * y1.z, s * x1.w + c * y1.w);
  }
  if (i < len4) {
    const float4 x0 = p4[i], y0 = q4[i];
    p4[i] = make_float4(c * x0.x - s * y0.x, c * x0.y - s * y0.y,
                        c * x0.z - s * y0.z, c * x0.w - s * y0.w);
    q4[i] = make_float4(s * x0.x + c * y0.x, s * x0.y + c * y0.y,
                        s * x0.z + c * y0.z, s * x0.w + c * y0.w);
  }
}

// Floats of one warp's share of shared memory: the Jacobi matrix (ce
// columns of stride col_stride(rows)), V (ce columns of stride
// col_stride(ce)) when it is accumulated, sigma and the sort order;
// rounded up to 16 bytes.
__host__ __device__ inline long long svd_warp_floats(int rows, int ce,
                                                     bool want_v) {
  const long long f =
      static_cast<long long>(ce) * col_stride(rows) +
      (want_v ? static_cast<long long>(ce) * col_stride(ce) : 0) + 2LL * ce;
  return (f + 3) & ~3LL;
}

// One warp per matrix.  TRANS: Jacobi on A^T (the n < k route).
template <bool TRANS>
__global__ void svd_warp_kernel(const float* __restrict__ A, long long sab,
                                long long san, long long sak,
                                float* __restrict__ U, float* __restrict__ S,
                                float* __restrict__ Vt, int nb, int n, int k,
                                int want_vt, int max_sweeps, float tol) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (b >= nb) return;  // the whole warp: no barrier below spans warps
  const int rows = TRANS ? k : n, cols = TRANS ? n : k;
  const int ce = cols + (cols & 1), hp = ce / 2, kn = cols;
  const int ldc = col_stride(rows), ldv = col_stride(ce);
  const bool want_v = TRANS || want_vt;
  float* As = smem + warp * svd_warp_floats(rows, ce, want_v);
  float* Vs = As + ce * ldc;
  float* sig = Vs + (want_v ? ce * ldv : 0);
  int* order = reinterpret_cast<int*>(sig + ce);

  // load through the strides, lanes along whichever index is unit-stride
  const long long s_row = TRANS ? sak : san, s_col = TRANS ? san : sak;
  const float* Ab = A + b * sab;
  for (int e = lane; e < ce * ldc; e += 32) As[e] = 0.f;  // pad rows too
  __syncwarp();
  float ss = 0.f;
  for (int e = lane; e < rows * ce; e += 32) {
    int r, c;
    if (s_row == 1) {
      c = e / rows;
      r = e - c * rows;
    } else {
      r = e / ce;
      c = e - r * ce;
    }
    const float x = c < cols ? Ab[r * s_row + c * s_col] : 0.f;
    As[c * ldc + r] = x;
    ss = fmaf(x, x, ss);
  }
  for (int e = lane; want_v && e < ce * ldv; e += 32) {
    const int c = e / ldv;
    Vs[e] = e - c * ldv == c ? 1.f : 0.f;
  }
  const float scale = fmaxf(sqrtf(warp_sum(ss)), 1e-30f);
  __syncwarp();
  for (int e = lane; e < rows * cols; e += 32) {
    const int c = e / rows, r = e - c * rows;
    As[c * ldc + r] /= scale;
  }
  __syncwarp();

  bool settled = false;
  for (int sweep = 0; sweep < max_sweeps; ++sweep) {
    float off = 0.f, tot = 0.f;
    for (int r = 0; r < ce - 1; ++r) {
      if (lane < hp) {
        const int x0 = lineup(lane, r, ce), x1 = lineup(ce - 1 - lane, r, ce);
        const int p = min(x0, x1), q = max(x0, x1);
        float* ap = As + p * ldc;
        float* aq = As + q * ldc;
        // 16-byte loads, four chains each: the lane walks its columns
        // serially (pad rows are zero)
        const float4* p4 = reinterpret_cast<const float4*>(ap);
        const float4* q4 = reinterpret_cast<const float4*>(aq);
        float4 a4 = make_float4(0.f, 0.f, 0.f, 0.f), b4 = a4, c4 = a4;
        for (int i = 0; i < ldc / 4; ++i) {
          const float4 x = p4[i], y = q4[i];
          a4 = make_float4(fmaf(x.x, x.x, a4.x), fmaf(x.y, x.y, a4.y),
                           fmaf(x.z, x.z, a4.z), fmaf(x.w, x.w, a4.w));
          b4 = make_float4(fmaf(y.x, y.x, b4.x), fmaf(y.y, y.y, b4.y),
                           fmaf(y.z, y.z, b4.z), fmaf(y.w, y.w, b4.w));
          c4 = make_float4(fmaf(x.x, y.x, c4.x), fmaf(x.y, y.y, c4.y),
                           fmaf(x.z, y.z, c4.z), fmaf(x.w, y.w, c4.w));
        }
        const float app = (a4.x + a4.y) + (a4.z + a4.w);
        const float aqq = (b4.x + b4.y) + (b4.z + b4.w);
        const float apq = (c4.x + c4.y) + (c4.z + c4.w);
        if (r == 0) tot += app + aqq;
        off = fmaf(2.f * apq, apq, off);
        if (fabsf(apq) > 1e-12f * sqrtf(app * aqq + 1e-30f)) {
          const float tau =
              (aqq - app) / (2.f * (fabsf(apq) > 1e-30f ? apq : 1e-30f));
          const float t = sgn(tau) / (fabsf(tau) + sqrtf(1.f + tau * tau));
          const float c = 1.f / sqrtf(1.f + t * t);
          const float s = c * t;
          rotate_cols(ap, aq, ldc / 4, c, s);
          if (want_v) rotate_cols(Vs + p * ldv, Vs + q * ldv, ldv / 4, c, s);
        }
      }
      __syncwarp();
    }
    off = warp_sum(off);
    tot = warp_sum(tot);
    const bool converged = !(off > (tol * tot) * (tol * tot));
    if (converged && settled) break;
    settled = converged;
  }

  for (int c = lane; c < ce; c += 32) {
    const float* ac = As + c * ldc;
    float s = 0.f;
    for (int i = 0; i < rows; ++i) s = fmaf(ac[i], ac[i], s);
    sig[c] = sqrtf(s);
  }
  __syncwarp();
  // stable descending rank, pad columns (c >= cols) last
  for (int c = lane; c < ce; c += 32) {
    const float kc = c < cols ? sig[c] : -1.f;
    int rank = 0;
    for (int j = 0; j < ce; ++j) {
      const float kj = j < cols ? sig[j] : -1.f;
      rank += (kj > kc) || (kj == kc && j < c);
    }
    order[rank] = c;
  }
  __syncwarp();
  float* Ub = U + b * n * kn;
  float* Vb = Vt + b * kn * k;
  if (!TRANS) {
    for (int e = lane; e < n * kn; e += 32) {
      const int i = e / kn, c = order[e - i * kn];
      Ub[e] = As[c * ldc + i] / fmaxf(sig[c], 1e-30f);
    }
    for (int e = lane; want_vt && e < kn * k; e += 32) {
      const int j = e / k;
      Vb[e] = Vs[order[j] * ldv + (e - j * k)];
    }
  } else {  // A = V' S U'^T: U = V', V^T = U'^T with U' = A^T V' / sigma
    for (int e = lane; e < n * kn; e += 32) {
      const int i = e / kn;
      Ub[e] = Vs[order[e - i * kn] * ldv + i];
    }
    for (int e = lane; want_vt && e < kn * k; e += 32) {
      const int j = e / k, c = order[j];
      Vb[e] = As[c * ldc + (e - j * k)] / fmaxf(sig[c], 1e-30f);
    }
  }
  for (int j = lane; j < kn; j += 32) S[b * kn + j] = sig[order[j]] * scale;
}

}  // namespace

extern "C" long long batched_svd_smem_bytes(int n, int k) {
  const long long ke = k + (k & 1);
  return (n * (ke + 1) + ke * (ke + 1) + 2 * ke + 32) * 4;
}

// The general route.  A [nb, n, k] by element strides; U [nb, n, kn],
// S [nb, kn], Vt [nb, kn, k] contiguous (Vt null: V is not accumulated).
// nb, n and k are > 0.
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

// Floats of one matrix's share of the warp route's shared memory.
extern "C" long long batched_svd_warp_floats(int n, int k, int want_vt) {
  const bool trans = n < k;
  const int cols = trans ? n : k;
  return svd_warp_floats(trans ? k : n, cols + (cols & 1), trans || want_vt);
}

// The warp route: ``wpb`` matrices (warps) per block, the transposed
// variant where n < k.  Vt is written only when want_vt.  nb, n, k > 0.
extern "C" int batched_svd_warp_f32(const float* A, long long sab,
                                    long long san, long long sak, float* U,
                                    float* S, float* Vt, int nb, int n, int k,
                                    int want_vt, int wpb, int max_sweeps,
                                    float tol, void* stream) {
  const size_t smem = static_cast<size_t>(wpb) * 4 *
                      static_cast<size_t>(batched_svd_warp_floats(n, k,
                                                                  want_vt));
  const int blocks = (nb + wpb - 1) / wpb;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (n < k) {
    err = allow_dynamic_smem(svd_warp_kernel<true>, smem);
    if (err) return err;
    svd_warp_kernel<true><<<blocks, 32 * wpb, smem, st>>>(
        A, sab, san, sak, U, S, Vt, nb, n, k, want_vt, max_sweeps, tol);
  } else {
    err = allow_dynamic_smem(svd_warp_kernel<false>, smem);
    if (err) return err;
    svd_warp_kernel<false><<<blocks, 32 * wpb, smem, st>>>(
        A, sab, san, sak, U, S, Vt, nb, n, k, want_vt, max_sweeps, tol);
  }
  return static_cast<int>(cudaGetLastError());
}
