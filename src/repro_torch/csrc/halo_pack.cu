// Gather of the halo plan's send rows:  Y[i, :] = X[idx[i], :]
//
// Replaces: src/repro/kernels/halo_pack.py, halo_pack / _pack_kernel (the
// scalar-prefetch Pallas kernel that DMAs each planned [k, nv] row of the
// distributed HGEMV's halo exchange into the packed payload).
//
// Bound on the H100: memory.  A pure copy: each packed row is read once
// and written once (2 * cap * row * 4 bytes, plus 4 bytes of index per
// row), no arithmetic.  On the distributed path the rows are [k, nv] =
// [36, 16] (2.3 KB) or, for the dense leaves, [64, 16] (4 KB), and a
// payload holds tens to a few thousand of them, so a launch moves at most
// a few MB and is latency-bound long before it is bandwidth-bound.
//
// Design: one warp per packed row, eight rows per block of 256 threads.
// The warp reads its row's index itself (the TPU kernel's scalar
// prefetch) and copies the row with 16-byte loads and stores when the row
// length is a multiple of 4 floats and both pointers are 16-byte aligned,
// four bytes at a time otherwise; neighbouring lanes touch neighbouring
// addresses, so every access is coalesced.  The destination is any
// contiguous [cap, row] buffer -- the wrapper may pass a slice of the
// flat per-offset payload or of the merged [p, capmax] all-to-all buffer,
// so the pack writes straight into the send buffer (the counterpart of
// the TPU kernel's DMA into the packed output).  Padding entries of idx
// repeat row 0 and are copied like any other.
#include "common.cuh"

namespace {

constexpr int NT = 256, WARPS = NT / 32;

template <typename T>
__global__ void __launch_bounds__(NT)
halo_pack_kernel(const T* __restrict__ X, const int* __restrict__ idx,
                 T* __restrict__ Y, int cap, long long row) {
  const int lane = threadIdx.x & 31;
  const long long i =
      static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (i >= cap) return;
  const T* src = X + static_cast<long long>(idx[i]) * row;
  T* dst = Y + i * row;
  for (long long e = lane; e < row; e += 32) dst[e] = __ldg(src + e);
}

}  // namespace

// X [n, row] and Y [cap, row] float32, contiguous; idx [cap] int32 with
// entries in [0, n).  ``row`` counts floats.  The caller never passes
// cap or row of zero (a grid of zero blocks is refused).
extern "C" int halo_pack_f32(const float* X, const int* idx, float* Y,
                             int cap, long long row, void* stream) {
  const dim3 grid((cap + WARPS - 1) / WARPS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = row % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(X) |
                    reinterpret_cast<uintptr_t>(Y)) % 16 == 0;
  if (vec)
    halo_pack_kernel<float4><<<grid, NT, 0, s>>>(
        reinterpret_cast<const float4*>(X), idx, reinterpret_cast<float4*>(Y),
        cap, row / 4);
  else
    halo_pack_kernel<float><<<grid, NT, 0, s>>>(X, idx, Y, cap, row);
  return static_cast<int>(cudaGetLastError());
}
