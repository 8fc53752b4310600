// Segmented gather of the halo plan's send rows: for every segment s of a
// table,  Y_s[i, :] = X_s[idx_s[i], :],  all segments in one launch.
//
// Replaces: src/repro/kernels/halo_pack.py, halo_pack / _pack_kernel (the
// scalar-prefetch Pallas kernel that DMAs each planned [k, nv] row of the
// distributed HGEMV's halo exchange into the packed payload).
//
// Bound on the H100: launches, then memory.  A pure copy: each packed row
// is read once and written once, no arithmetic.  One distributed HGEMV
// packs ~2,000 rows of [36, 16] or [64, 16] floats (4.65 MB read, 4.65 MB
// written per rank at N = 2^20, p = 4, a 2.8 us byte bound), but they come
// in 76 (level, offset) pieces: one launch per piece costs ~7 us of host
// and launch time each, two orders of magnitude over the bytes.
//
// Design: the whole exchange is one launch.  The wrapper passes a table of
// segments by value, as a ``__grid_constant__`` kernel parameter (no copy
// to the card before the launch; the table stays under the 4 KB parameter
// limit of every CUDA version): per segment its index list, source slot,
// destination offset, row count and row length, plus the exclusive prefix
// of the row counts.  One warp copies one packed row: it finds its
// segment by binary search on the prefix, reads its row's index itself
// (the TPU kernel's scalar prefetch), and copies with 16-byte loads and
// stores when the row length is a multiple of 4 floats and both pointers
// are 16-byte aligned, four bytes at a time otherwise; neighbouring lanes
// touch neighbouring addresses.  The destination is one buffer -- the flat
// per-offset payloads or the merged [p, capmax] all-to-all rows -- so the
// pack is the only copy before the wire.  In the bf16 payload mode the
// store casts to bfloat16 with round-to-nearest-even (``cvt.rn``), the
// rounding of PyTorch's own cast.  Padding entries of idx repeat row 0 and
// are copied like any other.
#include <cuda_bf16.h>

#include "common.cuh"

constexpr int MAX_SEGS = 96, MAX_SRCS = 32;

// The kernel's parameter table (outside the anonymous namespace: the C
// entry point takes it, and must keep external linkage).
struct PackSeg {
  const int* idx;      // [cap] source rows
  long long dst_off;   // first element of the segment in the destination
  int src;             // slot of the source in PackTable::srcs
  int cap;             // rows
  int row;             // floats per row
  int first;           // exclusive prefix of cap: the segment's first row
};

struct PackTable {
  int nseg;
  int rows;            // sum of cap
  int bf16;            // destination is bfloat16 (else float32)
  int nsrc;            // sources (slots of srcs in use)
  void* dst;
  const float* srcs[MAX_SRCS];
  PackSeg seg[MAX_SEGS];
};

namespace {

constexpr int NT = 128, WARPS = NT / 32;
constexpr int UNROLL = 8;       // loads in flight per lane: a whole
                                // [64, 16] row per warp in one pass

__device__ __forceinline__ void store4(float* d, float4 v) {
  *reinterpret_cast<float4*>(d) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* d, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(d) = u;
}

__device__ __forceinline__ void store1(float* d, float v) { *d = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* d, float v) {
  *d = __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ void copy_row(const float* __restrict__ src,
                                         T* __restrict__ dst, int row,
                                         int lane) {
  const bool vec = row % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dst) % (4 * sizeof(T)) == 0;
  // every load of a pass is issued before its stores, so a lane keeps
  // UNROLL loads in flight instead of one
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    const int n4 = row / 4;
    for (int e0 = lane; e0 < n4; e0 += 32 * UNROLL) {
      float4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (e0 + 32 * u < n4) v[u] = __ldg(s4 + e0 + 32 * u);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (e0 + 32 * u < n4) store4(dst + 4 * (e0 + 32 * u), v[u]);
    }
  } else {
    for (int e0 = lane; e0 < row; e0 += 32 * UNROLL) {
      float v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (e0 + 32 * u < row) v[u] = __ldg(src + e0 + 32 * u);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (e0 + 32 * u < row) store1(dst + e0 + 32 * u, v[u]);
    }
  }
}

__global__ void __launch_bounds__(NT)
halo_pack_kernel(__grid_constant__ const PackTable t) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (w >= t.rows) return;
  int lo = 0, hi = t.nseg - 1;             // last segment with first <= w
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.seg[mid].first <= w) lo = mid; else hi = mid - 1;
  }
  const PackSeg& s = t.seg[lo];
  const int i = w - s.first;
  const float* src =
      t.srcs[s.src] + static_cast<long long>(s.idx[i]) * s.row;
  const long long off = s.dst_off + static_cast<long long>(i) * s.row;
  if (t.bf16)
    copy_row(src, static_cast<__nv_bfloat16*>(t.dst) + off, s.row, lane);
  else
    copy_row(src, static_cast<float*>(t.dst) + off, s.row, lane);
}

}  // namespace

extern "C" int halo_pack_table_bytes() { return sizeof(PackTable); }

// One launch over the host-static table ``t`` (built once by the wrapper;
// its ``dst`` and ``srcs`` are not read) with this call's pointers ``live``
// = {stream, dst, src_0, ..., src_{nsrc-1}} as integers.  The table goes
// into the launch's parameters.  Sources are float32 ``[n_s, row_s]``
// contiguous; the destination holds every segment's rows.  The caller
// never passes a table without rows (a grid of zero blocks is refused).
extern "C" int halo_pack_segments(const PackTable* t, const long long* live) {
  PackTable p = *t;
  p.dst = reinterpret_cast<void*>(live[1]);
  for (int i = 0; i < p.nsrc; ++i)
    p.srcs[i] = reinterpret_cast<const float*>(live[2 + i]);
  const dim3 grid((p.rows + WARPS - 1) / WARPS);
  halo_pack_kernel<<<grid, NT, 0, reinterpret_cast<cudaStream_t>(live[0])>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}
