// Reductions shared by the port's kernels (sphere_tcg.cu, stiefel_tcg.cu,
// matvec_chain.cu).  Every sum runs in one fixed order and every thread
// (of the block, or of every CTA of a cooperative grid) gets the same bits
// back, so branches on a result are uniform and CTAs that recompute one
// value agree with no atomics.
//
// `red` is a shared array of SLOTS * WARPS + SLOTS floats: the warps'
// partials, then the totals.  The totals keep one place whatever N is, so
// a call's partials never overwrite a total that a slower warp may still
// be reading from the call before.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The barrier of a whole CTA (block_sum's default).
struct CtaSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

// Sums N per-thread partials over a block of WARPS warps: each warp by a
// shuffle tree, then warp 0 over the warps' sums; every thread reads the
// totals back from shared memory after a barrier.  `sync` is the barrier
// of those WARPS warps (the CTA's, or a named barrier of some of its warps).
template <int WARPS, int SLOTS, int N, typename Sync = CtaSync>
__device__ __forceinline__ void block_sum(float (&v)[N], float* red, Sync sync = Sync()) {
  static_assert(WARPS <= 32, "one warp sums the warps' partials");
  static_assert(N <= SLOTS, "too many sums");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    v[k] = warp_sum(v[k]);
    if (lane == 0) red[k * WARPS + warp] = v[k];
  }
  sync();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float t = warp_sum(lane < WARPS ? red[k * WARPS + lane] : 0.f);
      if (lane == 0) red[SLOTS * WARPS + k] = t;
    }
  }
  sync();
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = red[SLOTS * WARPS + k];
}

// Sum over the nb CTAs' partials of a cooperative grid (part[b * N + k]),
// read through L2 (__ldcg: other CTAs wrote them): lane l of warp 0 takes
// b = l, l + 32, ..., then a shuffle tree.  Every CTA gets the same bits.
// Opens and closes with a barrier.
template <int WARPS, int SLOTS, int N>
__device__ __forceinline__ void grid_total(const float* part, int nb, float (&t)[N], float* red) {
  static_assert(N <= SLOTS, "too many sums");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float acc = 0.f;
      for (int b = lane; b < nb; b += 32) acc += __ldcg(part + (size_t)b * N + k);
      acc = warp_sum(acc);
      if (lane == 0) red[SLOTS * WARPS + k] = acc;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) t[k] = red[SLOTS * WARPS + k];
  __syncthreads();
}

// Reduce-scatter of E >= 32 per-lane partials over a warp: afterwards lane
// l holds in v[j] (j < E / 32) the warp's sum of entry l * (E / 32) + j.
// Each level halves the entries a lane keeps and adds its partner's half
// (E - E / 32 shuffles in all, against 5 E for E separate warp sums).  The
// levels are template instances, so every index is a constant and v stays
// in registers.
template <int E, int LEVEL = 0>
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[E]) {
  static_assert(E >= 32 && (E & (E - 1)) == 0, "E must be a power of two >= 32");
  if constexpr (LEVEL < 5) {
    constexpr int s = 16 >> LEVEL;
    constexpr int m = E >> (LEVEL + 1);
    const bool upper = (threadIdx.x & s) != 0;
#pragma unroll
    for (int j = 0; j < m; ++j) {
      const float send = upper ? v[j] : v[j + m];
      const float keep = upper ? v[j + m] : v[j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, s);
    }
    warp_reduce_scatter<E, LEVEL + 1>(v);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace
