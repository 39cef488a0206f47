// Reductions shared by the port's kernels (sphere_tcg.cu, stiefel_tcg.cu,
// matvec_chain.cu), and the exchange of a thread-block cluster's CTAs
// through distributed shared memory (stiefel_tcg.cu, matvec_chain.cu).
// Every sum runs in one fixed order and every thread (of the block, of
// every CTA of a cooperative grid, or of a cluster) gets the same bits
// back, so branches on a result are uniform and CTAs that recompute one
// value agree with no atomics.
//
// `red` is a shared array of SLOTS * WARPS + SLOTS floats: the warps'
// partials, then the totals.  The totals keep one place whatever N is, so
// a call's partials never overwrite a total that a slower warp may still
// be reading from the call before.

#pragma once

#include <cooperative_groups.h>
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

// The same with ONE barrier: each warp's sums by a shuffle tree into
// red[buf], then every warp adds the WARPS partials itself in warp order
// (the same bits in every warp).  `red` holds [2][SLOTS][WARPS] floats; two
// consecutive calls take different `buf`s, so a call never overwrites
// partials a slower warp may still be reading from the call before.
template <int WARPS, int SLOTS, int N>
__device__ __forceinline__ void cta_sum(float (&v)[N], float* red, int buf) {
  static_assert(N <= SLOTS, "too many sums");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* r = red + buf * SLOTS * WARPS;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float s = warp_sum(v[k]);
    if (lane == 0) r[k * WARPS + warp] = s;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += r[k * WARPS + w];
    v[k] = t;
  }
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

// The same over the `lanes` lanes of each aligned group (a power of two, at
// most 32, at most E; the low bits of the lane index): afterwards sub-lane
// s = lane % lanes holds in v[j] (j < E / lanes) the group's sum of entry
// s * (E / lanes) + j.  `lanes` is a run-time value, uniform over the warp;
// the levels' halvings are constants, so v stays in registers.
template <int E, int LEVEL = 0>
__device__ __forceinline__ void group_reduce_scatter(float (&v)[E], int lanes) {
  if constexpr ((E >> LEVEL) > 1 && LEVEL < 5) {
    const int s = lanes >> (LEVEL + 1);
    if (s == 0) return;
    constexpr int m = E >> (LEVEL + 1);
    const bool upper = (threadIdx.x & s) != 0;
#pragma unroll
    for (int j = 0; j < m; ++j) {
      const float send = upper ? v[j] : v[j + m];
      const float keep = upper ? v[j + m] : v[j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, s);
    }
    group_reduce_scatter<E, LEVEL + 1>(v, lanes);
  }
}

// A CTA's block of `nf4` float4s at `block` (shared memory) written to the
// same place in the shared memory of each other CTA of its cluster of
// `slices` (this one is `slice`), by `threads` threads: the block writes of
// a cluster exchange, float4 by float4 (a scalar store to a peer costs as
// much as a float4).  The caller's cluster barrier then publishes them.
__device__ __forceinline__ void copy_to_peers(float* block, int nf4, int slices, int slice,
                                              int threads) {
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  const float4* src = reinterpret_cast<const float4*>(block);
  for (int idx = threadIdx.x; idx < (slices - 1) * nf4; idx += threads) {
    const int p = idx / nf4, e = idx - p * nf4;
    reinterpret_cast<float4*>(cl.map_shared_rank(block, (slice + 1 + p) % slices))[e] = src[e];
  }
}

// Sum of the slices' partials part[u * stride] over u < slices, in slice
// order: every CTA of a cluster that holds the same partials gets the same
// bits.
__device__ __forceinline__ float slice_sum(const float* part, int stride, int slices) {
  float acc = 0.f;
  for (int u = 0; u < slices; ++u) acc += part[(size_t)u * stride];
  return acc;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace
