// Hand-written Hopper (sm_90a) kernel for the sphere-quadratic barrier
// subproblem of RIPTRM on NonnegPCA: minimise -x'Zs x on S^{n-1}, x >= 0.
//
// With P = I - x x', corr = 2 x'Zs x + x'y and barrier weights w = y / c,
// the condensed barrier Hessian is
//
//     Hw(v) = -2 P(Zs v) + corr v + P(w o v).
//
//   tcg_kernel    replaces riptrm_tpu/ops/pallas_kernels.py
//                 ::pallas_tcg_sphere_quadratic (_tcg_kernel, one lane)
//                 and pallas_tcg_sphere_quadratic_batched (_tcg_kernel_batched,
//                 B lanes against one shared Zs): the whole Steihaug-Toint tCG
//                 of ops/tcg.py::truncated_cg, one CTA per lane.
//
// (K1, the chained Hw matvec, is chain_resident_kernel in matvec_chain.cu.)
//
// What bounds it on an H100: each tCG iteration reads all of Zs (n^2 * 4
// bytes, 4 MB at n = 1000) once per lane.  Zs does not fit in one SM's
// shared memory (227 KB) but sits in the 50 MB L2, so each CTA streams it
// from L2 with coalesced 16-byte loads (one warp per row, lanes across the
// columns; Zs is symmetric, so row i of Zs is column i).  A single lane is
// bound by one SM's share of L2 bandwidth; B lanes read B copies of Zs per
// iteration through the shared L2.  The lane's vectors (8 n-vectors, 32 KB
// at n = 1000) live in shared memory, and every scalar of the loop is a
// block reduction read back by all threads (reduce.cuh), so the exit
// decision is uniform within the block.  The matvec is full float32 with
// FMA on the CUDA cores (no TF32, no bf16 splitting).
//
// Plain C interface for ctypes (riptrm_torch/ops/_build.py): the launcher
// returns cudaGetLastError() after the launch, 0 on success.

#include <cuda_runtime.h>

#include "reduce.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSums = 3;
constexpr int kRedSlots = kMaxSums * kWarps + kMaxSums;

// out[i] = sum_j zs[i * n + j] * v[j]; v and out in shared memory.
__device__ __forceinline__ void matvec(const float* __restrict__ zs, const float* v,
                                       float* out, int n, bool vec4) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (vec4) {
    const int n4 = n >> 2;
    const float4* v4 = reinterpret_cast<const float4*>(v);
    for (int row = warp; row < n; row += kWarps) {
      const float4* z4 = reinterpret_cast<const float4*>(zs + (size_t)row * n);
      float acc = 0.f;
#pragma unroll 4
      for (int c = lane; c < n4; c += 32) {
        const float4 a = __ldg(z4 + c);
        const float4 b = v4[c];
        acc = fmaf(a.x, b.x, acc);
        acc = fmaf(a.y, b.y, acc);
        acc = fmaf(a.z, b.z, acc);
        acc = fmaf(a.w, b.w, acc);
      }
      acc = warp_sum(acc);
      if (lane == 0) out[row] = acc;
    }
  } else {
    for (int row = warp; row < n; row += kWarps) {
      const float* zr = zs + (size_t)row * n;
      float acc = 0.f;
#pragma unroll 4
      for (int c = lane; c < n; c += 32) acc = fmaf(__ldg(zr + c), v[c], acc);
      acc = warp_sum(acc);
      if (lane == 0) out[row] = acc;
    }
  }
}

// hv = -2 P(Zs v) + corr v + P(w o v).  Opens with a barrier, so callers
// may have just written v; afterwards each thread owns hv[i] for
// i = threadIdx.x + k * kThreads.
__device__ __forceinline__ void apply_hw(const float* __restrict__ zs, const float* x,
                                         const float* w, const float* v, float* hv,
                                         float corr, int n, bool vec4, float* red) {
  __syncthreads();
  matvec(zs, v, hv, n, vec4);
  __syncthreads();
  float s[2] = {0.f, 0.f};
  for (int i = threadIdx.x; i < n; i += kThreads) {
    s[0] += x[i] * hv[i];
    s[1] += x[i] * (w[i] * v[i]);
  }
  block_sum<kWarps, kMaxSums>(s, red);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float bar = w[i] * v[i];
    hv[i] = -2.f * (hv[i] - x[i] * s[0]) + corr * v[i] + (bar - x[i] * s[1]);
  }
}

__device__ __forceinline__ float safe_div(float a, float b) { return a / (b == 0.f ? 1.f : b); }

// One CTA per lane: that lane's whole tCG loop, the stop logic of
// _tcg_kernel (pallas_kernels.py) and ops/tcg.py::truncated_cg.  A lane
// leaves its loop when it stops, which is the freeze of the batched TPU
// kernel: its outputs are its values at the step it stopped, and its
// iteration count is its own j.  Shared memory: 8 n floats.
__global__ void __launch_bounds__(kThreads)
tcg_kernel(const float* __restrict__ zs, const float* __restrict__ xs,
           const float* __restrict__ ws, const float* __restrict__ grads,
           const float* __restrict__ corrs, const float* __restrict__ radii,
           const float* __restrict__ targets, const float* __restrict__ flags,
           float* __restrict__ etas, float* __restrict__ hetas, int* __restrict__ stats,
           int n, int maxinner, int mininner, int vec4) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kRedSlots];
  const int lane_id = blockIdx.x;
  const size_t off = (size_t)lane_id * n;
  float* x = smem;
  float* w = x + n;
  float* g = w + n;
  float* eta = g + n;
  float* heta = eta + n;
  float* r = heta + n;
  float* delta = r + n;
  float* hd = delta + n;

  const float corr = corrs[lane_id];
  const float radius = radii[lane_id];
  const float rad2 = radius * radius;
  const float target = targets[lane_id];
  const bool linear = flags[lane_id] > 0.f;

  float s0[1] = {0.f};
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float gi = grads[off + i];
    x[i] = xs[off + i];
    w[i] = ws[off + i];
    g[i] = gi;
    eta[i] = 0.f;
    heta[i] = 0.f;
    r[i] = gi;
    delta[i] = -gi;
    s0[0] += gi * gi;
  }
  block_sum<kWarps, kMaxSums>(s0, red);

  float z_r = s0[0], e_pe = 0.f, d_pd = z_r, e_pd = 0.f, model = 0.f;
  int j = 0, code = 0;
  bool done = false;
  while (!done && j < maxinner) {
    apply_hw(zs, x, w, delta, hd, corr, n, vec4, red);
    float s1[1] = {0.f};
    for (int i = threadIdx.x; i < n; i += kThreads) s1[0] += delta[i] * hd[i];
    block_sum<kWarps, kMaxSums>(s1, red);
    const float d_hd = s1[0];
    const float alpha = safe_div(z_r, d_hd);
    const float e_pe_new = e_pe + 2.f * alpha * e_pd + alpha * alpha * d_pd;
    const bool bail = d_hd <= 0.f || e_pe_new >= rad2;
    const float disc = fmaxf(e_pd * e_pd + d_pd * (rad2 - e_pe), 0.f);
    const float tau = safe_div(-e_pd + sqrtf(disc), d_pd);

    // model at the accepted CG point, and |r_new|^2, in one reduction
    float s3[3] = {0.f, 0.f, 0.f};
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float ec = eta[i] + alpha * delta[i];
      const float hc = heta[i] + alpha * hd[i];
      const float rn = r[i] + alpha * hd[i];
      s3[0] += ec * g[i];
      s3[1] += ec * hc;
      s3[2] += rn * rn;
    }
    block_sum<kWarps, kMaxSums>(s3, red);
    const float model_c = s3[0] + 0.5f * s3[1];
    const bool model_inc = model_c >= model;
    const float zr_new = s3[2];
    const bool hit = (j + 1 > mininner) && sqrtf(zr_new) <= target;
    const float beta = safe_div(zr_new, z_r);
    const bool done_now = bail || model_inc || hit;
    code = bail ? (d_hd <= 0.f ? 1 : 2) : model_inc ? 3 : hit ? (linear ? 4 : 5) : 0;

    // eta/Heta: boundary point on bail, kept on model increase, else the
    // CG point; then r_new and delta_new = P(-r_new + beta delta).
    float s4[1] = {0.f};
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float d = delta[i], h = hd[i];
      if (bail) {
        eta[i] += tau * d;
        heta[i] += tau * h;
      } else if (!model_inc) {
        eta[i] += alpha * d;
        heta[i] += alpha * h;
      }
      const float rn = r[i] + alpha * h;
      r[i] = rn;
      const float t = -rn + beta * d;
      delta[i] = t;
      s4[0] += x[i] * t;
    }
    block_sum<kWarps, kMaxSums>(s4, red);
    for (int i = threadIdx.x; i < n; i += kThreads) delta[i] -= x[i] * s4[0];

    if (!done_now) {
      e_pd = beta * (e_pd + alpha * d_pd);
      d_pd = zr_new + beta * beta * d_pd;
      e_pe = e_pe_new;
      z_r = zr_new;
      model = model_c;
    }
    ++j;
    done = done_now;
  }
  for (int i = threadIdx.x; i < n; i += kThreads) {
    etas[off + i] = eta[i];
    hetas[off + i] = heta[i];
  }
  if (threadIdx.x == 0) {
    stats[2 * lane_id] = j;
    stats[2 * lane_id + 1] = code;
  }
}

}  // namespace

extern "C" {

int sphere_tcg_launch(const float* zs, const float* xs, const float* ws, const float* grads,
                      const float* corrs, const float* radii, const float* targets,
                      const float* flags, float* etas, float* hetas, int* stats, int b,
                      int n, int maxinner, int mininner, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = 8 * (size_t)n * sizeof(float);
  err = allow_smem(tcg_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec4 = (n % 4 == 0) && aligned16(zs);
  tcg_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      zs, xs, ws, grads, corrs, radii, targets, flags, etas, hetas, stats, n, maxinner,
      mininner, vec4);
  return (int)cudaGetLastError();
}

const char* sphere_tcg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
