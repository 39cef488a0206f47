// Hand-written Hopper (sm_90a) kernel for the Stiefel-bound barrier
// subproblem of RIPTRM on BoundedPCA: minimise -tr(X'Zs X D) on St(n, p)
// subject to |X_ij| <= bound.
//
// With P(U) = U - X sym(X'U), the barrier weights W and the Lagrangian
// curvature block S = sym(X'E) (both computed outside, as the JAX package
// does in _stiefel_bound_pieces), the condensed barrier Hessian is
//
//     Hw(V) = P(-2 (Zs V) diag(d) - V S + W o V).
//
//   stiefel_tcg_kernel  replaces both riptrm_tpu/ops/pallas_kernels.py
//                       ::pallas_tcg_stiefel_bound_batched (_tcg_kernel_stiefel,
//                       lane-major) and ::pallas_tcg_stiefel_bound_batched_pmajor
//                       (_tcg_kernel_stiefel_pmajor, p-major).  The two TPU
//                       kernels compute one function, the loop
//                       _stiefel_tcg_loop (= ops/tcg.py::truncated_cg), in two
//                       layouts chosen for the TPU's vector unit; this kernel
//                       computes that function once, one CTA per lane.
//
// What bounds it on an H100: the product Zs V, 2 n^2 p flops per tCG
// iteration and lane, in full float32 FMA on the CUDA cores (no TF32, no
// bf16 splitting: the BoundedPCA inner loop never meets its complementarity
// criterion at TF32-class matvec noise).  At St(128, 8) Zs (64 KB) and the
// lane's 8 frames (32 KB) sit in one CTA's shared memory, so an iteration
// reads nothing from L2; Zs is read column-wise (Zs is symmetric), which
// keeps a warp's 32 reads on 32 banks.  Where they do not fit, Zs is read
// through L2 and then the frames go to a global scratch tensor (St(512, 32):
// Zs 1 MB, 8 frames 512 KB); the wrapper picks the placement
// (ops/kernels.py::stiefel_smem_plan) and the same code runs on generic
// pointers.  Each thread owns one row of Zs V and a chunk of at most MAXK of
// its columns in registers, so each Zs entry it loads feeds MAXK FMAs.  The
// per-lane reductions (the p x p matrix X'U and the Frobenius dots) are
// block reductions (reduce.cuh) read back by every thread from shared
// memory after a barrier, so every thread takes the same loop exit; a lane
// leaves its loop when it stops, which gives the outputs of the TPU
// kernels' frozen lanes.
//
// Plain C interface for ctypes (riptrm_torch/ops/_build.py): the launcher
// returns cudaGetLastError() after the launch, 0 on success.

#include <cuda_runtime.h>

#include "reduce.cuh"

namespace {

constexpr int kThreads = 256;  // ops/kernels.py::STIEFEL_THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSums = 3;
constexpr int kRedSlots = kMaxSums * kWarps + kMaxSums;
enum Placement { kAllShared = 0, kZsGlobal = 1, kFramesGlobal = 2 };

__device__ __forceinline__ float safe_div(float a, float b) { return a / (b == 0.f ? 1.f : b); }

// out = -2 (Zs V) diag(d) - V S + W o V, the part of Hw before the
// projection.  Task (i, g) owns row i and columns [g*kc, g*kc + kc) of the
// output, accumulated in registers over j.  Opens with a barrier, so the
// caller may just have written V.
template <int MAXK>
__device__ __forceinline__ void hw_unprojected(const float* Z, const float* V, const float* W,
                                               const float* S, const float* d, float* out,
                                               int n, int p, int groups, int kc) {
  __syncthreads();
  for (int t = threadIdx.x; t < n * groups; t += kThreads) {
    const int i = t % n, k0 = (t / n) * kc;
    const int cols = min(kc, p - k0);
    float acc[MAXK];
#pragma unroll
    for (int c = 0; c < MAXK; ++c) acc[c] = 0.f;
    for (int j = 0; j < n; ++j) {
      const float z = Z[(size_t)j * n + i];  // Zs[i, j] by symmetry
      const float* vj = V + (size_t)j * p + k0;
#pragma unroll
      for (int c = 0; c < MAXK; ++c)
        if (c < cols) acc[c] = fmaf(z, vj[c], acc[c]);
    }
    const float* vi = V + (size_t)i * p;
#pragma unroll
    for (int c = 0; c < MAXK; ++c) {
      if (c < cols) {
        const int k = k0 + c;
        float vs = 0.f;
        for (int l = 0; l < p; ++l) vs = fmaf(vi[l], S[l * p + k], vs);
        out[(size_t)i * p + k] = -2.f * acc[c] * d[k] - vs + W[(size_t)i * p + k] * vi[k];
      }
    }
  }
}

// U <- U - X sym(X'U) in place.  C = X'U is summed in `segs` interleaved
// row segments per entry (partials in `part`, p^2 * segs floats), then
// reduced into `cm`.  Opens with a barrier; afterwards each thread owns
// U[idx] for idx = threadIdx.x + k * kThreads.
__device__ __forceinline__ void project(float* U, const float* X, float* cm, float* part, int n,
                                        int p, int segs) {
  __syncthreads();
  const int pp = p * p;
  for (int t = threadIdx.x; t < pp * segs; t += kThreads) {
    const int ab = t % pp, s = t / pp;
    const int a = ab / p, b = ab % p;
    float acc = 0.f;
    for (int i = s; i < n; i += segs) acc = fmaf(X[(size_t)i * p + a], U[(size_t)i * p + b], acc);
    part[t] = acc;
  }
  __syncthreads();
  for (int ab = threadIdx.x; ab < pp; ab += kThreads) {
    float acc = 0.f;
    for (int s = 0; s < segs; ++s) acc += part[s * pp + ab];
    cm[ab] = acc;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < n * p; idx += kThreads) {
    const int i = idx / p, k = idx % p;
    const float* xi = X + (size_t)i * p;
    float acc = U[idx];
    for (int a = 0; a < p; ++a) acc -= xi[a] * (0.5f * (cm[a * p + k] + cm[k * p + a]));
    U[idx] = acc;
  }
}

// One CTA per lane: the lane's whole tCG loop, the stop logic of
// _stiefel_tcg_loop and ops/tcg.py::truncated_cg (codes 0-5, the boundary
// step, the model-increase check, mininner).
template <int MAXK>
__global__ void __launch_bounds__(kThreads)
stiefel_tcg_kernel(const float* __restrict__ zs, const float* __restrict__ dg,
                   const float* __restrict__ xs, const float* __restrict__ ws,
                   const float* __restrict__ ss, const float* __restrict__ grads,
                   const float* __restrict__ radii, const float* __restrict__ targets,
                   const float* __restrict__ flags, float* __restrict__ etas,
                   float* __restrict__ hetas, int* __restrict__ stats, float* scratch, int n,
                   int p, int maxinner, int mininner, int mode, int segs, int groups, int kc) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kRedSlots];
  const int lane_id = blockIdx.x;
  const int np = n * p, pp = p * p;
  const size_t off = (size_t)lane_id * np;

  // Carve the working set: [Zs] [8 frames] S, C, partials, d.
  float* cur = smem;
  const float* Z = zs;
  if (mode == kAllShared) {
    for (int i = threadIdx.x; i < n * n; i += kThreads) cur[i] = zs[i];
    Z = cur;
    cur += (size_t)n * n;
  }
  float* frames;
  if (mode == kFramesGlobal) {
    frames = scratch + (size_t)lane_id * 8 * np;
  } else {
    frames = cur;
    cur += (size_t)8 * np;
  }
  float* S = cur;
  float* cm = S + pp;
  float* part = cm + pp;
  float* d = part + (size_t)pp * segs;
  float* x = frames;
  float* w = x + np;
  float* g = w + np;
  float* eta = g + np;
  float* heta = eta + np;
  float* r = heta + np;
  float* delta = r + np;
  float* hd = delta + np;

  const float radius = radii[lane_id];
  const float rad2 = radius * radius;
  const float target = targets[lane_id];
  const bool linear = flags[lane_id] > 0.f;

  float s0[1] = {0.f};
  for (int idx = threadIdx.x; idx < np; idx += kThreads) {
    const float gi = grads[off + idx];
    x[idx] = xs[off + idx];
    w[idx] = ws[off + idx];
    g[idx] = gi;
    eta[idx] = 0.f;
    heta[idx] = 0.f;
    r[idx] = gi;
    delta[idx] = -gi;
    s0[0] += gi * gi;
  }
  for (int idx = threadIdx.x; idx < pp; idx += kThreads) S[idx] = ss[(size_t)lane_id * pp + idx];
  for (int k = threadIdx.x; k < p; k += kThreads) d[k] = dg[k];
  block_sum<kWarps, kMaxSums>(s0, red);  // its barriers also publish the loads above

  float z_r = s0[0], e_pe = 0.f, d_pd = z_r, e_pd = 0.f, model = 0.f;
  int j = 0, code = 0;
  bool done = false;
  while (!done && j < maxinner) {
    hw_unprojected<MAXK>(Z, delta, w, S, d, hd, n, p, groups, kc);
    project(hd, x, cm, part, n, p, segs);
    float s1[1] = {0.f};
    for (int idx = threadIdx.x; idx < np; idx += kThreads) s1[0] += delta[idx] * hd[idx];
    block_sum<kWarps, kMaxSums>(s1, red);
    const float d_hd = s1[0];
    const float alpha = safe_div(z_r, d_hd);
    const float e_pe_new = e_pe + 2.f * alpha * e_pd + alpha * alpha * d_pd;
    const bool bail = d_hd <= 0.f || e_pe_new >= rad2;
    const float disc = fmaxf(e_pd * e_pd + d_pd * (rad2 - e_pe), 0.f);
    const float tau = safe_div(-e_pd + sqrtf(disc), d_pd);

    // model at the CG point, and |r_new|^2, in one reduction
    float s3[3] = {0.f, 0.f, 0.f};
    for (int idx = threadIdx.x; idx < np; idx += kThreads) {
      const float ec = eta[idx] + alpha * delta[idx];
      const float hc = heta[idx] + alpha * hd[idx];
      const float rn = r[idx] + alpha * hd[idx];
      s3[0] += ec * g[idx];
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
    for (int idx = threadIdx.x; idx < np; idx += kThreads) {
      const float dl = delta[idx], h = hd[idx];
      if (bail) {
        eta[idx] += tau * dl;
        heta[idx] += tau * h;
      } else if (!model_inc) {
        eta[idx] += alpha * dl;
        heta[idx] += alpha * h;
      }
      const float rn = r[idx] + alpha * h;
      r[idx] = rn;
      delta[idx] = -rn + beta * dl;
    }
    project(delta, x, cm, part, n, p, segs);

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
  for (int idx = threadIdx.x; idx < np; idx += kThreads) {
    etas[off + idx] = eta[idx];
    hetas[off + idx] = heta[idx];
  }
  if (threadIdx.x == 0) {
    stats[2 * lane_id] = j;
    stats[2 * lane_id + 1] = code;
  }
}

template <int MAXK>
cudaError_t launch(const float* zs, const float* d, const float* xs, const float* ws,
                   const float* ss, const float* grads, const float* radii, const float* targets,
                   const float* flags, float* etas, float* hetas, int* stats, float* scratch,
                   int b, int n, int p, int maxinner, int mininner, int mode, int segs,
                   int groups, int kc, size_t smem, cudaStream_t stream) {
  auto kernel = stiefel_tcg_kernel<MAXK>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<b, kThreads, smem, stream>>>(zs, d, xs, ws, ss, grads, radii, targets, flags, etas,
                                        hetas, stats, scratch, n, p, maxinner, mininner, mode,
                                        segs, groups, kc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// mode: 0 Zs and the frames in shared memory, 1 the frames there and Zs in
// global memory, 2 the frames in `scratch` ([b, 8, n, p] floats) as well.
int stiefel_tcg_launch(const float* zs, const float* d, const float* xs, const float* ws,
                       const float* ss, const float* grads, const float* radii,
                       const float* targets, const float* flags, float* etas, float* hetas,
                       int* stats, float* scratch, int b, int n, int p, int maxinner,
                       int mininner, int mode, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (mode < kAllShared || mode > kFramesGlobal || (mode == kFramesGlobal && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  // The same layout as ops/kernels.py::stiefel_smem_plan.
  const int pp = p * p;
  const int segs = pp < kThreads ? kThreads / pp : 1;
  size_t floats = (size_t)(2 + segs) * pp + p;
  if (mode != kFramesGlobal) floats += (size_t)8 * n * p;
  if (mode == kAllShared) floats += (size_t)n * n;
  const size_t smem = floats * sizeof(float);
  // Split the p columns of each row of Zs V over `groups` threads when the
  // rows alone leave threads idle; each thread keeps kc <= MAXK columns.
  const int max_k = 32;
  int groups = n < kThreads ? kThreads / n : 1;
  if (groups > p) groups = p;
  if (groups < (p + max_k - 1) / max_k) groups = (p + max_k - 1) / max_k;
  const int kc = (p + groups - 1) / groups;
  groups = (p + kc - 1) / kc;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define STIEFEL_LAUNCH(K)                                                                       \
  launch<K>(zs, d, xs, ws, ss, grads, radii, targets, flags, etas, hetas, stats, scratch, b, n, \
            p, maxinner, mininner, mode, segs, groups, kc, smem, st)
  if (kc <= 4) return (int)STIEFEL_LAUNCH(4);
  if (kc <= 8) return (int)STIEFEL_LAUNCH(8);
  if (kc <= 16) return (int)STIEFEL_LAUNCH(16);
  return (int)STIEFEL_LAUNCH(32);
#undef STIEFEL_LAUNCH
}

}  // extern "C"
