// Hand-written Hopper (sm_90a) kernels for two chains of normalised matvecs.
//
//   chain_left_kernel,    replace riptrm_tpu/ops/pallas_kernels.py::bare_matvec_chain
//   chain_right_kernel    (_bare_chain_kernel, K5): n_iters passes of v <- v @ Z
//                         (left, v [r, n]) or v <- Z @ v (right, v [n, c]), each
//                         row (left) or column (right) then divided by
//                         sqrt(sum w^2 + 1e-30).  Nothing else: it is the
//                         roofline's speed-of-light denominator for the tCG
//                         kernels (riptrm_torch/experiment/roofline.py).
//   chain_hbm_kernel      replaces chained_barrier_matvec_hbm (_chain_hbm_kernel,
//                         K6): K1's function (chain_kernel in sphere_tcg.cu),
//                         n_iters normalised applications of the sphere barrier
//                         Hessian Hw(v) = -2 P(Zs v) + corr v + P(w o v), for an n
//                         whose Zs does not fit near one SM.
//
// Both kernels take Z transposed (zt, row-major Z'), which the wrapper makes
// once per call; the tCG kernels' Zs is symmetric, so there zt = Zs and the
// reads below are exactly theirs.
//
// K5.  What bounds it: the product, 2 r n^2 (left) or 2 n^2 c (right) FMA
// flops per pass, read from L2 or shared memory as the tCG kernels read it;
// the chains are independent, so a CTA runs whole chains and needs no
// grid-wide step.  Left: one CTA per row of v, v and w in shared memory, zt
// streamed from L2 with coalesced 16-byte loads, one warp per output entry
// (tcg_kernel's matvec, sphere_tcg.cu).  Such a matvec waits on L2 latency,
// so each lane issues a row's loads before its FMAs (rows_dot): from a
// plainly unrolled loop nvcc issued the later loads only after the FMAs on
// the first, where its schedule of tcg_kernel issues them together, and a
// pass at n = 1000 cost more than a whole tCG iteration (PERF.md).
// Right: one CTA per group of g columns; zt in shared memory when it fits
// with the group (4 (n^2 + 2 n g) bytes: 64 KB at n = 128, g = 8), else
// read through L2; a thread owns a row and a chunk of the group's columns
// in registers, so each zt entry feeds up to MAXK FMAs (stiefel_tcg_kernel's
// product, stiefel_tcg.cu).  Every precision accumulates in FP32 with FMA on
// the CUDA cores; 'high' and
// 'default' round the operands as the TPU does: 'high' is the bf16x3 split
// hi*hi + hi*lo + lo*hi, 'default' one product of bf16-rounded operands.
// That rounding defines the function the JAX package times.  Each CTA's
// reductions run in a fixed order (no atomics).
//
// K6.  What bounds it: the bytes of Zs, n^2 * 4 per iteration (64 MB at
// n = 4000, above the 50 MB L2), read from device memory.  K1 is one CTA and
// would pull all of it through one SM, so K6 spreads Zs's rows over a
// cooperative grid of G co-resident CTAs (at most the occupancy times the SM
// count), each streaming its contiguous slice of rows with 16-byte loads,
// one warp per row.  An iteration has two grid-wide steps
// (cooperative_groups::this_grid().sync(), launched with
// cudaLaunchCooperativeKernel; no -rdc needed):
//   1. each CTA loads v (n floats) into shared memory, computes its rows of
//      Zs v and the partial sums x.(Zs v) and x.(w o v);  -- grid sync --
//   2. every CTA sums the [G] partials in one fixed order (so all CTAs get
//      the same bits, with no atomics), forms Hw(v) on its rows, writes them
//      to a global vector and its partial |Hw(v)|^2;  -- grid sync --
// and the next iteration's load divides by the norm summed the same way.
// The global vector needs no second buffer: it is read only before the
// first grid step of the next iteration and written only after it.  Data
// written by other CTAs is read with __ldcg (L2, never a stale L1 line).
// A cooperative launch larger than co-residency is refused; the launcher
// returns that error and the wrapper raises.
//
// Plain C interface for ctypes (riptrm_torch/ops/_build.py): each launcher
// returns cudaGetLastError() (or the launch's error) after the launch, 0 on
// success.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;  // left chain and K6
constexpr int kWarps = kThreads / 32;
constexpr int kRightThreads = 256;  // ops/kernels.py::MATVEC_RIGHT_THREADS
constexpr int kLoads = 8;  // float4 loads a lane has in flight per row (rows_dot)
constexpr int kMaxSums = 2;
constexpr int kRedSlots = kMaxSums * kWarps + kMaxSums;
enum Precision { kHighest = 0, kHigh = 1, kDefault = 2 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sums N per-thread partials over a block of kThreads; every thread gets
// the same bits back (read from shared memory after a barrier).
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* red) {
  static_assert(N <= kMaxSums, "too many sums");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    v[k] = warp_sum(v[k]);
    if (lane == 0) red[k * kWarps + warp] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float t = warp_sum(lane < kWarps ? red[k * kWarps + lane] : 0.f);
      if (lane == 0) red[kMaxSums * kWarps + k] = t;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = red[kMaxSums * kWarps + k];
}

__device__ __forceinline__ float bf16_round(float a) {
  return __bfloat162float(__float2bfloat16_rn(a));
}

// A Z entry split once for the precision: (z, 0) for 'highest', (bf16(z),
// 0) for 'default', (hi, lo) of the bf16x3 split for 'high'.
template <int PREC>
__device__ __forceinline__ void split(float z, float& hi, float& lo) {
  if (PREC == kHighest) {
    hi = z;
    lo = 0.f;
  } else {
    hi = bf16_round(z);
    lo = PREC == kHigh ? bf16_round(z - hi) : 0.f;
  }
}

// acc + z * v in the precision's arithmetic, FP32 accumulation.
template <int PREC>
__device__ __forceinline__ float mac(float zh, float zl, float v, float acc) {
  if (PREC == kHighest) return fmaf(zh, v, acc);
  const float vh = bf16_round(v);
  if (PREC == kDefault) return fmaf(zh, vh, acc);
  const float vl = bf16_round(v - vh);
  return fmaf(zl, vh, fmaf(zh, vl, fmaf(zh, vh, acc)));
}

template <int PREC>
__device__ __forceinline__ float mac4(float4 z, float4 v, float acc) {
  float h, l;
  split<PREC>(z.x, h, l);
  acc = mac<PREC>(h, l, v.x, acc);
  split<PREC>(z.y, h, l);
  acc = mac<PREC>(h, l, v.y, acc);
  split<PREC>(z.z, h, l);
  acc = mac<PREC>(h, l, v.z, acc);
  split<PREC>(z.w, h, l);
  return mac<PREC>(h, l, v.w, acc);
}

// out[k] = sum_j zt[(row0 + k) * n + j] * v[j] for k < rows, one warp per
// output entry; v in shared memory, zt read through L2 (float4 when vec4).
// A warp's row is a chain of L2 round trips, so a lane issues its next
// kLoads float4 loads of the row before the FMAs that use them (one round
// trip per row up to n = 1024).  The sum runs in the same order as a plain
// `c += 32` loop.
template <int PREC>
__device__ __forceinline__ void rows_dot(const float* __restrict__ zt, const float* v, float* out,
                                         int row0, int rows, int n, bool vec4) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k = warp; k < rows; k += kWarps) {
    const float* zr = zt + (size_t)(row0 + k) * n;
    float acc = 0.f;
    if (vec4) {
      const float4* z4 = reinterpret_cast<const float4*>(zr);
      const float4* v4 = reinterpret_cast<const float4*>(v);
      const int n4 = n >> 2;
      for (int c0 = lane; c0 < n4; c0 += 32 * kLoads) {
        float4 zb[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int c = c0 + 32 * u;
          zb[u] = c < n4 ? __ldg(z4 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int c = c0 + 32 * u;
          if (c < n4) acc = mac4<PREC>(zb[u], v4[c], acc);
        }
      }
    } else {
#pragma unroll 4
      for (int c = lane; c < n; c += 32) {
        float h, l;
        split<PREC>(__ldg(zr + c), h, l);
        acc = mac<PREC>(h, l, v[c], acc);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) out[k] = acc;
  }
}

// K5, left: one CTA per row of v.  Shared memory: v and w, 2 n floats.
template <int PREC>
__global__ void __launch_bounds__(kThreads)
chain_left_kernel(const float* __restrict__ zt, const float* __restrict__ v0,
                  float* __restrict__ out, int n, int n_iters, int vec4) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kRedSlots];
  float* v = smem;
  float* w = v + n;
  const size_t off = (size_t)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += kThreads) v[i] = v0[off + i];
  for (int it = 0; it < n_iters; ++it) {
    __syncthreads();
    rows_dot<PREC>(zt, v, w, 0, n, n, vec4);  // w = v @ Z
    __syncthreads();
    float s[1] = {0.f};
    for (int i = threadIdx.x; i < n; i += kThreads) s[0] += w[i] * w[i];
    block_sum(s, red);
    const float nrm = sqrtf(s[0] + 1e-30f);
    for (int i = threadIdx.x; i < n; i += kThreads) v[i] = w[i] / nrm;
  }
  for (int i = threadIdx.x; i < n; i += kThreads) out[off + i] = v[i];
}

// K5, right: one CTA per group of g columns of v [n, c].  Shared memory:
// [zt, n^2 floats, when zs_shared] V [n, g], W [n, g], the g column norms.
// Task (i, q) owns row i and columns [q kc, q kc + kc) of the group.
template <int PREC, int MAXK>
__global__ void __launch_bounds__(kRightThreads)
chain_right_kernel(const float* __restrict__ zt, const float* __restrict__ v0,
                   float* __restrict__ out, int n, int c, int g, int n_iters, int zs_shared,
                   int groups, int kc) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float part[kRightThreads];
  const int col0 = blockIdx.x * g;
  const int gw = min(g, c - col0);  // live columns of this group
  float* cur = smem;
  const float* Z = zt;
  if (zs_shared) {
    for (int i = threadIdx.x; i < n * n; i += kRightThreads) cur[i] = zt[i];
    Z = cur;
    cur += (size_t)n * n;
  }
  float* V = cur;
  float* W = V + (size_t)n * g;
  float* norms = W + (size_t)n * g;
  for (int idx = threadIdx.x; idx < n * g; idx += kRightThreads) {
    const int i = idx / g, k = idx % g;
    V[idx] = k < gw ? v0[(size_t)i * c + col0 + k] : 0.f;
  }
  const int segs = kRightThreads / g > 0 ? kRightThreads / g : 1;
  for (int it = 0; it < n_iters; ++it) {
    __syncthreads();
    for (int t = threadIdx.x; t < n * groups; t += kRightThreads) {
      const int i = t % n, k0 = (t / n) * kc;
      const int cols = min(kc, gw - k0);
      float acc[MAXK];
#pragma unroll
      for (int q = 0; q < MAXK; ++q) acc[q] = 0.f;
      for (int j = 0; j < n; ++j) {
        float h, l;
        split<PREC>(Z[(size_t)j * n + i], h, l);  // zt[j, i] = Z[i, j]
        const float* vj = V + (size_t)j * g + k0;
#pragma unroll
        for (int q = 0; q < MAXK; ++q)
          if (q < cols) acc[q] = mac<PREC>(h, l, vj[q], acc[q]);
      }
#pragma unroll
      for (int q = 0; q < MAXK; ++q)
        if (q < cols) W[(size_t)i * g + k0 + q] = acc[q];
    }
    __syncthreads();
    // column sums of squares: `segs` interleaved row segments per column,
    // then each column's segments in order
    for (int t = threadIdx.x; t < g * segs; t += kRightThreads) {
      const int k = t % g, s = t / g;
      float acc = 0.f;
      if (k < gw)
        for (int i = s; i < n; i += segs) acc = fmaf(W[(size_t)i * g + k], W[(size_t)i * g + k], acc);
      part[t] = acc;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < g; k += kRightThreads) {
      float acc = 0.f;
      for (int s = 0; s < segs; ++s) acc += part[s * g + k];
      norms[k] = sqrtf(acc + 1e-30f);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < n * g; idx += kRightThreads)
      if (idx % g < gw) V[idx] = W[idx] / norms[idx % g];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < n * gw; idx += kRightThreads) {
    const int i = idx / gw, k = idx % gw;
    out[(size_t)i * c + col0 + k] = V[(size_t)i * g + k];
  }
}

// Sum over the G CTAs' partials (part[b * N + k]) in one fixed order: lane
// l of warp 0 takes b = l, l + 32, ..., then a fixed shuffle tree.  Every
// CTA gets the same bits.  Opens and closes with a barrier.
template <int N>
__device__ __forceinline__ void grid_total(const float* part, int nb, float (&t)[N], float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float acc = 0.f;
      for (int b = lane; b < nb; b += 32) acc += __ldcg(part + (size_t)b * N + k);
      acc = warp_sum(acc);
      if (lane == 0) red[kMaxSums * kWarps + k] = acc;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) t[k] = red[kMaxSums * kWarps + k];
  __syncthreads();
}

// K6: a cooperative grid; CTA b owns rows [b rows_per_cta, ...) of Zs.
// Shared memory: v (n floats) and the CTA's rows of Zs v / Hw(v).
// Scratch: hv_g [n] (Hw(v) of the last iteration), partial [3 G] (x.zv and
// x.(w o v) per CTA, then |hv|^2 per CTA).
__global__ void __launch_bounds__(kThreads)
chain_hbm_kernel(const float* __restrict__ zs, const float* __restrict__ x_g,
                 const float* __restrict__ w_g, const float* __restrict__ v0,
                 const float* __restrict__ corr_g, float* hv_g, float* partial,
                 float* __restrict__ out, int n, int n_iters, int rows_per_cta, int vec4) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kRedSlots];
  const int nb = gridDim.x;
  const int row0 = blockIdx.x * rows_per_cta;
  const int rows = max(0, min(n, row0 + rows_per_cta) - row0);
  float* v = smem;
  float* hv = v + n;
  float* dots = partial;         // [G, 2]
  float* sq = partial + 2 * nb;  // [G]
  const float corr = corr_g[0];
  float nrm = 1.f;
  for (int it = 0; it < n_iters; ++it) {
    if (it == 0) {
      for (int i = threadIdx.x; i < n; i += kThreads) v[i] = v0[i];
    } else {
      float t[1];
      grid_total(sq, nb, t, red);
      nrm = sqrtf(t[0]);
      for (int i = threadIdx.x; i < n; i += kThreads) v[i] = __ldcg(hv_g + i) / nrm;
    }
    __syncthreads();
    rows_dot<kHighest>(zs, v, hv, row0, rows, n, vec4);  // Zs v on the CTA's rows
    __syncthreads();
    float s[2] = {0.f, 0.f};
    for (int k = threadIdx.x; k < rows; k += kThreads) {
      const int i = row0 + k;
      s[0] += x_g[i] * hv[k];
      s[1] += x_g[i] * (w_g[i] * v[i]);
    }
    block_sum(s, red);
    if (threadIdx.x == 0) {
      dots[2 * blockIdx.x] = s[0];
      dots[2 * blockIdx.x + 1] = s[1];
    }
    grid.sync();
    float tot[2];
    grid_total(dots, nb, tot, red);
    float s2[1] = {0.f};
    for (int k = threadIdx.x; k < rows; k += kThreads) {
      const int i = row0 + k;
      const float xi = x_g[i], vi = v[i];
      const float h = -2.f * (hv[k] - xi * tot[0]) + corr * vi + (w_g[i] * vi - xi * tot[1]);
      hv[k] = h;
      hv_g[i] = h;
      s2[0] += h * h;
    }
    block_sum(s2, red);
    if (threadIdx.x == 0) sq[blockIdx.x] = s2[0];
    grid.sync();
  }
  if (n_iters == 0) {
    for (int k = threadIdx.x; k < rows; k += kThreads) out[row0 + k] = v0[row0 + k];
    return;
  }
  float t[1];
  grid_total(sq, nb, t, red);
  nrm = sqrtf(t[0]);
  for (int k = threadIdx.x; k < rows; k += kThreads) out[row0 + k] = hv[k] / nrm;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <int PREC>
cudaError_t launch_left(const float* zt, const float* v0, float* out, int r, int n, int n_iters,
                        cudaStream_t stream) {
  const size_t smem = 2 * (size_t)n * sizeof(float);
  const cudaError_t err = allow_smem(chain_left_kernel<PREC>, smem);
  if (err != cudaSuccess) return err;
  const int vec4 = (n % 4 == 0) && aligned16(zt);
  chain_left_kernel<PREC><<<r, kThreads, smem, stream>>>(zt, v0, out, n, n_iters, vec4);
  return cudaGetLastError();
}

template <int PREC, int MAXK>
cudaError_t launch_right(const float* zt, const float* v0, float* out, int n, int c, int g,
                         int n_iters, int zs_shared, int groups, int kc, cudaStream_t stream) {
  size_t floats = 2 * (size_t)n * g + g;
  if (zs_shared) floats += (size_t)n * n;
  const size_t smem = floats * sizeof(float);
  auto kernel = chain_right_kernel<PREC, MAXK>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(c + g - 1) / g, kRightThreads, smem, stream>>>(zt, v0, out, n, c, g, n_iters,
                                                           zs_shared, groups, kc);
  return cudaGetLastError();
}

template <int PREC>
cudaError_t launch_right_k(const float* zt, const float* v0, float* out, int n, int c, int g,
                           int n_iters, int zs_shared, cudaStream_t stream) {
  // Split a row's g columns over `groups` threads when the rows alone leave
  // threads idle; each thread keeps kc <= MAXK columns (stiefel_tcg.cu).
  const int max_k = 32;
  int groups = n < kRightThreads ? kRightThreads / n : 1;
  if (groups > g) groups = g;
  if (groups < (g + max_k - 1) / max_k) groups = (g + max_k - 1) / max_k;
  const int kc = (g + groups - 1) / groups;
  groups = (g + kc - 1) / kc;
  if (kc <= 4) return launch_right<PREC, 4>(zt, v0, out, n, c, g, n_iters, zs_shared, groups, kc, stream);
  if (kc <= 8) return launch_right<PREC, 8>(zt, v0, out, n, c, g, n_iters, zs_shared, groups, kc, stream);
  if (kc <= 16) return launch_right<PREC, 16>(zt, v0, out, n, c, g, n_iters, zs_shared, groups, kc, stream);
  return launch_right<PREC, 32>(zt, v0, out, n, c, g, n_iters, zs_shared, groups, kc, stream);
}

size_t hbm_smem(int n, int rows_per_cta) { return ((size_t)n + rows_per_cta) * sizeof(float); }

}  // namespace

extern "C" {

// K5, left: v0 and out [r, n]; prec 0 'highest', 1 'high', 2 'default'.
int matvec_chain_left_launch(const float* zt, const float* v0, float* out, int r, int n,
                             int n_iters, int prec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (prec == kHighest) return (int)launch_left<kHighest>(zt, v0, out, r, n, n_iters, st);
  if (prec == kHigh) return (int)launch_left<kHigh>(zt, v0, out, r, n, n_iters, st);
  if (prec == kDefault) return (int)launch_left<kDefault>(zt, v0, out, r, n, n_iters, st);
  return (int)cudaErrorInvalidValue;
}

// K5, right: v0 and out [n, c], groups of g columns; zs_shared as
// ops/kernels.py::matvec_right_plan decides.
int matvec_chain_right_launch(const float* zt, const float* v0, float* out, int n, int c, int g,
                              int n_iters, int prec, int zs_shared, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (g < 1 || g > c || g > kRightThreads) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (prec == kHighest) return (int)launch_right_k<kHighest>(zt, v0, out, n, c, g, n_iters, zs_shared, st);
  if (prec == kHigh) return (int)launch_right_k<kHigh>(zt, v0, out, n, c, g, n_iters, zs_shared, st);
  if (prec == kDefault) return (int)launch_right_k<kDefault>(zt, v0, out, n, c, g, n_iters, zs_shared, st);
  return (int)cudaErrorInvalidValue;
}

// K6's grid: the co-resident capacity (occupancy times SMs), cut so each
// warp has at least one row.  Returns G > 0, or minus a CUDA error code.
int chain_hbm_grid(int n, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  const size_t smem = hbm_smem(n, n);  // the most any grid needs
  err = allow_smem(chain_hbm_kernel, smem);
  if (err != cudaSuccess) return -(int)err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chain_hbm_kernel, kThreads, smem);
  if (err != cudaSuccess) return -(int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -(int)err;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  int g = per_sm * sms;
  const int by_rows = (n + kWarps - 1) / kWarps;
  if (g > by_rows) g = by_rows;
  const int rows_per_cta = (n + g - 1) / g;
  return (n + rows_per_cta - 1) / rows_per_cta;
}

// K6 on a grid of `grid` CTAs: hv_g [n] and partial [3 grid] are scratch.
int chain_hbm_launch(const float* zs, const float* x, const float* w, const float* v0,
                     const float* corr, float* hv_g, float* partial, float* out, int n,
                     int n_iters, int grid, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (grid < 1) return (int)cudaErrorInvalidValue;
  int rows_per_cta = (n + grid - 1) / grid;
  const size_t smem = hbm_smem(n, rows_per_cta);
  err = allow_smem(chain_hbm_kernel, hbm_smem(n, n));
  if (err != cudaSuccess) return (int)err;
  int vec4 = (n % 4 == 0) && aligned16(zs);
  void* args[] = {(void*)&zs, (void*)&x, (void*)&w, (void*)&v0, (void*)&corr, (void*)&hv_g,
                  (void*)&partial, (void*)&out, (void*)&n, (void*)&n_iters,
                  (void*)&rows_per_cta, (void*)&vec4};
  err = cudaLaunchCooperativeKernel((const void*)chain_hbm_kernel, dim3(grid), dim3(kThreads),
                                    args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the refusal is reported here, not later
    return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
