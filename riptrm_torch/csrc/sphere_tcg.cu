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

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "reduce.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSums = 3;
constexpr int kRedSlots = 2 * kMaxSums * kWarps;  // cta_sum's two buffers

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

// hv = -2 P(u) + corr v + P(w o v) from u = Zs v (u read with __ldcg when
// other CTAs wrote it).  Opens with a barrier, so callers may just have
// written v or u; afterwards each thread owns hv[i] for i = threadIdx.x +
// k * kThreads.
template <bool FROM_L2>
__device__ __forceinline__ void form_hw(const float* u, const float* x, const float* w,
                                        const float* v, float* hv, float corr, int n,
                                        float* red) {
  __syncthreads();
  float s[2] = {0.f, 0.f};
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float ui = FROM_L2 ? __ldcg(u + i) : u[i];
    hv[i] = ui;
    s[0] += x[i] * ui;
    s[1] += x[i] * (w[i] * v[i]);
  }
  cta_sum<kWarps, kMaxSums>(s, red, 0);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float bar = w[i] * v[i];
    hv[i] = -2.f * (hv[i] - x[i] * s[0]) + corr * v[i] + (bar - x[i] * s[1]);
  }
}

__device__ __forceinline__ float safe_div(float a, float b) { return a / (b == 0.f ? 1.f : b); }

// A lane's vectors (8 n floats, in shared memory) and its loop's scalars.
struct Lane {
  float *x, *w, *g, *eta, *heta, *r, *delta, *hd;
  __device__ Lane(float* base, int ld)
      : x(base), w(base + ld), g(base + 2 * ld), eta(base + 3 * ld), heta(base + 4 * ld),
        r(base + 5 * ld), delta(base + 6 * ld), hd(base + 7 * ld) {}
};
struct Scalars {
  float z_r, e_pe, d_pd, e_pd, model, rad2, target, corr;
  int j, code, linear, done;
};

// Load lane `b` (x, w, g; eta = Heta = 0, r = g, delta = -g; the pad
// entries [n, ld) zero) and its scalars; every thread gets the same bits.
__device__ __forceinline__ Scalars load_lane(const Lane& L, int b, const float* xs,
                                             const float* ws, const float* grads,
                                             const float* corrs, const float* radii,
                                             float theta, float kappa, int n,
                                             int ld, float* red) {
  const size_t off = (size_t)b * n;
  float s0[1] = {0.f};
  for (int i = threadIdx.x; i < ld; i += kThreads) {
    const bool in = i < n;
    const float gi = in ? grads[off + i] : 0.f;
    L.x[i] = in ? xs[off + i] : 0.f;
    L.w[i] = in ? ws[off + i] : 0.f;
    L.g[i] = gi;
    L.eta[i] = 0.f;
    L.heta[i] = 0.f;
    L.r[i] = gi;
    L.delta[i] = -gi;
    L.hd[i] = 0.f;
    s0[0] += gi * gi;
  }
  cta_sum<kWarps, kMaxSums>(s0, red, 0);
  const float radius = radii[b];
  Scalars S;
  S.z_r = s0[0];
  S.e_pe = 0.f;
  S.d_pd = s0[0];
  S.e_pd = 0.f;
  S.model = 0.f;
  S.rad2 = radius * radius;
  // truncated_cg's target: |r0| min(|r0|^theta, kappa), linear: kappa < |r0|^theta
  const float norm_r0 = sqrtf(s0[0]), powr = powf(norm_r0, theta);
  S.target = norm_r0 * fminf(powr, kappa);
  S.corr = corrs ? corrs[b] : 0.f;  // the resident B = 1 path forms it itself
  S.j = 0;
  S.code = 0;
  S.linear = kappa < powr;
  S.done = 0;
  return S;
}

// One tCG iteration of a lane once hd = Hw(delta) is formed: the stop logic
// of _tcg_kernel (pallas_kernels.py) and ops/tcg.py::truncated_cg.  eta and
// Heta take the boundary point on bail, stay on model increase and take the
// CG point otherwise; then r_new and delta_new = P(-r_new + beta delta).  A
// lane that stops keeps eta and Heta from here on (the freeze of the batched
// TPU kernel).
__device__ __forceinline__ void tcg_update(const Lane& L, Scalars& S, int n, int maxinner,
                                           int mininner, float* red) {
  float s1[1] = {0.f};
  for (int i = threadIdx.x; i < n; i += kThreads) s1[0] += L.delta[i] * L.hd[i];
  cta_sum<kWarps, kMaxSums>(s1, red, 1);
  const float d_hd = s1[0];
  const float alpha = safe_div(S.z_r, d_hd);
  const float e_pe_new = S.e_pe + 2.f * alpha * S.e_pd + alpha * alpha * S.d_pd;
  const bool bail = d_hd <= 0.f || e_pe_new >= S.rad2;
  const float disc = fmaxf(S.e_pd * S.e_pd + S.d_pd * (S.rad2 - S.e_pe), 0.f);
  const float tau = safe_div(-S.e_pd + sqrtf(disc), S.d_pd);

  // model at the accepted CG point, and |r_new|^2, in one reduction
  float s3[3] = {0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float ec = L.eta[i] + alpha * L.delta[i];
    const float hc = L.heta[i] + alpha * L.hd[i];
    const float rn = L.r[i] + alpha * L.hd[i];
    s3[0] += ec * L.g[i];
    s3[1] += ec * hc;
    s3[2] += rn * rn;
  }
  cta_sum<kWarps, kMaxSums>(s3, red, 0);
  const float model_c = s3[0] + 0.5f * s3[1];
  const bool model_inc = model_c >= S.model;
  const float zr_new = s3[2];
  const bool hit = (S.j + 1 > mininner) && sqrtf(zr_new) <= S.target;
  const float beta = safe_div(zr_new, S.z_r);
  const bool done_now = bail || model_inc || hit;
  S.code = bail ? (d_hd <= 0.f ? 1 : 2) : model_inc ? 3 : hit ? (S.linear ? 4 : 5) : 0;

  float s4[1] = {0.f};
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float d = L.delta[i], h = L.hd[i];
    if (bail) {
      L.eta[i] += tau * d;
      L.heta[i] += tau * h;
    } else if (!model_inc) {
      L.eta[i] += alpha * d;
      L.heta[i] += alpha * h;
    }
    const float rn = L.r[i] + alpha * h;
    L.r[i] = rn;
    const float t = -rn + beta * d;
    L.delta[i] = t;
    s4[0] += L.x[i] * t;
  }
  cta_sum<kWarps, kMaxSums>(s4, red, 1);
  for (int i = threadIdx.x; i < n; i += kThreads) L.delta[i] -= L.x[i] * s4[0];

  if (!done_now) {
    S.e_pd = beta * (S.e_pd + alpha * S.d_pd);
    S.d_pd = zr_new + beta * beta * S.d_pd;
    S.e_pe = e_pe_new;
    S.z_r = zr_new;
    S.model = model_c;
  }
  ++S.j;
  S.done = done_now || S.j >= maxinner;
}

// The streaming path: one CTA per lane, Zs read from L2 on every iteration
// (the plan's route above the resident limit, n <= 7232).  Shared memory:
// 8 n floats.
__global__ void __launch_bounds__(kThreads)
tcg_kernel(const float* __restrict__ zs, const float* __restrict__ xs,
           const float* __restrict__ ws, const float* __restrict__ grads,
           const float* __restrict__ corrs, const float* __restrict__ radii,
           float* __restrict__ etas, float* __restrict__ hetas, int* __restrict__ stats,
           int n, int maxinner, int mininner, float theta, float kappa, int vec4) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kRedSlots];
  const int b = blockIdx.x;
  const Lane L(smem, n);
  Scalars S = load_lane(L, b, xs, ws, grads, corrs, radii, theta, kappa, n, n, red);
  S.done = maxinner <= 0;
  while (!S.done) {
    __syncthreads();  // delta written by every thread
    matvec(zs, L.delta, L.hd, n, vec4);
    form_hw<false>(L.hd, L.x, L.w, L.delta, L.hd, S.corr, n, red);
    tcg_update(L, S, n, maxinner, mininner, red);
  }
  const size_t off = (size_t)b * n;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    etas[off + i] = L.eta[i];
    hetas[off + i] = L.heta[i];
  }
  if (threadIdx.x == 0) {
    stats[2 * b] = S.j;
    stats[2 * b + 1] = S.code;
  }
}

// ---------------------------------------------------------------------------
// The resident path: Zs across a cooperative grid
// ---------------------------------------------------------------------------
constexpr int kRowT = 8, kSlotT = 8;  // a warp's tile of u: 8 rows x 8 lanes
constexpr int kTileOut = kRowT * kSlotT;
constexpr int kMaxOwned = 4;          // lanes a CTA owns (ops/kernels.py::TCG_MAX_OWNED)
constexpr int kPart = kWarps * kTileOut;  // one task (tile, segment) per warp

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// The tasks of a CTA's product, u rows x lanes: tile = rows [8 rt, +8) x
// lane slots [8 lt, +8); warp w takes task w = (tile w % ntiles, segment
// w / ntiles of each chunk's float4 columns), ksegs = kWarps / ntiles.
struct Tasks {
  int rtiles, ntiles, ksegs;
  __device__ Tasks(int rtiles_, int nl)
      : rtiles(rtiles_), ntiles(rtiles_ * ((nl + kSlotT - 1) / kSlotT)),
        ksegs(max(1, kWarps / ntiles)) {}
};

// One chunk of columns [c0, c0 + nc4) (float4s) into the warp's running
// sums acc (8 rows x 8 slots, kept across chunks): slot q's v at ds + q *
// dstride floats (shared memory; ds holds the chunk's first column).  The
// warp's lanes take columns lane, lane + 32, ... of its segment of the
// chunk; each Zs float4 feeds 32 FMAs and each v float4 32.
__device__ __forceinline__ void product_chunk(const float* zr, int ldk4, const float* ds,
                                              int dstride, int nl, const Tasks& T, int c0,
                                              int nc4, float (&acc)[kTileOut]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= T.ntiles * T.ksegs) return;
  const int tile = warp % T.ntiles, s = warp / T.ntiles;
  const int rt = tile % T.rtiles, q0 = (tile / T.rtiles) * kSlotT;
  const int nv = min(kSlotT, nl - q0);
  const int seg = (nc4 + T.ksegs - 1) / T.ksegs;  // the s-th cut of this chunk
  const int lo = s * seg, hi = min(nc4, lo + seg);
  const float4* z0 = reinterpret_cast<const float4*>(zr) + (size_t)rt * kRowT * ldk4 + c0;
  const float4* d0 = reinterpret_cast<const float4*>(ds + (size_t)q0 * dstride);
  const int dstride4 = dstride >> 2;
#pragma unroll 2
  for (int c = lo + lane; c < hi; c += 32) {
    float4 d[kSlotT];
#pragma unroll
    for (int q = 0; q < kSlotT; ++q)
      d[q] = q < nv ? d0[(size_t)q * dstride4 + c] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < kRowT; ++r) {
      const float4 z = z0[(size_t)r * ldk4 + c];
#pragma unroll
      for (int q = 0; q < kSlotT; ++q) {
        float& a = acc[r * kSlotT + q];
        a = fmaf(z.x, d[q].x, a);
        a = fmaf(z.y, d[q].y, a);
        a = fmaf(z.z, d[q].z, a);
        a = fmaf(z.w, d[q].w, a);
      }
    }
  }
}

// The warps' sums through a warp reduce-scatter into part, then summed over
// the segments in order and written to u: slot q's rows at u + lanes[q] *
// ustride (lanes nullptr: the single lane, u itself).  Opens and closes with
// a barrier.
__device__ __forceinline__ void product_store(float (&acc)[kTileOut], float* part, float* u,
                                              size_t ustride, const int* lanes, int nl,
                                              const Tasks& T, int row0, int rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < T.ntiles * T.ksegs) {
    warp_reduce_scatter<kTileOut>(acc);  // lane l: entries 2 l, 2 l + 1
    part[warp * kTileOut + 2 * lane] = acc[0];
    part[warp * kTileOut + 2 * lane + 1] = acc[1];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < T.ntiles * kTileOut; o += kThreads) {
    const int tile = o / kTileOut, e = o % kTileOut;
    const int row = (tile % T.rtiles) * kRowT + e / kSlotT;
    const int q = (tile / T.rtiles) * kSlotT + e % kSlotT;
    float sum = 0.f;
    for (int s = 0; s < T.ksegs; ++s) sum += part[(s * T.ntiles + tile) * kTileOut + e];
    if (row < rows && q < nl) u[(size_t)(lanes ? lanes[q] : 0) * ustride + row0 + row] = sum;
  }
  __syncthreads();
}

// One cooperative grid, one CTA per SM, each holding `rows` rows of Zs in
// shared memory for the whole call (the plan: ops/kernels.py::tcg_plan).
// grid = groups x blocks: CTA g takes the row block g % blocks and, in the
// product, the lane group g / blocks.
//
// REPL (B = 1): every CTA holds the lane whole (and, given no corr, forms
// it as K1 does: its rows of Zs x, one grid step).  An iteration: its rows of
// u = Zs delta into u_g (by parity);  -- grid step --  every CTA reads all of
// u and runs the lane's iteration itself, in one order, so every CTA has
// the same bits (K1's scheme, matvec_chain.cu): ONE grid step an iteration.
//
// Otherwise (B lanes): CTA g owns lanes g, g + grid, ... (their vectors in
// its shared memory).  An iteration: every CTA lists the live lanes (the
// alive flags), its group takes its share of them and stages their deltas
// from delta_g in chunks through two buffers (asynchronous copies; the copy
// of chunk c + 1 in flight while the product runs on chunk c; one CTA
// barrier a chunk), its rows of u for those lanes
// into u_g;  -- grid step --  each owner runs its lanes' iterations from
// u_g and publishes delta and the alive flag;  -- grid step.  A stopped
// lane leaves the product: an iteration costs its live lanes only.  Each
// warp keeps its tile's 64 sums in registers across the chunks and reduces
// them once.
//
// Dynamic shared memory (floats), as resident_smem counts it: zr
// [rpad][ldk] (the rows, zero-padded to rpad = rows rounded up to 8 and
// ldk = n rounded up to 4), the owned lanes [owned][8][ldk], the staged
// chunks [2][lmax][chunk] (not in REPL), part [kPart], list [B] ints.
// The owned lanes' loop scalars sit in static shared memory, copied to
// every thread's registers for an iteration and written back by thread 0
// (the iteration's barriers lie between every read and that write).
template <bool REPL>
__global__ void __launch_bounds__(kThreads, 1)
tcg_resident_kernel(const float* __restrict__ zs, const float* __restrict__ xs,
                    const float* __restrict__ ws, const float* __restrict__ grads,
                    const float* __restrict__ corrs, const float* __restrict__ radii,
                    float* __restrict__ etas, float* __restrict__ hetas,
                    int* __restrict__ stats, float* u_g, float* delta_g, int* alive_g, int b,
                    int n, int maxinner, int mininner, float theta, float kappa, int groups,
                    int rows, int owned, int lmax, int chunk) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kRedSlots];
  __shared__ int wcount[kWarps];
  __shared__ Scalars ssh[kMaxOwned];
  const int nb = gridDim.x, blocks = nb / groups;
  const int rb = blockIdx.x % blocks, gi = blockIdx.x / blocks;
  const int ldk = (n + 3) & ~3, ldk4 = ldk >> 2;
  const int rpad = (rows + kRowT - 1) / kRowT * kRowT, rtiles = rpad / kRowT;
  const int row0 = rb * rows, myrows = max(0, min(n, row0 + rows) - row0);
  float* zr = smem;
  float* lanebuf = zr + (size_t)rpad * ldk;
  float* stage = lanebuf + (size_t)owned * 8 * ldk;
  float* part = stage + (REPL ? 0 : (size_t)2 * lmax * chunk);
  int* list = reinterpret_cast<int*>(part + kPart);

  for (int idx = threadIdx.x; idx < rpad * ldk; idx += kThreads) {
    const int i = idx / ldk, j = idx - i * ldk;
    zr[idx] = i < myrows && j < n ? zs[(size_t)(row0 + i) * n + j] : 0.f;
  }
  if constexpr (REPL) {
    const Lane L(lanebuf, ldk);
    Scalars S = load_lane(L, 0, xs, ws, grads, corrs, radii, theta, kappa, n, ldk, red);
    S.done = maxinner <= 0;
    const Tasks T(rtiles, 1);
    if (corrs == nullptr) {
      // corr = 2 x'Zs x + x'(w o x): the CTA's rows of Zs x into u_g's odd
      // buffer (iteration 0 writes the even one), one grid step, then every
      // CTA the dot with all of it in one order (K1's scheme)
      float* u = u_g + ldk;
      float acc[kTileOut];
#pragma unroll
      for (int e = 0; e < kTileOut; ++e) acc[e] = 0.f;
      product_chunk(zr, ldk4, L.x, ldk, 1, T, 0, ldk4, acc);
      product_store(acc, part, u, 0, nullptr, 1, T, row0, myrows);
      grid.sync();
      float c[2] = {0.f, 0.f};
      for (int i = threadIdx.x; i < n; i += kThreads) {
        c[0] += L.x[i] * __ldcg(u + i);
        c[1] += L.w[i] * L.x[i] * L.x[i];
      }
      cta_sum<kWarps, kMaxSums>(c, red, 1);
      S.corr = 2.f * c[0] + c[1];
    }
    int it = 0;
    while (!S.done) {
      float* u = u_g + (size_t)(it & 1) * ldk;
      float acc[kTileOut];
#pragma unroll
      for (int e = 0; e < kTileOut; ++e) acc[e] = 0.f;
      __syncthreads();  // delta written by every thread
      product_chunk(zr, ldk4, L.delta, ldk, 1, T, 0, ldk4, acc);
      product_store(acc, part, u, 0, nullptr, 1, T, row0, myrows);
      grid.sync();
      form_hw<true>(u, L.x, L.w, L.delta, L.hd, S.corr, n, red);
      tcg_update(L, S, n, maxinner, mininner, red);
      ++it;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < myrows; i += kThreads) {
      etas[row0 + i] = L.eta[row0 + i];
      hetas[row0 + i] = L.heta[row0 + i];
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      stats[0] = S.j;
      stats[1] = S.code;
    }
  } else {
    for (int m = 0; m < owned; ++m) {
      const int lb = blockIdx.x + m * nb;
      if (lb >= b) break;
      const Lane L(lanebuf + (size_t)m * 8 * ldk, ldk);
      Scalars S = load_lane(L, lb, xs, ws, grads, corrs, radii, theta, kappa, n, ldk, red);
      S.done = maxinner <= 0;
      for (int i = threadIdx.x; i < ldk; i += kThreads)
        delta_g[(size_t)lb * ldk + i] = L.delta[i];
      if (threadIdx.x == 0) {
        ssh[m] = S;
        alive_g[lb] = !S.done;
      }
      __syncthreads();  // the next lane's load reuses cta_sum's buffer 0
    }

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int chunk4 = chunk >> 2, nch = (ldk4 + chunk4 - 1) / chunk4;
    grid.sync();  // delta_g and the alive flags published
    for (;;) {
      // the live lanes, in lane order (the same list in every CTA)
      int nl = 0;
      for (int base = 0; base < b; base += kThreads) {
        const int lb = base + threadIdx.x;
        const bool live = lb < b && __ldcg(alive_g + lb) != 0;
        const unsigned m = __ballot_sync(0xffffffffu, live);
        if (lane == 0) wcount[warp] = __popc(m);
        __syncthreads();
        int off = nl, tot = 0;
        for (int w = 0; w < kWarps; ++w) {
          off += w < warp ? wcount[w] : 0;
          tot += wcount[w];
        }
        if (live) list[off + __popc(m & ((1u << lane) - 1u))] = lb;
        nl += tot;
        __syncthreads();
      }
      if (nl == 0) break;
      // this group's share of the live lanes
      const int per = (nl + groups - 1) / groups;
      const int q0 = min(nl, gi * per), gl = min(nl, q0 + per) - q0;
      const int* glanes = list + q0;
      if (gl > 0) {
        const Tasks T(rtiles, gl);
        float acc[kTileOut];
#pragma unroll
        for (int e = 0; e < kTileOut; ++e) acc[e] = 0.f;
        // chunk ch of the group's deltas into buffer ch % 2, one commit
        // group per chunk (an empty one past the last keeps the count)
        auto issue = [&](int ch) {
          if (ch < nch) {
            float* dst = stage + (size_t)(ch & 1) * lmax * chunk;
            const int c0 = ch * chunk4, nc4 = min(ldk4 - c0, chunk4);
            for (int idx = threadIdx.x; idx < gl * nc4; idx += kThreads) {
              const int q = idx / nc4, c = idx - q * nc4;
              cp_async16(dst + (size_t)q * chunk + 4 * c,
                         delta_g + (size_t)glanes[q] * ldk + 4 * (c0 + c));
            }
          }
          asm volatile("cp.async.commit_group;" ::: "memory");
        };
        issue(0);
        for (int ch = 0; ch < nch; ++ch) {
          asm volatile("cp.async.wait_group 0;" ::: "memory");  // chunk ch landed
          __syncthreads();  // ... for every thread, and chunk ch - 1's buffer is free
          issue(ch + 1);
          const int c0 = ch * chunk4;
          product_chunk(zr, ldk4, stage + (size_t)(ch & 1) * lmax * chunk, chunk, gl, T, c0,
                        min(ldk4 - c0, chunk4), acc);
        }
        asm volatile("cp.async.wait_group 0;" ::: "memory");
        product_store(acc, part, u_g, ldk, glanes, gl, T, row0, myrows);
      }
      grid.sync();
      for (int m = 0; m < owned; ++m) {
        const int lb = blockIdx.x + m * nb;
        if (lb >= b) break;
        Scalars S = ssh[m];
        if (S.done) continue;
        const Lane L(lanebuf + (size_t)m * 8 * ldk, ldk);
        form_hw<true>(u_g + (size_t)lb * ldk, L.x, L.w, L.delta, L.hd, S.corr, n, red);
        tcg_update(L, S, n, maxinner, mininner, red);
        // each thread publishes the entries it just wrote (i = threadIdx.x +
        // k kThreads; the pad entries stay zero)
        for (int i = threadIdx.x; i < ldk; i += kThreads)
          delta_g[(size_t)lb * ldk + i] = L.delta[i];
        if (threadIdx.x == 0) {
          ssh[m] = S;
          alive_g[lb] = !S.done;
        }
      }
      grid.sync();
    }
    for (int m = 0; m < owned; ++m) {
      const int lb = blockIdx.x + m * nb;
      if (lb >= b) break;
      const Lane L(lanebuf + (size_t)m * 8 * ldk, ldk);
      const size_t off = (size_t)lb * n;
      for (int i = threadIdx.x; i < n; i += kThreads) {
        etas[off + i] = L.eta[i];
        hetas[off + i] = L.heta[i];
      }
      if (threadIdx.x == 0) {
        stats[2 * lb] = ssh[m].j;
        stats[2 * lb + 1] = ssh[m].code;
      }
    }
  }
}

// The layout of tcg_resident_kernel, as ops/kernels.py::tcg_plan counts it.
size_t resident_smem(int n, int b, int rows, int owned, int lmax, int chunk, bool repl) {
  const size_t ldk = (size_t)((n + 3) & ~3);
  const size_t rpad = (size_t)(rows + kRowT - 1) / kRowT * kRowT;
  return (rpad * ldk + (size_t)owned * 8 * ldk + (repl ? 0 : (size_t)2 * lmax * chunk) + kPart +
          (size_t)b) *
         sizeof(float);
}

}  // namespace

extern "C" {

int sphere_tcg_launch(const float* zs, const float* xs, const float* ws, const float* grads,
                      const float* corrs, const float* radii, float* etas, float* hetas,
                      int* stats, int b, int n, int maxinner, int mininner, float theta,
                      float kappa, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = 8 * (size_t)n * sizeof(float);
  err = allow_smem(tcg_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec4 = (n % 4 == 0) && aligned16(zs);
  tcg_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      zs, xs, ws, grads, corrs, radii, etas, hetas, stats, n, maxinner, mininner, theta, kappa,
      vec4);
  return (int)cudaGetLastError();
}

// The resident path on a cooperative grid of `grid` CTAs (the plan of
// ops/kernels.py::tcg_plan: `groups` lane groups x grid / groups row blocks
// of `rows` rows; each CTA owns up to `owned` lanes; lane groups of at
// most `lmax` lanes staged `chunk` floats at a time through two buffers).  Scratch: u_g [2 ldk] at b = 1, [b ldk] otherwise; delta_g
// [b ldk]; alive_g [b].  At b = 1 corrs may be null: the kernel then forms
// corr itself.
int sphere_tcg_resident_launch(const float* zs, const float* xs, const float* ws,
                               const float* grads, const float* corrs, const float* radii,
                               float* etas, float* hetas, int* stats, float* u_g,
                               float* delta_g, int* alive_g, int b, int n, int maxinner,
                               int mininner, float theta, float kappa, int grid, int groups,
                               int rows, int owned, int lmax, int chunk, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool repl = b == 1;
  const int rtiles = (rows + kRowT - 1) / kRowT;
  if (b < 1 || n < 1 || grid < 1 || groups < 1 || grid % groups != 0 || rows < 1 ||
      (!repl && corrs == nullptr) ||
      (long long)rows * (grid / groups) < n || owned < 1 || owned > kMaxOwned ||
      (long long)owned * grid < b || (repl && groups != 1) ||
      (!repl && (lmax < (b + groups - 1) / groups || chunk < 4 || chunk % 4 != 0)) ||
      rtiles * ((lmax + kSlotT - 1) / kSlotT) > kWarps)
    return (int)cudaErrorInvalidValue;
  const size_t smem = resident_smem(n, b, rows, owned, lmax, chunk, repl);
  const void* kernel =
      repl ? (const void*)tcg_resident_kernel<true> : (const void*)tcg_resident_kernel<false>;
  err = repl ? allow_smem(tcg_resident_kernel<true>, smem)
             : allow_smem(tcg_resident_kernel<false>, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&zs,       (void*)&xs,       (void*)&ws,     (void*)&grads,
                  (void*)&corrs,    (void*)&radii,    (void*)&etas,   (void*)&hetas,
                  (void*)&stats,    (void*)&u_g,      (void*)&delta_g, (void*)&alive_g,
                  (void*)&b,        (void*)&n,        (void*)&maxinner, (void*)&mininner,
                  (void*)&theta,    (void*)&kappa,    (void*)&groups, (void*)&rows,
                  (void*)&owned,    (void*)&lmax,     (void*)&chunk};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the refusal is reported here, not later
    return (int)err;
  }
  return (int)cudaGetLastError();
}

const char* sphere_tcg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
