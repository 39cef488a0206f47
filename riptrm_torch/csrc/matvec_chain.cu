// Hand-written Hopper (sm_90a) kernels for the chains of normalised matvecs.
//
//   chain_resident_kernel  replaces riptrm_tpu/ops/pallas_kernels.py
//                          ::chained_barrier_matvec (_chain_kernel, K1):
//                          n_iters normalised applications v <- Hw(v)/|Hw(v)| of
//                          the sphere barrier Hessian
//                          Hw(v) = -2 P(Zs v) + corr v + P(w o v),  P = I - x x'.
//   chain_hbm_kernel       replaces chained_barrier_matvec_hbm (_chain_hbm_kernel,
//                          K6): K1's function for an n whose Zs does not fit in
//                          the SMs' shared memory.
//   chain_left_kernel,     replace bare_matvec_chain (_bare_chain_kernel, K5):
//   chain_right_kernel     n_iters passes of v <- v @ Z (left, v [r, n]) or
//                          v <- Z @ v (right, v [n, c]), each row (left) or
//                          column (right) then divided by sqrt(sum w^2 + 1e-30).
//                          Nothing else: the roofline's speed-of-light
//                          denominator for the tCG kernels
//                          (riptrm_torch/experiment/roofline.py).
//
// A chain is a sequence of dependent passes over one matrix, and one SM
// holds at most 227 KB: one CTA per chain would stream the whole matrix
// from L2 on every pass and wait on L2 latency, with the other SMs idle
// (61-85 us per pass at n = 1000, PERF.md).  So K1 and K5 left run on a
// cooperative grid of co-resident CTAs (launched with
// cudaLaunchCooperativeKernel; cooperative_groups::this_grid().sync(), no
// -rdc needed), each holding its slice of the matrix in shared memory for
// the whole call, copied once; a pass reads nothing of the matrix from L2
// and takes ONE grid-wide step.  What bounds them then is that step and
// the vector traffic around it, not the matrix.  A value every CTA needs
// is either recomputed by every CTA from the same inputs in the same
// order (the same bits everywhere, no atomics; reduce.cuh), or written to
// a global buffer double-buffered by pass parity: a CTA one pass ahead
// writes the other buffer, and a CTA two passes ahead has waited at the
// grid step for every read of this one.  Data written by other CTAs is
// read with __ldcg (L2, never a stale L1 line).  A cooperative launch
// larger than co-residency is refused; the launcher returns that error.
//
// K1.  CTA b owns the rows [b rpc, b rpc + rpc) of Zs in shared memory (the
// plan, ops/kernels.py::chain_resident_plan: rpc = ceil(n / SMs), 8 rows,
// 32 KB at n = 1000 on 132 SMs), and v, x, w whole; it forms corr itself
// (one grid step before the first pass).  A pass: its rows of u = Zs v
// into a global u (by parity), grid step; then every CTA reads all of u (n
// floats from L2), forms x.u, x.(w o v), Hw(v) and |Hw(v)|^2 itself and
// keeps the next v in shared memory.  Resident while ceil(n / SMs) rows of
// Zs and 4 n-vectors fit one block's shared memory: n <= 2508 on 132 SMs;
// the wrapper refuses larger n and names K6.  What bounds it: 64 dependent
// grid steps (~1.1 us each on an H100), each with a 4 KB L2 read and three
// block reductions; the FP32 operations (2 n^2 per pass) take 0.03 us.
//
// K5 left.  Cut by columns of Z: CTA (cc, rr) holds Z[:, its cols columns]
// transposed in shared memory (cols = ceil(n / (SMs / row_groups)): 16
// columns, 64 KB at n = 1000, r = 16) and computes w[its rows, its
// columns]; the plan (ops/kernels.py::matvec_left_plan) also cuts the r
// rows of v into row_groups, so that fewer CTAs read each row of v.  A
// pass: stage its rows of the last pass's w from L2 in chunks of shared
// memory, a warp per row; the rows are whole, so the warp takes the row's
// norm itself and divides; a warp computes an 8 x 8 tile of w in registers
// (each Z entry read from shared memory feeds 8 FMAs, each v entry 8), its
// lanes splitting the inner dimension (a warp reduce-scatter sums them);
// write the block of w; grid step.  What bounds it: the product in FP32
// (2 r n^2 per pass, 3.8 us at r = 128 and n = 1000 against 67 TFLOP/s),
// fed from shared memory, whose reads match the FMA rate at an 8 x 8 tile;
// and each CTA's read of its rows of w from L2 (r n / row_groups floats
// per pass).  Z is read as it is given.
//
// K5 right.  One CTA per group of g columns; Z' (the wrapper's transpose)
// in shared memory when it fits with the group (4 (n^2 + 2 n g) bytes:
// 64 KB at n = 128, g = 8), else read through L2; a thread owns a row and a
// chunk of the group's columns in registers, so each Z' entry feeds up to
// MAXK FMAs (stiefel_tcg_kernel's product, stiefel_tcg.cu).
//
// K5's precisions: every one accumulates in FP32 with FMA on the CUDA
// cores; 'high' and 'default' round the operands as the TPU does: 'high'
// is the bf16x3 split hi*hi + hi*lo + lo*hi, 'default' one product of
// bf16-rounded operands.  That rounding defines the function the JAX
// package times.
//
// K6.  What bounds it: the bytes of Zs, n^2 * 4 per iteration (64 MB at
// n = 4000, above the 50 MB L2), read from device memory.  A cooperative
// grid of G co-resident CTAs (at most the occupancy times the SM count),
// each streaming its contiguous slice of rows with 16-byte loads, one warp
// per row.  An iteration has two grid-wide steps:
//   1. each CTA loads v (n floats) into shared memory, computes its rows of
//      Zs v and the partial sums x.(Zs v) and x.(w o v);  -- grid sync --
//   2. every CTA sums the [G] partials in one fixed order, forms Hw(v) on
//      its rows, writes them to a global vector and its partial |Hw(v)|^2;
//      -- grid sync --
// and the next iteration's load divides by the norm summed the same way.
// The global vector needs no second buffer: it is read only before the
// first grid step of the next iteration and written only after it.
//
// Plain C interface for ctypes (riptrm_torch/ops/_build.py): each launcher
// returns cudaGetLastError() (or the launch's error) after the launch, 0 on
// success.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "reduce.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;  // K1 and K6
constexpr int kWarps = kThreads / 32;
constexpr int kLeftThreads = 256;  // ops/kernels.py::MATVEC_LEFT_THREADS
constexpr int kLeftWarps = kLeftThreads / 32;
constexpr int kTileRows = 8, kTileCols = 8;  // a K5-left warp's tile of w
constexpr int kTile = kTileRows * kTileCols;
constexpr int kRightThreads = 256;  // ops/kernels.py::MATVEC_RIGHT_THREADS
constexpr int kLoads = 8;  // float4 loads a lane has in flight per row (rows_dot)
constexpr int kMaxSums = 2;
constexpr int kRedSlots = kMaxSums * kWarps + kMaxSums;
enum Precision { kHighest = 0, kHigh = 1, kDefault = 2 };

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

// out[k] = sum_j zs[(row0 + k) * n + j] * v[j] for k < rows, one warp per
// output entry; v in shared memory, zs read through L2 (float4 when vec4).
// A warp's row is a chain of L2 round trips, so a lane issues its next
// kLoads float4 loads of the row before the FMAs that use them (one round
// trip per row up to n = 1024).  The sum runs in the same order as a plain
// `c += 32` loop.
__device__ __forceinline__ void rows_dot(const float* __restrict__ zs, const float* v, float* out,
                                         int row0, int rows, int n, bool vec4) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k = warp; k < rows; k += kWarps) {
    const float* zr = zs + (size_t)(row0 + k) * n;
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
          if (c < n4) acc = mac4<kHighest>(zb[u], v4[c], acc);
        }
      }
    } else {
#pragma unroll 4
      for (int c = lane; c < n; c += 32) acc = fmaf(__ldg(zr + c), v[c], acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) out[k] = acc;
  }
}

__device__ __forceinline__ int pad4(int n) { return (n + 3) & ~3; }

// ---------------------------------------------------------------------------
// K1: Zs resident across a cooperative grid
// ---------------------------------------------------------------------------
// dot[k] = (row k of zr) . vec for the CTA's `rows` rows, from shared
// memory: `wpr` warps a row (kWarps / rows when rows < kWarps), each over a
// segment of the row's float4s, the segments then summed in order.  Opens
// with a barrier (vec may just have been written) and ends with one.
__device__ __forceinline__ void own_rows_dot(const float* zr, const float* vec, float* dot,
                                             float* seg, int rows, int ldk4) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wpr = rows > 0 && rows < kWarps ? kWarps / rows : 1;
  const int span = (ldk4 + wpr - 1) / wpr;
  const float4* v4 = reinterpret_cast<const float4*>(vec);
  __syncthreads();
  for (int t = warp; t < rows * wpr; t += kWarps) {
    const int k = t / wpr, s = t - k * wpr;
    const float4* z4 = reinterpret_cast<const float4*>(zr) + (size_t)k * ldk4;
    const int end = min(ldk4, (s + 1) * span);
    float acc = 0.f;
    for (int c = s * span + lane; c < end; c += 32) acc = mac4<kHighest>(z4[c], v4[c], acc);
    acc = warp_sum(acc);
    if (lane == 0) {
      if (wpr == 1)
        dot[k] = acc;
      else
        seg[t] = acc;  // t < rows * wpr <= kWarps
    }
  }
  __syncthreads();
  if (wpr > 1) {
    if (threadIdx.x < rows) {
      float acc = 0.f;
      for (int s = 0; s < wpr; ++s) acc += seg[threadIdx.x * wpr + s];
      dot[threadIdx.x] = acc;
    }
    __syncthreads();
  }
}

// Dynamic shared memory (floats): zr [rows_per_cta][ldk] (the CTA's rows of
// Zs, zero-padded to ldk = n rounded up to 4), v [ldk], x [ldk], w [n],
// hv [n], dot [rows_per_cta].  Scratch: u_g [2 n + G], the rows of Zs v by
// pass parity, then the CTA's partial x'Zs x.  corr = 2 x'Zs x + x'(w o x)
// is formed in the kernel: one more grid step, where a wrapper would launch
// a handful of small kernels on every call.
__global__ void __launch_bounds__(kThreads)
chain_resident_kernel(const float* __restrict__ zs, const float* __restrict__ x_g,
                      const float* __restrict__ w_g, const float* __restrict__ v0, float* u_g,
                      float* __restrict__ out, int n, int n_iters, int rows_per_cta) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kRedSlots];
  __shared__ float seg[kWarps];
  const int ldk = pad4(n), ldk4 = ldk >> 2;
  const int row0 = blockIdx.x * rows_per_cta;
  const int rows = max(0, min(n, row0 + rows_per_cta) - row0);
  float* zr = smem;
  float* v = zr + (size_t)rows_per_cta * ldk;
  float* x = v + ldk;
  float* w = x + ldk;
  float* hv = w + n;
  float* dot = hv + n;
  float* xzx = u_g + 2 * (size_t)n;  // [G]
  for (int idx = threadIdx.x; idx < rows * ldk; idx += kThreads) {
    const int k = idx / ldk, j = idx - k * ldk;
    zr[idx] = j < n ? zs[(size_t)(row0 + k) * n + j] : 0.f;
  }
  for (int i = threadIdx.x; i < ldk; i += kThreads) {
    v[i] = i < n ? v0[i] : 0.f;
    x[i] = i < n ? x_g[i] : 0.f;
    if (i < n) w[i] = w_g[i];
  }
  // corr: the CTA's rows of x'Zs x, one grid step, every CTA the sum in order
  own_rows_dot(zr, x, dot, seg, rows, ldk4);
  float s0[1] = {0.f};
  for (int k = threadIdx.x; k < rows; k += kThreads) s0[0] += x[row0 + k] * dot[k];
  block_sum<kWarps, kMaxSums>(s0, red);
  if (threadIdx.x == 0) xzx[blockIdx.x] = s0[0];
  grid.sync();
  float tot[1];
  grid_total<kWarps, kMaxSums>(xzx, gridDim.x, tot, red);
  float s1[1] = {0.f};
  for (int i = threadIdx.x; i < n; i += kThreads) s1[0] += w[i] * x[i] * x[i];
  block_sum<kWarps, kMaxSums>(s1, red);
  const float corr = 2.f * tot[0] + s1[0];
  for (int it = 0; it < n_iters; ++it) {
    float* u = u_g + (size_t)(it & 1) * n;
    own_rows_dot(zr, v, dot, seg, rows, ldk4);  // Zs v on the CTA's rows
    for (int k = threadIdx.x; k < rows; k += kThreads) u[row0 + k] = dot[k];
    grid.sync();
    // every CTA: the whole Hw(v) from all of u, in the same order
    float s[2] = {0.f, 0.f};
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float ui = __ldcg(u + i);
      hv[i] = ui;
      s[0] += x[i] * ui;
      s[1] += x[i] * (w[i] * v[i]);
    }
    block_sum<kWarps, kMaxSums>(s, red);
    float s2[1] = {0.f};
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float xi = x[i], vi = v[i];
      const float h = -2.f * (hv[i] - xi * s[0]) + corr * vi + (w[i] * vi - xi * s[1]);
      hv[i] = h;
      s2[0] += h * h;
    }
    block_sum<kWarps, kMaxSums>(s2, red);
    const float nrm = sqrtf(s2[0]);
    for (int i = threadIdx.x; i < n; i += kThreads) v[i] = hv[i] / nrm;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < rows; k += kThreads) out[row0 + k] = v[row0 + k];
}

// ---------------------------------------------------------------------------
// K5, left: Z resident across a cooperative grid of col_groups x row_groups
// ---------------------------------------------------------------------------
// a / d rounded to nearest, given y = RN(1/d): q = RN(a y) lies within an
// ulp of a / d, and one FMA residual corrects it (Markstein), three
// operations against div.rn's general sequence.  d here is a norm, never
// near the overflow or underflow range.
__device__ __forceinline__ float div_by(float a, float d, float y) {
  const float q = __fmul_rn(a, y);
  return __fmaf_rn(__fmaf_rn(-q, d, a), y, q);
}

// Stage rows [q0, q0 + rows) of the CTA's rows of v into vs [rows][ldk],
// the pad columns zeroed, a warp per row: pass 0 copies v0 [r, n] as it
// is; later passes load the last pass's w (src [r][ldk]; a warp has four
// rows of eight float4 loads a lane in flight), sum its squares on the
// way, and divide the row by nrm = sqrt(|w|^2 + 1e-30) in place, each lane
// its own entries (no barrier).  Every CTA of a row group stages the same
// whole rows in the same order, so all of them get the same bits.  With
// `divide` false only nrm[q] is set (the last pass's norms).
__device__ __forceinline__ void stage_rows(float* vs, float* nrm, const float* __restrict__ v0,
                                           const float* src, int i0, int q0, int rows, int n,
                                           bool first, bool divide) {
  constexpr int kBatch = 8, kPair = 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ldk = pad4(n), ldk4 = ldk >> 2;
  if (first) {
    for (int q = warp; q < rows; q += kLeftWarps) {
      const float* v = v0 + (size_t)(i0 + q0 + q) * n;
      for (int k = lane; k < ldk; k += 32) vs[(size_t)q * ldk + k] = k < n ? v[k] : 0.f;
    }
    return;
  }
  for (int qa = warp; qa < rows; qa += kPair * kLeftWarps) {
    float acc[kPair] = {0.f, 0.f, 0.f, 0.f};
    for (int base = lane; base < ldk4; base += 32 * kBatch) {
      float4 a[kPair][kBatch];
#pragma unroll
      for (int p = 0; p < kPair; ++p) {
        const int q = qa + p * kLeftWarps;
        const float4* w4 = reinterpret_cast<const float4*>(src + (size_t)(i0 + q0 + q) * ldk);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int k4 = base + 32 * u;
          a[p][u] = q < rows && k4 < ldk4 ? __ldcg(w4 + k4) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int p = 0; p < kPair; ++p) {
        float4* row4 = reinterpret_cast<float4*>(vs + (size_t)(qa + p * kLeftWarps) * ldk);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int k = 4 * (base + 32 * u);
          float4 b = a[p][u];
          if (k + 1 >= n) b.y = 0.f;
          if (k + 2 >= n) b.z = 0.f;
          if (k + 3 >= n) b.w = 0.f;
          acc[p] = fmaf(b.x, b.x, fmaf(b.y, b.y, fmaf(b.z, b.z, fmaf(b.w, b.w, acc[p]))));
          if (divide && qa + p * kLeftWarps < rows && k < ldk) row4[k >> 2] = b;
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kPair; ++p) {
      const int q = qa + p * kLeftWarps;
      const float d = sqrtf(warp_sum(acc[p]) + 1e-30f);
      if (q >= rows) continue;
      if (lane == 0) nrm[q0 + q] = d;
      if (divide) {
        const float y = __frcp_rn(d);
        float4* row4 = reinterpret_cast<float4*>(vs + (size_t)q * ldk);
        for (int k4 = lane; k4 < ldk4; k4 += 32) {
          const float4 b = row4[k4];
          row4[k4] = make_float4(div_by(b.x, d, y), div_by(b.y, d, y), div_by(b.z, d, y),
                                 div_by(b.w, d, y));
        }
      }
    }
  }
}

// Dynamic shared memory (floats): zt [cp][ldk] (the CTA's columns of Z,
// transposed and zero-padded: cp = cols rounded up to kTileCols), vs
// [chunk][ldk] (staged rows of v), ws [rows_per_group][cp] (the CTA's block
// of w), nrm [rows_per_group], red [kLeftWarps][kTile].  Scratch: wbuf
// [2][r][ldk], w by pass parity.
template <int PREC>
__global__ void __launch_bounds__(kLeftThreads)
chain_left_kernel(const float* __restrict__ z, const float* __restrict__ v0,
                  float* __restrict__ out, float* wbuf, int r, int n, int n_iters,
                  int col_groups, int cols, int rows_per_group, int chunk) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ldk = pad4(n), ldk4 = ldk >> 2;
  const int cp = (cols + kTileCols - 1) / kTileCols * kTileCols;
  const int col_tiles = cp / kTileCols;
  const int cc = blockIdx.x % col_groups, rr = blockIdx.x / col_groups;
  const int c0 = cc * cols, i0 = rr * rows_per_group;
  const int ncols = max(0, min(n, c0 + cols) - c0);
  const int nrows = max(0, min(r, i0 + rows_per_group) - i0);
  float* zt = smem;
  float* vs = zt + (size_t)cp * ldk;
  float* ws = vs + (size_t)chunk * ldk;
  float* nrm = ws + (size_t)rows_per_group * cp;
  float* red = nrm + rows_per_group;

  for (int idx = threadIdx.x; idx < cp * ldk; idx += kLeftThreads) {
    const int k = idx / cp, c = idx - k * cp;  // a warp reads along a row of Z
    zt[(size_t)c * ldk + k] = (c < ncols && k < n) ? z[(size_t)k * n + c0 + c] : 0.f;
  }
  const size_t wsize = (size_t)r * ldk;
  for (int it = 0; it < n_iters; ++it) {
    const float* src = wbuf + (it & 1) * wsize;
    float* dst = wbuf + ((it + 1) & 1) * wsize;
    for (int q0 = 0; q0 < nrows; q0 += chunk) {
      const int rows = min(chunk, nrows - q0);
      __syncthreads();  // the last chunk's reads of vs done
      stage_rows(vs, nrm, v0, src, i0, q0, rows, n, it == 0, true);
      __syncthreads();
      const int tiles = (rows + kTileRows - 1) / kTileRows * col_tiles;
      const int wpt = tiles < kLeftWarps ? kLeftWarps / tiles : 1;  // warps per tile
      const int span = (ldk4 + wpt - 1) / wpt;
      for (int t0 = 0; t0 < tiles * wpt; t0 += kLeftWarps) {
        const int t = t0 + warp;
        const int tile = t / wpt, sub = t - tile * wpt;
        const int a0 = (tile / col_tiles) * kTileRows, cb = (tile % col_tiles) * kTileCols;
        float acc[kTile];
#pragma unroll
        for (int e = 0; e < kTile; ++e) acc[e] = 0.f;
        if (t < tiles * wpt) {
          const float4* v4 = reinterpret_cast<const float4*>(vs + (size_t)a0 * ldk);
          const float4* z4 = reinterpret_cast<const float4*>(zt + (size_t)cb * ldk);
          const int end = min(ldk4, (sub + 1) * span);
          for (int k4 = sub * span + lane; k4 < end; k4 += 32) {
            float4 vv[kTileRows];
#pragma unroll
            for (int a = 0; a < kTileRows; ++a) vv[a] = v4[a * ldk4 + k4];
#pragma unroll
            for (int c = 0; c < kTileCols; ++c) {
              const float4 zz = z4[c * ldk4 + k4];
#pragma unroll
              for (int a = 0; a < kTileRows; ++a)
                acc[a * kTileCols + c] = mac4<PREC>(zz, vv[a], acc[a * kTileCols + c]);
            }
          }
        }
        warp_reduce_scatter<kTile>(acc);  // lane l: entries 2 l and 2 l + 1
#pragma unroll
        for (int j = 0; j < kTile / 32; ++j) {
          const int e = (kTile / 32) * lane + j;
          const int a = a0 + e / kTileCols, c = cb + e % kTileCols;
          if (wpt > 1)
            red[warp * kTile + e] = acc[j];
          else if (t < tiles * wpt && a < rows)
            ws[(size_t)(q0 + a) * cp + c] = acc[j];
        }
      }
      if (wpt > 1) {  // one round: sum each tile's warps in order
        __syncthreads();
        for (int e = threadIdx.x; e < tiles * kTile; e += kLeftThreads) {
          const int tile = e / kTile, j = e - tile * kTile;
          const int a = (tile / col_tiles) * kTileRows + j / kTileCols;
          const int c = (tile % col_tiles) * kTileCols + j % kTileCols;
          float acc = 0.f;
          for (int s = 0; s < wpt; ++s) acc += red[(tile * wpt + s) * kTile + j];
          if (a < rows) ws[(size_t)(q0 + a) * cp + c] = acc;
        }
      }
    }
    __syncthreads();
    for (int q = warp; q < nrows; q += kLeftWarps)
      for (int c = lane; c < ncols; c += 32)
        dst[(size_t)(i0 + q) * ldk + c0 + c] = ws[(size_t)q * cp + c];
    grid.sync();
  }
  if (n_iters == 0) {
    for (int q = warp; q < nrows; q += kLeftWarps)
      for (int c = lane; c < ncols; c += 32)
        out[(size_t)(i0 + q) * n + c0 + c] = v0[(size_t)(i0 + q) * n + c0 + c];
    return;
  }
  // the last pass's norms, from its whole rows staged once more
  const float* last = wbuf + (n_iters & 1) * wsize;
  stage_rows(vs, nrm, v0, last, i0, 0, nrows, n, false, false);
  __syncthreads();
  for (int q = warp; q < nrows; q += kLeftWarps)
    for (int c = lane; c < ncols; c += 32)
      out[(size_t)(i0 + q) * n + c0 + c] = ws[(size_t)q * cp + c] / nrm[q];
}

// ---------------------------------------------------------------------------
// K5, right: one CTA per group of g columns of v [n, c]
// ---------------------------------------------------------------------------
// Shared memory: [zt, n^2 floats, when zs_shared] V [n, g], W [n, g], the
// g column norms.  Task (i, q) owns row i and columns [q kc, q kc + kc) of
// the group.
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

// ---------------------------------------------------------------------------
// K6: Zs streamed from device memory by a cooperative grid
// ---------------------------------------------------------------------------
// CTA b owns rows [b rows_per_cta, ...) of Zs.  Shared memory: v (n floats)
// and the CTA's rows of Zs v / Hw(v).  Scratch: hv_g [n] (Hw(v) of the last
// iteration), partial [3 G] (x.zv and x.(w o v) per CTA, then |hv|^2 per
// CTA).
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
      grid_total<kWarps, kMaxSums>(sq, nb, t, red);
      nrm = sqrtf(t[0]);
      for (int i = threadIdx.x; i < n; i += kThreads) v[i] = __ldcg(hv_g + i) / nrm;
    }
    __syncthreads();
    rows_dot(zs, v, hv, row0, rows, n, vec4);  // Zs v on the CTA's rows
    __syncthreads();
    float s[2] = {0.f, 0.f};
    for (int k = threadIdx.x; k < rows; k += kThreads) {
      const int i = row0 + k;
      s[0] += x_g[i] * hv[k];
      s[1] += x_g[i] * (w_g[i] * v[i]);
    }
    block_sum<kWarps, kMaxSums>(s, red);
    if (threadIdx.x == 0) {
      dots[2 * blockIdx.x] = s[0];
      dots[2 * blockIdx.x + 1] = s[1];
    }
    grid.sync();
    float tot[2];
    grid_total<kWarps, kMaxSums>(dots, nb, tot, red);
    float s2[1] = {0.f};
    for (int k = threadIdx.x; k < rows; k += kThreads) {
      const int i = row0 + k;
      const float xi = x_g[i], vi = v[i];
      const float h = -2.f * (hv[k] - xi * tot[0]) + corr * vi + (w_g[i] * vi - xi * tot[1]);
      hv[k] = h;
      hv_g[i] = h;
      s2[0] += h * h;
    }
    block_sum<kWarps, kMaxSums>(s2, red);
    if (threadIdx.x == 0) sq[blockIdx.x] = s2[0];
    grid.sync();
  }
  if (n_iters == 0) {
    for (int k = threadIdx.x; k < rows; k += kThreads) out[row0 + k] = v0[row0 + k];
    return;
  }
  float t[1];
  grid_total<kWarps, kMaxSums>(sq, nb, t, red);
  nrm = sqrtf(t[0]);
  for (int k = threadIdx.x; k < rows; k += kThreads) out[row0 + k] = hv[k] / nrm;
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
cudaError_t launch_cooperative(const void* kernel, int grid, int threads, void** args,
                               size_t smem, void* stream) {
  const cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(threads), args,
                                                      smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the refusal is reported here, not later
    return err;
  }
  return cudaGetLastError();
}

// The same layouts as ops/kernels.py::chain_resident_plan and
// ::matvec_left_plan.
size_t resident_smem(int n, int rows_per_cta) {
  const size_t ldk = (size_t)((n + 3) & ~3);
  return ((rows_per_cta + 2) * ldk + 2 * (size_t)n + rows_per_cta) * sizeof(float);
}

size_t left_smem(int n, int cols, int rows_per_group, int chunk) {
  const size_t ldk = (size_t)((n + 3) & ~3);
  const size_t cp = (size_t)((cols + kTileCols - 1) / kTileCols * kTileCols);
  return ((cp + chunk) * ldk + rows_per_group * (cp + 1) + (size_t)kLeftWarps * kTile) *
         sizeof(float);
}

template <int PREC>
cudaError_t launch_left(const float* z, const float* v0, float* out, float* wbuf, int r, int n,
                        int n_iters, int col_groups, int row_groups, int cols,
                        int rows_per_group, int chunk, void* stream) {
  const size_t smem = left_smem(n, cols, rows_per_group, chunk);
  auto kernel = chain_left_kernel<PREC>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&z, (void*)&v0, (void*)&out, (void*)&wbuf, (void*)&r, (void*)&n,
                  (void*)&n_iters, (void*)&col_groups, (void*)&cols, (void*)&rows_per_group,
                  (void*)&chunk};
  return launch_cooperative((const void*)kernel, col_groups * row_groups, kLeftThreads, args,
                            smem, stream);
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

// K1 on a grid of `grid` CTAs of rows_per_cta rows each (the plan of
// ops/kernels.py::chain_resident_plan); u [2 n + grid] is scratch.
int chain_resident_launch(const float* zs, const float* x, const float* w, const float* v0,
                          float* u, float* out, int n, int n_iters, int grid, int rows_per_cta,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (grid < 1 || rows_per_cta < 1 || (long long)grid * rows_per_cta < n)
    return (int)cudaErrorInvalidValue;
  const size_t smem = resident_smem(n, rows_per_cta);
  err = allow_smem(chain_resident_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&zs, (void*)&x, (void*)&w, (void*)&v0, (void*)&u, (void*)&out,
                  (void*)&n, (void*)&n_iters, (void*)&rows_per_cta};
  return (int)launch_cooperative((const void*)chain_resident_kernel, grid, kThreads, args, smem,
                                 stream);
}

// K5, left: v0 and out [r, n]; prec 0 'highest', 1 'high', 2 'default'; the
// plan of ops/kernels.py::matvec_left_plan; wbuf [2 r ldk] is scratch
// (ldk = n rounded up to 4).
int matvec_chain_left_launch(const float* z, const float* v0, float* out, float* wbuf, int r,
                             int n, int n_iters, int prec, int col_groups,
                             int row_groups, int cols, int rows_per_group, int chunk,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (col_groups < 1 || row_groups < 1 || cols < 1 || rows_per_group < 1 || chunk < 1 ||
      chunk % kTileRows != 0 || (long long)col_groups * cols < n ||
      (long long)row_groups * rows_per_group < r)
    return (int)cudaErrorInvalidValue;
#define LEFT_LAUNCH(P)                                                                       \
  launch_left<P>(z, v0, out, wbuf, r, n, n_iters, col_groups, row_groups, cols,             \
                 rows_per_group, chunk, stream)
  if (prec == kHighest) return (int)LEFT_LAUNCH(kHighest);
  if (prec == kHigh) return (int)LEFT_LAUNCH(kHigh);
  if (prec == kDefault) return (int)LEFT_LAUNCH(kDefault);
#undef LEFT_LAUNCH
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
  return (int)launch_cooperative((const void*)chain_hbm_kernel, grid, kThreads, args, smem,
                                 stream);
}

}  // extern "C"
