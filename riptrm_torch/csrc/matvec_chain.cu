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
// K5 right.  Each column is its own chain, so no step is ever needed across
// column groups; the rows of Z are what is cut.  The plan
// (ops/kernels.py::matvec_right_plan) takes groups of gc = 8 (or 4) columns
// and cuts the n rows of Z into `slices` row slices of rs rows, so that
// groups x slices CTAs come near the SM count (16 groups x 8 slices of 16
// rows at [128, 128]; 128 groups x 1 slice at [128, 1024]); the slices of
// one group form one thread-block cluster (at most 8, the portable size).
// A CTA holds its rows of Z in shared memory (read as given, transposed on
// the copy, and for 'high' split once into hi and lo), or reads them
// through L2 when they do not fit beside the group's whole v (double-
// buffered by pass parity).  The product: a thread's 4 x 4 register tile
// of w (each Z float4 feeds 16 FMAs, v rows read as float4 broadcasts),
// the inner dimension split over the threads the tiles leave idle, the
// splits summed in one fixed order.  The exchange: each CTA writes its
// block of w and its per-column partial sum of squares into every peer's
// shared memory (distributed shared memory, cluster.map_shared_rank), then
// ONE cluster barrier per pass; every CTA sums the partials in the same
// order (the same bits in every CTA), divides, and has the whole next v
// locally.  With one slice the barrier is the CTA's own.  What bounds it:
// the FP32 FMAs (2 n^2 c per pass: ~0.5 us at [128, 1024] at the H100's
// 67 TFLOP/s) and, at [128, 128], the cluster barrier and the DSMEM writes.

// K5's precisions: every one accumulates in FP32 with FMA on the CUDA
// cores; 'high' and 'default' round the operands as the TPU does: 'high'
// is the bf16x3 split hi*hi + hi*lo + lo*hi, 'default' one product of
// bf16-rounded operands.  That rounding defines the function the JAX
// package times.
//
// K6.  What bounds it: the bytes of Zs, n^2 * 4 per iteration (64 MB at
// n = 4000, above the 50 MB L2), read from device memory.  A cooperative
// grid of one CTA per SM (ops/kernels.py::chain_hbm_plan).  In each CTA a
// producer warp claims rows of Zs from a per-iteration counter and streams
// them through a ring of shared-memory stages with 1-D bulk copies of the
// Tensor Memory Accelerator (chunks of at most 8 KB, up to 32 stages,
// full/empty mbarriers); kHbmWarps consumer warps take the dot products
// with v.  Claiming, not a fixed cut, because every CTA waits at the grid
// step for the slowest and the SMs draw unequal shares of the memory
// bandwidth (on an H100, a fixed cut of 30-31 rows at n = 4000 left CTA 0
// waiting ~5 us of its ~28 us iteration at the step, PERF.md).  Zs does
// not depend on v, so the producer runs on into the next iteration's rows
// while the consumers take the iteration's grid-wide step.  An iteration: the chunks' dot
// products, the CTA's rows of u = Zs v into a global u (by parity);  --
// grid step --  every CTA reads all of u and forms x.u, x.(w o v), Hw(v)
// and |Hw(v)|^2 itself in one order (K1's scheme: one step, the same bits
// everywhere).  The step is hand-rolled (one atomic add per CTA, as
// grid.sync() takes it) because grid.sync() would block the producer too.
// Where n % 4 != 0 (or Zs is not 16-byte aligned) the rows are not 16-byte
// aligned and the consumers load them themselves.

// Plain C interface for ctypes (riptrm_torch/ops/_build.py): each launcher
// returns cudaGetLastError() (or the launch's error) after the launch, 0 on
// success.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

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
constexpr int kRightRows = 4, kRightCols = 4;  // a K5-right thread's tile of w
constexpr int kRightTile = kRightRows * kRightCols;
constexpr int kHbmWarps = 8;  // K6's consumer warps (ops/kernels.py::HBM_WARPS)
constexpr int kHbmMaxStages = 32;  // its ring's most stages
constexpr int kHbmBatch = 16;  // u entries a K6 consumer loads at once
constexpr int kHbmConsumers = kHbmWarps * 32;
constexpr int kHbmThreads = kHbmConsumers + 32;  // and one producer warp
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

__host__ __device__ __forceinline__ int pad4(int n) { return (n + 3) & ~3; }

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
// K5, right: row slices of Z across a thread-block cluster
// ---------------------------------------------------------------------------
// Every barrier of a pass: the cluster's when the group has several slices,
// the CTA's own otherwise.
__device__ __forceinline__ void slices_sync(int slices) {
  if (slices > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// One thread's tile of w = Z v: rows [row0 + 4 rt, +4) of Z (tile % rts = rt)
// times columns [4 ct, +4) of the group (tile / rts = ct), over the inner
// indices j = q, q + split, ...  From the slice's rows in shared memory (zh,
// zl [n][rs], split once for the precision) or from Z in L2.
template <int PREC, int GC, bool ZS>
__device__ __forceinline__ void right_tile(float (&acc)[kRightTile], const float* __restrict__ z,
                                           const float* zh, const float* zl, const float* cur,
                                           int tile, int q, int nsplit, int n, int rs, int row0,
                                           int rows) {
  const int rts = rs / kRightRows, rt = tile % rts, ct = tile / rts;
#pragma unroll
  for (int e = 0; e < kRightTile; ++e) acc[e] = 0.f;
  const float4* v4 = reinterpret_cast<const float4*>(cur) + ct;
#pragma unroll 4
  for (int j = q; j < n; j += nsplit) {
    const float4 vv = v4[(size_t)j * (GC / 4)];
    float zha[kRightRows], zla[kRightRows];
    if (ZS) {
      const float4 h = reinterpret_cast<const float4*>(zh + (size_t)j * rs)[rt];
      zha[0] = h.x, zha[1] = h.y, zha[2] = h.z, zha[3] = h.w;
      if (PREC == kHigh) {
        const float4 l = reinterpret_cast<const float4*>(zl + (size_t)j * rs)[rt];
        zla[0] = l.x, zla[1] = l.y, zla[2] = l.z, zla[3] = l.w;
      }
    } else {
#pragma unroll
      for (int r = 0; r < kRightRows; ++r) {
        const int i = kRightRows * rt + r;
        split<PREC>(i < rows ? __ldg(z + (size_t)(row0 + i) * n + j) : 0.f, zha[r], zla[r]);
      }
    }
    float vh[kRightCols] = {vv.x, vv.y, vv.z, vv.w}, vl[kRightCols];
    if (PREC != kHighest)
#pragma unroll
      for (int k = 0; k < kRightCols; ++k) {
        const float h = bf16_round(vh[k]);
        vl[k] = bf16_round(vh[k] - h);
        vh[k] = h;
      }
#pragma unroll
    for (int r = 0; r < kRightRows; ++r)
#pragma unroll
      for (int k = 0; k < kRightCols; ++k) {
        float& a = acc[r * kRightCols + k];
        a = fmaf(zha[r], vh[k], a);
        if (PREC == kHigh) a = fmaf(zla[r], vh[k], fmaf(zha[r], vl[k], a));
      }
  }
}

// CTA (group, slice) of a cluster of `slices` CTAs (slice = block_rank()):
// the group's GC columns of v (col0 = group GC; a ragged last group is
// zero-padded) and the slice's rs rows of Z (row0 = slice rs).  Dynamic
// shared memory (floats), as ops/kernels.py::matvec_right_plan counts it:
// V [2][np][GC] (the group's whole v by pass parity, np = slices rs rows,
// the pad rows zero), when ZS the slice's rows of Z transposed, zh [n][rs]
// and for 'high' zl [n][rs], red [kRightThreads][kRightTile] when the inner
// dimension is split, part [2][slices][GC] (the slices' column sums of
// squares by parity).
template <int PREC, int GC, bool ZS>
__global__ void __launch_bounds__(kRightThreads)
chain_right_kernel(const float* __restrict__ z, const float* __restrict__ v0,
                   float* __restrict__ out, int n, int c, int n_iters, int rs, int slices) {
  static_assert(GC % kRightCols == 0 && GC <= kRightThreads / 32 && kRightThreads % GC == 0,
                "a warp per column; a thread's entries in one column");
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int slice = slices > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int col0 = (blockIdx.x / slices) * GC, row0 = slice * rs;
  const int gw = min(GC, c - col0);
  const int rows = max(0, min(n, row0 + rs) - row0);
  const int np = rs * slices, rts = rs / kRightRows, tiles = rts * (GC / kRightCols);
  const int nsplit = tiles < kRightThreads ? kRightThreads / tiles : 1;
  float* V = smem;
  float* zh = V + 2 * (size_t)np * GC;
  float* zl = zh + (ZS ? (size_t)n * rs : 0);
  float* red = zl + (ZS && PREC == kHigh ? (size_t)n * rs : 0);
  float* part = red + (nsplit > 1 ? kRightThreads * kRightTile : 0);

  if (n_iters == 0) {
    for (int idx = tid; idx < rows * gw; idx += kRightThreads) {
      const int i = idx / gw, k = idx - i * gw;
      out[(size_t)(row0 + i) * c + col0 + k] = v0[(size_t)(row0 + i) * c + col0 + k];
    }
    return;
  }
  for (int idx = tid; idx < np * GC; idx += kRightThreads) {
    const int i = idx / GC, k = idx % GC;
    V[idx] = i < n && k < gw ? v0[(size_t)i * c + col0 + k] : 0.f;
  }
  if (ZS)
    for (int idx = tid; idx < rs * n; idx += kRightThreads) {
      const int j = idx / rs, i = idx - j * rs;  // neighbouring threads, neighbouring banks
      float h, l;
      split<PREC>(i < rows ? z[(size_t)(row0 + i) * n + j] : 0.f, h, l);
      zh[(size_t)j * rs + i] = h;
      if (PREC == kHigh) zl[(size_t)j * rs + i] = l;
    }
  slices_sync(slices);  // the cluster runs before any CTA writes to a peer

  // From shared memory, neighbouring threads take neighbouring tiles at one
  // j (V read as a broadcast, Z as consecutive float4s); from L2,
  // neighbouring j of one tile (a warp reads along rows of Z).
  const int tile = ZS || nsplit == 1 ? tid % tiles : tid / nsplit;
  const int q = ZS || nsplit == 1 ? tid / tiles : tid % nsplit;
  const int kcol = tid % GC;
  float norm = 1.f;
  for (int it = 0; it < n_iters; ++it) {
    const float* cur = V + (size_t)(it & 1) * np * GC;
    float* nxt = V + (size_t)((it + 1) & 1) * np * GC;
    float acc[kRightTile];
    if (nsplit > 1) {
      if (tid < nsplit * tiles) {
        right_tile<PREC, GC, ZS>(acc, z, zh, zl, cur, tile, q, nsplit, n, rs, row0, rows);
        float4* r4 = reinterpret_cast<float4*>(red + (size_t)(q * tiles + tile) * kRightTile);
#pragma unroll
        for (int e = 0; e < kRightTile / 4; ++e)
          r4[e] = make_float4(acc[4 * e], acc[4 * e + 1], acc[4 * e + 2], acc[4 * e + 3]);
      }
    } else {
      for (int t = tid; t < tiles; t += kRightThreads) {
        right_tile<PREC, GC, ZS>(acc, z, zh, zl, cur, t, 0, 1, n, rs, row0, rows);
        const int rt = t % rts, ct = t / rts;
#pragma unroll
        for (int r = 0; r < kRightRows; ++r)
          reinterpret_cast<float4*>(nxt + (size_t)(row0 + kRightRows * rt + r) * GC)[ct] =
              make_float4(acc[4 * r], acc[4 * r + 1], acc[4 * r + 2], acc[4 * r + 3]);
      }
    }
    __syncthreads();
    // warp k, column k of the slice's block of w: the splits summed in order
    // into this CTA's V, and the column's sum of squares into every CTA's
    // part (lane l writes rank l's); then the block into every peer's V
    float* pp = part + (size_t)((it + 1) & 1) * slices * GC;
    if (warp < GC) {
      const int k = warp, e0 = k % kRightCols, ct = k / kRightCols;
      float ss = 0.f;
      for (int i = lane; i < rows; i += 32) {
        const size_t at = (size_t)(row0 + i) * GC + k;
        float w;
        if (nsplit > 1) {
          const float* rp = red + (size_t)(i / kRightRows + rts * ct) * kRightTile +
                            (i % kRightRows) * kRightCols + e0;
          w = 0.f;
          for (int u = 0; u < nsplit; ++u) w += rp[(size_t)u * tiles * kRightTile];
          nxt[at] = w;
        } else {
          w = nxt[at];
        }
        ss = fmaf(w, w, ss);
      }
      ss = warp_sum(ss);
      if (lane < slices)
        (slices > 1 ? cg::this_cluster().map_shared_rank(pp, lane) : pp)[slice * GC + k] = ss;
    }
    if (slices > 1) {
      __syncthreads();
      copy_to_peers(nxt + (size_t)row0 * GC, rs * GC / 4, slices, slice, kRightThreads);
    }
    slices_sync(slices);  // the one step of the pass across the cluster
    // a thread's entries all lie in column tid % GC (kRightThreads % GC == 0):
    // it sums that column's partials itself, in the order every CTA does
    norm = sqrtf(slice_sum(pp + kcol, GC, slices) + 1e-30f);
    if (it + 1 < n_iters) {
      for (int idx = tid; idx < np * GC; idx += kRightThreads) nxt[idx] = nxt[idx] / norm;
      __syncthreads();
    }
  }
  const float* last = V + (size_t)(n_iters & 1) * np * GC;
  if (kcol < gw)
    for (int i = tid / GC; i < rows; i += kRightThreads / GC)
      out[(size_t)(row0 + i) * c + col0 + kcol] = last[(size_t)(row0 + i) * GC + kcol] / norm;
}

// ---------------------------------------------------------------------------
// K6: Zs streamed from device memory through a ring of bulk copies
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory by the Tensor Memory Accelerator; the barrier's phase
// completes when they have landed.
__device__ __forceinline__ void bulk_load(float* dst, const float* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A barrier of the consumer warps alone (the producer never waits on it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kHbmConsumers) : "memory");
}

struct ConsumersSync {
  __device__ __forceinline__ void operator()() const { consumers_sync(); }
};

// A grid-wide step taken by one thread of each CTA of a co-resident grid
// (the CTA's other consumers wait for it at consumers_sync), as
// cooperative_groups' grid.sync() takes it: one atomic add per CTA on one
// word (zero before the first step), CTA 0 adding 2^31 - (nb - 1) and the
// others 1, so the word's top bit flips when the last CTA arrives; each CTA
// spins until it sees its own add's top bit flipped.  The fence publishes
// what the CTA wrote before the step; the acquiring load makes visible
// what the others did.
__device__ __forceinline__ void grid_step(unsigned* bar, unsigned nb) {
  __threadfence();
  const unsigned old = atomicAdd(bar, blockIdx.x == 0 ? 0x80000000u - (nb - 1) : 1u);
  unsigned now;
  do {
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(now) : "l"(bar) : "memory");
  } while (((old ^ now) & 0x80000000u) == 0);
}

// The rows of Zs go to the CTAs as they stream, not by a fixed cut: every
// CTA waits at the grid step for the slowest, and SMs draw unequal shares of
// the card's memory bandwidth, so each CTA's producer claims rows one at a
// time from a per-iteration counter (claims[it], zero on entry), the next
// claim in flight while the current row's chunks are issued; a CTA claims
// at most `cap` rows an iteration.  A row is cut into `pieces` chunks of at
// most `piece` floats (a multiple of 4).  The producer numbers its chunks
// on across iterations: chunk q lands in stage q % stages (a multiple of
// kHbmWarps) with a tag (iteration, slot, piece, row), slot being the
// row's place among the CTA's rows of that iteration, and is consumed by
// warp q % kHbmWarps, so each stage has one consumer, which sees its
// phases in order.  After an iteration's rows the producer records their
// number and issues one empty end chunk per warp.  It claims rows for
// iteration j only once the consumers have read their rows of j - 2 (the
// row table and the counts are double-buffered by parity).  Dynamic shared
// memory (floats), as ops/kernels.py::chain_hbm_plan counts it: the stages
// [stages][piece], v [n rounded up to 4], dot [cap][pieces] (the chunks'
// dot products), rowid [2][cap] (ints), and when xw_shared x and w [n
// rounded up to 4 each] (read from global memory otherwise).  Scratch: u_g
// [2 n] (Zs v, by iteration parity), bar [1] and claims [n_iters] (zero).
// v is kept as the last iteration's Hw(v) itself, with its norm nrm: the
// rows' dot products are divided by nrm, and every CTA forms the next
// Hw(v) = a + x (2 x.u - x.(w o v)), a = -2 u + (corr + w) o v, from all of
// u, x and w (K1's scheme), so an iteration takes one grid step.  Without
// BULK (n % 4 != 0, or Zs not 16-byte aligned) the consumers read the rows
// from global memory themselves; the producer still claims and tags them.
template <bool BULK>
__global__ void __launch_bounds__(kHbmThreads)
chain_hbm_kernel(const float* __restrict__ zs, const float* __restrict__ x_g,
                 const float* __restrict__ w_g, const float* __restrict__ v0,
                 const float* __restrict__ corr_g, float* u_g, unsigned* bar, int* claims,
                 float* __restrict__ out, int n, int n_iters, int pieces, int piece,
                 int stages, int cap, int xw_shared) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t full[kHbmMaxStages], empty[kHbmMaxStages];
  __shared__ int4 tag[kHbmMaxStages];  // iteration, slot (-1: the end), piece, row
  __shared__ float red[kMaxSums * kHbmWarps + kMaxSums];
  __shared__ int nrows[2];
  __shared__ int consumer_iter;  // the iteration whose rows the consumers have read
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nb = gridDim.x, b = blockIdx.x;
  const int ldk = pad4(n);
  float* stage = smem;
  float* v = stage + (size_t)stages * piece;
  float* dot = v + ldk;
  int* rowid = reinterpret_cast<int*>(dot + (size_t)cap * pieces);
  float* xs = reinterpret_cast<float*>(rowid + 2 * cap);
  float* ws = xs + ldk;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    consumer_iter = -1;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kHbmWarps) {
    // The producer: claims rows and streams them, iteration after
    // iteration, as soon as a stage is free.  The copies never wait for v,
    // so while the consumers take an iteration's grid step the next
    // iteration's first rows are already landing.
    if (lane == 0 && n_iters > 0) {
      int q = 0;
      auto next_stage = [&](int4 t) {
        const int s = q % stages;
        mbar_wait(&empty[s], ((unsigned)(q / stages) & 1u) ^ 1u);
        tag[s] = t;
        ++q;
        return s;
      };
      for (int it = 0; it < n_iters; ++it) {
        while (*(volatile int*)&consumer_iter < it - 2) __nanosleep(64);
        int count = 0, row = atomicAdd(claims + it, 1);
        while (row < n) {
          const int next = count + 1 < cap ? atomicAdd(claims + it, 1) : n;
          rowid[(it & 1) * cap + count] = row;
          for (int p = 0; p < pieces; ++p) {
            const int s = next_stage(make_int4(it, count, p, row));
            if (BULK) {
              const int len = min(piece, n - p * piece);
              bulk_load(stage + (size_t)s * piece, zs + (size_t)row * n + (size_t)p * piece,
                        4u * len, &full[s]);
            } else {
              mbar_arrive(&full[s]);
            }
          }
          ++count;
          row = next;
        }
        nrows[it & 1] = count;
        for (int k = 0; k < kHbmWarps; ++k) mbar_arrive(&full[next_stage(make_int4(it, -1, 0, 0))]);
      }
    }
    return;
  }

  const float corr = corr_g[0];
  float nrm = 1.f;  // |v| (v0 is taken as it is)
  for (int i = threadIdx.x; i < n; i += kHbmConsumers) {
    v[i] = v0[i];
    if (xw_shared) {
      xs[i] = x_g[i];
      ws[i] = w_g[i];
    }
  }
  const float* xp = xw_shared ? xs : x_g;
  const float* wp = xw_shared ? ws : w_g;
  consumers_sync();
  int q = warp;  // this warp's next chunk
  for (int it = 0; it < n_iters; ++it) {
    for (;; q += kHbmWarps) {  // this iteration's chunks, up to the warp's end chunk
      const int s = q % stages;
      mbar_wait(&full[s], (unsigned)(q / stages) & 1u);
      const int4 t = tag[s];
      if (t.y >= 0) {
        const int p = t.z, len = min(piece, n - p * piece);
        const float* vp = v + (size_t)p * piece;
        float acc = 0.f;
        if (BULK) {
          const float4* z4 = reinterpret_cast<const float4*>(stage + (size_t)s * piece);
          const float4* v4 = reinterpret_cast<const float4*>(vp);
#pragma unroll 4
          for (int k = lane; k < len / 4; k += 32) acc = mac4<kHighest>(z4[k], v4[k], acc);
        } else {
          const float* zr = zs + (size_t)t.w * n + (size_t)p * piece;
#pragma unroll 4
          for (int k = lane; k < len; k += 32) acc = fmaf(__ldg(zr + k), vp[k], acc);
        }
        acc = warp_sum(acc);
        if (lane == 0) dot[t.y * pieces + p] = acc;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (t.y < 0) {
        q += kHbmWarps;
        break;
      }
    }
    consumers_sync();
    float* u = u_g + (size_t)(it & 1) * n;
    const int* rid = rowid + (it & 1) * cap;
    for (int r = threadIdx.x; r < nrows[it & 1]; r += kHbmConsumers) {
      float zv = 0.f;
      for (int p = 0; p < pieces; ++p) zv += dot[r * pieces + p];
      u[rid[r]] = zv / nrm;  // Zs v for v = the kept vector / nrm
    }
    consumers_sync();
    if (threadIdx.x == 0) {
      *(volatile int*)&consumer_iter = it;  // this iteration's rows are read
      grid_step(bar, nb);  // the iteration's one step
    }
    consumers_sync();
    // every CTA: the whole Hw(v) from all of u, in the same order; a
    // thread's loads of u are issued together (one L2 round trip, while
    // the stream loads the L2, per kHbmBatch entries)
    float s[2] = {0.f, 0.f};
    for (int i0 = threadIdx.x; i0 < n; i0 += kHbmBatch * kHbmConsumers) {
      float uu[kHbmBatch];
#pragma unroll
      for (int k = 0; k < kHbmBatch; ++k) {
        const int i = i0 + k * kHbmConsumers;
        uu[k] = i < n ? __ldcg(u + i) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kHbmBatch; ++k) {
        const int i = i0 + k * kHbmConsumers;
        if (i < n) {
          const float vi = v[i] / nrm, xi = xp[i], wi = wp[i];
          s[0] += xi * uu[k];
          s[1] += xi * (wi * vi);
          v[i] = -2.f * uu[k] + (corr + wi) * vi;
        }
      }
    }
    block_sum<kHbmWarps, kMaxSums>(s, red, ConsumersSync());
    const float c = 2.f * s[0] - s[1];
    float s2[1] = {0.f};
    for (int i = threadIdx.x; i < n; i += kHbmConsumers) {
      const float h = fmaf(xp[i], c, v[i]);
      v[i] = h;
      s2[0] += h * h;
    }
    block_sum<kHbmWarps, kMaxSums>(s2, red, ConsumersSync());  // v whole after it
    nrm = sqrtf(s2[0]);
  }
  const int base = n / nb, extra = n % nb;  // the output: a fixed cut of the rows
  const int row0 = b * base + min(b, extra), rows = base + (b < extra ? 1 : 0);
  for (int r = threadIdx.x; r < rows; r += kHbmConsumers)
    out[row0 + r] = n_iters == 0 ? v0[row0 + r] : v[row0 + r] / nrm;
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

// The layout of chain_right_kernel, as ops/kernels.py::matvec_right_plan
// counts it.
size_t right_smem(int n, int rs, int slices, int gc, bool zs_shared, int prec) {
  const int tiles = rs / kRightRows * (gc / kRightCols);
  const int nsplit = tiles < kRightThreads ? kRightThreads / tiles : 1;
  size_t floats = 2 * (size_t)rs * slices * gc + 2 * (size_t)slices * gc;
  if (zs_shared) floats += (size_t)(prec == kHigh ? 2 : 1) * n * rs;
  if (nsplit > 1) floats += (size_t)kRightThreads * kRightTile;
  return floats * sizeof(float);
}

template <int PREC, int GC, bool ZS>
cudaError_t launch_right(const float* z, const float* v0, float* out, int n, int c, int n_iters,
                         int rs, int slices, cudaStream_t stream) {
  auto kernel = chain_right_kernel<PREC, GC, ZS>;
  const size_t smem = right_smem(n, rs, slices, GC, ZS, PREC);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((c + GC - 1) / GC * slices);
  cfg.blockDim = dim3(kRightThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, z, v0, out, n, c, n_iters, rs, slices);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the refusal is reported here, not later
    return err;
  }
  return cudaGetLastError();
}

template <int PREC>
cudaError_t launch_right_cols(const float* z, const float* v0, float* out, int n, int c,
                              int n_iters, int gc, int rs, int slices, int zs_shared,
                              cudaStream_t st) {
  if (gc == 8)
    return zs_shared ? launch_right<PREC, 8, true>(z, v0, out, n, c, n_iters, rs, slices, st)
                     : launch_right<PREC, 8, false>(z, v0, out, n, c, n_iters, rs, slices, st);
  return zs_shared ? launch_right<PREC, 4, true>(z, v0, out, n, c, n_iters, rs, slices, st)
                   : launch_right<PREC, 4, false>(z, v0, out, n, c, n_iters, rs, slices, st);
}

// The layout of chain_hbm_kernel, as ops/kernels.py::chain_hbm_plan counts it.
size_t hbm_smem(int n, int pieces, int piece, int stages, int cap, int xw_shared) {
  return ((size_t)stages * piece + (size_t)pad4(n) * (xw_shared ? 3 : 1) +
          (size_t)cap * (pieces + 2)) *
         sizeof(float);
}

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

// K5, right: v0 and out [n, c]; groups of gc (4 or 8) columns, each a
// cluster of `slices` CTAs of rs rows of Z (the plan of
// ops/kernels.py::matvec_right_plan); Z in shared memory when zs_shared.
int matvec_chain_right_launch(const float* z, const float* v0, float* out, int n, int c,
                              int n_iters, int prec, int gc, int slices, int rs, int zs_shared,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((gc != 4 && gc != 8) || slices < 1 || slices > 8 || rs < kRightRows ||
      rs % kRightRows != 0 || (long long)rs * slices < n || c < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RIGHT_LAUNCH(P) launch_right_cols<P>(z, v0, out, n, c, n_iters, gc, rs, slices, zs_shared, st)
  if (prec == kHighest) return (int)RIGHT_LAUNCH(kHighest);
  if (prec == kHigh) return (int)RIGHT_LAUNCH(kHigh);
  if (prec == kDefault) return (int)RIGHT_LAUNCH(kDefault);
#undef RIGHT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// K6 on a cooperative grid of `grid` CTAs (grid <= n; the rows of Zs cut in
// `pieces` chunks of at most `piece` floats, a multiple of 4, through a
// ring of `stages` stages, a multiple of the consumer warps; x and w in
// shared memory when xw_shared: the plan of ops/kernels.py::chain_hbm_plan);
// u [2 n], bar [1] and claims [n_iters] (both zero) are scratch.
int chain_hbm_launch(const float* zs, const float* x, const float* w, const float* v0,
                     const float* corr, float* u, unsigned* bar, int* claims, float* out,
                     int n, int n_iters, int grid, int pieces, int piece, int stages,
                     int xw_shared, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (grid < 1 || grid > n || pieces < 1 || piece < 4 || piece % 4 != 0 ||
      (long long)pieces * piece < n || stages < kHbmWarps || stages > kHbmMaxStages ||
      stages % kHbmWarps != 0 || (long long)n_iters * (n * (long long)pieces + kHbmWarps) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int cap = min(n, 2 * ((n + grid - 1) / grid));  // ops/kernels.py::chain_hbm_plan
  const size_t smem = hbm_smem(n, pieces, piece, stages, cap, xw_shared);
  const bool bulk = n % 4 == 0 && aligned16(zs);
  err = bulk ? allow_smem(chain_hbm_kernel<true>, smem) : allow_smem(chain_hbm_kernel<false>, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&zs,     (void*)&x,      (void*)&w,       (void*)&v0,
                  (void*)&corr,   (void*)&u,      (void*)&bar,     (void*)&claims,
                  (void*)&out,    (void*)&n,      (void*)&n_iters, (void*)&pieces,
                  (void*)&piece,  (void*)&stages, (void*)&cap,     (void*)&xw_shared};
  const void* kernel = bulk ? (const void*)chain_hbm_kernel<true> : (const void*)chain_hbm_kernel<false>;
  return (int)launch_cooperative(kernel, grid, kHbmThreads, args, smem, stream);
}

}  // extern "C"
