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
//                       computes that function once.
//
// What bounds it on an H100: a call lasts as long as its slowest lane, and a
// lane's tCG iterations are dependent, so the target is one lane's iteration
// latency.  Its work is the product Zs V (2 n^2 p flops, in full float32 FMA
// on the CUDA cores: no TF32, no bf16 splitting; the BoundedPCA inner loop
// never meets its complementarity criterion at TF32-class matvec noise),
// two projections and a handful of Frobenius dots.
//
// The design.  A lane runs on a thread-block cluster of `slices` CTAs (1, 2,
// 4 or 8; the plan, ops/kernels.py::stiefel_plan, takes the largest with
// B x slices <= SMs).  CTA s holds rows [s rows, (s + 1) rows) of the
// lane: its slice of Zs (columns of Zs, read as rows by symmetry) in
// shared memory, or read through L2 where the slice does not fit; its rows
// of the frames X, W, G, eta, Heta, r; and the whole of delta, which the
// product reads.  An iteration computes what ops/tcg.py::truncated_cg
// does, in its order, through four exchanges: the slice's partial sums go
// to every peer's receive slot as float4 blocks, then ONE cluster barrier
// (a CTA barrier at one slice), after which every CTA sums the slices in
// order (the same bits everywhere):
//   1. the product: a warp takes 32 rows (a lane a row) and 8 columns of
//      Zs delta and sums Zs[i, j] delta[j, :] over its share of j in 8
//      registers: each Zs load feeds 8 FMAs, the warp's 32 rows of Zs are
//      one 128-byte read, and delta's row is read by the whole warp at one
//      address (a broadcast); where the slice has fewer such tasks than
//      warps the spare warps split j and their sums meet in shared memory.
//      (Four or two rows a lane, to read delta's row once for more FMAs,
//      measured slower on the H100: PERF.md.)  The epilogue forms the
//      unprojected Hw entries HU; exchanged: sym(X'HU), p(p+1)/2 numbers, a
//      warp each, its lanes over the rows, summed by a shuffle tree.
//   2. HD = HU - X sym(X'HU) on the rows; exchanged: d_hd = <delta, HD>.
//   3. the model at the CG point and |r_new|^2 (the warps' partials).
//   4. t = -r_new + beta delta on the rows; exchanged: sym(X't), whence
//      delta_new = t - X sym(X't), whose rows then go to every peer's
//      delta before the next product; skipped when the lane stops.
// (Folding d_hd into exchange 1, as <delta, HU> - <sym(X'delta),
// sym(X'HU)>, and sym(X't) into exchange 3, as -sym(X'r_new) + beta
// sym(X'delta), saves two exchanges, but its rounding stalled more
// St(128, 8) lanes of the BoundedPCA sweeps: PERF.md.)
// Every CTA of a cluster takes the same stop decision from the same sums;
// a lane leaves its loop when it stops, which gives the outputs of the TPU
// kernels' frozen lanes.
//
// Plain C interface for ctypes (riptrm_torch/ops/_build.py): the launcher
// returns cudaGetLastError() (or the launch's error) after the launch, 0 on
// success.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "reduce.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;  // ops/kernels.py::STIEFEL_THREADS
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float safe_div(float a, float b) { return a / (b == 0.f ? 1.f : b); }

__host__ __device__ __forceinline__ int pad4(int n) { return (n + 3) & ~3; }

// Every barrier of an exchange: the cluster's when the lane has several
// slices, the CTA's own otherwise.
__device__ __forceinline__ void slices_sync(int slices) {
  if (slices > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// The row stride of the slice's Zs in shared memory ([n][ldr], row j holding
// Zs[j, row0 : row0 + rows], zero-padded to whole warps of 32 rows).
__host__ __device__ __forceinline__ int zs_ld(int rows) { return (rows + 31) / 32 * 32; }

// The floats of shared memory the kernel carves (ops/kernels.py::stiefel_plan
// counts the same), each section rounded up to 4 floats.
struct Layout {
  int zt, d, frames, pmat, part, recv1, recv2, recv3, recv4, pairs, total;
  __host__ __device__ Layout(int n, int p, int pc, int slices, int rows, int splits, bool zs) {
    const int np2 = p * (p + 1) / 2;
    zt = 0;
    d = zt + (zs ? n * zs_ld(rows) : 0);
    frames = d + n * (pc + 4);
    pmat = frames + pad4(7 * rows * (pc + 1));
    part = pmat + 3 * pc * pc + pc;
    recv1 = part + (splits > 1 ? splits * rows * (pc + 4) : 0);
    recv2 = recv1 + slices * pad4(np2);
    recv3 = recv2 + slices * 4;
    recv4 = recv3 + slices * 4;
    pairs = recv4 + slices * pad4(np2);
    total = pairs + pad4(np2);
  }
};

// A lane's share of an exchange's pair task: over the slice's rows i =
// lane, lane + 32, ..., the pair (a, b) = pairs[q] gives A[i][a] B[i][b] +
// A[i][b] B[i][a] (twice sym(A'B)[a, b]); rows of A of stride lda, of B
// ldb.
__device__ __forceinline__ float pair_rows(const float* A, int lda, const float* B, int ldb,
                                           int ab, int rows) {
  const int a = ab >> 8, b = ab & 255;
  float acc = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x & 31; i < rows; i += 32) {
    acc = fmaf(A[i * lda + a], B[i * ldb + b], acc);
    acc = fmaf(A[i * lda + b], B[i * ldb + a], acc);
  }
  return acc;
}

// The slice's q partials of an exchange into this CTA's slot of `recv`
// ([slices][qp]): a warp an entry, each lane's share `task(t)` summed by a
// shuffle tree; then the slot copied to every peer's and published by the
// exchange's barrier.
template <typename Task>
__device__ __forceinline__ void exchange(Task task, int q, int qp, float* recv, int slices,
                                         int slice) {
  float* mine = recv + (size_t)slice * qp;
  for (int t = threadIdx.x >> 5; t < q; t += kWarps) {
    const float v = warp_sum(task(t));
    if ((threadIdx.x & 31) == 0) mine[t] = v;
  }
  if (slices > 1) {
    __syncthreads();
    copy_to_peers(mine, qp / 4, slices, slice, kThreads);
  }
  slices_sync(slices);
}

// Lane blockIdx.x / slices on a cluster of `slices` CTAs, this one holding
// rows [row0, row0 + rows) (the last slice fewer); PC: p rounded up to 8,
// 16 or 32 (the pad columns hold zeros throughout); ZS: the slice's Zs in
// shared memory, else read through L2.  Shared memory (floats), as Layout
// carves it: zt [n][ldr] (ZS), delta [n][pc + 4], the slice's rows of X, W,
// G, eta, Heta, r and of Hw (unprojected, projected, then t), each of row
// stride pc + 1 ([7][rows][pc + 1]), S, sym(X'HU) and sym(X't) ([pc][pc]
// each) and d, the product's split sums (`part`), the four exchanges'
// receive slots ([slices][entries rounded up to 4] each), the pair table.
template <int PC, bool ZS>
__global__ void __launch_bounds__(kThreads, 1)
stiefel_tcg_kernel(const float* __restrict__ zs, const float* __restrict__ dg,
                   const float* __restrict__ xs, const float* __restrict__ ws,
                   const float* __restrict__ ss, const float* __restrict__ grads,
                   const float* __restrict__ radii, float* __restrict__ etas,
                   float* __restrict__ hetas, int* __restrict__ stats, int n, int p,
                   int maxinner, int mininner, float theta, float kappa, int slices, int rows,
                   int splits) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float wred[kWarps][4];  // the warps' partial sums: exchanges 2 and 3
  __shared__ float red[2 * kWarps + 2];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int slice = slices > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int b = blockIdx.x / slices;
  const int row0 = slice * rows, myrows = max(0, min(n, row0 + rows) - row0);
  // delta's rows float4-aligned; the frames' rows of odd stride, so a warp
  // reading one column of 32 rows hits 32 banks
  const int ldd = PC + 4, ldf = PC + 1, ldr = zs_ld(rows);
  const int np2 = p * (p + 1) / 2, qp = pad4(np2);
  const Layout lay(n, p, PC, slices, rows, splits, ZS);
  float* zt = smem + lay.zt;
  float* D = smem + lay.d;
  float* X = smem + lay.frames;
  float* W = X + rows * ldf;
  float* G = W + rows * ldf;
  float* ETA = G + rows * ldf;
  float* HETA = ETA + rows * ldf;
  float* R = HETA + rows * ldf;
  float* HB = R + rows * ldf;
  float* Sm = smem + lay.pmat;
  float* Cs = Sm + PC * PC;
  float* Ts = Cs + PC * PC;
  float* dv = Ts + PC * PC;
  float* part = smem + lay.part;
  float* recv1 = smem + lay.recv1;
  float* recv2 = smem + lay.recv2;
  float* recv3 = smem + lay.recv3;
  float* recv4 = smem + lay.recv4;
  int* pairs = reinterpret_cast<int*>(smem + lay.pairs);
  const size_t off = (size_t)b * n * p;

  if (ZS)
    for (int idx = tid; idx < n * ldr; idx += kThreads) {
      const int j = idx / ldr, i = idx - j * ldr;
      zt[idx] = i < myrows ? zs[(size_t)j * n + row0 + i] : 0.f;
    }
  // delta = -G whole in every CTA: the first product needs no exchange
  float s0[1] = {0.f};
  for (int idx = tid; idx < n * ldd; idx += kThreads) {
    const int j = idx / ldd, k = idx - j * ldd;
    const float g = k < p ? grads[off + (size_t)j * p + k] : 0.f;
    D[idx] = -g;
    s0[0] += g * g;
  }
  for (int idx = tid; idx < rows * ldf; idx += kThreads) {
    const int i = idx / ldf, k = idx - i * ldf;
    const bool in = i < myrows && k < p;
    const size_t at = off + (size_t)(row0 + i) * p + k;
    const float g = in ? grads[at] : 0.f;
    X[idx] = in ? xs[at] : 0.f;
    W[idx] = in ? ws[at] : 0.f;
    G[idx] = g;
    ETA[idx] = 0.f;
    HETA[idx] = 0.f;
    R[idx] = g;
    HB[idx] = 0.f;
  }
  for (int idx = tid; idx < PC * PC; idx += kThreads) {
    const int a = idx / PC, c = idx - a * PC;
    Sm[idx] = a < p && c < p ? ss[(size_t)b * p * p + a * p + c] : 0.f;
    Cs[idx] = Ts[idx] = 0.f;
  }
  for (int k = tid; k < PC; k += kThreads) dv[k] = k < p ? dg[k] : 0.f;
  for (int q = tid; q < np2; q += kThreads) {  // pair q = (a, c), a <= c, row-major
    int a = 0, rem = q;
    while (rem >= p - a) rem -= p - a++;
    pairs[q] = a << 8 | (a + rem);
  }
  block_sum<kWarps, 2>(s0, red);  // its barriers publish the loads above
  slices_sync(slices);            // and the cluster runs before any peer write

  const float radius = radii[b];
  const float rad2 = radius * radius;
  // truncated_cg's target: |r0| min(|r0|^theta, kappa), linear: kappa < |r0|^theta
  const float norm_r0 = sqrtf(s0[0]), powr = powf(norm_r0, theta);
  const float target = norm_r0 * fminf(powr, kappa);
  const bool linear = kappa < powr;
  float z_r = s0[0], e_pe = 0.f, d_pd = z_r, e_pd = 0.f, model = 0.f;
  int j = 0, code = 0;
  bool done = maxinner <= 0;
  // The product's tasks: warp t takes the 32 rows [32 rb, +32) of the slice
  // (a lane a row), the 8 columns [8 cg, +8) and j = s, s + K, ...; with
  // fewer (rb, cg) than warps the plan's K = `splits` splits of j go to the
  // spare warps and their sums meet in `part` ([K][rows][PC + 4]), summed
  // in split order.
  const int nrb = (rows + 31) / 32, ntask = nrb * (PC / 8), K = splits;
  const int ldp = PC + 4;
  // the unprojected Hw entry from u = (Zs delta)[i, k]
  auto hu_entry = [&](int i, int k, float u) {
    const float* di = D + (size_t)(row0 + i) * ldd;
    float vs = 0.f;
    for (int l = 0; l < p; ++l) vs = fmaf(di[l], Sm[l * PC + k], vs);
    HB[i * ldf + k] = -2.f * u * dv[k] - vs + W[i * ldf + k] * di[k];
  };
  while (!done) {
    // -- exchange 1: HU = -2 (Zs delta) d - delta S + W o delta on the rows
    for (int t = warp; t < ntask * K; t += kWarps) {
      const int rb = t % nrb, cg = (t / nrb) % (PC / 8), sp = t / ntask;
      const int i = rb * 32 + lane;
      const bool live = i < myrows;
      const float4* dcol = reinterpret_cast<const float4*>(D) + 2 * cg;
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int j = sp; j < n; j += K) {
        // Zs[i, j] (by symmetry), the lanes' 32 rows side by side; delta's
        // row j read by the whole warp at one address
        const float z = ZS ? zt[(size_t)j * ldr + i]
                           : (live ? __ldg(zs + (size_t)j * n + row0 + i) : 0.f);
        const float4 v0 = dcol[(size_t)j * (ldd / 4)], v1 = dcol[(size_t)j * (ldd / 4) + 1];
        acc[0] = fmaf(z, v0.x, acc[0]);
        acc[1] = fmaf(z, v0.y, acc[1]);
        acc[2] = fmaf(z, v0.z, acc[2]);
        acc[3] = fmaf(z, v0.w, acc[3]);
        acc[4] = fmaf(z, v1.x, acc[4]);
        acc[5] = fmaf(z, v1.y, acc[5]);
        acc[6] = fmaf(z, v1.z, acc[6]);
        acc[7] = fmaf(z, v1.w, acc[7]);
      }
      if (!live) continue;
      if (K == 1) {
#pragma unroll
        for (int c = 0; c < 8; ++c) hu_entry(i, 8 * cg + c, acc[c]);
      } else {
        float4* out = reinterpret_cast<float4*>(part + ((size_t)sp * rows + i) * ldp + 8 * cg);
        out[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
        out[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
      }
    }
    if (K > 1) {
      __syncthreads();
      for (int idx = tid; idx < myrows * PC; idx += kThreads) {
        const int i = idx / PC, k = idx - i * PC;
        float u = 0.f;
        for (int sp = 0; sp < K; ++sp) u += part[((size_t)sp * rows + i) * ldp + k];
        hu_entry(i, k, u);
      }
    }
    __syncthreads();
    exchange([&](int q) { return pair_rows(X, ldf, HB, ldf, pairs[q], myrows); }, np2, qp,
             recv1, slices, slice);
    for (int q = tid; q < np2; q += kThreads) {
      const int a = pairs[q] >> 8, c = pairs[q] & 255;
      Cs[a * PC + c] = Cs[c * PC + a] = 0.5f * slice_sum(recv1 + q, qp, slices);
    }
    __syncthreads();
    // -- exchange 2: HD = HU - X sym(X'HU) on the rows, and d_hd = <delta, HD>
    float dhd = 0.f;
    for (int idx = tid; idx < myrows * PC; idx += kThreads) {
      const int i = idx / PC, k = idx - i * PC, f = i * ldf + k;
      const float* xi = X + i * ldf;
      float hd = HB[f];
      for (int a = 0; a < p; ++a) hd = fmaf(-xi[a], Cs[a * PC + k], hd);
      HB[f] = hd;
      dhd = fmaf(D[(size_t)(row0 + i) * ldd + k], hd, dhd);
    }
    dhd = warp_sum(dhd);
    if (lane == 0) wred[warp][3] = dhd;
    __syncthreads();
    exchange([&](int) { return lane < kWarps ? wred[lane][3] : 0.f; }, 1, 4, recv2, slices,
             slice);
    const float d_hd = slice_sum(recv2, 4, slices);
    const float alpha = safe_div(z_r, d_hd);
    const float e_pe_new = e_pe + 2.f * alpha * e_pd + alpha * alpha * d_pd;
    const bool bail = d_hd <= 0.f || e_pe_new >= rad2;
    const float disc = fmaxf(e_pd * e_pd + d_pd * (rad2 - e_pe), 0.f);
    const float tau = safe_div(-e_pd + sqrtf(disc), d_pd);

    // -- exchange 3: the model at the CG point and |r_new|^2
    float s3[3] = {0.f, 0.f, 0.f};
    for (int idx = tid; idx < myrows * PC; idx += kThreads) {
      const int i = idx / PC, k = idx - i * PC, f = i * ldf + k;
      const float hd = HB[f];
      const float dl = D[(size_t)(row0 + i) * ldd + k];
      const float ec = ETA[f] + alpha * dl;
      const float hc = HETA[f] + alpha * hd;
      const float rn = R[f] + alpha * hd;
      s3[0] += ec * G[f];
      s3[1] += ec * hc;
      s3[2] += rn * rn;
      R[f] = rn;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      s3[k] = warp_sum(s3[k]);
      if (lane == 0) wred[warp][k] = s3[k];
    }
    __syncthreads();
    exchange([&](int q) { return lane < kWarps ? wred[lane][q] : 0.f; }, 3, 4, recv3, slices,
             slice);
    const float model_c = slice_sum(recv3, 4, slices) + 0.5f * slice_sum(recv3 + 1, 4, slices);
    const float zr_new = slice_sum(recv3 + 2, 4, slices);
    const bool model_inc = model_c >= model;
    const bool hit = (j + 1 > mininner) && sqrtf(zr_new) <= target;
    const float beta = safe_div(zr_new, z_r);
    const bool done_now = bail || model_inc || hit;
    code = bail ? (d_hd <= 0.f ? 1 : 2) : model_inc ? 3 : hit ? (linear ? 4 : 5) : 0;

    // eta/Heta: the boundary point on bail, kept on model increase, else the
    // CG point; and t = -r_new + beta delta into HB
    for (int idx = tid; idx < myrows * PC; idx += kThreads) {
      const int i = idx / PC, k = idx - i * PC, f = i * ldf + k;
      const float d = D[(size_t)(row0 + i) * ldd + k], h = HB[f];
      if (bail) {
        ETA[f] += tau * d;
        HETA[f] += tau * h;
      } else if (!model_inc) {
        ETA[f] += alpha * d;
        HETA[f] += alpha * h;
      }
      HB[f] = -R[f] + beta * d;
    }
    if (!done_now) {
      e_pd = beta * (e_pd + alpha * d_pd);
      d_pd = zr_new + beta * beta * d_pd;
      e_pe = e_pe_new;
      z_r = zr_new;
      model = model_c;
    }
    ++j;
    done = done_now || j >= maxinner;
    if (done) break;
    // -- exchange 4: delta_new = P(t) = t - X sym(X't), then its rows into
    // every peer's delta before the next product
    __syncthreads();
    exchange([&](int q) { return pair_rows(X, ldf, HB, ldf, pairs[q], myrows); }, np2, qp,
             recv4, slices, slice);
    for (int q = tid; q < np2; q += kThreads) {
      const int a = pairs[q] >> 8, c = pairs[q] & 255;
      Ts[a * PC + c] = Ts[c * PC + a] = 0.5f * slice_sum(recv4 + q, qp, slices);
    }
    __syncthreads();
    for (int idx = tid; idx < myrows * PC; idx += kThreads) {
      const int i = idx / PC, k = idx - i * PC, f = i * ldf + k;
      const float* xi = X + i * ldf;
      float t = HB[f];
      for (int a = 0; a < p; ++a) t = fmaf(-xi[a], Ts[a * PC + k], t);
      D[(size_t)(row0 + i) * ldd + k] = t;
    }
    if (slices > 1) {
      __syncthreads();
      copy_to_peers(D + (size_t)row0 * ldd, myrows * ldd / 4, slices, slice, kThreads);
    }
    slices_sync(slices);
  }
  for (int idx = tid; idx < myrows * p; idx += kThreads) {
    const int i = idx / p, k = idx - i * p;
    etas[off + (size_t)(row0 + i) * p + k] = ETA[i * ldf + k];
    hetas[off + (size_t)(row0 + i) * p + k] = HETA[i * ldf + k];
  }
  if (slice == 0 && tid == 0) {
    stats[2 * b] = j;
    stats[2 * b + 1] = code;
  }
}

template <int PC, bool ZS>
cudaError_t launch(const float* zs, const float* d, const float* xs, const float* ws,
                   const float* ss, const float* grads, const float* radii, float* etas,
                   float* hetas, int* stats, int b, int n, int p, int maxinner, int mininner,
                   float theta, float kappa, int slices, int rows, int splits,
                   cudaStream_t stream) {
  auto kernel = stiefel_tcg_kernel<PC, ZS>;
  const size_t smem =
      (size_t)Layout(n, p, PC, slices, rows, splits, ZS).total * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * slices);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, zs, d, xs, ws, ss, grads, radii, etas, hetas, stats, n,
                           p, maxinner, mininner, theta, kappa, slices, rows, splits);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the refusal is reported here, not later
    return err;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// B lanes on clusters of `slices` CTAs of `rows` rows each, the product's
// inner dimension split `splits` ways, Zs in shared memory when zs_shared
// (the plan of ops/kernels.py::stiefel_plan); theta and kappa set the tCG
// target
// from each lane's |grad|, as truncated_cg does.
int stiefel_tcg_launch(const float* zs, const float* d, const float* xs, const float* ws,
                       const float* ss, const float* grads, const float* radii, float* etas,
                       float* hetas, int* stats, int b, int n, int p, int maxinner,
                       int mininner, float theta, float kappa, int slices, int rows,
                       int splits, int zs_shared, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int pc = p <= 8 ? 8 : p <= 16 ? 16 : 32;
  if (b < 1 || n < 1 || p < 1 || p > 32 || (slices != 1 && slices != 2 && slices != 4 &&
      slices != 8) || rows < 1 || (long long)rows * slices < n || splits < 1 ||
      splits > kWarps)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define STIEFEL_LAUNCH(PC, ZS)                                                              \
  launch<PC, ZS>(zs, d, xs, ws, ss, grads, radii, etas, hetas, stats, b, n, p, maxinner, \
                 mininner, theta, kappa, slices, rows, splits, st)
  if (pc == 8) return (int)(zs_shared ? STIEFEL_LAUNCH(8, true) : STIEFEL_LAUNCH(8, false));
  if (pc == 16) return (int)(zs_shared ? STIEFEL_LAUNCH(16, true) : STIEFEL_LAUNCH(16, false));
  return (int)(zs_shared ? STIEFEL_LAUNCH(32, true) : STIEFEL_LAUNCH(32, false));
#undef STIEFEL_LAUNCH
}

// The most clusters of `slices` CTAs the card holds at once
// (cudaOccupancyMaxActiveClusters): a CTA of kThreads threads at 128
// registers fills an SM's register file, so one CTA per SM whatever its
// shared memory, and the count follows the SMs of each GPC.  A negative
// value is a CUDA error.
int stiefel_max_clusters(int slices, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  auto kernel = stiefel_tcg_kernel<8, true>;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slices);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -(int)err;
  }
  return clusters;
}

}  // extern "C"
