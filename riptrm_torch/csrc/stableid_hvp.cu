// Hand-written Hopper (sm_90a) kernel for the StableIdentification family's
// barrier-KKT operator, the Hessian-vector product that RIPTRM's generic
// tCG applies once an iteration (riptrm_torch/solvers/riptrm.py::_barrier_ops):
//
//   Hw(dx) = Hess L[dx] + Gx(y o Gxaj(dx) / c)
//
// on Product(Skew(d), SPD(d), SPD(d)), points and tangents [B, 3, d, d]
// (J, R, Q), d <= 8, at most 64 constraints on entries of A = (J - R) Q.
//
//   stableid_hvp_kernel  replaces no Pallas kernel: the JAX package applies
//                        the family's Hessian by autograd under vmap.  It
//                        stands in for the port's composition of that
//                        operator (problems/stable_identification.py::
//                        barrier_hvp_plain, its plain version): the closed
//                        form Lagrangian HVP, the Product manifold's
//                        Hessian conversion and the barrier term, some
//                        twenty batched 5 x 5 products (cuBLAS's SIMT batched
//                        GEMM, ~200 us each at B = 131072) and their
//                        elementwise chain, in one launch.
//
// The arithmetic (FP32 FMA only, no atomics; each lane's operations and
// their order do not depend on B or on the lane's place in the batch).
// With G the Lagrangian's Euclidean gradient in A (the point's frozen work,
// one [B, d, d] input), jmr = J - R, dv = vJ - vR, dA = dv Q + jmr vQ,
// the constraints' slopes s_i = lin_i - 2 two_i (A[r_i, c_i] - p1_i) and
// K the d x d matrix that holds, at each constrained entry, the sum of
// -2 two_i y_i + y_i s_i^2 / c_i (the Lagrangian's curvature and the
// barrier term, which the composition scatters apart),
//
//   dG = scale dA (X X') + K o dA,          M = dG Q' + G vQ',
//   N  = dv' G + jmr' dG,                    E = jmr' G,
//   out_J = skew(M),
//   out_R = -R sym(M) R - sym(vR sym(G Q') R),
//   out_Q =  Q sym(N) Q + sym(vQ sym(E) Q):
//
// the Euclidean image (M, -M, N) mapped by the product manifold's Hessian
// conversion (skew; P sym(.) P + sym(V sym(egrad) P) with egrad =
// (G Q', -G Q', E)), the barrier term folded into dG, the same operator
// summed in another order.  A lane whose inputs hold a NaN or an infinity
// reads NaN whole (the composition's one-hot products spread it over most
// of the lane).
//
// What bounds it on an H100: a lane reads its point and tangent (2 x 300 B
// at d = 5), G (100 B), y and c (2 x 64 B at m = 16) and writes its image
// (300 B): ~1.13 KB, 148 MB at B = 131072, 44 us at 3.35 TB/s; 18 d^3 + d^2
// FMA a lane (2.3 k at d = 5), 0.6 GFLOP, 9 us at 67 TFLOP/s.  So the bytes
// bound it, and every intermediate stays in registers: nothing but the
// image is written, and the frozen products (A, G Q', jmr' G, the
// constraint coefficients) are recomputed here rather than stored and
// read (0.11 ms a call, 39 % of the bound, PERF.md).  One thread a lane would
// hold ~300 live floats and spill; so a lane takes d threads of one warp
// (6 lanes a warp at d = 5), thread i holding row i of every d x d block.
// Row i of a product A B takes B's rows by warp shuffles (d^2 an operand;
// two products that share an operand share its shuffles), a transpose
// goes through a padded per-lane scratch in shared memory, and Q, used on
// the right three times, is kept whole in registers after its one
// broadcast.  The instance's constants (X X', the constraints' entries,
// kinds and p1) sit in shared memory, loaded once a block.  No scratch in
// device memory, no host read.
//
// Plain C interface for ctypes (riptrm_torch/ops/_build.py): the launcher
// returns cudaGetLastError() after the launch, 0 on success.

#include <cuda_runtime.h>

namespace {

constexpr int kHvpWarps = 4;  // warps a block
constexpr int kMaxD = 8;
constexpr int kMaxM = 64;
constexpr unsigned kFull = 0xffffffffu;

// Row i of the transpose of the d x d block whose rows the lane's threads
// hold (`v` is this thread's row), through the lane's scratch `s`
// [D][D + 1].
template <int D>
__device__ __forceinline__ void transpose(const float (&v)[D], float (&t)[D], float* s,
                                          int i) {
#pragma unroll
  for (int j = 0; j < D; ++j) s[i * (D + 1) + j] = v[j];
  __syncwarp();
#pragma unroll
  for (int j = 0; j < D; ++j) t[j] = s[j * (D + 1) + i];
  __syncwarp();  // the scratch is written again only after every read
}

template <int D>
__device__ __forceinline__ void sym_rows(const float (&v)[D], float (&out)[D], float* s, int i) {
  float t[D];
  transpose<D>(v, t, s, i);
#pragma unroll
  for (int j = 0; j < D; ++j) out[j] = 0.5f * (v[j] + t[j]);
}

template <int D>
__global__ void __launch_bounds__(32 * kHvpWarps)
stableid_hvp_kernel(const float* __restrict__ x, const float* __restrict__ g,
                    const float* __restrict__ y, const float* __restrict__ c,
                    const float* __restrict__ dx, const float* __restrict__ gram,
                    const long long* __restrict__ idx, const float* __restrict__ lin,
                    const float* __restrict__ two, const float* __restrict__ p1, float scale,
                    float* __restrict__ out, int batch, int m) {
  constexpr int L = 32 / D;  // lanes a warp
  constexpr int DD = D * D;
  __shared__ float s_gram[DD];
  __shared__ int s_row[kMaxM], s_col[kMaxM];
  __shared__ float s_lin[kMaxM], s_two[kMaxM], s_p1[kMaxM];
  __shared__ float s_t[kHvpWarps][L][D * (D + 1)];
  for (int t = threadIdx.x; t < DD; t += blockDim.x) s_gram[t] = gram[t];
  for (int t = threadIdx.x; t < m; t += blockDim.x) {
    const long long e = idx[t];
    s_row[t] = (int)(e / D);
    s_col[t] = (int)(e % D);
    s_lin[t] = lin[t];
    s_two[t] = two[t];
    s_p1[t] = p1[t];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, tl = threadIdx.x & 31;
  // a thread past the warp's last lane (2 at d = 5) shuffles with the
  // others, on its neighbour's data, and stores nothing
  const int slot = min(tl / D, L - 1), i = tl - (tl / D) * D;
  const int base = slot * D;
  const long long lane = ((long long)blockIdx.x * kHvpWarps + warp) * L + slot;
  const bool owner = tl < L * D && lane < batch;
  const long long at = lane < batch ? lane : batch - 1;  // a lane past B reads the last
  float* s = s_t[warp][slot];

  const float* xl = x + at * 3 * DD + i * D;
  const float* dl = dx + at * 3 * DD + i * D;
  const float* gl = g + at * DD + i * D;
  float r[D], q[D], jmr[D], vr[D], vq[D], dv[D], gr[D];
  float seen = 0.f;  // NaN once an input this thread reads is not finite
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float xj = __ldg(xl + j), vj = __ldg(dl + j);
    r[j] = __ldg(xl + DD + j);
    q[j] = __ldg(xl + 2 * DD + j);
    jmr[j] = xj - r[j];
    vr[j] = __ldg(dl + DD + j);
    vq[j] = __ldg(dl + 2 * DD + j);
    dv[j] = vj - vr[j];
    gr[j] = __ldg(gl + j);
    seen += 0.f * (xj + vj + r[j] + q[j] + vr[j] + vq[j] + gr[j]);
  }

  // Q's rows to every thread of the lane (kept whole): A = jmr Q,
  // dA = dv Q, G Q'
  float qf[D][D], a[D], da[D], gq[D];
#pragma unroll
  for (int j = 0; j < D; ++j) a[j] = da[j] = gq[j] = 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const float v = __shfl_sync(kFull, q[j], base + k);
      qf[k][j] = v;
      a[j] = fmaf(jmr[k], v, a[j]);
      da[j] = fmaf(dv[k], v, da[j]);
      gq[k] = fmaf(gr[j], v, gq[k]);
    }
  }
  // vQ's rows: dA += jmr vQ, M starts as G vQ'
  float mm[D];
#pragma unroll
  for (int j = 0; j < D; ++j) mm[j] = 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const float v = __shfl_sync(kFull, vq[j], base + k);
      da[j] = fmaf(jmr[k], v, da[j]);
      mm[k] = fmaf(gr[j], v, mm[k]);
    }
  }

  // K's row i: the constraints on this row's entries
  float kc[D];
#pragma unroll
  for (int j = 0; j < D; ++j) kc[j] = 0.f;
  const float* yl = y + at * m;
  const float* cl = c + at * m;
  for (int t = 0; t < m; ++t) {
    if (s_row[t] != i) continue;
    const int col = s_col[t];
    float at_a = 0.f;
#pragma unroll
    for (int j = 0; j < D; ++j) at_a = j == col ? a[j] : at_a;
    const float two_t = s_two[t];
    const float slope = fmaf(-2.f * two_t, at_a - s_p1[t], s_lin[t]);
    const float yt = __ldg(yl + t), ct = __ldg(cl + t);
    seen += 0.f * (yt + ct);
    const float kt = fmaf(-2.f * two_t, yt, yt * slope * slope / ct);
#pragma unroll
    for (int j = 0; j < D; ++j) kc[j] += j == col ? kt : 0.f;
  }

  // dG's row i, and M = dG Q' + G vQ' from Q held whole
  float dg[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < D; ++k) acc = fmaf(da[k], s_gram[k * D + j], acc);
    dg[j] = fmaf(kc[j], da[j], scale * acc);
  }
#pragma unroll
  for (int k = 0; k < D; ++k) {
#pragma unroll
    for (int j = 0; j < D; ++j) mm[k] = fmaf(dg[j], qf[k][j], mm[k]);
  }

  // N = dv' G + jmr' dG and E = jmr' G: the columns of dv and jmr, G's and
  // dG's rows
  float dvt[D], jmrt[D], nn[D], ee[D];
  transpose<D>(dv, dvt, s, i);
  transpose<D>(jmr, jmrt, s, i);
#pragma unroll
  for (int j = 0; j < D; ++j) nn[j] = ee[j] = 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const float gv = __shfl_sync(kFull, gr[j], base + k);
      const float dgv = __shfl_sync(kFull, dg[j], base + k);
      nn[j] = fmaf(dvt[k], gv, nn[j]);
      nn[j] = fmaf(jmrt[k], dgv, nn[j]);
      ee[j] = fmaf(jmrt[k], gv, ee[j]);
    }
  }

  // the Skew block: skew(M); sym(M), sym(G Q'), sym(N), sym(E)
  float mt[D], sm[D], sg[D], sn[D], se[D], o_j[D];
  transpose<D>(mm, mt, s, i);
#pragma unroll
  for (int j = 0; j < D; ++j) {
    o_j[j] = 0.5f * (mm[j] - mt[j]);
    sm[j] = 0.5f * (mm[j] + mt[j]);
  }
  sym_rows<D>(gq, sg, s, i);
  sym_rows<D>(nn, sn, s, i);
  sym_rows<D>(ee, se, s, i);

  // left products: R sym(M), vR sym(G Q'), Q sym(N), vQ sym(E)
  float t1[D], u1[D], t2[D], u2[D];
#pragma unroll
  for (int j = 0; j < D; ++j) t1[j] = u1[j] = t2[j] = u2[j] = 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const float a1 = __shfl_sync(kFull, sm[j], base + k);
      const float b1 = __shfl_sync(kFull, sg[j], base + k);
      const float a2 = __shfl_sync(kFull, sn[j], base + k);
      const float b2 = __shfl_sync(kFull, se[j], base + k);
      t1[j] = fmaf(r[k], a1, t1[j]);
      u1[j] = fmaf(vr[k], b1, u1[j]);
      t2[j] = fmaf(q[k], a2, t2[j]);
      u2[j] = fmaf(vq[k], b2, u2[j]);
    }
  }
  // right products: by R (its rows shuffled) and by Q (held whole)
  float t1r[D], u1r[D], t2q[D], u2q[D];
#pragma unroll
  for (int j = 0; j < D; ++j) t1r[j] = u1r[j] = t2q[j] = u2q[j] = 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const float rv = __shfl_sync(kFull, r[j], base + k);
      t1r[j] = fmaf(t1[k], rv, t1r[j]);
      u1r[j] = fmaf(u1[k], rv, u1r[j]);
      t2q[j] = fmaf(t2[k], qf[k][j], t2q[j]);
      u2q[j] = fmaf(u2[k], qf[k][j], u2q[j]);
    }
  }
  float w1[D], w2[D];
  sym_rows<D>(u1r, w1, s, i);
  sym_rows<D>(u2q, w2, s, i);

  // a lane any of whose threads met a value that is not finite: NaN whole
  const unsigned lane_bits = ((1u << D) - 1u) << base;
  const bool poisoned = (__ballot_sync(kFull, isnan(seen)) & lane_bits) != 0u;
  if (owner) {
    const float nan = __int_as_float(0x7fc00000);
    float* ol = out + lane * 3 * DD + i * D;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      ol[j] = poisoned ? nan : o_j[j];
      ol[DD + j] = poisoned ? nan : -t1r[j] - w1[j];
      ol[2 * DD + j] = poisoned ? nan : t2q[j] + w2[j];
    }
  }
}

template <int D>
cudaError_t launch_hvp(const float* x, const float* g, const float* y, const float* c,
                       const float* dx, const float* gram, const long long* idx,
                       const float* lin, const float* two, const float* p1, float scale,
                       float* out, int batch, int m, int grid, cudaStream_t stream) {
  stableid_hvp_kernel<D><<<grid, 32 * kHvpWarps, 0, stream>>>(x, g, y, c, dx, gram, idx, lin,
                                                              two, p1, scale, out, batch, m);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, dx, out [batch, 3, d, d], g [batch, d, d], y, c [batch, m] float32
// row-major; gram [d, d], lin, two, p1 [m] float32, idx [m] int64 (row * d
// + column); grid = ceil(batch / (4 (32 / d))) blocks of 4 warps, 32 / d
// lanes a warp (ops/kernels.py::stableid_hvp_plan).
int stableid_hvp_launch(const float* x, const float* g, const float* y, const float* c,
                        const float* dx, const float* gram, const long long* idx,
                        const float* lin, const float* two, const float* p1, float* out,
                        float scale, int batch, int d, int m, int grid, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1 || d > kMaxD || m < 0 || m > kMaxM || batch < 0 ||
      (long long)grid * kHvpWarps * (32 / d) < batch)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define RIPTRM_HVP_CASE(D) \
  case D:                  \
    return (int)launch_hvp<D>(x, g, y, c, dx, gram, idx, lin, two, p1, scale, out, batch, m, grid, s);
    RIPTRM_HVP_CASE(1)
    RIPTRM_HVP_CASE(2)
    RIPTRM_HVP_CASE(3)
    RIPTRM_HVP_CASE(4)
    RIPTRM_HVP_CASE(5)
    RIPTRM_HVP_CASE(6)
    RIPTRM_HVP_CASE(7)
    RIPTRM_HVP_CASE(8)
#undef RIPTRM_HVP_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
