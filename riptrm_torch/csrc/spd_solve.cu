// Hand-written Hopper (sm_90a) kernel for the SPD metric's Cholesky solve
// (riptrm_torch/manifolds/spd.py::_cho_solve): x^-1 u from x's lower
// Cholesky factor L, that is L^-1 u by forward substitution, then L^-T of
// that by back substitution, for a batch of d x d systems with d right-hand
// columns each (d <= 8).
//
//   spd_solve_kernel  replaces no Pallas kernel: the JAX package calls
//                     jax.scipy.linalg.cho_solve (two triangular solves in
//                     XLA).  It stands in for the port's two batched
//                     torch.linalg.solve_triangular calls (cuBLAS's batched
//                     trsm, ~430 us each at 262144 systems of 5 x 5, with
//                     the host's preparation of their pointer arrays), in
//                     one launch.
//
// The arithmetic (FP32 FMA only, no atomics; each column's operations and
// their order do not depend on the batch or the system's place in it):
//
//   y_i = (u_i - sum_{j < i} L_ij y_j) / L_ii,   i = 0 .. d - 1,
//   x_i = (y_i - sum_{j > i} L_ji x_j) / L_ii,   i = d - 1 .. 0,
//
// each sum taken by fmaf from j = 0 (forward) or j = i + 1 (back) upwards,
// the divisions IEEE-rounded (no fast math).  A system whose factor holds a
// NaN (spd.py::_chol writes NaN over a factor that failed) reads NaN whole,
// as the library's solves do.
//
// What bounds it on an H100: a system reads L and u and writes x, 3 d^2
// floats (300 B at d = 5), 78.6 MB at 262144 systems, 23.5 us at 3.35 TB/s;
// d^2 (d + 1) FMA (150 at d = 5), 0.08 GFLOP, ~1 us at 67 TFLOP/s.  So the
// bytes bound it, and each is moved once with coalesced accesses: a block
// stages a run of 256 / d systems, L and u, into shared memory (a warp's
// loads cover consecutive addresses), one thread a (system, column) solves
// from there in registers, and the block writes x back as one contiguous
// run.  Both inputs are read in place by their strides: the stacked SPD
// blocks of a Product tangent are a narrowed view of a packed [B, 3, d, d]
// tensor (batch stride 3 d^2, offset d^2 floats, 4-byte aligned), and the
// factor is column-major, as the library's Cholesky writes it, so no copy
// to contiguous memory precedes the solve.  Each block works out its
// systems' offsets once, so the element loads take no 64-bit division.  No
// scratch in device memory, no host read.
//
// Plain C interface for ctypes (riptrm_torch/ops/_build.py): the launcher
// returns cudaGetLastError() after the launch, 0 on success.

#include <cuda_runtime.h>

namespace {

constexpr int kSolveThreads = 256;  // threads a block
constexpr int kMaxD = 8;

// A tensor's leading axes as two levels (outer, inner) and the strides of
// a system's rows and columns, in floats.
struct Layout {
  long long outer, inner;
  int row, col;
};

template <int D>
__global__ void __launch_bounds__(kSolveThreads)
spd_solve_kernel(const float* __restrict__ l, const float* __restrict__ u,
                 float* __restrict__ out, long long systems, long long inner, Layout ll,
                 Layout ul) {
  constexpr int S = kSolveThreads / D;  // systems a block
  constexpr int DD = D * D;
  __shared__ float s_l[S * DD];
  __shared__ float s_u[S * DD];
  __shared__ long long s_loff[S], s_uoff[S];
  const long long first = (long long)blockIdx.x * S;
  const int here = (int)min((long long)S, systems - first);
  for (int t = threadIdx.x; t < here; t += kSolveThreads) {
    const long long s = first + t, o = s / inner, i = s - o * inner;
    s_loff[t] = o * ll.outer + i * ll.inner;
    s_uoff[t] = o * ul.outer + i * ul.inner;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < here * DD; t += kSolveThreads) {
    const int k = t / DD, e = t - k * DD, r = e / D, c = e - r * D;
    s_l[t] = __ldg(l + s_loff[k] + r * ll.row + c * ll.col);
    s_u[t] = __ldg(u + s_uoff[k] + r * ul.row + c * ul.col);
  }
  __syncthreads();

  const int k = threadIdx.x / D, col = threadIdx.x - k * D;
  if (k < here) {
    const float* lk = s_l + k * DD;
    float* uk = s_u + k * DD;
    float x[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float acc = uk[i * D + col];
#pragma unroll
      for (int j = 0; j < i; ++j) acc = fmaf(-lk[i * D + j], x[j], acc);
      x[i] = acc / lk[i * D + i];
    }
#pragma unroll
    for (int i = D - 1; i >= 0; --i) {
      float acc = x[i];
#pragma unroll
      for (int j = i + 1; j < D; ++j) acc = fmaf(-lk[j * D + i], x[j], acc);
      x[i] = acc / lk[i * D + i];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) uk[i * D + col] = x[i];
  }
  __syncthreads();
  float* ob = out + first * DD;
  for (int t = threadIdx.x; t < here * DD; t += kSolveThreads) ob[t] = s_u[t];
}

template <int D>
cudaError_t launch_solve(const float* l, const float* u, float* out, long long systems,
                         long long inner, Layout ll, Layout ul, int grid, cudaStream_t stream) {
  spd_solve_kernel<D><<<grid, kSolveThreads, 0, stream>>>(l, u, out, systems, inner, ll, ul);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// l, u [outer, inner, d, d] float32 by the strides given (in floats: the
// two leading levels', then a row's and a column's), out [outer, inner, d,
// d] float32 row-major; grid = ceil(outer inner / (256 / d)) blocks of 256
// threads (ops/kernels.py::spd_solve_plan).
int spd_solve_launch(const float* l, const float* u, float* out, long long outer,
                     long long inner, long long l_outer, long long l_inner, int l_row, int l_col,
                     long long u_outer, long long u_inner, int u_row, int u_col, int d, int grid,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long systems = outer * inner;
  if (d < 1 || d > kMaxD || outer < 0 || inner < 1 ||
      (long long)grid * (kSolveThreads / d) < systems)
    return (int)cudaErrorInvalidValue;
  if (systems == 0) return 0;
  const Layout ll{l_outer, l_inner, l_row, l_col}, ul{u_outer, u_inner, u_row, u_col};
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define RIPTRM_SOLVE_CASE(D) \
  case D:                    \
    return (int)launch_solve<D>(l, u, out, systems, inner, ll, ul, grid, s);
    RIPTRM_SOLVE_CASE(1)
    RIPTRM_SOLVE_CASE(2)
    RIPTRM_SOLVE_CASE(3)
    RIPTRM_SOLVE_CASE(4)
    RIPTRM_SOLVE_CASE(5)
    RIPTRM_SOLVE_CASE(6)
    RIPTRM_SOLVE_CASE(7)
    RIPTRM_SOLVE_CASE(8)
#undef RIPTRM_SOLVE_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
