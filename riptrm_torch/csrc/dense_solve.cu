// Hand-written Hopper (sm_90a) kernel for RIPM's dense Newton solve: B
// independent systems A x = b, A [B, n, n] float32 row-major or
// column-major (as RIPM's symmetrised materialisation leaves it) and b
// [B, n], by LU with partial pivoting, one warp a system, n <= 64.
//
//   dense_solve_kernel  replaces no Pallas kernel: the JAX package solves
//                       with jnp.linalg.solve (riptrm_tpu/solvers/ripm.py),
//                       which is XLA's LU.  It stands in for the library's
//                       batched LU on that path (torch.linalg.solve_ex:
//                       getrf + getrs with their column-major copy, row
//                       swaps and workspace), in one launch.
//
// The arithmetic (ops/kernels.py::dense_solve_plain is the same in
// PyTorch): at step k the pivot is the largest |a_ik| over the rows not yet
// eliminated, ties to the lowest position in LAPACK's swapped row order
// (isamax's rule); multipliers l_i = a_ik / a_pk; the trailing rows and the
// right-hand side take a_ij = fma(-l_i, a_pj, a_ij); back substitution runs
// column by column from the last, x_k = y_k / u_kk.  FP32 FMA only.  A
// system whose LU meets an exactly zero pivot column, or whose answer is
// not finite, writes NaN to its whole x.  Each system's operations and
// their order do not depend on B or on the system's place in the batch.
//
// What bounds it on an H100: at n = 49, B = 131072 one call reads 1.259 GB
// of matrices and 25.7 MB of right-hand sides and writes 25.7 MB: 0.39 ms
// at 3.35 TB/s; LU and both substitutions are ~83 kFLOP a system, 1.09e10
// in all, 0.16 ms at 67 TFLOP/s.  The design: each warp loads its system's
// matrix once, row by row with coalesced asynchronous copies (cp.async, all
// in flight at once), into shared memory (a row stride of n | 1 words, so
// that a thread reading its row, or U's column, meets no bank conflict),
// and from there into registers: thread t holds rows t and t + 32 whole
// (the template's ROWS; 2 x 64 floats), so the elimination reads no memory.
// The pivot is two warp reductions (redux.sync); rows are never moved:
// each thread keeps its rows' positions in the swapped order.  The pivot
// row reaches the other threads by one shuffle a column.  A runtime loop
// runs the steps, and each active row shifts one column left as it is
// updated, so that registers are addressed statically while the loop's
// code stays small (fully unrolled steps ran 1.6x slower); an eliminated
// row stays put, and at the end every thread stores its rows as U's rows,
// whose columns back substitution reads from shared memory.  No scratch,
// no host read.  It reaches ~15 % of the byte bound at n = 49, B = 131072;
// what limits it (the shuffles, or each step's serial chain of reductions,
// shuffles and a division) is not measured (PERF.md, open questions).
//
// Plain C interface for ctypes (riptrm_torch/ops/_build.py): the launcher
// returns cudaGetLastError() after the launch, 0 on success.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kSolveWarps = 4;  // systems a block, one warp each
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// Floats of one warp's shared memory: n rows of n | 1 (the staged matrix,
// then U's rows) and the eliminated right-hand side.
__host__ __device__ inline int warp_floats(int n) { return n * (n | 1) + n; }

// Step k's update of the active rows in registers: each shifts one column
// left as it is updated, so that the step's column is always r[.][0]; the
// pivot row (slot H of thread src) reaches every thread by one shuffle a
// column.  Rows already eliminated keep their U row in place (predicated
// off).  Columns past `valid` (n - k) are skipped in blocks of 8: what
// lands there is never read.
template <int ROWS, int H>
__device__ __forceinline__ void update(float (&r)[ROWS][32 * ROWS], const float (&l)[ROWS],
                                       const bool (&active)[ROWS], int src, int valid) {
#pragma unroll
  for (int c = 1; c < 32 * ROWS; ++c) {
    if ((c & 7) == 0 && c >= valid) break;
    const float u = __shfl_sync(kFull, r[H][c], src);
#pragma unroll
    for (int q = 0; q < ROWS; ++q)
      if (active[q]) r[q][c - 1] = fmaf(-l[q], u, r[q][c]);
  }
}

template <int ROWS>
__global__ void __launch_bounds__(32 * kSolveWarps)
dense_solve_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ x, int batch, int n, bool transposed) {
  constexpr int NP = 32 * ROWS;
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long sys = (long long)blockIdx.x * kSolveWarps + warp;
  if (sys >= batch) return;  // the whole warp: nothing below syncs the block
  const int ld = n | 1;
  float* s = smem + warp * warp_floats(n);
  float* y = s + n * ld;
  const float* ag = a + sys * n * n;

  // the system's memory as it lies (A's rows, or its columns where
  // `transposed`), every load in flight at once (cp.async: no register
  // waits on one)
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
      const int col = lane + 32 * q;
      if (col < n) cp_async4(s + i * ld + col, ag + i * n + col);
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncwarp();  // U overwrites the staged matrix only after the last read

  float r[ROWS][NP];  // r[q][c] = A(row lane + 32 q, column k + c) at step k
  float rb[ROWS];     // the right-hand side's entry of each row
  int pos[ROWS];      // the row's position in the swapped order
  int step[ROWS];     // the step at which the row was the pivot, -1 before
  bool active[ROWS];  // not yet a pivot (and not padding)
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    const int row = lane + 32 * q;
    active[q] = row < n;
#pragma unroll
    for (int j = 0; j < NP; ++j)
      r[q][j] = (active[q] && j < n) ? s[transposed ? j * ld + row : row * ld + j] : 0.f;
    rb[q] = active[q] ? __ldg(b + sys * n + row) : 0.f;
    pos[q] = row;
    step[q] = -1;
  }

  bool ok = true;
#pragma unroll 1
  for (int k = 0; k < n; ++k) {
    // the pivot: the largest |a_ik| over active rows (as unsigned bits + 1,
    // 0 for the others), ties to the lowest position
    unsigned bk = 0, bp = 0xffffffffu;
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
      const unsigned key = active[q] ? __float_as_uint(fabsf(r[q][0])) + 1u : 0u;
      if (key > bk || (key == bk && (unsigned)pos[q] < bp)) {
        bk = key;
        bp = pos[q];
      }
    }
    const unsigned m = __reduce_max_sync(kFull, bk);
    if (m <= 1u) {  // every |a_ik| an exact zero: warp-uniform
      ok = false;
      break;
    }
    const int p = (int)__reduce_min_sync(kFull, bk == m ? bp : 0xffffffffu);
    bool mine[ROWS];
#pragma unroll
    for (int q = 0; q < ROWS; ++q) mine[q] = active[q] && pos[q] == p;
    const int src = __ffs(__ballot_sync(kFull, mine[0] || mine[ROWS - 1])) - 1;
    const bool hi = ROWS > 1 && __any_sync(kFull, mine[ROWS - 1]);
    const float piv = __shfl_sync(kFull, hi ? r[ROWS - 1][0] : r[0][0], src);
    const float yk = __shfl_sync(kFull, hi ? rb[ROWS - 1] : rb[0], src);
    // multipliers by division: two equal rows give l = 1 exactly, so an
    // exact zero pivot where the matrix has one (a reciprocal would not)
    float l[ROWS];
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
      // the row at position k moves to the pivot's position
      if (active[q] && pos[q] == k) pos[q] = p;
      if (mine[q]) step[q] = k;
      active[q] = active[q] && !mine[q];
      l[q] = active[q] ? r[q][0] / piv : 0.f;
    }
    if (hi)
      update<ROWS, ROWS - 1>(r, l, active, src, n - k);
    else
      update<ROWS, 0>(r, l, active, src, n - k);
#pragma unroll
    for (int q = 0; q < ROWS; ++q)
      if (active[q]) rb[q] = fmaf(-l[q], yk, rb[q]);
  }

  float xo[ROWS];  // thread t keeps x[t + 32 q]
#pragma unroll
  for (int q = 0; q < ROWS; ++q) xo[q] = 0.f;
  if (ok) {
    // each row to its place in U (U(k, k + c) at s[k ld + k + c]) and y
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
      if (step[q] >= 0) {
        float* urow = s + step[q] * ld + step[q];
#pragma unroll
        for (int c = 0; c < NP; ++c)
          if (c < n - step[q]) urow[c] = r[q][c];
        y[step[q]] = rb[q];
      }
    }
    __syncwarp();
    float yv[ROWS];  // thread t keeps y[t + 32 q]
#pragma unroll
    for (int q = 0; q < ROWS; ++q) yv[q] = lane + 32 * q < n ? y[lane + 32 * q] : 0.f;
#pragma unroll 1
    for (int k = n - 1; k >= 0; --k) {
      const float own = (ROWS > 1 && k >= 32) ? yv[ROWS - 1] : yv[0];
      const float xk = __shfl_sync(kFull, own, k & 31) / s[k * ld + k];
#pragma unroll
      for (int q = 0; q < ROWS; ++q) {
        const int i = lane + 32 * q;
        if (i < k) yv[q] = fmaf(-s[i * ld + k], xk, yv[q]);
      }
      if (lane == (k & 31)) {
        if (ROWS > 1 && k >= 32)
          xo[ROWS - 1] = xk;
        else
          xo[0] = xk;
      }
    }
#pragma unroll
    for (int q = 0; q < ROWS; ++q) ok &= (lane + 32 * q >= n) || isfinite(xo[q]);
  }
  ok = __all_sync(kFull, ok);
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    const int col = lane + 32 * q;
    if (col < n) x[sys * n + col] = ok ? xo[q] : __int_as_float(0x7fc00000);
  }
}

size_t solve_smem(int n) { return sizeof(float) * kSolveWarps * warp_floats(n); }

template <int ROWS>
cudaError_t launch_solve(const float* a, const float* b, float* x, int batch, int n, int grid,
                         bool transposed, cudaStream_t stream) {
  const size_t smem = solve_smem(n);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dense_solve_kernel<ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dense_solve_kernel<ROWS><<<grid, 32 * kSolveWarps, smem, stream>>>(a, b, x, batch, n,
                                                                      transposed);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a [batch, n, n] row-major (transposed = 0) or column-major (1: the
// memory holds each A' row-major), b and x [batch, n]; the plan of
// ops/kernels.py::dense_solve_plan: rows (1 for n <= 32, 2 for n <= 64)
// and grid = ceil(batch / 4) blocks of 4 warps.
int dense_solve_launch(const float* a, const float* b, float* x, int batch, int n, int rows,
                       int grid, int transposed, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 1 || n > 32 * rows || rows < 1 || rows > 2 || batch < 0 ||
      (long long)grid * kSolveWarps < batch)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(rows == 1 ? launch_solve<1>(a, b, x, batch, n, grid, transposed != 0, s)
                         : launch_solve<2>(a, b, x, batch, n, grid, transposed != 0, s));
}

}  // extern "C"
