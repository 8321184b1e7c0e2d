// K3: warm-started batched CG on dense SPD systems, result written in place.
//
// Replaces buffalo_tpu/ops/solve.py: solve_cg (:83) = cg_warm_start (:37) +
// cg_loop (:49) in a fori_loop, and the result write of
// buffalo_tpu/ops/als_kernels.py _apply_batch (:351 range, :372 scatter).
// System b (A[b] x = y[b], d x d, from als_normal_equations) starts from its
// current table row and its result goes to table[row_start + b] (range) or
// table[rows[b]] (scatter).  Rows with len 0 keep p; padding ids past the
// table (1 << 30 or num_rows in the reference, dropped there with
// mode="drop") are skipped, since a write there would fault.
//
// What bounds it on the card: reading A (4 d^2 bytes per system, 6.4 KB at
// d = 40) once; the (cg_iters + 1) matvecs re-read it from shared memory,
// and the chain of block reductions sets the latency per system.
// Design: one block per system, A in shared memory with an odd row stride,
// CG vectors in shared memory, fixed-order reductions (no atomics).
#include "als_common.cuh"

namespace {

constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads)
batched_cg_dense_kernel(const float* __restrict__ A, const float* __restrict__ y,
                        float* __restrict__ table, const int32_t* __restrict__ lens,
                        const int32_t* __restrict__ rows, int64_t row_start,
                        int64_t n_table_rows, int d, int cg_iters, float cg_tol) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  if (lens[b] <= 0) return;
  const int64_t dst = rows ? (int64_t)rows[b] : row_start + b;
  if (dst < 0 || dst >= n_table_rows) return;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lda = d | 1;
  float* As = smem;           // [d][lda]
  float* x0 = As + d * lda;   // [d] current row
  float* ys = x0 + d;
  float* x = ys + d;
  float* r = x + d;
  float* p = r + d;
  float* Ap = p + d;
  float* scratch = Ap + d;    // [33]

  const float* Ab = A + (int64_t)b * d * d;
  float* row = table + dst * d;
  for (int i = tid; i < d * d; i += T) {
    const int j = i / d;
    As[j * lda + (i - j * d)] = Ab[i];
  }
  for (int j = tid; j < d; j += T) {
    x0[j] = row[j];
    ys[j] = y[(int64_t)b * d + j];
  }
  __syncthreads();

  auto matvec = [&](const float* v, float* out) {
    for (int i = tid; i < d; i += T) {
      float s = 0.f;
      for (int j = 0; j < d; ++j) s += As[i * lda + j] * v[j];
      out[i] = s;
    }
    __syncthreads();
  };
  als::warm_cg(matvec, x0, ys, x, r, p, Ap, scratch, d, cg_iters, cg_tol);
  for (int j = tid; j < d; j += T) row[j] = x[j];
}

}  // namespace

extern "C" int batched_cg_dense(const float* A, const float* y, float* table,
                                const int32_t* lens, const int32_t* rows,
                                int64_t row_start, int64_t n_table_rows, int R, int d,
                                int cg_iters, float cg_tol, void* stream) {
  if (R == 0) return 0;
  const size_t smem = sizeof(float) * ((size_t)d * (d | 1) + 6 * d + 33);
  cudaError_t err = als::allow_smem(batched_cg_dense_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  batched_cg_dense_kernel<<<R, kThreads, smem, (cudaStream_t)stream>>>(
      A, y, table, lens, rows, row_start, n_table_rows, d, cg_iters, cg_tol);
  return (int)cudaGetLastError();
}
