// K1: fused matrix-free row CG for ALS range batches with padded length
// L <= 96 (MATRIX_FREE_MAX_L).
//
// Replaces buffalo_tpu/ops/als_kernels.py: _solve_cg_matrix_free (:103), the
// CG branch of als_solve_batch (:157-162), _loss_terms (:77) and the
// RangeBatch gather/write of _apply_batch (:337-353), with solve.py's
// cg_warm_start (:37) + cg_loop (:49).  Per row u of the batch it solves
//   (FF + reg*ada*I + F^T diag(w) F) x = F^T (1 + w),   F = Bf[cols[u]]
// by a warm start from the current row and cg_iters CG steps, without ever
// forming the d x d system, and writes x over table[row_start + u].
//
// What bounds it on the card: the gather of F (L rows of d floats from the
// fixed-side table, which fits in the 50 MB L2 at ML-20M size) and the
// latency of a block-wide reduction chain (3 per CG step); the arithmetic is
// ~(cg_iters + 1) * (4 L d + d^2) FMAs per row, far below the card's rate.
// Design: one block per row; F (<= 96 x d) and FF sit in shared memory, so
// F is read from device memory once and never written there; every CG
// vector lives in shared memory; reductions are fixed-order (no atomics).
// Rows with len 0 (padding) are skipped: the table keeps p.
#include "als_common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
als_cg_matrix_free_kernel(float* __restrict__ table, const float* __restrict__ Bf,
                          const float* __restrict__ FF, const int32_t* __restrict__ lens,
                          const int32_t* __restrict__ cols, const float* __restrict__ vals,
                          float* __restrict__ nume, float* __restrict__ deno,
                          int64_t row_start, int L, int d, float alpha, float reg,
                          int adaptive_reg, int cg_iters, float cg_tol, int item_axis,
                          float num_fixed_rows, int compute_loss) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int n = lens[b];
  if (n <= 0) return;  // padding row: p stays, its loss terms are 0
  const int tid = threadIdx.x, T = blockDim.x;
  const int ldF = d | 1;  // odd row stride: threads over l hit distinct banks
  float* F = smem;                 // [L][ldF]
  float* FFs = F + L * ldF;        // [d][d]
  float* w = FFs + d * d;          // [L]  alpha * vals
  float* fx = w + L;               // [L]  matvec scratch
  float* p0 = fx + L;              // [d]  current row (pre-update)
  float* y = p0 + d;
  float* x = y + d;
  float* r = x + d;
  float* p = r + d;
  float* Ap = p + d;
  float* scratch = Ap + d;         // [33]

  const int32_t* cb = cols + (int64_t)b * L;
  const float* vb = vals + (int64_t)b * L;
  float* row = table + (row_start + b) * (int64_t)d;
  for (int i = tid; i < n * d; i += T) {
    const int l = i / d, k = i - l * d;
    F[l * ldF + k] = Bf[(int64_t)cb[l] * d + k];
  }
  for (int l = tid; l < n; l += T) w[l] = vb[l] * alpha;
  for (int i = tid; i < d * d; i += T) FFs[i] = FF[i];
  for (int j = tid; j < d; j += T) p0[j] = row[j];
  __syncthreads();

  const float reg_ada = reg * (adaptive_reg ? (float)n : 1.f);
  for (int j = tid; j < d; j += T) {
    float s = 0.f;
    for (int l = 0; l < n; ++l) s += F[l * ldF + j] * (1.f + w[l]);
    y[j] = s;
  }

  if (compute_loss) {
    float part = 0.f;
    for (int j = tid; j < d; j += T) part += p0[j] * p0[j];
    float nu = reg_ada * als::block_sum(part, scratch);
    float de = 0.f;
    if (item_axis) {
      part = 0.f;
      for (int j = tid; j < d; j += T) {
        float s = 0.f;
        for (int k = 0; k < d; ++k) s += FFs[j * d + k] * p0[k];
        part += p0[j] * s;
      }
      const float pFFp = als::block_sum(part, scratch);
      float pos = 0.f, wsum = 0.f;
      for (int l = tid; l < n; l += T) {
        float dot = 0.f;
        for (int k = 0; k < d; ++k) dot += p0[k] * F[l * ldF + k];
        pos += -dot * dot + (dot - 1.f) * (dot - 1.f) * (1.f + w[l]);
        wsum += w[l];
      }
      nu += pFFp + als::block_sum(pos, scratch);
      de = num_fixed_rows + als::block_sum(wsum, scratch);
    }
    if (tid == 0) {
      nume[b] = nu;
      deno[b] = de;
    }
  }
  __syncthreads();

  // A v = v FF + reg*ada v + F^T (w * (F v)), the reference's matvec order
  auto matvec = [&](const float* v, float* out) {
    for (int l = tid; l < n; l += T) {
      float s = 0.f;
      for (int k = 0; k < d; ++k) s += F[l * ldF + k] * v[k];
      fx[l] = s * w[l];
    }
    __syncthreads();
    for (int j = tid; j < d; j += T) {
      float dense = 0.f;
      for (int k = 0; k < d; ++k) dense += v[k] * FFs[k * d + j];
      dense += reg_ada * v[j];
      float data = 0.f;
      for (int l = 0; l < n; ++l) data += F[l * ldF + j] * fx[l];
      out[j] = dense + data;
    }
    __syncthreads();
  };
  als::warm_cg(matvec, p0, y, x, r, p, Ap, scratch, d, cg_iters, cg_tol);
  for (int j = tid; j < d; j += T) row[j] = x[j];
}

}  // namespace

extern "C" int als_cg_matrix_free(float* table, const float* Bf, const float* FF,
                                  const int32_t* lens, const int32_t* cols,
                                  const float* vals, float* nume, float* deno,
                                  int64_t row_start, int B, int L, int d, float alpha,
                                  float reg, int adaptive_reg, int cg_iters, float cg_tol,
                                  int item_axis, float num_fixed_rows, int compute_loss,
                                  void* stream) {
  if (B == 0) return 0;
  const int ldF = d | 1;
  const size_t smem = sizeof(float) * ((size_t)L * ldF + (size_t)d * d + 2 * L + 6 * d + 33);
  cudaError_t err = als::allow_smem(als_cg_matrix_free_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  als_cg_matrix_free_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      table, Bf, FF, lens, cols, vals, nume, deno, row_start, L, d, alpha, reg,
      adaptive_reg, cg_iters, cg_tol, item_axis, num_fixed_rows, compute_loss);
  return (int)cudaGetLastError();
}
