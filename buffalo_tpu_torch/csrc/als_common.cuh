// Helpers shared by the ALS row-solve kernels (als_*.cu, batched_cg_dense.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace als {

// Deterministic block-wide sum, returned to every thread: a warp-shuffle
// tree, then the warp partials added in warp order by one thread.  No
// atomics, so a launch sums in the same order every time.  blockDim.x
// must be a multiple of 32; `scratch` holds at least 33 floats.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += scratch[w];
    scratch[32] = s;
  }
  __syncthreads();
  const float s = scratch[32];
  __syncthreads();  // scratch may be reused as soon as this returns
  return s;
}

// The reference's warm-started CG (buffalo_tpu/ops/solve.py:37,49) for one
// system of width d held by one block.  `matvec(v, out)` writes A v into
// `out` and ends with __syncthreads().  On entry x0 and y hold the start
// point and right-hand side; on exit x holds the result.  Vectors live in
// shared memory and are strided over the block's threads.
template <typename MatVec>
__device__ void warm_cg(MatVec matvec, const float* x0, const float* y,
                        float* x, float* r, float* p, float* Ap, float* scratch,
                        int d, int iters, float tol) {
  const int tid = threadIdx.x, T = blockDim.x;
  // warm start: keep x0 unless the zero start has the smaller residual
  matvec(x0, Ap);
  float yy = 0.f, rr = 0.f;
  for (int j = tid; j < d; j += T) {
    const float rj = y[j] - Ap[j];
    r[j] = rj;
    yy += y[j] * y[j];
    rr += rj * rj;
  }
  const float yy_sum = block_sum(yy, scratch);
  const bool use_zero = yy_sum < block_sum(rr, scratch);
  float part = 0.f;
  for (int j = tid; j < d; j += T) {
    x[j] = use_zero ? 0.f : x0[j];
    if (use_zero) r[j] = y[j];
    p[j] = r[j];
    part += r[j] * r[j];
  }
  float rsold = block_sum(part, scratch);
  bool active = rsold >= tol;
  // once a system freezes its x never changes again (alpha = 0), so the
  // remaining lockstep steps of the reference can be skipped
  for (int it = 0; it < iters && active; ++it) {
    matvec(p, Ap);
    part = 0.f;
    for (int j = tid; j < d; j += T) part += p[j] * Ap[j];
    const float alpha = rsold / fmaxf(block_sum(part, scratch), 1e-30f);
    part = 0.f;
    for (int j = tid; j < d; j += T) {
      x[j] += alpha * p[j];
      r[j] -= alpha * Ap[j];
      part += r[j] * r[j];
    }
    const float rsnew = block_sum(part, scratch);
    active = rsnew >= tol;
    const float beta = rsold > 0.f ? rsnew / fmaxf(rsold, 1e-30f) : 0.f;
    for (int j = tid; j < d; j += T) p[j] = r[j] + beta * p[j];
    rsold = rsnew;
    __syncthreads();
  }
}

// Opt in to more than 48 KB of dynamic shared memory when a launch needs it.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace als
