// Helpers shared by the ALS row-solve kernels (als_*.cu, batched_cg_dense.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace als {

constexpr unsigned kFull = 0xffffffffu;

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

// ---------------------------------------------------------------- warp level
// The warp-per-system kernels (K1, K3) hold a vector of width <= N = 32 M
// as M registers per lane: lane i keeps entries i, i + 32, ... (zeros past
// the system's width).

__host__ __device__ constexpr int round32(int n) { return (n + 31) / 32 * 32; }

// A shared-memory row stride for rows of w floats that lanes read or write
// as float4, one row per lane: a multiple of 4 that is 4 (mod 8) words, so
// each quarter-warp's eight 16-byte accesses land on distinct banks.
__host__ __device__ constexpr int lane_row_stride(int w) {
  return ((w + 3) / 4 * 4) % 8 == 4 ? (w + 3) / 4 * 4 : (w + 3) / 4 * 4 + 4;
}

// Warp-wide sum by a fixed xor-butterfly: every lane adds the same two
// values at every level (a + b == b + a in IEEE arithmetic), so all lanes
// get the same bits, and a launch sums in the same order every time.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Reduce-scatter over the warp: on entry every lane holds N partials
// v[0..N) of which those at DW and past are zero; on exit v[32 m] holds the
// warp's sum of entry (lane + 32 m).  Recursive halving in a fixed order
// (xor offsets 16, 8, 4, 2, 1): at offset o a lane keeps the half whose
// index bit o equals its own lane bit and sends the other half, so each
// level moves half of the remaining values; all indices are compile-time.
template <int DW, int N>
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[N]) {
  static_assert(N % 32 == 0 && DW <= N, "N is a multiple of 32 covering DW");
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const bool up = lane & o;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if ((k & 31) < o && k < DW) {  // slot k (bit o clear) pairs with k + o
        const float lo = v[k], hi = (k + o < DW) ? v[k + o] : 0.f;
        const float send = up ? lo : hi;
        const float keep = up ? hi : lo;
        v[k] = keep + __shfl_xor_sync(kFull, send, o);
      }
    }
  }
}

// The reference's warm-started CG (buffalo_tpu/ops/solve.py:37,49) for one
// system held by one warp, M entries per lane.  `matvec(v, out)` writes
// A v; the caller has computed Ax0 = A x0 (K1 reads its loss terms from
// that product).  Every reduction is a warp_sum, so the freeze test and
// the loop exit are the same on all lanes and no block barrier is needed.
template <int M, typename MatVec>
__device__ __forceinline__ void warp_cg(MatVec&& matvec, const float (&x0)[M],
                                        const float (&y)[M], const float (&Ax0)[M],
                                        float (&x)[M], int iters, float tol) {
  float r[M], p[M], Ap[M];
  float yy = 0.f, rr = 0.f;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    r[m] = y[m] - Ax0[m];
    yy += y[m] * y[m];
    rr += r[m] * r[m];
  }
  // warm start: keep x0 unless the zero start has the smaller residual
  const bool use_zero = warp_sum(yy) < warp_sum(rr);
  float part = 0.f;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    x[m] = use_zero ? 0.f : x0[m];
    if (use_zero) r[m] = y[m];
    p[m] = r[m];
    part += r[m] * r[m];
  }
  float rsold = warp_sum(part);
  bool active = rsold >= tol;
  // once a system freezes its x never changes again (alpha = 0), so the
  // remaining lockstep steps of the reference can be skipped
  for (int it = 0; it < iters && active; ++it) {
    matvec(p, Ap);
    part = 0.f;
#pragma unroll
    for (int m = 0; m < M; ++m) part += p[m] * Ap[m];
    const float alpha = rsold / fmaxf(warp_sum(part), 1e-30f);
    part = 0.f;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      x[m] += alpha * p[m];
      r[m] -= alpha * Ap[m];
      part += r[m] * r[m];
    }
    const float rsnew = warp_sum(part);
    active = rsnew >= tol;
    const float beta = rsold > 0.f ? rsnew / fmaxf(rsold, 1e-30f) : 0.f;
#pragma unroll
    for (int m = 0; m < M; ++m) p[m] = r[m] + beta * p[m];
    rsold = rsnew;
  }
}

// Asynchronous global -> shared copies through L1; with `full` false
// nothing is read and the destination is zero-filled.  L1 matters for a
// power-law gather: the popular rows of Bf are read by every SM, and
// copies that bypass L1 (cp.async.cg) queue on the few L2 lines that hold
// them (K1 on the ML-20M L = 96 batch: 3.4x slower, tools/cg_bench.py).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Calls f(std::integral_constant<int, DW>{}) with the compiled width DW
// that covers d (the kernels hold rows of DW floats, zeros past d): the main
// path's 40, the narrow 16, 64 and 128, and for kernels that take wider rows
// (kMaxDW = 256) 160, the iALS++ path's, and 256, each width padded up to
// the next; widths past kMaxDW are refused.
template <int kMaxDW, typename F>
inline int with_width(int d, F&& f) {
  if (d <= 16) return f(std::integral_constant<int, 16>{});
  if (d <= 40) return f(std::integral_constant<int, 40>{});
  if (d <= 64) return f(std::integral_constant<int, 64>{});
  if (d <= 128) return f(std::integral_constant<int, 128>{});
  if constexpr (kMaxDW >= 256) {
    if (d <= 160) return f(std::integral_constant<int, 160>{});
    if (d <= 256) return f(std::integral_constant<int, 256>{});
  }
  return (int)cudaErrorInvalidValue;
}

// Entry i of a values array of float32 or, with bf16 set, bfloat16 (the
// JAX package's vals.astype(float32) on bfloat16 values is exact)
__device__ __forceinline__ float load_val(const void* vals, int64_t i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(vals)[i])
              : static_cast<const float*>(vals)[i];
}

// Opt in to more than 48 KB of dynamic shared memory when a launch needs it.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

constexpr size_t kMaxSmem = 227 * 1024;

}  // namespace als
