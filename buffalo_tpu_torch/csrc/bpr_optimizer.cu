// K10: the deferred optimizer step of one table at the epoch barrier, per
// element: g = grad (divided by max(count of its row, 1) with per-coordinate
// normalization), g -= 2 reg param; adam: m = b1 m + (1 - b1) g, v = b2 v +
// (1 - b2) g^2, param += lr (m / c1) / (sqrt(v / c2) + 1e-8) with the bias
// corrections c1 = 1 - b1^t, c2 = 1 - b2^t; adagrad: v += g^2, param += lr g /
// (sqrt(v) + 1e-8); grad is zeroed.  1 - b1 and 1 - b2 come from the caller,
// rounded from double as the reference rounds them (1 - 0.999f in float is
// 1.3e-5 off 1e-3).  The projection mode (WARP's epoch barrier) then scales
// each row to L2 norm at most 1: x / max(1, |x|).
//
// Replaces buffalo_tpu/ops/sgd_kernels.py apply_deferred_update (:315),
// adam_update (:295), adagrad_update (:305) and bpr_epoch's inline step
// (:579-597); with the projection, warp_kernels.py warp_epoch's barrier
// (:327-343) and project_unit_ball (:498).  The capped add (bpr_capped_add)
// is the sgd mesh epoch's apply, param += clip_row_norm(delta, cap)
// (bpr_epoch_dp :804-846, clip_row_norm :280): per row the delta scaled to
// L2 norm at most cap (cap 0: as it is), or for a vector each element
// clamped to [-cap, cap].
//
// What bounds it on the card: bytes.  It reads param, grad, v (and m) and
// writes them back, 32 (adam) or 24 bytes per element, with a handful of
// operations each.  Design: one fused elementwise pass, one thread per
// element, no reuse and no shared memory; the projection mode takes a warp
// per row (the same step per element, then the row's norm by a fixed-order
// warp sum), holding a row of up to 256 floats in registers; wider rows
// (the wide instantiation) write the stepped row and scale it in a second
// pass.  The capped add takes a warp per row: the delta's norm in lane
// order, then the scaled add.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kMaxH = 8;  // columns per lane in the projection mode's registers
constexpr float kEps = 1e-8f;

// Element e's step: the new value of param[e]; m, v and grad written.
__device__ __forceinline__ float step(float* __restrict__ param, float* __restrict__ grad,
                                     float* __restrict__ m, float* __restrict__ v,
                                     const float* __restrict__ counts, int64_t e, int width,
                                     int adam, float lr, float b1, float b2, float a1, float a2,
                                     float c1, float c2, float reg) {
  float g = grad[e];
  if (counts) g = g / fmaxf(counts[e / width], 1.f);
  const float x = param[e];
  g = g - 2.f * reg * x;
  float delta;
  if (adam) {
    const float mm = b1 * m[e] + a1 * g;
    const float vv = b2 * v[e] + a2 * g * g;
    m[e] = mm;
    v[e] = vv;
    delta = lr * (mm / c1) / (sqrtf(vv / c2) + kEps);
  } else {
    const float vv = v[e] + g * g;
    v[e] = vv;
    delta = lr * g / (sqrtf(vv) + kEps);
  }
  grad[e] = 0.f;
  return x + delta;
}

__global__ void __launch_bounds__(kThreads)
optimizer_kernel(float* __restrict__ param, float* __restrict__ grad, float* __restrict__ m,
                 float* __restrict__ v, const float* __restrict__ counts, int64_t n, int width,
                 int adam, float lr, float b1, float b2, float a1, float a2, float c1, float c2,
                 float reg) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  param[e] = step(param, grad, m, v, counts, e, width, adam, lr, b1, b2, a1, a2, c1, c2, reg);
}

// One warp per row: the step of each element, then the row scaled to norm <= 1.
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
project_kernel(float* __restrict__ param, float* __restrict__ grad, float* __restrict__ m,
               float* __restrict__ v, const float* __restrict__ counts, int64_t rows, int width,
               int adam, float lr, float b1, float b2, float a1, float a2, float c1, float c2,
               float reg) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;
  float ss = 0.f;
  if (kWide) {
    // columns in the same order as the registers' (lane + 32 h)
    for (int c = lane; c < width; c += 32) {
      const float x = step(param, grad, m, v, counts, r * width + c, width, adam, lr, b1, b2,
                           a1, a2, c1, c2, reg);
      param[r * width + c] = x;
      ss = fmaf(x, x, ss);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float scale = fmaxf(1.f, sqrtf(ss));
    for (int c = lane; c < width; c += 32) param[r * width + c] /= scale;
    return;
  }
  float x[kMaxH];
#pragma unroll
  for (int h = 0; h < kMaxH; ++h) {
    const int c = lane + 32 * h;
    x[h] = c < width ? step(param, grad, m, v, counts, r * width + c, width, adam, lr, b1, b2,
                            a1, a2, c1, c2, reg)
                     : 0.f;
    ss = fmaf(x[h], x[h], ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float scale = fmaxf(1.f, sqrtf(ss));
#pragma unroll
  for (int h = 0; h < kMaxH; ++h) {
    const int c = lane + 32 * h;
    if (c < width) param[r * width + c] = x[h] / scale;
  }
}

// One warp per row: param += delta scaled to L2 norm at most cap.
__global__ void __launch_bounds__(kThreads)
capped_rows_kernel(float* __restrict__ param, const float* __restrict__ delta, int64_t rows,
                   int width, float cap) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;
  const float* dr = delta + r * width;
  float s = 1.f;
  if (cap > 0.f) {
    float ss = 0.f;
    for (int c = lane; c < width; c += 32) ss = fmaf(dr[c], dr[c], ss);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    s = fminf(1.f, cap / fmaxf(sqrtf(ss), 1e-12f));
  }
  for (int c = lane; c < width; c += 32) param[r * width + c] += dr[c] * s;
}

// One thread per element of a vector: param += delta clamped to [-cap, cap].
__global__ void __launch_bounds__(kThreads)
capped_elements_kernel(float* __restrict__ param, const float* __restrict__ delta, int64_t n,
                       float cap) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  const float x = delta[e];
  param[e] += cap > 0.f ? fminf(fmaxf(x, -cap), cap) : x;
}

}  // namespace

// 1 when rows of `width` floats take the projection's wide instantiation.
extern "C" int bpr_optimizer_wide(int width) { return width > 32 * kMaxH ? 1 : 0; }

// n = rows * width elements; m is read only for adam, counts (one per row)
// only when given; a1 = 1 - b1, a2 = 1 - b2; project: each row then scaled to
// L2 norm at most 1.
extern "C" int bpr_optimizer(float* param, float* grad, float* m, float* v, const float* counts,
                             int64_t n, int width, int adam, float lr, float b1, float b2,
                             float a1, float a2, float c1, float c2, float reg, int project,
                             void* stream) {
  if (n < 0 || width < 1 || (adam && !m) || n % width) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (project) {
    const int64_t rows = n / width;
    const unsigned grid = (unsigned)((rows + kWarps - 1) / kWarps);
    if (bpr_optimizer_wide(width))
      project_kernel<true><<<grid, kThreads, 0, st>>>(param, grad, m, v, counts, rows, width,
                                                      adam, lr, b1, b2, a1, a2, c1, c2, reg);
    else
      project_kernel<false><<<grid, kThreads, 0, st>>>(param, grad, m, v, counts, rows, width,
                                                       adam, lr, b1, b2, a1, a2, c1, c2, reg);
  } else {
    optimizer_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        param, grad, m, v, counts, n, width, adam, lr, b1, b2, a1, a2, c1, c2, reg);
  }
  return (int)cudaGetLastError();
}

// param += clip_row_norm(delta, cap): rows of `width` floats (elementwise: a
// vector, each element clamped); cap 0 adds the delta as it is.
extern "C" int bpr_capped_add(float* param, const float* delta, int64_t n, int width,
                              float cap, int elementwise, void* stream) {
  if (n < 0 || width < 1 || n % width || cap < 0.f) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (elementwise) {
    capped_elements_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        param, delta, n, cap);
  } else {
    const int64_t rows = n / width;
    capped_rows_kernel<<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0, st>>>(
        param, delta, rows, width, cap);
  }
  return (int)cudaGetLastError();
}
