// K10: the deferred optimizer step of one table at the epoch barrier, per
// element: g = grad (divided by max(count of its row, 1) with per-coordinate
// normalization), g -= 2 reg param; adam: m = b1 m + (1 - b1) g, v = b2 v +
// (1 - b2) g^2, param += lr (m / c1) / (sqrt(v / c2) + 1e-8) with the bias
// corrections c1 = 1 - b1^t, c2 = 1 - b2^t; adagrad: v += g^2, param += lr g /
// (sqrt(v) + 1e-8); grad is zeroed.  1 - b1 and 1 - b2 come from the caller,
// rounded from double as the reference rounds them (1 - 0.999f in float is
// 1.3e-5 off 1e-3).
//
// Replaces buffalo_tpu/ops/sgd_kernels.py apply_deferred_update (:315),
// adam_update (:295), adagrad_update (:305) and bpr_epoch's inline step
// (:579-597).
//
// What bounds it on the card: bytes.  It reads param, grad, v (and m) and
// writes them back, 32 (adam) or 24 bytes per element, with a handful of
// operations each.  Design: one fused elementwise pass, one thread per
// element, no reuse and no shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-8f;

__global__ void __launch_bounds__(kThreads)
optimizer_kernel(float* __restrict__ param, float* __restrict__ grad, float* __restrict__ m,
                 float* __restrict__ v, const float* __restrict__ counts, int64_t n, int width,
                 int adam, float lr, float b1, float b2, float a1, float a2, float c1, float c2,
                 float reg) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
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
  param[e] = x + delta;
  grad[e] = 0.f;
}

}  // namespace

// n = rows * width elements; m is read only for adam, counts (one per row)
// only when given; a1 = 1 - b1, a2 = 1 - b2.
extern "C" int bpr_optimizer(float* param, float* grad, float* m, float* v, const float* counts,
                             int64_t n, int width, int adam, float lr, float b1, float b2,
                             float a1, float a2, float c1, float c2, float reg, void* stream) {
  if (n < 0 || width < 1 || (adam && !m)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  optimizer_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                     (cudaStream_t)stream>>>(param, grad, m, v, counts, n, width, adam, lr, b1,
                                              b2, a1, a2, c1, c2, reg);
  return (int)cudaGetLastError();
}
