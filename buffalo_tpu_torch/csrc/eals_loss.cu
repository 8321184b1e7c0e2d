// K14: eALS's residuals and loss terms over the nnz entries (row rows[e], col
// keys[e], value vals[e]): vhat_e = P[row] . Q[col] (or the given residuals),
// written when asked, and the three sums sum w err^2, sum C[col] vhat^2 and
// sum err^2 with w = 1 + alpha v, err = v - vhat.  The d x d term <Sp, Sq> and
// the regularizers stay torch products on the small tables.
//
// Replaces buffalo_tpu/ops/eals_kernels.py compute_vhat (:356) and the nnz
// sums of eals_loss (:334-344).
//
// What bounds it on the card: bytes.  Two rows of d floats gathered per entry
// (hitting L2: P 22 MB, Q 4.3 MB at ML-20M, d = 40), the ids, values and
// weights read and the residuals written: ~0.4 GB per pass of the 19.9M
// ML-20M entries, ~4 d operations each.  Design: a grid of at most 1,056
// blocks, one thread per entry in a grid-stride loop computing its dot with
// 16-byte loads, the sums accumulated in double per thread, reduced in a
// fixed order within the block (shuffles, then the warps in order) and over
// the blocks by a second one-block launch, so two launches are bitwise equal.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1056;  // 8 per SM of the H100's 132

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float dot(const float* __restrict__ p, const float* __restrict__ q,
                                     int d, bool vec) {
  float acc = 0.f;
  if (vec) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    for (int c = 0; c < d / 4; ++c) {
      const float4 a = __ldg(p4 + c), b = __ldg(q4 + c);
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
      acc = fmaf(a.z, b.z, acc);
      acc = fmaf(a.w, b.w, acc);
    }
  } else {
    for (int c = 0; c < d; ++c) acc = fmaf(__ldg(p + c), __ldg(q + c), acc);
  }
  return acc;
}

// Block sums of the three terms into part[3 * blockIdx.x ..].
__global__ void __launch_bounds__(kThreads)
residual_kernel(const float* __restrict__ P, const float* __restrict__ Q, int d, bool vec,
                const int32_t* __restrict__ rows, const int32_t* __restrict__ keys,
                const float* __restrict__ vals, const float* __restrict__ C, int64_t n,
                float alpha, const float* __restrict__ vhat_in, float* __restrict__ vhat_out,
                double* __restrict__ part) {
  __shared__ double red[3 * kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double s[3] = {0.0, 0.0, 0.0};
  for (int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * kThreads) {
    const int col = keys[e];
    const float v = vhat_in ? vhat_in[e] : dot(P + (int64_t)rows[e] * d, Q + (int64_t)col * d, d, vec);
    if (vhat_out) vhat_out[e] = v;
    if (part) {
      const float x = vals[e];
      const float err = x - v;
      const float w = 1.f + alpha * x;
      s[0] += (double)(w * err * err);
      s[1] += (double)(C[col] * v * v);
      s[2] += (double)(err * err);
    }
  }
  if (!part) return;
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    s[t] = warp_sum(s[t]);
    if (lane == 0) red[3 * warp + t] = s[t];
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    double tot = 0.0;
    for (int w = 0; w < kWarps; ++w) tot += red[3 * w + threadIdx.x];
    part[3 * blockIdx.x + threadIdx.x] = tot;
  }
}

// One block: the blocks' sums added in order, rounded to float once.
__global__ void __launch_bounds__(32) total_kernel(const double* __restrict__ part, int nb,
                                                   float* __restrict__ out) {
  if (threadIdx.x >= 3) return;
  double tot = 0.0;
  for (int b = 0; b < nb; ++b) tot += part[3 * b + threadIdx.x];
  out[threadIdx.x] = (float)tot;
}

int blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

}  // namespace

// Workspace doubles for n entries.
extern "C" int eals_loss_workspace(int64_t n) { return 3 * blocks_for(n); }

// vhat_in (residuals given) or P/Q (computed); vhat_out may be null; sums
// (3 floats) may be null, then vals, C and part are unused.
extern "C" int eals_loss(const float* P, const float* Q, int d, const int32_t* rows,
                         const int32_t* keys, const float* vals, const float* C, int64_t n,
                         float alpha, const float* vhat_in, float* vhat_out, double* part,
                         float* sums, void* stream) {
  if (n < 0 || d < 1 || (!vhat_in && (!P || !Q)) || (sums && !part))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int nb = blocks_for(n);
  const bool vec = d % 4 == 0 && P && Q && (uintptr_t)P % 16 == 0 && (uintptr_t)Q % 16 == 0;
  if (n > 0 || sums)
    residual_kernel<<<nb, kThreads, 0, st>>>(P, Q, d, vec, rows, keys, vals, C, n, alpha, vhat_in,
                                             vhat_out, sums ? part : nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !sums) return (int)err;
  total_kernel<<<1, 32, 0, st>>>(part, nb, sums);
  return (int)cudaGetLastError();
}
