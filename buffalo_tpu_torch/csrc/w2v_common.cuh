// What the W2V kernels share (K19 csrc/w2v_pair_step.cu, K21
// csrc/w2v_stream_chunk.cu): K21's row of d <= 32 H floats held by a warp,
// lane c owning columns c + 32 h, and the warp's dot product; the warp sum;
// g(label, f) = label - sigmoid(f) with the reference's hard clamps
// at +-6 (buffalo_tpu/ops/w2v_kernels.py _g :27); and the (loss, count)
// partials summed per block in warp order, then over the blocks in a fixed
// order, with no float atomics.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr float kMaxExp = 6.f, kEps = 1e-10f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float sigm(float f) { return 1.f / (1.f + expf(-f)); }

__device__ __forceinline__ float g_of(float label, float f) {
  return f > kMaxExp ? label - 1.f : (f < -kMaxExp ? label : label - sigm(f));
}

template <int H>
__device__ __forceinline__ void load_row(const float* row, int d, int lane, float (&r)[H]) {
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int c = lane + 32 * h;
    r[h] = c < d ? row[c] : 0.f;
  }
}

template <int H>
__device__ __forceinline__ float dot(const float (&a)[H], const float (&b)[H]) {
  float s = 0.f;
#pragma unroll
  for (int h = 0; h < H; ++h) s += a[h] * b[h];
  return warp_sum(s);
}

template <int H>
__device__ __forceinline__ void axpy(float a, const float (&x)[H], float (&y)[H]) {
#pragma unroll
  for (int h = 0; h < H; ++h) y[h] += a * x[h];
}

// out[c] = s r[c]
template <int H>
__device__ __forceinline__ void store_row(float* __restrict__ out, int d, int lane, float s,
                                          const float (&r)[H]) {
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int c = lane + 32 * h;
    if (c < d) out[c] = s * r[h];
  }
}

// part[2 blockIdx.x + {0, 1}] = the block's (loss, count): each warp's lane-0
// values added in warp order.  Every thread of the block calls it.
__device__ __forceinline__ void block_partials(float loss, float cnt, float* __restrict__ part) {
  __shared__ float wloss[kWarps], wcnt[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    wloss[warp] = loss;
    wcnt[warp] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sl = 0.f, sc = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      sl += wloss[w];
      sc += wcnt[w];
    }
    part[2 * blockIdx.x] = sl;
    part[2 * blockIdx.x + 1] = sc;
  }
}

// out[0], out[1]: the sums of the n partial pairs, in a fixed order (each
// lane a strided run, then a fixed shuffle tree).
__global__ void __launch_bounds__(32) sum_parts(const float* __restrict__ part, int n,
                                                float* __restrict__ out) {
  const int lane = threadIdx.x;
  float a = 0.f, c = 0.f;
  for (int i = lane; i < n; i += 32) {
    a += part[2 * i];
    c += part[2 * i + 1];
  }
  a = warp_sum(a);
  c = warp_sum(c);
  if (lane == 0) {
    out[0] = a;
    out[1] = c;
  }
}

}  // namespace
