// The counter-based draws and the bloom probe shared by the sampling kernels
// (K8 csrc/bpr_sample.cu, K11 csrc/warp_search.cu, K19 csrc/w2v_pair_step.cu):
// Philox4x32-10, the alias draw and the
// blocked bloom filter's hashes (buffalo_tpu/ops/sgd_kernels.py _mix32 :106,
// _bloom_hashes :117, bloom_contains :234), the same uint32 functions as the
// plain versions in ops/sgd_kernels.py.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct U4 {
  uint32_t x0, x1, x2, x3;
};

// Philox4x32-10 (Salmon et al., SC 2011; Random123's round and key schedule).
__device__ __forceinline__ U4 philox(U4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x0), lo0 = 0xD2511F53u * c.x0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.x2), lo1 = 0xCD9E8D57u * c.x2;
    c = U4{hi1 ^ c.x1 ^ k0, lo1, hi0 ^ c.x3 ^ k1, lo0};
  }
  return c;
}

// The draw of K8 and K19: the Philox words (x0, x1) of the counter
// (c0, c1, c2, c3) give the index mulhi(x0, n); with alias tables that index
// is kept when (x1 >> 8) 2^-24 < prob[index], else alias[index] is drawn;
// with prob null it is drawn uniformly.
__device__ __forceinline__ uint32_t alias_draw(U4 ctr, uint32_t k0, uint32_t k1, uint32_t n,
                                               const float* __restrict__ prob,
                                               const int32_t* __restrict__ alias) {
  const U4 x = philox(ctr, k0, k1);
  const uint32_t cand = __umulhi(x.x0, n);
  if (!prob) return cand;
  const float u01 = (float)(x.x1 >> 8) * (1.0f / 16777216.0f);
  return u01 < prob[cand] ? cand : (uint32_t)alias[cand];
}

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

// Whether the blocked bloom filter flags (u, i) as a positive: both bits of
// the pair in its one word; wmask = 2^(log2_bits - 5) - 1.
__device__ __forceinline__ bool bloom_contains(const uint32_t* __restrict__ bloom, uint32_t wmask,
                                               uint32_t u, uint32_t i) {
  const uint32_t h1 = mix32(u ^ mix32(i ^ 0x9e3779b9u));
  const uint32_t h2 = mix32(i ^ mix32(u ^ 0x85ebca6bu));
  const uint32_t w = bloom[h1 & wmask];
  return (w >> (h2 & 31u)) & (w >> ((h2 >> 5) & 31u)) & 1u;
}

}  // namespace
