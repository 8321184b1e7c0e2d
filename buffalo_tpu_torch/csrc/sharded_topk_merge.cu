// K22: the sharded top-k merge.  For each query, D lists of kl candidates
// (one per shard of a row-sharded table, each sorted by score descending,
// ties to the smaller global index, shard j's indices all below shard
// j+1's) become the top k of their shard-major concatenation, in the same
// order: score descending, ties to the smaller index.
//
// Replaces the merge of buffalo_tpu/ops/topk.py sharded_matmul_topk
// (:353-365: an all-gather of the (B, D * kl) candidates, then lax.top_k
// over them and a take_along_axis of the indices).
//
// Entries compare as 64-bit keys: the score's bits mapped to an
// order-preserving unsigned integer in the high word, the index reversed
// in the low word, as the plain version (ops/retrieval_kernels.py _keys)
// orders them, so the two agree bit for bit, -inf and ties included.
//
// What bounds it on the card: bytes (the candidates read once, the k
// results written once) at the sizes serving uses; each output is one
// warp-wide arg-max.  Design: one warp per query; lane j < D holds the head
// of shard j's list in registers; each step takes the warp's largest key
// (a xor-butterfly of 64-bit shuffles), the winning lane writes it and
// loads its next candidate.  D <= 32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8, kThreads = kWarps * 32;

__device__ __forceinline__ unsigned long long key_of(float v, int idx) {
  const unsigned b = __float_as_uint(v);
  const unsigned o = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)o << 32) | (unsigned long long)(0xffffffffu - (unsigned)idx);
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long y = __shfl_xor_sync(kFull, x, o);
    x = y > x ? y : x;
  }
  return x;
}

__global__ void __launch_bounds__(kThreads)
merge(const float* __restrict__ vals, const int* __restrict__ idx, int B, int D, int kl, int k,
      float* __restrict__ out_v, int* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (q >= B) return;  // whole warps leave together
  const bool mine = lane < D;
  const float* v = vals + ((int64_t)q * D + (mine ? lane : 0)) * kl;
  const int* ix = idx + ((int64_t)q * D + (mine ? lane : 0)) * kl;
  int pos = 0;
  float hv = 0.f;
  int hi = 0;
  // key 0 marks an exhausted (or absent) list: no real entry has it
  unsigned long long head = 0;
  if (mine) {
    hv = v[0];
    hi = ix[0];
    head = key_of(hv, hi);
  }
  float* ov = out_v + (int64_t)q * k;
  int* oi = out_i + (int64_t)q * k;
  for (int t = 0; t < k; ++t) {
    const unsigned long long best = warp_max(head);
    if (mine && head == best) {
      ov[t] = hv;
      oi[t] = hi;
      if (++pos < kl) {
        hv = v[pos];
        hi = ix[pos];
        head = key_of(hv, hi);
      } else {
        head = 0;
      }
    }
  }
}

}  // namespace

// vals / idx: (B, D, kl) row-major; out_v / out_i: (B, k).  1 <= D <= 32,
// 1 <= k <= D * kl; the indices of one query are distinct.
extern "C" int sharded_topk_merge(const float* vals, const int* idx, int B, int D, int kl, int k,
                                  float* out_v, int* out_i, void* stream) {
  if (B < 0 || D < 1 || D > 32 || kl < 1 || k < 1 || (int64_t)k > (int64_t)D * kl)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  merge<<<(B + kWarps - 1) / kWarps, kThreads, 0, (cudaStream_t)stream>>>(vals, idx, B, D, kl, k,
                                                                          out_v, out_i);
  return (int)cudaGetLastError();
}
