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
// loads its next candidate.  Past 32 shards (the wide form) the heads sit
// in the warp's slice of shared memory, lane j keeping lists j, j + 32, ...:
// each step a lane's best head, then the same warp-wide arg-max.
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

// The wide form (D > 32): the warp's heads in shared memory (D keys and
// positions per warp).
__global__ void __launch_bounds__(kThreads)
merge_wide(const float* __restrict__ vals, const int* __restrict__ idx, int B, int D, int kl,
           int k, float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ unsigned long long heads[];  // [kWarps][D], then [kWarps][D] positions
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = blockIdx.x * kWarps + warp;
  if (q >= B) return;  // whole warps leave together
  unsigned long long* head = heads + (int64_t)warp * D;
  int* pos = reinterpret_cast<int*>(heads + (int64_t)kWarps * D) + (int64_t)warp * D;
  const float* v = vals + (int64_t)q * D * kl;
  const int* ix = idx + (int64_t)q * D * kl;
  for (int j = lane; j < D; j += 32) {
    head[j] = key_of(v[(int64_t)j * kl], ix[(int64_t)j * kl]);
    pos[j] = 0;
  }
  float* ov = out_v + (int64_t)q * k;
  int* oi = out_i + (int64_t)q * k;
  for (int t = 0; t < k; ++t) {
    unsigned long long mine = 0;
    int jm = -1;
    for (int j = lane; j < D; j += 32)
      if (head[j] > mine) {
        mine = head[j];
        jm = j;
      }
    const unsigned long long best = warp_max(mine);
    if (jm >= 0 && mine == best) {
      const int64_t o = (int64_t)jm * kl + pos[jm];
      ov[t] = v[o];
      oi[t] = ix[o];
      if (++pos[jm] < kl) head[jm] = key_of(v[o + 1], ix[o + 1]);
      else head[jm] = 0;
    }
    __syncwarp();
  }
}

}  // namespace

// 1 when D lists take the wide form.
extern "C" int sharded_topk_merge_wide(int D) { return D > 32 ? 1 : 0; }

// vals / idx: (B, D, kl) row-major; out_v / out_i: (B, k).  D >= 1,
// 1 <= k <= D * kl; the indices of one query are distinct.
extern "C" int sharded_topk_merge(const float* vals, const int* idx, int B, int D, int kl, int k,
                                  float* out_v, int* out_i, void* stream) {
  if (B < 0 || D < 1 || kl < 1 || k < 1 || (int64_t)k > (int64_t)D * kl)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  if (sharded_topk_merge_wide(D)) {
    const size_t smem = (sizeof(unsigned long long) + sizeof(int)) * kWarps * (size_t)D;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          merge_wide, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    merge_wide<<<(B + kWarps - 1) / kWarps, kThreads, smem, (cudaStream_t)stream>>>(
        vals, idx, B, D, kl, k, out_v, out_i);
    return (int)cudaGetLastError();
  }
  merge<<<(B + kWarps - 1) / kWarps, kThreads, 0, (cudaStream_t)stream>>>(vals, idx, B, D, kl, k,
                                                                          out_v, out_i);
  return (int)cudaGetLastError();
}
