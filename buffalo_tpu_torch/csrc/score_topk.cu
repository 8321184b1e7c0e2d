// K5: fused score + top-k.  For each row of p (B, d), float32 or bfloat16,
// the k best (score, index) pairs of p . Q^T (+ Qb) over the rows of Q (N, d),
// sorted by score descending, ties to the smaller index; the (B x N) score
// matrix is never written.
//
// Replaces buffalo_tpu/ops/topk.py: _chunked_topn (:171) and
// _chunked_topn_tiled (:195) (jnp.dot + lax.top_k per query chunk, or per
// item tile with a concat + top_k merge), which batch_topn (:238) calls, and
// the assignment steps of IVFIndex.build (buffalo_tpu/parallel/ann.py:220
// lloyd's argmax, k = 1, and :245 spill_assign's top_k, k = spill), where the
// unit rows are the queries and the centroids the items.
//
// What bounds it on the card: 2 B N d FP32 operations (1.01 TFLOP for 10,000
// queries over the 505,840 x 100 KakaoBrunch catalog, 15 ms at 67 TFLOP/s)
// against B d + N d + N floats read (0.2 GB, 0.06 ms): the operations.  Design
// (topk_select.cuh): a block of 256 threads holds 64 queries (k <= 32; 32 for
// k <= 128, 8 for k <= 1024) in shared memory and streams its part of Q
// through shared memory in tiles of 128 items (256 for k > 128), each thread
// computing a 4 x 8 (2 x 8, 1 x 8) register tile of scores with FFMA; per
// query a warp keeps the sorted list and the running k-th threshold, so only
// the few items that beat it are sorted.  The item axis is split S ways
// (grid.y, chosen by the caller) so that 1,000 queries still give enough
// blocks for 132 SMs; a second launch merges the S partial lists per query,
// the concat + top_k of _chunked_topn_tiled.
#include "topk_select.cuh"

namespace {

using namespace topk;

template <class C, bool kWide>
__global__ void __launch_bounds__(kThreads)
score_topk_kernel(const void* __restrict__ p, int p_bf16, const float* __restrict__ Q,
                  const float* __restrict__ Qb, int B, int N, int d, int k, int per_split,
                  uint64_t* __restrict__ part, float* __restrict__ vals,
                  int32_t* __restrict__ idx) {
  extern __shared__ __align__(16) char smem[];
  const Smem<C> sm(smem, kWide ? kDC : d);
  const int q0 = blockIdx.x * C::QB, s = blockIdx.y;
  const int lo = s * per_split, n = max(0, min(per_split, N - lo));
  for (int q = threadIdx.x; q < C::QB; q += kThreads) sm.row[q] = q0 + q < B ? q0 + q : -1;
  __syncthreads();
  scan_items<C, kWide>(sm, p, p_bf16 != 0, d, Q + (int64_t)lo * d, Qb ? Qb + lo : nullptr, n,
                (uint32_t)lo, k);
  for (int e = threadIdx.x; e < C::QB * k; e += kThreads) {
    const int q = e / k, j = e % k;
    if (q0 + q >= B) continue;
    const uint64_t key = sm.list[q * C::KP + j];
    const int64_t o = (int64_t)(q0 + q) * k + j;
    if (gridDim.y == 1) {
      vals[o] = key_score(key);
      idx[o] = (int32_t)key_index(key);
    } else {
      part[(int64_t)s * B * k + o] = key;
    }
  }
}

// The top k of query b's S partial lists (S k keys, 0-padded to n, a power
// of two): one block per query, a bitonic sort in shared memory.
__global__ void __launch_bounds__(kThreads)
merge_splits_kernel(const uint64_t* __restrict__ part, int S, int B, int k, int n,
                    float* __restrict__ vals, int32_t* __restrict__ idx) {
  extern __shared__ __align__(16) char smem[];
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem);
  const int b = blockIdx.x;
  for (int e = threadIdx.x; e < n; e += kThreads)
    keys[e] = e < S * k ? part[((int64_t)(e / k) * B + b) * k + e % k] : 0ull;
  __syncthreads();
  bitonic_sort_desc(keys, n, threadIdx.x, kThreads, [] { __syncthreads(); });
  for (int j = threadIdx.x; j < k; j += kThreads) {
    vals[(int64_t)b * k + j] = key_score(keys[j]);
    idx[(int64_t)b * k + j] = (int32_t)key_index(keys[j]);
  }
}

}  // namespace

// part: S * B * k keys of scratch when S > 1 (unused when S == 1).
extern "C" int score_topk(const void* p, int p_bf16, const float* Q, const float* Qb, int B,
                          int N, int d, int k, int S, uint64_t* part, float* vals,
                          int32_t* idx, void* stream) {
  if (B == 0) return 0;
  if (k < 1 || k > N || d < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return with_list(k, [&](auto cfg) {
    using C = decltype(cfg);
    const bool wide = d > kMaxStagedD;
    const size_t bytes = Smem<C>::bytes(wide ? kDC : d);
    if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
    auto kernel = wide ? score_topk_kernel<C, true> : score_topk_kernel<C, false>;
    cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return (int)err;
    const int per_split = (N + S - 1) / S;
    kernel<<<dim3((B + C::QB - 1) / C::QB, S), kThreads, bytes, st>>>(
        p, p_bf16, Q, Qb, B, N, d, k, per_split, part, vals, idx);
    err = cudaGetLastError();
    if (err != cudaSuccess || S == 1) return (int)err;
    int n = 1;
    while (n < S * k) n <<= 1;
    const size_t mbytes = sizeof(uint64_t) * n;
    if (mbytes > kMaxSmem) return (int)cudaErrorInvalidValue;
    err = allow_smem(merge_splits_kernel, mbytes);
    if (err != cudaSuccess) return (int)err;
    merge_splits_kernel<<<B, kThreads, mbytes, st>>>(part, S, B, k, n, vals, idx);
    return (int)cudaGetLastError();
  });
}
