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
// results written once) at the sizes serving uses.  Two forms, the choice
// a function of (D, kl, k) alone (sharded_topk_merge_form):
//  * the warp form, for small k: one warp per query; lane j < D holds the
//    head of shard j's list in registers; each step takes the warp's
//    largest key (a xor-butterfly of 64-bit shuffles), the winning lane
//    writes it and loads its next candidate.  Past 32 shards (the wide
//    form) the heads sit in the warp's slice of shared memory, lane j
//    keeping lists j, j + 32, ...: each step a lane's best head, then the
//    same warp-wide arg-max.  Its k steps are serial, each a shuffle
//    arg-max and a dependent load;
//  * the tree form, for large k: only each list's first L = min(kl, k)
//    entries can reach the top k.  A block stages them for G queries in
//    shared memory as keys and merges the lists in pairs, level by level
//    (D lists, then ceil(D / 2), ...; a list without a partner is copied),
//    each merged list cut at k, the last level writing the top k.  Within
//    a merge each thread writes kMergeRun consecutive outputs: their
//    start's split between the two lists by a binary search (the merge
//    path), then a walk of kMergeRun steps, the same for every thread.
//    The keys of one query are distinct (its indices are), so every merge
//    is exact; nothing is serial in k.  The lists must fit in shared memory
//    (sharded_topk_merge_tree_fits).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8, kThreads = kWarps * 32;
constexpr int kMergeRun = 8;           // outputs of a merge by one thread
constexpr int kMaxGroup = 64;          // most queries of a tree-form block
constexpr int kSmemMax = 232448;       // shared memory a block can take
constexpr int kTreeMinK = 32;          // the tree form from this k on ...
constexpr int kTreeMaxD = 16;          // ... for at most this many lists

__device__ __forceinline__ unsigned long long key_of(float v, int idx) {
  const unsigned b = __float_as_uint(v);
  const unsigned o = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)o << 32) | (unsigned long long)(0xffffffffu - (unsigned)idx);
}

// The score and the index of a key (key_of's inverse).
__device__ __forceinline__ float value_of(unsigned long long key) {
  const unsigned o = (unsigned)(key >> 32);
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ int index_of(unsigned long long key) {
  return (int)(0xffffffffu - (unsigned)key);
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

// A staged list holds entry p at p + p / 16: one padding key per 16, so
// that threads merging runs a few entries apart read and write distinct
// banks.
__host__ __device__ __forceinline__ int padded(int p) { return p + (p >> 4); }
__host__ __device__ __forceinline__ int stride_of(int n) { return padded(n - 1) + 1; }

// The tree's shared memory for one query, in keys: level t holds ceil(D /
// 2^t) lists of at most min(k, 2^t L) keys, the even levels in region X,
// the odd ones in region Y (the last level goes to the output).
__host__ __device__ __forceinline__ void tree_words(int D, int L, int k, int* xw, int* yw) {
  *xw = *yw = 0;
  int m = D;
  for (int t = 0; m > 1 || t == 0; ++t) {
    const int64_t full = (int64_t)L << (t < 20 ? t : 20);
    const int w = m * stride_of((int)(full < k ? full : k));
    int* r = (t & 1) ? yw : xw;
    if (w > *r) *r = w;
    if (m == 1) break;
    m = (m + 1) / 2;
  }
}

// The keys in list i of level t (it covers the D lists i 2^t ..): at most k.
__device__ __forceinline__ int tree_len(int i, int t, int D, int L, int k) {
  const int cover = min(1 << t, D - (i << t));
  const int64_t n = (int64_t)cover * L;
  return n < k ? (int)n : k;
}

// The tree form: block b takes queries [b G, b G + G); L = min(kl, k).
// vec4: the candidates staged with 16-byte loads (kl and L multiples of 4).
__global__ void __launch_bounds__(kThreads)
merge_tree(const float* __restrict__ vals, const int* __restrict__ idx, int B, int D, int kl,
           int k, int G, int vec4, float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ unsigned long long region[];  // [G][xw] then [G][yw]
  const int L = min(kl, k), q0 = blockIdx.x * G, nq = min(G, B - q0);
  int xw, yw;
  tree_words(D, L, k, &xw, &yw);
  unsigned long long* X = region;
  unsigned long long* Y = region + (int64_t)G * xw;
  const int64_t first = (int64_t)q0 * D;  // the block's first list
  const int S0 = stride_of(L);
  if (vec4) {
    const int L4 = L / 4;
    for (int t = threadIdx.x; t < nq * D * L4; t += kThreads) {
      const int row = t / L4, p = 4 * (t - row * L4), g = row / D, j = row - g * D;
      const int64_t src = (first + row) * kl + p;
      const float4 v = *reinterpret_cast<const float4*>(vals + src);
      const int4 i = *reinterpret_cast<const int4*>(idx + src);
      unsigned long long* dst = X + g * xw + j * S0 + padded(p);  // one run of 16
      dst[0] = key_of(v.x, i.x);
      dst[1] = key_of(v.y, i.y);
      dst[2] = key_of(v.z, i.z);
      dst[3] = key_of(v.w, i.w);
    }
  } else {
    for (int t = threadIdx.x; t < nq * D * L; t += kThreads) {
      const int row = t / L, p = t - row * L, g = row / D, j = row - g * D;
      const int64_t src = (first + row) * kl + p;
      X[g * xw + j * S0 + padded(p)] = key_of(vals[src], idx[src]);
    }
  }
  __syncthreads();
  int m = D;
  for (int t = 0;; ++t) {
    const int m2 = (m + 1) / 2;
    const bool last = m2 == 1;  // the final merge (or D = 1's copy) writes the output
    const unsigned long long* in = (t & 1) ? Y : X;
    unsigned long long* out = (t & 1) ? X : Y;
    const int iw = (t & 1) ? yw : xw, ow = (t & 1) ? xw : yw;
    const int istr = stride_of(tree_len(0, t, D, L, k)),
              ostr = stride_of(tree_len(0, t + 1, D, L, k));
    const int runs = (tree_len(0, t + 1, D, L, k) + kMergeRun - 1) / kMergeRun;
    for (int w = threadIdx.x; w < nq * m2 * runs; w += kThreads) {
      const int g = w / (m2 * runs), rest = w - g * (m2 * runs), p = rest / runs;
      const int o0 = (rest - p * runs) * kMergeRun;
      const unsigned long long* a = in + g * iw + 2 * p * istr;
      const unsigned long long* b = a + istr;
      const int na = tree_len(2 * p, t, D, L, k);
      const int nb = 2 * p + 1 < m ? tree_len(2 * p + 1, t, D, L, k) : 0;
      const int n = min(k, na + nb);
      if (o0 >= n) continue;
      int lo = max(0, o0 - nb), hi = min(o0, na);  // a's share of the first o0
      while (lo < hi) {
        const int i = (lo + hi) >> 1;
        if (a[padded(i)] > b[padded(o0 - i - 1)]) lo = i + 1;
        else hi = i;
      }
      int i = lo, j = o0 - lo;
      const int o1 = min(o0 + kMergeRun, n);
      const int64_t q = q0 + g;
      for (int o = o0; o < o1; ++o) {
        const bool take_a = j >= nb || (i < na && a[padded(i)] > b[padded(j)]);
        const unsigned long long key = take_a ? a[padded(i)] : b[padded(j)];
        if (take_a) ++i;
        else ++j;
        if (last) {
          out_v[q * k + o] = value_of(key);
          out_i[q * k + o] = index_of(key);
        } else {
          out[g * ow + p * ostr + padded(o)] = key;
        }
      }
    }
    if (last) return;
    __syncthreads();
    m = m2;
  }
}

cudaError_t launch_warp(const float* vals, const int* idx, int B, int D, int kl, int k,
                        float* out_v, int* out_i, cudaStream_t st) {
  const unsigned grid = (unsigned)((B + kWarps - 1) / kWarps);
  if (D <= 32) {
    merge<<<grid, kThreads, 0, st>>>(vals, idx, B, D, kl, k, out_v, out_i);
    return cudaGetLastError();
  }
  const size_t smem = (sizeof(unsigned long long) + sizeof(int)) * kWarps * (size_t)D;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(merge_wide, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  merge_wide<<<grid, kThreads, smem, st>>>(vals, idx, B, D, kl, k, out_v, out_i);
  return cudaGetLastError();
}

// Queries per block of the tree form and its shared memory: about
// kThreads runs of kMergeRun outputs on the first level; 0 when one query's
// lists do not fit.
int tree_group(int D, int kl, int k, size_t* smem) {
  const int L = kl < k ? kl : k;
  int xw, yw;
  tree_words(D, L, k, &xw, &yw);
  const int64_t per_q = (int64_t)(xw + yw) * sizeof(unsigned long long);
  if (per_q > kSmemMax) return 0;
  const int64_t first = (int64_t)((D + 1) / 2) * (((int64_t)2 * L < k ? 2 * L : k) + kMergeRun - 1) /
                        kMergeRun;
  int64_t g = kThreads / first;
  g = g < 1 ? 1 : g > kMaxGroup ? kMaxGroup : g;
  while (g > 1 && g * per_q > kSmemMax) --g;
  *smem = (size_t)(g * per_q);
  return (int)g;
}

cudaError_t launch_tree(const float* vals, const int* idx, int B, int D, int kl, int k,
                        float* out_v, int* out_i, cudaStream_t st) {
  size_t smem = 0;
  const int G = tree_group(D, kl, k, &smem);
  if (G == 0) return cudaErrorInvalidValue;
  const int L = kl < k ? kl : k;
  const int vec4 = kl % 4 == 0 && L % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(vals) | reinterpret_cast<uintptr_t>(idx)) & 15) == 0;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(merge_tree, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  // all of L1 as shared memory, so that as many blocks as it holds share an SM
  err = cudaFuncSetAttribute(merge_tree, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  merge_tree<<<(unsigned)((B + G - 1) / G), kThreads, smem, st>>>(vals, idx, B, D, kl, k, G, vec4,
                                                                   out_v, out_i);
  return cudaGetLastError();
}

bool bad_args(int B, int D, int kl, int k) {
  return B < 0 || D < 1 || kl < 1 || k < 1 || (int64_t)k > (int64_t)D * kl;
}

}  // namespace

// 1 when D lists take the wide warp form.
extern "C" int sharded_topk_merge_wide(int D) { return D > 32 ? 1 : 0; }

// 1 when the tree form takes D lists of kl for the top k: one query's lists
// fit in a block's shared memory.
extern "C" int sharded_topk_merge_tree_fits(int D, int kl, int k) {
  size_t smem;
  return D >= 1 && kl >= 1 && k >= 1 && tree_group(D, kl, k, &smem) > 0 ? 1 : 0;
}

// The form the merge of D lists of kl for the top k takes: 0 the warp form,
// 1 the tree form (from k = kTreeMinK on for at most kTreeMaxD lists: the
// crossover measured on the H100, PERF.md).
extern "C" int sharded_topk_merge_form(int D, int kl, int k) {
  return k >= kTreeMinK && D <= kTreeMaxD && sharded_topk_merge_tree_fits(D, kl, k) ? 1 : 0;
}

// vals / idx: (B, D, kl) row-major; out_v / out_i: (B, k).  D >= 1,
// 1 <= k <= D * kl; the indices of one query are distinct.  form 0: the
// warp form, 1: the tree form (where it fits).
extern "C" int sharded_topk_merge_as(int form, const float* vals, const int* idx, int B, int D,
                                     int kl, int k, float* out_v, int* out_i, void* stream) {
  if (bad_args(B, D, kl, k) || (form != 0 && form != 1)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(form ? launch_tree(vals, idx, B, D, kl, k, out_v, out_i, st)
                    : launch_warp(vals, idx, B, D, kl, k, out_v, out_i, st));
}

// The merge in the form sharded_topk_merge_form chooses.
extern "C" int sharded_topk_merge(const float* vals, const int* idx, int B, int D, int kl, int k,
                                  float* out_v, int* out_i, void* stream) {
  if (bad_args(B, D, kl, k)) return (int)cudaErrorInvalidValue;
  return sharded_topk_merge_as(sharded_topk_merge_form(D, kl, k), vals, idx, B, D, kl, k, out_v,
                               out_i, stream);
}
