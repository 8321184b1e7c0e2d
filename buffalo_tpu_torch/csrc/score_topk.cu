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
// What bounds it on the card: 2 B N d operations (1.01 TFLOP for 10,000
// queries over the 505,840 x 100 KakaoBrunch catalog: 15 ms at the 67
// TFLOP/s of FP32, 6.1 ms as 3xTF32 at 495 TFLOP/s) against B d + N d + N
// floats read (0.2 GB, 0.06 ms): the operations.  Two forms, chosen by the
// caller (ops/retrieval_kernels.py score_topk_form):
//  * tensor cores (k <= 32, d <= 256): a block of 4 warps holds 64 queries
//    in shared memory and streams its part of Q in tiles of 64 items, 16
//    features at a time, through a 3-stage cp.async ring (d zero-padded to a
//    multiple of 8 by the copies' zero fill), so the next chunk's copy
//    overlaps this one's products.  Warp w owns queries 16 w .. 16 w + 15
//    and scores them against the whole tile with mma.sync m16n8k8 TF32 in
//    the 3xTF32 split (mma_tf32.cuh): q_small b_big + q_big b_small +
//    q_big b_big, each 16-feature chunk summed from zero on the tensor
//    cores and added to the float32 accumulators (a bfloat16 query is
//    exact in TF32, so its q_small term is absent); the item's bias is
//    added to the accumulator.  Scores are float32 sums in another order
//    than the FFMA form's, as close to the exact sum as a float32 sum.
//    The warp selects from its accumulator fragments: each lane compares
//    its scores with its two queries' thresholds (registers; a score above
//    it can only come from a later item, so a tie loses), and only those
//    above go to the query's candidate buffer, 32 items at a time so that
//    a buffer flushed before it overflows always has room (topk_select.cuh's
//    flush, in registers at this list length); the score tile is never
//    written to shared memory.  Keys are distinct, so the top k
//    does not depend on the order of the appends.
//  * FFMA (topk_select.cuh scan_items, K6's scan): every other k and width.
// The item axis is split S ways (grid.y, chosen by the caller so that the
// blocks fill the card's resident blocks in whole waves); a second launch
// merges the S partial lists per query, the concat + top_k of
// _chunked_topn_tiled.
#include "mma_tf32.cuh"
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

// ---- the tensor-core form
namespace tc {

constexpr int KP = 32;                    // list length: k <= 32
constexpr int kWarpsTC = 4, kThreadsTC = 32 * kWarpsTC;
constexpr int QB = 16 * kWarpsTC;          // queries per block, 16 per warp
constexpr int IT = 64;                     // items per tile: 8 n-tiles of 8
constexpr int KC = 16;                     // features per staged chunk
constexpr int STAGES = 3;
constexpr int ILD = KC + 4;                // staged item row (floats)
constexpr int kMaxD = 256;

// d zero-padded to the k-steps; the queries' row (dpad + 4: lanes (g, t)
// read g ld + t in 32 distinct banks, ld / 4 odd; likewise the staged items'
// row, ILD)
__host__ __device__ constexpr int dpad(int d) { return (d + 7) / 8 * 8; }
__host__ __device__ constexpr int qld(int d) { return dpad(d) + 4; }

struct Smem {
  uint64_t* list;  // [QB][KP] sorted best entries per query
  uint64_t* buf;   // [QB][KP] candidates not yet merged
  int* cnt;        // [QB] candidates in buf
  float* qs;       // [QB][qld] the queries, zero past d and past B
  float* items;    // [STAGES][IT][ILD] the ring

  __host__ __device__ static constexpr size_t bytes(int d) {
    return sizeof(uint64_t) * 2 * QB * KP + sizeof(int) * QB +
           sizeof(float) * ((size_t)QB * qld(d) + (size_t)STAGES * IT * ILD);
  }

  __device__ explicit Smem(char* base, int d) {
    list = reinterpret_cast<uint64_t*>(base);
    buf = list + QB * KP;
    cnt = reinterpret_cast<int*>(buf + QB * KP);
    qs = reinterpret_cast<float*>(cnt + QB);
    items = qs + (size_t)QB * qld(d);
  }
};

// Bit 2 nl + e: item (4 h + nl) 8 + 2 t + e of the tile (one of the lane's
// in half h) scores above thr for query row r of the lane (acc[.][2 r + e]).
__device__ __forceinline__ unsigned above(const float (&acc)[8][4], int h, int r, float thr,
                                          bool live, int t, int nv) {
  unsigned m = 0u;
#pragma unroll
  for (int nl = 0; nl < 4; ++nl)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = (4 * h + nl) * 8 + 2 * t + e;
      if (live && i < nv && !(acc[4 * h + nl][2 * r + e] <= thr)) m |= 1u << (2 * nl + e);
    }
  return m;
}

// The quad's (the 4 lanes of one query row) candidates: this lane's count c,
// its inclusive prefix incl and the quad's total.
__device__ __forceinline__ void quad_ranks(unsigned m, int t, int& c, int& incl, int& tot) {
  c = __popc(m);
  incl = c;
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o, 4);
    if (t >= o) incl += v;
  }
  tot = __shfl_sync(kFull, incl, 3, 4);
}

// The threshold of a query from its list: the k-th key's score, or NaN
// while the list holds fewer than k entries (!(s <= NaN) takes every s).
__device__ __forceinline__ float threshold_of(const uint64_t* list, int k) {
  const uint64_t key = list[k - 1];
  return key ? key_score(key) : __int_as_float(0x7fffffff);
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreadsTC)
score_topk_tc_kernel(const void* __restrict__ p, const float* __restrict__ Q,
                     const float* __restrict__ Qb, int B, int N, int d, int k, int per_split,
                     bool vec, uint64_t* __restrict__ part, float* __restrict__ vals,
                     int32_t* __restrict__ idx) {
  extern __shared__ __align__(16) char smem[];
  const Smem sm(smem, d);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * QB, s = blockIdx.y;
  const int lo = s * per_split, n = max(0, min(per_split, N - lo));
  const int dp = dpad(d), ql = qld(d), nch = (dp + KC - 1) / KC;
  const int steps = (n + IT - 1) / IT * nch;
  const float* items = Q + (int64_t)lo * d;

  for (int e = tid; e < QB * dp; e += kThreadsTC) {
    const int q = e / dp, c = e - q * dp;
    float v = 0.f;
    if (q0 + q < B && c < d) {
      const int64_t o = (int64_t)(q0 + q) * d + c;
      v = kBf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[o])
                : static_cast<const float*>(p)[o];
    }
    sm.qs[q * ql + c] = v;
  }
  for (int e = tid; e < QB * KP; e += kThreadsTC) sm.list[e] = 0;
  for (int q = tid; q < QB; q += kThreadsTC) sm.cnt[q] = 0;

  // step st: features [KC (st % nch), + KC) of tile st / nch into stage
  // st % STAGES, zero past d and past the split's items; always one group
  auto fetch = [&](int st) {
    if (st < steps) {
      const int tile = st / nch, c0 = (st % nch) * KC;
      const int nv = min(IT, n - tile * IT);
      float* dst = sm.items + (st % STAGES) * IT * ILD;
      const float* src = items + (int64_t)tile * IT * d;
      if (vec) {
        for (int e = tid; e < IT * (KC / 4); e += kThreadsTC) {
          const int i = e / (KC / 4), c = c0 + 4 * (e % (KC / 4));
          if (c >= dp) continue;
          const bool full = i < nv && c < d;
          cp_async16(dst + i * ILD + c - c0, full ? src + (int64_t)i * d + c : src, full);
        }
      } else {
        for (int e = tid; e < IT * KC; e += kThreadsTC) {
          const int i = e / KC, c = c0 + e % KC;
          if (c >= dp) continue;
          const bool full = i < nv && c < d;
          cp_async4(dst + i * ILD + c - c0, full ? src + (int64_t)i * d + c : src, full);
        }
      }
    }
    cp_async_commit();
  };

  const int qr0 = warp * 16 + g, qr1 = qr0 + 8;  // this lane's two queries
  const bool live0 = q0 + qr0 < B, live1 = q0 + qr1 < B;
  float thr0 = __int_as_float(0x7fffffff), thr1 = thr0;
  const float* a0p = sm.qs + qr0 * ql + t;
  const float* a1p = sm.qs + qr1 * ql + t;
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  __syncthreads();  // queries staged, lists cleared
  for (int st = 0; st < STAGES - 1; ++st) fetch(st);
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of step st landed
    __syncthreads();              // everyone's did; step st - 1 is consumed
    fetch(st + STAGES - 1);
    const int c0 = (st % nch) * KC, nks = min(KC, dp - c0) / 8;
    const float* it = sm.items + (st % STAGES) * IT * ILD + g * ILD + t;
    float sum[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KC / 8; ++ks) {
      if (ks < nks) {
        const int kg = c0 + ks * 8;
        const float x[4] = {a0p[kg], a1p[kg], a0p[kg + 4], a1p[kg + 4]};
        uint32_t ab[4], as[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (kBf16)
            ab[e] = __float_as_uint(x[e]);  // exact in TF32
          else
            split_tf32(x[e], ab[e], as[e]);
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float* b = it + nt * 8 * ILD + ks * 8;
          uint32_t bb[2], bs[2];
          split_tf32(b[0], bb[0], bs[0]);
          split_tf32(b[4], bb[1], bs[1]);
          if (!kBf16) mma_tf32(sum[nt], as, bb);
          mma_tf32(sum[nt], ab, bs);
          mma_tf32(sum[nt], ab, bb);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] += sum[nt][e];
    if (st % nch != nch - 1) continue;

    // the tile's scores are complete: lane (g, t) holds queries qr0 (e = 0,
    // 1) and qr1 (e = 2, 3) against items nt * 8 + 2 t + (e & 1)
    const int t0 = st / nch * IT, nv = min(IT, n - t0);
    if (Qb != nullptr) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = nt * 8 + 2 * t + e;
          const float bv = i < nv ? __ldg(Qb + lo + t0 + i) : 0.f;
          acc[nt][e] += bv;
          acc[nt][2 + e] += bv;
        }
    }
    // per half (32 items: at most 32 candidates a query) and query row, the
    // lane's items above the threshold
    unsigned m[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h][0] = above(acc, h, 0, thr0, live0, t, nv);
      m[h][1] = above(acc, h, 1, thr1, live1, t, nv);
    }
    if (__any_sync(kFull, (m[0][0] | m[0][1] | m[1][0] | m[1][1]) != 0u)) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qr = r ? qr1 : qr0;
          float& thr = r ? thr1 : thr0;
          int c, incl, tot;
          quad_ranks(m[h][r], t, c, incl, tot);
          int cur = sm.cnt[qr];
          // merge the buffers this half would overflow first (the keys
          // taken below the raised threshold are merged away later)
          unsigned over = __ballot_sync(kFull, t == 0 && cur + tot > KP);
          while (over) {
            const int l = __ffs(over) - 1;
            over &= over - 1;
            const int q = warp * 16 + (l >> 2) + 8 * r;
            flush<KP>(sm.list + q * KP, sm.buf + q * KP, sm.cnt[q]);
            __syncwarp();
            if (g == (l >> 2)) {
              thr = threshold_of(sm.list + q * KP, k);
              cur = 0;
            }
            if (lane == 0) sm.cnt[q] = 0;
            __syncwarp();
          }
          uint64_t* to = sm.buf + qr * KP + cur + incl - c;
          int j = 0;
#pragma unroll
          for (int nl = 0; nl < 4; ++nl)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (m[h][r] >> (2 * nl + e) & 1u)
                to[j++] = make_key(acc[4 * h + nl][2 * r + e],
                                   (uint32_t)(lo + t0 + (4 * h + nl) * 8 + 2 * t + e));
          __syncwarp();
          if (t == 0 && tot) sm.cnt[qr] = cur + tot;
          __syncwarp();
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  }
  cp_async_wait<0>();
  for (int qq = 0; qq < 16; ++qq) {
    const int q = warp * 16 + qq, c = sm.cnt[q];
    if (q0 + q < B && c > 0) flush<KP>(sm.list + q * KP, sm.buf + q * KP, c);
  }
  __syncthreads();
  for (int e = tid; e < QB * k; e += kThreadsTC) {
    const int q = e / k, j = e % k;
    if (q0 + q >= B) continue;
    const uint64_t key = sm.list[q * KP + j];
    const int64_t o = (int64_t)(q0 + q) * k + j;
    if (gridDim.y == 1) {
      vals[o] = key_score(key);
      idx[o] = (int32_t)key_index(key);
    } else {
      part[(int64_t)s * B * k + o] = key;
    }
  }
}

}  // namespace tc

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

// The S partial lists of each query into its top k (S > 1).
int merge_splits(const uint64_t* part, int S, int B, int k, float* vals, int32_t* idx,
                 cudaStream_t st) {
  int n = 1;
  while (n < S * k) n <<= 1;
  const size_t mbytes = sizeof(uint64_t) * n;
  if (mbytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(merge_splits_kernel, mbytes);
  if (err != cudaSuccess) return (int)err;
  merge_splits_kernel<<<B, kThreads, mbytes, st>>>(part, S, B, k, n, vals, idx);
  return (int)cudaGetLastError();
}

}  // namespace

// 1 when the tensor-core form takes k entries of rows of d floats.
extern "C" int score_topk_tc_takes(int k, int d) {
  return k >= 1 && k <= tc::KP && d >= 1 && d <= tc::kMaxD ? 1 : 0;
}

// Blocks of the tensor-core form resident on one SM at width d (0: it does
// not take d), from the occupancy calculator.
extern "C" int score_topk_tc_blocks(int d, int p_bf16) {
  if (!score_topk_tc_takes(1, d)) return 0;
  auto kernel = p_bf16 ? tc::score_topk_tc_kernel<true> : tc::score_topk_tc_kernel<false>;
  const size_t bytes = tc::Smem::bytes(d);
  if (allow_smem(kernel, bytes) != cudaSuccess) return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, tc::kThreadsTC, bytes) !=
      cudaSuccess)
    return 0;
  return n;
}

// form 1: the tensor-core form (score_topk_tc_takes), else FFMA; part: S * B
// * k keys of scratch when S > 1 (unused when S == 1).
extern "C" int score_topk(const void* p, int p_bf16, const float* Q, const float* Qb, int B,
                          int N, int d, int k, int S, int form, uint64_t* part, float* vals,
                          int32_t* idx, void* stream) {
  if (B == 0) return 0;
  if (k < 1 || k > N || d < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int per_split = (N + S - 1) / S;
  if (form == 1) {
    if (!score_topk_tc_takes(k, d)) return (int)cudaErrorInvalidValue;
    auto kernel = p_bf16 ? tc::score_topk_tc_kernel<true> : tc::score_topk_tc_kernel<false>;
    const size_t bytes = tc::Smem::bytes(d);
    cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return (int)err;
    const bool vec = d % 4 == 0 && (uintptr_t)Q % 16 == 0;
    kernel<<<dim3((B + tc::QB - 1) / tc::QB, S), tc::kThreadsTC, bytes, st>>>(
        p, Q, Qb, B, N, d, k, per_split, vec, part, vals, idx);
    err = cudaGetLastError();
    if (err != cudaSuccess || S == 1) return (int)err;
    return merge_splits(part, S, B, k, vals, idx, st);
  }
  return with_list(k, [&](auto cfg) {
    using C = decltype(cfg);
    const bool wide = d > kMaxStagedD;
    const size_t bytes = Smem<C>::bytes(wide ? kDC : d);
    if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
    auto kernel = wide ? score_topk_kernel<C, true> : score_topk_kernel<C, false>;
    cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3((B + C::QB - 1) / C::QB, S), kThreads, bytes, st>>>(
        p, p_bf16, Q, Qb, B, N, d, k, per_split, part, vals, idx);
    err = cudaGetLastError();
    if (err != cudaSuccess || S == 1) return (int)err;
    return merge_splits(part, S, B, k, vals, idx, st);
  });
}
