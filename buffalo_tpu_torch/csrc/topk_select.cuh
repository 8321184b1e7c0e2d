// Scoring and top-k selection shared by K5's FFMA form (score_topk.cu, which
// also has a tensor-core form of its own) and K6 (ivf_tile_topk.cu), and
// the keys, merges and flush that K5's tensor-core form selects with: a
// block holds a tile of QB queries, streams a range of
// item rows through shared memory in tiles of IT, scores each (query, item)
// pair with FFMA and keeps, per query, a sorted list of its best KP entries.
//
// Order.  An entry is a 64-bit key: the score's bits mapped so that a larger
// float is a larger unsigned number, then the item index reversed, so a larger
// key is a better entry and ties in score go to the smaller index, which is
// what lax.top_k and jnp.argmax do.  Key 0 is an empty slot, below every real
// entry; -inf is a real score and is kept like any other.
//
// Scores.  Each score is a float32 sum over d in ascending order, starting at
// 0 (one fmaf per feature), plus the item's bias if there is one.
//
// Selection.  Warp w owns queries w, w + 8, ...: per item tile its lanes walk
// the tile's scores 32 at a time and append the entries that beat the
// query's threshold (the key of its k-th entry so far) to a candidate buffer
// of KP keys, at ranks from a ballot, so in item order.  When the buffer
// would overflow, or the scan ends, the warp sorts the buffer (bitonic, in
// registers at KP = 32, else in shared memory) and merges it into the list:
// the top KP of two sorted lists of KP are max(list[i], buf[KP - 1 - i]), a
// bitonic sequence, sorted by one more bitonic merge.  The threshold then
// rises to the list's k-th key.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace topk {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kDC = 32;  // features per shared-memory chunk of an item tile
constexpr size_t kMaxSmem = 227 * 1024;

// Block shapes per list length KP (a power of two >= k): the lists take 16 KP
// bytes per query, so queries per block shrink as KP grows.  Thread (tq, ti)
// scores queries TQ tq .. TQ tq + TQ - 1 against items 4 ti .. 4 ti + 3 and
// IT / 2 + 4 ti .. + 3 of each tile: (IT / 8) x (QB / TQ) = 256 threads.
template <int KP_>
struct Cfg;
template <>
struct Cfg<32> {
  static constexpr int KP = 32, QB = 64, IT = 128, TQ = 4;
};
template <>
struct Cfg<128> {
  static constexpr int KP = 128, QB = 32, IT = 128, TQ = 2;
};
template <>
struct Cfg<1024> {
  static constexpr int KP = 1024, QB = 8, IT = 256, TQ = 1;
};

// Calls f(Cfg<KP>{}) with the smallest list length that holds k (k <= 1024).
template <typename F>
inline int with_list(int k, F&& f) {
  if (k <= 32) return f(Cfg<32>{});
  if (k <= 128) return f(Cfg<128>{});
  if (k <= 1024) return f(Cfg<1024>{});
  return (int)cudaErrorInvalidValue;
}

__device__ __forceinline__ uint64_t make_key(float s, uint32_t idx) {
  const uint32_t b = __float_as_uint(s);
  const uint32_t o = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((uint64_t)o << 32) | (uint64_t)(0xffffffffu - idx);
}

__device__ __forceinline__ float key_score(uint64_t key) {
  const uint32_t o = (uint32_t)(key >> 32);
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ uint32_t key_index(uint64_t key) {
  return 0xffffffffu - (uint32_t)key;
}

// Bitonic sort of n keys (a power of two) into descending order by the
// threads [0, nthreads) of the caller's group; `sync` orders the stages.
template <typename Sync>
__device__ __forceinline__ void bitonic_sort_desc(uint64_t* a, int n, int t, int nthreads,
                                                  Sync&& sync) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = t; i < n / 2; i += nthreads) {
        const int lo = 2 * stride * (i / stride) + (i % stride), hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const uint64_t x = a[lo], y = a[hi];
        if ((x < y) == desc) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      sync();
    }
  }
}

// A bitonic sequence of n keys into descending order (one warp).
__device__ __forceinline__ void warp_bitonic_merge_desc(uint64_t* a, int n) {
  const int lane = threadIdx.x & 31;
  for (int stride = n >> 1; stride > 0; stride >>= 1) {
    for (int i = lane; i < n / 2; i += 32) {
      const int lo = 2 * stride * (i / stride) + (i % stride), hi = lo + stride;
      const uint64_t x = a[lo], y = a[hi];
      if (x < y) {
        a[lo] = y;
        a[hi] = x;
      }
    }
    __syncwarp();
  }
}

// Merge the first cnt keys of buf into the sorted list (one warp).  At KP
// = 32 in registers: lane i takes the buffer's i-th key (0 past cnt), a
// bitonic sort across the lanes puts them in descending order, and
// max(list[i], buf[31 - i]), a bitonic sequence, is sorted by one more
// bitonic merge; longer lists sort the buffer in shared memory.
template <int KP>
__device__ __forceinline__ void flush(uint64_t* list, uint64_t* buf, int cnt) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  if constexpr (KP == 32) {
    uint64_t x = lane < cnt ? buf[lane] : 0ull;
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
      const bool desc = (lane & size) == 0;
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const uint64_t y = __shfl_xor_sync(kFull, x, stride);
        x = (((lane & stride) == 0) == desc) ? (x > y ? x : y) : (x < y ? x : y);
      }
    }
    const uint64_t a = list[lane], b = __shfl_sync(kFull, x, 31 - lane);
    uint64_t z = a > b ? a : b;
#pragma unroll
    for (int stride = 16; stride > 0; stride >>= 1) {
      const uint64_t y = __shfl_xor_sync(kFull, z, stride);
      z = (lane & stride) == 0 ? (z > y ? z : y) : (z < y ? z : y);
    }
    list[lane] = z;
    __syncwarp();
  } else {
    for (int i = cnt + lane; i < KP; i += 32) buf[i] = 0;
    __syncwarp();
    bitonic_sort_desc(buf, KP, lane, 32, [] { __syncwarp(); });
    for (int i = lane; i < KP; i += 32) {
      const uint64_t a = list[i], b = buf[KP - 1 - i];
      list[i] = a > b ? a : b;
    }
    __syncwarp();
    warp_bitonic_merge_desc(list, KP);
  }
}

// The block's shared memory, carved from one dynamic allocation.
template <class C>
struct Smem {
  uint64_t* list;  // [QB][KP] sorted best entries per query
  uint64_t* buf;   // [QB][KP] candidates not yet merged
  uint64_t* thr;   // [QB] key of the k-th entry so far (0: fewer than k)
  int64_t* row;    // [QB] query row of each slot, -1 for an empty slot
  float* S;        // [QB][IT] the tile's scores
  float* QT;       // [kDC][IT + 4] a chunk of the item tile, transposed
  float* pT;       // [d][QB] the queries, transposed
  int* cnt;        // [QB] candidates in buf

  static constexpr int QTLD = C::IT + 4;

  __host__ __device__ static constexpr size_t bytes(int d) {
    return sizeof(uint64_t) * (2 * C::QB * C::KP + C::QB) + sizeof(int64_t) * C::QB +
           sizeof(float) * ((size_t)C::QB * C::IT + (size_t)kDC * QTLD + (size_t)d * C::QB) +
           sizeof(int) * C::QB;
  }

  __device__ explicit Smem(char* base, int d) {
    list = reinterpret_cast<uint64_t*>(base);
    buf = list + C::QB * C::KP;
    thr = buf + C::QB * C::KP;
    row = reinterpret_cast<int64_t*>(thr + C::QB);
    S = reinterpret_cast<float*>(row + C::QB);
    QT = S + C::QB * C::IT;
    pT = QT + kDC * QTLD;
    cnt = reinterpret_cast<int*>(pT + (size_t)d * C::QB);
  }
};

// Scan items [0, n_items) of `items` (rows of d floats) for the queries of
// sm.row (set, and the block synchronised, by the caller): entry index of
// item c is idx0 + c, its score the dot product plus bias[c] when `bias` is
// given.  On return (after a block barrier) sm.list[q * KP ...] holds query
// q's best entries in descending key order, 0-padded; empty slots are left
// untouched.  Reads no item row past n_items.
// Rows past kMaxStagedD floats take the wide instantiation: the queries'
// features are staged kDC at a time beside the item tile's chunk (sm built
// for kDC features), in the same order, so the scores are the same sums.
constexpr int kMaxStagedD = 256;

template <class C, bool kWide = false>
__device__ void scan_items(const Smem<C>& sm, const void* queries, bool q_bf16, int d,
                           const float* __restrict__ items, const float* __restrict__ bias,
                           int n_items, uint32_t idx0, int k) {
  constexpr int QB = C::QB, IT = C::IT, TQ = C::TQ, KP = C::KP;
  constexpr int IG = IT / 8, QTLD = Smem<C>::QTLD;
  static_assert(IG * (QB / TQ) == kThreads, "one thread per (query group, item group)");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ti = tid % IG, tq = tid / IG;

  for (int e = tid; e < QB * KP; e += kThreads) sm.list[e] = 0;
  for (int q = tid; q < QB; q += kThreads) {
    sm.thr[q] = 0;
    sm.cnt[q] = 0;
  }
  // the queries' features [j0, j0 + n) into rows [j0 - base, ..) of pT
  auto stage_queries = [&](int j0, int n, int base) {
    for (int e = tid; e < QB * n; e += kThreads) {
      const int q = e / n, j = j0 + e % n;
      const int64_t r = sm.row[q];
      float v = 0.f;
      if (r >= 0)
        v = q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(queries)[r * d + j])
                   : static_cast<const float*>(queries)[r * d + j];
      sm.pT[(j - base) * QB + q] = v;
    }
  };
  if (!kWide) stage_queries(0, d, 0);

  for (int t0 = 0; t0 < n_items; t0 += IT) {
    const int nv = min(IT, n_items - t0);
    float acc[TQ][8];
#pragma unroll
    for (int a = 0; a < TQ; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;

    for (int j0 = 0; j0 < d; j0 += kDC) {
      const int jn = min(kDC, d - j0);
      __syncthreads();  // the previous chunk (or tile's selection) is done
      for (int e = tid; e < IT * kDC; e += kThreads) {
        const int i = e / kDC, jj = e % kDC;
        sm.QT[jj * QTLD + i] =
            (i < nv && jj < jn) ? __ldg(items + (int64_t)(t0 + i) * d + j0 + jj) : 0.f;
      }
      if (kWide) stage_queries(j0, jn, j0);
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < jn; ++jj) {
        const float* pr = sm.pT + (kWide ? jj : j0 + jj) * QB + tq * TQ;
        float a[TQ];
        if constexpr (TQ == 4) {
          const float4 v = *reinterpret_cast<const float4*>(pr);
          a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w;
        } else if constexpr (TQ == 2) {
          const float2 v = *reinterpret_cast<const float2*>(pr);
          a[0] = v.x, a[1] = v.y;
        } else {
          a[0] = pr[0];
        }
        const float* qr = sm.QT + jj * QTLD + 4 * ti;
        const float4 b0 = *reinterpret_cast<const float4*>(qr);
        const float4 b1 = *reinterpret_cast<const float4*>(qr + IT / 2);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int x = 0; x < TQ; ++x)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[x][c] = fmaf(a[x], b[c], acc[x][c]);
      }
    }
#pragma unroll
    for (int x = 0; x < TQ; ++x)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int i = (c < 4 ? 4 * ti + c : IT / 2 + 4 * ti + c - 4);
        float s = acc[x][c];
        if (bias != nullptr && i < nv) s += __ldg(bias + t0 + i);
        sm.S[(tq * TQ + x) * IT + i] = s;
      }
    __syncthreads();

    for (int q = warp; q < QB; q += kWarps) {
      if (sm.row[q] < 0) continue;
      uint64_t thr = sm.thr[q];
      int cnt = sm.cnt[q];
      uint64_t* list = sm.list + q * KP;
      uint64_t* buf = sm.buf + q * KP;
      for (int base = 0; base < nv; base += 32) {
        const int i = base + lane;
        const uint64_t key = i < nv ? make_key(sm.S[q * IT + i], idx0 + t0 + i) : 0ull;
        unsigned m = __ballot_sync(kFull, key > thr);
        if (m == 0) continue;
        if (cnt + __popc(m) > KP) {
          flush<KP>(list, buf, cnt);
          thr = list[k - 1];
          cnt = 0;
          m = __ballot_sync(kFull, key > thr);
          if (m == 0) continue;
        }
        if (key > thr) buf[cnt + __popc(m & ((1u << lane) - 1u))] = key;
        cnt += __popc(m);
      }
      __syncwarp();
      if (lane == 0) {
        sm.thr[q] = thr;
        sm.cnt[q] = cnt;
      }
    }
  }
  __syncthreads();
  for (int q = warp; q < QB; q += kWarps) {
    const int cnt = sm.cnt[q];
    if (sm.row[q] >= 0 && cnt > 0) flush<KP>(sm.list + q * KP, sm.buf + q * KP, cnt);
  }
  __syncthreads();
}

// Opt in to more than 48 KB of dynamic shared memory when a launch needs it.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace topk
