// K6: the IVF tile scorer.  For tile t: gather queries[qidx[t, s]] for its
// bq_cap query slots, score them against table rows [lo[t], lo[t] + ln[t]) of
// the cell-ordered table, and write each slot's kk best (score, lo[t] + column)
// pairs, sorted (score descending, ties to the smaller column).  Columns in
// [ln[t], l_cap) and slots with qmask 0 score -inf, as in the reference, so a
// slot with fewer than kk real columns is completed by (-inf, lo[t] + column)
// for the first masked columns, and a masked slot gets (-inf, lo[t] + j): the
// merge on the host (parallel/ann.py:_merge_host) drops every non-finite
// entry.  No table row past ln[t] is read, so the table needs no tail padding.
//
// Replaces buffalo_tpu/parallel/ann.py: _tiled_score (:54) (per tile
// jnp.take + dynamic_slice + jnp.dot + mask + lax.top_k under lax.scan).
//
// What bounds it on the card: 2 d FP32 operations per (live slot, real
// column) pair, against the tiles' distinct table rows and the queries read
// once; a tile holds at most 256 x 1024 pairs, but a probed cell often
// holds a few dozen rows (the brunch catalog's searches: ~17 real columns a
// slot in tiles of 256 x 512).  So the work is sized by live pairs, in two
// forms, each launched on its own list of tiles (the caller's split,
// ops/retrieval_kernels.py ivf_tile_classes):
//  * small (kk <= 32, a tile of at most ivf_small_rows(d) rows): a block
//    per tile stages the tile's rows once in shared memory (row stride
//    padded so that 8 lanes' float4 reads fall in distinct banks); each
//    warp takes kSlots live slots at a time, stages their query rows, and
//    scores 32 rows at a time with a lane per row (the scan's sums: from
//    0, one fmaf per feature in order, so the scores are the scan's bit for
//    bit), each slot's 32 keys sorted across the lanes and merged into its
//    list of 32 held one key a lane (topk_select.cuh's register flush); a
//    masked slot is written without any read;
//  * scan (every other tile): the block scan of topk_select.cuh (shared with
//    K5's FFMA form), one block per (tile, group of QB slots), the tile's
//    rows streamed through shared memory, the selection as in K5; rows past
//    256 floats the wide instantiation.
#include <math.h>

#include <type_traits>

#include "topk_select.cuh"

namespace {

using namespace topk;

// Writes slot (t, s)'s kk entries from its sorted list (key 0: none), the
// rule of the header for the columns without one.
__device__ __forceinline__ void write_slot(float* __restrict__ vals, int32_t* __restrict__ pos,
                                           int64_t o, int j, uint64_t key, bool live, int lo_t,
                                           int ln_t, int kk) {
  const int real = live ? min(kk, ln_t) : 0;  // entries with a real column
  float v;
  int col;
  if (j < real) {
    v = key_score(key);
    col = (int)key_index(key);
  } else {
    v = -INFINITY;
    col = (live ? ln_t : 0) + (j - real);
  }
  vals[o + j] = v;
  pos[o + j] = lo_t + col;
}

template <class C, bool kWide>
__global__ void __launch_bounds__(kThreads)
ivf_tile_topk_kernel(const float* __restrict__ queries, const float* __restrict__ table,
                     const int32_t* __restrict__ qidx, const uint8_t* __restrict__ qmask,
                     const int32_t* __restrict__ lo, const int32_t* __restrict__ ln,
                     const int32_t* __restrict__ tiles, int bq_cap, int d, int kk,
                     float* __restrict__ vals, int32_t* __restrict__ pos) {
  extern __shared__ __align__(16) char smem[];
  const Smem<C> sm(smem, kWide ? kDC : d);
  const int t = tiles[blockIdx.x], s0 = blockIdx.y * C::QB;
  for (int q = threadIdx.x; q < C::QB; q += kThreads) {
    const int64_t slot = (int64_t)t * bq_cap + s0 + q;
    sm.row[q] = (s0 + q < bq_cap && qmask[slot]) ? (int64_t)qidx[slot] : -1;
  }
  __syncthreads();
  const int lo_t = lo[t], ln_t = ln[t];
  // a block of masked slots only writes their padding
  if (__syncthreads_or(threadIdx.x < C::QB && sm.row[threadIdx.x] >= 0))
    scan_items<C, kWide>(sm, queries, false, d, table + (int64_t)lo_t * d, nullptr, ln_t, 0u,
                         kk);
  for (int e = threadIdx.x; e < C::QB * kk; e += kThreads) {
    const int q = e / kk, j = e % kk;
    if (s0 + q >= bq_cap) continue;
    write_slot(vals, pos, ((int64_t)t * bq_cap + s0 + q) * kk, j, sm.list[q * C::KP + j],
               sm.row[q] >= 0, lo_t, ln_t, kk);
  }
}

// ---- the small-tile form
namespace small {

constexpr int kSlots = 8;  // slots a warp scores at once

// Row stride of the staged rows and queries (floats): float4 rows with an
// odd number of float4s (8 lanes' 16-byte reads in distinct banks), float
// rows of an odd number of floats (32 lanes' reads in distinct banks).
__host__ __device__ constexpr int stride(int d, bool vec) {
  return vec ? ((d / 4) % 2 ? d : d + 4) : (d % 2 ? d : d + 1);
}

__host__ __device__ constexpr size_t bytes(int d, bool vec, int rows) {
  return sizeof(float) * (size_t)stride(d, vec) * (rows + kWarps * kSlots);
}

// The 32 lanes' keys in descending order across the lanes (bitonic).
__device__ __forceinline__ uint64_t sort_desc(uint64_t x, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
    const bool desc = (lane & size) == 0;
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const uint64_t y = __shfl_xor_sync(kFull, x, stride);
      x = (((lane & stride) == 0) == desc) ? (x > y ? x : y) : (x < y ? x : y);
    }
  }
  return x;
}

// The top 32 of two descending lists held a key a lane: max(list[i],
// keys[31 - i]) is bitonic, sorted by one more bitonic merge.
__device__ __forceinline__ uint64_t merge_desc(uint64_t list, uint64_t sorted, int lane) {
  const uint64_t b = __shfl_sync(kFull, sorted, 31 - lane);
  uint64_t z = list > b ? list : b;
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const uint64_t y = __shfl_xor_sync(kFull, z, stride);
    z = (lane & stride) == 0 ? (z > y ? z : y) : (z < y ? z : y);
  }
  return z;
}

__device__ __forceinline__ float fma_unit(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float fma_unit(float a, float b, float acc) { return fmaf(a, b, acc); }

// One block per tile of the list; rows_cap: the rows the staging holds
// (every tile of the list has at most that many).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
ivf_tile_topk_small(const float* __restrict__ queries, const float* __restrict__ table,
                    const int32_t* __restrict__ qidx, const uint8_t* __restrict__ qmask,
                    const int32_t* __restrict__ lo, const int32_t* __restrict__ ln,
                    const int32_t* __restrict__ tiles, int bq_cap, int d, int kk, int rows_cap,
                    float* __restrict__ vals, int32_t* __restrict__ pos) {
  using U = std::conditional_t<kVec, float4, float>;
  extern __shared__ __align__(16) char smem[];
  const int units = kVec ? d / 4 : d, su = stride(d, kVec) / (kVec ? 4 : 1);
  U* rows = reinterpret_cast<U*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  U* qs = rows + (size_t)su * (rows_cap + warp * kSlots);
  const int t = tiles[blockIdx.x], lo_t = lo[t], ln_t = ln[t];
  if (ln_t > rows_cap) __trap();  // the caller's split put a larger tile here
  const U* tab = reinterpret_cast<const U*>(table) + (int64_t)lo_t * units;
  const U* qry = reinterpret_cast<const U*>(queries);
  for (int e = threadIdx.x; e < ln_t * units; e += kThreads) {
    const int r = e / units, u = e - r * units;
    rows[r * su + u] = __ldg(tab + e);
  }
  __syncthreads();
  for (int s0 = warp * kSlots; s0 < bq_cap; s0 += kWarps * kSlots) {
    const int64_t base = (int64_t)t * bq_cap;
    const int s = s0 + lane;
    const bool mine = lane < kSlots && s < bq_cap && qmask[base + s];
    const int qr = mine ? qidx[base + s] : 0;
    const unsigned live = __ballot_sync(kFull, mine);
    uint64_t list[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) list[j] = 0ull;
    if (live && ln_t > 0) {
      for (int j = 0; j < kSlots; ++j) {
        const int r = __shfl_sync(kFull, qr, j);
        if (live >> j & 1u)
          for (int u = lane; u < units; u += 32)
            qs[j * su + u] = __ldg(qry + (int64_t)r * units + u);
      }
      __syncwarp();
      for (int c0 = 0; c0 < ln_t; c0 += 32) {
        const int c = c0 + lane;
        const U* rr = rows + (size_t)(c < ln_t ? c : 0) * su;
        float acc[kSlots];
#pragma unroll
        for (int j = 0; j < kSlots; ++j) acc[j] = 0.f;
#pragma unroll 4
        for (int u = 0; u < units; ++u) {
          const U x = rr[u];
#pragma unroll
          for (int j = 0; j < kSlots; ++j) acc[j] = fma_unit(qs[j * su + u], x, acc[j]);
        }
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
          if (!(live >> j & 1u)) continue;  // warp-uniform
          const uint64_t key = c < ln_t ? make_key(acc[j], (uint32_t)c) : 0ull;
          const uint64_t thr = __shfl_sync(kFull, list[j], kk - 1);
          if (!__any_sync(kFull, key > thr)) continue;
          list[j] = merge_desc(list[j], sort_desc(key, lane), lane);
        }
      }
      __syncwarp();  // the staged queries are read
    }
#pragma unroll
    for (int j = 0; j < kSlots; ++j)
      if (s0 + j < bq_cap && lane < kk)
        write_slot(vals, pos, (base + s0 + j) * kk, lane, list[j], live >> j & 1u, lo_t, ln_t,
                   kk);
  }
}

}  // namespace small

bool aligned(const void* a) { return (uintptr_t)a % 16 == 0; }

}  // namespace

// Rows a tile may have for the small form at width d and kk (0: it takes
// none): at most max_rows, fewer where its staging passes shared memory.
extern "C" int ivf_small_rows(int d, int kk, int max_rows) {
  if (d < 1 || kk < 1 || kk > 32 || max_rows < 1) return 0;
  // the wider of the two strides (float rows where a table is not aligned)
  const bool vec = d % 4 == 0 && small::stride(d, true) > small::stride(d, false);
  const size_t q = small::bytes(d, vec, 0);
  const size_t row = small::bytes(d, vec, 1) - q;
  if (q + row > kMaxSmem) return 0;
  const size_t fit = (kMaxSmem - q) / row;
  return (int)(fit < (size_t)max_rows ? fit : max_rows);
}

// form 0: the scan over the n_tiles tiles of `tiles`; form 1: the small
// form, every listed tile of at most rows_cap rows (ivf_small_rows).
extern "C" int ivf_tile_topk(const float* queries, const float* table, const int32_t* qidx,
                             const uint8_t* qmask, const int32_t* lo, const int32_t* ln, int T,
                             int bq_cap, int d, int kk, int form, const int32_t* tiles,
                             int n_tiles, int rows_cap, float* vals, int32_t* pos,
                             void* stream) {
  if (T == 0 || bq_cap == 0 || n_tiles == 0) return 0;
  if (kk < 1 || d < 1 || n_tiles < 0 || n_tiles > T || !tiles) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (form == 1) {
    if (rows_cap < 1 || rows_cap > ivf_small_rows(d, kk, rows_cap))
      return (int)cudaErrorInvalidValue;
    const bool vec = d % 4 == 0 && aligned(queries) && aligned(table);
    const size_t bytes = small::bytes(d, vec, rows_cap);
    auto kernel = vec ? small::ivf_tile_topk_small<true> : small::ivf_tile_topk_small<false>;
    cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<n_tiles, kThreads, bytes, st>>>(queries, table, qidx, qmask, lo, ln, tiles, bq_cap,
                                             d, kk, rows_cap, vals, pos);
    return (int)cudaGetLastError();
  }
  if (form != 0) return (int)cudaErrorInvalidValue;
  return with_list(kk, [&](auto cfg) {
    using C = decltype(cfg);
    const bool wide = d > kMaxStagedD;
    const size_t bytes = Smem<C>::bytes(wide ? kDC : d);
    if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
    auto kernel = wide ? ivf_tile_topk_kernel<C, true> : ivf_tile_topk_kernel<C, false>;
    cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(n_tiles, (bq_cap + C::QB - 1) / C::QB), kThreads, bytes, st>>>(
        queries, table, qidx, qmask, lo, ln, tiles, bq_cap, d, kk, vals, pos);
    return (int)cudaGetLastError();
  });
}
