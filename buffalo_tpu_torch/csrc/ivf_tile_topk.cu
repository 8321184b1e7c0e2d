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
// once; a tile holds at most 256 x 1024 pairs.  Design: the block scan of
// topk_select.cuh (shared with K5), one block per (tile, group of QB slots),
// the tile's rows streamed through shared memory, the selection as in K5.
#include <math.h>

#include "topk_select.cuh"

namespace {

using namespace topk;

template <class C, bool kWide>
__global__ void __launch_bounds__(kThreads)
ivf_tile_topk_kernel(const float* __restrict__ queries, const float* __restrict__ table,
                     const int32_t* __restrict__ qidx, const uint8_t* __restrict__ qmask,
                     const int32_t* __restrict__ lo, const int32_t* __restrict__ ln,
                     int bq_cap, int d, int kk, float* __restrict__ vals,
                     int32_t* __restrict__ pos) {
  extern __shared__ __align__(16) char smem[];
  const Smem<C> sm(smem, kWide ? kDC : d);
  const int t = blockIdx.x, s0 = blockIdx.y * C::QB;
  for (int q = threadIdx.x; q < C::QB; q += kThreads) {
    const int64_t slot = (int64_t)t * bq_cap + s0 + q;
    sm.row[q] = (s0 + q < bq_cap && qmask[slot]) ? (int64_t)qidx[slot] : -1;
  }
  __syncthreads();
  const int lo_t = lo[t], ln_t = ln[t];
  scan_items<C, kWide>(sm, queries, false, d, table + (int64_t)lo_t * d, nullptr, ln_t, 0u, kk);
  for (int e = threadIdx.x; e < C::QB * kk; e += kThreads) {
    const int q = e / kk, j = e % kk;
    if (s0 + q >= bq_cap) continue;
    const bool live = sm.row[q] >= 0;
    const int real = live ? min(kk, ln_t) : 0;  // entries with a real column
    float v;
    int col;
    if (j < real) {
      const uint64_t key = sm.list[q * C::KP + j];
      v = key_score(key);
      col = (int)key_index(key);
    } else {
      v = -INFINITY;
      col = (live ? ln_t : 0) + (j - real);
    }
    const int64_t o = ((int64_t)t * bq_cap + s0 + q) * kk + j;
    vals[o] = v;
    pos[o] = lo_t + col;
  }
}

}  // namespace

extern "C" int ivf_tile_topk(const float* queries, const float* table, const int32_t* qidx,
                             const uint8_t* qmask, const int32_t* lo, const int32_t* ln, int T,
                             int bq_cap, int d, int kk, float* vals, int32_t* pos,
                             void* stream) {
  if (T == 0 || bq_cap == 0) return 0;
  if (kk < 1 || d < 1) return (int)cudaErrorInvalidValue;
  return with_list(kk, [&](auto cfg) {
    using C = decltype(cfg);
    const bool wide = d > kMaxStagedD;
    const size_t bytes = Smem<C>::bytes(wide ? kDC : d);
    if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
    auto kernel = wide ? ivf_tile_topk_kernel<C, true> : ivf_tile_topk_kernel<C, false>;
    cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(T, (bq_cap + C::QB - 1) / C::QB), kThreads, bytes, (cudaStream_t)stream>>>(
        queries, table, qidx, qmask, lo, ln, bq_cap, d, kk, vals, pos);
    return (int)cudaGetLastError();
  });
}
