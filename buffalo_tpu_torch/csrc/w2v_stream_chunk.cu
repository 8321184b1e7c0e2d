// K21: the skip-gram deltas of one token chunk, expanded on the card.
// Position p of the chunk holds word w[p] (V = padding), sentence id s[p] and
// shrunken half-window h[p]; block b = p / blk of the positions shares the K
// negatives negs[b]; l0 / l1 are rows of L0 / L1, ln[b][k] = L1[negs[b][k]].
// For every offset o = 1..W and position i with j = i + o < T in the same
// sentence, both words real:
//  * direction A (centre i, context j) when o <= h[i]: the positive
//    g_a = g(1, l0[j] . l1[i]) adds g_a l0[j] to dL1p[i] and g_a l1[i] to
//    dL0p[j]; each negative k of block(i) other than w[i] adds
//    g(0, l0[j] . ln) l0[j] to dLn[b][k] and g(0, .) ln to dL0p[j];
//  * direction B (centre j, context i) when o <= h[j]: g_b = g(1, l0[i] .
//    l1[j]) adds g_b l1[j] to dL0p[i] and g_b l0[i] to dL1p[j]; each
//    negative of block(i) other than w[j] adds g(0, l0[i] . ln) l0[i] to
//    dLn[b][k] and g(0, .) ln to dL0p[i];
// with g(label, f) = label - sigmoid(f), 1 - label above +6 and label below
// -6.  Pairs that would cross the chunk's end are dropped.  The loss (the
// SGNS log terms, 1e-10 inside the logs) and the count of (pair, direction)
// terms are summed per block of positions and the blocks' partials in block
// order, with no float atomics.  The tables are only read; K20
// (csrc/w2v_row_apply.cu) adds the deltas, scaled by the rate.
//
// Replaces buffalo_tpu/ops/w2v_kernels.py _stream_chunk_deltas (:236) and the
// delta half of w2v_epoch_stream's scan body (:200-219).
//
// What bounds it on the card: each position's two rows and each negative
// block's K rows read once, and the (2 T + NB K) d floats written; at the
// brunch chunk (T = 131,072, d = 32, K = 5, block 4) ~70 MB, ~20 us of HBM.
// The work: 2 d (3 + 3 K) operations per (pair, direction) term, ~0.9
// GFLOP per brunch chunk (740k terms), ~13 us at the FP32 rate.  Design: a
// block owns a tile of 32 positions (rounded to a multiple of the negative
// block) and reads the rows of the tile, of the W positions on each side
// and of their negatives from L0 / L1 (the halo's rows are shared with the
// neighbouring tiles through L1 and L2).  Its warps take one output row
// each, lanes on the columns: a position's dL0p and dL1p row, gathering
// what lands there from the halo (so no two blocks write one row), or a
// negative's dLn row.  A pair's dot products are recomputed by each row
// they feed rather than stored.
#include <cuda_runtime.h>
#include <stdint.h>

#include "w2v_common.cuh"

namespace {

// positions per block (rounded to a multiple of blk): 32-position tiles ran
// faster than 128-position ones despite their wider halos (PERF.md, K21)
constexpr int kTile = 32;

struct Chunk {
  const float* __restrict__ L0;
  const float* __restrict__ L1;
  const int32_t* __restrict__ w;
  const int32_t* __restrict__ s;
  const uint8_t* __restrict__ h;
  const int32_t* __restrict__ negs;
  int T, V, d, K, W, blk;
};

template <int H>
__global__ void __launch_bounds__(kThreads)
chunk_deltas(Chunk c, int tile, int compute_loss, float* __restrict__ dL0p,
             float* __restrict__ dL1p, float* __restrict__ dLn, float* __restrict__ part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = c.d, K = c.K, W = c.W, blk = c.blk;
  const int p0 = blockIdx.x * tile, p1 = min(c.T, p0 + tile);
  auto valid = [&](int p) { return p >= 0 && p < c.T && c.w[p] < c.V; };
  auto r0 = [&](int p) { return c.L0 + (int64_t)c.w[p] * d; };
  auto r1 = [&](int p) { return c.L1 + (int64_t)c.w[p] * d; };
  auto rn = [&](int b, int k) { return c.L1 + (int64_t)c.negs[(int64_t)b * K + k] * d; };

  float loss = 0.f, cnt = 0.f;
  const int npos = p1 - p0, nneg = (npos / blk) * K;
  for (int it = warp; it < npos + nneg; it += kWarps) {
    float x[H], y[H], z[H];
    if (it < npos) {
      // ---- position p: its dL0p and dL1p rows
      const int p = p0 + it;
      float a0[H], a1[H];
#pragma unroll
      for (int h = 0; h < H; ++h) a0[h] = a1[h] = 0.f;
      if (valid(p)) {
        const int sp = c.s[p], hp = c.h[p], bp = p / blk;
        float l0p[H], l1p[H];
        load_row<H>(r0(p), d, lane, l0p);
        load_row<H>(r1(p), d, lane, l1p);
        // l0[p] . ln[bp][k] for k < 32, lane k holding k's
        float fnb = 0.f;
        for (int k = 0; k < K && k < 32; ++k) {
          load_row<H>(rn(bp, k), d, lane, z);
          const float f = dot<H>(l0p, z);
          if (lane == k) fnb = f;
        }
        for (int o = 1; o <= W; ++o) {
          // the pair (p, p + o): A's positive to dL1p[p], B's terms to dL0p[p]
          const int j = p + o;
          if (j < c.T && c.w[j] < c.V && c.s[j] == sp) {
            const int wj = c.w[j], hj = c.h[j];
            if (o <= hp) {
              load_row<H>(r0(j), d, lane, x);
              const float f = dot<H>(x, l1p);
              axpy<H>(g_of(1.f, f), x, a1);
              if (compute_loss) loss -= logf(sigm(f) + kEps);
              cnt += 1.f;
            }
            if (o <= hj) {
              load_row<H>(r1(j), d, lane, y);
              const float f = dot<H>(l0p, y);
              axpy<H>(g_of(1.f, f), y, a0);
              if (compute_loss) loss -= logf(sigm(f) + kEps);
              cnt += 1.f;
              for (int k = 0; k < K; ++k) {
                if (c.negs[(int64_t)bp * K + k] == wj) continue;
                load_row<H>(rn(bp, k), d, lane, z);
                const float fk = k < 32 ? __shfl_sync(kFull, fnb, k) : dot<H>(l0p, z);
                axpy<H>(g_of(0.f, fk), z, a0);
                if (compute_loss) loss -= logf(1.f - sigm(fk) + kEps);
              }
            }
          }
          // the pair (p - o, p): what lands on p
          const int i = p - o;
          if (i >= 0 && c.w[i] < c.V && c.s[i] == sp) {
            const int wi = c.w[i], hi = c.h[i], bi = i / blk;
            if (o <= hi) {
              load_row<H>(r1(i), d, lane, y);
              axpy<H>(g_of(1.f, dot<H>(l0p, y)), y, a0);
              for (int k = 0; k < K; ++k) {
                if (c.negs[(int64_t)bi * K + k] == wi) continue;
                load_row<H>(rn(bi, k), d, lane, z);
                const float fk = dot<H>(l0p, z);
                axpy<H>(g_of(0.f, fk), z, a0);
                if (compute_loss) loss -= logf(1.f - sigm(fk) + kEps);
              }
            }
            if (o <= hp) {
              load_row<H>(r0(i), d, lane, x);
              axpy<H>(g_of(1.f, dot<H>(x, l1p)), x, a1);
            }
          }
        }
      }
      store_row<H>(dL0p + (int64_t)p * d, d, lane, 1.f, a0);
      store_row<H>(dL1p + (int64_t)p * d, d, lane, 1.f, a1);
    } else {
      // ---- negative k of block b: its dLn row
      const int q = it - npos;
      const int b = p0 / blk + q / K, k = q % K;
      const int n = c.negs[(int64_t)b * K + k];
      float acc[H];
#pragma unroll
      for (int h = 0; h < H; ++h) acc[h] = 0.f;
      load_row<H>(rn(b, k), d, lane, z);
      for (int i = b * blk; i < (b + 1) * blk; ++i) {
        if (!valid(i)) continue;
        const int wi = c.w[i], si = c.s[i], hi = c.h[i];
        load_row<H>(r0(i), d, lane, x);
        const float fb = dot<H>(x, z);
        for (int o = 1; o <= W; ++o) {
          const int j = i + o;
          if (j >= c.T || c.w[j] >= c.V || c.s[j] != si) continue;
          if (o <= hi && n != wi) {
            load_row<H>(r0(j), d, lane, y);
            axpy<H>(g_of(0.f, dot<H>(y, z)), y, acc);
          }
          if (o <= c.h[j] && n != c.w[j]) axpy<H>(g_of(0.f, fb), x, acc);
        }
      }
      store_row<H>(dLn + ((int64_t)b * K + k) * d, d, lane, 1.f, acc);
    }
  }
  block_partials(loss, cnt, part);
}

// Rows past 256 floats: chunk_deltas with every row read from global memory
// (L1) and the three output rows summed in place, in the registers' column
// order (lane + 32 h), so each dot and axpy adds as the narrow form does.
__device__ __forceinline__ float gdot(const float* __restrict__ a, const float* __restrict__ b,
                                      int d, int lane) {
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s += a[c] * b[c];
  return warp_sum(s);
}

__device__ __forceinline__ void gaxpy(float g, const float* __restrict__ x, float* y, int d,
                                      int lane) {
  for (int c = lane; c < d; c += 32) y[c] += g * x[c];
}

__global__ void __launch_bounds__(kThreads)
chunk_deltas_wide(Chunk c, int tile, int compute_loss, float* __restrict__ dL0p,
                  float* __restrict__ dL1p, float* __restrict__ dLn, float* __restrict__ part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = c.d, K = c.K, W = c.W, blk = c.blk;
  const int p0 = blockIdx.x * tile, p1 = min(c.T, p0 + tile);
  auto valid = [&](int p) { return p >= 0 && p < c.T && c.w[p] < c.V; };
  auto r0 = [&](int p) { return c.L0 + (int64_t)c.w[p] * d; };
  auto r1 = [&](int p) { return c.L1 + (int64_t)c.w[p] * d; };
  auto rn = [&](int b, int k) { return c.L1 + (int64_t)c.negs[(int64_t)b * K + k] * d; };

  float loss = 0.f, cnt = 0.f;
  const int npos = p1 - p0, nneg = (npos / blk) * K;
  for (int it = warp; it < npos + nneg; it += kWarps) {
    if (it < npos) {
      const int p = p0 + it;
      float* a0 = dL0p + (int64_t)p * d;
      float* a1 = dL1p + (int64_t)p * d;
      for (int t = lane; t < d; t += 32) a0[t] = a1[t] = 0.f;
      if (!valid(p)) continue;
      const int sp = c.s[p], hp = c.h[p], bp = p / blk;
      const float* l0p = r0(p);
      const float* l1p = r1(p);
      float fnb = 0.f;
      for (int k = 0; k < K && k < 32; ++k) {
        const float f = gdot(l0p, rn(bp, k), d, lane);
        if (lane == k) fnb = f;
      }
      for (int o = 1; o <= W; ++o) {
        const int j = p + o;
        if (j < c.T && c.w[j] < c.V && c.s[j] == sp) {
          const int wj = c.w[j], hj = c.h[j];
          if (o <= hp) {
            const float* x = r0(j);
            const float f = gdot(x, l1p, d, lane);
            gaxpy(g_of(1.f, f), x, a1, d, lane);
            if (compute_loss) loss -= logf(sigm(f) + kEps);
            cnt += 1.f;
          }
          if (o <= hj) {
            const float* y = r1(j);
            const float f = gdot(l0p, y, d, lane);
            gaxpy(g_of(1.f, f), y, a0, d, lane);
            if (compute_loss) loss -= logf(sigm(f) + kEps);
            cnt += 1.f;
            for (int k = 0; k < K; ++k) {
              if (c.negs[(int64_t)bp * K + k] == wj) continue;
              const float* z = rn(bp, k);
              const float fk = k < 32 ? __shfl_sync(kFull, fnb, k) : gdot(l0p, z, d, lane);
              gaxpy(g_of(0.f, fk), z, a0, d, lane);
              if (compute_loss) loss -= logf(1.f - sigm(fk) + kEps);
            }
          }
        }
        const int i = p - o;
        if (i >= 0 && c.w[i] < c.V && c.s[i] == sp) {
          const int wi = c.w[i], hi = c.h[i], bi = i / blk;
          if (o <= hi) {
            const float* y = r1(i);
            gaxpy(g_of(1.f, gdot(l0p, y, d, lane)), y, a0, d, lane);
            for (int k = 0; k < K; ++k) {
              if (c.negs[(int64_t)bi * K + k] == wi) continue;
              const float* z = rn(bi, k);
              const float fk = gdot(l0p, z, d, lane);
              gaxpy(g_of(0.f, fk), z, a0, d, lane);
              if (compute_loss) loss -= logf(1.f - sigm(fk) + kEps);
            }
          }
          if (o <= hp) {
            const float* x = r0(i);
            gaxpy(g_of(1.f, gdot(x, l1p, d, lane)), x, a1, d, lane);
          }
        }
      }
    } else {
      const int q = it - npos;
      const int b = p0 / blk + q / K, k = q % K;
      const int n = c.negs[(int64_t)b * K + k];
      float* acc = dLn + ((int64_t)b * K + k) * d;
      for (int t = lane; t < d; t += 32) acc[t] = 0.f;
      const float* z = rn(b, k);
      for (int i = b * blk; i < (b + 1) * blk; ++i) {
        if (!valid(i)) continue;
        const int wi = c.w[i], si = c.s[i], hi = c.h[i];
        const float* x = r0(i);
        const float fb = gdot(x, z, d, lane);
        for (int o = 1; o <= W; ++o) {
          const int j = i + o;
          if (j >= c.T || c.w[j] >= c.V || c.s[j] != si) continue;
          if (o <= hi && n != wi) {
            const float* y = r0(j);
            gaxpy(g_of(0.f, gdot(y, z, d, lane)), y, acc, d, lane);
          }
          if (o <= c.h[j] && n != c.w[j]) gaxpy(g_of(0.f, fb), x, acc, d, lane);
        }
      }
    }
  }
  block_partials(loss, cnt, part);
}

int tile_of(int blk) { return blk * (kTile / blk > 1 ? kTile / blk : 1); }

template <int H>
cudaError_t launch(const Chunk& c, int compute_loss, float* dL0p, float* dL1p, float* dLn,
                   float* part, cudaStream_t st) {
  const int tile = tile_of(c.blk);
  const int tiles = (c.T + tile - 1) / tile;
  chunk_deltas<H><<<tiles, kThreads, 0, st>>>(c, tile, compute_loss, dL0p, dL1p, dLn, part);
  return cudaGetLastError();
}

}  // namespace

// 1 when rows of d floats take the wide instantiation.
extern "C" int w2v_stream_chunk_wide(int d) { return d > 256 ? 1 : 0; }

// Partials the launch needs (2 floats each): one per tile of positions.
extern "C" int w2v_stream_parts(int T, int blk) {
  if (T < 1 || blk < 1) return 0;
  const int tile = tile_of(blk);
  return (T + tile - 1) / tile;
}

// T is a multiple of blk; negs holds (T / blk) K vocab ids; part has
// 2 w2v_stream_parts(T, blk) floats; out gets (loss, count).
extern "C" int w2v_stream_chunk(const float* L0, const float* L1, const int32_t* w,
                                const int32_t* s, const uint8_t* h, const int32_t* negs, int T,
                                int V, int d, int K, int window, int blk, int compute_loss,
                                float* dL0p, float* dL1p, float* dLn, float* part, float* out,
                                void* stream) {
  // window <= 255: the half-windows come as uint8 (the JAX package's wire
  // format asserts the same, models/w2v.py:311)
  if (T < 1 || V < 1 || d < 1 || K < 1 || window < 0 || window > 255 || blk < 1 ||
      T % blk != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const Chunk c{L0, L1, w, s, h, negs, T, V, d, K, window, blk};
  cudaError_t e;
  if (d <= 32) e = launch<1>(c, compute_loss, dL0p, dL1p, dLn, part, st);
  else if (d <= 64) e = launch<2>(c, compute_loss, dL0p, dL1p, dLn, part, st);
  else if (d <= 128) e = launch<4>(c, compute_loss, dL0p, dL1p, dLn, part, st);
  else if (d <= 256) e = launch<8>(c, compute_loss, dL0p, dL1p, dLn, part, st);
  else {
    const int tile = tile_of(c.blk);
    chunk_deltas_wide<<<(c.T + tile - 1) / tile, kThreads, 0, st>>>(c, tile, compute_loss, dL0p,
                                                                      dL1p, dLn, part);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess) return (int)e;
  sum_parts<<<1, 32, 0, st>>>(part, w2v_stream_parts(T, blk), out);
  return (int)cudaGetLastError();
}
