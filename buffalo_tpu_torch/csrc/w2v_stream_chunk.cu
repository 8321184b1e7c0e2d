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
// GFLOP per brunch chunk (740k terms), ~13 us at the FP32 rate.
//
// The staged form (chunk_deltas_staged; d <= 256 where a tile fits shared
// memory, w2v_stream_staged_tile): a block owns a tile of P positions (a
// multiple of the negative block, ~64) and stages once, with cp.async, the
// L0 and L1 rows of the tile and of the W positions on each side, and the
// L1 rows of the negatives of every block the tile and its left halo
// touch, with their words, sentence ids and half-windows.  Phase 1, lanes
// on terms: one thread per (pair, direction) positive term, per (pair,
// negative) term of direction A and per (position, negative) dot of
// direction B (l0[i] . ln does not depend on the offset) computes its dot
// product from shared memory, with no shuffles, and writes g (0 where the
// term is dropped) into shared memory, with the loss and the count of the
// pairs whose left position is in the tile; a direction-B negative's
// coefficient is its g times the number of offsets that keep it.  Phase 2,
// lanes on columns: a group of lanes per output row (dL0p and dL1p of each
// position of the tile, dLn of each negative block inside it), each lane
// on float4 column chunks, sums its terms' g x row in one fixed order.  The pairs that reach into the tile from the
// left halo are computed by both tiles; every output row is written by one
// block, with no float atomics.  The stream path's window 5 and 5 negatives
// are an instantiation of their own (loops unrolled, indices folded).  Both
// forms take g and the loss terms from w2v_common.cuh (expf, logf).
//
// The warp form (chunk_deltas; the shapes the staged form does not take,
// and rows past 256 floats in chunk_deltas_wide): a block owns a tile of
// 32 positions (rounded to a multiple of the negative block) and reads the
// rows of the tile, of the W positions on each side and of their negatives
// from L0 / L1 (the halo's rows are shared with the neighbouring tiles
// through L1 and L2).  Its warps take one output row each, lanes on the
// columns: a position's dL0p and dL1p row, gathering what lands there from
// the halo (so no two blocks write one row), or a negative's dLn row.  A
// pair's dot products are recomputed by each row they feed rather than
// stored.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"
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

// ----------------------------------------------------------- staged form
constexpr int kStagedMaxD = 256;
constexpr int kStagedTile = 64;            // positions per tile, rounded to the block
constexpr size_t kStagedSmemAim = 100 * 1024;
constexpr size_t kStagedSmemMax = 226 * 1024;  // 227 KB less the static partials

// The shared-memory plan of a tile of P positions.
struct Staged {
  int P, RS;       // positions per tile; row stride (floats, RS / 4 odd)
  int NR, NI, NB;  // staged rows (P + 2W), left positions (P + W), negative blocks
  size_t smem;
};

Staged staged_plan(int P, int d, int K, int W, int blk) {
  Staged g;
  g.P = P;
  g.RS = (d + 3) / 4 * 4;
  if ((g.RS / 4) % 2 == 0) g.RS += 4;
  g.NR = P + 2 * W;
  g.NI = P + W;
  g.NB = (P + W + blk - 1) / blk + 1;
  const size_t floats = (size_t)(2 * g.NR + g.NB * K) * g.RS  // rows
                        + (size_t)g.NI * W * (2 + K)            // gA, gB, gNA
                        + (size_t)g.NI * K;                     // cNB
  const size_t ints = 3 * (size_t)g.NR + (size_t)g.NB * K;      // word, sentence, half; negs
  g.smem = 4 * (floats + ints) + 2 * sizeof(float) * kWarps;
  return g;
}

// The tile the staged form takes for this shape: ~kStagedTile positions
// (a multiple of blk) cut until it fits kStagedSmemAim, else the largest
// that fits the 227 KB a block may hold; P = 0: the staged form does not
// take it.
Staged staged_tile(int d, int K, int W, int blk) {
  Staged none{};
  if (d < 1 || d > kStagedMaxD || K < 1 || blk < 1 || W < 0) return none;
  const int P0 = blk * max(1, kStagedTile / blk);
  for (int P = P0; P >= blk; P -= blk) {
    const Staged g = staged_plan(P, d, K, W, blk);
    if (g.smem <= kStagedSmemAim) return g;
  }
  for (int P = P0; P >= blk; P -= blk) {
    const Staged g = staged_plan(P, d, K, W, blk);
    if (g.smem <= kStagedSmemMax) return g;
  }
  return none;
}

// x / n for 0 <= x < 2^22 and n >= 1: (x + 1/2) / n lies 1 / (2 n) from
// the integers around it, and its float32 product with 1 / n is within
// 2^-23 of it relatively, less than that below 2^22 (a tile's slots fit
// shared memory, far fewer)
__device__ __forceinline__ int div_small(int x, float inv_n) {
  return (int)(((float)x + 0.5f) * inv_n);
}

__device__ __forceinline__ float dot_rows(const float* __restrict__ a, const float* __restrict__ b,
                                          int RS) {
  float s = 0.f;
  for (int c = 0; c < RS; c += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + c);
    const float4 y = *reinterpret_cast<const float4*>(b + c);
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
    s = fmaf(x.z, y.z, s);
    s = fmaf(x.w, y.w, s);
  }
  return s;
}

// kW, kK: the window and the negatives per block when known at compile
// time (the stream path's 5 and 5), else 0 and the chunk's
template <int kW, int kK>
__global__ void __launch_bounds__(kThreads)
chunk_deltas_staged(Chunk c, Staged g, int compute_loss, int vec, float* __restrict__ dL0p,
                    float* __restrict__ dL1p, float* __restrict__ dLn, float* __restrict__ part) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = c.d, blk = c.blk, RS = g.RS, P = g.P;
  const int K = kK ? kK : c.K, W = kW ? kW : c.W;
  const int p0 = blockIdx.x * P, q0 = p0 - W;           // first staged position
  const int b_lo = max(q0, 0) / blk;                    // first staged negative block
  const int b_hi = (min(p0 + P, c.T) - 1) / blk;        // last
  float* L0s = sm;                                      // [NR][RS]
  float* L1s = L0s + g.NR * RS;                         // [NR][RS]
  float* Ns = L1s + g.NR * RS;                          // [NB][K][RS]
  float* gA = Ns + g.NB * K * RS;                       // [NI][W]
  float* gB = gA + g.NI * W;                            // [NI][W]
  float* gNA = gB + g.NI * W;                           // [NI][W][K]
  float* cNB = gNA + g.NI * W * K;                      // [NI][K]
  int* wq = reinterpret_cast<int*>(cNB + g.NI * K);     // [NR] word, -1 invalid
  int* sq = wq + g.NR;                                  // [NR] sentence
  int* hq = sq + g.NR;                                  // [NR] half-window
  int* nq = hq + g.NR;                                  // [NB][K] negative words

  // ---- stage: the positions' words, sentences, half-windows and rows, the
  // negatives' rows; a position outside the chunk or a padding word has
  // zero rows and word -1
  for (int r = tid; r < g.NR; r += kThreads) {
    const int q = q0 + r;
    const bool in = q >= 0 && q < c.T;
    const int w = in ? c.w[q] : c.V;
    wq[r] = w < c.V ? w : -1;
    sq[r] = in ? c.s[q] : -2;
    hq[r] = in ? (int)c.h[q] : 0;
  }
  const int nb = b_hi - b_lo + 1;
  for (int i = tid; i < nb * K; i += kThreads)
    nq[i] = c.negs[(int64_t)b_lo * K + i];
  __syncthreads();
  const int W4 = vec ? 4 : 1, per_row = (d + W4 - 1) / W4;
  for (int i = tid; i < (2 * g.NR + nb * K) * per_row; i += kThreads) {
    const int row = i / per_row, col = (i - row * per_row) * W4;
    const float* src;
    int word;
    float* dst;
    if (row < 2 * g.NR) {
      const int r = row < g.NR ? row : row - g.NR;
      word = wq[r];
      src = row < g.NR ? c.L0 : c.L1;
      dst = (row < g.NR ? L0s : L1s) + r * RS + col;
    } else {
      const int n = row - 2 * g.NR;
      word = nq[n];
      src = c.L1;
      dst = Ns + n * RS + col;
    }
    const bool ok = word >= 0;
    const float* from = ok ? src + (int64_t)word * d + col : src;
    if (vec) cp_async16(dst, from, ok);
    else cp_async4(dst, from, ok);
  }
  cp_async_commit();
  // columns d .. RS stay zero (the dots read whole float4s)
  if (RS > d)
    for (int i = tid; i < (2 * g.NR + nb * K) * (RS - d); i += kThreads) {
      const int row = i / (RS - d);
      sm[row * RS + d + (i - row * (RS - d))] = 0.f;
    }
  cp_async_wait<0>();
  __syncthreads();

  // ---- phase 1, lanes on terms.  Left position i = q0 + li (li < NI),
  // offset o, pair (i, i + o); slots: 2 NI W positive terms, NI W K
  // direction-A negative terms, NI K direction-B negative dots
  float loss = 0.f, cnt = 0.f;
  const int n_pos = 2 * g.NI * W, n_na = g.NI * W * K, n_all = n_pos + n_na + g.NI * K;
  const float inv_k = 1.f / K, inv_w = 1.f / max(W, 1);
  for (int slot = tid; slot < n_all; slot += kThreads) {
    if (slot < n_na + n_pos && slot >= n_pos) {
      // direction A's negative k of pair (i, i + o): l0[i + o] . ln[b(i)][k]
      const int x = slot - n_pos, po = div_small(x, inv_k), k = x - po * K;
      const int li = div_small(po, inv_w), o = po - li * W + 1;
      const int i = q0 + li, lj = li + o, wi = wq[li];
      const bool va = i >= 0 && wi >= 0 && wq[lj] >= 0 && sq[li] == sq[lj] && o <= hq[li] &&
                      i + o < c.T;
      float gk = 0.f;
      if (va && p0 <= i + o) {
        const int n = i / blk - b_lo;
        if (nq[n * K + k] != wi) {
          const float f = dot_rows(L0s + lj * RS, Ns + (n * K + k) * RS, RS);
          gk = g_of(0.f, f);
          if (compute_loss && i >= p0) loss -= logf(1.f - sigm(f) + kEps);
        }
      }
      gNA[po * K + k] = gk;
    } else if (slot < n_pos) {
      // a positive term: direction A (centre i) or B (centre i + o)
      const int dir = slot & 1, po = slot >> 1, li = div_small(po, inv_w), o = po - li * W + 1;
      const int i = q0 + li, lj = li + o;
      const bool pair = i >= 0 && wq[li] >= 0 && wq[lj] >= 0 && sq[li] == sq[lj] && i + o < c.T;
      const bool v = pair && o <= hq[dir ? lj : li];
      float gv = 0.f;
      if (v && p0 <= i + o) {
        const float f = dir ? dot_rows(L0s + li * RS, L1s + lj * RS, RS)
                            : dot_rows(L0s + lj * RS, L1s + li * RS, RS);
        gv = g_of(1.f, f);
        if (i >= p0) {
          if (compute_loss) loss -= logf(sigm(f) + kEps);
          cnt += 1.f;
        }
      }
      (dir ? gB : gA)[po] = gv;
    } else {
      // direction B's negative k of position i of the tile: l0[i] .
      // ln[b(i)][k], times the offsets whose pair keeps it (a centre i + o
      // other than it); the halo's are never read
      const int x = slot - n_pos - n_na, li = div_small(x, inv_k), k = x - li * K, i = q0 + li;
      float coef = 0.f;
      if (i >= p0 && wq[li] >= 0) {
        const int n = i / blk - b_lo, neg = nq[n * K + k];
        int keep = 0;
        for (int o = 1; o <= W; ++o) {
          const int lj = li + o;
          keep += wq[lj] >= 0 && sq[lj] == sq[li] && o <= hq[lj] && i + o < c.T &&
                  neg != wq[lj];
        }
        if (keep) {
          const float f = dot_rows(L0s + li * RS, Ns + (n * K + k) * RS, RS);
          coef = keep * g_of(0.f, f);
          if (compute_loss) loss -= keep * logf(1.f - sigm(f) + kEps);
        }
      }
      cNB[li * K + k] = coef;
    }
  }
  __syncthreads();

  // ---- phase 2, lanes on columns: LPR lanes per output row, each on
  // float4 column chunks (a warp holds 32 / LPR rows), the row's terms in a
  // fixed order
  const int C4 = (d + 3) / 4;
  int LPR = 1;
  while (LPR < C4 && LPR < 32) LPR *= 2;
  const int sub = lane & (LPR - 1), rpw = 32 / LPR;
  const int np = min(P, c.T - p0), nrow = 2 * np + (np / blk) * K;
  for (int row = warp * rpw + lane / LPR; row < nrow; row += kWarps * rpw) {
    float* out;
    for (int c4 = sub; c4 < C4; c4 += LPR) {
      const int col = 4 * c4;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      auto add = [&](float gv, const float* r) {
        const float4 v = *reinterpret_cast<const float4*>(r + col);
        acc.x = fmaf(gv, v.x, acc.x);
        acc.y = fmaf(gv, v.y, acc.y);
        acc.z = fmaf(gv, v.z, acc.z);
        acc.w = fmaf(gv, v.w, acc.w);
      };
      if (row < 2 * np) {
        const int kind = row < np ? 0 : 1, pl = kind ? row - np : row, lp = pl + W;
        out = (kind ? dL1p : dL0p) + (int64_t)(p0 + pl) * d;
        if (kind == 0) {  // dL0p[p]: B's terms of (p, p + o), then A's of (p - o, p)
          const int b = (p0 + pl) / blk - b_lo;
          for (int o = 1; o <= W; ++o) add(gB[lp * W + o - 1], L1s + (lp + o) * RS);
          for (int k = 0; k < K; ++k) add(cNB[lp * K + k], Ns + (b * K + k) * RS);
          for (int o = 1; o <= W; ++o) {
            const int li = lp - o, i = q0 + li;
            add(gA[li * W + o - 1], L1s + li * RS);
            if (i >= 0) {
              const int n = i / blk - b_lo;
              for (int k = 0; k < K; ++k)
                add(gNA[(li * W + o - 1) * K + k], Ns + (n * K + k) * RS);
            }
          }
        } else {  // dL1p[p]: A's positive of (p, p + o), then B's of (p - o, p)
          for (int o = 1; o <= W; ++o) add(gA[lp * W + o - 1], L0s + (lp + o) * RS);
          for (int o = 1; o <= W; ++o) add(gB[(lp - o) * W + o - 1], L0s + (lp - o) * RS);
        }
      } else {  // dLn[b][k]: the block's positions in order, each one's offsets
        const int x = row - 2 * np, bl = x / K, k = x - bl * K, b = p0 / blk + bl;
        out = dLn + ((int64_t)b * K + k) * d;
        for (int i = b * blk; i < (b + 1) * blk; ++i) {
          const int li = i - q0;
          for (int o = 1; o <= W; ++o) add(gNA[(li * W + o - 1) * K + k], L0s + (li + o) * RS);
          add(cNB[li * K + k], L0s + li * RS);
        }
      }
      if (col + 4 <= d && (d & 3) == 0) {
        *reinterpret_cast<float4*>(out + col) = acc;
      } else {
        const float a[4] = {acc.x, acc.y, acc.z, acc.w};
        for (int e = 0; e < 4 && col + e < d; ++e) out[col + e] = a[e];
      }
    }
  }
  // the loss and count: each thread's in slot order, the warps in order
  loss = warp_sum(loss);
  cnt = warp_sum(cnt);
  block_partials(loss, cnt, part);
}

}  // namespace

// 1 when rows of d floats take the wide instantiation of the warp form.
extern "C" int w2v_stream_chunk_wide(int d) { return d > 256 ? 1 : 0; }

// Positions per tile of the staged form for this shape, 0 when the staged
// form does not take it (rows past 256 floats, or no tile fits 227 KB).
extern "C" int w2v_stream_staged_tile(int d, int K, int window, int blk) {
  return staged_tile(d, K, window, blk).P;
}

// Partials the launch needs (2 floats each): one per tile of positions.
extern "C" int w2v_stream_parts(int T, int d, int K, int window, int blk) {
  if (T < 1 || blk < 1) return 0;
  const int P = staged_tile(d, K, window, blk).P;
  const int tile = P > 0 ? P : tile_of(blk);
  return (T + tile - 1) / tile;
}

// T is a multiple of blk; negs holds (T / blk) K vocab ids; part has
// 2 w2v_stream_parts(T, d, K, window, blk) floats; out gets (loss, count).
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
  const Staged g = staged_tile(d, K, window, blk);
  if (g.P > 0) {
    const int vec = d % 4 == 0 && ((uintptr_t)L0 & 15) == 0 && ((uintptr_t)L1 & 15) == 0;
    auto* kern = window == 5 && K == 5 ? chunk_deltas_staged<5, 5> : chunk_deltas_staged<0, 0>;
    if (g.smem > 48 * 1024 &&
        (e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)g.smem)) != cudaSuccess)
      return (int)e;
    kern<<<(T + g.P - 1) / g.P, kThreads, g.smem, st>>>(c, g, compute_loss, vec, dL0p, dL1p, dLn,
                                                        part);
    e = cudaGetLastError();
  } else if (d <= 32) e = launch<1>(c, compute_loss, dL0p, dL1p, dLn, part, st);
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
  sum_parts<<<1, 32, 0, st>>>(part, w2v_stream_parts(T, d, K, window, blk), out);
  return (int)cudaGetLastError();
}
