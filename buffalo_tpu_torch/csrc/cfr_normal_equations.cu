// K17: CoFactor's per-row normal equations.  For batch row b (table row
// rows[b], its current vector x) over up to two sides of entries (column
// col, value v, gathered row f):
//  * implicit (user-item; weight w = alpha v): S_i = sum w f f^T,
//    t_i = sum (1 + w) f;
//  * explicit (item-context SPPMI; coefficient k = v - rbias[row] -
//    cbias[col]): S_e = sum f f^T, t_e = sum k f;
// A = l (FF + S_i) + S_e + reg I, y = l t_i + t_e (terms of an absent side
// left out, FF and l with the implicit side), and the loss terms of x
// before the solve: l (x FF x + sum (-dot^2 + (1 + w) (dot - 1)^2)) over
// the implicit side, sum (v - dot - rbias - cbias)^2 over the explicit side,
// reg |x|^2 — each on request, each times the row mask (entries on either
// side).  total[b] = both sides' lengths (the solve and the bias write skip
// rows with none).  A side is a padded block (row b's entries are
// cols[b, 0:lens[b]]) or a segment batch's chunks (row b's chunks
// chunk_ptr[b] .. chunk_ptr[b + 1], chunk c's entries cols[c,
// 0:chunk_lens[c]]; lens[b] the row's length).
//
// Replaces buffalo_tpu/ops/cfr_kernels.py _implicit_terms (:29) and the A / y
// builds and loss terms of _cfr_user_body (:56), _cfr_item_body (:92-137),
// _cfr_context_body (:563-583), and _segment_stats (:158) with the segment
// bodies (:181-323).
//
// What bounds it on the card: operations.  d^2 multiply-adds per entry and
// side (1,024 at d = 32) against ~4 d + 8 bytes per entry, so ~40 operations
// per byte, past the H100's FP32 ridge (~20); and the d^2 floats of A
// written per row.  Design of the narrow form (d <= kMaxD), K2's plan
// (csrc/als_normal_equations.cu, helpers in mma_tf32.cuh):
// * A row group of kG warps owns a row at a time (rows round-robin over the
//   groups of a grid sized to the card): one warp for padded rows whose
//   block triangle fits one warp's registers (d <= 47, most CoFactor rows
//   hold tens of entries), the whole block of 8 warps, splitting the units,
//   for wider rows and for segment batches (head rows of many chunks).  The
//   choice depends on d and on the mode only, so a row's bits depend on its
//   own entries alone, never on its batch or its place in it.
// * Gather ring: a group walks its rows' tiles of kTL entries (each row's
//   implicit side, then its explicit side; an empty row one empty tile) as
//   one stream through two shared-memory stages, so a short row's gathers
//   overlap its neighbours' products.  Each tile's cols come by cp.async a
//   tile ahead; its rows of F (16-byte copies when d * 4 is a multiple of
//   16, else 4-byte; zero-filled tails), values, cbias and, at a row's first
//   tile, the row's x come with the next stage.
// * Tensor cores at float32 accuracy: mma.sync m16n8k8 TF32 with the 3xTF32
//   split over the upper block triangle of the (d + 1) x (d + 1) product,
//   mirrored on write.  The B operand carries the entry's weight (w = alpha
//   v implicit, 1 explicit) on the feature columns; column d of the staged
//   rows holds y's coefficient (1 + w implicit, k explicit), unweighted, so
//   the same products give t_i or t_e.  Fragments past the staged row read
//   its zero column d + 1.  Each k-step's product starts from zero and is
//   added in float32.
// * Order: the implicit sums complete, then scaled in place to l (FF + S_i)
//   (and l t_i), before the explicit products are added onto them.
// * Loss: per entry, by the thread that prepares the entry's weight and
//   coefficient, its dot with x from the staged row (both sides), summed in
//   double; x FF x and |x|^2 per row; fixed-order reductions.
// No atomics: two launches are bitwise equal.  Rows past kMaxD floats take
// the wide form: A in 64 x 64 output tiles, one block per (row, tile) over
// the row's entries in order (their two 64-column slices of F staged per
// tile of entries), then one block per row for y and the loss terms,
// reading F from global memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kTile = 32;   // entries staged at a time (wide form)
constexpr int kMaxD = 128;
constexpr int kStages = 2;  // ring depth (narrow form)

struct SideArgs {
  const float* F;  // null: no such side
  const int32_t* lens;
  const int32_t* chunk_ptr;  // null: a padded block
  const int32_t* chunk_lens;
  const int32_t* cols;
  const float* vals;
  int L;
};

struct Args {
  const float* X;
  int n, d;
  const int32_t* rows;
  int R;
  SideArgs imp;
  const float* FF;
  float alpha, l;
  SideArgs exp;
  const float* rbias;
  const float* cbias;
  float reg;
  int loss_flags;  // 1 implicit, 2 explicit, 4 reg
  float* A;
  float* y;
  float* loss;
  int32_t* total;
};

__device__ __forceinline__ double block_sum(double v, double* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) s += scratch[w];
  __syncthreads();
  return s;  // thread 0's
}

// ----------------------------------------------------------- narrow form
// Tiling of the narrow form, set by the launcher.
struct Tiling {
  int NP;       // d + 1 (the coefficient column) padded to 16
  int S;        // shared row stride: >= d + 2 and 8 or 24 (mod 32) words, so
                // fragment loads are free of bank conflicts
  int MT, NU;   // m16 tiles down; 16 x 16 units of the upper block triangle
  int GF;       // floats of one row group's shared memory
  int vec;      // 16-byte copies
  int nchunk;   // copies per entry row
  uint32_t magic;  // q / nchunk == __umulhi(q, magic) for q < kTL * nchunk
                   // (nchunk > 1)
};

// kG warps per row group: 1 (4 groups in a block of 128 threads) or 8.
template <int kG>
struct Group {
  static constexpr int kGT = 32 * kG;               // threads of a group
  static constexpr int kBlock = kG == 1 ? 128 : kThreads;
  static constexpr int kGroups = kBlock / kGT;
  static constexpr int kTL = kG == 1 ? 32 : 64;     // entries per stage
  // a warp per row waits on its gathers and its mma chains: four blocks of
  // four warps on an SM (at most 128 registers a thread) outran the three
  // that the unbounded build's registers allow, and five (spilling)
  static constexpr int kMinBlocks = kG == 1 ? 4 : 1;
  static __device__ __forceinline__ void sync() {
    if (kG == 1) __syncwarp();
    else __syncthreads();
  }
};

// One row group's shared memory, GF floats: the stages' rows of F, weights
// (values until prepared), cbias of the entries, cols; x and the row's
// lengths and bias for two rows; per stage its row, side, entries and
// whether it is its row's last.
__host__ __device__ inline int group_floats(int S, int NP, int kTL) {
  return (kStages * kTL * (S + 3) + 2 * NP + 8 + 4 * kStages + 3) / 4 * 4;
}

// The shared memory in front of the groups: kWarps doubles for the block's
// reductions, then (a warp per row) FF's entries of the units in fragment
// order.
constexpr int kRedFloats = 2 * kWarps;
template <int kG, int kUPW>
constexpr int kFFFloats = kG == 1 ? kUPW * 8 * 32 : 0;

__device__ __forceinline__ SideArgs side_of(const Args& g, int s) {
  return s ? g.exp : g.imp;
}

// A walk over a row group's tiles: its rows b0, b0 + stride, ... in order,
// each row's side 0 (implicit), then 1 (explicit), each side over its
// chunks in order (a padded side is chunk b); a row without entries gives
// one empty tile (side 3); b >= R past the group's last row.
struct Tiles {
  int b, side, c, c1, base, len;
  int first;  // the tile is its row's first
};

// To the next tile with entries in row it.b, or side 2 when the row has no
// more.
__device__ __forceinline__ void seek(Tiles& it, const Args& g) {
  while (it.side < 2) {
    if (it.base < it.len) return;
    if (it.c + 1 < it.c1) {  // the next chunk of a segment side
      ++it.c;
      it.base = 0;
      it.len = side_of(g, it.side).chunk_lens[it.c];
      continue;
    }
    ++it.side;
    it.c = it.c1 = it.base = it.len = 0;
    if (it.side == 2) return;
    const SideArgs s = side_of(g, it.side);
    if (!s.F) continue;
    if (s.chunk_ptr) {
      it.c = s.chunk_ptr[it.b];
      it.c1 = s.chunk_ptr[it.b + 1];
      it.len = it.c < it.c1 ? s.chunk_lens[it.c] : 0;
    } else {
      it.c = it.b;
      it.c1 = it.b + 1;
      it.len = s.lens[it.b];
    }
  }
}

__device__ __forceinline__ void row_begin(Tiles& it, const Args& g, int b) {
  it.b = b;
  it.first = 1;
  if (b >= g.R) return;
  it.side = -1;
  it.c = it.c1 = it.base = it.len = 0;
  seek(it, g);
  if (it.side == 2) it.side = 3;  // the row's empty tile
}

__device__ __forceinline__ void next_tile(Tiles& it, const Args& g, int stride, int kTL) {
  if (it.b >= g.R) return;
  if (it.side != 3) {
    it.base += kTL;
    seek(it, g);
    it.first = 0;
    if (it.side < 2) return;
  }
  row_begin(it, g, it.b + stride);
}

// Whether the walk's current tile is its row's last.
__device__ __forceinline__ bool last_tile(const Tiles& it, const Args& g, int kTL) {
  if (it.side == 3) return true;
  Tiles nx = it;
  nx.base += kTL;
  seek(nx, g);
  return nx.side == 2;
}

// The narrow form: kUPW units of the upper block triangle per warp (every
// unit of the row in one warp for kG = 1, where kMT fixes the triangle at
// compile time); units past NU compute unit 0 again and are never stored.
// Each row group walks its rows' tiles as one stream through the ring, so
// a short row's gathers overlap its neighbours' products.
template <int kG, int kMT, int kUPW>
__global__ void __launch_bounds__(Group<kG>::kBlock, Group<kG>::kMinBlocks)
    narrow_kernel(const Args g, const Tiling tl) {
  using Gr = Group<kG>;
  constexpr int kTL = Gr::kTL, kGT = Gr::kGT;
  extern __shared__ __align__(16) float smem[];
  double* red = reinterpret_cast<double*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp / kG, gw = warp - grp * kG, gt = tid - grp * kGT;
  const int d = g.d, S = tl.S, NP = tl.NP;
  const int MT = kG == 1 ? kMT : tl.MT, NU = kG == 1 ? kMT * (kMT + 1) / 2 : tl.NU;
  float* ffs = smem + kRedFloats;  // kG = 1: [8 kUPW][32] FF in fragment order
  float* Fs = ffs + kFFFloats<kG, kUPW> + grp * tl.GF;  // [kStages][kTL][S]
  float* ws = Fs + kStages * kTL * S;               // [kStages][kTL]
  float* cb = ws + kStages * kTL;                   // [kStages][kTL]
  int32_t* cs = reinterpret_cast<int32_t*>(cb + kStages * kTL);  // [kStages][kTL]
  float* xs = reinterpret_cast<float*>(cs + kStages * kTL);      // [2][NP]: x of two rows
  int32_t* rinfo = reinterpret_cast<int32_t*>(xs + 2 * NP);      // [2][4]: b, lens, rb
  int32_t* meta = rinfo + 8;  // [kStages][4]: b, side, entries, last
  // columns past d + 1 are never written by the gather or the preparation,
  // nor x's past d
  for (int i = gt; i < kStages * kTL * (S - d - 1); i += kGT) {
    const int r = i / (S - d - 1);
    Fs[r * S + d + 1 + (i - r * (S - d - 1))] = 0.f;
  }
  for (int i = gt; i < 2 * NP; i += kGT) xs[i] = 0.f;

  // this warp's units and the staged columns its fragments read: a
  // fragment column at or past S lies in the padding and reads column d +
  // 1 instead, which is zero
  const int g8 = lane >> 2, t = lane & 3;
  const int u0 = gw * kUPW;
  int aoff[kUPW], boff[kUPW];  // the units' first rows and columns of A
  int acol[kUPW][2], bcol[kUPW][2];  // the columns read, less g8
  bool unweighted[kUPW][2];
#pragma unroll
  for (int uu = 0; uu < kUPW; ++uu) {
    int mi = 0, nj = 0;
    if (u0 + uu < NU) unit_mn(u0 + uu, MT, mi, nj);
    aoff[uu] = mi * 16;
    boff[uu] = nj * 16;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int a = aoff[uu] + 8 * h, bc = boff[uu] + 8 * h;
      acol[uu][h] = a + g8 < S ? a : d + 1 - g8;
      bcol[uu][h] = bc + g8 < S ? bc : d + 1 - g8;
      unweighted[uu][h] = bc + g8 == d;  // y's coefficient column
    }
  }
  const int W = tl.vec ? 4 : 1, ncopy = kTL * tl.nchunk;
  const int stride = gridDim.x * Gr::kGroups;

  // cols of the walk's tile into cs[st] (-1 past its entries)
  auto fetch_cols = [&](Tiles& it, int st) {
    if (gt < kTL) {
      int32_t* dst = cs + st * kTL + gt;
      const bool in = it.b < g.R && it.side < 2 && gt < it.len - it.base;
      if (in) {
        const SideArgs s = side_of(g, it.side);
        cp_async4(dst, s.cols + (int64_t)it.c * s.L + it.base + gt, true);
      } else {
        *dst = -1;
      }
    }
    next_tile(it, g, stride, kTL);
  };
  // the tile's description into meta[st]; at a row's first tile its x and
  // lengths into the row buffer `buf`; rows of F, values and cbias into
  // stage st (its cols in cs[st])
  int prk = 0;  // rows begun by the walk
  auto fetch_rows = [&](Tiles& it, int st) {
    const bool past = it.b >= g.R;
    const int side = it.side;
    const int cnt = !past && side < 2 ? min(kTL, it.len - it.base) : 0;
    const bool last = !past && last_tile(it, g, kTL);
    if (gt == 0) {
      meta[4 * st] = past ? g.R : it.b;
      meta[4 * st + 1] = side;
      meta[4 * st + 2] = cnt;
      meta[4 * st + 3] = last;
    }
    if (!past && it.first) {
      const int buf = prk++ & 1;
      const int row = g.rows[it.b];
      const int xr = min(row, g.n - 1);
      if (gt == 0) {
        rinfo[4 * buf] = it.b;
        rinfo[4 * buf + 1] = g.imp.F ? g.imp.lens[it.b] : 0;
        rinfo[4 * buf + 2] = g.exp.F ? g.exp.lens[it.b] : 0;
        rinfo[4 * buf + 3] = __float_as_int(g.exp.F ? g.rbias[xr] : 0.f);
      }
      for (int z = gt; z < d; z += kGT)
        cp_async4(xs + buf * NP + z, g.X + (int64_t)xr * d + z, true);
    }
    if (!past && side < 2) {
      const SideArgs s = side_of(g, side);
      const int32_t* cst = cs + st * kTL;
      float* Fst = Fs + st * kTL * S;
      for (int q = gt; q < ncopy; q += kGT) {
        const int l = tl.nchunk == 1 ? q : (int)__umulhi((unsigned)q, tl.magic);
        const int c = (q - l * tl.nchunk) * W;
        const int col = cst[l];
        const float* from = col >= 0 ? s.F + (int64_t)col * d + c : s.F;
        if (tl.vec) cp_async16_l1(Fst + l * S + c, from, col >= 0);
        else cp_async4(Fst + l * S + c, from, col >= 0);
      }
      if (gt < kTL) {
        const bool in = gt < cnt;
        const float* vals = s.vals + (int64_t)it.c * s.L + it.base;
        cp_async4(ws + st * kTL + gt, in ? vals + gt : vals, in);
        if (side == 1) {
          const int col = in ? cst[gt] : 0;
          cp_async4(cb + st * kTL + gt, g.cbias + col, in);
        }
      }
    }
    next_tile(it, g, stride, kTL);
  };

  float acc[kUPW][2][4];
#pragma unroll
  for (int uu = 0; uu < kUPW; ++uu)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[uu][e >> 2][e & 3] = 0.f;
  // the implicit sums scaled in place: l (FF + S_i) on A's columns, l t_i
  // on column d
  // (with a warp per row every warp holds the same units: their FF entries
  // are staged once per block in fragment order)
  auto ff_at = [&](int uu, int h, int e) {
    const int j = aoff[uu] + g8 + (e >= 2 ? 8 : 0), k = boff[uu] + 8 * h + 2 * t + (e & 1);
    return j < d && k < d && j <= k ? __ldg(g.FF + (int64_t)j * d + k) : 0.f;
  };
  if (kG == 1 && g.imp.F) {
    if (warp == 0)
#pragma unroll
      for (int uu = 0; uu < kUPW; ++uu)
#pragma unroll
        for (int e = 0; e < 8; ++e) ffs[((uu * 2 + (e >> 2)) * 4 + (e & 3)) * 32 + lane] =
            ff_at(uu, e >> 2, e & 3);
    __syncthreads();
  }
  auto scale_implicit = [&]() {
#pragma unroll
    for (int uu = 0; uu < kUPW; ++uu)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ff = kG == 1 ? ffs[((uu * 2 + h) * 4 + e) * 32 + lane] : ff_at(uu, h, e);
          acc[uu][h][e] = g.l * (ff + acc[uu][h][e]);
        }
  };
  bool scaled = !g.imp.F;
  double l_imp = 0.0, l_exp = 0.0;
  int crk = 0;  // rows finished

  Tiles rit;
  row_begin(rit, g, blockIdx.x * Gr::kGroups + grp);
  Tiles cit = rit;
  fetch_cols(cit, 0);
  cp_async_commit();
  cp_async_wait<0>();
  Gr::sync();  // cs[0]
  fetch_rows(rit, 0);
  fetch_cols(cit, 1);
  cp_async_commit();
  for (int i = 0;; ++i) {
    const int st = i & 1;
    cp_async_wait<0>();  // this thread's copies of tile i (and cols of i + 1)
    Gr::sync();          // everyone's; stage i - 1 is consumed
    const int b = meta[4 * st], side = meta[4 * st + 1], cnt = meta[4 * st + 2];
    const bool last = meta[4 * st + 3];
    if (b >= g.R) break;
    fetch_rows(rit, st ^ 1);
    fetch_cols(cit, st);
    cp_async_commit();
    const int buf = crk & 1;
    const float* x = xs + buf * NP;
    const int n_imp = rinfo[4 * buf + 1], n_exp = rinfo[4 * buf + 2];
    const bool live = n_imp + n_exp > 0;
    if (side == 1 && !scaled) {
      scale_implicit();
      scaled = true;
    }
    // the entries' weights and coefficients (column d), and their loss
    // terms from their dots with x
    float* Fst = Fs + st * kTL * S;
    float* wst = ws + st * kTL;
    if (cnt > 0 && gt < kTL) {
      float w = 0.f, coeff = 0.f;
      if (gt < cnt) {
        const float v = wst[gt];
        const float* f = Fst + gt * S;
        const bool want = live && (side ? (g.loss_flags & 2) : (g.loss_flags & 1));
        float dot = 0.f;
        if (want && (d & 3) == 0) {
          // four columns a step; quarter-warps start a step apart, so the
          // 16-byte reads of eight rows fall on distinct banks
          const float4* x4 = reinterpret_cast<const float4*>(x);
          const float4* f4 = reinterpret_cast<const float4*>(f);
          const int n4 = d >> 2;
          int z = (gt >> 2) % n4;
          for (int k = 0; k < n4; ++k) {
            const float4 a = x4[z], c = f4[z];
            dot = fmaf(a.x, c.x, dot);
            dot = fmaf(a.y, c.y, dot);
            dot = fmaf(a.z, c.z, dot);
            dot = fmaf(a.w, c.w, dot);
            if (++z == n4) z = 0;
          }
        } else if (want) {  // each thread starts at its own column
          int z = gt % d;
          for (int k = 0; k < d; ++k) {
            dot = fmaf(x[z], f[z], dot);
            if (++z == d) z = 0;
          }
        }
        if (side == 0) {
          w = v * g.alpha;
          coeff = 1.f + w;
          if (want) {
            const float dm = dot - 1.f;
            l_imp += (double)(-dot * dot + coeff * (dm * dm));
          }
        } else {
          const float rb = __int_as_float(rinfo[4 * buf + 3]);
          const float cbv = cb[st * kTL + gt];
          w = 1.f;
          coeff = v - rb - cbv;
          if (want) {
            const float err = v - dot - rb - cbv;
            l_exp += (double)(err * err);
          }
        }
      }
      wst[gt] = w;
      Fst[gt * S + d] = coeff;
    }
    Gr::sync();
    for (int ks = 0; ks * 8 < cnt; ++ks) {
      const int l0 = ks * 8;
      const float w0 = wst[l0 + t], w1 = wst[l0 + t + 4];
      const float* r0 = Fst + (l0 + t) * S + g8;  // entry l0 + t, feature g8
      const float* r1 = r0 + 4 * S;                // entry l0 + t + 4
#pragma unroll
      for (int uu = 0; uu < kUPW; ++uu) {
        // A operand: features (rows of A) x entries
        uint32_t ab[4], as[4];
        split_tf32(r0[acol[uu][0]], ab[0], as[0]);
        split_tf32(r0[acol[uu][1]], ab[1], as[1]);
        split_tf32(r1[acol[uu][0]], ab[2], as[2]);
        split_tf32(r1[acol[uu][1]], ab[3], as[3]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // B operand: entries x features, weighted
          uint32_t bb[2], bs[2];
          const float f0 = r0[bcol[uu][h]], f1 = r1[bcol[uu][h]];
          split_tf32(unweighted[uu][h] ? f0 : f0 * w0, bb[0], bs[0]);
          split_tf32(unweighted[uu][h] ? f1 : f1 * w1, bb[1], bs[1]);
          float step[4];
          mma_tf32_first(step, as, bb);
          mma_tf32(step, ab, bs);
          mma_tf32(step, ab, bb);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[uu][h][e] += step[e];
        }
      }
    }
    if (!last) continue;

    // the row's end: A (upper block triangle, mirrored) and y (column d)
    if (!scaled) scale_implicit();
    float* A = g.A + (int64_t)b * d * d;
#pragma unroll
    for (int uu = 0; uu < kUPW; ++uu) {
      if (u0 + uu >= NU) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = aoff[uu] + g8 + (e >= 2 ? 8 : 0), k = boff[uu] + 8 * h + 2 * t + (e & 1);
          if (j >= d || j > k || k > d) continue;
          const float v = acc[uu][h][e];
          if (k == d) {
            g.y[(int64_t)b * d + j] = v;
          } else {
            A[(int64_t)j * d + k] = j == k ? v + g.reg : v;
            if (j != k) A[(int64_t)k * d + j] = v;
          }
        }
    }
    // the loss terms of x (x FF x, |x|^2, the per-entry sums), reduced in
    // a fixed order when any is asked for
    double sums[4] = {0.0, l_imp, l_exp, 0.0};
    if (g.loss_flags) {
      if (live && g.imp.F && (g.loss_flags & 1)) {
        int j = gt / d, k = gt - j * d;  // entry (j, k) = j d + k, kGT apart
        for (int e = gt; e < d * d; e += kGT) {
          sums[0] += (double)(x[j] * __ldg(g.FF + e) * x[k]);
          for (k += kGT; k >= d; k -= d) ++j;
        }
      }
      if (live && (g.loss_flags & 4))
        for (int z = gt; z < d; z += kGT) sums[3] += (double)(x[z] * x[z]);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        double v = sums[s];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
        if (kG > 1) {
          if (lane == 0) red[warp] = v;
          __syncthreads();
          v = 0.0;
          if (tid == 0)
            for (int w = 0; w < kG; ++w) v += red[w];
          __syncthreads();
        }
        sums[s] = v;  // the group's thread 0's
      }
    }
    if (gt == 0) {
      g.loss[b] = (float)((double)g.l * (sums[0] + sums[1]) + sums[2] + (double)g.reg * sums[3]);
      g.total[b] = n_imp + n_exp;
    }
    // the next row from zero
#pragma unroll
    for (int uu = 0; uu < kUPW; ++uu)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[uu][e >> 2][e & 3] = 0.f;
    scaled = !g.imp.F;
    l_imp = l_exp = 0.0;
    ++crk;
  }
}

// ------------------------------------------------------------- wide rows
constexpr int kOut = 64;                  // an output tile of A is kOut x kOut
constexpr int kTilePer = kOut * kOut / kThreads;

// A's tile (blockIdx.y) of row blockIdx.x: both sides' sums as in
// normal_equations_kernel, the same per-entry order.
__global__ void __launch_bounds__(kThreads) wide_a_kernel(Args g) {
  __shared__ float Fi[kTile][kOut], Fj[kTile][kOut], wa[kTile];
  const int d = g.d, t = threadIdx.x, b = blockIdx.x;
  const int nt = (d + kOut - 1) / kOut;
  const int i0 = (blockIdx.y / nt) * kOut, j0 = (blockIdx.y % nt) * kOut;
  float acc[kTilePer], out[kTilePer];
#pragma unroll
  for (int j = 0; j < kTilePer; ++j) out[j] = acc[j] = 0.f;
  for (int side = 0; side < 2; ++side) {
    const SideArgs& s = side ? g.exp : g.imp;
    if (!s.F) continue;
    int c0 = b, c1 = b + 1;
    if (s.chunk_ptr) {
      c0 = s.chunk_ptr[b];
      c1 = s.chunk_ptr[b + 1];
    }
    for (int c = c0; c < c1; ++c) {
      const int len = s.chunk_ptr ? s.chunk_lens[c] : s.lens[b];
      const int32_t* cols = s.cols + (int64_t)c * s.L;
      const float* vals = s.vals + (int64_t)c * s.L;
      for (int base = 0; base < len; base += kTile) {
        const int cnt = min(kTile, len - base);
        for (int q = t; q < kTile * kOut; q += kThreads) {
          const int l = q / kOut, z = q - l * kOut;
          const float* f = s.F + (int64_t)(l < cnt ? cols[base + l] : 0) * d;
          Fi[l][z] = l < cnt && i0 + z < d ? f[i0 + z] : 0.f;
          Fj[l][z] = l < cnt && j0 + z < d ? f[j0 + z] : 0.f;
        }
        if (t < kTile) wa[t] = t < cnt ? (side ? 1.f : vals[base + t] * g.alpha) : 0.f;
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kTilePer; ++j) {
          const int e = t + j * kThreads, ri = e / kOut, rj = e - ri * kOut;
          float a = acc[j];
          for (int l = 0; l < cnt; ++l) a = fmaf(Fi[l][ri] * wa[l], Fj[l][rj], a);
          acc[j] = a;
        }
        __syncthreads();
      }
    }
#pragma unroll
    for (int j = 0; j < kTilePer; ++j) {
      const int e = t + j * kThreads, i = i0 + e / kOut, jj = j0 + e % kOut;
      if (side == 0) {
        if (i < d && jj < d) out[j] = g.l * (g.FF[(int64_t)i * d + jj] + acc[j]);
      } else {
        out[j] += acc[j];
      }
      acc[j] = 0.f;
    }
  }
  float* A = g.A + (int64_t)b * d * d;
#pragma unroll
  for (int j = 0; j < kTilePer; ++j) {
    const int e = t + j * kThreads, i = i0 + e / kOut, jj = j0 + e % kOut;
    if (i < d && jj < d) A[(int64_t)i * d + jj] = i == jj ? out[j] + g.reg : out[j];
  }
}

// One side's y entries (thread t: columns t, t + kThreads, ...) and the loss
// sum of thread l < kTile, as side_sums, F read from global memory.
template <bool kImplicit>
__device__ void wide_side_y(const Args& g, const SideArgs& s, int b, float rb, const float* xr,
                            float* wy, float* yacc, int ny, double& lsum, bool want_loss) {
  const int d = g.d, t = threadIdx.x;
  int c0 = b, c1 = b + 1;
  if (s.chunk_ptr) {
    c0 = s.chunk_ptr[b];
    c1 = s.chunk_ptr[b + 1];
  }
  for (int c = c0; c < c1; ++c) {
    const int len = s.chunk_ptr ? s.chunk_lens[c] : s.lens[b];
    const int32_t* cols = s.cols + (int64_t)c * s.L;
    const float* vals = s.vals + (int64_t)c * s.L;
    for (int base = 0; base < len; base += kTile) {
      const int cnt = min(kTile, len - base);
      if (t < kTile) {
        float y_w = 0.f;
        if (t < cnt) {
          const float v = vals[base + t];
          const float* f = s.F + (int64_t)cols[base + t] * d;
          float dot = 0.f;
          if (want_loss)
            for (int z = 0; z < d; ++z) dot = fmaf(xr[z], f[z], dot);
          if (kImplicit) {
            y_w = 1.f + v * g.alpha;
            if (want_loss) {
              const float dm = dot - 1.f;
              lsum += (double)(-dot * dot + y_w * (dm * dm));
            }
          } else {
            const float cb = g.cbias[cols[base + t]];
            y_w = v - rb - cb;
            if (want_loss) {
              const float err = v - dot - rb - cb;
              lsum += (double)(err * err);
            }
          }
        }
        wy[t] = y_w;
      }
      __syncthreads();
      for (int q = 0; q < ny; ++q) {
        const int z = t + q * kThreads;
        if (z >= d) break;
        float yv = yacc[q];
        for (int l = 0; l < cnt; ++l)
          yv = fmaf(s.F[(int64_t)cols[base + l] * d + z], wy[l], yv);
        yacc[q] = yv;
      }
      __syncthreads();
    }
  }
}

// y, the loss terms and the entry count of row blockIdx.x (wide rows).
__global__ void __launch_bounds__(kThreads) wide_y_kernel(Args g, int ny) {
  extern __shared__ float ysm[];  // kThreads ny: the y sums of each thread
  __shared__ double scratch[kWarps];
  __shared__ float wy[kTile];
  const int d = g.d, t = threadIdx.x, b = blockIdx.x;
  const int row = g.rows[b];
  const int xr = min(row, g.n - 1);
  const float* x = g.X + (int64_t)xr * d;
  const int n_imp = g.imp.F ? g.imp.lens[b] : 0;
  const int n_exp = g.exp.F ? g.exp.lens[b] : 0;
  const bool live = n_imp + n_exp > 0;
  float* yacc = ysm + t * ny;
  for (int q = 0; q < ny; ++q) yacc[q] = 0.f;
  double l_imp = 0.0, l_exp = 0.0;
  // y = l (implicit sums) + (explicit sums), each side from zero, as the
  // narrow form's yout
  float* y = g.y + (int64_t)b * d;
  if (g.imp.F)
    wide_side_y<true>(g, g.imp, b, 0.f, x, wy, yacc, ny, l_imp, live && (g.loss_flags & 1));
  for (int q = 0; q < ny; ++q) {
    const int z = t + q * kThreads;
    if (z < d) y[z] = g.imp.F ? g.l * yacc[q] : 0.f;
    yacc[q] = 0.f;
  }
  if (g.exp.F) {
    wide_side_y<false>(g, g.exp, b, g.rbias[xr], x, wy, yacc, ny, l_exp,
                       live && (g.loss_flags & 2));
    for (int q = 0; q < ny; ++q) {
      const int z = t + q * kThreads;
      if (z < d) y[z] += yacc[q];
    }
  }
  double xffx = 0.0, x2 = 0.0;
  if (live && g.imp.F && (g.loss_flags & 1)) {
    for (int64_t k = t; k < (int64_t)d * d; k += kThreads)
      xffx += (double)(x[k / d] * g.FF[k] * x[k % d]);
  }
  if (live && (g.loss_flags & 4))
    for (int z = t; z < d; z += kThreads) x2 += (double)(x[z] * x[z]);
  const double s_ffx = block_sum(xffx, scratch);
  const double s_imp = block_sum(l_imp, scratch);
  const double s_exp = block_sum(l_exp, scratch);
  const double s_x2 = block_sum(x2, scratch);
  if (t == 0) {
    g.loss[b] = (float)((double)g.l * (s_ffx + s_imp) + s_exp + (double)g.reg * s_x2);
    g.total[b] = n_imp + n_exp;
  }
}

// The narrow form's launch: grid sized to what the card holds at once.
template <int kG, int kMT, int kUPW>
cudaError_t launch_narrow(const Args& g, const Tiling& tl, cudaStream_t st) {
  using Gr = Group<kG>;
  const size_t smem = sizeof(float) * ((size_t)kRedFloats + kFFFloats<kG, kUPW> +
                                       (size_t)Gr::kGroups * tl.GF);
  auto kernel = narrow_kernel<kG, kMT, kUPW>;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, Gr::kBlock, smem);
  if (err != cudaSuccess) return err;
  const int64_t need = ((int64_t)g.R + Gr::kGroups - 1) / Gr::kGroups;
  const int64_t fit = (int64_t)(per_sm > 0 ? per_sm : 1) * sms;
  kernel<<<(unsigned)(need < fit ? need : fit), Gr::kBlock, smem, st>>>(g, tl);
  return cudaGetLastError();
}

constexpr int kUnitCounts[] = {1, 2, 3, 4, 6};  // instantiated units per warp (kG = 8)

cudaError_t launch_narrow(const Args& g, cudaStream_t st) {
  const int d = g.d;
  Tiling tl;
  tl.NP = (d + 1 + 15) / 16 * 16;
  tl.MT = tl.NP / 16;
  tl.NU = tl.MT * (tl.MT + 1) / 2;
  tl.S = d + 2;  // column d + 1 stays zero
  while (tl.S % 32 != 8 && tl.S % 32 != 24) ++tl.S;
  auto aligned = [](const float* p) { return !p || (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  tl.vec = d % 4 == 0 && aligned(g.imp.F) && aligned(g.exp.F);
  tl.nchunk = tl.vec ? d / 4 : d;
  tl.magic = 0xffffffffu / (uint32_t)tl.nchunk + 1u;
  const bool segment = (g.imp.F && g.imp.chunk_ptr) || (g.exp.F && g.exp.chunk_ptr);
  if (!segment && tl.MT <= 3) {  // a warp per row
    tl.GF = group_floats(tl.S, tl.NP, Group<1>::kTL);
    if (tl.MT == 1) return launch_narrow<1, 1, 1>(g, tl, st);
    if (tl.MT == 2) return launch_narrow<1, 2, 3>(g, tl, st);
    return launch_narrow<1, 3, 6>(g, tl, st);
  }
  tl.GF = group_floats(tl.S, tl.NP, Group<8>::kTL);
  int upw = 0;
  for (int c : kUnitCounts)
    if (!upw && c * kWarps >= tl.NU) upw = c;
  switch (upw) {
    case 1: return launch_narrow<8, 0, 1>(g, tl, st);
    case 2: return launch_narrow<8, 0, 2>(g, tl, st);
    case 3: return launch_narrow<8, 0, 3>(g, tl, st);
    case 4: return launch_narrow<8, 0, 4>(g, tl, st);
    case 6: return launch_narrow<8, 0, 6>(g, tl, st);
    default: return cudaErrorInvalidValue;  // d <= kMaxD keeps NU <= 48
  }
}

}  // namespace

// 1 when rows of d floats take the wide form.
extern "C" int cfr_normal_equations_wide(int d) { return d > kMaxD ? 1 : 0; }

// Sides are (F, lens, chunk_ptr, chunk_lens, cols, vals, L); F null leaves a
// side out (FF / alpha / l go with the implicit side, rbias / cbias with the
// explicit one).  A (R, d, d), y (R, d), loss (R), total (R) are written.
extern "C" int cfr_normal_equations(
    const float* X, int n, int d, const int32_t* rows, int R, const float* Fi,
    const int32_t* lens_i, const int32_t* ptr_i, const int32_t* clens_i, const int32_t* cols_i,
    const float* vals_i, int L_i, const float* FF, float alpha, float l, const float* Fe,
    const int32_t* lens_e, const int32_t* ptr_e, const int32_t* clens_e, const int32_t* cols_e,
    const float* vals_e, int L_e, const float* rbias, const float* cbias, float reg,
    int loss_flags, float* A, float* y, float* loss, int32_t* total, void* stream) {
  if (d < 1 || n < 1 || R < 0 || (!Fi && !Fe) || (Fi && !FF) ||
      (Fe && (!rbias || !cbias)) || !A || !y || !loss || !total)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  Args g{X, n, d, rows, R,
         SideArgs{Fi, lens_i, ptr_i, clens_i, cols_i, vals_i, L_i}, FF, alpha, l,
         SideArgs{Fe, lens_e, ptr_e, clens_e, cols_e, vals_e, L_e}, rbias, cbias, reg,
         loss_flags, A, y, loss, total};
  const cudaStream_t st = (cudaStream_t)stream;
  if (!cfr_normal_equations_wide(d)) return (int)launch_narrow(g, st);
  const int nt = (d + kOut - 1) / kOut;
  wide_a_kernel<<<dim3(R, nt * nt), kThreads, 0, st>>>(g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int ny = (d + kThreads - 1) / kThreads;
  const size_t ysmem = sizeof(float) * kThreads * ny;
  if (ysmem > 48 * 1024) {
    err = cudaFuncSetAttribute(wide_y_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)ysmem);
    if (err != cudaSuccess) return (int)err;
  }
  wide_y_kernel<<<R, kThreads, ysmem, st>>>(g, ny);
  return (int)cudaGetLastError();
}
