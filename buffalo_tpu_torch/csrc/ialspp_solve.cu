// K4: iALS++ block subspace CG for ALS batches, range or scatter rows.
//
// Replaces buffalo_tpu/ops/als_kernels.py: ialspp_solve_batch (:174-238) with
// the loss terms of _loss_terms (:77) and the gather/write of _apply_batch
// (:343-346 range, :364-372 scatter), the reference's _partial_update_ialspp
// (als.cc:211-358).  Per row u, with F = Bf[cols[u]] over its n entries,
// w = alpha * vals and the residual cache Yui_l = p . F_l:
//   for each block [beg, beg + bs) of the d features, in order,
//     b   = p FF[:, blk] + reg p_blk + sum_l (Yui_l - 1) w_l F_l[blk]
//     x   = 3 CG steps from zero on (FF[blk, blk] + reg I
//                                    + F[:, blk]^T diag(w) F[:, blk]) x = b,
//           a system freezing once its squared residual is below cg_tol
//     p_blk -= x,   Yui_l -= F_l[blk] . x   (dead after the last block)
// with plain reg (adaptive_reg scales only the loss's regularization term),
// and the loss terms from the pre-update p.  The result is written over
// table[row_start + u] (range mode) or table[rows[u]] (rows mode); rows with
// len 0 and ids outside the table (a PaddedBatch's padding) are skipped.
// The values are float32 or bfloat16 (read as float32).
//
// The identity behind the Gram form: with G = F^T diag(w) F over the row's
// entries, the cache's change after earlier blocks is F (p - p0), so with
// e = F^T ((Yui0 - 1) w) (Yui0 = F p0, the pre-update p)
//   sum_l (Yui_l - 1) w_l F_l[blk] = e[blk] + G[blk, :] (p - p0),
//   F[:, blk]^T (w * F[:, blk] v)  = G[blk, blk] v,
// and with A = FF + reg I + G each block is
//   b = FF[blk, :] p0 + reg p_blk + e[blk] + A[blk, :] (p - p0)
// (p - p0 is zero on the block and past it) and 3 CG steps on A[blk, blk]:
// once G and e are formed no entry is read again.  (b = A[blk, :] p -
// F[:, blk]^T w is the same in exact arithmetic, but cancels two large sums
// in float32; e is summed from the small (Yui0 - 1) w, as the plain version
// sums.)  The loss terms come from Yui0 entry by entry, as the plain
// version's.
//
// Three forms.  At d <= 176 a row takes one by its length (the launcher's
// short_max and gram_min; the wrapper picks them from measurements on the
// H100): the short form up to short_max entries, the tile form up to
// gram_min, the Gram form past it; wider rows all take the tile form.
// Each form's blocks skip the rows of the others, so a call is at most
// three launches.
// * Gram form: rows of more than gram_min entries, d <= 176 (its d x d
//   system and the product's running totals in one block's shared memory).
//   One block of 512 threads per row.  The entries' Bf rows come through a
//   cp.async ring of two 64-entry stages (K2's gather, csrc/mma_tf32.cuh);
//   as a stage lands a warp per entry forms Yui0 = F_l . p0 and the loss
//   terms, then G's upper block triangle and e are formed with mma.sync
//   m16n8k8 as 3xTF32 (an all-ones feature column in the padding, weighted
//   by (Yui0 - 1) w, gives e); each k-step's product is summed from zero and
//   added to registers, flushed every four stages into running totals.  A is
//   then assembled over the consumed ring and every block's b and CG run on
//   it in shared memory: a warp per row of A for the products, a thread per
//   feature for the CG vectors.  A batch of fewer rows than four waves of
//   the SMs splits its longer rows into pieces of at least 512 entries, a
//   block each (plan_pieces, from the batch's shape): each piece writes its
//   sums to a workspace and the row's last piece to finish (an integer
//   count) adds them in piece order and solves.  What bounds it: the
//   tensor-core loop
//   (~d^2 / 2 products per entry, 3 mma.sync each, with their splits and
//   fragment loads), where the implicit form does ~10 d operations per
//   entry: it pays only on long rows, which it gathers once instead of five
//   times.
// * Short form: rows of at most short_max entries, d <= 176.  A block of 256
//   threads takes kRows = 8 consecutive batch rows (those that are short),
//   with shared memory sized by the class (short_max entries a row), so
//   several blocks share an SM.  The dense products of its rows, FF[blk, :]
//   P^T for b and FF[blk, blk] V^T for each CG step, are one 3xTF32
//   tensor-core product per block of rows, FF read once for all of them.
//   The entry passes (Yui with the loss terms and b in one, then one per CG
//   step) split each row's entries over the 8 warps (warp w takes entries
//   w, w + 8, ...), lanes on the features, each entry's row read from L1 /
//   L2 and its dot a butterfly; the per-feature partials are added in warp
//   order.  Warp r keeps row r's CG vectors.  What bounds it: the dense
//   products (FF's fragments read from L2 for every block of rows), then
//   the entries' re-reads from L2 (four passes a block).
// * Tile form: rows between the two bounds, and every row past d = 176:
//   the first kernel, one block of 256 threads per row, thread j owning
//   feature j of a block (several past 256), F in a shared-memory tile sized
//   by the longest row it takes (a longer row streamed through it in every
//   pass).  What bounds it: one thread's serial walk over the tile's entries
//   for each per-feature sum, and one block per SM where the tile fills the
//   227 KB.
// Every sum has a fixed order, so two launches are bitwise equal, and every
// branch that meets a barrier is the same on all threads.
#include <climits>

#include "als_common.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kSteps = 3;  // CG steps per block (als.cc:322-345)

struct Params {
  float* table;
  const float* Bf;
  const float* FF;
  const int32_t* lens;
  const int32_t* rows;  // rows mode: table row of each batch row; else null
  const int32_t* cols;
  const void* vals;     // float32, or bfloat16 with vals_bf16
  float* nume;
  float* deno;
  int64_t row_start, n_table_rows;
  int B, L, d, bs;
  float alpha, reg, cg_tol, num_fixed_rows;
  int adaptive_reg, item_axis, compute_loss, vals_bf16;
  int short_max;  // the short form's rows: at most short_max entries
  int gram_min;   // the Gram form's rows: more than gram_min entries; the
                  // tile form takes those between
  // the wide form
  int T;    // entries per shared-memory tile
  int YL;   // the longest row it takes: min(L, gram_min)
  int S;    // tile row stride in floats (16-byte rows)
  int vec;  // 16-byte copies
  // the short form
  int DP;   // row stride of its per-row vectors, 4 (mod 32) words
  int SM;   // entries a row, rounded up to 4
  // the Gram form
  int NP;       // features padded to 16, with the two ones columns
  int GS;       // ring row stride, 8 or 24 (mod 32) words
  int NTn;      // n8 tiles across; the upper block triangle has NU 16 x 16 units
  int MT;       // m16 tiles down
  int NU;
  int EG;       // entry groups: warp w takes the k-steps w % EG (mod EG)
  int TT;       // n8 tiles of the running totals (all of the triangle's)
  int R0;       // floats of the ring, later A
  int UPW;      // units per warp
  int maxP;     // blocks per row: a long row's entries split into pieces
  int PL;       // entries per piece (a multiple of kTL)
  int WSZ;      // floats of a piece's partial sums in gws
  float* gws;   // [B][maxP][WSZ] the pieces' partial sums (maxP > 1)
  int* gcnt;    // [B] pieces done per row, zeroed (maxP > 1)
  int nchunk;   // copies per entry row
  uint32_t magic;  // q / nchunk == __umulhi(q, magic) for q < kTL * nchunk
};

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// ------------------------------------------------------------ short form
constexpr int kSThreads = 256;
constexpr int kSWarps = kSThreads / 32;
constexpr int kRows = kSWarps;  // rows per block: warp r keeps row r's CG state

__host__ __device__ constexpr size_t short_floats(int DP, int SM) {
  return (size_t)4 * kRows * DP + (size_t)kSWarps * kRows * DP + 3 * (size_t)kRows * SM +
         2 * kSWarps * kRows + kRows;
}

// kC columns per lane: rows of up to 32 kC floats.
template <int kC>
__global__ void __launch_bounds__(kSThreads) ialspp_short(const Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int nrow[kRows];
  __shared__ int64_t drow[kRows];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = p.d, DP = p.DP, SM = p.SM, r0 = blockIdx.x * kRows;
  float* ps = smem;                           // [kRows][DP] p, updated per block
  float* qs = ps + kRows * DP;                // [kRows][DP] the dense products
  float* vs = qs + kRows * DP;                // [kRows][DP] the CG directions
  float* xs = vs + kRows * DP;                // [kRows][DP] the last block's x
  float* part = xs + kRows * DP;              // [kSWarps][kRows][DP] feature partials
  float* Yui = part + kSWarps * kRows * DP;   // [kRows][SM]
  float* ws = Yui + kRows * SM;               // [kRows][SM]
  int* cs = reinterpret_cast<int*>(ws + kRows * SM);  // [kRows][SM]
  float* lossp = reinterpret_cast<float*>(cs + kRows * SM);  // [kSWarps][kRows][2]
  int* acts = reinterpret_cast<int*>(lossp + 2 * kSWarps * kRows);  // [kRows]

  // the block's rows that are short; a long row is the Gram form's
  if (tid < kRows) {
    const int b = r0 + tid;
    int n = 0;
    int64_t dst = -1;
    if (b < p.B) {
      n = min(p.lens[b], p.L);
      dst = p.rows ? (int64_t)p.rows[b] : p.row_start + b;
    }
    const bool mine = n > 0 && n <= p.short_max && dst >= 0 && dst < p.n_table_rows;
    nrow[tid] = mine ? n : 0;
    drow[tid] = dst;
    acts[tid] = 0;
  }
  __syncthreads();
  bool any = false;
#pragma unroll
  for (int r = 0; r < kRows; ++r) any |= nrow[r] > 0;
  if (!any) return;  // the whole block
  for (int i = tid; i < kRows * DP; i += kSThreads) {
    const int r = i / DP, j = i - r * DP;
    ps[i] = nrow[r] > 0 && j < d ? p.table[drow[r] * d + j] : 0.f;
    xs[i] = 0.f;
  }
  for (int i = tid; i < kRows * SM; i += kSThreads) {
    const int r = i / SM, l = i - r * SM;
    const bool in = l < nrow[r];
    const int64_t e = (int64_t)(r0 + r) * p.L + l;
    cs[i] = in ? p.cols[e] : 0;
    ws[i] = in ? p.alpha * als::load_val(p.vals, e, p.vals_bf16) : 0.f;
  }
  __syncthreads();

  // out[r][m0 + m] = sum_k FF[m0 + m][k0 + k] in[r][k0 + k], m < M, k < K, for
  // the block's rows at once: one 3xTF32 product, M and the rows' 8 columns
  // by K, a warp per m16 tile; FF is read once for all the rows
  auto dense = [&](const float* in, int m0, int M, int k0, int K, float* out) {
    const int g = lane >> 2, t = lane & 3;
    const int MT = (M + 15) / 16, KS = (K + 7) / 8;
    for (int mt = warp; mt < MT; mt += kSWarps) {  // dense
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const int ma = mt * 16 + g, mb = ma + 8;
      const float* fa = p.FF + (int64_t)(m0 + min(ma, M - 1)) * d + k0;
      const float* fb = p.FF + (int64_t)(m0 + min(mb, M - 1)) * d + k0;
      const float* vin = in + g * DP + k0;
#pragma unroll 4
      for (int ks = 0; ks < KS; ++ks) {
        const int ka = ks * 8 + t, kb = ka + 4;
        uint32_t ab[4], as[4], bb[2], bs[2];
        split_tf32(ma < M && ka < K ? __ldg(fa + ka) : 0.f, ab[0], as[0]);
        split_tf32(mb < M && ka < K ? __ldg(fb + ka) : 0.f, ab[1], as[1]);
        split_tf32(ma < M && kb < K ? __ldg(fa + kb) : 0.f, ab[2], as[2]);
        split_tf32(mb < M && kb < K ? __ldg(fb + kb) : 0.f, ab[3], as[3]);
        split_tf32(ka < K ? vin[ka] : 0.f, bb[0], bs[0]);
        split_tf32(kb < K ? vin[kb] : 0.f, bb[1], bs[1]);
        float step[4];
        mma_tf32_first(step, as, bb);
        mma_tf32(step, ab, bs);
        mma_tf32(step, ab, bb);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] += step[e];
      }
      if (ma < M) {
        out[(2 * t) * DP + m0 + ma] = acc[0];
        out[(2 * t + 1) * DP + m0 + ma] = acc[1];
      }
      if (mb < M) {
        out[(2 * t) * DP + m0 + mb] = acc[2];
        out[(2 * t + 1) * DP + m0 + mb] = acc[3];
      }
    }
  };

  const float reg = p.reg;
  const int nblk = (d + p.bs - 1) / p.bs;
  int pbeg = 0, pbs = 0;  // the previous block
  // warp `warp` keeps its row's CG vectors: element j = lane + 32 i
  float rv[kC], xv[kC], pv[kC];
  float rsold = 0.f;
  for (int blk = 0; blk < nblk; ++blk) {
    const int beg = blk * p.bs, bs = min(p.bs, d - beg);
    const bool first = blk == 0;
    // ---- FF[blk, :] p (all of FF p for the first block: the loss's p FF p)
    dense(ps, first ? 0 : beg, first ? d : bs, 0, d, qs);
    // ---- Yui (first block: p . F_l with the loss terms; later: less the
    // previous block's F_l . x) and the entries' part of b, one pass
    for (int r = 0; r < kRows; ++r) {
      const int n = nrow[r];
      if (n == 0) continue;
      float acc[kC];
#pragma unroll
      for (int i = 0; i < kC; ++i) acc[i] = 0.f;
      float pos = 0.f, wsum = 0.f;
#pragma unroll 2
      for (int l = warp; l < n; l += kSWarps) {
        const float* f = p.Bf + (int64_t)cs[r * SM + l] * d;
        const float w = ws[r * SM + l];
        float fv[kC], x = 0.f;
#pragma unroll
        for (int i = 0; i < kC; ++i) {
          const int c = lane + 32 * i;
          fv[i] = c < d ? __ldg(f + c) : 0.f;
          if (first) x = fmaf(fv[i], c < d ? ps[r * DP + c] : 0.f, x);
          else if (c >= pbeg && c < pbeg + pbs) x = fmaf(fv[i], xs[r * DP + c], x);
        }
        float s = als::warp_sum(x);
        if (first) {
          pos += -s * s + (s - 1.f) * (s - 1.f) * (1.f + w);
          wsum += w;
        } else {
          s = Yui[r * SM + l] - s;
        }
        if (lane == 0) Yui[r * SM + l] = s;
        const float gl = (s - 1.f) * w;
#pragma unroll
        for (int i = 0; i < kC; ++i) acc[i] = fmaf(gl, fv[i], acc[i]);
      }
      float* pw = part + (warp * kRows + r) * DP;
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        const int j = lane + 32 * i - beg;
        if (j >= 0 && j < bs) pw[j] = acc[i];
      }
      if (lane == 0 && first) {
        lossp[2 * (warp * kRows + r)] = pos;
        lossp[2 * (warp * kRows + r) + 1] = wsum;
      }
    }
    __syncthreads();

    // ---- warp r: b, the loss terms (first block), the CG start
    const int me = warp, n_me = nrow[me];
    bool active = false;
    if (n_me > 0) {
      float rr = 0.f;
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        const int j = lane + 32 * i;
        float b = 0.f;
        if (j < bs) {
          float data = 0.f;
          for (int w = 0; w < kSWarps; ++w) data += part[(w * kRows + me) * DP + j];
          b = qs[me * DP + beg + j] + reg * ps[me * DP + beg + j] + data;
          vs[me * DP + beg + j] = b;
        }
        rv[i] = b;
        xv[i] = 0.f;
        pv[i] = b;
        rr += b * b;
      }
      rsold = als::warp_sum(rr);
      active = rsold >= p.cg_tol;
      if (lane == 0) acts[me] = active;
      if (first && p.compute_loss) {
        float sq = 0.f, pffp = 0.f;
#pragma unroll
        for (int i = 0; i < kC; ++i) {
          const int c = lane + 32 * i;
          if (c < d) {
            const float pc = ps[me * DP + c];
            sq += pc * pc;
            pffp += pc * qs[me * DP + c];
          }
        }
        float pos = 0.f, wsum = 0.f;
        for (int w = 0; w < kSWarps; ++w) {
          pos += lossp[2 * (w * kRows + me)];
          wsum += lossp[2 * (w * kRows + me) + 1];
        }
        const float reg_ada = reg * (p.adaptive_reg ? (float)n_me : 1.f);
        float nu = reg_ada * als::warp_sum(sq), de = 0.f;
        if (p.item_axis) {
          nu += als::warp_sum(pffp) + pos;
          de = p.num_fixed_rows + wsum;
        }
        if (lane == 0) {
          p.nume[r0 + me] = nu;
          p.deno[r0 + me] = de;
        }
      }
    }

    // ---- 3 CG steps from x = 0, r = b in lockstep over the rows, each
    // freezing by itself (solve.py cg_loop's rule)
    for (int it = 0; it < kSteps; ++it) {
      if (!__syncthreads_or(active)) break;  // vs and acts are written
      dense(vs, beg, bs, beg, bs, qs);
      for (int r = 0; r < kRows; ++r) {
        const int n = nrow[r];
        if (n == 0 || !acts[r]) continue;
        float acc[kC];
#pragma unroll
        for (int i = 0; i < kC; ++i) acc[i] = 0.f;
#pragma unroll 2
        for (int q = warp; q < n; q += kSWarps) {  // entries
          const float* f = p.Bf + (int64_t)cs[r * SM + q] * d + beg;
          float fv[kC], x = 0.f;
#pragma unroll
          for (int i = 0; i < kC; ++i) {
            const int j = lane + 32 * i;
            fv[i] = j < bs ? __ldg(f + j) : 0.f;
            x = fmaf(fv[i], j < bs ? vs[r * DP + beg + j] : 0.f, x);
          }
          const float gl = als::warp_sum(x) * ws[r * SM + q];
#pragma unroll
          for (int i = 0; i < kC; ++i) acc[i] = fmaf(gl, fv[i], acc[i]);
        }
        float* pw = part + (warp * kRows + r) * DP;
#pragma unroll
        for (int i = 0; i < kC; ++i) {
          const int j = lane + 32 * i;
          if (j < bs) pw[j] = acc[i];
        }
      }
      __syncthreads();
      if (active) {
        float Ap[kC], pAp = 0.f;
#pragma unroll
        for (int i = 0; i < kC; ++i) {
          const int j = lane + 32 * i;
          Ap[i] = 0.f;
          if (j < bs) {
            float data = 0.f;
            for (int w = 0; w < kSWarps; ++w) data += part[(w * kRows + me) * DP + j];
            Ap[i] = qs[me * DP + beg + j] + reg * pv[i] + data;
          }
          pAp += pv[i] * Ap[i];
        }
        const float alpha = rsold / fmaxf(als::warp_sum(pAp), 1e-30f);
        float rr = 0.f;
#pragma unroll
        for (int i = 0; i < kC; ++i) {
          xv[i] += alpha * pv[i];
          rv[i] -= alpha * Ap[i];
          rr += rv[i] * rv[i];
        }
        const float rsnew = als::warp_sum(rr);
        active = rsnew >= p.cg_tol;
        const float beta = rsold > 0.f ? rsnew / fmaxf(rsold, 1e-30f) : 0.f;
#pragma unroll
        for (int i = 0; i < kC; ++i) {
          const int j = lane + 32 * i;
          pv[i] = rv[i] + beta * pv[i];
          if (j < bs) vs[me * DP + beg + j] = pv[i];
        }
        rsold = rsnew;
      }
      if (lane == 0 && n_me > 0) acts[me] = active;
    }
    __syncthreads();  // every warp is past the step's reads of vs and qs

    // ---- p_blk -= x, x kept for the next block's Yui update
    if (n_me > 0) {
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        const int j = lane + 32 * i;
        if (j < bs) {
          ps[me * DP + beg + j] -= xv[i];
          xs[me * DP + beg + j] = xv[i];
        }
      }
    }
    pbeg = beg;
    pbs = bs;
    __syncthreads();
  }
  if (nrow[warp] > 0)
    for (int c = lane; c < d; c += 32) p.table[drow[warp] * d + c] = ps[warp * DP + c];
}

// ------------------------------------------------------------- Gram form
constexpr int kGThreads = 512;
constexpr int kGWarps = kGThreads / 32;
constexpr int kTL = 64;     // entries per ring stage (8 MMA k-steps)
constexpr int kStages = 2;  // ring depth
constexpr int kFlush = 4;   // stages summed in registers between flushes
constexpr int kMaxUPW = 6;  // units per warp: at most 96 units, d <= 176

// (m16 row, n8 column) of tile `tile` of the upper block triangle, row-major
__device__ __forceinline__ void tile_mn(int tile, int NTn, int& mi, int& ni) {
  mi = 0;
  while (tile >= NTn - 2 * mi) tile -= NTn - 2 * mi++;
  ni = 2 * mi + tile;
}

__host__ __device__ constexpr size_t gram_floats(int R0, int EG, int TT, int NP) {
  return (size_t)R0 + 3 * kStages * kTL + (size_t)EG * TT * 128 + 6 * (size_t)NP +
         2 * kGWarps + 33;
}

template <int kUPW>
__global__ void __launch_bounds__(kGThreads, 1) ialspp_gram(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / p.maxP, piece = blockIdx.x - b * p.maxP;
  const int n_row = min(p.lens[b], p.L);
  const int64_t dst = p.rows ? (int64_t)p.rows[b] : p.row_start + b;
  // short rows are the short form's; padding and ids outside the table skip
  if (n_row <= p.gram_min || dst < 0 || dst >= p.n_table_rows) return;  // the whole block
  // a row of more than PL entries is split into pieces of PL, one block
  // each: this block's entries [e0, e0 + n)
  const int pieces = (n_row + p.PL - 1) / p.PL, e0 = piece * p.PL;
  if (piece >= pieces) return;
  const int n = min(p.PL, n_row - e0);
  const int d = p.d, S = p.GS, AS = d + 1;
  float* Fs = smem;                           // [kStages][kTL][S] the ring
  float* As = smem;                           // [d][d + 1] A, over the consumed ring
  float* vst = smem + p.R0;                   // [kStages][kTL] values
  float* gst = vst + kStages * kTL;           // [kStages][kTL] (Yui - 1) w
  int32_t* cs = reinterpret_cast<int32_t*>(gst + kStages * kTL);  // [kStages][kTL]
  float* tot = reinterpret_cast<float*>(cs + kStages * kTL);      // [EG][TT][128]
  float* ps = tot + p.EG * p.TT * 128;        // [NP] p, updated per block
  float* p0 = ps + p.NP;                      // [NP] the pre-update p
  float* ev = p0 + p.NP;                      // [NP] e = F^T ((Yui - 1) w)
  float* qv = ev + p.NP;                      // [NP] FF p0
  float* vs = qv + p.NP;                      // [NP] the CG direction
  float* Av = vs + p.NP;                      // [NP] products with A's rows
  float* lossw = Av + p.NP;                   // [kGWarps][2] the warps' loss sums
  float* scratch = lossw + 2 * kGWarps;       // [33]

  for (int j = tid; j < p.NP; j += kGThreads) {
    const float v = j < d ? p.table[dst * d + j] : 0.f;
    ps[j] = v;
    p0[j] = v;
  }
  // columns past d, never written by the gather: a ones column (d, whose
  // products weighted by (Yui - 1) w give e), then zeros
  const int extra = S - d;
  for (int i = tid; i < kStages * kTL * extra; i += kGThreads) {
    const int r = i / extra, c = d + (i - r * extra);
    Fs[r * S + c] = c == d ? 1.f : 0.f;
  }
  for (int i = tid; i < p.EG * p.TT * 128; i += kGThreads) tot[i] = 0.f;

  // ---- one pass over the entries: Yui = F p0 with the loss terms, then
  // G's upper block triangle and e on the tensor cores (K2's ring)
  const int64_t base = (int64_t)b * p.L + e0;
  const int32_t* cb = p.cols + base;
  const float* vb = static_cast<const float*>(p.vals) + base;
  const int ntiles = (n + kTL - 1) / kTL;
  auto col_of = [&](int tile) {
    const int e = tile * kTL + tid;
    return (tid < kTL && e < n) ? __ldg(cb + e) : -1;
  };
  const int W = p.vec ? 4 : 1, ncopy = kTL * p.nchunk;
  auto issue = [&](int tile) {
    if (tile < ntiles) {
      const int st = tile % kStages;
      float* Fst = Fs + st * kTL * S;
      const int32_t* cst = cs + st * kTL;
      for (int q = tid; q < ncopy; q += kGThreads) {
        const int l = __umulhi((unsigned)q, p.magic), c = (q - l * p.nchunk) * W;
        const int col = cst[l];
        const float* from = col >= 0 ? p.Bf + (int64_t)col * d + c : p.Bf;
        if (p.vec) cp_async16(Fst + l * S + c, from, col >= 0);
        else cp_async4(Fst + l * S + c, from, col >= 0);
      }
      if (tid < kTL) {
        const int e = tile * kTL + tid;
        if (p.vals_bf16)
          vst[st * kTL + tid] = e < n ? als::load_val(p.vals, base + e, true) : 0.f;
        else
          cp_async4(vst + st * kTL + tid, e < n ? vb + e : vb, e < n);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < kStages; ++s)
    if (tid < kTL) cs[s * kTL + tid] = col_of(s);
  int col_next = col_of(kStages);
  __syncthreads();
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  // this warp's units and k-steps.  A unit is a 16 x 16 block (mi, nj) of
  // the upper block triangle: two m16n8 tiles that share their A fragment.
  // A warp holds kUPW units from u0 (slots past the triangle are skipped, a
  // branch the same on all of the warp's lanes).
  const int eg = warp % p.EG;
  const int g = lane >> 2, t = lane & 3;
  const int u0 = (warp / p.EG) * kUPW;
  int aoff[kUPW], boff[kUPW], tile0[kUPW];
  bool ecol[kUPW][2];  // B column d: weighted by (Yui - 1) w, not w
  bool newa[kUPW];     // the unit's A fragment differs from the one before
#pragma unroll
  for (int uu = 0; uu < kUPW; ++uu) {
    int mi = 0, nj = 0;
    if (u0 + uu < p.NU) unit_mn(u0 + uu, p.MT, mi, nj);
    newa[uu] = uu == 0 || mi * 16 != aoff[uu > 0 ? uu - 1 : 0];
    aoff[uu] = mi * 16;
    boff[uu] = nj * 16;
    tile0[uu] = mi * p.NTn - mi * (mi - 1) + 2 * (nj - mi);
#pragma unroll
    for (int h = 0; h < 2; ++h) ecol[uu][h] = nj * 16 + h * 8 + g == d;
  }
  float acc[kUPW][2][4];
#pragma unroll
  for (int uu = 0; uu < kUPW; ++uu)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[uu][e >> 2][e & 3] = 0.f;
  auto flush = [&]() {
#pragma unroll
    for (int uu = 0; uu < kUPW; ++uu) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (u0 + uu < p.NU) {
          float4* to =
              reinterpret_cast<float4*>(tot + ((eg * p.TT + tile0[uu] + h) * 128 + lane * 4));
          float4 v = *to;
          v.x += acc[uu][h][0];
          v.y += acc[uu][h][1];
          v.z += acc[uu][h][2];
          v.w += acc[uu][h][3];
          *to = v;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[uu][h][e] = 0.f;
      }
    }
  };

  float pos = 0.f, wsum = 0.f;  // this warp's entries' loss sums
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile i landed
    __syncthreads();               // everyone's did; stage i-1 is consumed
    issue(i + kStages - 1);
    if (tid < kTL) cs[(i % kStages) * kTL + tid] = col_next;  // tile i + kStages
    col_next = col_of(i + kStages + 1);

    const int st = i % kStages, tl = min(kTL, n - i * kTL);
    const float* Fst = Fs + st * kTL * S;
    const float* vq = vst + st * kTL;
    float* gq = gst + st * kTL;
    // Yui_l = F_l . p0 by a warp per entry (lanes on the features, a fixed
    // butterfly); padding entries get weight 0
    for (int l = warp; l < kTL; l += kGWarps) {
      float x = 0.f;
      for (int k = lane; k < d; k += 32) x = fmaf(Fst[l * S + k], p0[k], x);
      const float s = als::warp_sum(x), w = p.alpha * vq[l];
      if (l < tl) {
        pos += -s * s + (s - 1.f) * (s - 1.f) * (1.f + w);
        wsum += w;
      }
      if (lane == 0) gq[l] = l < tl ? (s - 1.f) * w : 0.f;
    }
    __syncthreads();
    for (int ks = eg; ks * 8 < tl; ks += p.EG) {
      const int l0 = ks * 8;
      const float w0 = p.alpha * vq[l0 + t], w1 = p.alpha * vq[l0 + t + 4];
      const float g0 = gq[l0 + t], g1 = gq[l0 + t + 4];
      const float* r0 = Fst + (l0 + t) * S + g;  // entry l0 + t, feature g
      const float* r1 = r0 + 4 * S;               // entry l0 + t + 4
      uint32_t ab[4], as[4];  // kept while consecutive units share their rows
#pragma unroll
      for (int uu = 0; uu < kUPW; ++uu) {
        if (u0 + uu >= p.NU) break;  // the warp's slots past the triangle
        if (newa[uu]) {
          split_tf32(r0[aoff[uu]], ab[0], as[0]);
          split_tf32(r0[aoff[uu] + 8], ab[1], as[1]);
          split_tf32(r1[aoff[uu]], ab[2], as[2]);
          split_tf32(r1[aoff[uu] + 8], ab[3], as[3]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = boff[uu] + 8 * h;
          uint32_t bb[2], bs[2];
          split_tf32(r0[c] * (ecol[uu][h] ? g0 : w0), bb[0], bs[0]);
          split_tf32(r1[c] * (ecol[uu][h] ? g1 : w1), bb[1], bs[1]);
          float step[4];
          mma_tf32_first(step, as, bb);
          mma_tf32(step, ab, bs);
          mma_tf32(step, ab, bb);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[uu][h][e] += step[e];
        }
      }
    }
    if ((i + 1) % kFlush == 0) flush();
  }
  flush();
  cp_async_wait<0>();
  if (lane == 0) {
    lossw[2 * warp] = pos;
    lossw[2 * warp + 1] = wsum;
  }
  __syncthreads();

  // ---- a split row: each piece writes its sums (entry groups added in
  // group order, the warps' loss sums in warp order); the row's last piece
  // to finish (an integer count) adds them in piece order and goes on
  if (pieces > 1) {
    __shared__ int last;
    const int nt = 2 * p.NU * 128;
    float* mine = p.gws + ((int64_t)b * p.maxP + piece) * p.WSZ;
    for (int i = tid; i < nt; i += kGThreads) {
      float v = tot[i];
      for (int gg = 1; gg < p.EG; ++gg) v += tot[gg * p.TT * 128 + i];
      mine[i] = v;
    }
    if (tid == 0) {
      float ps_ = 0.f, ws_ = 0.f;
      for (int w = 0; w < kGWarps; ++w) {
        ps_ += lossw[2 * w];
        ws_ += lossw[2 * w + 1];
      }
      mine[nt] = ps_;
      mine[nt + 1] = ws_;
    }
    __threadfence();  // the partials before the count
    __syncthreads();
    if (tid == 0) last = atomicAdd(p.gcnt + b, 1) == pieces - 1;
    __syncthreads();
    if (!last) return;  // the whole block
    __threadfence();
    const float* all = p.gws + (int64_t)b * p.maxP * p.WSZ;
    for (int i = tid; i < p.EG * p.TT * 128; i += kGThreads) {
      float v = 0.f;
      if (i < nt)
        for (int q = 0; q < pieces; ++q) v += __ldcg(all + (int64_t)q * p.WSZ + i);
      tot[i] = v;
    }
    if (tid == 0) {
      float ps_ = 0.f, ws_ = 0.f;
      for (int q = 0; q < pieces; ++q) {
        ps_ += __ldcg(all + (int64_t)q * p.WSZ + nt);
        ws_ += __ldcg(all + (int64_t)q * p.WSZ + nt + 1);
      }
      for (int w = 0; w < 2 * kGWarps; ++w) lossw[w] = 0.f;
      lossw[0] = ps_;
      lossw[1] = ws_;
    }
    __syncthreads();
  }

  // ---- entry groups added in group order, G mirrored from its upper
  // triangle into A over the ring (row stride d + 1 spreads the mirrored
  // writes over the banks), e from column d
  for (int lt = warp; lt < 2 * p.NU; lt += kGWarps) {
    int mi, ni;
    tile_mn(lt, p.NTn, mi, ni);
    float4 v = *reinterpret_cast<const float4*>(tot + lt * 128 + lane * 4);
    for (int gg = 1; gg < p.EG; ++gg) {
      const float4 u = *reinterpret_cast<const float4*>(tot + (gg * p.TT + lt) * 128 + lane * 4);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    const float vr[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = mi * 16 + g + (r >= 2 ? 8 : 0), k = ni * 8 + 2 * t + (r & 1);
      if (j > k || j >= d || k > d) continue;
      if (k < d) {
        As[j * AS + k] = vr[r];
        As[k * AS + j] = vr[r];
      } else {
        ev[j] = vr[r];
      }
    }
  }
  __syncthreads();
  // A = FF + reg I + G; q = FF p0, a warp per row of FF
  for (int e = tid; e < d * d; e += kGThreads) {
    const int j = e / d, k = e - j * d;
    As[j * AS + k] += __ldg(p.FF + e) + (j == k ? p.reg : 0.f);
  }
  for (int j = warp; j < d; j += kGWarps) {
    float x = 0.f;
    for (int k = lane; k < d; k += 32) x = fmaf(__ldg(p.FF + (int64_t)j * d + k), p0[k], x);
    x = als::warp_sum(x);
    if (lane == 0) qv[j] = x;
  }
  __syncthreads();

  // out[jj] = A[j0 + jj, k0:k0 + kl] . v[0:kl], a warp per row of A
  auto rows_dot = [&](int j0, int nr, int k0, int kl, const float* v, float* out) {
    for (int jj = warp; jj < nr; jj += kGWarps) {
      const float* a = As + (j0 + jj) * AS + k0;
      float s = 0.f;
      for (int k = lane; k < kl; k += 32) s = fmaf(a[k], v[k], s);
      s = als::warp_sum(s);
      if (lane == 0) out[jj] = s;
    }
  };

  // ---- the loss terms of the pre-update p: reg_ada |p|^2, on the item axis
  // + p FF p + the entries' sum of -(Yui)^2 + (Yui - 1)^2 (1 + w)
  if (p.compute_loss) {
    float sq = 0.f, pq = 0.f;
    for (int j = tid; j < d; j += kGThreads) {
      sq += p0[j] * p0[j];
      pq += p0[j] * qv[j];
    }
    const float reg_ada = p.reg * (p.adaptive_reg ? (float)n_row : 1.f);
    float nu = reg_ada * als::block_sum(sq, scratch), de = 0.f;
    const float pqs = als::block_sum(pq, scratch);
    if (p.item_axis) {
      float pos_all = 0.f, w_all = 0.f;
      for (int w = 0; w < kGWarps; ++w) {
        pos_all += lossw[2 * w];
        w_all += lossw[2 * w + 1];
      }
      nu += pqs + pos_all;
      de = p.num_fixed_rows + w_all;
    }
    if (tid == 0) {
      p.nume[b] = nu;
      p.deno[b] = de;
    }
  }

  const int nblk = (d + p.bs - 1) / p.bs, j = tid;
  for (int blk = 0; blk < nblk; ++blk) {  // gram
    const int beg = blk * p.bs, bs = min(p.bs, d - beg);
    // ---- b = FF[blk, :] p0 + reg p_blk + e[blk] + A[blk, :beg] (p - p0)[:beg]:
    // the cache's Yui = F p folded in through G (the earlier blocks moved)
    if (beg > 0) {
      if (j < beg) vs[j] = ps[j] - p0[j];
      __syncthreads();
      rows_dot(beg, bs, 0, beg, vs, Av);
      __syncthreads();
    }
    float r = 0.f, x = 0.f, pv = 0.f;
    if (j < bs) {
      r = qv[beg + j] + p.reg * ps[beg + j] + ev[beg + j] + (beg > 0 ? Av[j] : 0.f);
      pv = r;
    }
    __syncthreads();  // Av and vs are read before they are written again
    if (j < bs) vs[j] = pv;
    float rsold = als::block_sum(r * r, scratch);
    bool active = rsold >= p.cg_tol;
    // ---- 3 CG steps from x = 0, r = b on A[blk, blk] (solve.py cg_loop's
    // freeze rule)
    for (int it = 0; it < kSteps && active; ++it) {
      rows_dot(beg, bs, beg, bs, vs, Av);
      __syncthreads();
      const float Ap = j < bs ? Av[j] : 0.f;
      const float alpha = rsold / fmaxf(als::block_sum(pv * Ap, scratch), 1e-30f);
      x += alpha * pv;
      r -= alpha * Ap;
      const float rsnew = als::block_sum(r * r, scratch);
      active = rsnew >= p.cg_tol;
      const float beta = rsold > 0.f ? rsnew / fmaxf(rsold, 1e-30f) : 0.f;
      pv = r + beta * pv;
      if (j < bs) vs[j] = pv;
      __syncthreads();
      rsold = rsnew;
    }
    if (j < bs) ps[beg + j] -= x;
    __syncthreads();
  }
  for (int c = tid; c < d; c += kGThreads) p.table[dst * d + c] = ps[c];
}

// ------------------------------------------------------------- wide form
constexpr int kThreads = 256;  // 8 warps; thread j owns feature j of a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxM = 32;      // features per thread: block_size <= 8192

// shared memory of a launch, in floats
__host__ __device__ constexpr size_t smem_floats(int T, int S, int d, int L) {
  return (size_t)T * S + 2 * round4(d) + round4(L) + 3 * round4(T) + 33;
}

// kM features of a block per thread: thread j owns features j + m kThreads,
// m < kM (1 for block sizes up to kThreads; wider blocks, iALS++'s default
// block_size = d past 256, take the wider instantiations).
template <int kM>
__global__ void __launch_bounds__(kThreads) ialspp_tile(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = min(p.lens[b], p.L);
  const int64_t dst = p.rows ? (int64_t)p.rows[b] : p.row_start + b;
  // rows of the other classes, padding and ids outside the table skip
  if (n <= p.short_max || n > p.gram_min || dst < 0 || dst >= p.n_table_rows)
    return;  // the whole block
  const int d = p.d, S = p.S, T = p.T;
  float* Fs = smem;                                  // [T][S] the tile's F rows
  float* ps = Fs + (size_t)T * S;                    // [d]    p, updated per block
  float* vs = ps + round4(d);                        // [bs]   CG direction, then x
  float* Yui = vs + round4(d);                       // [YL]   p . F_l
  float* ws = Yui + round4(p.YL);                    // [T]    the tile's w
  float* gs = ws + round4(T);                        // [T]    per-entry scalars
  int* cs = reinterpret_cast<int*>(gs + round4(T));  // [T]    the tile's cols
  float* scratch = reinterpret_cast<float*>(cs + round4(T));  // [33]

  const int64_t base = (int64_t)b * p.L;
  const int ntiles = (n + T - 1) / T;
  const bool resident = ntiles == 1;
  const int KC = p.vec ? d / 4 : d;  // copies per row
  auto load_tile = [&](int t0, int tl) {
    __syncthreads();  // nobody reads the previous tile, ws or gs any more
    for (int i = tid; i < tl; i += kThreads) {
      cs[i] = p.cols[base + t0 + i];
      ws[i] = p.alpha * als::load_val(p.vals, base + t0 + i, p.vals_bf16);
    }
    __syncthreads();
    for (int q = tid; q < tl * KC; q += kThreads) {
      const int l = q / KC, c = q - l * KC;
      const float* src = p.Bf + (int64_t)cs[l] * d;
      if (p.vec) als::cp_async16(Fs + l * S + 4 * c, src + 4 * c, true);
      else als::cp_async4(Fs + l * S + c, src + c, true);
    }
    als::cp_async_commit();
    als::cp_async_wait_all();
    __syncthreads();
  };
  // body(t0, tl) on the row's entries a tile at a time (each body ends with
  // a barrier); a row of one tile keeps it for the whole solve
  auto tiles = [&](auto&& body) {
    for (int t = 0; t < ntiles; ++t) {
      const int t0 = t * T;
      if (!resident) load_tile(t0, min(T, n - t0));
      body(t0, min(T, n - t0));
    }
  };
  // use(l, F_l[beg, beg + len) . v) for the tile's entries: warp w takes
  // entries w, w + 8, ...; the butterfly gives every lane the same bits
  auto dot_rows = [&](int tl, int beg, int len, const float* v, auto&& use) {
    for (int l = warp; l < tl; l += kWarps) {
      const float* f = Fs + l * S + beg;
      float s = 0.f;
      for (int k = lane; k < len; k += 32) s = fmaf(f[k], v[k], s);
      use(l, als::warp_sum(s));
    }
  };
  // sum over the tile's entries of gs[l] F_l[beg + j], in entry order
  auto sum_rows = [&](int tl, int beg, int j) {
    float s = 0.f;
    for (int l = 0; l < tl; ++l) s = fmaf(gs[l], Fs[l * S + beg + j], s);
    return s;
  };

  if (resident) load_tile(0, n);
  for (int j = tid; j < d; j += kThreads) ps[j] = p.table[dst * d + j];
  __syncthreads();

  // ---- Yui = p . F_l, with the entry sums of the loss (pre-update p)
  float pos = 0.f, wsum = 0.f;  // this warp's share, the same on all its lanes
  tiles([&](int t0, int tl) {
    dot_rows(tl, 0, d, ps, [&](int l, float s) {
      if (lane == 0) Yui[t0 + l] = s;
      pos += -s * s + (s - 1.f) * (s - 1.f) * (1.f + ws[l]);
      wsum += ws[l];
    });
    __syncthreads();
  });
  if (p.compute_loss) {
    float sq = 0.f, pffp = 0.f;
    for (int j = tid; j < d; j += kThreads) {
      sq += ps[j] * ps[j];
      if (p.item_axis) {
        float q = 0.f;
        for (int k = 0; k < d; ++k) q = fmaf(ps[k], __ldg(p.FF + (int64_t)k * d + j), q);
        pffp += ps[j] * q;
      }
    }
    const float reg_ada = p.reg * (p.adaptive_reg ? (float)n : 1.f);
    float nu = reg_ada * als::block_sum(sq, scratch), de = 0.f;
    if (p.item_axis) {
      nu += als::block_sum(pffp, scratch) + als::block_sum(lane == 0 ? pos : 0.f, scratch);
      de = p.num_fixed_rows + als::block_sum(lane == 0 ? wsum : 0.f, scratch);
    }
    if (tid == 0) {
      p.nume[b] = nu;
      p.deno[b] = de;
    }
  }

  const int nblk = (d + p.bs - 1) / p.bs;
  for (int blk = 0; blk < nblk; ++blk) {
    const int beg = blk * p.bs, bs = min(p.bs, d - beg);

    // ---- b = p FF[:, blk] + reg p_blk + sum_l (Yui_l - 1) w_l F_l[blk]
    float dense[kM], data[kM];
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const int j = tid + m * kThreads;
      dense[m] = data[m] = 0.f;
      if (j < bs) {  // thread tid holds feature beg + j of the block
        for (int k = 0; k < d; ++k)
          dense[m] = fmaf(ps[k], __ldg(p.FF + (int64_t)k * d + beg + j), dense[m]);
        dense[m] += p.reg * ps[beg + j];
      }
    }
    tiles([&](int t0, int tl) {
      for (int l = tid; l < tl; l += kThreads) gs[l] = (Yui[t0 + l] - 1.f) * ws[l];
      __syncthreads();
#pragma unroll
      for (int m = 0; m < kM; ++m)
        if (tid + m * kThreads < bs) data[m] += sum_rows(tl, beg, tid + m * kThreads);
      __syncthreads();
    });

    // ---- 3 CG steps from x = 0, r = b (solve.py cg_loop's freeze rule)
    float r[kM], x[kM], pv[kM];
    float rr = 0.f;
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const int j = tid + m * kThreads;
      r[m] = j < bs ? dense[m] + data[m] : 0.f;
      x[m] = 0.f;
      pv[m] = r[m];
      if (j < bs) vs[j] = pv[m];
      rr += r[m] * r[m];
    }
    float rsold = als::block_sum(rr, scratch);
    bool active = rsold >= p.cg_tol;
    for (int it = 0; it < kSteps && active; ++it) {
      // A pv = pv (FF[blk, blk] + reg I) + F[:, blk]^T (w * F[:, blk] pv);
      // FF is symmetric, so column j is read down a column (coalesced)
      float Ap[kM], acc[kM];
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const int j = tid + m * kThreads;
        Ap[m] = acc[m] = 0.f;
        if (j < bs) {
          for (int i = 0; i < bs; ++i)
            Ap[m] = fmaf(vs[i], __ldg(p.FF + (int64_t)(beg + i) * d + beg + j), Ap[m]);
          Ap[m] += p.reg * pv[m];
        }
      }
      tiles([&](int t0, int tl) {
        dot_rows(tl, beg, bs, vs, [&](int l, float s) {
          if (lane == 0) gs[l] = s * ws[l];
        });
        __syncthreads();
#pragma unroll
        for (int m = 0; m < kM; ++m)
          if (tid + m * kThreads < bs) acc[m] += sum_rows(tl, beg, tid + m * kThreads);
        __syncthreads();
      });
      float pAp = 0.f;
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        Ap[m] += acc[m];
        pAp += pv[m] * Ap[m];
      }
      const float alpha = rsold / fmaxf(als::block_sum(pAp, scratch), 1e-30f);
      rr = 0.f;
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        x[m] += alpha * pv[m];
        r[m] -= alpha * Ap[m];
        rr += r[m] * r[m];
      }
      const float rsnew = als::block_sum(rr, scratch);
      active = rsnew >= p.cg_tol;
      const float beta = rsold > 0.f ? rsnew / fmaxf(rsold, 1e-30f) : 0.f;
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        pv[m] = r[m] + beta * pv[m];
        if (tid + m * kThreads < bs) vs[tid + m * kThreads] = pv[m];
      }
      __syncthreads();
      rsold = rsnew;
    }

    // ---- p_blk -= x; Yui -= F[:, blk] x (not needed after the last block)
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const int j = tid + m * kThreads;
      if (j < bs) {
        ps[beg + j] -= x[m];
        vs[j] = x[m];
      }
    }
    __syncthreads();
    if (blk + 1 < nblk)
      tiles([&](int t0, int tl) {
        dot_rows(tl, beg, bs, vs, [&](int l, float s) {
          if (lane == 0) Yui[t0 + l] -= s;
        });
        __syncthreads();
      });
  }
  for (int j = tid; j < d; j += kThreads) p.table[dst * d + j] = ps[j];
}

}  // namespace

// Features of a block per thread in the wide form (1 for block sizes up to
// 256).
extern "C" int ialspp_features_per_thread(int block_size) {
  return (block_size + kThreads - 1) / kThreads;
}

namespace {

// The Gram form's tiling for rows of d floats; false where its shared
// memory or its unit slots do not hold the system.
bool plan_gram(Params& p) {
  const int d = p.d;
  p.NP = (d + 1 + 15) / 16 * 16;
  p.GS = p.NP + 8;  // NP is 0 or 16 (mod 32)
  p.NTn = p.NP / 8;
  p.MT = p.NP / 16;
  p.NU = p.MT * (p.MT + 1) / 2;
  // the warps split into EG entry groups, each covering every unit: the
  // fewest empty unit slots, then the fewest groups
  int best = -1, upw_best = 0;
  for (int eg = 1; eg <= kGWarps; eg *= 2) {
    const int wpg = kGWarps / eg, upw = (p.NU + wpg - 1) / wpg;
    if (upw > kMaxUPW) continue;
    const int waste = upw * wpg - p.NU;
    if (best < 0 || waste < best) {
      best = waste;
      p.EG = eg;
      upw_best = upw;
    }
  }
  if (best < 0) return false;
  p.TT = 2 * p.NU;
  const int ring = kStages * kTL * p.GS, a = d * (d + 1);
  p.R0 = round4(ring > a ? ring : a);
  p.vec = d % 4 == 0 && (reinterpret_cast<uintptr_t>(p.Bf) & 15) == 0;
  p.nchunk = p.vec ? d / 4 : d;
  p.magic = 0xffffffffu / (uint32_t)p.nchunk + 1u;
  p.UPW = upw_best;
  return sizeof(float) * gram_floats(p.R0, p.EG, p.TT, p.NP) <= als::kMaxSmem;
}

int short_cols(int d) {
  const int c = (d + 31) / 32;
  return c <= 1 ? 1 : c <= 2 ? 2 : c <= 4 ? 4 : c <= 6 ? 6 : 0;
}

// The new forms take rows of d floats when both fit; else the wide form.
bool new_forms(Params& p) { return short_cols(p.d) > 0 && plan_gram(p); }

constexpr int kMinPiece = 8 * kTL;  // the shortest piece of a split row

// The Gram form's pieces for a batch of B rows of length up to L: blocks
// enough for four waves of the card's SMs where B rows are fewer (so that
// the last wave's idle share is small), pieces of at least kMinPiece
// entries.  A function of (B, L) and the card only, so
// two launches split a row alike.
void plan_pieces(Params& p) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int want = (4 * sms + p.B - 1) / p.B, most = (p.L + kMinPiece - 1) / kMinPiece;
  p.maxP = want < most ? want : most;
  if (p.maxP < 1) p.maxP = 1;
  p.PL = ((p.L + p.maxP - 1) / p.maxP + kTL - 1) / kTL * kTL;
  p.maxP = (p.L + p.PL - 1) / p.PL;
  p.WSZ = 2 * p.NU * 128 + 2;
}

size_t plan_short(Params& p) {
  p.DP = (p.d + 31) / 32 * 32 + 4;
  const int sm = p.short_max < p.L ? p.short_max : p.L;
  p.SM = round4(sm > 1 ? sm : 1);
  return sizeof(float) * short_floats(p.DP, p.SM);
}

template <class F>
cudaError_t with_short(int d, F&& f) {
  switch (short_cols(d)) {
    case 1: return f(ialspp_short<1>);
    case 2: return f(ialspp_short<2>);
    case 4: return f(ialspp_short<4>);
    default: return f(ialspp_short<6>);
  }
}

template <class F>
cudaError_t with_gram(int upw, F&& f) {
  switch (upw) {
    case 1: return f(ialspp_gram<1>);
    case 2: return f(ialspp_gram<2>);
    case 3: return f(ialspp_gram<3>);
    case 4: return f(ialspp_gram<4>);
    case 5: return f(ialspp_gram<5>);
    default: return f(ialspp_gram<6>);
  }
}

int blocks_per_sm(const void* kernel, int threads, size_t smem) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem) != cudaSuccess)
    return -1;
  return n;
}

// The tile form's tile for rows of at most YL entries: entries and shared
// memory in bytes (0 where a tile of one entry does not fit).
size_t plan_tile(Params& p) {
  p.S = round4(p.d);
  p.vec = p.d % 4 == 0 && (reinterpret_cast<uintptr_t>(p.Bf) & 15) == 0;
  // the largest tile that fits (each of its three per-entry arrays rounds up
  // by at most 3 floats), at most the longest row it takes
  const size_t budget = als::kMaxSmem / sizeof(float), fixed = smem_floats(0, p.S, p.d, p.YL);
  if (fixed + 9 + p.S + 3 > budget) return 0;
  const size_t T = (budget - fixed - 9) / (p.S + 3);
  p.T = T < (size_t)p.YL ? (int)T : p.YL;
  return sizeof(float) * smem_floats(p.T, p.S, p.d, p.YL);
}

template <class F>
cudaError_t with_tile(int block_size, F&& f) {
  const int per = ialspp_features_per_thread(block_size);
  if (per == 1) return f(ialspp_tile<1>);
  if (per == 2) return f(ialspp_tile<2>);
  if (per <= 4) return f(ialspp_tile<4>);
  if (per <= 8) return f(ialspp_tile<8>);
  if (per <= 16) return f(ialspp_tile<16>);
  return f(ialspp_tile<kMaxM>);
}

// The row classes of a launch: with the short and Gram forms (rows of d
// floats that both hold, blocks of at most 512 features), rows of at most
// short_max entries take the short form, rows of more than gram_min the
// Gram form, the rest the tile form; else every row takes the tile form.
bool set_classes(Params& p, int short_max, int gram_min) {
  const bool forms = p.bs <= kGThreads && new_forms(p);
  p.short_max = forms ? short_max : 0;
  p.gram_min = forms ? (gram_min > short_max ? gram_min : short_max) : INT_MAX;
  p.YL = p.L < p.gram_min ? p.L : p.gram_min;
  return forms;
}

}  // namespace

// The forms that rows of d floats take with blocks of block_size and the
// class bounds short_max and gram_min, for a batch of padded length L:
// out[0] 1 where the short and Gram forms take them, else 0 (every row the
// tile form's); out[1] / out[2] the short form's shared memory in bytes and
// blocks per SM, out[3] / out[4] the Gram form's, out[5] rows per short
// block, out[6] / out[7] the tile form's.  Returns a cudaError_t.
extern "C" int ialspp_forms(int d, int block_size, int short_max, int gram_min, int L,
                            int* out) {
  Params p{};
  p.d = d;
  p.bs = block_size;
  p.L = L;
  for (int i = 0; i < 8; ++i) out[i] = 0;
  const bool forms = set_classes(p, short_max, gram_min);
  cudaError_t err = cudaSuccess;
  if (forms) {
    out[0] = 1;
    const size_t ss = plan_short(p);
    out[1] = (int)ss;
    err = with_short(d, [&](auto kernel) {
      cudaError_t e = als::allow_smem(kernel, ss);
      out[2] = blocks_per_sm((const void*)kernel, kSThreads, ss);
      return e;
    });
    const size_t gs = sizeof(float) * gram_floats(p.R0, p.EG, p.TT, p.NP);
    out[3] = (int)gs;
    if (err == cudaSuccess)
      err = with_gram(p.UPW, [&](auto kernel) {
        cudaError_t e = als::allow_smem(kernel, gs);
        out[4] = blocks_per_sm((const void*)kernel, kGThreads, gs);
        return e;
      });
    out[5] = kRows;
  }
  const size_t ts = plan_tile(p);
  out[6] = (int)ts;
  if (err == cudaSuccess && ts)
    err = with_tile(block_size, [&](auto kernel) {
      cudaError_t e = als::allow_smem(kernel, ts);
      out[7] = blocks_per_sm((const void*)kernel, kThreads, ts);
      return e;
    });
  return (int)err;
}

// Range mode: rows == NULL, batch row u is table row row_start + u.  Rows
// mode: rows != NULL, batch row u is table row rows[u].  nume / deno (B)
// receive the loss terms of the rows solved and are left as they are for the
// rows skipped.  The classes: see ialspp_forms; up to three launches, each
// form's blocks skipping the rows of the others.
extern "C" int ialspp_solve(float* table, const float* Bf, const float* FF,
                            const int32_t* lens, const int32_t* rows, int64_t row_start,
                            const int32_t* cols, const void* vals, int vals_bf16, float* nume,
                            float* deno, int64_t n_table_rows, int B, int L, int d,
                            int block_size, float alpha, float reg, int adaptive_reg,
                            float cg_tol, int item_axis, float num_fixed_rows,
                            int compute_loss, int short_max, int gram_min, float* gram_ws,
                            int* gram_cnt, void* stream) {
  if (B == 0) return 0;
  if (L < 1 || d < 1 || block_size < 1 || block_size > kThreads * kMaxM || short_max < 0 ||
      gram_min < 0)
    return (int)cudaErrorInvalidValue;
  Params p{table, Bf,    FF,  lens,   rows,  cols,         vals,         nume,
           deno,  row_start, n_table_rows, B, L, d, block_size, alpha, reg,
           cg_tol, num_fixed_rows, adaptive_reg, item_axis, compute_loss, vals_bf16};
  const bool forms = set_classes(p, short_max, gram_min);
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (forms && p.short_max > 0) {
    const size_t ss = plan_short(p);
    if (ss > als::kMaxSmem) return (int)cudaErrorInvalidValue;
    err = with_short(d, [&](auto kernel) {
      cudaError_t e = als::allow_smem(kernel, ss);
      if (e != cudaSuccess) return e;
      kernel<<<(B + kRows - 1) / kRows, kSThreads, ss, st>>>(p);
      return cudaGetLastError();
    });
    if (err != cudaSuccess) return (int)err;
  }
  if (L > p.short_max && p.gram_min > p.short_max) {
    const size_t ts = plan_tile(p);
    if (!ts) return (int)cudaErrorInvalidValue;
    err = with_tile(block_size, [&](auto kernel) {
      cudaError_t e = als::allow_smem(kernel, ts);
      if (e != cudaSuccess) return e;
      kernel<<<B, kThreads, ts, st>>>(p);
      return cudaGetLastError();
    });
    if (err != cudaSuccess) return (int)err;
  }
  if (forms && L > p.gram_min) {
    plan_pieces(p);
    if (p.maxP > 1 && (!gram_ws || !gram_cnt)) return (int)cudaErrorInvalidValue;
    p.gws = gram_ws;
    p.gcnt = gram_cnt;
    const size_t gs = sizeof(float) * gram_floats(p.R0, p.EG, p.TT, p.NP);
    err = with_gram(p.UPW, [&](auto kernel) {
      cudaError_t e = als::allow_smem(kernel, gs);
      if (e != cudaSuccess) return e;
      kernel<<<B * p.maxP, kGThreads, gs, st>>>(p);
      return cudaGetLastError();
    });
  }
  return (int)err;
}

// sizes[0]: float32 words, sizes[1]: int32 words (zeroed by the caller) of
// the Gram form's workspace for a batch of B rows of length up to L: none
// where no row is split.
extern "C" int ialspp_gram_workspace(int d, int block_size, int B, int L, int short_max,
                                     int gram_min, int64_t* sizes) {
  Params p{};
  p.d = d;
  p.bs = block_size;
  p.B = B;
  p.L = L;
  sizes[0] = sizes[1] = 0;
  if (B < 1 || L < 1 || !set_classes(p, short_max, gram_min) || L <= p.gram_min) return 0;
  plan_pieces(p);
  if (p.maxP > 1) {
    sizes[0] = (int64_t)B * p.maxP * p.WSZ;
    sizes[1] = B;
  }
  return 0;
}
