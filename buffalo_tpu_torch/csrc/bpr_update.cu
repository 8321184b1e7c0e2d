// K9: a BPR chunk's update.  Given the chunk's users and positives (N slots,
// the first n_valid real) and its negatives (neg_per per slot, >= num_items a
// sentinel), every sample's logit l = 1 - sigmoid(x) with the reference's
// +-6 clamps, x = p_u . (q_i - q_j) (+ Qb_i - Qb_j), 0 for a sentinel or a
// padding slot; then either
//  * sgd (bpr_update): per user dP = lr (sum l (q_i - q_j) - reg_u neg_per
//    slots p_u), per item dQ = lr (sum +-l p_u - Q (reg_i neg_per positives
//    + reg_j negatives)), each clipped by its row L2 norm to max_step_norm
//    (0: no clip) and added; the item bias moves by its positive side
//    (clamped) and then by its negative side, whose reg term reads the bias
//    after the positive side's step; every other term reads the chunk's
//    snapshot of the tables; or
//  * the deferred path (bpr_accumulate): the same sums without lr and reg
//    added into the epoch's gradient tables, and with per-coordinate
//    normalization the counts (user and positive once per slot, the negative
//    once per sample); or
//  * the delta path (bpr_delta, a mesh shard's sgd chunk, bpr_epoch_dp
//    :804-846): the sgd step's rows unclipped, added into dense delta tables
//    dP, dQ and dQb (the bias's positive side), the tables untouched; a
//    second launch (bpr_delta_bias_neg) adds the negative side's bias step
//    from the same item rows once Qb has taken the reduced positive side;
//    the cap applies to the reduced deltas (K10's capped add);
// and (bpr_loss) the mean of log(1 + exp(-x)) over fixed triplets.
//
// Replaces buffalo_tpu/ops/sgd_kernels.py _bpr_forward (:336), clipped_logit
// (:272), clip_row_norm (:280), bpr_sgd_step (:390), bpr_accumulate_step
// (:355), the scan bodies of bpr_epoch (:544-651) and bpr_loss (:859).
//
// What bounds it on the card: gathering three rows per sample (p_u, q_i, q_j)
// and writing the touched rows; at d = 40 about 0.5 KB per sample, so a
// 524,288-slot chunk moves ~0.25 GB (~0.08 ms at 3.35 TB/s) if every row
// were read per sample, far less with each touched row read once; the
// operations (~9 d per sample) are far below the FP32 rate.  What costs is
// the number of dependent launches and any pass over a whole table.
// Design: seven stream operations per call, none sized by a table's rows
// (the entries are grouped by the rows they touch, csrc/touched_rows.cuh).
//  * One memset zeroes the groupings' hash tables and counters.
//  * Launch 1, a warp per segment of kSeg slots: lane t computes slot t's
//    logits (its rows' dot products), writes each item entry's user and
//    logit (sum) beside its entry id, and counts the item entries (the
//    positives, entries 0 .. N-1, then the negatives) by row.  A resident
//    chunk's users ascend (users_sorted): the warp then sums, in slot
//    order, each user run that lies in its segment into a compact row of
//    sums, and registers a run that starts here and goes on past it for
//    launch 5 (in pieces of kRunPiece slots); otherwise the user entries are
//    counted by row too.
//  * Launches 2 and 3: the groupings' scans and the placement of each
//    entry id beside its user and logit.
//  * Launch 4: a warp per touched row of up to kWarpSort entries puts them
//    back in entry order (in registers or its shared buffer) and sums them
//    into its compact row of sums; a longer row is only sorted, by the
//    block.
//  * Launch 5: the longer rows and the registered runs in pieces of kPiece
//    entries (kRunPiece slots), a warp per piece; the row's last piece to
//    finish adds their partials in piece order into the row's sums.
//  * Launch 6, a warp per touched row: its epilogue from its sums, the
//    step with the clip (sgd), the accumulation, or the delta.  Every read
//    of the tables happens in launches 1-5, so the sgd step reads the
//    chunk's snapshot while P and Q are written in place.
// Every sum over a row runs in entry order with no float atomics, so two
// launches are bitwise equal.  The sums gather their rows in batches whose
// loads are in flight together (a row per entry, 4-8 at a time), lanes on
// the columns: 2 columns a lane up to d = 64, 8 up to kChunk = 256; wider
// rows take the wide instantiation, which walks a row in 256-column
// chunks.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "touched_rows.cuh"

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float clipped_logit(float x) {
  return x > 6.f ? 0.f : (x < -6.f ? 1.f : 1.f / (1.f + expf(x)));
}

// The modes of the epilogue
enum Mode { kStep = 0, kAccumulate = 1, kDelta = 2 };

// Entries per piece of a row longer than kWarpSort: a piece's warp gathers its
// rows 32 entries at a time, and the row's last piece adds np partials.  A
// presorted user run across segments goes in pieces of kRunPiece slots.
constexpr int kPiece = 256, kRunPiece = 64;

// Widths of a compact row of sums: a user's d sums and its slot count; an
// item's d sums, then its positive and negative logit sums and counts.
__host__ __device__ __forceinline__ int user_width(int d) { return d + 1; }
__host__ __device__ __forceinline__ int item_width(int d) { return d + 4; }

struct Bpr {
  const int32_t *users, *pos, *neg;
  float *P, *Q, *Qb;  // written by the sgd step only
  int N, neg_per, n_valid, U, I, d, vec4;
  int mode, use_bias, upd_i, upd_j, users_sorted;
  float lr, reg_u, reg_i, reg_j, reg_b, cap;
  float *gP, *gQ, *gQb, *cP, *cQ;  // the accumulators, or the delta tables
  float* logit;    // [N neg_per]
  int2* edat;      // [N (neg_per + 1)]: item entry e's (user, logit sum)
  int2* pay;       // the same placed beside gi.ids
  float* res_u;    // [gu.cap][user_width]: each touched user's sums
  float* res_i;    // [gi.cap][item_width]: each touched item's sums
  Grouping gu, gi; // the users (any order; compact rows of runs when
                   // presorted) and the items
  int nseg, nb_seg, nb_u, nb_i, nt_u, nt_i;
};

// sum over c < d of p[c] (a[c] - b[c]), by one thread.
__device__ __forceinline__ float dot_diff(const float* __restrict__ p,
                                          const float* __restrict__ a,
                                          const float* __restrict__ b, int d, int vec4) {
  if (vec4) {
    const float4 *p4 = reinterpret_cast<const float4*>(p),
                 *a4 = reinterpret_cast<const float4*>(a),
                 *b4 = reinterpret_cast<const float4*>(b);
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 4
    for (int c = 0; c < d / 4; ++c) {
      const float4 x = p4[c], y = a4[c], z = b4[c];
      s0 = fmaf(x.x, y.x - z.x, s0);
      s1 = fmaf(x.y, y.y - z.y, s1);
      s2 = fmaf(x.z, y.z - z.z, s2);
      s3 = fmaf(x.w, y.w - z.w, s3);
    }
    return (s0 + s1) + (s2 + s3);
  }
  float s = 0.f;
#pragma unroll 4
  for (int c = 0; c < d; ++c) s = fmaf(p[c], a[c] - b[c], s);
  return s;
}

// acc[h] += c_t (a_t[col] - b_t[col]) (kDiff) or c_t a_t[col] for t in [0,
// n) in order, col = c0 + lane + 32 h below d; term(t, c, a, b) gives the
// coefficient and the rows (c = 0: nothing added, the rows not read).
// Every lane calls with the same n; the loads of a batch of terms are
// issued before their adds.
template <int H, bool kDiff, class Term>
__device__ __forceinline__ void gather_sum(int n, int c0, int d, Term term, float (&acc)[H]) {
  constexpr int kB = H <= 2 ? 8 : 4;  // rows whose loads are in flight together
  const int lane = threadIdx.x & 31;
  for (int t0 = 0; t0 < n; t0 += kB) {
    float cf[kB];
    const float* ra[kB];
    const float* rb[kB];
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      cf[i] = 0.f;
      ra[i] = rb[i] = nullptr;
      if (t0 + i < n) term(t0 + i, cf[i], ra[i], rb[i]);
    }
    float v[kB][H];
#pragma unroll
    for (int i = 0; i < kB; ++i)
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const int c = c0 + lane + 32 * h;
        v[i][h] = 0.f;
        if (cf[i] != 0.f && c < d) v[i][h] = kDiff ? ra[i][c] - rb[i][c] : ra[i][c];
      }
#pragma unroll
    for (int i = 0; i < kB; ++i)
#pragma unroll
      for (int h = 0; h < H; ++h) acc[h] = fmaf(cf[i], v[i][h], acc[h]);
  }
}

// The sums of m user entries (slots slot(0), slot(1), ... in entry order,
// m up to kPiece):
// over each slot's samples, l (q_pos - q_neg), sentinels adding nothing;
// store(c, sum) for every column c, then store(d, m) (the slot count).
template <int H, bool kWide, class Slot, class Store>
__device__ __forceinline__ void user_sums(const Bpr& a, int m, Slot slot, Store store) {
  const int lane = threadIdx.x & 31, d = a.d, np = a.neg_per;
  auto term = [&](int t, float& c, const float*& ra, const float*& rb) {
    const int i = np == 1 ? t : t / np;
    const int j = slot(i);
    const int64_t k = (int64_t)j * np + (t - i * np);
    const int nk = a.neg[k];
    if (nk < 0 || nk >= a.I) return;
    c = a.logit[k];
    ra = a.Q + (int64_t)a.pos[j] * d;
    rb = a.Q + (int64_t)nk * d;
  };
  for (int c0 = 0; c0 < chunk_end<kWide>(d); c0 += 32 * H) {
    float acc[H];
#pragma unroll
    for (int h = 0; h < H; ++h) acc[h] = 0.f;
    gather_sum<H, true>(m * np, c0, d, term, acc);
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int c = c0 + lane + 32 * h;
      if (c < d) store(c, acc[h]);
    }
  }
  if (lane == 0) store(d, (float)m);
}

// The sums of m item entries in entry order, fetched 32 at a time:
// fetch(s0, n, e, u, wb) puts entry s0 + t (t < n) in lane t (its id, its
// user and its logit sum's bits).  c p_u with c = w for a positive (0
// without update_i), -w for a negative (0 without update_j); store(c, sum)
// for every column c, then store(d .. d + 3, the positive and negative
// logit sums and counts).
template <int H, bool kWide, class Fetch, class Store>
__device__ __forceinline__ void item_sums(const Bpr& a, int m, Fetch fetch, Store store) {
  const int lane = threadIdx.x & 31, d = a.d;
  for (int c0 = 0; c0 < chunk_end<kWide>(d); c0 += 32 * H) {
    float acc[H];
#pragma unroll
    for (int h = 0; h < H; ++h) acc[h] = 0.f;
    for (int s0 = 0; s0 < m; s0 += 32) {
      const int n = min(32, m - s0);
      int e, u, wb;
      fetch(s0, n, e, u, wb);
      gather_sum<H, false>(
          n, c0, d,
          [&](int t, float& c, const float*& ra, const float*&) {
            const int et = __shfl_sync(kFull, e, t), ut = __shfl_sync(kFull, u, t);
            const float wt = __int_as_float(__shfl_sync(kFull, wb, t));
            c = et < a.N ? (a.upd_i ? wt : 0.f) : (a.upd_j ? -wt : 0.f);
            ra = a.P + (int64_t)ut * d;
          },
          acc);
    }
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int c = c0 + lane + 32 * h;
      if (c < d) store(c, acc[h]);
    }
  }
  float lpos = 0.f, lneg = 0.f, cpos = 0.f, cneg = 0.f;
  for (int s0 = 0; s0 < m; s0 += 32) {
    const int n = min(32, m - s0);
    int e, u, wb;
    fetch(s0, n, e, u, wb);
    for (int t = 0; t < n; ++t) {
      const int et = __shfl_sync(kFull, e, t);
      const float wt = __int_as_float(__shfl_sync(kFull, wb, t));
      if (et < a.N) {
        lpos += wt;
        cpos += 1.f;
      } else {
        lneg += wt;
        cneg += 1.f;
      }
    }
  }
  if (lane == 0) {
    store(d, lpos);
    store(d + 1, lneg);
    store(d + 2, cpos);
    store(d + 3, cneg);
  }
}

// A compact user row for a presorted run (user u): its index.
__device__ __forceinline__ int new_user_row(const Bpr& a, int u) {
  int x = 0;
  if ((threadIdx.x & 31) == 0) {
    x = atomicAdd(&a.gu.meta[0], 1);
    a.gu.row[x] = u;
  }
  return __shfl_sync(kFull, x, 0);
}

// Launch 1: warp `seg` takes slots [seg kSeg, (seg + 1) kSeg).
template <int H, bool kWide>
__global__ void __launch_bounds__(kThreads) segment_kernel(const Bpr a) {
  const int seg = blockIdx.x * kWarps + (int)(threadIdx.x >> 5);
  if (seg >= a.nseg) return;  // whole warps leave together
  const int lane = threadIdx.x & 31, d = a.d, N = a.N;
  const int s0 = seg * kSeg, j = s0 + lane;
  const bool in = j < N, live = j < a.n_valid;
  const int u = live ? a.users[j] : -1, pi = live ? a.pos[j] : -1;
  const float* p = a.P + (int64_t)(live ? u : 0) * d;
  const float* qi = a.Q + (int64_t)(live ? pi : 0) * d;
  float w = 0.f;  // the slot's logit sum
  for (int n = 0; n < a.neg_per; ++n) {
    const int64_t k = (int64_t)j * a.neg_per + n;
    const int nk = in ? a.neg[k] : -1;
    const bool ok = live && nk >= 0 && nk < a.I;
    float l = 0.f;
    if (ok) {
      float x = dot_diff(p, qi, a.Q + (int64_t)nk * d, d, a.vec4);
      if (a.use_bias) x += a.Qb[pi] - a.Qb[nk];
      l = clipped_logit(x);
    }
    w += l;
    if (in) {
      a.logit[k] = l;
      a.edat[N + k] = make_int2(u, __float_as_int(l));
    }
    count_entry(a.gi, in ? (int)(N + k) : -1, ok ? nk : -1);
  }
  if (in) a.edat[j] = make_int2(u, __float_as_int(w));
  count_entry(a.gi, in ? j : -1, live && pi >= 0 && pi < a.I ? pi : -1);
  if (!a.users_sorted) {
    count_entry(a.gu, in ? j : -1, live && u >= 0 && u < a.U ? u : -1);
    return;
  }
  // the presorted user side: the runs of slots [s0, s1)
  __syncwarp();  // the warp's logits, read below
  const int s1 = min(s0 + kSeg, a.n_valid), len = s1 - s0;
  if (len <= 0) return;
  const int u_left = __shfl_up_sync(kFull, u, 1);
  const unsigned starts = __ballot_sync(kFull, lane < len && (lane == 0 || u != u_left));
  const int before = s0 > 0 ? a.users[s0 - 1] : -1;
  const int after = s1 < a.n_valid ? a.users[s1] : -1;
  unsigned rest = starts;
  while (rest) {
    const int pa = __ffs(rest) - 1;
    rest &= rest - 1;
    const int pb = rest ? __ffs(rest) - 1 : len;
    const int user = __shfl_sync(kFull, u, pa);
    if (pa == 0 && user == before) continue;  // begun left of s0: registered there
    const int x = new_user_row(a, user);
    if (pb == len && user == after) {
      // goes on past s1: its end, then its pieces
      const int r1 = run_end(a.users, user, s1, a.n_valid), r0 = s0 + pa;
      const int np = (r1 - r0 + kRunPiece - 1) / kRunPiece;
      if (lane == 0)
        add_pieces<kRunPiece>(a.gu, atomicAdd(&a.gu.meta[2], np), np, r1 - r0, r0, x);
      continue;
    }
    float* out = a.res_u + (int64_t)x * user_width(d);
    user_sums<H, kWide>(a, pb - pa, [&](int i) { return s0 + pa + i; },
                        [&](int c, float v) { out[c] = v; });
  }
}

// Launch 2: the scan tiles of the user grouping (users in any order), then
// of the item grouping; rows longer than kWarpSort are listed, their pieces
// naming their compact rows.
__global__ void __launch_bounds__(kScanThreads) scan_kernel(const Bpr a) {
  scan_rows<true, kPiece, kWarpSort>((int)blockIdx.x < a.nt_u ? a.gu : a.gi);
}

// Launch 3: the entries placed by row, an item entry's user and logit
// beside its id.
__global__ void __launch_bounds__(kThreads) place_kernel(const Bpr a) {
  const int blk = blockIdx.x;
  if (blk < a.nb_u) {
    const int e = blk * kThreads + threadIdx.x;
    place_entry(a.gu, e < a.N ? e : -1);
    return;
  }
  const int e = (blk - a.nb_u) * kThreads + threadIdx.x;
  place_entry(a.gi, e < a.gi.n ? e : -1, [&](int at, int id) { a.pay[at] = a.edat[id]; });
}

// Rows of up to 32 entries: lane k < m gets the k-th smallest id of ids[0,
// m) and the lane of ids it came from (a bitonic sort across the warp);
// lanes past m get -1.
__device__ __forceinline__ int warp_sorted_from(const int32_t* ids, int m, int* from) {
  const int lane = threadIdx.x & 31;
  int v = lane < m ? ids[lane] : 0x7fffffff, src = lane;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int o = __shfl_xor_sync(kFull, v, j), os = __shfl_xor_sync(kFull, src, j);
      const bool up = (lane & k) == 0, low = (lane & j) == 0;
      if (low == up ? o < v : o > v) {
        v = o;
        src = os;
      }
    }
  *from = src;
  return lane < m ? v : -1;
}

// Launch 4: a warp per touched row of up to kWarpSort entries puts them in
// entry order (in registers up to kShort entries, else in the warp's shared
// buffer) and sums them into its compact row of sums; a longer row is
// sorted into entry order (ord) for launch 5 by a block, over a bitmap of
// kOrderWords words (a window of 2^18 entry ids).
constexpr int kOrderWords = 8192;

template <int H, bool kWide>
__global__ void __launch_bounds__(kThreads) rows_kernel(const Bpr a) {
  __shared__ unsigned bits[kOrderWords + kOrderWords / 32];
  __shared__ int bufs[kWarps][kWarpSort];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, d = a.d;
  const int nru = a.users_sorted ? 0 : a.gu.meta[0], nri = a.gi.meta[0];
  const int nlu = a.users_sorted ? 0 : a.gu.meta[1], nli = a.gi.meta[1];
  for (int L = blockIdx.x; L < nlu + nli; L += gridDim.x) {
    const bool item = L >= nlu;
    const Grouping G = item ? a.gi : a.gu;
    const int ri = G.longs[item ? L - nlu : L];
    const int s0 = G.start[ri], m = G.start[ri + 1] - s0;
    block_order<kOrderWords>(G.ids + s0, m, G.n, G.ord + s0, bits);
  }
  int* buf = bufs[warp];
  for (int q = blockIdx.x * kWarps + warp; q < nru + nri; q += gridDim.x * kWarps) {
    const bool item = q >= nru;
    const Grouping G = item ? a.gi : a.gu;
    const int ri = item ? q - nru : q;
    const int s0 = G.start[ri], m = G.start[ri + 1] - s0;
    if (m > kWarpSort) continue;  // sorted by a block above, summed in pieces
    float* out = item ? a.res_i + (int64_t)ri * item_width(d)
                      : a.res_u + (int64_t)ri * user_width(d);
    auto store = [&](int c, float v) { out[c] = v; };
    if (m > kShort) {
      warp_sort_buffer(G.ids + s0, m, buf);
      if (item)
        item_sums<H, kWide>(
            a, m,
            [&](int b0, int n, int& e, int& u, int& wb) {
              e = lane < n ? buf[b0 + lane] : 0;
              const int2 ed = lane < n ? a.edat[e] : make_int2(0, 0);
              u = ed.x;
              wb = ed.y;
            },
            store);
      else
        user_sums<H, kWide>(a, m, [&](int i) { return buf[i]; }, store);
      __syncwarp();  // the warp's buffer is refilled for its next row
      continue;
    }
    if (!item) {
      const int e = warp_sorted(G.ids + s0, m);
      user_sums<H, kWide>(a, m, [&](int i) { return __shfl_sync(kFull, e, i); }, store);
      continue;
    }
    const int2 py = lane < m ? a.pay[s0 + lane] : make_int2(0, 0);
    int from;
    const int e = warp_sorted_from(G.ids + s0, m, &from);
    const int u = __shfl_sync(kFull, py.x, from), wb = __shfl_sync(kFull, py.y, from);
    item_sums<H, kWide>(
        a, m,
        [&](int, int, int& fe, int& fu, int& fw) {
          fe = e;
          fu = u;
          fw = wb;
        },
        store);
  }
}

// out[0, W) = the sums of n partials stored by column (column c of partial
// k at col[c * pmax + k]), each column summed by the warp: lane j adds
// partials j, j + 32, ... in that order, then the lanes' sums meet in a
// fixed butterfly; kCols columns at a time, so that their loads are in
// flight together.
__device__ __forceinline__ void sum_partials(const float* col, int64_t pmax, int n, int W,
                                             float* out) {
  constexpr int kCols = 8;
  const int lane = threadIdx.x & 31;
  for (int c0 = 0; c0 < W; c0 += kCols) {
    float v[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) v[j] = 0.f;
    for (int k = lane; k < n; k += 32) {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (c0 + j < W) v[j] += __ldcg(col + (int64_t)(c0 + j) * pmax + k);
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v[j] += __shfl_xor_sync(kFull, v[j], o);
      if (lane == j && c0 + j < W) out[c0 + j] = v[j];
    }
  }
}

// Launch 5: a warp per piece of kPiece entries of a row longer than kWarpSort
// (in entry order, from launch 4), or of a presorted user run across
// segments (kRunPiece consecutive slots from the run's start): its partial
// sums, and the row's sums from its last piece, the partials in piece
// order.
template <int H, bool kWide>
__global__ void __launch_bounds__(kThreads) pieces_kernel(const Bpr a) {
  const int lane = threadIdx.x & 31, d = a.d;
  const int npu = a.gu.meta[2], npi = a.gi.meta[2];
  for (int q = blockIdx.x * kWarps + (int)(threadIdx.x >> 5); q < npu + npi;
       q += gridDim.x * kWarps) {
    const bool item = q >= npu;
    const Grouping G = item ? a.gi : a.gu;
    const int qs = item ? q - npu : q;
    const int4 pd = G.pdesc[qs];
    const int span = 2 * (!item && a.users_sorted ? kRunPiece : kPiece);  // add_pieces'
    const int first = pd.x, np = pd.y / span, nb = pd.y % span, at = pd.z, x = pd.w;
    // column c of the piece at part[c * pmax] (pieces of a row adjacent)
    float* part = G.part + qs;
    const int64_t pmax = G.pmax;
    auto store = [&](int c, float v) { part[(int64_t)c * pmax] = v; };
    if (!item) {  // a presorted run's slots, else the sorted entries
      const int32_t* ord = G.ord + at;
      if (a.users_sorted) user_sums<H, kWide>(a, nb, [&](int i) { return at + i; }, store);
      else user_sums<H, kWide>(a, nb, [&](int i) { return ord[i]; }, store);
    } else {
      item_sums<H, kWide>(
          a, nb,
          [&](int s0, int n, int& e, int& u, int& wb) {
            e = lane < n ? G.ord[at + s0 + lane] : 0;
            const int2 ed = lane < n ? a.edat[e] : make_int2(0, 0);
            u = ed.x;
            wb = ed.y;
          },
          store);
    }
    __threadfence();  // this lane's partials before the count
    __syncwarp();
    int done = 0;
    if (lane == 0) done = atomicAdd(&G.fin[first], 1);
    if (__shfl_sync(kFull, done, 0) != np - 1) continue;  // not the last piece
    __threadfence();
    const int W = item ? item_width(d) : user_width(d);
    sum_partials(G.part + first, pmax, np, W, (item ? a.res_i : a.res_u) + (int64_t)x * W);
  }
}

// Row t's epilogue from its sums s (columns below d) and reg factor rc:
// the sgd step t += clip(lr (s - rc t)) (kStep), the accumulation o += s
// (kAccumulate) or the unclipped step added into o (kDelta).  The clip's
// norm is summed lane by lane, then across the warp.
__device__ __forceinline__ void row_epilogue(int mode, const float* s, int d, float lr, float rc,
                                             float cap, float* t, float* o) {
  const int lane = threadIdx.x & 31;
  if (mode == kAccumulate) {
    for (int c = lane; c < d; c += 32) o[c] += __ldcg(s + c);
    return;
  }
  if (mode == kDelta) {
    for (int c = lane; c < d; c += 32) o[c] += lr * (__ldcg(s + c) - rc * t[c]);
    return;
  }
  float scale = 1.f;
  if (cap > 0.f) {
    float ss = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float dl = lr * (__ldcg(s + c) - rc * t[c]);
      ss = fmaf(dl, dl, ss);
    }
    scale = fminf(1.f, cap / fmaxf(sqrtf(warp_sum(ss)), 1e-12f));
  }
  for (int c = lane; c < d; c += 32) t[c] += lr * (__ldcg(s + c) - rc * t[c]) * scale;
}

// Launch 6: a warp per touched user row, then per touched item row.
__global__ void __launch_bounds__(kThreads) epilogue_kernel(const Bpr a) {
  const int lane = threadIdx.x & 31, d = a.d;
  const int nu = a.gu.meta[0], ni = a.gi.meta[0];
  for (int q = blockIdx.x * kWarps + (int)(threadIdx.x >> 5); q < nu + ni;
       q += gridDim.x * kWarps) {
    if (q < nu) {
      const int r = a.gu.row[q];
      const float* s = a.res_u + (int64_t)q * user_width(d);
      const float n = __ldcg(s + d);
      const int64_t o = (int64_t)r * d;
      row_epilogue(a.mode, s, d, a.lr, a.reg_u * (float)a.neg_per * n, a.cap, a.P + o,
                   a.gP ? a.gP + o : nullptr);
      if (a.mode == kAccumulate && a.cP && lane == 0) a.cP[r] += n;
      continue;
    }
    const int ri = q - nu, r = a.gi.row[ri];
    const float* s = a.res_i + (int64_t)ri * item_width(d);
    const float lpos = __ldcg(s + d), lneg = __ldcg(s + d + 1), cpos = __ldcg(s + d + 2),
                cneg = __ldcg(s + d + 3);
    const float rc = (a.upd_i ? a.reg_i * (float)a.neg_per * cpos : 0.f) +
                     (a.upd_j ? a.reg_j * cneg : 0.f);
    const int64_t o = (int64_t)r * d;
    row_epilogue(a.mode, s, d, a.lr, rc, a.cap, a.Q + o, a.gQ ? a.gQ + o : nullptr);
    if (lane != 0) continue;
    if (a.mode == kAccumulate) {
      if (a.use_bias) a.gQb[r] += (a.upd_i ? lpos : 0.f) - (a.upd_j ? lneg : 0.f);
      if (a.cQ) a.cQ[r] += cpos + cneg;
      continue;
    }
    if (!a.use_bias) continue;
    if (a.mode == kDelta) {
      if (a.upd_i) a.gQb[r] += a.lr * (lpos - a.reg_b * (float)a.neg_per * cpos * a.Qb[r]);
      continue;
    }
    float b = a.Qb[r];
    if (a.upd_i) {
      float db = a.lr * (lpos - a.reg_b * (float)a.neg_per * cpos * b);
      if (a.cap > 0.f) db = fminf(fmaxf(db, -a.cap), a.cap);
      b += db;
    }
    if (a.upd_j) {
      float db = a.lr * (-lneg - a.reg_b * cneg * b);
      if (a.cap > 0.f) db = fminf(fmaxf(db, -a.cap), a.cap);
      b += db;
    }
    a.Qb[r] = b;
  }
}

// The delta path's second launch: a thread per touched item row, the
// negative side's bias step -lr (the row's negative logit sum + reg_b
// count Qb), added into dQb; Qb is read after the positive side's delta
// has been applied.
__global__ void __launch_bounds__(kThreads)
bias_neg_kernel(const Bpr a, const float* __restrict__ Qb, float* __restrict__ dQb) {
  const int ni = a.gi.meta[0], d = a.d;
  for (int ri = blockIdx.x * kThreads + threadIdx.x; ri < ni; ri += gridDim.x * kThreads) {
    const float* s = a.res_i + (int64_t)ri * item_width(d);
    const float cneg = s[d + 3];
    if (cneg > 0.f) {
      const int r = a.gi.row[ri];
      dQb[r] += a.lr * (-s[d + 1] - a.reg_b * cneg * Qb[r]);
    }
  }
}

// Mean log(1 + exp(-x)) over n triplets: one block, warp w takes triplets w,
// w + 8, ... in order, the warps' sums added in order.
__global__ void __launch_bounds__(kThreads)
loss_kernel(const int32_t* __restrict__ users, const int32_t* __restrict__ pos,
            const int32_t* __restrict__ neg, int n, const float* __restrict__ P,
            const float* __restrict__ Q, const float* __restrict__ Qb, int d, int use_bias,
            float* __restrict__ out) {
  __shared__ float red[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float sum = 0.f;
  for (int t = warp; t < n; t += kWarps) {
    const float* p = P + (int64_t)users[t] * d;
    const float* qi = Q + (int64_t)pos[t] * d;
    const float* qj = Q + (int64_t)neg[t] * d;
    float acc = 0.f;
    for (int c = lane; c < d; c += 32) acc = fmaf(p[c], qi[c] - qj[c], acc);
    float x = warp_sum(acc);
    if (use_bias) x += Qb[pos[t]] - Qb[neg[t]];
    sum += fmaxf(-x, 0.f) + log1pf(expf(-fabsf(x)));
  }
  if (lane == 0) red[warp] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w];
    *out = n > 0 ? s / (float)n : 0.f;
  }
}

// ------------------------------------------------------------- host side
// The workspace: int32 words (the piece descriptors, then the zeroed
// prefix: the scans' status words, both groupings' counters, the finisher
// counts, the item then the user hash table; then the groupings' arrays and
// the item entries' data) and float32 words (the logits, the rows' sums,
// the pieces' partials).
struct Layout {
  int64_t ints, floats;
  int64_t zero_begin, zero_sorted, zero_any;  // the zeroed words [begin, end)
};

Layout layout(int N, int neg_per, int U, int I, int d, int32_t* ib, float* fb, Bpr* a) {
  int64_t io = 0, fo = 0;
  auto ints = [&](int64_t m) {
    int32_t* p = ib ? ib + io : nullptr;
    io += m;
    return p;
  };
  auto floats = [&](int64_t m) {
    float* p = fb ? fb + fo : nullptr;
    fo += m;
    return p;
  };
  const int64_t B = (int64_t)N * neg_per;
  const int ni = (int)(N + B), nseg = (N + kSeg - 1) / kSeg;
  const int64_t hi = hash_size(ni, I), hu = hash_size(N, U);
  Grouping gi{}, gu{};
  gi.nlong = max_long_rows(ni);
  // the user side's long rows, or a presorted side's runs across segments
  // (at most one starts in each segment)
  gu.nlong = max_long_rows(N) > nseg ? max_long_rows(N) : nseg;
  gi.pmax = max_pieces<kPiece>(ni) + gi.nlong;
  gu.pmax = max_pieces<kRunPiece>(N) + gu.nlong;  // the larger of both sides' pieces
  // the 16-byte piece descriptors, then the scans' 8-byte status words, at
  // the workspace's aligned start
  gi.pdesc = reinterpret_cast<int4*>(ints(4 * gi.pmax));
  gu.pdesc = reinterpret_cast<int4*>(ints(4 * gu.pmax));
  Layout L{};
  L.zero_begin = io;
  auto words = [&](int cap) {
    return reinterpret_cast<unsigned long long*>(ints(2 * (int64_t)scan_tiles(cap)));
  };
  gi.status = words(ni < I ? ni : I);
  gu.status = words(N < U ? N : U);
  gu.meta = ints(4);
  gi.meta = ints(4);
  gi.fin = ints(gi.pmax);
  gu.fin = ints(gu.pmax);
  gi.hash = ints(2 * hi);
  L.zero_sorted = io;
  gu.hash = ints(2 * hu);
  L.zero_any = io;
  auto carve = [&](Grouping& G, int n, int rows, int64_t H) {
    G.n = n;
    G.cap = n < rows ? n : rows;
    G.mask = (unsigned)(H - 1);
    G.slot = ints(n);
    G.row = ints(G.cap);
    G.hslot = ints(G.cap);
    G.start = ints((int64_t)G.cap + 1);
    G.longs = ints(G.nlong);
    G.ids = ints(n);
    G.ord = ints(n);
  };
  carve(gi, ni, I, hi);
  carve(gu, N, U, hu);
  io += io & 1;  // the 8-byte entry data
  int2* edat = reinterpret_cast<int2*>(ints(2 * (int64_t)ni));
  int2* pay = reinterpret_cast<int2*>(ints(2 * (int64_t)ni));
  float* logit = floats(B);
  float* res_u = floats((int64_t)gu.cap * user_width(d));
  float* res_i = floats((int64_t)gi.cap * item_width(d));
  gu.part = floats(gu.pmax * user_width(d));
  gi.part = floats(gi.pmax * item_width(d));
  L.ints = io;
  L.floats = fo;
  if (a) {
    a->gi = gi;
    a->gu = gu;
    a->edat = edat;
    a->pay = pay;
    a->logit = logit;
    a->res_u = res_u;
    a->res_i = res_i;
    a->nseg = nseg;
  }
  return L;
}

template <int H, bool kWide>
cudaError_t launch(Bpr& a, const Layout& L, int32_t* ws_i, cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(
      ws_i + L.zero_begin, 0,
      sizeof(int32_t) * ((a.users_sorted ? L.zero_sorted : L.zero_any) - L.zero_begin), st);
  if (err != cudaSuccess) return err;
  a.nb_seg = (a.nseg + kWarps - 1) / kWarps;
  a.nb_u = a.users_sorted ? 0 : (a.N + kThreads - 1) / kThreads;
  a.nb_i = (a.gi.n + kThreads - 1) / kThreads;
  segment_kernel<H, kWide><<<a.nb_seg, kThreads, 0, st>>>(a);
  CHECK_LAUNCH();
  a.nt_u = a.users_sorted ? 0 : scan_tiles(a.gu.cap);
  a.nt_i = scan_tiles(a.gi.cap);
  scan_kernel<<<a.nt_u + a.nt_i, kScanThreads, 0, st>>>(a);
  CHECK_LAUNCH();
  place_kernel<<<a.nb_u + a.nb_i, kThreads, 0, st>>>(a);
  CHECK_LAUNCH();
  auto grid = [](int64_t warps) {
    const int64_t blocks = (warps + kWarps - 1) / kWarps;
    return (unsigned)(blocks < 1 ? 1 : blocks < kRowBlocks ? blocks : kRowBlocks);
  };
  // all of L1 as shared memory, so that as many blocks as it holds share
  // an SM (once per instantiation)
  static const cudaError_t carveout = cudaFuncSetAttribute(
      rows_kernel<H, kWide>, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (carveout != cudaSuccess) return carveout;
  rows_kernel<H, kWide><<<grid((a.users_sorted ? 0 : (int64_t)a.gu.cap) + a.gi.cap),
                          kThreads, 0, st>>>(a);
  CHECK_LAUNCH();
  pieces_kernel<H, kWide><<<grid(a.gu.pmax + a.gi.pmax), kThreads, 0, st>>>(a);
  CHECK_LAUNCH();
  epilogue_kernel<<<grid((int64_t)a.gu.cap + a.gi.cap), kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

// The sums hold a row in registers, H columns per lane: d <= 64 takes H =
// 2, d <= kChunk H = 8 (narrow); wider rows take the wide instantiation,
// which walks them in kChunk-column chunks.
bool wide(int d) { return d > kChunk; }

bool bad_args(int N, int neg_per, int U, int I, int d) {
  return N < 1 || neg_per < 1 || U < 1 || I < 1 || d < 1 ||
         (int64_t)N * (neg_per + 1) >= (1LL << 31);
}

Bpr make(int mode, const int32_t* users, const int32_t* pos, const int32_t* neg, const float* P,
         const float* Q, const float* Qb, int N, int neg_per, int n_valid, int U, int I, int d,
         int use_bias, int upd_i, int upd_j, int users_sorted) {
  Bpr a{};
  a.mode = mode;
  a.users = users;
  a.pos = pos;
  a.neg = neg;
  a.P = const_cast<float*>(P);
  a.Q = const_cast<float*>(Q);
  a.Qb = const_cast<float*>(Qb);
  a.N = N;
  a.neg_per = neg_per;
  a.n_valid = n_valid < 0 ? 0 : n_valid > N ? N : n_valid;
  a.U = U;
  a.I = I;
  a.d = d;
  a.vec4 = d % 4 == 0 && ((reinterpret_cast<uintptr_t>(P) | reinterpret_cast<uintptr_t>(Q)) & 15) == 0;
  a.use_bias = use_bias;
  a.upd_i = upd_i;
  a.upd_j = upd_j;
  a.users_sorted = users_sorted;
  return a;
}

int run(Bpr& a, int32_t* ws_i, float* ws_f, void* stream) {
  const Layout L = layout(a.N, a.neg_per, a.U, a.I, a.d, ws_i, ws_f, &a);
  const cudaStream_t st = (cudaStream_t)stream;
  if (wide(a.d)) return (int)launch<8, true>(a, L, ws_i, st);
  return (int)(a.d <= 64 ? launch<2, false>(a, L, ws_i, st) : launch<8, false>(a, L, ws_i, st));
}

}  // namespace

// sizes[0]: int32 words, sizes[1]: float32 words of the workspace.
extern "C" int bpr_workspace(int N, int neg_per, int U, int I, int d, int64_t* sizes) {
  const Layout L = layout(N, neg_per, U, I, d, nullptr, nullptr, nullptr);
  sizes[0] = L.ints;
  sizes[1] = L.floats;
  return 0;
}

// 1 when rows of d floats take the wide instantiation of the sums.
extern "C" int bpr_wide(int d) { return wide(d) ? 1 : 0; }

// users_sorted (here and below): users[0, n_valid) ascend (a resident
// chunk), so each user's slots are one run, summed where they lie.
extern "C" int bpr_update(const int32_t* users, const int32_t* pos, const int32_t* neg, float* P,
                          float* Q, float* Qb, int N, int neg_per, int n_valid, int U, int I,
                          int d, float lr, float reg_u, float reg_i, float reg_j, float reg_b,
                          float cap, int use_bias, int upd_i, int upd_j, int users_sorted,
                          int32_t* ws_i, float* ws_f, void* stream) {
  if (N == 0) return 0;
  if (bad_args(N, neg_per, U, I, d)) return (int)cudaErrorInvalidValue;
  Bpr a = make(kStep, users, pos, neg, P, Q, Qb, N, neg_per, n_valid, U, I, d, use_bias, upd_i,
               upd_j, users_sorted);
  a.lr = lr;
  a.reg_u = reg_u;
  a.reg_i = reg_i;
  a.reg_j = reg_j;
  a.reg_b = reg_b;
  a.cap = cap;
  return run(a, ws_i, ws_f, stream);
}

extern "C" int bpr_accumulate(const int32_t* users, const int32_t* pos, const int32_t* neg,
                              const float* P, const float* Q, const float* Qb, int N, int neg_per,
                              int n_valid, int U, int I, int d, float* gP, float* gQ, float* gQb,
                              float* cP, float* cQ, int use_bias, int upd_i, int upd_j, int pcn,
                              int users_sorted, int32_t* ws_i, float* ws_f, void* stream) {
  if (N == 0) return 0;
  if (bad_args(N, neg_per, U, I, d)) return (int)cudaErrorInvalidValue;
  Bpr a = make(kAccumulate, users, pos, neg, P, Q, Qb, N, neg_per, n_valid, U, I, d, use_bias,
               upd_i, upd_j, users_sorted);
  a.gP = gP;
  a.gQ = gQ;
  a.gQb = gQb;
  a.cP = pcn ? cP : nullptr;
  a.cQ = pcn ? cQ : nullptr;
  return run(a, ws_i, ws_f, stream);
}

// The delta path (a mesh shard's sgd chunk): the sgd step's unclipped row
// sums added into dP, dQ and (with the bias and update_i) the positive
// side's bias step into dQb; the tables are read, not written.  The
// workspace keeps the item rows' sums for bpr_delta_bias_neg.
extern "C" int bpr_delta(const int32_t* users, const int32_t* pos, const int32_t* neg,
                         const float* P, const float* Q, const float* Qb, int N, int neg_per,
                         int n_valid, int U, int I, int d, float lr, float reg_u, float reg_i,
                         float reg_j, float reg_b, int use_bias, int upd_i, int upd_j, float* dP,
                         float* dQ, float* dQb, int users_sorted, int32_t* ws_i, float* ws_f,
                         void* stream) {
  if (N == 0) return 0;
  if (bad_args(N, neg_per, U, I, d)) return (int)cudaErrorInvalidValue;
  Bpr a = make(kDelta, users, pos, neg, P, Q, Qb, N, neg_per, n_valid, U, I, d, use_bias, upd_i,
               upd_j, users_sorted);
  a.lr = lr;
  a.reg_u = reg_u;
  a.reg_i = reg_i;
  a.reg_j = reg_j;
  a.reg_b = reg_b;
  a.gP = dP;
  a.gQ = dQ;
  a.gQb = dQb;
  return run(a, ws_i, ws_f, stream);
}

// The delta path's second launch: the negative side's bias step, from the
// same chunk's item rows (the workspace of its bpr_delta call) and Qb as it
// stands after the positive side's delta, added into dQb.
extern "C" int bpr_delta_bias_neg(int N, int neg_per, int U, int I, int d, float lr, float reg_b,
                                  const float* Qb, float* dQb, int32_t* ws_i, float* ws_f,
                                  void* stream) {
  if (N == 0) return 0;
  if (bad_args(N, neg_per, U, I, d)) return (int)cudaErrorInvalidValue;
  Bpr a{};
  a.d = d;
  a.lr = lr;
  a.reg_b = reg_b;
  layout(N, neg_per, U, I, d, ws_i, ws_f, &a);
  const int64_t blocks = ((int64_t)a.gi.cap + kThreads - 1) / kThreads;
  bias_neg_kernel<<<(unsigned)(blocks < kRowBlocks ? blocks : kRowBlocks), kThreads, 0,
                    (cudaStream_t)stream>>>(a, Qb, dQb);
  return (int)cudaGetLastError();
}

extern "C" int bpr_loss(const int32_t* users, const int32_t* pos, const int32_t* neg,
                        const float* P, const float* Q, const float* Qb, int n, int d,
                        int use_bias, float* out, void* stream) {
  if (n < 0 || d < 1) return (int)cudaErrorInvalidValue;
  loss_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(users, pos, neg, n, P, Q, Qb, d,
                                                        use_bias, out);
  return (int)cudaGetLastError();
}
