// K12: a WARP chunk's deferred gradients.  Given K11's choice per slot j
// (users[j], pos[j], neg[j], any_v[j], weight w[j]; slots from n_valid on are
// padding), every valid slot with any_v adds, with W = 2 w for l2 and w for
// dot:
//  * u_deriv - reg_u p_u into gP[u], u_deriv = W (q_i - q_j);
//  * i_deriv - reg_i q_i into gQ[i] if update_i, i_deriv = w p_u (dot) or
//    w (p_u - q_i) (l2);
//  * j_deriv - reg_j q_j into gQ[j] if update_j, j_deriv = -w p_u (dot) or
//    -w (p_u - q_j) (l2);
// and with per-coordinate normalization 1 into cP[u], cQ[i] and cQ[j]
// (whatever update_i / update_j say).  The sums are added onto the epoch's
// running gradients and counts; P and Q are only read.
//
// Replaces buffalo_tpu/ops/warp_kernels.py warp_accumulate_step's scatter
// (:145-170) and warp_epoch's scan-body scatter (:295-317).
//
// What bounds it on the card: three rows gathered per contributing slot (p_u,
// q_i, q_j), d floats each, and the touched rows of gP and gQ read and
// written once; at d = 64 ~0.8 KB per slot, and ~10 d operations per slot
// are far below the FP32 rate.  The arithmetic is tiny, so what costs is the
// number of dependent launches and any pass over the whole table.  Design:
// six stream operations per call, none sized by the table's rows.
//  * One memset zeroes the groupings' hash tables and counters (sized by
//    the entries).
//  * Launch 1, the user side of a resident chunk (users[0, n_valid)
//    ascending): one warp per segment of kSeg slots sums, in slot order,
//    each user's run that lies in the segment and adds it once onto gP (and
//    cP); a run that starts in the segment and goes on past it is
//    registered for launch 5 (its end found by a search).  In the same
//    launch, the item side's entries (2N: the positives then the
//    negatives), and the user side's of a chunk in any order, are counted
//    by row (touched_rows.cuh, step 1).
//  * Launches 2 and 3: each grouping's scan (tiles of its touched rows, a
//    block each, prefixes by look-back) and placement.
//  * Launch 4: a warp per touched row of up to kShort entries sorts its
//    entry ids back into ascending order, sums its entries in that order
//    and adds the sum and the count once; a longer row is only sorted (by a
//    warp up to kWarpSort entries, else by the block).
//  * Launch 5: the longer rows and the registered runs in pieces of kShort
//    entries in entry order, a warp per piece; the row's last piece to
//    finish (an integer count) adds their partials in piece order and the
//    count.
// No float atomics: two launches are bitwise equal.  A lane holds 8 columns
// (kChunk = 256 per warp); wider rows take the wide instantiation, which
// walks each row in 256-column chunks.
#include <cuda_runtime.h>
#include <stdint.h>

#include "touched_rows.cuh"

namespace {

struct Acc {
  const int32_t *users, *pos, *neg;
  const uint8_t* anyv;
  const float *w, *P, *Q;
  int N, n_valid, U, I, d, l2;
  float reg_u, reg_i, reg_j;
  int upd_i, upd_j, keep_pos, keep_neg, users_sorted;
  float *gP, *gQ, *cP, *cQ;
  int nseg;        // segments of a presorted user side
  Grouping gu, gi; // the user side in any order; the item side
  int nb_seg, nb_u, nb_i;  // blocks of the grouping launches, by role
  int nt_u, nt_i;          // scan tiles of the user and item groupings
};

__device__ __forceinline__ bool live(const Acc& a, int j) {
  return j < a.n_valid && a.anyv[j];
}

// Item entry e < N is the positive of slot e, N + j the negative of slot j;
// it is kept for its side's update or for the counts.
__device__ __forceinline__ int item_key(const Acc& a, int e) {
  if (e < 0 || e >= 2 * a.N) return -1;
  const bool positive = e < a.N;
  const int j = positive ? e : e - a.N;
  if (!live(a, j) || !(positive ? a.keep_pos : a.keep_neg)) return -1;
  const int k = positive ? a.pos[j] : a.neg[j];
  return k >= 0 && k < a.I ? k : -1;
}

__device__ __forceinline__ int user_key(const Acc& a, int j) {
  if (j < 0 || j >= a.N || !live(a, j)) return -1;
  const int k = a.users[j];
  return k >= 0 && k < a.U ? k : -1;
}

// Adds onto acc (columns c0 + lane + 32 h below d) the entries held one per
// lane in lanes [k0, k1) (entry id e, -1 for none), in lane order: user
// entries (slots) or item entries.
__device__ __forceinline__ void add_entries(const Acc& a, bool item, int e, int k0, int k1,
                                            int c0, float (&acc)[kMaxH]) {
  const int lane = threadIdx.x & 31, d = a.d;
  int rp = 0, rq = 0, rn = 0, act = 0;
  float s = 0.f, rg = 0.f;
  if (e >= 0) {
    if (!item) {
      rp = a.users[e];
      rq = a.pos[e];
      rn = a.neg[e];
      s = a.l2 ? 2.f * a.w[e] : a.w[e];
      rg = a.reg_u;
      act = 1;
    } else {
      const bool positive = e < a.N;
      const int j = positive ? e : e - a.N;
      rp = a.users[j];
      rq = positive ? a.pos[j] : a.neg[j];
      s = positive ? a.w[j] : -a.w[j];
      rg = positive ? a.reg_i : a.reg_j;
      act = positive ? a.upd_i : a.upd_j;  // else kept for the counts only
    }
  }
#pragma unroll 8
  for (int k = k0; k < k1; ++k) {
    if (!__shfl_sync(kFull, act, k)) continue;
    const float* p = a.P + (int64_t)__shfl_sync(kFull, rp, k) * d;
    const float* q = a.Q + (int64_t)__shfl_sync(kFull, rq, k) * d;
    const float sk = __shfl_sync(kFull, s, k), rk = __shfl_sync(kFull, rg, k);
    if (!item) {
      const float* qn = a.Q + (int64_t)__shfl_sync(kFull, rn, k) * d;
#pragma unroll
      for (int h = 0; h < kMaxH; ++h) {
        const int c = c0 + lane + 32 * h;
        if (c < d) acc[h] += sk * (q[c] - qn[c]) - rk * p[c];
      }
    } else {
#pragma unroll
      for (int h = 0; h < kMaxH; ++h) {
        const int c = c0 + lane + 32 * h;
        if (c < d) acc[h] += sk * (a.l2 ? p[c] - q[c] : p[c]) - rk * q[c];
      }
    }
  }
}

// Adds onto g[0, d) and *cnt n partials stored by column (column c of
// partial k at col(c)[k]; column d the count), each column summed by the
// warp: lane j adds col(c)[j], col(c)[j + 32], ... in that order, then the
// lanes' sums meet in a fixed butterfly (every lane gets the same bits);
// 32 columns at a time, so that their loads are in flight together.
template <class Col>
__device__ __forceinline__ void add_partials(Col col, int n, int d, float* g, float* cnt) {
  const int lane = threadIdx.x & 31;
  for (int c0 = 0; c0 <= d; c0 += 32) {
    float v[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) v[j] = 0.f;
#pragma unroll 2
    for (int k = lane; k < n; k += 32) {
#pragma unroll
      for (int j = 0; j < 32; ++j)
        if (c0 + j <= d) v[j] += __ldcg(col(c0 + j) + k);
    }
    float mine = 0.f;  // lane j keeps column c0 + j
#pragma unroll
    for (int j = 0; j < 32; ++j) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v[j] += __shfl_xor_sync(kFull, v[j], o);
      if (lane == j) mine = v[j];
    }
    const int c = c0 + lane;
    if (c < d) g[c] += mine;
    if (c == d && cnt) *cnt += mine;
  }
}

// The presorted user side: warp `seg` sums, in slot order, the runs of
// slots [seg kSeg, (seg + 1) kSeg) below n_valid that lie in the segment
// and adds each once; a run that starts here and goes on past it is
// registered for launch 5, in pieces of kShort slots from its start.
template <bool kWide>
__device__ void user_segment(const Acc& a, int seg) {
  if (seg >= a.nseg) return;
  const int lane = threadIdx.x & 31, d = a.d;
  const int s0 = seg * kSeg, s1 = min(s0 + kSeg, a.n_valid), len = s1 - s0;
  const int j = s0 + lane;
  const bool in = lane < len;
  const int u = in ? a.users[j] : -1;
  const bool lv = in && a.anyv[j];
  const int u_left = __shfl_up_sync(kFull, u, 1);
  const unsigned starts = __ballot_sync(kFull, in && (lane == 0 || u != u_left));
  const unsigned lives = __ballot_sync(kFull, lv);
  const int before = s0 > 0 ? a.users[s0 - 1] : -1;
  const int after = s1 < a.n_valid ? a.users[s1] : -1;
  unsigned rest = starts;
  while (rest) {
    const int pa = __ffs(rest) - 1;
    rest &= rest - 1;
    const int pb = rest ? __ffs(rest) - 1 : len;
    const int user = __shfl_sync(kFull, u, pa);
    if (pa == 0 && user == before) continue;  // begun left of s0: registered there
    if (pb == len && user == after) {
      // goes on past s1: its end, then its pieces
      const int r1 = run_end(a.users, user, s1, a.n_valid), r0 = s0 + pa;
      const int np = (r1 - r0 + kShort - 1) / kShort;
      if (lane == 0) add_pieces(a.gu, atomicAdd(&a.gu.meta[2], np), np, r1 - r0, r0, user);
      continue;
    }
    const unsigned span = (pb == 32 ? kFull : (1u << pb) - 1u) & ~((1u << pa) - 1u);
    const int n_live = __popc(lives & span);
    if (n_live == 0) continue;
    float* g = a.gP + (int64_t)user * d;
    for (int c0 = 0; c0 < chunk_end<kWide>(d); c0 += kChunk) {
      float acc[kMaxH];
#pragma unroll
      for (int h = 0; h < kMaxH; ++h) acc[h] = 0.f;
      add_entries(a, false, lv ? j : -1, pa, pb, c0, acc);  // the run's live slots
#pragma unroll
      for (int h = 0; h < kMaxH; ++h) {
        const int c = c0 + lane + 32 * h;
        if (c < d) g[c] += acc[h];
      }
    }
    if (a.cP && lane == 0) a.cP[user] += (float)n_live;
  }
}

// Launch 1: the presorted user side's segments, then step 1 of the user
// grouping (a chunk in any order), then of the item grouping.
template <bool kWide>
__global__ void __launch_bounds__(kThreads) group_kernel(const Acc a) {
  int blk = blockIdx.x;
  if (blk < a.nb_seg) {
    user_segment<kWide>(a, blk * kWarps + (int)(threadIdx.x >> 5));
    return;
  }
  blk -= a.nb_seg;
  if (blk < a.nb_u) {
    const int e = blk * kThreads + threadIdx.x;
    count_entry(a.gu, e < a.N ? e : -1, user_key(a, e));
    return;
  }
  const int e = (blk - a.nb_u) * kThreads + threadIdx.x;
  count_entry(a.gi, e < 2 * a.N ? e : -1, item_key(a, e));
}

// Launch 2: the scan tiles of the user grouping (a chunk in any order),
// then of the item grouping.
__global__ void __launch_bounds__(kScanThreads) scan_kernel(const Acc a) {
  scan_rows((int)blockIdx.x < a.nt_u ? a.gu : a.gi);
}

// Launch 3: the entries placed by row.
__global__ void __launch_bounds__(kThreads) place_kernel(const Acc a) {
  const int blk = blockIdx.x;
  if (blk < a.nb_u) {
    const int e = blk * kThreads + threadIdx.x;
    place_entry(a.gu, e < a.N ? e : -1);
    return;
  }
  const int e = (blk - a.nb_u) * kThreads + threadIdx.x;
  place_entry(a.gi, e < 2 * a.N ? e : -1);
}

// Launch 4: a warp per touched row of up to kShort entries sums it in entry
// order and adds it once; a longer row is sorted into entry order (ord) for
// launch 5, by its warp up to kWarpSort entries, else by a block.
template <bool kWide>
__global__ void __launch_bounds__(kThreads) rows_kernel(const Acc a) {
  __shared__ unsigned bits[kWinWords + kWinWords / 32];
  __shared__ int bufs[kWarps][kWarpSort];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, d = a.d;
  const int nru = a.users_sorted ? 0 : a.gu.meta[0], nri = a.gi.meta[0];
  const int nlu = a.users_sorted ? 0 : a.gu.meta[1], nli = a.gi.meta[1];
  for (int L = blockIdx.x; L < nlu + nli; L += gridDim.x) {
    const bool item = L >= nlu;
    const Grouping G = item ? a.gi : a.gu;
    const int ri = G.longs[item ? L - nlu : L];
    const int s0 = G.start[ri], m = G.start[ri + 1] - s0;
    if (m > kWarpSort) block_order(G.ids + s0, m, G.n, G.ord + s0, bits);
  }
  for (int q = blockIdx.x * kWarps + warp; q < nru + nri; q += gridDim.x * kWarps) {
    const bool item = q >= nru;
    const Grouping G = item ? a.gi : a.gu;
    const int ri = item ? q - nru : q;
    const int s0 = G.start[ri], m = G.start[ri + 1] - s0;
    if (m > kWarpSort) continue;  // sorted by a block above
    if (m > kShort) {
      warp_sort_buffer(G.ids + s0, m, bufs[warp]);
      for (int i = lane; i < m; i += 32) G.ord[s0 + i] = bufs[warp][i];
      __syncwarp();  // the warp's buffer is refilled for its next row
      continue;
    }
    const int r = G.row[ri];
    float* g = (item ? a.gQ : a.gP) + (int64_t)r * d;
    const int e = warp_sorted(G.ids + s0, m);
    for (int c0 = 0; c0 < chunk_end<kWide>(d); c0 += kChunk) {
      float acc[kMaxH];
#pragma unroll
      for (int h = 0; h < kMaxH; ++h) acc[h] = 0.f;
      add_entries(a, item, e, 0, m, c0, acc);
#pragma unroll
      for (int h = 0; h < kMaxH; ++h) {
        const int c = c0 + lane + 32 * h;
        if (c < d) g[c] += acc[h];
      }
    }
    float* cnt = item ? a.cQ : a.cP;
    if (cnt && lane == 0) cnt[r] += (float)m;
  }
}

// Launch 5: a warp per piece of kShort entries of a row longer than kShort
// (in entry order, from launch 4), or of a presorted user run across
// segments (kShort consecutive slots from the run's start): its partial,
// and the row's sum and count added by its last piece, the partials in
// entry order.
template <bool kWide>
__global__ void __launch_bounds__(kThreads) pieces_kernel(const Acc a) {
  const int lane = threadIdx.x & 31, d = a.d;
  const int npu = a.gu.meta[2], npi = a.gi.meta[2];
  for (int q = blockIdx.x * kWarps + (int)(threadIdx.x >> 5); q < npu + npi;
       q += gridDim.x * kWarps) {
    const bool item = q >= npu;
    const Grouping G = item ? a.gi : a.gu;
    const int qs = item ? q - npu : q;
    const int4 pd = G.pdesc[qs];
    const int first = pd.x, np = pd.y >> 6, nb = pd.y & 63, at = pd.z, r = pd.w;
    int e = -1;  // a presorted run's live slots, else the sorted entries
    if (lane < nb) e = !item && a.users_sorted ? (a.anyv[at + lane] ? at + lane : -1)
                                               : G.ord[at + lane];
    // column c of the piece at part[c * pmax] (pieces of a row adjacent)
    float* part = G.part + qs;
    const int64_t pmax = G.pmax;
    for (int c0 = 0; c0 < chunk_end<kWide>(d); c0 += kChunk) {
      float acc[kMaxH];
#pragma unroll
      for (int h = 0; h < kMaxH; ++h) acc[h] = 0.f;
      add_entries(a, item, e, 0, nb, c0, acc);
#pragma unroll
      for (int h = 0; h < kMaxH; ++h) {
        const int c = c0 + lane + 32 * h;
        if (c < d) part[(int64_t)c * pmax] = acc[h];
      }
    }
    const int counted = __popc(__ballot_sync(kFull, e >= 0));
    if (lane == 0) part[(int64_t)d * pmax] = (float)counted;
    __threadfence();  // this lane's partials before the count
    __syncwarp();
    int done = 0;
    if (lane == 0) done = atomicAdd(&G.fin[first], 1);
    if (__shfl_sync(kFull, done, 0) != np - 1) continue;  // not the last piece
    __threadfence();
    float* cnt = item ? a.cQ : a.cP;
    add_partials([&](int c) { return G.part + (int64_t)c * pmax + first; }, np, d,
                 (item ? a.gQ : a.gP) + (int64_t)r * d, cnt ? cnt + r : nullptr);
  }
}

// The workspace: int32 words (the zeroed prefix first: both groupings'
// counters, the finisher counts, the item then the user hash table) and
// float32 words (the segment partials).
struct Layout {
  int64_t ints, floats;
  int64_t zero_begin, zero_sorted, zero_any;  // the zeroed words [begin, end)
};

Layout layout(int N, int U, int I, int d, int32_t* ib, float* fb, Acc* a) {
  int64_t io = 0;
  auto ints = [&](int64_t m) {
    int32_t* p = ib ? ib + io : nullptr;
    io += m;
    return p;
  };
  const int nseg = (N + kSeg - 1) / kSeg;
  const int64_t hi = hash_size(2 * N, I), hu = hash_size(N, U);
  Grouping gi{}, gu{};
  gi.nlong = max_long_rows(2 * N);
  // the user side's long rows, or a presorted side's runs across segments
  // (at most one starts in each segment)
  gu.nlong = max_long_rows(N) > nseg ? max_long_rows(N) : nseg;
  gi.pmax = max_pieces(2 * N) + gi.nlong;
  gu.pmax = max_pieces(N) + gu.nlong;
  // the 16-byte piece descriptors, then the scans' 8-byte status words, at
  // the workspace's aligned start
  gi.pdesc = reinterpret_cast<int4*>(ints(4 * gi.pmax));
  gu.pdesc = reinterpret_cast<int4*>(ints(4 * gu.pmax));
  Layout L{};
  L.zero_begin = io;
  auto words = [&](int cap) {
    return reinterpret_cast<unsigned long long*>(ints(2 * (int64_t)scan_tiles(cap)));
  };
  gi.status = words(2 * N < I ? 2 * N : I);
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
  carve(gi, 2 * N, I, hi);
  carve(gu, N, U, hu);
  L.ints = io;
  L.floats = (gi.pmax + gu.pmax) * (d + 1);
  if (a) {
    gi.part = fb;
    gu.part = fb ? fb + gi.pmax * (d + 1) : nullptr;
    a->gi = gi;
    a->gu = gu;
  }
  return L;
}

template <bool kWide>
cudaError_t launch(Acc& a, const Layout& L, int32_t* ws_i, cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(
      ws_i + L.zero_begin, 0,
      sizeof(int32_t) * ((a.users_sorted ? L.zero_sorted : L.zero_any) - L.zero_begin), st);
  if (err != cudaSuccess) return err;
  a.nseg = a.users_sorted ? (a.n_valid + kSeg - 1) / kSeg : 0;
  a.nb_seg = (a.nseg + kWarps - 1) / kWarps;
  a.nb_u = a.users_sorted ? 0 : (a.N + kThreads - 1) / kThreads;
  a.nb_i = (2 * a.N + kThreads - 1) / kThreads;
  group_kernel<kWide><<<a.nb_seg + a.nb_u + a.nb_i, kThreads, 0, st>>>(a);
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
  rows_kernel<kWide><<<grid((a.users_sorted ? 0 : (int64_t)a.gu.cap) + a.gi.cap), kThreads, 0,
                       st>>>(a);
  CHECK_LAUNCH();
  pieces_kernel<kWide><<<grid(a.gu.pmax + a.gi.pmax), kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// sizes[0]: int32 words, sizes[1]: float32 words of the workspace.
extern "C" int warp_workspace(int N, int U, int I, int d, int64_t* sizes) {
  const Layout L = layout(N, U, I, d, nullptr, nullptr, nullptr);
  sizes[0] = L.ints;
  sizes[1] = L.floats;
  return 0;
}

// 1 when rows of d floats take the wide instantiation.
extern "C" int warp_accumulate_wide(int d) { return d > kChunk ? 1 : 0; }

// users_sorted: users[0, n_valid) ascend (a resident chunk).  cP and cQ are
// both given (per-coordinate normalization) or both null.
extern "C" int warp_accumulate(const int32_t* users, const int32_t* pos, const int32_t* neg,
                               const uint8_t* anyv, const float* w, const float* P,
                               const float* Q, int N, int n_valid, int U, int I, int d, int l2,
                               float reg_u, float reg_i, float reg_j, int upd_i, int upd_j,
                               int users_sorted, float* gP, float* gQ, float* cP, float* cQ,
                               int32_t* ws_i, float* ws_f, void* stream) {
  if (N < 0 || U < 1 || I < 1 || d < 1 || (int64_t)2 * N >= (1LL << 31) || (!cP) != (!cQ))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const int pcn = cP != nullptr;
  Acc a{};
  a.users = users;
  a.pos = pos;
  a.neg = neg;
  a.anyv = anyv;
  a.w = w;
  a.P = P;
  a.Q = Q;
  a.N = N;
  a.n_valid = n_valid < 0 ? 0 : n_valid > N ? N : n_valid;
  a.U = U;
  a.I = I;
  a.d = d;
  a.l2 = l2;
  a.reg_u = reg_u;
  a.reg_i = reg_i;
  a.reg_j = reg_j;
  a.upd_i = upd_i;
  a.upd_j = upd_j;
  a.keep_pos = upd_i || pcn;
  a.keep_neg = upd_j || pcn;
  a.users_sorted = users_sorted;
  a.gP = gP;
  a.gQ = gQ;
  a.cP = cP;
  a.cQ = cQ;
  const Layout L = layout(N, U, I, d, ws_i, ws_f, &a);
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(warp_accumulate_wide(d) ? launch<true>(a, L, ws_i, st)
                                       : launch<false>(a, L, ws_i, st));
}
