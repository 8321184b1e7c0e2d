// K20: delta rows grouped by table row, each row's sum capped and added.
// The entries are side a's na rows (rows_a, keyed by keys_a) then side b's
// nb rows; an entry keyed outside [0, R) is dropped (the JAX package's
// .at[].add(mode="drop")).  Each touched row r gets
//   T[r] += D * min(1, cap / max(|D|, 1e-20)),  D = sum of scale * row
// over its entries in entry order (cap 0: T[r] += D); an untouched row keeps
// its bytes.
//
// Replaces buffalo_tpu/ops/w2v_kernels.py _clipped_apply (:34) with the
// scatters that feed it: the pair step's (:548-563: L1 from the targets and
// negatives, then L0 from the inputs) and the stream epoch's (:221-226: L0
// from the chunk's positions, then L1 from the positions and the
// block-shared negatives).
//
// What bounds it on the card: each entry's row read once (n d floats) and
// each touched table row read and written once.  The L1 update of a brunch
// stream chunk (294,912 entries of 4 bytes of key and 128 of row, 163,298
// touched rows, d = 32) moves ~80 MB, ~24 us of HBM; its entries average
// 1.8 per touched row, so what costs is any pass that is not over the
// entries: a sort of every entry, a search over the table's rows.  Design:
// touched_rows.cuh's grouping (as K9 and K12), sized by the entries and
// never by the table, six stream operations per call:
//  * a memset of the grouping's hash table and counters;
//  * count: each live entry's row into the hash table, the touched rows
//    listed once;
//  * scan: the touched rows' starts by a decoupled look-back, rows longer
//    than kShort entries listed with their pieces of kShort entries;
//  * place: each entry's id into its row's range (integer atomics);
//  * rows: a warp per touched row of at most kShort entries puts its entry
//    ids back in ascending order (entry order), sums the scaled rows in that
//    order with eight rows' loads in flight, caps the sum and adds it to T
//    in one pass; a longer row is only sorted (by its warp up to kWarpSort
//    entries, else by the block);
//  * pieces: a warp per piece of kShort entries of a longer row sums it in
//    entry order into a partial; the row's last piece to finish (an integer
//    count) adds the partials in piece order, caps and writes.
// No float atomics: two launches are bitwise equal.  A lane holds H <= 16
// columns (rows up to 512 floats) and sums a row in one pass; wider rows
// take the wide instantiation, which walks each row in 256-column chunks
// (a capped row twice: the norm of the whole sum first).  The query
// w2v_row_apply_wide names the instantiations past 256 floats.
#include <cuda_runtime.h>
#include <stdint.h>

#include "touched_rows.cuh"

namespace {


struct Apply {
  const int32_t *ka, *kb;
  const float *ra, *rb;
  int na, nb, R, d;
  float scale, cap;
  float* T;
  Grouping g;
};

__device__ __forceinline__ int key_of(const Apply& a, int e) {
  if (e < 0 || e >= a.na + a.nb) return -1;
  const int k = e < a.na ? a.ka[e] : a.kb[e - a.na];
  return k >= 0 && k < a.R ? k : -1;
}

__device__ __forceinline__ const float* row_of(const Apply& a, int e) {
  return e < a.na ? a.ra + (int64_t)e * a.d : a.rb + (int64_t)(e - a.na) * a.d;
}

// acc = scale times the sum of the rows of the entries held one per lane in
// lanes [0, m) (ascending ids), columns c0 + lane + 32 h, in lane order.
template <int H>
__device__ __forceinline__ void sum_entries(const Apply& a, int e, int m, int c0,
                                            float (&acc)[H]) {
  const int lane = threadIdx.x & 31, dk = a.d - c0;
#pragma unroll
  for (int h = 0; h < H; ++h) acc[h] = 0.f;
  // rows (or partials) loaded before they are added: fewer for a lane's 16
  // columns, so that they stay in registers
  constexpr int kAhead = H <= 8 ? 8 : 4;
  for (int k0 = 0; k0 < m; k0 += kAhead) {
    float v[kAhead][H];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int ej = __shfl_sync(kFull, e, (k0 + j) & 31);
      const float* row = row_of(a, k0 + j < m ? ej : 0) + c0;
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const int c = lane + 32 * h;
        v[j][h] = k0 + j < m && c < dk ? row[c] : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j)
#pragma unroll
      for (int h = 0; h < H; ++h) acc[h] = fmaf(a.scale, v[j][h], acc[h]);
  }
}

// acc = the sum of partials [q0, q1) (rows of d floats), columns c0 + lane +
// 32 h, in partial order with kAhead loads in flight (from L2: other warps
// wrote them).
template <int H>
__device__ __forceinline__ void sum_partials(const float* __restrict__ part, int q0, int q1,
                                             int d, int c0, float (&acc)[H]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < H; ++h) acc[h] = 0.f;
  constexpr int kAhead = H <= 8 ? 8 : 4;
  for (int q = q0; q < q1; q += kAhead) {
    float v[kAhead][H];
#pragma unroll
    for (int j = 0; j < kAhead; ++j)
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const int c = c0 + lane + 32 * h;
        v[j][h] = q + j < q1 && c < d ? __ldcg(part + (int64_t)(q + j) * d + c) : 0.f;
      }
#pragma unroll
    for (int j = 0; j < kAhead; ++j)
#pragma unroll
      for (int h = 0; h < H; ++h) acc[h] += v[j][h];
  }
}

// The cap's factor for a sum whose lanes hold the squares ss.
__device__ __forceinline__ float cap_factor(float ss, float cap) {
  float t = ss;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(kFull, t, o);
  return fminf(1.f, cap / fmaxf(sqrtf(t), 1e-20f));
}

// Row r's sum (sum(c0, acc) gives columns c0 + lane + 32 h), capped and
// added to T.  The wide instantiation walks 256-column chunks, the norm of
// the whole sum first when the cap is on.
template <int H, bool kWide, class Sum>
__device__ __forceinline__ void cap_and_add(const Apply& a, int r, Sum sum) {
  const int lane = threadIdx.x & 31, d = a.d;
  float acc[H];
  float s = 1.f;
  if (kWide && a.cap > 0.f) {
    float ss = 0.f;
    for (int c0 = 0; c0 < d; c0 += kChunk) {
      sum(c0, acc);
#pragma unroll
      for (int h = 0; h < H; ++h) ss += acc[h] * acc[h];
    }
    s = cap_factor(ss, a.cap);
  }
  float* tr = a.T + (int64_t)r * d;
  for (int c0 = 0; c0 < chunk_end<kWide>(d); c0 += kChunk) {
    sum(c0, acc);
    if (!kWide && a.cap > 0.f) {
      float ss = 0.f;
#pragma unroll
      for (int h = 0; h < H; ++h) ss += acc[h] * acc[h];
      s = cap_factor(ss, a.cap);
    }
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int c = c0 + lane + 32 * h;
      if (c < d) tr[c] += a.cap > 0.f ? acc[h] * s : acc[h];
    }
  }
}

// warp_sorted for a row of m <= kShort entries, its one or two entries
// ordered without the sort's network (most rows of a chunk hold one or two).
__device__ __forceinline__ int rows_sorted(const int32_t* ids, int m) {
  const int lane = threadIdx.x & 31;
  if (m > 2) return warp_sorted(ids, m);
  const int a = ids[0], b = m == 2 ? ids[1] : a;
  return lane == 0 ? min(a, b) : lane == 1 && m == 2 ? max(a, b) : -1;
}

// Launch 1: each live entry's row counted.
__global__ void __launch_bounds__(kThreads) apply_count(const Apply a) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  count_entry(a.g, e < a.na + a.nb ? e : -1, key_of(a, e));
}

// Launch 2: the touched rows' starts; rows past kShort entries get pieces.
__global__ void __launch_bounds__(kScanThreads) apply_scan(const Apply a) { scan_rows(a.g); }

// Launch 3: the entries placed by row.
__global__ void __launch_bounds__(kThreads) apply_place(const Apply a) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  place_entry(a.g, e < a.na + a.nb ? e : -1);
}

// Launch 4: a warp per touched row of up to kShort entries sums, caps and
// writes it; a longer row is put in entry order (ord) for launch 5, by its
// warp up to kWarpSort entries, else by a block.
template <int H, bool kWide>
__global__ void __launch_bounds__(kThreads) apply_rows_short(const Apply a) {
  __shared__ unsigned bits[kWinWords + kWinWords / 32];
  __shared__ int bufs[kWarps][kWarpSort];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Grouping& G = a.g;
  const int nr = G.meta[0], nl = G.meta[1];
  for (int L = blockIdx.x; L < nl; L += gridDim.x) {
    const int ri = G.longs[L];
    const int s0 = G.start[ri], m = G.start[ri + 1] - s0;
    if (m > kWarpSort) block_order(G.ids + s0, m, G.n, G.ord + s0, bits);
  }
  for (int q = blockIdx.x * kWarps + warp; q < nr; q += gridDim.x * kWarps) {
    const int s0 = G.start[q], m = G.start[q + 1] - s0;
    if (m > kWarpSort) continue;  // sorted by a block above
    if (m > kShort) {
      warp_sort_buffer(G.ids + s0, m, bufs[warp]);
      for (int i = lane; i < m; i += 32) G.ord[s0 + i] = bufs[warp][i];
      __syncwarp();  // the warp's buffer is refilled for its next row
      continue;
    }
    const int e = rows_sorted(G.ids + s0, m);  // short rows
    cap_and_add<H, kWide>(a, G.row[q],
                          [&](int c0, float(&acc)[H]) { sum_entries<H>(a, e, m, c0, acc); });
  }
}

// Launch 5: a warp per piece of kShort entries of a longer row (in entry
// order, from launch 4): its partial; the row's last piece to finish adds
// the partials in piece order, caps and writes.
template <int H, bool kWide>
__global__ void __launch_bounds__(kThreads) apply_pieces(const Apply a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, d = a.d;
  const Grouping& G = a.g;
  const int np = G.meta[2];
  for (int q = blockIdx.x * kWarps + warp; q < np; q += gridDim.x * kWarps) {
    const int4 pd = G.pdesc[q];
    const int first = pd.x, pieces = pd.y >> 6, nbp = pd.y & 63, at = pd.z, r = pd.w;
    const int e = lane < nbp ? G.ord[at + lane] : -1;
    float* part = G.part + (int64_t)q * d;
    for (int c0 = 0; c0 < chunk_end<kWide>(d); c0 += kChunk) {
      float acc[H];
      sum_entries<H>(a, e, nbp, c0, acc);
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const int c = c0 + lane + 32 * h;
        if (c < d) part[c] = acc[h];
      }
    }
    __threadfence();  // this lane's partials before the count
    __syncwarp();
    int done = 0;
    if (lane == 0) done = atomicAdd(&G.fin[first], 1);
    if (__shfl_sync(kFull, done, 0) != pieces - 1) continue;  // not the last piece
    __threadfence();
    cap_and_add<H, kWide>(a, r, [&](int c0, float(&acc)[H]) {
      sum_partials<H>(G.part, first, first + pieces, d, c0, acc);
    });
  }
}

// The workspace: int32 words (the piece descriptors, then the zeroed words:
// the scan's status, the counters, the finisher counts, the hash table;
// then the grouping's arrays) and float32 words (the pieces' partials).
struct Layout {
  int64_t ints, floats, zero_begin, zero_end;
};

Layout layout(int n, int R, int d, int32_t* ib, float* fb, Grouping* out) {
  int64_t io = 0;
  auto ints = [&](int64_t m) {
    int32_t* p = ib ? ib + io : nullptr;
    io += m;
    return p;
  };
  Grouping G{};
  const int64_t H = hash_size(n, R);
  G.n = n;
  G.cap = n < R ? n : R;
  G.mask = (unsigned)(H - 1);
  G.nlong = max_long_rows(n);
  G.pmax = max_pieces(n);
  G.pdesc = reinterpret_cast<int4*>(ints(4 * G.pmax));  // 16-byte aligned
  Layout L{};
  L.zero_begin = io;
  G.status = reinterpret_cast<unsigned long long*>(ints(2 * (int64_t)scan_tiles(G.cap)));
  G.meta = ints(4);
  G.fin = ints(G.pmax);
  G.hash = ints(2 * H);
  L.zero_end = io;
  G.slot = ints(n);
  G.row = ints(G.cap);
  G.hslot = ints(G.cap);
  G.start = ints((int64_t)G.cap + 1);
  G.longs = ints(G.nlong);
  G.ids = ints(n);
  G.ord = ints(n);
  L.ints = io;
  L.floats = G.pmax * d;
  G.part = fb;
  if (out) *out = G;
  return L;
}

template <int H, bool kWide = false>
cudaError_t launch(const Apply& a, cudaStream_t st) {
  auto grid = [](int64_t warps) {
    const int64_t blocks = (warps + kWarps - 1) / kWarps;
    return (unsigned)(blocks < 1 ? 1 : blocks < kRowBlocks ? blocks : kRowBlocks);
  };
  apply_rows_short<H, kWide><<<grid(a.g.cap), kThreads, 0, st>>>(a);
  CHECK_LAUNCH();
  apply_pieces<H, kWide><<<grid(a.g.pmax), kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// sizes[0]: int32 words, sizes[1]: float32 words of the workspace for n
// entries over R rows of d floats.
extern "C" int w2v_apply_workspace(int n, int R, int d, int64_t* sizes) {
  const Layout L = layout(n, R, d, nullptr, nullptr, nullptr);
  sizes[0] = L.ints;
  sizes[1] = L.floats;
  return 0;
}

// 1 when rows of d floats take the wide instantiation.
extern "C" int w2v_row_apply_wide(int d) { return d > kChunk ? 1 : 0; }

// keys_b / rows_b may be null when nb is 0.
extern "C" int w2v_row_apply(const int32_t* keys_a, const float* rows_a, int na,
                             const int32_t* keys_b, const float* rows_b, int nb, float* T, int R,
                             int d, float scale, float cap, int32_t* ws_i, float* ws_f,
                             void* stream) {
  if (na < 0 || nb < 0 || R < 1 || d < 1 || (int64_t)na + nb >= (1LL << 31) ||
      cap < 0.f)
    return (int)cudaErrorInvalidValue;
  const int n = na + nb;
  if (n == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  Apply a{keys_a, keys_b, rows_a, rows_b, na, nb, R, d, scale, cap, T, {}};
  const Layout L = layout(n, R, d, ws_i, ws_f, &a.g);
  cudaError_t err = cudaMemsetAsync(ws_i + L.zero_begin, 0,
                                    sizeof(int32_t) * (L.zero_end - L.zero_begin), st);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  apply_count<<<blocks, kThreads, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  apply_scan<<<scan_tiles(a.g.cap), kScanThreads, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  apply_place<<<blocks, kThreads, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (d <= 32) err = launch<1>(a, st);
  else if (d <= 64) err = launch<2>(a, st);
  else if (d <= 128) err = launch<4>(a, st);
  else if (d <= kChunk) err = launch<8>(a, st);
  else if (d <= 2 * kChunk) err = launch<16>(a, st);  // one pass, no re-read for the cap
  else err = launch<kMaxH, true>(a, st);
  return (int)err;
}
