// Grouping of a chunk's entries by the table rows they touch, sized by the
// entries and never by the table (K12 csrc/warp_accumulate.cu, K9
// csrc/bpr_update.cu):
//  1. count: each live entry's row goes into an open-addressing hash table
//     of H = 2^k >= 2 min(entries, rows) slots (key + 1, count; zeroed by the
//     caller), the first entry of a row appending it to a compact list of
//     touched rows; counts are integer adds, one per warp and slot;
//  2. scan: tiles of compact rows, one block each, turn the rows' counts
//     into starts (an exclusive scan in compact order, each tile's prefix
//     from its predecessors' published sums: a decoupled look-back, exact
//     in integers), leave each slot's start as its placement cursor, list
//     the rows longer than kShort and give each a range of pieces of
//     kShort entries;
//  3. place: each entry takes a position in its row's range from the cursor
//     (integer atomics: the order inside a row is arbitrary);
//  4. a row's entry ids are put back in ascending order, which is entry
//     order, before anything is summed: in registers for rows of up to
//     kShort entries, in a warp's shared buffer up to kWarpSort, and by the
//     whole block through a bitmap of the entry ids beyond that.
// Only integer work happens before the sums, so every float sum over a row
// has a fixed order, and two launches are bitwise equal.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kScanThreads = 256;   // threads of a scan tile's block
constexpr int kScanPer = 4;         // compact rows per scan thread
constexpr int kTileRows = kScanThreads * kScanPer;
constexpr int kShort = 32;          // longest row summed by one warp at once;
                                    // longer rows are summed in pieces of kShort
constexpr int kWarpSort = 256;      // longest row a warp sorts alone
constexpr int kWinWords = 2048;     // a long row's bitmap window (65,536 ids)
constexpr int kMaxH = 8;            // columns per lane of one column chunk
constexpr int kChunk = 32 * kMaxH;  // a warp's columns per pass
constexpr int kSeg = 32;            // slots per warp on a presorted side
constexpr int kRowBlocks = 1024;    // most blocks of the row sums

// The column chunks of a row of d floats: one pass at offset 0 for the
// narrow instantiation (d <= kChunk), else ceil(d / kChunk) passes.
template <bool kWide>
__device__ __forceinline__ int chunk_end(int d) {
  return kWide ? d : 1;
}

#define CHECK_LAUNCH()                         \
  do {                                         \
    const cudaError_t e_ = cudaGetLastError(); \
    if (e_ != cudaSuccess) return e_;          \
  } while (0)

// One side's grouping state in the workspace.
struct Grouping {
  int n;          // entries
  int cap;        // most touched rows: min(n, rows of the table)
  unsigned mask;  // H - 1
  int32_t* hash;  // [2 H]: key + 1, then count (later the cursor); zeroed
  int32_t* meta;  // [4]: touched rows, long rows (scan_rows' kLong), their
                  // pieces, scan tiles begun; zeroed
  unsigned long long* status;  // [tiles]: a scan tile's published sum; zeroed
  int32_t* slot;  // [n]: the entry's hash slot, -1 for a dead entry
  int32_t* row;   // [cap]: the compact row's table row
  int32_t* hslot; // [cap]: the compact row's hash slot
  int32_t* start; // [cap + 1]
  int32_t* longs; // [nlong]: the long compact rows
  int4* pdesc;    // [pmax]: per piece (add_pieces) its row's first piece,
                  // (its row's pieces) * 2 kPiece + its entries, its first
                  // entry's place in ord (or slot), the table (or compact)
                  // row
  int32_t* fin;   // [pmax]: pieces done per row, at its first piece; zeroed
  int32_t* ids;   // [n]: the entries placed by row
  int32_t* ord;   // [n]: the long rows' entries in ascending order
  float* part;    // [W][pmax]: the long rows' piece partials by column
                  // (W = d + 1 for K12)
  int64_t pmax;   // most pieces
  int nlong;      // most long rows
};

// Most rows longer than kShort among n entries, and most pieces of kPiece
// entries they hold.
inline int max_long_rows(int n) { return n / (kShort + 1) + 1; }
template <int kPiece = kShort>
inline int64_t max_pieces(int n) {
  return (int64_t)n / kPiece + max_long_rows(n);
}
// Scan tiles of `cap` compact rows at most.
inline int scan_tiles(int cap) { return (cap + kTileRows - 1) / kTileRows + 1; }

// Slots of a hash table for n entries over `rows` rows: a power of two at
// least twice the most rows the entries can touch (at most 2^31).
inline int64_t hash_size(int n, int rows) {
  const int64_t want = 2 * (int64_t)(n < rows ? n : rows);
  int64_t h = 2;
  while (h < want) h <<= 1;
  return h;
}

__device__ __forceinline__ unsigned mix32(unsigned x) {
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  return x ^ (x >> 16);
}

__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Step 1 for one entry per lane (key -1: dead), every lane of the warp
// calling: the entry's slot, its row appended when new, the slot's count
// raised by the warp's entries of that row at once.
__device__ __forceinline__ void count_entry(const Grouping& G, int e, int key) {
  int s = -1;
  if (key >= 0) {
    unsigned h = mix32((unsigned)key) & G.mask;
    for (;;) {
      // a slot that holds a key is read, not swapped: a hot row's entries
      // do not queue on one atomic
      int old = __ldcg(&G.hash[2 * (int64_t)h]);
      if (old == 0) {
        old = atomicCAS(&G.hash[2 * (int64_t)h], 0, key + 1);
        if (old == 0) {
          const int r = atomicAdd(&G.meta[0], 1);
          G.row[r] = key;
          G.hslot[r] = (int)h;
          break;
        }
      }
      if (old == key + 1) break;
      h = (h + 1) & G.mask;
    }
    s = (int)h;
  }
  if (e >= 0) G.slot[e] = s;
  const unsigned peers = __match_any_sync(kFull, s);
  if (s >= 0 && (lanes_below() & peers) == 0)
    atomicAdd(&G.hash[2 * (int64_t)s + 1], __popc(peers));
}

// Step 3 for one entry per lane (e -1: none), every lane calling; put(at,
// e) places whatever goes beside the id at ids[at].
template <class Put>
__device__ __forceinline__ void place_entry(const Grouping& G, int e, Put put) {
  const int s = e >= 0 ? G.slot[e] : -1;
  const unsigned peers = __match_any_sync(kFull, s);
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (s >= 0 && (threadIdx.x & 31) == leader)
    base = atomicAdd(&G.hash[2 * (int64_t)s + 1], __popc(peers));
  base = __shfl_sync(kFull, base, leader);
  if (s >= 0) {
    const int at = base + __popc(peers & lanes_below());
    G.ids[at] = e;
    put(at, e);
  }
}

__device__ __forceinline__ void place_entry(const Grouping& G, int e) {
  place_entry(G, e, [](int, int) {});
}

// Exclusive scan of one value per thread of a block of kT threads, in
// thread order; *total gets the block's sum.  Integer adds.
template <int kT>
__device__ __forceinline__ int block_scan(int v, int* wsum, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kT / 32 ? wsum[lane] : 0;
    int y = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int z = __shfl_up_sync(kFull, y, o);
      if (lane >= o) y += z;
    }
    if (lane < kT / 32) wsum[lane] = y - w;
    if (lane == 31) wsum[32] = y;
  }
  __syncthreads();
  const int r = wsum[warp] + x - v;
  *total = wsum[32];
  __syncthreads();  // wsum may be reused as soon as this returns
  return r;
}

// The np pieces of kPiece entries of a row of m entries from place `at`
// (table row r), described from piece `first` on: (first, np 2 kPiece +
// the piece's entries, its first place, r).
template <int kPiece = kShort>
__device__ __forceinline__ void add_pieces(const Grouping& G, int first, int np, int m, int at,
                                           int r) {
  for (int q = 0; q < np; ++q)
    G.pdesc[first + q] =
        make_int4(first, np * 2 * kPiece + min(kPiece, m - q * kPiece), at + q * kPiece, r);
}

// Step 2: one tile of kTileRows compact rows per block of kScanThreads
// threads, tiles taken in the order the blocks start (so a tile's
// predecessors are running or done, and waiting on them ends).  A row
// longer than kLong entries is listed, and its pieces (of kPiece entries)
// name its table row, or with kByIndex its compact row.
template <bool kByIndex = false, int kPiece = kShort, int kLong = kShort>
__device__ __forceinline__ void scan_rows(const Grouping& G) {
  __shared__ int wsum[33];
  __shared__ int tile, prefix;
  if (threadIdx.x == 0) tile = atomicAdd(&G.meta[3], 1);
  __syncthreads();
  const int t = tile, nr = G.meta[0], i0 = t * kTileRows + threadIdx.x * kScanPer;
  if (t * kTileRows >= nr) return;
  int hs[kScanPer], c[kScanPer], local = 0;
#pragma unroll
  for (int v = 0; v < kScanPer; ++v) hs[v] = i0 + v < nr ? G.hslot[i0 + v] : -1;
#pragma unroll
  for (int v = 0; v < kScanPer; ++v) c[v] = hs[v] >= 0 ? G.hash[2 * (int64_t)hs[v] + 1] : 0;
#pragma unroll
  for (int v = 0; v < kScanPer; ++v) local += c[v];
  int sum;
  int run = block_scan<kScanThreads>(local, wsum, &sum);
  if (threadIdx.x == 0) {
    // publish the tile's sum (flag 1), then its inclusive prefix (flag 2)
    // once the predecessors' sums, read back to the first inclusive one,
    // are added
    volatile unsigned long long* st = G.status;
    int before = 0;
    if (t > 0) {
      atomicExch(&G.status[t], (1ull << 32) | (unsigned)sum);
      for (int j = t - 1;;) {
        const unsigned long long w = st[j];
        const unsigned flag = (unsigned)(w >> 32);
        if (flag == 0) continue;
        before += (int)(unsigned)w;
        if (flag == 2) break;
        --j;
      }
    }
    atomicExch(&G.status[t], (2ull << 32) | (unsigned)(before + sum));
    prefix = before;
    if ((t + 1) * kTileRows >= nr) G.start[nr] = before + sum;
  }
  __syncthreads();
  run += prefix;
#pragma unroll
  for (int v = 0; v < kScanPer; ++v) {
    const int i = i0 + v;
    if (i >= nr) continue;
    G.start[i] = run;
    G.hash[2 * (int64_t)hs[v] + 1] = run;
    if (c[v] > kLong) {  // a long row and its range of pieces
      const int np = (c[v] + kPiece - 1) / kPiece;
      G.longs[atomicAdd(&G.meta[1], 1)] = i;
      add_pieces<kPiece>(G, atomicAdd(&G.meta[2], np), np, c[v], run, kByIndex ? i : G.row[i]);
    }
    run += c[v];
  }
}

// The end of the run of key u from entry lo (keys ascending, keys[lo] ==
// u): the first entry in [lo, hi) past it, or hi; a 32-way search by the
// warp.
__device__ __forceinline__ int run_end(const int32_t* __restrict__ keys, int u, int lo, int hi) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int x = lo + lane * step;
    const unsigned m = __ballot_sync(kFull, x >= hi || keys[x] > u);
    const int f = m ? __ffs(m) - 1 : 32;  // lane 0 probes lo, inside the run
    hi = min(hi, lo + f * step);
    lo += (f - 1) * step + 1;
  }
  const int x = lo + lane;
  const unsigned m = __ballot_sync(kFull, x < hi && keys[x] > u);
  return m ? lo + __ffs(m) - 1 : hi;
}

// Step 4, rows of up to 32 entries: lane k < m gets the k-th smallest id of
// ids[0, m) (a bitonic sort across the warp), lanes past m get -1.
__device__ __forceinline__ int warp_sorted(const int32_t* ids, int m) {
  const int lane = threadIdx.x & 31;
  int v = lane < m ? ids[lane] : 0x7fffffff;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int o = __shfl_xor_sync(kFull, v, j);
      const bool up = (lane & k) == 0, low = (lane & j) == 0;
      v = low == up ? min(v, o) : max(v, o);
    }
  return lane < m ? v : -1;
}

// Step 4, rows of 33 to kWarpSort entries: buf[0, m) gets ids[0, m) in
// ascending order (a bitonic sort in the warp's buffer of kWarpSort ints).
__device__ __forceinline__ void warp_sort_buffer(const int32_t* ids, int m, int* buf) {
  const int lane = threadIdx.x & 31;
  int P = 64;
  while (P < m) P <<= 1;
#pragma unroll 4
  for (int i = lane; i < P; i += 32) buf[i] = i < m ? ids[i] : 0x7fffffff;
  __syncwarp();
  for (int k = 2; k <= P; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = lane; i < P; i += 32) {
        const int l = i ^ j;
        if (l > i) {
          const int a = buf[i], b = buf[l];
          if ((a > b) == ((i & k) == 0)) {
            buf[i] = b;
            buf[l] = a;
          }
        }
      }
      __syncwarp();
    }
}

// The shared words of block_order's bitmap of kWords words: word i at
// bitmap_at(i), one padding word per 32, so that threads scanning their
// runs of consecutive words read distinct banks.
__device__ __forceinline__ int bitmap_at(int i) { return i + (i >> 5); }

// Step 4, a row longer than kWarpSort, by the whole block: out[0, m) gets
// ids[0, m) (entry ids below n) in ascending order, window by window of a
// bitmap over the ids.  bits holds kWords + kWords / 32 words (a window of
// 32 kWords ids, at bitmap_at).
template <int kWords = kWinWords>
__device__ __forceinline__ void block_order(const int32_t* ids, int m, int n, int32_t* out,
                                            unsigned* bits) {
  __shared__ int wsum[33];
  __shared__ int span[2];
  constexpr int kPer = kWords / kThreads;
  if (threadIdx.x == 0) {
    span[0] = n;
    span[1] = 0;
  }
  __syncthreads();
  int lo = n, hi = 0;  // only the windows between the smallest and largest id
#pragma unroll 8
  for (int i = threadIdx.x; i < m; i += kThreads) {
    lo = min(lo, ids[i]);
    hi = max(hi, ids[i] + 1);
  }
  atomicMin(&span[0], lo);
  atomicMax(&span[1], hi);
  __syncthreads();
  lo = span[0] & ~31;
  hi = span[1];
  int done = 0;
  for (int w0 = lo; w0 < hi; w0 += 32 * kWords) {
    for (int i = threadIdx.x; i < kWords + kWords / 32; i += kThreads) bits[i] = 0u;
    __syncthreads();
#pragma unroll 8
    for (int i = threadIdx.x; i < m; i += kThreads) {
      const int e = ids[i] - w0;
      if (e >= 0 && e < 32 * kWords) atomicOr(&bits[bitmap_at(e >> 5)], 1u << (e & 31));
    }
    __syncthreads();
    const int q0 = threadIdx.x * kPer;
    int local = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) local += __popc(bits[bitmap_at(q0 + q)]);
    int tot;
    int at = done + block_scan<kThreads>(local, wsum, &tot);
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      unsigned word = bits[bitmap_at(q0 + q)];
      while (word) {
        const int bit = __ffs(word) - 1;
        word &= word - 1;
        out[at++] = w0 + 32 * (q0 + q) + bit;
      }
    }
    done += tot;
    __syncthreads();  // bits are cleared for the next window
  }
}

}  // namespace
