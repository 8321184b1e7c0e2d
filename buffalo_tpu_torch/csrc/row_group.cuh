// Grouping of a chunk's entries by table row (K20 csrc/w2v_row_apply.cu,
// K15 csrc/plsi_estep.cu; K9 and K12 group by touched rows instead,
// csrc/touched_rows.cuh): a stable LSD radix
// sort of (row key, entry id) pairs (8-bit digits, integer shared-memory
// histograms per tile of kTile entries, their offsets by a three-launch
// parallel scan, one warp per tile placing its entries in order), the row
// counts and starts, and the runs of kRun sorted entries that one warp sums
// in entry order before one warp per row adds its runs in order.  Integer
// work only until the run sums, so a row's float sums have a fixed order and
// two launches are bitwise equal; no float atomics.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kTile = 2048;  // entries per radix tile
constexpr int kRun = 128;    // entries per partial sum
constexpr int kMaxH = 8;     // columns per lane of one column chunk
constexpr int kChunk = 32 * kMaxH;  // a warp's columns per pass: rows past
                                    // it are walked in chunks (wide mode)

// The column chunks of a row of d floats: one pass at offset 0 for the
// narrow instantiation (d <= kChunk), else ceil(d / kChunk) passes.
template <bool kWide>
__device__ __forceinline__ int chunk_end(int d) {
  return kWide ? d : 1;
}
constexpr int kScan = 1024;  // threads of a scan block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

#define CHECK_LAUNCH()                                        \
  do {                                                        \
    const cudaError_t e_ = cudaGetLastError();                \
    if (e_ != cudaSuccess) return e_;                         \
  } while (0)

// The entries of one side: n keys (row ids; R = dropped) and their ids; each
// run's partial sum has W floats.
struct Side {
  int n, R, nt, W;
  int64_t max_runs;
  int32_t *key[2], *idx[2], *hist, *hoff, *cnt, *start, *run_start, *part_i;
  float* part;
  int sorted;  // which of key/idx holds the sorted entries
};

__global__ void __launch_bounds__(kThreads)
tile_hist(const int32_t* __restrict__ key, int n, int shift, int nt, int32_t* __restrict__ hist) {
  __shared__ int cnt[256];
  const int t = blockIdx.x;
  cnt[threadIdx.x] = 0;
  __syncthreads();
  const int e1 = min(n, (t + 1) * kTile);
  for (int e = t * kTile + threadIdx.x; e < e1; e += kThreads)
    atomicAdd(&cnt[(key[e] >> shift) & 255], 1);
  __syncthreads();
  hist[threadIdx.x * nt + t] = cnt[threadIdx.x];
}

// Exclusive scan of the block's kScan values, one per thread in thread
// order: this thread's prefix; *total gets the block's sum.  Integer adds,
// so the result does not depend on the order.
__device__ __forceinline__ int block_scan(int v, int* total) {
  __shared__ int wsum[kScan / 32];
  __shared__ int tot;
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
    const int w = wsum[lane];
    int y = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int z = __shfl_up_sync(kFull, y, o);
      if (lane >= o) y += z;
    }
    wsum[lane] = y - w;
    if (lane == 31) tot = y;
  }
  __syncthreads();
  const int r = wsum[warp] + x - v;
  *total = tot;
  __syncthreads();  // wsum and tot may be reused as soon as this returns
  return r;
}

// A scan of in[0, n) (and, with kRuns, of ceil(in[i] / kRun)) in three
// launches: per block of kScan values their sums (scan_reduce), the blocks'
// exclusive offsets in one block (scan_top, kScan at a time with a carry),
// each block's values scanned from its offset (scan_apply); out[n] (and
// runs[n]) get the totals.  part holds 2 (nb + 1) ints, nb = ceil(n / kScan).
template <bool kRuns>
__device__ __forceinline__ int runs_of(int v) {
  return kRuns ? (v + kRun - 1) / kRun : 0;
}

template <bool kRuns>
__global__ void __launch_bounds__(kScan)
scan_reduce(const int32_t* __restrict__ in, int n, int nb, int32_t* __restrict__ part) {
  const int i = blockIdx.x * kScan + threadIdx.x;
  const int v = i < n ? in[i] : 0;
  int t0, t1;
  block_scan(v, &t0);
  block_scan(runs_of<kRuns>(v), &t1);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = t0;
    part[nb + 1 + blockIdx.x] = t1;
  }
}

template <bool kRuns>
__global__ void __launch_bounds__(kScan)
scan_top(int nb, int32_t* __restrict__ part) {
  for (int h = 0; h < (kRuns ? 2 : 1); ++h) {
    int32_t* p = part + h * (nb + 1);
    int carry = 0;
    for (int b0 = 0; b0 < nb; b0 += kScan) {
      const int b = b0 + threadIdx.x;
      const int v = b < nb ? p[b] : 0;
      int t;
      const int r = block_scan(v, &t);
      if (b < nb) p[b] = carry + r;
      carry += t;
    }
    if (threadIdx.x == 0) p[nb] = carry;
  }
}

template <bool kRuns>
__global__ void __launch_bounds__(kScan)
scan_apply(const int32_t* __restrict__ in, int n, int nb, const int32_t* __restrict__ part,
           int32_t* __restrict__ out, int32_t* __restrict__ runs) {
  const int i = blockIdx.x * kScan + threadIdx.x;
  const int v = i < n ? in[i] : 0;
  int t;
  const int r0 = block_scan(v, &t);
  const int r1 = block_scan(runs_of<kRuns>(v), &t);
  if (i < n) {
    out[i] = part[blockIdx.x] + r0;
    if (kRuns) runs[i] = part[nb + 1 + blockIdx.x] + r1;
  }
  if (i == 0) {
    out[n] = part[nb];
    if (kRuns) runs[n] = part[2 * nb + 1];
  }
}

// One warp per tile, its entries in order: each goes after the earlier
// entries of its digit (stable).
__global__ void __launch_bounds__(32)
tile_scatter(const int32_t* __restrict__ key, const int32_t* __restrict__ idx, int n, int shift,
             int nt, const int32_t* __restrict__ hoff, int32_t* __restrict__ key_out,
             int32_t* __restrict__ idx_out) {
  __shared__ int seen[256];
  const int t = blockIdx.x, lane = threadIdx.x;
  for (int b = lane; b < 256; b += 32) seen[b] = 0;
  __syncwarp();
  const int e1 = min(n, (t + 1) * kTile);
  for (int base = t * kTile; base < e1; base += 32) {
    const int e = base + lane;
    const bool in = e < e1;
    const int kv = in ? key[e] : 0;
    const int dig = in ? (kv >> shift) & 255 : 256;
    const unsigned peers = __match_any_sync(kFull, dig);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    const int before = in ? seen[dig] : 0;
    __syncwarp();
    if (in) {
      const int dest = hoff[dig * nt + t] + before + rank;
      key_out[dest] = kv;
      idx_out[dest] = idx[e];
      if (rank == 0) seen[dig] = before + __popc(peers);
    }
    __syncwarp();
  }
}

// Row counts of the sorted keys: the lanes of a warp holding one row add
// their number once (sorted keys come in long runs; integer atomics).
__global__ void __launch_bounds__(kThreads)
count_rows(const int32_t* __restrict__ key, int n, int R, int32_t* __restrict__ cnt) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int k = e < n ? key[e] : R;
  const unsigned peers = __match_any_sync(kFull, k);
  if (k < R && (threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&cnt[k], __popc(peers));
}

// The row of run q (run_start[r] <= q < run_start[r + 1]) and its sorted
// entries [m0, m1); false past the last run.
__device__ __forceinline__ bool find_run(int q, int R, const int32_t* __restrict__ start,
                                         const int32_t* __restrict__ run_start, int& r, int& m0,
                                         int& m1) {
  if (q >= run_start[R]) return false;
  int lo = 0, hi = R;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (run_start[mid] <= q) lo = mid;
    else hi = mid;
  }
  r = lo;
  m0 = start[lo] + (q - run_start[lo]) * kRun;
  m1 = min(start[lo + 1], m0 + kRun);
  return true;
}

// The runs of row r added in order: acc (columns c0 + lane + 32 h below d)
// and, with W > d, the scalars past them.
__device__ __forceinline__ int row_sum(int r, const int32_t* __restrict__ run_start,
                                       const float* __restrict__ part, int d, int W, int lane,
                                       float (&acc)[kMaxH], float (&sc)[4], int c0 = 0) {
#pragma unroll
  for (int h = 0; h < kMaxH; ++h) acc[h] = 0.f;
#pragma unroll
  for (int s = 0; s < 4; ++s) sc[s] = 0.f;
  const int q0 = run_start[r], q1 = run_start[r + 1];
  for (int q = q0; q < q1; ++q) {
    const float* pr = part + (int64_t)q * W;
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) {
      const int c = c0 + lane + 32 * h;
      if (c < d) acc[h] += pr[c];
    }
    for (int s = 0; s < W - d; ++s) sc[s] += pr[d + s];
  }
  return q1 - q0;
}

int64_t runs_bound(int n, int R) { return (int64_t)n / kRun + (R < n ? R : n) + 1; }

unsigned warps_grid(int64_t n) { return (unsigned)((n + kWarps - 1) / kWarps); }

// Carves side x (n entries over R rows, runs of W floats) from a workspace:
// ints(m) / floats(m) hand out the next m words (null pointers when only
// sizing).
template <class Ints, class Floats>
void carve_side(Side& x, int n, int R, int W, Ints ints, Floats floats) {
  x.n = n;
  x.R = R;
  x.W = W;
  x.nt = (x.n + kTile - 1) / kTile;
  x.max_runs = runs_bound(x.n, x.R);
  for (int b = 0; b < 2; ++b) {
    x.key[b] = ints(x.n);
    x.idx[b] = ints(x.n);
  }
  x.hist = ints((int64_t)256 * x.nt);
  x.hoff = ints((int64_t)256 * x.nt + 1);
  x.cnt = ints((int64_t)x.R + 1);
  x.start = ints((int64_t)x.R + 1);
  x.run_start = ints((int64_t)x.R + 1);
  // the scans' block offsets: 2 (nb + 1) ints for the larger of the
  // histogram (256 nt) and the rows (R + 1)
  const int64_t longest = 256 * (int64_t)x.nt > x.R + 1 ? 256 * (int64_t)x.nt : x.R + 1;
  x.part_i = ints(2 * ((longest + kScan - 1) / kScan + 1));
  x.part = floats(x.max_runs * x.W);
  x.sorted = 0;
}

// out[0..n] = the exclusive scan of in[0, n) and its total; with runs, the
// same of the runs of kRun per value.
cudaError_t scan(const int32_t* in, int n, int32_t* part, int32_t* out, int32_t* runs,
                 cudaStream_t st) {
  const int nb = (n + kScan - 1) / kScan;
  if (runs) {
    scan_reduce<true><<<nb, kScan, 0, st>>>(in, n, nb, part);
    CHECK_LAUNCH();
    scan_top<true><<<1, kScan, 0, st>>>(nb, part);
    CHECK_LAUNCH();
    scan_apply<true><<<nb, kScan, 0, st>>>(in, n, nb, part, out, runs);
  } else {
    scan_reduce<false><<<nb, kScan, 0, st>>>(in, n, nb, part);
    CHECK_LAUNCH();
    scan_top<false><<<1, kScan, 0, st>>>(nb, part);
    CHECK_LAUNCH();
    scan_apply<false><<<nb, kScan, 0, st>>>(in, n, nb, part, out, nullptr);
  }
  return cudaGetLastError();
}

// The stable sort by row of the keys and ids in key[0] / idx[0] (skipped when
// presorted: the keys already ascend), then the row counts, starts and run
// starts.
cudaError_t sort_side(Side& x, bool presorted, cudaStream_t st) {
  x.sorted = 0;
  if (x.n == 0) return cudaSuccess;
  cudaError_t err;
  for (int shift = 0; !presorted && shift < 32 && (x.R >> shift) != 0; shift += 8) {
    const int a = x.sorted, b = 1 - a;
    tile_hist<<<x.nt, kThreads, 0, st>>>(x.key[a], x.n, shift, x.nt, x.hist);
    CHECK_LAUNCH();
    err = scan(x.hist, 256 * x.nt, x.part_i, x.hoff, nullptr, st);
    if (err != cudaSuccess) return err;
    tile_scatter<<<x.nt, 32, 0, st>>>(x.key[a], x.idx[a], x.n, shift, x.nt, x.hoff, x.key[b],
                                       x.idx[b]);
    CHECK_LAUNCH();
    x.sorted = b;
  }
  err = cudaMemsetAsync(x.cnt, 0, sizeof(int32_t) * (x.R + 1), st);
  if (err != cudaSuccess) return err;
  count_rows<<<(x.n + kThreads - 1) / kThreads, kThreads, 0, st>>>(x.key[x.sorted], x.n, x.R,
                                                                    x.cnt);
  CHECK_LAUNCH();
  return scan(x.cnt, x.R, x.part_i, x.start, x.run_start, st);
}

}  // namespace
