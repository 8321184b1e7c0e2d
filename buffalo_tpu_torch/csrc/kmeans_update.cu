// K7: the k-means cell update.  Given unit rows (N, D) and each row's cell
// (from K5 at k = 1), the new centroid of cell c is the mean of its member
// rows, normalized (norm floored at 1e-12); a cell with no members keeps its
// old centroid.  Rows of zero norm weigh 0: they join no cell.
//
// Replaces the update half of buffalo_tpu/parallel/ann.py lloyd (:220):
// the per-chunk segment_sum of the weighted rows and counts (:228-234) and the
// mean + normalize epilogue (:238-241).
//
// What bounds it on the card: reading the rows (4 N D bytes, 204 MB for the
// 505,840 x 101 augmented KakaoBrunch table, 0.06 ms) and the assignment; the
// operations are N D adds.  Design: deterministic, with no float atomics, so a
// launch sums in the same order every time, and the table read once.  The
// members of each cell are ordered by row (a counting sort over the
// assignment alone): per chunk of kChunk rows a histogram of the cells
// (integer shared-memory atomics, exact); the (chunk, cell) offsets by a
// block per 32 cells, its warps on slices of the chunks, and the cell starts
// and each run's (cell, first slot, rows) by the last of those blocks to
// finish; then a block per chunk, a thread per row, places each row after
// the earlier rows of its cell (its warp's __match_any_sync ranks, the warps
// in turn).  The sorted members are summed in runs of at most `run` rows of
// one cell, one block per run, a thread per column adding every row in row
// order from global memory and marking the rows whose squares it sees
// positive (a row weighs 1 when marked: a float32 sum of squares is positive
// exactly when one square is; a run holding a row of zero norm sums its
// columns again over the marked rows).  The last run of a cell to finish (an
// integer counter per cell) adds the cell's runs' sums and counts in run
// order and writes the normalized mean; the blocks past the last run write
// the empty cells' old centroids, normalized.  Four launches.  Past 227 KB
// of per-cell counters (58,112 cells) the histogram counts with global
// integer atomics into its zeroed row (a memset more) and the placement
// advances each (chunk, cell) offset in place; past 512 columns the epilogue
// writes the mean and scales it in a second pass.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 512;              // rows per histogram / placement block
constexpr int kRun = 128;                // members per partial sum at most
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kScanThreads = 1024, kScanWarps = kScanThreads / 32;
constexpr int kMaxD = 2 * kThreads;  // a thread owns columns j and j + 256 (narrow)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The workspace's int32 arrays, carved in order from one allocation.
struct Work {
  int nb;
  int64_t run_blocks;
  int32_t *run_info, *hist, *total, *start, *run_start, *done, *run_cnt, *perm, *counter;
};

int64_t run_blocks(int N, int C, int run) { return (int64_t)N / run + C + 1; }

// Carves the workspace (null base: sizes only); returns its int32 words.
int64_t carve(int32_t* base, int N, int C, int run, Work& w) {
  int64_t o = 0;
  auto take = [&](int64_t m) {
    int32_t* p = base ? base + o : nullptr;
    o += m;
    return p;
  };
  w.nb = (N + kChunk - 1) / kChunk;
  w.run_blocks = run_blocks(N, C, run);
  w.run_info = take(4 * w.run_blocks);  // per run: cell, first slot, rows, cell's first run
  w.hist = take((int64_t)w.nb * C);     // [chunk][cell]: counts, then offsets
  w.total = take(C);
  w.start = take((int64_t)C + 1);
  w.run_start = take((int64_t)C + 1);
  w.done = take(C);
  w.run_cnt = take(w.run_blocks);
  w.perm = take(N);
  w.counter = take(1);
  return o;
}

// hist[b][c]: the rows of chunk b in cell c (assign alone; cells outside
// [0, C) join none).  kGlobal: the counts go to hist directly (zeroed by the
// caller).  Block 0 zeroes the scan's counter.
template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
cell_histogram(const int32_t* __restrict__ assign, int N, int C, int nb,
               int32_t* __restrict__ hist, int32_t* __restrict__ counter) {
  extern __shared__ int counts[];
  const int b = blockIdx.x;
  if (b == 0 && threadIdx.x == 0) *counter = 0;
  if (b >= nb) return;
  int32_t* row = hist + (int64_t)b * C;
  if (!kGlobal) {
    for (int c = threadIdx.x; c < C; c += kThreads) counts[c] = 0;
    __syncthreads();
  }
  const int r1 = min(N, (b + 1) * kChunk);
  for (int r = b * kChunk + threadIdx.x; r < r1; r += kThreads) {
    const int c = assign[r];
    if (c >= 0 && c < C) atomicAdd(kGlobal ? row + c : counts + c, 1);
  }
  if (kGlobal) return;
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) row[c] = counts[c];
}

// Exclusive scan of the block's values, one per thread in thread order:
// this thread's prefix; *total gets the block's sum (integer adds).
__device__ __forceinline__ int block_scan(int v, int* total) {
  __shared__ int wsum[kScanWarps];
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
  __syncthreads();  // wsum and tot are reused by the next call
  return r;
}

// A block per 32 cells (lane = cell), its warps on consecutive slices of the
// chunks: hist[b][c] becomes chunk b's first slot within cell c (chunks in
// order), total[c] the cell's rows, done[c] 0.  The last block to finish
// scans the totals into start (rows) and run_start (runs of `run`), and
// writes each run's (cell, first slot, rows, the cell's first run).
__global__ void __launch_bounds__(kScanThreads)
cell_scan(int32_t* __restrict__ hist, int nb, int C, int run, int32_t* __restrict__ total,
          int32_t* __restrict__ start, int32_t* __restrict__ run_start,
          int32_t* __restrict__ done, int4* __restrict__ run_info,
          int32_t* __restrict__ counter) {
  constexpr int kBatch = 8;
  __shared__ int part[kScanWarps][33];
  __shared__ int ticket;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const bool live = c < C;
  const int per = (nb + kScanWarps - 1) / kScanWarps;
  const int b0 = min(nb, warp * per), b1 = min(nb, b0 + per);
  int s = 0;
  if (live) {
    for (int b = b0; b < b1; b += kBatch) {
      int h[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) h[k] = b + k < b1 ? hist[(int64_t)(b + k) * C + c] : 0;
#pragma unroll
      for (int k = 0; k < kBatch; ++k) s += h[k];
    }
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0) {
    int r = 0;
    for (int w = 0; w < kScanWarps; ++w) {
      const int v = part[w][lane];
      part[w][lane] = r;
      r += v;
    }
    if (live) {
      total[c] = r;
      done[c] = 0;
    }
  }
  __syncthreads();
  if (live) {
    int off = part[warp][lane];
    for (int b = b0; b < b1; b += kBatch) {
      int h[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) h[k] = b + k < b1 ? hist[(int64_t)(b + k) * C + c] : 0;
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (b + k < b1) hist[(int64_t)(b + k) * C + c] = off;
        off += h[k];
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) ticket = atomicAdd(counter, 1);
  __syncthreads();
  if (ticket != (int)gridDim.x - 1) return;
  __threadfence();
  int carry_s = 0, carry_r = 0;
  for (int c0 = 0; c0 < C; c0 += kScanThreads) {
    const int cc = c0 + threadIdx.x;
    const int v = cc < C ? __ldcg(total + cc) : 0;
    int ts, tr;
    const int nr = (v + run - 1) / run;
    const int es = block_scan(v, &ts);
    const int er = block_scan(nr, &tr);
    if (cc < C) {
      const int s0 = carry_s + es, q0 = carry_r + er;
      start[cc] = s0;
      run_start[cc] = q0;
      for (int k = 0; k < nr; ++k)
        run_info[q0 + k] = make_int4(cc, s0 + k * run, min(run, v - k * run), q0);
    }
    carry_s += ts;
    carry_r += tr;
  }
  if (threadIdx.x == 0) {
    start[C] = carry_s;
    run_start[C] = carry_r;
  }
}

// A block per chunk, a thread per row: perm[start[c] + offset[b][c] + the
// chunk's earlier rows of cell c] = r, the warps in turn (kGlobal: the
// earlier rows counted by advancing offset[b][c] itself, else in shared
// memory).
template <bool kGlobal>
__global__ void __launch_bounds__(kChunk)
place_members(const int32_t* __restrict__ assign, int N, int C, int32_t* __restrict__ hist,
              const int32_t* __restrict__ start, int32_t* __restrict__ perm) {
  extern __shared__ int seen[];
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = b * kChunk + threadIdx.x;
  int c = r < N ? assign[r] : -1;
  if (c >= C) c = -1;
  const unsigned peers = __match_any_sync(kFull, c);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  int base = 0;
  if (c >= 0) {
    base = start[c] + (kGlobal ? 0 : hist[(int64_t)b * C + c]);
    if (!kGlobal) seen[c] = 0;
  }
  __syncthreads();
  for (int w = 0; w < kChunk / 32; ++w) {
    if (warp == w) {
      volatile int* sp = c < 0 ? nullptr : kGlobal ? hist + (int64_t)b * C + c : seen + c;
      const int before = c < 0 ? 0 : *sp;
      __syncwarp();
      if (c >= 0) {
        perm[base + before + rank] = r;
        if (rank == 0) *sp = before + __popc(peers);
      }
    }
    __syncthreads();
  }
}

// Cell c's new centroid from its runs [q0, q1) (read through L2: other
// blocks wrote them): the runs' sums and counts added in order, the mean
// (the old centroid where no row counts), normalized with a 1e-12 floor.
__device__ void cell_epilogue(int c, int q0, int q1, int D, const float* __restrict__ old,
                              const float* part, const int32_t* run_cnt,
                              float* __restrict__ out) {
  __shared__ float red[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int n = 0;
  for (int q = q0; q < q1; ++q) n += __ldcg(run_cnt + q);
  float* o = out + (int64_t)c * D;
  const float* prev = old + (int64_t)c * D;
  auto mean = [&](int col) {
    float s = 0.f;
    for (int q = q0; q < q1; ++q) s += __ldcg(part + (int64_t)q * D + col);
    return n > 0 ? s / (float)n : prev[col];
  };
  float val[2] = {0.f, 0.f};
  float ss = 0.f;
  if (D > kMaxD) {  // every column of the thread, the means kept in out
    for (int col = threadIdx.x; col < D; col += kThreads) {
      const float m = mean(col);
      o[col] = m;
      ss = fmaf(m, m, ss);
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = threadIdx.x + h * kThreads;
      if (col < D) {
        val[h] = mean(col);
        ss = fmaf(val[h], val[h], ss);
      }
    }
  }
  ss = warp_sum(ss);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  float norm2 = 0.f;
  for (int w = 0; w < kWarps; ++w) norm2 += red[w];
  __syncthreads();  // red is reused by the next call
  const float scale = 1.f / fmaxf(sqrtf(norm2), 1e-12f);
  if (D > kMaxD) {
    for (int col = threadIdx.x; col < D; col += kThreads) o[col] *= scale;
    return;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = threadIdx.x + h * kThreads;
    if (col < D) o[col] = val[h] * scale;
  }
}

// Block q < run_start[C]: run q of the sorted members (cell, first slot,
// rows and the cell's first run from run_info); thread j sums column j (and
// j + kThreads, ...) of the run's rows in row order, read from global
// memory kUnrollRows rows ahead, every row added, and marks per 32-row word
// the rows whose squares it sees positive (the warp's marks OR-ed into
// shared words).  A row counts when marked: a float32 sum of squares is
// positive exactly when one square is.  Where a row is not marked (rows of
// zero norm, rare), the columns are summed again over the marked rows
// alone.  The cell's last run to finish writes its centroid; the blocks
// past the last run write the empty cells'.
__global__ void __launch_bounds__(kThreads)
run_sums(const float* __restrict__ unit, const float* __restrict__ old, int D, int C,
                const int32_t* __restrict__ start, const int32_t* __restrict__ run_start,
                const int4* __restrict__ run_info, const int32_t* __restrict__ perm, float* part,
                int32_t* run_cnt, int32_t* __restrict__ done, float* __restrict__ out) {
  constexpr int kUnrollRows = 8;
  __shared__ int rows[kRun];
  __shared__ unsigned marks[kRun / 32];
  __shared__ int last;
  const int q = blockIdx.x, lane = threadIdx.x & 31;
  const int nruns = run_start[C];
  if (q >= nruns) {
    const int stride = (int)gridDim.x - nruns;
    for (int c = q - nruns; c < C; c += stride)
      if (start[c + 1] == start[c]) cell_epilogue(c, 0, 0, D, old, part, run_cnt, out);
    return;
  }
  const int4 info = run_info[q];  // cell, first slot, rows, the cell's first run
  const int c = info.x, m0 = info.y, nm = info.z, q0 = info.w, q1 = run_start[c + 1];
  for (int m = threadIdx.x; m < nm; m += kThreads) rows[m] = perm[m0 + m];
  if (threadIdx.x < kRun / 32) marks[threadIdx.x] = 0u;
  __syncthreads();
  for (int j0 = 0; j0 < D; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    const bool col = j < D;
    float s = 0.f;
    for (int w = 0; w * 32 < nm; ++w) {
      const int m1 = min(nm, w * 32 + 32);
      unsigned mark = 0u;
#pragma unroll kUnrollRows
      for (int m = w * 32; m < m1; ++m) {
        const float x = col ? __ldg(unit + (int64_t)rows[m] * D + j) : 0.f;
        s += x;
        mark |= (x * x > 0.f ? 1u : 0u) << (m & 31);
      }
      mark = __reduce_or_sync(kFull, mark);
      if (lane == 0 && mark) atomicOr(marks + w, mark);
    }
    if (col) part[(int64_t)q * D + j] = s;
  }
  __syncthreads();
  int n = 0;
  for (int w = 0; w * 32 < nm; ++w) n += __popc(marks[w]);
  if (n < nm) {  // rows of zero norm: the marked rows alone
    for (int j = threadIdx.x; j < D; j += kThreads) {
      float s = 0.f;
      for (int m = 0; m < nm; ++m)
        if ((marks[m >> 5] >> (m & 31)) & 1u) s += __ldg(unit + (int64_t)rows[m] * D + j);
      part[(int64_t)q * D + j] = s;
    }
  }
  if (threadIdx.x == 0) run_cnt[q] = n;
  __threadfence();
  __syncthreads();
  if (q1 - q0 > 1) {
    if (threadIdx.x == 0) last = atomicAdd(done + c, 1) == q1 - q0 - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
  }
  cell_epilogue(c, q0, q1, D, old, part, run_cnt, out);
}

}  // namespace

// 1 when C cells' counters take the global form (past 227 KB of shared
// memory).
extern "C" int kmeans_update_global_counts(int C) {
  return sizeof(int) * (size_t)C > 227 * 1024 ? 1 : 0;
}


// sizes[0]: int32 words of the workspace for N rows in C cells and runs of
// `run`; sizes[1]: float32 words of the run sums (D each).
extern "C" int kmeans_update_workspace(int N, int D, int C, int run, int64_t* sizes) {
  Work w;
  sizes[0] = carve(nullptr, N, C, run, w);
  sizes[1] = w.run_blocks * D;
  return 0;
}

// ws: kmeans_update_workspace's int32 words (16-byte aligned), part its
// float32 words; run: the members a run block sums (1 to kRun;
// ops/retrieval_kernels.py kmeans_plan picks it).
extern "C" int kmeans_update(const float* unit, const int32_t* assign, const float* old, int N,
                             int D, int C, int run, int32_t* ws, float* part, float* out,
                             void* stream) {
  if (C == 0) return 0;
  if (D < 1 || N < 0 || run < 1 || run > kRun || (uintptr_t)ws % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  Work w;
  carve(ws, N, C, run, w);
  const bool global = kmeans_update_global_counts(C);
  const size_t cbytes = global ? 0 : sizeof(int) * C;
  cudaError_t err;
  if (cbytes > 48 * 1024) {
    err = cudaFuncSetAttribute(cell_histogram<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cbytes);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(place_members<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cbytes);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned hist_blocks = w.nb > 0 ? w.nb : 1;  // block 0 zeroes the counter
  if (global) {
    if (w.nb > 0) {
      err = cudaMemsetAsync(w.hist, 0, sizeof(int32_t) * (size_t)w.nb * C, st);
      if (err != cudaSuccess) return (int)err;
    }
    cell_histogram<true><<<hist_blocks, kThreads, 0, st>>>(assign, N, C, w.nb, w.hist,
                                                           w.counter);
  } else {
    cell_histogram<false><<<hist_blocks, kThreads, cbytes, st>>>(assign, N, C, w.nb, w.hist,
                                                                 w.counter);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  int4* run_info = reinterpret_cast<int4*>(w.run_info);
  cell_scan<<<(C + 31) / 32, kScanThreads, 0, st>>>(w.hist, w.nb, C, run, w.total, w.start,
                                                    w.run_start, w.done, run_info, w.counter);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (w.nb > 0) {
    if (global)
      place_members<true><<<w.nb, kChunk, 0, st>>>(assign, N, C, w.hist, w.start, w.perm);
    else
      place_members<false><<<w.nb, kChunk, cbytes, st>>>(assign, N, C, w.hist, w.start, w.perm);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  run_sums<<<(unsigned)w.run_blocks, kThreads, 0, st>>>(unit, old, D, C, w.start, w.run_start,
                                                      run_info, w.perm, part, w.run_cnt, w.done,
                                                      out);
  return (int)cudaGetLastError();
}
