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
// launch sums in the same order every time.  The members of each cell are
// ordered by row (a counting sort): per chunk of kChunk rows a histogram of
// the cells (integer shared-memory atomics, exact), an ordered scan of the
// histograms into each (chunk, cell)'s first slot, then one warp per chunk
// walks its rows in order and places each after the earlier rows of its cell
// (__match_any_sync ranks).  The sorted members are then summed in runs of
// at most kRun, a run never crossing a cell, one block per run (so a cell of
// 100,000 members is spread over ~800 blocks instead of one), and one block
// per cell adds its runs' sums in order and applies the epilogue.  Six
// launches of one call.  Past 227 KB of per-cell counters (58,112 cells) the
// counts are global integer atomics on the chunk's histogram row, and the
// placement advances each (chunk, cell) offset in place; past 512 columns
// the epilogue writes the mean and scales it in a second pass.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 2048;  // rows per histogram / placement block
constexpr int kRun = 128;     // members per partial sum
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kMaxD = 2 * kThreads;  // a thread owns columns j and j + 256 (narrow)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// hist[b][c]: rows of chunk b in cell c with nonzero norm; member[r] flags them.
// kGlobal: the counts go to hist directly (zeroed by the caller).
template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
cell_histogram(const float* __restrict__ unit, const int32_t* __restrict__ assign, int N, int D,
               int C, int32_t* __restrict__ hist, uint8_t* __restrict__ member) {
  extern __shared__ int shared_counts[];
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* counts = kGlobal ? hist + (int64_t)b * C : shared_counts;
  if (!kGlobal) {
    for (int c = threadIdx.x; c < C; c += kThreads) counts[c] = 0;
    __syncthreads();
  }
  const int r0 = b * kChunk, r1 = min(N, r0 + kChunk);
  for (int r = r0 + warp; r < r1; r += kWarps) {
    const float* row = unit + (int64_t)r * D;
    float ss = 0.f;
    for (int j = lane; j < D; j += 32) ss = fmaf(row[j], row[j], ss);
    const bool in = warp_sum(ss) > 0.f;
    if (lane == 0) {
      member[r] = in;
      if (in) atomicAdd(&counts[assign[r]], 1);
    }
  }
  if (kGlobal) return;
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) hist[(int64_t)b * C + c] = counts[c];
}

// Per cell: total members and, in place of hist, each chunk's offset within
// the cell (chunks in order).
__global__ void __launch_bounds__(kThreads)
cell_offsets(int32_t* __restrict__ hist, int nb, int C, int32_t* __restrict__ total) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  int run = 0;
  for (int b = 0; b < nb; ++b) {
    const int h = hist[(int64_t)b * C + c];
    hist[(int64_t)b * C + c] = run;
    run += h;
  }
  total[c] = run;
}

// Exclusive scans over the cells (one block, thread t a contiguous range of
// cells): start = of the member counts, run_start = of the runs per cell.
__global__ void __launch_bounds__(1024)
cell_starts(const int32_t* __restrict__ total, int C, int32_t* __restrict__ start,
            int32_t* __restrict__ run_start) {
  __shared__ int part[2][1024];
  const int per = (C + 1023) / 1024, c0 = threadIdx.x * per, c1 = min(C, c0 + per);
  int s = 0, r = 0;
  for (int c = c0; c < c1; ++c) {
    s += total[c];
    r += (total[c] + kRun - 1) / kRun;
  }
  part[0][threadIdx.x] = s;
  part[1][threadIdx.x] = r;
  __syncthreads();
  if (threadIdx.x < 2) {
    int acc = 0;
    for (int t = 0; t < 1024; ++t) {
      const int v = part[threadIdx.x][t];
      part[threadIdx.x][t] = acc;
      acc += v;
    }
    (threadIdx.x == 0 ? start : run_start)[C] = acc;
  }
  __syncthreads();
  s = part[0][threadIdx.x];
  r = part[1][threadIdx.x];
  for (int c = c0; c < c1; ++c) {
    start[c] = s;
    run_start[c] = r;
    s += total[c];
    r += (total[c] + kRun - 1) / kRun;
  }
}

// One warp per chunk, its rows in order: perm[start[c] + offset[b][c] + rank]
// = r, rank counting the chunk's earlier members of cell c (kGlobal: counted
// by advancing offset[b][c] itself).
template <bool kGlobal>
__global__ void __launch_bounds__(32)
place_members(const int32_t* __restrict__ assign, const uint8_t* __restrict__ member, int N,
              int C, int32_t* __restrict__ offset, const int32_t* __restrict__ start,
              int32_t* __restrict__ perm) {
  extern __shared__ int shared_seen[];
  const int b = blockIdx.x, lane = threadIdx.x;
  int* seen = kGlobal ? offset + (int64_t)b * C : shared_seen;
  if (!kGlobal) {
    for (int c = lane; c < C; c += 32) seen[c] = 0;
    __syncwarp();
  }
  const int r0 = b * kChunk, r1 = min(N, r0 + kChunk);
  for (int base = r0; base < r1; base += 32) {
    const int r = base + lane;
    const bool in = r < r1 && member[r];
    const int c = in ? assign[r] : -1;
    const unsigned peers = __match_any_sync(kFull, c);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    const int before = in ? seen[c] : 0;
    __syncwarp();
    if (in) {
      perm[start[c] + (kGlobal ? 0 : offset[(int64_t)b * C + c]) + before + rank] = r;
      if (rank == 0) seen[c] = before + __popc(peers);
    }
    __syncwarp();
  }
}

// Block q: run q of the sorted members (the cell found by a binary search of
// run_start), column j of its sum by thread j (and j + 256), members in row
// order.  Blocks past the last run return.
__global__ void __launch_bounds__(kThreads)
run_sums(const float* __restrict__ unit, int D, int C, const int32_t* __restrict__ start,
         const int32_t* __restrict__ run_start, const int32_t* __restrict__ perm,
         float* __restrict__ part) {
  const int q = blockIdx.x;
  if (q >= run_start[C]) return;
  int lo = 0, hi = C;  // the cell c with run_start[c] <= q < run_start[c + 1]
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (run_start[mid] <= q) lo = mid;
    else hi = mid;
  }
  const int m0 = start[lo] + (q - run_start[lo]) * kRun;
  const int m1 = min(start[lo + 1], m0 + kRun);
  __shared__ int rows[kRun];
  for (int m = m0 + threadIdx.x; m < m1; m += kThreads) rows[m - m0] = perm[m];
  __syncthreads();
  for (int j = threadIdx.x; j < D; j += kThreads) {
    float s = 0.f;
#pragma unroll 8
    for (int m = 0; m < m1 - m0; ++m) s += unit[(int64_t)rows[m] * D + j];
    part[(int64_t)q * D + j] = s;
  }
}

// One block per cell: its runs' sums added in order, the mean (the old
// centroid where the cell has no members), normalized.
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
cell_means(const float* __restrict__ old, int D, const int32_t* __restrict__ start,
           const int32_t* __restrict__ run_start, const float* __restrict__ part,
           float* __restrict__ out) {
  __shared__ float red[kWarps];
  const int c = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = start[c + 1] - start[c], q0 = run_start[c], q1 = run_start[c + 1];
  float val[2] = {0.f, 0.f};
  float ss = 0.f;
  if (kWide) {  // every column of the thread, the means kept in out
    for (int col = threadIdx.x; col < D; col += kThreads) {
      float s = 0.f;
      for (int q = q0; q < q1; ++q) s += part[(int64_t)q * D + col];
      const float m = n > 0 ? s / (float)n : old[(int64_t)c * D + col];
      out[(int64_t)c * D + col] = m;
      ss = fmaf(m, m, ss);
    }
  }
#pragma unroll
  for (int h = 0; h < 2 && !kWide; ++h) {
    const int col = threadIdx.x + h * kThreads;
    if (col < D) {
      float s = 0.f;
      for (int q = q0; q < q1; ++q) s += part[(int64_t)q * D + col];
      val[h] = n > 0 ? s / (float)n : old[(int64_t)c * D + col];
      ss = fmaf(val[h], val[h], ss);
    }
  }
  ss = warp_sum(ss);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  float norm2 = 0.f;
  for (int w = 0; w < kWarps; ++w) norm2 += red[w];
  const float scale = 1.f / fmaxf(sqrtf(norm2), 1e-12f);
  if (kWide) {
    for (int col = threadIdx.x; col < D; col += kThreads) out[(int64_t)c * D + col] *= scale;
    return;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = threadIdx.x + h * kThreads;
    if (col < D) out[(int64_t)c * D + col] = val[h] * scale;
  }
}

}  // namespace

// 1 when C cells' counters take the global form (past 227 KB of shared
// memory).
extern "C" int kmeans_update_global_counts(int C) {
  return sizeof(int) * (size_t)C > 227 * 1024 ? 1 : 0;
}

// scratch (allocated by the caller): hist nb * C, total C, start C + 1,
// run_start C + 1 int32; member N bytes; perm N int32; part (N / 128 + C + 1)
// * D floats; nb = ceil(N / 2048).
extern "C" int kmeans_update(const float* unit, const int32_t* assign, const float* old, int N,
                             int D, int C, int32_t* hist, int32_t* total, int32_t* start,
                             int32_t* run_start, uint8_t* member, int32_t* perm, float* part,
                             float* out, void* stream) {
  if (C == 0) return 0;
  if (D < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int nb = (N + kChunk - 1) / kChunk;
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
  if (nb > 0) {
    if (global) {
      err = cudaMemsetAsync(hist, 0, sizeof(int32_t) * (size_t)nb * C, st);
      if (err != cudaSuccess) return (int)err;
      cell_histogram<true><<<nb, kThreads, 0, st>>>(unit, assign, N, D, C, hist, member);
    } else {
      cell_histogram<false><<<nb, kThreads, cbytes, st>>>(unit, assign, N, D, C, hist, member);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  cell_offsets<<<(C + kThreads - 1) / kThreads, kThreads, 0, st>>>(hist, nb, C, total);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  cell_starts<<<1, 1024, 0, st>>>(total, C, start, run_start);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (nb > 0) {
    if (global) place_members<true><<<nb, 32, 0, st>>>(assign, member, N, C, hist, start, perm);
    else place_members<false><<<nb, 32, cbytes, st>>>(assign, member, N, C, hist, start, perm);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    // at most N / kRun + C runs: every cell's last run may be short
    run_sums<<<N / kRun + C, kThreads, 0, st>>>(unit, D, C, start, run_start, perm, part);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (D > kMaxD) cell_means<true><<<C, kThreads, 0, st>>>(old, D, start, run_start, part, out);
  else cell_means<false><<<C, kThreads, 0, st>>>(old, D, start, run_start, part, out);
  return (int)cudaGetLastError();
}
