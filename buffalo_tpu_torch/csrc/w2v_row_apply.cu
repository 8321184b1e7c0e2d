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
// each touched table row read and written once; the sort moves 8 bytes per
// entry a few times.  The L1 update of a brunch stream chunk (294,912
// entries of 4 bytes of key and 128 of row, 163,298 touched rows, d = 32)
// moves ~80 MB, ~24 us of HBM.  Design: row_group.cuh's stable radix
// grouping (as K9 and K12), so the sums have a fixed order and no float
// atomics: a warp per run of kRun
// sorted entries sums its rows (lanes on the columns, the run's entry ids
// read 32 at a time and the rows loaded four ahead), and a warp per touched
// row adds its runs in order, eight loads in flight, caps and writes.  A
// head word with tens of thousands of entries in a chunk is many runs summed
// in parallel, then a few hundred partial rows added by one warp.  A lane
// holds H <= 8 columns (rows up to 256 floats); wider rows take the wide
// instantiation, which walks each row in 256-column chunks (the capped
// rows twice: the norm of the sum first).
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_group.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
make_keys(const int32_t* __restrict__ ka, int na, const int32_t* __restrict__ kb, int nb, int R,
          int32_t* __restrict__ key, int32_t* __restrict__ idx) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= na + nb) return;
  const int k = e < na ? ka[e] : kb[e - na];
  key[e] = k >= 0 && k < R ? k : R;
  idx[e] = e;
}

template <int H>
__device__ __forceinline__ void add_row(const float* __restrict__ row, int d, int lane, float s,
                                        float (&acc)[H]) {
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int c = lane + 32 * h;
    if (c < d) acc[h] += s * row[c];
  }
}

// part[q] = the sum of run q's scaled rows, in entry order.
template <int H, bool kWide>
__global__ void __launch_bounds__(kThreads)
run_sums(const int32_t* __restrict__ idx, int R, const int32_t* __restrict__ start,
         const int32_t* __restrict__ run_start, const float* __restrict__ ra, int na,
         const float* __restrict__ rb, int d, float scale, float* __restrict__ part) {
  const int lane = threadIdx.x & 31, q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  int r, m0, m1;
  if (!find_run(q, R, start, run_start, r, m0, m1)) return;
  for (int k0 = 0; k0 < chunk_end<kWide>(d); k0 += kChunk) {
    const int dk = d - k0;  // the columns from this chunk on
    float acc[H];
#pragma unroll
    for (int h = 0; h < H; ++h) acc[h] = 0.f;
    for (int base = m0; base < m1; base += 32) {
      const int mine = base + lane < m1 ? idx[base + lane] : 0;
      const int cnt = min(32, m1 - base);
#pragma unroll 4
      for (int j = 0; j < cnt; ++j) {
        const int e = __shfl_sync(kFull, mine, j);
        const float* row = e < na ? ra + (int64_t)e * d : rb + (int64_t)(e - na) * d;
        add_row<H>(row + k0, dk, lane, scale, acc);
      }
    }
    float* out = part + (int64_t)q * d + k0;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int c = lane + 32 * h;
      if (c < dk) out[c] = acc[h];
    }
  }
}

// acc = the sum of row r's runs over columns k0 + lane + 32 h, in run order
// with kAhead loads in flight.
template <int H>
__device__ __forceinline__ void sum_runs(int q0, int q1, const float* __restrict__ part, int d,
                                         int k0, int lane, float (&acc)[H]) {
  constexpr int kAhead = 8;
#pragma unroll
  for (int h = 0; h < H; ++h) acc[h] = 0.f;
  for (int q = q0; q < q1; q += kAhead) {
    float v[kAhead][H];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const int c = k0 + lane + 32 * h;
        v[a][h] = q + a < q1 && c < d ? part[(int64_t)(q + a) * d + c] : 0.f;
      }
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      if (q + a < q1) {
#pragma unroll
        for (int h = 0; h < H; ++h) acc[h] += v[a][h];
      }
    }
  }
}

// One warp per table row: its runs added in order, the cap, the write.
template <int H, bool kWide>
__global__ void __launch_bounds__(kThreads)
apply_rows(int R, const int32_t* __restrict__ start, const int32_t* __restrict__ run_start,
           const float* __restrict__ part, int d, float cap, float* __restrict__ T) {
  const int lane = threadIdx.x & 31, r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= R || start[r + 1] == start[r]) return;
  const int q0 = run_start[r], q1 = run_start[r + 1];
  float acc[H];
  float s = 1.f;
  if (kWide && cap > 0.f) {  // the norm of the whole sum first
    float ss = 0.f;
    for (int k0 = 0; k0 < d; k0 += kChunk) {
      sum_runs<H>(q0, q1, part, d, k0, lane, acc);
#pragma unroll
      for (int h = 0; h < H; ++h) ss += acc[h] * acc[h];
    }
    s = fminf(1.f, cap / fmaxf(sqrtf(warp_sum(ss)), 1e-20f));
  }
  float* tr = T + (int64_t)r * d;
  for (int k0 = 0; k0 < chunk_end<kWide>(d); k0 += kChunk) {
    sum_runs<H>(q0, q1, part, d, k0, lane, acc);
    if (!kWide && cap > 0.f) {
      float ss = 0.f;
#pragma unroll
      for (int h = 0; h < H; ++h) ss += acc[h] * acc[h];
      s = fminf(1.f, cap / fmaxf(sqrtf(warp_sum(ss)), 1e-20f));
    }
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int c = k0 + lane + 32 * h;
      if (c < d) tr[c] += cap > 0.f ? acc[h] * s : acc[h];
    }
  }
}

void layout(int n, int R, int d, int32_t* ibase, float* fbase, Side& x, int64_t* isz,
            int64_t* fsz) {
  int64_t io = 0, fo = 0;
  auto ints = [&](int64_t m) {
    int32_t* p = ibase ? ibase + io : nullptr;
    io += m;
    return p;
  };
  auto floats = [&](int64_t m) {
    float* p = fbase ? fbase + fo : nullptr;
    fo += m;
    return p;
  };
  carve_side(x, n, R, d, ints, floats);
  *isz = io;
  *fsz = fo;
}

template <int H, bool kWide = false>
cudaError_t launch(const Side& x, const float* ra, int na, const float* rb, float* T, int d,
                   float scale, float cap, cudaStream_t st) {
  run_sums<H, kWide><<<warps_grid(x.max_runs), kThreads, 0, st>>>(
      x.idx[x.sorted], x.R, x.start, x.run_start, ra, na, rb, d, scale, x.part);
  CHECK_LAUNCH();
  apply_rows<H, kWide><<<warps_grid(x.R), kThreads, 0, st>>>(x.R, x.start, x.run_start, x.part,
                                                             d, cap, T);
  return cudaGetLastError();
}

}  // namespace

// sizes[0]: int32 words, sizes[1]: float32 words of the workspace for n
// entries over R rows of d floats.
extern "C" int w2v_apply_workspace(int n, int R, int d, int64_t* sizes) {
  Side x;
  layout(n, R, d, nullptr, nullptr, x, &sizes[0], &sizes[1]);
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
  Side x;
  int64_t isz, fsz;
  layout(n, R, d, ws_i, ws_f, x, &isz, &fsz);
  make_keys<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(keys_a, na, keys_b, nb, R,
                                                                 x.key[0], x.idx[0]);
  CHECK_LAUNCH();
  const cudaError_t err = sort_side(x, false, st);
  if (err != cudaSuccess) return (int)err;
  cudaError_t e;
  if (d <= 32) e = launch<1>(x, rows_a, na, rows_b, T, d, scale, cap, st);
  else if (d <= 64) e = launch<2>(x, rows_a, na, rows_b, T, d, scale, cap, st);
  else if (d <= 128) e = launch<4>(x, rows_a, na, rows_b, T, d, scale, cap, st);
  else if (d <= kChunk) e = launch<8>(x, rows_a, na, rows_b, T, d, scale, cap, st);
  else e = launch<kMaxH, true>(x, rows_a, na, rows_b, T, d, scale, cap, st);
  return (int)e;
}
