// K15: pLSI's E-step over one batch.  For a row vector a (d floats) and its
// entries (column col_l, value w_l, the other side's row f_l = Bf[col_l]):
//  * summed floor (range and segment modes, the bucket-order layout):
//    norm_l = max(a . f_l, d * 1e-10), An[row] += a * sum_l (w_l / norm_l) f_l;
//  * element floor (padded modes, the fallback path): latent_lz =
//    max(a_z f_lz, 1e-10), norm_l = sum_z latent_lz, An[row] += sum_l
//    latent_l / norm_l * w_l and Qn[col_l] += latent_l / norm_l * w_l;
// and the row's loss -sum_l w_l log(norm_l).  Rows past the table are
// padding and are not written (their entries still reach Qn and the loss,
// as in the reference).
//
// Replaces buffalo_tpu/ops/plsi_kernels.py _estep_block (:111),
// _range_accumulate (:143), _segment_accumulate (:162) and, in the padded
// modes, plsi_accumulate (:23) and _accumulate_chunks (:44).
//
// What bounds it on the card: bytes.  Per entry one gathered row of d
// floats (80 B at d = 20, mostly from L2: ML-20M's P is 11 MB, Q 2 MB) and
// 8 B of ids and values, ~4 d operations; an ML-20M epoch reads both
// orientations' 19.9M entries once.  A warp whose lanes each read an
// entry's row with d scalar loads is held back not by bytes but by load
// instructions (every load of the warp touches 32 rows), by the registers
// of whole rows (16 warps an SM) and by long rows on few warps.
// The team form (rows of up to 32 kTeamFloats floats; the wrapper picks
// the shape, ops/plsi_kernels.py estep_shape): a team of T lanes takes one
// entry, each lane holding F floats of its row as 16- or 4-byte loads (vec:
// what the width and the tables' alignment allow).  On batches at least 32
// wide with rows of up to 32 floats a lane is a team, holding the whole
// row (F = 8, 16, 24 or 32); narrower batches and wider rows take teams of
// kTeamFloats floats a lane.  A group of S lanes (S a power of two from T
// to 32) walks one batch row: it loads the row's column ids and values S
// at a time, one per lane, coalesced, and hands them to its S / T teams by
// shuffles; each team loads kUnrollFloats / F entries' rows before the
// first dot.  A norm is a log2(T)-level xor sum inside the team; at the
// row's end the teams' sums (and the loss, in double) meet in log2(S / T)
// fixed xor levels.  Short rows share a warp: a range batch of width L <=
// 16 puts 32 / S rows on it.  Range and padded rows past 512 entries are
// cut into pieces, a warp each, whose sums a second launch (chunk_rows)
// adds in piece order.  Past the team form's widths the lanes go on the
// columns (a warp walks the entries one at a time, each norm a butterfly
// sum), past 32 kMaxH = 256 floats with the sums in dynamic shared memory.
// A segment batch's head rows (up to ~1M entries at ML-20M) take one block
// per 8192-entry chunk, its warps on consecutive slices of the chunk, the
// warps' sums added in warp order into the chunk's partial; then a block
// per row adds its chunks' partials in chunk order, its warps on slices.
// Loss partials are doubles.  The padded modes' Qn sums group the batch's
// entries by column with row_group.cuh's stable radix sort and add each
// column's runs in entry order.  No float atomics anywhere: every sum has a
// fixed order, so two launches are bitwise equal.  Each entry's norm is
// kept from the first pass so that the second recomputes the same latent
// values.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "row_group.cuh"

namespace {

enum Mode { kRange = 0, kSegment = 1, kPaddedRows = 2, kPaddedSegment = 3 };

// the team form: the rows' floats a lane holds in teams of several lanes
// (one lane an entry holds 8, 16, 24 or 32), and the entries each team
// loads before the first dot: kUnrollFloats / F
constexpr int kTeamFloats = 4;
constexpr int kUnrollFloats = 16;

struct Args {
  int mode;
  float* An;
  int nA;
  const float* A;
  const float* Bf;
  int nB, d, row_start, R;
  const int32_t* rows;
  const int32_t* lens;  // per padded row, or per chunk in the segment modes
  int L;
  const int32_t* cols;
  const float* vals;
  const int32_t* chunk_ptr;
  const int32_t* seg_ids;
  float* loss;
  float* norms;
  float floor_sum;  // d * 1e-10, rounded once from double as the reference's
};

// ---------------------------------------------------------------- teams
// A team lane's F floats of a row: vector v (E floats) is the row's vector
// v T + tl; x[v E + j] its float j.  Vectors past the row read as zeros.
template <int E, int F>
__device__ __forceinline__ void load_team(const float* __restrict__ t, int d, int T, int tl,
                                          float (&x)[F]) {
#pragma unroll
  for (int v = 0; v < F / E; ++v) {
    const int c = (v * T + tl) * E;
    if constexpr (E == 4) {
      const float4 q = c < d ? __ldg(reinterpret_cast<const float4*>(t + c))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      x[4 * v] = q.x;
      x[4 * v + 1] = q.y;
      x[4 * v + 2] = q.z;
      x[4 * v + 3] = q.w;
    } else {
      x[v] = c < d ? __ldg(t + c) : 0.f;
    }
  }
}

// The column of a team lane's float h.
template <int E>
__device__ __forceinline__ int team_col(int h, int T, int tl) {
  return ((h / E) * T + tl) * E + h % E;
}

// A group of S lanes walks one list of n entries (ids cols[e0 + l], values
// vals[e0 + l]); nmax is the longest list of the warp's groups (every lane
// runs the same steps: the shuffles take the whole warp).  gl is the lane
// in the group, its team tg = gl / T and its lane in the team tl = gl % T.
// Each lane sums its floats of the rows into acc and its team's share of
// the loss (lane tl = 0); norms[e0 + l] gets entry l's norm in the
// element-floor form.
template <int E, int F, bool kElem>
__device__ __forceinline__ void walk_team(const Args& g, const float (&a)[F], int64_t e0, int n,
                                          int nmax, int T, int S, int gl, float (&acc)[F],
                                          double& loss) {
  constexpr int U = kUnrollFloats / F > 1 ? kUnrollFloats / F : 1;
  const int NT = S / T, tg = gl / T, tl = gl & (T - 1);
  const int32_t* cols = g.cols + e0;
  const float* vals = g.vals + e0;
  bool colok[F];  // this lane's floats within the row
#pragma unroll
  for (int h = 0; h < F; ++h) colok[h] = team_col<E>(h, T, tl) < g.d;
  for (int base = 0; base < nmax; base += S) {
    const int l = base + gl;
    const int my_col = l < n ? cols[l] : 0;
    const float my_w = l < n ? vals[l] : 0.f;
    for (int j0 = 0; j0 < S; j0 += NT * U) {
      float f[U][F], w[U], s[U];
      bool live[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * NT + tg;  // the entry's lane in the group
        // a lane an entry (T = 1) holds its own entry's id and value
        const int col = T == 1 ? my_col : __shfl_sync(kFull, my_col, j & (S - 1), S);
        w[u] = T == 1 ? my_w : __shfl_sync(kFull, my_w, j & (S - 1), S);
        live[u] = j < S && base + j < n;
        if (live[u]) {
          load_team<E, F>(g.Bf + (int64_t)col * g.d, g.d, T, tl, f[u]);
        } else {
#pragma unroll
          for (int h = 0; h < F; ++h) f[u][h] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u] = 0.f;
#pragma unroll
        for (int h = 0; h < F; ++h) {
          if (kElem) {
            f[u][h] = colok[h] ? fmaxf(a[h] * f[u][h], 1e-10f) : 0.f;
            s[u] += f[u][h];
          } else {
            s[u] = fmaf(a[h], f[u][h], s[u]);
          }
        }
      }
      for (int o = 1; o < T; o <<= 1) {
#pragma unroll
        for (int u = 0; u < U; ++u) s[u] += __shfl_xor_sync(kFull, s[u], o);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float norm = kElem ? s[u] : fmaxf(s[u], g.floor_sum);
        const float gw = live[u] ? w[u] / norm : 0.f;
        if (live[u] && g.loss && tl == 0) loss += (double)(logf(norm) * w[u]);
        if (kElem) {
          if (live[u] && g.norms && tl == 0) g.norms[e0 + base + j0 + u * NT + tg] = norm;
#pragma unroll
          for (int h = 0; h < F; ++h)
            if (live[u]) acc[h] += f[u][h] / norm * w[u];
        } else {
#pragma unroll
          for (int h = 0; h < F; ++h) acc[h] = fmaf(gw, f[u][h], acc[h]);
        }
      }
    }
  }
}

// The teams' sums of a group added in fixed xor levels T, 2 T, ... S / 2
// (the group's lanes of team 0 get the totals; the loss likewise at gl 0).
template <int F>
__device__ __forceinline__ void group_total(float (&acc)[F], double& loss, int T, int S) {
  for (int o = T; o < S; o <<= 1) {
#pragma unroll
    for (int h = 0; h < F; ++h) acc[h] += __shfl_xor_sync(kFull, acc[h], o);
    loss += __shfl_xor_sync(kFull, loss, o);
  }
}

// Range and padded rows cut into pieces of `piece` entries, the team form:
// a warp per (row, piece), its sums into part[row pieces + piece] (d floats)
// and part_loss, which chunk_rows adds in piece order.
template <int E, int F, bool kElem>
__device__ __forceinline__ void row_piece(const Args& g, int T, int piece,
                                          float* __restrict__ part,
                                          double* __restrict__ part_loss) {
  const int lane = threadIdx.x & 31;
  const int pieces = (g.L + piece - 1) / piece;
  const int64_t wi = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (wi >= (int64_t)g.R * pieces) return;
  const int b = (int)(wi / pieces), p = (int)(wi % pieces);
  const int row = g.mode == kRange ? g.row_start + b : g.rows[b];
  const int n = g.lens[b], l0 = min(n, p * piece), l1 = min(n, l0 + piece);
  const int tl = lane & (T - 1);
  float a[F], acc[F];
  load_team<E, F>(g.A + (int64_t)min(row, g.nA - 1) * g.d, g.d, T, tl, a);
#pragma unroll
  for (int h = 0; h < F; ++h) acc[h] = 0.f;
  double loss = 0.0;
  walk_team<E, F, kElem>(g, a, (int64_t)b * g.L + l0, l1 - l0, l1 - l0, T, 32, lane, acc,
                         loss);
  group_total<F>(acc, loss, T, 32);
  if (lane < T) {
#pragma unroll
    for (int h = 0; h < F; ++h) {
      const int c = team_col<E>(h, T, tl);
      if (c < g.d) part[wi * g.d + c] = acc[h];
    }
  }
  if (lane == 0) part_loss[wi] = loss;
}

// Range and padded rows, the team form: 32 / S rows a warp, or (piece > 0)
// a warp per piece of a row.
template <int E, int F, bool kElem>
__global__ void __launch_bounds__(kThreads)
rows_kernel(Args g, int T, int S, int piece, float* __restrict__ part,
            double* __restrict__ part_loss) {
  if (piece > 0) {
    row_piece<E, F, kElem>(g, T, piece, part, part_loss);
    return;
  }
  const int lane = threadIdx.x & 31, per = 32 / S;
  const int b0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * per;
  if (b0 >= g.R) return;  // the whole warp
  const int gl = lane & (S - 1), b = b0 + lane / S;
  const bool live = b < g.R;
  const int row = live ? (g.mode == kRange ? g.row_start + b : g.rows[b]) : g.nA;
  const int n = live ? g.lens[b] : 0;
  int nmax = n;
  for (int o = S; o < 32; o <<= 1) nmax = max(nmax, __shfl_xor_sync(kFull, nmax, o));
  const int tl = gl & (T - 1);
  float a[F], acc[F];
  load_team<E, F>(g.A + (int64_t)min(row, g.nA - 1) * g.d, g.d, T, tl, a);
#pragma unroll
  for (int h = 0; h < F; ++h) acc[h] = 0.f;
  double loss = 0.0;
  walk_team<E, F, kElem>(g, a, (int64_t)b * g.L, n, nmax, T, S, gl, acc, loss);
  group_total<F>(acc, loss, T, S);
  if (!live) return;
  if (g.loss && gl == 0) g.loss[b] = (float)(-loss);
  if (gl >= T || n == 0 || row < 0 || row >= g.nA) return;
  float* out = g.An + (int64_t)row * g.d;
#pragma unroll
  for (int h = 0; h < F; ++h) {
    const int c = team_col<E>(h, T, tl);
    if (c < g.d) out[c] += kElem ? acc[h] : a[h] * acc[h];
  }
}

// Segment modes, pass 1, the team form: one block per chunk c (of local row
// seg_ids[c]); warp w takes the chunk's entries [w S, (w + 1) S), and the
// warps' sums are added in warp order into part[c] (d floats) and
// part_loss[c].
template <int E, int F, bool kElem>
__global__ void __launch_bounds__(kThreads)
chunk_kernel(Args g, int T, float* __restrict__ part, double* __restrict__ part_loss) {
  __shared__ float red[kWarps][32 * kTeamFloats];
  __shared__ double red_loss[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, c = blockIdx.x;
  const int s = g.seg_ids[c];
  const int row = s < g.R ? g.rows[s] : g.nA;
  const int len = g.lens[c];
  const int S = (len + kWarps - 1) / kWarps;
  const int l0 = min(len, warp * S), l1 = min(len, l0 + S);
  const int tl = lane & (T - 1);
  float a[F], acc[F];
  load_team<E, F>(g.A + (int64_t)min(row, g.nA - 1) * g.d, g.d, T, tl, a);
#pragma unroll
  for (int h = 0; h < F; ++h) acc[h] = 0.f;
  double loss = 0.0;
  walk_team<E, F, kElem>(g, a, (int64_t)c * g.L + l0, l1 - l0, l1 - l0, T, 32, lane, acc, loss);
  group_total<F>(acc, loss, T, 32);
  if (lane < T) {
#pragma unroll
    for (int h = 0; h < F; ++h) {
      const int col = team_col<E>(h, T, tl);
      if (col < g.d) red[warp][col] = acc[h];
    }
  }
  if (lane == 0) red_loss[warp] = loss;
  __syncthreads();
  for (int t = threadIdx.x; t < g.d; t += kThreads) {
    float v = red[0][t];
    for (int w = 1; w < kWarps; ++w) v += red[w][t];
    part[(int64_t)c * g.d + t] = v;
  }
  if (threadIdx.x == 0) {
    double tl_sum = 0.0;
    for (int w = 0; w < kWarps; ++w) tl_sum += red_loss[w];
    part_loss[c] = tl_sum;
  }
}

// -------------------------------------------------------------- columns
// A warp's view of a row vector: a lane holds columns lane + 32 h, h < W.
template <int W>
__device__ __forceinline__ void load_vec(const float* __restrict__ t, int d, int lane,
                                         float (&v)[W]) {
#pragma unroll
  for (int h = 0; h < W; ++h) {
    const int c = lane + 32 * h;
    v[h] = c < d ? __ldg(t + c) : 0.f;
  }
}

// Entries [0, n) of one list (ids cols[e0 + l], values vals[e0 + l]) into
// acc and loss, the lanes on the columns (loss the same on every lane);
// norms[e0 + l] gets entry l's norm in the element-floor form.
template <int W, bool kElem>
__device__ __forceinline__ void walk_cols(const Args& g, const float (&a)[W], int lane, int64_t e0,
                                          int n, float (&acc)[W], double& loss) {
  const int32_t* cols = g.cols + e0;
  const float* vals = g.vals + e0;
  for (int l = 0; l < n; ++l) {
    const float w = vals[l];
    float f[W];
    load_vec<W>(g.Bf + (int64_t)cols[l] * g.d, g.d, lane, f);
    float s = 0.f;
#pragma unroll
    for (int h = 0; h < W; ++h) {
      if (kElem) {
        f[h] = lane + 32 * h < g.d ? fmaxf(a[h] * f[h], 1e-10f) : 0.f;
        s += f[h];
      } else {
        s = fmaf(a[h], f[h], s);
      }
    }
    s = warp_sum(s);
    const float norm = kElem ? s : fmaxf(s, g.floor_sum);
    if (g.loss) loss += (double)(logf(norm) * w);
    if (kElem) {
      if (g.norms && lane == 0) g.norms[e0 + l] = norm;
#pragma unroll
      for (int h = 0; h < W; ++h) acc[h] += f[h] / norm * w;
    } else {
      const float gw = w / norm;
#pragma unroll
      for (int h = 0; h < W; ++h) acc[h] = fmaf(gw, f[h], acc[h]);
    }
  }
}

// Range and padded rows, lanes on the columns: one warp per batch row.
template <int W, bool kElem>
__global__ void __launch_bounds__(kThreads) rows_kernel_cols(Args g) {
  const int lane = threadIdx.x & 31, b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= g.R) return;
  const int row = g.mode == kRange ? g.row_start + b : g.rows[b];
  const int n = g.lens[b];
  float a[W], acc[W];
  load_vec<W>(g.A + (int64_t)min(row, g.nA - 1) * g.d, g.d, lane, a);
#pragma unroll
  for (int h = 0; h < W; ++h) acc[h] = 0.f;
  double loss = 0.0;
  walk_cols<W, kElem>(g, a, lane, (int64_t)b * g.L, n, acc, loss);
  if (g.loss && lane == 0) g.loss[b] = (float)(-loss);
  if (n == 0 || row < 0 || row >= g.nA) return;
  float* out = g.An + (int64_t)row * g.d;
#pragma unroll
  for (int h = 0; h < W; ++h) {
    const int c = lane + 32 * h;
    if (c < g.d) out[c] += kElem ? acc[h] : a[h] * acc[h];
  }
}

// Segment modes, pass 1, lanes on the columns: chunk_kernel's blocks and
// slices.
template <int W, bool kElem>
__global__ void __launch_bounds__(kThreads)
chunk_kernel_cols(Args g, float* __restrict__ part, double* __restrict__ part_loss) {
  __shared__ float red[kWarps][32 * kMaxH];
  __shared__ double red_loss[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, c = blockIdx.x;
  const int s = g.seg_ids[c];
  const int row = s < g.R ? g.rows[s] : g.nA;
  const int len = g.lens[c];
  const int S = (len + kWarps - 1) / kWarps;
  const int l0 = min(len, warp * S), l1 = min(len, l0 + S);
  float a[W], acc[W];
  load_vec<W>(g.A + (int64_t)min(row, g.nA - 1) * g.d, g.d, lane, a);
#pragma unroll
  for (int h = 0; h < W; ++h) acc[h] = 0.f;
  double loss = 0.0;
  walk_cols<W, kElem>(g, a, lane, (int64_t)c * g.L + l0, l1 - l0, acc, loss);
#pragma unroll
  for (int h = 0; h < W; ++h) {
    const int col = lane + 32 * h;
    if (col < g.d) red[warp][col] = acc[h];
  }
  if (lane == 0) red_loss[warp] = loss;
  __syncthreads();
  for (int t = threadIdx.x; t < g.d; t += kThreads) {
    float v = red[0][t];
    for (int w = 1; w < kWarps; ++w) v += red[w][t];
    part[(int64_t)c * g.d + t] = v;
  }
  if (threadIdx.x == 0) {
    double tl = 0.0;
    for (int w = 0; w < kWarps; ++w) tl += red_loss[w];
    part_loss[c] = tl;
  }
}

// Wide rows: walk_cols' form with a (the row of A) and
// each f read from global memory in the registers' column order, the sums
// into tot (d floats of the warp's shared slice).
template <bool kElem>
__device__ __forceinline__ void walk_wide(const Args& g, const float* __restrict__ a, int lane,
                                          int64_t e0, int n, float* tot, double& loss) {
  const int32_t* cols = g.cols + e0;
  const float* vals = g.vals + e0;
  const int d = g.d;
  for (int l = 0; l < n; ++l) {
    const float w = vals[l];
    const float* f = g.Bf + (int64_t)cols[l] * d;
    float s = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float af = __ldg(a + c), fc = __ldg(f + c);
      s = kElem ? s + fmaxf(af * fc, 1e-10f) : fmaf(af, fc, s);
    }
    s = warp_sum(s);
    const float norm = kElem ? s : fmaxf(s, g.floor_sum);
    if (g.loss) loss += (double)(logf(norm) * w);
    if (kElem && g.norms && lane == 0) g.norms[e0 + l] = norm;
    const float gw = w / norm;
    for (int c = lane; c < d; c += 32) {
      const float fc = __ldg(f + c);
      tot[c] = kElem ? tot[c] + fmaxf(__ldg(a + c) * fc, 1e-10f) / norm * w
                     : fmaf(gw, fc, tot[c]);
    }
  }
}

// Range and padded rows with wide rows: one warp per batch row.
template <bool kElem>
__global__ void __launch_bounds__(kThreads) rows_kernel_wide(Args g) {
  extern __shared__ float wsm[];  // kWarps x d
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= g.R) return;
  const int row = g.mode == kRange ? g.row_start + b : g.rows[b];
  const int n = g.lens[b], d = g.d;
  const float* a = g.A + (int64_t)min(row, g.nA - 1) * d;
  float* tot = wsm + (int64_t)warp * d;
  for (int c = lane; c < d; c += 32) tot[c] = 0.f;
  __syncwarp();
  double loss = 0.0;
  walk_wide<kElem>(g, a, lane, (int64_t)b * g.L, n, tot, loss);
  __syncwarp();
  if (g.loss && lane == 0) g.loss[b] = (float)(-loss);
  if (n > 0 && row >= 0 && row < g.nA) {
    float* out = g.An + (int64_t)row * d;
    for (int c = lane; c < d; c += 32) out[c] += kElem ? tot[c] : a[c] * tot[c];
  }
}

// Segment modes, pass 1, wide rows: chunk_kernel with each warp's sums in
// its shared slice, added in warp order.
template <bool kElem>
__global__ void __launch_bounds__(kThreads)
chunk_kernel_wide(Args g, float* __restrict__ part, double* __restrict__ part_loss) {
  extern __shared__ float wsm[];  // kWarps x d
  __shared__ double red_loss[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, c = blockIdx.x;
  const int s = g.seg_ids[c], d = g.d;
  const int row = s < g.R ? g.rows[s] : g.nA;
  const int len = g.lens[c];
  const int S = (len + kWarps - 1) / kWarps;
  const int l0 = min(len, warp * S), l1 = min(len, l0 + S);
  float* tot = wsm + (int64_t)warp * d;
  for (int t = lane; t < d; t += 32) tot[t] = 0.f;
  __syncwarp();
  double loss = 0.0;
  walk_wide<kElem>(g, g.A + (int64_t)min(row, g.nA - 1) * d, lane, (int64_t)c * g.L + l0,
                   l1 - l0, tot, loss);
  if (lane == 0) red_loss[warp] = loss;
  __syncthreads();
  for (int t = threadIdx.x; t < d; t += kThreads) {
    float v = wsm[t];
    for (int w = 1; w < kWarps; ++w) v += wsm[(int64_t)w * d + t];
    part[(int64_t)c * d + t] = v;
  }
  if (threadIdx.x == 0) {
    double tl = 0.0;
    for (int w = 0; w < kWarps; ++w) tl += red_loss[w];
    part_loss[c] = tl;
  }
}

// Pass 2 (the segment modes, and range or padded rows cut into pieces): a
// block per row, warp w adding a contiguous slice of the row's partials in
// order (4 partials' loads in flight), the warps' sums added in warp order;
// then An[row] += the sums (times a in the summed-floor form) and the row's
// loss.  pieces > 0: row r's partials are [r pieces, (r + 1) pieces) and its
// table row that of its mode; else chunk_ptr's.
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
chunk_rows(Args g, const float* __restrict__ part, const double* __restrict__ part_loss,
           int elem, int pieces) {
  constexpr int kBatch = 4;
  __shared__ float red[kWarps][kChunk];
  __shared__ double red_loss[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, r = blockIdx.x;
  int row, c0, c1;
  if (pieces > 0) {
    row = g.mode == kRange ? g.row_start + r : g.rows[r];
    c0 = r * pieces;
    c1 = c0 + pieces;
  } else {
    row = g.rows[r];
    c0 = g.chunk_ptr[r];
    c1 = g.chunk_ptr[r + 1];
  }
  const int per = (c1 - c0 + kWarps - 1) / kWarps;
  const int w0 = min(c1, c0 + warp * per), w1 = min(c1, w0 + per);
  const bool write = c1 > c0 && row >= 0 && row < g.nA;
  for (int k0 = 0; k0 < chunk_end<kWide>(g.d); k0 += kChunk) {
    float t[kMaxH];
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) t[h] = 0.f;
    double tl = 0.0;
    for (int c = w0; c < w1; c += kBatch) {
      float v[kBatch][kMaxH];
      double lv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const bool in = c + u < w1;
#pragma unroll
        for (int h = 0; h < kMaxH; ++h) {
          const int col = k0 + lane + 32 * h;
          v[u][h] = in && col < g.d ? part[(int64_t)(c + u) * g.d + col] : 0.f;
        }
        lv[u] = in && k0 == 0 ? part_loss[c + u] : 0.0;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
#pragma unroll
        for (int h = 0; h < kMaxH; ++h) t[h] += v[u][h];
        tl += lv[u];
      }
    }
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) {
      const int col = lane + 32 * h;
      if (k0 + col < g.d) red[warp][col] = t[h];
    }
    if (lane == 0) red_loss[warp] = tl;
    __syncthreads();
    for (int col = threadIdx.x; col < kChunk && k0 + col < g.d; col += kThreads) {
      float v = red[0][col];
      for (int w = 1; w < kWarps; ++w) v += red[w][col];
      const int64_t at = (int64_t)row * g.d + k0 + col;
      if (write) g.An[at] += elem ? v : g.A[at] * v;
    }
    if (k0 == 0 && threadIdx.x == 0 && g.loss) {
      double sum = 0.0;
      for (int w = 0; w < kWarps; ++w) sum += red_loss[w];
      g.loss[r] = (float)(-sum);
    }
    __syncthreads();
  }
}

// The padded modes' Qn side: entry e lives (keyed by its column) when it is
// within its list's length; dead entries are keyed past the table.
__global__ void __launch_bounds__(kThreads)
make_keys(const int32_t* __restrict__ lens, const int32_t* __restrict__ cols, int L, int n,
          int R, int32_t* __restrict__ key, int32_t* __restrict__ idx) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  const int b = e / L;
  key[e] = e - b * L < lens[b] ? cols[e] : R;
  idx[e] = e;
}

// part[q] = the run's latent rows summed in entry order (the same values
// as the first pass: the row's a, the column's q, the kept norm).
// (kWide: H = kMaxH columns per lane per 256-column chunk of the row.)
template <int H, bool kWide>
__global__ void __launch_bounds__(kThreads)
q_runs(const int32_t* __restrict__ idx, const int32_t* __restrict__ start,
       const int32_t* __restrict__ run_start, Args g, float* __restrict__ part) {
  const int lane = threadIdx.x & 31, q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  int r, m0, m1;
  if (!find_run(q, g.nB, start, run_start, r, m0, m1)) return;
  for (int k0 = 0; k0 < chunk_end<kWide>(g.d); k0 += kChunk) {
    const int dk = g.d - k0;  // the columns from this chunk on
    float qv[H], acc[H];
    load_vec<H>(g.Bf + (int64_t)r * g.d + k0, dk, lane, qv);
#pragma unroll
    for (int h = 0; h < H; ++h) acc[h] = 0.f;
    for (int m = m0; m < m1; ++m) {
      const int e = idx[m];
      const int b = e / g.L;
      int row;
      if (g.mode == kPaddedRows) {
        row = g.rows[b];
      } else {
        const int s = g.seg_ids[b];
        row = s < g.R ? g.rows[s] : g.nA;
      }
      float p[H];
      load_vec<H>(g.A + (int64_t)min(row, g.nA - 1) * g.d + k0, dk, lane, p);
      const float norm = g.norms[e], w = g.vals[e];
#pragma unroll
      for (int h = 0; h < H; ++h)
        if (lane + 32 * h < dk) acc[h] += fmaxf(p[h] * qv[h], 1e-10f) / norm * w;
    }
    float* out = part + (int64_t)q * g.d + k0;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int c = lane + 32 * h;
      if (c < dk) out[c] = acc[h];
    }
  }
}

// One warp per column of Qn: its runs added in order.
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
q_add(int R, const int32_t* __restrict__ start, const int32_t* __restrict__ run_start,
      const float* __restrict__ part, int d, float* __restrict__ Qn) {
  const int lane = threadIdx.x & 31, r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= R || start[r + 1] == start[r]) return;
  float acc[kMaxH], sc[4];
  float* out = Qn + (int64_t)r * d;
  for (int k0 = 0; k0 < chunk_end<kWide>(d); k0 += kChunk) {
    row_sum(r, run_start, part, d, d, lane, acc, sc, k0);
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) {
      const int c = k0 + lane + 32 * h;
      if (c < d) out[c] += acc[h];
    }
  }
}

// f(integral_constant<int, W>): lanes on the columns with W = 2, 4 or 8
// columns each (rows of up to 256 floats).
template <class F>
cudaError_t with_cols(int d, F f) {
  if (d <= 64) return f(std::integral_constant<int, 2>());
  if (d <= 128) return f(std::integral_constant<int, 4>());
  return f(std::integral_constant<int, 8>());
}

// f(integral_constant<int, E>, integral_constant<int, F>) for the team
// form's loads of E (4 or 1) floats and F (4, 8, 16, 24 or 32) floats a
// lane.
template <class Fn>
cudaError_t with_team(int vec, int lane_floats, Fn f) {
  using std::integral_constant;
  const auto floats = [&](auto e) {
    switch (lane_floats) {
      case 8: return f(e, integral_constant<int, 8>());
      case 16: return f(e, integral_constant<int, 16>());
      case 24: return f(e, integral_constant<int, 24>());
      case 32: return f(e, integral_constant<int, 32>());
      default: return f(e, integral_constant<int, 4>());
    }
  };
  return vec == 4 ? floats(integral_constant<int, 4>()) : floats(integral_constant<int, 1>());
}

// f(integral_constant<int, H>) for the columns per lane H (1, 2, 4, 8).
template <class F>
cudaError_t with_h(int d, F f) {
  if (d <= 32) return f(std::integral_constant<int, 1>());
  if (d <= 64) return f(std::integral_constant<int, 2>());
  if (d <= 128) return f(std::integral_constant<int, 4>());
  return f(std::integral_constant<int, 8>());
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

}  // namespace

// sizes[0]: int32 words, sizes[1]: float32 words of the padded modes'
// workspace for n entries over a Qn of R rows.
extern "C" int plsi_estep_workspace(int n, int R, int d, int64_t* sizes) {
  Side x;
  layout(n, R, d, nullptr, nullptr, x, &sizes[0], &sizes[1]);
  return 0;
}

// 1 when rows of d floats take the wide instantiation.
extern "C" int plsi_estep_wide(int d) { return d > 32 * kMaxH ? 1 : 0; }


// mode: 0 range (rows [row_start, + R) of An / A), 1 segment (rows[R] with
// chunk_ptr[R + 1], seg_ids; lens per chunk), 2 padded rows (rows[R]), 3
// padded segment (as 1).  n_lists lists of L entries in cols / vals.  loss
// (one float per row) may be null in modes 0-1.  Modes 2-3 take Qn (Bf's
// shape), norms (n_lists L floats) and the workspace; modes 1 and 3 the
// chunk partials seg_part (n_lists d floats) and seg_loss (n_lists doubles).
// team > 0: the team form with teams of `team` lanes holding `lane_floats`
// floats each (4, 8, 16, 24 or 32), groups of
// `group` lanes a row (range and padded rows; 32 in the segment modes) and
// loads of `vec` floats (4 or 1: d and the tables' addresses multiples of
// it); team 0: lanes on the columns.
extern "C" int plsi_estep(int mode, float* An, int nA, const float* A, const float* Bf, int nB,
                          int d, int row_start, int R, const int32_t* rows, const int32_t* lens,
                          int L, const int32_t* cols, const float* vals, const int32_t* chunk_ptr,
                          const int32_t* seg_ids, float* loss, float* Qn, int n_lists,
                          float* norms, int32_t* ws_i, float* ws_f, float* seg_part,
                          double* seg_loss, int team, int group, int lane_floats, int vec,
                          int piece, void* stream) {
  const bool padded = mode == kPaddedRows || mode == kPaddedSegment;
  const bool seg = mode == kSegment || mode == kPaddedSegment;
  const int64_t n = (int64_t)n_lists * L;
  const auto pow2 = [](int v) { return v > 0 && (v & (v - 1)) == 0; };
  const uintptr_t at = (uintptr_t)An | (uintptr_t)A | (uintptr_t)Bf;
  const bool floats_ok = lane_floats == kTeamFloats || lane_floats == 8 || lane_floats == 16 ||
                         lane_floats == 24 || lane_floats == 32;
  const bool team_ok =
      team == 0 || (pow2(team) && team <= 32 && floats_ok && team * lane_floats >= d &&
                    pow2(group) && team <= group && group <= 32 && (vec == 1 || vec == 4) &&
                    d % vec == 0 && at % (sizeof(float) * vec) == 0 && (!seg || group == 32) &&
                    d <= 32 * kTeamFloats &&
                    (piece == 0 || (!seg && group == 32 && seg_part && seg_loss)));
  if (mode < 0 || mode > 3 || d < 1 || nA < 1 || nB < 1 || L < 1 ||
      n >= (1LL << 31) || (padded && (!Qn || !norms || !ws_i || !ws_f || !loss)) ||
      (seg && (!chunk_ptr || !seg_ids || !seg_part || !seg_loss)) || (mode != kRange && !rows) ||
      !team_ok || piece < 0 || (piece > 0 && team == 0))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const Args g{mode, An, nA, A, Bf, nB, d, row_start, R, rows, lens, L, cols, vals, chunk_ptr,
               seg_ids, loss, padded ? norms : nullptr, (float)((double)d * 1e-10)};
  const bool wide = plsi_estep_wide(d);
  if (wide && team > 0) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (wide) {
    // each warp's sums in its slice of dynamic shared memory
    const size_t smem = sizeof(float) * (size_t)kWarps * d;
    if (smem > 48 * 1024) {
      const void* kernels[] = {(const void*)rows_kernel_wide<true>,
                               (const void*)rows_kernel_wide<false>,
                               (const void*)chunk_kernel_wide<true>,
                               (const void*)chunk_kernel_wide<false>};
      for (const void* k : kernels) {
        err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
      }
    }
    if (seg) {
      if (n_lists > 0) {
        if (padded)
          chunk_kernel_wide<true><<<n_lists, kThreads, smem, st>>>(g, seg_part, seg_loss);
        else
          chunk_kernel_wide<false><<<n_lists, kThreads, smem, st>>>(g, seg_part, seg_loss);
        CHECK_LAUNCH();
      }
      chunk_rows<true><<<R, kThreads, 0, st>>>(g, seg_part, seg_loss, padded ? 1 : 0, 0);
    } else {
      if (padded) rows_kernel_wide<true><<<warps_grid(R), kThreads, smem, st>>>(g);
      else rows_kernel_wide<false><<<warps_grid(R), kThreads, smem, st>>>(g);
    }
    err = cudaGetLastError();
  } else if (team > 0) {
    err = with_team(vec, lane_floats, [&](auto e, auto f) {
      constexpr int kE = decltype(e)::value, kF = decltype(f)::value;
      if (seg) {
        if (n_lists > 0) {
          if (padded)
            chunk_kernel<kE, kF, true><<<n_lists, kThreads, 0, st>>>(g, team, seg_part,
                                                                     seg_loss);
          else
            chunk_kernel<kE, kF, false><<<n_lists, kThreads, 0, st>>>(g, team, seg_part,
                                                                      seg_loss);
          CHECK_LAUNCH();
        }
        chunk_rows<false><<<R, kThreads, 0, st>>>(g, seg_part, seg_loss, padded ? 1 : 0, 0);
      } else {
        const int pieces = piece > 0 ? (L + piece - 1) / piece : 0;
        const unsigned grid = piece > 0 ? warps_grid((int64_t)R * pieces)
                                        : warps_grid(((int64_t)R * group + 31) / 32);
        if (padded)
          rows_kernel<kE, kF, true><<<grid, kThreads, 0, st>>>(g, team, group, piece, seg_part,
                                                               seg_loss);
        else
          rows_kernel<kE, kF, false><<<grid, kThreads, 0, st>>>(g, team, group, piece, seg_part,
                                                                seg_loss);
        if (piece > 0) {
          CHECK_LAUNCH();
          chunk_rows<false><<<R, kThreads, 0, st>>>(g, seg_part, seg_loss, padded ? 1 : 0,
                                                    pieces);
        }
      }
      return cudaGetLastError();
    });
  } else err = with_cols(d, [&](auto w) {
    constexpr int kW = decltype(w)::value;
    if (seg) {
      if (n_lists > 0) {
        if (padded)
          chunk_kernel_cols<kW, true><<<n_lists, kThreads, 0, st>>>(g, seg_part, seg_loss);
        else
          chunk_kernel_cols<kW, false><<<n_lists, kThreads, 0, st>>>(g, seg_part, seg_loss);
        CHECK_LAUNCH();
      }
      chunk_rows<false><<<R, kThreads, 0, st>>>(g, seg_part, seg_loss, padded ? 1 : 0, 0);
    } else {
      if (padded) rows_kernel_cols<kW, true><<<warps_grid(R), kThreads, 0, st>>>(g);
      else rows_kernel_cols<kW, false><<<warps_grid(R), kThreads, 0, st>>>(g);
    }
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;
  if (!padded || n == 0) return 0;
  Side x;
  int64_t isz, fsz;
  layout((int)n, nB, d, ws_i, ws_f, x, &isz, &fsz);
  make_keys<<<(x.n + kThreads - 1) / kThreads, kThreads, 0, st>>>(lens, cols, L, x.n, x.R,
                                                                   x.key[0], x.idx[0]);
  CHECK_LAUNCH();
  err = sort_side(x, false, st);
  if (err != cudaSuccess) return (int)err;
  if (wide) {
    q_runs<kMaxH, true><<<warps_grid(x.max_runs), kThreads, 0, st>>>(
        x.idx[x.sorted], x.start, x.run_start, g, x.part);
    CHECK_LAUNCH();
    q_add<true><<<warps_grid(nB), kThreads, 0, st>>>(nB, x.start, x.run_start, x.part, d, Qn);
    return (int)cudaGetLastError();
  }
  err = with_h(d, [&](auto h) {
    q_runs<decltype(h)::value, false><<<warps_grid(x.max_runs), kThreads, 0, st>>>(
        x.idx[x.sorted], x.start, x.run_start, g, x.part);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;
  q_add<false><<<warps_grid(nB), kThreads, 0, st>>>(nB, x.start, x.run_start, x.part, d, Qn);
  return (int)cudaGetLastError();
}
