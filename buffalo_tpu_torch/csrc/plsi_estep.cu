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
// orientations' 19.9M entries once.  Design: one warp per row of a range or
// padded batch.  For d <= 32 (pLSI's default is 20) the lanes take the
// entries: lane i owns entries i, i + 32, ... and keeps a and its own sum
// of d floats in registers, so 32 gathers are in flight at once, and the
// lanes' sums meet in a fixed xor-butterfly at the row's end.  Wider rows
// put the lanes on the columns (a warp walks the entries one at a time,
// each norm a butterfly sum).  A segment batch's head rows (up to ~1M
// entries at ML-20M) take one block per 8192-entry chunk, its warps on
// consecutive slices of the chunk, the warps' sums added in warp order into
// the chunk's partial; then one warp per row adds its chunks' partials in
// chunk order (K2's chunk mode).  Loss partials are doubles.  The padded
// modes' Qn sums group the batch's entries by column with row_group.cuh's
// stable radix sort and add each column's runs in entry order.  No float
// atomics anywhere: two launches are bitwise equal.  Each entry's norm is
// kept from the first pass so that the second recomputes the same latent
// values.  Rows past 32 kMaxH = 256 floats take the wide instantiation:
// lanes on the columns, the rows read from global memory (L1) in the same
// column order, each warp's sums in dynamic shared memory (d floats), the
// Qn runs and rows walked in 256-column chunks.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "row_group.cuh"

namespace {

enum Mode { kRange = 0, kSegment = 1, kPaddedRows = 2, kPaddedSegment = 3 };

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

__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <bool kEntries>
__device__ __forceinline__ int column(int h, int lane) {
  return kEntries ? h : lane + 32 * h;
}

// A warp's view of a row vector: kEntries, every lane holds all W >= d
// floats (lanes over the entries); else a lane holds columns lane + 32 h,
// h < W (lanes over the columns).
template <int W, bool kEntries>
__device__ __forceinline__ void load_vec(const float* __restrict__ t, int d, int lane,
                                         float (&v)[W]) {
#pragma unroll
  for (int h = 0; h < W; ++h) {
    const int c = column<kEntries>(h, lane);
    v[h] = c < d ? __ldg(t + c) : 0.f;
  }
}

// Entries [0, n) of one list (ids cols[e0 + l], values vals[e0 + l]) into
// acc and loss, the lanes on the entries or on the columns; norms[e0 + l]
// gets entry l's norm in the element-floor form.  With lanes on the
// columns, loss is the same on every lane.
template <int W, bool kEntries, bool kElem>
__device__ __forceinline__ void walk(const Args& g, const float (&a)[W], int lane, int64_t e0,
                                     int n, float (&acc)[W], double& loss) {
  const int32_t* cols = g.cols + e0;
  const float* vals = g.vals + e0;
  for (int l = kEntries ? lane : 0; l < n; l += kEntries ? 32 : 1) {
    const float w = vals[l];
    float f[W];
    load_vec<W, kEntries>(g.Bf + (int64_t)cols[l] * g.d, g.d, lane, f);
    float s = 0.f;
#pragma unroll
    for (int h = 0; h < W; ++h) {
      if (kElem) {
        f[h] = column<kEntries>(h, lane) < g.d ? fmaxf(a[h] * f[h], 1e-10f) : 0.f;
        s += f[h];
      } else {
        s = fmaf(a[h], f[h], s);
      }
    }
    if (!kEntries) s = warp_sum(s);
    const float norm = kElem ? s : fmaxf(s, g.floor_sum);
    if (g.loss) loss += (double)(logf(norm) * w);
    if (kElem) {
      if (g.norms && (kEntries || lane == 0)) g.norms[e0 + l] = norm;
#pragma unroll
      for (int h = 0; h < W; ++h) acc[h] += f[h] / norm * w;
    } else {
      const float gw = w / norm;
#pragma unroll
      for (int h = 0; h < W; ++h) acc[h] = fmaf(gw, f[h], acc[h]);
    }
  }
}

// With lanes on the entries, the lanes' sums added by a fixed butterfly
// (every lane gets them); the loss likewise.
template <int W, bool kEntries>
__device__ __forceinline__ void warp_total(float (&acc)[W], double& loss) {
  if (!kEntries) return;
#pragma unroll
  for (int h = 0; h < W; ++h) acc[h] = warp_sum(acc[h]);
  loss = warp_sum_d(loss);
}

// An[row] += the sums (times a in the summed-floor form).
template <int W, bool kEntries>
__device__ __forceinline__ void add_out(const Args& g, int row, const float (&a)[W],
                                        const float (&tot)[W], bool elem, int lane) {
  float* out = g.An + (int64_t)row * g.d;
#pragma unroll
  for (int h = 0; h < W; ++h) {
    const int c = column<kEntries>(h, lane);
    if (c < g.d && (!kEntries || lane == h)) out[c] += elem ? tot[h] : a[h] * tot[h];
  }
}

// Range and padded rows: one warp per batch row.
template <int W, bool kEntries, bool kElem>
__global__ void __launch_bounds__(kThreads) rows_kernel(Args g) {
  const int lane = threadIdx.x & 31, b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= g.R) return;
  const int row = g.mode == kRange ? g.row_start + b : g.rows[b];
  const int n = g.lens[b];
  float a[W], acc[W];
  load_vec<W, kEntries>(g.A + (int64_t)min(row, g.nA - 1) * g.d, g.d, lane, a);
#pragma unroll
  for (int h = 0; h < W; ++h) acc[h] = 0.f;
  double loss = 0.0;
  walk<W, kEntries, kElem>(g, a, lane, (int64_t)b * g.L, n, acc, loss);
  warp_total<W, kEntries>(acc, loss);
  if (g.loss && lane == 0) g.loss[b] = (float)(-loss);
  if (n > 0 && row >= 0 && row < g.nA) add_out<W, kEntries>(g, row, a, acc, kElem, lane);
}

// Segment modes, pass 1: one block per chunk c (of local row seg_ids[c]);
// warp w takes the chunk's entries [w S, (w + 1) S), and the warps' sums
// are added in warp order into part[c] (d floats) and part_loss[c].
template <int W, bool kEntries, bool kElem>
__global__ void __launch_bounds__(kThreads)
chunk_kernel(Args g, float* __restrict__ part, double* __restrict__ part_loss) {
  __shared__ float red[kWarps][32 * kMaxH];
  __shared__ double red_loss[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, c = blockIdx.x;
  const int s = g.seg_ids[c];
  const int row = s < g.R ? g.rows[s] : g.nA;
  const int len = g.lens[c];
  const int S = (len + kWarps - 1) / kWarps;
  const int l0 = min(len, warp * S), l1 = min(len, l0 + S);
  float a[W], acc[W];
  load_vec<W, kEntries>(g.A + (int64_t)min(row, g.nA - 1) * g.d, g.d, lane, a);
#pragma unroll
  for (int h = 0; h < W; ++h) acc[h] = 0.f;
  double loss = 0.0;
  walk<W, kEntries, kElem>(g, a, lane, (int64_t)c * g.L + l0, l1 - l0, acc, loss);
  warp_total<W, kEntries>(acc, loss);
#pragma unroll
  for (int h = 0; h < W; ++h) {
    const int col = column<kEntries>(h, lane);
    if (col < g.d && (!kEntries || lane == h)) red[warp][col] = acc[h];
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

// Wide rows: walk's lanes-on-the-columns form with a (the row of A) and
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

// Segment modes, pass 2: one warp per row, its chunks' partials added in
// chunk order, then An[row] += the sums (times a in the summed-floor form).
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
chunk_rows(Args g, const float* __restrict__ part, const double* __restrict__ part_loss,
           int elem) {
  const int lane = threadIdx.x & 31, r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= g.R) return;
  const int row = g.rows[r], c0 = g.chunk_ptr[r], c1 = g.chunk_ptr[r + 1];
  double tl = 0.0;
  for (int k0 = 0; k0 < chunk_end<kWide>(g.d); k0 += kChunk) {
    float t[kMaxH];
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) t[h] = 0.f;
    for (int c = c0; c < c1; ++c) {
#pragma unroll
      for (int h = 0; h < kMaxH; ++h) {
        const int col = k0 + lane + 32 * h;
        if (col < g.d) t[h] += part[(int64_t)c * g.d + col];
      }
      if (k0 == 0) tl += part_loss[c];
    }
    if (k0 == 0 && g.loss && lane == 0) g.loss[r] = (float)(-tl);
    if (c1 == c0 || row < 0 || row >= g.nA) return;
    const float* ar = g.A + (int64_t)row * g.d;
    float* out = g.An + (int64_t)row * g.d;
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) {
      const int col = k0 + lane + 32 * h;
      if (col < g.d) out[col] += elem ? t[h] : ar[col] * t[h];
    }
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
    load_vec<H, false>(g.Bf + (int64_t)r * g.d + k0, dk, lane, qv);
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
      load_vec<H, false>(g.A + (int64_t)min(row, g.nA - 1) * g.d + k0, dk, lane, p);
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

// f(integral_constant<int, W>, integral_constant<bool, kEntries>): lanes on
// the entries with rows of W = 8, 16, 24 or 32 >= d floats, or (d > 32) on
// the columns with W = 2, 4 or 8 columns each.
template <class F>
cudaError_t with_layout(int d, F f) {
  using T = std::true_type;
  using N = std::false_type;
  if (d <= 8) return f(std::integral_constant<int, 8>(), T());
  if (d <= 16) return f(std::integral_constant<int, 16>(), T());
  if (d <= 24) return f(std::integral_constant<int, 24>(), T());
  if (d <= 32) return f(std::integral_constant<int, 32>(), T());
  if (d <= 64) return f(std::integral_constant<int, 2>(), N());
  if (d <= 128) return f(std::integral_constant<int, 4>(), N());
  return f(std::integral_constant<int, 8>(), N());
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
extern "C" int plsi_estep(int mode, float* An, int nA, const float* A, const float* Bf, int nB,
                          int d, int row_start, int R, const int32_t* rows, const int32_t* lens,
                          int L, const int32_t* cols, const float* vals, const int32_t* chunk_ptr,
                          const int32_t* seg_ids, float* loss, float* Qn, int n_lists,
                          float* norms, int32_t* ws_i, float* ws_f, float* seg_part,
                          double* seg_loss, void* stream) {
  const bool padded = mode == kPaddedRows || mode == kPaddedSegment;
  const bool seg = mode == kSegment || mode == kPaddedSegment;
  const int64_t n = (int64_t)n_lists * L;
  if (mode < 0 || mode > 3 || d < 1 || nA < 1 || nB < 1 || L < 1 ||
      n >= (1LL << 31) || (padded && (!Qn || !norms || !ws_i || !ws_f || !loss)) ||
      (seg && (!chunk_ptr || !seg_ids || !seg_part || !seg_loss)) || (mode != kRange && !rows))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const Args g{mode, An, nA, A, Bf, nB, d, row_start, R, rows, lens, L, cols, vals, chunk_ptr,
               seg_ids, loss, padded ? norms : nullptr, (float)((double)d * 1e-10)};
  const bool wide = plsi_estep_wide(d);
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
      chunk_rows<true><<<warps_grid(R), kThreads, 0, st>>>(g, seg_part, seg_loss, padded ? 1 : 0);
    } else {
      if (padded) rows_kernel_wide<true><<<warps_grid(R), kThreads, smem, st>>>(g);
      else rows_kernel_wide<false><<<warps_grid(R), kThreads, smem, st>>>(g);
    }
    err = cudaGetLastError();
  } else err = with_layout(d, [&](auto w, auto entries) {
    constexpr int kW = decltype(w)::value;
    constexpr bool kE = decltype(entries)::value;
    if (seg) {
      if (n_lists > 0) {
        if (padded)
          chunk_kernel<kW, kE, true><<<n_lists, kThreads, 0, st>>>(g, seg_part, seg_loss);
        else
          chunk_kernel<kW, kE, false><<<n_lists, kThreads, 0, st>>>(g, seg_part, seg_loss);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return e;
      }
      chunk_rows<false><<<warps_grid(R), kThreads, 0, st>>>(g, seg_part, seg_loss,
                                                           padded ? 1 : 0);
    } else {
      if (padded) rows_kernel<kW, kE, true><<<warps_grid(R), kThreads, 0, st>>>(g);
      else rows_kernel<kW, kE, false><<<warps_grid(R), kThreads, 0, st>>>(g);
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
