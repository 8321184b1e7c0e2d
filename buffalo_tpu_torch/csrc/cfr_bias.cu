// K18: CoFactor's closed-form bias after the solve.  For batch row b with
// entries on either side (total[b] > 0) and table row rows[b] inside X, x =
// X[rows[b]] is the row K3 has just written; over its explicit entries
// (column col, value v, gathered row c):
//   bias[rows[b]] = sum (v - x . c - cbias[col]) / (len + 1e-10),
// written whatever len is (0 for a row without explicit entries); and, when
// asked (the user phase), loss[b] += reg_new |x|^2.
//
// Replaces buffalo_tpu/ops/cfr_kernels.py the bias and masked write of
// _cfr_item_body (:146-154), _cfr_context_body (:584-593) and the segment
// bodies' ends (:270-281, :314-322), and _cfr_user_body's loss (:73).
//
// What bounds it on the card: bytes, one gathered row of d floats per
// explicit entry (mostly from L2) and 8 bytes of ids and values, ~2 d
// operations.  Design: one warp per row walking its entries (a segment
// row's chunks in order).  For d <= 32 (CoFactor's benchmark width) the
// lanes take the entries: lane i owns entries i, i + 32, ... with x in
// registers, so 32 gathers are in flight at once; wider rows put the lanes
// on the columns (each dot a fixed xor-butterfly sum).  The bias is summed
// in double and the lanes' sums meet in a fixed butterfly: no atomics, two
// launches are bitwise equal.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kMaxH = 4;  // columns per lane of the narrow forms: d <= 128

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

struct Args {
  const float* X;
  int n, d;
  const int32_t* rows;
  int R;
  const int32_t* total;
  const float* F;
  const int32_t* lens;
  const int32_t* chunk_ptr;
  const int32_t* chunk_lens;
  const int32_t* cols;
  const float* vals;
  int L;
  const float* cbias;
  float* bias;
  float reg_new;
  float* loss;
};

// kEntries: lanes over the entries with rows of D >= d floats per lane;
// else lanes over the columns, D = 32 kMaxH.
template <int D, bool kEntries>
__global__ void __launch_bounds__(kThreads) bias_kernel(Args g) {
  constexpr int N = kEntries ? D : kMaxH;  // floats of x per lane
  const int lane = threadIdx.x & 31, b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= g.R) return;
  const int row = g.rows[b];
  if (g.total[b] <= 0 || row < 0 || row >= g.n) return;
  const float* xr = g.X + (int64_t)row * g.d;
  float x[N];
  float x2 = 0.f;
#pragma unroll
  for (int h = 0; h < N; ++h) {
    const int c = kEntries ? h : lane + 32 * h;
    x[h] = c < g.d ? xr[c] : 0.f;
    x2 = fmaf(x[h], x[h], x2);
  }
  if (g.loss) {
    const float s = kEntries ? x2 : warp_sum(x2);
    if (lane == 0) g.loss[b] += g.reg_new * s;
  }
  if (!g.F) return;
  int c0 = b, c1 = b + 1;
  if (g.chunk_ptr) {
    c0 = g.chunk_ptr[b];
    c1 = g.chunk_ptr[b + 1];
  }
  double sum = 0.0;
  for (int ch = c0; ch < c1; ++ch) {
    const int len = g.chunk_ptr ? g.chunk_lens[ch] : g.lens[b];
    const int32_t* cc = g.cols + (int64_t)ch * g.L;
    const float* vv = g.vals + (int64_t)ch * g.L;
    for (int e = kEntries ? lane : 0; e < len; e += kEntries ? 32 : 1) {
      const int col = cc[e];
      const float* f = g.F + (int64_t)col * g.d;
      float part = 0.f;
#pragma unroll
      for (int h = 0; h < N; ++h) {
        const int c = kEntries ? h : lane + 32 * h;
        if (c < g.d) part = fmaf(x[h], __ldg(f + c), part);
      }
      const float dot = kEntries ? part : warp_sum(part);
      if (kEntries || lane == 0) sum += (double)(vv[e] - dot - g.cbias[col]);
    }
  }
  sum = warp_sum_d(sum);
  if (lane == 0) g.bias[row] = (float)sum / ((float)g.lens[b] + 1e-10f);
}

// Rows past 32 kMaxH floats: the lanes over the columns, the row x read from
// global memory (L1) in the registers' column order for its norm and each
// entry's dot.
__global__ void __launch_bounds__(kThreads) bias_kernel_wide(Args g) {
  const int lane = threadIdx.x & 31, b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= g.R) return;
  const int row = g.rows[b];
  if (g.total[b] <= 0 || row < 0 || row >= g.n) return;
  const float* xr = g.X + (int64_t)row * g.d;
  if (g.loss) {
    float x2 = 0.f;
    for (int c = lane; c < g.d; c += 32) x2 = fmaf(xr[c], xr[c], x2);
    const float s = warp_sum(x2);
    if (lane == 0) g.loss[b] += g.reg_new * s;
  }
  if (!g.F) return;
  int c0 = b, c1 = b + 1;
  if (g.chunk_ptr) {
    c0 = g.chunk_ptr[b];
    c1 = g.chunk_ptr[b + 1];
  }
  double sum = 0.0;
  for (int ch = c0; ch < c1; ++ch) {
    const int len = g.chunk_ptr ? g.chunk_lens[ch] : g.lens[b];
    const int32_t* cc = g.cols + (int64_t)ch * g.L;
    const float* vv = g.vals + (int64_t)ch * g.L;
    for (int e = 0; e < len; ++e) {
      const int col = cc[e];
      const float* f = g.F + (int64_t)col * g.d;
      float part = 0.f;
      for (int c = lane; c < g.d; c += 32) part = fmaf(xr[c], __ldg(f + c), part);
      const float dot = warp_sum(part);
      if (lane == 0) sum += (double)(vv[e] - dot - g.cbias[col]);
    }
  }
  sum = warp_sum_d(sum);
  if (lane == 0) g.bias[row] = (float)sum / ((float)g.lens[b] + 1e-10f);
}

}  // namespace

// 1 when rows of d floats take the wide instantiation.
extern "C" int cfr_bias_wide(int d) { return d > 32 * kMaxH ? 1 : 0; }

// The explicit side (F, lens, chunk_ptr, chunk_lens, cols, vals, L) with
// cbias and bias, or F null (no bias); loss null unless reg_new is used.
extern "C" int cfr_bias(const float* X, int n, int d, const int32_t* rows, int R,
                        const int32_t* total, const float* F, const int32_t* lens,
                        const int32_t* chunk_ptr, const int32_t* chunk_lens,
                        const int32_t* cols, const float* vals, int L, const float* cbias,
                        float* bias, float reg_new, float* loss, void* stream) {
  if (d < 1 || n < 1 || R < 0 || (F && (!bias || !cbias || !lens)) ||
      (!F && !loss))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  const Args g{X, n, d, rows, R, total, F, lens, chunk_ptr, chunk_lens, cols, vals, L,
               cbias, bias, reg_new, loss};
  const unsigned grid = (R + kWarps - 1) / kWarps;
  const cudaStream_t st = (cudaStream_t)stream;
  if (d <= 8) bias_kernel<8, true><<<grid, kThreads, 0, st>>>(g);
  else if (d <= 16) bias_kernel<16, true><<<grid, kThreads, 0, st>>>(g);
  else if (d <= 32) bias_kernel<32, true><<<grid, kThreads, 0, st>>>(g);
  else if (d <= 32 * kMaxH) bias_kernel<32 * kMaxH, false><<<grid, kThreads, 0, st>>>(g);
  else bias_kernel_wide<<<grid, kThreads, 0, st>>>(g);
  return (int)cudaGetLastError();
}
