// K16: pLSI's M-step, in place on the accumulated tables: P's rows get
// add_p (times p_mask[r] when masks are given) and are divided by their sum;
// Q's rows get add_q (times q_mask[r]) and its columns are divided by their
// sums over every row.  A zero sum divides by 1, so an empty row or column
// stays zero instead of NaN.
//
// Replaces buffalo_tpu/ops/plsi_kernels.py _mstep (:209, the permuted tables
// with the masks of their real rows; add_q = alpha2 / the real item count)
// and plsi_normalize_swap (:313, every row; add_q = alpha2 / Q's rows).
//
// What bounds it on the card: bytes, both tables read and written once
// (Q read twice: its column sums come first), a few operations per element.
// Design: one warp per row of P (a fixed xor-butterfly sum); Q's column
// sums in double, per block of 256 rows (8 warps over the rows, a lane per
// column, the warps' sums added in warp order) and over the blocks in block
// order by one block, so the sums do not depend on the launch and are
// within a rounding of the exact sum; then an elementwise pass.  Rows up to
// kMaxD floats sit in registers (P) or one shared tile of column sums (Q);
// wider rows take the wide instantiation: P's rows read twice (the sum,
// then the divide), Q's columns in kMaxD-column chunks of the same tile.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 256;
constexpr int kMaxD = 256, kMaxH = kMaxD / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float smooth(float add, const float* __restrict__ mask, int64_t r) {
  return mask ? add * mask[r] : add;
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads)
p_rows(float* __restrict__ P, int n, int d, float add, const float* __restrict__ mask) {
  const int lane = threadIdx.x & 31, r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= n) return;
  float* row = P + (int64_t)r * d;
  const float s_add = smooth(add, mask, r);
  if (kWide) {  // the columns in the registers' order (lane + 32 h)
    float part = 0.f;
    for (int c = lane; c < d; c += 32) part += row[c] + s_add;
    const float s = warp_sum(part);
    const float div = s > 0.f ? s : 1.f;
    for (int c = lane; c < d; c += 32) row[c] = (row[c] + s_add) / div;
    return;
  }
  float x[kMaxH];
  float part = 0.f;
#pragma unroll
  for (int h = 0; h < kMaxH; ++h) {
    const int c = lane + 32 * h;
    x[h] = c < d ? row[c] + s_add : 0.f;
    part += x[h];
  }
  const float s = warp_sum(part);
  const float div = s > 0.f ? s : 1.f;
#pragma unroll
  for (int h = 0; h < kMaxH; ++h) {
    const int c = lane + 32 * h;
    if (c < d) row[c] = x[h] / div;
  }
}

// part[b * d + c] = the sum of column c of the smoothed rows of block b.
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
q_partial(const float* __restrict__ Q, int n, int d, float add, const float* __restrict__ mask,
          double* __restrict__ part) {
  __shared__ double red[kWarps][kMaxD];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * kRowsPerBlock, r1 = min(n, r0 + kRowsPerBlock);
  for (int c0 = 0; c0 < (kWide ? d : 1); c0 += kMaxD) {
    const int dc = min(d - c0, kMaxD);
    for (int c = lane; c < dc; c += 32) {
      double s = 0.0;
      for (int r = r0 + warp; r < r1; r += kWarps)
        s += (double)(Q[(int64_t)r * d + c0 + c] + smooth(add, mask, r));
      red[warp][c] = s;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < dc; c += kThreads) {
      double t = 0.0;
      for (int w = 0; w < kWarps; ++w) t += red[w][c];
      part[(int64_t)blockIdx.x * d + c0 + c] = t;
    }
    if (kWide) __syncthreads();  // the tile is refilled for the next chunk
  }
}

// part[nb * d + c] = the column sums over the blocks, in block order.
__global__ void __launch_bounds__(kThreads) q_total(double* __restrict__ part, int nb, int d) {
  for (int c = threadIdx.x; c < d; c += kThreads) {
    double t = 0.0;
    for (int b = 0; b < nb; ++b) t += part[(int64_t)b * d + c];
    part[(int64_t)nb * d + c] = t;
  }
}

__global__ void __launch_bounds__(kThreads)
q_apply(float* __restrict__ Q, int n, int d, float add, const float* __restrict__ mask,
        const double* __restrict__ total) {
  const int64_t m = (int64_t)n * d;
  for (int64_t i = blockIdx.x * (int64_t)kThreads + threadIdx.x; i < m;
       i += (int64_t)gridDim.x * kThreads) {
    const int64_t r = i / d;
    const float s = (float)total[i - r * d];
    Q[i] = (Q[i] + smooth(add, mask, r)) / (s > 0.f ? s : 1.f);
  }
}

int blocks_for(int n) { return (n + kRowsPerBlock - 1) / kRowsPerBlock; }

}  // namespace

// 1 when rows of d floats take the wide instantiation.
extern "C" int plsi_mstep_wide(int d) { return d > kMaxD ? 1 : 0; }

// Doubles of the workspace for a Q of n rows and d columns.
extern "C" int plsi_mstep_workspace(int n, int d) { return (blocks_for(n) + 1) * d; }

// The M-step in two launches, so that a row-sharded table's column sums
// can be all-reduced between them (plsi_epoch_sharded_range, :256); on one
// device the second follows the first directly.  plsi_mstep_sums: P's rows
// as above, and the column sums of Q's smoothed rows (Q itself unchanged)
// into part[nb * d .. (nb + 1) * d), nb = the workspace's blocks.
// plsi_mstep_apply: Q's rows smoothed and divided by the given column sums
// (d doubles).  p_mask and q_mask both given (one float per row) or both
// null.
extern "C" int plsi_mstep_sums(float* P, int nP, const float* Q, int nQ, int d, float add_p,
                               float add_q, const float* p_mask, const float* q_mask,
                               double* part, void* stream) {
  if (d < 1 || nP < 0 || nQ < 0 || (!p_mask) != (!q_mask) || !part)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool wide = plsi_mstep_wide(d);
  if (nP > 0) {
    const unsigned grid = (nP + kWarps - 1) / kWarps;
    if (wide) p_rows<true><<<grid, kThreads, 0, st>>>(P, nP, d, add_p, p_mask);
    else p_rows<false><<<grid, kThreads, 0, st>>>(P, nP, d, add_p, p_mask);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int nb = blocks_for(nQ);
  if (nb > 0) {
    if (wide) q_partial<true><<<nb, kThreads, 0, st>>>(Q, nQ, d, add_q, q_mask, part);
    else q_partial<false><<<nb, kThreads, 0, st>>>(Q, nQ, d, add_q, q_mask, part);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  q_total<<<1, kThreads, 0, st>>>(part, nb, d);
  return (int)cudaGetLastError();
}

extern "C" int plsi_mstep_apply(float* Q, int nQ, int d, float add_q, const float* q_mask,
                                const double* total, void* stream) {
  if (d < 1 || nQ < 0 || !total) return (int)cudaErrorInvalidValue;
  if (nQ == 0) return 0;
  const int64_t m = (int64_t)nQ * d;
  const int grid = (int)((m + kThreads - 1) / kThreads < 4096 ? (m + kThreads - 1) / kThreads : 4096);
  q_apply<<<grid, kThreads, 0, (cudaStream_t)stream>>>(Q, nQ, d, add_q, q_mask, total);
  return (int)cudaGetLastError();
}
