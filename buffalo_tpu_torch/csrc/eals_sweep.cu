// K13: the eALS dimension sweep (He et al., SIGIR 2016; eals.cc:202-236) on
// the rows of one batch of table X against the fixed side Y.  For each row x,
// over its entries (col c, value v, negative weight C_e), w = 1 + alpha v and
// the dimensions in order (Gauss-Seidel: dimension t reads the row's updated
// dimensions before it), with the row's residuals vhat_e = x . y_c:
//   vf_e = vhat_e - x_t y_ct
//   num = sum (w v - (w - C_e) vf_e) y_ct - c_row (x . S[:, t] - x_t S_tt)
//   den = sum (w - C_e) y_ct^2 + c_row S_tt + reg
//   x_t = num / den,  vhat_e = vf_e + x_t y_ct.
// The user pass (item_axis 0) takes c_row = 1 and C_e = C[c] (the item
// weights at the fixed side's positions); the item pass takes c_row = C_e =
// C[row].  Modes:
//  0 range: rows row_start .. + B of the permuted table, entries cols/vals
//    (B x L) masked by lens, vhat recomputed from the factors in shared memory;
//  1 segment: one head row per rows[r] (rows past the table dropped), its
//    chunks chunk_ptr[r] .. chunk_ptr[r + 1] of cols/vals (Nc x Cw) with
//    chunk_lens, vhat recomputed into the workspace vhat (Nc x Cw);
//  2 rows: every row r of X with entries indptr[r] .. indptr[r + 1] of
//    cols/vals and the carried residuals vhat (read and updated).
//
// Replaces buffalo_tpu/ops/eals_kernels.py _eals_dim_sweep (:71),
// _eals_segment_sweep (:115), _eals_apply_batch (:165), _eals_apply_group
// (:207), eals_group_step (:225) and eals_epoch's batch loops (:310), and
// eals_half_epoch (:24).
//
// What bounds it on the card: per dimension and entry one 4-byte gather of
// y_ct (P is 22 MB, Q 4.3 MB at ML-20M, d = 40, so the gathers hit L2) and
// ~8 operations; the dimensions are sequential within a row.  Design: one
// block per row (32 to 256 threads by the batch's row length), each thread
// owning the same strided entries in every dimension so that the residuals
// need no barrier, the row in shared memory, the two sums reduced in a fixed
// order (warp shuffles, then the warps in order) and the dense term x . S[:, t]
// by the first warp; S (d x d) is read from L1/L2.  The row sits in a static
// shared array of kMaxD floats; wider rows take the wide instantiation, which
// keeps it in dynamic shared memory after the residuals.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxD = 256, kMaxWarps = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

struct Batch {
  int mode, num_rows, d, item_axis;
  float alpha, reg;
  const float* Y;
  const float* S;
  const float* C;
  int row_start, L;           // range
  const int32_t* lens;        // range, segment
  const int32_t* rows;        // segment
  const int32_t* chunk_ptr;   // segment
  const int32_t* chunk_lens;  // segment
  int Cw;                     // segment
  const int64_t* indptr;      // rows
  const int32_t* cols;
  const float* vals;
  float* vhat;                // segment, rows
};

// The entry segments of block b: (table row, c_row, segment count); segment
// s is entries [base, base + len) of cols/vals with residuals at res + i.
struct Row {
  int64_t row;
  float c_row;
  int nseg;
};

__device__ __forceinline__ Row row_of(const Batch& a, int b) {
  Row r;
  if (a.mode == 0) {
    r.row = a.row_start + b;
    r.nseg = 1;
  } else if (a.mode == 1) {
    r.row = a.rows[b];
    r.nseg = a.chunk_ptr[b + 1] - a.chunk_ptr[b];
  } else {
    r.row = b;
    r.nseg = 1;
  }
  r.c_row = 1.f;
  if (a.item_axis) {
    const bool real = a.mode != 1 || a.lens[b] > 0;
    r.c_row = real && r.row < a.num_rows ? a.C[r.row] : 0.f;
  }
  return r;
}

__device__ __forceinline__ void segment(const Batch& a, int b, int s, float* vsh, int64_t& base,
                                        int& len, float*& res) {
  if (a.mode == 0) {
    base = (int64_t)b * a.L;
    len = a.lens[b];
    res = vsh;
  } else if (a.mode == 1) {
    const int ch = a.chunk_ptr[b] + s;
    base = (int64_t)ch * a.Cw;
    len = a.chunk_lens[ch];
    res = a.vhat + base;
  } else {
    base = a.indptr[b];
    len = (int)(a.indptr[b + 1] - base);
    res = a.vhat + base;
  }
}

template <bool kWide>
__global__ void __launch_bounds__(32 * kMaxWarps)
sweep_kernel(Batch a, float* __restrict__ X) {
  extern __shared__ float vsh[];  // range mode: the row's residuals
  __shared__ float xs_static[kWide ? 1 : kMaxD];
  __shared__ float red[2 * kMaxWarps];
  float* xs = kWide ? vsh + (a.mode == 0 ? a.L : 0) : xs_static;
  const int b = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
  const Row r = row_of(a, b);
  if (r.row >= a.num_rows) return;  // a dropped (padding) row
  const int d = a.d;
  for (int c = tid; c < d; c += T) xs[c] = X[r.row * d + c];
  __syncthreads();
  const bool item = a.item_axis;
  const float* __restrict__ Y = a.Y;
  if (a.mode != 2) {  // the residuals of the row's current factors
    for (int s = 0; s < r.nseg; ++s) {
      int64_t base;
      int len;
      float* res;
      segment(a, b, s, vsh, base, len, res);
      for (int i = tid; i < len; i += T) {
        const float* y = Y + (int64_t)a.cols[base + i] * d;
        float acc = 0.f;
        for (int k = 0; k < d; ++k) acc = fmaf(xs[k], y[k], acc);
        res[i] = acc;
      }
    }
  }
  for (int t = 0; t < d; ++t) {
    const float xt = xs[t];
    float num = 0.f, den = 0.f;
    for (int s = 0; s < r.nseg; ++s) {
      int64_t base;
      int len;
      float* res;
      segment(a, b, s, vsh, base, len, res);
      for (int i = tid; i < len; i += T) {
        const int col = a.cols[base + i];
        const float v = a.vals[base + i];
        const float y = Y[(int64_t)col * d + t];
        const float w = 1.f + a.alpha * v;
        const float wmc = w - (item ? r.c_row : a.C[col]);
        const float vf = res[i] - xt * y;
        num += (w * v - wmc * vf) * y;
        den += wmc * y * y;
      }
    }
    num = warp_sum(num);
    den = warp_sum(den);
    if (lane == 0) {
      red[2 * warp] = num;
      red[2 * warp + 1] = den;
    }
    __syncthreads();
    if (warp == 0) {
      float dense = 0.f;
      for (int k = lane; k < d; k += 32) dense = fmaf(xs[k], a.S[k * d + t], dense);
      dense = warp_sum(dense);
      if (lane == 0) {
        float sn = 0.f, sd = 0.f;
        for (int w = 0; w < nwarps; ++w) {
          sn += red[2 * w];
          sd += red[2 * w + 1];
        }
        const float stt = a.S[t * d + t];
        dense -= xt * stt;
        xs[t] = (sn - r.c_row * dense) / (sd + r.c_row * stt + a.reg);
      }
    }
    __syncthreads();
    const float xn = xs[t];
    for (int s = 0; s < r.nseg; ++s) {
      int64_t base;
      int len;
      float* res;
      segment(a, b, s, vsh, base, len, res);
      for (int i = tid; i < len; i += T) {
        const float y = Y[(int64_t)a.cols[base + i] * d + t];
        res[i] = (res[i] - xt * y) + xn * y;
      }
    }
  }
  for (int c = tid; c < d; c += T) X[r.row * d + c] = xs[c];
}

// Threads per row for entries of length L per segment.
int threads_for(int L) { return L <= 64 ? 32 : L <= 256 ? 64 : L <= 1024 ? 128 : 256; }

}  // namespace

// 1 when rows of d floats take the wide instantiation.
extern "C" int eals_sweep_wide(int d) { return d > kMaxD ? 1 : 0; }

// mode 0 (range): row_start, B rows, L, lens, cols/vals (B x L); mode 1
// (segment): R rows, rows, lens, chunk_ptr (R + 1), chunk_lens, cols/vals (Nc x
// Cw), vhat workspace (Nc x Cw); mode 2 (rows): num_rows rows, indptr, cols/vals
// (nnz), vhat (nnz, carried).  C is indexed by the fixed side's column (user
// pass) or by X's own row (item pass).
extern "C" int eals_sweep(int mode, float* X, int num_rows, const float* Y, int d, const float* S,
                          const float* C, int item_axis, float alpha, float reg, int row_start,
                          int B, int L, const int32_t* lens, const int32_t* rows, int R,
                          const int32_t* chunk_ptr, const int32_t* chunk_lens, int Cw,
                          const int64_t* indptr, const int32_t* cols, const float* vals,
                          float* vhat, void* stream) {
  if (mode < 0 || mode > 2 || d < 1 || num_rows < 0 || (mode == 0 && L > 8192) ||
      (mode != 0 && !vhat))
    return (int)cudaErrorInvalidValue;
  const int blocks = mode == 0 ? B : mode == 1 ? R : num_rows;
  if (blocks <= 0) return 0;
  Batch a{mode, num_rows, d, item_axis, alpha, reg, Y, S, C, row_start, L, lens, rows, chunk_ptr,
          chunk_lens, Cw, indptr, cols, vals, vhat};
  const int T = threads_for(mode == 0 ? L : mode == 1 ? Cw : 128);
  const size_t smem = mode == 0 ? sizeof(float) * (size_t)L : 0;
  if (eals_sweep_wide(d)) {
    const size_t wide_smem = smem + sizeof(float) * (size_t)d;
    if (wide_smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          sweep_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wide_smem);
      if (err != cudaSuccess) return (int)err;
    }
    sweep_kernel<true><<<blocks, T, wide_smem, (cudaStream_t)stream>>>(a, X);
  } else {
    sweep_kernel<false><<<blocks, T, smem, (cudaStream_t)stream>>>(a, X);
  }
  return (int)cudaGetLastError();
}
