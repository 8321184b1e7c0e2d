// K17: CoFactor's per-row normal equations.  For batch row b (table row
// rows[b], its current vector x) over up to two sides of entries (column
// col, value v, gathered row f):
//  * implicit (user-item; weight w = alpha v): S_i = sum w f f^T,
//    t_i = sum (1 + w) f;
//  * explicit (item-context SPPMI; coefficient k = v - rbias[row] -
//    cbias[col]): S_e = sum f f^T, t_e = sum k f;
// A = l (FF + S_i) + S_e + reg I, y = l t_i + t_e (terms of an absent side
// left out, FF and l with the implicit side), and the loss terms of x
// before the solve: l (x FF x + sum (-dot^2 + (1 + w) (dot - 1)^2)) over
// the implicit side, sum (v - dot - rbias - cbias)^2 over the explicit side,
// reg |x|^2 — each on request, each times the row mask (entries on either
// side).  total[b] = both sides' lengths (the solve and the bias write skip
// rows with none).  A side is a padded block (row b's entries are
// cols[b, 0:lens[b]]) or a segment batch's chunks (row b's chunks
// chunk_ptr[b] .. chunk_ptr[b + 1], chunk c's entries cols[c,
// 0:chunk_lens[c]]; lens[b] the row's length).
//
// Replaces buffalo_tpu/ops/cfr_kernels.py _implicit_terms (:29) and the A / y
// builds and loss terms of _cfr_user_body (:56), _cfr_item_body (:92-137),
// _cfr_context_body (:563-583), and _segment_stats (:158) with the segment
// bodies (:181-323).
//
// What bounds it on the card: operations.  d^2 multiply-adds per entry and
// side (1,024 at d = 32) against ~4 d + 8 bytes per entry, so ~40 operations
// per byte, past the H100's FP32 ridge (~20); and the d^2 floats of A
// written per row.  Design: one block of 256 threads per row; the entries
// come in tiles of 32 (their rows of F staged in shared memory, weights
// beside them), thread t owns A's entries t, t + 256, ... and adds every
// entry of the tile in order; thread l < 32 of the tile computes entry l's
// dot with x (in order over the columns) for the loss terms; y's entries
// belong to threads 0 .. d - 1.  The implicit side's sums are complete
// before the explicit side's start, so A is assembled as the reference
// orders it.  Loss partials are doubles reduced in a fixed order.  No
// atomics: two launches are bitwise equal.  S = sum w f f^T is formed
// directly, not as (sqrt(w) f)(sqrt(w) f)^T as the reference does.  Rows
// past kMaxD floats take the wide form: A in 64 x 64 output tiles, one
// block per (row, tile) over the row's entries in order (their two 64-column
// slices of F staged per tile of entries), then one block per row for y and
// the loss terms, reading F from global memory; every sum keeps the narrow
// form's order, so the two forms compute the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kTile = 32;
constexpr int kMaxD = 128;

struct SideArgs {
  const float* F;  // null: no such side
  const int32_t* lens;
  const int32_t* chunk_ptr;  // null: a padded block
  const int32_t* chunk_lens;
  const int32_t* cols;
  const float* vals;
  int L;
};

struct Args {
  const float* X;
  int n, d;
  const int32_t* rows;
  int R;
  SideArgs imp;
  const float* FF;
  float alpha, l;
  SideArgs exp;
  const float* rbias;
  const float* cbias;
  float reg;
  int loss_flags;  // 1 implicit, 2 explicit, 4 reg
  float* A;
  float* y;
  float* loss;
  int32_t* total;
};

__device__ __forceinline__ double block_sum(double v, double* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) s += scratch[w];
  __syncthreads();
  return s;  // thread 0's
}

// One side of row b into acc (A's entries of this thread), yacc (y's entry
// threadIdx.x < d) and, for thread l < kTile, the loss sum; implicit: w =
// alpha v, explicit: coefficient v - rb - cbias[col].
template <int PER, bool kImplicit>
__device__ void side_sums(const Args& g, const SideArgs& s, int b, float rb, const float* xs,
                          float* Fs, float* wa, float* wy, float (&acc)[PER], float& yacc,
                          double& lsum, bool want_loss) {
  const int d = g.d, t = threadIdx.x;
  int c0 = b, c1 = b + 1;
  if (s.chunk_ptr) {
    c0 = s.chunk_ptr[b];
    c1 = s.chunk_ptr[b + 1];
  }
  for (int c = c0; c < c1; ++c) {
    const int len = s.chunk_ptr ? s.chunk_lens[c] : s.lens[b];
    const int32_t* cols = s.cols + (int64_t)c * s.L;
    const float* vals = s.vals + (int64_t)c * s.L;
    for (int base = 0; base < len; base += kTile) {
      const int cnt = min(kTile, len - base);
      for (int i = t; i < kTile * d; i += kThreads) {
        const int l = i / d, z = i - l * d;
        Fs[i] = l < cnt ? s.F[(int64_t)cols[base + l] * d + z] : 0.f;
      }
      __syncthreads();
      if (t < kTile) {
        float a_w = 0.f, y_w = 0.f;
        if (t < cnt) {
          const float v = vals[base + t];
          float dot = 0.f;
          if (want_loss)
            for (int z = 0; z < d; ++z) dot = fmaf(xs[z], Fs[t * d + z], dot);
          if (kImplicit) {
            const float w = v * g.alpha;
            a_w = w;
            y_w = 1.f + w;
            if (want_loss) {
              const float dm = dot - 1.f;
              lsum += (double)(-dot * dot + y_w * (dm * dm));
            }
          } else {
            const float cb = g.cbias[cols[base + t]];
            a_w = 1.f;
            y_w = v - rb - cb;
            if (want_loss) {
              const float err = v - dot - rb - cb;
              lsum += (double)(err * err);
            }
          }
        }
        wa[t] = a_w;
        wy[t] = y_w;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int k = t + j * kThreads;
        if (k < d * d) {
          const int i = k / d, jj = k - i * d;
          float a = acc[j];
          for (int l = 0; l < cnt; ++l) a = fmaf(Fs[l * d + i] * wa[l], Fs[l * d + jj], a);
          acc[j] = a;
        }
      }
      if (t < d) {
        float yv = yacc;
        for (int l = 0; l < cnt; ++l) yv = fmaf(Fs[l * d + t], wy[l], yv);
        yacc = yv;
      }
      __syncthreads();
    }
  }
}

template <int PER>
__global__ void __launch_bounds__(kThreads) normal_equations_kernel(Args g) {
  extern __shared__ float smem[];
  __shared__ double scratch[kWarps];
  const int d = g.d, t = threadIdx.x, b = blockIdx.x;
  float* xs = smem;              // d
  float* Fs = xs + kMaxD;        // kTile d
  float* wa = Fs + kTile * d;    // kTile
  float* wy = wa + kTile;        // kTile
  const int row = g.rows[b];
  const int xr = min(row, g.n - 1);
  for (int z = t; z < d; z += kThreads) xs[z] = g.X[(int64_t)xr * d + z];
  __syncthreads();
  const int n_imp = g.imp.F ? g.imp.lens[b] : 0;
  const int n_exp = g.exp.F ? g.exp.lens[b] : 0;
  const bool live = n_imp + n_exp > 0;
  float acc[PER], out[PER];
  float yacc = 0.f, yout = 0.f;
  double l_imp = 0.0, l_exp = 0.0;
#pragma unroll
  for (int j = 0; j < PER; ++j) out[j] = acc[j] = 0.f;
  if (g.imp.F) {
    side_sums<PER, true>(g, g.imp, b, 0.f, xs, Fs, wa, wy, acc, yacc, l_imp,
                         live && (g.loss_flags & 1));
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int k = t + j * kThreads;
      if (k < d * d) out[j] = g.l * (g.FF[k] + acc[j]);
      acc[j] = 0.f;
    }
    yout = g.l * yacc;
    yacc = 0.f;
  }
  if (g.exp.F) {
    const float rb = g.rbias[xr];
    side_sums<PER, false>(g, g.exp, b, rb, xs, Fs, wa, wy, acc, yacc, l_exp,
                          live && (g.loss_flags & 2));
#pragma unroll
    for (int j = 0; j < PER; ++j) out[j] += acc[j];
    yout += yacc;
  }
  float* A = g.A + (int64_t)b * d * d;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int k = t + j * kThreads;
    if (k < d * d) A[k] = k / d == k % d ? out[j] + g.reg : out[j];
  }
  if (t < d) g.y[(int64_t)b * d + t] = yout;
  // the loss terms of x: x FF x over this thread's entries of FF, |x|^2
  // over threads 0 .. d - 1, the per-entry sums of threads 0 .. kTile - 1
  double xffx = 0.0, x2 = 0.0;
  if (live && g.imp.F && (g.loss_flags & 1)) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int k = t + j * kThreads;
      if (k < d * d) xffx += (double)(xs[k / d] * g.FF[k] * xs[k % d]);
    }
  }
  if (live && (g.loss_flags & 4) && t < d) x2 = (double)(xs[t] * xs[t]);
  const double s_ffx = block_sum(xffx, scratch);
  const double s_imp = block_sum(l_imp, scratch);
  const double s_exp = block_sum(l_exp, scratch);
  const double s_x2 = block_sum(x2, scratch);
  if (t == 0) {
    g.loss[b] = (float)((double)g.l * (s_ffx + s_imp) + s_exp + (double)g.reg * s_x2);
    g.total[b] = n_imp + n_exp;
  }
}

// ------------------------------------------------------------- wide rows
constexpr int kOut = 64;                  // an output tile of A is kOut x kOut
constexpr int kTilePer = kOut * kOut / kThreads;

// A's tile (blockIdx.y) of row blockIdx.x: both sides' sums as in
// normal_equations_kernel, the same per-entry order.
__global__ void __launch_bounds__(kThreads) wide_a_kernel(Args g) {
  __shared__ float Fi[kTile][kOut], Fj[kTile][kOut], wa[kTile];
  const int d = g.d, t = threadIdx.x, b = blockIdx.x;
  const int nt = (d + kOut - 1) / kOut;
  const int i0 = (blockIdx.y / nt) * kOut, j0 = (blockIdx.y % nt) * kOut;
  float acc[kTilePer], out[kTilePer];
#pragma unroll
  for (int j = 0; j < kTilePer; ++j) out[j] = acc[j] = 0.f;
  for (int side = 0; side < 2; ++side) {
    const SideArgs& s = side ? g.exp : g.imp;
    if (!s.F) continue;
    int c0 = b, c1 = b + 1;
    if (s.chunk_ptr) {
      c0 = s.chunk_ptr[b];
      c1 = s.chunk_ptr[b + 1];
    }
    for (int c = c0; c < c1; ++c) {
      const int len = s.chunk_ptr ? s.chunk_lens[c] : s.lens[b];
      const int32_t* cols = s.cols + (int64_t)c * s.L;
      const float* vals = s.vals + (int64_t)c * s.L;
      for (int base = 0; base < len; base += kTile) {
        const int cnt = min(kTile, len - base);
        for (int q = t; q < kTile * kOut; q += kThreads) {
          const int l = q / kOut, z = q - l * kOut;
          const float* f = s.F + (int64_t)(l < cnt ? cols[base + l] : 0) * d;
          Fi[l][z] = l < cnt && i0 + z < d ? f[i0 + z] : 0.f;
          Fj[l][z] = l < cnt && j0 + z < d ? f[j0 + z] : 0.f;
        }
        if (t < kTile) wa[t] = t < cnt ? (side ? 1.f : vals[base + t] * g.alpha) : 0.f;
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kTilePer; ++j) {
          const int e = t + j * kThreads, ri = e / kOut, rj = e - ri * kOut;
          float a = acc[j];
          for (int l = 0; l < cnt; ++l) a = fmaf(Fi[l][ri] * wa[l], Fj[l][rj], a);
          acc[j] = a;
        }
        __syncthreads();
      }
    }
#pragma unroll
    for (int j = 0; j < kTilePer; ++j) {
      const int e = t + j * kThreads, i = i0 + e / kOut, jj = j0 + e % kOut;
      if (side == 0) {
        if (i < d && jj < d) out[j] = g.l * (g.FF[(int64_t)i * d + jj] + acc[j]);
      } else {
        out[j] += acc[j];
      }
      acc[j] = 0.f;
    }
  }
  float* A = g.A + (int64_t)b * d * d;
#pragma unroll
  for (int j = 0; j < kTilePer; ++j) {
    const int e = t + j * kThreads, i = i0 + e / kOut, jj = j0 + e % kOut;
    if (i < d && jj < d) A[(int64_t)i * d + jj] = i == jj ? out[j] + g.reg : out[j];
  }
}

// One side's y entries (thread t: columns t, t + kThreads, ...) and the loss
// sum of thread l < kTile, as side_sums, F read from global memory.
template <bool kImplicit>
__device__ void wide_side_y(const Args& g, const SideArgs& s, int b, float rb, const float* xr,
                            float* wy, float* yacc, int ny, double& lsum, bool want_loss) {
  const int d = g.d, t = threadIdx.x;
  int c0 = b, c1 = b + 1;
  if (s.chunk_ptr) {
    c0 = s.chunk_ptr[b];
    c1 = s.chunk_ptr[b + 1];
  }
  for (int c = c0; c < c1; ++c) {
    const int len = s.chunk_ptr ? s.chunk_lens[c] : s.lens[b];
    const int32_t* cols = s.cols + (int64_t)c * s.L;
    const float* vals = s.vals + (int64_t)c * s.L;
    for (int base = 0; base < len; base += kTile) {
      const int cnt = min(kTile, len - base);
      if (t < kTile) {
        float y_w = 0.f;
        if (t < cnt) {
          const float v = vals[base + t];
          const float* f = s.F + (int64_t)cols[base + t] * d;
          float dot = 0.f;
          if (want_loss)
            for (int z = 0; z < d; ++z) dot = fmaf(xr[z], f[z], dot);
          if (kImplicit) {
            y_w = 1.f + v * g.alpha;
            if (want_loss) {
              const float dm = dot - 1.f;
              lsum += (double)(-dot * dot + y_w * (dm * dm));
            }
          } else {
            const float cb = g.cbias[cols[base + t]];
            y_w = v - rb - cb;
            if (want_loss) {
              const float err = v - dot - rb - cb;
              lsum += (double)(err * err);
            }
          }
        }
        wy[t] = y_w;
      }
      __syncthreads();
      for (int q = 0; q < ny; ++q) {
        const int z = t + q * kThreads;
        if (z >= d) break;
        float yv = yacc[q];
        for (int l = 0; l < cnt; ++l)
          yv = fmaf(s.F[(int64_t)cols[base + l] * d + z], wy[l], yv);
        yacc[q] = yv;
      }
      __syncthreads();
    }
  }
}

// y, the loss terms and the entry count of row blockIdx.x (wide rows).
__global__ void __launch_bounds__(kThreads) wide_y_kernel(Args g, int ny) {
  extern __shared__ float ysm[];  // kThreads ny: the y sums of each thread
  __shared__ double scratch[kWarps];
  __shared__ float wy[kTile];
  const int d = g.d, t = threadIdx.x, b = blockIdx.x;
  const int row = g.rows[b];
  const int xr = min(row, g.n - 1);
  const float* x = g.X + (int64_t)xr * d;
  const int n_imp = g.imp.F ? g.imp.lens[b] : 0;
  const int n_exp = g.exp.F ? g.exp.lens[b] : 0;
  const bool live = n_imp + n_exp > 0;
  float* yacc = ysm + t * ny;
  for (int q = 0; q < ny; ++q) yacc[q] = 0.f;
  double l_imp = 0.0, l_exp = 0.0;
  // y = l (implicit sums) + (explicit sums), each side from zero, as the
  // narrow form's yout
  float* y = g.y + (int64_t)b * d;
  if (g.imp.F)
    wide_side_y<true>(g, g.imp, b, 0.f, x, wy, yacc, ny, l_imp, live && (g.loss_flags & 1));
  for (int q = 0; q < ny; ++q) {
    const int z = t + q * kThreads;
    if (z < d) y[z] = g.imp.F ? g.l * yacc[q] : 0.f;
    yacc[q] = 0.f;
  }
  if (g.exp.F) {
    wide_side_y<false>(g, g.exp, b, g.rbias[xr], x, wy, yacc, ny, l_exp,
                       live && (g.loss_flags & 2));
    for (int q = 0; q < ny; ++q) {
      const int z = t + q * kThreads;
      if (z < d) y[z] += yacc[q];
    }
  }
  double xffx = 0.0, x2 = 0.0;
  if (live && g.imp.F && (g.loss_flags & 1)) {
    for (int64_t k = t; k < (int64_t)d * d; k += kThreads)
      xffx += (double)(x[k / d] * g.FF[k] * x[k % d]);
  }
  if (live && (g.loss_flags & 4))
    for (int z = t; z < d; z += kThreads) x2 += (double)(x[z] * x[z]);
  const double s_ffx = block_sum(xffx, scratch);
  const double s_imp = block_sum(l_imp, scratch);
  const double s_exp = block_sum(l_exp, scratch);
  const double s_x2 = block_sum(x2, scratch);
  if (t == 0) {
    g.loss[b] = (float)((double)g.l * (s_ffx + s_imp) + s_exp + (double)g.reg * s_x2);
    g.total[b] = n_imp + n_exp;
  }
}

}  // namespace

// 1 when rows of d floats take the wide form.
extern "C" int cfr_normal_equations_wide(int d) { return d > kMaxD ? 1 : 0; }

// Sides are (F, lens, chunk_ptr, chunk_lens, cols, vals, L); F null leaves a
// side out (FF / alpha / l go with the implicit side, rbias / cbias with the
// explicit one).  A (R, d, d), y (R, d), loss (R), total (R) are written.
extern "C" int cfr_normal_equations(
    const float* X, int n, int d, const int32_t* rows, int R, const float* Fi,
    const int32_t* lens_i, const int32_t* ptr_i, const int32_t* clens_i, const int32_t* cols_i,
    const float* vals_i, int L_i, const float* FF, float alpha, float l, const float* Fe,
    const int32_t* lens_e, const int32_t* ptr_e, const int32_t* clens_e, const int32_t* cols_e,
    const float* vals_e, int L_e, const float* rbias, const float* cbias, float reg,
    int loss_flags, float* A, float* y, float* loss, int32_t* total, void* stream) {
  if (d < 1 || n < 1 || R < 0 || (!Fi && !Fe) || (Fi && !FF) ||
      (Fe && (!rbias || !cbias)) || !A || !y || !loss || !total)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  Args g{X, n, d, rows, R,
         SideArgs{Fi, lens_i, ptr_i, clens_i, cols_i, vals_i, L_i}, FF, alpha, l,
         SideArgs{Fe, lens_e, ptr_e, clens_e, cols_e, vals_e, L_e}, rbias, cbias, reg,
         loss_flags, A, y, loss, total};
  const cudaStream_t st = (cudaStream_t)stream;
  if (cfr_normal_equations_wide(d)) {
    const int nt = (d + kOut - 1) / kOut;
    wide_a_kernel<<<dim3(R, nt * nt), kThreads, 0, st>>>(g);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int ny = (d + kThreads - 1) / kThreads;
    const size_t ysmem = sizeof(float) * kThreads * ny;
    if (ysmem > 48 * 1024) {
      err = cudaFuncSetAttribute(wide_y_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)ysmem);
      if (err != cudaSuccess) return (int)err;
    }
    wide_y_kernel<<<R, kThreads, ysmem, st>>>(g, ny);
    return (int)cudaGetLastError();
  }
  const size_t smem = sizeof(float) * (kMaxD + kTile * d + 2 * kTile);
  const int per = (d * d + kThreads - 1) / kThreads;
  if (per <= 4) normal_equations_kernel<4><<<R, kThreads, smem, st>>>(g);
  else if (per <= 16) normal_equations_kernel<16><<<R, kThreads, smem, st>>>(g);
  else normal_equations_kernel<64><<<R, kThreads, smem, st>>>(g);
  return (int)cudaGetLastError();
}
