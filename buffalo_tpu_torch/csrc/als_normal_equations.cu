// K2: per-row dense ALS normal equations and loss terms.
//
// Replaces buffalo_tpu/ops/als_kernels.py: _row_stats (:65) + the A assembly
// of als_solve_batch (:164-167) for range batches with L > 96, and the
// per-chunk statistics + segment_sum of als_solve_segment_batch (:268-282)
// for segment batches of head rows, with the loss terms of _loss_terms (:77)
// and (:284-297).  Per row r it writes
//   A[r] = FF + F^T diag(w) F + reg*ada*I,   y[r] = F^T (1 + w),
//   nume[r], deno[r]   (the reference's loss accumulators, pre-update p)
// where F = Bf[cols] over the row's entries and w = alpha * vals.
//
// Range mode (chunk_ptr == NULL): one block per row r, whose entries are
// cols[r, :lens[r]], with p = table[row_start + r].
// Segment mode: row r owns chunks [chunk_ptr[r], chunk_ptr[r+1]) of width C,
// chunk c holding chunk_lens[c] entries, and p = table[rows[r]].  A head
// row can hold a million entries, so one block per row would leave the card
// idle behind the longest row; instead one block per chunk writes the
// chunk's partial statistics (the reference's A_chunk / y_chunk), and a
// second kernel adds each row's chunk partials in chunk order and finishes
// A, y and the loss (the reference's segment_sum).  No atomics: every
// launch sums in the same order.
//
// What bounds it on the card: 2 d^2 FLOPs per entry (the rank-1 update of
// A), which at d = 40 outweighs the 4 d bytes gathered per entry, plus one
// d x d write per row.  Design: a tile of 64 gathered entries sits in
// shared memory (F padded to a multiple of 4 columns) and each thread owns
// a 4 x 4 register tile of A, reading its 8 operands per entry as two
// float4 loads; when A has fewer than 256 tiles, G groups of threads split
// the entries of a tile and their totals are added in group order at the
// end.  Sums are two-level, so thousands of entries do not pile into one
// float32 running sum: registers hold the sum of a few tiles, which is then
// added to a running total in shared memory (y's per-thread sum is formed
// per tile).
#include "als_common.cuh"

namespace {

constexpr int kTL = 64;    // entries per shared-memory tile
constexpr int kFlush = 4;  // tiles summed in registers between flushes

// Statistics of one block's entries.  Range mode: block r is row r.  Chunk
// mode (chunk_ptr != NULL): block c is chunk c of the row found in
// chunk_ptr, and only the entry sums are written (A without FF and reg,
// nume = sum of the entries' loss terms, deno = sum of w).
__global__ void __launch_bounds__(1024)
als_normal_equations_kernel(const float* __restrict__ table, const float* __restrict__ Bf,
                            const float* __restrict__ FF, const int32_t* __restrict__ lens,
                            const int32_t* __restrict__ rows, int64_t row_start,
                            const int32_t* __restrict__ chunk_ptr, int R,
                            const int32_t* __restrict__ chunk_lens,
                            const int32_t* __restrict__ cols, const float* __restrict__ vals,
                            int C, float* __restrict__ A_out, float* __restrict__ y_out,
                            float* __restrict__ nume, float* __restrict__ deno,
                            int64_t n_table_rows, int d, int DP, int G, float alpha,
                            float reg, int adaptive_reg, int item_axis,
                            float num_fixed_rows, int compute_loss) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const int nq = DP / 4, nt = nq * nq;
  float* Fs = smem;                                  // [kTL][DP]
  float* tot = Fs + kTL * DP;                        // [G][nt][16] totals
  float* ws = tot + G * nt * 16;                     // [kTL]
  int32_t* cs = reinterpret_cast<int32_t*>(ws + kTL);  // [kTL]
  float* ps = reinterpret_cast<float*>(cs + kTL);    // [DP] current row
  float* scratch = ps + DP;                          // [33]

  const bool partial = chunk_ptr != nullptr;
  int n;          // entries of this block
  int64_t src;    // table row of p
  bool real;
  if (partial) {
    // the row owning chunk b: the last r with chunk_ptr[r] <= b
    int lo = 0, hi = R;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (chunk_ptr[mid] <= b) lo = mid; else hi = mid - 1;
    }
    n = chunk_lens[b];
    src = lo < R ? rows[lo] : -1;
    real = b < chunk_ptr[R] && lens[lo] > 0 && n > 0 && src >= 0 && src < n_table_rows;
  } else {
    n = lens[b];
    src = row_start + b;
    real = n > 0 && src < n_table_rows;
  }
  if (!real) n = 0;
  for (int j = tid; j < DP; j += T) ps[j] = (real && j < d) ? table[src * d + j] : 0.f;

  const int t = tid % nt, g = tid / nt;
  const bool owns_tile = tid < nt * G;
  float* my_tot = tot + (g * nt + t) * 16;
  if (owns_tile)
    for (int e = 0; e < 16; ++e) my_tot[e] = 0.f;
  const int j0 = (t / nq) * 4, k0 = (t % nq) * 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;
  float yacc = 0.f, pos = 0.f, wsum = 0.f;
  int tiles = 0;
  auto flush = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        my_tot[i * 4 + k] += acc[i][k];
        acc[i][k] = 0.f;
      }
  };

  const int32_t* cb = cols + (int64_t)b * C;
  const float* vb = vals + (int64_t)b * C;
  for (int base = 0; base < n; base += kTL) {
    const int tl = min(kTL, n - base);
    __syncthreads();  // the previous tile is consumed
    for (int l = tid; l < tl; l += T) {
      cs[l] = cb[base + l];
      ws[l] = vb[base + l] * alpha;
    }
    __syncthreads();
    for (int i = tid; i < tl * DP; i += T) {
      const int l = i / DP, k = i - l * DP;
      Fs[i] = k < d ? Bf[(int64_t)cs[l] * d + k] : 0.f;
    }
    __syncthreads();
    if (owns_tile) {
      for (int l = g; l < tl; l += G) {
        const float wl = ws[l];
        const float4 a = *reinterpret_cast<const float4*>(Fs + l * DP + j0);
        const float4 bq = *reinterpret_cast<const float4*>(Fs + l * DP + k0);
        const float av[4] = {a.x * wl, a.y * wl, a.z * wl, a.w * wl};
        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][k] += av[i] * bv[k];
      }
      if (++tiles % kFlush == 0) flush();
    }
    if (tid < d) {
      float s = 0.f;
      for (int l = 0; l < tl; ++l) s += Fs[l * DP + tid] * (1.f + ws[l]);
      yacc += s;
    }
    if (compute_loss && item_axis) {
      for (int l = tid; l < tl; l += T) {
        float dot = 0.f;
        for (int k = 0; k < d; ++k) dot += ps[k] * Fs[l * DP + k];
        pos += -dot * dot + (dot - 1.f) * (dot - 1.f) * (1.f + ws[l]);
        wsum += ws[l];
      }
    }
  }
  __syncthreads();

  if (owns_tile) flush();
  __syncthreads();
  const float reg_ada = partial ? 0.f : reg * (adaptive_reg ? (float)lens[b] : 1.f);
  if (tid < nt) {  // group 0 adds the groups' totals in group order
    float* Ab = A_out + (int64_t)b * d * d;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float s = 0.f;
        for (int gg = 0; gg < G; ++gg) s += tot[(gg * nt + tid) * 16 + i * 4 + k];
        const int j = j0 + i, kk = k0 + k;
        if (j < d && kk < d)
          Ab[j * d + kk] = partial ? s : FF[j * d + kk] + s + (j == kk ? reg_ada : 0.f);
      }
    }
  }
  if (tid < d) y_out[(int64_t)b * d + tid] = yacc;

  if (compute_loss) {
    float nu = 0.f, de = 0.f;
    if (!partial) {
      float part = 0.f;
      for (int j = tid; j < d; j += T) part += ps[j] * ps[j];
      nu = reg_ada * als::block_sum(part, scratch);
    }
    if (item_axis) {
      if (!partial) {
        float part = 0.f;
        for (int j = tid; j < d; j += T) {
          float s = 0.f;
          for (int k = 0; k < d; ++k) s += FF[j * d + k] * ps[k];
          part += ps[j] * s;
        }
        nu += als::block_sum(part, scratch);
        de = num_fixed_rows;
      }
      nu += als::block_sum(pos, scratch);
      de += als::block_sum(wsum, scratch);
    }
    if (tid == 0) {
      nume[b] = real ? nu : 0.f;
      deno[b] = real ? de : 0.f;
    }
  }
}

// Segment mode, second pass: row r adds its chunks' partials in chunk order
// (the reference's segment_sum) and finishes A = FF + sum + reg*ada*I, y and
// the loss terms of the pre-update row.
__global__ void __launch_bounds__(256)
als_segment_reduce_kernel(const float* __restrict__ table, const float* __restrict__ FF,
                          const int32_t* __restrict__ lens, const int32_t* __restrict__ rows,
                          const int32_t* __restrict__ chunk_ptr,
                          const float* __restrict__ A_part, const float* __restrict__ y_part,
                          const float* __restrict__ pos_part, const float* __restrict__ w_part,
                          float* __restrict__ A_out, float* __restrict__ y_out,
                          float* __restrict__ nume, float* __restrict__ deno,
                          int64_t n_table_rows, int d, float reg, int adaptive_reg,
                          int item_axis, float num_fixed_rows, int compute_loss) {
  extern __shared__ float smem[];
  float* ps = smem;         // [d]
  float* scratch = ps + d;  // [33]
  const int r = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const int n = lens[r];
  const int64_t src = rows[r];
  const bool real = n > 0 && src >= 0 && src < n_table_rows;
  const int c0 = chunk_ptr[r], c1 = real ? chunk_ptr[r + 1] : c0;
  const float reg_ada = reg * (adaptive_reg ? (float)n : 1.f);
  const int dd = d * d;
  for (int e = tid; e < dd; e += T) {
    float s = 0.f;
    for (int c = c0; c < c1; ++c) s += A_part[(int64_t)c * dd + e];
    const int j = e / d;
    A_out[(int64_t)r * dd + e] = FF[e] + s + (e == j * d + j ? reg_ada : 0.f);
  }
  for (int j = tid; j < d; j += T) {
    float s = 0.f;
    for (int c = c0; c < c1; ++c) s += y_part[(int64_t)c * d + j];
    y_out[(int64_t)r * d + j] = s;
    ps[j] = real ? table[src * d + j] : 0.f;
  }
  if (!compute_loss) return;
  __syncthreads();
  float part = 0.f;
  for (int j = tid; j < d; j += T) part += ps[j] * ps[j];
  float nu = reg_ada * als::block_sum(part, scratch);
  float de = 0.f;
  if (item_axis) {
    part = 0.f;
    for (int j = tid; j < d; j += T) {
      float s = 0.f;
      for (int k = 0; k < d; ++k) s += FF[j * d + k] * ps[k];
      part += ps[j] * s;
    }
    nu += als::block_sum(part, scratch);
    float pos = 0.f, w = 0.f;
    for (int c = c0; c < c1; ++c) {
      pos += pos_part[c];
      w += w_part[c];
    }
    nu += pos;
    de = num_fixed_rows + w;
  }
  if (tid == 0) {
    nume[r] = real ? nu : 0.f;
    deno[r] = real ? de : 0.f;
  }
}

}  // namespace

// Range mode: chunk_ptr == NULL, R rows.  Segment mode: chunk_ptr != NULL,
// R rows over Nc chunks, with (Nc, d, d) / (Nc, d) / (Nc) / (Nc) scratch for
// the chunk partials in A_part / y_part / pos_part / w_part.
extern "C" int als_normal_equations(const float* table, const float* Bf, const float* FF,
                                    const int32_t* lens, const int32_t* rows,
                                    int64_t row_start, const int32_t* chunk_ptr,
                                    const int32_t* chunk_lens, const int32_t* cols,
                                    const float* vals, int C, int Nc, float* A_part,
                                    float* y_part, float* pos_part, float* w_part,
                                    float* A_out, float* y_out, float* nume, float* deno,
                                    int64_t n_table_rows, int R, int d, float alpha,
                                    float reg, int adaptive_reg, int item_axis,
                                    float num_fixed_rows, int compute_loss, void* stream) {
  if (R == 0) return 0;
  const int DP = (d + 3) / 4 * 4, nq = DP / 4, nt = nq * nq;
  if (nt > 1024) return (int)cudaErrorInvalidValue;
  const int G = nt >= 256 ? 1 : 256 / nt;
  const int T = (nt * G + 31) / 32 * 32;
  const size_t smem =
      sizeof(float) * ((size_t)kTL * DP + (size_t)G * nt * 16 + 2 * kTL + DP + 33);
  cudaError_t err = als::allow_smem(als_normal_equations_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (chunk_ptr == nullptr) {
    als_normal_equations_kernel<<<R, T, smem, s>>>(
        table, Bf, FF, lens, rows, row_start, nullptr, R, nullptr, cols, vals, C, A_out,
        y_out, nume, deno, n_table_rows, d, DP, G, alpha, reg, adaptive_reg, item_axis,
        num_fixed_rows, compute_loss);
    return (int)cudaGetLastError();
  }
  if (Nc > 0) {
    als_normal_equations_kernel<<<Nc, T, smem, s>>>(
        table, Bf, FF, lens, rows, row_start, chunk_ptr, R, chunk_lens, cols, vals, C,
        A_part, y_part, pos_part, w_part, n_table_rows, d, DP, G, alpha, reg,
        adaptive_reg, item_axis, num_fixed_rows, compute_loss);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  als_segment_reduce_kernel<<<R, 256, sizeof(float) * (d + 33), s>>>(
      table, FF, lens, rows, chunk_ptr, A_part, y_part, pos_part, w_part, A_out, y_out,
      nume, deno, n_table_rows, d, reg, adaptive_reg, item_axis, num_fixed_rows,
      compute_loss);
  return (int)cudaGetLastError();
}
