// K1: fused matrix-free row CG for ALS batches with padded length L <= 96
// (MATRIX_FREE_MAX_L), range or scatter (PaddedBatch) rows.
//
// Replaces buffalo_tpu/ops/als_kernels.py: _solve_cg_matrix_free (:103), the
// CG branch of als_solve_batch (:157-162), _loss_terms (:77) and the
// gather/write of _apply_batch (:337-353 range, :354-372 scatter), with
// solve.py's cg_warm_start (:37) + cg_loop (:49).  Per row u of the batch it
// solves
//   (FF + reg*ada*I + F^T diag(w) F) x = F^T (1 + w),   F = Bf[cols[u]]
// by a warm start from the current row and cg_iters CG steps, without ever
// forming the d x d system, and writes x over table[row_start + u] (range
// mode) or table[rows[u]] (rows mode; ids outside the table, the padding
// rows of a PaddedBatch, are skipped as the JAX package drops them).  The
// values are float32 or bfloat16 (read as float32).
//
// What bounds it on the card: the arithmetic is ~(cg_iters + 1) (4 n d +
// 2 d^2) operations per row, the bytes the gather of F (n rows of d floats
// from a fixed-side table that sits in the 50 MB L2), and neither is large;
// what costs is moving F and the CG vectors between lanes.  Design:
// * One warp per row, several warps per block, each warp walking rows
//   b, b + (all warps of the grid), ...; the grid is as large as fits on the
//   card at once.  FF^T is staged once per block in shared memory (the
//   kernel's only block barrier, before any row).
// * Lane i owns entries l = i, i + 32, i + 64 of the row.  F x needs no
//   reduction: the lane dots its own rows of F with x (broadcast through the
//   warp's shared slice as float4); F^T (w * F x) is a per-lane axpy over
//   its own rows followed by a warp reduce-scatter (shuffles in a fixed
//   order), after which lane i holds entries i, i + 32, ... of the result,
//   the layout of every CG vector.  The dense part x FF is lane i's column
//   of FF^T against the same broadcast x.
// * For the widths of the main path the lane's rows of F are held in
//   registers for the whole solve; wider rows are read back from shared
//   memory in each matvec.
// * The gather goes through cp.async into the warp's slot (16-byte copies
//   when rows are 16-byte aligned, zero-filled past n and d), lanes on
//   consecutive pieces of whole rows: one piece per lane from 32 different
//   rows made the gather ten times slower than all the arithmetic.  With F
//   in registers the next row's gather is issued as soon as this row's F
//   is loaded, so it lands while this row's CG runs.
// * The CG loop has no block barrier: every reduction is a warp shuffle
//   tree, the same bits on every lane, so a frozen warp simply leaves.
// * The loss terms come from the warm-start product A x0: F x0 before the
//   weights gives the dots p.F[l], x0 FF gives pFFp.
// Rows with len 0 (padding) and rows-mode ids outside the table are
// skipped: the table keeps p and the loss terms stay 0.
#include <algorithm>

#include "als_common.cuh"

namespace {

// warps per block, one row each at a time (chosen on the card with
// tools/cg_bench.py, PERF.md); fewer where wide rows' shared memory does not fit
constexpr int kWarps = 4;
// F stays in registers when a lane's share (NE rows of DW floats) is at
// most this many floats and rows are at most 64 wide (the partial sums of
// F^T g take another DW registers)
constexpr int kRegFloats = 120;

struct Params {
  float* table;
  const float* Bf;
  const float* FF;
  const int32_t* lens;
  const int32_t* rows;  // rows mode: table row of each batch row; else null
  const int32_t* cols;
  const void* vals;     // float32, or bfloat16 with vals_bf16
  float* nume;
  float* deno;
  int64_t row_start, n_table_rows;
  int B, L, d;
  float alpha, reg;
  int adaptive_reg, cg_iters;
  float cg_tol;
  int item_axis;
  float num_fixed_rows;
  int compute_loss, vec, vals_bf16;
};

// (one block per SM is enough: ptxas may use up to 255 registers a thread)
template <int DW, int NE, bool kReg>
__global__ void __launch_bounds__(kWarps * 32, 1)
als_cg_matrix_free_kernel(const Params p) {
  constexpr int N = als::round32(DW), M = N / 32, KC = DW / 4;
  constexpr int LD = als::lane_row_stride(DW);
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, W = blockDim.x >> 5;
  const int L = p.L, d = p.d;
  float* FFt = reinterpret_cast<float*>(smem4);       // [N][LD]  FF^T, zero-padded
  const int L4 = (L + 3) / 4 * 4;
  float* vs = FFt + N * LD + warp * (N + L * LD + L4);  // [N]   broadcast slice
  float* slot = vs + N;                                 // [L][LD] gathered F
  int* ids = reinterpret_cast<int*>(slot + L * LD);     // [L]   gathered row ids

  // ---- FF^T once per block
  for (int k = warp; k < N; k += W)
    for (int j = lane; j < LD; j += 32)
      FFt[k * LD + j] = (k < d && j < d) ? p.FF[(int64_t)j * d + k] : 0.f;
  __syncthreads();

  const int stride = gridDim.x * W;
  int b = blockIdx.x * W + warp;
  if (b >= p.B) return;

  // ---- per-row entry metadata and the gather into the slot
  // (a rows-mode row outside the table gets n = 0: skipped like padding)
  auto load_meta = [&](int r, int& n, int (&c)[NE], float (&w)[NE]) {
    n = min(p.lens[r], L);
    if (p.rows && (p.rows[r] < 0 || p.rows[r] >= p.n_table_rows)) n = 0;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int l = lane + 32 * e;
      const bool ok = l < n;
      c[e] = ok ? p.cols[(int64_t)r * L + l] : -1;
      w[e] = ok ? als::load_val(p.vals, (int64_t)r * L + l, p.vals_bf16) * p.alpha : 0.f;
    }
  };
  // lanes copy consecutive 16-byte pieces (or floats) of the flattened
  // (entry, piece) space, so one instruction reads a few whole rows of Bf
  // and not one piece of 32 rows; the row ids go through the warp's slice
  auto gather = [&](const int (&c)[NE]) {
    __syncwarp();  // every lane is done with the slot and the last ids
#pragma unroll
    for (int e = 0; e < NE; ++e)
      if (lane + 32 * e < L) ids[lane + 32 * e] = c[e];
    __syncwarp();
    if (p.vec) {
      for (int i = lane; i < L * KC; i += 32) {
        const int l = i / KC, q = i - l * KC, col = ids[l];
        const bool full = col >= 0 && 4 * q < d;
        als::cp_async16(slot + l * LD + 4 * q, p.Bf + (full ? (int64_t)col * d + 4 * q : 0),
                        full);
      }
    } else {
      for (int i = lane; i < L * DW; i += 32) {
        const int l = i / DW, j = i - l * DW, col = ids[l];
        const bool full = col >= 0 && j < d;
        als::cp_async4(slot + l * LD + j, p.Bf + (full ? (int64_t)col * d + j : 0), full);
      }
    }
    als::cp_async_commit();
  };

  int n, c[NE], n2 = 0, c2[NE];
  float w[NE], w2[NE];
  load_meta(b, n, c, w);
  gather(c);
  int next = b + stride;
  if (next < p.B) load_meta(next, n2, c2, w2);

  float4 Fr[kReg ? NE : 1][kReg ? KC : 1];
  auto getF = [&](int e, int q) -> float4 {
    if constexpr (kReg) return Fr[e][q];
    else if (lane + 32 * e >= L) return make_float4(0.f, 0.f, 0.f, 0.f);  // no slot row
    else return reinterpret_cast<const float4*>(slot + (lane + 32 * e) * LD)[q];
  };

  for (;;) {
    als::cp_async_wait_all();
    __syncwarp();
    if constexpr (kReg) {
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const bool in = lane + 32 * e < L;
#pragma unroll
        for (int q = 0; q < KC; ++q)
          Fr[e][q] = in ? reinterpret_cast<const float4*>(slot + (lane + 32 * e) * LD)[q]
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (next < p.B) gather(c2);  // lands while this row's CG runs
    }

    if (n > 0) {
      float* row = p.table + (p.rows ? (int64_t)p.rows[b] : p.row_start + b) * d;
      const float reg_ada = p.reg * (p.adaptive_reg ? (float)n : 1.f);
      // entry slots e that hold any entry of this row (warp-uniform)
      auto live = [&](int e) { return 32 * e < n; };

      // y = F^T (1 + w): per-lane axpy over own rows, then reduce-scatter
      float part[N];
#pragma unroll
      for (int k = 0; k < N; ++k) part[k] = 0.f;
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        if (!live(e)) continue;
        const float g = 1.f + w[e];  // F's row is zero past n
#pragma unroll
        for (int q = 0; q < KC; ++q) {
          const float4 f = getF(e, q);
          part[4 * q + 0] = fmaf(f.x, g, part[4 * q + 0]);
          part[4 * q + 1] = fmaf(f.y, g, part[4 * q + 1]);
          part[4 * q + 2] = fmaf(f.z, g, part[4 * q + 2]);
          part[4 * q + 3] = fmaf(f.w, g, part[4 * q + 3]);
        }
      }
      als::warp_reduce_scatter<DW, N>(part);
      float y[M], x0[M];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        y[m] = part[32 * m];
        x0[m] = lane + 32 * m < d ? row[lane + 32 * m] : 0.f;
      }

      // A v = v FF + reg*ada v + F^T (w * (F v)), the reference's matvec
      // order; fx gets F v before the weights and dense gets v FF
      auto matvec_full = [&](const float (&v)[M], float (&out)[M], float (&fx)[NE],
                             float (&dense)[M]) {
        __syncwarp();
#pragma unroll
        for (int m = 0; m < M; ++m) vs[lane + 32 * m] = v[m];
        __syncwarp();
#pragma unroll
        for (int e = 0; e < NE; ++e) fx[e] = 0.f;
#pragma unroll
        for (int m = 0; m < M; ++m) dense[m] = 0.f;
#pragma unroll
        for (int q = 0; q < KC; ++q) {
          const float4 v4 = reinterpret_cast<const float4*>(vs)[q];
#pragma unroll
          for (int e = 0; e < NE; ++e) {
            if (!live(e)) continue;
            const float4 f = getF(e, q);
            fx[e] = fmaf(f.x, v4.x, fx[e]);
            fx[e] = fmaf(f.y, v4.y, fx[e]);
            fx[e] = fmaf(f.z, v4.z, fx[e]);
            fx[e] = fmaf(f.w, v4.w, fx[e]);
          }
#pragma unroll
          for (int m = 0; m < M; ++m) {
            const float4 t = reinterpret_cast<const float4*>(FFt + (lane + 32 * m) * LD)[q];
            dense[m] = fmaf(v4.x, t.x, dense[m]);
            dense[m] = fmaf(v4.y, t.y, dense[m]);
            dense[m] = fmaf(v4.z, t.z, dense[m]);
            dense[m] = fmaf(v4.w, t.w, dense[m]);
          }
        }
        float acc[N];
#pragma unroll
        for (int k = 0; k < N; ++k) acc[k] = 0.f;
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          if (!live(e)) continue;
          const float g = fx[e] * w[e];
#pragma unroll
          for (int q = 0; q < KC; ++q) {
            const float4 f = getF(e, q);
            acc[4 * q + 0] = fmaf(f.x, g, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(f.y, g, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(f.z, g, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(f.w, g, acc[4 * q + 3]);
          }
        }
        als::warp_reduce_scatter<DW, N>(acc);
#pragma unroll
        for (int m = 0; m < M; ++m) out[m] = (dense[m] + reg_ada * v[m]) + acc[32 * m];
      };

      float Ax0[M], fx[NE], dense[M], x[M];
      matvec_full(x0, Ax0, fx, dense);
      if (p.compute_loss) {
        float sq = 0.f;
#pragma unroll
        for (int m = 0; m < M; ++m) sq += x0[m] * x0[m];
        float nu = reg_ada * als::warp_sum(sq), de = 0.f;
        if (p.item_axis) {
          float pffp = 0.f, pos = 0.f, wsum = 0.f;
#pragma unroll
          for (int m = 0; m < M; ++m) pffp += x0[m] * dense[m];
#pragma unroll
          for (int e = 0; e < NE; ++e) {
            if (lane + 32 * e < n) {
              const float t = fx[e];
              pos += -t * t + (t - 1.f) * (t - 1.f) * (1.f + w[e]);
            }
            wsum += w[e];
          }
          nu += als::warp_sum(pffp) + als::warp_sum(pos);
          de = p.num_fixed_rows + als::warp_sum(wsum);
        }
        if (lane == 0) {
          p.nume[b] = nu;
          p.deno[b] = de;
        }
      }
      als::warp_cg<M>(
          [&](const float (&v)[M], float (&out)[M]) {
            float fx_[NE], dense_[M];
            matvec_full(v, out, fx_, dense_);
          },
          x0, y, Ax0, x, p.cg_iters, p.cg_tol);
#pragma unroll
      for (int m = 0; m < M; ++m)
        if (lane + 32 * m < d) row[lane + 32 * m] = x[m];
    }

    if constexpr (!kReg) {
      if (next < p.B) gather(c2);
    }
    if (next >= p.B) break;
    b = next;
    n = n2;
#pragma unroll
    for (int e = 0; e < NE; ++e) w[e] = w2[e];
    next = b + stride;
    if (next < p.B) load_meta(next, n2, c2, w2);
  }
}

template <int DW, int NE>
int launch(const Params& p, cudaStream_t stream) {
  constexpr bool kReg = NE * DW <= kRegFloats && DW <= 64;
  constexpr int N = als::round32(DW), LD = als::lane_row_stride(DW);
  const size_t fixed = sizeof(float) * N * LD;
  const size_t per_warp = sizeof(float) * (N + (size_t)p.L * LD + (p.L + 3) / 4 * 4);
  int W = kWarps;
  while (W > 1 && fixed + W * per_warp > als::kMaxSmem) --W;
  const size_t smem = fixed + W * per_warp;
  auto kernel = als_cg_matrix_free_kernel<DW, NE, kReg>;
  cudaError_t err = als::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, W * 32, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = std::min((p.B + W - 1) / W, std::max(per_sm, 1) * sms);
  kernel<<<grid, W * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Range mode: rows == NULL, batch row u is table row row_start + u.  Rows
// mode: rows != NULL, batch row u is table row rows[u].
extern "C" int als_cg_matrix_free(float* table, const float* Bf, const float* FF,
                                  const int32_t* lens, const int32_t* rows,
                                  const int32_t* cols, const void* vals, int vals_bf16,
                                  float* nume, float* deno, int64_t row_start,
                                  int64_t n_table_rows, int B, int L, int d, float alpha,
                                  float reg, int adaptive_reg, int cg_iters, float cg_tol,
                                  int item_axis, float num_fixed_rows, int compute_loss,
                                  void* stream) {
  if (B == 0) return 0;
  if (L < 1 || L > 96) return (int)cudaErrorInvalidValue;
  const int vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(Bf) % 16 == 0;
  const Params p{table,        Bf,           FF,        lens,     rows,           cols,
                 vals,         nume,         deno,      row_start, n_table_rows, B,
                 L,            d,            alpha,     reg,      adaptive_reg,   cg_iters,
                 cg_tol,       item_axis,    num_fixed_rows, compute_loss, vec, vals_bf16};
  const cudaStream_t s = (cudaStream_t)stream;
  return als::with_width<128>(d, [&](auto width) {
    constexpr int DW = decltype(width)::value;
    if (L <= 32) return launch<DW, 1>(p, s);
    if (L <= 64) return launch<DW, 2>(p, s);
    return launch<DW, 3>(p, s);
  });
}
