// K4: iALS++ block subspace CG for ALS batches, range or scatter rows.
//
// Replaces buffalo_tpu/ops/als_kernels.py: ialspp_solve_batch (:174-238) with
// the loss terms of _loss_terms (:77) and the gather/write of _apply_batch
// (:343-346 range, :364-372 scatter), the reference's _partial_update_ialspp
// (als.cc:211-358).  Per row u, with F = Bf[cols[u]] over its n entries,
// w = alpha * vals and the residual cache Yui_l = p . F_l:
//   for each block [beg, beg + bs) of the d features, in order,
//     b   = p FF[:, blk] + reg p_blk + sum_l (Yui_l - 1) w_l F_l[blk]
//     x   = 3 CG steps from zero on (FF[blk, blk] + reg I
//                                    + F[:, blk]^T diag(w) F[:, blk]) x = b,
//           a system freezing once its squared residual is below cg_tol
//     p_blk -= x,   Yui_l -= F_l[blk] . x   (dead after the last block)
// with plain reg (adaptive_reg scales only the loss's regularization term),
// and the loss terms from the pre-update p.  The result is written over
// table[row_start + u] (range mode) or table[rows[u]] (rows mode); rows with
// len 0 and ids outside the table (a PaddedBatch's padding) are skipped.
// The values are float32 or bfloat16 (read as float32).
//
// What bounds it on the card: per row and block, the gather of F (n rows of
// d floats from a fixed-side table that sits in L2 or HBM) is read by the b
// pass, three matvecs and the Yui updates, ~6 d n operations a pass; FF's
// block is read from L2 by the four dense products.  Neither the bytes nor
// the FP32 rate is near its limit: the block barriers between the passes
// are (a simple first kernel, one block per row).  Design:
// * One block of 256 threads per row.  Thread j owns feature j of the
//   current block (bs <= 256): its entries of b, x, r and A p stay in its
//   registers, and the CG direction is broadcast through shared memory.
// * F sits in a shared-memory tile of T entries (16-byte rows, filled by
//   cp.async through L1: a power-law gather re-reads popular rows).  A row
//   of at most T entries is gathered once and kept for the whole solve; a
//   longer row is streamed through the tile in every pass.  Yui (one float
//   per entry, up to 8192) stays in shared memory.
// * Per-entry dots (F_l . v) are one warp per entry, lanes over features,
//   summed by a fixed xor butterfly; per-feature sums (F^T g) are one thread
//   per feature over the tile's entries in order, each tile summed from zero
//   and added to a running total; scalar products are block_sums.  Every sum
//   has a fixed order, so two launches are bitwise equal, and every branch
//   that meets a barrier is the same on all threads.
#include "als_common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps; thread j owns feature j of a block
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 3;      // CG steps per block (als.cc:322-345)
constexpr int kMaxM = 32;      // features per thread: block_size <= 8192

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
  int L, d, bs;
  float alpha, reg, cg_tol, num_fixed_rows;
  int adaptive_reg, item_axis, compute_loss, vals_bf16;
  int T;    // entries per shared-memory tile
  int S;    // tile row stride in floats (16-byte rows)
  int vec;  // 16-byte copies
};

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// shared memory of a launch, in floats
__host__ __device__ constexpr size_t smem_floats(int T, int S, int d, int L) {
  return (size_t)T * S + 2 * round4(d) + round4(L) + 3 * round4(T) + 33;
}

// kM features of a block per thread: thread j owns features j + m kThreads,
// m < kM (1 for block sizes up to kThreads; wider blocks, iALS++'s default
// block_size = d past 256, take the wider instantiations).
template <int kM>
__global__ void __launch_bounds__(kThreads) ialspp_solve_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = min(p.lens[b], p.L);
  const int64_t dst = p.rows ? (int64_t)p.rows[b] : p.row_start + b;
  if (n <= 0 || dst < 0 || dst >= p.n_table_rows) return;  // the whole block
  const int d = p.d, S = p.S, T = p.T;
  float* Fs = smem;                                  // [T][S] the tile's F rows
  float* ps = Fs + (size_t)T * S;                    // [d]    p, updated per block
  float* vs = ps + round4(d);                        // [bs]   CG direction, then x
  float* Yui = vs + round4(d);                       // [L]    p . F_l
  float* ws = Yui + round4(p.L);                     // [T]    the tile's w
  float* gs = ws + round4(T);                        // [T]    per-entry scalars
  int* cs = reinterpret_cast<int*>(gs + round4(T));  // [T]    the tile's cols
  float* scratch = reinterpret_cast<float*>(cs + round4(T));  // [33]

  const int64_t base = (int64_t)b * p.L;
  const int ntiles = (n + T - 1) / T;
  const bool resident = ntiles == 1;
  const int KC = p.vec ? d / 4 : d;  // copies per row
  auto load_tile = [&](int t0, int tl) {
    __syncthreads();  // nobody reads the previous tile, ws or gs any more
    for (int i = tid; i < tl; i += kThreads) {
      cs[i] = p.cols[base + t0 + i];
      ws[i] = p.alpha * als::load_val(p.vals, base + t0 + i, p.vals_bf16);
    }
    __syncthreads();
    for (int q = tid; q < tl * KC; q += kThreads) {
      const int l = q / KC, c = q - l * KC;
      const float* src = p.Bf + (int64_t)cs[l] * d;
      if (p.vec) als::cp_async16(Fs + l * S + 4 * c, src + 4 * c, true);
      else als::cp_async4(Fs + l * S + c, src + c, true);
    }
    als::cp_async_commit();
    als::cp_async_wait_all();
    __syncthreads();
  };
  // body(t0, tl) on the row's entries a tile at a time (each body ends with
  // a barrier); a row of one tile keeps it for the whole solve
  auto tiles = [&](auto&& body) {
    for (int t = 0; t < ntiles; ++t) {
      const int t0 = t * T;
      if (!resident) load_tile(t0, min(T, n - t0));
      body(t0, min(T, n - t0));
    }
  };
  // use(l, F_l[beg, beg + len) . v) for the tile's entries: warp w takes
  // entries w, w + 8, ...; the butterfly gives every lane the same bits
  auto dot_rows = [&](int tl, int beg, int len, const float* v, auto&& use) {
    for (int l = warp; l < tl; l += kWarps) {
      const float* f = Fs + l * S + beg;
      float s = 0.f;
      for (int k = lane; k < len; k += 32) s = fmaf(f[k], v[k], s);
      use(l, als::warp_sum(s));
    }
  };
  // sum over the tile's entries of gs[l] F_l[beg + j], in entry order
  auto sum_rows = [&](int tl, int beg, int j) {
    float s = 0.f;
    for (int l = 0; l < tl; ++l) s = fmaf(gs[l], Fs[l * S + beg + j], s);
    return s;
  };

  if (resident) load_tile(0, n);
  for (int j = tid; j < d; j += kThreads) ps[j] = p.table[dst * d + j];
  __syncthreads();

  // ---- Yui = p . F_l, with the entry sums of the loss (pre-update p)
  float pos = 0.f, wsum = 0.f;  // this warp's share, the same on all its lanes
  tiles([&](int t0, int tl) {
    dot_rows(tl, 0, d, ps, [&](int l, float s) {
      if (lane == 0) Yui[t0 + l] = s;
      pos += -s * s + (s - 1.f) * (s - 1.f) * (1.f + ws[l]);
      wsum += ws[l];
    });
    __syncthreads();
  });
  if (p.compute_loss) {
    float sq = 0.f, pffp = 0.f;
    for (int j = tid; j < d; j += kThreads) {
      sq += ps[j] * ps[j];
      if (p.item_axis) {
        float q = 0.f;
        for (int k = 0; k < d; ++k) q = fmaf(ps[k], __ldg(p.FF + (int64_t)k * d + j), q);
        pffp += ps[j] * q;
      }
    }
    const float reg_ada = p.reg * (p.adaptive_reg ? (float)n : 1.f);
    float nu = reg_ada * als::block_sum(sq, scratch), de = 0.f;
    if (p.item_axis) {
      nu += als::block_sum(pffp, scratch) + als::block_sum(lane == 0 ? pos : 0.f, scratch);
      de = p.num_fixed_rows + als::block_sum(lane == 0 ? wsum : 0.f, scratch);
    }
    if (tid == 0) {
      p.nume[b] = nu;
      p.deno[b] = de;
    }
  }

  const int nblk = (d + p.bs - 1) / p.bs;
  for (int blk = 0; blk < nblk; ++blk) {
    const int beg = blk * p.bs, bs = min(p.bs, d - beg);

    // ---- b = p FF[:, blk] + reg p_blk + sum_l (Yui_l - 1) w_l F_l[blk]
    float dense[kM], data[kM];
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const int j = tid + m * kThreads;
      dense[m] = data[m] = 0.f;
      if (j < bs) {  // thread tid holds feature beg + j of the block
        for (int k = 0; k < d; ++k)
          dense[m] = fmaf(ps[k], __ldg(p.FF + (int64_t)k * d + beg + j), dense[m]);
        dense[m] += p.reg * ps[beg + j];
      }
    }
    tiles([&](int t0, int tl) {
      for (int l = tid; l < tl; l += kThreads) gs[l] = (Yui[t0 + l] - 1.f) * ws[l];
      __syncthreads();
#pragma unroll
      for (int m = 0; m < kM; ++m)
        if (tid + m * kThreads < bs) data[m] += sum_rows(tl, beg, tid + m * kThreads);
      __syncthreads();
    });

    // ---- 3 CG steps from x = 0, r = b (solve.py cg_loop's freeze rule)
    float r[kM], x[kM], pv[kM];
    float rr = 0.f;
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const int j = tid + m * kThreads;
      r[m] = j < bs ? dense[m] + data[m] : 0.f;
      x[m] = 0.f;
      pv[m] = r[m];
      if (j < bs) vs[j] = pv[m];
      rr += r[m] * r[m];
    }
    float rsold = als::block_sum(rr, scratch);
    bool active = rsold >= p.cg_tol;
    for (int it = 0; it < kSteps && active; ++it) {
      // A pv = pv (FF[blk, blk] + reg I) + F[:, blk]^T (w * F[:, blk] pv);
      // FF is symmetric, so column j is read down a column (coalesced)
      float Ap[kM], acc[kM];
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const int j = tid + m * kThreads;
        Ap[m] = acc[m] = 0.f;
        if (j < bs) {
          for (int i = 0; i < bs; ++i)
            Ap[m] = fmaf(vs[i], __ldg(p.FF + (int64_t)(beg + i) * d + beg + j), Ap[m]);
          Ap[m] += p.reg * pv[m];
        }
      }
      tiles([&](int t0, int tl) {
        dot_rows(tl, beg, bs, vs, [&](int l, float s) {
          if (lane == 0) gs[l] = s * ws[l];
        });
        __syncthreads();
#pragma unroll
        for (int m = 0; m < kM; ++m)
          if (tid + m * kThreads < bs) acc[m] += sum_rows(tl, beg, tid + m * kThreads);
        __syncthreads();
      });
      float pAp = 0.f;
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        Ap[m] += acc[m];
        pAp += pv[m] * Ap[m];
      }
      const float alpha = rsold / fmaxf(als::block_sum(pAp, scratch), 1e-30f);
      rr = 0.f;
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        x[m] += alpha * pv[m];
        r[m] -= alpha * Ap[m];
        rr += r[m] * r[m];
      }
      const float rsnew = als::block_sum(rr, scratch);
      active = rsnew >= p.cg_tol;
      const float beta = rsold > 0.f ? rsnew / fmaxf(rsold, 1e-30f) : 0.f;
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        pv[m] = r[m] + beta * pv[m];
        if (tid + m * kThreads < bs) vs[tid + m * kThreads] = pv[m];
      }
      __syncthreads();
      rsold = rsnew;
    }

    // ---- p_blk -= x; Yui -= F[:, blk] x (not needed after the last block)
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const int j = tid + m * kThreads;
      if (j < bs) {
        ps[beg + j] -= x[m];
        vs[j] = x[m];
      }
    }
    __syncthreads();
    if (blk + 1 < nblk)
      tiles([&](int t0, int tl) {
        dot_rows(tl, beg, bs, vs, [&](int l, float s) {
          if (lane == 0) Yui[t0 + l] -= s;
        });
        __syncthreads();
      });
  }
  for (int j = tid; j < d; j += kThreads) p.table[dst * d + j] = ps[j];
}

}  // namespace

// Features of a block per thread (1: the narrow form, block_size <= 256).
extern "C" int ialspp_features_per_thread(int block_size) {
  return (block_size + kThreads - 1) / kThreads;
}

// Range mode: rows == NULL, batch row u is table row row_start + u.  Rows
// mode: rows != NULL, batch row u is table row rows[u].  nume / deno (B)
// receive the loss terms of the rows solved and are left as they are for the
// rows skipped.
extern "C" int ialspp_solve(float* table, const float* Bf, const float* FF,
                            const int32_t* lens, const int32_t* rows, int64_t row_start,
                            const int32_t* cols, const void* vals, int vals_bf16, float* nume,
                            float* deno, int64_t n_table_rows, int B, int L, int d,
                            int block_size, float alpha, float reg, int adaptive_reg,
                            float cg_tol, int item_axis, float num_fixed_rows,
                            int compute_loss, void* stream) {
  if (B == 0) return 0;
  if (L < 1 || d < 1 || block_size < 1 || block_size > kThreads * kMaxM)
    return (int)cudaErrorInvalidValue;
  Params p{table, Bf,    FF,  lens,   rows,  cols,         vals,         nume,
           deno,  row_start, n_table_rows, L, d, block_size, alpha, reg,
           cg_tol, num_fixed_rows, adaptive_reg, item_axis, compute_loss, vals_bf16};
  p.S = round4(d);
  p.vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(Bf) % 16 == 0;
  // the largest tile that fits (each of its three per-entry arrays rounds up
  // by at most 3 floats), at most the batch's length
  const size_t budget = als::kMaxSmem / sizeof(float), fixed = smem_floats(0, p.S, d, L);
  if (fixed + 9 + p.S + 3 > budget) return (int)cudaErrorInvalidValue;
  const size_t T = (budget - fixed - 9) / (p.S + 3);
  p.T = T < (size_t)L ? (int)T : L;
  const size_t smem = sizeof(float) * smem_floats(p.T, p.S, d, L);
  auto launch = [&](auto kernel) {
    cudaError_t err = als::allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
  };
  const int per = ialspp_features_per_thread(block_size);
  if (per == 1) return launch(ialspp_solve_kernel<1>);
  if (per == 2) return launch(ialspp_solve_kernel<2>);
  if (per <= 4) return launch(ialspp_solve_kernel<4>);
  if (per <= 8) return launch(ialspp_solve_kernel<8>);
  if (per <= 16) return launch(ialspp_solve_kernel<16>);
  return launch(ialspp_solve_kernel<kMaxM>);
}
