// K3: warm-started batched CG on dense SPD systems, result written in place.
//
// Replaces buffalo_tpu/ops/solve.py: solve_cg (:83) = cg_warm_start (:37) +
// cg_loop (:49) in a fori_loop, and the result write of
// buffalo_tpu/ops/als_kernels.py _apply_batch (:351 range, :372 scatter).
// System b (A[b] x = y[b], d x d, from als_normal_equations) starts from its
// current table row and its result goes to table[row_start + b] (range) or
// table[rows[b]] (scatter).  Rows with len 0 keep p; padding ids past the
// table (1 << 30 or num_rows in the reference, dropped there with
// mode="drop") are skipped, since a write there would fault.
//
// What bounds it on the card: reading A (4 d^2 bytes per system, 6.4 KB at
// d = 40) once is ~2 us for a whole batch; what is left is the latency of
// one system's chain (the load of A, cg_iters + 1 matvecs, ~10 reductions)
// and the launch.  Design: one warp per system, several systems per block,
// no block barrier anywhere.  Lane i owns rows i, i + 32, ... of A and
// entries i, i + 32, ... of every CG vector, so a matvec needs no
// reduction: the vector is broadcast through the warp's own slice of shared
// memory (__syncwarp) and read as float4.  Dot products are xor-butterfly
// warp sums, the same bits on every lane.  For d <= 64 the lane's rows of A
// sit in registers, loaded once with 16-byte loads when rows are 16-byte
// aligned; wider A is copied into the warp's shared memory (rows at a
// stride that keeps float4 row reads free of bank conflicts) and read from
// there in every matvec, two warps per block at d = 160 (105 KB each).  At
// d = 256 one system's A (266 KB) exceeds a block's 227 KB, so each matvec
// reads it again from L2 (global mode, still two warps per block).  Past
// 256 floats the vectors no longer fit a lane's registers: one block of
// kWideThreads per system holds them in shared memory, thread i computing
// rows i, i + kWideThreads, ... of each matvec from A in global memory (in
// column order, as the lanes do), the dot products block sums in a fixed
// order.
#include "als_common.cuh"

namespace {

// systems per block, one warp each (chosen on the card with
// tools/cg_bench.py, PERF.md); fewer where a wide A's shared memory does not fit
constexpr int kWarps = 2;

// where a warp keeps its system's A
enum Mode { kRegisters, kShared, kGlobal };

template <int DW, int kMode>
__global__ void __launch_bounds__(kWarps * 32, 1)
batched_cg_dense_kernel(const float* __restrict__ A, const float* __restrict__ y,
                        float* __restrict__ table, const int32_t* __restrict__ lens,
                        const int32_t* __restrict__ rows, int64_t row_start,
                        int64_t n_table_rows, int R, int d, int cg_iters, float cg_tol,
                        int vec) {
  constexpr int N = als::round32(DW), M = N / 32, KC = DW / 4;
  constexpr int LDA = als::lane_row_stride(DW);
  constexpr bool kReg = kMode == kRegisters;
  constexpr int kWarpFloats = N + (kMode == kShared ? N * LDA : 0);
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= R || lens[b] <= 0) return;
  const int64_t dst = rows ? (int64_t)rows[b] : row_start + b;
  if (dst < 0 || dst >= n_table_rows) return;
  float* vs = reinterpret_cast<float*>(smem4) + warp * kWarpFloats;  // [N]
  float* As = vs + N;                                                 // [N][LDA]
  const float* Ab = A + (int64_t)b * d * d;

  // A's rows: registers (lane's rows, zeros past d) or the warp's shared slice
  float4 a[kReg ? M : 1][kReg ? KC : 1];
  auto load4 = [&](int i, int c) {  // A[i][4c .. 4c + 4), zeros past d
    const float* src = Ab + (int64_t)i * d + 4 * c;
    if (vec && 4 * c < d) return __ldg(reinterpret_cast<const float4*>(src));
    float4 t;
    t.x = 4 * c + 0 < d ? __ldg(src + 0) : 0.f;
    t.y = 4 * c + 1 < d ? __ldg(src + 1) : 0.f;
    t.z = 4 * c + 2 < d ? __ldg(src + 2) : 0.f;
    t.w = 4 * c + 3 < d ? __ldg(src + 3) : 0.f;
    return t;
  };
  if constexpr (kReg) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int i = lane + 32 * m;
#pragma unroll
      for (int c = 0; c < KC; ++c)
        a[m][c] = i < d ? load4(i, c) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else if constexpr (kMode == kShared) {
    for (int i = 0; i < d; ++i)
      for (int c = lane; c < KC; c += 32)
        reinterpret_cast<float4*>(As + i * LDA)[c] = load4(i, c);
    __syncwarp();
  }
  auto getA = [&](int m, int c) -> float4 {
    if constexpr (kReg) return a[m][c];
    else if constexpr (kMode == kShared)
      return reinterpret_cast<const float4*>(As + (lane + 32 * m) * LDA)[c];
    else return load4(lane + 32 * m, c);  // only for rows < d
  };

  float* row = table + dst * d;
  float x0[M], ys[M], Ax0[M], x[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int i = lane + 32 * m;
    x0[m] = i < d ? row[i] : 0.f;
    ys[m] = i < d ? y[(int64_t)b * d + i] : 0.f;
  }
  // out = A v, row by row: lane i's entry is A[i] . v, summed in column order
  auto matvec = [&](const float (&v)[M], float (&out)[M]) {
    __syncwarp();
#pragma unroll
    for (int m = 0; m < M; ++m) vs[lane + 32 * m] = v[m];
    __syncwarp();
    float acc[M];
#pragma unroll
    for (int m = 0; m < M; ++m) acc[m] = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const float4 v4 = reinterpret_cast<const float4*>(vs)[c];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        if (!kReg && lane + 32 * m >= d) continue;  // no such row in As
        const float4 t = getA(m, c);
        acc[m] = fmaf(t.x, v4.x, acc[m]);
        acc[m] = fmaf(t.y, v4.y, acc[m]);
        acc[m] = fmaf(t.z, v4.z, acc[m]);
        acc[m] = fmaf(t.w, v4.w, acc[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) out[m] = acc[m];
  };
  matvec(x0, Ax0);
  als::warp_cg<M>(matvec, x0, ys, Ax0, x, cg_iters, cg_tol);
#pragma unroll
  for (int m = 0; m < M; ++m)
    if (lane + 32 * m < d) row[lane + 32 * m] = x[m];
}

// ------------------------------------------------------------- wide systems
constexpr int kWideThreads = 256;

// One block per system of any width d: x0, y, x, r, p and A p in shared
// memory (6 d floats), A read from global memory.
__global__ void __launch_bounds__(kWideThreads)
batched_cg_dense_wide(const float* __restrict__ A, const float* __restrict__ y,
                      float* __restrict__ table, const int32_t* __restrict__ lens,
                      const int32_t* __restrict__ rows, int64_t row_start, int64_t n_table_rows,
                      int R, int d, int cg_iters, float cg_tol) {
  extern __shared__ float wsm[];
  __shared__ float scratch[33];
  const int b = blockIdx.x, tid = threadIdx.x;
  if (lens[b] <= 0) return;  // the whole block
  const int64_t dst = rows ? (int64_t)rows[b] : row_start + b;
  if (dst < 0 || dst >= n_table_rows) return;
  float *x0 = wsm, *ys = x0 + d, *x = ys + d, *r = x + d, *pv = r + d, *Ap = pv + d;
  const float* Ab = A + (int64_t)b * d * d;
  float* row = table + dst * d;
  for (int i = tid; i < d; i += kWideThreads) {
    x0[i] = row[i];
    ys[i] = y[(int64_t)b * d + i];
  }
  __syncthreads();
  auto matvec = [&](const float* v, float* out) {  // out = A v, row by row
    for (int i = tid; i < d; i += kWideThreads) {
      const float* a = Ab + (int64_t)i * d;
      float acc = 0.f;
      for (int k = 0; k < d; ++k) acc = fmaf(__ldg(a + k), v[k], acc);
      out[i] = acc;
    }
    __syncthreads();
  };
  // the reference's warm start (solve.py:37): keep x0 unless the zero start
  // has the smaller residual
  matvec(x0, Ap);
  float yy = 0.f, rr = 0.f;
  for (int i = tid; i < d; i += kWideThreads) {
    r[i] = ys[i] - Ap[i];
    yy += ys[i] * ys[i];
    rr += r[i] * r[i];
  }
  const bool use_zero = als::block_sum(yy, scratch) < als::block_sum(rr, scratch);
  float part = 0.f;
  for (int i = tid; i < d; i += kWideThreads) {
    x[i] = use_zero ? 0.f : x0[i];
    if (use_zero) r[i] = ys[i];
    pv[i] = r[i];
    part += r[i] * r[i];
  }
  __syncthreads();
  float rsold = als::block_sum(part, scratch);
  bool active = rsold >= cg_tol;
  for (int it = 0; it < cg_iters && active; ++it) {
    matvec(pv, Ap);
    part = 0.f;
    for (int i = tid; i < d; i += kWideThreads) part += pv[i] * Ap[i];
    const float alpha = rsold / fmaxf(als::block_sum(part, scratch), 1e-30f);
    part = 0.f;
    for (int i = tid; i < d; i += kWideThreads) {
      x[i] += alpha * pv[i];
      r[i] -= alpha * Ap[i];
      part += r[i] * r[i];
    }
    const float rsnew = als::block_sum(part, scratch);
    active = rsnew >= cg_tol;
    const float beta = rsold > 0.f ? rsnew / fmaxf(rsold, 1e-30f) : 0.f;
    for (int i = tid; i < d; i += kWideThreads) pv[i] = r[i] + beta * pv[i];
    __syncthreads();
    rsold = rsnew;
  }
  for (int i = tid; i < d; i += kWideThreads) row[i] = x[i];
}

}  // namespace

// 1 when systems of width d take the wide kernel.
extern "C" int batched_cg_dense_wide_mode(int d) { return d > 256 ? 1 : 0; }

extern "C" int batched_cg_dense(const float* A, const float* y, float* table,
                                const int32_t* lens, const int32_t* rows,
                                int64_t row_start, int64_t n_table_rows, int R, int d,
                                int cg_iters, float cg_tol, void* stream) {
  if (R == 0) return 0;
  const int vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0;
  if (batched_cg_dense_wide_mode(d)) {
    const size_t smem = sizeof(float) * 6 * (size_t)d;
    const cudaError_t err = als::allow_smem(batched_cg_dense_wide, smem);
    if (err != cudaSuccess) return (int)err;
    batched_cg_dense_wide<<<R, kWideThreads, smem, (cudaStream_t)stream>>>(
        A, y, table, lens, rows, row_start, n_table_rows, R, d, cg_iters, cg_tol);
    return (int)cudaGetLastError();
  }
  return als::with_width<256>(d, [&](auto width) {
    constexpr int DW = decltype(width)::value;
    constexpr int N = als::round32(DW);
    constexpr size_t kSharedA = sizeof(float) * N * als::lane_row_stride(DW);
    constexpr int kMode = DW <= 64                                   ? kRegisters
                          : sizeof(float) * N + kSharedA <= als::kMaxSmem ? kShared
                                                                        : kGlobal;
    const size_t per_warp = sizeof(float) * N + (kMode == kShared ? kSharedA : 0);
    int W = kWarps;
    while (W > 1 && W * per_warp > als::kMaxSmem) --W;
    auto kernel = batched_cg_dense_kernel<DW, kMode>;
    cudaError_t err = als::allow_smem(kernel, W * per_warp);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(R + W - 1) / W, W * 32, W * per_warp, (cudaStream_t)stream>>>(
        A, y, table, lens, rows, row_start, n_table_rows, R, d, cg_iters, cg_tol, vec);
    return (int)cudaGetLastError();
  });
}
