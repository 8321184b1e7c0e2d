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
// reads it again from L2 (global mode, still two warps per block).
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

}  // namespace

extern "C" int batched_cg_dense(const float* A, const float* y, float* table,
                                const int32_t* lens, const int32_t* rows,
                                int64_t row_start, int64_t n_table_rows, int R, int d,
                                int cg_iters, float cg_tol, void* stream) {
  if (R == 0) return 0;
  const int vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0;
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
