// K14: eALS's residuals and loss terms over the nnz entries (row rows[e], col
// keys[e], value vals[e]): vhat_e = P[row] . Q[col] (or the given residuals),
// written when asked, and the three sums sum w err^2, sum C[col] vhat^2 and
// sum err^2 with w = 1 + alpha v, err = v - vhat.  The d x d term <Sp, Sq> and
// the regularizers stay torch products on the small tables.
//
// Replaces buffalo_tpu/ops/eals_kernels.py compute_vhat (:356) and the nnz
// sums of eals_loss (:334-344).
//
// What bounds it on the card: bytes.  The function moves each entry's id,
// key and value once and each row of P and Q once (0.1 ms at ML-20M, d =
// 40), but every entry reads a row of Q: 19.9M x 160 B = 3.2 GB through
// the SMs' L1 and L2, where a warp's 32 entries touch 32 rows.  P's rows
// come in row runs (the loss view is in row order), so a warp reads few of
// them; the Zipf head of Q stays in L1 by itself.  Design: a thread per
// entry, its dot from 16-byte loads in the plain sum's order (from 0, one
// fmaf per feature), in a persistent grid of as many 1,024-thread blocks
// as are resident.  The sums are accumulated in double per thread
// over a fixed set of entries, reduced in a fixed order within the block
// (shuffles, then the warps in order) and over the blocks by a second
// one-block launch, a warp per term, so two launches are bitwise equal.
// Measured and not kept (H100): teams of 2, 4 or 16 lanes an entry (more
// issue slots than the L1 wavefronts they save), the hottest items' rows
// of Q staged in shared memory (the staging took the L1 and the occupancy
// that already served them), blocks of 512 threads.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 1024, kWarps = kThreads / 32;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float fma_unit(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float fma_unit(float a, float b, float acc) { return fmaf(a, b, acc); }

// The block's part of the three sums into part[3 * blockIdx.x ..], in a
// fixed order: the lanes by an xor tree, then the warps in order.
__device__ __forceinline__ void block_sums(double (&s)[3], double* __restrict__ part) {
  __shared__ double red[3 * kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    s[t] = warp_sum(s[t]);
    if (lane == 0) red[3 * warp + t] = s[t];
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    double tot = 0.0;
    for (int w = 0; w < kWarps; ++w) tot += red[3 * w + threadIdx.x];
    part[3 * blockIdx.x + threadIdx.x] = tot;
  }
}

// Residuals computed from the tables (kVec: float4 units), entry e by
// thread e mod the grid's threads; part null: residuals only.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
loss_kernel(const float* __restrict__ P, const float* __restrict__ Q, int d,
            const int32_t* __restrict__ rows, const int32_t* __restrict__ keys,
            const float* __restrict__ vals, const float* __restrict__ C, int64_t n, float alpha,
            float* __restrict__ vhat_out, double* __restrict__ part) {
  using U = std::conditional_t<kVec, float4, float>;
  const int units = kVec ? d / 4 : d;
  const U* Pu = reinterpret_cast<const U*>(P);
  const U* Qu = reinterpret_cast<const U*>(Q);
  double s[3] = {0.0, 0.0, 0.0};
  for (int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * kThreads) {
    const int c = keys[e];
    const U* pr = Pu + (int64_t)rows[e] * units;
    const U* qr = Qu + (int64_t)c * units;
    float v = 0.f;
#pragma unroll 4
    for (int u = 0; u < units; ++u) v = fma_unit(__ldg(pr + u), __ldg(qr + u), v);
    if (vhat_out) vhat_out[e] = v;
    if (part) {
      const float x = vals[e];
      const float err = x - v;
      const float w = 1.f + alpha * x;
      s[0] += (double)(w * err * err);
      s[1] += (double)(C[c] * v * v);
      s[2] += (double)(err * err);
    }
  }
  if (part) block_sums(s, part);
}

// The sums from given residuals: a thread per entry, the same walk.
__global__ void __launch_bounds__(kThreads)
given_kernel(const int32_t* __restrict__ keys, const float* __restrict__ vals,
             const float* __restrict__ C, int64_t n, float alpha, const float* __restrict__ vhat,
             double* __restrict__ part) {
  double s[3] = {0.0, 0.0, 0.0};
  for (int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * kThreads) {
    const float v = vhat[e], x = vals[e];
    const float err = x - v;
    const float w = 1.f + alpha * x;
    s[0] += (double)(w * err * err);
    s[1] += (double)(C[keys[e]] * v * v);
    s[2] += (double)(err * err);
  }
  block_sums(s, part);
}

// One block, a warp per term: lane l adds blocks l, l + 32, .. in order,
// the lanes by the xor tree; rounded to float once.
__global__ void __launch_bounds__(96) total_kernel(const double* __restrict__ part, int nb,
                                                   float* __restrict__ out) {
  const int lane = threadIdx.x & 31, t = threadIdx.x >> 5;
  double tot = 0.0;
  for (int b = lane; b < nb; b += 32) tot += part[3 * b + t];
  tot = warp_sum(tot);
  if (lane == 0) out[t] = (float)tot;
}

using Kernel = decltype(&loss_kernel<true>);

// Blocks the card holds at once (SMs times blocks an SM, from the kernel's
// occupancy where k is given, else from the SM's thread limit: no kernel
// holds more), no more than the entries need and at least one.
int grid_of(const void* k, int64_t n) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  const cudaError_t err =
      k ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads, 0)
        : cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  if (err != cudaSuccess) return -1;
  if (!k) per_sm /= kThreads;
  if (per_sm < 1) return -1;
  const int64_t need = (n + kThreads - 1) / kThreads, full = (int64_t)sms * per_sm;
  return (int)(need < full ? (need > 0 ? need : 1) : full);
}

bool aligned(const void* a) { return (uintptr_t)a % 16 == 0; }

}  // namespace

// Workspace doubles (3 per block) that every call of eals_loss on n entries
// fits in.
extern "C" int eals_loss_workspace(int64_t n) {
  const int g = grid_of(nullptr, n);
  return g < 0 ? -1 : 3 * g;
}

// vhat_in (residuals given) or P/Q (computed); vhat_out may be null; sums
// (3 floats) may be null, then vals, C and part are unused.
extern "C" int eals_loss(const float* P, const float* Q, int d, const int32_t* rows,
                         const int32_t* keys, const float* vals, const float* C, int64_t n,
                         float alpha, const float* vhat_in, float* vhat_out, double* part,
                         float* sums, void* stream) {
  if (n < 0 || d < 1 || (!vhat_in && (!P || !Q)) || (sums && !part) || (vhat_in && !sums))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int nb;
  if (vhat_in) {
    nb = grid_of((const void*)given_kernel, n);
    if (nb < 0) return (int)cudaErrorInvalidValue;
    given_kernel<<<nb, kThreads, 0, st>>>(keys, vals, C, n, alpha, vhat_in, part);
  } else {
    // float4 units where d is a multiple of 4 and both tables 16-byte aligned
    const Kernel k =
        d % 4 == 0 && aligned(P) && aligned(Q) ? loss_kernel<true> : loss_kernel<false>;
    nb = grid_of((const void*)k, n);
    if (nb < 0) return (int)cudaErrorInvalidValue;
    if (n > 0 || sums)
      k<<<nb, kThreads, 0, st>>>(P, Q, d, rows, keys, vals, C, n, alpha, vhat_out,
                                 sums ? part : nullptr);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !sums) return (int)err;
  total_kernel<<<1, 96, 0, st>>>(part, nb, sums);
  return (int)cudaGetLastError();
}
