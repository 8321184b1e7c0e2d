// K12: a WARP chunk's deferred gradients.  Given K11's choice per slot j
// (users[j], pos[j], neg[j], any_v[j], weight w[j]; slots from n_valid on are
// padding), every valid slot with any_v adds, with W = 2 w for l2 and w for
// dot:
//  * u_deriv - reg_u p_u into gP[u], u_deriv = W (q_i - q_j);
//  * i_deriv - reg_i q_i into gQ[i] if update_i, i_deriv = w p_u (dot) or
//    w (p_u - q_i) (l2);
//  * j_deriv - reg_j q_j into gQ[j] if update_j, j_deriv = -w p_u (dot) or
//    -w (p_u - q_j) (l2);
// and with per-coordinate normalization 1 into cP[u], cQ[i] and cQ[j]
// (whatever update_i / update_j say).  The sums are added onto the epoch's
// running gradients and counts; P and Q are only read.
//
// Replaces buffalo_tpu/ops/warp_kernels.py warp_accumulate_step's scatter
// (:145-170) and warp_epoch's scan-body scatter (:295-317).
//
// What bounds it on the card: three rows gathered per contributing slot (p_u,
// q_i, q_j), d floats each, and the touched rows of gP and gQ read and
// written once; at d = 64 ~0.8 KB per slot, so a 32,768-slot chunk moves ~27
// MB, and ~10 d operations per slot are far below the FP32 rate.  Design: as
// K9 (row_group.cuh), with no float atomics: each side's entries are grouped
// by row with the stable radix sort, each row's entries summed in entry order
// in runs of kRun (one warp per run), and one warp per row adds its runs in
// order onto the running sums, so two launches are bitwise equal.  The user
// side of a resident chunk is already in user order (the positives come in
// CSR order), so its sort is skipped: padding slots are keyed past the table
// and slots without a violator stay in place, summing nothing.  A lane holds
// 8 columns (kChunk = 256 per warp); wider rows take the wide instantiation
// of the run and row kernels, which walks each row in 256-column chunks.
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_group.cuh"

namespace {

__device__ __forceinline__ bool live(int j, int n_valid, const uint8_t* __restrict__ anyv) {
  return j < n_valid && anyv[j];
}

// User side: entry j = slot j.  Item side: entry e < N the positive of slot
// e, entry N + j the negative of slot j; an item entry lives for its side's
// update or for the counts.
__global__ void __launch_bounds__(kThreads)
make_keys(int item_side, const int32_t* __restrict__ users, const int32_t* __restrict__ pos,
          const int32_t* __restrict__ neg, const uint8_t* __restrict__ anyv, int N, int n_valid,
          int users_sorted, int keep_pos, int keep_neg, int R, int n, int32_t* __restrict__ key,
          int32_t* __restrict__ idx) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  int k;
  if (!item_side) {
    k = users_sorted ? (e < n_valid ? users[e] : R) : (live(e, n_valid, anyv) ? users[e] : R);
  } else if (e < N) {
    k = keep_pos && live(e, n_valid, anyv) ? pos[e] : R;
  } else {
    k = keep_neg && live(e - N, n_valid, anyv) ? neg[e - N] : R;
  }
  key[e] = k;
  idx[e] = e;
}

// User runs: part[q] = (the sum of the run's user deltas, its live entries).
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
user_runs(const int32_t* __restrict__ idx, int R, const int32_t* __restrict__ start,
          const int32_t* __restrict__ run_start, const int32_t* __restrict__ users,
          const int32_t* __restrict__ pos, const int32_t* __restrict__ neg,
          const uint8_t* __restrict__ anyv, const float* __restrict__ w, int n_valid,
          const float* __restrict__ P, const float* __restrict__ Q, int d, int l2, float reg_u,
          float* __restrict__ part) {
  const int lane = threadIdx.x & 31, q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  int r, m0, m1;
  if (!find_run(q, R, start, run_start, r, m0, m1)) return;
  float* out = part + (int64_t)q * (d + 1);
  float cnt = 0.f;
  for (int c0 = 0; c0 < chunk_end<kWide>(d); c0 += kChunk) {
    float acc[kMaxH];
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) acc[h] = 0.f;
    cnt = 0.f;
    for (int m = m0; m < m1; ++m) {
      const int j = idx[m];
      if (!live(j, n_valid, anyv)) continue;
      const float ww = l2 ? 2.f * w[j] : w[j];
      const float* p = P + (int64_t)users[j] * d;
      const float* qi = Q + (int64_t)pos[j] * d;
      const float* qj = Q + (int64_t)neg[j] * d;
#pragma unroll
      for (int h = 0; h < kMaxH; ++h) {
        const int c = c0 + lane + 32 * h;
        if (c < d) acc[h] += ww * (qi[c] - qj[c]) - reg_u * p[c];
      }
      cnt += 1.f;
    }
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) {
      const int c = c0 + lane + 32 * h;
      if (c < d) out[c] = acc[h];
    }
  }
  if (lane == 0) out[d] = cnt;
}

// Item runs: part[q] = (the sum of the run's item deltas, its entries).
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
item_runs(const int32_t* __restrict__ idx, int R, const int32_t* __restrict__ start,
          const int32_t* __restrict__ run_start, const int32_t* __restrict__ users,
          const int32_t* __restrict__ pos, const int32_t* __restrict__ neg, int N,
          const float* __restrict__ w, const float* __restrict__ P, const float* __restrict__ Q,
          int d, int l2, float reg_i, float reg_j, int upd_i, int upd_j,
          float* __restrict__ part) {
  const int lane = threadIdx.x & 31, q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  int r, m0, m1;
  if (!find_run(q, R, start, run_start, r, m0, m1)) return;
  float* out = part + (int64_t)q * (d + 1);
  for (int c0 = 0; c0 < chunk_end<kWide>(d); c0 += kChunk) {
    float acc[kMaxH];
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) acc[h] = 0.f;
    for (int m = m0; m < m1; ++m) {
      const int e = idx[m];
      const bool positive = e < N;
      const int j = positive ? e : e - N;
      if (!(positive ? upd_i : upd_j)) continue;  // kept for the counts only
      const float* p = P + (int64_t)users[j] * d;
      const float* q = Q + (int64_t)(positive ? pos[j] : neg[j]) * d;
      const float s = positive ? w[j] : -w[j];
      const float reg = positive ? reg_i : reg_j;
#pragma unroll
      for (int h = 0; h < kMaxH; ++h) {
        const int c = c0 + lane + 32 * h;
        if (c < d) acc[h] += s * (l2 ? p[c] - q[c] : p[c]) - reg * q[c];
      }
    }
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) {
      const int c = c0 + lane + 32 * h;
      if (c < d) out[c] = acc[h];
    }
  }
  if (lane == 0) out[d] = (float)(m1 - m0);
}

// One warp per row: its runs added in order onto g (and the count onto cnt).
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
add_rows(int R, const int32_t* __restrict__ start, const int32_t* __restrict__ run_start,
         const float* __restrict__ part, int d, float* __restrict__ g, float* __restrict__ cnt) {
  const int lane = threadIdx.x & 31, r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= R || start[r + 1] == start[r]) return;
  float acc[kMaxH], sc[4];
  float* gr = g + (int64_t)r * d;
  for (int c0 = 0; c0 < chunk_end<kWide>(d); c0 += kChunk) {
    row_sum(r, run_start, part, d, d + 1, lane, acc, sc, c0);
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) {
      const int c = c0 + lane + 32 * h;
      if (c < d) gr[c] += acc[h];
    }
  }
  if (cnt && lane == 0) cnt[r] += sc[0];
}

// The run and row kernels of one chunk, narrow or wide.
template <bool kWide>
cudaError_t sum_sides(const Side& su, const Side& si, const int32_t* users, const int32_t* pos,
                      const int32_t* neg, const uint8_t* anyv, const float* w, const float* P,
                      const float* Q, int N, int n_valid, int U, int I, int d, int l2,
                      float reg_u, float reg_i, float reg_j, int upd_i, int upd_j, float* gP,
                      float* gQ, float* cP, float* cQ, cudaStream_t st) {
  user_runs<kWide><<<warps_grid(su.max_runs), kThreads, 0, st>>>(
      su.idx[su.sorted], su.R, su.start, su.run_start, users, pos, neg, anyv, w, n_valid, P, Q, d,
      l2, reg_u, su.part);
  CHECK_LAUNCH();
  item_runs<kWide><<<warps_grid(si.max_runs), kThreads, 0, st>>>(
      si.idx[si.sorted], si.R, si.start, si.run_start, users, pos, neg, N, w, P, Q, d, l2, reg_i,
      reg_j, upd_i, upd_j, si.part);
  CHECK_LAUNCH();
  add_rows<kWide><<<warps_grid(U), kThreads, 0, st>>>(U, su.start, su.run_start, su.part, d, gP,
                                                      cP);
  CHECK_LAUNCH();
  add_rows<kWide><<<warps_grid(I), kThreads, 0, st>>>(I, si.start, si.run_start, si.part, d, gQ,
                                                      cQ);
  return cudaGetLastError();
}

void layout(int N, int U, int I, int d, int32_t* ibase, float* fbase, Side& su, Side& si,
            int64_t* isz, int64_t* fsz) {
  int64_t io = 0, fo = 0;
  auto ints = [&](int64_t m) {
    int32_t* p = ibase ? ibase + io : nullptr;
    io += m;
    return p;
  };
  auto floats = [&](int64_t m) {
    float* p = fbase ? fbase + fo : nullptr;
    fo += m;
    return p;
  };
  carve_side(su, N, U, d + 1, ints, floats);
  carve_side(si, 2 * N, I, d + 1, ints, floats);
  *isz = io;
  *fsz = fo;
}

}  // namespace

// sizes[0]: int32 words, sizes[1]: float32 words of the workspace.
extern "C" int warp_workspace(int N, int U, int I, int d, int64_t* sizes) {
  Side su, si;
  layout(N, U, I, d, nullptr, nullptr, su, si, &sizes[0], &sizes[1]);
  return 0;
}

// 1 when rows of d floats take the wide instantiation.
extern "C" int warp_accumulate_wide(int d) { return d > kChunk ? 1 : 0; }

// users_sorted: users[0, n_valid) ascend (a resident chunk).  cP and cQ are
// both given (per-coordinate normalization) or both null.
extern "C" int warp_accumulate(const int32_t* users, const int32_t* pos, const int32_t* neg,
                               const uint8_t* anyv, const float* w, const float* P,
                               const float* Q, int N, int n_valid, int U, int I, int d, int l2,
                               float reg_u, float reg_i, float reg_j, int upd_i, int upd_j,
                               int users_sorted, float* gP, float* gQ, float* cP, float* cQ,
                               int32_t* ws_i, float* ws_f, void* stream) {
  if (N < 0 || U < 1 || I < 1 || d < 1 || (int64_t)2 * N >= (1LL << 31) ||
      (!cP) != (!cQ))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int pcn = cP != nullptr;
  Side su, si;
  int64_t isz, fsz;
  layout(N, U, I, d, ws_i, ws_f, su, si, &isz, &fsz);
  for (int s = 0; s < 2; ++s) {
    Side& x = s ? si : su;
    make_keys<<<(x.n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        s, users, pos, neg, anyv, N, n_valid, users_sorted, upd_i || pcn, upd_j || pcn, x.R, x.n,
        x.key[0], x.idx[0]);
    CHECK_LAUNCH();
    const cudaError_t err = sort_side(x, s == 0 && users_sorted, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)(warp_accumulate_wide(d)
                   ? sum_sides<true>(su, si, users, pos, neg, anyv, w, P, Q, N, n_valid, U, I, d,
                                     l2, reg_u, reg_i, reg_j, upd_i, upd_j, gP, gQ, cP, cQ, st)
                   : sum_sides<false>(su, si, users, pos, neg, anyv, w, P, Q, N, n_valid, U, I,
                                      d, l2, reg_u, reg_i, reg_j, upd_i, upd_j, gP, gQ, cP, cQ,
                                      st));
}
