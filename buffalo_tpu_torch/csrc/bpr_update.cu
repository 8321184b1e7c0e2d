// K9: a BPR chunk's update.  Given the chunk's users and positives (N slots,
// the first n_valid real) and its negatives (neg_per per slot, >= num_items a
// sentinel), every sample's logit l = 1 - sigmoid(x) with the reference's
// +-6 clamps, x = p_u . (q_i - q_j) (+ Qb_i - Qb_j), 0 for a sentinel or a
// padding slot; then either
//  * sgd (bpr_update): per user dP = lr (sum l (q_i - q_j) - reg_u neg_per
//    slots p_u), per item dQ = lr (sum +-l p_u - Q (reg_i neg_per positives
//    + reg_j negatives)), each clipped by its row L2 norm to max_step_norm
//    (0: no clip) and added; the item bias moves by its positive side
//    (clamped) and then by its negative side, whose reg term reads the bias
//    after the positive side's step; every other term reads the chunk's
//    snapshot of the tables; or
//  * the deferred path (bpr_accumulate): the same sums without lr and reg
//    added into the epoch's gradient tables, and with per-coordinate
//    normalization the counts (user and positive once per slot, the negative
//    once per sample); or
//  * the delta path (bpr_delta, a mesh shard's sgd chunk, bpr_epoch_dp
//    :804-846): the sgd step's rows unclipped, added into dense delta tables
//    dP, dQ and dQb (the bias's positive side), the tables untouched; a
//    second launch (bpr_delta_bias_neg) adds the negative side's bias step
//    from the same item groups once Qb has taken the reduced positive side;
//    the cap applies to the reduced deltas (K10's capped add);
// and (bpr_loss) the mean of log(1 + exp(-x)) over fixed triplets.
//
// Replaces buffalo_tpu/ops/sgd_kernels.py _bpr_forward (:336), clipped_logit
// (:272), clip_row_norm (:280), bpr_sgd_step (:390), bpr_accumulate_step
// (:355), the scan bodies of bpr_epoch (:544-651) and bpr_loss (:859).
//
// What bounds it on the card: gathering three rows per sample (p_u, q_i, q_j)
// and writing the touched rows; at d = 40 about 0.5 KB per sample, so a
// 524,288-slot chunk moves ~0.25 GB (~0.08 ms at 3.35 TB/s), the operations
// (~9 d per sample) are far below the FP32 rate.  Design: sums are
// deterministic, with no float atomics.  A stable LSD radix sort
// (row_group.cuh) groups the user entries (one
// per slot) and the item entries (one per slot for the positive, one per
// sample for the negative) by row; each row's entries are summed in entry
// order in runs of kRun, one warp per run, and one warp per row adds its runs
// in order, clips and writes.  Padding slots and sentinel negatives are keyed
// to a dropped row.  The logits are computed once (one warp per sample) and
// both sides' run sums finish before either epilogue writes, so every term
// reads the snapshot.  A lane holds 8 columns of a row (kChunk = 256); wider
// rows take the wide instantiation of the run and row kernels, which walks a
// row in 256-column chunks (the clipped step passes twice: its norm first).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "row_group.cuh"

namespace {

__device__ __forceinline__ float clipped_logit(float x) {
  return x > 6.f ? 0.f : (x < -6.f ? 1.f : 1.f / (1.f + expf(x)));
}

// One warp per sample k (slot j = k / neg_per): its masked logit.
__global__ void __launch_bounds__(kThreads)
forward_kernel(const int32_t* __restrict__ users, const int32_t* __restrict__ pos,
               const int32_t* __restrict__ neg, int64_t B, int neg_per, int n_valid,
               const float* __restrict__ P, const float* __restrict__ Q,
               const float* __restrict__ Qb, int I, int d, int use_bias,
               float* __restrict__ logit) {
  const int lane = threadIdx.x & 31;
  const int64_t k = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (k >= B) return;
  const int j = (int)(k / neg_per);
  const int nk = neg[k];
  const bool ok = nk >= 0 && nk < I;
  if (j >= n_valid || !ok) {
    if (lane == 0) logit[k] = 0.f;
    return;
  }
  const float* p = P + (int64_t)users[j] * d;
  const float* qi = Q + (int64_t)pos[j] * d;
  const float* qj = Q + (int64_t)nk * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc = fmaf(p[c], qi[c] - qj[c], acc);
  float x = warp_sum(acc);
  if (use_bias) x += Qb[pos[j]] - Qb[nk];
  if (lane == 0) logit[k] = clipped_logit(x);
}

// ----------------------------------------------------------- entries + sort
// User side: entry j = slot j, keyed by its user.  Item side: entry e < N the
// positive of slot e, entry N + k the negative of sample k.
__global__ void __launch_bounds__(kThreads)
make_keys(int item_side, const int32_t* __restrict__ users, const int32_t* __restrict__ pos,
          const int32_t* __restrict__ neg, int N, int neg_per, int n_valid, int R, int n,
          int32_t* __restrict__ key, int32_t* __restrict__ idx) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  int k;
  if (!item_side) {
    k = e < n_valid ? users[e] : R;
  } else if (e < N) {
    k = e < n_valid ? pos[e] : R;
  } else {
    const int s = e - N, v = neg[s];
    k = (s / neg_per < n_valid && v >= 0 && v < R) ? v : R;
  }
  key[e] = k;
  idx[e] = e;
}

// User runs: part[q] = sum over the run's slots j and their samples k of
// l_k (q_pos(j) - q_neg(k)).  Wide rows (kWide) are walked in column chunks.
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
user_runs(const int32_t* __restrict__ idx, int R, const int32_t* __restrict__ start,
          const int32_t* __restrict__ run_start, const int32_t* __restrict__ pos,
          const int32_t* __restrict__ neg, int neg_per, const float* __restrict__ logit,
          const float* __restrict__ Q, int I, int d, float* __restrict__ part) {
  const int lane = threadIdx.x & 31, q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  int r, m0, m1;
  if (!find_run(q, R, start, run_start, r, m0, m1)) return;
  for (int c0 = 0; c0 < chunk_end<kWide>(d); c0 += kChunk) {
    float acc[kMaxH];
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) acc[h] = 0.f;
    for (int m = m0; m < m1; ++m) {
      const int j = idx[m];
      const float* qi = Q + (int64_t)pos[j] * d;
      for (int n = 0; n < neg_per; ++n) {
        const int64_t k = (int64_t)j * neg_per + n;
        const float w = logit[k];
        const float* qj = Q + (int64_t)min(neg[k], I - 1) * d;
#pragma unroll
        for (int h = 0; h < kMaxH; ++h) {
          const int c = c0 + lane + 32 * h;
          if (c < d) acc[h] = fmaf(w, qi[c] - qj[c], acc[h]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) {
      const int c = c0 + lane + 32 * h;
      if (c < d) part[(int64_t)q * d + c] = acc[h];
    }
  }
}

// Item runs: part[q] = (sum of c_e p_u, then the positive logit sum, the
// negative logit sum, the positive and the negative entry counts); c_e is
// the slot's logit sum for a positive (0 without update_i) and minus the
// sample's logit for a negative (0 without update_j).
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
item_runs(const int32_t* __restrict__ idx, int R, const int32_t* __restrict__ start,
          const int32_t* __restrict__ run_start, const int32_t* __restrict__ users, int N,
          int neg_per, const float* __restrict__ logit, const float* __restrict__ P, int d,
          int upd_i, int upd_j, float* __restrict__ part) {
  const int lane = threadIdx.x & 31, q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  int r, m0, m1;
  if (!find_run(q, R, start, run_start, r, m0, m1)) return;
  float* out = part + (int64_t)q * (d + 4);
  float lpos = 0.f, lneg = 0.f, cpos = 0.f, cneg = 0.f;
  for (int c0 = 0; c0 < chunk_end<kWide>(d); c0 += kChunk) {
    float acc[kMaxH];
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) acc[h] = 0.f;
    lpos = lneg = cpos = cneg = 0.f;
    for (int m = m0; m < m1; ++m) {
      const int e = idx[m];
      int u;
      float coef;
      if (e < N) {
        u = users[e];
        float w = 0.f;
        for (int n = 0; n < neg_per; ++n) w += logit[(int64_t)e * neg_per + n];
        lpos += w;
        cpos += 1.f;
        coef = upd_i ? w : 0.f;
      } else {
        const int64_t k = e - N;
        u = users[k / neg_per];
        const float w = logit[k];
        lneg += w;
        cneg += 1.f;
        coef = upd_j ? -w : 0.f;
      }
      const float* p = P + (int64_t)u * d;
#pragma unroll
      for (int h = 0; h < kMaxH; ++h) {
        const int c = c0 + lane + 32 * h;
        if (c < d) acc[h] = fmaf(coef, p[c], acc[h]);
      }
    }
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) {
      const int c = c0 + lane + 32 * h;
      if (c < d) out[c] = acc[h];
    }
  }
  if (lane == 0) {
    out[d] = lpos;
    out[d + 1] = lneg;
    out[d + 2] = cpos;
    out[d + 3] = cneg;
  }
}

// Scale of a row step clipped to L2 norm cap (cap 0: 1), from each lane's
// partial sum of squares.
__device__ __forceinline__ float clip_scale(float ss, float cap) {
  if (cap <= 0.f) return 1.f;
  ss = warp_sum(ss);
  return fminf(1.f, cap / fmaxf(sqrtf(ss), 1e-12f));
}

// The modes of the row kernels
enum RowMode { kStep = 0, kAccumulate = 1, kDelta = 2 };

// One warp per row of a table T with its runs' sums acc and the reg factor
// rc = rc_of(the row's scalars): the sgd step T += clip(lr (acc - rc T))
// (kStep), the accumulation out += acc (kAccumulate), or the unclipped step
// added to a delta table out (kDelta).  Wide rows take the chunks twice when
// clipping: the step's norm first.
template <bool kWide, class RcOf>
__device__ __forceinline__ void row_update(int mode, int r, const int32_t* __restrict__ run_start,
                                           const float* __restrict__ part, int d, int W, int lane,
                                           float lr, RcOf rc_of, float cap, float* __restrict__ T,
                                           float* __restrict__ out, float (&sc)[4]) {
  float* t = T ? T + (int64_t)r * d : nullptr;
  float* o = out ? out + (int64_t)r * d : nullptr;
  float acc[kMaxH];
  float s = 1.f;
  if (kWide && mode == kStep && cap > 0.f) {
    float ss = 0.f;
    for (int c0 = 0; c0 < d; c0 += kChunk) {
      row_sum(r, run_start, part, d, W, lane, acc, sc, c0);
      const float rc = rc_of(sc);
#pragma unroll
      for (int h = 0; h < kMaxH; ++h) {
        const int c = c0 + lane + 32 * h;
        const float dl = c < d ? lr * (acc[h] - rc * t[c]) : 0.f;
        ss = fmaf(dl, dl, ss);
      }
    }
    s = clip_scale(ss, cap);
  }
  for (int c0 = 0; c0 < chunk_end<kWide>(d); c0 += kChunk) {
    row_sum(r, run_start, part, d, W, lane, acc, sc, c0);
    if (mode == kAccumulate) {
#pragma unroll
      for (int h = 0; h < kMaxH; ++h) {
        const int c = c0 + lane + 32 * h;
        if (c < d) o[c] += acc[h];
      }
      continue;
    }
    const float rc = rc_of(sc);
    float dl[kMaxH];
    float ss = 0.f;
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) {
      const int c = c0 + lane + 32 * h;
      dl[h] = c < d ? lr * (acc[h] - rc * t[c]) : 0.f;
      ss = fmaf(dl[h], dl[h], ss);
    }
    if (mode == kDelta) {
#pragma unroll
      for (int h = 0; h < kMaxH; ++h) {
        const int c = c0 + lane + 32 * h;
        if (c < d) o[c] += dl[h];
      }
      continue;
    }
    if (!kWide) s = clip_scale(ss, cap);
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) {
      const int c = c0 + lane + 32 * h;
      if (c < d) t[c] += dl[h] * s;
    }
  }
}

// One warp per user row: the sgd step of P (kStep), the accumulation into gP
// (kAccumulate) or the step added into dP (kDelta).
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
user_rows(int mode, int R, const int32_t* __restrict__ start,
          const int32_t* __restrict__ run_start, const float* __restrict__ part, int d,
          int neg_per, float lr, float reg_u, float cap, float* __restrict__ P,
          float* __restrict__ gP, float* __restrict__ cP) {
  const int lane = threadIdx.x & 31, r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;
  const int n = start[r + 1] - start[r];
  if (n == 0) return;
  float sc[4];
  const float rc = reg_u * (float)(n * neg_per);
  row_update<kWide>(mode, r, run_start, part, d, d, lane, lr,
                    [rc](const float(&)[4]) { return rc; }, cap, P, gP, sc);
  if (mode == kAccumulate && cP && lane == 0) cP[r] += (float)n;
}

// One warp per item row: the sgd step of Q and Qb (kStep), the accumulation
// (kAccumulate), or the steps of Q and of Qb's positive side added into dQ
// and dQb (kDelta; the negative side follows in bias_neg_rows, after the
// positive side's delta has been applied).
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
item_rows(int mode, int R, const int32_t* __restrict__ start,
          const int32_t* __restrict__ run_start, const float* __restrict__ part, int d,
          int neg_per, float lr, float reg_i, float reg_j, float reg_b, float cap, int use_bias,
          int upd_i, int upd_j, float* __restrict__ Q, float* __restrict__ Qb,
          float* __restrict__ gQ, float* __restrict__ gQb, float* __restrict__ cQ) {
  const int lane = threadIdx.x & 31, r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;
  if (start[r + 1] == start[r]) return;
  float sc[4];
  // the reg factor from the counts, the scalars past the row's sums
  const float ri = upd_i ? reg_i * (float)neg_per : 0.f, rj = upd_j ? reg_j : 0.f;
  row_update<kWide>(mode, r, run_start, part, d, d + 4, lane, lr,
                    [=](const float(&x)[4]) {
                      return (upd_i ? ri * x[2] : 0.f) + (upd_j ? rj * x[3] : 0.f);
                    },
                    cap, Q, gQ, sc);
  const float lpos = sc[0], lneg = sc[1], cpos = sc[2], cneg = sc[3];
  if (lane != 0) return;
  if (mode == kAccumulate) {
    if (use_bias) gQb[r] += (upd_i ? lpos : 0.f) - (upd_j ? lneg : 0.f);
    if (cQ) cQ[r] += cpos + cneg;
    return;
  }
  if (!use_bias) return;
  if (mode == kDelta) {
    if (upd_i) gQb[r] += lr * (lpos - reg_b * (float)neg_per * cpos * Qb[r]);
    return;
  }
  float b = Qb[r];
  if (upd_i) {
    float db = lr * (lpos - reg_b * (float)neg_per * cpos * b);
    if (cap > 0.f) db = fminf(fmaxf(db, -cap), cap);
    b += db;
  }
  if (upd_j) {
    float db = lr * (-lneg - reg_b * cneg * b);
    if (cap > 0.f) db = fminf(fmaxf(db, -cap), cap);
    b += db;
  }
  Qb[r] = b;
}

// One thread per item row: the negative side's bias step, -lr (sum of the
// row's negative logits + reg_b count Qb), added into dQb; Qb is read after
// the positive side's delta has been applied (the delta path's second
// launch).
__global__ void __launch_bounds__(kThreads)
bias_neg_rows(int R, const int32_t* __restrict__ start, const int32_t* __restrict__ run_start,
              const float* __restrict__ part, int d, float lr, float reg_b,
              const float* __restrict__ Qb, float* __restrict__ dQb) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R || start[r + 1] == start[r]) return;
  float lneg = 0.f, cneg = 0.f;
  for (int q = run_start[r]; q < run_start[r + 1]; ++q) {
    lneg += part[(int64_t)q * (d + 4) + d + 1];
    cneg += part[(int64_t)q * (d + 4) + d + 3];
  }
  if (cneg > 0.f) dQb[r] += lr * (-lneg - reg_b * cneg * Qb[r]);
}

// Mean log(1 + exp(-x)) over n triplets: one block, warp w takes triplets w,
// w + 8, ... in order, the warps' sums added in order.
__global__ void __launch_bounds__(kThreads)
loss_kernel(const int32_t* __restrict__ users, const int32_t* __restrict__ pos,
            const int32_t* __restrict__ neg, int n, const float* __restrict__ P,
            const float* __restrict__ Q, const float* __restrict__ Qb, int d, int use_bias,
            float* __restrict__ out) {
  __shared__ float red[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float sum = 0.f;
  for (int t = warp; t < n; t += kWarps) {
    const float* p = P + (int64_t)users[t] * d;
    const float* qi = Q + (int64_t)pos[t] * d;
    const float* qj = Q + (int64_t)neg[t] * d;
    float acc = 0.f;
    for (int c = lane; c < d; c += 32) acc = fmaf(p[c], qi[c] - qj[c], acc);
    float x = warp_sum(acc);
    if (use_bias) x += Qb[pos[t]] - Qb[neg[t]];
    sum += fmaxf(-x, 0.f) + log1pf(expf(-fabsf(x)));
  }
  if (lane == 0) red[warp] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w];
    *out = n > 0 ? s / (float)n : 0.f;
  }
}

// ------------------------------------------------------------- host side
// Carves the workspace: fills the sides and the logits when ibase/fbase are
// given, returns the int32 and float32 words needed.
void layout(int N, int neg_per, int U, int I, int d, int32_t* ibase, float* fbase, Side& su,
            Side& si, float** logit, int64_t* isz, int64_t* fsz) {
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
  const int64_t B = (int64_t)N * neg_per;
  *logit = floats(B);
  carve_side(su, N, U, d, ints, floats);
  carve_side(si, (int)(N + B), I, d + 4, ints, floats);
  *isz = io;
  *fsz = fo;
}

// Keys, the stable sort by row, the row counts and starts of one side.
cudaError_t group_side(Side& x, int item_side, const int32_t* users, const int32_t* pos,
                       const int32_t* neg, int N, int neg_per, int n_valid, cudaStream_t st) {
  x.sorted = 0;
  if (x.n == 0) return cudaSuccess;
  make_keys<<<(x.n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      item_side, users, pos, neg, N, neg_per, n_valid, x.R, x.n, x.key[0], x.idx[0]);
  CHECK_LAUNCH();
  return sort_side(x, false, st);
}

// The shared front of every mode: logits, both sides grouped and summed in
// runs (all reads of the snapshot happen here).
template <bool kWide>
cudaError_t front(const int32_t* users, const int32_t* pos, const int32_t* neg, const float* P,
                  const float* Q, const float* Qb, int N, int neg_per, int n_valid, int U, int I,
                  int d, int use_bias, int upd_i, int upd_j, int32_t* ws_i, float* ws_f,
                  Side& su, Side& si, cudaStream_t st) {
  float* logit;
  int64_t isz, fsz;
  layout(N, neg_per, U, I, d, ws_i, ws_f, su, si, &logit, &isz, &fsz);
  const int64_t B = (int64_t)N * neg_per;
  forward_kernel<<<warps_grid(B), kThreads, 0, st>>>(users, pos, neg, B, neg_per, n_valid, P, Q,
                                                     Qb, I, d, use_bias, logit);
  CHECK_LAUNCH();
  cudaError_t err = group_side(su, 0, users, pos, neg, N, neg_per, n_valid, st);
  if (err != cudaSuccess) return err;
  err = group_side(si, 1, users, pos, neg, N, neg_per, n_valid, st);
  if (err != cudaSuccess) return err;
  user_runs<kWide><<<warps_grid(su.max_runs), kThreads, 0, st>>>(
      su.idx[su.sorted], su.R, su.start, su.run_start, pos, neg, neg_per, logit, Q, I, d,
      su.part);
  CHECK_LAUNCH();
  item_runs<kWide><<<warps_grid(si.max_runs), kThreads, 0, st>>>(
      si.idx[si.sorted], si.R, si.start, si.run_start, users, N, neg_per, logit, P, d, upd_i,
      upd_j, si.part);
  CHECK_LAUNCH();
  return cudaSuccess;
}

// The front, then both sides' row kernels in mode `mode`: the tables' sgd
// step, the accumulation into (gP, gQ, gQb, cP, cQ) or the deltas into (gP,
// gQ, gQb) = (dP, dQ, dQb).
template <bool kWide>
int run(int mode, const int32_t* users, const int32_t* pos, const int32_t* neg, float* P,
        float* Q, float* Qb, int N, int neg_per, int n_valid, int U, int I, int d, float lr,
        float reg_u, float reg_i, float reg_j, float reg_b, float cap, int use_bias, int upd_i,
        int upd_j, float* gP, float* gQ, float* gQb, float* cP, float* cQ, int32_t* ws_i,
        float* ws_f, cudaStream_t st) {
  Side su, si;
  cudaError_t err = front<kWide>(users, pos, neg, P, Q, Qb, N, neg_per, n_valid, U, I, d,
                                 use_bias, upd_i, upd_j, ws_i, ws_f, su, si, st);
  if (err != cudaSuccess) return (int)err;
  user_rows<kWide><<<warps_grid(U), kThreads, 0, st>>>(mode, U, su.start, su.run_start, su.part,
                                                       d, neg_per, lr, reg_u, cap, P, gP, cP);
  CHECK_LAUNCH();
  item_rows<kWide><<<warps_grid(I), kThreads, 0, st>>>(mode, I, si.start, si.run_start, si.part,
                                                       d, neg_per, lr, reg_i, reg_j, reg_b, cap,
                                                       use_bias, upd_i, upd_j, Q, Qb, gQ, gQb,
                                                       cQ);
  return (int)cudaGetLastError();
}

// The row kernels hold a row in registers up to kChunk columns (narrow);
// wider rows take the wide instantiation, which walks them in chunks.
bool wide(int d) { return d > kChunk; }

bool bad_args(int N, int neg_per, int U, int I, int d) {
  return N < 1 || neg_per < 1 || U < 1 || I < 1 || d < 1 ||
         (int64_t)N * (neg_per + 1) >= (1LL << 31);
}

}  // namespace

// sizes[0]: int32 words, sizes[1]: float32 words of the workspace.
extern "C" int bpr_workspace(int N, int neg_per, int U, int I, int d, int64_t* sizes) {
  Side su, si;
  float* logit;
  layout(N, neg_per, U, I, d, nullptr, nullptr, su, si, &logit, &sizes[0], &sizes[1]);
  return 0;
}

// 1 when rows of d floats take the wide instantiation of the row kernels.
extern "C" int bpr_wide(int d) { return wide(d) ? 1 : 0; }

#define BPR_RUN(...) (wide(d) ? run<true>(__VA_ARGS__) : run<false>(__VA_ARGS__))

extern "C" int bpr_update(const int32_t* users, const int32_t* pos, const int32_t* neg, float* P,
                          float* Q, float* Qb, int N, int neg_per, int n_valid, int U, int I,
                          int d, float lr, float reg_u, float reg_i, float reg_j, float reg_b,
                          float cap, int use_bias, int upd_i, int upd_j, int32_t* ws_i,
                          float* ws_f, void* stream) {
  if (N == 0) return 0;
  if (bad_args(N, neg_per, U, I, d)) return (int)cudaErrorInvalidValue;
  return BPR_RUN(kStep, users, pos, neg, P, Q, Qb, N, neg_per, n_valid, U, I, d, lr, reg_u, reg_i,
                 reg_j, reg_b, cap, use_bias, upd_i, upd_j, nullptr, nullptr, nullptr, nullptr,
                 nullptr, ws_i, ws_f, (cudaStream_t)stream);
}

extern "C" int bpr_accumulate(const int32_t* users, const int32_t* pos, const int32_t* neg,
                              const float* P, const float* Q, const float* Qb, int N, int neg_per,
                              int n_valid, int U, int I, int d, float* gP, float* gQ, float* gQb,
                              float* cP, float* cQ, int use_bias, int upd_i, int upd_j, int pcn,
                              int32_t* ws_i, float* ws_f, void* stream) {
  if (N == 0) return 0;
  if (bad_args(N, neg_per, U, I, d)) return (int)cudaErrorInvalidValue;
  return BPR_RUN(kAccumulate, users, pos, neg, const_cast<float*>(P), const_cast<float*>(Q),
                 const_cast<float*>(Qb), N, neg_per, n_valid, U, I, d, 0.f, 0.f, 0.f, 0.f, 0.f,
                 0.f, use_bias, upd_i, upd_j, gP, gQ, gQb, pcn ? cP : nullptr, pcn ? cQ : nullptr,
                 ws_i, ws_f, (cudaStream_t)stream);
}

// The delta path (a mesh shard's sgd chunk): the sgd step's unclipped row
// sums added into dP, dQ and (with the bias and update_i) the positive
// side's bias step into dQb; the tables are read, not written.  The
// workspace keeps the item side's groups for bpr_delta_bias_neg.
extern "C" int bpr_delta(const int32_t* users, const int32_t* pos, const int32_t* neg,
                         const float* P, const float* Q, const float* Qb, int N, int neg_per,
                         int n_valid, int U, int I, int d, float lr, float reg_u, float reg_i,
                         float reg_j, float reg_b, int use_bias, int upd_i, int upd_j, float* dP,
                         float* dQ, float* dQb, int32_t* ws_i, float* ws_f, void* stream) {
  if (N == 0) return 0;
  if (bad_args(N, neg_per, U, I, d)) return (int)cudaErrorInvalidValue;
  return BPR_RUN(kDelta, users, pos, neg, const_cast<float*>(P), const_cast<float*>(Q),
                 const_cast<float*>(Qb), N, neg_per, n_valid, U, I, d, lr, reg_u, reg_i, reg_j,
                 reg_b, 0.f, use_bias, upd_i, upd_j, dP, dQ, dQb, nullptr, nullptr, ws_i, ws_f,
                 (cudaStream_t)stream);
}

// The delta path's second launch: the negative side's bias step, from the
// same chunk's item groups (the workspace of its bpr_delta call) and Qb as
// it stands after the positive side's delta, added into dQb.
extern "C" int bpr_delta_bias_neg(int N, int neg_per, int U, int I, int d, float lr, float reg_b,
                                  const float* Qb, float* dQb, int32_t* ws_i, float* ws_f,
                                  void* stream) {
  if (N == 0) return 0;
  if (bad_args(N, neg_per, U, I, d)) return (int)cudaErrorInvalidValue;
  Side su, si;
  float* logit;
  int64_t isz, fsz;
  layout(N, neg_per, U, I, d, ws_i, ws_f, su, si, &logit, &isz, &fsz);
  bias_neg_rows<<<(I + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      I, si.start, si.run_start, si.part, d, lr, reg_b, Qb, dQb);
  return (int)cudaGetLastError();
}

extern "C" int bpr_loss(const int32_t* users, const int32_t* pos, const int32_t* neg,
                        const float* P, const float* Q, const float* Qb, int n, int d,
                        int use_bias, float* out, void* stream) {
  if (n < 0 || d < 1) return (int)cudaErrorInvalidValue;
  loss_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(users, pos, neg, n, P, Q, Qb, d,
                                                        use_bias, out);
  return (int)cudaGetLastError();
}
