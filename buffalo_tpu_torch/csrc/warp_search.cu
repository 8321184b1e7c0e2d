// K11: WARP's violator search for one chunk of positives (slot j: user
// users[j], positive pos[j]; slots from n_valid on are padding).  Candidate j
// of a slot is cands[slot * K + j] when a candidate tensor is given, else
// mulhi(x0, num_items) of the Philox4x32-10 words of the counter (slot, chunk,
// epoch, j) under the seed's key, so K = 16, 32 and 64 share their first
// draws.  Scores are p.q (dot) or -|p - q|^2 (l2), each summed in double and
// rounded once to float, so they do not depend on the order of the sum; a
// candidate violates when ui - uj < threshold.  The rule of the JAX package:
//  * lazy: the bloom filter is probed at the first min(4, K) violators only;
//    the chosen negative is the first of them it does not flag, with
//    trial = 2 (f + 1 - the flagged violators before it), f its column;
//  * all: every candidate is probed (or its bit read from seen_bits); the
//    first unflagged violator, trial = 2 (unflagged candidates up to it);
//  with no choice, f = the first violator (lazy, else 0) or 0 (all), and
//  trial = 2 (f + 1) (lazy) or max(2 (candidate 0 unflagged), 1) (all).
// Outputs per slot: the candidate at f, any_v, trial, and the weight
// w = any_v && valid ? log(max(1, (max(I - |seen_u| - 1, 0)) / trial)) : 0
// (integer division before the log); counts[count_index] gains the number of
// valid slots with any_v.  warp_probe writes every candidate's seen bit,
// packed 32 to a word (the split epoch's first pass); warp_violations is the
// violation rate over fixed triplets.  On a mesh shard the Philox counter
// takes the slot's global index, slot + slot_offset (the shard's first slot
// of the chunk), so a shard's candidates equal the single device's rows
// (warp_epoch_dp :398-401).
//
// Replaces buffalo_tpu/ops/warp_kernels.py _scores (:30),
// _select_violator_lazy (:41), the search of warp_accumulate_step (:110-146)
// and of warp_epoch's scan body (:259-296), warp_probe_epoch (:175),
// _unpack_seen_bits (:212) and warp_loss (:505).
//
// What bounds it on the card: the candidate rows of Q gathered (d floats
// each; Q is 6.8 MB at ML-20M, d = 64, so the gathers hit L2) and one bloom
// word per probe; the selection depends only on the candidates up to the
// chosen violator.  Design: one warp per slot walks its candidates 32 at a
// time, a lane per candidate reading its whole row with 16-byte loads
// against the slot's user row in shared memory, and stops at the first group
// that settles the choice; ballots give the ranks and counts.  Rows wider
// than the shared row (kMaxD) take the wide instantiation, which reads the
// user row from global memory (L1) in the same order.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sampling.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kMaxD = 256;
constexpr int kProbes = 4;

// p (shared) against row q, summed in double and rounded once; vec: q is
// 16-byte aligned and d % 4 == 0.
__device__ __forceinline__ float row_score(const float* p, const float* __restrict__ q, int d,
                                           int l2, bool vec) {
  double acc = 0.0;
  if (vec) {
    const float4* q4 = reinterpret_cast<const float4*>(q);
    for (int c = 0; c < d; c += 4) {
      const float4 v = __ldg(q4 + c / 4);
      const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (l2) {
          const float df = p[c + t] - x[t];
          acc = fma((double)df, (double)df, acc);
        } else {
          acc = fma((double)p[c + t], (double)x[t], acc);
        }
      }
    }
  } else {
    for (int c = 0; c < d; ++c) {
      const float x = __ldg(q + c);
      if (l2) {
        const float df = p[c] - x;
        acc = fma((double)df, (double)df, acc);
      } else {
        acc = fma((double)p[c], (double)x, acc);
      }
    }
  }
  return l2 ? (float)(-acc) : (float)acc;
}

struct Draw {
  const int32_t* cands;  // (N, K) or null: Philox
  int K, num_items;
  uint32_t k0, k1, epoch, chunk;
  int64_t offset;  // the chunk's global index of slot 0
  __device__ __forceinline__ uint32_t operator()(int slot, int j) const {
    if (cands) return (uint32_t)cands[(int64_t)slot * K + j];
    const U4 x = philox(U4{(uint32_t)(slot + offset), chunk, epoch, (uint32_t)j}, k0, k1);
    return __umulhi(x.x0, (uint32_t)num_items);
  }
};

template <bool kWide>
__global__ void __launch_bounds__(kThreads)
search_kernel(const int32_t* __restrict__ users, const int32_t* __restrict__ pos, int N,
              int n_valid, Draw draw, const float* __restrict__ P, const float* __restrict__ Q,
              int d, int l2, bool vec, float threshold, int lazy,
              const uint32_t* __restrict__ seen_bits, const uint32_t* __restrict__ bloom,
              uint32_t wmask, const int64_t* __restrict__ indptr, int32_t* __restrict__ out_neg,
              float* __restrict__ out_w, uint8_t* __restrict__ out_anyv,
              int32_t* __restrict__ out_trial, int32_t* __restrict__ counts) {
  __shared__ float ps[kWarps][kWide ? 1 : kMaxD];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = blockIdx.x * kWarps + warp;
  const int K = draw.K, nw = (K + 31) / 32;
  bool found = false;
  if (slot < N) {
    const int u = users[slot];
    const float* p = P + (int64_t)u * d;
    if (!kWide) {
      float* pw = ps[warp];
      for (int c = lane; c < d; c += 32) pw[c] = p[c];
      __syncwarp();
      p = pw;
    }
    const float ui = row_score(p, Q + (int64_t)pos[slot] * d, d, l2, vec);
    const int J = K < kProbes ? K : kProbes;
    int f = 0, trial = 1;
    uint32_t neg = 0, cand0 = 0, first_cand = 0;
    int first_viol = -1, nviol = 0, unseen = 0;
    bool seen0 = false;
    for (int j0 = 0; j0 < K; j0 += 32) {
      const int j = j0 + lane;
      const bool in = j < K;
      const uint32_t cand = in ? draw(slot, j) : 0u;
      const bool viol = in && ui - row_score(p, Q + (int64_t)cand * d, d, l2, vec) < threshold;
      if (j0 == 0) cand0 = __shfl_sync(kFull, cand, 0);
      const unsigned below = (1u << lane) - 1u;
      bool seen = false;
      if (lazy) {
        const unsigned vm = __ballot_sync(kFull, viol);
        const int rank = nviol + __popc(vm & below) + 1;
        const bool probe = viol && rank <= J;
        if (probe) seen = seen_bits ? (seen_bits[(int64_t)slot * nw + (j >> 5)] >> (j & 31)) & 1u
                                    : bloom_contains(bloom, wmask, (uint32_t)u, cand);
        if (first_viol < 0 && vm) {
          const int fl = __ffs(vm) - 1;
          first_viol = j0 + fl;
          first_cand = __shfl_sync(kFull, cand, fl);
        }
        const unsigned ok = __ballot_sync(kFull, probe && !seen);
        if (ok) {
          const int fl = __ffs(ok) - 1;
          f = j0 + fl;
          // the probed violators before it were all flagged
          trial = 2 * (f + 1 - (nviol + __popc(vm & ((1u << fl) - 1u))));
          neg = __shfl_sync(kFull, cand, fl);
          found = true;
          break;
        }
        nviol += __popc(vm);
        if (nviol >= J) break;
      } else {
        if (in) seen = seen_bits ? (seen_bits[(int64_t)slot * nw + (j >> 5)] >> (j & 31)) & 1u
                                 : bloom_contains(bloom, wmask, (uint32_t)u, cand);
        const unsigned ns = __ballot_sync(kFull, in && !seen);
        if (j0 == 0) seen0 = !(ns & 1u);
        const unsigned ok = __ballot_sync(kFull, in && !seen && viol);
        if (ok) {
          const int fl = __ffs(ok) - 1;
          f = j0 + fl;
          const unsigned upto = fl == 31 ? kFull : (2u << fl) - 1u;
          trial = 2 * (unseen + __popc(ns & upto));
          neg = __shfl_sync(kFull, cand, fl);
          found = true;
          break;
        }
        unseen += __popc(ns);
      }
    }
    if (!found) {
      if (lazy && first_viol >= 0) {
        f = first_viol;
        neg = first_cand;
      } else {
        f = 0;
        neg = cand0;
      }
      trial = lazy ? 2 * (f + 1) : (seen0 ? 1 : 2);
    }
    if (lane == 0) {
      const int seen_u = (int)(indptr[u + 1] - indptr[u]);
      const int avail = max(draw.num_items - seen_u - 1, 0);
      const float phi = logf((float)max(1, avail / trial));
      const bool valid = slot < n_valid;
      out_neg[slot] = (int32_t)neg;
      out_anyv[slot] = found ? 1 : 0;
      out_trial[slot] = trial;
      out_w[slot] = found && valid ? phi : 0.f;
      found = found && valid;
    }
  }
  const int n = __syncthreads_count(lane == 0 && found);
  if (threadIdx.x == 0 && n) atomicAdd(counts, n);
}

__global__ void __launch_bounds__(kThreads)
probe_kernel(const int32_t* __restrict__ users, int N, Draw draw,
             const uint32_t* __restrict__ bloom, uint32_t wmask, uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int slot = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (slot >= N) return;
  const uint32_t u = (uint32_t)users[slot];
  const int nw = (draw.K + 31) / 32;
  for (int g = 0; g < nw; ++g) {
    const int j = 32 * g + lane;
    const bool seen = j < draw.K && bloom_contains(bloom, wmask, u, draw(slot, j));
    const unsigned bits = __ballot_sync(kFull, seen);
    if (lane == 0) out[(int64_t)slot * nw + g] = bits;
  }
}

// One block: warp w scores triplets w, w + kWarps, ... (each lane summing a
// strided part of the row in double), the violations counted exactly.
__global__ void __launch_bounds__(kThreads)
violations_kernel(const int32_t* __restrict__ users, const int32_t* __restrict__ pos,
                  const int32_t* __restrict__ neg, int n, const float* __restrict__ P,
                  const float* __restrict__ Q, int d, int l2, float threshold,
                  float* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int count = 0;
  for (int t = warp; t < n; t += kWarps) {
    const float* p = P + (int64_t)users[t] * d;
    const float* qi = Q + (int64_t)pos[t] * d;
    const float* qj = Q + (int64_t)neg[t] * d;
    double si = 0.0, sj = 0.0;
    for (int c = lane; c < d; c += 32) {
      if (l2) {
        const float a = p[c] - qi[c], b = p[c] - qj[c];
        si = fma((double)a, (double)a, si);
        sj = fma((double)b, (double)b, sj);
      } else {
        si = fma((double)p[c], (double)qi[c], si);
        sj = fma((double)p[c], (double)qj[c], sj);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      si += __shfl_xor_sync(kFull, si, o);
      sj += __shfl_xor_sync(kFull, sj, o);
    }
    const float ui = l2 ? (float)(-si) : (float)si, uj = l2 ? (float)(-sj) : (float)sj;
    count += lane == 0 && ui - uj < threshold;
  }
  __shared__ int red[kWarps];
  if (lane == 0) red[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += red[w];
    *out = n > 0 ? (float)s / (float)n : 0.f;
  }
}

Draw make_draw(const int32_t* cands, int K, int num_items, int64_t key, int epoch, int chunk,
               int64_t offset) {
  const uint64_t kk = (uint64_t)key;
  return Draw{cands, K, num_items, (uint32_t)kk, (uint32_t)(kk >> 32), (uint32_t)epoch,
              (uint32_t)chunk, offset};
}

uint32_t word_mask(int bloom_log2) { return (1u << (bloom_log2 - 5)) - 1u; }

}  // namespace

// 1 when rows of d floats take the search's wide instantiation.
extern "C" int warp_search_wide(int d) { return d > kMaxD ? 1 : 0; }

// cands (N x K) may be null (Philox draws under key = (k1 << 32) | k0);
// seen_bits (N x ceil(K / 32) words) may be null (the bloom filter, 2^(log2 -
// 5) words, is probed); counts points at the chunk's found count.
extern "C" int warp_search(const int32_t* users, const int32_t* pos, int N, int n_valid, int K,
                           int num_items, const float* P, const float* Q, int d, int l2,
                           float threshold, int lazy, const int32_t* cands,
                           const uint32_t* seen_bits, const uint32_t* bloom, int bloom_log2,
                           int64_t key, int epoch, int chunk, int64_t slot_offset,
                           const int64_t* indptr, int32_t* out_neg, float* out_w,
                           uint8_t* out_anyv, int32_t* out_trial, int32_t* counts,
                           void* stream) {
  if (N < 0 || K < 1 || num_items < 1 || d < 1 || slot_offset < 0 ||
      (!seen_bits && (!bloom || bloom_log2 < 5 || bloom_log2 > 32)))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const bool vec = (d % 4 == 0) && ((uintptr_t)Q % 16 == 0);
  const Draw draw = make_draw(cands, K, num_items, key, epoch, chunk, slot_offset);
  const unsigned grid = (N + kWarps - 1) / kWarps;
  const uint32_t wm = seen_bits ? 0u : word_mask(bloom_log2);
  if (warp_search_wide(d))
    search_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        users, pos, N, n_valid, draw, P, Q, d, l2, vec, threshold, lazy, seen_bits, bloom, wm,
        indptr, out_neg, out_w, out_anyv, out_trial, counts);
  else
    search_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        users, pos, N, n_valid, draw, P, Q, d, l2, vec, threshold, lazy, seen_bits, bloom, wm,
        indptr, out_neg, out_w, out_anyv, out_trial, counts);
  return (int)cudaGetLastError();
}

extern "C" int warp_probe(const int32_t* users, int N, int K, int num_items,
                          const int32_t* cands, const uint32_t* bloom, int bloom_log2, int64_t key,
                          int epoch, int chunk, uint32_t* out_bits, void* stream) {
  if (N < 0 || K < 1 || num_items < 1 || !bloom || bloom_log2 < 5 || bloom_log2 > 32)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  probe_kernel<<<(N + kWarps - 1) / kWarps, kThreads, 0, (cudaStream_t)stream>>>(
      users, N, make_draw(cands, K, num_items, key, epoch, chunk, 0), bloom, word_mask(bloom_log2),
      out_bits);
  return (int)cudaGetLastError();
}

extern "C" int warp_violations(const int32_t* users, const int32_t* pos, const int32_t* neg, int n,
                               const float* P, const float* Q, int d, int l2, float threshold,
                               float* out, void* stream) {
  if (n < 0 || d < 1) return (int)cudaErrorInvalidValue;
  violations_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(users, pos, neg, n, P, Q, d, l2,
                                                               threshold, out);
  return (int)cudaGetLastError();
}
