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
// What bounds it on the card: the candidate rows the choices need (d
// floats each; Q is 6.8 MB at ML-20M, d = 64, so the gathers hit L2) and
// their float64 sums (H100 converts 16 values to or from 64-bit types per
// clock and SM, against 64 DFMA).  Design: a block stages each slot's user
// row once in shared memory (as double for dot, the exact conversion done
// once; as float for l2, whose difference is taken in float before its
// one conversion) beside its positive's row, all in one round trip, and
// one thread per slot sums ui once from them, in the same order.  A group
// of `lanes` lanes per slot (K rounded up to a power of two, at most
// kMaxLanes = 16: search_lanes; 32 / lanes slots to a warp) walks the
// candidates `lanes` at a time, a lane per candidate, and stops at the
// first group that settles the choice; ballots masked to the group give
// the ranks and counts.  The group reads its candidates' rows together,
// 32 floats of each at a time, into the warp's tile in shared memory (a
// warp load touches a few rows' lines, not one line per lane), and each
// lane sums its own row from there: a candidate's score is one conversion
// and one DFMA per element.  Rows wider than kMaxD take the wide
// instantiation, which reads the user row and each candidate's row from
// global memory (L1) as float, in the same order; so do rows whose width
// is no multiple of 4.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sampling.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kMaxD = 256;
constexpr int kProbes = 4;
// a slot's lanes are its candidates up to this (a power of two up to 32):
// groups of 16 read fewer rows the choice does not need than groups of 32
// and were the fastest at K = 16 and 64 on the card (PERF.md §6)
constexpr int kMaxLanes = 16;
constexpr size_t kMaxSmem = 227 * 1024;

// p against row q, each product summed in double in ascending c and the sum
// rounded once to float: dot sums p q, l2 the squares of the float
// differences (the score is minus that); p is the row staged as double
// (dot) or as float; vec: q is in global memory, 16-byte aligned, and d % 4
// == 0 (else q may also be a staged row).
template <class PT>
__device__ __forceinline__ float row_score(const PT* p, const float* __restrict__ q, int d,
                                           int l2, bool vec) {
  double acc = 0.0;
  if (vec) {
    const float4* q4 = reinterpret_cast<const float4*>(q);
#pragma unroll 4
    for (int c = 0; c < d; c += 4) {
      const float4 v = __ldg(q4 + c / 4);
      const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (l2) {
          const float df = (float)p[c + t] - x[t];
          acc = fma((double)df, (double)df, acc);
        } else {
          acc = fma((double)p[c + t], (double)x[t], acc);
        }
      }
    }
  } else {
    for (int c = 0; c < d; ++c) {
      const float x = q[c];
      if (l2) {
        const float df = (float)p[c] - x;
        acc = fma((double)df, (double)df, acc);
      } else {
        acc = fma((double)p[c], (double)x, acc);
      }
    }
  }
  return l2 ? (float)(-acc) : (float)acc;
}

// Candidate scores through the warp's tile (vec rows up to kMaxD): the
// group's rows are read kDC floats at a time by all of its lanes, so that a
// warp load touches a few rows' lines and not one line per lane, staged in
// the warp's tile (a row per lane, kRowLd floats: a quarter warp's float4
// reads fall in distinct banks), and each lane sums its own row from there,
// in ascending c, as row_score does.
constexpr int kDC = 32, kRowLd = kDC + 4, kBatch = 4;  // kBatch loads in flight a lane

template <class PT>
__device__ __forceinline__ float tiled_score(const PT* p, const float* __restrict__ Q,
                                             uint32_t cand, bool in, int d, int l2, int G,
                                             int gl, int gbase, float* tile, int lane) {
  double acc = 0.0;
  for (int c0 = 0; c0 < d; c0 += kDC) {
    const int n4 = min(kDC, d - c0) >> 2;  // float4s of each row in this chunk
#pragma unroll
    for (int m0 = 0; m0 < kDC / 4; m0 += kBatch) {
      float4 v[kBatch];
      int to[kBatch];
      bool ok[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        // lane gl reads float4 e = gl + G m of the group's rows: (e / n4, e % n4)
        const int m = m0 + b, e = gl + G * m;
        const int r = n4 == kDC / 4 ? e >> 3 : e / n4, col = e - r * n4;
        const int src = gbase + (r & (G - 1));
        const uint32_t cr = __shfl_sync(kFull, cand, src);
        const bool rin = __shfl_sync(kFull, (int)in, src) != 0;
        ok[b] = m < n4 && rin;
        to[b] = src * kRowLd + 4 * col;
        if (ok[b]) v[b] = __ldg(reinterpret_cast<const float4*>(Q + (int64_t)cr * d + c0) + col);
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (ok[b]) *reinterpret_cast<float4*>(tile + to[b]) = v[b];
    }
    __syncwarp();
    if (in) {
      const float* row = tile + lane * kRowLd;
      for (int c4 = 0; c4 < n4; ++c4) {
        const float4 x4 = *reinterpret_cast<const float4*>(row + 4 * c4);
        const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int c = c0 + 4 * c4 + t;
          if (l2) {
            const float df = (float)p[c] - x[t];
            acc = fma((double)df, (double)df, acc);
          } else {
            acc = fma((double)p[c], (double)x[t], acc);
          }
        }
      }
    }
    __syncwarp();
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

// The staged user rows' element type: double for dot (converted once),
// float for l2 and for the wide instantiation (read from global memory).
template <bool kWide, bool kL2>
struct Staged {
  using T = double;
};
template <bool kL2>
struct Staged<true, kL2> {
  using T = float;
};
template <>
struct Staged<false, true> {
  using T = float;
};

// Shared memory of a block of `threads` threads, `lanes` to a slot: the
// user rows and the positives' rows (d | 1 apart, so that a warp's slots
// read other banks; each part padded to 16 bytes), then the warps' tiles of
// candidate rows, then ui per slot; the wide instantiation has ui only.
__host__ __device__ constexpr size_t pad16(size_t n) { return (n + 15) / 16 * 16; }

template <bool kWide, bool kL2>
__host__ __device__ constexpr size_t staged_bytes(int slots, int d) {
  return kWide ? 0
               : pad16(sizeof(typename Staged<kWide, kL2>::T) * (size_t)slots * (d | 1)) +
                     pad16(sizeof(float) * (size_t)slots * (d | 1));
}

template <bool kWide, bool kL2>
__host__ __device__ constexpr size_t search_smem(int threads, int lanes, int d) {
  return staged_bytes<kWide, kL2>(threads / lanes, d) +
         sizeof(float) * ((kWide ? 0 : (size_t)threads * kRowLd) + threads / lanes);
}

// One block: blockDim.x / lanes slots from blockIdx.x * that, `lanes` (a
// power of two up to 32) lanes per slot.
template <bool kWide, bool kL2>
__global__ void __launch_bounds__(kThreads)
search_kernel(const int32_t* __restrict__ users, const int32_t* __restrict__ pos, int N,
              int n_valid, Draw draw, const float* __restrict__ P, const float* __restrict__ Q,
              int d, bool vec, float threshold, int lazy, int lanes,
              const uint32_t* __restrict__ seen_bits, const uint32_t* __restrict__ bloom,
              uint32_t wmask, const int64_t* __restrict__ indptr, int32_t* __restrict__ out_neg,
              float* __restrict__ out_w, uint8_t* __restrict__ out_anyv,
              int32_t* __restrict__ out_trial, int32_t* __restrict__ counts) {
  using PT = typename Staged<kWide, kL2>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = lanes, slots = blockDim.x / G, ld = d | 1;
  PT* ps = reinterpret_cast<PT*>(smem);
  float* uis = reinterpret_cast<float*>(smem + search_smem<kWide, kL2>(blockDim.x, G, d) -
                                        sizeof(float) * slots);
  float* tile = reinterpret_cast<float*>(smem + staged_bytes<kWide, kL2>(slots, d)) +
                (threadIdx.x >> 5) * 32 * kRowLd;
  const int slot0 = blockIdx.x * slots;
  float* qpos = reinterpret_cast<float*>(
      smem + pad16(sizeof(PT) * (size_t)slots * ld));  // the positives' rows
  if (!kWide) {  // every thread stages: one round trip for all the rows
    for (int e = threadIdx.x; e < slots * d; e += blockDim.x) {
      const int s = e / d, c = e - s * d;
      if (slot0 + s < N) {
        ps[s * ld + c] = (PT)P[(int64_t)users[slot0 + s] * d + c];
        qpos[s * ld + c] = Q[(int64_t)pos[slot0 + s] * d + c];
      }
    }
    __syncthreads();
  }
  // ui once per slot (thread s sums slot s's positive)
  if (threadIdx.x < slots && slot0 + (int)threadIdx.x < N) {
    const int s = threadIdx.x;
    uis[s] = kWide ? row_score(P + (int64_t)users[slot0 + s] * d,
                               Q + (int64_t)pos[slot0 + s] * d, d, kL2, vec)
                   : row_score(ps + s * ld, qpos + s * ld, d, kL2, false);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, gl = lane & (G - 1);
  const int gbase = lane - gl;  // the group's first lane
  const int s_loc = (threadIdx.x >> 5) * (32 / G) + lane / G;
  const int slot = slot0 + s_loc;
  const unsigned gmask = G == 32 ? kFull : (1u << G) - 1u;
  const bool live = slot < N;
  const int u = live ? users[slot] : 0;
  const PT* p = kWide ? nullptr : ps + s_loc * ld;
  const float* pg = P + (int64_t)u * d;
  const float ui = live ? uis[s_loc] : 0.f;
  const int K = draw.K, nw = (K + 31) / 32;
  const int J = K < kProbes ? K : kProbes;
  const unsigned below = (1u << gl) - 1u;
  bool found = false, done = !live, seen0 = false;
  int f = 0, trial = 1, first_viol = -1, nviol = 0, unseen = 0;
  uint32_t neg = 0, cand0 = 0, first_cand = 0;
  // the warp walks while one of its slots is open; ballots, shuffles and
  // the loop's bounds are the whole warp's, each group reading its bits
  for (int j0 = 0; j0 < K && __any_sync(kFull, !done); j0 += G) {
    const int j = j0 + gl;
    const bool in = !done && j < K;
    const uint32_t cand = in ? draw(slot, j) : 0u;
    bool viol = false;
    if (!kWide && vec) {  // warp-uniform: every lane takes part in the loads
      const float uj = tiled_score(p, Q, cand, in, d, kL2, G, gl, gbase, tile, lane);
      viol = in && ui - uj < threshold;
    } else if (in) {
      const float* q = Q + (int64_t)cand * d;
      viol = ui - (kWide ? row_score(pg, q, d, kL2, vec) : row_score(p, q, d, kL2, vec)) <
             threshold;
    }
    const uint32_t c_first = __shfl_sync(kFull, cand, gbase);
    if (j0 == 0) cand0 = c_first;
    bool seen = false;
    if (lazy) {
      const unsigned vm = (__ballot_sync(kFull, viol) >> gbase) & gmask;
      const int rank = nviol + __popc(vm & below) + 1;
      const bool probe = viol && rank <= J;
      if (probe) seen = seen_bits ? (seen_bits[(int64_t)slot * nw + (j >> 5)] >> (j & 31)) & 1u
                                  : bloom_contains(bloom, wmask, (uint32_t)u, cand);
      const int fv = vm ? __ffs(vm) - 1 : 0;
      const uint32_t cv = __shfl_sync(kFull, cand, gbase + fv);
      const unsigned ok = (__ballot_sync(kFull, probe && !seen) >> gbase) & gmask;
      const int fo = ok ? __ffs(ok) - 1 : 0;
      const uint32_t co = __shfl_sync(kFull, cand, gbase + fo);
      if (!done) {
        if (first_viol < 0 && vm) {
          first_viol = j0 + fv;
          first_cand = cv;
        }
        if (ok) {
          f = j0 + fo;
          // the probed violators before it were all flagged
          trial = 2 * (f + 1 - (nviol + __popc(vm & ((1u << fo) - 1u))));
          neg = co;
          found = done = true;
        } else {
          nviol += __popc(vm);
          done = nviol >= J;
        }
      }
    } else {
      if (in) seen = seen_bits ? (seen_bits[(int64_t)slot * nw + (j >> 5)] >> (j & 31)) & 1u
                               : bloom_contains(bloom, wmask, (uint32_t)u, cand);
      const unsigned ns = (__ballot_sync(kFull, in && !seen) >> gbase) & gmask;
      const unsigned ok = (__ballot_sync(kFull, in && !seen && viol) >> gbase) & gmask;
      const int fo = ok ? __ffs(ok) - 1 : 0;
      const uint32_t co = __shfl_sync(kFull, cand, gbase + fo);
      if (!done) {
        if (j0 == 0) seen0 = !(ns & 1u);
        if (ok) {
          f = j0 + fo;
          const unsigned upto = fo == 31 ? kFull : (2u << fo) - 1u;
          trial = 2 * (unseen + __popc(ns & upto));
          neg = co;
          found = done = true;
        } else {
          unseen += __popc(ns);
        }
      }
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
  const bool lead = live && gl == 0;
  if (lead) {
    const int seen_u = (int)(indptr[u + 1] - indptr[u]);
    const int avail = max(draw.num_items - seen_u - 1, 0);
    const float phi = logf((float)max(1, avail / trial));
    const bool valid = slot < n_valid;
    out_neg[slot] = (int32_t)neg;
    out_anyv[slot] = found ? 1 : 0;
    out_trial[slot] = trial;
    out_w[slot] = found && valid ? phi : 0.f;
  }
  const int n = __syncthreads_count(lead && found && slot < n_valid);
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

namespace {

template <bool kWide, bool kL2>
int launch_search(unsigned grid, int threads, size_t smem, cudaStream_t st, const int32_t* users,
                  const int32_t* pos, int N, int n_valid, const Draw& draw, const float* P,
                  const float* Q, int d, bool vec, float threshold, int lazy, int lanes,
                  const uint32_t* seen_bits, const uint32_t* bloom, uint32_t wm,
                  const int64_t* indptr, int32_t* out_neg, float* out_w, uint8_t* out_anyv,
                  int32_t* out_trial, int32_t* counts) {
  auto kernel = search_kernel<kWide, kL2>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, threads, smem, st>>>(users, pos, N, n_valid, draw, P, Q, d, vec, threshold, lazy,
                                      lanes, seen_bits, bloom, wm, indptr, out_neg, out_w,
                                      out_anyv, out_trial, counts);
  return (int)cudaGetLastError();
}

// A slot's lanes: K rounded up to a power of two, at most kMaxLanes, so
// that 32 / lanes slots share a warp, no lane idles at a power-of-two K,
// and a slot settled by its first violators reads no more candidates' rows
// than a group holds.
int search_lanes(int K) {
  int lanes = 1;
  while (lanes < K && lanes < kMaxLanes) lanes *= 2;
  return lanes;
}

// Shared memory bytes of a search block of `warps` warps, `lanes` to a
// slot, at width d.
size_t block_smem(int warps, int lanes, int d, int l2) {
  const int threads = 32 * warps;
  if (warp_search_wide(d)) return search_smem<true, false>(threads, lanes, d);
  return l2 ? search_smem<false, true>(threads, lanes, d)
            : search_smem<false, false>(threads, lanes, d);
}

}  // namespace

// cands (N x K) may be null (Philox draws under key = (k1 << 32) | k0);
// seen_bits (N x ceil(K / 32) words) may be null (the bloom filter, 2^(log2 -
// 5) words, is probed); counts points at the chunk's found count.  Each slot
// takes search_lanes(K) lanes; a block takes kWarps warps, halved while its
// shared memory passes 48 KB (few lanes on wide rows).
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
  const int lanes = search_lanes(K);
  int warps = kWarps;
  while (warps > 1 && block_smem(warps, lanes, d, l2) > 48 * 1024) warps /= 2;
  const int threads = 32 * warps, slots = threads / lanes;
  const size_t smem = block_smem(warps, lanes, d, l2);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const bool vec = (d % 4 == 0) && ((uintptr_t)Q % 16 == 0);
  const Draw draw = make_draw(cands, K, num_items, key, epoch, chunk, slot_offset);
  const unsigned grid = (unsigned)((N + slots - 1) / slots);
  const uint32_t wm = seen_bits ? 0u : word_mask(bloom_log2);
  const cudaStream_t st = (cudaStream_t)stream;
  auto launch = [&](auto kernel_fn) {
    return kernel_fn(grid, threads, smem, st, users, pos, N, n_valid, draw, P, Q, d, vec,
                     threshold, lazy, lanes, seen_bits, bloom, wm, indptr, out_neg, out_w,
                     out_anyv, out_trial, counts);
  };
  if (warp_search_wide(d))
    return l2 ? launch(launch_search<true, true>) : launch(launch_search<true, false>);
  return l2 ? launch(launch_search<false, true>) : launch(launch_search<false, false>);
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
