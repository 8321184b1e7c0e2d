// K8: one chunk's BPR negatives, sampled and verified.  Slot k = j * neg_per
// + n of the chunk belongs to user users[j].  Attempt a takes the Philox4x32-10
// words (x0, x1) of the counter (k, chunk, epoch, a) under the seed's key:
// the candidate is mulhi(x0, num_items), or with alias tables that index kept
// when (x1 >> 8) 2^-24 < prob[index], else alias[index].  With a bloom filter
// (blocked, both bits of a pair in one uint32 word) the first of kAttempts
// candidates not flagged as a positive of the user wins, else the sentinel
// num_items (it trains nothing); without one, attempt 0.  Optionally slot j's
// positive is keys[lo + (x0 >> 2) % max(deg, 1)] of its user's CSR list, from
// the counter (j, chunk, epoch, kPositiveStream).  On a mesh shard the
// counters take the slot's global index: slot_offset (the shard's first slot
// of the chunk) is added to j, and slot_offset * neg_per to k, so a shard's
// draws equal the single device's bit for bit (bpr_epoch_dp :702-731).
//
// Replaces buffalo_tpu/ops/sgd_kernels.py draw_from_alias (:70),
// draw_negatives (:82), _bloom_hashes (:117), bloom_contains (:234),
// sample_verified_negatives (:243), bpr_sample_negatives_epoch (:445) and the
// random-positive draw of bpr_epoch (:508-519).  The draws are this port's
// own (JAX's threefry stream cannot be reproduced); the plain version
// (ops/sgd_kernels.py sample_negatives_plain) computes the same uint32
// function, so the two agree bit for bit.
//
// What bounds it on the card: one random 4-byte bloom word per attempt (a
// 32 MiB filter at ML-20M, most of it in L2), the user ids read and the
// negatives written, about 1.2 attempts per slot; Philox is ~100 integer
// operations per attempt.  Design: one thread per slot, everything in
// registers, the attempts stop at the first unseen candidate.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sampling.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kAttempts = 4;
constexpr uint32_t kPositiveStream = 0x80000000u;

__global__ void __launch_bounds__(kThreads)
sample_kernel(const int32_t* __restrict__ users, int N, int neg_per, int num_items, uint32_t k0,
              uint32_t k1, uint32_t epoch, uint32_t chunk, int64_t slot_offset,
              const uint32_t* __restrict__ bloom,
              int bloom_log2, const float* __restrict__ prob, const int32_t* __restrict__ alias,
              const int64_t* __restrict__ pos_indptr, const int32_t* __restrict__ pos_keys,
              int32_t* __restrict__ out_neg, int32_t* __restrict__ out_pos) {
  const int64_t k = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t B = (int64_t)N * neg_per;
  if (k >= B) return;
  const uint32_t u = (uint32_t)users[k / neg_per];
  const uint32_t wmask = bloom ? (1u << (bloom_log2 - 5)) - 1u : 0u;
  int32_t out = num_items;
  const int attempts = bloom ? kAttempts : 1;
  for (int a = 0; a < attempts; ++a) {
    const uint32_t cand = alias_draw(U4{(uint32_t)(k + slot_offset * neg_per), chunk, epoch,
                                        (uint32_t)a},
                                     k0, k1,
                                     (uint32_t)num_items, prob, alias);
    if (!bloom || !bloom_contains(bloom, wmask, u, cand)) {
      out = (int32_t)cand;
      break;
    }
  }
  out_neg[k] = out;
  if (out_pos && k < N) {
    // slot j = k's own user (the negatives above belong to slot k / neg_per)
    const uint32_t uj = (uint32_t)users[k];
    const U4 x = philox(U4{(uint32_t)(k + slot_offset), chunk, epoch, kPositiveStream}, k0, k1);
    const int64_t lo = pos_indptr[uj], deg = pos_indptr[uj + 1] - lo;
    out_pos[k] = pos_keys[lo + (int64_t)(x.x0 >> 2) % (deg > 0 ? deg : 1)];
  }
}

}  // namespace

// bloom (2^(bloom_log2 - 5) words), prob/alias (num_items entries), and
// pos_indptr/pos_keys/out_pos may be null; key = (k1 << 32) | k0.
extern "C" int bpr_sample(const int32_t* users, int N, int neg_per, int num_items, int64_t key,
                          int epoch, int chunk, int64_t slot_offset, const uint32_t* bloom,
                          int bloom_log2,
                          const float* prob, const int32_t* alias, const int64_t* pos_indptr,
                          const int32_t* pos_keys, int32_t* out_neg, int32_t* out_pos,
                          void* stream) {
  if (N < 0 || neg_per < 1 || num_items < 1 || slot_offset < 0 ||
      (bloom && (bloom_log2 < 5 || bloom_log2 > 32)))
    return (int)cudaErrorInvalidValue;
  const int64_t B = (int64_t)N * neg_per;
  if (B == 0) return 0;
  const uint64_t kk = (uint64_t)key;
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  sample_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      users, N, neg_per, num_items, (uint32_t)kk, (uint32_t)(kk >> 32), (uint32_t)epoch,
      (uint32_t)chunk, slot_offset, bloom, bloom_log2, prob, alias, pos_indptr, pos_keys, out_neg,
      out_pos ? out_pos : nullptr);
  return (int)cudaGetLastError();
}
