// K19: the skip-gram negative-sampling (SGNS) forward of one pair chunk.
// Pair b trains input word inputs[b] (its L0 row) against target word
// targets[b] (its L1 row) and K negatives; inputs[b] = V marks a padding
// pair, which trains nothing.  Negative k of pair b is slot s = b K + k: the
// first of three alias draws (K8's routine, the Philox counter (s, chunk,
// epoch, attempt)) that is not the target, else (target + 1) mod V; or
// negs_in[s] when given.  On a mesh shard the counter takes the slot's global
// index: slot_offset (the shard's first pair of the chunk) is added to b, so
// the shard draws the single device's negatives of its pairs bit for bit
// (_w2v_step_body :503-511 draws the global batch and slices it).  With f =
// l0 . l1 and g(label, f) = label - sigmoid(f), 1 - label above +6 and label
// below -6, pair b emits, each row scaled by lr and every term from the
// tables before the step:
//  * keys1[b] = target, d1[b] = g(1, f_pos) l0;
//  * keys1[B + s] = negative k, d1[B + s] = g(0, f_neg_k) l0;
//  * d0[b] = g(1, f_pos) l_t + sum_k g(0, f_neg_k) l_k (keyed by inputs[b]);
// padding pairs key their L1 rows V (dropped) and emit zero rows.  The loss
// -log(sigmoid(f_pos) + 1e-10) - sum_k log(1 - sigmoid(f_neg_k) + 1e-10)
// and the count of real pairs are summed per block in pair order and the
// blocks' partials in block order, with no float atomics.  K20
// (csrc/w2v_row_apply.cu) then adds the rows into L1 and L0.
//
// Replaces buffalo_tpu/ops/w2v_kernels.py _w2v_step_body (:477) and the
// forward of w2v_step (:462) and w2v_epoch's scan body (:63-75), with _g
// (:27) and the draws of :500-517.
//
// What bounds it on the card: the rows it reads (the input's L0 row, the
// target's and K negatives' L1 rows, d floats each) and the (2 + K) d floats
// it writes per pair; at d = 32, K = 5 about 1.8 KB per pair, so a
// 262,144-pair chunk moves ~0.5 GB at most (the head words' rows come from
// L2).  The 3 (K + 1) Philox draws and (K + 1) d FMAs per pair are far below
// the card's rates.  Design: one warp per pair, lane c holding columns c +
// 32 h, so each dot product is a warp sum; the draws one lane per negative;
// nothing is written until the pair's sums are formed, and no table is
// written at all.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sampling.cuh"
#include "w2v_common.cuh"

namespace {

constexpr int kAttempts = 3;

// kWide (rows past 256 floats): the rows read from global memory in the
// registers' column order, the input's delta summed in its output row.
template <int H, bool kWide>
__global__ void __launch_bounds__(kThreads)
pair_step(const float* __restrict__ L0, const float* __restrict__ L1,
          const int32_t* __restrict__ inputs, const int32_t* __restrict__ targets, int B, int V,
          int d, int K, float lr, uint32_t k0, uint32_t k1, uint32_t epoch, uint32_t chunk,
          int64_t slot_offset, const float* __restrict__ prob, const int32_t* __restrict__ alias,
          const int32_t* __restrict__ negs_in, int32_t* negs, int32_t* __restrict__ keys1,
          float* __restrict__ d1, float* __restrict__ d0, int compute_loss,
          float* __restrict__ part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  float loss = 0.f, cnt = 0.f;
  if (b < B) {
    const int in = inputs[b], tg = targets[b];
    const bool valid = in < V;
    const float vf = valid ? 1.f : 0.f;
    for (int k = lane; k < K; k += 32) {
      const int64_t s = (int64_t)b * K + k;
      int32_t n;
      if (negs_in) {
        n = negs_in[s];
      } else {
        n = -1;
        for (int a = 0; a < kAttempts && n < 0; ++a) {
          const int32_t c =
              (int32_t)alias_draw(U4{(uint32_t)(s + slot_offset * K), chunk, epoch,
                                     (uint32_t)a},
                                  k0, k1, (uint32_t)V, prob, alias);
          if (c != tg) n = c;
        }
        if (n < 0) n = (int32_t)(((int64_t)tg + 1) % V);
      }
      negs[s] = n;
      keys1[B + s] = valid ? n : V;
    }
    if (lane == 0) keys1[b] = valid ? tg : V;
    __syncwarp();  // the warp's negatives, written above, are read below
    if (kWide) {
      const float* l0 = L0 + (int64_t)min(in, V - 1) * d;
      const float* lt = L1 + (int64_t)min(tg, V - 1) * d;
      float* w0 = d0 + (int64_t)b * d;  // the input's delta, summed in place
      float sp = 0.f;
      for (int c = lane; c < d; c += 32) sp += l0[c] * lt[c];
      const float fp = warp_sum(sp);
      const float gp = g_of(1.f, fp) * vf;
      float lsum = compute_loss ? -logf(sigm(fp) + kEps) : 0.f;
      for (int c = lane; c < d; c += 32) {
        w0[c] = gp * lt[c];
        d1[(int64_t)b * d + c] = lr * gp * l0[c];
      }
      for (int k = 0; k < K; ++k) {
        const int64_t s = (int64_t)b * K + k;
        const float* ln = L1 + (int64_t)negs[s] * d;
        float sn = 0.f;
        for (int c = lane; c < d; c += 32) sn += l0[c] * ln[c];
        const float fn = warp_sum(sn);
        const float gn = g_of(0.f, fn) * vf;
        if (compute_loss) lsum -= logf(1.f - sigm(fn) + kEps);
        for (int c = lane; c < d; c += 32) {
          w0[c] += gn * ln[c];
          d1[((int64_t)B + s) * d + c] = lr * gn * l0[c];
        }
      }
      for (int c = lane; c < d; c += 32) w0[c] = lr * w0[c];
      loss = vf * lsum;
      cnt = vf;
    }
  }
  if (kWide) {
    block_partials(loss, cnt, part);
    return;
  }
  if (b < B) {
    const int in = inputs[b], tg = targets[b];
    const float vf = in < V ? 1.f : 0.f;
    float l0[H], lt[H], ln[H], work[H];
    load_row<H>(L0 + (int64_t)min(in, V - 1) * d, d, lane, l0);
    load_row<H>(L1 + (int64_t)min(tg, V - 1) * d, d, lane, lt);
    const float fp = dot<H>(l0, lt);
    const float gp = g_of(1.f, fp) * vf;
    float lsum = compute_loss ? -logf(sigm(fp) + kEps) : 0.f;
#pragma unroll
    for (int h = 0; h < H; ++h) work[h] = gp * lt[h];
    store_row<H>(d1 + (int64_t)b * d, d, lane, lr * gp, l0);
    for (int k = 0; k < K; ++k) {
      const int64_t s = (int64_t)b * K + k;
      load_row<H>(L1 + (int64_t)negs[s] * d, d, lane, ln);
      const float fn = dot<H>(l0, ln);
      const float gn = g_of(0.f, fn) * vf;
      if (compute_loss) lsum -= logf(1.f - sigm(fn) + kEps);
      axpy<H>(gn, ln, work);
      store_row<H>(d1 + ((int64_t)B + s) * d, d, lane, lr * gn, l0);
    }
    store_row<H>(d0 + (int64_t)b * d, d, lane, lr, work);
    loss = vf * lsum;
    cnt = vf;
  }
  block_partials(loss, cnt, part);
}

}  // namespace

// 1 when rows of d floats take the wide instantiation.
extern "C" int w2v_pair_step_wide(int d) { return d > 256 ? 1 : 0; }

// Partials the launch needs (2 floats each).
extern "C" int w2v_pair_parts(int B) { return (B + kWarps - 1) / kWarps; }

// key = (k1 << 32) | k0 of the seed; slot_offset >= 0; negs_in may be null
// (draw), prob/alias are then the V-entry alias tables; part has 2
// w2v_pair_parts(B) floats; out gets (loss, count).
extern "C" int w2v_pair_step(const float* L0, const float* L1, const int32_t* inputs,
                             const int32_t* targets, int B, int V, int d, int K, float lr,
                             int64_t key, int epoch, int chunk, int64_t slot_offset,
                             const float* prob, const int32_t* alias, const int32_t* negs_in,
                             int32_t* negs,
                             int32_t* keys1, float* d1, float* d0, int compute_loss, float* part,
                             float* out, void* stream) {
  if (B < 0 || V < 1 || d < 1 || K < 1 || slot_offset < 0 ||
      (!negs_in && (!prob || !alias)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const uint64_t kk = (uint64_t)key;
  const int blocks = w2v_pair_parts(B);
  if (blocks > 0) {
#define W2V_PAIR(H, W)                                                                      \
  pair_step<H, W><<<blocks, kThreads, 0, st>>>(L0, L1, inputs, targets, B, V, d, K, lr,     \
                                            (uint32_t)kk, (uint32_t)(kk >> 32),             \
                                            (uint32_t)epoch, (uint32_t)chunk, slot_offset,  \
                                            prob, alias, negs_in, negs, keys1, d1, d0,      \
                                            compute_loss, part)
    if (d <= 32) W2V_PAIR(1, false);
    else if (d <= 64) W2V_PAIR(2, false);
    else if (d <= 128) W2V_PAIR(4, false);
    else if (d <= 256) W2V_PAIR(8, false);
    else W2V_PAIR(8, true);
#undef W2V_PAIR
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  sum_parts<<<1, 32, 0, st>>>(part, blocks, out);
  return (int)cudaGetLastError();
}
