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
// and the count of real pairs are summed per block in a fixed order and the
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
// the card's rates, so the time is the latency of each pair's chain of
// loads.  Design (rows up to 256 floats): a team of lanes per pair
// (pair_lanes: a lane per kLaneFloats floats of the row, 4 at d = 32, so 8
// pairs a warp), each lane holding one or two float4s of every row.  The
// input's and target's rows are read first; the team's first lanes draw the
// negatives into registers (written to negs and keys1 on the way), the rows
// are addressed from those registers by shuffles, and all of a pair's rows
// (up to 8 negatives at a time) are in flight before its first dot; each dot
// is a fixed xor sum over the team.  The delta rows are written as float4s.
// Rows past 256 floats take the wide form: a warp per pair, the rows read
// from global memory in the lanes' column order.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sampling.cuh"
#include "w2v_common.cuh"

namespace {

constexpr int kAttempts = 3;
constexpr int kNarrowMax = 256;  // the team forms' widest row
constexpr int kNegBlock = 8;     // negatives whose rows are in flight at once
constexpr int kLaneFloats = 8;   // floats of a row a team's lane holds
static_assert(kLaneFloats <= 8, "the team forms hold at most 2 float4s a lane");

// Lanes a pair for rows of d floats: the fewest, a power of two up to 32,
// that hold the row at kLaneFloats floats a lane; a warp past kNarrowMax
// floats (the wide form).
int pair_lanes(int d) {
  if (d > kNarrowMax) return 32;
  int g = 1;
  while (g < 32 && g * kLaneFloats < d) g *= 2;
  return g;
}

struct PairArgs {
  const float* L0;
  const float* L1;
  const int32_t* inputs;
  const int32_t* targets;
  int B, V, d, K;
  float lr;
  uint32_t k0, k1, epoch, chunk;
  int64_t slot_offset;
  const float* prob;
  const int32_t* alias;
  const int32_t* negs_in;
  int32_t* negs;
  int32_t* keys1;
  float* d1;
  float* d0;
  int compute_loss;
  float* part;
  bool vec;  // rows as aligned float4s (d % 4 == 0)
};

// Negative slot s of a pair with target tg: given, or drawn.
__device__ __forceinline__ int32_t negative(const PairArgs& a, int64_t s, int tg) {
  if (a.negs_in) return a.negs_in[s];
  int32_t n = -1;
  for (int at = 0; at < kAttempts && n < 0; ++at) {
    const int32_t c = (int32_t)alias_draw(
        U4{(uint32_t)(s + a.slot_offset * a.K), a.chunk, a.epoch, (uint32_t)at}, a.k0, a.k1,
        (uint32_t)a.V, a.prob, a.alias);
    if (c != tg) n = c;
  }
  return n < 0 ? (int32_t)(((int64_t)tg + 1) % a.V) : n;
}

// Columns 4q .. 4q + 3 of a row (zeros past d).
__device__ __forceinline__ float4 ld4(const float* row, int q, int d, bool vec) {
  const int c = 4 * q;
  if (vec) return c < d ? reinterpret_cast<const float4*>(row)[q]
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 r;
  r.x = c < d ? row[c] : 0.f;
  r.y = c + 1 < d ? row[c + 1] : 0.f;
  r.z = c + 2 < d ? row[c + 2] : 0.f;
  r.w = c + 3 < d ? row[c + 3] : 0.f;
  return r;
}

// out[4q ..] = m r (columns below d).
__device__ __forceinline__ void st4(float* row, int q, int d, bool vec, float m, float4 r) {
  const int c = 4 * q;
  if (c >= d) return;
  const float4 o = make_float4(m * r.x, m * r.y, m * r.z, m * r.w);
  if (vec) {
    reinterpret_cast<float4*>(row)[q] = o;
    return;
  }
  row[c] = o.x;
  if (c + 1 < d) row[c + 1] = o.y;
  if (c + 2 < d) row[c + 2] = o.z;
  if (c + 3 < d) row[c + 3] = o.w;
}

// A team's dot product: each lane's float4s, then a fixed xor sum.
template <int G, int V4>
__device__ __forceinline__ float team_dot(const float4 (&x)[V4], const float4 (&y)[V4]) {
  float p = 0.f;
#pragma unroll
  for (int u = 0; u < V4; ++u) {
    p += x[u].x * y[u].x;
    p += x[u].y * y[u].y;
    p += x[u].z * y[u].z;
    p += x[u].w * y[u].w;
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) p += __shfl_xor_sync(kFull, p, o);
  return p;
}

// A team of G lanes per pair, 32 / G pairs a warp; lane s of a team holds
// the float4s s + G u (u < V4) of each row.
template <int G, int V4>
__global__ void __launch_bounds__(kThreads) pair_step_group(PairArgs a) {
  constexpr int NPL = (kNegBlock + G - 1) / G;  // negatives a lane draws per block
  const int lane = threadIdx.x & 31, t = lane / G, s = lane % G;
  const int b = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * (32 / G) + t;
  const bool have = b < a.B;
  const int in = have ? a.inputs[b] : a.V, tg = have ? a.targets[b] : 0;
  const bool valid = in < a.V;
  const float vf = valid ? 1.f : 0.f;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 l0[V4], lt[V4], work[V4];
  const float* r0 = a.L0 + (int64_t)min(in, a.V - 1) * a.d;
  const float* rt = a.L1 + (int64_t)min(tg, a.V - 1) * a.d;
#pragma unroll
  for (int u = 0; u < V4; ++u) {
    l0[u] = have ? ld4(r0, s + G * u, a.d, a.vec) : zero;
    lt[u] = have ? ld4(rt, s + G * u, a.d, a.vec) : zero;
  }
  if (have && s == 0) a.keys1[b] = valid ? tg : a.V;
  float lsum = 0.f;
  for (int kb = 0; kb < a.K; kb += kNegBlock) {
    const int nk = min(kNegBlock, a.K - kb);
    int32_t nd[NPL];
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int j = s + G * i;
      nd[i] = 0;
      if (have && j < nk) {
        const int64_t slot = (int64_t)b * a.K + kb + j;
        nd[i] = negative(a, slot, tg);
        a.negs[slot] = nd[i];
        a.keys1[a.B + slot] = valid ? nd[i] : a.V;
      }
    }
    float4 ln[kNegBlock][V4];
#pragma unroll
    for (int j = 0; j < kNegBlock; ++j) {
      const int32_t n = __shfl_sync(kFull, nd[j / G], j % G, G);
      const float* rn = a.L1 + (int64_t)n * a.d;
#pragma unroll
      for (int u = 0; u < V4; ++u)
        ln[j][u] = have && j < nk ? ld4(rn, s + G * u, a.d, a.vec) : zero;
    }
    if (kb == 0) {
      const float fp = team_dot<G, V4>(l0, lt);
      const float gp = g_of(1.f, fp) * vf;
      if (a.compute_loss) lsum = -logf(sigm(fp) + kEps);
#pragma unroll
      for (int u = 0; u < V4; ++u)
        work[u] = make_float4(gp * lt[u].x, gp * lt[u].y, gp * lt[u].z, gp * lt[u].w);
      if (have) {
#pragma unroll
        for (int u = 0; u < V4; ++u)
          st4(a.d1 + (int64_t)b * a.d, s + G * u, a.d, a.vec, a.lr * gp, l0[u]);
      }
    }
#pragma unroll
    for (int j = 0; j < kNegBlock; ++j) {
      if (j >= nk) break;
      const float fn = team_dot<G, V4>(l0, ln[j]);
      const float gn = g_of(0.f, fn) * vf;
      if (a.compute_loss) lsum -= logf(1.f - sigm(fn) + kEps);
#pragma unroll
      for (int u = 0; u < V4; ++u) {
        work[u].x += gn * ln[j][u].x;
        work[u].y += gn * ln[j][u].y;
        work[u].z += gn * ln[j][u].z;
        work[u].w += gn * ln[j][u].w;
      }
      if (have) {
        const int64_t row = (int64_t)a.B + (int64_t)b * a.K + kb + j;
#pragma unroll
        for (int u = 0; u < V4; ++u)
          st4(a.d1 + row * a.d, s + G * u, a.d, a.vec, a.lr * gn, l0[u]);
      }
    }
  }
  if (have) {
#pragma unroll
    for (int u = 0; u < V4; ++u) st4(a.d0 + (int64_t)b * a.d, s + G * u, a.d, a.vec, a.lr, work[u]);
  }
  // each team's (loss, count) at its lane 0, summed over the warp's lanes
  // in a fixed tree, then over the block's warps in order
  const bool lead = have && s == 0;
  block_partials(warp_sum(lead ? vf * lsum : 0.f), warp_sum(lead ? vf : 0.f), a.part);
}

// Rows past kNarrowMax floats: a warp per pair, the rows read from global
// memory in the lanes' column order, the input's delta summed in its output
// row.
__global__ void __launch_bounds__(kThreads) pair_step_wide(PairArgs a) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int d = a.d, B = a.B, K = a.K;
  float loss = 0.f, cnt = 0.f;
  if (b < B) {
    const int in = a.inputs[b], tg = a.targets[b];
    const bool valid = in < a.V;
    const float vf = valid ? 1.f : 0.f;
    for (int k = lane; k < K; k += 32) {
      const int64_t s = (int64_t)b * K + k;
      const int32_t n = negative(a, s, tg);
      a.negs[s] = n;
      a.keys1[B + s] = valid ? n : a.V;
    }
    if (lane == 0) a.keys1[b] = valid ? tg : a.V;
    __syncwarp();  // the warp's negatives, written above, are read below
    const float* l0 = a.L0 + (int64_t)min(in, a.V - 1) * d;
    const float* lt = a.L1 + (int64_t)min(tg, a.V - 1) * d;
    float* w0 = a.d0 + (int64_t)b * d;  // the input's delta, summed in place
    float sp = 0.f;
    for (int c = lane; c < d; c += 32) sp += l0[c] * lt[c];
    const float fp = warp_sum(sp);
    const float gp = g_of(1.f, fp) * vf;
    float lsum = a.compute_loss ? -logf(sigm(fp) + kEps) : 0.f;
    for (int c = lane; c < d; c += 32) {
      w0[c] = gp * lt[c];
      a.d1[(int64_t)b * d + c] = a.lr * gp * l0[c];
    }
    for (int k = 0; k < K; ++k) {
      const int64_t s = (int64_t)b * K + k;
      const float* ln = a.L1 + (int64_t)a.negs[s] * d;
      float sn = 0.f;
      for (int c = lane; c < d; c += 32) sn += l0[c] * ln[c];
      const float fn = warp_sum(sn);
      const float gn = g_of(0.f, fn) * vf;
      if (a.compute_loss) lsum -= logf(1.f - sigm(fn) + kEps);
      for (int c = lane; c < d; c += 32) {
        w0[c] += gn * ln[c];
        a.d1[((int64_t)B + s) * d + c] = a.lr * gn * l0[c];
      }
    }
    for (int c = lane; c < d; c += 32) w0[c] = a.lr * w0[c];
    loss = vf * lsum;
    cnt = vf;
  }
  block_partials(loss, cnt, a.part);
}

template <int G>
void launch_group(const PairArgs& a, int V4, int blocks, cudaStream_t st) {
  if (V4 <= 1) pair_step_group<G, 1><<<blocks, kThreads, 0, st>>>(a);
  else pair_step_group<G, 2><<<blocks, kThreads, 0, st>>>(a);
}

}  // namespace

// 1 when rows of d floats take the wide instantiation.
extern "C" int w2v_pair_step_wide(int d) { return d > kNarrowMax ? 1 : 0; }

// The blocks of a launch of B pairs of rows of d floats: one (loss, count)
// partial each.
extern "C" int w2v_pair_parts(int B, int d) {
  return (int)(((int64_t)B * pair_lanes(d) + kThreads - 1) / kThreads);
}

// key = (k1 << 32) | k0 of the seed; slot_offset >= 0; negs_in may be null
// (draw), prob/alias are then the V-entry alias tables; part has 2
// w2v_pair_parts(B, d) floats; out gets (loss, count).
extern "C" int w2v_pair_step(const float* L0, const float* L1, const int32_t* inputs,
                             const int32_t* targets, int B, int V, int d, int K, float lr,
                             int64_t key, int epoch, int chunk, int64_t slot_offset,
                             const float* prob, const int32_t* alias, const int32_t* negs_in,
                             int32_t* negs, int32_t* keys1, float* d1, float* d0,
                             int compute_loss, float* part, float* out, void* stream) {
  if (B < 0 || V < 1 || d < 1 || K < 1 || slot_offset < 0 || (!negs_in && (!prob || !alias)))
    return (int)cudaErrorInvalidValue;
  const bool wide = d > kNarrowMax;
  const int lanes = pair_lanes(d), V4 = (d + 4 * lanes - 1) / (4 * lanes);
  const cudaStream_t st = (cudaStream_t)stream;
  const uint64_t kk = (uint64_t)key;
  const bool vec = d % 4 == 0 && (uintptr_t)L0 % 16 == 0 && (uintptr_t)L1 % 16 == 0 &&
                   (uintptr_t)d1 % 16 == 0 && (uintptr_t)d0 % 16 == 0;
  const PairArgs a{L0, L1, inputs, targets, B, V, d, K, lr, (uint32_t)kk,
                   (uint32_t)(kk >> 32), (uint32_t)epoch, (uint32_t)chunk, slot_offset, prob,
                   alias, negs_in, negs, keys1, d1, d0, compute_loss, part, vec};
  const int blocks = w2v_pair_parts(B, d);
  if (blocks > 0) {
    if (wide) {
      pair_step_wide<<<blocks, kThreads, 0, st>>>(a);
    } else {
      switch (lanes) {
        case 1: launch_group<1>(a, V4, blocks, st); break;
        case 2: launch_group<2>(a, V4, blocks, st); break;
        case 4: launch_group<4>(a, V4, blocks, st); break;
        case 8: launch_group<8>(a, V4, blocks, st); break;
        case 16: launch_group<16>(a, V4, blocks, st); break;
        default: launch_group<32>(a, V4, blocks, st); break;
      }
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  sum_parts<<<1, 32, 0, st>>>(part, blocks, out);
  return (int)cudaGetLastError();
}
