// K13: the eALS dimension sweep (He et al., SIGIR 2016; eals.cc:202-236) on
// the rows of one batch of table X against the fixed side Y.  For each row x,
// over its entries (col c, value v, negative weight C_e), w = 1 + alpha v and
// the dimensions in order (Gauss-Seidel: dimension t reads the row's updated
// dimensions before it), with the row's residuals vhat_e = x . y_c:
//   vf_e = vhat_e - x_t y_ct
//   num = sum (w v - (w - C_e) vf_e) y_ct - c_row (x . S[:, t] - x_t S_tt)
//   den = sum (w - C_e) y_ct^2 + c_row S_tt + reg
//   x_t = num / den,  vhat_e = vf_e + x_t y_ct.
// The user pass (item_axis 0) takes c_row = 1 and C_e = C[c] (the item
// weights at the fixed side's positions); the item pass takes c_row = C_e =
// C[row].  Modes:
//  0 range: rows row_start .. + B of the permuted table, entries cols/vals
//    (B x L) masked by lens;
//  1 segment: one head row per rows[r] (rows past the table dropped), its
//    chunks chunk_ptr[r] .. chunk_ptr[r + 1] of cols/vals (Nc x Cw) with
//    chunk_lens;
//  2 rows: every row r of X with entries indptr[r] .. indptr[r + 1] of
//    cols/vals and the carried residuals vhat (read and updated).
//
// Replaces buffalo_tpu/ops/eals_kernels.py _eals_dim_sweep (:71),
// _eals_segment_sweep (:115), _eals_apply_batch (:165), _eals_apply_group
// (:207), eals_group_step (:225) and eals_epoch's batch loops (:310), and
// eals_half_epoch (:24).
//
// Two forms.
//
// The Gram form (eals_gram_sweep: range and segment modes, d <= kGramMaxD =
// 128).  The residuals only carry sum_e (w - C_e) vhat_e y_et = (G x)_t from
// one dimension to the next, so the d steps above are exactly one forward
// Gauss-Seidel sweep on the row's normal equations A x = b,
//   A = F^T diag(w - C_e) F + c_row S^T + reg I,   b = F^T (w v),
// with F the row's gathered fixed-side rows: x_new = (L_A + D_A)^-1 (b - U_A
// x_old), a lower-triangular solve that touches no entry.  Per row the
// kernel gathers F through a cp.async ring (K2's plan, csrc/mma_tf32.cuh),
// forms G | b on the tensor cores (mma.sync m16n8k8, 3xTF32 at float32
// accuracy: plain TF32 would not hold the sweep's tolerance) over the upper
// block triangle plus b's column (column d of the B operand carries w v in
// place of the weighted row), mirrors it into shared memory, adds c_row S^T
// and reg, and runs the sweep there on one warp: r = b - U_A x_old (a
// thread per row of A), then for t = 0 .. d - 1, x_t = r_t / A_tt and every
// later r_k -= A_kt x_t (lanes on k, a fixed order).  A range row of at
// most kPiece = 2,048 entries is one block (gram_sweep_range).  Longer range
// rows and every segment chunk are cut into pieces of at least 1,024
// entries, enough of them for ~4 blocks an SM, one block each
// (gram_pieces) writing the piece's G | b into the workspace;
// then one block per row (gram_sweep_rows) adds its pieces in order (chunk
// by chunk) and sweeps: K2's als_normal_equations_chunks +
// als_segment_reduce_kernel pattern, so a head row of a million entries
// spreads over the card, with no float atomics and the same bits at every
// launch.  What bounds it on the card: per entry the d floats of F
// gathered (from L2: P is 22 MB, Q 4.3 MB at ML-20M, d = 40) and ~d^2 / 2
// tensor-core products (x3 for the split) with their fragment loads and
// splits, which the instruction rate sets; per row the d sequential steps of the
// sweep (one division, one shuffle and d / 32 products each), which the
// other blocks on the SM hide.  Warps split the tiles (and, where there are
// fewer tiles than warps, the k-steps).
//
// The sweep form (eals_sweep: every mode; the rows mode, and the range and
// segment modes past d = 128): the steps as written above.  One block per
// row (32 to 256 threads by the batch's row length), each thread owning the
// same strided entries in every dimension so that the residuals need no
// barrier, the row in shared memory, the two sums reduced in a fixed order
// (warp shuffles, then the warps in order) and the dense term x . S[:, t]
// by the first warp; S (d x d) is read from L1/L2; range mode keeps the
// residuals in shared memory, segment mode in the workspace vhat.  What
// bounds it: per dimension and entry one 4-byte gather of y_ct and ~8
// operations, the dimensions sequential within a row.  The row sits in a
// static shared array of kMaxD floats; wider rows take the wide
// instantiation, which keeps it in dynamic shared memory after the
// residuals.  The rows mode stays on this form: it carries the residuals
// in and out for eals_loss, which the Gram form never forms.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxD = 256, kMaxWarps = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

struct Batch {
  int mode, num_rows, d, item_axis;
  float alpha, reg;
  const float* Y;
  const float* S;
  const float* C;
  int row_start, L;           // range
  const int32_t* lens;        // range, segment
  const int32_t* rows;        // segment
  const int32_t* chunk_ptr;   // segment
  const int32_t* chunk_lens;  // segment
  int Cw;                     // segment
  const int64_t* indptr;      // rows
  const int32_t* cols;
  const float* vals;
  float* vhat;                // segment, rows
};

// The entry segments of block b: (table row, c_row, segment count); segment
// s is entries [base, base + len) of cols/vals with residuals at res + i.
struct Row {
  int64_t row;
  float c_row;
  int nseg;
};

__device__ __forceinline__ Row row_of(const Batch& a, int b) {
  Row r;
  if (a.mode == 0) {
    r.row = a.row_start + b;
    r.nseg = 1;
  } else if (a.mode == 1) {
    r.row = a.rows[b];
    r.nseg = a.chunk_ptr[b + 1] - a.chunk_ptr[b];
  } else {
    r.row = b;
    r.nseg = 1;
  }
  r.c_row = 1.f;
  if (a.item_axis) {
    const bool real = a.mode != 1 || a.lens[b] > 0;
    r.c_row = real && r.row < a.num_rows ? a.C[r.row] : 0.f;
  }
  return r;
}

__device__ __forceinline__ void segment(const Batch& a, int b, int s, float* vsh, int64_t& base,
                                        int& len, float*& res) {
  if (a.mode == 0) {
    base = (int64_t)b * a.L;
    len = a.lens[b];
    res = vsh;
  } else if (a.mode == 1) {
    const int ch = a.chunk_ptr[b] + s;
    base = (int64_t)ch * a.Cw;
    len = a.chunk_lens[ch];
    res = a.vhat + base;
  } else {
    base = a.indptr[b];
    len = (int)(a.indptr[b + 1] - base);
    res = a.vhat + base;
  }
}

template <bool kWide>
__global__ void __launch_bounds__(32 * kMaxWarps)
sweep_kernel(Batch a, float* __restrict__ X) {
  extern __shared__ float vsh[];  // range mode: the row's residuals
  __shared__ float xs_static[kWide ? 1 : kMaxD];
  __shared__ float red[2 * kMaxWarps];
  float* xs = kWide ? vsh + (a.mode == 0 ? a.L : 0) : xs_static;
  const int b = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
  const Row r = row_of(a, b);
  if (r.row >= a.num_rows) return;  // a dropped (padding) row
  const int d = a.d;
  for (int c = tid; c < d; c += T) xs[c] = X[r.row * d + c];
  __syncthreads();
  const bool item = a.item_axis;
  const float* __restrict__ Y = a.Y;
  if (a.mode != 2) {  // the residuals of the row's current factors
    for (int s = 0; s < r.nseg; ++s) {
      int64_t base;
      int len;
      float* res;
      segment(a, b, s, vsh, base, len, res);
      for (int i = tid; i < len; i += T) {
        const float* y = Y + (int64_t)a.cols[base + i] * d;
        float acc = 0.f;
        for (int k = 0; k < d; ++k) acc = fmaf(xs[k], y[k], acc);
        res[i] = acc;
      }
    }
  }
  for (int t = 0; t < d; ++t) {
    const float xt = xs[t];
    float num = 0.f, den = 0.f;
    for (int s = 0; s < r.nseg; ++s) {
      int64_t base;
      int len;
      float* res;
      segment(a, b, s, vsh, base, len, res);
      for (int i = tid; i < len; i += T) {
        const int col = a.cols[base + i];
        const float v = a.vals[base + i];
        const float y = Y[(int64_t)col * d + t];
        const float w = 1.f + a.alpha * v;
        const float wmc = w - (item ? r.c_row : a.C[col]);
        const float vf = res[i] - xt * y;
        num += (w * v - wmc * vf) * y;
        den += wmc * y * y;
      }
    }
    num = warp_sum(num);
    den = warp_sum(den);
    if (lane == 0) {
      red[2 * warp] = num;
      red[2 * warp + 1] = den;
    }
    __syncthreads();
    if (warp == 0) {
      float dense = 0.f;
      for (int k = lane; k < d; k += 32) dense = fmaf(xs[k], a.S[k * d + t], dense);
      dense = warp_sum(dense);
      if (lane == 0) {
        float sn = 0.f, sd = 0.f;
        for (int w = 0; w < nwarps; ++w) {
          sn += red[2 * w];
          sd += red[2 * w + 1];
        }
        const float stt = a.S[t * d + t];
        dense -= xt * stt;
        xs[t] = (sn - r.c_row * dense) / (sd + r.c_row * stt + a.reg);
      }
    }
    __syncthreads();
    const float xn = xs[t];
    for (int s = 0; s < r.nseg; ++s) {
      int64_t base;
      int len;
      float* res;
      segment(a, b, s, vsh, base, len, res);
      for (int i = tid; i < len; i += T) {
        const float y = Y[(int64_t)a.cols[base + i] * d + t];
        res[i] = (res[i] - xt * y) + xn * y;
      }
    }
  }
  for (int c = tid; c < d; c += T) X[r.row * d + c] = xs[c];
}

// Threads per row for entries of length L per segment.
int threads_for(int L) { return L <= 64 ? 32 : L <= 256 ? 64 : L <= 1024 ? 128 : 256; }

// ------------------------------------------------------------- Gram form
constexpr int kGramMaxD = 128;
constexpr int kGThreads = 256, kGWarps = kGThreads / 32;
constexpr int kGTL = 64;      // entries per ring stage (8 MMA k-steps)
constexpr int kGStages = 2;   // ring depth
constexpr int kGFlush = 4;    // stages summed in registers between flushes
constexpr int kPiece = 2048;  // a range row past this is cut into pieces, as every
                              // segment chunk, each over its own block
constexpr int kMinPiece = 1024;     // entries of a piece at least (unless the unit is shorter)
constexpr int kPieceBlocks = 528;   // blocks a batch of pieces aims at (4 an SM)

struct Gram {
  int num_rows, d, item_axis;
  float alpha, reg;
  const float* Y;
  const float* S;
  const float* C;
  int row_start, L;           // range
  const int32_t* lens;        // range: per row; segment: per head row
  const int32_t* rows;        // segment
  const int32_t* chunk_ptr;   // segment
  const int32_t* chunk_lens;  // segment
  int R, Cw;                  // segment
  const int32_t* cols;
  const float* vals;
  float* work;                // pieces: each piece's G | b, d x SA
  int seg;                    // segment mode
  int PPU, PL;                // pieces per unit (a range row, or a chunk), entries each
  // tiling (set by the launcher)
  int NTn;  // n8 tiles across the d + 1 columns of G | b
  int NT;   // tiles of the upper block triangle (b's column included)
  int FS;   // ring row stride, 8 or 24 (mod 32) words: conflict-free fragments
  int SA;   // the system's row stride, odd: conflict-free column reads
  int EG;   // entry groups: warp w takes the k-steps w % EG (mod EG)
  int vec;  // 16-byte copies (d a multiple of 4)
  int nchunk;  // copies per entry row
  int ring;    // floats of the ring, at least d SA (the system reuses it)
};

// (m16 row, n8 column) of tile `tile` of the upper block triangle, row-major:
// row mi holds the tiles ni = 2 mi .. NTn - 1
__device__ __forceinline__ void gram_tile(int tile, int NTn, int& mi, int& ni) {
  mi = 0;
  while (tile >= NTn - 2 * mi) tile -= NTn - 2 * mi++;
  ni = 2 * mi + tile;
}

// G | b of the n entries from `base` of cols / vals into As (d x SA in
// shared memory, which reuses the ring): G = F^T diag(w - C_e) F mirrored
// from its upper triangle, b = F^T (w v) in column d.  C_e = c_row in the
// item pass.  Every thread of the block calls it.
template <int kTPW>
__device__ __forceinline__ void gram_body(const Gram& p, float* smem, int64_t base, int n,
                                          float c_row) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = p.d, FS = p.FS, SA = p.SA;
  float* Fs = smem;                                                 // [kGStages][kGTL][FS]
  float* vs = smem + p.ring;                                        // [kGStages][kGTL]
  float* ce = vs + kGStages * kGTL;                                 // [kGStages][kGTL]
  int32_t* cs = reinterpret_cast<int32_t*>(ce + kGStages * kGTL);  // [kGStages][kGTL]
  float* tot = reinterpret_cast<float*>(cs + kGStages * kGTL);     // [EG][NT][128]

  // columns past d, never written by the gather, stay zero
  const int extra = FS - d;
  for (int i = tid; i < kGStages * kGTL * extra; i += kGThreads) {
    const int r = i / extra;
    Fs[r * FS + d + (i - r * extra)] = 0.f;
  }
  for (int i = tid; i < p.EG * p.NT * 128; i += kGThreads) tot[i] = 0.f;

  const int32_t* cb = p.cols + base;
  const float* vb = p.vals + base;
  const int ntiles = (n + kGTL - 1) / kGTL;
  auto col_of = [&](int tile) {
    const int e = tile * kGTL + tid;
    return (tid < kGTL && e < n) ? __ldg(cb + e) : -1;
  };
  // cp.async the rows, values (and in the user pass the C_e) of `tile` into
  // its stage, zeros past n; every call commits one group, empty past the
  // last tile
  const int W = p.vec ? 4 : 1, ncopy = kGTL * p.nchunk;
  auto fetch = [&](int tile) {
    if (tile < ntiles) {
      const int st = tile % kGStages;
      float* Fst = Fs + st * kGTL * FS;
      const int32_t* cst = cs + st * kGTL;
      for (int q = tid; q < ncopy; q += kGThreads) {
        const int l = q / p.nchunk, c = (q - l * p.nchunk) * W;
        const int col = cst[l];
        const float* from = col >= 0 ? p.Y + (int64_t)col * d + c : p.Y;
        if (p.vec) cp_async16_l1(Fst + l * FS + c, from, col >= 0);
        else cp_async4(Fst + l * FS + c, from, col >= 0);
      }
      if (tid < kGTL) {
        const int e = tile * kGTL + tid;
        cp_async4(vs + st * kGTL + tid, e < n ? vb + e : vb, e < n);
        if (!p.item_axis) {
          const int col = cst[tid];
          cp_async4(ce + st * kGTL + tid, col >= 0 ? p.C + col : p.C, col >= 0);
        }
      }
    }
    cp_async_commit();
  };

  // this warp's tiles (a run of kTPW from t0) and k-steps
  const int eg = warp % p.EG, t0 = (warp / p.EG) * kTPW;
  const int g = lane >> 2, t = lane & 3;
  int aoff[kTPW], boff[kTPW];
  bool on[kTPW], isb[kTPW];  // isb: this lane's B column is b's (d)
#pragma unroll
  for (int u = 0; u < kTPW; ++u) {
    int mi = 0, ni = 0;
    on[u] = t0 + u < p.NT;
    if (on[u]) gram_tile(t0 + u, p.NTn, mi, ni);
    aoff[u] = mi * 16;
    boff[u] = ni * 8;
    isb[u] = ni * 8 + g == d;
  }
  float acc[kTPW][4];
#pragma unroll
  for (int u = 0; u < kTPW; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
  auto flush = [&]() {
#pragma unroll
    for (int u = 0; u < kTPW; ++u) {
      if (on[u]) {
        float4* to = reinterpret_cast<float4*>(tot + ((eg * p.NT + t0 + u) * 128 + lane * 4));
        float4 v = *to;
        v.x += acc[u][0]; v.y += acc[u][1]; v.z += acc[u][2]; v.w += acc[u][3];
        *to = v;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
    }
  };

  for (int s = 0; s < kGStages; ++s)
    if (tid < kGTL) cs[s * kGTL + tid] = col_of(s);
  int col_next = col_of(kGStages);
  __syncthreads();
  for (int s = 0; s < kGStages - 1; ++s) fetch(s);
  const bool item = p.item_axis;
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kGStages - 2>();  // this thread's copies of tile i landed
    __syncthreads();                // everyone's did; stage i - 1 is consumed
    fetch(i + kGStages - 1);
    if (tid < kGTL) cs[(i % kGStages) * kGTL + tid] = col_next;  // tile i + kGStages
    col_next = col_of(i + kGStages + 1);

    const int st = i % kGStages, tl = min(kGTL, n - i * kGTL);
    const float* Fst = Fs + st * kGTL * FS;
    const float* vst = vs + st * kGTL;
    const float* cst = ce + st * kGTL;
    for (int ks = eg; ks * 8 < tl; ks += p.EG) {
      const int l0 = ks * 8;
      // the lane's two entries: weights w - C_e (G) and w v (b's column);
      // entries past n were zero-filled, rows and values
      const float v0 = vst[l0 + t], v1 = vst[l0 + t + 4];
      const float w0 = 1.f + p.alpha * v0, w1 = 1.f + p.alpha * v1;
      const float m0 = w0 - (item ? c_row : cst[l0 + t]);
      const float m1 = w1 - (item ? c_row : cst[l0 + t + 4]);
      const float q0 = w0 * v0, q1 = w1 * v1;
      const float* r0 = Fst + (l0 + t) * FS + g;  // entry l0 + t, feature g
      const float* r1 = r0 + 4 * FS;               // entry l0 + t + 4
#pragma unroll
      for (int u = 0; u < kTPW; ++u) {
        if (!on[u]) continue;
        // A operand: features (rows of G) x entries; B: entries x columns
        uint32_t ab[4], as[4], bb[2], bs[2];
        split_tf32(r0[aoff[u]], ab[0], as[0]);
        split_tf32(r0[aoff[u] + 8], ab[1], as[1]);
        split_tf32(r1[aoff[u]], ab[2], as[2]);
        split_tf32(r1[aoff[u] + 8], ab[3], as[3]);
        split_tf32(isb[u] ? q0 : m0 * r0[boff[u]], bb[0], bs[0]);
        split_tf32(isb[u] ? q1 : m1 * r1[boff[u]], bb[1], bs[1]);
        // the k-step's sum from 0, added to the registers in float32
        float step[4];
        mma_tf32_first(step, as, bb);
        mma_tf32(step, ab, bs);
        mma_tf32(step, ab, bb);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][e] += step[e];
      }
    }
    if ((i + 1) % kGFlush == 0) flush();
  }
  flush();
  cp_async_wait<0>();
  __syncthreads();

  // entry groups added in group order, G mirrored from its upper triangle
  // into As (the ring's space), b into column d
  float* As = smem;
  for (int lt = warp; lt < p.NT; lt += kGWarps) {
    int mi, ni;
    gram_tile(lt, p.NTn, mi, ni);
    float4 v = *reinterpret_cast<const float4*>(tot + lt * 128 + lane * 4);
    for (int gg = 1; gg < p.EG; ++gg) {
      const float4 w = *reinterpret_cast<const float4*>(tot + (gg * p.NT + lt) * 128 + lane * 4);
      v.x += w.x; v.y += w.y; v.z += w.z; v.w += w.w;
    }
    const float vr[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = mi * 16 + g + (r >= 2 ? 8 : 0), k = ni * 8 + 2 * t + (r & 1);
      if (m >= d || k > d || m > k) continue;
      As[m * SA + k] = vr[r];
      if (k < d) As[k * SA + m] = vr[r];
    }
  }
  __syncthreads();
}

// A = G + c_row S^T + reg I in As, then one forward Gauss-Seidel sweep of
// X's row: r = b - U_A x_old and 1 / A_tt (a thread per row of A), then on
// one warp, for t = 0 .. d - 1, x_t = r_t (1 / A_tt) and r_k -= A_kt x_t
// for every k > t (lane k mod 32); the row written back.  Every thread of
// the block calls it; xs holds 3 d floats.
__device__ __forceinline__ void gram_sweep_row(const Gram& p, float* As, float* xs,
                                               int64_t row, float c_row, float* __restrict__ X) {
  float* rs = xs + p.d;
  float* inv = rs + p.d;
  const int d = p.d, SA = p.SA, tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < d * d; i += kGThreads) {
    const int r = i / d, k = i - r * d;
    As[r * SA + k] += c_row * p.S[k * d + r] + (r == k ? p.reg : 0.f);
  }
  for (int k = tid; k < d; k += kGThreads) xs[k] = X[row * d + k];
  __syncthreads();
  for (int r = tid; r < d; r += kGThreads) {
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < d; ++k) acc = fmaf(k > r ? As[r * SA + k] : 0.f, xs[k], acc);
    rs[r] = As[r * SA + d] - acc;
    inv[r] = 1.f / As[r * SA + r];
  }
  __syncthreads();
  if (tid < 32) {
    float rr[4];  // r_k for k = lane + 32 h (d <= 128)
#pragma unroll
    for (int h = 0; h < 4; ++h) rr[h] = lane + 32 * h < d ? rs[lane + 32 * h] : 0.f;
#pragma unroll
    for (int h = 0; h < 4; ++h) {  // t = 32 h + tt: r_t sits in rr[h] of lane tt
      if (32 * h >= d) break;
#pragma unroll 8
      for (int tt = 0; tt < 32; ++tt) {
        const int t = 32 * h + tt;
        if (t >= d) break;
        const float xt = __shfl_sync(kFull, rr[h], tt) * inv[t];
#pragma unroll
        for (int hh = h; hh < 4; ++hh) {
          const int k = lane + 32 * hh;
          if (k > t && k < d) rr[hh] = fmaf(-As[k * SA + t], xt, rr[hh]);
        }
        if (lane == tt) xs[t] = xt;
      }
    }
    __syncwarp();
    for (int k = lane; k < d; k += 32) X[row * d + k] = xs[k];
  }
}

// The block's unit u (a range row, or a segment chunk): its first entry,
// length, table row and item-pass weight c_row; false for a padding chunk
// or one of a dropped row.
__device__ __forceinline__ bool gram_unit(const Gram& p, int u, int64_t& base, int& len,
                                          int64_t& row, float& c_row) {
  if (!p.seg) {
    row = p.row_start + u;
    base = (int64_t)u * p.L;
    len = p.lens[u];
    c_row = p.item_axis ? p.C[row] : 1.f;
    return true;
  }
  int lo = 0, hi = p.R;  // the row owning chunk u: the last r with chunk_ptr[r] <= u
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (p.chunk_ptr[mid] <= u) lo = mid; else hi = mid - 1;
  }
  row = lo < p.R ? p.rows[lo] : -1;
  base = (int64_t)u * p.Cw;
  len = p.chunk_lens[u];
  c_row = p.item_axis && lo < p.R && p.lens[lo] > 0 && row >= 0 && row < p.num_rows
              ? p.C[row] : 0.f;
  return u < p.chunk_ptr[p.R] && row >= 0 && row < p.num_rows;
}

// range mode, rows up to kPiece entries: one block per row of the batch
template <int kTPW>
__global__ void __launch_bounds__(kGThreads) gram_sweep_range(Gram p, float* __restrict__ X) {
  extern __shared__ __align__(16) float smem[];
  int64_t base, row;
  int len;
  float c_row;
  gram_unit(p, blockIdx.x, base, len, row, c_row);
  gram_body<kTPW>(p, smem, base, len, c_row);
  gram_sweep_row(p, smem, smem + p.ring, row, c_row, X);
}

// longer range rows and segment chunks, first launch: one block per piece
// (PL entries of a unit), its G | b into the workspace (d x SA floats
// per piece); pieces past a unit's length, padding chunks and the chunks
// of dropped rows write nothing and are never read
template <int kTPW>
__global__ void __launch_bounds__(kGThreads) gram_pieces(Gram p) {
  extern __shared__ __align__(16) float smem[];
  const int u = blockIdx.x / p.PPU, piece = blockIdx.x - u * p.PPU;
  int64_t base, row;
  int len;
  float c_row;
  if (!gram_unit(p, u, base, len, row, c_row) || piece * p.PL >= len) return;
  gram_body<kTPW>(p, smem, base + piece * p.PL, min(p.PL, len - piece * p.PL), c_row);
  float* out = p.work + (int64_t)blockIdx.x * p.d * p.SA;
  for (int i = threadIdx.x; i < p.d * p.SA; i += kGThreads)
    out[i] = i % p.SA <= p.d ? smem[i] : 0.f;
}

// second launch: one block per row, its units' pieces added in order, then
// the sweep; segment rows past the table dropped
__global__ void __launch_bounds__(kGThreads) gram_sweep_rows(Gram p, float* __restrict__ X) {
  extern __shared__ __align__(16) float smem[];
  const int r = blockIdx.x, d = p.d, SA = p.SA;
  int64_t row;
  int u0, u1;
  float c_row;
  if (p.seg) {
    row = p.rows[r];
    if (row < 0 || row >= p.num_rows) return;
    u0 = p.chunk_ptr[r];
    u1 = p.chunk_ptr[r + 1];
    c_row = p.item_axis ? (p.lens[r] > 0 ? p.C[row] : 0.f) : 1.f;
  } else {
    row = p.row_start + r;
    u0 = r;
    u1 = r + 1;
    c_row = p.item_axis ? p.C[row] : 1.f;
  }
  // each thread's kE elements of G | b at a time, the pieces in order,
  // kU pieces' loads in flight before their adds: a head row's hundreds of
  // pieces cost their count / kU in load latencies, not d SA times that
  constexpr int kE = 8, kU = 4;
  const int64_t stride = (int64_t)d * SA;
  for (int i0 = threadIdx.x; i0 < d * SA; i0 += kE * kGThreads) {
    float acc[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[e] = 0.f;
    for (int u = u0; u < u1; ++u) {
      const int len = p.seg ? p.chunk_lens[u] : p.lens[u];
      const int np = (len + p.PL - 1) / p.PL;
      const float* w = p.work + (int64_t)u * p.PPU * stride + i0;
      for (int piece = 0; piece < np; piece += kU, w += kU * stride) {
        float v[kU][kE];
#pragma unroll
        for (int j = 0; j < kU; ++j)
#pragma unroll
          for (int e = 0; e < kE; ++e)
            v[j][e] = piece + j < np && i0 + e * kGThreads < d * SA
                          ? w[j * stride + e * kGThreads] : 0.f;
#pragma unroll
        for (int j = 0; j < kU; ++j)
#pragma unroll
          for (int e = 0; e < kE; ++e) acc[e] += v[j][e];
      }
    }
#pragma unroll
    for (int e = 0; e < kE; ++e)
      if (i0 + e * kGThreads < d * SA) smem[i0 + e * kGThreads] = acc[e];
  }
  __syncthreads();
  gram_sweep_row(p, smem, smem + d * SA, row, c_row, X);
}

struct GramPlan {
  int NTn, NT, FS, SA, EG, TPW, ring;
  size_t smem;
};

GramPlan gram_plan(int d) {
  GramPlan g;
  g.NTn = (d + 1 + 7) / 8;
  const int MT = (d + 15) / 16;
  g.NT = 0;
  for (int mi = 0; mi < MT; ++mi) g.NT += g.NTn - 2 * mi;
  // teams of warps split the tiles, entry groups the k-steps (where there
  // are fewer tiles than warps)
  const int teams = g.NT >= 8 ? 8 : g.NT >= 4 ? 4 : g.NT >= 2 ? 2 : 1;
  g.EG = kGWarps / teams;
  g.TPW = (g.NT + teams - 1) / teams;
  g.FS = max(16 * MT, 8 * g.NTn);
  while (g.FS % 32 != 8 && g.FS % 32 != 24) g.FS += 8;
  g.SA = (d + 1) % 2 ? d + 1 : d + 2;
  g.ring = (max(kGStages * kGTL * g.FS, d * g.SA) + 3) / 4 * 4;  // tot stays 16-byte aligned
  // the sweep's 3 d floats reuse the stage arrays (3 kGStages kGTL >= 3 d)
  g.smem = sizeof(float) * ((size_t)g.ring + 3 * kGStages * kGTL + (size_t)g.EG * g.NT * 128);
  return g;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel k, size_t smem) {
  return smem > 48 * 1024 ? cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem)
                          : cudaSuccess;
}

// the kernels of each run length kTPW (1, 2, 3, 4, 6, 10 tiles a warp)
template <int kTPW>
cudaError_t launch_gram(bool pieces, const Gram& p, int blocks, size_t smem, float* X,
                        cudaStream_t st) {
  cudaError_t e;
  if (!pieces) {
    if ((e = allow_smem(gram_sweep_range<kTPW>, smem)) != cudaSuccess) return e;
    gram_sweep_range<kTPW><<<blocks, kGThreads, smem, st>>>(p, X);
  } else {
    if ((e = allow_smem(gram_pieces<kTPW>, smem)) != cudaSuccess) return e;
    gram_pieces<kTPW><<<blocks, kGThreads, smem, st>>>(p);
  }
  return cudaGetLastError();
}

// (pieces per unit, entries per piece) of `units` units of `width`
// entries: (0, 0) when a range row fits one block; else pieces of at least
// kMinPiece entries (a multiple of the ring's stage), as many as bring the
// batch to kPieceBlocks blocks
void pieces_of(int mode, int units, int width, int& PPU, int& PL) {
  PPU = PL = 0;
  if (mode == 0 && width <= kPiece) return;
  PPU = max(1, min((width + kMinPiece - 1) / kMinPiece, (kPieceBlocks + units - 1) / units));
  PL = ((width + PPU - 1) / PPU + kGTL - 1) / kGTL * kGTL;
  PPU = (width + PL - 1) / PL;
}

}  // namespace

// 1 when rows of d floats take the wide instantiation.
extern "C" int eals_sweep_wide(int d) { return d > kMaxD ? 1 : 0; }

// mode 0 (range): row_start, B rows, L, lens, cols/vals (B x L); mode 1
// (segment): R rows, rows, lens, chunk_ptr (R + 1), chunk_lens, cols/vals (Nc x
// Cw), vhat workspace (Nc x Cw); mode 2 (rows): num_rows rows, indptr, cols/vals
// (nnz), vhat (nnz, carried).  C is indexed by the fixed side's column (user
// pass) or by X's own row (item pass).
extern "C" int eals_sweep(int mode, float* X, int num_rows, const float* Y, int d, const float* S,
                          const float* C, int item_axis, float alpha, float reg, int row_start,
                          int B, int L, const int32_t* lens, const int32_t* rows, int R,
                          const int32_t* chunk_ptr, const int32_t* chunk_lens, int Cw,
                          const int64_t* indptr, const int32_t* cols, const float* vals,
                          float* vhat, void* stream) {
  if (mode < 0 || mode > 2 || d < 1 || num_rows < 0 || (mode == 0 && L > 8192) ||
      (mode != 0 && !vhat))
    return (int)cudaErrorInvalidValue;
  const int blocks = mode == 0 ? B : mode == 1 ? R : num_rows;
  if (blocks <= 0) return 0;
  Batch a{mode, num_rows, d, item_axis, alpha, reg, Y, S, C, row_start, L, lens, rows, chunk_ptr,
          chunk_lens, Cw, indptr, cols, vals, vhat};
  const int T = threads_for(mode == 0 ? L : mode == 1 ? Cw : 128);
  const size_t smem = mode == 0 ? sizeof(float) * (size_t)L : 0;
  if (eals_sweep_wide(d)) {
    const size_t wide_smem = smem + sizeof(float) * (size_t)d;
    if (wide_smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          sweep_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wide_smem);
      if (err != cudaSuccess) return (int)err;
    }
    sweep_kernel<true><<<blocks, T, wide_smem, (cudaStream_t)stream>>>(a, X);
  } else {
    sweep_kernel<false><<<blocks, T, smem, (cudaStream_t)stream>>>(a, X);
  }
  return (int)cudaGetLastError();
}

// The Gram form's widest rows (floats).
extern "C" int eals_gram_max_d() { return kGramMaxD; }

// Floats of the Gram form's workspace: a d x SA partial per piece of each
// of `units` units of `width` entries (range rows past kPiece, or segment
// chunks; pieces_of); 0 when none is needed, -1 past 2^31 - 1.
extern "C" int eals_gram_workspace(int mode, int units, int width, int d) {
  if (units < 1 || width < 1 || d < 1 || d > kGramMaxD) return 0;
  int PPU, PL;
  pieces_of(mode, units, width, PPU, PL);
  const long long n = (long long)units * PPU * d * gram_plan(d).SA;
  return n > 2147483647LL ? -1 : (int)n;
}

// The Gram form: mode 0 (range): row_start, B rows, L, lens, cols/vals (B x
// L); mode 1 (segment): R head rows, rows, lens, chunk_ptr (R + 1),
// chunk_lens, cols/vals (Nc x Cw); work: eals_gram_workspace(mode, B or Nc,
// L or Cw, d) floats.  C is indexed by the fixed side's column (user pass)
// or by X's own row (item pass).
extern "C" int eals_gram_sweep(int mode, float* X, int num_rows, const float* Y, int d,
                               const float* S, const float* C, int item_axis, float alpha,
                               float reg, int row_start, int B, int L, const int32_t* lens,
                               const int32_t* rows, int R, const int32_t* chunk_ptr,
                               const int32_t* chunk_lens, int Cw, int Nc, const int32_t* cols,
                               const float* vals, float* work, void* stream) {
  if (mode < 0 || mode > 1 || d < 1 || d > kGramMaxD || num_rows < 0)
    return (int)cudaErrorInvalidValue;
  const int units = mode == 0 ? B : Nc, width = mode == 0 ? L : Cw;
  if (units <= 0 || width <= 0 || (mode == 1 && R <= 0)) return 0;
  int PPU, PL;
  pieces_of(mode, units, width, PPU, PL);
  if (PPU > 0 && !work) return (int)cudaErrorInvalidValue;
  const GramPlan g = gram_plan(d);
  const int vec = d % 4 == 0 && ((uintptr_t)Y & 15) == 0 ? 1 : 0;
  Gram p{num_rows, d, item_axis, alpha, reg, Y, S, C, row_start, L, lens, rows, chunk_ptr,
         chunk_lens, R, Cw, cols, vals, work, mode, PPU, PL, g.NTn, g.NT, g.FS, g.SA, g.EG, vec,
         vec ? d / 4 : d, g.ring};
  const cudaStream_t st = (cudaStream_t)stream;
  const bool pieces = PPU > 0;
  const int blocks = pieces ? units * PPU : units;
  cudaError_t e;
  if (g.TPW <= 1) e = launch_gram<1>(pieces, p, blocks, g.smem, X, st);
  else if (g.TPW <= 2) e = launch_gram<2>(pieces, p, blocks, g.smem, X, st);
  else if (g.TPW <= 3) e = launch_gram<3>(pieces, p, blocks, g.smem, X, st);
  else if (g.TPW <= 4) e = launch_gram<4>(pieces, p, blocks, g.smem, X, st);
  else if (g.TPW <= 6) e = launch_gram<6>(pieces, p, blocks, g.smem, X, st);
  else e = launch_gram<10>(pieces, p, blocks, g.smem, X, st);
  if (e != cudaSuccess || !pieces) return (int)e;
  const size_t smem = sizeof(float) * ((size_t)d * g.SA + 3 * d);
  if ((e = allow_smem(gram_sweep_rows, smem)) != cudaSuccess) return (int)e;
  gram_sweep_rows<<<mode == 0 ? B : R, kGThreads, smem, st>>>(p, X);
  return (int)cudaGetLastError();
}
