// K18: CoFactor's closed-form bias after the solve.  For batch row b with
// entries on either side (total[b] > 0) and table row rows[b] inside X, x =
// X[rows[b]] is the row K3 has just written; over its explicit entries
// (column col, value v, gathered row c):
//   bias[rows[b]] = sum (v - x . c - cbias[col]) / (len + 1e-10),
// written whatever len is (0 for a row without explicit entries); and, when
// asked (the user phase), loss[b] += reg_new |x|^2.
//
// Replaces buffalo_tpu/ops/cfr_kernels.py the bias and masked write of
// _cfr_item_body (:146-154), _cfr_context_body (:584-593) and the segment
// bodies' ends (:270-281, :314-322), and _cfr_user_body's loss (:73).
//
// What bounds it on the card: bytes, one gathered row of d floats per
// explicit entry (mostly from L2) and 8 bytes of ids and values, ~2 d
// operations.  Design (rows up to 128 floats): the work is cut by entries,
// not by rows.  A warp takes one piece of at most `piece` entries of a
// padded row or of a segment chunk (the grid: rows or chunks x pieces per
// row or chunk, sized by the caller; pieces past a row's entries exit at
// once), so a launch of a few long rows still fills the card.  The warp
// reads a piece 32 entries at a time: ids, values and cbias[col] by one
// coalesced load each, then teams of lanes take the entries (a lane per
// float4 of the row, at most kMaxLanes: 8 at d = 32, wider rows 2 to 4
// float4s a lane), each lane holding x as float4s and reading its float4s
// of every entry's row (16-byte loads, all of a team's rows in flight
// before its dots), each dot a fixed xor sum over the team.  The residuals are summed in double in a
// fixed order.  A row that fits one piece writes its bias at once; a longer
// row's pieces write their double sums to `part`, and a second launch adds
// each row's pieces in piece order and writes the bias: no atomics, two
// launches are bitwise equal.  The loss term is a launch of its own (a warp
// per row).  Rows past 128 floats take the wide form: a warp per row, the
// lanes over the columns, its chunks in order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kMaxD = 128;   // the narrow forms' widest row
constexpr int kInFlight = 8; // float4 row loads a lane keeps in flight
constexpr int kMaxLanes = 8; // lanes an entry: one per float4, at most 8

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

struct Args {
  const float* X;
  int n, d;
  const int32_t* rows;
  int R;
  const int32_t* total;
  const float* F;
  const int32_t* lens;
  const int32_t* chunk_ptr;
  const int32_t* chunk_lens;
  const int32_t* cols;
  const float* vals;
  int L;
  const float* cbias;
  float* bias;
  float reg_new;
  float* loss;
  int piece, ppr;  // entries per piece, pieces per padded row or chunk
  int64_t pieces;  // the grid's pieces: rows or chunks x ppr
  double* part;    // one double per piece, where rows span pieces
  bool vec;        // rows as aligned float4s (d % 4 == 0)
};

__device__ __forceinline__ bool writes(const Args& g, int b, int& row) {
  row = g.rows[b];
  return g.total[b] > 0 && row >= 0 && row < g.n;
}

// True when row b's bias is one piece's sum (written by that piece).
__device__ __forceinline__ bool one_piece(const Args& g, int b) {
  if (!g.chunk_ptr) return g.lens[b] <= g.piece;
  const int c0 = g.chunk_ptr[b];
  return g.chunk_ptr[b + 1] - c0 == 1 && g.chunk_lens[c0] <= g.piece;
}

// Columns 4q .. 4q + 3 of a row (zeros past d).
__device__ __forceinline__ float4 ld4(const float* row, int q, int d, bool vec) {
  const int c = 4 * q;
  if (vec) return c < d ? __ldg(reinterpret_cast<const float4*>(row) + q)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 r;
  r.x = c < d ? __ldg(row + c) : 0.f;
  r.y = c + 1 < d ? __ldg(row + c + 1) : 0.f;
  r.z = c + 2 < d ? __ldg(row + c + 2) : 0.f;
  r.w = c + 3 < d ? __ldg(row + c + 3) : 0.f;
  return r;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float p) {
  p = fmaf(a.x, b.x, p);
  p = fmaf(a.y, b.y, p);
  p = fmaf(a.z, b.z, p);
  return fmaf(a.w, b.w, p);
}

// The user phase's loss term: a warp per row, the lanes over the columns.
__global__ void __launch_bounds__(kThreads) bias_kernel_loss(Args g) {
  const int lane = threadIdx.x & 31, b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  int row;
  if (b >= g.R || !writes(g, b, row)) return;
  const float* xr = g.X + (int64_t)row * g.d;
  float x2 = 0.f;
  for (int c = lane; c < g.d; c += 32) x2 = fmaf(xr[c], xr[c], x2);
  x2 = warp_sum(x2);
  if (lane == 0) g.loss[b] += g.reg_new * x2;
}

// One piece a warp: teams of G lanes, each lane holding V4 float4s of x
// (columns 4 (s + G u) .. + 3 for lane s of its team).
template <int G, int V4>
__global__ void __launch_bounds__(kThreads) bias_kernel_pieces(Args g) {
  constexpr int T = 32 / G;  // teams a warp
  constexpr int KB = G < kInFlight / V4 ? G : (kInFlight / V4 > 0 ? kInFlight / V4 : 1);
  const int lane = threadIdx.x & 31, t = lane / G, s = lane % G;
  const int64_t w = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= g.pieces) return;
  const int ch = (int)(w / g.ppr), j = (int)(w % g.ppr);
  int b = ch;
  if (g.chunk_ptr) {  // the chunk's row: chunk_ptr[b] <= ch < chunk_ptr[b + 1]
    if (ch >= g.chunk_ptr[g.R]) return;
    int lo = 0, hi = g.R;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (g.chunk_ptr[mid] <= ch) lo = mid;
      else hi = mid;
    }
    b = lo;
  }
  int row;
  if (!writes(g, b, row)) return;
  const int len = g.chunk_ptr ? g.chunk_lens[ch] : g.lens[b];
  const int e0 = j * g.piece;
  if (j > 0 && e0 >= len) return;  // piece 0 writes even a row without entries
  const int e1 = min(len, e0 + g.piece);
  const float* xr = g.X + (int64_t)row * g.d;
  float4 x[V4];
#pragma unroll
  for (int u = 0; u < V4; ++u) x[u] = ld4(xr, s + G * u, g.d, g.vec);
  const int32_t* cc = g.cols + (int64_t)ch * g.L;
  const float* vv = g.vals + (int64_t)ch * g.L;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  double sum = 0.0;
  for (int e = e0; e < e1; e += 32) {
    // lane (t, s) holds entry e + s T + t; team t's entry k is lane k's
    const int me = e + s * T + t;
    int col = 0;
    float v = 0.f, cb = 0.f;
    if (me < e1) {
      col = __ldg(cc + me);
      v = __ldg(vv + me);
      cb = __ldg(g.cbias + col);
    }
    float mine = 0.f;  // the dot of this lane's entry
#pragma unroll
    for (int k0 = 0; k0 < G; k0 += KB) {
      float4 f[KB][V4];
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        const int ck = __shfl_sync(kFull, col, k0 + k, G);
        const bool live = e + (k0 + k) * T + t < e1;
        const float* fr = g.F + (int64_t)ck * g.d;
#pragma unroll
        for (int u = 0; u < V4; ++u) f[k][u] = live ? ld4(fr, s + G * u, g.d, g.vec) : zero;
      }
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        float p = 0.f;
#pragma unroll
        for (int u = 0; u < V4; ++u) p = dot4(x[u], f[k][u], p);
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1) p += __shfl_xor_sync(kFull, p, o);
        if (s == k0 + k) mine = p;
      }
    }
    if (me < e1) sum += (double)(v - mine - cb);
  }
  sum = warp_sum_d(sum);
  if (lane != 0) return;
  if (one_piece(g, b)) g.bias[row] = (float)sum / ((float)g.lens[b] + 1e-10f);
  else g.part[w] = sum;
}

// The rows that span pieces: each row's pieces added in piece order (a
// thread per row).
__global__ void __launch_bounds__(kThreads) bias_finish(Args g) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  int row;
  if (b >= g.R || !writes(g, b, row) || one_piece(g, b)) return;
  int c0 = b, c1 = b + 1;
  if (g.chunk_ptr) {
    c0 = g.chunk_ptr[b];
    c1 = g.chunk_ptr[b + 1];
  }
  double sum = 0.0;
  for (int ch = c0; ch < c1; ++ch) {
    const int len = g.chunk_ptr ? g.chunk_lens[ch] : g.lens[b];
    const int np = len > g.piece ? (len + g.piece - 1) / g.piece : 1;
    for (int j = 0; j < np; ++j) sum += g.part[(int64_t)ch * g.ppr + j];
  }
  g.bias[row] = (float)sum / ((float)g.lens[b] + 1e-10f);
}

// Rows past kMaxD floats: a warp per row, the lanes over the columns, the
// row x read from global memory (L1) in the registers' column order for its
// norm and each entry's dot.
__global__ void __launch_bounds__(kThreads) bias_kernel_wide(Args g) {
  const int lane = threadIdx.x & 31, b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= g.R) return;
  const int row = g.rows[b];
  if (g.total[b] <= 0 || row < 0 || row >= g.n) return;
  const float* xr = g.X + (int64_t)row * g.d;
  if (g.loss) {
    float x2 = 0.f;
    for (int c = lane; c < g.d; c += 32) x2 = fmaf(xr[c], xr[c], x2);
    const float s = warp_sum(x2);
    if (lane == 0) g.loss[b] += g.reg_new * s;
  }
  if (!g.F) return;
  int c0 = b, c1 = b + 1;
  if (g.chunk_ptr) {
    c0 = g.chunk_ptr[b];
    c1 = g.chunk_ptr[b + 1];
  }
  double sum = 0.0;
  for (int ch = c0; ch < c1; ++ch) {
    const int len = g.chunk_ptr ? g.chunk_lens[ch] : g.lens[b];
    const int32_t* cc = g.cols + (int64_t)ch * g.L;
    const float* vv = g.vals + (int64_t)ch * g.L;
    for (int e = 0; e < len; ++e) {
      const int col = cc[e];
      const float* f = g.F + (int64_t)col * g.d;
      float part = 0.f;
      for (int c = lane; c < g.d; c += 32) part = fmaf(xr[c], __ldg(f + c), part);
      const float dot = warp_sum(part);
      if (lane == 0) sum += (double)(vv[e] - dot - g.cbias[col]);
    }
  }
  sum = warp_sum_d(sum);
  if (lane == 0) g.bias[row] = (float)sum / ((float)g.lens[b] + 1e-10f);
}

template <int G>
void launch_pieces(const Args& g, int V4, unsigned grid, cudaStream_t st) {
  if (V4 <= 1) bias_kernel_pieces<G, 1><<<grid, kThreads, 0, st>>>(g);
  else if (V4 <= 2) bias_kernel_pieces<G, 2><<<grid, kThreads, 0, st>>>(g);
  else if (V4 <= 4) bias_kernel_pieces<G, 4><<<grid, kThreads, 0, st>>>(g);
  else bias_kernel_pieces<G, 8><<<grid, kThreads, 0, st>>>(g);
}

}  // namespace

// 1 when rows of d floats take the wide instantiation.
extern "C" int cfr_bias_wide(int d) { return d > kMaxD ? 1 : 0; }

// The explicit side (F, lens, chunk_ptr, chunk_lens, cols, vals, L) with its
// `chunks` rows of cols (R for a padded side), cbias and bias, or F null (no
// bias); loss null unless reg_new is used.  Rows up to kMaxD floats: pieces
// of `piece` entries, ceil(L / piece) (at least 1) per padded row or chunk,
// and `part` (a double per piece) unless every row fits one piece (a padded
// side of at most `piece` slots).
extern "C" int cfr_bias(const float* X, int n, int d, const int32_t* rows, int R,
                        const int32_t* total, const float* F, const int32_t* lens,
                        const int32_t* chunk_ptr, const int32_t* chunk_lens,
                        const int32_t* cols, const float* vals, int L, int chunks,
                        const float* cbias, float* bias, float reg_new, float* loss,
                        int piece, double* part, void* stream) {
  if (d < 1 || n < 1 || R < 0 || chunks < 0 || piece < 1 ||
      (F && (!bias || !cbias || !lens)) || (!F && !loss))
    return (int)cudaErrorInvalidValue;
  const int ppr = L > piece ? (L + piece - 1) / piece : 1;
  if (R == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool vec = d % 4 == 0 && (uintptr_t)X % 16 == 0 && (!F || (uintptr_t)F % 16 == 0);
  Args g{X, n, d, rows, R, total, F, lens, chunk_ptr, chunk_lens, cols, vals, L,
         cbias, bias, reg_new, loss, piece, ppr, (int64_t)chunks * ppr, part, vec};
  if (d > kMaxD) {
    bias_kernel_wide<<<(R + kWarps - 1) / kWarps, kThreads, 0, st>>>(g);
    return (int)cudaGetLastError();
  }
  if (loss) bias_kernel_loss<<<(R + kWarps - 1) / kWarps, kThreads, 0, st>>>(g);
  if (!F) return (int)cudaGetLastError();
  int lanes = 1;
  while (lanes < kMaxLanes && 4 * lanes < d) lanes *= 2;
  const int V4 = (d + 4 * lanes - 1) / (4 * lanes);
  const bool spans = chunk_ptr || ppr > 1;
  if (V4 > 8 || (spans && !part) || (!chunk_ptr && chunks != R))
    return (int)cudaErrorInvalidValue;
  if (g.pieces > 0) {
    const int64_t blocks = (g.pieces + kWarps - 1) / kWarps;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)blocks;
    switch (lanes) {
      case 1: launch_pieces<1>(g, V4, grid, st); break;
      case 2: launch_pieces<2>(g, V4, grid, st); break;
      case 4: launch_pieces<4>(g, V4, grid, st); break;
      default: launch_pieces<kMaxLanes>(g, V4, grid, st); break;
    }
  }
  if (spans) bias_finish<<<(R + kThreads - 1) / kThreads, kThreads, 0, st>>>(g);
  return (int)cudaGetLastError();
}
