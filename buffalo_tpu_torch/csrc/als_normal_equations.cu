// K2: per-row dense ALS normal equations and loss terms.
//
// Replaces buffalo_tpu/ops/als_kernels.py: _row_stats (:65) + the A assembly
// of als_solve_batch (:164-167) for range batches with L > 96, and the
// per-chunk statistics + segment_sum of als_solve_segment_batch (:268-297)
// for segment batches of head rows, with the loss terms of _loss_terms (:77)
// and (:284-297).  Per row r it writes
//   A[r] = FF + F^T diag(w) F + reg*ada*I,   y[r] = F^T (1 + w),
//   nume[r], deno[r]   (the reference's loss accumulators, pre-update p)
// where F = Bf[cols] over the row's entries and w = alpha * vals.
//
// Range mode (als_normal_equations_range): one block per row r, whose
// entries are cols[r, :lens[r]], with p = table[row_start + r], or
// p = table[rows[r]] in rows mode (a PaddedBatch of the scatter layout,
// whose padding ids lie outside the table: such rows get zero loss terms
// and their systems are never solved).  Values are float32 or bfloat16.
// Segment mode: row r owns chunks [chunk_ptr[r], chunk_ptr[r+1]) of width C,
// chunk c holding chunk_lens[c] entries, and p = table[rows[r]].  A head
// row can hold a million entries, so one block per chunk
// (als_normal_equations_chunks) writes the chunk's partial statistics (the
// reference's A_chunk / y_chunk), and als_segment_reduce_kernel adds each
// row's chunk partials in chunk order and finishes A, y and the loss (the
// reference's segment_sum).  No atomics: every launch sums in the same order.
//
// What bounds it on the card: not the bytes (the gathered rows of Bf sit in
// L2; both tables of the ML-20M layout fit in its 50 MB) and not the tensor
// cores' rate, but instruction issue: each m16n8k8 product of the 3xTF32
// split comes with about nine other instructions (fragment loads, the
// split, the weights, the float32 sum), then per-row set-up and the A
// write.  Design:
// * Gather ring: the entries' Bf rows go to a ring of kStages shared-memory
//   stages of kTL entries with cp.async (16-byte, L2-only copies when rows
//   are 16-byte multiples, else 4-byte), the stage's cols loaded a stage
//   ahead, so one stage is multiplied while the next lands; one barrier per
//   stage.
// * Tensor cores at float32 accuracy: mma.sync m16n8k8 TF32 with a 3xTF32
//   split (x = big + small, big*big + big*small + small*big, float32
//   accumulation).  M and N are features, K is entries; only the upper block
//   triangle of A is accumulated and it is mirrored on write.  Two all-ones
//   feature columns ride in the padding, so the same products give F^T w,
//   F^T 1 and sum(w) (y and deno).  The row stride is 8 or 24 (mod 32) words,
//   so fragment loads are free of bank conflicts.
// * Warps split the product's 16 x 16 units (two m16n8 tiles sharing their
//   A fragment) and, where A is small, the k-steps of a stage; their totals
//   are added in a fixed order at the end.  Sums are
//   two-level, so thousands of entries do not pile into one float32 running
//   sum: registers hold a few stages (each k-step's products summed from
//   zero), and a running total sits in shared memory.
// * y, sum(w) and the item-axis loss come out of the same products: the
//   loss sum over entries of -(p.f)^2 + (p.f - 1)^2 (1 + w) is
//   p^T F^T diag(w) F p - 2 p.y + n + sum(w), finished from A and y.
// * Wide rows (d = 160 on the iALS++ path, up to 256): 8 warps of at most
//   6 units cover 48 units (d <= 142); past that the entries are streamed
//   once per pass of 48 units, and the data part of A is assembled in the
//   output itself (global memory, L2) instead of over the ring.
// * Past 256 floats the ring of whole rows no longer fits shared memory:
//   the wide form tiles A's output into 64 x 64 blocks, one thread block per
//   (row or chunk, tile), each walking the entries in order with their two
//   64-column slices of Bf staged (scalar FMAs in float32); a second kernel,
//   one block per row or chunk, forms y and the loss terms from global
//   memory.
#include "als_common.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTL = 64;         // entries per ring stage (8 MMA k-steps)
constexpr int kStages = 2;      // ring depth
constexpr int kFlush = 4;       // stages summed in registers between flushes

struct Params {
  const float* table;
  const float* Bf;
  const float* FF;
  const int32_t* lens;
  const int32_t* rows;
  const int32_t* chunk_ptr;
  const int32_t* chunk_lens;
  const int32_t* cols;
  const void* vals;  // float32, or bfloat16 with vals_bf16
  float* A;  // range mode: the outputs; chunk mode: the chunk partials
  float* y;
  float* nume;
  float* deno;
  int64_t row_start, n_table_rows;
  int R, C, d;
  float alpha, reg, num_fixed_rows;
  int adaptive_reg, item_axis, compute_loss, vals_bf16;
  // tiling (set by the launcher)
  int NP;       // features padded to 16, with the two ones columns
  int S;        // shared row stride, 8 or 24 (mod 32) words
  int NTn;      // n8 tiles across; the upper block triangle has NT tiles
  int NT;
  int MT;       // m16 tiles down; the upper block triangle has NU 16 x 16 units
  int NU;
  int EG;       // entry groups: warp w takes the k-steps w % EG (mod EG)
  int UPW;      // units per warp (the kernel's kUPW)
  int UPP;      // units per pass over the entries, (kWarps / EG) * UPW
  int passes;   // passes over the entries, NU / UPP rounded up
  int TT;       // n8 tiles of one pass's running totals
  int a_global; // A's data part assembled in the output, not over the ring
  int vec;      // 16-byte copies
  int nchunk;   // copies per entry row
  uint32_t magic;  // q / nchunk == __umulhi(q, magic) for q < kTL * nchunk
};

// (m16 row, n8 column) of tile `tile` of the upper block triangle, row-major
__device__ __forceinline__ void tile_mn(int tile, int NTn, int& mi, int& ni) {
  mi = 0;
  while (tile >= NTn - 2 * mi) tile -= NTn - 2 * mi++;
  ni = 2 * mi + tile;
}

// Statistics of one block's entries.  Range mode: block r is row r.  Chunk
// mode: block c is chunk c of the row found in chunk_ptr, and only the entry
// sums are written (A without FF and reg, nume = sum of the entries' loss
// terms, deno = sum of w).
template <bool kChunks, int kUPW>
__device__ __forceinline__ void normal_equations_body(const Params& p) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = p.d, S = p.S;
  float* Fs = smem;                                // [kStages][kTL][S]
  float* vs = Fs + kStages * kTL * S;              // [kStages][kTL] vals
  int32_t* cs = reinterpret_cast<int32_t*>(vs + kStages * kTL);  // [kStages][kTL]
  float* tot = reinterpret_cast<float*>(cs + kStages * kTL);     // [EG][TT][128]
  float* ps = tot + p.EG * p.TT * 128;             // [NP] current row
  float* yw = ps + p.NP;                           // [NP][2] F^T w, F^T 1
  float* scratch = yw + 2 * p.NP;                  // [33]

  int n;        // entries of this block
  int64_t src;  // table row of p
  bool real;
  if (kChunks) {
    // the row owning chunk b: the last r with chunk_ptr[r] <= b
    int lo = 0, hi = p.R;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (p.chunk_ptr[mid] <= b) lo = mid; else hi = mid - 1;
    }
    n = p.chunk_lens[b];
    src = lo < p.R ? p.rows[lo] : -1;
    real = b < p.chunk_ptr[p.R] && p.lens[lo] > 0 && n > 0 && src >= 0 &&
           src < p.n_table_rows;
  } else {
    n = p.lens[b];
    src = p.rows ? (int64_t)p.rows[b] : p.row_start + b;
    real = n > 0 && src >= 0 && src < p.n_table_rows;
  }
  if (!real) n = 0;
  for (int j = tid; j < p.NP; j += kThreads) ps[j] = (real && j < d) ? p.table[src * d + j] : 0.f;
  // columns past d, never written by the gather: two ones columns (d and
  // d + 1), then zeros
  const int extra = S - d;
  for (int i = tid; i < kStages * kTL * extra; i += kThreads) {
    const int r = i / extra, c = d + (i - r * extra);
    Fs[r * S + c] = c <= d + 1 ? 1.f : 0.f;
  }

  const int32_t* cb = p.cols + (int64_t)b * p.C;
  const float* vb = static_cast<const float*>(p.vals) + (int64_t)b * p.C;
  const int ntiles = (n + kTL - 1) / kTL;
  auto col_of = [&](int tile) {
    const int e = tile * kTL + tid;
    return (tid < kTL && e < n) ? __ldg(cb + e) : -1;
  };
  // cp.async the Bf rows and vals of `tile` into its stage (zeros past n);
  // every call commits one group, empty past the last tile.  bfloat16 values
  // are converted by a plain load (cp.async copies 4 bytes or more), which
  // the barrier before the stage is read makes visible like the copies.
  const int W = p.vec ? 4 : 1, ncopy = kTL * p.nchunk;
  auto issue = [&](int tile) {
    if (tile < ntiles) {
      const int st = tile % kStages;
      float* Fst = Fs + st * kTL * S;
      const int32_t* cst = cs + st * kTL;
      for (int q = tid; q < ncopy; q += kThreads) {
        const int l = __umulhi((unsigned)q, p.magic), c = (q - l * p.nchunk) * W;
        const int col = cst[l];
        const float* from = col >= 0 ? p.Bf + (int64_t)col * d + c : p.Bf;
        if (p.vec) cp_async16(Fst + l * S + c, from, col >= 0);
        else cp_async4(Fst + l * S + c, from, col >= 0);
      }
      if (tid < kTL) {
        const int e = tile * kTL + tid;
        if (p.vals_bf16)
          vs[st * kTL + tid] = e < n ? als::load_val(p.vals, (int64_t)b * p.C + e, true) : 0.f;
        else
          cp_async4(vs + st * kTL + tid, e < n ? vb + e : vb, e < n);
      }
    }
    cp_async_commit();
  };

  // A's data part (F^T diag(w) F): over the ring once the entries are
  // consumed (one pass), else in the output row by row
  const int AS = p.a_global ? d : d + 1;
  float* As = p.a_global ? p.A + (int64_t)b * d * d : Fs;
  const int eg = warp % p.EG;
  const int g = lane >> 2, t = lane & 3;
  for (int pass = 0; pass < p.passes; ++pass) {
    const int pu0 = pass * p.UPP;  // the pass's first unit; its tiles start at 2 pu0
    for (int i = tid; i < p.EG * p.TT * 128; i += kThreads) tot[i] = 0.f;
    // prologue: the cols of the first kStages tiles, the gathers of the first
    // kStages - 1
    for (int s = 0; s < kStages; ++s)
      if (tid < kTL) cs[s * kTL + tid] = col_of(s);
    int col_next = col_of(kStages);
    __syncthreads();
    for (int s = 0; s < kStages - 1; ++s) issue(s);

    // this warp's units and k-steps.  A unit is a 16 x 16 block (mi, nj) of
    // the upper block triangle: two m16n8 tiles that share their A fragment.
    // A warp holds kUPW units from u0 (slots past the triangle compute unit 0
    // again and are never stored), so the unit loop has no branch and its
    // loads and products interleave.
    const int u0 = pu0 + (warp / p.EG) * kUPW;
    int aoff[kUPW], boff[kUPW], tile0[kUPW];  // fragment columns, first tile in the pass
    bool unweighted[kUPW][2];  // B column d + 1 carries F^T 1: no w
#pragma unroll
    for (int uu = 0; uu < kUPW; ++uu) {
      int mi = 0, nj = 0;
      if (u0 + uu < p.NU) unit_mn(u0 + uu, p.MT, mi, nj);
      aoff[uu] = mi * 16;
      boff[uu] = nj * 16;
      tile0[uu] = mi * p.NTn - mi * (mi - 1) + 2 * (nj - mi) - 2 * pu0;
#pragma unroll
      for (int h = 0; h < 2; ++h) unweighted[uu][h] = nj * 16 + h * 8 + g == d + 1;
    }
    float acc[kUPW][2][4];
#pragma unroll
    for (int uu = 0; uu < kUPW; ++uu)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[uu][e >> 2][e & 3] = 0.f;
    auto flush = [&]() {
#pragma unroll
      for (int uu = 0; uu < kUPW; ++uu) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (u0 + uu < p.NU) {
            float4* to = reinterpret_cast<float4*>(
                tot + ((eg * p.TT + tile0[uu] + h) * 128 + lane * 4));
            float4 v = *to;
            v.x += acc[uu][h][0]; v.y += acc[uu][h][1];
            v.z += acc[uu][h][2]; v.w += acc[uu][h][3];
            *to = v;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[uu][h][e] = 0.f;
        }
      }
    };

    for (int i = 0; i < ntiles; ++i) {
      cp_async_wait<kStages - 2>();  // this thread's copies of tile i landed
      __syncthreads();               // everyone's did; stage i-1 is consumed
      issue(i + kStages - 1);
      if (tid < kTL) cs[(i % kStages) * kTL + tid] = col_next;  // tile i + kStages
      col_next = col_of(i + kStages + 1);

      const int st = i % kStages, tl = min(kTL, n - i * kTL);
      const float* Fst = Fs + st * kTL * S;
      const float* vst = vs + st * kTL;
      for (int ks = eg; ks * 8 < tl; ks += p.EG) {
        const int l0 = ks * 8;
        const float w0 = p.alpha * vst[l0 + t], w1 = p.alpha * vst[l0 + t + 4];
        const float* r0 = Fst + (l0 + t) * S + g;  // entry l0 + t, feature g
        const float* r1 = r0 + 4 * S;               // entry l0 + t + 4
#pragma unroll
        for (int uu = 0; uu < kUPW; ++uu) {
          // A operand: features (rows of A) x entries
          uint32_t ab[4], as[4];
          split_tf32(r0[aoff[uu]], ab[0], as[0]);
          split_tf32(r0[aoff[uu] + 8], ab[1], as[1]);
          split_tf32(r1[aoff[uu]], ab[2], as[2]);
          split_tf32(r1[aoff[uu] + 8], ab[3], as[3]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // B operand: entries x features, weighted by w
            const int c = boff[uu] + 8 * h;
            uint32_t bb[2], bs[2];
            split_tf32(r0[c] * (unweighted[uu][h] ? 1.f : w0), bb[0], bs[0]);
            split_tf32(r1[c] * (unweighted[uu][h] ? 1.f : w1), bb[1], bs[1]);
            // the k-step's sum starts from 0 and is added to the registers
            // in float32: the tensor core's own accumulation would round a
            // large running sum once per product
            float step[4];
            mma_tf32_first(step, as, bb);
            mma_tf32(step, ab, bs);
            mma_tf32(step, ab, bb);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[uu][h][e] += step[e];
          }
        }
      }
      if ((i + 1) % kFlush == 0) flush();
    }
    flush();
    cp_async_wait<0>();
    __syncthreads();

    // entry groups added in group order, A mirrored from its upper triangle;
    // in shared memory the row stride d + 1 spreads the mirrored writes over
    // the banks
    const int ntile = 2 * min(p.UPP, p.NU - pu0);
    for (int lt = warp; lt < ntile; lt += kWarps) {
      int mi, ni;
      tile_mn(2 * pu0 + lt, p.NTn, mi, ni);
      float4 v = *reinterpret_cast<const float4*>(tot + lt * 128 + lane * 4);
      for (int gg = 1; gg < p.EG; ++gg) {
        const float4 u = *reinterpret_cast<const float4*>(tot + (gg * p.TT + lt) * 128 + lane * 4);
        v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
      }
      const float vr[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = mi * 16 + g + (r >= 2 ? 8 : 0), k = ni * 8 + 2 * t + (r & 1);
        if (j > k || j > d || k > d + 1) continue;
        if (k < d) {
          As[j * AS + k] = vr[r];
          As[k * AS + j] = vr[r];
        } else {
          yw[2 * j + (k - d)] = vr[r];  // F^T w, F^T 1; row d: sum(w)
        }
      }
    }
    __syncthreads();  // the totals are read before the next pass clears them
  }

  // A written row by row.  The item-axis loss of the pre-update row is
  // sum_l [-(p.f_l)^2 + (p.f_l - 1)^2 (1 + w_l)]
  //   = p^T F^T diag(w) F p - 2 p.y + n + sum(w),
  // so it comes from A and y here, not from the entries; with
  // p^T FF p (range mode) it is p^T (FF + F^T diag(w) F) p - 2 p.y + ...
  // Each element of A is read and written by one thread, so As may be Ab.
  const float reg_ada = kChunks ? 0.f : p.reg * (p.adaptive_reg ? (float)p.lens[b] : 1.f);
  float* Ab = p.A + (int64_t)b * d * d;
  float quad = 0.f;
  for (int j = warp; j < d; j += kWarps)
    for (int k = lane; k < d; k += 32) {
      const int e = j * d + k;
      const float m = As[j * AS + k], ff = kChunks ? 0.f : p.FF[e];
      Ab[e] = kChunks ? m : ff + m + (j == k ? reg_ada : 0.f);
      quad += ps[j] * (ff + m) * ps[k];
    }
  for (int j = tid; j < d; j += kThreads) {
    const float yj = yw[2 * j] + yw[2 * j + 1];
    p.y[(int64_t)b * d + j] = yj;
    quad -= 2.f * ps[j] * yj;
  }

  if (p.compute_loss) {
    float nu = 0.f, de = 0.f;
    if (!kChunks) {
      float part = 0.f;
      for (int j = tid; j < d; j += kThreads) part += ps[j] * ps[j];
      nu = reg_ada * als::block_sum(part, scratch);
    }
    if (p.item_axis) {
      nu += als::block_sum(quad, scratch) + (float)n + yw[2 * d];
      de = (kChunks ? 0.f : p.num_fixed_rows) + yw[2 * d];
    }
    if (tid == 0) {
      p.nume[b] = real ? nu : 0.f;
      p.deno[b] = real ? de : 0.f;
    }
  }
}

// Two kernels, so that a profile names the range and segment modes apart;
// kUPW units (two m16n8 accumulator tiles each) per warp
template <int kUPW>
__global__ void __launch_bounds__(kThreads, kUPW <= 3 ? 3 : kUPW <= 4 ? 2 : 1)
    als_normal_equations_range(const Params p) {
  normal_equations_body<false, kUPW>(p);
}

template <int kUPW>
__global__ void __launch_bounds__(kThreads, kUPW <= 3 ? 3 : kUPW <= 4 ? 2 : 1)
    als_normal_equations_chunks(const Params p) {
  normal_equations_body<true, kUPW>(p);
}

template <int kUPW>
cudaError_t launch_statistics(const Params& p, int blocks, size_t smem, cudaStream_t s) {
  const bool chunks = p.chunk_ptr != nullptr;
  cudaError_t err = chunks ? als::allow_smem(als_normal_equations_chunks<kUPW>, smem)
                           : als::allow_smem(als_normal_equations_range<kUPW>, smem);
  if (err != cudaSuccess) return err;
  if (chunks) als_normal_equations_chunks<kUPW><<<blocks, kThreads, smem, s>>>(p);
  else als_normal_equations_range<kUPW><<<blocks, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

constexpr int kUnitCounts[] = {1, 2, 3, 4, 6};  // instantiated kUPW

// ------------------------------------------------------------- wide rows
constexpr int kOut = 64;                         // output tiles of kOut x kOut
constexpr int kWideTile = 32;                    // entries staged at a time
constexpr int kWidePer = kOut * kOut / kThreads;  // a thread's tile entries

// The entries of block b (a row, or a chunk of a head row): [base, base + n)
// of cols / vals, the table row src of p, and whether it is real.
struct WideList {
  int n;
  int64_t src, base;
  bool real;
};

__device__ __forceinline__ WideList wide_list(const Params& p, int b, bool chunks) {
  WideList L;
  if (chunks) {
    int lo = 0, hi = p.R;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (p.chunk_ptr[mid] <= b) lo = mid; else hi = mid - 1;
    }
    L.n = p.chunk_lens[b];
    L.src = lo < p.R ? p.rows[lo] : -1;
    L.real = b < p.chunk_ptr[p.R] && p.lens[lo] > 0 && L.n > 0 && L.src >= 0 &&
             L.src < p.n_table_rows;
  } else {
    L.n = p.lens[b];
    L.src = p.rows ? (int64_t)p.rows[b] : p.row_start + b;
    L.real = L.n > 0 && L.src >= 0 && L.src < p.n_table_rows;
  }
  if (!L.real) L.n = 0;
  L.base = (int64_t)b * p.C;
  return L;
}

// A's output tile blockIdx.y of row / chunk blockIdx.x: the entries' sum of
// w f_i f_j, then (range mode) FF and the reg term.
template <bool kChunks>
__global__ void __launch_bounds__(kThreads) wide_a_kernel(const Params p) {
  __shared__ float Fi[kWideTile][kOut], Fj[kWideTile][kOut], wa[kWideTile];
  const int d = p.d, t = threadIdx.x, b = blockIdx.x;
  const int nt = (d + kOut - 1) / kOut;
  const int i0 = (blockIdx.y / nt) * kOut, j0 = (blockIdx.y % nt) * kOut;
  const WideList L = wide_list(p, b, kChunks);
  float acc[kWidePer];
#pragma unroll
  for (int j = 0; j < kWidePer; ++j) acc[j] = 0.f;
  for (int base = 0; base < L.n; base += kWideTile) {
    const int cnt = min(kWideTile, L.n - base);
    for (int q = t; q < kWideTile * kOut; q += kThreads) {
      const int l = q / kOut, z = q - l * kOut;
      const float* f = p.Bf + (int64_t)(l < cnt ? p.cols[L.base + base + l] : 0) * d;
      Fi[l][z] = l < cnt && i0 + z < d ? f[i0 + z] : 0.f;
      Fj[l][z] = l < cnt && j0 + z < d ? f[j0 + z] : 0.f;
    }
    if (t < kWideTile)
      wa[t] = t < cnt ? p.alpha * als::load_val(p.vals, L.base + base + t, p.vals_bf16) : 0.f;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kWidePer; ++j) {
      const int e = t + j * kThreads, ri = e / kOut, rj = e - ri * kOut;
      float a = acc[j];
      for (int l = 0; l < cnt; ++l) a = fmaf(Fi[l][ri] * wa[l], Fj[l][rj], a);
      acc[j] = a;
    }
    __syncthreads();
  }
  const float reg_ada = kChunks ? 0.f : p.reg * (p.adaptive_reg ? (float)p.lens[b] : 1.f);
  float* Ab = p.A + (int64_t)b * d * d;
#pragma unroll
  for (int j = 0; j < kWidePer; ++j) {
    const int e = t + j * kThreads, i = i0 + e / kOut, k = j0 + e % kOut;
    if (i < d && k < d)
      Ab[(int64_t)i * d + k] =
          kChunks ? acc[j] : p.FF[(int64_t)i * d + k] + acc[j] + (i == k ? reg_ada : 0.f);
  }
}

// y = F^T (1 + w) and the loss terms of row / chunk blockIdx.x (wide rows):
// nume = reg_ada |p|^2 (range) plus, on the item axis, p^T FF p (range) +
// sum_l w_l (p.f_l)^2 - 2 p.y + n + sum(w); deno = num_fixed_rows (range)
// + sum(w), as normal_equations_body.
template <bool kChunks>
__global__ void __launch_bounds__(kThreads) wide_y_kernel(const Params p) {
  extern __shared__ float ps[];  // [d]
  __shared__ float scratch[33];
  const int d = p.d, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, b = blockIdx.x;
  const WideList L = wide_list(p, b, kChunks);
  for (int j = tid; j < d; j += kThreads) ps[j] = L.real ? p.table[L.src * d + j] : 0.f;
  __syncthreads();
  float py = 0.f;
  for (int j = tid; j < d; j += kThreads) {
    float yw = 0.f, y1 = 0.f;
    for (int e = 0; e < L.n; ++e) {
      const float f = p.Bf[(int64_t)p.cols[L.base + e] * d + j];
      yw = fmaf(p.alpha * als::load_val(p.vals, L.base + e, p.vals_bf16), f, yw);
      y1 += f;
    }
    const float yj = yw + y1;
    p.y[(int64_t)b * d + j] = yj;
    py += ps[j] * yj;
  }
  if (!p.compute_loss) return;
  const float reg_ada = kChunks ? 0.f : p.reg * (p.adaptive_reg ? (float)p.lens[b] : 1.f);
  float sq = 0.f, quad = 0.f, wsum = 0.f;
  for (int j = tid; j < d; j += kThreads) {
    sq += ps[j] * ps[j];
    if (!kChunks && p.item_axis) {
      float q = 0.f;
      for (int k = 0; k < d; ++k) q = fmaf(p.FF[(int64_t)j * d + k], ps[k], q);
      quad += ps[j] * q;
    }
  }
  if (p.item_axis) {
    for (int e = warp; e < L.n; e += kThreads / 32) {
      const float* f = p.Bf + (int64_t)p.cols[L.base + e] * d;
      float s = 0.f;
      for (int k = lane; k < d; k += 32) s = fmaf(ps[k], f[k], s);
      s = als::warp_sum(s);
      if (lane == 0)
        quad += p.alpha * als::load_val(p.vals, L.base + e, p.vals_bf16) * s * s;
    }
    for (int e = tid; e < L.n; e += kThreads)
      wsum += p.alpha * als::load_val(p.vals, L.base + e, p.vals_bf16);
  }
  float nu = 0.f, de = 0.f;
  if (!kChunks) nu = reg_ada * als::block_sum(sq, scratch);
  if (p.item_axis) {
    const float w = als::block_sum(wsum, scratch);
    nu += als::block_sum(quad - 2.f * py, scratch) + (float)L.n + w;
    de = (kChunks ? 0.f : p.num_fixed_rows) + w;
  }
  if (tid == 0) {
    p.nume[b] = L.real ? nu : 0.f;
    p.deno[b] = L.real ? de : 0.f;
  }
}

cudaError_t launch_wide(const Params& p, int blocks, cudaStream_t s) {
  const int nt = (p.d + kOut - 1) / kOut;
  const bool chunks = p.chunk_ptr != nullptr;
  if (chunks) wide_a_kernel<true><<<dim3(blocks, nt * nt), kThreads, 0, s>>>(p);
  else wide_a_kernel<false><<<dim3(blocks, nt * nt), kThreads, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * p.d;
  err = chunks ? als::allow_smem(wide_y_kernel<true>, smem)
               : als::allow_smem(wide_y_kernel<false>, smem);
  if (err != cudaSuccess) return err;
  if (chunks) wide_y_kernel<true><<<blocks, kThreads, smem, s>>>(p);
  else wide_y_kernel<false><<<blocks, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

// Segment mode, second pass: row r adds its chunks' partials in chunk order
// (the reference's segment_sum) and finishes A = FF + sum + reg*ada*I, y and
// the loss terms of the pre-update row.
__global__ void __launch_bounds__(256)
als_segment_reduce_kernel(const float* __restrict__ table, const float* __restrict__ FF,
                          const int32_t* __restrict__ lens, const int32_t* __restrict__ rows,
                          const int32_t* __restrict__ chunk_ptr,
                          const float* __restrict__ A_part, const float* __restrict__ y_part,
                          const float* __restrict__ pos_part, const float* __restrict__ w_part,
                          float* __restrict__ A_out, float* __restrict__ y_out,
                          float* __restrict__ nume, float* __restrict__ deno,
                          int64_t n_table_rows, int d, float reg, int adaptive_reg,
                          int item_axis, float num_fixed_rows, int compute_loss) {
  extern __shared__ float smem[];
  float* ps = smem;         // [d]
  float* scratch = ps + d;  // [33]
  const int r = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const int n = lens[r];
  const int64_t src = rows[r];
  const bool real = n > 0 && src >= 0 && src < n_table_rows;
  const int c0 = chunk_ptr[r], c1 = real ? chunk_ptr[r + 1] : c0;
  const float reg_ada = reg * (adaptive_reg ? (float)n : 1.f);
  const int dd = d * d;
  for (int e = tid; e < dd; e += T) {
    float s = 0.f;
    for (int c = c0; c < c1; ++c) s += A_part[(int64_t)c * dd + e];
    const int j = e / d;
    A_out[(int64_t)r * dd + e] = FF[e] + s + (e == j * d + j ? reg_ada : 0.f);
  }
  for (int j = tid; j < d; j += T) {
    float s = 0.f;
    for (int c = c0; c < c1; ++c) s += y_part[(int64_t)c * d + j];
    y_out[(int64_t)r * d + j] = s;
    ps[j] = real ? table[src * d + j] : 0.f;
  }
  if (!compute_loss) return;
  __syncthreads();
  float part = 0.f;
  for (int j = tid; j < d; j += T) part += ps[j] * ps[j];
  float nu = reg_ada * als::block_sum(part, scratch);
  float de = 0.f;
  if (item_axis) {
    part = 0.f;
    for (int j = tid; j < d; j += T) {
      float s = 0.f;
      for (int k = 0; k < d; ++k) s += FF[j * d + k] * ps[k];
      part += ps[j] * s;
    }
    nu += als::block_sum(part, scratch);
    float pos = 0.f, w = 0.f;
    for (int c = c0; c < c1; ++c) {
      pos += pos_part[c];
      w += w_part[c];
    }
    nu += pos;
    de = num_fixed_rows + w;
  }
  if (tid == 0) {
    nume[r] = real ? nu : 0.f;
    deno[r] = real ? de : 0.f;
  }
}

}  // namespace

// 1 when rows of d floats take the wide form.
extern "C" int als_normal_equations_wide(int d) { return d > 256 ? 1 : 0; }

// Range mode: chunk_ptr == NULL, R rows.  Segment mode: chunk_ptr != NULL,
// R rows over Nc chunks, with (Nc, d, d) / (Nc, d) / (Nc) / (Nc) scratch for
// the chunk partials in A_part / y_part / pos_part / w_part.
extern "C" int als_normal_equations(const float* table, const float* Bf, const float* FF,
                                    const int32_t* lens, const int32_t* rows,
                                    int64_t row_start, const int32_t* chunk_ptr,
                                    const int32_t* chunk_lens, const int32_t* cols,
                                    const void* vals, int vals_bf16, int C, int Nc,
                                    float* A_part,
                                    float* y_part, float* pos_part, float* w_part,
                                    float* A_out, float* y_out, float* nume, float* deno,
                                    int64_t n_table_rows, int R, int d, float alpha,
                                    float reg, int adaptive_reg, int item_axis,
                                    float num_fixed_rows, int compute_loss, void* stream) {
  if (R == 0) return 0;
  Params p{table, Bf, FF, lens, rows, chunk_ptr, chunk_lens, cols, vals,
           A_out, y_out, nume, deno, row_start, n_table_rows, R, C, d,
           alpha, reg, num_fixed_rows, adaptive_reg, item_axis, compute_loss, vals_bf16};
  p.NP = (d + 2 + 15) / 16 * 16;
  p.S = p.NP + 8;  // NP is 0 or 16 (mod 32)
  p.NTn = p.NP / 8;
  p.NT = 0;
  p.MT = p.NP / 16;
  for (int mi = 0; mi < p.MT; ++mi) p.NT += p.NTn - 2 * mi;
  p.NU = p.MT * (p.MT + 1) / 2;
  // the fewest entry groups (least shared memory and final summing) that
  // leave at most an eighth of the warps' unit slots empty; else one group
  auto units_per_warp = [&](int eg) {
    const int need = (p.NU + kWarps / eg - 1) / (kWarps / eg);
    for (int c : kUnitCounts)
      if (c >= need) return c;
    return 0;
  };
  p.EG = 0;
  for (int eg = 1; eg <= kWarps && !p.EG; eg *= 2) {
    const int upw = units_per_warp(eg);
    if (upw && 8 * (upw * (kWarps / eg) - p.NU) <= p.NU) p.EG = eg;
  }
  if (!p.EG) p.EG = 1;
  p.UPW = units_per_warp(p.EG);
  if (p.UPW == 0) p.UPW = kUnitCounts[sizeof(kUnitCounts) / sizeof(int) - 1];  // passes
  p.UPP = (kWarps / p.EG) * p.UPW;
  p.passes = (p.NU + p.UPP - 1) / p.UPP;
  p.TT = p.NT < 2 * p.UPP ? p.NT : 2 * p.UPP;
  p.a_global = p.passes > 1 || (size_t)d * (d + 1) > (size_t)kStages * kTL * (p.S + 2);
  p.vec = d % 4 == 0 && (reinterpret_cast<uintptr_t>(Bf) & 15) == 0;
  p.nchunk = p.vec ? d / 4 : d;
  p.magic = 0xffffffffu / (uint32_t)p.nchunk + 1u;
  const size_t smem = sizeof(float) * ((size_t)kStages * kTL * (p.S + 2) +
                                       (size_t)p.EG * p.TT * 128 + 3 * p.NP + 33);
  cudaStream_t s = (cudaStream_t)stream;
  const bool wide = als_normal_equations_wide(d);
  auto launch = [&](int blocks) {
    if (wide) return launch_wide(p, blocks, s);
    switch (p.UPW) {
      case 1: return launch_statistics<1>(p, blocks, smem, s);
      case 2: return launch_statistics<2>(p, blocks, smem, s);
      case 3: return launch_statistics<3>(p, blocks, smem, s);
      case 4: return launch_statistics<4>(p, blocks, smem, s);
      default: return launch_statistics<6>(p, blocks, smem, s);
    }
  };
  if (chunk_ptr == nullptr) return (int)launch(R);
  if (Nc > 0) {
    p.A = A_part;
    p.y = y_part;
    p.nume = pos_part;
    p.deno = w_part;
    const cudaError_t err = launch(Nc);
    if (err != cudaSuccess) return (int)err;
  }
  als_segment_reduce_kernel<<<R, 256, sizeof(float) * (d + 33), s>>>(
      table, FF, lens, rows, chunk_ptr, A_part, y_part, pos_part, w_part, A_out, y_out,
      nume, deno, n_table_rows, d, reg, adaptive_reg, item_axis, num_fixed_rows,
      compute_loss);
  return (int)cudaGetLastError();
}
