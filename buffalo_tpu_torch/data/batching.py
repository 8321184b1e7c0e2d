"""Fixed-shape device batching of CSR interaction data.

Copy of ``buffalo_tpu.data.batching`` for the PyTorch port.  The
planner, the bucket-order range layout and the segment batches are the
reference's, unchanged, so both packages solve the same batches: rows
are grouped by a ~1.25-geometric degree grid ``L``; a bucket's batch
holds ``B`` rows padded to ``(B, L)`` with ``B*L`` bounded by the
``batch_mb`` entry budget, and rows past ``max_len`` become
``SegmentBatch`` chunks.  The constants (``MATRIX_FREE_MAX_L``, the
``max_rows`` cap in ``DeviceBatcher``) are the TPU's tunings, kept for
parity until the card has its own measurements.

Batches are host numpy; ``stage_batch`` moves one onto a torch device
(pinned host memory, ``non_blocking`` copies on a card, bfloat16 values
rounded there when asked for) and ``DeviceBatcher`` keeps the whole
epoch resident or, past ``resident_mb``, streams it batch by batch
through a ring of reused pinned buffers.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence

import numpy as np

MIN_L = 8
MIN_B = 8
# rows longer than this are split into fixed-width chunks and their
# normal-equation statistics accumulated by segment-sum (SegmentBatch)
# instead of one giant padded row: a power-law head item at 730M-nnz
# scale would otherwise need a multi-GB (1, deg, d) gather
DEFAULT_MAX_L = 8192
# buckets at or below this padded length are solved matrix-free (no
# (B, d, d) system in HBM), so the per-batch row cap only applies to
# longer buckets (ops/als_kernels.MATRIX_FREE_MAX_L uses this value)
MATRIX_FREE_MAX_L = 96


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(math.ceil(math.log2(max(1, x)))))


def _bucket_lengths(max_len: int) -> np.ndarray:
    """~1.25-geometric row-length grid, multiples of 8.

    The gather of fixed-side rows costs per *padded* entry, so finer
    buckets than pow2 (worst-case 2x waste) directly cut epoch time;
    1.25 steps bound padding waste at ~25% while keeping the number
    of distinct XLA shapes small (~30 for any dataset).
    """
    out = [MIN_L]
    while out[-1] < max_len:
        nxt = min(max_len, int(math.ceil(out[-1] * 1.25 / 8) * 8))
        out.append(max(nxt, out[-1] + 8))
    return np.unique(np.asarray(out, dtype=np.int64))


class PaddedBatch(NamedTuple):
    """One fixed-shape batch of rows from a CSR orientation.

    rows: int32[B] original row ids (padding rows carry the out-of-range
          id num_rows with len 0 so device scatters drop them)
    lens: int32[B] true row lengths (0 for padding rows)
    cols: int32[B, L] neighbor ids, padded with 0
    vals: float32[B, L] values, padded with 0

    A NamedTuple so a batch stages onto a device field by field
    (``stage_batch``).
    """
    rows: np.ndarray
    lens: np.ndarray
    cols: np.ndarray
    vals: np.ndarray

    @property
    def shape(self):
        return self.cols.shape

    @property
    def num_real_rows(self) -> int:
        return int((self.lens > 0).sum())


class SegmentBatch(NamedTuple):
    """Long rows, split into fixed-width chunks for segment-sum stats.

    rows:       int32[R]  global row ids (padding rows -> num_rows)
    lens:       int32[R]  true total row lengths (0 for padding)
    seg_ids:    int32[Nc] local row index of each chunk (padding -> R)
    chunk_lens: int32[Nc] valid entries per chunk
    cols:       int32[Nc, C] neighbor ids
    vals:       float32[Nc, C] values

    All chunks of one row live in the same batch, so per-row statistics
    are exact after a segment-sum over ``seg_ids``.
    """
    rows: np.ndarray
    lens: np.ndarray
    seg_ids: np.ndarray
    chunk_lens: np.ndarray
    cols: np.ndarray
    vals: np.ndarray

    @property
    def shape(self):
        return self.cols.shape

    @property
    def num_real_rows(self) -> int:
        return int((self.lens > 0).sum())


class RangeBatch(NamedTuple):
    """A padded batch whose rows are a CONTIGUOUS range of a permuted
    factor table: [row_start, row_start + B).

    After permuting the table into bucket order once per training run,
    the update of a batch is a contiguous range write and the
    current-row read a contiguous range read, with no scatter.
    ``row_start`` is an int32 scalar (an (n,) array once stacked).
    """
    row_start: np.ndarray    # int32 () — first row of the range
    lens: np.ndarray         # int32[B] true row lengths (0 padding)
    cols: np.ndarray         # int32[B, L] (ids in the OTHER table's
    vals: np.ndarray         # float32[B, L]         permuted order)

    @property
    def shape(self):
        return self.cols.shape

    @property
    def num_real_rows(self) -> int:
        return int((self.lens > 0).sum())


def _gather_remapped(indptr, key, val, rows, B, L, other_newpos,
                     vals_dtype=np.float32):
    """Gather CSR rows into a padded (B, L) block.

    The one ragged-CSR gather used by both the range-layout builders
    and ``BatchPlanner.iter_batches``.  ``rows`` may be shorter than B
    (the rest is padding with len 0); ``other_newpos``, when given,
    maps the raw neighbor ids into the permuted other table's
    positions.
    """
    n = len(rows)
    if n:
        from buffalo_tpu_torch.data import native
        got = native.gather_remapped_native(
            np.asarray(indptr), np.asarray(key),
            None if val is None else np.asarray(val),
            np.asarray(rows), B, L, other_newpos, vals_dtype)
        if got is not None:
            return got
    out_lens = np.zeros(B, dtype=np.int32)
    pad_cols = np.zeros((B, L), dtype=np.int32)
    pad_vals = np.zeros((B, L), dtype=vals_dtype)
    if n:
        key = np.asarray(key)
        beg = indptr[rows]
        lens = (indptr[rows + 1] - beg).astype(np.int32)
        offs = np.arange(L, dtype=np.int64)[None, :]
        idx = beg[:, None] + np.minimum(offs,
                                        np.maximum(lens[:, None] - 1, 0))
        mask = offs < lens[:, None]
        raw = key[idx]
        cols = np.where(mask,
                        raw if other_newpos is None else other_newpos[raw],
                        0)
        if val is not None:
            vals = np.where(mask, np.asarray(val, np.float32)[idx], 0.0)
        else:
            vals = mask.astype(np.float32)
        out_lens[:n] = lens
        pad_cols[:n] = cols
        pad_vals[:n] = vals.astype(vals_dtype)
    return out_lens, pad_cols, pad_vals


def build_range_layout(row_planner: "BatchPlanner",
                       col_planner: "BatchPlanner",
                       row_key, row_val, col_key, col_val,
                       vals_dtype=np.float32):
    """Permute both orientations into bucket order and emit RangeBatches.

    Returns (row_batches, col_batches, u_newpos, i_newpos, u_rows_padded,
    i_rows_padded): ``*_newpos[old_id] -> position`` in the permuted
    (and padded) table; every real row gets a position (degree-0 rows
    at the tail, untouched by training).  Cross-references are
    remapped: rowwise ``cols`` carry item positions, colwise ``cols``
    user positions.  Long rows (SegmentBatch) keep scatter semantics
    with remapped ids.
    """
    def positions(planner):
        num = planner.num_rows
        newpos = np.full(num, -1, dtype=np.int64)
        plan = []  # (row_ids, start, B) per batch
        pos = 0
        bmult = planner.batch_rows_multiple
        for bucket in planner.buckets:
            ids = bucket.row_ids
            for beg in range(0, len(ids), bucket.B):
                rows = ids[beg:beg + bucket.B]
                n = len(rows)
                B = min(bucket.B, -(-n // bmult) * bmult)
                newpos[rows] = pos + np.arange(n)
                plan.append((rows, pos, B, int(bucket.L)))
                pos += B
        seg = np.asarray(
            [r for p in planner.segment_plans for r in p], dtype=np.int64)
        first_free = pos
        # segment rows then degree-0 rows at the tail
        deg0 = np.nonzero(newpos < 0)[0]
        if len(seg):
            deg0 = deg0[~np.isin(deg0, seg)]
        tail = np.concatenate([seg, deg0])
        newpos[tail] = first_free + np.arange(len(tail))
        total = first_free + len(tail)
        padded = -(-total // MIN_B) * MIN_B
        return newpos, plan, padded

    u_newpos, u_plan, u_padded = positions(row_planner)
    i_newpos, i_plan, i_padded = positions(col_planner)

    def emit(planner, plan, key, val, self_newpos, other_newpos):
        out = []
        indptr = planner.indptr
        key = np.asarray(key)  # native gather takes int32/int64 as-is
        for rows, pos, B, L in plan:
            out_lens, pad_cols, pad_vals = _gather_remapped(
                indptr, key, val, rows, B, L, other_newpos, vals_dtype)
            out.append(RangeBatch(row_start=np.int32(pos),
                                  lens=out_lens, cols=pad_cols,
                                  vals=pad_vals))
        # segment batches: remap both the row ids and the col ids
        for plan_rows in planner.segment_plans:
            out.append(_remap_segment(planner, plan_rows, key, val,
                                      self_newpos, other_newpos, vals_dtype))
        return out

    row_batches = emit(row_planner, u_plan, row_key, row_val,
                       u_newpos, i_newpos)
    col_batches = emit(col_planner, i_plan, col_key, col_val,
                       i_newpos, u_newpos)
    return (row_batches, col_batches, u_newpos, i_newpos,
            int(u_padded), int(i_padded))


def _remap_segment(planner, plan_rows, key, val, self_newpos, other_newpos,
                   vals_dtype=np.float32):
    """Build one SegmentBatch with row/col ids remapped into permuted
    table positions (padding rows point out of range so device scatters
    drop them)."""
    sb = planner._build_segment_batch(plan_rows, key, val)
    rows = np.where(sb.lens > 0,
                    np.take(np.concatenate([self_newpos,
                                            np.array([1 << 30])]),
                            np.minimum(sb.rows, len(self_newpos))),
                    1 << 30).astype(np.int32)
    cols = other_newpos[sb.cols.astype(np.int64)].astype(np.int32)
    return SegmentBatch(rows=rows, lens=sb.lens, seg_ids=sb.seg_ids,
                        chunk_lens=sb.chunk_lens, cols=cols,
                        vals=sb.vals.astype(vals_dtype))


def build_sharded_range_layout(row_planner: "BatchPlanner",
                               col_planner: "BatchPlanner",
                               row_key, row_val, col_key, col_val,
                               num_shards: int, vals_dtype=np.float32):
    """Permute both tables into PER-SHARD bucket order (the JAX package's
    ``build_sharded_range_layout``, ``data/batching.py:272``).

    Shard k of the permuted table is the contiguous block ``[k*S,
    (k+1)*S)``; within a shard, rows sit in bucket order so every batch
    updates a contiguous LOCAL range.  Every shard carries an identical
    batch schedule (uneven bucket splits are filled with padding rows of
    length 0), so the stacked groups gain a leading shard axis.

    Returns ``(row_groups, col_groups, row_segments, col_segments,
    u_newpos, i_newpos, S_u, S_i)``: groups are stacked ``RangeBatch``
    tuples with the shard axis first (``row_start (D, n)``, ``lens (D, n,
    B)``, ``cols/vals (D, n, B, L)``); segments are ``SegmentBatch``es
    with GLOBAL remapped ids; ``*_newpos[old_id]`` is the global position
    in a table of ``num_shards * S`` rows.  Byte-equal to the JAX
    function's output.
    """
    D = int(num_shards)

    def positions(planner):
        num = planner.num_rows
        local = np.full(num, -1, dtype=np.int64)
        shard = np.zeros(num, dtype=np.int64)
        plan = []  # (parts per shard, local_start, n_pad, B, L)
        pos = 0
        for bucket in planner.buckets:
            parts = np.array_split(bucket.row_ids, D)
            n_pad = -(-max(len(p) for p in parts) // MIN_B) * MIN_B
            B = min(int(bucket.B), n_pad)
            for k, part in enumerate(parts):
                shard[part] = k
                local[part] = pos + np.arange(len(part))
            plan.append((parts, pos, n_pad, B, int(bucket.L)))
            pos += n_pad
        # tail: long (segment) rows then degree-0 rows, round-robin
        seg = np.asarray([r for p in planner.segment_plans for r in p],
                         dtype=np.int64)
        deg0 = np.nonzero(local < 0)[0]
        if len(seg):
            deg0 = deg0[~np.isin(deg0, seg)]
        tail = np.concatenate([seg, deg0])
        for k in range(D):
            mine = tail[k::D]
            shard[mine] = k
            local[mine] = pos + np.arange(len(mine))
        S = pos + (-(-len(tail) // D) if len(tail) else 0)
        S = -(-max(S, MIN_B) // MIN_B) * MIN_B
        return (shard * S + local), plan, int(S)

    u_newpos, u_plan, S_u = positions(row_planner)
    i_newpos, i_plan, S_i = positions(col_planner)

    def emit(planner, plan, key, val, self_newpos, other_newpos):
        key = np.asarray(key)
        indptr = planner.indptr
        per_shard: List[List[RangeBatch]] = [[] for _ in range(D)]
        for parts, start, n_pad, B, L in plan:
            for lo in range(0, n_pad, B):
                Bj = min(B, n_pad - lo)
                for k in range(D):
                    lens, cols, vals = _gather_remapped(
                        indptr, key, val, parts[k][lo:lo + Bj], Bj, L,
                        other_newpos, vals_dtype)
                    per_shard[k].append(RangeBatch(
                        row_start=np.int32(start + lo), lens=lens,
                        cols=cols, vals=vals))
        # same-shape stacking is aligned across shards by construction;
        # the shard axis goes in front
        stacked = [stack_batches(bs) for bs in per_shard]
        groups = [type(g0)(*[np.stack([np.asarray(getattr(s[i], f))
                                       for s in stacked])
                             for f in g0._fields])
                  for i, g0 in enumerate(stacked[0])]
        segments = [_remap_segment(planner, p, key, val, self_newpos,
                                   other_newpos, vals_dtype)
                    for p in planner.segment_plans]
        return groups, segments

    row_groups, row_segments = emit(row_planner, u_plan, row_key, row_val,
                                    u_newpos, i_newpos)
    col_groups, col_segments = emit(col_planner, i_plan, col_key, col_val,
                                    i_newpos, u_newpos)
    return (row_groups, col_groups, row_segments, col_segments,
            u_newpos, i_newpos, S_u, S_i)


def shard_group(group: RangeBatch, shard: int) -> RangeBatch:
    """Shard ``shard``'s slice of a stacked group of
    ``build_sharded_range_layout`` (the leading shard axis dropped)."""
    return RangeBatch(*[np.asarray(a)[shard] for a in group])


def stage_shard_groups(groups, mesh, vals_dtype=None) -> List[list]:
    """Stacked groups of ``build_sharded_range_layout`` staged per local
    shard of ``mesh``: one list of groups per shard, on its device."""
    return [[stage_batch(shard_group(g, k), dev, vals_dtype) for g in groups]
            for k, dev in zip(mesh.shards, mesh.devices)]


def split_rows(batch, parts: int, part: int):
    """Part ``part`` of ``parts`` equal row slices of a staged padded
    batch (the JAX package's batch sharding over a mesh axis: row
    ``r`` of a batch of B rows lives on shard ``r // (B / parts)``).
    A PaddedBatch's B is a multiple of the mesh size (``row_multiple``)."""
    B = batch.lens.shape[0]
    if B % parts:
        raise ValueError(f"a batch of {B} rows does not split over "
                         f"{parts} shards")
    n = B // parts
    return PaddedBatch(*[a[part * n:(part + 1) * n] for a in batch])


@dataclass
class _BucketPlan:
    L: int                    # padded row length
    B: int                    # rows per batch
    row_ids: np.ndarray       # all row ids in this bucket (int64)


class BatchPlanner:
    """Plan fixed-shape batches for one CSR orientation."""

    def __init__(self, indptr: np.ndarray, batch_mb: int = 1024,
                 entries_per_batch: Optional[int] = None,
                 row_multiple: int = 1, max_len: int = DEFAULT_MAX_L,
                 max_rows: Optional[int] = None,
                 matrix_free: bool = True):
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.num_rows = len(self.indptr) - 1
        degrees = np.diff(self.indptr)
        # 16 bytes/entry mirrors the reference's budget math
        # (buffered_data.py:47): batch_mb MB / 16 entries
        if entries_per_batch is None:
            entries_per_batch = max(int(batch_mb) * 1024 * 1024 // 16, 4096)
        self.entries_per_batch = entries_per_batch
        self.row_multiple = max(1, int(row_multiple))
        # round up to a multiple of 8 so the bucket grid lands exactly
        # on max_len; otherwise rows just below a non-multiple cap get
        # an L above it and are misrouted to the segment/scatter path
        self.max_len = -(-max(MIN_L, int(max_len)) // 8) * 8

        buckets: Dict[int, List[int]] = {}
        nonzero = np.nonzero(degrees)[0]
        grid = _bucket_lengths(self.max_len)
        if len(nonzero):
            d_nz = degrees[nonzero]
            Ls = np.where(
                d_nz > self.max_len, _next_pow2(self.max_len) * 2,
                grid[np.minimum(np.searchsorted(grid, d_nz), len(grid) - 1)])
        else:
            Ls = np.array([], dtype=np.int64)
        long_mask = Ls > self.max_len
        long_rows = nonzero[long_mask] if len(nonzero) else nonzero
        short = nonzero[~long_mask] if len(nonzero) else nonzero
        short_Ls = Ls[~long_mask] if len(nonzero) else Ls
        for L in np.unique(short_Ls):
            buckets[int(L)] = short[short_Ls == L]
        self.buckets: List[_BucketPlan] = []
        # B is a multiple of 8 (f32 sublane tile) and of row_multiple —
        # NOT pow2: padding rows still gather L fixed-side rows each, so
        # over-rounding B costs real epoch time
        bmult = MIN_B * self.row_multiple // math.gcd(MIN_B,
                                                      self.row_multiple)
        for L, row_ids in sorted(buckets.items()):
            B = max(bmult, entries_per_batch // L // bmult * bmult)
            if max_rows is not None and (not matrix_free
                                         or L > MATRIX_FREE_MAX_L):
                # the direct solve materializes a lane-padded (B, d, d)
                # system; bound rows per batch independently of the
                # entry budget.  Matrix-free CG buckets skip the cap
                # below MATRIX_FREE_MAX_L, but a consumer on a direct
                # solver (llt/ldlt) materializes the system at EVERY L,
                # so it passes matrix_free=False to cap all buckets.
                B = min(B, max(bmult, max_rows // bmult * bmult))
            # don't overshoot tiny buckets: one batch is enough
            B = min(B, -(-len(row_ids) // bmult) * bmult)
            self.buckets.append(_BucketPlan(L=L, B=B,
                                            row_ids=np.asarray(row_ids)))
        self.batch_rows_multiple = bmult
        self.segment_plans = self._plan_segments(long_rows, degrees)
        self.num_batches = sum(int(math.ceil(len(b.row_ids) / b.B))
                               for b in self.buckets) + len(self.segment_plans)

    def _plan_segments(self, long_rows: np.ndarray, degrees: np.ndarray
                       ) -> List[List[int]]:
        """Pack long rows into batches of <= entries_per_batch chunk entries.

        All chunks of a row stay in one batch (per-row stats must be
        complete within the batch); a single row always fits because
        its degree is bounded by the other axis' size.
        """
        if len(long_rows) == 0:
            return []
        C = self.max_len
        chunk_budget = max(1, self.entries_per_batch // C)
        plans: List[List[int]] = []
        cur: List[int] = []
        cur_chunks = 0
        # process big rows first so batches pack tightly
        order = np.argsort(-degrees[long_rows], kind="stable")
        for r in long_rows[order]:
            n_chunks = int(math.ceil(degrees[r] / C))
            if cur and cur_chunks + n_chunks > chunk_budget:
                plans.append(cur)
                cur, cur_chunks = [], 0
            cur.append(int(r))
            cur_chunks += n_chunks
        if cur:
            plans.append(cur)
        return plans

    def shapes(self) -> List[tuple]:
        return [(b.B, b.L) for b in self.buckets]

    def padded_entries(self) -> int:
        """Exact padded (cols) entry count of the planned epoch —
        buckets plus segment chunks.  The one number the resident /
        group-dispatch / vals-dtype budget decisions should share
        (a final partial batch is counted at full B: a tight upper
        bound)."""
        total = sum(b.B * b.L * int(math.ceil(len(b.row_ids) / b.B))
                    for b in self.buckets)
        if self.segment_plans:
            deg = np.diff(self.indptr)
            for plan in self.segment_plans:
                total += int(np.ceil(
                    deg[plan] / self.max_len).sum()) * self.max_len
        return total

    def iter_batches(self, key: np.ndarray, val: Optional[np.ndarray]
                     ) -> Iterator[PaddedBatch]:
        """Materialize padded batches from flat CSR key/val arrays."""
        indptr = self.indptr
        bmult = getattr(self, "batch_rows_multiple", MIN_B)
        key = np.asarray(key, dtype=np.int32)
        for bucket in self.buckets:
            ids = bucket.row_ids
            for start in range(0, len(ids), bucket.B):
                rows = ids[start:start + bucket.B]
                n = len(rows)
                # shrink the (always-partial) final batch of the bucket
                B = min(bucket.B, -(-n // bmult) * bmult)
                out_lens, cols, vals = _gather_remapped(
                    indptr, key, val, rows, B, bucket.L, None)
                # padding rows carry the out-of-range id num_rows so that
                # device scatters with mode="drop" ignore them
                out_rows = np.full(B, self.num_rows, dtype=np.int32)
                out_rows[:n] = rows
                yield PaddedBatch(rows=out_rows, lens=out_lens,
                                  cols=cols, vals=vals)
        for plan in self.segment_plans:
            yield self._build_segment_batch(plan, key, val)

    def _build_segment_batch(self, plan: Sequence[int], key: np.ndarray,
                             val: Optional[np.ndarray]) -> SegmentBatch:
        return build_segment_batch(self.indptr, key, val, plan,
                                   self.max_len, self.num_rows)


def pad_rows(indptr: np.ndarray, key: np.ndarray, val: Optional[np.ndarray],
             rows: np.ndarray, L: Optional[int] = None):
    """Gather the given rows of a CSR into a padded (len(rows), L) block.

    Used when a second CSR group must be fetched for the same row set
    as an existing batch (CFR's synchronized colwise+sppmi item pass,
    reference ``buffered_data.py:120-160``).  ``L`` defaults to the
    next power of two of the max degree among ``rows``.
    """
    indptr = np.asarray(indptr, dtype=np.int64)
    rows = np.asarray(rows, dtype=np.int64)
    safe = np.clip(rows, 0, len(indptr) - 2)
    beg = indptr[safe]
    lens = (indptr[safe + 1] - beg).astype(np.int32)
    lens = np.where((rows >= 0) & (rows < len(indptr) - 1), lens, 0)
    if L is None:
        L = max(MIN_L, _next_pow2(int(lens.max()) if len(lens) else 1))
    offs = np.arange(L, dtype=np.int64)[None, :]
    idx = beg[:, None] + np.minimum(offs, np.maximum(lens[:, None] - 1, 0))
    mask = offs < lens[:, None]
    cols = np.where(mask, np.asarray(key, dtype=np.int32)[idx], 0)
    if val is not None:
        vals = np.where(mask, np.asarray(val, dtype=np.float32)[idx],
                        0.0).astype(np.float32)
    else:
        vals = mask.astype(np.float32)
    return lens, cols.astype(np.int32), vals


def build_segment_batch(indptr: np.ndarray, key: np.ndarray,
                        val: Optional[np.ndarray], plan: Sequence[int],
                        chunk_width: int, num_rows: int) -> SegmentBatch:
    """Pack the given rows of a CSR into a SegmentBatch of fixed-width
    chunks (see SegmentBatch docstring); padding rows point to
    ``num_rows`` so device scatters drop them."""
    indptr = np.asarray(indptr, dtype=np.int64)
    C = int(chunk_width)
    rows = np.asarray(plan, dtype=np.int64)
    lens = (indptr[rows + 1] - indptr[rows]).astype(np.int64)
    n_chunks = np.maximum(np.ceil(lens / C).astype(np.int64), 1)
    R = max(MIN_B, -(-len(rows) // MIN_B) * MIN_B)
    Nc = max(MIN_B, -(-int(n_chunks.sum()) // MIN_B) * MIN_B)

    out_rows = np.full(R, num_rows, dtype=np.int32)
    out_rows[:len(rows)] = rows
    out_lens = np.zeros(R, dtype=np.int32)
    out_lens[:len(rows)] = lens

    seg_ids = np.full(Nc, R, dtype=np.int32)  # padding chunks -> R
    chunk_lens = np.zeros(Nc, dtype=np.int32)
    cols = np.zeros((Nc, C), dtype=np.int32)
    vals = np.zeros((Nc, C), dtype=np.float32)
    key = np.asarray(key, dtype=np.int32)
    pos = 0
    for local, (r, dlen) in enumerate(zip(rows, lens)):
        beg = int(indptr[r])
        for off in range(0, max(int(dlen), 1), C):
            n = min(C, int(dlen) - off)
            seg_ids[pos] = local
            if n > 0:
                chunk_lens[pos] = n
                cols[pos, :n] = key[beg + off:beg + off + n]
                if val is not None:
                    vals[pos, :n] = np.asarray(
                        val[beg + off:beg + off + n], dtype=np.float32)
                else:
                    vals[pos, :n] = 1.0
            pos += 1
    return SegmentBatch(rows=out_rows, lens=out_lens, seg_ids=seg_ids,
                        chunk_lens=chunk_lens, cols=cols, vals=vals)


def permute_table(T: np.ndarray, pos: np.ndarray, padded_rows: int
                  ) -> np.ndarray:
    """Place table rows at their range-layout positions (zero padding)."""
    out = np.zeros((int(padded_rows), T.shape[1]), T.dtype)
    out[pos] = T
    return out


def stack_batches(batches: Sequence) -> List:
    """Group same-shape batches and stack each field (leading axis n).

    The reference compiles one body per stacked shape; the port's
    epoch loops over a stack's leading axis, so it takes stacked and
    flat batch lists alike.  Preserves first-appearance order between groups (batch order
    within a shape is preserved by the stack).
    """
    groups: Dict[tuple, list] = {}
    order: List[tuple] = []
    for b in batches:
        key = (type(b).__name__,) + tuple(a.shape for a in b)
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(b)
    out = []
    for key in order:
        bs = groups[key]
        out.append(type(bs[0])(*[
            np.stack([np.asarray(getattr(b, f)) for b in bs])
            for f in bs[0]._fields]))
    return out




class StagedSegmentBatch(NamedTuple):
    """A ``SegmentBatch`` on a torch device, plus each row's chunk range.

    ``build_segment_batch`` emits a row's chunks contiguously and in
    row order (padding chunks last, with ``seg_ids == R``), so row ``r``
    owns chunks ``[chunk_ptr[r], chunk_ptr[r + 1])``.  The offsets are
    computed once on the host when the batch is staged; the normal-
    equation kernel walks them in order instead of a ``segment_sum``.
    """
    rows: object
    lens: object
    seg_ids: object
    chunk_lens: object
    cols: object
    vals: object
    chunk_ptr: object


def segment_chunk_ptr(seg_ids: np.ndarray, num_rows: int) -> np.ndarray:
    """int32[R + 1] chunk offsets per local row of a SegmentBatch."""
    seg_ids = np.asarray(seg_ids)
    if np.any(np.diff(seg_ids) < 0):
        raise ValueError("SegmentBatch chunks must be grouped by row")
    return np.searchsorted(seg_ids, np.arange(num_rows + 1),
                           side="left").astype(np.int32)


def _to_tensor(a, device, dtype=None):
    """``a`` as a tensor on ``device``; ``dtype`` (bfloat16 values) is
    applied on the host, rounding to nearest even as ``ml_dtypes`` does
    for the reference."""
    import torch

    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None:
        t = t.to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def stage_batch(batch, device, vals_dtype=None):
    """Move one host batch onto ``device``, field by field.

    The counterpart of ``DeviceBatcher._to_device`` in the reference
    (``jax.device_put``): array fields become tensors, copied from
    pinned host memory with ``non_blocking=True`` on a card; the values
    are converted to ``vals_dtype`` (``torch.bfloat16`` for the
    reference's bfloat16 range layout) when it is given.  A RangeBatch's
    ``row_start`` stays a host integer (or an int64 array for a stacked
    group), since the epoch loop slices with it on the host.  A
    SegmentBatch becomes a ``StagedSegmentBatch``.
    """
    import torch

    device = torch.device(device)
    if isinstance(batch, RangeBatch):
        rs = np.asarray(batch.row_start)
        return RangeBatch(
            row_start=int(rs) if rs.ndim == 0 else rs.astype(np.int64),
            lens=_to_tensor(batch.lens, device),
            cols=_to_tensor(batch.cols, device),
            vals=_to_tensor(batch.vals, device, vals_dtype))
    if isinstance(batch, PaddedBatch):
        return PaddedBatch(*[_to_tensor(a, device) for a in batch[:3]],
                           _to_tensor(batch.vals, device, vals_dtype))
    if isinstance(batch, SegmentBatch):
        seg_ids = np.asarray(batch.seg_ids)
        if seg_ids.ndim != 1:
            raise ValueError("stage SegmentBatches one at a time, "
                             "not stacked")
        ptr = segment_chunk_ptr(seg_ids, len(batch.rows))
        return StagedSegmentBatch(
            *[_to_tensor(a, device) for a in batch[:5]],
            _to_tensor(batch.vals, device, vals_dtype),
            _to_tensor(ptr, device))
    raise TypeError(f"cannot stage {type(batch).__name__}")


class _StagingRing:
    """Host batches staged onto a card one ahead of the kernels.

    Two slots, each a set of pinned host buffers and device buffers per
    field, reused from batch to batch and epoch to epoch (grown when a
    batch needs more).  ``put`` copies a batch into a slot and on to the
    card on a side stream; ``take`` makes the current stream wait for
    that copy before the kernels read the batch.  Slot ``s`` is reused
    by the batch two later: its pinned buffers after the host has seen
    its last copy finish, its device buffers after the kernels of the
    batch that read them were enqueued (the side stream waits for them).
    """

    def __init__(self, device):
        import torch

        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.buffers = [{}, {}]   # slot -> field -> (pinned, device), flat
        self.copied = [None, None]  # slot -> event of its last copy
        self.bytes = 0            # bytes copied to the card, running total

    def _buffer(self, slot, name, numel, dtype):
        import torch

        bufs = self.buffers[slot].get(name)
        if bufs is None or bufs[0].numel() < numel or bufs[0].dtype != dtype:
            # device memory comes from the current stream, whose kernels
            # are the only other users of a slot's buffers
            bufs = (torch.empty(numel, dtype=dtype, pin_memory=True),
                    torch.empty(numel, dtype=dtype, device=self.device))
            self.buffers[slot][name] = bufs
        return bufs

    def put(self, slot, batch):
        """Stage host ``batch`` (PaddedBatch or SegmentBatch) into
        ``slot``; returns (fields on the card, copy event)."""
        import torch

        if self.copied[slot] is not None:
            self.copied[slot].synchronize()
        fields = dict(zip(batch._fields, batch))
        if isinstance(batch, SegmentBatch):
            fields["chunk_ptr"] = segment_chunk_ptr(batch.seg_ids,
                                                    len(batch.rows))
        host = {k: torch.from_numpy(np.ascontiguousarray(a))
                for k, a in fields.items()}
        bufs = {k: self._buffer(slot, k, t.numel(), t.dtype)
                for k, t in host.items()}
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        out = {}
        with torch.cuda.stream(self.stream):
            for k, t in host.items():
                pin, dev = bufs[k]
                pin[:t.numel()].copy_(t.reshape(-1))
                out[k] = dev[:t.numel()].view(t.shape)
                out[k].copy_(pin[:t.numel()].view(t.shape), non_blocking=True)
                self.bytes += t.numel() * t.element_size()
            event = torch.cuda.Event()
            event.record(self.stream)
        self.copied[slot] = event
        return out, event

    def take(self, staged):
        """A staged batch, ready for kernels on the current stream."""
        import torch

        out, event = staged
        torch.cuda.current_stream(self.device).wait_event(event)
        if "chunk_ptr" in out:
            return StagedSegmentBatch(**out)
        return PaddedBatch(**out)


# past this many padded entries a single fused epoch program OOMs on
# XLA temporaries in the reference (its 730M lesson), which then
# dispatches per group; the port launches per batch either way
GROUP_DISPATCH_ENTRIES = 100 << 20


def padded_entry_count(batches: Sequence) -> int:
    """Total padded (cols) entries across a list of staged batches."""
    return sum(int(np.prod(np.asarray(b.cols).shape)) for b in batches)


def choose_group_dispatch(opt, padded_entries: int) -> bool:
    """Resolve the shared ``epoch_dispatch`` option (auto|fused|group).
    The port validates it and reports the reference's choice; its
    arithmetic is the same either way (the reference's two dispatches
    train to the same loss, ``tests/models/test_als.py``)."""
    dispatch = str(opt.get("epoch_dispatch", "auto") or "auto")
    if dispatch not in ("auto", "fused", "group"):
        raise ValueError(
            f"epoch_dispatch must be auto|fused|group, got {dispatch!r}")
    return dispatch == "group" or (
        dispatch == "auto" and padded_entries > GROUP_DISPATCH_ENTRIES)


class DeviceBatcher:
    """Plans one CSR orientation's batches and feeds them to a device.

    The counterpart of the reference's ``DeviceBatcher``
    (``buffalo_tpu/data/batching.py:691``) with the same planner inputs:
    the ``batch_mb`` entry budget sized for the gathered fixed-side rows,
    and the ``max_rows`` cap on direct-solve buckets.  When the padded
    epoch fits ``resident_mb`` (``resident``), every batch is staged
    once and kept on the device; otherwise each iteration builds the
    batches on the host (``planner.iter_batches``) and stages them one
    ahead of the kernels through a ``_StagingRing`` (the reference's
    streaming path).  Iterating yields staged ``PaddedBatch`` /
    ``StagedSegmentBatch`` tuples in the planner's order.
    """

    def __init__(self, data, axis: str = "rowwise", batch_mb: int = 1024,
                 resident_mb: int = 4096, row_multiple: int = 1,
                 max_len: int = DEFAULT_MAX_L,
                 d: Optional[int] = None, matrix_free: bool = True,
                 device="cuda"):
        self.data = data
        self.axis = axis
        group = data.get_group(axis)
        self.key = np.asarray(group["key"])
        self.val = np.asarray(group["val"]) if "val" in group else None
        # per-entry working-set: cols+vals (8B) plus, when the factor
        # dimension is known, the gathered fixed-side rows F and one
        # weighted copy (2 * 4d B)
        bytes_per_entry = 16 if d is None else 8 + 8 * int(d)
        entries = max(int(batch_mb) * 1024 * 1024 // bytes_per_entry, 4096)
        # the reference's cap for (B, d, d) solve state lane-padded to
        # 128 on a TPU, kept so both packages plan the same batches
        max_rows = None if d is None else max(
            int(batch_mb) * 1024 * 1024 // (8 * int(d) * 128), 1024)
        self.planner = BatchPlanner(np.asarray(group["indptr"]),
                                    entries_per_batch=entries,
                                    row_multiple=row_multiple,
                                    max_len=max_len, max_rows=max_rows,
                                    matrix_free=matrix_free)
        self.padded_entries = self.planner.padded_entries()
        # 8 bytes per padded entry (int32 col + f32 val) on device
        self.resident = (self.padded_entries * 8) <= \
            resident_mb * 1024 * 1024
        self.device = device
        self._device_cache: Optional[List] = None
        self._ring: Optional[_StagingRing] = None

    def device_batches(self) -> List:
        """The full epoch staged on the device, once (resident mode)."""
        if self._device_cache is None:
            self._device_cache = [
                stage_batch(b, self.device)
                for b in self.planner.iter_batches(self.key, self.val)]
        return self._device_cache

    @property
    def h2d_bytes(self) -> int:
        """Bytes the streaming iterations have copied to the card."""
        return 0 if self._ring is None else self._ring.bytes

    def __iter__(self):
        if self.resident:
            yield from self.device_batches()
            return
        import torch

        device = torch.device(self.device)
        batches = self.planner.iter_batches(self.key, self.val)
        if device.type != "cuda":
            for b in batches:
                yield stage_batch(b, device)
            return
        if self._ring is None:
            self._ring = _StagingRing(device)
        pending = None
        for i, b in enumerate(batches):
            staged = self._ring.put(i % 2, b)
            if pending is not None:
                yield self._ring.take(pending)
            pending = staged
        if pending is not None:
            yield self._ring.take(pending)

    @property
    def num_batches(self) -> int:
        return self.planner.num_batches


class COOBatcher:
    """Flat (user, item, value) chunks of fixed size for the SGD family
    (the JAX package's ``COOBatcher``, ``data/batching.py:793``).

    Positives come from the rowwise CSR expanded to COO, in the order of a
    seeded ``np.random.default_rng`` permutation per epoch (the same
    chunks as the JAX package's for the same seed); the tail chunk wraps
    around to the epoch's head to keep the chunk size.
    """

    def __init__(self, data, chunk_size: int = 1 << 20, shuffle: bool = True,
                 seed: int = 0):
        group = data.get_group("rowwise")
        indptr = np.asarray(group["indptr"], dtype=np.int64)
        self.users = np.repeat(
            np.arange(len(indptr) - 1, dtype=np.int32), np.diff(indptr))
        self.items = np.asarray(group["key"], dtype=np.int32)
        self.vals = (np.asarray(group["val"], dtype=np.float32)
                     if "val" in group else np.ones(len(self.items), np.float32))
        self.chunk_size = int(chunk_size)
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.nnz = len(self.items)

    def __iter__(self):
        order = (self.rng.permutation(self.nnz) if self.shuffle
                 else np.arange(self.nnz))
        N = self.chunk_size
        for start in range(0, self.nnz, N):
            idx = order[start:start + N]
            if len(idx) < N:  # wrap the tail to keep the chunk size
                idx = np.concatenate([idx, order[:N - len(idx)]])
            yield (self.users[idx], self.items[idx], self.vals[idx])

    @property
    def num_batches(self) -> int:
        return math.ceil(self.nnz / self.chunk_size)


def csr_pair_chunks(data, batch_size: int):
    """The rowwise CSR's (user, item) pairs in CSR order as two
    (nchunks, batch_size) int32 arrays, padded with zeros past nnz (the
    epochs mask them), and nnz: the resident epoch of the SGD family
    (the JAX package's ``bpr.py:164-188``, ``warp.py:238-256``)."""
    group = data.get_group("rowwise")
    indptr = np.asarray(group["indptr"], dtype=np.int64)
    users = np.repeat(np.arange(len(indptr) - 1, dtype=np.int32),
                      np.diff(indptr))
    items = np.array(group["key"], dtype=np.int32)
    nnz = len(items)
    nchunks = -(-nnz // batch_size)
    pad = nchunks * batch_size - nnz
    if pad:
        users = np.concatenate([users, np.zeros(pad, np.int32)])
        items = np.concatenate([items, np.zeros(pad, np.int32)])
    return (users.reshape(nchunks, batch_size),
            items.reshape(nchunks, batch_size), nnz)


def loss_triplets(data, num_users: int, num_items: int) -> List[np.ndarray]:
    """sqrt(U) fixed (u, i+, j-) triplets for the SGD family's training
    loss as int32 arrays [users, positives, negatives], drawn with
    ``np.random`` in the calls and order of the JAX package
    (``bpr.py:120-144``, ``warp.py:145-168``): the users without
    replacement, then per user |seen| + 1 items without replacement, the
    first unseen one the negative."""
    users, positives, negatives = [], [], []
    num_loss_samples = int(data.get_header()["num_users"] ** 0.5)
    _users = np.random.choice(range(num_users), size=num_loss_samples,
                              replace=False)
    for u in _users:
        keys, *_ = data.get(u)
        if len(keys) == 0:
            continue
        seen = set(map(int, keys))
        negs = [n for n in np.random.choice(
            range(num_items), size=len(seen) + 1, replace=False)
            if n not in seen]
        if not negs:
            continue
        users.append(int(u))
        positives.append(int(keys[0]))
        negatives.append(int(negs[0]))
    return [np.array(a, dtype=np.int32) for a in (users, positives,
                                                  negatives)]
