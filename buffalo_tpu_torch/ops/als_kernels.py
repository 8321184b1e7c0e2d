"""ALS batch update math: per-row normal equations over padded batches.

PyTorch counterpart of ``buffalo_tpu.ops.als_kernels`` on one device:
the bucket-order range layout (``RangeBatch``), the scatter layout and
the streaming path (``PaddedBatch``), and ``SegmentBatch`` head rows of
either.  Each batch of an epoch goes through hand-written CUDA kernels on
the card (``csrc/*.cu``):

* **K1** ``als_cg_matrix_free`` — rows with padded length
  ``L <= MATRIX_FREE_MAX_L`` under a CG optimizer: gather, loss terms,
  warm start and CG without forming the d x d system, result written in
  place (range or rows mode).
* **K2** ``als_normal_equations`` — longer rows and SegmentBatch head
  rows: the dense system ``A = FF + Fw^T F + reg I``, ``y = F^T (1 + w)``
  and the loss terms; one block per row, or per segment chunk followed
  by an ordered per-row reduction.
* **K3** ``batched_cg_dense`` — warm-started CG on K2's systems, result
  written to the row range, or scattered with padding ids skipped.
* **K4** ``ialspp_solve_batch`` — iALS++ (``optimizer="ialspp"``, auto
  at d >= 128) on every range and padded batch: block subspace CG with
  the residual cache, loss terms, result written in place; up to d = 176
  a row takes one of three forms by its length (``IALSPP_SHORT_MAX``,
  ``IALSPP_GRAM_MIN``: several short rows a block; the tile form; the
  Gram form, F^T diag(w) F from one gather on the tensor cores), wider
  rows the tile form (``ialspp_forms``).  iALS++ segment rows take K2 +
  K3, as the reference's ``manual_cg`` there.

Values are float32 or bfloat16 (the range layout's at scale); the
kernels and plain versions read them as float32.  K2-K4 take rows of any
width (past 256 floats K2 builds A in output tiles, K3 keeps a system's
vectors in shared memory, K4 gives each thread several features of a
block); K1 holds rows of at most ``K1_MAX_D`` floats by design, and the
ALS driver never sends it wider ones (d >= 128 trains with iALS++).

Over a device mesh (``parallelism``) the same kernels run per shard:
``als_epoch_sharded_range`` on the per-shard range layout, and
``als_epoch_replicated`` for the JAX driver's "dp" sharding and its "tp"
scatter and streamed paths, with the gramians, fixed sides and losses
through ``all_reduce_sum`` / ``all_gather_rows``.

Each wrapper runs its plain PyTorch version (same module, ``*_plain``)
when given CPU tensors, and launches its kernel (or raises) for CUDA
tensors; ``launches`` on each wrapper counts kernel launches.  The loss
accumulators (nume/deno) follow the reference formula (``als.cc:175-202``)
and come back per row; ``als_epoch`` sums them with one ``torch.sum``.
"""
from __future__ import annotations

import ctypes
from typing import Iterator, Optional

import torch

from buffalo_tpu_torch.data.batching import (MATRIX_FREE_MAX_L, PaddedBatch,
                                             RangeBatch, StagedSegmentBatch)
from buffalo_tpu_torch.ops.solve import (CG_SOLVERS, CHOLESKY_SOLVERS,
                                         cg_loop, cg_warm_start, solve_cg,
                                         solve_cholesky)

_P, _I64, _I32, _F32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_float)
# C signatures of the kernels' launch functions (csrc/*.cu); every one
# returns the cudaError_t of its launch
_SIGNATURES = {
    "als_cg_matrix_free": [_P, _P, _P, _P, _P, _P, _P, _I32, _P, _P, _I64,
                           _I64, _I32, _I32, _I32, _F32, _F32, _I32, _I32,
                           _F32, _I32, _F32, _I32, _P],
    "als_normal_equations": [_P, _P, _P, _P, _P, _I64, _P, _P, _P, _P, _I32,
                             _I32, _I32, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I64, _I32, _I32, _F32, _F32, _I32, _I32, _F32,
                             _I32, _P],
    "batched_cg_dense": [_P, _P, _P, _P, _P, _I64, _I64, _I32, _I32, _I32,
                         _F32, _P],
    "ialspp_solve": [_P, _P, _P, _P, _P, _I64, _P, _P, _I32, _P, _P, _I64,
                     _I32, _I32, _I32, _I32, _F32, _F32, _I32, _F32, _I32,
                     _F32, _I32, _I32, _I32, _P, _P, _P],
    "ialspp_forms": [_I32, _I32, _I32, _I32, _I32, _P],
    "ialspp_gram_workspace": [_I32, _I32, _I32, _I32, _I32, _I32, _P],
}
# K1's widest rows (F and FF^T in shared memory); the ALS driver trains
# d >= 128 with iALS++ (K4), so no model sends K1 wider ones
K1_MAX_D = 128
# K4's row classes at widths its short and Gram forms take (d <= 176;
# ``ialspp_forms`` says which forms a width takes):
# rows of at most IALSPP_SHORT_MAX entries take the short form (several rows
# a block, FF's products shared), rows of more than IALSPP_GRAM_MIN the Gram
# form (one gather into F^T diag(w) F on the tensor cores), the rest the
# tile form (a block per row, F in shared memory); chosen on the H100 at
# d = 160 by tools/k4_k20_bench.py --sweep (PERF.md)
IALSPP_SHORT_MAX = 24
IALSPP_GRAM_MIN = 304
# K4's widest block (the wide form keeps a block's vectors in registers of
# 256 threads, 32 features each)
IALSPP_MAX_BLOCK = 8192
VALS_DTYPES = (torch.float32, torch.bfloat16)


def _kernel(name: str):
    """The C launch function of kernel ``name`` (built on first use)."""
    from buffalo_tpu_torch.ops._build import launcher

    return launcher(name, _SIGNATURES[name],
                    library="ialspp_solve" if name.startswith("ialspp_")
                    else name)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           device: torch.device, ndim: int):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-d tensor, "
                         f"got shape {tuple(t.shape)}")


def _check_vals(vals, device, ndim=2):
    """vals' dtype flag for a kernel: float32 (0) or bfloat16 (1)."""
    if vals.dtype not in VALS_DTYPES:
        raise TypeError(f"vals must be float32 or bfloat16, got {vals.dtype}")
    _check("vals", vals, vals.dtype, device, ndim)
    return int(vals.dtype == torch.bfloat16)


def _check_rows(lens, cols, row_start, rows, table, device):
    """A batch's rows: a range of the table, or (rows mode) one int32 id
    per row, ids outside the table being padding."""
    B = lens.shape[0]
    if cols.shape[0] != B:
        raise ValueError("lens and cols disagree on the batch's rows")
    if rows is None:
        if row_start < 0 or row_start + B > table.shape[0]:
            raise ValueError(f"rows [{row_start}, {row_start + B}) past a "
                             f"table of {table.shape[0]}")
    else:
        _check("rows", rows, torch.int32, device, 1)
        if rows.shape[0] != B:
            raise ValueError("rows and lens disagree on the batch's rows")


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def _check_tables(table, Bf, FF, device):
    _check("table", table, torch.float32, device, 2)
    _check("Bf", Bf, torch.float32, device, 2)
    _check("FF", FF, torch.float32, device, 2)
    d = table.shape[1]
    if Bf.shape[1] != d or tuple(FF.shape) != (d, d):
        raise ValueError(f"width mismatch: table {tuple(table.shape)}, "
                         f"Bf {tuple(Bf.shape)}, FF {tuple(FF.shape)}")
    return d


# ---------------------------------------------------------------- plain
def _loss_rows(p, F, FF, w, mask, row_mask, ada, *, reg, item_axis,
               num_fixed_rows):
    """Per-row loss terms of ``_loss_terms`` (``als_kernels.py:77``),
    pre-update ``p``; w already carries alpha and the mask."""
    nume = row_mask * ada * reg * (p * p).sum(-1)
    deno = torch.zeros_like(nume)
    if item_axis:
        dots = torch.einsum("bd,bld->bl", p, F)
        pos = mask * (-dots * dots + (dots - 1.0) ** 2 * (1.0 + w))
        pFFp = torch.einsum("bd,de,be->b", p, FF, p)
        nume = nume + row_mask * (pFFp + pos.sum(-1))
        deno = row_mask * (num_fixed_rows + w.sum(-1))
    return nume, deno


def _entry_mask(lens, L, dtype):
    """(rows, L) mask of the valid entries of each padded row."""
    return (torch.arange(L, device=lens.device)[None, :]
            < lens[:, None]).to(dtype)


def _row_weights(lens, adaptive_reg, dtype):
    """(row_mask, ada): rows with entries, and the regularization scale
    (the row length under ``adaptive_reg``, else 1)."""
    row_mask = (lens > 0).to(dtype)
    ada = lens.to(dtype) if adaptive_reg else torch.ones_like(row_mask)
    return row_mask, ada


def als_cg_matrix_free_plain(table, Bf, FF, row_start, lens, cols, vals, *,
                             rows=None, alpha, reg, adaptive_reg, cg_iters,
                             cg_tol, item_axis, num_fixed_rows, compute_loss):
    """Plain version of K1: ``als_solve_batch``'s matrix-free branch
    (``als_kernels.py:157-162``) on ``table[row_start:row_start+B]`` or,
    in rows mode, ``table[rows]`` (ids outside the table skipped),
    written back in place.  Returns per-row (nume, deno)."""
    B, L = cols.shape
    dt = table.dtype
    idx, write = _target_rows(table, lens, row_start, rows)
    p = table[idx.clamp(0, table.shape[0] - 1)]
    F = Bf[cols.long()]
    mask = _entry_mask(lens, L, dt)
    row_mask, ada = _row_weights(lens, adaptive_reg, dt)
    w = vals.to(dt) * alpha * mask
    if compute_loss:
        nume, deno = _loss_rows(p, F, FF, w, mask, row_mask, ada, reg=reg,
                                item_axis=item_axis,
                                num_fixed_rows=num_fixed_rows)
    else:
        nume = deno = table.new_zeros(B)
    y = torch.einsum("bld,bl->bd", F, (1.0 + w) * mask)
    reg_vec = (reg * ada)[:, None]

    def matvec(x):
        dense = x @ FF + reg_vec * x
        fx = torch.einsum("bld,bd->bl", F, x)
        return dense + torch.einsum("bld,bl->bd", F, fx * w)

    x, r = cg_warm_start(matvec, y, p)
    x = cg_loop(matvec, x, r, cg_iters, cg_tol)
    table[idx[write]] = x[write]
    return _skipped_zero(nume, write, lens), _skipped_zero(deno, write, lens)


def _skipped_zero(terms, write, lens):
    """Loss terms of the rows a kernel skips (ids outside the table) set
    to 0, as the kernels leave them; rows with len 0 have 0 already."""
    return torch.where(write | (lens <= 0), terms, torch.zeros_like(terms))


def _segment_ids(chunk_ptr, num_chunks):
    """Local row of each chunk (padding chunks -> R), from the offsets."""
    R = chunk_ptr.shape[0] - 1
    counts = (chunk_ptr[1:] - chunk_ptr[:-1]).long()
    seg = torch.full((num_chunks,), R, dtype=torch.long,
                     device=chunk_ptr.device)
    seg[:int(chunk_ptr[-1])] = torch.repeat_interleave(
        torch.arange(R, device=chunk_ptr.device), counts)
    return seg


def als_normal_equations_plain(table, Bf, FF, lens, cols, vals, *,
                               row_start=0, rows=None, chunk_ptr=None,
                               chunk_lens=None, alpha, reg, adaptive_reg,
                               item_axis, num_fixed_rows, compute_loss):
    """Plain version of K2.  Range mode (``chunk_ptr is None``): the dense
    branch of ``als_solve_batch`` (``_row_stats`` + A assembly,
    ``als_kernels.py:164-167``) for ``table[row_start:row_start+R]`` or,
    with ``rows``, ``table[rows]`` (a PaddedBatch: ids outside the table
    get zero loss terms).  Segment mode: ``als_solve_segment_batch``'s
    per-chunk statistics and ``segment_sum`` (``:268-297``), chunks of
    row r at ``[chunk_ptr[r], chunk_ptr[r+1])``.  Returns (A (R, d, d),
    y (R, d), nume (R,), deno (R,))."""
    R = lens.shape[0]
    n, d = table.shape
    dt = table.dtype
    F = Bf[cols.long()]
    row_mask, ada = _row_weights(lens, adaptive_reg, dt)
    nume = deno = table.new_zeros(R)
    if chunk_ptr is None:
        idx, write = _target_rows(table, lens, row_start, rows)
        p = table[idx.clamp(0, n - 1)]
        mask = _entry_mask(lens, cols.shape[1], dt)
        w = vals.to(dt) * alpha * mask
        A_data = torch.einsum("bld,ble->bde", F * w[:, :, None], F)
        y = torch.einsum("bld,bl->bd", F, (1.0 + w) * mask)
        if compute_loss:
            nume, deno = (_skipped_zero(t, write, lens) for t in _loss_rows(
                p, F, FF, w, mask, row_mask, ada, reg=reg,
                item_axis=item_axis, num_fixed_rows=num_fixed_rows))
    else:
        p = table[rows.long().clamp(max=n - 1)]
        Nc, C = cols.shape
        seg = _segment_ids(chunk_ptr, Nc)

        def segment_sum(x):
            return table.new_zeros((R + 1,) + x.shape[1:]).index_add_(
                0, seg, x)[:R]

        mask = _entry_mask(chunk_lens, C, dt)
        w = vals.to(dt) * alpha * mask
        A_data = segment_sum(
            torch.einsum("ncd,nce->nde", F * w[:, :, None], F))
        y = segment_sum(torch.einsum("ncd,nc->nd", F, (1.0 + w) * mask))
        if compute_loss:
            nume = row_mask * ada * reg * (p * p).sum(-1)
            if item_axis:
                p_chunk = torch.cat([p, p.new_zeros(1, d)])[seg]
                dots = torch.einsum("ncd,nd->nc", F, p_chunk)
                pos = mask * (-dots * dots + (dots - 1.0) ** 2 * (1.0 + w))
                pFFp = torch.einsum("rd,de,re->r", p, FF, p)
                nume = nume + row_mask * (pFFp + segment_sum(pos.sum(-1)))
                deno = row_mask * (num_fixed_rows + segment_sum(w.sum(-1)))
    eye = torch.eye(d, device=table.device, dtype=dt)
    A = FF[None] + A_data + (reg * ada)[:, None, None] * eye[None]
    return A, y, nume, deno


def _target_rows(table, lens, row_start, rows):
    """(row index (R,), write mask (R,)) of a batch's solve results:
    rows with len 0 keep p, padding ids past the table are skipped (the
    reference drops them with ``mode="drop"``)."""
    R = lens.shape[0]
    if rows is None:
        idx = torch.arange(row_start, row_start + R, device=table.device)
    else:
        idx = rows.long()
    return idx, (lens > 0) & (idx >= 0) & (idx < table.shape[0])


def batched_cg_dense_plain(A, y, table, lens, *, row_start=0, rows=None,
                           cg_iters, cg_tol):
    """Plain version of K3: ``solve_cg`` (``solve.py:83``) from the
    current rows, then the result write (``als_kernels.py:351,372``)."""
    idx, write = _target_rows(table, lens, row_start, rows)
    p = table[idx.clamp(0, table.shape[0] - 1)]
    x = solve_cg(A, y, p, num_iters=cg_iters, tolerance=cg_tol)
    table[idx[write]] = x[write]


def ialspp_solve_batch_plain(table, Bf, FF, lens, cols, vals, *, row_start=0,
                            rows=None, alpha, reg, adaptive_reg, block_size,
                            cg_tol, item_axis, num_fixed_rows, compute_loss,
                            steps=3):
    """Plain version of K4: ``ialspp_solve_batch`` (``als_kernels.py:
    174-238``) on ``table[row_start:row_start+B]`` or, in rows mode,
    ``table[rows]`` (ids outside the table skipped), written back in
    place.  The solve uses plain ``reg`` (``adaptive_reg`` scales only the
    loss's regularization term), ``steps`` CG steps from zero per block of
    ``block_size`` features (3, the reference's; a check's power is shown
    with fewer), and the loss terms of the pre-update rows.  Returns
    per-row (nume, deno)."""
    B, L = cols.shape
    n, d = table.shape
    dt = table.dtype
    idx, write = _target_rows(table, lens, row_start, rows)
    p = table[idx.clamp(0, n - 1)]
    F = Bf[cols.long()]
    mask = _entry_mask(lens, L, dt)
    row_mask, ada = _row_weights(lens, adaptive_reg, dt)
    w = vals.to(dt) * alpha * mask
    if compute_loss:
        nume, deno = (_skipped_zero(t, write, lens) for t in _loss_rows(
            p, F, FF, w, mask, row_mask, ada, reg=reg, item_axis=item_axis,
            num_fixed_rows=num_fixed_rows))
    else:
        nume = deno = table.new_zeros(B)
    Yui = torch.einsum("bd,bld->bl", p, F)
    for beg in range(0, d, block_size):
        end = min(beg + block_size, d)
        Fb = F[:, :, beg:end]
        gram_cols = FF[:, beg:end]
        A = gram_cols[beg:end] + reg * torch.eye(end - beg, dtype=dt,
                                                 device=table.device)
        p_blk = p[:, beg:end]
        b = (p @ gram_cols + reg * p_blk
             + torch.einsum("bl,bld->bd", (Yui - 1.0) * w, Fb))

        def matvec(v):
            data = torch.einsum(
                "bl,bld->bd", torch.einsum("bld,bd->bl", Fb, v) * w, Fb)
            return v @ A.T + data

        # 3-step CG from zero start (als.cc:322-345)
        x = cg_loop(matvec, torch.zeros_like(b), b, steps, cg_tol)
        x = x * row_mask[:, None]
        p = torch.cat([p[:, :beg], p_blk - x, p[:, end:]], dim=1)
        Yui = Yui - torch.einsum("bld,bd->bl", Fb, x)
    table[idx[write]] = p[write]
    return nume, deno


# ------------------------------------------------------------- wrappers
def als_cg_matrix_free(table, Bf, FF, row_start, lens, cols, vals, *,
                       rows=None, alpha, reg, adaptive_reg, cg_iters, cg_tol,
                       item_axis, num_fixed_rows, compute_loss):
    """K1: fused matrix-free row CG for rows of at most 96 entries.

    Replaces ``_solve_cg_matrix_free`` + the CG branch of
    ``als_solve_batch`` + ``_loss_terms`` + the batch gather/write
    (``buffalo_tpu/ops/als_kernels.py:103,157-162,77,337-372``).
    Updates ``table[row_start:row_start+B]`` (a RangeBatch) or, in rows
    mode, ``table[rows]`` (a PaddedBatch; ids outside the table are
    skipped) in place and returns the per-row (nume, deno), zeros when
    ``compute_loss`` is off.
    """
    if table.device.type == "cpu":
        return als_cg_matrix_free_plain(
            table, Bf, FF, row_start, lens, cols, vals, rows=rows,
            alpha=alpha, reg=reg, adaptive_reg=adaptive_reg,
            cg_iters=cg_iters, cg_tol=cg_tol, item_axis=item_axis,
            num_fixed_rows=num_fixed_rows, compute_loss=compute_loss)
    dev = table.device
    d = _check_tables(table, Bf, FF, dev)
    if d > K1_MAX_D:
        raise ValueError(
            f"als_cg_matrix_free (K1) holds rows of at most {K1_MAX_D} "
            f"floats, got {d}: ALS trains d >= 128 with iALS++ (K4), so no "
            "model routes wider rows here")
    _check("lens", lens, torch.int32, dev, 1)
    _check("cols", cols, torch.int32, dev, 2)
    bf16 = _check_vals(vals, dev)
    B, L = cols.shape
    if L > MATRIX_FREE_MAX_L:
        raise ValueError(f"als_cg_matrix_free takes L <= "
                         f"{MATRIX_FREE_MAX_L}, got {L}")
    _check_rows(lens, cols, row_start, rows, table, dev)
    nume = torch.zeros(B, device=dev)
    deno = torch.zeros(B, device=dev)
    rc = _kernel("als_cg_matrix_free")(
        _ptr(table), _ptr(Bf), _ptr(FF), _ptr(lens), _ptr(rows), _ptr(cols),
        _ptr(vals), bf16, _ptr(nume), _ptr(deno),
        0 if rows is not None else int(row_start), table.shape[0], B, L, d,
        float(alpha), float(reg), int(bool(adaptive_reg)), int(cg_iters),
        float(cg_tol), int(bool(item_axis)), float(num_fixed_rows),
        int(bool(compute_loss)), _stream(dev))
    _raise_on(rc, "als_cg_matrix_free")
    als_cg_matrix_free.launches += 1
    return nume, deno


als_cg_matrix_free.launches = 0


def als_normal_equations(table, Bf, FF, lens, cols, vals, *, row_start=0,
                         rows=None, chunk_ptr=None, chunk_lens=None, alpha,
                         reg, adaptive_reg, item_axis, num_fixed_rows,
                         compute_loss):
    """K2: per-row dense normal equations and loss terms.

    Replaces ``_row_stats`` + the A assembly (``als_kernels.py:65,
    164-167``) for rows with L > 96 (a RangeBatch's range, or a
    PaddedBatch's ``rows``), and the per-chunk statistics +
    ``segment_sum`` of ``als_solve_segment_batch`` (``:268-282``) for
    SegmentBatch rows (``chunk_ptr`` given), plus ``_loss_terms``
    (``:77``, ``:284-297``).  Returns (A, y, nume, deno) for K3.  Segment
    mode runs as two kernels of one launch call: per-chunk statistics,
    then an ordered per-row reduction (counted as one launch).
    """
    kw = dict(row_start=row_start, rows=rows, chunk_ptr=chunk_ptr,
              chunk_lens=chunk_lens, alpha=alpha, reg=reg,
              adaptive_reg=adaptive_reg, item_axis=item_axis,
              num_fixed_rows=num_fixed_rows, compute_loss=compute_loss)
    if table.device.type == "cpu":
        return als_normal_equations_plain(table, Bf, FF, lens, cols, vals,
                                          **kw)
    dev = table.device
    d = _check_tables(table, Bf, FF, dev)
    _check("lens", lens, torch.int32, dev, 1)
    _check("cols", cols, torch.int32, dev, 2)
    bf16 = _check_vals(vals, dev)
    R = lens.shape[0]
    if chunk_ptr is None:
        _check_rows(lens, cols, row_start, rows, table, dev)
    else:
        _check("rows", rows, torch.int32, dev, 1)
        _check("chunk_ptr", chunk_ptr, torch.int32, dev, 1)
        _check("chunk_lens", chunk_lens, torch.int32, dev, 1)
        if rows.shape[0] != R or chunk_ptr.shape[0] != R + 1 \
                or chunk_lens.shape[0] != cols.shape[0]:
            raise ValueError("bad SegmentBatch for als_normal_equations")
    A = torch.empty(R, d, d, device=dev)
    y = torch.empty(R, d, device=dev)
    nume = torch.zeros(R, device=dev)
    deno = torch.zeros(R, device=dev)
    Nc = 0 if chunk_ptr is None else cols.shape[0]
    # chunk partials of the segment mode: A, y, loss terms, sum of w
    part = [torch.empty(Nc, d, d, device=dev), torch.empty(Nc, d, device=dev),
            torch.empty(Nc, device=dev), torch.empty(Nc, device=dev)] \
        if Nc else [None] * 4
    rc = _kernel("als_normal_equations")(
        _ptr(table), _ptr(Bf), _ptr(FF), _ptr(lens), _ptr(rows),
        0 if rows is not None else int(row_start), _ptr(chunk_ptr),
        _ptr(chunk_lens), _ptr(cols), _ptr(vals), bf16, cols.shape[1], Nc,
        *map(_ptr, part), _ptr(A), _ptr(y), _ptr(nume), _ptr(deno),
        table.shape[0], R, d, float(alpha), float(reg),
        int(bool(adaptive_reg)), int(bool(item_axis)), float(num_fixed_rows),
        int(bool(compute_loss)), _stream(dev))
    _raise_on(rc, "als_normal_equations")
    als_normal_equations.launches += 1
    return A, y, nume, deno


als_normal_equations.launches = 0


def batched_cg_dense(A, y, table, lens, *, row_start=0, rows=None,
                     cg_iters, cg_tol):
    """K3: warm-started batched CG on dense SPD systems, in place.

    Replaces ``solve_cg`` (``solve.py:83``: ``cg_warm_start`` +
    ``cg_loop``) and the result write (``als_kernels.py:351,372``):
    system b starts from its current table row and its result goes to
    ``row_start + b`` (range) or ``rows[b]`` (scatter); rows with len 0
    and padding ids past the table are skipped.
    """
    if table.device.type == "cpu":
        return batched_cg_dense_plain(A, y, table, lens, row_start=row_start,
                                      rows=rows, cg_iters=cg_iters,
                                      cg_tol=cg_tol)
    dev = table.device
    _check("A", A, torch.float32, dev, 3)
    _check("y", y, torch.float32, dev, 2)
    _check("table", table, torch.float32, dev, 2)
    _check("lens", lens, torch.int32, dev, 1)
    R, d = y.shape
    if tuple(A.shape) != (R, d, d) or table.shape[1] != d \
            or lens.shape[0] != R:
        raise ValueError("shape mismatch in batched_cg_dense")
    if rows is None:
        if row_start < 0 or row_start + R > table.shape[0]:
            raise ValueError("row range past the table")
    else:
        _check("rows", rows, torch.int32, dev, 1)
    rc = _kernel("batched_cg_dense")(
        _ptr(A), _ptr(y), _ptr(table), _ptr(lens), _ptr(rows),
        int(row_start), table.shape[0], R, d, int(cg_iters), float(cg_tol),
        _stream(dev))
    _raise_on(rc, "batched_cg_dense")
    batched_cg_dense.launches += 1


batched_cg_dense.launches = 0


def ialspp_solve_batch(table, Bf, FF, lens, cols, vals, *, row_start=0,
                       rows=None, alpha, reg, adaptive_reg, block_size,
                       cg_tol, item_axis, num_fixed_rows, compute_loss):
    """K4: iALS++ block subspace CG for a RangeBatch or PaddedBatch.

    Replaces ``ialspp_solve_batch`` + ``_loss_terms`` + the batch
    gather/write (``buffalo_tpu/ops/als_kernels.py:174-238,77,343-372``).
    Updates ``table[row_start:row_start+B]`` or, in rows mode,
    ``table[rows]`` (ids outside the table skipped) in place and returns
    the per-row (nume, deno), zeros when ``compute_loss`` is off.
    """
    kw = dict(row_start=row_start, rows=rows, alpha=alpha, reg=reg,
              adaptive_reg=adaptive_reg, block_size=block_size,
              cg_tol=cg_tol, item_axis=item_axis,
              num_fixed_rows=num_fixed_rows, compute_loss=compute_loss)
    if table.device.type == "cpu":
        return ialspp_solve_batch_plain(table, Bf, FF, lens, cols, vals, **kw)
    dev = table.device
    d = _check_tables(table, Bf, FF, dev)
    if not 1 <= min(block_size, d) <= IALSPP_MAX_BLOCK:
        raise ValueError(f"block_size must be in [1, {IALSPP_MAX_BLOCK}], "
                         f"got {block_size}")
    _check("lens", lens, torch.int32, dev, 1)
    _check("cols", cols, torch.int32, dev, 2)
    bf16 = _check_vals(vals, dev)
    _check_rows(lens, cols, row_start, rows, table, dev)
    B, L = cols.shape
    nume = torch.zeros(B, device=dev)
    deno = torch.zeros(B, device=dev)
    bs = min(int(block_size), d)
    sizes = _ialspp_workspace(d, bs, B, L)
    # the Gram form's pieces of split rows: partial sums, counts zeroed
    gws = torch.empty(sizes[0], device=dev) if sizes[0] else None
    gcnt = (torch.zeros(sizes[1], dtype=torch.int32, device=dev)
            if sizes[1] else None)
    rc = _kernel("ialspp_solve")(
        _ptr(table), _ptr(Bf), _ptr(FF), _ptr(lens), _ptr(rows),
        0 if rows is not None else int(row_start), _ptr(cols), _ptr(vals),
        bf16, _ptr(nume), _ptr(deno), table.shape[0], B, L, d, bs,
        float(alpha), float(reg), int(bool(adaptive_reg)),
        float(cg_tol), int(bool(item_axis)), float(num_fixed_rows),
        int(bool(compute_loss)), IALSPP_SHORT_MAX, IALSPP_GRAM_MIN,
        _ptr(gws), _ptr(gcnt), _stream(dev))
    _raise_on(rc, "ialspp_solve")
    ialspp_solve_batch.launches += 1
    return nume, deno


ialspp_solve_batch.launches = 0


_IALSPP_WS = {}


def _ialspp_workspace(d, block_size, B, L):
    """(float32 words, int32 words) of K4's Gram-form workspace for a batch
    (the C query ``ialspp_gram_workspace``), cached per shape and class
    bounds."""
    key = (d, block_size, B, L, IALSPP_SHORT_MAX, IALSPP_GRAM_MIN)
    if key not in _IALSPP_WS:
        sizes = (ctypes.c_int64 * 2)()
        _raise_on(_kernel("ialspp_gram_workspace")(
            d, block_size, B, L, IALSPP_SHORT_MAX, IALSPP_GRAM_MIN,
            ctypes.cast(sizes, ctypes.c_void_p)), "ialspp_gram_workspace")
        _IALSPP_WS[key] = (int(sizes[0]), int(sizes[1]))
    return _IALSPP_WS[key]


def ialspp_forms(d, block_size, L=None):
    """K4's forms for rows of ``d`` floats (the C query ``ialspp_forms``):
    {"form": "short+tile+gram", or "tile" where every row takes the tile
    form; the class bounds; each form's shared memory (bytes) and blocks
    per SM, the short form's rows per block}, at a batch of padded length
    ``L`` (default: one past the Gram bound).  Needs a card."""
    out = (ctypes.c_int * 8)()
    lo, hi = IALSPP_SHORT_MAX, IALSPP_GRAM_MIN
    _raise_on(_kernel("ialspp_forms")(
        int(d), min(int(block_size), int(d)), int(lo), int(hi),
        int(L or hi + 1), ctypes.cast(out, ctypes.c_void_p)), "ialspp_forms")
    tile = dict(tile_smem_bytes=out[6], tile_blocks_per_sm=out[7])
    if not out[0]:
        return dict(form="tile", **tile)
    return dict(form="short+tile+gram", short_max=lo, gram_min=hi,
                short_smem_bytes=out[1], short_blocks_per_sm=out[2],
                short_rows_per_block=out[5], gram_smem_bytes=out[3],
                gram_blocks_per_sm=out[4], **tile)


KERNELS = (als_cg_matrix_free, als_normal_equations, batched_cg_dense,
           ialspp_solve_batch)


# --------------------------------------------------------------- epoch
def gramian(X: torch.Tensor) -> torch.Tensor:
    """``X^T X`` (a plain dense product, left to cuBLAS)."""
    return torch.matmul(X.T, X)


def _solve_into(table, A, y, lens, *, optimizer, cg_iters, cg_tol,
                row_start=0, rows=None):
    if optimizer in CG_SOLVERS:
        batched_cg_dense(A, y, table, lens, row_start=row_start, rows=rows,
                         cg_iters=cg_iters, cg_tol=cg_tol)
    elif optimizer in CHOLESKY_SOLVERS:
        x = solve_cholesky(A, y)
        idx, write = _target_rows(table, lens, row_start, rows)
        table[idx[write]] = x[write]
    else:
        raise ValueError(f"Unknown optimizer: {optimizer}")


def _apply_batch(A, Bf, FF, batch, *, optimizer, cg_iters, cg_tol,
                 block_size, **common):
    """Update table ``A`` with one staged batch (``data.batching.
    stage_batch``): a RangeBatch's row range, or a PaddedBatch's or
    SegmentBatch's rows.  Returns per-row (nume, deno)."""
    if isinstance(batch, StagedSegmentBatch):
        # iALS++ solves head rows as manual_cg does (als_kernels.py:299)
        Asys, y, nume, deno = als_normal_equations(
            A, Bf, FF, batch.lens, batch.cols, batch.vals, rows=batch.rows,
            chunk_ptr=batch.chunk_ptr, chunk_lens=batch.chunk_lens,
            **common)
        _solve_into(A, Asys, y, batch.lens,
                    optimizer="manual_cg" if optimizer == "ialspp"
                    else optimizer,
                    cg_iters=max(cg_iters, 3), cg_tol=cg_tol,
                    rows=batch.rows)
        return nume, deno
    if isinstance(batch, RangeBatch):
        where = dict(row_start=batch.row_start)
    elif isinstance(batch, PaddedBatch):
        where = dict(rows=batch.rows)
    else:
        raise TypeError(f"unexpected batch type {type(batch).__name__}; "
                        "stage batches with data.batching.stage_batch")
    if optimizer == "ialspp":
        return ialspp_solve_batch(A, Bf, FF, batch.lens, batch.cols,
                                  batch.vals, block_size=block_size,
                                  cg_tol=cg_tol, **where, **common)
    if optimizer in CG_SOLVERS and batch.cols.shape[1] <= MATRIX_FREE_MAX_L:
        return als_cg_matrix_free(
            A, Bf, FF, where.get("row_start", 0), batch.lens, batch.cols,
            batch.vals, rows=where.get("rows"), cg_iters=cg_iters,
            cg_tol=cg_tol, **common)
    Asys, y, nume, deno = als_normal_equations(
        A, Bf, FF, batch.lens, batch.cols, batch.vals, **where, **common)
    _solve_into(A, Asys, y, batch.lens, optimizer=optimizer,
                cg_iters=cg_iters, cg_tol=cg_tol, **where)
    return nume, deno


def _flat(batches) -> Iterator:
    """Batches one at a time: a stacked RangeBatch group (leading axis
    n, the reference's ``lax.scan`` input) is walked along that axis."""
    for b in batches:
        if isinstance(b, RangeBatch) and b.lens.dim() == 2:
            for i in range(b.lens.shape[0]):
                yield RangeBatch(int(b.row_start[i]), b.lens[i], b.cols[i],
                                 b.vals[i])
        else:
            yield b


def als_half_epoch(A, Bf, batches, *, reg, item_axis, num_fixed_rows,
                   FF=None, **common):
    """One half of an epoch: ``FF = Bf^T Bf``, then every batch of
    ``batches`` (a list, or an iterable that stages them as it goes, the
    streaming path) updates its rows of ``A`` in place.  The counterpart
    of the reference's ``gramian_step`` + ``als_group_step`` loop and of
    its streaming loop over ``als_batch_step`` (``models/als.py:
    161-170,212-238``).  Returns the per-row (nume, deno) of every batch,
    concatenated.  ``FF`` given (a mesh's all-reduced gramian) replaces
    ``Bf^T Bf``."""
    FF = gramian(Bf) if FF is None else FF
    numes, denos = [], []
    for batch in _flat(batches):
        n, dn = _apply_batch(A, Bf, FF, batch, reg=reg, item_axis=item_axis,
                             num_fixed_rows=num_fixed_rows, **common)
        numes.append(n)
        denos.append(dn)
    return numes, denos


def als_epoch(P, Q, row_batches, col_batches, *, optimizer, alpha, reg_u,
              reg_i, adaptive_reg, cg_iters, cg_tol, block_size,
              compute_loss, num_p_rows=None, num_q_rows=None):
    """One full ALS epoch: gramian + rowwise half + colwise half.

    Counterpart of ``buffalo_tpu.ops.als_kernels.als_epoch`` over staged
    batches (``data.batching.stage_batch``) of any layout, or iterables
    that stage them (``data.batching.DeviceBatcher``).  P and Q are
    updated in place (and returned).  Returns (P, Q, nume, deno) with 0-d
    tensors.
    """
    common = dict(optimizer=optimizer, alpha=alpha,
                  adaptive_reg=adaptive_reg, cg_iters=cg_iters,
                  cg_tol=cg_tol, block_size=block_size,
                  compute_loss=compute_loss)
    numes, denos = als_half_epoch(
        P, Q, row_batches, reg=reg_u, item_axis=False,
        num_fixed_rows=num_q_rows or Q.shape[0], **common)
    n2, d2 = als_half_epoch(
        Q, P, col_batches, reg=reg_i, item_axis=True,
        num_fixed_rows=num_p_rows or P.shape[0], **common)
    numes, denos = numes + n2, denos + d2
    if not numes:
        zero = P.new_zeros(())
        return P, Q, zero, zero
    return P, Q, torch.cat(numes).sum(), torch.cat(denos).sum()


# ------------------------------------------------------------ device mesh
def _half_terms(A, Bf, FF, batches, **kw):
    """``als_half_epoch`` with the gramian ``FF`` given; (nume, deno)
    summed, as one (2,) tensor."""
    numes, denos = als_half_epoch(A, Bf, batches, FF=FF, **kw)
    if not numes:
        return A.new_zeros(2)
    return torch.stack([torch.cat(numes).sum(), torch.cat(denos).sum()])


def _sharded_half(mesh, A, Bf, groups, segments, **kw):
    """One half over row-sharded tables (``sharded_half`` of
    ``als_epoch_sharded_range``, ``als_kernels.py:480``): the gramian as an
    all-reduce of per-shard partial products, the fixed side all-gathered
    (once per device), each shard's range batches into its own shard, then
    the segment batches (global ids) on the gathered table of this
    process's first device, their rows written back into the shards that
    own them.  Returns the per-shard (nume, deno) and the segments'."""
    from buffalo_tpu_torch import parallelism as par

    FF = par.all_reduce_sum(mesh, [gramian(b) for b in Bf])
    Bf_full = par.all_gather_rows(mesh, Bf)
    parts = [_half_terms(a, bf, ff, g, **kw)
             for a, bf, ff, g in zip(A, Bf_full, FF, groups)]
    seg = A[0].new_zeros(2)
    if segments:
        A_full = par.all_gather_rows(mesh, A, first_only=True)
        seg = _half_terms(A_full, Bf_full[0], FF[0], segments, **kw)
        par.write_back(mesh, A, A_full)
    return parts, seg


def als_epoch_sharded_range(P, Q, row_groups, col_groups, row_segments,
                            col_segments, *, mesh, optimizer, alpha, reg_u,
                            reg_i, adaptive_reg, cg_iters, cg_tol,
                            block_size, compute_loss, num_p_rows,
                            num_q_rows):
    """One ALS epoch over a device mesh on the per-shard range layout.

    Counterpart of ``buffalo_tpu.ops.als_kernels.als_epoch_sharded_range``
    (:480).  ``P`` / ``Q``: this process's row shards (one tensor per
    local shard of ``mesh``, in the per-shard bucket order of
    ``build_sharded_range_layout``); ``row_groups`` / ``col_groups``: per
    local shard, its staged groups (local ``row_start``); ``*_segments``:
    staged SegmentBatches with global ids on the mesh's first device.
    Every batch runs on the single-device kernels (K1, K2 + K3, K4); the
    shards are updated in place.  nume/deno are summed over the shards
    (an all-reduce) plus the segments' (computed once per process, as the
    JAX program computes them replicated).  Returns (P, Q, nume, deno).
    """
    from buffalo_tpu_torch import parallelism as par

    common = dict(optimizer=optimizer, alpha=alpha,
                  adaptive_reg=adaptive_reg, cg_iters=cg_iters,
                  cg_tol=cg_tol, block_size=block_size,
                  compute_loss=compute_loss)
    p1, s1 = _sharded_half(mesh, P, Q, row_groups, row_segments, reg=reg_u,
                           item_axis=False, num_fixed_rows=num_q_rows,
                           **common)
    p2, s2 = _sharded_half(mesh, Q, P, col_groups, col_segments, reg=reg_i,
                           item_axis=True, num_fixed_rows=num_p_rows,
                           **common)
    total = par.all_reduce_sum(mesh, [a + b for a, b in zip(p1, p2)])[0]
    total = total + s1 + s2
    return P, Q, total[0], total[1]


def _replica_half(mesh, reps, Bf, FF, batches, **kw):
    """One half over replicated tables (the JAX package's "dp" sharding,
    and its "tp" scatter path once the table is gathered): each local
    shard solves its slice of every padded batch's rows
    (``data.batching.split_rows``) into its device's replica; a segment
    batch runs whole on the first replica.  When the mesh spans processes
    or devices, the solved rows then reach every replica through one
    all-reduce of a table holding only the rows this process solved
    (every row is solved by exactly one shard; the segment rows are added
    by the first process).  Returns the per-shard (nume, deno) and the
    segments'."""
    from buffalo_tpu_torch import parallelism as par
    from buffalo_tpu_torch.data.batching import split_rows

    parts = [reps[0].new_zeros(2) for _ in mesh.devices]
    seg = reps[0].new_zeros(2)
    mine = [[] for _ in mesh.devices]
    every, seg_rows = [], []
    for batch in _flat(batches):
        if isinstance(batch, StagedSegmentBatch):
            seg = seg + _half_terms(reps[0], Bf[0], FF[0], [batch], **kw)
            seg_rows.append(batch.rows)
            continue
        every.append(batch.rows)
        for j, g in enumerate(mesh.shards):
            sub = split_rows(batch, mesh.size, g)
            if sub.rows.device != reps[j].device:
                sub = type(sub)(*[a.to(reps[j].device) for a in sub])
            parts[j] = parts[j] + _half_terms(reps[j], Bf[j], FF[j], [sub],
                                              **kw)
            mine[j].append(sub.rows)
    if mesh.group is None and len(mesh.unique_devices) == 1:
        return parts, seg
    n, dev0 = reps[0].shape[0], reps[0].device

    def valid(rows, device):
        r = torch.cat(rows).long().to(device)
        return r[r < n]

    contrib = torch.zeros_like(reps[0])
    for j, rows in enumerate(mine):
        if rows:
            r = valid(rows, reps[j].device)
            contrib[r.to(dev0)] = reps[j][r].to(dev0)
    if seg_rows and mesh.first == 0:
        r = valid(seg_rows, dev0)
        contrib[r] = reps[0][r]
    full = par.all_reduce_sum(mesh, [contrib], first_only=True)
    # every process plans the same batches: the rows they name are the
    # rows some shard solved
    if every or seg_rows:
        idx = valid(every + seg_rows, dev0)
        for rep in {id(r): r for r in reps}.values():
            rep[idx.to(rep.device)] = full[idx].to(rep.device)
    return parts, seg


def als_epoch_replicated(P, Q, row_batches, col_batches, *, mesh,
                         row_sharded, optimizer, alpha, reg_u, reg_i,
                         adaptive_reg, cg_iters, cg_tol, block_size,
                         compute_loss, num_p_rows, num_q_rows):
    """One ALS epoch over a device mesh on padded batches (global row
    ids): the JAX package's "dp" sharding (``row_sharded=False``: ``P``
    and ``Q`` one replica per local shard, shards on one device sharing
    it, the gramian one product) and its "tp" scatter path
    (``row_sharded=True``: ``P`` and ``Q`` row shards; per half the
    gramian is an all-reduce of partial products and both tables are
    all-gathered, the slices solved into the gathered table and each
    shard takes its rows back), resident or streamed (``*_batches``
    staged lists, or ``DeviceBatcher``s planned with ``row_multiple`` =
    the mesh size).  Returns (P, Q, nume, deno)."""
    from buffalo_tpu_torch import parallelism as par

    common = dict(optimizer=optimizer, alpha=alpha,
                  adaptive_reg=adaptive_reg, cg_iters=cg_iters,
                  cg_tol=cg_tol, block_size=block_size,
                  compute_loss=compute_loss)

    def half(A, Bf, batches, **kw):
        if row_sharded:
            FF = par.all_reduce_sum(mesh, [gramian(b) for b in Bf])
            Bf_r = par.all_gather_rows(mesh, Bf)
            A_r = par.all_gather_rows(mesh, A)
        else:
            FF = _per_device_gramian(Bf)
            Bf_r, A_r = Bf, A
        parts, seg = _replica_half(mesh, A_r, Bf_r, FF, batches, **kw,
                                   **common)
        if row_sharded:
            par.write_back(mesh, A, A_r[0])
        return parts, seg

    p1, s1 = half(P, Q, row_batches, reg=reg_u, item_axis=False,
                  num_fixed_rows=num_q_rows)
    p2, s2 = half(Q, P, col_batches, reg=reg_i, item_axis=True,
                  num_fixed_rows=num_p_rows)
    total = par.all_reduce_sum(mesh, [a + b for a, b in zip(p1, p2)])[0]
    total = total + s1 + s2
    return P, Q, total[0], total[1]


def _per_device_gramian(tables):
    """``gramian`` of each distinct replica, listed per shard."""
    out = {}
    return [out.setdefault(id(t), gramian(t)) for t in tables]
