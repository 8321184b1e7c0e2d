"""ALS batch update math: per-row normal equations over padded batches.

PyTorch counterpart of ``buffalo_tpu.ops.als_kernels`` for the
single-device, bucket-order range layout.  Each batch of an epoch goes
through hand-written CUDA kernels on the card (``csrc/*.cu``):

* **K1** ``als_cg_matrix_free`` — RangeBatch rows with padded length
  ``L <= MATRIX_FREE_MAX_L``: gather, loss terms, warm start and CG
  without forming the d x d system, result written in place.
* **K2** ``als_normal_equations`` — RangeBatch rows with ``L > 96`` and
  SegmentBatch head rows: the dense system ``A = FF + Fw^T F + reg I``,
  ``y = F^T (1 + w)`` and the loss terms; one block per range row, or
  per segment chunk followed by an ordered per-row reduction.
* **K3** ``batched_cg_dense`` — warm-started CG on K2's systems, result
  written to the row range, or scattered with padding ids skipped.

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

from buffalo_tpu_torch.data.batching import (MATRIX_FREE_MAX_L, RangeBatch,
                                             StagedSegmentBatch)
from buffalo_tpu_torch.ops.solve import (CG_SOLVERS, CHOLESKY_SOLVERS,
                                         cg_loop, cg_warm_start, solve_cg,
                                         solve_cholesky)

IALSPP_TODO = ("optimizer='ialspp' (auto-selected at d >= 128) is not "
               "ported yet: ROADMAP queue 1 item 2 (iALS++ kernel K4)")

_P, _I64, _I32, _F32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_float)
# C signatures of the kernels' launch functions (csrc/*.cu); every one
# returns the cudaError_t of its launch
_SIGNATURES = {
    "als_cg_matrix_free": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I32,
                           _I32, _I32, _F32, _F32, _I32, _I32, _F32, _I32,
                           _F32, _I32, _P],
    "als_normal_equations": [_P, _P, _P, _P, _P, _I64, _P, _P, _P, _P,
                             _I32, _I32, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I64, _I32, _I32, _F32, _F32, _I32, _I32, _F32,
                             _I32, _P],
    "batched_cg_dense": [_P, _P, _P, _P, _P, _I64, _I64, _I32, _I32, _I32,
                         _F32, _P],
}
# the widest rows the kernels take
MAX_D = 128


_launchers = {}


def _kernel(name: str):
    """The C launch function of kernel ``name`` (built on first use)."""
    fn = _launchers.get(name)
    if fn is None:
        from buffalo_tpu_torch.ops._build import load_kernel

        fn = getattr(load_kernel(name), name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        _launchers[name] = fn
    return fn


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
                             alpha, reg, adaptive_reg, cg_iters, cg_tol,
                             item_axis, num_fixed_rows, compute_loss):
    """Plain version of K1: ``als_solve_batch``'s matrix-free branch
    (``als_kernels.py:157-162``) on ``table[row_start:row_start+B]``,
    written back in place.  Returns per-row (nume, deno)."""
    B, L = cols.shape
    dt = table.dtype
    p = table[row_start:row_start + B]
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
    table[row_start:row_start + B] = torch.where(row_mask[:, None] > 0, x, p)
    return nume, deno


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
    """Plain version of K2.  Range mode (``rows is None``): the dense
    branch of ``als_solve_batch`` (``_row_stats`` + A assembly,
    ``als_kernels.py:164-167``) for ``table[row_start:row_start+R]``.
    Segment mode: ``als_solve_segment_batch``'s per-chunk statistics and
    ``segment_sum`` (``:268-297``), chunks of row r at
    ``[chunk_ptr[r], chunk_ptr[r+1])``.  Returns (A (R, d, d), y (R, d),
    nume (R,), deno (R,))."""
    R = lens.shape[0]
    n, d = table.shape
    dt = table.dtype
    F = Bf[cols.long()]
    row_mask, ada = _row_weights(lens, adaptive_reg, dt)
    nume = deno = table.new_zeros(R)
    if rows is None:
        p = table[row_start:row_start + R]
        mask = _entry_mask(lens, cols.shape[1], dt)
        w = vals.to(dt) * alpha * mask
        A_data = torch.einsum("bld,ble->bde", F * w[:, :, None], F)
        y = torch.einsum("bld,bl->bd", F, (1.0 + w) * mask)
        if compute_loss:
            nume, deno = _loss_rows(p, F, FF, w, mask, row_mask, ada,
                                    reg=reg, item_axis=item_axis,
                                    num_fixed_rows=num_fixed_rows)
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


# ------------------------------------------------------------- wrappers
def als_cg_matrix_free(table, Bf, FF, row_start, lens, cols, vals, *,
                       alpha, reg, adaptive_reg, cg_iters, cg_tol,
                       item_axis, num_fixed_rows, compute_loss):
    """K1: fused matrix-free row CG for a RangeBatch (L <= 96).

    Replaces ``_solve_cg_matrix_free`` + the CG branch of
    ``als_solve_batch`` + ``_loss_terms`` + the RangeBatch gather/write
    (``buffalo_tpu/ops/als_kernels.py:103,157-162,77,337-353``).
    Updates ``table[row_start:row_start+B]`` in place and returns the
    per-row (nume, deno), zeros when ``compute_loss`` is off.
    """
    if table.device.type == "cpu":
        return als_cg_matrix_free_plain(
            table, Bf, FF, row_start, lens, cols, vals, alpha=alpha,
            reg=reg, adaptive_reg=adaptive_reg, cg_iters=cg_iters,
            cg_tol=cg_tol, item_axis=item_axis,
            num_fixed_rows=num_fixed_rows, compute_loss=compute_loss)
    dev = table.device
    d = _check_tables(table, Bf, FF, dev)
    if d > MAX_D:
        raise ValueError(f"als_cg_matrix_free supports d <= {MAX_D}, got {d}")
    _check("lens", lens, torch.int32, dev, 1)
    _check("cols", cols, torch.int32, dev, 2)
    _check("vals", vals, torch.float32, dev, 2)
    B, L = cols.shape
    if L > MATRIX_FREE_MAX_L or row_start < 0 \
            or row_start + B > table.shape[0]:
        raise ValueError(f"bad RangeBatch: L={L}, rows [{row_start}, "
                         f"{row_start + B}) of {table.shape[0]}")
    nume = torch.zeros(B, device=dev)
    deno = torch.zeros(B, device=dev)
    rc = _kernel("als_cg_matrix_free")(
        _ptr(table), _ptr(Bf), _ptr(FF), _ptr(lens), _ptr(cols),
        _ptr(vals), _ptr(nume), _ptr(deno), int(row_start), B, L, d,
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
    164-167``) for RangeBatch rows with L > 96, and the per-chunk
    statistics + ``segment_sum`` of ``als_solve_segment_batch``
    (``:268-282``) for SegmentBatch rows, plus ``_loss_terms`` (``:77``,
    ``:284-297``).  Returns (A, y, nume, deno) for K3.  Segment mode runs
    as two kernels of one launch call: per-chunk statistics, then an
    ordered per-row reduction (counted as one launch).
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
    if d > MAX_D:
        raise ValueError(f"als_normal_equations supports d <= {MAX_D}, "
                         f"got {d}")
    _check("lens", lens, torch.int32, dev, 1)
    _check("cols", cols, torch.int32, dev, 2)
    _check("vals", vals, torch.float32, dev, 2)
    R = lens.shape[0]
    if rows is None:
        if cols.shape[0] != R or row_start < 0 \
                or row_start + R > table.shape[0]:
            raise ValueError("bad RangeBatch for als_normal_equations")
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
    Nc = 0 if rows is None else cols.shape[0]
    # chunk partials of the segment mode: A, y, loss terms, sum of w
    part = [torch.empty(Nc, d, d, device=dev), torch.empty(Nc, d, device=dev),
            torch.empty(Nc, device=dev), torch.empty(Nc, device=dev)] \
        if Nc else [None] * 4
    rc = _kernel("als_normal_equations")(
        _ptr(table), _ptr(Bf), _ptr(FF), _ptr(lens), _ptr(rows),
        int(row_start), _ptr(chunk_ptr), _ptr(chunk_lens), _ptr(cols),
        _ptr(vals), cols.shape[1], Nc, *map(_ptr, part), _ptr(A), _ptr(y),
        _ptr(nume), _ptr(deno), table.shape[0], R, d, float(alpha),
        float(reg), int(bool(adaptive_reg)), int(bool(item_axis)),
        float(num_fixed_rows), int(bool(compute_loss)), _stream(dev))
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
    if d > MAX_D:
        raise ValueError(f"batched_cg_dense supports d <= {MAX_D}, got {d}")
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

KERNELS = (als_cg_matrix_free, als_normal_equations, batched_cg_dense)


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


def _apply_batch(A, Bf, FF, batch, *, optimizer, cg_iters, cg_tol, **common):
    """Update table ``A`` with one staged batch; per-row (nume, deno)."""
    if isinstance(batch, RangeBatch):
        B, L = batch.cols.shape
        if optimizer in CG_SOLVERS and L <= MATRIX_FREE_MAX_L:
            return als_cg_matrix_free(
                A, Bf, FF, batch.row_start, batch.lens, batch.cols,
                batch.vals, cg_iters=cg_iters, cg_tol=cg_tol, **common)
        Asys, y, nume, deno = als_normal_equations(
            A, Bf, FF, batch.lens, batch.cols, batch.vals,
            row_start=batch.row_start, **common)
        _solve_into(A, Asys, y, batch.lens, optimizer=optimizer,
                    cg_iters=cg_iters, cg_tol=cg_tol,
                    row_start=batch.row_start)
        return nume, deno
    if isinstance(batch, StagedSegmentBatch):
        Asys, y, nume, deno = als_normal_equations(
            A, Bf, FF, batch.lens, batch.cols, batch.vals, rows=batch.rows,
            chunk_ptr=batch.chunk_ptr, chunk_lens=batch.chunk_lens,
            **common)
        _solve_into(A, Asys, y, batch.lens, optimizer=optimizer,
                    cg_iters=max(cg_iters, 3), cg_tol=cg_tol,
                    rows=batch.rows)
        return nume, deno
    raise TypeError(f"unexpected batch type {type(batch).__name__}; "
                    "stage batches with data.batching.stage_batch")


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


def als_epoch(P, Q, row_batches, col_batches, *, optimizer, alpha, reg_u,
              reg_i, adaptive_reg, cg_iters, cg_tol, block_size,
              compute_loss, num_p_rows=None, num_q_rows=None):
    """One full ALS epoch: gramian + rowwise half + colwise half.

    Counterpart of ``buffalo_tpu.ops.als_kernels.als_epoch`` over staged
    batches (``data.batching.stage_batch``).  P and Q are updated in
    place (and returned); ``block_size`` belongs to iALS++, which is not
    ported yet.  Returns (P, Q, nume, deno) with 0-d tensors.
    """
    if optimizer == "ialspp":
        raise NotImplementedError(IALSPP_TODO)
    common = dict(optimizer=optimizer, alpha=alpha,
                  adaptive_reg=adaptive_reg, cg_iters=cg_iters,
                  cg_tol=cg_tol, compute_loss=compute_loss)
    numes, denos = [], []
    FF = gramian(Q)
    for batch in _flat(row_batches):
        n, dn = _apply_batch(P, Q, FF, batch, reg=reg_u, item_axis=False,
                             num_fixed_rows=num_q_rows or Q.shape[0],
                             **common)
        numes.append(n)
        denos.append(dn)
    FF = gramian(P)
    for batch in _flat(col_batches):
        n, dn = _apply_batch(Q, P, FF, batch, reg=reg_i, item_axis=True,
                             num_fixed_rows=num_p_rows or P.shape[0],
                             **common)
        numes.append(n)
        denos.append(dn)
    if not numes:
        zero = P.new_zeros(())
        return P, Q, zero, zero
    return P, Q, torch.cat(numes).sum(), torch.cat(denos).sum()
