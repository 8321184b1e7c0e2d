"""CoFactor (CFR) batch updates, on one device or a device mesh.

PyTorch counterpart of ``buffalo_tpu.ops.cfr_kernels`` (Liang et al.,
Factorization Meets the Item Embedding, RecSys 2016): the three-phase
epoch — users (implicit ALS scaled by ``l``), items (the user-side
implicit term plus the SPPMI explicit term with item and context biases,
then the closed-form item bias) and contexts (SPPMI only, then the context
bias).  Each batch of a phase goes through two hand-written CUDA
kernels (``csrc/*.cu``) around K3's solve, each beside its plain PyTorch
version (``*_plain``):

* **K17** ``cfr_normal_equations`` — per row the system ``A = l (FF +
  sum alpha v f f^T) [+ sum c c^T] + reg I`` and ``y = l sum (1 + alpha v)
  f [+ sum (v - b_row - b_col) c]`` over the row's implicit and explicit
  sides, and the loss terms of the row's vector before the solve
  (``_implicit_terms`` :29, ``_cfr_user_body`` :56, ``_cfr_item_body``
  :92-137, ``_cfr_context_body`` :563-583, ``_segment_stats`` :158 and the
  segment bodies).  A side is a padded block (one chunk per row) or a
  segment batch's chunks; sums run in a fixed order, with ``sum w f f^T``
  formed directly (not through ``sqrt(w)``).
* **K3** ``batched_cg_dense`` (``ops/als_kernels.py``) solves, warm-started
  from the rows, and writes the rows of the batch with entries on either
  side (or ``torch.linalg`` for ``llt`` / ``ldlt``).
* **K18** ``cfr_bias`` — after the solve, the closed-form bias ``sum (v -
  x . c - b_col) / (len + 1e-10)`` of the NEW row over its explicit
  entries, written wherever the row has entries on either side (``0`` for
  a row without explicit entries), and the user phase's ``reg |x|^2`` loss
  term of the new row (``_cfr_item_body`` :146-154, ``_cfr_context_body``
  :584-593, the segment bodies' ends, ``_cfr_user_body`` :73).  Up to 128
  floats a row it cuts the entries into pieces (``bias_launch``): a warp
  per piece of at most ``BIAS_PIECE`` entries of a padded row or segment
  chunk, a team of lanes per entry reading its row as float4s; a row
  spanning pieces has them added in piece order by a second launch.

``gramian`` (``FF``) is a plain product (``torch.matmul``).  Each wrapper
runs its plain version for CPU tensors and launches its kernel (or raises)
for CUDA tensors; ``launches`` on each wrapper counts the calls that
launched it.  Rows of any width (past 128 floats K17 builds A in output
tiles and K18 reads rows from global memory); values are float32.

``cfr_epoch`` runs over a ``parallelism.Mesh`` (one device is a mesh of one
shard): the padded batches' rows split over the shards, the tables
replicated, each phase's solved rows gathered over the mesh once.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from buffalo_tpu_torch.data.batching import StagedSegmentBatch
from buffalo_tpu_torch.ops.als_kernels import (_check, _ptr, _raise_on,
                                               _solve_into, _stream, gramian)
from buffalo_tpu_torch.ops.sgd_kernels import replica_shards

_P, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIDE = [_P, _P, _P, _P, _P, _P, _I32]
# C signatures of the launch functions (csrc/cfr_*.cu); each returns the
# cudaError_t of its launches
_SIGNATURES = {
    "cfr_normal_equations": [_P, _I32, _I32, _P, _I32] + _SIDE
    + [_P, _F32, _F32] + _SIDE + [_P, _P, _F32, _I32, _P, _P, _P, _P, _P],
    "cfr_bias": [_P, _I32, _I32, _P, _I32, _P] + _SIDE
    + [_I32, _P, _P, _F32, _P, _I32, _P, _P],
    "cfr_bias_wide": [_I32],
}
_LIBRARY = {"cfr_bias_wide": "cfr_bias"}
# K17's loss terms (of the rows before the solve)
LOSS_IMPLICIT, LOSS_EXPLICIT, LOSS_REG = 1, 2, 4
# K18 cuts a side's entries into pieces of at most BIAS_PIECE entries of one
# padded row or segment chunk, one warp each (csrc/cfr_bias.cu)
BIAS_PIECE = 256


def _kernel(name: str):
    from buffalo_tpu_torch.ops._build import launcher

    return launcher(name, _SIGNATURES[name], library=_LIBRARY.get(name))


class Side(NamedTuple):
    """The entries of one side of a batch's rows, gathered from ``table``:
    a padded block (``lens`` (R,), ``cols`` / ``vals`` (R, L), one chunk
    per row) or a segment batch (``lens`` the rows' total lengths,
    ``cols`` / ``vals`` (Nc, C) chunks, row r's at ``[chunk_ptr[r],
    chunk_ptr[r + 1])`` with ``chunk_lens`` entries each)."""
    table: torch.Tensor
    lens: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    chunk_ptr: Optional[torch.Tensor] = None
    chunk_lens: Optional[torch.Tensor] = None

    @classmethod
    def of(cls, table, batch):
        """The side of a staged ``PaddedBatch`` or ``StagedSegmentBatch``."""
        if isinstance(batch, StagedSegmentBatch):
            return cls(table, batch.lens, batch.cols, batch.vals,
                       batch.chunk_ptr, batch.chunk_lens)
        return cls(table, batch.lens, batch.cols, batch.vals)


# ---------------------------------------------------------------- plain
def _entries(side, R):
    """(gathered rows (Nc, C, d), values and entry mask (Nc, C) in the
    table's dtype, chunk -> row (Nc,) or None for a padded side, segment
    sum to the R rows)."""
    F = side.table[side.cols.long()]
    vals = side.vals.to(F.dtype)
    if side.chunk_ptr is None:
        L = side.cols.shape[1]
        mask = (torch.arange(L, device=side.cols.device)[None, :]
                < side.lens[:, None]).to(F.dtype)
        return F, vals, mask, None, (lambda x: x)
    Nc, C = side.cols.shape
    counts = (side.chunk_ptr[1:] - side.chunk_ptr[:-1]).long()
    seg = torch.full((Nc,), R, dtype=torch.long, device=side.cols.device)
    seg[:int(side.chunk_ptr[-1])] = torch.repeat_interleave(
        torch.arange(R, device=side.cols.device), counts)
    mask = (torch.arange(C, device=side.cols.device)[None, :]
            < side.chunk_lens[:, None]).to(F.dtype)

    def segsum(x):
        return x.new_zeros((R + 1,) + tuple(x.shape[1:])).index_add_(
            0, seg, x)[:R]

    return F, vals, mask, seg, segsum


def _per_entry(v, seg):
    """Per-row values (R, ...) at each chunk (padding chunks -> 0)."""
    if seg is None:
        return v
    return torch.cat([v, v.new_zeros((1,) + tuple(v.shape[1:]))])[seg]


def cfr_normal_equations_plain(X, rows, *, implicit=None, explicit=None,
                               FF=None, rbias=None, cbias=None, alpha=0.0,
                               l=1.0, reg, loss=0):
    """Plain version of K17 on the R rows ``rows`` of X (ids past the table
    are padding): ``implicit`` / ``explicit`` sides (either may be None),
    the explicit coefficient ``v - rbias[row] - cbias[col]``.  ``loss``
    selects the terms of the rows' current vectors: ``LOSS_IMPLICIT`` (l
    (x FF x + sum pos)), ``LOSS_EXPLICIT`` (sum err^2), ``LOSS_REG`` (reg
    |x|^2).  Returns (A (R, d, d), y (R, d), per-row loss (R,), the rows'
    total lengths over both sides (R,) int32)."""
    R = rows.shape[0]
    n, d = X.shape
    x = X[rows.long().clamp(max=n - 1)]
    A = X.new_zeros(R, d, d)
    y = X.new_zeros(R, d)
    out = X.new_zeros(R)
    total = torch.zeros(R, dtype=torch.int32, device=X.device)
    for side in (implicit, explicit):
        if side is not None:
            total = total + side.lens
    row_mask = (total > 0).to(X.dtype)
    if implicit is not None:
        F, vals, mask, seg, segsum = _entries(implicit, R)
        w = vals * alpha * mask
        A = l * (FF[None] + segsum(torch.einsum("ncd,nce->nde",
                                                F * w[:, :, None], F)))
        y = l * segsum(torch.einsum("ncd,nc->nd", F, (1.0 + w) * mask))
        if loss & LOSS_IMPLICIT:
            dots = torch.einsum("ncd,nd->nc", F, _per_entry(x, seg))
            pos = mask * (-dots * dots + (1.0 + w) * (dots - 1.0) ** 2)
            xFFx = torch.einsum("rd,de,re->r", x, FF, x)
            out = out + l * row_mask * (xFFx + segsum(pos.sum(-1)))
    if explicit is not None:
        F, vals, mask, seg, segsum = _entries(explicit, R)
        rb = _per_entry(rbias[rows.long().clamp(max=n - 1)], seg)[:, None]
        cb = cbias[explicit.cols.long()]
        coeff = (vals - rb - cb) * mask
        A = A + segsum(torch.einsum("ncd,nce,nc->nde", F, F, mask))
        y = y + segsum(torch.einsum("ncd,nc->nd", F, coeff))
        if loss & LOSS_EXPLICIT:
            pred = torch.einsum("ncd,nd->nc", F, _per_entry(x, seg))
            err = (vals - pred - rb - cb) * mask
            out = out + row_mask * segsum((err * err).sum(-1))
    if loss & LOSS_REG:
        out = out + reg * row_mask * (x * x).sum(-1)
    A = A + reg * torch.eye(d, dtype=X.dtype, device=X.device)[None]
    return A, y, out, total.to(torch.int32)


def cfr_bias_plain(X, rows, total, *, explicit=None, bias=None, cbias=None,
                   reg_new=0.0, loss=None):
    """Plain version of K18 after the solve, on the NEW rows of X: with
    ``explicit``, bias[row] = sum (v - x . c - cbias[col]) / (len + 1e-10)
    for every row with entries (``total`` > 0) inside the table; with
    ``reg_new``, loss[r] += reg_new |x|^2 on those rows."""
    R = rows.shape[0]
    n = X.shape[0]
    idx = rows.long()
    write = (total > 0) & (idx < n)
    x = X[idx.clamp(max=n - 1)]
    if explicit is not None:
        F, vals, mask, seg, segsum = _entries(explicit, R)
        pred = torch.einsum("ncd,nd->nc", F, _per_entry(x, seg))
        b = segsum(((vals - pred - cbias[explicit.cols.long()])
                    * mask).sum(-1))
        new = b / (explicit.lens.float() + 1e-10)
        bias[idx[write]] = new[write]
    if reg_new:
        loss += reg_new * write.to(X.dtype) * (x * x).sum(-1)


# ------------------------------------------------------------- wrappers
def _side_args(name, side, R, dev, d):
    """The C arguments of one side (null pointers when absent)."""
    if side is None:
        return [None] * 6 + [0]
    _check(f"{name}.table", side.table, torch.float32, dev, 2)
    if side.table.shape[1] != d:
        raise ValueError(f"{name} table is {side.table.shape[1]} wide, not {d}")
    _check(f"{name}.lens", side.lens, torch.int32, dev, 1)
    _check(f"{name}.cols", side.cols, torch.int32, dev, 2)
    _check(f"{name}.vals", side.vals, torch.float32, dev, 2)
    if side.lens.shape[0] != R:
        raise ValueError(f"{name} has {side.lens.shape[0]} rows, not {R}")
    if side.chunk_ptr is None:
        if side.cols.shape[0] != R:
            raise ValueError(f"{name}'s padded block has "
                             f"{side.cols.shape[0]} rows, not {R}")
    else:
        _check(f"{name}.chunk_ptr", side.chunk_ptr, torch.int32, dev, 1)
        _check(f"{name}.chunk_lens", side.chunk_lens, torch.int32, dev, 1)
        if side.chunk_ptr.shape[0] != R + 1 or \
                side.chunk_lens.shape[0] != side.cols.shape[0]:
            raise ValueError(f"bad segment side {name}")
    return [_ptr(side.table), _ptr(side.lens), _ptr(side.chunk_ptr),
            _ptr(side.chunk_lens), _ptr(side.cols), _ptr(side.vals),
            side.cols.shape[1]]


def _check_rows(X, rows, dev):
    _check("X", X, torch.float32, dev, 2)
    _check("rows", rows, torch.int32, dev, 1)
    return X.shape[1]


def cfr_normal_equations(X, rows, *, implicit=None, explicit=None, FF=None,
                         rbias=None, cbias=None, alpha=0.0, l=1.0, reg,
                         loss=0):
    """K17: the batch's per-row systems and pre-solve loss terms (see
    ``cfr_normal_equations_plain``).  Replaces ``_implicit_terms`` :29,
    the A / y builds and loss terms of ``_cfr_user_body`` :56,
    ``_cfr_item_body`` :92-137 and ``_cfr_context_body`` :563-583, and
    ``_segment_stats`` :158 with the segment bodies :181-323
    (``buffalo_tpu/ops/cfr_kernels.py``).  Returns (A, y, loss, total)."""
    kw = dict(implicit=implicit, explicit=explicit, FF=FF, rbias=rbias,
              cbias=cbias, alpha=alpha, l=l, reg=reg, loss=loss)
    if X.device.type == "cpu":
        return cfr_normal_equations_plain(X, rows, **kw)
    dev = X.device
    d = _check_rows(X, rows, dev)
    R = rows.shape[0]
    if implicit is None and explicit is None:
        raise ValueError("cfr_normal_equations needs a side")
    if implicit is not None:
        _check("FF", FF, torch.float32, dev, 2)
        if tuple(FF.shape) != (d, d):
            raise ValueError(f"FF is {tuple(FF.shape)}, not ({d}, {d})")
    if explicit is not None:
        _check("rbias", rbias, torch.float32, dev, 1)
        _check("cbias", cbias, torch.float32, dev, 1)
    A = torch.empty(R, d, d, dtype=torch.float32, device=dev)
    y = torch.empty(R, d, dtype=torch.float32, device=dev)
    out = torch.empty(R, dtype=torch.float32, device=dev)
    total = torch.empty(R, dtype=torch.int32, device=dev)
    rc = _kernel("cfr_normal_equations")(
        _ptr(X), X.shape[0], d, _ptr(rows), R,
        *_side_args("implicit", implicit, R, dev, d),
        _ptr(FF if implicit is not None else None), float(alpha), float(l),
        *_side_args("explicit", explicit, R, dev, d),
        _ptr(rbias if explicit is not None else None),
        _ptr(cbias if explicit is not None else None), float(reg), int(loss),
        _ptr(A), _ptr(y), _ptr(out), _ptr(total), _stream(dev))
    _raise_on(rc, "cfr_normal_equations")
    cfr_normal_equations.launches += 1
    return A, y, out, total


cfr_normal_equations.launches = 0


def bias_launch(chunks, width, segment, piece):
    """K18's launch shape for an explicit side of ``chunks`` padded rows
    or segment chunks of ``width`` slots cut into pieces of at most
    ``piece`` entries: (pieces per row or chunk, at least one since piece
    0 writes the bias of a row without entries; the grid's pieces, one
    warp each; whether a row can span pieces, so that the pieces' partial
    sums are kept and a second launch adds them)."""
    ppr = max(1, -(-int(width) // int(piece)))
    return ppr, int(chunks) * ppr, bool(segment) or ppr > 1


def cfr_bias(X, rows, total, *, explicit=None, bias=None, cbias=None,
             reg_new=0.0, loss=None):
    """K18: the closed-form bias of the new rows and the user phase's loss
    term (see ``cfr_bias_plain``), in place on ``bias`` and ``loss``.
    Replaces the bias and masked write of ``_cfr_item_body`` :146-154,
    ``_cfr_context_body`` :584-593 and the segment bodies' ends, and the
    loss of ``_cfr_user_body`` :73 (``buffalo_tpu/ops/cfr_kernels.py``).
    ``launches`` counts the calls; ``device_launches`` the kernels they
    launched (a row's pieces and the launch that adds them, the loss
    term's own)."""
    kw = dict(explicit=explicit, bias=bias, cbias=cbias, reg_new=reg_new,
              loss=loss)
    if X.device.type == "cpu":
        return cfr_bias_plain(X, rows, total, **kw)
    dev = X.device
    d = _check_rows(X, rows, dev)
    R = rows.shape[0]
    _check("total", total, torch.int32, dev, 1)
    if explicit is not None:
        _check("bias", bias, torch.float32, dev, 1)
        _check("cbias", cbias, torch.float32, dev, 1)
        if bias.shape[0] != X.shape[0]:
            raise ValueError("bias must have one entry per row of X")
    if reg_new:
        _check("loss", loss, torch.float32, dev, 1)
    side = _side_args("explicit", explicit, R, dev, d)
    chunks = explicit.cols.shape[0] if explicit is not None else 0
    _, pieces, spans = bias_launch(
        chunks, side[-1], explicit is not None
        and explicit.chunk_ptr is not None, BIAS_PIECE)
    wide = bool(_kernel("cfr_bias_wide")(d))
    part = (torch.empty(max(1, pieces), dtype=torch.float64, device=dev)
            if explicit is not None and spans and not wide else None)
    rc = _kernel("cfr_bias")(
        _ptr(X), X.shape[0], d, _ptr(rows), R, _ptr(total), *side, chunks,
        _ptr(cbias if explicit is not None else None),
        _ptr(bias if explicit is not None else None), float(reg_new),
        _ptr(loss if reg_new else None), BIAS_PIECE, _ptr(part),
        _stream(dev))
    _raise_on(rc, "cfr_bias")
    cfr_bias.launches += 1
    if R:
        cfr_bias.device_launches += 1 if wide else (
            int(bool(reg_new)) + (0 if explicit is None
                                  else int(pieces > 0) + int(spans)))


cfr_bias.launches = 0
cfr_bias.device_launches = 0

KERNELS = (cfr_normal_equations, cfr_bias)


# -------------------------------------------------------- composed steps
def _solve(X, A, y, rows, total, *, optimizer, cg_iters, cg_tol):
    """K3 (or Cholesky) into X's rows with entries on either side."""
    _solve_into(X, A, y, total, optimizer=optimizer, cg_iters=cg_iters,
                cg_tol=cg_tol, rows=rows)


def cfr_user_step(U, I, FF, batch, *, alpha, l, reg_u, optimizer, cg_iters,
                  cg_tol, compute_loss):
    """One user batch (``cfr_user_step`` :48, ``cfr_user_segment_step``
    :329): K17, the solve, K18's loss term.  Returns the per-row loss."""
    A, y, loss, total = cfr_normal_equations(
        U, batch.rows, implicit=Side.of(I, batch), FF=FF, alpha=alpha, l=l,
        reg=reg_u)
    _solve(U, A, y, batch.rows, total, optimizer=optimizer,
           cg_iters=cg_iters, cg_tol=cg_tol)
    if compute_loss:
        cfr_bias(U, batch.rows, total, reg_new=reg_u, loss=loss)
    return loss


def cfr_item_step(I, U, C, Ib, Cb, FF, entry, *, alpha, l, reg_i,
                  optimizer, cg_iters, cg_tol, compute_loss):
    """One item entry (``cfr_item_step`` :81, ``cfr_item_segment_step``
    :340): a staged colwise ``PaddedBatch`` with its SPPMI block (lens_c,
    cols_c, vals_c) or a pair of segment batches over one row list.  The
    explicit side reads Ib of the previous epoch at the row and Cb at the
    context; the new Ib is written after the solve.  Returns the per-row
    loss."""
    if isinstance(entry[0], StagedSegmentBatch):
        sb_u, sb_c = entry
        rows, imp, exp = sb_u.rows, Side.of(U, sb_u), Side.of(C, sb_c)
    else:
        b, lens_c, cols_c, vals_c = entry
        rows, imp = b.rows, Side.of(U, b)
        exp = Side(C, lens_c, cols_c, vals_c)
    flags = (LOSS_IMPLICIT | LOSS_EXPLICIT | LOSS_REG) if compute_loss else 0
    A, y, loss, total = cfr_normal_equations(
        I, rows, implicit=imp, explicit=exp, FF=FF, rbias=Ib, cbias=Cb,
        alpha=alpha, l=l, reg=reg_i, loss=flags)
    _solve(I, A, y, rows, total, optimizer=optimizer, cg_iters=cg_iters,
           cg_tol=cg_tol)
    cfr_bias(I, rows, total, explicit=exp, bias=Ib, cbias=Cb)
    return loss


def cfr_context_step(C, I, Ib, Cb, batch, *, reg_c, optimizer, cg_iters,
                     cg_tol, compute_loss):
    """One context batch (``cfr_context_step`` :555,
    ``cfr_context_segment_step`` :353): the SPPMI rows with Cb at the row
    and this epoch's Ib at the item, the solve, the new Cb.  Returns the
    per-row loss."""
    exp = Side.of(I, batch)
    A, y, loss, total = cfr_normal_equations(
        C, batch.rows, explicit=exp, rbias=Cb, cbias=Ib, reg=reg_c,
        loss=LOSS_REG if compute_loss else 0)
    _solve(C, A, y, batch.rows, total, optimizer=optimizer,
           cg_iters=cg_iters, cg_tol=cg_tol)
    cfr_bias(C, batch.rows, total, explicit=exp, bias=Cb, cbias=Ib)
    return loss


def _entry_rows(entry):
    """The row ids of a staged padded batch or item entry."""
    return entry.rows if hasattr(entry, "rows") else entry[0].rows


def _phase(mesh, tables, entries, written, step):
    """One phase of ``cfr_epoch`` over ``entries``, each run by ``step(dev,
    T, entry)`` on the tables ``T`` of device ``dev`` (a per-row loss
    back).  On one shard: every entry in order, on the one replica.  On a
    mesh of several shards: each local shard solves its row slices of the
    padded entries (lists, one slice per local shard) into its device's
    replica (the phase reads only the other tables and each row's own
    entries, and every row is one shard's, so shards sharing a replica do
    not meet); then the rows each shard solved are gathered over the mesh
    with their ids, one ``all_gather_rows`` per table the phase writes
    (``written``, indices into ``T``), and written into every replica, and
    the loss is summed over the mesh once; then the segment entries
    ({device: entry}) run on every replica.  Returns the phase's loss, a
    (1,) tensor on the first local device."""
    devs = mesh.devices
    if mesh.size == 1:
        losses = [step(devs[0], tables[devs[0]], e) for e in entries]
        return (torch.cat(losses).sum().reshape(1) if losses
                else tables[devs[0]][0].new_zeros(1))
    from buffalo_tpu_torch.parallelism import all_gather_rows, all_reduce_sum

    reps = replica_shards(mesh)
    padded = [e for e in entries if isinstance(e, list)]
    total = tables[devs[0]][0].new_zeros(1)
    if padded:
        losses = [torch.cat([step(dev, tables[dev], e[k]) for e in padded])
                  .sum().reshape(1) for k, dev in enumerate(devs)]
        n = tables[devs[0]][written[0]].shape[0]
        mine = [torch.cat([_entry_rows(e[k]) for e in padded]).long()
                for k in range(len(devs))]
        rows = all_gather_rows(mesh, mine)
        for i in written:
            got = all_gather_rows(mesh, [tables[dev][i][r.clamp(max=n - 1)]
                                         for r, dev in zip(mine, devs)])
            for dev, k in reps.items():
                keep = rows[k] < n
                tables[dev][i][rows[k][keep]] = got[k][keep]
        total = all_reduce_sum(mesh, losses, first_only=True)
    for e in entries:
        if isinstance(e, dict):
            for r, dev in enumerate(reps):
                loss = step(dev, tables[dev], e[dev])
                if r == 0:
                    total = total + loss.sum().to(total.device)
    return total


def cfr_epoch(mesh, tables, user_batches, item_batches, context_batches, *,
              alpha, l, reg_u, reg_i, reg_c, optimizer, cg_iters, cg_tol,
              compute_loss):
    """The three-phase epoch (``cfr_epoch`` :365 and the streamed loop of
    ``models/cfr.py:244``), and ``cfr_epoch_dp`` :431 on a mesh of several
    shards (one device is a mesh of one shard).  ``tables`` {device: [U,
    I, C, Ib, Cb]} holds one replica per local device, updated in place.
    On one shard each phase's entries are staged batches or item entries
    (or iterables that stage them).  On a mesh the tables are replicated
    and a padded batch or item entry is a list of the local shards' row
    slices, each on its shard's device (the batch's rows padded to a
    multiple of the mesh size with sentinel rows past the table, which
    K17, K3 and K18 leave alone); a segment batch or pair is {device:
    staged entry}, run on every replica after the phase's padded entries,
    as the JAX package runs them outside its ``shard_map``.  Per phase
    (``_phase``): K17, K3 (or Cholesky) and K18 per entry and shard, then
    the solved rows gathered once per written table (U; I and Ib; C and
    Cb) and the loss summed once.  The JAX package sums the phase's
    deltas (``T + psum(T_cur - T)``, an ulp from the row); the gathered
    rows are the solved rows themselves, so the mesh ends with the single
    device's tables.  Returns the epoch's loss (a 0-d tensor on the first
    local device)."""
    com = dict(optimizer=optimizer, cg_iters=cg_iters, cg_tol=cg_tol,
               compute_loss=compute_loss)
    FF = {dev: gramian(T[1]) for dev, T in tables.items()}
    loss = _phase(mesh, tables, user_batches, (0,), lambda dev, T, b:
                  cfr_user_step(T[0], T[1], FF[dev], b, alpha=alpha, l=l,
                                reg_u=reg_u, **com))
    FF = {dev: gramian(T[0]) for dev, T in tables.items()}
    loss = loss + _phase(mesh, tables, item_batches, (1, 3), lambda dev, T, e:
                         cfr_item_step(T[1], T[0], T[2], T[3], T[4], FF[dev],
                                       e, alpha=alpha, l=l, reg_i=reg_i,
                                       **com))
    loss = loss + _phase(mesh, tables, context_batches, (2, 4),
                         lambda dev, T, b: cfr_context_step(
                             T[2], T[1], T[3], T[4], b, reg_c=reg_c, **com))
    return loss.reshape(())
