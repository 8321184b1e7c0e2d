"""Element-wise ALS (eALS) coordinate-descent kernels on one device.

PyTorch counterpart of ``buffalo_tpu.ops.eals_kernels``'s single-device
functions (He et al., Fast Matrix Factorization for Online Recommendation
with Implicit Feedback, SIGIR 2016): per-dimension closed-form updates with
popularity-weighted negative feedback ``C_i`` and per-entry residual
caches, the dense negative-feedback term from the gramians ``Sq = (C^0.5
Q)^T (C^0.5 Q)`` / ``Sp = P^T P``.  Two hand-written CUDA kernels
(``csrc/*.cu``), each beside its plain PyTorch version (``*_plain``):

* **K13** ``dim_sweep`` — the coordinate descent over all d dimensions,
  in order, of the rows of one batch: a ``RangeBatch`` (a contiguous range
  of the permuted table), a ``StagedSegmentBatch`` (head rows in chunks)
  or CSR rows with residuals carried in and out (``range_layout=False``).
  Two forms on the card (``dim_sweep_form``): up to ``GRAM_MAX_D`` floats
  a range or segment batch takes the Gram form (each row's normal
  equations on the tensor cores, then one Gauss-Seidel sweep on them,
  the same d steps); the rows mode and wider rows the sweep form (the
  steps over the entries).
* **K14** ``eals_residual`` — the residuals p_u . q_i over the nnz entries
  and the loss's three sums over them.

``eals_gramian`` and the loss's d x d terms are plain products
(``torch.matmul``).  Each wrapper runs its plain version for CPU tensors
and launches its kernel (or raises) for CUDA tensors; ``launches`` on each
wrapper counts the calls that launched it.  Rows of any width (K13's
sweep form keeps rows past 256 floats in dynamic shared memory); values
are float32.  ``eals_epoch_sharded_range`` runs K13
per shard of a device mesh (``parallelism``).
"""
from __future__ import annotations

import ctypes

import torch

from buffalo_tpu_torch.data.batching import RangeBatch, StagedSegmentBatch
from buffalo_tpu_torch.ops.als_kernels import (_check, _flat, _ptr, _raise_on,
                                               _stream)

# the longest range-batch row K13 keeps in shared memory (the planner's
# max_len: longer rows come as segment batches)
MAX_RANGE_L = 8192
# the widest rows K13's Gram form takes (csrc/eals_sweep.cu kGramMaxD)
GRAM_MAX_D = 128

_P, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_float)
# C signatures of the launch functions (csrc/eals_*.cu); each returns the
# cudaError_t of its launches
_SIGNATURES = {
    "eals_sweep": [_I32, _P, _I32, _P, _I32, _P, _P, _I32, _F32, _F32, _I32,
                   _I32, _I32, _P, _P, _I32, _P, _P, _I32, _P, _P, _P, _P,
                   _P],
    "eals_gram_sweep": [_I32, _P, _I32, _P, _I32, _P, _P, _I32, _F32, _F32,
                        _I32, _I32, _I32, _P, _P, _I32, _P, _P, _I32, _I32,
                        _P, _P, _P, _P],
    "eals_gram_workspace": [_I32, _I32, _I32, _I32],
    "eals_gram_max_d": [],
    "eals_loss_workspace": [_I64],
    "eals_loss": [_P, _P, _I32, _P, _P, _P, _P, _I64, _F32, _P, _P, _P, _P,
                  _P],
}
_LIBRARY = {"eals_sweep": "eals_sweep", "eals_gram_sweep": "eals_sweep",
            "eals_gram_workspace": "eals_sweep",
            "eals_gram_max_d": "eals_sweep",
            "eals_loss_workspace": "eals_loss", "eals_loss": "eals_loss"}


def _kernel(name: str):
    from buffalo_tpu_torch.ops._build import launcher

    return launcher(name, _SIGNATURES[name], library=_LIBRARY[name])


# ---------------------------------------------------------------- plain
def _sweep_rows(p, y_of, vals, cvals, c_row, mask, S, vhat, *, alpha, reg,
                segsum=None, jacobi=False):
    """The dimension loop of ``_eals_dim_sweep`` :95-109 /
    ``_eals_segment_sweep`` :140-159 on rows p (R, d): ``y_of(t)`` gives
    each entry's y_t (entries (E, L)), ``segsum`` maps per-entry-row sums
    to the R rows (None: one entry row per row).  ``jacobi`` computes every
    dimension from the old row instead (for the check's power only).
    Returns (rows, residuals)."""
    w = (1.0 + alpha * vals) * mask
    wv = w * vals
    wmc = w - cvals * mask
    rows = segsum or (lambda x: x)
    gather = None if segsum is None else segsum.gather
    p0, vhat0 = p.clone(), vhat.clone()
    for t in range(p.shape[1]):
        src_p, src_v = (p0, vhat0) if jacobi else (p, vhat)
        y = y_of(t)
        xt = src_p[:, t]
        xe = xt if gather is None else gather(xt)
        vf = src_v - xe[:, None] * y
        num = rows(((wv - wmc * vf) * y).sum(1))
        den = rows((wmc * y * y).sum(1))
        s_col, s_tt = S[:, t], S[t, t]
        dense = src_p @ s_col - xt * s_tt
        x_new = (num - c_row * dense) / (den + c_row * s_tt + reg)
        xn = x_new if gather is None else gather(x_new)
        if not jacobi:
            vhat = vf + xn[:, None] * y
        p = p.clone()
        p[:, t] = x_new
    return p, vhat


def range_sweep_plain(X, Y, S, C, row_start, lens, cols, vals, *, item_axis,
                      alpha, reg, jacobi=False):
    """Plain version of K13's range mode (``_eals_apply_batch`` :176-190,
    ``_eals_dim_sweep`` :71), in place on rows [row_start, + B) of X."""
    B, L = cols.shape
    p = X[row_start:row_start + B]
    F = Y[cols.long()]
    vals = vals.float()
    mask = (torch.arange(L, device=X.device)[None, :] < lens[:, None]).float()
    if item_axis:
        c_row = C[row_start:row_start + B]
        cvals = c_row[:, None].expand(B, L)
    else:
        c_row = torch.ones(B, dtype=torch.float32, device=X.device)
        cvals = C[cols.long()]
    vhat = torch.einsum("bd,bld->bl", p, F) * mask
    x, _ = _sweep_rows(p, lambda t: F[:, :, t], vals, cvals, c_row, mask, S,
                       vhat, alpha=alpha, reg=reg, jacobi=jacobi)
    X[row_start:row_start + B] = x


class _SegSum:
    """Per-chunk sums -> per-row sums over ``seg`` (padding chunks R
    dropped), and rows -> chunks (padding 0), ``_eals_segment_sweep``'s
    ``segment_sum`` / ``chunk_rows``."""

    def __init__(self, seg, R):
        self.seg, self.R = seg, R

    def __call__(self, x):
        out = torch.zeros(self.R + 1, dtype=x.dtype, device=x.device)
        return out.index_add_(0, self.seg, x)[:self.R]

    def gather(self, x):
        return torch.cat([x, x.new_zeros(1)])[self.seg]


def segment_sweep_plain(X, Y, S, C, batch, *, item_axis, alpha, reg,
                        jacobi=False):
    """Plain version of K13's segment mode (``_eals_apply_batch`` :191-204,
    ``_eals_segment_sweep`` :115), in place on X's rows ``batch.rows``
    (rows past the table dropped)."""
    R = batch.rows.shape[0]
    n = X.shape[0]
    safe = torch.clamp(batch.rows.long(), max=n - 1)
    p = X[safe]
    Nc, Cw = batch.cols.shape
    seg = torch.clamp(batch.seg_ids.long(), max=R)
    mask = (torch.arange(Cw, device=X.device)[None, :]
            < batch.chunk_lens[:, None]).float()
    F = Y[batch.cols.long()]
    if item_axis:
        c_row = torch.where(batch.lens > 0, C[safe], torch.zeros_like(C[safe]))
        cvals = c_row[torch.clamp(batch.seg_ids.long(), max=R - 1)][:, None] \
            .expand(Nc, Cw)
    else:
        c_row = torch.ones(R, dtype=torch.float32, device=X.device)
        cvals = C[batch.cols.long()]
    segsum = _SegSum(seg, R)
    p0 = torch.cat([p, p.new_zeros(1, p.shape[1])])[seg]
    vhat = torch.einsum("ncd,nd->nc", F, p0) * mask
    x, _ = _sweep_rows(p, lambda t: F[:, :, t], batch.vals.float(), cvals,
                       c_row, mask, S, vhat, alpha=alpha, reg=reg,
                       segsum=segsum, jacobi=jacobi)
    keep = batch.rows.long() < n
    X[batch.rows.long()[keep]] = x[keep]


def rows_sweep_plain(X, Y, S, C, indptr, cols, vals, vhat, *, item_axis,
                     alpha, reg, jacobi=False):
    """Plain version of K13's rows mode (``eals_half_epoch`` :24): every
    row of X over its CSR entries, the residuals ``vhat`` (nnz) carried in
    and updated in place."""
    n = X.shape[0]
    row_ids = torch.repeat_interleave(
        torch.arange(n, device=X.device), indptr[1:] - indptr[:-1])
    c_row = C if item_axis else torch.ones(n, dtype=torch.float32,
                                           device=X.device)
    cvals = (C[row_ids] if item_axis else C[cols.long()])[:, None]
    keys = cols.long()
    ones = torch.ones_like(cvals)

    class RowSum(_SegSum):
        def gather(self, x):
            return x[row_ids]

    x, v = _sweep_rows(X, lambda t: Y[keys, t][:, None], vals.float()[:, None],
                       cvals, c_row, ones, S, vhat[:, None].clone(),
                       alpha=alpha, reg=reg, segsum=RowSum(row_ids, n),
                       jacobi=jacobi)
    X.copy_(x)
    vhat.copy_(v[:, 0])


def eals_residual_plain(P, Q, row_ids, keys, vals=None, C=None, *, alpha=0.0,
                        vhat=None, sums=True):
    """Plain version of K14: (vhat (nnz) float32: the given one or
    ``(P[r] * Q[c]).sum(-1)``, the sums (sum w err^2, sum C[c] vhat^2,
    sum err^2) as a (3,) float32 tensor or None)."""
    if vhat is None:
        vhat = (P[row_ids.long()] * Q[keys.long()]).sum(-1)
    if not sums:
        return vhat, None
    err = vals - vhat
    w = 1.0 + alpha * vals
    return vhat, torch.stack([(w * err * err).sum(),
                              (C[keys.long()] * vhat * vhat).sum(),
                              (err * err).sum()])


# ------------------------------------------------------------- wrappers
def _check_tables(X, Y, S, C, dev):
    _check("X", X, torch.float32, dev, 2)
    _check("Y", Y, torch.float32, dev, 2)
    _check("S", S, torch.float32, dev, 2)
    _check("C", C, torch.float32, dev, 1)
    d = X.shape[1]
    if Y.shape[1] != d or tuple(S.shape) != (d, d):
        raise ValueError(f"X {tuple(X.shape)}, Y {tuple(Y.shape)} and S "
                         f"{tuple(S.shape)} disagree")
    return d


def dim_sweep_form(d, batch):
    """K13's form on the card for rows of ``d`` floats: "gram" for a range
    or segment batch up to ``GRAM_MAX_D``, else "sweep" (the rows mode,
    ``batch`` None, and wider rows)."""
    return "gram" if batch is not None and d <= GRAM_MAX_D else "sweep"


def dim_sweep(X, Y, S, C, *, item_axis, alpha, reg, batch=None, indptr=None,
              cols=None, vals=None, vhat=None):
    """K13: the eALS dimension sweep of one batch's rows of X, in place.
    ``batch``: a staged ``RangeBatch`` (rows [row_start, + B) of the
    permuted table) or ``StagedSegmentBatch`` (head rows, ids past the
    table dropped), residuals recomputed from the factors; without it, the
    rows mode: every row of X over CSR ``indptr`` (int64) / ``cols`` /
    ``vals`` with the residuals ``vhat`` carried in place.  ``C``: the
    negative weights, indexed by the fixed side's column (user pass) or
    X's own row (``item_axis``).  The form on the card is
    ``dim_sweep_form``'s.  Replaces ``_eals_dim_sweep`` :71,
    ``_eals_segment_sweep`` :115, ``_eals_apply_batch`` :165 and
    ``eals_half_epoch`` :24 (``buffalo_tpu/ops/eals_kernels.py``)."""
    kw = dict(item_axis=item_axis, alpha=alpha, reg=reg)
    on_cpu = X.device.type == "cpu"
    if isinstance(batch, RangeBatch):
        if on_cpu:
            return range_sweep_plain(X, Y, S, C, int(batch.row_start),
                                     batch.lens, batch.cols, batch.vals, **kw)
    elif isinstance(batch, StagedSegmentBatch):
        if on_cpu:
            return segment_sweep_plain(X, Y, S, C, batch, **kw)
    elif batch is None:
        if on_cpu:
            return rows_sweep_plain(X, Y, S, C, indptr, cols, vals, vhat,
                                    **kw)
    else:
        raise TypeError(f"unexpected batch type {type(batch).__name__}; "
                        "stage batches with data.batching.stage_batch")
    dev = X.device
    d = _check_tables(X, Y, S, C, dev)
    form = dim_sweep_form(d, batch)
    args = dict(row_start=0, B=0, L=0, lens=None, rows=None, R=0,
                chunk_ptr=None, chunk_lens=None, Cw=0, indptr=None)
    if isinstance(batch, RangeBatch):
        mode, cols, vals = 0, batch.cols, batch.vals
        B, L = cols.shape
        _check("lens", batch.lens, torch.int32, dev, 1)
        rs = int(batch.row_start)
        if rs < 0 or rs + B > X.shape[0] or L > MAX_RANGE_L:
            raise ValueError(f"range batch rows [{rs}, {rs + B}) x {L} past "
                             f"a table of {X.shape[0]} (or L > "
                             f"{MAX_RANGE_L})")
        args.update(row_start=rs, B=B, L=L, lens=batch.lens)
    elif isinstance(batch, StagedSegmentBatch):
        mode, cols, vals = 1, batch.cols, batch.vals
        R = batch.rows.shape[0]
        for name in ("rows", "lens", "chunk_ptr", "chunk_lens"):
            _check(name, getattr(batch, name), torch.int32, dev, 1)
        if form == "sweep":
            vhat = torch.empty(cols.shape, dtype=torch.float32, device=dev)
        args.update(lens=batch.lens, rows=batch.rows, R=R,
                    chunk_ptr=batch.chunk_ptr, chunk_lens=batch.chunk_lens,
                    Cw=cols.shape[1])
    else:
        mode = 2
        _check("indptr", indptr, torch.int64, dev, 1)
        if indptr.shape[0] != X.shape[0] + 1:
            raise ValueError("indptr must have one entry per row of X, + 1")
        _check("vhat", vhat, torch.float32, dev, 1)
        args.update(indptr=indptr)
    _check("cols", cols, torch.int32, dev, cols.dim())
    _check("vals", vals, torch.float32, dev, cols.dim())
    head = (mode, _ptr(X), X.shape[0], _ptr(Y), d, _ptr(S), _ptr(C),
            int(bool(item_axis)), float(alpha), float(reg), args["row_start"],
            args["B"], args["L"], _ptr(args["lens"]), _ptr(args["rows"]),
            args["R"], _ptr(args["chunk_ptr"]), _ptr(args["chunk_lens"]),
            args["Cw"])
    if form == "gram":
        # the pieces' partials of rows past one block (range rows longer
        # than its piece, segment chunks)
        units, width = cols.shape
        n_work = _kernel("eals_gram_workspace")(mode, units, width, d)
        if n_work < 0:
            raise ValueError(f"{units} x {width} entries of rows of {d} "
                             "floats need a workspace past 2^31 floats")
        work = (torch.empty(n_work, dtype=torch.float32, device=dev)
                if n_work else None)
        rc = _kernel("eals_gram_sweep")(
            *head, units if mode == 1 else 0, _ptr(cols), _ptr(vals),
            _ptr(work), _stream(dev))
    else:
        rc = _kernel("eals_sweep")(
            *head, _ptr(args["indptr"]), _ptr(cols), _ptr(vals), _ptr(vhat),
            _stream(dev))
    _raise_on(rc, "dim_sweep")
    dim_sweep.launches += 1


dim_sweep.launches = 0


def eals_residual(P, Q, row_ids, keys, vals=None, C=None, *, alpha=0.0,
                  vhat=None, sums=True):
    """K14: the residuals and the loss's nnz sums (see
    ``eals_residual_plain``) in one pass over the entries; ``vhat`` given:
    only the sums, from it.  Replaces ``compute_vhat`` :356 and the sums
    of ``eals_loss`` :334-344.  Returns (vhat, or None when it is given or
    the sums are asked; sums (3,) float32 or None)."""
    kw = dict(alpha=alpha, vhat=vhat, sums=sums)
    if P.device.type == "cpu":
        out, s = eals_residual_plain(P, Q, row_ids, keys, vals, C, **kw)
        return (out if vhat is None and not sums else None), s
    dev = P.device
    _check("P", P, torch.float32, dev, 2)
    _check("Q", Q, torch.float32, dev, 2)
    d = P.shape[1]
    if Q.shape[1] != d:
        raise ValueError(f"P is {d} wide, Q {Q.shape[1]}")
    n = row_ids.shape[0]
    _check("row_ids", row_ids, torch.int32, dev, 1)
    _check("keys", keys, torch.int32, dev, 1)
    if keys.shape[0] != n:
        raise ValueError("row_ids and keys disagree")
    if vhat is not None:
        _check("vhat", vhat, torch.float32, dev, 1)
    out = (torch.empty(n, dtype=torch.float32, device=dev)
           if vhat is None and not sums else None)
    total = part = None
    if sums:
        _check("vals", vals, torch.float32, dev, 1)
        _check("C", C, torch.float32, dev, 1)
        total = torch.empty(3, dtype=torch.float32, device=dev)
        n_part = _kernel("eals_loss_workspace")(n)
        if n_part < 0:
            raise RuntimeError("eals_residual: no grid for this card")
        part = torch.empty(n_part, dtype=torch.float64, device=dev)
    rc = _kernel("eals_loss")(
        _ptr(P), _ptr(Q), d, _ptr(row_ids), _ptr(keys), _ptr(vals), _ptr(C),
        n, float(alpha), _ptr(vhat), _ptr(out), _ptr(part), _ptr(total),
        _stream(dev))
    _raise_on(rc, "eals_residual")
    eals_residual.launches += 1
    return out, total


eals_residual.launches = 0

KERNELS = (dim_sweep, eals_residual)


# -------------------------------------------------------- composed steps
def eals_gramian(T, C_perm=None):
    """Sq = (C^0.5 Q)^T (C^0.5 Q) or Sp = P^T P (``eals_gramian`` :235), a
    plain product."""
    if C_perm is not None:
        T = T * torch.sqrt(C_perm)[:, None]
    return torch.matmul(T.T, T)


def eals_group_step(X, Y, C_perm, S, group, *, item_axis, alpha, reg):
    """The batches of one group (a stacked RangeBatch group or one staged
    batch) through K13 (``eals_group_step`` :225), X in place."""
    for batch in _flat([group]):
        dim_sweep(X, Y, S, C_perm, item_axis=item_axis, alpha=alpha, reg=reg,
                  batch=batch)
    return X


def eals_epoch(P, Q, row_groups, col_groups, C_perm, *, alpha, reg_u,
               reg_i):
    """One eALS epoch on the range layout (``eals_epoch`` :310): Sq, the
    user batches, Sp, the item batches; P and Q updated in place."""
    Sq = eals_gramian(Q, C_perm)
    for g in row_groups:
        eals_group_step(P, Q, C_perm, Sq, g, item_axis=False, alpha=alpha,
                        reg=reg_u)
    Sp = eals_gramian(P)
    for g in col_groups:
        eals_group_step(Q, P, C_perm, Sp, g, item_axis=True, alpha=alpha,
                        reg=reg_i)
    return P, Q


def eals_half_epoch(X, Y, vhat, indptr, keys, vals, C, S, *, item_axis,
                    alpha, reg):
    """Every row of X over its CSR entries with the carried residuals
    (``eals_half_epoch`` :24, the ``range_layout=False`` path), through
    K13's rows mode; X and ``vhat`` updated in place.  The JAX function's
    per-entry ``c_nnz`` and per-row ``c_row`` come from ``C`` and
    ``item_axis``."""
    dim_sweep(X, Y, S, C, item_axis=item_axis, alpha=alpha, reg=reg,
              indptr=indptr, cols=keys, vals=vals, vhat=vhat)
    return X, vhat


def compute_vhat(P, Q, row_ids, keys):
    """Per-entry predictions p_u . q_i (``compute_vhat`` :356), K14."""
    return eals_residual(P, Q, row_ids, keys, sums=False)[0]


def eals_loss(P, Q, vhat, row_ids, keys, vals, C, reg_u, reg_i, *, alpha):
    """RMSE and the total loss with negative feedback (``eals_loss`` :334):
    sum w err^2 - sum C_i vhat^2 + <P^T P, Q^T C Q> + reg_u |P|^2 + reg_i
    |Q|^2.  The nnz sums come from K14 (with ``vhat`` None, the residuals
    are computed in the same pass); the rest are products of the tables.
    Returns 0-d tensors (rmse, total)."""
    _, s = eals_residual(P, Q, row_ids, keys, vals, C, alpha=alpha, vhat=vhat)
    CQ = Q * torch.sqrt(C)[:, None]
    feedbacks = s[0] - s[1] + (torch.matmul(P.T, P)
                               * torch.matmul(CQ.T, CQ)).sum()
    reg = reg_u * (P * P).sum() + reg_i * (Q * Q).sum()
    return torch.sqrt(s[2] / row_ids.shape[0]), feedbacks + reg


# ------------------------------------------------------------ device mesh
def _sweep_segments(mesh, X, Y_full, S, C, segments, *, item_axis, alpha,
                    reg):
    """Segment batches (global ids) on the gathered X of this process's
    first device, their rows written back into the shards that own
    them."""
    from buffalo_tpu_torch import parallelism as par

    if not segments:
        return
    X_full = par.all_gather_rows(mesh, X, first_only=True)
    for sb in segments:
        dim_sweep(X_full, Y_full, S, C, item_axis=item_axis, alpha=alpha,
                  reg=reg, batch=sb)
    par.write_back(mesh, X, X_full)


def eals_epoch_sharded_range(P, Q, row_groups, col_groups, row_segments,
                             col_segments, C_perm, *, mesh, alpha, reg_u,
                             reg_i):
    """One eALS epoch over a device mesh on the per-shard range layout
    (``eals_epoch_sharded_range`` :245).  ``P``, ``Q`` and ``C_perm``: this
    process's row shards (one tensor per local shard, in the order of
    ``build_sharded_range_layout``); ``*_groups``: per local shard its
    staged groups; ``*_segments``: staged SegmentBatches with global ids
    on the mesh's first device.  Per half the weighted gramian is an
    all-reduce of per-shard partials (``eals_gramian`` :235), the fixed
    side is all-gathered (and on the user pass ``C_perm``, read at the
    fixed side's positions; the item pass reads each shard's own), each
    shard's batches run K13 into the shard, then the segment rows.  The
    shards are updated in place."""
    from buffalo_tpu_torch import parallelism as par

    kw = dict(alpha=alpha)
    Sq = par.all_reduce_sum(mesh, [eals_gramian(q, c)
                                   for q, c in zip(Q, C_perm)])
    Q_full = par.all_gather_rows(mesh, Q)
    C_full = par.all_gather_rows(mesh, C_perm)
    for p, q, s, c, groups in zip(P, Q_full, Sq, C_full, row_groups):
        for g in groups:
            eals_group_step(p, q, c, s, g, item_axis=False, reg=reg_u, **kw)
    _sweep_segments(mesh, P, Q_full[0], Sq[0], C_full[0], row_segments,
                    item_axis=False, reg=reg_u, **kw)
    Sp = par.all_reduce_sum(mesh, [eals_gramian(p) for p in P])
    P_full = par.all_gather_rows(mesh, P)
    for q, p, s, c, groups in zip(Q, P_full, Sp, C_perm, col_groups):
        for g in groups:
            eals_group_step(q, p, c, s, g, item_axis=True, reg=reg_i, **kw)
    _sweep_segments(mesh, Q, P_full[0], Sp[0], C_full[0], col_segments,
                    item_axis=True, reg=reg_i, **kw)
    return P, Q
