"""pLSI EM steps on one device.

PyTorch counterpart of ``buffalo_tpu.ops.plsi_kernels``'s single-device
functions (Hofmann, Probabilistic Latent Semantic Indexing, SIGIR 99): the
E-step responsibility ``P(z|u) Q(i|z)`` normalized over z, accumulated into
next-epoch tables weighted by the interaction value, loss ``-sum v
log(norm)``; the M-step smoothing by ``alpha1 / d`` and ``alpha2 / |I|``
with P's rows and Q's columns normalized.  Two hand-written CUDA kernels
(``csrc/*.cu``), each beside its plain PyTorch version (``*_plain``):

* **K15** ``plsi_estep`` — the E-step of one staged batch.  Range mode (a
  ``RangeBatch`` of the bucket-order layout) and segment mode (a
  ``StagedSegmentBatch`` of head rows) accumulate one orientation's sums
  ``a * sum_l (w_l / norm_l) f_l`` with the norm floored once at ``d *
  1e-10`` (``_estep_block`` :111); the padded mode (``padded=True``, a
  ``PaddedBatch`` or ``StagedSegmentBatch`` of the fallback path) floors
  each latent element at 1e-10 and accumulates both tables, Q's by column
  through an ordered grouping (``plsi_accumulate`` :23,
  ``_accumulate_chunks`` :44).  Each returns the batch's per-row loss.
* **K16** ``plsi_mstep`` — the smoothing and the normalizations, in place:
  masked to the real rows of the permuted tables (``_mstep`` :209) or over
  every row (``plsi_normalize_swap`` :313); a zero sum divides by 1.

The compositions (``plsi_epoch_range``, ``plsi_epoch`` and the per-group
steps) are plain loops over them.  Each wrapper runs its plain version for
CPU tensors and launches its kernel (or raises) for CUDA tensors;
``launches`` on each wrapper counts the calls that launched it.  Rows are at
most ``MAX_D`` floats wide; values are float32.
"""
from __future__ import annotations

import ctypes

import torch

from buffalo_tpu_torch.data.batching import (PaddedBatch, RangeBatch,
                                             StagedSegmentBatch)
from buffalo_tpu_torch.ops.als_kernels import (_check, _flat, _ptr, _raise_on,
                                               _stream)

MAX_D = 256

_P, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_float)
# C signatures of the launch functions (csrc/plsi_*.cu); each returns the
# cudaError_t of its launches
_SIGNATURES = {
    "plsi_estep_workspace": [_I32, _I32, _I32, _P],
    "plsi_estep": [_I32, _P, _I32, _P, _P, _I32, _I32, _I32, _I32, _P, _P,
                   _I32, _P, _P, _P, _P, _P, _P, _I32, _P, _P, _P, _P, _P,
                   _P],
    "plsi_mstep_workspace": [_I32, _I32],
    "plsi_mstep": [_P, _I32, _P, _I32, _I32, _F32, _F32, _P, _P, _P, _P],
}
_LIBRARY = {"plsi_estep_workspace": "plsi_estep", "plsi_estep": "plsi_estep",
            "plsi_mstep_workspace": "plsi_mstep", "plsi_mstep": "plsi_mstep"}
# K15's launch modes
RANGE, SEGMENT, PADDED_ROWS, PADDED_SEGMENT = 0, 1, 2, 3


def _kernel(name: str):
    from buffalo_tpu_torch.ops._build import launcher

    return launcher(name, _SIGNATURES[name], library=_LIBRARY[name])


# ---------------------------------------------------------------- plain
def _mask(lens, L):
    return (torch.arange(L, device=lens.device)[None, :]
            < lens[:, None]).float()


def _summed_floor(a, f, vals, mask):
    """``_estep_block`` :111: (sums (R, d), per-row loss (R,)) of rows a
    (R, d) over their gathered entries f (R, L, d)."""
    d = a.shape[-1]
    norm = torch.einsum("bd,bld->bl", a, f).clamp_min(d * 1e-10)
    w = vals * mask
    loss = -(torch.log(norm) * w).sum(-1)
    return a * torch.einsum("bl,bld->bd", w / norm, f), loss


def _element_floor(p, q, vals, mask):
    """``plsi_accumulate`` :33-36: (latent (R, L, d) normalized and
    weighted, per-row loss (R,))."""
    latent = (p[:, None, :] * q).clamp_min(1e-10)
    norm = latent.sum(-1, keepdim=True)
    w = vals * mask
    loss = -(torch.log(norm[..., 0]) * w).sum(-1)
    return latent / norm * w[..., None], loss


def _chunk_rows(batch, n):
    """(global row of each chunk, past-the-table for padding chunks; the
    chunks' local rows (padding -> R))."""
    R = batch.rows.shape[0]
    seg = batch.seg_ids.long().clamp(max=R)
    padded = torch.cat([batch.rows.long(),
                        torch.full((1,), n, dtype=torch.long,
                                   device=batch.rows.device)])
    return padded[seg], seg


def _segment_sum(x, seg, R):
    out = x.new_zeros((R + 1,) + tuple(x.shape[1:]))
    return out.index_add_(0, seg, x)[:R]


def _add_rows(An, rows, x):
    """``An.at[rows].add(x, mode="drop")``."""
    keep = rows < An.shape[0]
    An.index_add_(0, rows[keep], x[keep])


def estep_range_plain(An, A, Bf, row_start, lens, cols, vals, *,
                      with_loss=True):
    """Plain version of K15's range mode (``_range_accumulate`` :143):
    An[row_start:+B] += the rows' sums.  Returns the per-row loss (B,) or
    None."""
    B, L = cols.shape
    a = A[row_start:row_start + B]
    sums, loss = _summed_floor(a, Bf[cols.long()], vals, _mask(lens, L))
    An[row_start:row_start + B] += sums
    return loss if with_loss else None


def estep_segment_plain(An, A, Bf, batch, *, with_loss=True):
    """Plain version of K15's segment mode (``_segment_accumulate`` :162):
    per-chunk sums added to An[rows] (rows past the table dropped).
    Returns the per-row loss (R,) or None."""
    R = batch.rows.shape[0]
    n = An.shape[0]
    chunk_rows, seg = _chunk_rows(batch, n)
    a = A[chunk_rows.clamp(max=A.shape[0] - 1)]
    sums, loss = _summed_floor(a, Bf[batch.cols.long()], batch.vals,
                               _mask(batch.chunk_lens, batch.cols.shape[1]))
    _add_rows(An, chunk_rows, sums)
    return _segment_sum(loss, seg, R) if with_loss else None


def estep_padded_plain(Pn, Qn, P, Q, batch):
    """Plain version of K15's padded mode: ``plsi_accumulate`` :23 on a
    ``PaddedBatch``, ``_accumulate_chunks`` :44 (via
    ``plsi_accumulate_segments`` :66) on a ``StagedSegmentBatch``.  Adds
    each row's latent sums to Pn[rows] and each entry's latent row to
    Qn[col].  Returns the per-row loss."""
    n = P.shape[0]
    if isinstance(batch, StagedSegmentBatch):
        R = batch.rows.shape[0]
        rows, seg = _chunk_rows(batch, n)
        lens = batch.chunk_lens
    else:
        rows, seg, lens = batch.rows.long(), None, batch.lens
    cols = batch.cols.long()
    latent, loss = _element_floor(P[rows.clamp(max=n - 1)], Q[cols],
                                  batch.vals, _mask(lens, cols.shape[1]))
    _add_rows(Pn, rows, latent.sum(1))
    Qn.index_add_(0, cols.reshape(-1), latent.reshape(-1, latent.shape[-1]))
    return loss if seg is None else _segment_sum(loss, seg, R)


def mstep_plain(Pn, Qn, *, alpha1, alpha2, num_items=None, p_mask=None,
                q_mask=None):
    """Plain version of K16, in place: ``_mstep`` :209 with the masks of
    the real rows (``num_items`` the real item count), or
    ``plsi_normalize_swap`` :313 without them (``num_items`` = Qn's
    rows)."""
    d = Pn.shape[1]
    if p_mask is None:
        Pn += alpha1 / d
    else:
        Pn += (alpha1 / d) * p_mask[:, None]
    psum = Pn.sum(1, keepdim=True)
    Pn /= torch.where(psum > 0, psum, torch.ones_like(psum))
    if q_mask is None:
        Qn += alpha2 / Qn.shape[0]
    else:
        Qn += (alpha2 / num_items) * q_mask[:, None]
    qsum = Qn.sum(0, keepdim=True)
    Qn /= torch.where(qsum > 0, qsum, torch.ones_like(qsum))


# ------------------------------------------------------------- wrappers
def _check_width(d):
    if d > MAX_D:
        raise NotImplementedError(
            f"the pLSI kernels take rows of at most {MAX_D} floats, got "
            f"d = {d} (ROADMAP queue 2, d > 256)")


def plsi_estep(An, A, Bf, batch, *, padded=False, Qn=None, with_loss=True):
    """K15: one batch's E-step, accumulated in place.

    Range and segment mode (``padded`` False): An += the sums of the rows
    of A (a ``RangeBatch``'s range, a ``StagedSegmentBatch``'s rows) over
    their entries' rows of Bf, with the summed floor.  Padded mode: An is
    Pn, A is P, Bf is Q and ``Qn`` gets each entry's latent row, with the
    element floor.  Replaces ``_estep_block`` :111, ``_range_accumulate``
    :143, ``_segment_accumulate`` :162, ``plsi_accumulate`` :23 and
    ``_accumulate_chunks`` :44 (``buffalo_tpu/ops/plsi_kernels.py``).
    Returns the per-row loss (float32, one per batch row) or None."""
    seg = isinstance(batch, StagedSegmentBatch)
    if not seg and not isinstance(batch, (RangeBatch, PaddedBatch)):
        raise TypeError(f"unexpected batch type {type(batch).__name__}; "
                        "stage batches with data.batching.stage_batch")
    if padded != (Qn is not None) or (
            isinstance(batch, PaddedBatch) != (padded and not seg)):
        raise ValueError("padded mode takes Qn and a PaddedBatch or "
                         "segment batch; range mode a RangeBatch")
    if An.device.type == "cpu":
        if padded:
            return estep_padded_plain(An, Qn, A, Bf, batch)
        if seg:
            return estep_segment_plain(An, A, Bf, batch, with_loss=with_loss)
        return estep_range_plain(An, A, Bf, int(batch.row_start), batch.lens,
                                 batch.cols, batch.vals, with_loss=with_loss)
    dev = An.device
    for name, t in (("An", An), ("A", A), ("Bf", Bf)) + (
            (("Qn", Qn),) if padded else ()):
        _check(name, t, torch.float32, dev, 2)
    d = A.shape[1]
    if An.shape != A.shape or Bf.shape[1] != d or (
            padded and Qn.shape != Bf.shape):
        raise ValueError(f"An {tuple(An.shape)}, A {tuple(A.shape)}, Bf "
                         f"{tuple(Bf.shape)} disagree")
    _check_width(d)
    cols, vals = batch.cols, batch.vals
    _check("cols", cols, torch.int32, dev, 2)
    _check("vals", vals, torch.float32, dev, 2)
    rows = seg_ids = chunk_ptr = None
    row_start = 0
    if seg:
        for name in ("rows", "lens", "chunk_ptr", "chunk_lens", "seg_ids"):
            _check(name, getattr(batch, name), torch.int32, dev, 1)
        rows, lens, seg_ids = batch.rows, batch.chunk_lens, batch.seg_ids
        chunk_ptr = batch.chunk_ptr
        R = rows.shape[0]
        mode = PADDED_SEGMENT if padded else SEGMENT
    else:
        lens = batch.lens
        _check("lens", lens, torch.int32, dev, 1)
        R = lens.shape[0]
        if padded:
            rows = batch.rows
            _check("rows", rows, torch.int32, dev, 1)
            mode = PADDED_ROWS
        else:
            row_start = int(batch.row_start)
            if row_start < 0 or row_start + R > An.shape[0]:
                raise ValueError(f"range batch rows [{row_start}, "
                                 f"{row_start + R}) past a table of "
                                 f"{An.shape[0]}")
            mode = RANGE
    if cols.shape[0] != lens.shape[0]:
        raise ValueError("cols and lens disagree on the batch's rows")
    loss = torch.empty(R, dtype=torch.float32, device=dev) \
        if with_loss or padded else None
    n_entries = cols.numel()
    ws_i = ws_f = norms = seg_part = seg_loss = None
    if seg:  # the chunks' partial sums, added per row in chunk order
        seg_part = torch.empty(max(cols.shape[0] * d, 1), dtype=torch.float32,
                               device=dev)
        seg_loss = torch.empty(max(cols.shape[0], 1), dtype=torch.float64,
                               device=dev)
    if padded:
        sizes = (ctypes.c_int64 * 2)()
        _kernel("plsi_estep_workspace")(n_entries, Qn.shape[0], d,
                                        ctypes.cast(sizes, ctypes.c_void_p))
        ws_i = torch.empty(max(sizes[0], 1), dtype=torch.int32, device=dev)
        ws_f = torch.empty(max(sizes[1], 1), dtype=torch.float32, device=dev)
        norms = torch.empty(max(n_entries, 1), dtype=torch.float32,
                            device=dev)
    rc = _kernel("plsi_estep")(
        mode, _ptr(An), An.shape[0], _ptr(A), _ptr(Bf), Bf.shape[0], d,
        row_start, R, _ptr(rows), _ptr(lens), cols.shape[1], _ptr(cols),
        _ptr(vals), _ptr(chunk_ptr), _ptr(seg_ids), _ptr(loss), _ptr(Qn),
        cols.shape[0], _ptr(norms), _ptr(ws_i), _ptr(ws_f), _ptr(seg_part),
        _ptr(seg_loss), _stream(dev))
    _raise_on(rc, "plsi_estep")
    plsi_estep.launches += 1
    return loss


plsi_estep.launches = 0


def plsi_mstep(Pn, Qn, *, alpha1, alpha2, num_items=None, p_mask=None,
               q_mask=None):
    """K16: the M-step in place (see ``mstep_plain``): both masks (the
    permuted tables' real rows, ``num_items`` the real item count) or
    neither (every row; ``num_items`` = Qn's rows).  Replaces ``_mstep``
    :209 / ``plsi_mstep`` :224 and ``plsi_normalize_swap`` :313."""
    if (p_mask is None) != (q_mask is None) or (
            p_mask is not None and not num_items):
        raise ValueError("give both masks and the real item count, or "
                         "neither")
    kw = dict(alpha1=alpha1, alpha2=alpha2, num_items=num_items,
              p_mask=p_mask, q_mask=q_mask)
    if Pn.device.type == "cpu":
        return mstep_plain(Pn, Qn, **kw)
    dev = Pn.device
    _check("Pn", Pn, torch.float32, dev, 2)
    _check("Qn", Qn, torch.float32, dev, 2)
    d = Pn.shape[1]
    if Qn.shape[1] != d:
        raise ValueError(f"Pn is {d} wide, Qn {Qn.shape[1]}")
    _check_width(d)
    if p_mask is not None:
        _check("p_mask", p_mask, torch.float32, dev, 1)
        _check("q_mask", q_mask, torch.float32, dev, 1)
        if p_mask.shape[0] != Pn.shape[0] or q_mask.shape[0] != Qn.shape[0]:
            raise ValueError("the masks must have one entry per row")
    nq = Qn.shape[0] if p_mask is None else int(num_items)
    part = torch.empty(max(_kernel("plsi_mstep_workspace")(Qn.shape[0], d),
                           1), dtype=torch.float64, device=dev)
    rc = _kernel("plsi_mstep")(
        _ptr(Pn), Pn.shape[0], _ptr(Qn), Qn.shape[0], d, float(alpha1) / d,
        float(alpha2) / nq, _ptr(p_mask), _ptr(q_mask), _ptr(part),
        _stream(dev))
    _raise_on(rc, "plsi_mstep")
    plsi_mstep.launches += 1


plsi_mstep.launches = 0

KERNELS = (plsi_estep, plsi_mstep)


# -------------------------------------------------------- composed steps
def _loss_sum(losses, like):
    """The epoch's loss: one sum over every batch's per-row losses."""
    losses = [x for x in losses if x is not None]
    return torch.cat(losses).sum() if losses else like.new_zeros(())


def plsi_accumulate_group(An, A, Bf, group, *, with_loss):
    """One staged batch or stacked RangeBatch group into An through K15
    (``plsi_accumulate_group`` :199 / ``plsi_segment_group`` :205).
    Returns the per-row losses of its batches."""
    return [plsi_estep(An, A, Bf, b, with_loss=with_loss)
            for b in _flat([group])]


def plsi_epoch_range(P, Q, row_groups, col_groups, p_mask, q_mask, *,
                     alpha1, alpha2, num_items):
    """One EM epoch on the bucket-order layout (``plsi_epoch_range`` :229):
    the rowwise pass accumulates Pn and the loss, the colwise pass Qn, then
    the masked M-step.  Returns (P', Q', loss) with new tables; P and Q are
    only read."""
    Pn, Qn = torch.zeros_like(P), torch.zeros_like(Q)
    losses = []
    for g in row_groups:
        losses += plsi_accumulate_group(Pn, P, Q, g, with_loss=True)
    for g in col_groups:
        plsi_accumulate_group(Qn, Q, P, g, with_loss=False)
    plsi_mstep(Pn, Qn, alpha1=alpha1, alpha2=alpha2, num_items=num_items,
               p_mask=p_mask, q_mask=q_mask)
    return Pn, Qn, _loss_sum(losses, P)


def plsi_accumulate(Pn, Qn, P, Q, batch):
    """One padded or segment batch of the fallback path through K15's
    padded mode (``plsi_accumulate`` :23, ``plsi_accumulate_segments``
    :66).  Returns its per-row loss."""
    return plsi_estep(Pn, P, Q, batch, padded=True, Qn=Qn)


def plsi_normalize_swap(Pn, Qn, *, alpha1, alpha2):
    """The unmasked M-step (``plsi_normalize_swap`` :313) in place, K16."""
    plsi_mstep(Pn, Qn, alpha1=alpha1, alpha2=alpha2)
    return Pn, Qn


def plsi_epoch(P, Q, batches, *, alpha1, alpha2):
    """One EM epoch over the rowwise padded and segment batches
    (``plsi_epoch`` :78, and the streamed loop of ``models/plsi.py``):
    ``batches`` a list of staged batches or an iterable that stages them.
    Returns (P', Q', loss) with new tables."""
    Pn, Qn = torch.zeros_like(P), torch.zeros_like(Q)
    losses = [plsi_accumulate(Pn, Qn, P, Q, b) for b in _flat(batches)]
    plsi_normalize_swap(Pn, Qn, alpha1=alpha1, alpha2=alpha2)
    return Pn, Qn, _loss_sum(losses, P)
