"""pLSI EM steps on one device.

PyTorch counterpart of ``buffalo_tpu.ops.plsi_kernels``'s single-device
functions (Hofmann, Probabilistic Latent Semantic Indexing, SIGIR 99): the
E-step responsibility ``P(z|u) Q(i|z)`` normalized over z, accumulated into
next-epoch tables weighted by the interaction value, loss ``-sum v
log(norm)``; the M-step smoothing by ``alpha1 / d`` and ``alpha2 / |I|``
with P's rows and Q's columns normalized.  Two hand-written CUDA kernels
(``csrc/*.cu``), each beside its plain PyTorch version (``*_plain``):

* **K15** ``plsi_estep`` — the E-step of one staged batch (on the card,
  in the shape ``estep_shape`` picks: rows of up to 32 floats one lane an
  entry holding the whole row on batches at least 32 wide, else up to 64
  floats (128 in segment batches) a team of lanes an entry, four floats a
  lane; wider rows the lanes on the columns).  Range mode (a
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
steps) are plain loops over them.  Over a device mesh
(``plsi_epoch_sharded_range``) K15 runs per shard and K16 in two halves,
``plsi_mstep_sums`` and ``plsi_mstep_apply``, around an all-reduce of Q's
column sums.  Each wrapper runs its plain version for
CPU tensors and launches its kernel (or raises) for CUDA tensors;
``launches`` on each wrapper counts the calls that launched it.  Rows of any
width (past 256 floats the kernels walk them in chunks); values are
float32.
"""
from __future__ import annotations

import ctypes

import torch

from buffalo_tpu_torch.data.batching import (PaddedBatch, RangeBatch,
                                             StagedSegmentBatch)
from buffalo_tpu_torch.ops.als_kernels import (_check, _flat, _ptr, _raise_on,
                                               _stream)


_P, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_float)
# C signatures of the launch functions (csrc/plsi_*.cu); each returns the
# cudaError_t of its launches
_SIGNATURES = {
    "plsi_estep_workspace": [_I32, _I32, _I32, _P],
    "plsi_estep": [_I32, _P, _I32, _P, _P, _I32, _I32, _I32, _I32, _P, _P,
                   _I32, _P, _P, _P, _P, _P, _P, _I32, _P, _P, _P, _P, _P,
                   _I32, _I32, _I32, _I32, _I32, _P],
    "plsi_mstep_workspace": [_I32, _I32],
    "plsi_mstep_sums": [_P, _I32, _P, _I32, _I32, _F32, _F32, _P, _P, _P,
                        _P],
    "plsi_mstep_apply": [_P, _I32, _I32, _F32, _P, _P, _P],
}
_LIBRARY = {"plsi_estep_workspace": "plsi_estep", "plsi_estep": "plsi_estep",
            "plsi_mstep_workspace": "plsi_mstep",
            "plsi_mstep_sums": "plsi_mstep", "plsi_mstep_apply": "plsi_mstep"}
# K15's launch modes
RANGE, SEGMENT, PADDED_ROWS, PADDED_SEGMENT = 0, 1, 2, 3
# K15's team form (csrc/plsi_estep.cu): teams of lanes holding TEAM_FLOATS
# floats of an entry's row each (the C kTeamFloats) for rows of up to
# TEAM_MAX_D floats (SEGMENT_TEAM_MAX_D in segment batches: past 64 floats
# the lanes on the columns were as fast or faster on range and padded
# batches, PERF.md §6); batches at least ENTRIES_MIN_L wide with rows of up
# to 32 floats put one lane on each entry, holding its whole row (8, 16, 24
# or 32 floats); a batch of width L <= 16 puts several rows on a warp;
# range and padded batches wider than PIECE_MIN_L cut their rows into
# pieces of ROW_PIECE entries, a warp each
TEAM_FLOATS, TEAM_MAX_D, SEGMENT_TEAM_MAX_D = 4, 64, 128
ENTRIES_MIN_L = 32
ENTRY_FLOATS = (8, 16, 24, 32)
ROW_PIECE, PIECE_MIN_L = 256, 512


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


def _num_items(Qn, num_items, q_mask):
    """The item count of ``alpha2``'s smoothing: the real items with the
    masks, every row of Qn without them."""
    return Qn.shape[0] if q_mask is None else num_items


def mstep_plain(Pn, Qn, *, alpha1, alpha2, num_items=None, p_mask=None,
                q_mask=None):
    """Plain version of K16, in place: ``_mstep`` :209 with the masks of
    the real rows (``num_items`` the real item count), or
    ``plsi_normalize_swap`` :313 without them (``num_items`` = Qn's
    rows).  The two halves of ``mstep_sums_plain`` and
    ``mstep_apply_plain``, as the kernel's two launches."""
    colsum = mstep_sums_plain(Pn, Qn, alpha1=alpha1, alpha2=alpha2,
                              num_items=num_items, p_mask=p_mask,
                              q_mask=q_mask)
    mstep_apply_plain(Qn, colsum, alpha2=alpha2, num_items=num_items,
                      q_mask=q_mask)


def _smooth_q(Qn, alpha2, num_items, q_mask):
    add = alpha2 / _num_items(Qn, num_items, q_mask)
    return add if q_mask is None else add * q_mask[:, None]


def mstep_sums_plain(Pn, Qn, *, alpha1, alpha2, num_items=None, p_mask=None,
                     q_mask=None):
    """Plain version of K16's first half: P's rows smoothed and normalized
    in place; returns the column sums (float64, (d,)) of Q's smoothed
    rows, Q unchanged."""
    d = Pn.shape[1]
    if p_mask is None:
        Pn += alpha1 / d
    else:
        Pn += (alpha1 / d) * p_mask[:, None]
    psum = Pn.sum(1, keepdim=True)
    Pn /= torch.where(psum > 0, psum, torch.ones_like(psum))
    return (Qn + _smooth_q(Qn, alpha2, num_items, q_mask)).sum(
        0, dtype=torch.float64)


def mstep_apply_plain(Qn, colsum, *, alpha2, num_items=None, q_mask=None):
    """Plain version of K16's second half: Q's rows smoothed and divided by
    the column sums (on a mesh, summed over every shard; a zero sum
    divides by 1), in place."""
    s = colsum.to(Qn.dtype)
    Qn += _smooth_q(Qn, alpha2, num_items, q_mask)
    Qn /= torch.where(s > 0, s, torch.ones_like(s))[None, :]


# ------------------------------------------------------------- wrappers
def _pow2_at_least(n):
    return 1 << max(0, int(n) - 1).bit_length()


def estep_shape(d, L, segment=False):
    """K15's launch shape for rows of d floats in a batch of width L:
    (team, group, lane_floats, piece).
    team: the lanes that take one entry, each holding ``lane_floats``
    floats of its row: one lane and the fewest of ENTRY_FLOATS that hold
    the row for batches at least ENTRIES_MIN_L wide (d <= 32); else
    TEAM_FLOATS each and the smallest power of two that covers d; 0 past
    TEAM_MAX_D (SEGMENT_TEAM_MAX_D for segment batches: the lanes on the
    columns).  Any load width (``estep_vec``) takes these shapes.  group:
    the lanes that walk one batch row, so 32 // group rows share a warp:
    the smallest power of two
    from team up that holds L entries, at most 32; 32 for segment batches
    (a block's warps on one chunk) and for one lane an entry.  piece: the entries of a row a warp takes in range
    and padded batches wider than PIECE_MIN_L (ROW_PIECE; their sums added
    in piece order by a second launch), else 0 (the whole row)."""
    if d > (SEGMENT_TEAM_MAX_D if segment else TEAM_MAX_D):
        return 0, 32, TEAM_FLOATS, 0
    piece = ROW_PIECE if L > PIECE_MIN_L and not segment else 0
    if L >= ENTRIES_MIN_L and d <= ENTRY_FLOATS[-1]:
        return 1, 32, next(f for f in ENTRY_FLOATS if f >= d), piece
    team = _pow2_at_least(-(-d // TEAM_FLOATS))
    if segment or piece:
        return team, 32, TEAM_FLOATS, piece
    return team, min(32, max(team, _pow2_at_least(L))), TEAM_FLOATS, 0


def estep_vec(d, *tables):
    """The load width (4 or 1 floats) of K15's team form for rows of d
    floats of every table: 4 where d and each table's address are
    multiples of 4 floats."""
    if d % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tables):
        return 4
    return 1


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
    team, group, lane_floats, piece = estep_shape(d, cols.shape[1], seg)
    # the chunks' (or pieces') partial sums, added per row in order
    parts = cols.shape[0] if seg else (
        R * -(-cols.shape[1] // piece) if piece else 0)
    if seg or piece:
        seg_part = torch.empty(max(parts * d, 1), dtype=torch.float32,
                               device=dev)
        seg_loss = torch.empty(max(parts, 1), dtype=torch.float64, device=dev)
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
        _ptr(seg_loss), team, group, lane_floats, estep_vec(d, An, A, Bf),
        piece, _stream(dev))
    _raise_on(rc, "plsi_estep")
    plsi_estep.launches += 1
    return loss


plsi_estep.launches = 0


def _mstep_args(Qn, num_items, p_mask, q_mask):
    """Checks the masks' pairing; the item count of the smoothing."""
    if (p_mask is None) != (q_mask is None) or (
            p_mask is not None and not num_items):
        raise ValueError("give both masks and the real item count, or "
                         "neither")
    return int(_num_items(Qn, num_items, q_mask))


def _check_mask(name, mask, table, dev):
    if mask is not None:
        _check(name, mask, torch.float32, dev, 1)
        if mask.shape[0] != table.shape[0]:
            raise ValueError(f"{name} must have one entry per row")


def _launch_sums(Pn, Qn, add_p, add_q, p_mask, q_mask):
    """K16's first launch (``plsi_mstep_sums`` in csrc/plsi_mstep.cu);
    returns the column sums, float64 (d,) on Qn's device."""
    dev = Pn.device
    _check("Pn", Pn, torch.float32, dev, 2)
    _check("Qn", Qn, torch.float32, dev, 2)
    d = Pn.shape[1]
    if Qn.shape[1] != d:
        raise ValueError(f"Pn is {d} wide, Qn {Qn.shape[1]}")
    _check_mask("p_mask", p_mask, Pn, dev)
    _check_mask("q_mask", q_mask, Qn, dev)
    n = _kernel("plsi_mstep_workspace")(Qn.shape[0], d)
    part = torch.empty(n, dtype=torch.float64, device=dev)
    rc = _kernel("plsi_mstep_sums")(
        _ptr(Pn), Pn.shape[0], _ptr(Qn), Qn.shape[0], d, add_p, add_q,
        _ptr(p_mask), _ptr(q_mask), _ptr(part), _stream(dev))
    _raise_on(rc, "plsi_mstep_sums")
    return part[n - d:]


def _launch_apply(Qn, colsum, add_q, q_mask):
    """K16's second launch (``plsi_mstep_apply``), in place."""
    dev = Qn.device
    _check("Qn", Qn, torch.float32, dev, 2)
    d = Qn.shape[1]
    _check_mask("q_mask", q_mask, Qn, dev)
    _check("colsum", colsum, torch.float64, dev, 1)
    if colsum.shape[0] != d:
        raise ValueError(f"colsum must have {d} entries")
    rc = _kernel("plsi_mstep_apply")(
        _ptr(Qn), Qn.shape[0], d, add_q, _ptr(q_mask),
        _ptr(colsum.contiguous()), _stream(dev))
    _raise_on(rc, "plsi_mstep_apply")


def plsi_mstep(Pn, Qn, *, alpha1, alpha2, num_items=None, p_mask=None,
               q_mask=None):
    """K16: the M-step in place (see ``mstep_plain``): both masks (the
    permuted tables' real rows, ``num_items`` the real item count) or
    neither (every row; ``num_items`` = Qn's rows).  Its two launches
    follow each other; one K16 launch in the count.  Replaces ``_mstep``
    :209 / ``plsi_mstep`` :224 and ``plsi_normalize_swap`` :313."""
    nq = _mstep_args(Qn, num_items, p_mask, q_mask)
    if Pn.device.type == "cpu":
        return mstep_plain(Pn, Qn, alpha1=alpha1, alpha2=alpha2,
                           num_items=num_items, p_mask=p_mask,
                           q_mask=q_mask)
    add_q = float(alpha2) / nq
    colsum = _launch_sums(Pn, Qn, float(alpha1) / Pn.shape[1], add_q,
                          p_mask, q_mask)
    _launch_apply(Qn, colsum, add_q, q_mask)
    plsi_mstep.launches += 1


plsi_mstep.launches = 0


def plsi_mstep_sums(Pn, Qn, *, alpha1, alpha2, num_items=None, p_mask=None,
                    q_mask=None):
    """K16's first half, for a row shard of the permuted tables (``_mstep``
    :209 over a mesh): P's rows smoothed and normalized in place; returns
    the column sums of Q's smoothed rows (float64 (d,), in the kernel's
    block order), which the caller sums over the shards before
    ``plsi_mstep_apply``.  Counts as a K16 launch."""
    nq = _mstep_args(Qn, num_items, p_mask, q_mask)
    if Pn.device.type == "cpu":
        return mstep_sums_plain(Pn, Qn, alpha1=alpha1, alpha2=alpha2,
                                num_items=num_items, p_mask=p_mask,
                                q_mask=q_mask)
    colsum = _launch_sums(Pn, Qn, float(alpha1) / Pn.shape[1],
                          float(alpha2) / nq, p_mask, q_mask)
    plsi_mstep.launches += 1
    return colsum


def plsi_mstep_apply(Qn, colsum, *, alpha2, num_items=None, q_mask=None):
    """K16's second half: Q's rows smoothed and divided by ``colsum``
    (float64 (d,), summed over every shard), in place.  Counts as a K16
    launch."""
    nq = int(_num_items(Qn, num_items, q_mask))
    if Qn.device.type == "cpu":
        return mstep_apply_plain(Qn, colsum, alpha2=alpha2,
                                 num_items=num_items, q_mask=q_mask)
    _launch_apply(Qn, colsum, float(alpha2) / nq, q_mask)
    plsi_mstep.launches += 1


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


# ------------------------------------------------------------ device mesh
def _sharded_side(mesh, A, Bf, groups, segments, *, with_loss):
    """One orientation's E-step over row shards: the fixed side
    all-gathered, each shard's range batches into its own accumulator,
    then the segment batches (global ids) into the gathered accumulators
    of this process's first device, written back to the owning shards.
    Returns (accumulators per shard, per-row losses of the shards,
    the segments' losses)."""
    from buffalo_tpu_torch import parallelism as par

    Bf_full = par.all_gather_rows(mesh, Bf)
    An = [torch.zeros_like(a) for a in A]
    losses = []
    for an, a, bf, gs in zip(An, A, Bf_full, groups):
        loss = []
        for g in gs:
            loss += plsi_accumulate_group(an, a, bf, g, with_loss=with_loss)
        losses.append(_loss_sum(loss, a))
    seg = []
    if segments:
        A_full = par.all_gather_rows(mesh, A, first_only=True)
        An_full = par.all_gather_rows(mesh, An, first_only=True)
        for sb in segments:
            seg += plsi_accumulate_group(An_full, A_full, Bf_full[0], sb,
                                         with_loss=with_loss)
        par.write_back(mesh, An, An_full)
    return An, losses, _loss_sum(seg, A[0])


def plsi_epoch_sharded_range(P, Q, row_groups, col_groups, row_segments,
                             col_segments, p_mask, q_mask, *, mesh, alpha1,
                             alpha2, num_items):
    """One EM epoch over a device mesh on the per-shard range layout
    (``plsi_epoch_sharded_range`` :256).  ``P``, ``Q``, ``p_mask`` and
    ``q_mask``: this process's row shards; ``*_groups``: per local shard
    its staged groups; ``*_segments``: staged SegmentBatches (global ids)
    on the mesh's first device.  K15 accumulates each shard's next rows;
    the M-step is K16 in two halves around an all-reduce of Q's column
    sums (``plsi_mstep_sums`` / ``plsi_mstep_apply``); the loss is summed
    over the shards.  Returns (P', Q', loss) with new shards."""
    from buffalo_tpu_torch import parallelism as par

    Pn, losses, seg = _sharded_side(mesh, P, Q, row_groups, row_segments,
                                    with_loss=True)
    Qn, _, _ = _sharded_side(mesh, Q, P, col_groups, col_segments,
                             with_loss=False)
    kw = dict(alpha2=alpha2, num_items=num_items)
    sums = [plsi_mstep_sums(pn, qn, alpha1=alpha1, p_mask=pm, q_mask=qm,
                            **kw)
            for pn, qn, pm, qm in zip(Pn, Qn, p_mask, q_mask)]
    total = par.all_reduce_sum(mesh, sums)
    for qn, s, qm in zip(Qn, total, q_mask):
        plsi_mstep_apply(qn, s, q_mask=qm, **kw)
    loss = par.all_reduce_sum(mesh, [x.reshape(1) for x in losses])[0]
    return Pn, Qn, loss[0] + seg
