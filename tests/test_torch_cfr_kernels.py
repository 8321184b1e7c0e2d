"""The port's CoFactor kernels (plain versions of K17 and K18, around the
solve) against ``buffalo_tpu.ops.cfr_kernels`` on the CPU, on the same
seeded numpy inputs.  Each JAX body (user, item, context, and the three
segment bodies) is one batch's K17, solve and K18 in the port; the updated
rows, biases and loss are held to rtol 1e-4 (atol 1e-5 on the tables):
float32 normal equations summed in another order, and ``sum w f f^T``
formed directly where the JAX package squares ``sqrt(w) f``.  ``llt``
solves exactly; ``manual_cg`` runs the same 3 warm-started steps.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import buffalo_tpu.ops.cfr_kernels as JC
from buffalo_tpu.data.batching import SegmentBatch as JSegmentBatch
from buffalo_tpu_torch.data.batching import (PaddedBatch, SegmentBatch,
                                             stage_batch)
from buffalo_tpu_torch.ops import cfr_kernels as CK

TOL = dict(rtol=1e-4, atol=1e-5)
KW = dict(cg_iters=3, cg_tol=1e-10, compute_loss=True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _state(seed, d=6, nu=40, ni=30):
    rng = np.random.default_rng(seed)
    U = (0.3 * rng.standard_normal((nu, d))).astype(np.float32)
    I = (0.3 * rng.standard_normal((ni, d))).astype(np.float32)
    C = (0.3 * rng.standard_normal((ni, d))).astype(np.float32)
    Ib = (0.1 * rng.standard_normal(ni)).astype(np.float32)
    Cb = (0.1 * rng.standard_normal(ni)).astype(np.float32)
    return rng, U, I, C, Ib, Cb


def _padded(rng, B, L, n_cols, lens=None):
    if lens is None:
        lens = rng.integers(0, L + 1, B).astype(np.int32)
    cols = rng.integers(0, n_cols, (B, L)).astype(np.int32)
    vals = (rng.integers(1, 6, (B, L))
            * (np.arange(L)[None, :] < lens[:, None])).astype(np.float32)
    return lens, cols, vals


def _rows(rng, B, n):
    rows = rng.permutation(n)[:B].astype(np.int32)
    rows[[1, B - 2]] = n
    return rows


def _segment(rng, rows, lens_per_chunk, seg_ids, n_cols, C=8):
    chunk_lens = np.asarray(lens_per_chunk, np.int32)
    seg_ids = np.asarray(seg_ids, np.int32)
    R = len(rows)
    lens = np.zeros(R, np.int32)
    np.add.at(lens, seg_ids[seg_ids < R], chunk_lens[seg_ids < R])
    cols = rng.integers(0, n_cols, (len(chunk_lens), C)).astype(np.int32)
    vals = (rng.integers(1, 6, (len(chunk_lens), C))
            * (np.arange(C) < chunk_lens[:, None])).astype(np.float32)
    return SegmentBatch(np.asarray(rows, np.int32), lens, seg_ids,
                        chunk_lens, cols, vals)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def test_implicit_terms_match_jax():
    rng, U, I, C, Ib, Cb = _state(1)
    lens, cols, vals = _padded(rng, 9, 12, U.shape[0])
    mask = (np.arange(12)[None, :] < lens[:, None]).astype(np.float32)
    A, y, _ = JC._implicit_terms(_j(U[cols]), _j(vals), _j(mask), 8.0)
    d = U.shape[1]
    gA, gy, _, total = CK.cfr_normal_equations_plain(
        _t(I), _t(np.arange(9, dtype=np.int32)),
        implicit=CK.Side(_t(U), _t(lens), _t(cols), _t(vals)),
        FF=torch.zeros(d, d), alpha=8.0, l=1.0, reg=0.0)
    _close(gA, A)
    _close(gy, y)
    np.testing.assert_array_equal(total.numpy(), lens)


@pytest.mark.parametrize("optimizer", ["llt", "manual_cg"])
def test_user_body_matches_jax(optimizer):
    rng, U, I, C, Ib, Cb = _state(2)
    rows = _rows(rng, 12, U.shape[0])
    lens, cols, vals = _padded(rng, 12, 10, I.shape[0])
    lens[rows == U.shape[0]] = 0
    FF = (I.T @ I).astype(np.float32)
    wU, wl = JC._cfr_user_body(
        _j(U), _j(I), _j(FF), _j(rows), _j(lens), _j(cols), _j(vals),
        alpha=8.0, l=1.5, reg_u=0.1, optimizer=optimizer, cg_iters=3,
        cg_tol=1e-10, compute_loss=True)
    gU = _t(U).clone()
    loss = CK.cfr_user_step(gU, _t(I), _t(FF),
                            PaddedBatch(*map(_t, (rows, lens, cols, vals))),
                            alpha=8.0, l=1.5, reg_u=0.1, optimizer=optimizer,
                            **KW)
    _close(gU, wU)
    _close(loss.sum(), wl)


@pytest.mark.parametrize("optimizer", ["llt", "manual_cg"])
def test_item_body_matches_jax(optimizer):
    """The padded item body: rows with user entries and no SPPMI entries
    (their bias reset to 0), rows with SPPMI entries only (the leftover
    items, solved since the row mask counts both sides), padding ids."""
    rng, U, I, C, Ib, Cb = _state(3)
    B = 14
    rows = _rows(rng, B, I.shape[0])
    lens_u, cols_u, vals_u = _padded(rng, B, 10, U.shape[0])
    lens_c = rng.integers(0, 7, B).astype(np.int32)
    lens_u[[3, 4]] = 0
    lens_c[[3, 5, 6]] = [4, 0, 0]
    lens_u[rows == I.shape[0]] = 0
    lens_c[rows == I.shape[0]] = 0
    _, cols_c, vals_c = _padded(rng, B, 6, C.shape[0], lens_c)
    FF = (U.T @ U).astype(np.float32)
    wI, wIb, wl = JC._cfr_item_body(
        _j(I), _j(U), _j(C), _j(Ib), _j(Cb), _j(FF), _j(rows), _j(lens_u),
        _j(cols_u), _j(vals_u), _j(lens_c), _j(cols_c), _j(vals_c),
        alpha=8.0, l=1.5, reg_i=0.1, optimizer=optimizer, cg_iters=3,
        cg_tol=1e-10, compute_loss=True)
    gI, gIb = _t(I).clone(), _t(Ib).clone()
    entry = (PaddedBatch(*map(_t, (rows, lens_u, cols_u, vals_u))),
             _t(lens_c), _t(cols_c), _t(vals_c))
    loss = CK.cfr_item_step(gI, _t(U), _t(C), gIb, _t(Cb), _t(FF), entry,
                            alpha=8.0, l=1.5, reg_i=0.1, optimizer=optimizer,
                            **KW)
    _close(gI, wI)
    _close(gIb, wIb)
    _close(loss.sum(), wl)
    assert float(gIb[rows[5]]) == 0.0 and float(gIb[rows[6]]) == 0.0
    # the leftover row (no user entries) moved
    assert not np.allclose(gI[rows[3]].numpy(), I[rows[3]])


@pytest.mark.parametrize("optimizer", ["llt", "manual_cg"])
def test_context_body_matches_jax(optimizer):
    rng, U, I, C, Ib, Cb = _state(4)
    rows = _rows(rng, 12, C.shape[0])
    lens, cols, vals = _padded(rng, 12, 9, I.shape[0])
    lens[rows == C.shape[0]] = 0
    wC, wCb, wl = JC._cfr_context_body(
        _j(C), _j(I), _j(Ib), _j(Cb), _j(rows), _j(lens), _j(cols),
        _j(vals), reg_c=0.1, optimizer=optimizer, cg_iters=3, cg_tol=1e-10,
        compute_loss=True)
    gC, gCb = _t(C).clone(), _t(Cb).clone()
    loss = CK.cfr_context_step(
        gC, _t(I), _t(Ib), gCb,
        PaddedBatch(*map(_t, (rows, lens, cols, vals))), reg_c=0.1,
        optimizer=optimizer, **KW)
    _close(gC, wC)
    _close(gCb, wCb)
    _close(loss.sum(), wl)


@pytest.mark.parametrize("optimizer", ["llt", "manual_cg"])
def test_segment_bodies_match_jax(optimizer):
    """The user, item (a segment pair over one row list) and context
    segment bodies, rows of several chunks, a row without SPPMI entries
    (one empty chunk) and padding rows."""
    rng, U, I, C, Ib, Cb = _state(5)
    nu, ni = U.shape[0], I.shape[0]
    sb = _segment(rng, [4, 9, nu, nu], [8, 8, 3, 5, 0, 0], [0, 0, 0, 1, 4, 4],
                  ni)
    FF = (I.T @ I).astype(np.float32)
    wU, wl = JC._cfr_user_segment_body(
        _j(U), _j(I), _j(FF), JSegmentBatch(*sb), alpha=8.0, l=1.5,
        reg_u=0.1, optimizer=optimizer, cg_iters=3, cg_tol=1e-10,
        compute_loss=True)
    gU = _t(U).clone()
    loss = CK.cfr_user_step(gU, _t(I), _t(FF), stage_batch(sb, "cpu"),
                            alpha=8.0, l=1.5, reg_u=0.1, optimizer=optimizer,
                            **KW)
    _close(gU, wU)
    _close(loss.sum(), wl)

    item_rows = [2, 11, 20, ni]
    sb_u = _segment(rng, item_rows, [8, 8, 2, 8, 1, 0, 0],
                    [0, 0, 0, 1, 2, 4, 4], nu)
    sb_c = _segment(rng, item_rows, [8, 4, 0, 6, 0, 0],
                    [0, 0, 1, 2, 4, 4], ni)
    FF = (U.T @ U).astype(np.float32)
    wI, wIb, wl = JC._cfr_item_segment_body(
        _j(I), _j(U), _j(C), _j(Ib), _j(Cb), _j(FF), JSegmentBatch(*sb_u),
        JSegmentBatch(*sb_c), alpha=8.0, l=1.5, reg_i=0.1,
        optimizer=optimizer, cg_iters=3, cg_tol=1e-10, compute_loss=True)
    gI, gIb = _t(I).clone(), _t(Ib).clone()
    loss = CK.cfr_item_step(gI, _t(U), _t(C), gIb, _t(Cb), _t(FF),
                            (stage_batch(sb_u, "cpu"),
                             stage_batch(sb_c, "cpu")),
                            alpha=8.0, l=1.5, reg_i=0.1, optimizer=optimizer,
                            **KW)
    _close(gI, wI)
    _close(gIb, wIb)
    _close(loss.sum(), wl)
    assert float(gIb[11]) == 0.0  # user entries, no SPPMI entries

    sb = _segment(rng, [1, 7, 25, ni], [8, 8, 8, 2, 5, 0],
                  [0, 0, 0, 1, 2, 4], ni)
    wC, wCb, wl = JC._cfr_context_segment_body(
        _j(C), _j(I), _j(Ib), _j(Cb), JSegmentBatch(*sb), reg_c=0.1,
        optimizer=optimizer, cg_iters=3, cg_tol=1e-10, compute_loss=True)
    gC, gCb = _t(C).clone(), _t(Cb).clone()
    loss = CK.cfr_context_step(gC, _t(I), _t(Ib), gCb,
                               stage_batch(sb, "cpu"), reg_c=0.1,
                               optimizer=optimizer, **KW)
    _close(gC, wC)
    _close(gCb, wCb)
    _close(loss.sum(), wl)


# K17's edge shapes on the padded item body: the widths 13 and 100, rows
# of 0, 1, 7, 8, 9, 63, 64 and 65 entries on each side, one hot row
EDGE_ITEMS = {
    "width13": dict(d=13),
    "width100": dict(d=100),
    "tile_edges": dict(lens_u=[0, 1, 7, 8, 9, 63, 64, 65, 2, 0],
                       lens_c=[65, 64, 63, 9, 8, 7, 1, 0, 0, 3]),
    "hot_row": dict(lens_u=[300, 2, 0, 5, 1, 0, 7, 0, 3, 0],
                    lens_c=[280, 0, 1, 4, 0, 9, 2, 0, 6, 0]),
}


@pytest.mark.parametrize("optimizer", ["llt", "manual_cg"])
@pytest.mark.parametrize("edge", list(EDGE_ITEMS))
def test_item_body_edge_shapes_match_jax(edge, optimizer):
    """``_cfr_item_body`` against K17 (plain), the solve and K18 on K17's
    edge shapes: rows, biases and loss within 1e-4."""
    case = EDGE_ITEMS[edge]
    rng, U, I, C, Ib, Cb = _state(6, d=case.get("d", 6), nu=350, ni=330)
    B = 10
    rows = _rows(rng, B, I.shape[0])
    if "lens_u" in case:
        lens_u = np.asarray(case["lens_u"], np.int32)
        lens_c = np.asarray(case["lens_c"], np.int32)
    else:
        lens_u = rng.integers(0, 12, B).astype(np.int32)
        lens_c = rng.integers(0, 9, B).astype(np.int32)
    lens_u[rows == I.shape[0]] = 0
    lens_c[rows == I.shape[0]] = 0
    _, cols_u, vals_u = _padded(rng, B, int(lens_u.max()) + 3, U.shape[0],
                                lens_u)
    _, cols_c, vals_c = _padded(rng, B, int(lens_c.max()) + 2, C.shape[0],
                                lens_c)
    FF = (U.T @ U).astype(np.float32)
    wI, wIb, wl = JC._cfr_item_body(
        _j(I), _j(U), _j(C), _j(Ib), _j(Cb), _j(FF), _j(rows), _j(lens_u),
        _j(cols_u), _j(vals_u), _j(lens_c), _j(cols_c), _j(vals_c),
        alpha=8.0, l=1.5, reg_i=0.1, optimizer=optimizer, cg_iters=3,
        cg_tol=1e-10, compute_loss=True)
    gI, gIb = _t(I).clone(), _t(Ib).clone()
    entry = (PaddedBatch(*map(_t, (rows, lens_u, cols_u, vals_u))),
             _t(lens_c), _t(cols_c), _t(vals_c))
    loss = CK.cfr_item_step(gI, _t(U), _t(C), gIb, _t(Cb), _t(FF), entry,
                            alpha=8.0, l=1.5, reg_i=0.1, optimizer=optimizer,
                            **KW)
    _close(gI, wI)
    _close(gIb, wIb)
    _close(loss.sum(), wl)


# segment rows of one entry and of many chunks (C = 8) in each segment
# body: (chunk lengths, the SPPMI side's, each chunk's row; 4 = padding)
EDGE_SEGMENTS = {
    "one_entry_rows": ([1, 1, 1, 0], [1, 0, 1, 0], [0, 1, 2, 4]),
    "many_chunk_rows": ([8] * 9 + [3, 8, 8, 1], [8] * 10 + [8, 1, 5],
                        [0] * 10 + [1, 1, 1]),
}


@pytest.mark.parametrize("edge", list(EDGE_SEGMENTS))
def test_segment_bodies_edge_rows_match_jax(edge):
    """The user, item and context segment bodies on segment rows of one
    entry and of many chunks, against K17 (plain), the solve and K18."""
    lens, lens_c, segs = EDGE_SEGMENTS[edge]
    rng, U, I, C, Ib, Cb = _state(7)
    nu, ni = U.shape[0], I.shape[0]
    opt = dict(optimizer="llt", cg_iters=3, cg_tol=1e-10, compute_loss=True)
    sb = _segment(rng, [4, 9, 13, nu], lens, segs, ni)
    FF = (I.T @ I).astype(np.float32)
    wU, wl = JC._cfr_user_segment_body(
        _j(U), _j(I), _j(FF), JSegmentBatch(*sb), alpha=8.0, l=1.5,
        reg_u=0.1, **opt)
    gU = _t(U).clone()
    loss = CK.cfr_user_step(gU, _t(I), _t(FF), stage_batch(sb, "cpu"),
                            alpha=8.0, l=1.5, reg_u=0.1, optimizer="llt",
                            **KW)
    _close(gU, wU)
    _close(loss.sum(), wl)

    item_rows = [2, 11, 20, ni]
    sb_u = _segment(rng, item_rows, lens, segs, nu)
    sb_c = _segment(rng, item_rows, lens_c, segs, ni)
    FF = (U.T @ U).astype(np.float32)
    wI, wIb, wl = JC._cfr_item_segment_body(
        _j(I), _j(U), _j(C), _j(Ib), _j(Cb), _j(FF), JSegmentBatch(*sb_u),
        JSegmentBatch(*sb_c), alpha=8.0, l=1.5, reg_i=0.1, **opt)
    gI, gIb = _t(I).clone(), _t(Ib).clone()
    loss = CK.cfr_item_step(gI, _t(U), _t(C), gIb, _t(Cb), _t(FF),
                            (stage_batch(sb_u, "cpu"),
                             stage_batch(sb_c, "cpu")),
                            alpha=8.0, l=1.5, reg_i=0.1, optimizer="llt",
                            **KW)
    _close(gI, wI)
    _close(gIb, wIb)
    _close(loss.sum(), wl)

    sb = _segment(rng, [1, 7, 25, ni], lens, segs, ni)
    wC, wCb, wl = JC._cfr_context_segment_body(
        _j(C), _j(I), _j(Ib), _j(Cb), JSegmentBatch(*sb), reg_c=0.1, **opt)
    gC, gCb = _t(C).clone(), _t(Cb).clone()
    loss = CK.cfr_context_step(gC, _t(I), _t(Ib), gCb,
                               stage_batch(sb, "cpu"), reg_c=0.1,
                               optimizer="llt", **KW)
    _close(gC, wC)
    _close(gCb, wCb)
    _close(loss.sum(), wl)


@pytest.mark.parametrize("phase", ["user", "item", "context"])
def test_row_moved_between_batches_matches_jax(phase):
    """A row in the middle of one JAX batch and alone (its block trimmed to
    its own length) or first in a permuted batch of the port: the same
    updated row (and bias) within 1e-4, whichever batch carries it."""
    rng, U, I, C, Ib, Cb = _state(8)
    B, k = 12, 5
    X = {"user": U, "item": I, "context": C}[phase]
    rows = rng.permutation(X.shape[0])[:B].astype(np.int32)
    lens, cols, vals = _padded(rng, B, 10, (I if phase == "user" else
                                            U if phase == "item" else
                                            I).shape[0])
    lens[k] = 9
    lens_c, cols_c, vals_c = _padded(rng, B, 7, C.shape[0])
    lens_c[k] = 6
    if phase == "user":
        FF = (I.T @ I).astype(np.float32)
        wX, _ = JC._cfr_user_body(
            _j(U), _j(I), _j(FF), _j(rows), _j(lens), _j(cols), _j(vals),
            alpha=8.0, l=1.5, reg_u=0.1, optimizer="llt", cg_iters=3,
            cg_tol=1e-10, compute_loss=True)
        wb = None
    elif phase == "item":
        FF = (U.T @ U).astype(np.float32)
        wX, wb, _ = JC._cfr_item_body(
            _j(I), _j(U), _j(C), _j(Ib), _j(Cb), _j(FF), _j(rows), _j(lens),
            _j(cols), _j(vals), _j(lens_c), _j(cols_c), _j(vals_c),
            alpha=8.0, l=1.5, reg_i=0.1, optimizer="llt", cg_iters=3,
            cg_tol=1e-10, compute_loss=True)
    else:
        wX, wb, _ = JC._cfr_context_body(
            _j(C), _j(I), _j(Ib), _j(Cb), _j(rows), _j(lens), _j(cols),
            _j(vals), reg_c=0.1, optimizer="llt", cg_iters=3, cg_tol=1e-10,
            compute_loss=True)
    perm = np.concatenate([[k], np.delete(np.arange(B), k)[::-1]])
    for idx in ([k], perm):
        w_u = int(lens[idx].max())
        w_c = int(lens_c[idx].max())
        pick = (lambda a, w: _t(a[idx][:, :w]) if a.ndim == 2  # noqa: E731
                else _t(a[idx]))
        batch = PaddedBatch(_t(rows[idx]), pick(lens, 0), pick(cols, w_u),
                            pick(vals, w_u))
        gX = _t(X).clone()
        if phase == "user":
            CK.cfr_user_step(gX, _t(I), _t(FF), batch, alpha=8.0, l=1.5,
                             reg_u=0.1, optimizer="llt", **KW)
            gb = None
        elif phase == "item":
            gb = _t(Ib).clone()
            CK.cfr_item_step(gX, _t(U), _t(C), gb, _t(Cb), _t(FF),
                             (batch, pick(lens_c, 0), pick(cols_c, w_c),
                              pick(vals_c, w_c)),
                             alpha=8.0, l=1.5, reg_i=0.1, optimizer="llt",
                             **KW)
        else:
            gb = _t(Cb).clone()
            CK.cfr_context_step(gX, _t(I), _t(Ib), gb, batch, reg_c=0.1,
                                optimizer="llt", **KW)
        r = rows[k]
        np.testing.assert_allclose(gX[r].numpy(), np.asarray(wX)[r], **TOL)
        if wb is not None:
            np.testing.assert_allclose(float(gb[r]), float(np.asarray(wb)[r]),
                                       **TOL)


def test_item_bias_resets_without_sppmi():
    """``tests/models/test_w2v_cfr.py:334`` on the port: an updated item
    with user entries but no SPPMI entries gets Ib = 0, not its stale
    bias; an item outside the batch keeps its bias."""
    d, n_items, n_users = 4, 3, 5
    rng = np.random.default_rng(0)
    I = torch.tensor(rng.normal(size=(n_items, d)), dtype=torch.float32)
    U = torch.tensor(rng.normal(size=(n_users, d)), dtype=torch.float32)
    C = torch.tensor(rng.normal(size=(n_items, d)), dtype=torch.float32)
    Ib = torch.full((n_items,), 7.0)
    Cb = torch.zeros(n_items)
    FF = U.T @ U
    entry = (PaddedBatch(torch.tensor([0, 1], dtype=torch.int32),
                         torch.tensor([2, 2], dtype=torch.int32),
                         torch.tensor([[0, 1], [2, 3]], dtype=torch.int32),
                         torch.ones(2, 2)),
             torch.tensor([0, 2], dtype=torch.int32),
             torch.tensor([[0, 0], [1, 2]], dtype=torch.int32),
             torch.tensor([[0.0, 0.0], [1.0, 1.0]]))
    CK.cfr_item_step(I, U, C, Ib, Cb, FF, entry, alpha=8.0, l=1.0,
                     reg_i=0.01, optimizer="llt", cg_iters=3, cg_tol=1e-10,
                     compute_loss=False)
    assert float(Ib[0]) == 0.0
    assert float(Ib[1]) != 7.0
    assert float(Ib[2]) == 7.0


# ------------------------------------------------ K18's launch shape
P = CK.BIAS_PIECE


@pytest.mark.parametrize("segment", [False, True])
@pytest.mark.parametrize("width,piece", [(8, P), (P - 1, P), (P, P),
                                         (P + 1, P), (8192, P), (8192, 1024),
                                         (40, 8), (7, 1)])
def test_bias_launch_covers_each_entry_once(width, piece, segment):
    """``bias_launch`` against brute force: rows (or chunks) of 0, 1,
    piece, piece + 1 and ``width`` entries, each entry in exactly one
    piece of its own row's, every piece inside the grid, no piece past
    the last one a row of ``width`` entries needs, and the second launch
    wherever a row can span pieces (every segment side)."""
    p = piece
    lens = sorted({0, 1, min(p, width), min(p + 1, width), width})
    ppr, pieces, spans = CK.bias_launch(len(lens), width, segment, piece)
    assert ppr >= 1 and pieces == len(lens) * ppr
    assert ppr * p >= width and (ppr - 1) * p < max(width, 1)
    assert spans == (segment or width > p)
    seen = set()
    for c, n in enumerate(lens):
        for e in range(n):
            j = e // p
            assert j < ppr
            seen.add((c, e))
            assert c * ppr + j < pieces
        # the second launch adds max(1, ceil(n / piece)) pieces of the row
        assert max(1, -(-n // p)) <= ppr
    assert len(seen) == sum(lens)


def _bias_by_pieces(X, rows, total, side, cbias, piece):
    """K18's sum order on the CPU in float64: each piece of at most
    ``piece`` entries of a padded row or segment chunk summed on its own,
    a row's pieces added in piece order (chunks in order), then divided in
    float32 as the kernel does.  Returns {row: bias}."""
    X64 = X.double()
    F64 = side.table.double()
    lens = side.lens.tolist()
    if side.chunk_ptr is None:
        spans = [[b] for b in range(rows.shape[0])]
        chunk_lens = lens
    else:
        ptr = side.chunk_ptr.tolist()
        spans = [list(range(ptr[b], ptr[b + 1])) for b in range(len(ptr) - 1)]
        chunk_lens = side.chunk_lens.tolist()
    out = {}
    for b, row in enumerate(rows.tolist()):
        if total[b] <= 0 or row >= X.shape[0]:
            continue
        parts = []
        for ch in spans[b]:
            n = chunk_lens[ch]
            for j in range(max(1, -(-n // piece))):
                s = 0.0
                for e in range(j * piece, min(n, (j + 1) * piece)):
                    col = int(side.cols[ch, e])
                    dot = float(X64[row] @ F64[col])
                    s += float(side.vals[ch, e]) - dot - float(cbias[col])
                parts.append(s)
        out[row] = np.float32(sum(parts)) / (np.float32(lens[b])
                                            + np.float32(1e-10))
    return out


@pytest.mark.parametrize("piece", [1, 4, 256])
@pytest.mark.parametrize("kind", ["padded", "segment"])
def test_bias_piece_order_sum_matches_plain(kind, piece):
    """The float64 piece-order sum (``_bias_by_pieces``) on the item body's
    fixtures, with sentinel rows and rows whose ``total`` is 0, held to
    ``cfr_bias_plain`` within 1e-5 of the largest bias: the sum order the
    kernel takes computes the plain version's bias."""
    rng, U, I, C, Ib, Cb = _state(8, d=6, nu=60, ni=50)
    ni = I.shape[0]
    if kind == "padded":
        B = 12
        rows = _rows(rng, B, ni)
        lens_c = rng.integers(0, 11, B).astype(np.int32)
        lens_c[[0, 3]] = [0, 10]
        lens_c[rows == ni] = 0
        lens_c, cols_c, vals_c = _padded(rng, B, 10, ni, lens_c)
        side = CK.Side(_t(C), *map(_t, (lens_c, cols_c, vals_c)))
        total = lens_c.copy()
        total[[0, 5]] = [3, 0]       # user entries only; no entries at all
    else:
        sb = stage_batch(_segment(rng, [2, 11, 20, 33, ni],
                                  [8, 8, 3, 0, 5, 1, 0, 0],
                                  [0, 0, 0, 1, 3, 3, 5, 5], ni), "cpu")
        side = CK.Side.of(_t(C), sb)
        rows = sb.rows.numpy()
        total = sb.lens.numpy().copy()
        total[[1, 2]] = [4, 0]       # no SPPMI entries; nothing on either side
    rows_t, total_t = _t(rows), _t(total.astype(np.int32))
    X = _t(I)
    want = _t(Ib).clone()
    CK.cfr_bias_plain(X, rows_t, total_t, explicit=side, bias=want,
                      cbias=_t(Cb))
    got = _bias_by_pieces(X, rows_t, total_t, side, _t(Cb), piece)
    assert got, "no row written"
    scale = float(want.abs().max())
    for row, bias in got.items():
        assert abs(float(bias) - float(want[row])) <= 1e-5 * scale, row
    untouched = [r for r in range(ni) if r not in got]
    assert torch.equal(want[untouched], _t(Ib)[untouched])

