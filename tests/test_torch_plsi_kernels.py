"""The port's pLSI kernels (plain versions of K15 and K16) against
``buffalo_tpu.ops.plsi_kernels`` on the CPU, on the same seeded numpy
inputs.  Tolerance rtol 1e-5 (atol 1e-7 near 0): the same float32 E-step
and M-step with sums in another order; the losses are the per-row losses'
sum.  The range layout's summed floor and the padded path's element floor
are each held to their own JAX function, on Dirichlet(0.02) tables where
many latent products fall below the floor, and shown to differ there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import buffalo_tpu.ops.plsi_kernels as JP
from buffalo_tpu.data.batching import RangeBatch as JRangeBatch
from buffalo_tpu.data.batching import SegmentBatch as JSegmentBatch
from buffalo_tpu_torch.data.batching import (PaddedBatch, RangeBatch,
                                             SegmentBatch, stage_batch)
from buffalo_tpu_torch.ops import plsi_kernels as P

RTOL, ATOL = 1e-5, 1e-7


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=ATOL * max(1.0, float(np.abs(
                                   np.asarray(want)).max())))


def _tables(seed, nx=60, ny=45, d=6, sparse=False):
    rng = np.random.default_rng(seed)
    if sparse:
        X = rng.dirichlet(np.full(d, 0.02), nx)
        Y = rng.dirichlet(np.full(ny, 0.02), d).T
    else:
        X, Y = np.abs(rng.normal(size=(nx, d))), np.abs(rng.normal(size=(ny, d)))
    X = np.ascontiguousarray(X / X.sum(1, keepdims=True), np.float32)
    Y = np.ascontiguousarray(Y / Y.sum(0, keepdims=True), np.float32)
    return rng, X, Y


def _padded(rng, B, L, ny):
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    cols = rng.integers(0, ny, (B, L)).astype(np.int32)
    vals = (rng.integers(1, 5, (B, L))
            * (np.arange(L)[None, :] < lens[:, None])).astype(np.float32)
    return lens, cols, vals


def _segment(rng, ny, n, C=16):
    rows = np.array([3, 40, n, n], np.int32)
    lens = np.array([40, 9, 0, 0], np.int32)
    seg_ids = np.array([0, 0, 0, 1, 4, 4, 4, 4], np.int32)
    chunk_lens = np.array([16, 16, 8, 9, 0, 0, 0, 0], np.int32)
    cols = rng.integers(0, ny, (8, C)).astype(np.int32)
    vals = (rng.integers(1, 5, (8, C))
            * (np.arange(C) < chunk_lens[:, None])).astype(np.float32)
    return rows, lens, seg_ids, chunk_lens, cols, vals


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("sparse", [False, True])
def test_estep_block_matches_jax(sparse):
    rng, X, Y = _tables(1, sparse=sparse)
    lens, cols, vals = _padded(rng, 9, 12, Y.shape[0])
    a, f = X[:9], Y[cols]
    mask = (np.arange(12)[None, :] < lens[:, None]).astype(np.float32)
    sums, loss = JP._estep_block(jnp.asarray(a), jnp.asarray(f),
                                 jnp.asarray(vals), jnp.asarray(mask),
                                 with_loss=True)
    got, got_loss = P._summed_floor(_t(a), _t(f), _t(vals), _t(mask))
    _close(got, sums)
    _close(got_loss.sum(), loss)


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("with_loss", [False, True])
def test_range_accumulate_matches_jax(sparse, with_loss):
    rng, X, Y = _tables(2, sparse=sparse)
    B, L, rs = 11, 20, 7
    lens, cols, vals = _padded(rng, B, L, Y.shape[0])
    An = rng.random(X.shape).astype(np.float32)
    batch = JRangeBatch(row_start=np.int32(rs), lens=lens, cols=cols,
                        vals=vals)
    want, want_loss = JP._range_accumulate(
        jnp.asarray(An), jnp.asarray(X), jnp.asarray(Y), batch,
        with_loss=with_loss)
    got = _t(An).clone()
    loss = P.plsi_estep(got, _t(X), _t(Y),
                        stage_batch(RangeBatch(np.int32(rs), lens, cols,
                                               vals), "cpu"),
                        with_loss=with_loss)
    _close(got, want)
    if with_loss:
        _close(loss.sum(), want_loss)
    else:
        assert loss is None


@pytest.mark.parametrize("sparse", [False, True])
def test_segment_accumulate_matches_jax(sparse):
    rng, X, Y = _tables(3, sparse=sparse)
    sb = _segment(rng, Y.shape[0], X.shape[0])
    An = rng.random(X.shape).astype(np.float32)
    want, want_loss = JP._segment_accumulate(
        jnp.asarray(An), jnp.asarray(X), jnp.asarray(Y), JSegmentBatch(*sb),
        with_loss=True)
    got = _t(An).clone()
    loss = P.plsi_estep(got, _t(X), _t(Y),
                        stage_batch(SegmentBatch(*sb), "cpu"))
    _close(got, want)
    _close(loss.sum(), want_loss)
    assert loss.shape == (4,) and float(loss[2]) == 0.0


@pytest.mark.parametrize("sparse", [False, True])
def test_padded_accumulate_matches_jax(sparse):
    """``plsi_accumulate`` :23 (rows past the table are padding) and the
    element floor's difference from the summed one."""
    rng, X, Y = _tables(4, sparse=sparse)
    B, L = 13, 10
    lens, cols, vals = _padded(rng, B, L, Y.shape[0])
    rows = rng.permutation(X.shape[0])[:B].astype(np.int32)
    rows[[2, 5]] = X.shape[0]
    Pn = rng.random(X.shape).astype(np.float32)
    Qn = rng.random(Y.shape).astype(np.float32)
    wP, wQ, wl = JP.plsi_accumulate(
        jnp.asarray(Pn), jnp.asarray(Qn), jnp.asarray(X), jnp.asarray(Y),
        jnp.asarray(rows), jnp.asarray(lens), jnp.asarray(cols),
        jnp.asarray(vals))
    gP, gQ = _t(Pn).clone(), _t(Qn).clone()
    loss = P.plsi_accumulate(gP, gQ, _t(X), _t(Y),
                             PaddedBatch(*map(_t, (rows, lens, cols, vals))))
    _close(gP, wP)
    _close(gQ, wQ)
    _close(loss.sum(), wl)
    if sparse:
        # the summed floor on the same rows is another function
        other = torch.zeros_like(gP)
        keep = rows < X.shape[0]
        for b in np.nonzero(keep)[0]:
            P.estep_range_plain(other, _t(X), _t(Y), int(rows[b]),
                                _t(lens[b:b + 1]), _t(cols[b:b + 1]),
                                _t(vals[b:b + 1]))
        ref = torch.zeros_like(gP)
        P.estep_padded_plain(ref, torch.zeros_like(gQ), _t(X), _t(Y),
                             PaddedBatch(*map(_t, (rows, lens, cols, vals))))
        rel = float((other - ref).abs().max() / ref.abs().max())
        assert rel > 1e-3


def test_padded_segment_accumulate_matches_jax():
    rng, X, Y = _tables(5, sparse=True)
    sb = _segment(rng, Y.shape[0], X.shape[0])
    Pn = rng.random(X.shape).astype(np.float32)
    Qn = rng.random(Y.shape).astype(np.float32)
    j = JSegmentBatch(*sb)
    wP, wQ, wl = JP.plsi_accumulate_segments(
        jnp.asarray(Pn), jnp.asarray(Qn), jnp.asarray(X), jnp.asarray(Y),
        j.rows, j.seg_ids, j.chunk_lens, j.cols, j.vals)
    gP, gQ = _t(Pn).clone(), _t(Qn).clone()
    loss = P.plsi_accumulate(gP, gQ, _t(X), _t(Y),
                             stage_batch(SegmentBatch(*sb), "cpu"))
    _close(gP, wP)
    _close(gQ, wQ)
    _close(loss.sum(), wl)


# rows around a warp's 32 lanes: the team form's groups of 1-32 lanes take
# rows of these lengths whole or across steps
EDGE_LENS = (0, 1, 31, 32, 33)


def _edge_rows(rng, ny, L):
    lens = np.array(EDGE_LENS, np.int32)
    cols = rng.integers(0, ny, (len(lens), L)).astype(np.int32)
    vals = (rng.integers(1, 5, (len(lens), L))
            * (np.arange(L)[None, :] < lens[:, None])).astype(np.float32)
    return lens, cols, vals


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("d", [13, 20])
def test_range_accumulate_on_rows_around_a_warp_matches_jax(d, sparse):
    """``_range_accumulate`` :143 on rows of 0, 1, 31, 32 and 33 entries."""
    rng, X, Y = _tables(30 + d, nx=50, d=d, sparse=sparse)
    rs = 9
    lens, cols, vals = _edge_rows(rng, Y.shape[0], 33)
    An = rng.random(X.shape).astype(np.float32)
    want, want_loss = JP._range_accumulate(
        jnp.asarray(An), jnp.asarray(X), jnp.asarray(Y),
        JRangeBatch(row_start=np.int32(rs), lens=lens, cols=cols, vals=vals),
        with_loss=True)
    got = _t(An).clone()
    loss = P.plsi_estep(got, _t(X), _t(Y), stage_batch(
        RangeBatch(np.int32(rs), lens, cols, vals), "cpu"))
    _close(got, want)
    _close(loss.sum(), want_loss)
    assert float(loss[0]) == 0.0


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("d", [13, 20])
def test_segment_accumulate_on_rows_around_a_warp_matches_jax(d, sparse):
    """``_segment_accumulate`` :162 on rows of 0, 1, 31, 32 and 33 entries
    in chunks of 16 (a row of none, of one short chunk, of two full and one
    of one entry)."""
    rng, X, Y = _tables(40 + d, nx=50, d=d, sparse=sparse)
    C = 16
    rows = np.array([3, 10, 20, 30, X.shape[0]], np.int32)
    lens = np.array(EDGE_LENS, np.int32)
    seg_ids, chunk_lens = [], []
    for r, n in enumerate(lens):
        for lo in range(0, n, C):
            seg_ids.append(r)
            chunk_lens.append(min(C, n - lo))
    seg_ids, chunk_lens = (np.array(a, np.int32) for a in (seg_ids,
                                                          chunk_lens))
    cols = rng.integers(0, Y.shape[0], (len(seg_ids), C)).astype(np.int32)
    vals = (rng.integers(1, 5, (len(seg_ids), C))
            * (np.arange(C) < chunk_lens[:, None])).astype(np.float32)
    sb = (rows, lens, seg_ids, chunk_lens, cols, vals)
    An = rng.random(X.shape).astype(np.float32)
    want, want_loss = JP._segment_accumulate(
        jnp.asarray(An), jnp.asarray(X), jnp.asarray(Y), JSegmentBatch(*sb),
        with_loss=True)
    got = _t(An).clone()
    loss = P.plsi_estep(got, _t(X), _t(Y),
                        stage_batch(SegmentBatch(*sb), "cpu"))
    _close(got, want)
    _close(loss.sum(), want_loss)
    assert loss.shape == (5,) and float(loss[0]) == 0.0


@pytest.mark.parametrize("segment", [False, True])
def test_estep_shape_against_brute_force(segment):
    """K15's launch shape at every width to 300 and batch widths around a
    warp, ENTRIES_MIN_L and PIECE_MIN_L, in range and segment batches: one
    lane holding the whole row (the fewest of ENTRY_FLOATS that hold it) on
    wide batches; else the smallest power-of-two team that covers the row
    with TEAM_FLOATS floats a lane (none past TEAM_MAX_D, SEGMENT_TEAM_MAX_D
    for segment batches) and the smallest power-of-two group from the team
    up that holds a row of the batch, every group a warp's divisor (a whole
    warp for segment batches and rows cut into pieces); pieces of ROW_PIECE
    entries past PIECE_MIN_L (not in segment batches, which are cut into
    chunks)."""
    pows = (1, 2, 4, 8, 16, 32)
    for d in range(1, 301):
        for L in list(range(1, 41)) + [64, 96, 255, 256, 304, 512, 513,
                                       8192]:
            team, group, floats, piece = P.estep_shape(d, L, segment)
            assert 32 % group == 0 and team <= group
            if d > (P.SEGMENT_TEAM_MAX_D if segment else P.TEAM_MAX_D):
                assert (team, group, piece) == (0, 32, 0)
                continue
            assert team * floats >= d
            long_rows = L > P.PIECE_MIN_L and not segment
            assert piece == (P.ROW_PIECE if long_rows else 0)
            if piece:
                assert group == 32
            if L >= P.ENTRIES_MIN_L and d <= 32:
                assert (team, group) == (1, 32)
                assert floats == min(f for f in (8, 16, 24, 32) if f >= d)
                continue
            assert floats == P.TEAM_FLOATS
            assert team == min(t for t in pows if t * floats >= d)
            want = 32 if segment or piece else min(
                g for g in pows if g >= team and (g >= L or g == 32))
            assert group == want


def test_estep_vec_takes_16_byte_loads_where_aligned():
    """16-byte loads where d and every table's address are multiples of
    four floats, else 4-byte loads."""
    base = torch.zeros(4096)
    for d in range(1, 13):
        for off in range(4):
            t = base[off:off + 4 * d]
            want = 4 if d % 4 == 0 and off == 0 else 1
            assert P.estep_vec(d, t) == want
            assert P.estep_vec(d, base, t) == want
    assert P.estep_vec(20, base[:20], base[4:24]) == 4
    assert P.estep_vec(20, base[:20], base[2:22]) == 1


@pytest.mark.parametrize("alphas", [(1.0, 1.0), (0.5, 2.0), (0.0, 0.0)])
def test_mstep_masked_matches_jax(alphas):
    rng = np.random.default_rng(6)
    Pn = rng.random((40, 7)).astype(np.float32)
    Qn = rng.random((32, 7)).astype(np.float32)
    p_mask = (rng.random(40) > 0.2).astype(np.float32)
    q_mask = (rng.random(32) > 0.2).astype(np.float32)
    Pn[~p_mask.astype(bool)] = 0
    Qn[~q_mask.astype(bool)] = 0
    Pn[3] = 0
    Qn[:, 2] = 0
    a1, a2 = alphas
    wP, wQ = JP.plsi_mstep(jnp.asarray(Pn), jnp.asarray(Qn),
                           jnp.asarray(p_mask), jnp.asarray(q_mask),
                           alpha1=a1, alpha2=a2, num_items=27)
    gP, gQ = _t(Pn).clone(), _t(Qn).clone()
    P.plsi_mstep(gP, gQ, alpha1=a1, alpha2=a2, num_items=27,
                 p_mask=_t(p_mask), q_mask=_t(q_mask))
    _close(gP, wP)
    _close(gQ, wQ)
    assert torch.isfinite(gP).all() and torch.isfinite(gQ).all()


def test_normalize_swap_matches_jax_and_guards_zero_sums():
    """``plsi_normalize_swap`` :313, and its zero-sum guard
    (``tests/models/test_eals_plsi.py:241``): alpha1 = alpha2 = 0 with an
    empty row and column stays finite and zero."""
    Pn = np.array([[0.2, 0.8], [0.0, 0.0]], np.float32)
    Qn = np.array([[0.5, 0.0], [0.5, 0.0]], np.float32)
    wP, wQ = JP.plsi_normalize_swap(jnp.asarray(Pn), jnp.asarray(Qn),
                                    alpha1=0.0, alpha2=0.0)
    gP, gQ = P.plsi_normalize_swap(_t(Pn).clone(), _t(Qn).clone(),
                                   alpha1=0.0, alpha2=0.0)
    np.testing.assert_array_equal(gP.numpy(), np.asarray(wP))
    np.testing.assert_array_equal(gQ.numpy(), np.asarray(wQ))
    assert torch.isfinite(gP).all() and torch.isfinite(gQ).all()
    np.testing.assert_allclose(gP[0].numpy(), [0.2, 0.8], rtol=1e-6)
    assert (gP[1] == 0).all() and (gQ[:, 1] == 0).all()
    rng = np.random.default_rng(7)
    Pn, Qn = rng.random((30, 5)).astype(np.float32), \
        rng.random((25, 5)).astype(np.float32)
    wP, wQ = JP.plsi_normalize_swap(jnp.asarray(Pn), jnp.asarray(Qn),
                                    alpha1=1.0, alpha2=1.0)
    gP, gQ = P.plsi_normalize_swap(_t(Pn).clone(), _t(Qn).clone(),
                                   alpha1=1.0, alpha2=1.0)
    _close(gP, wP)
    _close(gQ, wQ)


def test_epochs_match_jax():
    """One range-layout epoch (``plsi_epoch_range``, a segment batch in
    each orientation) and one fallback epoch (``plsi_epoch`` over padded
    and segment batches) from the same tables."""
    rng, X, Y = _tables(8, nx=60, ny=45, d=5)
    Xp = np.concatenate([X, np.zeros((4, 5), np.float32)])
    Yp = np.concatenate([Y, np.zeros((3, 5), np.float32)])
    row_b = [RangeBatch(np.int32(0), *_padded(rng, 8, 6, 45)),
             RangeBatch(np.int32(8), *_padded(rng, 16, 12, 45)),
             SegmentBatch(*_segment(rng, 45, 64))]
    col_b = [RangeBatch(np.int32(0), *_padded(rng, 24, 9, 60)),
             SegmentBatch(*_segment(rng, 60, 48))]
    p_mask = np.r_[np.ones(60), np.zeros(4)].astype(np.float32)
    q_mask = np.r_[np.ones(45), np.zeros(3)].astype(np.float32)
    conv = {RangeBatch: JRangeBatch, SegmentBatch: JSegmentBatch}
    jr = tuple(conv[type(b)](*b) for b in row_b)
    jc = tuple(conv[type(b)](*b) for b in col_b)
    wP, wQ, wl = JP.plsi_epoch_range(
        jnp.asarray(Xp), jnp.asarray(Yp), jr[:2], jc[:1], jr[2:], jc[1:],
        jnp.asarray(p_mask), jnp.asarray(q_mask), alpha1=1.0, alpha2=1.0,
        num_items=45)
    gP, gQ, gl = P.plsi_epoch_range(
        _t(Xp), _t(Yp), [stage_batch(b, "cpu") for b in row_b],
        [stage_batch(b, "cpu") for b in col_b], _t(p_mask), _t(q_mask),
        alpha1=1.0, alpha2=1.0, num_items=45)
    _close(gP, wP)
    _close(gQ, wQ)
    _close(gl, wl)
    from buffalo_tpu.data.batching import PaddedBatch as JPaddedBatch
    rows = rng.permutation(60)[:16].astype(np.int32)
    padded = PaddedBatch(rows, *_padded(rng, 16, 8, 45))
    seg = SegmentBatch(*_segment(rng, 45, 60))
    wP, wQ, wl = JP.plsi_epoch(jnp.asarray(X), jnp.asarray(Y),
                               (JPaddedBatch(*padded), JSegmentBatch(*seg)),
                               alpha1=1.0, alpha2=2.0)
    gP, gQ, gl = P.plsi_epoch(_t(X), _t(Y), [stage_batch(padded, "cpu"),
                                             stage_batch(seg, "cpu")],
                              alpha1=1.0, alpha2=2.0)
    _close(gP, wP)
    _close(gQ, wQ)
    _close(gl, wl)
