"""The port's eALS kernels (plain versions of K13 and K14) against
``buffalo_tpu.ops.eals_kernels`` on the CPU, on the same seeded numpy
inputs.  Tolerance 1e-5 relative (1e-6 absolute near 0): the same float32
coordinate-descent arithmetic with sums in another order.  A sweep in
Jacobi order (every dimension from the old row) is shown to miss it, so
the comparison holds the dimensions' order.  K13's Gram form (each row's
normal equations, then one Gauss-Seidel sweep on them) is written here in
torch and held to the JAX package's dimension loop within 1e-5 of the
largest row entry.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import buffalo_tpu.ops.eals_kernels as JE
from buffalo_tpu.data.batching import RangeBatch as JRangeBatch
from buffalo_tpu.data.batching import SegmentBatch as JSegmentBatch
from buffalo_tpu_torch.data.batching import RangeBatch, SegmentBatch, stage_batch
from buffalo_tpu_torch.ops import eals_kernels as E

RTOL, ATOL = 1e-5, 1e-6
ALPHA, REG = 8.0, 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions' many small ops run fastest on one thread, and
    then do not contend with other test processes' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tables(seed, nx=40, ny=30, d=6):
    rng = np.random.default_rng(seed)
    X = (0.3 * rng.standard_normal((nx, d))).astype(np.float32)
    Y = (0.3 * rng.standard_normal((ny, d))).astype(np.float32)
    C = rng.uniform(0.05, 0.6, max(nx, ny)).astype(np.float32)
    A = rng.standard_normal((ny, d)).astype(np.float32)
    S = (A.T @ A / ny).astype(np.float32)
    return rng, X, Y, C, S


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("item_axis", [False, True])
def test_range_sweep_matches_jax(item_axis):
    rng, X, Y, C, S = _tables(1)
    B, L, rs = 7, 12, 9
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    cols = rng.integers(0, Y.shape[0], (B, L)).astype(np.int32)
    vals = (rng.integers(1, 5, (B, L)) * (np.arange(L) < lens[:, None])
            ).astype(np.float32)
    batch = JRangeBatch(row_start=np.int32(rs), lens=lens, cols=cols,
                        vals=vals)
    C_other, c_self = (None, C[:X.shape[0]]) if item_axis else (C[:30], None)
    want = np.asarray(JE._eals_apply_batch(
        jnp.asarray(X), jnp.asarray(Y),
        None if C_other is None else jnp.asarray(C_other),
        None if c_self is None else jnp.asarray(c_self), jnp.asarray(S),
        batch, item_axis=item_axis, alpha=ALPHA, reg=REG))
    Cp = torch.from_numpy(c_self if item_axis else C_other)
    got = torch.from_numpy(X.copy())
    E.dim_sweep(got, torch.from_numpy(Y), torch.from_numpy(S), Cp,
                item_axis=item_axis, alpha=ALPHA, reg=REG,
                batch=stage_batch(RangeBatch(np.int32(rs), lens, cols, vals),
                                  "cpu"))
    _close(got.numpy(), want)
    assert np.abs(want[rs:rs + B] - X[rs:rs + B]).max() > 1e-3
    jac = torch.from_numpy(X.copy())
    E.range_sweep_plain(jac, torch.from_numpy(Y), torch.from_numpy(S), Cp,
                        rs, torch.from_numpy(lens), torch.from_numpy(cols),
                        torch.from_numpy(vals), item_axis=item_axis,
                        alpha=ALPHA, reg=REG, jacobi=True)
    assert not np.allclose(jac.numpy(), want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("item_axis", [False, True])
def test_segment_sweep_matches_jax(item_axis):
    """Two head rows in chunks of 8 and a padding row past the table
    (dropped)."""
    rng, X, Y, C, S = _tables(2)
    n = X.shape[0]
    rows = np.array([5, 17, n], np.int32)
    lens = np.array([19, 8, 0], np.int32)
    seg_ids = np.array([0, 0, 0, 1, 3], np.int32)
    chunk_lens = np.array([8, 8, 3, 8, 0], np.int32)
    cols = rng.integers(0, Y.shape[0], (5, 8)).astype(np.int32)
    vals = (rng.integers(1, 5, (5, 8))
            * (np.arange(8) < chunk_lens[:, None])).astype(np.float32)
    jb = JSegmentBatch(rows=rows, lens=lens, seg_ids=seg_ids,
                       chunk_lens=chunk_lens, cols=cols, vals=vals)
    C_other, c_self = (None, C[:n]) if item_axis else (C[:30], None)
    want = np.asarray(JE._eals_apply_batch(
        jnp.asarray(X), jnp.asarray(Y),
        None if C_other is None else jnp.asarray(C_other),
        None if c_self is None else jnp.asarray(c_self), jnp.asarray(S), jb,
        item_axis=item_axis, alpha=ALPHA, reg=REG))
    got = torch.from_numpy(X.copy())
    E.dim_sweep(got, torch.from_numpy(Y), torch.from_numpy(S),
                torch.from_numpy(c_self if item_axis else C_other),
                item_axis=item_axis, alpha=ALPHA, reg=REG,
                batch=stage_batch(SegmentBatch(rows, lens, seg_ids, chunk_lens,
                                               cols, vals), "cpu"))
    _close(got.numpy(), want)
    assert np.abs(want[[5, 17]] - X[[5, 17]]).max() > 1e-3


@pytest.mark.parametrize("item_axis", [False, True])
def test_rows_sweep_matches_half_epoch(item_axis):
    """The rows mode (``range_layout=False``) against ``eals_half_epoch``,
    residuals carried: a row with no entries included."""
    rng, X, Y, C, S = _tables(3)
    n, ny = X.shape[0], Y.shape[0]
    deg = rng.integers(0, 9, n)
    deg[4] = 0
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    keys = np.concatenate([np.sort(rng.choice(ny, k, replace=False))
                           for k in deg]).astype(np.int32)
    vals = rng.integers(1, 5, len(keys)).astype(np.float32)
    row_ids = np.repeat(np.arange(n, dtype=np.int32), deg)
    vhat = (0.01 * rng.standard_normal(len(keys))).astype(np.float32)
    Cw = C[:n] if item_axis else C[:ny]
    c_nnz = Cw[row_ids] if item_axis else Cw[keys]
    c_row = Cw if item_axis else np.ones(n, np.float32)
    Xj, vj = JE.eals_half_epoch(
        jnp.asarray(X), jnp.asarray(Y), jnp.asarray(vhat),
        jnp.asarray(row_ids), jnp.asarray(keys), jnp.asarray(vals),
        jnp.asarray(c_nnz), jnp.asarray(c_row), jnp.asarray(S),
        num_rows=n, alpha=ALPHA, reg=REG)
    got, v = torch.from_numpy(X.copy()), torch.from_numpy(vhat.copy())
    E.eals_half_epoch(got, torch.from_numpy(Y), v, torch.from_numpy(indptr),
                      torch.from_numpy(keys), torch.from_numpy(vals),
                      torch.from_numpy(Cw), torch.from_numpy(S),
                      item_axis=item_axis, alpha=ALPHA, reg=REG)
    _close(got.numpy(), np.asarray(Xj))
    _close(v.numpy(), np.asarray(vj))


def _gram_form_sweep(p, F, vals, cvals, c_row, mask, S, seg=None, *,
                     jacobi=False):
    """K13's Gram form in torch: each row's A = F^T diag(w - C_e) F +
    c_row S^T + reg I and b = F^T (w v) (entry rows summed per row through
    ``seg``), then one forward Gauss-Seidel sweep, x = (L_A + D_A)^-1 (b -
    U_A x), by ``torch.linalg.solve_triangular``; or with ``jacobi`` the
    Jacobi step x = D_A^-1 (b - (L_A + U_A) x)."""
    R, d = p.shape
    w = (1.0 + ALPHA * vals) * mask
    G = torch.einsum("eld,el,elk->edk", F, w - cvals * mask, F)
    b = torch.einsum("eld,el->ed", F, w * vals)
    if seg is not None:
        G = torch.zeros(R + 1, d, d).index_add_(0, seg, G)[:R]
        b = torch.zeros(R + 1, d).index_add_(0, seg, b)[:R]
    A = G + c_row[:, None, None] * S.T[None] + REG * torch.eye(d)
    if jacobi:
        diag = torch.diagonal(A, dim1=1, dim2=2)
        off = A - torch.diag_embed(diag)
        return (b - (off @ p[..., None])[..., 0]) / diag
    rhs = b - (torch.triu(A, 1) @ p[..., None])[..., 0]
    return torch.linalg.solve_triangular(torch.tril(A), rhs[..., None],
                                         upper=False)[..., 0]


@pytest.mark.parametrize("d", [13, 40, 128])
@pytest.mark.parametrize("item_axis", [False, True])
@pytest.mark.parametrize("mode", ["range", "segment"])
def test_gram_form_is_the_dimension_sweep(d, item_axis, mode):
    """One Gauss-Seidel sweep on each row's normal equations (K13's Gram
    form on the card) is the JAX package's dimension loop
    (``_eals_dim_sweep`` / ``_eals_segment_sweep``): within 1e-5 of the
    largest row entry, where a Jacobi sweep of the same system is not.
    Range rows of length 0 to L; segment rows of one to three chunks of
    width 16, a padding chunk last."""
    rng = np.random.default_rng(100 + d + 2 * item_axis)
    ny = 3 * d
    Y = (0.3 * rng.standard_normal((ny, d))).astype(np.float32)
    A0 = rng.standard_normal((ny, d)).astype(np.float32)
    S = (A0.T @ A0 / ny).astype(np.float32)
    Cy = rng.uniform(0.05, 0.6, ny).astype(np.float32)
    if mode == "range":
        R, L = 12, 24
        lens = rng.integers(0, L + 1, R).astype(np.int32)
        lens[[2, 7]] = 0
        seg, seg_np = None, None
        Ew = L
    else:
        R, Ew = 3, 16
        chunk_lens = np.array([16, 16, 5, 16, 16, 9, 0], np.int32)
        seg_np = np.array([0, 0, 0, 1, 2, 2, R], np.int32)
        seg = torch.from_numpy(seg_np).long()
        lens = chunk_lens
    E = len(lens)
    mask = (np.arange(Ew)[None, :] < lens[:, None]).astype(np.float32)
    cols = rng.integers(0, ny, (E, Ew)).astype(np.int32)
    vals = (rng.integers(1, 5, (E, Ew)) * mask).astype(np.float32)
    p = (0.3 * rng.standard_normal((R, d))).astype(np.float32)
    if item_axis:
        c_row = rng.uniform(0.05, 0.6, R).astype(np.float32)
        cvals = (c_row[:, None] if seg_np is None
                 else c_row[np.minimum(seg_np, R - 1)][:, None]) \
            * np.ones((E, Ew), np.float32)
    else:
        c_row = np.ones(R, np.float32)
        cvals = Cy[cols]
    if mode == "range":
        want = np.asarray(JE._eals_dim_sweep(
            jnp.asarray(p), jnp.asarray(Y[cols]), jnp.asarray(vals),
            jnp.asarray(cvals), jnp.asarray(c_row), jnp.asarray(lens),
            jnp.asarray(S), alpha=ALPHA, reg=REG))
    else:
        jb = JSegmentBatch(rows=np.arange(R, dtype=np.int32),
                           lens=np.array([37, 16, 25], np.int32),
                           seg_ids=seg_np, chunk_lens=chunk_lens, cols=cols,
                           vals=vals)
        want = np.asarray(JE._eals_segment_sweep(
            jnp.asarray(p), jnp.asarray(Y), jb, jnp.asarray(cvals),
            jnp.asarray(c_row), jnp.asarray(S), alpha=ALPHA, reg=REG))
    t = [torch.from_numpy(a) for a in (p, Y[cols], vals, cvals, c_row, mask,
                                       S)]
    got = _gram_form_sweep(*t, seg=seg).numpy()
    jac = _gram_form_sweep(*t, seg=seg, jacobi=True).numpy()
    scale = float(np.abs(want).max())
    assert np.abs(want - p).max() > 1e-3 * scale
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert np.abs(jac - want).max() > 1e-5 * scale


@pytest.mark.parametrize("d", [13, 40])
def test_residual_and_loss_match_jax(d):
    rng, P, Q, C, _ = _tables(4, d=d)
    nnz = 120
    rows = rng.integers(0, P.shape[0], nnz).astype(np.int32)
    keys = rng.integers(0, Q.shape[0], nnz).astype(np.int32)
    vals = rng.integers(1, 5, nnz).astype(np.float32)
    Ci = C[:Q.shape[0]]
    vj = np.asarray(JE.compute_vhat(jnp.asarray(P), jnp.asarray(Q),
                                    jnp.asarray(rows), jnp.asarray(keys)))
    t = [torch.from_numpy(a) for a in (P, Q, rows, keys, vals, Ci)]
    vp = E.compute_vhat(*t[:4])
    _close(vp.numpy(), vj)
    rj, lj = JE.eals_loss(jnp.asarray(P), jnp.asarray(Q), jnp.asarray(vj),
                          jnp.asarray(rows), jnp.asarray(keys),
                          jnp.asarray(vals), jnp.asarray(Ci), 0.1, 0.2,
                          alpha=ALPHA)
    for vhat in (vp, None):  # given, or computed in the same pass
        rp, lp = E.eals_loss(*t[:2], vhat, *t[2:], 0.1, 0.2, alpha=ALPHA)
        np.testing.assert_allclose(float(rp), float(rj), rtol=RTOL)
        np.testing.assert_allclose(float(lp), float(lj), rtol=RTOL)
    _, sums = E.eals_residual(*t, alpha=ALPHA)
    assert sums.shape == (3,) and float(sums[2]) > 0


def test_gramian_matches_jax():
    _, _, Q, C, _ = _tables(5)
    Ci = C[:Q.shape[0]]
    for args in ((Q, Ci), (Q,)):
        want = np.asarray(JE.eals_gramian(*map(jnp.asarray, args)))
        got = E.eals_gramian(*map(torch.from_numpy, args))
        _close(got.numpy(), want)
