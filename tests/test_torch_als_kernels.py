"""The port's ALS batch paths against the reference's, on the CPU.

On CPU tensors each kernel wrapper runs its plain PyTorch version, so
K1 (matrix-free CG), K2 + K3 (dense normal equations + batched CG, for
long range rows and for segment rows), K4 (iALS++), the scatter batches
(PaddedBatch rows with padding ids, SegmentBatch) and the whole
range-layout epoch are held here to ``buffalo_tpu.ops.als_kernels`` on
the same numpy inputs, and the bfloat16 values the port stages to the
reference's bit for bit.  Tolerance rtol 1e-4 / atol 1e-5: float32,
different summation orders, three CG steps on well-conditioned systems.
The kernels themselves are held to these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buffalo_tpu.data import batching as ref_batching
from buffalo_tpu.ops import als_kernels as ref
from buffalo_tpu_torch.data import batching as port_batching
from buffalo_tpu_torch.ops import als_kernels as port

TOL = dict(rtol=1e-4, atol=1e-5)
D = 8


def _tables(n, m, seed):
    rng = np.random.default_rng(seed)
    table = (rng.normal(size=(n, D)) * 0.3).astype(np.float32)
    Bf = (rng.normal(size=(m, D)) * 0.3).astype(np.float32)
    return table, Bf, (Bf.T @ Bf).astype(np.float32)


def _padded(B, L, m, seed, max_len=None):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, max_len or L, size=B).astype(np.int32)
    lens[[1, -1]] = 0  # padding rows keep p
    cols = rng.integers(0, m, size=(B, L)).astype(np.int32)
    vals = (1.0 + rng.random((B, L))).astype(np.float32)
    mask = np.arange(L)[None, :] < lens[:, None]
    return lens, np.where(mask, cols, 0), np.where(mask, vals, 0.0)


def _kw(adaptive_reg, item_axis):
    return dict(alpha=4.0, reg=0.05, adaptive_reg=adaptive_reg,
                item_axis=item_axis, num_fixed_rows=123, compute_loss=True)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


FLAGS = pytest.mark.parametrize("adaptive_reg,item_axis",
                                [(False, False), (False, True),
                                 (True, False), (True, True)])


@FLAGS
@pytest.mark.parametrize("L", [24, 104])
def test_range_batch_matches_als_solve_batch(L, adaptive_reg, item_axis):
    """L <= 96: K1; L > 96: K2 + K3 — both against ``als_solve_batch``."""
    table, Bf, FF = _tables(50, 30, seed=L)
    B, rs = 16, 7
    lens, cols, vals = _padded(B, L, 30, seed=L + 1)
    kw = _kw(adaptive_reg, item_axis)
    x, nume, deno = ref.als_solve_batch(
        jnp.asarray(table[rs:rs + B]), jnp.asarray(Bf[cols]),
        jnp.asarray(FF), jnp.asarray(lens), jnp.asarray(vals),
        optimizer="manual_cg", cg_iters=3, cg_tol=1e-10, **kw)

    T, Bft, FFt, lt, ct, vt = _t(table, Bf, FF, lens, cols, vals)
    if L <= port.MATRIX_FREE_MAX_L:
        n_rows, d_rows = port.als_cg_matrix_free(
            T, Bft, FFt, rs, lt, ct, vt, cg_iters=3, cg_tol=1e-10, **kw)
    else:
        A, y, n_rows, d_rows = port.als_normal_equations(
            T, Bft, FFt, lt, ct, vt, row_start=rs, **kw)
        port.batched_cg_dense(A, y, T, lt, row_start=rs, cg_iters=3,
                              cg_tol=1e-10)
    np.testing.assert_allclose(T[rs:rs + B].numpy(), np.asarray(x), **TOL)
    untouched = np.r_[0:rs, rs + B:len(table)]
    assert np.array_equal(T.numpy()[untouched], table[untouched])
    np.testing.assert_allclose(float(n_rows.sum()), float(nume), rtol=1e-5)
    np.testing.assert_allclose(float(d_rows.sum()), float(deno), rtol=1e-5)


@FLAGS
def test_segment_batch_matches_als_solve_segment_batch(adaptive_reg,
                                                        item_axis):
    table, Bf, FF = _tables(20, 40, seed=11)
    rng = np.random.default_rng(12)
    degs = rng.integers(0, 30, size=20)
    degs[[3, 9, 14]] = [70, 33, 101]
    indptr = np.zeros(21, dtype=np.int64)
    np.cumsum(degs, out=indptr[1:])
    key = rng.integers(0, 40, int(indptr[-1])).astype(np.int32)
    val = (1.0 + rng.random(int(indptr[-1]))).astype(np.float32)
    sb = port_batching.build_segment_batch(indptr, key, val, [14, 3, 9],
                                           16, 20)
    # the range layout's remap: padding rows point far past the table
    rows = np.where(sb.lens > 0, sb.rows, 1 << 30).astype(np.int32)
    kw = _kw(adaptive_reg, item_axis)

    p = table[np.minimum(rows, len(table) - 1)]
    x, nume, deno = ref.als_solve_segment_batch(
        jnp.asarray(p), jnp.asarray(Bf), jnp.asarray(FF),
        jnp.asarray(sb.lens), jnp.asarray(sb.seg_ids),
        jnp.asarray(sb.chunk_lens), jnp.asarray(sb.cols),
        jnp.asarray(sb.vals), optimizer="manual_cg", cg_iters=3,
        cg_tol=1e-10, **kw)
    expected = table.copy()
    real = sb.lens > 0
    expected[rows[real]] = np.asarray(x)[real]

    staged = port_batching.stage_batch(sb._replace(rows=rows), "cpu")
    T, Bft, FFt = _t(table, Bf, FF)
    A, y, n_rows, d_rows = port.als_normal_equations(
        T, Bft, FFt, staged.lens, staged.cols, staged.vals,
        rows=staged.rows, chunk_ptr=staged.chunk_ptr,
        chunk_lens=staged.chunk_lens, **kw)
    port.batched_cg_dense(A, y, T, staged.lens, rows=staged.rows,
                          cg_iters=3, cg_tol=1e-10)
    np.testing.assert_allclose(T.numpy(), expected, **TOL)
    np.testing.assert_allclose(float(n_rows.sum()), float(nume), rtol=1e-5)
    np.testing.assert_allclose(float(d_rows.sum()), float(deno), rtol=1e-5)


def _epoch_fixture():
    """test_als_epoch.py:151-205's data: a CSR with degree-0 rows and one
    long row (the remapped segment path), both orientations."""
    num_users, num_items = 70, 40
    rng = np.random.default_rng(11)
    degs = rng.integers(0, 40, size=num_users)
    degs[-1] = 60
    indptr = np.zeros(num_users + 1, dtype=np.int64)
    np.cumsum(degs, out=indptr[1:])
    key = rng.integers(0, num_items, int(indptr[-1])).astype(np.int32)
    val = (1.0 + rng.random(int(indptr[-1]))).astype(np.float32)
    rows = np.repeat(np.arange(num_users, dtype=np.int32), degs)
    order = np.argsort(key, kind="stable")
    cindptr = np.zeros(num_items + 1, dtype=np.int64)
    np.cumsum(np.bincount(key, minlength=num_items), out=cindptr[1:])
    P0 = (rng.normal(size=(num_users, D)) * 0.1).astype(np.float32)
    Q0 = (rng.normal(size=(num_items, D)) * 0.1).astype(np.float32)
    return (indptr, key, val), (cindptr, rows[order], val[order]), P0, Q0


@pytest.mark.parametrize("optimizer", ["manual_cg", "llt"])
@pytest.mark.parametrize("stacked", [False, True])
def test_range_epoch_matches_reference(optimizer, stacked):
    (indptr, key, val), (cindptr, ckey, cval), P0, Q0 = _epoch_fixture()
    kw = dict(optimizer=optimizer, alpha=4.0, reg_u=0.05, reg_i=0.05,
              adaptive_reg=False, cg_iters=3, cg_tol=1e-10, block_size=8,
              compute_loss=True, num_p_rows=len(P0), num_q_rows=len(Q0))
    plan = dict(entries_per_batch=256, max_len=32)

    rp = ref_batching.BatchPlanner(indptr, **plan)
    cp = ref_batching.BatchPlanner(cindptr, **plan)
    row_b, col_b, u_pos, i_pos, u_pad, i_pad = \
        ref_batching.build_range_layout(rp, cp, key, val, ckey, cval)
    assert any(isinstance(b, ref_batching.SegmentBatch) for b in row_b)
    Pp = ref_batching.permute_table(P0, u_pos, u_pad)
    Qp = ref_batching.permute_table(Q0, i_pos, i_pad)
    P1, Q1, n1, d1 = ref.als_epoch(jnp.asarray(Pp), jnp.asarray(Qp),
                                   tuple(row_b), tuple(col_b), **kw)

    tp = port_batching.BatchPlanner(indptr, **plan)
    tc = port_batching.BatchPlanner(cindptr, **plan)
    t_row, t_col = port_batching.build_range_layout(
        tp, tc, key, val, ckey, cval)[:2]

    def staged(batches):
        ranges = [b for b in batches
                  if isinstance(b, port_batching.RangeBatch)]
        segs = [b for b in batches
                if isinstance(b, port_batching.SegmentBatch)]
        if stacked:  # the stacked groups the reference scans over
            ranges = port_batching.stack_batches(ranges)
        return [port_batching.stage_batch(b, "cpu") for b in ranges + segs]

    P2, Q2, n2, d2 = port.als_epoch(*_t(Pp, Qp), staged(t_row),
                                    staged(t_col), **kw)
    np.testing.assert_allclose(P2.numpy()[u_pos], np.asarray(P1)[u_pos],
                               **TOL)
    np.testing.assert_allclose(Q2.numpy()[i_pos], np.asarray(Q1)[i_pos],
                               **TOL)
    np.testing.assert_allclose(float(n2), float(n1), rtol=1e-4)
    np.testing.assert_allclose(float(d2), float(d1), rtol=1e-5)
    assert all(k.launches == 0 for k in port.KERNELS), \
        "CPU tensors must never launch a kernel"


def test_gramian_matches_reference():
    X = np.random.default_rng(0).normal(size=(1037, 12)).astype(np.float32)
    np.testing.assert_allclose(port.gramian(torch.from_numpy(X)).numpy(),
                               np.asarray(ref.gramian(jnp.asarray(X))),
                               rtol=1e-5, atol=1e-4)


def _warm_residuals(table, Bf, FF, lens, cols, vals, rs, kw):
    """float64 squared residual of each row's system after the reference's
    warm start (the quantity its freeze rule compares with cg_tol)."""
    B, L = cols.shape
    mask = np.arange(L)[None, :] < lens[:, None]
    w = np.where(mask, vals * kw["alpha"], 0.0)
    F = Bf[cols].astype(np.float64) * mask[:, :, None]
    ada = lens if kw["adaptive_reg"] else np.ones(B)
    A = (FF[None] + np.einsum("bld,bl,ble->bde", F, w, F)
         + (kw["reg"] * ada)[:, None, None] * np.eye(FF.shape[0])[None])
    y = np.einsum("bld,bl->bd", F, 1.0 + w)
    p = table[rs:rs + B].astype(np.float64)
    r = y - np.einsum("bde,be->bd", A, p)
    return np.minimum((y * y).sum(-1), (r * r).sum(-1))[lens > 0]


# the widths and lengths the card tests give K1: d = 13 and 33 are padded
# on the card, 64 its widest width with F in registers; L = 1 (all rows of
# one entry), 8 and 96 (one and three entry slots per lane); "freeze" sets
# cg_tol between the 30th and 70th percentile of the warm-start
# residuals, so some rows stop before any step and some mid-loop
@pytest.mark.parametrize("d", [13, 33, 64])
@pytest.mark.parametrize("L", [1, 8, 96])
@pytest.mark.parametrize("tol", ["tight", "freeze"])
def test_matrix_free_widths_match_als_solve_batch(d, L, tol):
    rng = np.random.default_rng(d * 1000 + L)
    n, m, B, rs = 60, 40, 24, 9
    table = (rng.normal(size=(n, d)) * 0.3).astype(np.float32)
    Bf = (rng.normal(size=(m, d)) * 0.3).astype(np.float32)
    FF = (Bf.T @ Bf).astype(np.float32)
    lens = rng.integers(1, L + 1, size=B).astype(np.int32)
    lens[[2, 5]] = [0, 1]
    mask = np.arange(L)[None, :] < lens[:, None]
    cols = np.where(mask, rng.integers(0, m, size=(B, L)), 0).astype(np.int32)
    vals = np.where(mask, 1.0 + rng.random((B, L)), 0.0).astype(np.float32)
    kw = _kw(adaptive_reg=d == 33, item_axis=L != 8)
    cg_tol = 1e-10
    if tol == "freeze":
        res = _warm_residuals(table, Bf, FF, lens, cols, vals, rs, kw)
        cg_tol = float(np.sqrt(np.quantile(res, 0.3) * np.quantile(res, 0.7)))
        assert (res < cg_tol).any() and (res >= cg_tol).any()
    x, nume, deno = ref.als_solve_batch(
        jnp.asarray(table[rs:rs + B]), jnp.asarray(Bf[cols]),
        jnp.asarray(FF), jnp.asarray(lens), jnp.asarray(vals),
        optimizer="manual_cg", cg_iters=3, cg_tol=cg_tol, **kw)
    T, Bft, FFt, lt, ct, vt = _t(table, Bf, FF, lens, cols, vals)
    n_rows, d_rows = port.als_cg_matrix_free_plain(
        T, Bft, FFt, rs, lt, ct, vt, cg_iters=3, cg_tol=cg_tol, **kw)
    np.testing.assert_allclose(T[rs:rs + B].numpy(), np.asarray(x), **TOL)
    untouched = np.r_[0:rs, rs + B:n]
    assert np.array_equal(T.numpy()[untouched], table[untouched])
    np.testing.assert_allclose(float(n_rows.sum()), float(nume), rtol=1e-5)
    np.testing.assert_allclose(float(d_rows.sum()), float(deno), rtol=1e-5)


# d / block: one block, two blocks, and a 4-wide tail block (8, 8, 4); L
# 24 is matrix-free length, 104 past it (iALS++ takes both); the loss
# flags on and off, and one case without the loss terms
@pytest.mark.parametrize("d,block_size", [(16, 16), (16, 8), (20, 8)])
@pytest.mark.parametrize("L", [24, 104])
@pytest.mark.parametrize("adaptive_reg,item_axis,compute_loss",
                         [(False, False, True), (False, True, True),
                          (True, False, True), (True, True, True),
                          (True, True, False)])
def test_ialspp_matches_ialspp_solve_batch(d, block_size, L, adaptive_reg,
                                           item_axis, compute_loss):
    rng = np.random.default_rng(d * 100 + L)
    n, m, B, rs = 50, 30, 16, 7
    table = (rng.normal(size=(n, d)) * 0.3).astype(np.float32)
    Bf = (rng.normal(size=(m, d)) * 0.3).astype(np.float32)
    FF = (Bf.T @ Bf).astype(np.float32)
    lens, cols, vals = _padded(B, L, m, seed=L + d)
    kw = dict(_kw(adaptive_reg, item_axis), compute_loss=compute_loss)
    x, nume, deno = ref.ialspp_solve_batch(
        jnp.asarray(table[rs:rs + B]), jnp.asarray(Bf[cols]),
        jnp.asarray(FF), jnp.asarray(lens), jnp.asarray(vals),
        block_size=block_size, cg_tol=1e-10, **kw)
    T, Bft, FFt, lt, ct, vt = _t(table.copy(), Bf, FF, lens, cols, vals)
    n_rows, d_rows = port.ialspp_solve_batch(
        T, Bft, FFt, lt, ct, vt, row_start=rs, block_size=block_size,
        cg_tol=1e-10, **kw)
    np.testing.assert_allclose(T[rs:rs + B].numpy(), np.asarray(x), **TOL)
    untouched = np.r_[0:rs, rs + B:n]
    assert np.array_equal(T.numpy()[untouched], table[untouched])
    np.testing.assert_allclose(float(n_rows.sum()), float(nume), rtol=1e-5)
    np.testing.assert_allclose(float(d_rows.sum()), float(deno), rtol=1e-5)


def _gram_form(p, F, FF, w, lens, *, reg, block_size, steps, cg_tol,
               adaptive_reg, item_axis, num_fixed_rows):
    """K4's Gram form in torch, in the dtype of its inputs.  One pass over
    each row's entries gives G = F^T diag(w) F, Yui = F p0 with the loss
    terms, and e = F^T ((Yui - 1) w); with A = FF + reg I + G and q = FF p0,
    each block is b = q[blk] + reg p[blk] + e[blk] + A[blk, :] (p - p0)
    (the cache's F (p - p0) folded in through G: in exact arithmetic
    G[blk, :] p - F[:, blk]^T w) and ``steps`` dense CG steps on A[blk,
    blk].  Returns (rows, nume, deno)."""
    from buffalo_tpu_torch.ops.solve import cg_loop

    B, d = p.shape
    mask = (torch.arange(F.shape[1])[None, :] < lens[:, None]).to(p.dtype)
    real = (lens > 0).to(p.dtype)
    G = torch.einsum("bl,bld,ble->bde", w, F, F)
    Yui = torch.einsum("bld,bd->bl", F, p)
    e = torch.einsum("bl,bld->bd", (Yui - 1) * w, F)
    A = FF + reg * torch.eye(d, dtype=p.dtype) + G
    q = p @ FF
    ada = lens.to(p.dtype) if adaptive_reg else torch.ones_like(real)
    nume = real * ada * reg * (p * p).sum(-1)
    deno = torch.zeros_like(nume)
    if item_axis:
        pos = mask * (-Yui * Yui + (Yui - 1) ** 2 * (1 + w))
        nume = nume + real * ((p * q).sum(-1) + pos.sum(-1))
        deno = real * (num_fixed_rows + w.sum(-1))
    p0, p = p, p.clone()
    for beg in range(0, d, block_size):
        end = min(beg + block_size, d)
        b = (q[:, beg:end] + reg * p[:, beg:end] + e[:, beg:end]
             + torch.einsum("bjk,bk->bj", A[:, beg:end], p - p0))
        Ab = A[:, beg:end, beg:end]
        x = cg_loop(lambda v: torch.einsum("bjk,bk->bj", Ab, v),
                    torch.zeros_like(b), b, steps, cg_tol)
        p[:, beg:end] -= x * real[:, None]
    return p, nume.sum(), deno.sum()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# d / block: the iALS++ path's d = 160 in one block and in blocks of 32,
# and d = 40 likewise; rows of 0 entries, short ones and ones past the old
# kernel's 348-entry tile, over columns of the ML-20M synthetic's
# popularity (rank^-0.9, bench.py synth_ml20m)
@pytest.mark.parametrize("d", [40, 160])
@pytest.mark.parametrize("blocks", ["one", "of_32"])
@pytest.mark.parametrize("item_axis", [False, True])
def test_gram_form_is_ialspp_solve_batch(d, blocks, item_axis):
    """K4's Gram form (csrc/ialspp_solve.cu) against the JAX package's
    ``ialspp_solve_batch``: the same loss terms (1e-4), and factors no
    further from a float64 run of the block CG than twice the plain
    float32 runs (the larger distance of the JAX package's and the port's
    plain version, two summation orders); the Gram form with one CG step
    fewer is not."""
    block_size = d if blocks == "one" else 32
    rng = np.random.default_rng(d + (block_size == 32) + 2 * item_axis)
    B, L, m = 24, 420, 700
    lens = np.r_[0, 1, 0, rng.integers(2, 64, 9),
                 rng.integers(349, L + 1, 12)].astype(np.int32)
    pop = 1.0 / np.arange(1, m + 1) ** 0.9
    cols = rng.choice(m, size=(B, L), p=pop / pop.sum()).astype(np.int32)
    vals = (1.0 + rng.integers(0, 5, size=(B, L))).astype(np.float32)
    mask = np.arange(L)[None, :] < lens[:, None]
    cols, vals = np.where(mask, cols, 0), np.where(mask, vals, 0.0)
    p = np.abs(rng.normal(size=(B, d)) * 0.1).astype(np.float32)
    Bf = np.abs(rng.normal(size=(m, d)) * 0.1).astype(np.float32)
    FF = (Bf.T @ Bf).astype(np.float32)
    kw = dict(alpha=8.0, reg=0.1, adaptive_reg=item_axis,
              item_axis=item_axis, num_fixed_rows=m, compute_loss=True)
    x_jax, nume, deno = ref.ialspp_solve_batch(
        jnp.asarray(p), jnp.asarray(Bf[cols]), jnp.asarray(FF),
        jnp.asarray(lens), jnp.asarray(vals), block_size=block_size,
        cg_tol=1e-10, **kw)
    plain = {}
    for dt in (torch.float32, torch.float64):
        plain[dt] = torch.from_numpy(p).to(dt, copy=True)
        port.ialspp_solve_batch_plain(
            plain[dt], torch.from_numpy(Bf).to(dt),
            torch.from_numpy(FF).to(dt), torch.from_numpy(lens),
            torch.from_numpy(cols), torch.from_numpy(vals).to(dt),
            block_size=block_size, cg_tol=1e-10, **kw)
    x64 = plain[torch.float64]
    F = torch.from_numpy(Bf[cols])
    w = torch.from_numpy(vals) * kw["alpha"]
    gram = dict(reg=kw["reg"], block_size=block_size, cg_tol=1e-10,
                adaptive_reg=kw["adaptive_reg"], item_axis=item_axis,
                num_fixed_rows=m)
    args = (torch.from_numpy(p), F, torch.from_numpy(FF), w,
            torch.from_numpy(lens))
    x32, n32, d32 = _gram_form(*args, steps=3, **gram)
    x_short, _, _ = _gram_form(*args, steps=2, **gram)
    np.testing.assert_allclose(float(n32), float(nume), rtol=1e-4)
    np.testing.assert_allclose(float(d32), float(deno), rtol=1e-5)
    floor = max(_rel(np.asarray(x_jax), x64),
                _rel(plain[torch.float32], x64))
    assert 0 < floor < 1e-3
    assert _rel(x32, x64) <= 2 * floor
    assert _rel(x_short, x64) > 2 * floor
    real = lens > 0
    assert np.array_equal(x32.numpy()[~real], p[~real])


def _scatter_half():
    """One half's scatter batches, host numpy from both packages'
    planners: PaddedBatches of L <= 96 and > 96 whose last batch per
    bucket carries padding rows (id ``num_rows``, len 0), and a
    SegmentBatch of the rows past ``max_len``; with the tables."""
    n, m = 60, 40
    rng = np.random.default_rng(21)
    degs = rng.integers(0, 120, size=n)
    degs[[5, 17]] = [300, 190]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(degs, out=indptr[1:])
    key = rng.integers(0, m, int(indptr[-1])).astype(np.int32)
    val = (1.0 + rng.random(int(indptr[-1]))).astype(np.float32)
    plan = dict(entries_per_batch=1024, max_len=128)
    batches = list(ref_batching.BatchPlanner(indptr, **plan)
                   .iter_batches(key, val))
    again = list(port_batching.BatchPlanner(indptr, **plan)
                 .iter_batches(key, val))
    table = (rng.normal(size=(n, D)) * 0.1).astype(np.float32)
    Bf = (rng.normal(size=(m, D)) * 0.1).astype(np.float32)
    return batches, again, table, Bf


@pytest.mark.parametrize("optimizer", ["manual_cg", "ialspp", "llt"])
@pytest.mark.parametrize("item_axis", [False, True])
def test_scatter_batches_match_apply_batch(optimizer, item_axis):
    """The scatter layout's batches one after another through the
    reference's ``_apply_batch`` and the port's, table and loss terms."""
    batches, again, table, Bf = _scatter_half()
    kinds = {type(b).__name__ for b in again}
    assert kinds == {"PaddedBatch", "SegmentBatch"}
    assert any(b.cols.shape[1] > port.MATRIX_FREE_MAX_L for b in again)
    assert any((b.rows == len(table)).any() for b in again)
    FF = (Bf.T @ Bf).astype(np.float32)
    kw = dict(optimizer=optimizer, alpha=4.0, reg=0.05, adaptive_reg=False,
              cg_iters=3, cg_tol=1e-10, block_size=3, item_axis=item_axis,
              num_fixed_rows=40, compute_loss=True)
    A_ref, nume, deno = jnp.asarray(table), 0.0, 0.0
    T, Bft, FFt = _t(table.copy(), Bf, FF)
    n_port, d_port = 0.0, 0.0
    for b_ref, b_port in zip(batches, again):
        A_ref, n, dn = ref._apply_batch(
            A_ref, jnp.asarray(Bf), jnp.asarray(FF),
            type(b_ref)(*map(jnp.asarray, b_ref)), **kw)
        nume, deno = nume + float(n), deno + float(dn)
        n, dn = port._apply_batch(T, Bft, FFt,
                                  port_batching.stage_batch(b_port, "cpu"),
                                  **kw)
        n_port, d_port = n_port + float(n.sum()), d_port + float(dn.sum())
        np.testing.assert_allclose(T.numpy(), np.asarray(A_ref), **TOL)
    assert not np.array_equal(T.numpy(), table)
    np.testing.assert_allclose(n_port, nume, rtol=1e-4)
    np.testing.assert_allclose(d_port, deno, rtol=1e-5)


def test_bf16_staged_values_match_reference_bits():
    """The port stages float32 values as bfloat16 (round to nearest
    even); the reference writes them with ``ml_dtypes``: equal bits."""
    (indptr, key, val), (cindptr, ckey, cval), _, _ = _epoch_fixture()
    val = val * np.float32(1.0 + 2.0 ** -9)  # most values need rounding
    cval = cval * np.float32(1.0 + 2.0 ** -9)
    plan = dict(entries_per_batch=256, max_len=32)
    bf16 = np.dtype(jnp.bfloat16)
    r_row = ref_batching.build_range_layout(
        ref_batching.BatchPlanner(indptr, **plan),
        ref_batching.BatchPlanner(cindptr, **plan), key, val, ckey, cval,
        vals_dtype=bf16)[0]
    t_row = port_batching.build_range_layout(
        port_batching.BatchPlanner(indptr, **plan),
        port_batching.BatchPlanner(cindptr, **plan), key, val, ckey, cval)[0]
    assert len(r_row) == len(t_row)
    exact = 0
    for a, b in zip(r_row, t_row):
        s = port_batching.stage_batch(b, "cpu", vals_dtype=torch.bfloat16)
        assert s.vals.dtype == torch.bfloat16 and a.vals.dtype == bf16
        got = s.vals.view(torch.int16).numpy()
        assert np.array_equal(got, np.asarray(a.vals).view(np.int16))
        exact += int((s.vals.float().numpy() == b.vals).sum())
    assert exact < sum(int(np.prod(b.vals.shape)) for b in t_row) // 2
