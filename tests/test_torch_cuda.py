"""The CUDA kernels against their plain PyTorch versions, on the card.

Each kernel of ``buffalo_tpu_torch.ops.als_kernels`` has no CPU mode, so
these tests need an NVIDIA card and ``nvcc`` and skip without one; run
them there with ``python -m pytest --noconftest tests/test_torch_cuda.py
-m cuda`` (the suite's conftest pins JAX, which a card-only machine need
not have).
The plain versions are held to the JAX reference on the CPU in
``test_torch_als_kernels.py``.  Tolerance: float32 in another summation
order, rtol 1e-4 / atol 1e-5 on the solved rows, 1e-4 relative on
the loss terms.
"""
import numpy as np
import pytest
import torch

from buffalo_tpu_torch.data import batching
from buffalo_tpu_torch.ops import als_kernels as K

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _case(dev, d, L, B=64, n=300, m=200, seed=0):
    """A RangeBatch of B rows of up to L entries over a table of n rows and
    a fixed side of m rows (rows 0 and B // 2 empty, row 1 of one entry).
    Past L = 1000 the fixed side shrinks as 1/L,
    so that y and A stay at the magnitudes the tolerances are set for:
    unscaled, 8192 entries over 200 fixed rows sum y into the thousands,
    where float32's spacing (2^-11 from 4096 up) exceeds atol, and entries
    near zero differ between any two summation orders."""
    rng = np.random.default_rng(seed)
    table = torch.tensor(rng.normal(size=(n, d)) * 0.3, dtype=torch.float32,
                         device=dev)
    Bf = torch.tensor(rng.normal(size=(m, d)) * 0.3 * min(1.0, 1000 / L),
                      dtype=torch.float32, device=dev)
    lens = rng.integers(1, L + 1, size=B).astype(np.int32)
    lens[[0, B // 2]] = 0
    lens[1] = 1
    cols = rng.integers(0, m, size=(B, L)).astype(np.int32)
    vals = (1.0 + rng.random((B, L))).astype(np.float32)
    mask = np.arange(L)[None, :] < lens[:, None]
    batch = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
             (lens, np.where(mask, cols, 0), np.where(mask, vals, 0.0))]
    return table, Bf, Bf.T @ Bf, batch


def _kw(item_axis, adaptive_reg=False):
    return dict(alpha=8.0, reg=0.1, adaptive_reg=adaptive_reg,
                item_axis=item_axis, num_fixed_rows=1000, compute_loss=True)


# d = 13 and 33 take the 4-byte gather and a padded width, 128 is the
# widest the kernels take (F read back from shared memory); L = 1 and 8 are
# one entry slot per lane, 33 two, 96 three; B = 61 is no multiple of the
# rows a block holds, and rows of 0 and 1 entries are in every batch
@pytest.mark.parametrize("d", [8, 13, 32, 33, 40, 64, 128])
@pytest.mark.parametrize("L", [1, 8, 33, 96])
@pytest.mark.parametrize("item_axis", [False, True])
def test_matrix_free_kernel_matches_plain(dev, d, L, item_axis):
    adaptive = d == 33 and L == 33
    table, Bf, FF, (lens, cols, vals) = _case(dev, d, L=L, B=61)
    expect = table.clone()
    n_ref, d_ref = K.als_cg_matrix_free_plain(
        expect, Bf, FF, 17, lens, cols, vals, cg_iters=3, cg_tol=1e-10,
        **_kw(item_axis, adaptive))
    before = K.als_cg_matrix_free.launches
    n_got, d_got = K.als_cg_matrix_free(
        table, Bf, FF, 17, lens, cols, vals, cg_iters=3, cg_tol=1e-10,
        **_kw(item_axis, adaptive))
    torch.cuda.synchronize()
    assert K.als_cg_matrix_free.launches == before + 1
    torch.testing.assert_close(table, expect, **TOL)
    torch.testing.assert_close(n_got, n_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(d_got, d_ref, rtol=1e-4, atol=1e-4)


def _warm_residuals(A, y, p):
    """Squared residual of each system after the reference's warm start,
    in float64: the rows a tolerance above it freezes before any step."""
    A, y, p = A.double(), y.double(), p.double()
    r = y - torch.einsum("bij,bj->bi", A, p)
    use_zero = (y * y).sum(-1) < (r * r).sum(-1)
    return torch.where(use_zero, (y * y).sum(-1), (r * r).sum(-1))


def _freezing_tol(A, y, p, lens):
    """A tolerance between the 30th and 70th percentile of the warm-start
    residuals of the real rows: some rows freeze at once, the others step
    and some of them freeze mid-loop."""
    rs = _warm_residuals(A, y, p)[lens > 0]
    lo, hi = torch.quantile(rs, 0.3), torch.quantile(rs, 0.7)
    tol = float((lo * hi).sqrt())
    assert bool((rs < tol).any()) and bool((rs >= tol).any())
    return tol


@pytest.mark.parametrize("kernel", ["matrix_free", "dense"])
def test_cg_kernels_freeze_like_plain(dev, kernel):
    """A tolerance that some rows meet after the warm start and others
    mid-loop: frozen warps leave, the rest keep stepping."""
    table, Bf, FF, (lens, cols, vals) = _case(dev, 40, L=96, B=61, seed=4)
    A, y, _, _ = K.als_normal_equations_plain(
        table, Bf, FF, lens, cols, vals, row_start=17, **_kw(True))
    tol = _freezing_tol(A, y, table[17:17 + 61], lens)
    expect = table.clone()
    if kernel == "matrix_free":
        args = (Bf, FF, 17, lens, cols, vals)
        kw = dict(cg_iters=3, cg_tol=tol, **_kw(True))
        K.als_cg_matrix_free_plain(expect, *args, **kw)
        K.als_cg_matrix_free(table, *args, **kw)
    else:
        kw = dict(row_start=17, cg_iters=3, cg_tol=tol)
        K.batched_cg_dense_plain(A, y, expect, lens, **kw)
        K.batched_cg_dense(A, y, table, lens, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(table, expect, **TOL)


# d = 13 and 65 are no multiple of 4 (scalar loads of A), 65, 128 and 160
# keep A in the warp's shared memory, 256 reads it from L2, the others keep
# it in registers; the scatter mode writes through a reversed row list
# holding padding ids past the table
@pytest.mark.parametrize("d", [8, 13, 40, 64, 65, 128, 160, 256, 300, 1000])
@pytest.mark.parametrize("mode", ["range", "scatter"])
def test_dense_cg_kernel_matches_plain(dev, d, mode):
    table, Bf, FF, (lens, cols, vals) = _case(dev, d, L=200, B=61, seed=d)
    A, y, _, _ = K.als_normal_equations_plain(
        table, Bf, FF, lens, cols, vals, row_start=5, **_kw(True))
    if mode == "range":
        where = dict(row_start=5)
    else:
        rows = torch.arange(65, 4, -1, dtype=torch.int32, device=dev)
        rows[::7] = 1 << 30
        rows[1::7] = table.shape[0]
        where = dict(rows=rows)
    expect = table.clone()
    K.batched_cg_dense_plain(A, y, expect, lens, cg_iters=3, cg_tol=1e-10,
                             **where)
    before = K.batched_cg_dense.launches
    K.batched_cg_dense(A, y, table, lens, cg_iters=3, cg_tol=1e-10, **where)
    torch.cuda.synchronize()
    assert K.batched_cg_dense.launches == before + 1
    torch.testing.assert_close(table, expect, **TOL)


@pytest.mark.parametrize("kernel", ["matrix_free", "dense"])
def test_cg_kernels_are_deterministic(dev, kernel):
    """Two launches on the same inputs give bitwise-equal results: every
    reduction is a warp shuffle tree in a fixed order, with no atomics."""
    table, Bf, FF, (lens, cols, vals) = _case(dev, 40, L=96, B=61)
    outs = [table.clone(), table.clone()]
    losses = []
    for out in outs:
        if kernel == "matrix_free":
            losses.append(K.als_cg_matrix_free(
                out, Bf, FF, 17, lens, cols, vals, cg_iters=3, cg_tol=1e-10,
                **_kw(True)))
        else:
            A, y, _, _ = K.als_normal_equations_plain(
                table, Bf, FF, lens, cols, vals, row_start=17, **_kw(True))
            K.batched_cg_dense(A, y, out, lens, row_start=17, cg_iters=3,
                               cg_tol=1e-10)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], table)
    for a, b in zip(*losses):
        assert torch.equal(a, b)


# d = 13 takes the 4-byte gather and feature padding, 128 is the widest
# with A over the ring, 160 and 256 pass over the entries 2 and 4 times and
# build A in the output; L = 97 and 104 end inside a stage of the gather
# ring, 1000 and 8192 wrap the ring many times and end in a partial stage
@pytest.mark.parametrize("d", [8, 13, 40, 64, 128, 160, 256, 300])
@pytest.mark.parametrize("L", [97, 104, 1000, 8192])
def test_normal_equations_and_cg_match_plain(dev, d, L):
    table, Bf, FF, (lens, cols, vals) = _case(dev, d, L=L, B=32)
    A_ref, y_ref, n_ref, d_ref = K.als_normal_equations_plain(
        table, Bf, FF, lens, cols, vals, row_start=5, **_kw(True))
    A, y, n_got, d_got = K.als_normal_equations(
        table, Bf, FF, lens, cols, vals, row_start=5, **_kw(True))
    torch.testing.assert_close(A, A_ref, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(n_got, n_ref, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(d_got, d_ref, rtol=1e-4, atol=1e-3)

    expect = table.clone()
    K.batched_cg_dense_plain(A_ref, y_ref, expect, lens, row_start=5,
                             cg_iters=3, cg_tol=1e-10)
    K.batched_cg_dense(A_ref, y_ref, table, lens, row_start=5, cg_iters=3,
                       cg_tol=1e-10)
    torch.cuda.synchronize()
    torch.testing.assert_close(table, expect, **TOL)


def _segment_case(dev, d, heads, n=50, m=400):
    """A SegmentBatch of the head rows 20 and 4 (degrees ``heads``) in
    8192-entry chunks, padding rows carrying the id ``1 << 30``."""
    rng = np.random.default_rng(3)
    degs = rng.integers(1, 5, size=n)
    degs[[4, 20]] = heads
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(degs, out=indptr[1:])
    key = rng.integers(0, m, int(indptr[-1])).astype(np.int32)
    val = (1.0 + rng.random(int(indptr[-1]))).astype(np.float32)
    sb = batching.build_segment_batch(indptr, key, val, [20, 4], 8192, n)
    sb = sb._replace(rows=np.where(sb.lens > 0, sb.rows, 1 << 30)
                     .astype(np.int32))
    s = batching.stage_batch(sb, dev)
    table = torch.tensor(rng.normal(size=(n, d)) * 0.3, dtype=torch.float32,
                         device=dev)
    Bf = torch.tensor(rng.normal(size=(m, d)) * 0.1, dtype=torch.float32,
                      device=dev)
    seg = dict(rows=s.rows, chunk_ptr=s.chunk_ptr, chunk_lens=s.chunk_lens)
    return table, Bf, Bf.T @ Bf, s, seg


# chunk lengths 8192 and 808 / 8192, 8192 and 616 end mid-stage; the d = 13
# case's 8192, 69 / 8192, 8192, 1 leave a short and a one-entry chunk; d =
# 160 is the iALS++ path's head rows
@pytest.mark.parametrize("d,heads", [(40, (9000, 17000)),
                                     (13, (8261, 16385)),
                                     (160, (9000, 17000))])
@pytest.mark.parametrize("item_axis,adaptive_reg", [(True, False),
                                                    (False, True)])
def test_segment_kernels_skip_padding_ids(dev, item_axis, adaptive_reg, d,
                                          heads):
    table, Bf, FF, s, seg = _segment_case(dev, d, heads)
    kw = _kw(item_axis, adaptive_reg)
    A_ref, y_ref, n_ref, d_ref = K.als_normal_equations_plain(
        table, Bf, FF, s.lens, s.cols, s.vals, **seg, **kw)
    A, y, n_got, d_got = K.als_normal_equations(
        table, Bf, FF, s.lens, s.cols, s.vals, **seg, **kw)
    torch.testing.assert_close(A, A_ref, rtol=1e-4, atol=1e-2)
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(n_got, n_ref, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(d_got, d_ref, rtol=1e-4, atol=1e-3)
    expect = table.clone()
    K.batched_cg_dense_plain(A_ref, y_ref, expect, s.lens, rows=s.rows,
                             cg_iters=3, cg_tol=1e-10)
    K.batched_cg_dense(A_ref, y_ref, table, s.lens, rows=s.rows, cg_iters=3,
                       cg_tol=1e-10)
    torch.cuda.synchronize()
    torch.testing.assert_close(table, expect, **TOL)


@pytest.mark.parametrize("mode", ["range", "segment"])
def test_normal_equations_kernel_is_deterministic(dev, mode):
    """Two launches on the same inputs give bitwise-equal results: every
    sum runs in a fixed order, with no atomics."""
    if mode == "range":
        table, Bf, FF, (lens, cols, vals) = _case(dev, 40, L=1000, B=32)
        args, kw = (table, Bf, FF, lens, cols, vals), dict(row_start=5)
    else:
        table, Bf, FF, s, kw = _segment_case(dev, 40, (9000, 17000))
        args = (table, Bf, FF, s.lens, s.cols, s.vals)
    first = K.als_normal_equations(*args, **kw, **_kw(True))
    second = K.als_normal_equations(*args, **kw, **_kw(True))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_wrappers_reject_what_kernels_do_not_take(dev):
    table, Bf, FF, (lens, cols, vals) = _case(dev, 8, L=24)
    with pytest.raises(TypeError):
        K.als_cg_matrix_free(table, Bf, FF, 0, lens.long(), cols, vals,
                             cg_iters=3, cg_tol=1e-10, **_kw(False))
    with pytest.raises(ValueError):
        K.als_cg_matrix_free(table, Bf, FF, 290, lens, cols, vals,
                             cg_iters=3, cg_tol=1e-10, **_kw(False))
    with pytest.raises(ValueError):
        K.als_cg_matrix_free(table, Bf.cpu(), FF, 0, lens, cols, vals,
                             cg_iters=3, cg_tol=1e-10, **_kw(False))
    # K1 holds rows of at most 128 floats by design (ALS sends wider rows
    # to iALS++); K2, K3 and K4 take any width
    wide = torch.zeros(300, 129, device=dev)
    with pytest.raises(ValueError, match="at most 128"):
        K.als_cg_matrix_free(wide, wide[:200].contiguous(),
                             torch.zeros(129, 129, device=dev), 0, lens,
                             cols, vals, cg_iters=3, cg_tol=1e-10,
                             **_kw(False))
    with pytest.raises(TypeError):  # values are float32 or bfloat16
        K.als_cg_matrix_free(table, Bf, FF, 0, lens, cols, vals.half(),
                             cg_iters=3, cg_tol=1e-10, **_kw(False))


def _rows_mode(dev, lens, n):
    """A PaddedBatch's row ids for a batch of len(lens) rows: table rows
    in reverse, every 7th a padding id (``n``, the table's row count, or
    ``1 << 30``) whose row is emptied, as the planner pads."""
    B = len(lens)
    rows = torch.arange(n - 1, n - 1 - B, -1, dtype=torch.int32, device=dev)
    rows[::7] = n
    rows[3::7] = 1 << 30
    lens = lens.clone()
    lens[(rows >= n)] = 0
    return rows, lens


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("mode", ["range", "rows"])
@pytest.mark.parametrize("L", [8, 96, 1000])
def test_k1_k2_rows_mode_and_bf16_match_plain(dev, L, mode, bf16):
    """K1 (L <= 96) or K2 + K3 (L = 1000) on PaddedBatch rows and on
    bfloat16 values, against the plain versions on the same inputs."""
    table, Bf, FF, (lens, cols, vals) = _case(dev, 40, L=L, B=61, seed=L)
    where = dict(row_start=5)
    if mode == "rows":
        rows, lens = _rows_mode(dev, lens, table.shape[0])
        where = dict(rows=rows)
    if bf16:
        vals = vals.to(torch.bfloat16)
    kw = _kw(True)
    expect = table.clone()
    if L <= K.MATRIX_FREE_MAX_L:
        rs = where.get("row_start", 0)
        rw = where.get("rows")
        n_ref, d_ref = K.als_cg_matrix_free_plain(
            expect, Bf, FF, rs, lens, cols, vals, rows=rw, cg_iters=3,
            cg_tol=1e-10, **kw)
        n_got, d_got = K.als_cg_matrix_free(
            table, Bf, FF, rs, lens, cols, vals, rows=rw, cg_iters=3,
            cg_tol=1e-10, **kw)
    else:
        A_ref, y_ref, n_ref, d_ref = K.als_normal_equations_plain(
            expect, Bf, FF, lens, cols, vals, **where, **kw)
        A, y, n_got, d_got = K.als_normal_equations(
            table, Bf, FF, lens, cols, vals, **where, **kw)
        torch.testing.assert_close(A, A_ref, rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
        K.batched_cg_dense_plain(A_ref, y_ref, expect, lens, cg_iters=3,
                                 cg_tol=1e-10, **where)
        K.batched_cg_dense(A_ref, y_ref, table, lens, cg_iters=3,
                           cg_tol=1e-10, **where)
    torch.cuda.synchronize()
    torch.testing.assert_close(table, expect, **TOL)
    torch.testing.assert_close(n_got, n_ref, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(d_got, d_ref, rtol=1e-4, atol=1e-3)


# (d, block): one block, two, a 22-wide tail block (150 = 4 x 32 + 22), the
# iALS++ path's d = 160 in one block and the widest d; L = 8 and 96 keep
# the row's F in shared memory for the whole solve, 1000 at d = 256 and
# 8192 stream it through the tile in every pass
@pytest.mark.parametrize("d,block_size", [(13, 13), (64, 32), (150, 32),
                                          (160, 160), (256, 256), (300, 32),
                                          (300, 300)])
@pytest.mark.parametrize("L", [8, 96, 1000, 8192])
@pytest.mark.parametrize("mode", ["range", "rows"])
def test_ialspp_kernel_matches_plain(dev, d, block_size, L, mode):
    table, Bf, FF, (lens, cols, vals) = _case(dev, d, L=L, B=40, seed=d + L)
    where = dict(row_start=5)
    if mode == "rows":
        rows, lens = _rows_mode(dev, lens, table.shape[0])
        where = dict(rows=rows)
    bf16 = L == 96  # bfloat16 values on one length
    if bf16:
        vals = vals.to(torch.bfloat16)
    kw = dict(_kw(True, adaptive_reg=d == 64), block_size=block_size,
              cg_tol=1e-10, **where)
    expect = table.clone()
    n_ref, d_ref = K.ialspp_solve_batch_plain(expect, Bf, FF, lens, cols,
                                              vals, **kw)
    before = K.ialspp_solve_batch.launches
    n_got, d_got = K.ialspp_solve_batch(table, Bf, FF, lens, cols, vals, **kw)
    torch.cuda.synchronize()
    assert K.ialspp_solve_batch.launches == before + 1
    torch.testing.assert_close(table, expect, **TOL)
    torch.testing.assert_close(n_got, n_ref, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(d_got, d_ref, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("L", [96, 8192])
def test_ialspp_kernel_is_deterministic(dev, L):
    """Two launches on the same inputs give bitwise-equal results, with F
    kept in shared memory (L = 96) and streamed (L = 8192)."""
    table, Bf, FF, (lens, cols, vals) = _case(dev, 160, L=L, B=40)
    outs, losses = [table.clone(), table.clone()], []
    for out in outs:
        losses.append(K.ialspp_solve_batch(
            out, Bf, FF, lens, cols, vals, row_start=5, block_size=160,
            cg_tol=1e-10, **_kw(True)))
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], table)
    for a, b in zip(*losses):
        assert torch.equal(a, b)


# K4's forms: d = 40, 160 and 176 take the short form (rows of at most
# IALSPP_SHORT_MAX entries, several a block), the tile form (up to
# IALSPP_GRAM_MIN) and the Gram form (longer rows; 176 is its widest); 256
# and 300 the tile form alone.  Each batch mixes the classes: empty rows,
# one entry, each bound and one past it, rows of one and two ring stages
# (64-entry stages) and past the tile's 348 entries; B = 37 is no multiple
# of the short form's rows a block
@pytest.mark.parametrize("d", [40, 160, 176, 256, 300])
@pytest.mark.parametrize("blocks", ["one", "of_32"])
@pytest.mark.parametrize("mode", ["range", "rows"])
@pytest.mark.parametrize("bf16", [False, True])
def test_ialspp_forms_match_plain(dev, d, blocks, mode, bf16):
    """K4 on a batch whose rows fall in both classes, in range and rows
    mode, on float32 and bfloat16 values, one block and blocks of 32:
    within TOL of the plain version, loss terms 1e-4, bitwise repeatable,
    one wrapper launch; the forms query names the route of the width."""
    L = 1000
    table, Bf, FF, (lens, cols, vals) = _case(dev, d, L=L, B=37, seed=d)
    lo, hi = K.IALSPP_SHORT_MAX, K.IALSPP_GRAM_MIN
    rng = np.random.default_rng(d)
    pick = np.r_[0, 1, lo, lo + 1, hi, hi + 1, 64, 65, 129, 349, L,
                 rng.integers(1, L + 1, 26)].astype(np.int32)
    lens = torch.from_numpy(pick).to(dev)
    mask = torch.arange(L, device=dev)[None, :] < lens[:, None]
    cols, vals = cols * mask, vals * mask
    where = dict(row_start=3)
    if mode == "rows":
        rows, lens = _rows_mode(dev, lens, table.shape[0])
        where = dict(rows=rows)
    if bf16:
        vals = vals.to(torch.bfloat16)
    kw = dict(_kw(True, adaptive_reg=bf16), cg_tol=1e-10,
              block_size=d if blocks == "one" else 32, **where)
    forms = K.ialspp_forms(d, kw["block_size"], L)
    assert forms["form"] == ("tile" if d > 176 else "short+tile+gram")
    expect = table.clone()
    n_ref, d_ref = K.ialspp_solve_batch_plain(expect, Bf, FF, lens, cols,
                                              vals, **kw)
    outs = [table.clone(), table.clone()]
    before = K.ialspp_solve_batch.launches
    got = [K.ialspp_solve_batch(o, Bf, FF, lens, cols, vals, **kw)
           for o in outs]
    torch.cuda.synchronize()
    assert K.ialspp_solve_batch.launches == before + 2
    torch.testing.assert_close(outs[0], expect, **TOL)
    torch.testing.assert_close(got[0][0], n_ref, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(got[0][1], d_ref, rtol=1e-4, atol=1e-3)
    assert torch.equal(outs[0], outs[1])
    assert all(torch.equal(a, b) for a, b in zip(*got))


def test_streamed_batches_match_host_batches(dev):
    """The staging ring's batches on the card equal the planner's host
    batches, epoch after epoch, and its byte count is theirs."""
    rng = np.random.default_rng(2)
    degs = rng.integers(0, 200, size=3000)
    degs[7] = 20_000
    indptr = np.concatenate([[0], np.cumsum(degs)])
    key = rng.integers(0, 500, int(indptr[-1])).astype(np.int32)
    val = (1.0 + rng.random(int(indptr[-1]))).astype(np.float32)

    class _Data:
        def get_group(self, g):
            return {"indptr": indptr, "key": key, "val": val}

    b = batching.DeviceBatcher(_Data(), "rowwise", batch_mb=2, d=8,
                               resident_mb=0, device=dev)
    host = list(b.planner.iter_batches(key, val))
    nbytes = sum(a.nbytes for h in host for a in h) + sum(
        4 * (len(h.rows) + 1) for h in host
        if isinstance(h, batching.SegmentBatch))
    assert len(host) > 4
    for epoch in range(2):
        seen = 0
        # a staged batch is read before the next is asked for: its slot
        # takes the batch two later
        for s, h in zip(b, host):
            for f in h._fields:
                assert np.array_equal(getattr(s, f).cpu().numpy(),
                                      getattr(h, f)), f
            seen += 1
        assert seen == len(host)
        assert b.h2d_bytes == (epoch + 1) * nbytes


# ---------------------------------------------------------------- K5-K7
def _topk_close(got, ref):
    """Scores within 1e-5 relative; ids equal except where the two scores
    are within that too (ties)."""
    (gv, gi), (rv, ri) = got, ref
    torch.testing.assert_close(gv, rv, rtol=1e-5, atol=1e-6)
    tied = torch.isclose(gv, rv, rtol=1e-5, atol=1e-6)
    assert bool(((gi == ri) | tied).all())


def _ties_in_index_order(vals, idx):
    """Where neighbouring scores are equal, the indices ascend."""
    same = vals[:, 1:] == vals[:, :-1]
    assert bool((~same | (idx[:, 1:] > idx[:, :-1])).all())


def _score_case(dev, d, N=2500, B=300, seed=0, dup=True):
    rng = np.random.default_rng(seed)
    Q = rng.normal(size=(N, d)).astype(np.float32)
    if dup:  # duplicated rows score equal: they must come back in order
        Q[5] *= 10  # the best match of p[:3]
        Q[[17, 400, 1999]] = Q[5]
    p = rng.normal(size=(B, d)).astype(np.float32)
    p[:3] = Q[5]
    Qb = rng.normal(size=N).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (p, Q, Qb)]


# d = 13, 40, 100, 160, 256 (no multiple of the 32-feature chunk but 160,
# 256); k = 1, 10 (list of 32), 100 (128), 1024; N = 2500 is no multiple of
# the item tile, B = 300 none of the query block
@pytest.mark.parametrize("d", [13, 40, 100, 160, 256, 300])
@pytest.mark.parametrize("k", [1, 10, 100, 1024])
@pytest.mark.parametrize("bias", [False, True])
def test_score_topk_kernel_matches_plain(dev, d, k, bias):
    from buffalo_tpu_torch.ops import retrieval_kernels as R

    p, Q, Qb = _score_case(dev, d, seed=d + k)
    Qb = Qb if bias else None
    before = R.score_topk.launches
    got = R.score_topk(p, Q, k, Qb)
    torch.cuda.synchronize()
    assert R.score_topk.launches == before + 1
    _topk_close(got, R.score_topk_plain(p, Q, k, Qb))
    _ties_in_index_order(*got)
    if not bias and k >= 4:  # the duplicated rows, in index order
        assert got[1][0, :4].tolist() == [5, 17, 400, 1999]


@pytest.mark.parametrize("shape", [(5000, 200, 40, 10), (4096, 711, 101, 1),
                                   (4096, 711, 101, 2), (70, 9000, 64, 10)])
def test_score_topk_kernel_shapes(dev, shape):
    """One split (N under two item tiles), the k-means assignment's shape
    (unit rows against 711 centroids at k = 1 and 2), and a small B over
    a wide catalog (many splits); bfloat16 queries against their float32
    rounding."""
    from buffalo_tpu_torch.ops import retrieval_kernels as R

    B, N, d, k = shape
    p, Q, Qb = _score_case(dev, d, N=N, B=B, seed=B, dup=False)
    _topk_close(R.score_topk(p, Q, k, Qb), R.score_topk_plain(p, Q, k, Qb))
    p16 = p.to(torch.bfloat16)
    _topk_close(R.score_topk(p16, Q, k), R.score_topk_plain(p16, Q, k))


def test_score_topk_kernel_neg_inf_and_limits(dev):
    """-inf scores (padding rows' bias) are kept as the lowest entries, in
    index order; k past 1024 raises NotImplementedError."""
    from buffalo_tpu_torch.ops import retrieval_kernels as R

    p, Q, Qb = _score_case(dev, 24, N=300, B=70, dup=False)
    Qb[200:] = float("-inf")
    vals, idx = R.score_topk(p, Q, 250, Qb)
    _topk_close((vals, idx), R.score_topk_plain(p, Q, 250, Qb))
    assert bool(torch.isinf(vals[:, 200:]).all())
    assert idx[:, 200:].tolist() == [list(range(200, 250))] * 70
    with pytest.raises(NotImplementedError):
        R.score_topk(p, torch.zeros(2000, 24, device=dev), 1025)


# the list lengths and widths at which K5's wrapper routes between its
# tensor-core form (k <= 32, d <= 256) and its FFMA form, over 1 to 26,744
# items (the ML-20M catalog); 100 queries are no multiple of a query block
@pytest.mark.parametrize("d", [1, 7, 40, 100, 256, 300])
@pytest.mark.parametrize("k", [1, 10, 32, 33, 128, 129, 1024])
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
def test_score_topk_forms_match_plain(dev, monkeypatch, d, k, qdtype, bias):
    """Each of K5's forms that takes (k, d), forced at every N, against
    its plain version by chip_smoke's ``kernel_topk_check`` rule (scores
    within 1e-5, ids equal off ties, equal scores in index order) at N =
    1, 127, 711, 26,744 (k <= N), every 7th row's bias -inf; two launches
    bitwise equal; the wrapper's own route by ``score_topk_form``.  The rows,
    queries and biases are |N(0, 1)|: the rule is relative, and a score
    that sums terms of both signs to near 0 (a single item's, at N = 1)
    parts from the plain version's by more than 1e-5 of itself in any
    two float32 summation orders."""
    from buffalo_tpu_torch.ops import retrieval_kernels as R

    for N in (1, 127, 711, 26_744):
        if k > N:
            continue
        rng = np.random.default_rng(N + d + k)
        Q = np.abs(rng.standard_normal((N, d))).astype(np.float32)
        p = np.abs(rng.standard_normal((100, d))).astype(np.float32)
        Qb = np.abs(rng.standard_normal(N)).astype(np.float32)
        Qb[::7] = -np.inf
        Q, p, Qb = (torch.from_numpy(a).to(dev) for a in (Q, p, Qb))
        p = p.to(getattr(torch, qdtype))
        Qb = Qb if bias else None
        takes_tc = k <= 32 and d <= 256
        form, _ = R.score_topk_shape(100, N, d, k, p.dtype, dev)
        assert form == ("tc" if takes_tc and N >= R.TC_MIN_ITEMS else "ffma")
        ref = R.score_topk_plain(p, Q, k, Qb)
        for forced in ("tc", "ffma") if takes_tc else ("ffma",):
            monkeypatch.setattr(R, "score_topk_form", lambda *a: forced)
            got = R.score_topk(p, Q, k, Qb)
            again = R.score_topk(p, Q, k, Qb)
            torch.cuda.synchronize()
            _topk_close(got, ref)
            _ties_in_index_order(*got)
            assert torch.equal(got[0], again[0])
            assert torch.equal(got[1], again[1])
            monkeypatch.undo()


@pytest.mark.parametrize("k", [10, 100])
def test_score_topk_empty_batch(dev, k):
    """No queries over a catalog the tensor-core form takes (k = 10) and
    one the FFMA form takes (k = 100): empty (0, k) lists, no launch."""
    from buffalo_tpu_torch.ops import retrieval_kernels as R

    Q = torch.ones(26_744, 40, device=dev)
    before = R.score_topk.launches
    for dtype in (torch.float32, torch.bfloat16):
        vals, idx = R.score_topk(torch.zeros(0, 40, device=dev, dtype=dtype),
                                 Q, k)
        assert vals.shape == idx.shape == (0, k)
        assert (vals.dtype, idx.dtype) == (torch.float32, torch.int32)
    assert R.score_topk.launches == before


def _ivf_case(dev, d, T=40, bq=64, l_cap=256, seed=0):
    rng = np.random.default_rng(seed)
    B, Nt = 500, 3000
    queries = rng.normal(size=(B, d)).astype(np.float32)
    table = rng.normal(size=(Nt, d)).astype(np.float32)
    ln = rng.integers(0, l_cap + 1, size=T).astype(np.int32)
    ln[:3] = [0, 1, l_cap]
    lo = rng.integers(0, Nt - l_cap, size=T).astype(np.int32)
    lo[-1], ln[-1] = Nt - 5, 5  # the table's last rows, nothing past them
    qidx = rng.integers(0, B, size=(T, bq)).astype(np.int32)
    qmask = rng.random((T, bq)) < 0.8
    return [torch.from_numpy(a).to(dev)
            for a in (queries, table, qidx, qmask, lo, ln)]


@pytest.mark.parametrize("d", [13, 40, 100, 160, 256, 300])
@pytest.mark.parametrize("kk", [1, 10, 100, 1024])
def test_ivf_tile_kernel_matches_plain(dev, d, kk):
    from buffalo_tpu_torch.ops import retrieval_kernels as R

    l_cap, bq = (1024, 256) if kk == 1024 else (256, 64)
    args = _ivf_case(dev, d, bq=bq, l_cap=l_cap, seed=d + kk)
    before = R.ivf_tile_topk.launches
    got = R.ivf_tile_topk(*args, kk, l_cap, ln_host=args[5].cpu().numpy())
    torch.cuda.synchronize()
    assert R.ivf_tile_topk.launches == before + 1
    ref = R.ivf_tile_topk_plain(*args, kk, l_cap)
    T, bq_, _ = ref[0].shape
    gv, gp = (x.reshape(T * bq_, kk) for x in got)
    rv, rp = (x.reshape(T * bq_, kk) for x in ref)
    _topk_close((gv, gp), (rv, rp))
    # masked entries are -inf (never NaN) at the first masked columns
    assert not bool(torch.isnan(gv).any())
    assert torch.equal(torch.isinf(gv), torch.isinf(rv))


@pytest.mark.parametrize("D", [14, 41, 101, 257, 301, 600])
def test_kmeans_update_kernel_matches_plain(dev, D):
    """Members' mean normalized, an empty cell keeping its centroid, rows
    of zero norm weighing nothing; two launches bitwise equal."""
    from buffalo_tpu_torch.ops import retrieval_kernels as R

    rng = np.random.default_rng(D)
    N, C = 9000, 97
    unit = rng.normal(size=(N, D)).astype(np.float32)
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    unit[-300:] = 0.0
    assign = rng.integers(0, C, size=N).astype(np.int32)
    assign[assign == 7] = 8  # cell 7 is empty
    assign[:50] = 3          # a large cell
    cent = rng.normal(size=(C, D)).astype(np.float32)
    unit, assign, cent = (torch.from_numpy(a).to(dev)
                          for a in (unit, assign, cent))
    before = R.kmeans_update.launches
    got = R.kmeans_update(unit, assign, cent)
    again = R.kmeans_update(unit, assign, cent)
    torch.cuda.synchronize()
    assert R.kmeans_update.launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, R.kmeans_update_plain(unit, assign, cent),
                               rtol=1e-5, atol=1e-5)
    ref7 = cent[7] / cent[7].norm()
    torch.testing.assert_close(got[7], ref7, rtol=1e-6, atol=1e-7)


def test_kmeans_update_kernel_many_cells(dev):
    """Past 58,112 cells the counters leave shared memory (the global
    form): the same means, bitwise repeatable."""
    from buffalo_tpu_torch.ops import retrieval_kernels as R

    rng = np.random.default_rng(1)
    N, C, D = 200_000, 60_000, 14
    unit = rng.normal(size=(N, D)).astype(np.float32)
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    assign = rng.integers(0, C, size=N).astype(np.int32)
    cent = rng.normal(size=(C, D)).astype(np.float32)
    unit, assign, cent = (torch.from_numpy(a).to(dev)
                          for a in (unit, assign, cent))
    got = R.kmeans_update(unit, assign, cent)
    assert torch.equal(got, R.kmeans_update(unit, assign, cent))
    torch.testing.assert_close(got, R.kmeans_update_plain(unit, assign, cent),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("D", [101, 300])
@pytest.mark.parametrize("run", [None, 1, 7])
def test_kmeans_update_kernel_runs_match_plain(dev, D, run):
    """K7 at the brunch and wide_rows widths, with cells of several runs
    (a run of ``kmeans_plan``'s length, or forced to 1 and 7 members):
    rows of zero norm and squares that underflow weigh nothing, an empty
    cell keeps its centroid; at most four launches a call; bitwise
    repeatable."""
    from torch.profiler import ProfilerActivity, profile

    from buffalo_tpu_torch.ops import retrieval_kernels as R

    rng = np.random.default_rng(D)
    N, C = 20_000, 60
    unit = rng.normal(size=(N, D)).astype(np.float32)
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    unit[rng.random(N) < 0.03] = 0.0
    unit[5] = 1e-23
    assign = rng.integers(0, C, size=N).astype(np.int32)
    assign[assign == 11] = 12
    assign[[5, 6]] = 13
    cent = rng.normal(size=(C, D)).astype(np.float32)
    unit, assign, cent = (torch.from_numpy(a).to(dev)
                          for a in (unit, assign, cent))
    real = R._K7_RUN
    if run is not None:
        R._K7_RUN = run
    try:
        got = R.kmeans_update(unit, assign, cent)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            again = R.kmeans_update(unit, assign, cent)
            torch.cuda.synchronize()
    finally:
        R._K7_RUN = real
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "emset" not in e.name]
    assert 1 <= len(kernels) <= 4
    assert torch.equal(got, again)
    torch.testing.assert_close(got, R.kmeans_update_plain(unit, assign, cent),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[11], cent[11] / cent[11].norm(),
                               rtol=1e-6, atol=1e-7)


def test_kmeans_update_kernel_on_rows_of_13313_floats(dev):
    """Rows of 13,313 floats (52 column passes of a run block): the plain
    version's means, bitwise repeatable."""
    from buffalo_tpu_torch.ops import retrieval_kernels as R

    rng = np.random.default_rng(3)
    N, C, D = 1_500, 9, 13_313
    unit = rng.normal(size=(N, D)).astype(np.float32)
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    unit[:40] = 0.0
    assign = rng.integers(0, C - 1, size=N).astype(np.int32)  # C - 1 empty
    cent = rng.normal(size=(C, D)).astype(np.float32)
    unit, assign, cent = (torch.from_numpy(a).to(dev)
                          for a in (unit, assign, cent))
    got = R.kmeans_update(unit, assign, cent)
    assert torch.equal(got, R.kmeans_update(unit, assign, cent))
    torch.testing.assert_close(got, R.kmeans_update_plain(unit, assign, cent),
                               rtol=1e-5, atol=1e-5)


def test_kmeans_update_kernel_past_the_counter_cap_at_d_300(dev):
    """wide_rows' index: 120,000 rows of 301 floats in 60,000 cells (the
    global counters, runs of kmeans_plan's length 4), empty cells among
    them; bitwise repeatable, the plain version's means."""
    from buffalo_tpu_torch.ops import retrieval_kernels as R

    rng = np.random.default_rng(2)
    N, C, D = 120_000, 60_000, 301
    unit = rng.normal(size=(N, D)).astype(np.float32)
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    assign = rng.integers(0, C, size=N).astype(np.int32)
    cent = rng.normal(size=(C, D)).astype(np.float32)
    unit, assign, cent = (torch.from_numpy(a).to(dev)
                          for a in (unit, assign, cent))
    assert R.kmeans_plan(N, D, C)["run"] == 4
    assert int((torch.bincount(assign.long(), minlength=C) == 0).sum()) > 0
    got = R.kmeans_update(unit, assign, cent)
    assert torch.equal(got, R.kmeans_update(unit, assign, cent))
    torch.testing.assert_close(got, R.kmeans_update_plain(unit, assign, cent),
                               rtol=1e-5, atol=1e-5)


def test_kmeans_plan_is_the_c_workspace(dev):
    """kmeans_plan's workspace words are the C launcher's carve."""
    import ctypes

    from buffalo_tpu_torch.ops import retrieval_kernels as R
    from buffalo_tpu_torch.ops._build import launcher

    f = launcher("kmeans_update_workspace", [ctypes.c_int] * 4
                 + [ctypes.c_void_p], library="kmeans_update")
    for N, D, C in ((0, 5, 1), (9000, 14, 97), (505_840, 101, 711),
                    (120_000, 301, 60_000), (1_000, 20_000, 3)):
        plan = R.kmeans_plan(N, D, C)
        sizes = (ctypes.c_int64 * 2)()
        f(N, D, C, plan["run"], ctypes.cast(sizes, ctypes.c_void_p))
        assert (sizes[0], sizes[1]) == (plan["ints"], plan["floats"])


# ---------------------------------------------------------------- K8-K10
def _bpr_case(dev, d, U=700, I=300, N=5000, neg_per=1, seed=0, scale=0.3):
    """Tables, a chunk sorted by user (CSR order) with a masked tail of 37
    slots, and negatives with about one sentinel in 40; a popular item
    (10% of the positives), so its row sums thousands of terms."""
    rng = np.random.default_rng(seed)
    P = rng.normal(0, scale, (U, d)).astype(np.float32)
    Q = rng.normal(0, scale, (I, d)).astype(np.float32)
    Qb = rng.normal(0, scale, I).astype(np.float32)
    users = np.sort(rng.integers(0, U, N)).astype(np.int32)
    pos = rng.integers(0, I, N).astype(np.int32)
    pos[rng.random(N) < 0.1] = 3
    neg = rng.integers(0, I, N * neg_per).astype(np.int32)
    neg[rng.random(N * neg_per) < 0.025] = I
    return [torch.from_numpy(a).to(dev)
            for a in (P, Q, Qb, users, pos, neg)], N - 37


def _step_close(got, ref, start, rtol=1e-5):
    """A table's step against the plain version's: within rtol of the
    largest step, plus two float32 spacings of the table's values (each
    side rounds start + step once)."""
    err = float((got - ref).abs().max())
    step = float((ref - start).abs().max())
    limit = rtol * step + 2 * 2 ** -23 * float(start.abs().max())
    assert err <= limit, (err, step, limit)


@pytest.mark.parametrize("alias", [False, True])
@pytest.mark.parametrize("verify", [False, True])
@pytest.mark.parametrize("neg_per", [1, 3])
def test_sample_kernel_equals_plain(dev, alias, verify, neg_per):
    """K8 is its plain version bit for bit: uniform or alias draws, with or
    without the bloom check, and the random positives."""
    from buffalo_tpu_torch.ops import sgd_kernels as S

    rng = np.random.default_rng(neg_per)
    U, I = 500, 3000
    deg = rng.integers(1, 200, U)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    keys = rng.integers(0, I, int(indptr[-1])).astype(np.int32)
    kw = dict(num_negatives=neg_per, seed=(1 << 40) + 5, epoch=3, chunk=7,
              pos_indptr=torch.from_numpy(indptr).to(dev),
              pos_keys=torch.from_numpy(keys).to(dev))
    if verify:
        words, log2 = S.build_bloom(indptr, keys)
        kw.update(bloom=torch.from_numpy(words.view(np.int32)).to(dev),
                  bloom_log2=log2)
    if alias:
        prob, al = S.build_alias_table(rng.pareto(1.0, I) + 0.01)
        kw["alias"] = (torch.from_numpy(prob).to(dev),
                       torch.from_numpy(al).to(dev))
    users = torch.from_numpy(rng.integers(0, U, 20000).astype(np.int32)).to(
        dev)
    before = S.sample_negatives.launches
    neg, pos = S.sample_negatives(users, I, **kw)
    torch.cuda.synchronize()
    assert S.sample_negatives.launches == before + 1
    ref_neg, ref_pos = S.sample_negatives_plain(users, I, **kw)
    assert torch.equal(neg, ref_neg) and torch.equal(pos, ref_pos)


@pytest.mark.parametrize("d", [8, 13, 40, 64, 129, 256, 300])
@pytest.mark.parametrize("cap", [0.0, 0.1])
@pytest.mark.parametrize("neg_per", [1, 2])
@pytest.mark.parametrize("users_sorted", [False, True])
def test_chunk_update_kernel_matches_plain(dev, d, cap, neg_per,
                                           users_sorted):
    """K9's sgd step against its plain version (steps within 1e-5 of the
    largest), two launches bitwise equal; the chunk's users (in CSR order)
    grouped by row or summed where they lie (presorted)."""
    from buffalo_tpu_torch.ops import sgd_kernels as S

    (P, Q, Qb, users, pos, neg), n_valid = _bpr_case(dev, d, neg_per=neg_per,
                                                     seed=d)
    kw = dict(n_valid=n_valid, lr=0.2, reg_u=0.03, reg_i=0.02, reg_j=0.04,
              reg_b=0.05, max_step_norm=cap, num_negatives=neg_per,
              use_bias=True, update_i=True, update_j=True,
              users_sorted=users_sorted)
    runs = []
    for fn in (S.chunk_update, S.chunk_update, S.chunk_update_plain):
        t = [P.clone(), Q.clone(), Qb.clone()]
        fn(*t, users, pos, neg, **kw)
        runs.append(t)
    torch.cuda.synchronize()
    for got, again, ref, start in zip(*runs, (P, Q, Qb)):
        assert torch.equal(got, again)
        _step_close(got, ref, start)


@pytest.mark.parametrize("flags", [(True, True, True), (False, True, False),
                                   (True, False, True)])
def test_chunk_update_kernel_flags_match_plain(dev, flags):
    from buffalo_tpu_torch.ops import sgd_kernels as S

    use_bias, update_i, update_j = flags
    (P, Q, Qb, users, pos, neg), n_valid = _bpr_case(dev, 40, seed=5)
    kw = dict(n_valid=n_valid, lr=0.2, reg_u=0.03, reg_i=0.02, reg_j=0.04,
              reg_b=0.05, max_step_norm=0.1, num_negatives=1,
              use_bias=use_bias, update_i=update_i, update_j=update_j)
    got, ref = [P.clone(), Q.clone(), Qb.clone()], [P.clone(), Q.clone(),
                                                     Qb.clone()]
    S.chunk_update(*got, users, pos, neg, **kw)
    S.chunk_update_plain(*ref, users, pos, neg, **kw)
    for g, r, s in zip(got, ref, (P, Q, Qb)):
        _step_close(g, r, s)


@pytest.mark.parametrize("d", [13, 40, 256, 300])
@pytest.mark.parametrize("pcn", [False, True])
@pytest.mark.parametrize("users_sorted", [False, True])
def test_chunk_accumulate_kernel_matches_plain(dev, d, pcn, users_sorted):
    from buffalo_tpu_torch.ops import sgd_kernels as S

    (P, Q, Qb, users, pos, neg), n_valid = _bpr_case(dev, d, neg_per=2,
                                                     seed=d + 1)
    kw = dict(n_valid=n_valid, num_negatives=2, use_bias=True, update_i=True,
              update_j=True, per_coordinate_normalize=pcn,
              users_sorted=users_sorted)
    runs = []
    for fn in (S.chunk_accumulate, S.chunk_accumulate,
               S.chunk_accumulate_plain):
        acc = S.new_accumulators(P, Q, Qb)
        for a in acc:   # accumulators already holding a previous chunk
            a.fill_(0.5)
        fn(P, Q, Qb, *acc, users, pos, neg, **kw)
        runs.append(acc)
    torch.cuda.synchronize()
    for got, again, ref in zip(*runs):
        assert torch.equal(got, again)
        _step_close(got, ref, torch.full_like(ref, 0.5))


def test_triplet_loss_kernel_matches_plain(dev):
    from buffalo_tpu_torch.ops import sgd_kernels as S

    (P, Q, Qb, users, pos, neg), _ = _bpr_case(dev, 40, N=372, seed=9)
    neg = neg.clamp(max=Q.shape[0] - 1)
    for bias in (False, True):
        got = S.triplet_loss(P, Q, Qb, users, pos, neg, use_bias=bias)
        ref = S.triplet_loss_plain(P, Q, Qb, users, pos, neg, use_bias=bias)
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=0)
        assert torch.equal(got, S.triplet_loss(P, Q, Qb, users, pos, neg,
                                               use_bias=bias))


@pytest.mark.parametrize("optimizer", ["adam", "adagrad"])
@pytest.mark.parametrize("pcn", [False, True])
@pytest.mark.parametrize("shape", [(1000, 40), (777,)])
def test_deferred_update_kernel_matches_plain(dev, optimizer, pcn, shape):
    from buffalo_tpu_torch.ops import sgd_kernels as S

    rng = np.random.default_rng(len(shape))
    tabs = [torch.from_numpy(rng.normal(0, s, shape).astype(np.float32)).to(
        dev) for s in (0.3, 0.5, 0.01)]
    tabs.append(tabs[2].abs() + 0.01)                     # v >= 0
    counts = torch.from_numpy(rng.integers(0, 9, shape[0]).astype(
        np.float32)).to(dev)
    kw = dict(step=4, optimizer=optimizer, lr=0.05, beta1=0.9, beta2=0.999,
              reg=0.025, per_coordinate_normalize=pcn)
    got, ref = [t.clone() for t in tabs], [t.clone() for t in tabs]
    S.deferred_update(*got, counts, **kw)
    S.deferred_update_plain(*ref, counts, **kw)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-7)
    assert not bool(got[1].any())                         # grad zeroed


def test_bpr_wrappers_reject_what_kernels_do_not_take(dev):
    from buffalo_tpu_torch.ops import sgd_kernels as S

    (P, Q, Qb, users, pos, neg), n = _bpr_case(dev, 40)
    kw = dict(n_valid=n, lr=0.1, reg_u=0.0, reg_i=0.0, reg_j=0.0, reg_b=0.0,
              max_step_norm=0.0, num_negatives=1, use_bias=True,
              update_i=True, update_j=True)
    with pytest.raises(TypeError):
        S.chunk_update(P, Q, Qb, users.long(), pos, neg, **kw)
    with pytest.raises(ValueError):
        S.chunk_update(P, Q, Qb, users, pos, neg[:-1], **kw)
    with pytest.raises(ValueError):
        S.deferred_update(P, P.clone(), None, P.clone(), None, step=0,
                          optimizer="rmsprop", lr=0.1, beta1=0.9, beta2=0.9,
                          reg=0.0, per_coordinate_normalize=False)


def test_bpr_epoch_on_the_card_matches_the_cpu(dev):
    """Two small resident epochs through the user's entry point on the
    card and on the CPU: the same negatives (K8 equals its plain version)
    and float32 updates in another order."""
    import buffalo_tpu_torch as bt

    rng = np.random.default_rng(0)
    U, I = 300, 120
    rows, cols = [], []
    for u in range(U):
        for i in rng.choice(I, rng.integers(2, 30), replace=False):
            rows.append(u)
            cols.append(int(i))

    from buffalo_tpu_torch.data.base import Data

    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows,
                                                        minlength=U))])
    groups = {"rowwise": {"indptr": indptr, "key": np.array(cols, np.int32)}}

    class Small(Data):
        def __init__(self):
            pass

        def get_header(self):
            return {"num_users": U, "num_items": I, "num_nnz": len(cols)}

        def get_group(self, name):
            return groups[name]

        def get(self, u):
            return (groups["rowwise"]["key"][indptr[u]:indptr[u + 1]],)

        data_type = "matrix"

        def show_info(self):
            return ""

    out = []
    for device in ("cuda", "cpu"):
        opt = bt.BPRMFOption().get_default_option()
        opt.update(d=24, num_iters=2, batch_size=1024, device=device,
                   validation={})
        m = bt.BPRMF(opt, data=Small())
        np.random.seed(1)
        m.initialize()
        m.train()
        out.append(m)
    for name in ("P", "Q", "Qb"):
        np.testing.assert_allclose(getattr(out[0], name),
                                   getattr(out[1], name), rtol=1e-4,
                                   atol=1e-5)


# ------------------------------------------------------------------ WARP
def _warp_case(dev, d, U=600, I=300, N=3000, seed=0, scale=0.4):
    from buffalo_tpu_torch.ops import sgd_kernels as S

    rng = np.random.default_rng(seed)
    deg = rng.integers(1, 12, U)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    keys = np.concatenate([np.sort(rng.choice(I, k, replace=False))
                           for k in deg]).astype(np.int32)
    words, log2 = S.build_bloom(indptr, keys)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    return dict(
        P=t((scale * rng.standard_normal((U, d))).astype(np.float32)),
        Q=t((scale * rng.standard_normal((I, d))).astype(np.float32)),
        users=t(np.sort(rng.integers(0, U, N)).astype(np.int32)),
        pos=t(rng.integers(0, I, N).astype(np.int32)), indptr=t(indptr),
        bloom=t(words.view(np.int32)), log2=log2, I=I)


def _search_kw(c, K, probe, score_func, n_valid, **kw):
    return dict(num_items=c["I"], num_candidates=K, seed=5, epoch=2, chunk=7,
                n_valid=n_valid, score_func=score_func, threshold=0.5,
                probe=probe, indptr=c["indptr"], bloom=c["bloom"],
                bloom_log2=c["log2"], **kw)


@pytest.mark.parametrize("d", [8, 13, 64, 256, 300])
@pytest.mark.parametrize("K", [3, 16, 64])
@pytest.mark.parametrize("probe", ["lazy", "all"])
@pytest.mark.parametrize("score_func", ["dot", "l2"])
def test_warp_search_kernel_equals_plain(dev, d, K, probe, score_func):
    """K11 against its plain version: ids, any_v, trials and counts equal,
    weights within 1 ulp; on its own draws and on injected candidates."""
    from buffalo_tpu_torch.ops import warp_kernels as W

    c = _warp_case(dev, d, scale=0.6 if d < 64 else 0.2)
    nv = c["users"].shape[0] - 37
    cands = W.warp_candidates(c["users"].shape[0], K, c["I"], seed=9,
                              epoch=0, chunk=0, device=dev)
    for extra in ({}, {"candidates": cands}):
        counts = [torch.zeros(3, dtype=torch.int32, device=dev)
                  for _ in range(2)]
        kw = _search_kw(c, K, probe, score_func, nv, **extra)
        got = W.warp_search(c["users"], c["pos"], c["P"], c["Q"],
                            counts=counts[0], count_index=1, **kw)
        ref = W.warp_search_plain(c["users"], c["pos"], c["P"], c["Q"],
                                  counts=counts[1], count_index=1, **kw)
        torch.cuda.synchronize()
        for name, g, r in zip(("neg", "w", "any_v", "trial"), got, ref):
            if name == "w":
                assert torch.allclose(g, r, rtol=1.2e-7, atol=0), name
            else:
                assert torch.equal(g, r), name
        assert torch.equal(counts[0], counts[1]) and int(counts[0][1]) > 0


# K across the packing edges of the lanes per slot (1, 8, 16 | 17, 32 | 33,
# 64); d = 4 and 64 on 16-byte loads, 63 on scalar ones, 300 the wide form
@pytest.mark.parametrize("d", [4, 63, 64, 300])
@pytest.mark.parametrize("K", [1, 8, 16, 17, 32, 33, 64])
@pytest.mark.parametrize("probe", ["lazy", "all"])
@pytest.mark.parametrize("score_func", ["dot", "l2"])
def test_warp_search_packed_lanes_equal_plain(dev, d, K, probe, score_func):
    """K11 against its plain version bit for bit (ids, any_v, trials and
    counts equal, weights within 1 ulp) on its own draws and on injected
    candidates, with the bloom filter and with seen bits, and at a slot
    offset; two launches bitwise equal."""
    from buffalo_tpu_torch.ops import warp_kernels as W

    c = _warp_case(dev, d, scale=0.6 if d < 64 else 0.2)
    N = c["users"].shape[0]
    cands = W.warp_candidates(N, K, c["I"], seed=9, epoch=0, chunk=0,
                              device=dev)
    for extra, offset, bits in (({}, 0, False), ({}, 0, True),
                                ({"candidates": cands}, 0, False),
                                ({"candidates": cands}, 0, True),
                                ({}, 1000, False)):
        kw = _search_kw(c, K, probe, score_func, N - 37, slot_offset=offset,
                        **extra)
        if bits:
            kw["seen_bits"] = W.warp_probe_plain(
                c["users"], num_items=c["I"], num_candidates=K, seed=5,
                epoch=2, chunk=7, bloom=kw.pop("bloom"),
                bloom_log2=c["log2"], candidates=extra.get("candidates"))
        counts = [torch.zeros(3, dtype=torch.int32, device=dev)
                  for _ in range(3)]
        got = W.warp_search(c["users"], c["pos"], c["P"], c["Q"],
                            counts=counts[0], count_index=1, **kw)
        again = W.warp_search(c["users"], c["pos"], c["P"], c["Q"],
                              counts=counts[1], count_index=1, **kw)
        ref = W.warp_search_plain(c["users"], c["pos"], c["P"], c["Q"],
                                  counts=counts[2], count_index=1, **kw)
        torch.cuda.synchronize()
        for name, g, a, r in zip(("neg", "w", "any_v", "trial"), got, again,
                                 ref):
            assert torch.equal(g, a), name
            if name == "w":
                assert torch.allclose(g, r, rtol=1.2e-7, atol=0), name
            else:
                assert torch.equal(g, r), name
        assert torch.equal(counts[0], counts[2])
        assert torch.equal(counts[1], counts[2]) and int(counts[0][1]) > 0


@pytest.mark.parametrize("K", [5, 64])
def test_warp_probe_kernel_equals_plain(dev, K):
    from buffalo_tpu_torch.ops import warp_kernels as W

    c = _warp_case(dev, 16)
    kw = dict(num_items=c["I"], num_candidates=K, seed=5, epoch=2, chunk=7,
              bloom=c["bloom"], bloom_log2=c["log2"])
    got = W.warp_probe(c["users"], **kw)
    ref = W.warp_probe_plain(c["users"], **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and bool(got.ne(0).any())
    # the search reading those bits under the "all" rule (the same draws)
    sk = _search_kw(c, K, "all", "dot", c["users"].shape[0], seen_bits=got)
    sk.pop("bloom")
    a = W.warp_search(c["users"], c["pos"], c["P"], c["Q"], **sk)
    b = W.warp_search(c["users"], c["pos"], c["P"], c["Q"],
                      **_search_kw(c, K, "all", "dot", c["users"].shape[0]))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("d", [8, 64, 256, 300])
@pytest.mark.parametrize("score_func", ["dot", "l2"])
@pytest.mark.parametrize("sorted_users", [False, True])
@pytest.mark.parametrize("flags", [(True, True, False), (False, True, True),
                                   (True, False, True)])
def test_warp_accumulate_kernel_matches_plain(dev, d, score_func,
                                              sorted_users, flags):
    """K12 against its plain version within 1e-5 of the largest entry,
    bitwise repeatable."""
    from buffalo_tpu_torch.ops import warp_kernels as W

    c = _warp_case(dev, d)
    N = c["users"].shape[0]
    users = c["users"] if sorted_users else c["users"][torch.randperm(
        N, device=dev)].contiguous()
    neg, w, any_v, _ = W.warp_search(
        users, c["pos"], c["P"], c["Q"],
        **_search_kw(c, 16, "lazy", score_func, N - 11))
    upd_i, upd_j, pcn = flags
    kw = dict(n_valid=N - 11, score_func=score_func, reg_u=0.03, reg_i=0.02,
              reg_j=0.01, update_i=upd_i, update_j=upd_j,
              per_coordinate_normalize=pcn, users_sorted=sorted_users)
    outs = []
    for fn in (W.warp_accumulate, W.warp_accumulate, W.warp_accumulate_plain):
        acc = W.new_accumulators(c["P"], c["Q"])
        for a in acc:
            a.fill_(0.5)
        fn(c["P"], c["Q"], *acc, users, c["pos"], neg, any_v, w, **kw)
        outs.append(acc)
    torch.cuda.synchronize()
    for g, g2, r in zip(*outs):
        assert torch.equal(g, g2)
        lim = 1e-5 * float((r - 0.5).abs().max()) + 2 ** -23
        assert float((g - r).abs().max()) <= lim


def _k12_edge_case(dev, case, d, seed=3):
    """Chunk inputs of K12 where its design branches: an item row past a
    warp's sort (5,000 positives on one item), user runs across many
    32-slot segments, no live slot, n_valid 0 and N, and a 200,000-row table
    of which the chunk touches a few hundred rows."""
    rng = np.random.default_rng(seed)
    U, I, N = 900, 700, 8192
    if case == "big_table":
        U = I = 200_000
    users = np.sort(rng.integers(0, U, N))
    pos = rng.integers(0, I, N)
    if case == "hot_item":
        pos[rng.permutation(N)[:5000]] = 17
    if case == "long_runs":
        users = np.sort(np.concatenate([np.full(2000, 5), np.full(100, 40),
                                        np.full(33, 41), np.full(32, 42),
                                        rng.integers(0, U, N - 2165)]))
    if case == "big_table":
        users = np.sort(rng.choice(U, 300)[rng.integers(0, 300, N)])
        pos = rng.choice(I, 250)[rng.integers(0, 250, N)]
    neg = rng.integers(0, I, N)
    if case == "big_table":
        neg = rng.choice(I, 250)[rng.integers(0, 250, N)]
    any_v = rng.random(N) < 0.8
    if case == "no_live":
        any_v[:] = False
    n_valid = {"n_valid_0": 0, "n_valid_N": N}.get(case, N - 37)
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)  # noqa
    return dict(
        P=t(0.3 * rng.standard_normal((U, d)), np.float32),
        Q=t(0.3 * rng.standard_normal((I, d)), np.float32),
        users=t(users, np.int32), pos=t(pos, np.int32),
        neg=t(neg, np.int32), any_v=t(any_v, np.bool_),
        w=t(rng.random(N) * 3, np.float32), n_valid=n_valid)


@pytest.mark.parametrize("d", [8, 64, 256, 300])
@pytest.mark.parametrize("case", ["hot_item", "long_runs", "no_live",
                                  "n_valid_0", "n_valid_N", "big_table"])
@pytest.mark.parametrize("sorted_users", [False, True])
def test_warp_accumulate_kernel_edge_cases(dev, d, case, sorted_users):
    """K12 against its plain version (1e-5 of the largest entry plus a
    float32 spacing, bitwise repeatable) where its design branches: rows
    longer than a warp's sort (a block per row), user runs across segments
    (partials added by the run's last piece), nothing live, and a table of
    200,000 rows of which the chunk touches a few hundred."""
    from buffalo_tpu_torch.ops import warp_kernels as W

    c = _k12_edge_case(dev, case, d)
    users = c["users"]
    if not sorted_users:
        users = users[torch.randperm(users.shape[0], device=dev)].contiguous()
    kw = dict(n_valid=c["n_valid"], score_func="l2" if d == 64 else "dot",
              reg_u=0.03, reg_i=0.02, reg_j=0.01, update_i=True,
              update_j=case != "hot_item", per_coordinate_normalize=True,
              users_sorted=sorted_users)
    outs = []
    for fn in (W.warp_accumulate, W.warp_accumulate, W.warp_accumulate_plain):
        acc = W.new_accumulators(c["P"], c["Q"])
        for a in acc:
            a.fill_(0.5)
        fn(c["P"], c["Q"], *acc, users, c["pos"], c["neg"], c["any_v"],
           c["w"], **kw)
        outs.append(acc)
    torch.cuda.synchronize()
    for g, g2, r in zip(*outs):
        assert torch.equal(g, g2)
        lim = 1e-5 * float((r - 0.5).abs().max()) + 2 ** -23
        assert float((g - r).abs().max()) <= lim
    if case in ("no_live", "n_valid_0"):
        assert all(bool((g == 0.5).all()) for g in outs[0])


def test_warp_violations_kernel_equals_plain(dev):
    from buffalo_tpu_torch.ops import warp_kernels as W

    c = _warp_case(dev, 40)
    rng = np.random.default_rng(2)
    trip = [torch.from_numpy(rng.integers(0, n, 999).astype(np.int32)).to(dev)
            for n in (c["P"].shape[0], c["I"], c["I"])]
    for sf in ("dot", "l2"):
        got = W.warp_violations(c["P"], c["Q"], *trip, score_func=sf,
                                threshold=0.5)
        ref = W.warp_violations_plain(c["P"], c["Q"], *trip, score_func=sf,
                                      threshold=0.5)
        assert float(got) == float(ref) and 0 < float(got) < 1


@pytest.mark.parametrize("optimizer", ["adam", "adagrad"])
@pytest.mark.parametrize("d", [13, 64, 256, 300])
def test_deferred_update_projection_matches_plain(dev, optimizer, d):
    """K10's projection mode: within 1e-6 of the plain version, and before
    the projection bitwise the elementwise mode's step."""
    from buffalo_tpu_torch.ops import sgd_kernels as S

    rng = torch.Generator(device=dev).manual_seed(4)
    P = 0.5 * torch.randn((999, d), generator=rng, device=dev)
    g = torch.randn((999, d), generator=rng, device=dev)
    m = 0.1 * torch.randn((999, d), generator=rng, device=dev)
    v = 0.1 * torch.rand((999, d), generator=rng, device=dev)
    cnt = torch.randint(0, 5, (999,), generator=rng, device=dev).float()
    kw = dict(step=2, optimizer=optimizer, lr=0.3, beta1=0.9, beta2=0.999,
              reg=0.01, per_coordinate_normalize=True)
    runs = [[t.clone() for t in (P, g, m, v)] for _ in range(3)]
    S.deferred_update(*runs[0], cnt, project=True, **kw)
    S.deferred_update_plain(*runs[1], cnt, project=True, **kw)
    S.deferred_update(*runs[2], cnt, project=False, **kw)
    torch.cuda.synchronize()
    for a, b in zip(runs[0], runs[1]):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-7)
    for a, b in zip(runs[0][1:], runs[2][1:]):
        assert torch.equal(a, b)
    norms = runs[2][0].norm(dim=1, keepdim=True).clamp(min=1.0)
    assert torch.allclose(runs[0][0], runs[2][0] / norms, rtol=1e-6,
                          atol=1e-7)
    assert float(runs[2][0].norm(dim=1).max()) > 1


# ------------------------------------------------------------------ eALS
def _eals_case(dev, d, nx=500, ny=300, seed=0):
    rng = np.random.default_rng(seed)
    X = torch.tensor(0.2 * rng.standard_normal((nx, d)), dtype=torch.float32,
                     device=dev)
    Y = torch.tensor(0.2 * rng.standard_normal((ny, d)), dtype=torch.float32,
                     device=dev)
    C = torch.tensor(rng.uniform(0.05, 0.5, max(nx, ny)), dtype=torch.float32,
                     device=dev)
    S = (Y.T @ Y).contiguous()
    return rng, X, Y, C, S


def _rel_close(got, ref, tol=1e-4):
    return float((got - ref).abs().max()) <= tol * float(ref.abs().max())


@pytest.mark.parametrize("d", [13, 40, 128, 256, 300])
@pytest.mark.parametrize("L", [8, 96, 1024, 8192])
@pytest.mark.parametrize("item_axis", [False, True])
def test_dim_sweep_range_kernel_matches_plain(dev, d, L, item_axis):
    from buffalo_tpu_torch.data.batching import RangeBatch
    from buffalo_tpu_torch.ops import eals_kernels as E

    rng, X, Y, C, S = _eals_case(dev, d, ny=300 if L < 1024 else 20000)
    B = 40 if L < 8192 else 6
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    cols = rng.integers(0, Y.shape[0], (B, L)).astype(np.int32)
    vals = (rng.integers(1, 5, (B, L)) * (np.arange(L) < lens[:, None]))
    batch = RangeBatch(17, *[torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                             for a in (lens, cols, vals.astype(np.float32))])
    got, ref, jac = X.clone(), X.clone(), X.clone()
    kw = dict(item_axis=item_axis, alpha=8.0, reg=0.1)
    E.dim_sweep(got, Y, S, C, batch=batch, **kw)
    E.range_sweep_plain(ref, Y, S, C, 17, *batch[1:], **kw)
    E.range_sweep_plain(jac, Y, S, C, 17, *batch[1:], jacobi=True, **kw)
    torch.cuda.synchronize()
    assert _rel_close(got, ref)
    assert not _rel_close(jac, ref)


@pytest.mark.parametrize("d", [13, 40, 256, 300])
@pytest.mark.parametrize("item_axis", [False, True])
def test_dim_sweep_segment_and_rows_kernels_match_plain(dev, d, item_axis):
    from buffalo_tpu_torch.data.batching import SegmentBatch, stage_batch
    from buffalo_tpu_torch.ops import eals_kernels as E

    rng, X, Y, C, S = _eals_case(dev, d)
    n = X.shape[0]
    rows = np.array([5, 300, n + 3], np.int32)
    lens = np.array([700, 200, 0], np.int32)
    seg_ids = np.array([0, 0, 0, 1, 3], np.int32)
    chunk_lens = np.array([256, 256, 188, 200, 0], np.int32)
    cols = rng.integers(0, Y.shape[0], (5, 256)).astype(np.int32)
    vals = (rng.integers(1, 5, (5, 256)) * (np.arange(256)
                                             < chunk_lens[:, None]))
    batch = stage_batch(SegmentBatch(rows, lens, seg_ids, chunk_lens, cols,
                                     vals.astype(np.float32)), dev)
    kw = dict(item_axis=item_axis, alpha=8.0, reg=0.1)
    got, ref = X.clone(), X.clone()
    E.dim_sweep(got, Y, S, C, batch=batch, **kw)
    E.segment_sweep_plain(ref, Y, S, C, batch, **kw)
    assert _rel_close(got, ref)
    # rows mode, residuals carried
    deg = rng.integers(0, 40, n)
    indptr = torch.tensor(np.concatenate([[0], np.cumsum(deg)]),
                          dtype=torch.int64, device=dev)
    keys = torch.tensor(rng.integers(0, Y.shape[0], int(deg.sum())),
                        dtype=torch.int32, device=dev)
    vv = torch.tensor(rng.integers(1, 5, int(deg.sum())), dtype=torch.float32,
                      device=dev)
    vh = 0.01 * torch.randn(int(deg.sum()), device=dev)
    a = [X.clone(), vh.clone()]
    b = [X.clone(), vh.clone()]
    E.eals_half_epoch(a[0], Y, a[1], indptr, keys, vv, C, S, **kw)
    E.rows_sweep_plain(b[0], Y, S, C, indptr, keys, vv, b[1], **kw)
    torch.cuda.synchronize()
    assert _rel_close(a[0], b[0]) and _rel_close(a[1], b[1])


@pytest.mark.parametrize("d", [13, 40, 64, 127, 128, 129])
@pytest.mark.parametrize("L", [8, 96, 1024, 8192])
@pytest.mark.parametrize("item_axis", [False, True])
def test_dim_sweep_range_forms_match_plain(dev, d, L, item_axis):
    """K13 on a range batch in the form its rule picks: the Gram form up
    to its edge (128), the sweep form at the first width past it; 1e-4
    relative of the plain version, a Jacobi sweep failing that, repeat
    launches bitwise equal."""
    from buffalo_tpu_torch.data.batching import RangeBatch
    from buffalo_tpu_torch.ops import eals_kernels as E

    rng, X, Y, C, S = _eals_case(dev, d, ny=300 if L < 1024 else 20000)
    B = 40 if L < 8192 else 6
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    lens[:2] = (0, 1)
    cols = rng.integers(0, Y.shape[0], (B, L)).astype(np.int32)
    vals = (rng.integers(1, 5, (B, L)) * (np.arange(L) < lens[:, None]))
    batch = RangeBatch(17, *[torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                             for a in (lens, cols, vals.astype(np.float32))])
    kw = dict(item_axis=item_axis, alpha=8.0, reg=0.1)
    got, again, ref, jac = X.clone(), X.clone(), X.clone(), X.clone()
    before = E.dim_sweep.launches
    E.dim_sweep(got, Y, S, C, batch=batch, **kw)
    E.dim_sweep(again, Y, S, C, batch=batch, **kw)
    E.range_sweep_plain(ref, Y, S, C, 17, *batch[1:], **kw)
    E.range_sweep_plain(jac, Y, S, C, 17, *batch[1:], jacobi=True, **kw)
    torch.cuda.synchronize()
    assert E.dim_sweep.launches == before + 2
    assert torch.equal(got, again)
    assert _rel_close(got, ref)
    assert not _rel_close(jac, ref)
    assert torch.equal(got[:17], X[:17]) and torch.equal(got[17 + B:],
                                                          X[17 + B:])


def _eals_segment(dev, rng, X, Y, chunks, C=256):
    """A staged segment batch: head rows 5 (chunks[0] full chunks and one
    of 77 entries), 300 (one chunk of C), 41 (one chunk of 3) and a row
    past the table (dropped), then two padding chunks."""
    from buffalo_tpu_torch.data.batching import SegmentBatch, stage_batch

    n = X.shape[0]
    rows = np.array([5, 300, 41, n + 3], np.int32)
    per_row = [[C] * chunks + [77], [C], [3], [C]]
    lens = np.array([sum(r) for r in per_row[:3]] + [0], np.int32)
    seg_ids = np.array([r for r, cl in enumerate(per_row) for _ in cl]
                       + [4, 4], np.int32)
    chunk_lens = np.array([c for cl in per_row for c in cl] + [0, 0],
                          np.int32)
    cols = rng.integers(0, Y.shape[0], (len(chunk_lens), C)).astype(np.int32)
    vals = (rng.integers(1, 5, cols.shape)
            * (np.arange(C) < chunk_lens[:, None])).astype(np.float32)
    return stage_batch(SegmentBatch(rows, lens, seg_ids, chunk_lens, cols,
                                    vals), dev)


@pytest.mark.parametrize("d", [13, 40, 128, 129])
@pytest.mark.parametrize("chunks", [1, 40])
@pytest.mark.parametrize("width", [256, 4096])
@pytest.mark.parametrize("item_axis", [False, True])
def test_dim_sweep_segment_forms_match_plain(dev, d, chunks, width,
                                             item_axis):
    """K13's segment mode in the form its rule picks (the Gram form up to
    128, the sweep form past it): a head row of 1 or 40 full chunks plus a
    short one, rows of one chunk, a row past the table dropped, chunks
    that fit one block and chunks cut into pieces; 1e-4 relative, Jacobi
    failing, repeatable, rows outside the batch untouched."""
    from buffalo_tpu_torch.ops import eals_kernels as E

    rng, X, Y, C, S = _eals_case(dev, d, ny=3000)
    batch = _eals_segment(dev, rng, X, Y, chunks, C=width)
    kw = dict(item_axis=item_axis, alpha=8.0, reg=0.1)
    ref, jac = X.clone(), X.clone()
    E.segment_sweep_plain(ref, Y, S, C, batch, **kw)
    E.segment_sweep_plain(jac, Y, S, C, batch, jacobi=True, **kw)
    got, again = X.clone(), X.clone()
    E.dim_sweep(got, Y, S, C, batch=batch, **kw)
    E.dim_sweep(again, Y, S, C, batch=batch, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _rel_close(got, ref)
    keep = torch.ones(X.shape[0], dtype=torch.bool, device=dev)
    keep[[5, 300, 41]] = False
    assert torch.equal(got[keep], X[keep])
    assert not _rel_close(jac, ref)


def test_dim_sweep_form_rule(dev):
    """The wrapper's rule and the C launcher agree on the Gram form's
    widest rows and its workspace; the rows mode and wider rows take the
    sweep form."""
    import ctypes

    from buffalo_tpu_torch.ops import eals_kernels as E
    from buffalo_tpu_torch.ops._build import launcher

    f = launcher("eals_gram_max_d", [], library="eals_sweep")
    assert f() == E.GRAM_MAX_D
    ws = launcher("eals_gram_workspace", [ctypes.c_int] * 4,
                  library="eals_sweep")
    # range rows that fit one block need none; longer ones and segment
    # chunks a partial per piece of at least 1,024 entries, more pieces
    # where the batch has few units
    assert ws(0, 3, 2048, 40) == 0 and ws(0, 3, 2056, 40) == 3 * 3 * 40 * 41
    assert ws(1, 3, 8192, 40) == 3 * 8 * 40 * 41 and ws(1, 3, 8192, 129) == 0
    assert ws(1, 400, 8192, 40) == 400 * 2 * 40 * 41
    assert [E.dim_sweep_form(d, object()) for d in (1, 128, 129)] == [
        "gram", "gram", "sweep"]
    assert E.dim_sweep_form(40, None) == "sweep"


@pytest.mark.parametrize("d", [13, 40, 256, 300])
def test_eals_residual_kernel_matches_plain(dev, d):
    from buffalo_tpu_torch.ops import eals_kernels as E

    rng, P, Q, C, _ = _eals_case(dev, d)
    n = 100003
    rows = torch.tensor(rng.integers(0, P.shape[0], n), dtype=torch.int32,
                        device=dev)
    keys = torch.tensor(rng.integers(0, Q.shape[0], n), dtype=torch.int32,
                        device=dev)
    vals = torch.tensor(rng.integers(1, 5, n), dtype=torch.float32,
                        device=dev)
    v_got = E.compute_vhat(P, Q, rows, keys)
    v_ref, s_ref = E.eals_residual_plain(P, Q, rows, keys, vals, C,
                                         alpha=8.0)
    _, s_got = E.eals_residual(P, Q, rows, keys, vals, C, alpha=8.0)
    _, s_given = E.eals_residual(P, Q, rows, keys, vals, C, alpha=8.0,
                                 vhat=v_ref)
    _, s_again = E.eals_residual(P, Q, rows, keys, vals, C, alpha=8.0)
    torch.cuda.synchronize()
    assert _rel_close(v_got, v_ref, 1e-6)
    assert torch.allclose(s_got, s_ref, rtol=1e-5)
    assert torch.allclose(s_given, s_ref, rtol=1e-5)
    assert torch.equal(s_got, s_again)


def _k14_view(dev, rng, nx, ny, n):
    """A loss view in row order with Zipf-skewed columns (a hot head)."""
    rows = np.sort(rng.integers(0, nx, n)).astype(np.int32)
    keys = (rng.zipf(1.3, n) % ny).astype(np.int32)
    vals = rng.integers(1, 5, n).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (rows, keys, vals)]


@pytest.mark.parametrize("d", [1, 13, 40, 64, 256, 300])
@pytest.mark.parametrize("aligned", [True, False])
def test_eals_residual_view_matches_plain(dev, d, aligned):
    """K14 on a row-ordered view with a Zipf head (float4 loads, or floats
    where d % 4 or a table's address forbids: the same values one float
    into a larger buffer) against its plain version: residuals 1e-6,
    sums 1e-5, two launches bitwise equal; the sums from given residuals
    likewise."""
    from buffalo_tpu_torch.ops import eals_kernels as E

    rng, P, Q, C, _ = _eals_case(dev, d, nx=2000, ny=3000, seed=d)
    if not aligned:
        P, Q = (torch.cat([torch.zeros(1, device=dev), t.reshape(-1)])[1:]
                .reshape(t.shape) for t in (P, Q))
    C = torch.tensor(rng.uniform(0.05, 0.5, 3000), dtype=torch.float32,
                     device=dev)
    rows, keys, vals = _k14_view(dev, rng, 2000, 3000, 200_003)
    v_ref, s_ref = E.eals_residual_plain(P, Q, rows, keys, vals, C,
                                         alpha=8.0)
    v = [E.compute_vhat(P, Q, rows, keys) for _ in range(2)]
    s = [E.eals_residual(P, Q, rows, keys, vals, C, alpha=8.0)[1]
         for _ in range(2)]
    given = E.eals_residual(P, Q, rows, keys, vals, C, alpha=8.0,
                            vhat=v_ref)[1]
    torch.cuda.synchronize()
    assert _rel_close(v[0], v_ref, 1e-6)
    assert torch.allclose(s[0], s_ref, rtol=1e-5)
    assert torch.allclose(given, s_ref, rtol=1e-5)
    assert torch.equal(v[0], v[1]) and torch.equal(s[0], s[1])


def _k6_edges(dev, d, kk, l_cap=256, bq=64, seed=0):
    """K6 tiles at every class edge (chip_smoke.k6_tiles' shapes): empty,
    one row, fewer rows than kk, the small form's bound and one past it,
    l_cap rows, the table's last rows, an all-masked tile, random ones."""
    from buffalo_tpu_torch.ops import retrieval_kernels as R

    rng = np.random.default_rng(seed)
    B, N = 500, 3000
    edge = R.ivf_small_rows(d, kk)
    ln = [0, 1, max(kk - 1, 1), l_cap, 5] + ([edge, edge + 1] if edge
                                             else [])
    T = len(ln) + 24
    ln = np.array(ln + list(rng.integers(0, l_cap + 1, T - len(ln))),
                  dtype=np.int32)
    lo = rng.integers(0, N - l_cap, size=T).astype(np.int32)
    lo[4] = N - 5
    qmask = rng.random((T, bq)) < 0.8
    qmask[-1] = False
    qidx = rng.integers(0, B, size=(T, bq)).astype(np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (
        rng.standard_normal((B, d), dtype=np.float32),
        rng.standard_normal((N, d), dtype=np.float32), qidx, qmask, lo, ln)]
    return args, ln


@pytest.mark.parametrize("d", [1, 4, 13, 40, 100, 256, 300])
@pytest.mark.parametrize("kk", [1, 10, 32, 33])
def test_ivf_tile_forms_match_plain(dev, d, kk):
    """K6's small form and scan, each on its class of tiles (counted per
    form), against the plain version; two calls bitwise equal; each form's
    tiles with their last quarter of rows (at least one) dropped fail the
    check (a last row alone can miss every slot's top 1 at d = 1)."""
    from buffalo_tpu_torch.ops import retrieval_kernels as R

    args, ln = _k6_edges(dev, d, kk, seed=d + kk)
    small, scan = R.ivf_tile_classes(ln, R.ivf_small_rows(d, kk))
    counts = (R.ivf_tile_topk.small_launches, R.ivf_tile_topk.scan_launches)
    got = R.ivf_tile_topk(*args, kk, 256, ln_host=ln)
    again = R.ivf_tile_topk(*args, kk, 256, ln_host=ln)
    with pytest.raises(ValueError, match="ln_host"):
        R.ivf_tile_topk(*args, kk, 256)  # no host copy of ln: no sync
    torch.cuda.synchronize()
    assert (R.ivf_tile_topk.small_launches - counts[0],
            R.ivf_tile_topk.scan_launches - counts[1]) == (
                2 * int(len(small) > 0), 2 * int(len(scan) > 0))
    assert (kk > 32 or d < R.IVF_SMALL_MIN_D) == (len(small) == 0)
    ref = R.ivf_tile_topk_plain(*args, kk, 256)
    T = ln.shape[0]
    _topk_close(*((x.reshape(T * 64, kk) for x in o) for o in (got, ref)))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(torch.isinf(got[0]), torch.isinf(ref[0]))
    for tiles in (small, scan):
        sel = tiles[ln[tiles] > 0]
        if not len(sel):
            continue
        cut = ln.copy()
        cut[sel] -= np.maximum(1, ln[sel] // 4)
        bad = R.ivf_tile_topk(*args[:5], torch.from_numpy(cut).to(dev), kk,
                              256, ln_host=ln)
        t = torch.from_numpy(sel).to(dev).long()
        assert not torch.allclose(bad[0][t], ref[0][t], rtol=1e-5,
                                  atol=1e-6) or not torch.equal(
                                      bad[1][t], ref[1][t])


@pytest.mark.parametrize("d", [32, 40, 100, 256])
def test_ivf_small_form_is_the_scan_bit_for_bit(dev, d, monkeypatch):
    """The small form sums each score as the scan does (from 0, one fmaf
    a feature in order): with every tile sent to the scan
    (IVF_SMALL_MAX_L = 0) the outputs are the same bits."""
    from buffalo_tpu_torch.ops import retrieval_kernels as R

    args, ln = _k6_edges(dev, d, 10, seed=d)
    assert len(R.ivf_tile_classes(ln, R.ivf_small_rows(d, 10))[0]) > 0
    got = R.ivf_tile_topk(*args, 10, 256, ln_host=ln)
    monkeypatch.setattr(R, "IVF_SMALL_MAX_L", 0)
    before = R.ivf_tile_topk.small_launches
    scan = R.ivf_tile_topk(*args, 10, 256, ln_host=ln)
    assert R.ivf_tile_topk.small_launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, scan))


@pytest.mark.parametrize("max_rows", [0, 1, 64, 256, 4096])
def test_ivf_small_rows_fits_the_staging(dev, max_rows, monkeypatch):
    """The small form's row cap (the C query): 0 below IVF_SMALL_MIN_D,
    past kk = 32 or with a cap of 0; else at most the cap, its staging
    (the rows and 8 warps x 8 query rows, at the wider of the float and
    float4 strides, each padded to an odd count of its units) within 227
    KB of shared memory, and one row more past it or past the cap."""
    from buffalo_tpu_torch.ops import retrieval_kernels as R

    monkeypatch.setattr(R, "IVF_SMALL_MAX_L", max_rows)
    for d in (1, 3, 4, 13, 32, 40, 100, 128, 256, 300, 512, 1000, 2000):
        s = max(d if d % 2 else d + 1,
                (d if (d // 4) % 2 else d + 4) if d % 4 == 0 else 0)

        def fits(rows):
            return 4 * s * (rows + 64) <= 227 * 1024
        for kk in (1, 10, 32, 33):
            rows = R.ivf_small_rows(d, kk)
            if d < R.IVF_SMALL_MIN_D or kk > 32 or max_rows == 0 \
                    or not fits(1):
                assert rows == 0, (d, kk)
                continue
            assert 1 <= rows <= max_rows and fits(rows), (d, kk)
            assert rows == max_rows or not fits(rows + 1), (d, kk)


# ------------------------------------------------------- top-k past 1024
def test_batch_topn_past_1024_on_the_card(dev):
    """k = 2,000 takes the matmul route and returns numpy's ids with ties by
    index (a table with duplicated rows)."""
    from buffalo_tpu_torch.ops import retrieval_kernels as R
    from buffalo_tpu_torch.ops.topk import batch_topn

    rng = np.random.default_rng(3)
    Q = rng.standard_normal((5000, 40)).astype(np.float32)
    Q[2500:3000] = Q[:500]
    p = rng.integers(-2, 3, (64, 40)).astype(np.float32)
    Q = np.round(Q * 4) / 4
    before = R.score_topk.launches
    ids, scores = batch_topn(p, Q, 2000, device="cuda")
    assert R.score_topk.launches == before
    s = p.astype(np.float64) @ Q.T.astype(np.float64)
    want = np.lexsort((np.arange(5000)[None, :].repeat(64, 0), -s),
                      axis=1)[:, :2000]
    np.testing.assert_array_equal(ids, want)
    ids10, _ = batch_topn(p, Q, 10, device="cuda")
    assert R.score_topk.launches == before + 1
    np.testing.assert_array_equal(ids10, want[:, :10])


# ------------------------------------------------------------------ pLSI
def _plsi_tables(dev, d, nx=600, ny=400, seed=0, sparse=False):
    """Row-stochastic X and column-stochastic Y (pLSI's P and Q); sparse:
    Dirichlet(0.02) rows and columns, so that many latent products fall
    below the element floor (1e-10) and some norms below the summed one."""
    rng = np.random.default_rng(seed)
    if sparse:
        X = rng.dirichlet(np.full(d, 0.02), nx)
        Y = rng.dirichlet(np.full(ny, 0.02), d).T
    else:
        X = np.abs(rng.normal(size=(nx, d)))
        Y = np.abs(rng.normal(size=(ny, d)))
    X = np.ascontiguousarray(X / X.sum(1, keepdims=True), np.float32)
    Y = np.ascontiguousarray(Y / Y.sum(0, keepdims=True), np.float32)
    return rng, torch.from_numpy(X).to(dev), torch.from_numpy(Y).to(dev)


def _plsi_batch(dev, rng, B, L, ny, rows=None):
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    lens[0] = 0
    cols = rng.integers(0, ny, (B, L)).astype(np.int32)
    vals = (rng.integers(1, 5, (B, L))
            * (np.arange(L)[None, :] < lens[:, None])).astype(np.float32)
    out = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
           for a in (lens, cols, vals)]
    if rows is not None:
        out = [torch.from_numpy(rows).to(dev)] + out
    return out


@pytest.mark.parametrize("d", [8, 20, 40, 64, 256, 300])
@pytest.mark.parametrize("L", [8, 96, 1024, 8192])
@pytest.mark.parametrize("sparse", [False, True])
def test_plsi_estep_range_kernel_matches_plain(dev, d, L, sparse):
    from buffalo_tpu_torch.data.batching import RangeBatch
    from buffalo_tpu_torch.ops import plsi_kernels as PK

    rng, X, Y = _plsi_tables(dev, d, ny=400 if L < 1024 else 20000,
                             sparse=sparse)
    B = 40 if L < 8192 else 6
    lens, cols, vals = _plsi_batch(dev, rng, B, L, Y.shape[0])
    batch = RangeBatch(17, lens, cols, vals)
    got, again, ref, wrong = (torch.zeros_like(X) for _ in range(4))
    before = PK.plsi_estep.launches
    loss = PK.plsi_estep(got, X, Y, batch)
    PK.plsi_estep(again, X, Y, batch)
    want = PK.estep_range_plain(ref, X, Y, 17, lens, cols, vals)
    torch.cuda.synchronize()
    assert PK.plsi_estep.launches == before + 2
    assert torch.equal(got, again)
    assert _rel_close(got, ref, 1e-5)
    assert torch.allclose(loss, want, rtol=1e-5, atol=1e-6)
    assert PK.plsi_estep(X.clone(), X, Y, batch, with_loss=False) is None
    if sparse:
        # the element floor (the padded path's) is another function here
        PK.estep_padded_plain(wrong, torch.zeros_like(Y), X, Y,
                              batching.PaddedBatch(
                                  torch.arange(17, 17 + B, device=dev,
                                               dtype=torch.int32),
                                  lens, cols, vals))
        assert not _rel_close(wrong, ref, 1e-5)


def _plsi_segment(dev, rng, ny, n, C=256):
    from buffalo_tpu_torch.data.batching import SegmentBatch, stage_batch

    rows = np.array([5, 300, n + 3], np.int32)
    lens = np.array([700, 200, 0], np.int32)
    seg_ids = np.array([0, 0, 0, 1, 3], np.int32)
    chunk_lens = np.array([256, 256, 188, 200, 0], np.int32)
    cols = rng.integers(0, ny, (5, C)).astype(np.int32)
    vals = (rng.integers(1, 5, (5, C))
            * (np.arange(C) < chunk_lens[:, None])).astype(np.float32)
    return stage_batch(SegmentBatch(rows, lens, seg_ids, chunk_lens, cols,
                                    vals), dev)


@pytest.mark.parametrize("d", [8, 20, 64, 256, 300])
def test_plsi_estep_segment_and_padded_kernels_match_plain(dev, d):
    from buffalo_tpu_torch.ops import plsi_kernels as PK

    rng, X, Y = _plsi_tables(dev, d, sparse=d == 20)
    n = X.shape[0]
    seg = _plsi_segment(dev, rng, Y.shape[0], n)
    got, ref = torch.zeros_like(X), torch.zeros_like(X)
    l_got = PK.plsi_estep(got, X, Y, seg)
    l_ref = PK.estep_segment_plain(ref, X, Y, seg)
    torch.cuda.synchronize()
    assert _rel_close(got, ref, 1e-5)
    assert torch.allclose(l_got, l_ref, rtol=1e-5, atol=1e-6)
    # padded mode: a PaddedBatch (padding rows past the table) and the
    # segment batch, both tables accumulated
    rows = rng.permutation(n)[:50].astype(np.int32)
    rows[[3, 9]] = n
    padded = batching.PaddedBatch(*_plsi_batch(dev, rng, 50, 33, Y.shape[0],
                                               rows=rows))
    for batch in (padded, seg):
        tabs = [torch.zeros_like(X), torch.zeros_like(Y)]
        runs = [[t.clone() for t in tabs] for _ in range(3)]
        l0 = PK.plsi_estep(runs[0][0], X, Y, batch, padded=True,
                           Qn=runs[0][1])
        PK.plsi_estep(runs[2][0], X, Y, batch, padded=True, Qn=runs[2][1])
        l1 = PK.estep_padded_plain(runs[1][0], runs[1][1], X, Y, batch)
        torch.cuda.synchronize()
        for a, b in zip(runs[0], runs[1]):
            assert _rel_close(a, b, 1e-5)
        assert torch.allclose(l0, l1, rtol=1e-5, atol=1e-6)
        assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[2]))


# K15's shape rules patched so that a batch takes one form: the team form
# (groups sharing warps on short rows), one lane an entry, lanes on the
# columns
_K15_FORMS = {"default": {}, "team": {"ENTRIES_MIN_L": 1 << 30},
              "entries": {"ENTRIES_MIN_L": 1},
              "columns": {"TEAM_MAX_D": 0, "SEGMENT_TEAM_MAX_D": 0}}


def _k15_check(PK, X, Y, batch, padded=False):
    """K15 twice and its plain version on one batch: sums within 1e-5 of
    the largest, losses within 1e-5, the two launches bitwise equal."""
    seg = isinstance(batch, batching.StagedSegmentBatch)
    runs = [[torch.zeros_like(X), torch.zeros_like(Y)] for _ in range(3)]
    kw = [dict(padded=True, Qn=r[1]) if padded else {} for r in runs]
    l0 = PK.plsi_estep(runs[0][0], X, Y, batch, **kw[0])
    l1 = PK.plsi_estep(runs[1][0], X, Y, batch, **kw[1])
    if padded:
        ref = PK.estep_padded_plain(runs[2][0], runs[2][1], X, Y, batch)
    elif seg:
        ref = PK.estep_segment_plain(runs[2][0], X, Y, batch)
    else:
        ref = PK.estep_range_plain(runs[2][0], X, Y, int(batch.row_start),
                                   batch.lens, batch.cols, batch.vals)
    torch.cuda.synchronize()
    for k in range(2 if padded else 1):
        assert _rel_close(runs[0][k], runs[2][k], 1e-5)
        assert torch.equal(runs[0][k], runs[1][k])
    assert torch.allclose(l0, ref, rtol=1e-5, atol=1e-6)
    assert torch.equal(l0, l1)


@pytest.mark.parametrize("d", [13, 20, 64, 128])
@pytest.mark.parametrize("form", sorted(_K15_FORMS))
def test_plsi_estep_forms_match_plain(dev, d, form):
    """Each form of K15 at the widths where the forms change: a range
    batch of short rows (width 12: up to eight rows a warp), one of rows
    around a warp (width 40, rows of 0-40 entries), one past
    ENTRIES_MIN_L, the segment batch and a padded batch."""
    from buffalo_tpu_torch.data.batching import RangeBatch
    from buffalo_tpu_torch.ops import plsi_kernels as PK

    rng, X, Y = _plsi_tables(dev, d, sparse=d == 20)
    n = X.shape[0]
    real = {k: getattr(PK, k) for k in _K15_FORMS[form]}
    for k, v in _K15_FORMS[form].items():
        setattr(PK, k, v)
    try:
        for B, L in ((300, 12), (150, 40), (20, 300)):
            lens, cols, vals = _plsi_batch(dev, rng, B, L, Y.shape[0])
            _k15_check(PK, X, Y, RangeBatch(3, lens, cols, vals))
        _k15_check(PK, X, Y, _plsi_segment(dev, rng, Y.shape[0], n))
        rows = rng.permutation(n)[:60].astype(np.int32)
        rows[[3, 9]] = n
        _k15_check(PK, X, Y, batching.PaddedBatch(*_plsi_batch(
            dev, rng, 60, 33, Y.shape[0], rows=rows)), padded=True)
    finally:
        for k, v in real.items():
            setattr(PK, k, v)


@pytest.mark.parametrize("d", [13, 20, 64])
def test_plsi_estep_unaligned_tables_take_4_byte_loads(dev, d):
    """Tables at an address off 16 bytes take the 4-byte loads (of the
    team form); the same sums."""
    from buffalo_tpu_torch.data.batching import RangeBatch
    from buffalo_tpu_torch.ops import plsi_kernels as PK

    rng, X, Y = _plsi_tables(dev, d)
    buf = torch.zeros(X.numel() + 1, device=dev)
    Xs = buf[1:].view(X.shape)
    Xs.copy_(X)
    assert PK.estep_vec(d, Xs, Y) == 1
    for B, L in ((300, 12), (20, 300)):
        lens, cols, vals = _plsi_batch(dev, rng, B, L, Y.shape[0])
        batch = RangeBatch(3, lens, cols, vals)
        got, ref = torch.zeros_like(X), torch.zeros_like(X)
        PK.plsi_estep(got, Xs, Y, batch)
        PK.estep_range_plain(ref, X, Y, 3, lens, cols, vals)
        torch.cuda.synchronize()
        assert _rel_close(got, ref, 1e-5)


@pytest.mark.parametrize("d", [8, 20, 64, 256, 300])
@pytest.mark.parametrize("masked", [False, True])
def test_plsi_mstep_kernel_matches_plain(dev, d, masked):
    from buffalo_tpu_torch.ops import plsi_kernels as PK

    rng = np.random.default_rng(d)
    Pn = torch.tensor(rng.random((3001, d)), dtype=torch.float32, device=dev)
    Qn = torch.tensor(rng.random((70001, d)), dtype=torch.float32,
                      device=dev)
    Pn[7] = 0
    Qn[:, 1] = 0
    kw = dict(alpha1=0.0, alpha2=0.0) if d == 8 else dict(alpha1=1.0,
                                                         alpha2=1.0)
    if masked:
        kw.update(p_mask=(torch.rand(3001, device=dev) > 0.1).float(),
                  q_mask=(torch.rand(70001, device=dev) > 0.1).float(),
                  num_items=60000)
    got = [Pn.clone(), Qn.clone()]
    ref = [Pn.clone(), Qn.clone()]
    PK.plsi_mstep(*got, **kw)
    PK.mstep_plain(*ref, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.isfinite(a).all()
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-9)
    if d == 8:
        assert torch.equal(got[0][7], torch.zeros(d, device=dev))
        assert torch.equal(got[1][:, 1], torch.zeros(70001, device=dev))


# ------------------------------------------------------------------- CFR
def _cfr_tables(dev, d, n=500, seed=0):
    rng = np.random.default_rng(seed)
    t = [torch.tensor(0.3 * rng.standard_normal((n, d)), dtype=torch.float32,
                      device=dev) for _ in range(3)]
    b = [torch.tensor(0.1 * rng.standard_normal(n), dtype=torch.float32,
                      device=dev) for _ in range(2)]
    return rng, t, b


def _cfr_padded_side(dev, rng, table, B, L, lens=None):
    from buffalo_tpu_torch.ops.cfr_kernels import Side

    if lens is None:
        lens = rng.integers(0, L + 1, B).astype(np.int32)
    cols = rng.integers(0, table.shape[0], (B, L)).astype(np.int32)
    vals = (rng.integers(1, 6, (B, L))
            * (np.arange(L)[None, :] < lens[:, None])).astype(np.float32)
    return Side(table, *[torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                         for a in (lens, cols, vals)])


def _cfr_segment_side(dev, rng, table, chunk_lens, seg_ids, R, C=64):
    from buffalo_tpu_torch.data.batching import segment_chunk_ptr
    from buffalo_tpu_torch.ops.cfr_kernels import Side

    chunk_lens = np.asarray(chunk_lens, np.int32)
    seg_ids = np.asarray(seg_ids, np.int32)
    lens = np.zeros(R, np.int32)
    np.add.at(lens, seg_ids[seg_ids < R], chunk_lens[seg_ids < R])
    cols = rng.integers(0, table.shape[0], (len(chunk_lens), C)).astype(
        np.int32)
    vals = (rng.integers(1, 6, (len(chunk_lens), C))
            * (np.arange(C) < chunk_lens[:, None])).astype(np.float32)
    arrs = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
            (lens, cols, vals, segment_chunk_ptr(seg_ids, R), chunk_lens)]
    return Side(table, *arrs)


def _cfr_phases(dev, d, rng, tabs, biases, segment):
    """(name, kwargs of cfr_normal_equations, rows) of the three phases."""
    from buffalo_tpu_torch.ops.cfr_kernels import (LOSS_EXPLICIT,
                                                   LOSS_IMPLICIT, LOSS_REG)

    U, I, C = tabs
    Ib, Cb = biases
    n = U.shape[0]
    if segment:
        R = 4
        rows = np.array([5, 17, 300, n], np.int32)

        def side(t, lens):
            return _cfr_segment_side(dev, rng, t, lens,
                                     [0, 0, 1, 2, 2, 2, 4][:len(lens)], R)
        imp = side(U, [64, 10, 0, 64, 64, 3, 0])
        exp = side(C, [64, 5, 0, 0, 0, 0, 0])
        ctx = side(I, [64, 64, 7, 64, 1, 2, 0])
    else:
        R = 37
        rows = rng.permutation(n)[:R].astype(np.int32)
        rows[[4, 30]] = n
        imp = _cfr_padded_side(dev, rng, U, R, 40)
        lens_c = rng.integers(0, 24, R).astype(np.int32)
        lens_c[[1, 2]] = 0
        exp = _cfr_padded_side(dev, rng, C, R, 24, lens_c)
        ctx = _cfr_padded_side(dev, rng, I, R, 24)
    rows = torch.from_numpy(rows).to(dev)
    FF = (U.T @ U).contiguous()
    return [
        ("user", dict(implicit=imp._replace(table=I), FF=(I.T @ I)
                      .contiguous(), alpha=8.0, l=1.5, reg=0.1), rows),
        ("item", dict(implicit=imp, explicit=exp, FF=FF, rbias=Ib,
                      cbias=Cb, alpha=8.0, l=1.5, reg=0.1,
                      loss=LOSS_IMPLICIT | LOSS_EXPLICIT | LOSS_REG), rows),
        ("context", dict(explicit=ctx, rbias=Cb, cbias=Ib, reg=0.1,
                         loss=LOSS_REG), rows),
    ]


@pytest.mark.parametrize("d", [8, 13, 32, 40, 64, 100, 128, 160, 300])
@pytest.mark.parametrize("segment", [False, True])
def test_cfr_normal_equations_kernel_matches_plain(dev, d, segment):
    from buffalo_tpu_torch.ops import cfr_kernels as CK

    rng, tabs, biases = _cfr_tables(dev, d)
    X = {"user": tabs[0], "item": tabs[1], "context": tabs[2]}
    for name, kw, rows in _cfr_phases(dev, d, rng, tabs, biases, segment):
        before = CK.cfr_normal_equations.launches
        got = CK.cfr_normal_equations(X[name], rows, **kw)
        again = CK.cfr_normal_equations(X[name], rows, **kw)
        ref = CK.cfr_normal_equations_plain(X[name], rows, **kw)
        torch.cuda.synchronize()
        assert CK.cfr_normal_equations.launches == before + 2
        assert all(torch.equal(a, b) for a, b in zip(got, again)), name
        for a, b in zip(got[:2], ref[:2]):
            assert _rel_close(a, b, 1e-4), name
        assert torch.allclose(got[2], ref[2], rtol=1e-4, atol=1e-5), name
        assert torch.equal(got[3], ref[3]), name
        if name == "item":
            # the explicit term is part of the check
            no_exp = CK.cfr_normal_equations_plain(
                X[name], rows, **dict(kw, explicit=None))
            assert not _rel_close(got[0], no_exp[0], 1e-4)


def _cfr_edge_phases(dev, d, rng, tabs, biases, segment):
    """The three phases on rows of 0, 1, 7, 8, 9, 63, 64 and 65 entries on
    each side (padded), or on segment rows of one chunk, of one entry and
    of many chunks (segment), sentinel rows among them."""
    from buffalo_tpu_torch.ops.cfr_kernels import (LOSS_EXPLICIT,
                                                   LOSS_IMPLICIT, LOSS_REG)

    U, I, C = tabs
    Ib, Cb = biases
    n = U.shape[0]
    if segment:
        R = 6
        rows = np.array([3, 11, n, 250, 71, n], np.int32)
        # row 0: one chunk; 1: many chunks; 3: one entry; 4: a full chunk
        # then one entry; sentinels 2 and 5 hold none
        lens = [64, 64, 64, 64, 64, 64, 64, 9, 1, 64, 1, 0]
        segs = [0, 1, 1, 1, 1, 1, 1, 1, 3, 4, 4, 6]

        def side(t):
            return _cfr_segment_side(dev, rng, t, lens, segs, R)
        imp, exp, ctx = side(U), side(C), side(I)
    else:
        lens_u = np.array([0, 1, 7, 8, 9, 63, 64, 65, 0, 33, 1, 0],
                          np.int32)
        lens_c = np.array([65, 64, 63, 9, 8, 7, 1, 0, 0, 2, 0, 0], np.int32)
        R = lens_u.shape[0]
        rows = rng.permutation(n)[:R].astype(np.int32)
        rows[[8, 11]] = n
        imp = _cfr_padded_side(dev, rng, U, R, 70, lens_u)
        exp = _cfr_padded_side(dev, rng, C, R, 66, lens_c)
        lens_x = lens_c[::-1].copy()
        lens_x[[8, 11]] = 0
        ctx = _cfr_padded_side(dev, rng, I, R, 66, lens_x)
    rows = torch.from_numpy(rows).to(dev)
    return [
        ("user", dict(implicit=imp._replace(table=I), FF=(I.T @ I)
                      .contiguous(), alpha=8.0, l=1.5, reg=0.1,
                      loss=LOSS_IMPLICIT | LOSS_REG), rows),
        ("item", dict(implicit=imp, explicit=exp, FF=(U.T @ U).contiguous(),
                      rbias=Ib, cbias=Cb, alpha=8.0, l=1.5, reg=0.1,
                      loss=LOSS_IMPLICIT | LOSS_EXPLICIT | LOSS_REG), rows),
        ("context", dict(explicit=ctx, rbias=Cb, cbias=Ib, reg=0.1,
                         loss=LOSS_EXPLICIT | LOSS_REG), rows),
    ]


@pytest.mark.parametrize("d", [8, 13, 32, 40, 64, 100, 128, 160, 300])
@pytest.mark.parametrize("segment", [False, True])
def test_cfr_normal_equations_edge_rows(dev, d, segment):
    """K17 against its plain version on rows of 0, 1, 7, 8, 9, 63, 64 and
    65 entries (both sides of the tile boundaries), segment rows of one
    chunk, one entry and many chunks, and sentinel rows (no loss, no
    total)."""
    from buffalo_tpu_torch.ops import cfr_kernels as CK

    rng, tabs, biases = _cfr_tables(dev, d, seed=d + 1)
    X = {"user": tabs[0], "item": tabs[1], "context": tabs[2]}
    n = tabs[0].shape[0]
    for name, kw, rows in _cfr_edge_phases(dev, d, rng, tabs, biases,
                                           segment):
        got = CK.cfr_normal_equations(X[name], rows, **kw)
        again = CK.cfr_normal_equations(X[name], rows, **kw)
        ref = CK.cfr_normal_equations_plain(X[name], rows, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again)), name
        for a, b in zip(got[:2], ref[:2]):
            assert _rel_close(a, b, 1e-4), name
        assert torch.allclose(got[2], ref[2], rtol=1e-4, atol=1e-5), name
        assert torch.equal(got[3], ref[3]), name
        sentinel = rows == n
        assert float(got[2][sentinel].abs().sum()) == 0
        assert not bool(got[3][sentinel].any())


@pytest.mark.parametrize("d", [8, 13, 32, 64, 128])
@pytest.mark.parametrize("segment", [False, True])
def test_cfr_normal_equations_row_bits_follow_the_row(dev, d, segment):
    """A row's A, y and loss are bitwise the same whether the row is alone
    in its batch (its block trimmed to its own length), in the middle of a
    batch, or in the same batch permuted: they depend on its entries
    alone, as the mesh's bit-for-bit tables need."""
    from buffalo_tpu_torch.ops import cfr_kernels as CK
    from buffalo_tpu_torch.ops.cfr_kernels import (LOSS_EXPLICIT,
                                                   LOSS_IMPLICIT, LOSS_REG)

    rng, (U, I, C), (Ib, Cb) = _cfr_tables(dev, d, seed=7)
    n = I.shape[0]
    kw = dict(FF=(U.T @ U).contiguous(), rbias=Ib, cbias=Cb, alpha=8.0,
              l=1.5, reg=0.1, loss=LOSS_IMPLICIT | LOSS_EXPLICIT | LOSS_REG)
    if segment:
        R = 5
        rows = np.array([9, 31, 77, n, 150], np.int32)
        lens = [64, 64, 13, 40, 64, 64, 64, 2, 0, 50]
        segs = [0, 0, 1, 2, 2, 2, 2, 2, 3, 4]
        imp = _cfr_segment_side(dev, rng, U, lens, segs, R)
        exp = _cfr_segment_side(dev, rng, C, lens[::-1], segs, R)

        def take(idx):
            # the rows idx with their chunks, in that order
            idx = list(idx)
            ptr = imp.chunk_ptr.cpu().numpy()
            chunks = [c for r in idx for c in range(ptr[r], ptr[r + 1])]
            segs2 = [i for i, r in enumerate(idx)
                     for _ in range(ptr[r], ptr[r + 1])]
            from buffalo_tpu_torch.data.batching import segment_chunk_ptr
            ci = torch.tensor(chunks, dtype=torch.long, device=dev)
            new_ptr = torch.from_numpy(segment_chunk_ptr(
                np.asarray(segs2, np.int32), len(idx))).to(dev)
            sides = [s._replace(lens=s.lens[idx].contiguous(),
                                cols=s.cols[ci].contiguous(),
                                vals=s.vals[ci].contiguous(),
                                chunk_ptr=new_ptr,
                                chunk_lens=s.chunk_lens[ci].contiguous())
                     for s in (imp, exp)]
            return torch.from_numpy(rows[idx]).to(dev), sides
    else:
        R = 24
        rows = rng.permutation(n)[:R].astype(np.int32)
        rows[5] = n
        lens_u = rng.integers(0, 70, R).astype(np.int32)
        lens_c = rng.integers(0, 40, R).astype(np.int32)
        lens_u[5] = lens_c[5] = 0
        imp = _cfr_padded_side(dev, rng, U, R, 70, lens_u)
        exp = _cfr_padded_side(dev, rng, C, R, 40, lens_c)

        def take(idx):
            idx = list(idx)
            sides = []
            for s in (imp, exp):
                width = max(1, int(s.lens[idx].max()))
                if len(idx) > 1:
                    width = s.cols.shape[1]
                sides.append(s._replace(
                    lens=s.lens[idx].contiguous(),
                    cols=s.cols[idx, :width].contiguous(),
                    vals=s.vals[idx, :width].contiguous()))
            return torch.from_numpy(rows[idx]).to(dev), sides

    def run(idx):
        r, (si, se) = take(idx)
        return CK.cfr_normal_equations(I, r, implicit=si, explicit=se, **kw)

    full = run(range(R))
    perm = rng.permutation(R)
    permuted = run(perm)
    torch.cuda.synchronize()
    for k in range(R):
        alone = run([k])
        where = int(np.nonzero(perm == k)[0][0])
        for a, b, c in zip(full, alone, permuted):
            assert torch.equal(a[k], b[0]) and torch.equal(a[k], c[where]), k


@pytest.mark.parametrize("d", [8, 32, 128, 160, 300])
@pytest.mark.parametrize("segment", [False, True])
def test_cfr_bias_kernel_matches_plain(dev, d, segment):
    from buffalo_tpu_torch.ops import cfr_kernels as CK

    rng, tabs, biases = _cfr_tables(dev, d)
    X = {"user": tabs[0], "item": tabs[1], "context": tabs[2]}
    bias_of = {"item": (biases[0], biases[1]),
               "context": (biases[1], biases[0])}
    for name, kw, rows in _cfr_phases(dev, d, rng, tabs, biases, segment):
        total = CK.cfr_normal_equations_plain(X[name], rows, **kw)[3]
        if name == "user":
            got, ref = torch.zeros(rows.shape[0], device=dev), None
            ref = got.clone()
            CK.cfr_bias(X[name], rows, total, reg_new=0.1, loss=got)
            CK.cfr_bias_plain(X[name], rows, total, reg_new=0.1, loss=ref)
            torch.cuda.synchronize()
            assert torch.allclose(got, ref, rtol=1e-5, atol=1e-7)
            continue
        own, other = bias_of[name]
        got, ref = own.clone(), own.clone()
        CK.cfr_bias(X[name], rows, total, explicit=kw["explicit"], bias=got,
                    cbias=other)
        CK.cfr_bias_plain(X[name], rows, total, explicit=kw["explicit"],
                          bias=ref, cbias=other)
        torch.cuda.synchronize()
        assert _rel_close(got, ref, 1e-5), name
        if name == "item" and not segment:
            # rows with user entries and no SPPMI entries get 0
            live = (total > 0) & (kw["explicit"].lens == 0) & \
                (rows < X[name].shape[0])
            assert bool(live.any())
            assert bool((got[rows[live].long()] == 0).all())


@pytest.mark.parametrize("d", [8, 13, 32, 64, 100, 128])
@pytest.mark.parametrize("kind", ["long_rows", "segment"])
def test_cfr_bias_pieces_match_plain(dev, d, kind):
    """K18's pieces on rows that span many: a padded block 8,192 wide with
    rows of 0 to 8,187 entries (one piece, several, all of them) and a
    segment side of 8,192-entry chunks (rows of several chunks, one short
    chunk, none), sentinel rows and rows with ``total`` 0 between them;
    within 1e-5 of the largest bias of the plain version, bitwise
    repeatable, one wrapper launch and two device launches a call, no row
    outside the written ones moved."""
    from buffalo_tpu_torch.ops import cfr_kernels as CK

    rng, tabs, biases = _cfr_tables(dev, d, n=3000, seed=d)
    X, F = tabs[1], tabs[2]
    n = X.shape[0]
    if kind == "long_rows":
        lens = np.array([8187, 0, 1, 256, 257, 1800, 4096, 8000, 3, 5000],
                        np.int32)
        R = len(lens)
        side = _cfr_padded_side(dev, rng, F, R, 8192, lens)
    else:
        R = 6
        chunk_lens = [8192, 8192, 3103, 17, 8192, 900, 5, 0]
        seg_ids = [0, 0, 0, 1, 3, 3, 4, 6]
        side = _cfr_segment_side(dev, rng, F, chunk_lens, seg_ids, R,
                                 C=8192)
    rows = rng.permutation(n)[:R].astype(np.int32)
    rows[2] = n                       # a sentinel row
    total = side.lens.cpu().numpy().copy()
    total[2] = 0
    total[1] += 4                     # entries on the other side only
    total[-1] = 0                     # nothing on either side
    rows, total = (torch.from_numpy(a).to(dev) for a in (rows, total))
    own, other = biases
    got, again, ref = own.clone(), own.clone(), own.clone()
    launches = CK.cfr_bias.launches
    dev_launches = CK.cfr_bias.device_launches
    CK.cfr_bias(X, rows, total, explicit=side, bias=got, cbias=other)
    CK.cfr_bias(X, rows, total, explicit=side, bias=again, cbias=other)
    CK.cfr_bias_plain(X, rows, total, explicit=side, bias=ref, cbias=other)
    torch.cuda.synchronize()
    assert CK.cfr_bias.launches == launches + 2
    assert CK.cfr_bias.device_launches == dev_launches + 4
    assert torch.equal(got, again)
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-5 * scale
    written = rows[(total > 0) & (rows < n)].long()
    assert bool((got[written] != own[written]).all())
    keep = torch.ones(n, dtype=torch.bool, device=dev)
    keep[written] = False
    assert torch.equal(got[keep], own[keep])


# ---------------------------------------------------------------- W2V
def _w2v_problem(dev, d, V=3000, seed=0):
    """Tables at a trained scale, Zipf(0.8) words and their unigram^0.75
    alias tables on the card."""
    from buffalo_tpu_torch.ops import sgd_kernels as S

    rng = np.random.default_rng(seed)
    L0, L1 = (torch.tensor(rng.normal(size=(V, d)) * 0.3,
                           dtype=torch.float32, device=dev) for _ in range(2))
    p = 1.0 / np.arange(1, V + 1) ** 0.8
    prob, al = S.build_alias_table(p ** 0.75)
    alias = (torch.from_numpy(prob).to(dev), torch.from_numpy(al).to(dev))
    return rng, L0, L1, p / p.sum(), alias


@pytest.mark.parametrize("d", [13, 32, 256, 300])
def test_w2v_pair_step_kernel_matches_plain(dev, d):
    """K19: its own draws bit for bit the plain version's (never the
    target), keys equal, delta rows 1e-5 of the largest, loss 1e-5, count
    exact, repeatable; and on given negatives."""
    from buffalo_tpu_torch.ops import w2v_kernels as W

    V, B, K = 3000, 5000, 5
    rng, L0, L1, p, alias = _w2v_problem(dev, d, V)
    inputs = torch.from_numpy(rng.choice(V, B, p=p).astype(np.int32))
    targets = torch.from_numpy(rng.choice(V, B, p=p).astype(np.int32))
    inputs[-37:] = V
    targets[-37:] = V
    kw = dict(vocab_size=V, num_negatives=K, seed=11, epoch=2, chunk=3,
              alias=alias)
    before = W.pair_step.launches
    got = W.pair_step(L0, L1, inputs.to(dev), targets.to(dev), 0.025, **kw)
    again = W.pair_step(L0, L1, inputs.to(dev), targets.to(dev), 0.025, **kw)
    negs = W.w2v_negatives(targets, V, num_negatives=K, seed=11, epoch=2,
                           chunk=3, alias=tuple(a.cpu() for a in alias))
    ref = W.pair_step_plain(L0.cpu(), L1.cpu(), inputs, targets, negs, 0.025,
                            vocab_size=V)
    given = W.pair_step(L0, L1, inputs.to(dev), targets.to(dev), 0.025,
                        negatives=negs.to(dev), **kw)
    torch.cuda.synchronize()
    assert W.pair_step.launches == before + 3
    assert torch.equal(got[0].cpu(), negs)
    assert not (negs == targets[:, None]).any()
    assert torch.equal(got[1].cpu(), ref[0])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for a, b in zip(got, given))
    for a, b in zip(got[2:4], ref[1:3]):
        assert _rel_close(a.cpu(), b, 1e-5)
    assert abs(float(got[4]) - float(ref[3])) <= 1e-5 * abs(float(ref[3]))
    assert float(got[5]) == float(ref[4]) == B - 37


@pytest.mark.parametrize("d", [13, 32, 256, 300])
@pytest.mark.parametrize("cap", [0.0, 0.1])
def test_w2v_row_apply_kernel_matches_plain(dev, d, cap):
    """K20 on two parts with dropped keys and a head word of 20,000
    entries: within 1e-5 of the largest summed row delta before the cap
    (plus two float32 spacings of the table), untouched rows bitwise,
    repeatable."""
    from buffalo_tpu_torch.ops import w2v_kernels as W

    V = 3000
    rng, L0, _, p, _ = _w2v_problem(dev, d, V)
    keys = [rng.choice(V, 60000, p=p).astype(np.int32),
            rng.choice(V, 9000, p=p).astype(np.int32)]
    keys[0][:20000] = 0
    keys[1][::5] = V
    parts = [(torch.from_numpy(k).to(dev),
              torch.tensor(rng.normal(size=(len(k), d)) * 0.01,
                           dtype=torch.float32, device=dev)) for k in keys]
    outs = [L0.clone() for _ in range(4)]
    before = W.row_apply.launches
    W.row_apply(outs[0], parts, scale=0.5, cap=cap)
    W.row_apply(outs[1], parts, scale=0.5, cap=cap)
    W.row_apply_plain(outs[2], parts, scale=0.5, cap=cap)
    W.row_apply_plain(outs[3], parts, scale=0.5, cap=0.0)
    torch.cuda.synchronize()
    assert W.row_apply.launches == before + 2
    assert torch.equal(outs[0], outs[1])
    # the scale: the largest summed row delta before the cap
    delta = (outs[3] - L0).abs().max()
    spacing = 2 * torch.finfo(torch.float32).eps * L0.abs().max()
    assert (outs[0] - outs[2]).abs().max() <= 1e-5 * delta + spacing
    touched = torch.zeros(V, dtype=torch.bool, device=dev)
    touched[torch.from_numpy(np.concatenate(keys)).to(dev).clamp(max=V - 1)
            .long()] = True
    assert torch.equal(outs[0][~touched], L0[~touched])


# K20's grouping edges: every key dropped, an empty side, one row of
# 5,000 entries (157 pieces of 32), rows past 256 floats
@pytest.mark.parametrize("case", ["all_dropped", "empty_side", "one_row"])
@pytest.mark.parametrize("d", [64, 300])
def test_w2v_row_apply_edges(dev, case, d):
    """K20 where the touched-rows grouping has nothing, one side, or one
    long row: the plain version's rows within 1e-5 of the largest summed
    delta (+ 2 float32 spacings), the rest bitwise, repeatable."""
    from buffalo_tpu_torch.ops import w2v_kernels as W

    V = 500
    rng, L0, _, p, _ = _w2v_problem(dev, d, V, seed=3)
    n = {"all_dropped": 3000, "empty_side": 4000, "one_row": 5000}[case]
    keys = rng.choice(V, n, p=p).astype(np.int32)
    if case == "all_dropped":
        keys[:] = np.where(np.arange(n) % 2 == 0, V, -1)
    if case == "one_row":
        keys[:] = 7
    k = torch.from_numpy(keys).to(dev)
    rows = torch.tensor(rng.normal(size=(n, d)) * 0.01, dtype=torch.float32,
                        device=dev)
    parts = [(k, rows)]
    if case == "empty_side":
        parts = [(k[:0], rows[:0]), (k, rows)]
    outs = [L0.clone() for _ in range(3)]
    for cap, out in zip((0.1, 0.1), outs[:2]):
        W.row_apply(out, parts, scale=0.5, cap=cap)
    W.row_apply_plain(outs[2], parts, scale=0.5, cap=0.1)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    if case == "all_dropped":
        assert torch.equal(outs[0], L0)
        return
    delta = (outs[2] - L0).abs().max()
    spacing = 2 * torch.finfo(torch.float32).eps * L0.abs().max()
    assert (outs[0] - outs[2]).abs().max() <= 1e-5 * delta + spacing
    touched = torch.zeros(V, dtype=torch.bool, device=dev)
    touched[k.long()] = True
    assert torch.equal(outs[0][~touched], L0[~touched])


@pytest.mark.parametrize("d", [13, 32, 256, 300])
@pytest.mark.parametrize("block", [4, 16])
def test_w2v_stream_chunk_kernel_matches_plain(dev, d, block):
    """K21 on a Zipf chunk with sentence ends inside negative blocks and
    padding at its end: 1e-5 of the largest entry, count exact, loss 1e-5,
    repeatable; one offset fewer fails that check."""
    from buffalo_tpu_torch.ops import w2v_kernels as W

    V, T, K, window = 3000, 8192, 5, 5
    rng, L0, L1, p, alias = _w2v_problem(dev, d, V)
    wc = rng.choice(V, T, p=p).astype(np.int32)
    bnd = (rng.random(T) < 0.1).astype(np.uint8)
    hc = (window - rng.integers(0, window, T)).astype(np.uint8)
    wc[-100:], bnd[-100:], hc[-100:] = V, 1, 0
    bnd[0] = 1
    sc = np.cumsum(bnd.astype(np.int32)).astype(np.int32)
    negs = W.stream_negatives(T // block, V, num_negatives=K, seed=1,
                              epoch=0, chunk=4, alias=alias, device=dev)
    args = [torch.from_numpy(a).to(dev) for a in (wc, sc, hc)] + [negs]
    kw = dict(window=window, block=block, vocab_size=V)
    got = W.stream_chunk_deltas(L0, L1, *args, **kw)
    again = W.stream_chunk_deltas(L0, L1, *args, **kw)
    cpu = [L0.cpu(), L1.cpu()] + [a.cpu() for a in args]
    ref = W.stream_chunk_deltas_plain(*cpu, **kw)
    short = W.stream_chunk_deltas_plain(*cpu, **dict(kw, window=window - 1))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for a, b, c in zip(got[:3], ref[:3], short[:3]):
        assert _rel_close(a.cpu(), b, 1e-5)
        assert not _rel_close(a.cpu(), c, 1e-5)
    assert abs(float(got[3]) - float(ref[3])) <= 1e-5 * abs(float(ref[3]))
    assert float(got[4]) == float(ref[4]) > 0


def _stream_form(d, K, window, block):
    """K21's staged tile for this shape (0: the warp form), and the widest
    window its staged form takes at d, K and block."""
    from buffalo_tpu_torch.ops.w2v_kernels import stream_staged_tile as f

    widest = [w for w in range(256) if f(d, K, w, block) > 0]
    return f(d, K, window, block), max(widest) if widest else None


@pytest.mark.parametrize("d", [13, 32, 64])
@pytest.mark.parametrize("block", [1, 4, 16])
@pytest.mark.parametrize("window", [1, 5, "widest"])
@pytest.mark.parametrize("tail", ["real", "padding"])
def test_w2v_stream_chunk_staged_form_edges(dev, d, block, window, tail):
    """K21's staged form: sentences that end at a tile's edge and inside
    its halo, negatives equal to their block's centre words, the chunk's
    last positions real words or padding, windows 1, 5 and the widest the
    staged form takes; 1e-5 of the largest entry, loss 1e-5, count exact,
    repeat launches bitwise equal."""
    from buffalo_tpu_torch.ops import w2v_kernels as W

    V, K = 2000, 5
    if window == "widest":
        window = _stream_form(d, K, 5, block)[1]
    P, _ = _stream_form(d, K, window, block)
    assert P > 0 and P % block == 0
    T = block * max(-(-512 // block), -(-6 * P // block))
    rng, L0, L1, p, alias = _w2v_problem(dev, d, V, seed=window + block)
    wc = rng.choice(V, T, p=p).astype(np.int32)
    bnd = (rng.random(T) < 0.05).astype(np.int32)
    bnd[0] = 1
    for e in range(P, T, max(P, 64 // P * P)):
        bnd[e] = 1                          # a sentence ends at a tile edge
        bnd[min(T - 1, e + window // 2 + 1)] = 1  # and inside a halo
        bnd[max(1, e - window // 2 - 1)] = 1
    hc = (window - rng.integers(0, window, T)).astype(np.uint8)
    if tail == "padding":
        wc[-3 * block:] = V
    negs = W.stream_negatives(T // block, V, num_negatives=K, seed=2,
                              epoch=0, chunk=1, alias=alias, device=dev)
    ctr = torch.from_numpy(wc[::block].copy()).to(dev)
    negs[::3, 0] = ctr[::3].clamp(max=V - 1)   # a negative equal to the centre
    last = np.arange(1, T // block, 3)      # and to a block's last centre
    negs[last, K - 1] = torch.from_numpy(wc[last * block + block - 1]).to(
        dev).clamp(max=V - 1)
    sc = np.cumsum(bnd).astype(np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (wc, sc, hc)] + [negs]
    kw = dict(window=window, block=block, vocab_size=V)
    got = W.stream_chunk_deltas(L0, L1, *args, **kw)
    again = W.stream_chunk_deltas(L0, L1, *args, **kw)
    ref = W.stream_chunk_deltas_plain(L0.cpu(), L1.cpu(),
                                      *[a.cpu() for a in args], **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for a, b in zip(got[:3], ref[:3]):
        assert _rel_close(a.cpu(), b, 1e-5)
    assert abs(float(got[3]) - float(ref[3])) <= 1e-5 * abs(float(ref[3]))
    assert float(got[4]) == float(ref[4]) > 0


def test_w2v_stream_chunk_form_rule(dev):
    """The staged form takes the stream path's shapes (d = 32, window 5,
    5 negatives, block 4; tiles a multiple of the block); rows past 256
    floats and windows past the widest staged one keep the warp form, and
    the widest window shrinks as rows widen."""
    t32, w32 = _stream_form(32, 5, 5, 4)
    t256, w256 = _stream_form(256, 5, 5, 4)
    assert t32 > 0 and t32 % 4 == 0 and t256 > 0
    assert _stream_form(300, 5, 5, 4) == (0, None)
    assert w256 < w32 < 255
    assert _stream_form(32, 5, w32 + 1, 4)[0] == 0


@pytest.mark.parametrize("window", [100, 255])
def test_w2v_stream_chunk_warp_form_past_staged(dev, window):
    """Windows past the staged form's widest take the warp form: held to
    the plain version as the staged form is."""
    from buffalo_tpu_torch.ops import w2v_kernels as W

    V, T, K, d, block = 1000, 2048, 5, 32, 4
    assert _stream_form(d, K, window, block)[0] == 0
    rng, L0, L1, p, alias = _w2v_problem(dev, d, V)
    wc = rng.choice(V, T, p=p).astype(np.int32)
    sc = np.cumsum(rng.random(T) < 0.002).astype(np.int32)
    hc = (window - rng.integers(0, window, T)).astype(np.uint8)
    negs = W.stream_negatives(T // block, V, num_negatives=K, seed=3,
                              epoch=0, chunk=0, alias=alias, device=dev)
    args = [torch.from_numpy(a).to(dev) for a in (wc, sc, hc)] + [negs]
    kw = dict(window=window, block=block, vocab_size=V)
    got = W.stream_chunk_deltas(L0, L1, *args, **kw)
    ref = W.stream_chunk_deltas_plain(L0.cpu(), L1.cpu(),
                                      *[a.cpu() for a in args], **kw)
    torch.cuda.synchronize()
    for a, b in zip(got[:3], ref[:3]):
        assert _rel_close(a.cpu(), b, 1e-5)
    assert float(got[4]) == float(ref[4]) > 0


@pytest.mark.parametrize("pair_gen", ["host", "device"])
def test_w2v_trains_on_the_card(dev, tmp_path, pair_gen):
    """A short ``W2V.train`` on the card, each path through its kernels:
    the clustered corpus's purity gate and a falling loss."""
    import buffalo_tpu_torch as bt
    from buffalo_tpu_torch.ops import sgd_kernels as S
    from buffalo_tpu_torch.ops import w2v_kernels as W

    rng = np.random.default_rng(3)
    cl = rng.integers(0, 5, 60)
    lines = [" ".join(f"w{int(x)}" for x in rng.choice(
        np.nonzero(cl == rng.integers(0, 5))[0], size=10))
        for _ in range(300)]
    (tmp_path / "main.txt").write_text("\n".join(lines) + "\n")
    sopt = bt.StreamOptions().get_default_option()
    sopt.input.main = str(tmp_path / "main.txt")
    sopt.data.path = str(tmp_path / "s.bfo")
    sopt.data.tmp_dir = str(tmp_path / "tmp")
    sopt.data.validation = {}
    data = bt.data.load(sopt)
    data.create()
    opt = bt.W2VOption().get_default_option()
    opt.update(d=16, num_iters=20, min_count=2, window=4, lr=0.05,
               pair_gen=pair_gen, neg_block=16)
    np.random.seed(5)
    m = bt.W2V(opt, data=data)
    m.initialize()
    counts = [k.launches for k in W.KERNELS + (S.sample_negatives,)]
    m.train()
    new = [k.launches - c for k, c in zip(W.KERNELS + (S.sample_negatives,),
                                          counts)]
    if pair_gen == "host":
        assert new[0] > 0 and new[1] == 2 * new[0] and new[2] == 0
    else:
        assert new[0] == 0 and new[2] > 0 and new[1] == 2 * new[2] \
            and new[3] == new[2]
    assert m.iteration_losses[-1] < m.iteration_losses[0]
    hits = total = 0
    for w in ["w0", "w1", "w2"]:
        for key, _ in m.most_similar(w, topk=5):
            total += 1
            hits += cl[int(key[1:])] == cl[int(w[1:])]
    assert total > 0 and hits / total > 0.5


# ------------------------------------------------------------ device mesh
def _merge_case(dev, B, D, kl, seed):
    """(B, D, kl) per-shard candidate lists as the sharded top-k makes
    them: sorted by score descending with ties in index order, shard j's
    indices all below shard j + 1's; integer scores (many ties, across and
    within shards) and -inf padding at the end of the last shard."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-4, 5, (B, D, kl)).astype(np.float32)
    v[:, -1, kl // 2:] = -np.inf
    v[0] = -np.inf
    S = kl + 5
    loc = np.argsort(rng.random((B, D, S)), axis=2)[:, :, :kl]
    order = np.lexsort((loc, -v), axis=2)
    v = np.take_along_axis(v, order, 2)
    i = (np.take_along_axis(loc, order, 2)
         + (np.arange(D) * S)[None, :, None]).astype(np.int32)
    return (torch.from_numpy(v).to(dev), torch.from_numpy(i).to(dev))


def _merge_crossover():
    """The smallest k of D = 4 lists of k that takes the tree form."""
    from buffalo_tpu_torch.ops import retrieval_kernels as R

    return next(k for k in range(1, 4097)
                if R.sharded_topk_merge_form(4, k, k) == "tree")


@pytest.mark.parametrize("D", [1, 2, 3, 4, 8, 32, 33, 100])
@pytest.mark.parametrize("kl", [1, 7, 64, 1024, 2000])
def test_sharded_topk_merge_kernel_equals_plain(dev, D, kl):
    """K22 bit for bit against its plain version in both forms, k from 1
    to every candidate and on each side of the crossover between them."""
    from buffalo_tpu_torch.ops import retrieval_kernels as R

    B = 37 if kl < 1024 else 9
    if kl == 2000 and D > 4:
        pytest.skip("kl = 2,000 runs at the mesh's widths")
    vals, idx = _merge_case(dev, B, D, kl, seed=D * 7 + kl)
    cross = _merge_crossover()
    for k in sorted({1, min(10, D * kl), min(kl, 2000), cross - 1, cross,
                     D * kl} & set(range(1, D * kl + 1))):
        pv, pi = R.sharded_topk_merge_plain(vals, idx, k)
        for form in (None, "warp", "tree"):
            if form == "tree" and not R.sharded_topk_merge_tree_fits(D, kl,
                                                                     k):
                with pytest.raises(ValueError):
                    R.sharded_topk_merge(vals, idx, k, form=form)
                continue
            before = R.sharded_topk_merge.launches
            gv, gi = R.sharded_topk_merge(vals, idx, k, form=form)
            assert R.sharded_topk_merge.launches == before + 1
            assert torch.equal(gi, pi), (D, kl, k, form)
            assert torch.equal(gv.view(torch.int32), pv.view(torch.int32))


def test_sharded_topk_merge_rejects_what_it_does_not_take(dev):
    from buffalo_tpu_torch.ops import retrieval_kernels as R

    vals, idx = _merge_case(dev, 4, 2, 3, 0)
    with pytest.raises(ValueError):
        R.sharded_topk_merge(vals, idx, 7)


def test_batch_topn_sharded_on_the_card(dev):
    """Four shards on one card: ids equal the unsharded scan's (integer
    scores, ties by index), at k = 10 and past K5 at k = 2,000."""
    from buffalo_tpu_torch import parallelism as par
    from buffalo_tpu_torch.ops import retrieval_kernels as R
    from buffalo_tpu_torch.ops.topk import batch_topn, batch_topn_sharded

    rng = np.random.default_rng(5)
    Q = np.round(rng.standard_normal((5003, 40)) * 4).astype(np.float32) / 4
    Q[2500:2600] = Q[:100]
    p = rng.integers(-2, 3, (64, 40)).astype(np.float32)
    Qb = np.round(rng.standard_normal(5003) * 4).astype(np.float32) / 4
    mesh = par.get_mesh(4, devices=["cuda:0"] * 4)
    for k in (10, 2000):
        before = R.sharded_topk_merge.launches
        a = batch_topn_sharded(p, Q, k, mesh, Qb=Qb)
        assert R.sharded_topk_merge.launches == before + 1
        b = batch_topn(p, Q, k, Qb=Qb, device="cuda")
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_allclose(a[1], b[1], rtol=1e-5)


@pytest.mark.parametrize("d", [8, 20, 256, 300])
@pytest.mark.parametrize("masked", [False, True])
def test_plsi_mstep_split_kernels_match_plain(dev, d, masked):
    """K16's two halves, as a mesh calls them (masked) and as the one
    device's unmasked M-step does: P rows 1e-6, Q's column sums 1e-12
    relative (double), Q after the division 1e-6, against the plain
    versions."""
    from buffalo_tpu_torch.ops import plsi_kernels as PK

    rng = np.random.default_rng(d)
    Pn = torch.from_numpy(rng.random((700, d)).astype(np.float32)).to(dev)
    Qn = torch.from_numpy(rng.random((900, d)).astype(np.float32)).to(dev)
    pm = torch.from_numpy((rng.random(700) > 0.1).astype(np.float32)).to(dev)
    qm = torch.from_numpy((rng.random(900) > 0.1).astype(np.float32)).to(dev)
    kw = dict(alpha1=0.5, alpha2=2.0)
    if masked:
        kw.update(num_items=800)
        mk, mk_cpu = dict(p_mask=pm, q_mask=qm), dict(p_mask=pm.cpu(),
                                                      q_mask=qm.cpu())
    else:
        mk = mk_cpu = {}
    got = [Pn.clone(), Qn.clone()]
    want = [Pn.cpu(), Qn.cpu()]
    s_got = PK.plsi_mstep_sums(*got, **mk, **kw)
    s_want = PK.mstep_sums_plain(*want, **mk_cpu, **kw)
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(s_got.cpu().numpy(), s_want.numpy(),
                               rtol=1e-12)
    kw.pop("alpha1")
    PK.plsi_mstep_apply(got[1], s_got, q_mask=mk.get("q_mask"), **kw)
    PK.mstep_apply_plain(want[1], s_want, q_mask=mk_cpu.get("q_mask"), **kw)
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].numpy(),
                               rtol=1e-6, atol=1e-9)


# ------------------------------------------------- the dp mesh's entry points
@pytest.mark.parametrize("alias", [False, True])
@pytest.mark.parametrize("neg_per", [1, 3])
def test_sample_kernel_slot_offset_equals_plain(dev, alias, neg_per):
    """K8 at a mesh shard's slot offset is its plain version bit for bit,
    and equals that slice of the single device's draws."""
    from buffalo_tpu_torch.ops import sgd_kernels as S

    rng = np.random.default_rng(neg_per)
    U, I, N, D = 400, 2000, 8000, 4
    deg = rng.integers(1, 100, U)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    keys = rng.integers(0, I, int(indptr[-1])).astype(np.int32)
    words, log2 = S.build_bloom(indptr, keys)
    kw = dict(num_negatives=neg_per, seed=11, epoch=2, chunk=5,
              bloom=torch.from_numpy(words.view(np.int32)).to(dev),
              bloom_log2=log2, pos_indptr=torch.from_numpy(indptr).to(dev),
              pos_keys=torch.from_numpy(keys).to(dev))
    if alias:
        prob, al = S.build_alias_table(rng.pareto(1.0, I) + 0.01)
        kw["alias"] = (torch.from_numpy(prob).to(dev),
                       torch.from_numpy(al).to(dev))
    users = torch.from_numpy(rng.integers(0, U, N).astype(np.int32)).to(dev)
    whole_neg, whole_pos = S.sample_negatives(users, I, **kw)
    n = N // D
    for g in range(D):
        part = users[g * n:(g + 1) * n].contiguous()
        neg, pos = S.sample_negatives(part, I, slot_offset=g * n, **kw)
        ref_neg, ref_pos = S.sample_negatives_plain(part, I, slot_offset=g * n,
                                                    **kw)
        assert torch.equal(neg, ref_neg) and torch.equal(pos, ref_pos)
        assert torch.equal(neg, whole_neg[g * n * neg_per:(g + 1) * n * neg_per])
        assert torch.equal(pos, whole_pos[g * n:(g + 1) * n])


@pytest.mark.parametrize("probe", ["lazy", "all"])
def test_warp_search_slot_offset_equals_plain(dev, probe):
    """K11 at a shard's slot offset: its plain version's choices, and the
    single device's rows of candidates."""
    from buffalo_tpu_torch.ops import warp_kernels as W

    c = _warp_case(dev, 64, seed=3, scale=0.2)
    N = c["users"].shape[0]
    off = 1000
    kw = _search_kw(c, 16, probe, "dot", N, slot_offset=off)
    got = W.warp_search(c["users"], c["pos"], c["P"], c["Q"], **kw)
    ref = W.warp_search_plain(c["users"], c["pos"], c["P"], c["Q"], **kw)
    torch.cuda.synchronize()
    for name, g, r in zip(("neg", "w", "any_v", "trial"), got, ref):
        if name == "w":
            assert torch.allclose(g, r, rtol=1.2e-7, atol=0), name
        else:
            assert torch.equal(g, r), name
    whole = W.warp_candidates(N + off, 16, c["I"], seed=5, epoch=2, chunk=7,
                              device=dev)
    assert torch.equal(W.warp_candidates(N, 16, c["I"], seed=5, epoch=2,
                                         chunk=7, device=dev, slot_offset=off),
                       whole[off:])


@pytest.mark.parametrize("d", [40, 300])
@pytest.mark.parametrize("flags", [(True, True, True), (True, False, True),
                                   (False, True, True)])
@pytest.mark.parametrize("users_sorted", [False, True])
def test_chunk_delta_kernel_matches_plain(dev, d, flags, users_sorted):
    """K9's delta path (both launches) against its plain version at K9's
    tolerance, two launches bitwise equal."""
    from buffalo_tpu_torch.ops import sgd_kernels as S

    use_bias, update_i, update_j = flags
    (P, Q, Qb, users, pos, neg), n_valid = _bpr_case(dev, d, neg_per=2,
                                                     seed=d)
    kw = dict(n_valid=n_valid, lr=0.2, reg_u=0.03, reg_i=0.02, reg_j=0.04,
              reg_b=0.05, num_negatives=2, use_bias=use_bias,
              update_i=update_i, update_j=update_j, users_sorted=users_sorted)
    outs = []
    for delta, neg_delta in ((S.chunk_delta, S.chunk_bias_neg_delta),
                             (S.chunk_delta, S.chunk_bias_neg_delta),
                             (S.chunk_delta_plain,
                              S.chunk_bias_neg_delta_plain)):
        dl = [torch.zeros_like(t) for t in (P, Q, Qb)]
        h = delta(P, Q, Qb, *dl, users, pos, neg, **kw)
        Qb2 = Qb + 0.01   # as after the positive side's reduced delta
        dneg = torch.zeros_like(Qb)
        neg_delta(h, Qb2, dneg, lr=0.2, reg_b=0.05)
        outs.append(dl + [dneg])
    torch.cuda.synchronize()
    zero = [torch.zeros_like(t) for t in outs[2]]
    for got, again, ref, z in zip(*outs, zero):
        assert torch.equal(got, again)
        _step_close(got, ref, z)


def _hot_case(dev, d, N, seed=0):
    """A chunk of N slots of one user, 70% of the positives on one item and
    its negatives uniform: the longest user and item rows a chunk holds,
    each summed in pieces."""
    (P, Q, Qb, _, pos, neg), _ = _bpr_case(dev, d, N=N, seed=seed)
    g = torch.Generator(device="cpu").manual_seed(seed)
    hot = torch.rand(N, generator=g) < 0.7
    pos = torch.where(hot.to(dev), torch.full_like(pos, 5), pos)
    users = torch.full_like(pos, 11)
    return P, Q, Qb, users, pos, neg


@pytest.mark.parametrize("N", [20_000, 140_000])
@pytest.mark.parametrize("users_sorted", [False, True])
def test_chunk_update_kernel_hot_rows(dev, N, users_sorted):
    """K9's sgd step and delta on a chunk of one user whose positives are
    70% one item (rows past 65,536 entries at N = 140,000: several bitmap
    windows), bitwise repeatable and within K9's tolerance of the plain
    version run in float64: a float32 sum of 10^5 terms in any one order
    is as far from the exact sum as the tolerance."""
    from buffalo_tpu_torch.ops import sgd_kernels as S

    P, Q, Qb, users, pos, neg = _hot_case(dev, 40, N)
    kw = dict(n_valid=N - 3, lr=0.01, reg_u=0.03, reg_i=0.02, reg_j=0.04,
              reg_b=0.05, num_negatives=1, use_bias=True, update_i=True,
              update_j=True)
    runs = []
    for fn in (S.chunk_update, S.chunk_update):
        t = [P.clone(), Q.clone(), Qb.clone()]
        fn(*t, users, pos, neg, max_step_norm=0.0,
           users_sorted=users_sorted, **kw)
        runs.append(t)
    ref = [P.double(), Q.double(), Qb.double()]
    S.chunk_update_plain(*ref, users, pos, neg, max_step_norm=0.0, **kw)
    deltas = []
    for fn in (S.chunk_delta, S.chunk_delta):
        dl = [torch.zeros_like(t) for t in (P, Q, Qb)]
        fn(P, Q, Qb, *dl, users, pos, neg, users_sorted=users_sorted, **kw)
        deltas.append(dl)
    dref = [torch.zeros_like(t, dtype=torch.float64) for t in (P, Q, Qb)]
    S.chunk_delta_plain(P.double(), Q.double(), Qb.double(), *dref, users,
                        pos, neg, **kw)
    torch.cuda.synchronize()
    for got, again, r, start in zip(*runs, ref, (P, Q, Qb)):
        assert torch.equal(got, again)
        _step_close(got, r.float(), start)
    for got, again, r in zip(*deltas, dref):
        assert torch.equal(got, again)
        _step_close(got, r.float(), torch.zeros_like(got))


@pytest.mark.parametrize("d", [13, 40, 300])
def test_chunk_update_kernel_presorted_equals_grouped(dev, d):
    """A resident chunk's users summed where they lie and grouped by row
    (as a streamed chunk's are) agree at K9's tolerance; users in any order
    take the grouped side."""
    from buffalo_tpu_torch.ops import sgd_kernels as S

    (P, Q, Qb, users, pos, neg), n_valid = _bpr_case(dev, d, seed=d + 3)
    kw = dict(n_valid=n_valid, lr=0.2, reg_u=0.03, reg_i=0.02, reg_j=0.04,
              reg_b=0.05, max_step_norm=0.1, num_negatives=1, use_bias=True,
              update_i=True, update_j=True)
    runs = []
    for flag in (True, False):
        t = [P.clone(), Q.clone(), Qb.clone()]
        S.chunk_update(*t, users, pos, neg, users_sorted=flag, **kw)
        runs.append(t)
    perm = torch.randperm(n_valid, generator=torch.Generator().manual_seed(d))
    perm = torch.cat([perm, torch.arange(n_valid, users.shape[0])]).to(dev)
    shuffled = [P.clone(), Q.clone(), Qb.clone()]
    S.chunk_update(*shuffled, users[perm].contiguous(),
                   pos[perm].contiguous(), neg[perm].contiguous(), **kw)
    ref = [P.clone(), Q.clone(), Qb.clone()]
    S.chunk_update_plain(*ref, users[perm], pos[perm], neg[perm], **kw)
    torch.cuda.synchronize()
    for a, b, sh, r, start in zip(*runs, shuffled, ref, (P, Q, Qb)):
        _step_close(a, b, start)
        _step_close(sh, r, start)


@pytest.mark.parametrize("users_sorted", [False, True])
def test_chunk_bias_neg_delta_kernel_matches_plain(dev, users_sorted):
    """K9's second delta launch alone: the negative side's bias from a
    chunk whose negatives are all sentinels but one item's, then from an
    ordinary chunk, within K9's tolerance and bitwise repeatable."""
    from buffalo_tpu_torch.ops import sgd_kernels as S

    (P, Q, Qb, users, pos, neg), n_valid = _bpr_case(dev, 40, seed=17)
    I = Q.shape[0]
    rare = torch.where(torch.arange(neg.shape[0], device=dev) % 97 == 0,
                       torch.full_like(neg, 7), torch.full_like(neg, I))
    for negs in (rare, neg):
        kw = dict(n_valid=n_valid, lr=0.2, reg_u=0.03, reg_i=0.02,
                  reg_j=0.04, reg_b=0.05, num_negatives=1, use_bias=True,
                  update_i=True, update_j=True)
        outs = []
        for delta, neg_delta in ((S.chunk_delta, S.chunk_bias_neg_delta),
                                 (S.chunk_delta, S.chunk_bias_neg_delta),
                                 (S.chunk_delta_plain,
                                  S.chunk_bias_neg_delta_plain)):
            dl = [torch.zeros_like(t) for t in (P, Q, Qb)]
            extra = ({"users_sorted": users_sorted}
                     if delta is S.chunk_delta else {})
            h = delta(P, Q, Qb, *dl, users, pos, negs, **kw, **extra)
            dneg = torch.zeros_like(Qb)
            before = S.chunk_bias_neg_delta.launches
            neg_delta(h, Qb - 0.02, dneg, lr=0.2, reg_b=0.05)
            if neg_delta is S.chunk_bias_neg_delta:
                assert S.chunk_bias_neg_delta.launches == before + 1
            outs.append(dneg)
        torch.cuda.synchronize()
        assert torch.equal(outs[0], outs[1])
        _step_close(outs[0], outs[2], torch.zeros_like(Qb))


@pytest.mark.parametrize("shape", [(1000, 40), (500, 300), (777,)])
@pytest.mark.parametrize("cap", [0.0, 0.05])
def test_capped_add_kernel_matches_plain(dev, shape, cap):
    """K10's capped add against its plain version at K10's tolerance."""
    from buffalo_tpu_torch.ops import sgd_kernels as S

    rng = np.random.default_rng(len(shape))
    param = torch.from_numpy(rng.normal(0, 0.3, shape).astype(np.float32)).to(
        dev)
    delta = torch.from_numpy(rng.normal(0, 0.05, shape).astype(
        np.float32)).to(dev)
    got, ref = param.clone(), param.clone()
    before = S.capped_add.launches
    S.capped_add(got, delta, cap=cap)
    S.capped_add_plain(ref, delta, cap)
    assert S.capped_add.launches == before + 1
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("d", [32, 300])
def test_w2v_pair_step_slot_offset_equals_plain(dev, d):
    """K19 at a mesh shard's slot offset: its draws bit for bit its plain
    version's and the single device's rows of that shard, the rows 1e-5 of
    the largest entry."""
    from buffalo_tpu_torch.ops import w2v_kernels as W

    V, N, K, D = 3000, 8000, 5, 4
    rng, L0, L1, p, alias = _w2v_problem(dev, d, V, seed=d)
    inputs = torch.from_numpy(rng.choice(V, N, p=p).astype(np.int32)).to(dev)
    targets = torch.from_numpy(rng.choice(V, N, p=p).astype(np.int32)).to(dev)
    kw = dict(vocab_size=V, num_negatives=K, seed=11, epoch=2, chunk=3,
              alias=alias)
    whole = W.pair_step(L0, L1, inputs, targets, 0.025, **kw)[0]
    n = N // D
    for g in (1, D - 1):
        sl = slice(g * n, (g + 1) * n)
        got = W.pair_step(L0, L1, inputs[sl], targets[sl], 0.025,
                          slot_offset=g * n, **kw)
        negs = W.w2v_negatives(targets[sl], V, num_negatives=K, seed=11,
                               epoch=2, chunk=3, alias=alias,
                               slot_offset=g * n)
        ref = W.pair_step_plain(L0, L1, inputs[sl], targets[sl], negs, 0.025,
                                vocab_size=V)
        torch.cuda.synchronize()
        assert torch.equal(got[0], negs) and torch.equal(got[0], whole[sl])
        assert torch.equal(got[1], ref[0])
        for a, b in zip(got[2:4], ref[1:3]):
            assert _rel_close(a, b, 1e-5)
        assert float(got[5]) == float(ref[4]) == n


@pytest.mark.parametrize("d", [1, 8, 9, 13, 32, 64, 100, 256, 257, 300])
def test_w2v_pair_parts_cover_every_pair(dev, d):
    """K19's C launch shape (``w2v_pair_parts``) against brute force: a
    team of the fewest lanes, a power of two up to 32, whose two float4s a
    lane hold the row (a warp past 256 floats), 256 threads a block, so
    every pair of 0, 1, a block's worth, one more and a 262,144-pair chunk
    lies in a block of the launch and no block is without a pair."""
    from buffalo_tpu_torch.ops import w2v_kernels as W

    lanes = 32 if d > 256 else min(32, 1 << (-(-d // 8) - 1).bit_length())
    per = 256 // lanes
    parts = W._kernel("w2v_pair_parts")
    for B in (0, 1, per - 1, per, per + 1, 7 * per + 3, 262_144):
        assert parts(B, d) == len({b // per for b in range(B)}), B


@pytest.mark.parametrize("d", [1, 4, 13, 32, 64, 100, 128, 129, 256])
@pytest.mark.parametrize("K", [1, 5, 9])
def test_w2v_pair_step_teams_at_an_offset(dev, d, K):
    """K19's team forms at every lane count (1 to 32 lanes a pair, one and
    two float4s a lane, rows of widths that are not multiples of 4) with K
    below, at and past a block of 8 negatives, on a shard's pairs at its
    slot offset (with padding pairs): own draws and keys bit for bit the
    plain version's, the same draws injected give the same outputs, rows
    1e-5 of the largest entry, loss 1e-5, count exact, repeatable."""
    from buffalo_tpu_torch.ops import w2v_kernels as W

    V, N = 3000, 4099
    rng, L0, L1, p, alias = _w2v_problem(dev, d, V, seed=d + K)
    inputs = torch.from_numpy(rng.choice(V, N, p=p).astype(np.int32)).to(dev)
    targets = torch.from_numpy(rng.choice(V, N, p=p).astype(np.int32)).to(dev)
    inputs[-11:] = V
    kw = dict(vocab_size=V, num_negatives=K, seed=5, epoch=1, chunk=7,
              alias=alias, slot_offset=3 * N)
    got = W.pair_step(L0, L1, inputs, targets, 0.025, **kw)
    again = W.pair_step(L0, L1, inputs, targets, 0.025, **kw)
    given = W.pair_step(L0, L1, inputs, targets, 0.025,
                        negatives=got[0].clone(), **kw)
    negs = W.w2v_negatives(targets, V, num_negatives=K, seed=5, epoch=1,
                           chunk=7, alias=alias, slot_offset=3 * N)
    ref = W.pair_step_plain(L0, L1, inputs, targets, negs, 0.025,
                            vocab_size=V)
    torch.cuda.synchronize()
    assert torch.equal(got[0], negs) and torch.equal(got[1], ref[0])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for a, b in zip(got, given))
    for a, b in zip(got[2:4], ref[1:3]):
        assert _rel_close(a, b, 1e-5)
    assert abs(float(got[4]) - float(ref[3])) <= 1e-5 * abs(float(ref[3]))
    assert float(got[5]) == float(ref[4]) == N - 11


@pytest.mark.parametrize("d", [32, 300])
def test_w2v_row_apply_on_the_union_of_shards(dev, d):
    """K20 on the union of 4 shards' parts (``apply_union`` on a mesh of 4
    shards of this card) against ``clipped_apply`` of the summed dense
    deltas, on a chunk whose head rows pass the cap."""
    from buffalo_tpu_torch import parallelism
    from buffalo_tpu_torch.ops import w2v_kernels as W

    V, D, cap = 3000, 4, 0.1
    rng, L0, L1, p, _ = _w2v_problem(dev, d, V, seed=d + 1)
    mesh = parallelism.get_mesh(D, devices=["cuda:0"] * D)
    shard_parts = []
    dense = torch.zeros_like(L1)
    for _ in range(D):
        parts = []
        for n in (5000, 2000):
            keys = rng.choice(V, n, p=p).astype(np.int32)
            keys[::9] = V
            k = torch.from_numpy(keys).to(dev)
            rows = torch.tensor(rng.normal(size=(n, d)) * 0.01,
                                dtype=torch.float32, device=dev)
            parts.append((k, rows))
            keep = k < V
            dense.index_add_(0, k[keep].long(), 0.5 * rows[keep])
        shard_parts.append(parts)
    tables = {mesh.devices[0]: (L0.clone(), L1.clone())}
    before = W.row_apply.launches
    W.apply_union(mesh, tables, 1, shard_parts, scale=0.5, cap=cap)
    torch.cuda.synchronize()
    assert W.row_apply.launches == before + 1
    want = W.clipped_apply(L1, dense, cap)
    capped = int((dense.norm(dim=1) > cap).sum())
    assert capped > 0
    spacing = 2 * torch.finfo(torch.float32).eps * L1.abs().max()
    err = (tables[mesh.devices[0]][1] - want).abs().max()
    assert err <= 1e-5 * dense.abs().max() + spacing
    assert torch.equal(tables[mesh.devices[0]][0], L0)


@pytest.mark.parametrize("d", [32, 160])
def test_cfr_kernels_with_sentinel_rows(dev, d):
    """K17, K3 and K18 on a shard's slice of a padded item batch whose rows
    hold sentinel ids (the table's size, no entries) between real rows:
    each against its plain version, the sentinel rows with no loss, and no
    row or bias outside the slice's real rows written."""
    from buffalo_tpu_torch.ops import cfr_kernels as CK
    from buffalo_tpu_torch.ops.cfr_kernels import (LOSS_EXPLICIT,
                                                   LOSS_IMPLICIT, LOSS_REG)

    rng, (U, I, C), (Ib, Cb) = _cfr_tables(dev, d, seed=d)
    n, R = I.shape[0], 48
    rows = rng.permutation(n)[:R].astype(np.int32)
    rows[1::3] = n
    sentinel = torch.from_numpy(rows == n).to(dev)
    lens_u = np.where(rows < n, rng.integers(1, 40, R), 0).astype(np.int32)
    lens_c = np.where(rows < n, rng.integers(0, 24, R), 0).astype(np.int32)
    imp = _cfr_padded_side(dev, rng, U, R, 40, lens_u)
    exp = _cfr_padded_side(dev, rng, C, R, 24, lens_c)
    rows_t = torch.from_numpy(rows).to(dev)
    kw = dict(implicit=imp, explicit=exp, FF=(U.T @ U).contiguous(),
              rbias=Ib, cbias=Cb, alpha=8.0, l=1.0, reg=0.1,
              loss=LOSS_IMPLICIT | LOSS_EXPLICIT | LOSS_REG)
    A, y, loss, total = CK.cfr_normal_equations(I, rows_t, **kw)
    rA, ry, rloss, rtotal = CK.cfr_normal_equations_plain(I, rows_t, **kw)
    torch.cuda.synchronize()
    assert _rel_close(A, rA) and _rel_close(y, ry)
    assert torch.allclose(loss, rloss, rtol=1e-4, atol=1e-5)
    assert torch.equal(total, rtotal)
    assert float(loss[sentinel].abs().sum()) == 0 and not total[sentinel].any()
    got, ref = I.clone(), I.clone()
    K.batched_cg_dense(A, y, got, total, rows=rows_t, cg_iters=3,
                       cg_tol=1e-10)
    K.batched_cg_dense_plain(A, y, ref, total, rows=rows_t, cg_iters=3,
                             cg_tol=1e-10)
    gb, rb = Ib.clone(), Ib.clone()
    CK.cfr_bias(got, rows_t, total, explicit=exp, bias=gb, cbias=Cb)
    CK.cfr_bias_plain(ref, rows_t, total, explicit=exp, bias=rb, cbias=Cb)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, **TOL)
    assert _rel_close(gb, rb, 1e-5)
    real = torch.zeros(n, dtype=torch.bool, device=dev)
    real[rows_t[~sentinel].long()] = True
    assert torch.equal(got[~real], I[~real]) and torch.equal(gb[~real],
                                                             Ib[~real])
    assert bool((got[real] != I[real]).any(1).all())


def test_narrow_widths_keep_their_instantiations(dev):
    """Rows of 40, 64 and 160 floats launch the narrow instantiations the
    kernels ran before they took wide rows; 300 the wide ones (each
    launcher's own choice, asked through its C interface)."""
    import ctypes

    from buffalo_tpu_torch.ops._build import launcher

    queries = {
        "bpr_wide": "bpr_update", "bpr_optimizer_wide": "bpr_optimizer",
        "warp_search_wide": "warp_search",
        "warp_accumulate_wide": "warp_accumulate",
        "eals_sweep_wide": "eals_sweep", "plsi_estep_wide": "plsi_estep",
        "plsi_mstep_wide": "plsi_mstep",
        "cfr_normal_equations_wide": "cfr_normal_equations",
        "cfr_bias_wide": "cfr_bias", "w2v_pair_step_wide": "w2v_pair_step",
        "w2v_row_apply_wide": "w2v_row_apply",
        "w2v_stream_chunk_wide": "w2v_stream_chunk",
        "als_normal_equations_wide": "als_normal_equations",
        "batched_cg_dense_wide_mode": "batched_cg_dense",
        "ialspp_features_per_thread": "ialspp_solve",
    }
    for name, lib in queries.items():
        f = launcher(name, [ctypes.c_int], library=lib)
        narrow = [f(d) for d in (40, 64, 160)]
        if name.startswith("cfr"):
            # CoFactor's kernels held 128 floats: 160 is their wide form
            assert narrow == [0, 0, 1] and f(300) == 1, name
        elif name == "ialspp_features_per_thread":
            assert narrow == [1, 1, 1] and f(300) == 2, name
        else:
            assert narrow == [0, 0, 0] and f(300) == 1, name
    merge = launcher("sharded_topk_merge_wide", [ctypes.c_int],
                     library="sharded_topk_merge")
    assert [merge(D) for D in (4, 32, 33)] == [0, 0, 1]
    cells = launcher("kmeans_update_global_counts", [ctypes.c_int],
                     library="kmeans_update")
    assert [cells(C) for C in (711, 58_112, 58_113)] == [0, 0, 1]
