"""The port's batched retrieval (``ops/topk.py``) and the plain versions of
its kernels K5–K7 (``ops/retrieval_kernels.py``), on the CPU.

``batch_topn`` is held to the JAX package's on the same numpy arrays:
scores within rtol 1e-5 (float32 products summed in another order), ids
equal except where the two scores are within that tolerance (ties).  The
plain versions are held to a float64 numpy reference with the tie order
checked: duplicated rows score equal in float32 and must come back in
index order, as ``lax.top_k`` returns them.
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

import buffalo_tpu.data.native as jax_native
import buffalo_tpu.ops.topk as J
import buffalo_tpu_torch.data.native as port_native
import buffalo_tpu_torch.ops.topk as T
from buffalo_tpu_torch.ops import retrieval_kernels as R
from tests.test_torch_native_ref import jax_native_lib  # noqa: F401

# the JAX package's native library, built and loaded under a lock
# (see test_torch_native_ref.py)
pytestmark = pytest.mark.usefixtures("jax_native_lib")

RTOL = 1e-5


def _same_up_to_ties(got, ref):
    """(keys, scores) pairs: scores within RTOL, keys equal except where
    the scores tie within it."""
    (gk, gs), (rk, rs) = got, ref
    assert gk.shape == rk.shape and gs.shape == rs.shape
    np.testing.assert_allclose(gs, rs, rtol=RTOL, atol=1e-6)
    differ = gk != rk
    assert np.all(~differ | np.isclose(gs, rs, rtol=RTOL, atol=1e-6))


def _tables(seed, N=700, d=16, B=40):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((N, d)).astype(np.float32)
    Q[2] *= 10                       # the best match of Q[2] itself
    Q[[9, 40, 333]] = Q[2]           # exact ties
    p = rng.standard_normal((B, d)).astype(np.float32)
    Qb = rng.standard_normal(N).astype(np.float32)
    return p, Q, Qb


CASES = {
    "flat": dict(topk=10),
    "bias": dict(topk=10, Qb=True),
    "pool": dict(topk=5, pool=np.array([3, 2, 9, 40, 333, 100, 650],
                                       np.int32)),
    "pool_bias_small": dict(topk=8, pool=np.array([7, 2, 9], np.int64),
                            Qb=True),
    "k_exceeds_catalog": dict(topk=750),
    "approx": dict(topk=10, approx=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_batch_topn_matches_jax(case):
    kw = dict(CASES[case])
    p, Q, Qb = _tables(1)
    if kw.pop("Qb", False):
        kw["Qb"] = Qb
    got = T.batch_topn(p, Q, device="cpu", **kw)
    ref = J.batch_topn(p, Q, **kw)
    _same_up_to_ties(got, ref)
    if "pool" in kw:
        assert set(got[0].ravel()) <= set(kw["pool"]) | {-1}


# the multi-chunk shapes of tests/ops/test_topk_stage.py: 1 to 7 chunks
# of 300 queries, across the chunk-count buckets
@pytest.mark.parametrize("B", [1, 300, 2048, 2049, 1501])
def test_batch_topn_multi_chunk_matches_jax(B):
    rng = np.random.default_rng(4)
    Q = rng.standard_normal((700, 16)).astype(np.float32)
    p = rng.standard_normal((B, 16)).astype(np.float32)
    _same_up_to_ties(T.batch_topn(p, Q, 5, chunk=300, device="cpu"),
                     J.batch_topn(p, Q, 5, chunk=300))


def test_batch_topn_bf16_queries_match_jax():
    """Queries rounded to bfloat16 on the host (nearest even) in both
    packages, scores accumulated in float32."""
    rng = np.random.default_rng(5)
    Q = rng.standard_normal((800, 32)).astype(np.float32)
    p = rng.standard_normal((200, 32)).astype(np.float32)
    got = T.batch_topn(p, Q, 10, query_dtype="bfloat16", device="cpu")
    _same_up_to_ties(got, J.batch_topn(p, Q, 10, query_dtype="bfloat16"))
    exact = T.batch_topn(p, Q, 10, device="cpu")
    assert not np.array_equal(got[1], exact[1])  # the queries were rounded


@pytest.mark.parametrize("bias", [False, True])
def test_tiled_path_matches_jax(monkeypatch, bias):
    """The score-matrix gate lowered in both packages: both take the
    catalog-tiled path (the port's plain per-tile top-k + merge) and give
    the flat scan's result."""
    rng = np.random.default_rng(0)
    Q = rng.standard_normal((5000, 16)).astype(np.float32)
    Q[4000] = Q[17]
    p = rng.standard_normal((300, 16)).astype(np.float32)
    p[0] = Q[17]
    Qb = rng.standard_normal(5000).astype(np.float32) if bias else None
    flat = T.batch_topn(p, Q, topk=10, Qb=Qb, device="cpu")
    monkeypatch.setattr(J, "_FLAT_SCORES_BYTES", 2048 * 1024)
    monkeypatch.setattr(T, "_FLAT_SCORES_BYTES", 2048 * 1024)
    calls = []
    plain = R.tiled_topk_plain
    monkeypatch.setattr(T, "tiled_topk_plain",
                        lambda *a: calls.append(1) or plain(*a))
    tiled = T.batch_topn(p, Q, topk=10, Qb=Qb, device="cpu")
    assert calls, "the port did not take the tiled path"
    _same_up_to_ties(tiled, J.batch_topn(p, Q, topk=10, Qb=Qb))
    np.testing.assert_array_equal(tiled[0], flat[0])
    np.testing.assert_array_equal(tiled[1], flat[1])


def test_empty_pool_and_empty_batch_match_jax():
    p = np.ones((2, 4), np.float32)
    Q = np.ones((6, 4), np.float32)
    empty = np.array([], dtype=np.int64)
    for got, ref in ((T.batch_topn(p, Q, 3, pool=empty, device="cpu"),
                      J.batch_topn(p, Q, 3, pool=empty)),
                     (T.batch_topn(p[:0], Q, 3, device="cpu"),
                      J.batch_topn(p[:0], Q, 3))):
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
    assert np.all(T.batch_topn(p, Q, 3, pool=empty, device="cpu")[0] == -1)


def test_bucket_chunk_count_and_chunks_match_jax():
    assert [T._bucket_chunk_count(n) for n in range(1, 300)] == \
        [J._bucket_chunk_count(n) for n in range(1, 300)]
    p = np.random.default_rng(3).standard_normal((2049, 5)).astype(
        np.float32)
    for chunk in (7, 300, 2048):
        np.testing.assert_array_equal(T._bucketed_chunks(p, chunk),
                                      J._bucketed_chunks(p, chunk))


@pytest.mark.parametrize("shape", [(5000, 100), (1000, 7), (63,), (129, 3),
                                   (2,)])
def test_fingerprint_native_numpy_and_jax_identical(monkeypatch, shape):
    """The OpenMP checksum, the numpy pass and the JAX package's give the
    same bytes (tails past a multiple of 8 bytes, buffers under 64 words
    included), and a one-ulp in-place write changes the fingerprint."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal(int(np.prod(shape))).astype(
        np.float32).reshape(shape)
    fp = T._fingerprint(a)
    assert fp == J._fingerprint(a)
    with monkeypatch.context() as m:
        m.setattr(port_native, "checksum_native",
                  lambda arr, n_chunks=64: None)
        assert T._fingerprint(a) == fp
    flat = a.reshape(-1)
    mid = flat.shape[0] // 2
    flat[mid] = np.nextafter(flat[mid], np.float32(np.inf), dtype=np.float32)
    assert T._fingerprint(a) != fp


def test_checksum_native_matches_jax_binding():
    """The port's binding of ``fileio_checksum`` returns the JAX
    package's sums, and None where that one does (too short, unaligned)."""
    a = np.random.default_rng(0).standard_normal(10_001).astype(np.float32)
    got = port_native.checksum_native(a)
    assert got is not None and got.dtype == np.int64 and got.shape == (64,)
    np.testing.assert_array_equal(got, jax_native.checksum_native(a))
    np.testing.assert_array_equal(port_native.checksum_native(a, 16),
                                  jax_native.checksum_native(a, 16))
    for bad in (a[:100], a.view(np.uint8)[4:4004].view(np.float32)):
        assert port_native.checksum_native(bad) is None
        assert jax_native.checksum_native(bad) is None


def test_stage_cache_invalidates_and_skips_pool_and_bias(monkeypatch):
    monkeypatch.setattr(T, "_stage_cache", None)
    rng = np.random.default_rng(1)
    Q = rng.random((500, 8)).astype(np.float32)
    p = rng.random((4, 8)).astype(np.float32)
    T.batch_topn(p, Q, 3, device="cpu")
    assert len(T._stage_cache) == 1
    staged = next(iter(T._stage_cache.values()))[1]
    # a write away from column 0: the checksum changes, the table re-stages
    Q[1, 1] = 100.0
    keys, scores = T.batch_topn(p, Q, 3, device="cpu")
    assert len(T._stage_cache) == 2
    assert (keys[:, 0] == (p @ Q.T).argmax(axis=1)).all()
    np.testing.assert_allclose(scores[:, 0], (p @ Q.T).max(axis=1),
                               rtol=RTOL)
    assert next(reversed(T._stage_cache.values()))[1] is not staged
    T.batch_topn(p, Q, 2, pool=np.arange(10, dtype=np.int32), device="cpu")
    T.batch_topn(p, Q, 2, Qb=np.ones(500, np.float32), device="cpu")
    assert len(T._stage_cache) == 2  # only the stable full table
    for _ in range(5):               # 4 slots at most
        T._stage(rng.random((3, 3)).astype(np.float32), "cpu")
    assert len(T._stage_cache) == 4


# ------------------------------------------------- plain versions (K5-K7)
def _f64_topk(scores, k):
    """float64 reference selection, ties to the smaller index."""
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return order, np.take_along_axis(scores, order, axis=1)


def _near_ties_only(idx, ref_idx, s64):
    """Ids equal to the float64 reference's except where the float64
    scores of the two picks are within RTOL."""
    a = np.take_along_axis(s64, idx.astype(np.int64), axis=1)
    b = np.take_along_axis(s64, ref_idx, axis=1)
    assert np.all((idx == ref_idx) | np.isclose(a, b, rtol=RTOL, atol=1e-9))


def _index_order_on_ties(vals, idx):
    same = vals[:, 1:] == vals[:, :-1]
    assert np.all(~same | (idx[:, 1:] > idx[:, :-1]))


# (k, d, N): the first three at d = 13 over 400 items; then the list
# lengths (32 | 33, 128 | 129, 1024) and widths (7, 100, 257) at which
# K5's wrapper routes between its tensor-core and FFMA forms, over enough
# items (the bias leaves half of them finite) that the k-th score stays
# clear of 0, where a float32 sum's error passes 1e-5 of the score
TOPK_SHAPES = [pytest.param(1, 13, 400, id="1"),
               pytest.param(10, 13, 400, id="10"),
               pytest.param(64, 13, 400, id="64"),
               pytest.param(32, 7, 400, id="32-d7"),
               pytest.param(32, 257, 400, id="32-d257"),
               pytest.param(33, 100, 400, id="33-d100"),
               pytest.param(128, 257, 4096, id="128-d257"),
               pytest.param(129, 7, 4096, id="129-d7"),
               pytest.param(1024, 100, 20480, id="1024-d100"),
               pytest.param(1024, 7, 20480, id="1024-d7")]


@pytest.mark.parametrize("k,d,N", TOPK_SHAPES)
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
def test_score_topk_plain_vs_float64(k, d, N, bias, qdtype):
    p, Q, Qb = _tables(k, N=N, d=d, B=50)
    p[0] = Q[2]
    Qb[N // 2:] = -np.inf if bias else 0.0   # -inf: valid lowest scores
    pt = torch.from_numpy(p).to(getattr(torch, qdtype))
    vals, idx = R.score_topk(pt, torch.from_numpy(Q), k,
                             torch.from_numpy(Qb) if bias else None)
    vals, idx = vals.numpy(), idx.numpy()
    s64 = pt.double().numpy() @ Q.astype(np.float64).T
    if bias:
        s64 = s64 + Qb
    ref_idx, ref_vals = _f64_topk(s64, k)
    np.testing.assert_allclose(vals, ref_vals, rtol=RTOL, atol=1e-6)
    _near_ties_only(idx, ref_idx, s64)
    _index_order_on_ties(vals, idx)
    if k >= 4 and not bias:
        assert idx[0, :4].tolist() == [2, 9, 40, 333]


@pytest.mark.parametrize("k,d,n,form", [
    (10, 100, 505_840, "tc"), (10, 40, 26_744, "tc"), (1, 101, 2048, "tc"),
    (32, 256, 5000, "tc"), (1, 101, 711, "ffma"), (2, 101, 2047, "ffma"),
    (33, 40, 26_744, "ffma"), (10, 257, 26_744, "ffma"),
    (1024, 8, 26_744, "ffma")])
def test_score_topk_form(k, d, n, form):
    """K5's route: the tensor cores take k <= 32 at d <= 256 over at least
    TC_MIN_ITEMS items (not the k-means assignment's 711 centroids)."""
    assert R.score_topk_form(k, d, n) == form


# (query blocks, item tiles, resident blocks, k) -> splits: the brunch call
# (10,000 queries, 505,840 items at 2 blocks an SM), ML-20M's (26,744 items
# at 3), the k-means chunk (65,536 against 711), 5M x 64 on 2,048 queries,
# and a catalog of one tile
@pytest.mark.parametrize("qb,tiles,resident,k,S", [
    (157, 7904, 264, 10, 5), (157, 418, 396, 10, 5), (1024, 12, 264, 1, 1),
    (32, 78125, 264, 10, 33), (2, 1, 264, 10, 1)])
def test_tc_splits_fill_whole_waves(qb, tiles, resident, k, S):
    """The tensor-core form's splits: from a wave's worth to four waves',
    the S whose blocks fill the resident ones best (the smaller on a tie),
    at most one split per item tile."""
    got = R.tc_splits(qb, tiles, resident, k)
    assert got == S
    fill = Fraction(qb * S, -(-qb * S // resident) * resident)
    lo = max(1, min(tiles, -(-resident // qb)))
    for other in range(lo, min(tiles, 4 * lo) + 1):
        blocks = qb * other
        f = Fraction(blocks, -(-blocks // resident) * resident)
        assert f < fill or (f == fill and other >= S)


def test_score_topk_plain_neg_inf_rows_in_index_order():
    p, Q, Qb = _tables(2, N=400, d=8, B=6)
    Qb[:] = -np.inf
    Qb[[5, 250]] = 0.0
    vals, idx = R.score_topk(torch.from_numpy(p), torch.from_numpy(Q), 6,
                             torch.from_numpy(Qb))
    assert np.isfinite(vals[:, :2].numpy()).all()
    assert np.isinf(vals[:, 2:].numpy()).all()
    assert idx[:, 2:].tolist() == [[0, 1, 2, 3]] * 6


def test_key_order_round_trip():
    """The plain versions' int64 keys order (score desc, index asc) over
    the special values and decode exactly."""
    v = torch.tensor([[float("-inf"), -1e30, -1.0, -1e-42, -0.0, 0.0,
                       1e-42, 1.0, 3.5, float("inf")]])
    i = torch.arange(v.shape[1], dtype=torch.int32)[None, :]
    keys = R._keys(v, i)
    assert torch.equal(torch.argsort(keys, descending=True)[0],
                       torch.arange(9, -1, -1))
    dv, di = R._decode(keys)
    assert torch.equal(dv.view(torch.int32), v.view(torch.int32))
    assert torch.equal(di, i)
    tied = R._keys(torch.full((1, 3), 2.0), torch.tensor([[5, 1, 3]]))
    assert R._decode(torch.topk(tied, 3).values)[1].tolist() == [[1, 3, 5]]


def test_tiled_plain_vs_float64():
    p, Q, Qb = _tables(6, N=1000, d=12, B=30)
    tile = 256
    Q_t = np.zeros((4 * tile, 12), np.float32)
    Q_t[:1000] = Q
    Qb_t = np.full(4 * tile, -np.inf, np.float32)
    Qb_t[:1000] = Qb
    vals, idx = R.tiled_topk_plain(
        torch.from_numpy(p), torch.from_numpy(Q_t.reshape(4, tile, 12)),
        torch.from_numpy(Qb_t.reshape(4, tile)), 20)
    s64 = p.astype(np.float64) @ Q.astype(np.float64).T + Qb
    ref_idx, ref_vals = _f64_topk(s64, 20)
    np.testing.assert_allclose(vals.numpy(), ref_vals, rtol=RTOL, atol=1e-6)
    _near_ties_only(idx.numpy(), ref_idx, s64)


def _ivf_tiles(seed, T_=12, bq=64, l_cap=128, d=10):
    rng = np.random.default_rng(seed)
    queries = rng.standard_normal((80, d)).astype(np.float32)
    table = rng.standard_normal((700, d)).astype(np.float32)
    table[[300, 301]] = table[299]
    ln = rng.integers(0, l_cap + 1, size=T_).astype(np.int32)
    ln[:3] = [0, 2, l_cap]
    lo = rng.integers(0, 700 - l_cap, size=T_).astype(np.int32)
    lo[1] = 250
    qidx = rng.integers(0, 80, size=(T_, bq)).astype(np.int32)
    qmask = rng.random((T_, bq)) < 0.7
    return queries, table, qidx, qmask, lo, ln


@pytest.mark.parametrize("kk", [1, 10, 128])
def test_ivf_tile_plain_matches_jax_tiled_score(kk):
    """K6's plain version against ``_tiled_score`` on the same tiles
    (the JAX table zero-padded at its tail as the reference stages it):
    values within RTOL (masked entries -inf in both), positions equal
    except at ties."""
    import jax.numpy as jnp

    from buffalo_tpu.parallel.ann import _tiled_score

    l_cap = 128
    queries, table, qidx, qmask, lo, ln = _ivf_tiles(kk, l_cap=l_cap)
    tp = np.vstack([table, np.zeros((1024, table.shape[1]), np.float32)])
    jv, jp = _tiled_score(jnp.asarray(queries), jnp.asarray(tp),
                          jnp.asarray(qidx), jnp.asarray(qmask),
                          jnp.asarray(lo), jnp.asarray(ln), k=kk, l_cap=l_cap)
    jv, jp = np.asarray(jv), np.asarray(jp)
    v, pos = R.ivf_tile_topk(*(torch.from_numpy(a) for a in
                               (queries, table, qidx, qmask, lo, ln)),
                             kk, l_cap)
    v, pos = v.numpy(), pos.numpy()
    assert np.array_equal(np.isinf(v), np.isinf(jv)) and not np.isnan(v).any()
    fin = np.isfinite(jv)
    np.testing.assert_allclose(v[fin], jv[fin], rtol=RTOL, atol=1e-6)
    differ = pos != jp
    assert np.all(~differ | np.isclose(v, jv, rtol=RTOL, atol=1e-6)
                  | ~fin)
    # tile 1 holds the duplicated rows 299-301: equal scores, in row order
    _index_order_on_ties(v.reshape(-1, kk), pos.reshape(-1, kk))


def test_ivf_tile_plain_vs_float64():
    queries, table, qidx, qmask, lo, ln = _ivf_tiles(9, T_=5, l_cap=128)
    v, pos = R.ivf_tile_topk(*(torch.from_numpy(a) for a in
                               (queries, table, qidx, qmask, lo, ln)),
                             8, 128)
    v, pos = v.numpy(), pos.numpy()
    for t in range(5):
        for s in range(qidx.shape[1]):
            if not qmask[t, s]:
                assert np.isinf(v[t, s]).all()
                assert pos[t, s].tolist() == list(range(lo[t], lo[t] + 8))
                continue
            cols = table[lo[t]:lo[t] + ln[t]].astype(np.float64)
            s64 = cols @ queries[qidx[t, s]].astype(np.float64)
            n = min(8, ln[t])
            order = np.argsort(-s64, kind="stable")[:n]
            np.testing.assert_allclose(v[t, s, :n], s64[order], rtol=RTOL)
            assert np.isinf(v[t, s, n:]).all()
            assert pos[t, s, n:].tolist() == list(
                range(lo[t] + ln[t], lo[t] + ln[t] + 8 - n))


@pytest.mark.parametrize("rows", [0, 1, 17, 64])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ivf_tile_classes_partition(rows, seed):
    """K6's class split at a row cap: every tile in exactly one class, in
    tile order; the small form's tiles those of at most ``rows`` rows
    (empty ones included), the scan's the rest; a cap of 0 (no small
    form) puts every tile in the scan."""
    rng = np.random.default_rng(seed)
    ln = np.concatenate([[0, 1, rows, rows + 1, 1024],
                         rng.integers(0, 80 if seed % 2 else 1025,
                                      60 * seed)]).astype(np.int32)
    small, scan = R.ivf_tile_classes(ln, rows)
    assert small.dtype == scan.dtype == np.int32
    assert np.array_equal(np.sort(np.concatenate([small, scan])),
                          np.arange(len(ln)))
    assert np.all(np.diff(small) > 0) and np.all(np.diff(scan) > 0)
    if rows == 0:
        assert len(small) == 0
        return
    assert np.all(ln[small] <= rows) and np.all(ln[scan] > rows)
    assert 0 in small and 2 in small and 3 in scan and 4 in scan


def test_kmeans_update_plain_vs_float64():
    rng = np.random.default_rng(11)
    unit = rng.standard_normal((500, 9)).astype(np.float32)
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    unit[-20:] = 0.0                   # zero rows weigh nothing
    assign = rng.integers(0, 12, size=500).astype(np.int32)
    assign[assign == 4] = 5            # cell 4 empty: keeps its centroid
    cent = rng.standard_normal((12, 9)).astype(np.float32)
    got = R.kmeans_update(torch.from_numpy(unit), torch.from_numpy(assign),
                          torch.from_numpy(cent)).numpy()
    ref = cent.astype(np.float64)
    for c in range(12):
        rows = unit[:-20][assign[:-20] == c].astype(np.float64)
        if len(rows):
            ref[c] = rows.mean(0)
    ref /= np.maximum(np.linalg.norm(ref, axis=1, keepdims=True), 1e-12)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_kernel_limits_raise_on_cuda_tensors_only():
    """Past k = 1024 the CUDA path raises (naming the limit) before any
    launch, at any width (the kernels take rows of any width); CPU tensors
    run the plain version."""
    p = torch.zeros(3, 300)
    Q = torch.zeros(2000, 300)
    vals, _ = R.score_topk(p, Q, 1100)
    assert vals.shape == (3, 1100)
    with pytest.raises(NotImplementedError, match="1024"):
        R._check_k("score_topk", 1025)
    R._check_k("score_topk", 1024)


def _tie_tables(seed, copies=3, rows=50, d=8, B=64):
    """A catalog of ``copies`` copies of ``rows`` rows and queries whose
    second half repeats the first; small integer entries, so every score
    is an exact float32 sum in any order and ties are many."""
    rng = np.random.default_rng(seed)
    Q = np.tile(rng.integers(-3, 4, (rows, d)), (copies, 1)).astype(np.float32)
    p = rng.integers(-3, 4, (B // 2, d)).astype(np.float32)
    p = np.concatenate([p, p])
    Qb = np.tile(rng.integers(-2, 3, rows), copies).astype(np.float32)
    pb = rng.integers(-2, 3, B).astype(np.float32)
    return p, Q, Qb, pb


@pytest.mark.parametrize("k", [1, 10, 150, 400])
@pytest.mark.parametrize("bias", [False, True])
def test_matmul_topk_and_topk_match_jax_order(k, bias):
    """Exact ties (duplicated rows of Q, integer scores) go to the smaller
    index and rows come back sorted, as ``lax.top_k`` gives them, at k = 1,
    10, the whole catalog (150) and past it (clamped); ``topk`` the same
    with and without ``sorted``.  Exact: every score is an integer."""
    p, Q, Qb, pb = _tie_tables(3)
    kw = dict(pb=pb, Qb=Qb) if bias else {}
    want_s, want_i = J.matmul_topk(p, Q, k, **kw)
    got_s, got_i = T.matmul_topk(p, Q, k, device="cpu", **kw)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    scores = p @ Q.T + ((pb[:, None] + Qb[None, :]) if bias else 0.0)
    want = J.topk(scores, k)
    for sort in (True, False):
        np.testing.assert_array_equal(
            T.topk(scores, k, sorted=sort, device="cpu"), want)
    np.testing.assert_array_equal(T.topk(scores[5], k, device="cpu"),
                                  J.topk(scores[5], k))


def test_card_route_past_k5_limits():
    """On the card k <= 1024 takes the single K5 launch at any width, and
    past it query chunks of ``torch.matmul`` + ``ordered_topk`` (each score
    block at most 1 GiB): the route is chosen by k, in the open."""
    from buffalo_tpu_torch.ops import topk as T

    assert T.k5_route(1024, 256) and T.k5_route(1, 13)
    assert not T.k5_route(1025, 40) and not T.k5_route(2000, 64)
    assert T.k5_route(10, 257) and T.k5_route(1024, 300)
    rng = np.random.default_rng(0)
    Q = np.round(rng.standard_normal((3000, 24)) * 4).astype(np.float32) / 4
    Q[1500:2000] = Q[:500]
    p = rng.integers(-2, 3, (37, 24)).astype(np.float32)
    Qb = np.round(rng.standard_normal(3000) * 4).astype(np.float32) / 4
    old = T._MATMUL_SCORES_BYTES
    try:
        T._MATMUL_SCORES_BYTES = 4 * 3000 * 5  # 5 queries per block here
        vals, idx = T.matmul_topn(torch.from_numpy(p), torch.from_numpy(Q),
                                  2000, torch.from_numpy(Qb))
    finally:
        T._MATMUL_SCORES_BYTES = old
    s = p.astype(np.float64) @ Q.T.astype(np.float64) + Qb[None, :]
    want = np.lexsort((np.arange(3000)[None, :].repeat(37, 0), -s),
                      axis=1)[:, :2000]
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(vals.numpy(),
                                  np.take_along_axis(s, want, 1))
