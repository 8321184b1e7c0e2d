"""The port's ``ParALS`` and ``IVFIndex`` against the JAX package's, on the
CPU.

The JAX ALS is trained once (d = 16 on the ``ml100k_like`` fixture, as
``tests/parallel/test_parallel.py`` trains it); each test gets a fresh
model of each package holding copies of those factors, carried to the
port with ``convert.from_jax_factors``.  Retrieval is held to the JAX
package's: scores within rtol 1e-5 (float32 sums in another order), ids
equal except where the two scores tie within it.  The index builds are
held to identical inverted files (``ids``, ``cell_ptr``) and centroids
within 1e-5, on data whose rows lie far from any cell boundary, where
float32 reordering cannot move a row to another cell.
"""
import numpy as np
import pytest

import buffalo_tpu as ref
import buffalo_tpu_torch as port
from buffalo_tpu.data import MatrixMarketOptions as RefMMOptions
from buffalo_tpu.data import load as ref_load
from buffalo_tpu.parallel import IVFIndex as RefIVF
from buffalo_tpu.parallel import ParALS as RefParALS
from buffalo_tpu.parallel import ParBPRMF as RefParBPRMF
from buffalo_tpu.parallel.ann import _merge_host as ref_merge
from buffalo_tpu.parallel.ann import _pick_cap as ref_pick_cap
from buffalo_tpu_torch.convert import from_jax_factors
from buffalo_tpu_torch.data import MatrixMarketOptions as PortMMOptions
from buffalo_tpu_torch.data import load as port_load
from buffalo_tpu_torch.parallel import IVFIndex, ParALS, ParBPRMF
from buffalo_tpu_torch.ops import retrieval_kernels as R
from buffalo_tpu_torch.parallel.ann import _BQ_CAPS, _L_CAPS, _merge_host, \
    _pick_cap

RTOL = 1e-5


def _build(options, load, fixture, root):
    opt = options().get_default_option()
    opt.input.main = fixture["path"]
    opt.input.uid = fixture["uid"]
    opt.input.iid = fixture["iid"]
    opt.data.path = str(root / "ml.bfo")
    opt.data.tmp_dir = str(root / "tmp")
    opt.data.validation = {"name": "sample", "p": 0.1, "max_samples": 300}
    data = load(opt)
    data.create()
    return data


@pytest.fixture(scope="module")
def datasets(ml100k_like, tmp_path_factory):
    return (_build(RefMMOptions, ref_load, ml100k_like,
                   tmp_path_factory.mktemp("ref_par")),
            _build(PortMMOptions, port_load, ml100k_like,
                   tmp_path_factory.mktemp("port_par")))


def _model(pkg, data):
    opt = pkg.ALSOption().get_default_option()
    opt.d = 16
    opt.num_iters = 6
    opt.validation = {}
    if pkg is port:
        opt.device = "cpu"
    return pkg.ALS(opt, data=data)


@pytest.fixture(scope="module")
def factors(datasets):
    m = _model(ref, datasets[0])
    np.random.seed(0)
    m.initialize()
    m.train()
    return np.array(m.P), np.array(m.Q)


@pytest.fixture
def pair(datasets, factors):
    """(JAX ALS, port ALS) holding the same trained factors."""
    a = _model(ref, datasets[0])
    a.P, a.Q = factors[0].copy(), factors[1].copy()
    b = _model(port, datasets[1])
    P, Q = from_jax_factors(*factors, device="cpu")
    b.P, b.Q = P.numpy(), Q.numpy()
    for m in (a, b):
        m.build_itemid_map()
        m.build_userid_map()
    return a, b


def _same_up_to_ties(got, want):
    gk, gs = np.asarray(got[0]), np.asarray(got[1])
    wk, ws = np.asarray(want[0]), np.asarray(want[1])
    assert gk.shape == wk.shape
    np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=1e-6)
    assert np.all((gk == wk) | np.isclose(gs, ws, rtol=RTOL, atol=1e-6))


def test_topk_recommendation_matches_jax(pair):
    a, b = pair
    keys = [f"u{i}" for i in range(0, 500, 7)] + ["not-a-user"]
    ka, ta, sa = RefParALS(a).topk_recommendation(keys, topk=10)
    kb, tb, sb = ParALS(b).topk_recommendation(keys, topk=10)
    assert ka == kb == keys[:-1]
    _same_up_to_ties((tb, sb), (ta, sa))
    _, ra, _ = RefParALS(a).topk_recommendation(keys[:5], topk=4, repr=True)
    _, rb, _ = ParALS(b).topk_recommendation(keys[:5], topk=4, repr=True)
    assert ra == rb and all(isinstance(t, str) for t in rb[0])


@pytest.mark.parametrize("group", ["item", "user"])
def test_most_similar_matches_jax(pair, group):
    a, b = pair
    n = 250 if group == "item" else 500
    pre = "i" if group == "item" else "u"
    keys = [f"{pre}{i}" for i in range(0, n, 9)]
    got = ParALS(b).most_similar(keys, topk=6, group=group)
    _same_up_to_ties(got, RefParALS(a).most_similar(keys, topk=6,
                                                     group=group))
    # normalized: the query itself first, at score ~1
    np.testing.assert_allclose(np.asarray(got[1])[:, 0], 1.0, rtol=1e-5)
    ra = RefParALS(a).most_similar(keys[:3], topk=3, group=group, repr=True)
    rb = ParALS(b).most_similar(keys[:3], topk=3, group=group, repr=True)
    assert ra[0] == rb[0]


def test_pool_padding_and_empty_pool(pair):
    a, b = pair
    pool = ["i1", "i2", "i3"]
    kb, tb, sb = ParALS(b).topk_recommendation(["u3"], topk=4, pool=pool)
    assert (tb[0, 3:] == -1).all() and (sb[0, 3:] == 0).all()
    _same_up_to_ties((tb, sb), RefParALS(a).topk_recommendation(
        ["u3"], topk=4, pool=pool)[1:])
    got = ParALS(b).most_similar(["i1", "i5"], topk=5, pool=pool)
    _same_up_to_ties(got, RefParALS(a).most_similar(["i1", "i5"], topk=5,
                                                    pool=pool))
    assert (np.asarray(got[0])[:, 3:] == -1).all()
    assert set(np.asarray(got[0])[:, :3].ravel()) == {1, 2, 3}
    for par in (ParALS(b), RefParALS(a)):
        with pytest.raises(RuntimeError, match="empty"):
            par.most_similar(["i1"], topk=5, pool=["nope"])


def test_approx_mode_matches_jax(pair):
    """approx=True: exact selection on bfloat16 queries in both packages
    on the CPU (the reference's approx_max_k is exact there)."""
    a, b = pair
    keys = [f"u{i}" for i in range(40)]
    pb = ParALS(b, approx=True)
    assert pb.approx is True
    got = pb.topk_recommendation(keys, topk=10)
    want = RefParALS(a, approx=True).topk_recommendation(keys, topk=10)
    _same_up_to_ties(got[1:], want[1:])


def test_normalized_factors_refused(pair):
    _, b = pair
    par = ParALS(b)
    par.most_similar(["i0"], topk=3)  # normalizes Q
    with pytest.raises(RuntimeError, match="normalized"):
        par.topk_recommendation(["u0"], topk=3)


def test_wrong_algo_and_mesh_rejected(pair):
    with pytest.raises(ValueError):
        ParALS(object())
    # a mesh must be a parallelism.Mesh, and two shards without a card or
    # named devices raise (sharded serving runs in test_torch_parallelism)
    with pytest.raises(TypeError, match="Mesh"):
        ParALS(pair[1], mesh=object())
    with pytest.raises(RuntimeError, match="name the devices"):
        ParALS(pair[1], num_devices=2)


@pytest.fixture(scope="module")
def bpr_factors(datasets):
    opt = ref.BPRMFOption().get_default_option()
    opt.update(d=16, num_iters=8, optimizer="adagrad", num_devices=1,
               validation={})
    m = ref.BPRMF(opt, data=datasets[0])
    np.random.seed(0)
    m.initialize()
    m.train()
    assert np.abs(m.Qb).max() > 1e-2     # the bias moves the ranking
    return np.array(m.P), np.array(m.Q), np.array(m.Qb)


@pytest.fixture
def bpr_pair(datasets, bpr_factors):
    """(JAX BPRMF, port BPRMF) holding the same trained P, Q and Qb."""
    models = []
    for pkg, data in ((ref, datasets[0]), (port, datasets[1])):
        opt = pkg.BPRMFOption().get_default_option()
        opt.update(d=16, validation={})
        if pkg is port:
            opt.device = "cpu"
        m = pkg.BPRMF(opt, data=data)
        m.P, m.Q, m.Qb = (t.copy() for t in bpr_factors)
        m.build_itemid_map()
        m.build_userid_map()
        models.append(m)
    return models


def test_parbprmf_matches_jax(bpr_pair):
    """Keys and scores (with the item bias) as the JAX package's ParBPRMF,
    with and without a pool; ``most_similar`` as ParALS's."""
    a, b = bpr_pair
    keys = [f"u{i}" for i in range(0, 500, 3)] + ["not-a-user"]
    ka, ta, sa = RefParBPRMF(a).topk_recommendation(keys, topk=10)
    kb, tb, sb = ParBPRMF(b).topk_recommendation(keys, topk=10)
    assert ka == kb == keys[:-1]
    _same_up_to_ties((tb, sb), (ta, sa))
    biased = np.asarray(b.P)[[int(k[1:]) for k in kb]] @ b.Q.T + b.Qb
    np.testing.assert_allclose(sb[:, 0], biased.max(axis=1), rtol=RTOL)
    pool = [f"i{i}" for i in range(0, 250, 4)]
    _same_up_to_ties(ParBPRMF(b).topk_recommendation(keys, topk=7,
                                                     pool=pool)[1:],
                     RefParBPRMF(a).topk_recommendation(keys, topk=7,
                                                        pool=pool)[1:])
    _, ra, _ = RefParBPRMF(a).topk_recommendation(keys[:4], topk=3, repr=True)
    _, rb, _ = ParBPRMF(b).topk_recommendation(keys[:4], topk=3, repr=True)
    assert ra == rb
    items = [f"i{i}" for i in range(0, 250, 11)]
    _same_up_to_ties(ParBPRMF(b).most_similar(items, topk=5),
                     RefParBPRMF(a).most_similar(items, topk=5))
    with pytest.raises(RuntimeError, match="normalized"):
        ParBPRMF(b).topk_recommendation(["u0"], topk=3)


# ------------------------------------------------------------------- IVF
def _clusters(seed, N=3000, d=8, C=12, spread=0.05):
    """Rows around C well-separated unit directions, with lognormal norms."""
    rng = np.random.default_rng(seed)
    basis = np.linalg.qr(rng.standard_normal((d, d)))[0]
    centers = np.vstack([basis, -basis])[:C]
    rows = centers[rng.integers(0, C, N)] + spread * rng.standard_normal(
        (N, d))
    return (rows * rng.lognormal(0, 0.3, (N, 1))).astype(np.float32)


def _same_index(got, want):
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.cell_ptr, want.cell_ptr)
    np.testing.assert_allclose(got.centroids, want.centroids, rtol=RTOL,
                               atol=1e-6)
    assert got.spill == want.spill


def test_one_lloyd_step_matches_jax():
    """From the same seeded centroids, one Lloyd step: the same
    assignment (the inverted file) and the same updated centroids."""
    table = _clusters(1)
    kw = dict(n_clusters=12, n_iters=1, spill=1, seed=3)
    _same_index(IVFIndex.build(table, device="cpu", **kw),
                RefIVF.build(table, **kw))


def test_lloyd_step_with_empty_cells_matches_jax():
    """Three distinct rows behind six cells: the seeded start draws
    duplicate centroids, whose later copies win no argmax tie and stay
    empty; one Lloyd step keeps them (normalized) in both packages."""
    rng = np.random.default_rng(4)
    table = rng.standard_normal((3, 8)).astype(np.float32)[
        rng.integers(0, 3, 600)]
    kw = dict(n_clusters=6, n_iters=1, spill=1, seed=5, mips_augment=False)
    got = IVFIndex.build(table, device="cpu", **kw)
    _same_index(got, RefIVF.build(table, **kw))
    assert (np.diff(got.cell_ptr) == 0).sum() >= 3


def _lloyd_update64(unit, assign, cent):
    """``lloyd``'s update (``buffalo_tpu/parallel/ann.py:228-241``) in
    float64 numpy, its row weights from the float32 squares as the
    reference computes them (a row whose squares underflow weighs 0)."""
    C, D = cent.shape
    w = (np.sum(unit * unit, axis=1, dtype=np.float32) > 0).astype(
        np.float64)
    sums = np.zeros((C, D))
    np.add.at(sums, assign, unit.astype(np.float64) * w[:, None])
    cnt = np.bincount(assign, weights=w, minlength=C)
    new = np.where(cnt[:, None] > 0, sums / np.maximum(cnt, 1.0)[:, None],
                   cent.astype(np.float64))
    return new / np.maximum(np.linalg.norm(new, axis=1, keepdims=True),
                            1e-12)


def _lloyd_case(case, N=400, D=12, C=9, seed=0):
    """(unit rows, cells, old centroids) with the case's cells: 2 and 5
    empty; 3's rows all of zero norm; 4, 6 and 8 of one row each; 7 two
    rows and one whose squares underflow in float32."""
    rng = np.random.default_rng(seed)
    unit = rng.standard_normal((N, D)).astype(np.float32)
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    assign = rng.choice([0, 1], N).astype(np.int32)
    cent = rng.standard_normal((C, D)).astype(np.float32)
    if case == "zero_norm_only":
        unit[:30] = 0.0
        assign[:30] = 3
    elif case == "one_member":
        assign[[10, 20, 30]] = [4, 6, 8]
    elif case == "underflow":
        unit[40] = 1e-23  # squares 1e-46: 0 in float32
        assign[[40, 41, 42]] = 7
    return unit, assign, cent


@pytest.mark.parametrize("case", ["empty_cells", "zero_norm_only",
                                  "one_member", "underflow"])
def test_kmeans_update_plain_matches_lloyd(case):
    """K7's plain version against ``lloyd``'s update: empty cells keep
    their centroid, rows of zero norm (or squares that underflow) weigh
    nothing, one-member cells take their row."""
    import torch

    unit, assign, cent = _lloyd_case(case)
    got = R.kmeans_update_plain(*map(torch.from_numpy, (unit, assign,
                                                        cent))).numpy()
    want = _lloyd_update64(unit, assign, cent)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    for c in (2, 5):  # never assigned
        np.testing.assert_allclose(got[c], cent[c] / np.linalg.norm(cent[c]),
                                   rtol=RTOL)
    if case == "zero_norm_only":
        np.testing.assert_allclose(got[3], cent[3] / np.linalg.norm(cent[3]),
                                   rtol=RTOL)
    if case == "one_member":
        np.testing.assert_allclose(got[[4, 6, 8]], unit[[10, 20, 30]],
                                   rtol=RTOL, atol=1e-7)
    if case == "underflow":
        mean = unit[[41, 42]].astype(np.float64).mean(0)
        np.testing.assert_allclose(got[7], mean / np.linalg.norm(mean),
                                   rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("D", [101, 300])
def test_run_order_sum_matches_plain(D):
    """The card's order, in float64 on the CPU: each cell's members in row
    order, the rows of nonzero norm summed in runs of ``kmeans_plan``'s
    run, the runs' sums and counts added in order; held to the plain
    version."""
    import torch

    rng = np.random.default_rng(D)
    N, C = 6000, 23
    unit = rng.standard_normal((N, D)).astype(np.float32)
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    unit[rng.random(N) < 0.05] = 0.0
    assign = rng.integers(0, C, N).astype(np.int32)
    assign[assign == 7] = 8
    assign[:700] = 3  # several runs
    cent = rng.standard_normal((C, D)).astype(np.float32)
    run = R.kmeans_plan(N, D, C)["run"]
    want = np.empty((C, D))
    for c in range(C):
        members = np.flatnonzero(assign == c)
        total, n = np.zeros(D), 0
        for lo in range(0, len(members), run):
            rows = unit[members[lo:lo + run]]
            keep = np.sum(rows * rows, axis=1, dtype=np.float32) > 0
            total = total + rows[keep].astype(np.float64).sum(0)
            n += int(keep.sum())
        mean = total / n if n else cent[c].astype(np.float64)
        want[c] = mean / max(np.linalg.norm(mean), 1e-12)
    got = R.kmeans_update_plain(*map(torch.from_numpy, (unit, assign, cent)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("D", [1, 41, 101, 300, 13_313])
def test_kmeans_plan_against_brute_force(D):
    """K7's chunks, run length and workspace: the run is the most rows (at
    most _K7_RUN) no more than the first power of two from twice the mean
    cell's rows; the run blocks exceed the runs of any assignment (the
    worst: cells of one row past a multiple of the run), so one is left for
    the empty cells; the workspace is the arrays' sum."""
    rng = np.random.default_rng(D)
    for N, C in ((0, 1), (1, 1), (777, 5), (9000, 97), (505_840, 711),
                 (120_000, 60_000), (1_000, 60_000), (3, 1_000)):
        plan = R.kmeans_plan(N, D, C)
        run = plan["run"]
        mean = -(-N // C)
        cap = min(p for p in (2 ** k for k in range(40)) if p >= 2 * mean)
        assert run == max(r for r in range(1, R._K7_RUN + 1) if r <= cap)
        assert plan["chunks"] == len(range(0, N, R._K7_CHUNK))
        worst = np.zeros(C, np.int64)  # as many runs as N rows allow
        left = N
        for c in range(C):
            take = min(left, (run + 1) if c < C - 1 else left)
            worst[c], left = take, left - take
        sizes = [worst, rng.multinomial(N, np.full(C, 1.0 / C))]
        for size in sizes:
            assert size.sum() == N
            assert int(np.ceil(size / run).sum()) < plan["run_blocks"]
        assert plan["ints"] == (4 * plan["run_blocks"] + plan["chunks"] * C
                                + C + 2 * (C + 1) + C + plan["run_blocks"]
                                + N + 1)
        assert plan["floats"] == plan["run_blocks"] * D


@pytest.mark.parametrize("mips_augment", [True, False])
def test_build_on_separated_clusters_matches_jax(mips_augment):
    table = _clusters(2)
    kw = dict(n_clusters=12, n_iters=10, spill=2, seed=0,
              mips_augment=mips_augment)
    got = IVFIndex.build(table, device="cpu", **kw)
    _same_index(got, RefIVF.build(table, **kw))
    assert got.centroids.shape[1] == 8 + mips_augment


def test_search_across_packages_through_npz(tmp_path):
    """An index built by one package, saved, loaded by the other: both
    searches agree (ids up to ties, scores within 1e-5)."""
    rng = np.random.default_rng(17)
    table = rng.standard_normal((4000, 24)).astype(np.float32)
    table *= rng.lognormal(0.0, 0.7, 4000).astype(np.float32)[:, None]
    queries = rng.standard_normal((300, 24)).astype(np.float32)
    jax_idx = RefIVF.build(table, n_probe=8, spill=2, seed=0)
    jax_idx.save(str(tmp_path / "jax"))
    loaded = IVFIndex.load(str(tmp_path / "jax.npz"), device="cpu")
    _same_up_to_ties(loaded.search(queries, 10), jax_idx.search(queries, 10))

    port_idx = IVFIndex.build(table, n_probe=8, spill=2, seed=0,
                              device="cpu")
    port_idx.save(str(tmp_path / "port.npz"))
    back = RefIVF.load(str(tmp_path / "port"))
    _same_up_to_ties(port_idx.search(queries, 10), back.search(queries, 10))
    assert back.spill == 2 and back.n_probe == 8


@pytest.mark.parametrize("n_probe", [8, 32, "all"])
def test_search_matches_jax(n_probe):
    """One index built by each package from the same table (the same
    seeded cells), searched at n_probe 8, 32 and every cell: ids equal up
    to ties, scores within 1e-5."""
    rng = np.random.default_rng(23)
    table = rng.standard_normal((6000, 20)).astype(np.float32)
    table *= rng.lognormal(0.0, 0.7, 6000).astype(np.float32)[:, None]
    queries = rng.standard_normal((400, 20)).astype(np.float32)
    kw = dict(n_clusters=60, spill=2, seed=0)
    got = IVFIndex.build(table, device="cpu", **kw)
    want = RefIVF.build(table, **kw)
    _same_index(got, want)
    for idx in (got, want):
        idx.n_probe = 60 if n_probe == "all" else n_probe
    _same_up_to_ties(got.search(queries, 10), want.search(queries, 10))


def test_full_probe_is_exact_and_spill_dedups():
    """Probing every cell equals the exact scan (up to ties), in both
    spill modes; spill = 2 never returns an item twice."""
    rng = np.random.default_rng(7)
    T = rng.standard_normal((3000, 12)).astype(np.float32)
    T /= np.linalg.norm(T, axis=1, keepdims=True)
    q = T[rng.integers(0, len(T), 200)]
    s = q @ T.T
    ref_i = np.argsort(-s, axis=1, kind="stable")[:, :7]
    for spill in (1, 2):
        idx = IVFIndex.build(T, n_clusters=50, n_probe=50, spill=spill,
                             device="cpu")
        got_i, got_v = idx.search(q, topk=7)
        _same_up_to_ties((got_i, got_v),
                         (ref_i, np.take_along_axis(s, ref_i, axis=1)))
        for row in got_i:
            assert len(set(row.tolist())) == len(row)


def test_ivf_empty_inputs():
    """Empty query batches and empty probed cells return -1 padding."""
    rng = np.random.default_rng(0)
    T = rng.normal(size=(64, 8)).astype(np.float32)
    T /= np.linalg.norm(T, axis=1, keepdims=True)
    for spill in (1, 2):
        idx = IVFIndex.build(T, n_clusters=8, n_probe=2, spill=spill,
                             device="cpu")
        ids, sc = idx.search(np.zeros((0, 8), np.float32), topk=5)
        assert ids.shape == (0, 5) and sc.shape == (0, 5)
        empty = IVFIndex.__new__(IVFIndex)
        empty.device = port.utils.resolve_device("cpu")
        empty.centroids = np.eye(2, 8, dtype=np.float32)
        empty.cell_ptr = np.array([0, 0, len(T)], dtype=np.int64)
        empty.ids = np.arange(len(T), dtype=np.int32)
        empty.table = T
        empty.n_probe = 1
        empty.spill = spill
        q = -empty.centroids[1][None, :] + 2 * empty.centroids[0][None, :]
        ids, sc = empty.search(q, topk=5)
        assert (ids == -1).all() and (sc == 0).all()


def test_mips_augment_round_trip_and_coverage(tmp_path):
    """MIPS-augmented cells (d + 1 centroids) search correctly, survive
    the .npz round trip, and cover a norm-spread catalog as well as
    direction-only cells."""
    rng = np.random.default_rng(17)
    N, d, B, topk = 4000, 48, 64, 10
    table = rng.normal(size=(N, d)).astype(np.float32)
    table *= rng.lognormal(0.0, 0.7, N).astype(np.float32)[:, None]
    queries = rng.normal(size=(B, d)).astype(np.float32)
    exact = np.argsort(-(queries @ table.T), axis=1)[:, :topk]

    def recall(idx):
        ids, _ = idx.search(queries, topk)
        return np.mean([len(set(ids[b]) & set(exact[b])) / topk
                        for b in range(B)])

    aug = IVFIndex.build(table, n_probe=16, spill=2, seed=0, device="cpu")
    plain = IVFIndex.build(table, n_probe=16, spill=2, seed=0,
                           mips_augment=False, device="cpu")
    assert aug.centroids.shape[1] == d + 1
    assert recall(aug) >= recall(plain) - 0.02 and recall(aug) > 0.5
    aug.save(str(tmp_path / "aug.npz"))
    loaded = IVFIndex.load(str(tmp_path / "aug.npz"), device="cpu")
    a, b = aug.search(queries, topk), loaded.search(queries, topk)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_ann_hook_by_path_and_group_scope(pair, tmp_path):
    """set_ann_index takes a saved index's path; the item index serves
    item queries only (one index per group)."""
    a, b = pair
    par = ParALS(b)
    ukeys = [f"u{i}" for i in range(6)]
    exact_u = par.most_similar(ukeys, topk=5, group="user")
    b.normalize("item")
    index = IVFIndex.build(b.Q, n_clusters=8, n_probe=8, device="cpu")
    index.save(str(tmp_path / "ivf"))
    par.set_ann_index(str(tmp_path / "ivf.npz"))
    keys = [f"i{i}" for i in range(10)]
    via_path = par.most_similar(keys, topk=5)
    par.set_ann_index(index)
    np.testing.assert_array_equal(via_path[0], par.most_similar(keys, 5)[0])
    # probing all 8 cells: the exact scan
    _same_up_to_ties(via_path, ParALS(b).most_similar(keys, topk=5,
                                                      pool=np.arange(250)))
    np.testing.assert_array_equal(
        exact_u[0], par.most_similar(ukeys, topk=5, group="user")[0])


def test_pick_cap_and_merge_host_match_jax():
    rng = np.random.default_rng(3)
    for lens in (np.full(1000, 150), np.full(10, 5000),
                 rng.integers(0, 3000, 500), np.array([], np.int64)):
        assert _pick_cap(lens, _L_CAPS) == ref_pick_cap(lens, _L_CAPS)
        assert _pick_cap(lens, _BQ_CAPS, 64) == \
            ref_pick_cap(lens, _BQ_CAPS, 64)
    T_, bq, kk, B = 30, 16, 5, 40
    vals = rng.standard_normal((T_, bq, kk)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.2] = -np.inf
    pos = rng.integers(0, 200, (T_, bq, kk)).astype(np.int32)
    qidx = rng.integers(0, B, (T_, bq)).astype(np.int32)
    qmask = rng.random((T_, bq)) < 0.8
    ids = rng.permutation(np.repeat(np.arange(100, dtype=np.int32), 2))
    for spill in (1, 2):
        got = _merge_host(vals, pos, qidx, qmask, ids, B, 7, spill)
        want = ref_merge(vals, pos, qidx, qmask, ids, B, 7, spill)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
