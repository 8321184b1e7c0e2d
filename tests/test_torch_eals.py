"""The port's eALS against the JAX package's, end to end on the CPU.

Same MatrixMarket input built by each package, ``np.random.seed`` set
before both ``initialize()`` calls so both start from the same P and Q;
the JAX package on one device, the port with ``device="cpu"`` (the plain
versions of K13 and K14).  eALS draws nothing at random while it trains,
so after 3 epochs Q is held to the JAX package's own range-vs-COO
tolerance (rtol 1e-4, atol 1e-6, ``tests/models/test_eals_plsi.py:92-93``)
and the RMSE to 1e-5.  That test holds only Q: P grows to ~75 here, where
float32's spacing is 8e-6, and the JAX package's own two layouts (the same
math in another order) end 1.2e-4 apart on it.  So each table is also held
within twice that distance of the JAX package's (the largest element-wise
difference between its range and COO runs of the same case).  On the
``ml100k_like`` fixture (range layout, both dispatches; the
``range_layout=False`` rows path) and on a fixture whose head item has
more entries than a range batch's row may (8,192), so that it trains as a
segment batch.
"""
import numpy as np
import pytest
import torch

import buffalo_tpu as ref
from buffalo_tpu.data import MatrixMarketOptions as RefMMOptions
from buffalo_tpu.data import load as ref_load
from buffalo_tpu.parallel.base import ParEALS as RefParEALS
import buffalo_tpu_torch as port
from buffalo_tpu_torch.convert import load_reference_model
from buffalo_tpu_torch.data import MatrixMarketOptions as PortMMOptions
from buffalo_tpu_torch.data import load as port_load

TOL = dict(rtol=1e-4, atol=1e-6)
RMSE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions' many small ops run fastest on one thread, and
    then do not contend with other test processes' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(options, load, fixture, root, validation=True):
    opt = options().get_default_option()
    opt.input.main = fixture["path"]
    opt.input.uid = fixture["uid"]
    opt.input.iid = fixture["iid"]
    opt.data.path = str(root / "ml.bfo")
    opt.data.tmp_dir = str(root / "tmp")
    opt.data.validation = ({"name": "sample", "p": 0.1, "max_samples": 300}
                           if validation else {})
    data = load(opt)
    data.create()
    return data


@pytest.fixture(scope="module")
def datasets(ml100k_like, tmp_path_factory):
    return (_build(RefMMOptions, ref_load, ml100k_like,
                   tmp_path_factory.mktemp("ref_eals")),
            _build(PortMMOptions, port_load, ml100k_like,
                   tmp_path_factory.mktemp("port_eals")))


@pytest.fixture(scope="module")
def head_datasets(tmp_path_factory):
    """8,300 users x 40 items: item 0 is in every user's list (a head
    item past the 8,192-entry row cap), plus 1-3 other items each."""
    root = tmp_path_factory.mktemp("eals_head")
    rng = np.random.default_rng(8)
    num_users, num_items = 8300, 40
    lines = []
    for u in range(num_users):
        items = [0] + list(rng.choice(np.arange(1, num_items),
                                      int(rng.integers(1, 4)), replace=False))
        lines += [f"{u + 1} {i + 1} {int(rng.integers(1, 6))}" for i in items]
    path = root / "main.mm"
    path.write_text("%%MatrixMarket matrix coordinate real general\n"
                    f"{num_users} {num_items} {len(lines)}\n"
                    + "\n".join(lines) + "\n")
    (root / "uid").write_text("\n".join(f"u{i}" for i in range(num_users)))
    (root / "iid").write_text("\n".join(f"i{i}" for i in range(num_items)))
    fixture = {"path": str(path), "uid": str(root / "uid"),
               "iid": str(root / "iid")}
    return (_build(RefMMOptions, ref_load, fixture, root / "ref", False),
            _build(PortMMOptions, port_load, fixture, root / "port", False))


def _noise(data, seed, **kw):
    """The JAX package's own range-vs-COO distance: the largest difference
    per table between its two layouts' runs."""
    runs = [_model(ref, data, seed, **kw, range_layout=layout)
            for layout in (True, False)]
    for m in runs:
        m.train()
    return {t: float(np.abs(getattr(runs[0], t) - getattr(runs[1], t)).max())
            for t in "PQ"}


def _close(a, b, noise, fixed=True):
    """Port model b against JAX model a (``fixed``: Q also at TOL)."""
    if fixed:
        np.testing.assert_allclose(b.Q, a.Q, **TOL)
    for t in "PQ":
        diff = float(np.abs(getattr(b, t) - getattr(a, t)).max())
        assert diff <= 2 * noise[t], (t, diff, noise[t])


def _model(pkg, data, seed, **kw):
    opt = pkg.EALSOption().get_default_option()
    opt.d = kw.pop("d", 8)
    opt.num_iters = kw.pop("num_iters", 3)
    opt.validation = kw.pop("validation", {"topk": 10})
    opt.evaluation_period = 1
    opt.update(kw)
    if pkg is ref:
        opt.num_devices = 1
    else:
        opt.device = "cpu"
    model = pkg.EALS(opt, data=data)
    np.random.seed(seed)
    model.initialize()
    return model


CASES = {
    "range_fused": dict(),
    "range_group": dict(epoch_dispatch="group"),
    "rows": dict(range_layout=False),
    "wide": dict(d=300),
}


@pytest.fixture(scope="module")
def noise(datasets):
    return _noise(datasets[0], 11)


@pytest.mark.parametrize("case", list(CASES))
def test_train_matches_jax(datasets, noise, case):
    kw = CASES[case]
    a = _model(ref, datasets[0], seed=11, **kw)
    ra = a.train()
    b = _model(port, datasets[1], seed=11, **kw)
    rb = b.train()
    if "d" in kw:
        # rows of 300 floats over 250 items: the JAX package's own two
        # layouts part by ~1e-4 on Q, so its distance at this width is
        # the rule for both tables
        _close(a, b, _noise(datasets[0], 11, d=kw["d"]), fixed=False)
    else:
        _close(a, b, noise)
    np.testing.assert_allclose(rb["train_loss"], ra["train_loss"],
                               rtol=RMSE_TOL)
    np.testing.assert_allclose(rb["val_ndcg"], ra["val_ndcg"], rtol=1e-4)
    losses = b.iteration_losses
    assert len(losses) == 3 and losses[-1] < losses[0]


def test_head_item_segment_batch_matches_jax(head_datasets):
    """The item side's head row (8,300 entries) trains as a segment batch
    in both packages."""
    from buffalo_tpu_torch.data.batching import BatchPlanner

    indptr = np.asarray(head_datasets[1].get_group("colwise")["indptr"])
    assert BatchPlanner(indptr).segment_plans
    a = _model(ref, head_datasets[0], seed=3, validation={})
    ra = a.train()
    b = _model(port, head_datasets[1], seed=3, validation={})
    rb = b.train()
    _close(a, b, _noise(head_datasets[0], 3, validation={}))
    np.testing.assert_allclose(rb["train_loss"], ra["train_loss"],
                               rtol=RMSE_TOL)


def test_par_eals_topk_matches_jax(datasets):
    a = _model(ref, datasets[0], seed=4, num_iters=2)
    a.train()
    b = _model(port, datasets[1], seed=4, num_iters=2)
    b.P, b.Q = a.P.copy(), a.Q.copy()
    users = [f"u{i}" for i in range(0, 500, 7)]
    _, ids_a, sc_a = RefParEALS(a).topk_recommendation(users, topk=10)
    _, ids_b, sc_b = port.ParEALS(b).topk_recommendation(users, topk=10)
    ids_a, ids_b = np.asarray(ids_a), np.asarray(ids_b)
    np.testing.assert_allclose(sc_b, sc_a, rtol=1e-5, atol=1e-6)
    # ids equal except where two scores tie within float32 rounding
    differ = ids_a != ids_b
    assert differ.mean() < 0.02
    for r, c in zip(*np.nonzero(differ)):
        assert abs(sc_a[r, c] - sc_b[r, c]) <= 1e-5 * abs(sc_a[r, c]) + 1e-6
    items, _ = port.ParEALS(b).most_similar(["i3", "i9"], topk=5)
    assert np.asarray(items).shape == (2, 5)


def test_save_load_both_directions(datasets, tmp_path):
    a = _model(ref, datasets[0], seed=2, num_iters=1)
    a.train()
    b = _model(port, datasets[1], seed=2, num_iters=1)
    b.train()
    port_path, ref_path = str(tmp_path / "p.eals"), str(tmp_path / "r.eals")
    b.save(port_path)
    a.save(ref_path)
    by_ref = ref.EALS.new(port_path)
    np.testing.assert_array_equal(by_ref.P, b.P)
    assert by_ref.opt.c0 == b.opt.c0
    by_port = port.EALS.new(ref_path, device="cpu")
    np.testing.assert_array_equal(by_port.Q, a.Q)
    served = load_reference_model(ref_path, device="cpu")
    assert isinstance(served, port.EALS)
    assert type(load_reference_model(port_path, device="cpu")) is port.EALS
    users = ["u1", "u7", "u300"]
    assert served.topk_recommendation(users, topk=8) == \
        a.topk_recommendation(users, topk=8)


def test_negative_weights_and_multi_device(datasets):
    m = _model(port, datasets[1], seed=1)
    C = m._get_negative_weights()
    np.testing.assert_allclose(C.sum(), m.opt.c0, rtol=1e-4)
    r = _model(ref, datasets[0], seed=1)
    np.testing.assert_array_equal(C, r._get_negative_weights())
    # two shards without a card or named devices raise (the mesh itself
    # trains in test_torch_mesh.py)
    with pytest.raises(RuntimeError, match="name the devices"):
        _model(port, datasets[1], seed=1, num_devices=2).train()
