"""The port's pLSI against the JAX package's, end to end on the CPU.

Same MatrixMarket input built by each package, ``np.random.seed`` set
before both ``initialize()`` calls so both start from the same P and Q;
the JAX package on one device, the port with ``device="cpu"`` (the plain
versions of K15 and K16).  pLSI draws nothing at random while it trains,
so after 3 epochs both tables are held to rtol 1e-4 (atol 1e-6: the
entries are probabilities, most below 1e-2) and the losses to 1e-5, for
each of the four epoch routes: the range layout (fused and group dispatch),
``range_layout=False`` (the rowwise padded batches with the element floor)
and the streamed batches past ``resident_mb``; and on a fixture whose head
item has more entries than a batch row may (8,192), so that it trains as a
segment batch in the range layout and the streamed route.
"""
import numpy as np
import pytest
import torch

import buffalo_tpu as ref
from buffalo_tpu.data import MatrixMarketOptions as RefMMOptions
from buffalo_tpu.data import load as ref_load
import buffalo_tpu_torch as port
from buffalo_tpu_torch.convert import from_jax_factors, load_reference_model
from buffalo_tpu_torch.data import MatrixMarketOptions as PortMMOptions
from buffalo_tpu_torch.data import load as port_load

TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_TOL = 1e-5


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
                   tmp_path_factory.mktemp("ref_plsi")),
            _build(PortMMOptions, port_load, ml100k_like,
                   tmp_path_factory.mktemp("port_plsi")))


@pytest.fixture(scope="module")
def head_datasets(tmp_path_factory):
    """8,300 users x 40 items: item 0 is in every user's list (a head
    item past the 8,192-entry row cap), plus 1-3 other items each."""
    root = tmp_path_factory.mktemp("plsi_head")
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


def _model(pkg, data, seed, **kw):
    opt = pkg.PLSIOption().get_default_option()
    opt.d = kw.pop("d", 8)
    opt.num_iters = kw.pop("num_iters", 3)
    opt.validation = kw.pop("validation", {"topk": 10})
    opt.evaluation_period = 1
    opt.update(kw)
    if pkg is ref:
        opt.num_devices = 1
    else:
        opt.device = "cpu"
    model = pkg.PLSI(opt, data=data)
    np.random.seed(seed)
    model.initialize()
    return model


def _losses(pkg, data, seed, **kw):
    """The model after training, and its per-epoch losses (the JAX package
    reports them to a callback, which it calls with validation on) or
    else its final loss."""
    seen = []
    m = _model(pkg, data, seed, **kw)
    res = m.train(
        training_callback=lambda i, met: seen.append(met["train_loss"]))
    return m, seen or [res["train_loss"]]


CASES = {
    "range_fused": dict(),
    "range_group": dict(epoch_dispatch="group"),
    "padded": dict(range_layout=False),
    "streamed": dict(resident_mb=0),
    # rows of 300 floats: past the 256 the kernels once took, which also
    # raised here on the CPU
    "wide": dict(d=300),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_matches_jax(datasets, case):
    kw = CASES[case]
    a, la = _losses(ref, datasets[0], 11, **kw)
    b, lb = _losses(port, datasets[1], 11, **kw)
    np.testing.assert_allclose(b.P, a.P, **TOL)
    np.testing.assert_allclose(b.Q, a.Q, **TOL)
    assert len(lb) == 3 and lb == b.iteration_losses
    np.testing.assert_allclose(lb, la, rtol=LOSS_TOL)
    assert lb[-1] < lb[0]
    np.testing.assert_allclose(b.P.sum(1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(b.Q.sum(0), 1.0, rtol=1e-5)


@pytest.mark.parametrize("case", ["range_fused", "streamed"])
def test_head_item_segment_batch_matches_jax(head_datasets, case):
    """The item side's head row (8,300 entries) is a segment batch of the
    range layout's colwise pass; the streamed route has no colwise pass,
    and its users' rows are all short."""
    from buffalo_tpu_torch.data.batching import BatchPlanner

    indptr = np.asarray(head_datasets[1].get_group("colwise")["indptr"])
    assert BatchPlanner(indptr).segment_plans
    kw = dict(CASES[case], validation={})
    a, la = _losses(ref, head_datasets[0], 3, **kw)
    b, lb = _losses(port, head_datasets[1], 3, **kw)
    np.testing.assert_allclose(b.P, a.P, **TOL)
    np.testing.assert_allclose(b.Q, a.Q, **TOL)
    np.testing.assert_allclose(lb, la, rtol=LOSS_TOL)


def test_inherit_and_save_load_both_directions(datasets, tmp_path):
    """A model saved by either package loads in the other; ``inherit``
    warm-starts from either package's file by string ids."""
    a = _model(ref, datasets[0], 2, num_iters=1)
    a.train()
    b = _model(port, datasets[1], 2, num_iters=1)
    b.train()
    port_path, ref_path = str(tmp_path / "p.plsi"), str(tmp_path / "r.plsi")
    b.save(port_path)
    a.save(ref_path)
    by_ref = ref.PLSI.new(port_path)
    np.testing.assert_array_equal(by_ref.P, b.P)
    assert by_ref.opt.alpha1 == b.opt.alpha1
    by_port = port.PLSI.new(ref_path, device="cpu")
    np.testing.assert_array_equal(by_port.Q, a.Q)
    served = load_reference_model(ref_path, device="cpu")
    assert type(served) is port.PLSI
    assert type(load_reference_model(port_path, device="cpu")) is port.PLSI
    users = ["u1", "u7", "u300"]
    assert served.topk_recommendation(users, topk=8) == \
        a.topk_recommendation(users, topk=8)
    P, Q = from_jax_factors(a.P, a.Q, device="cpu")
    np.testing.assert_array_equal(P.numpy(), a.P)
    np.testing.assert_array_equal(Q.numpy(), a.Q)
    for path, source in ((port_path, b), (ref_path, a)):
        inherit = {"model_path": path, "inherit_user": True,
                   "inherit_item": True}
        ma = _model(ref, datasets[0], 5, inherit_opt=inherit)
        mb = _model(port, datasets[1], 5, inherit_opt=inherit)
        for t in "PQ":
            np.testing.assert_array_equal(getattr(mb, t), getattr(ma, t))
            np.testing.assert_array_equal(getattr(mb, t), getattr(source, t))


def test_multi_device_raises(datasets):
    """Two shards without a card or named devices raise rather than share
    one device (the mesh itself trains in test_torch_mesh.py)."""
    with pytest.raises(RuntimeError, match="name the devices"):
        _model(port, datasets[1], 1, num_devices=2).train()
