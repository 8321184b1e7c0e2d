"""The port's WARP against the JAX package's, end to end on the CPU.

Same MatrixMarket input (the ``ml100k_like`` fixture, with validation),
built by each package; ``np.random.seed`` set before both ``initialize()``
calls, so both start from the same P and Q and draw the same loss
triplets; the JAX package on one device, the port with ``device="cpu"``
(the plain versions of K10-K12).

The packages draw their candidates from different generators (threefry
and the port's Philox), so the parity runs replace the port's
``warp_candidates`` with the JAX package's draws, replayed on its key
chain: ``PRNGKey(seed)``, split once per epoch and ``fold_in(sub, chunk)``
per resident chunk, or split once per streamed chunk.  Tolerance after 3
epochs: factors within rtol 1e-4 / atol 1e-5 (the same float32 updates in
another summation order), the K schedule equal, each epoch's violation
rate within one triplet's 1/n (a margin at the threshold may flip), val
metrics within 1e-4.  The port's own-Philox runs are held to the floors
of ``tests/models/test_warp.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import buffalo_tpu as ref
import buffalo_tpu.ops.warp_kernels as JW
import buffalo_tpu_torch as port
import buffalo_tpu_torch.ops.warp_kernels as PW
from buffalo_tpu.data import MatrixMarketOptions as RefMMOptions
from buffalo_tpu.data import load as ref_load
from buffalo_tpu_torch.convert import from_jax_factors, load_reference_model
from buffalo_tpu_torch.data import MatrixMarketOptions as PortMMOptions
from buffalo_tpu_torch.data import load as port_load

TOL = dict(rtol=1e-4, atol=1e-5)
VAL_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions' many small ops run fastest on one thread, and
    then do not contend with other test processes' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
                   tmp_path_factory.mktemp("ref_warp")),
            _build(PortMMOptions, port_load, ml100k_like,
                   tmp_path_factory.mktemp("port_warp")))


def _model(pkg, data, seed, **kw):
    opt = pkg.WARPOption().get_default_option()
    opt.d = kw.pop("d", 16)
    opt.num_iters = kw.pop("num_iters", 3)
    opt.validation = {"topk": 10}
    opt.evaluation_period = 1  # the training callback sees every epoch
    opt.update(kw)
    if pkg is ref:
        opt.num_devices = 1
    else:
        opt.device = "cpu"
    model = pkg.WARP(opt, data=data)
    np.random.seed(seed)
    model.initialize()
    return model


def _train(model):
    """Per-epoch (train_loss, val_ndcg, val_auc)."""
    out = []
    model.train(training_callback=lambda i, m: out.append(
        (m["train_loss"], m["val_ndcg"], m["val_auc"])))
    return np.array(out)


def _jax_draws(seed, streamed):
    """The JAX package's candidate draws in the order its training loop takes
    them, as a stand-in for ``warp_candidates``."""
    state = {"rng": jax.random.PRNGKey(seed), "epoch": None, "sub": None}

    def draw(N, K, num_items, *, seed, epoch, chunk, device, slot_offset=0):
        if streamed:
            state["rng"], key = jax.random.split(state["rng"])
        else:
            if epoch != state["epoch"]:
                state["rng"], state["sub"] = jax.random.split(state["rng"])
                state["epoch"] = epoch
            key = jax.random.fold_in(state["sub"], chunk)
        return torch.from_numpy(np.array(jax.random.randint(
            key, (N, K), 0, num_items, dtype=jnp.int32)))

    return draw


CASES = {
    "fused": dict(),
    "split": dict(epoch_dispatch="split"),
    "streamed": dict(resident_mb=0),
    "l2": dict(score_func="l2"),
    "wide": dict(d=300),
    "adam_pcn_reg": dict(optimizer="adam", lr=0.02,
                         per_coordinate_normalize=True, reg_u=0.01,
                         reg_i=0.01, reg_j=0.01),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_matches_jax(datasets, monkeypatch, case):
    """3 epochs with the JAX package's candidates: factors, the K schedule,
    losses and validation metrics."""
    kw = CASES[case]
    ks = []
    original = JW.warp_epoch

    def record(*args, **kwargs):
        ks.append(kwargs["num_candidates"])
        return original(*args, **kwargs)

    monkeypatch.setattr(JW, "warp_epoch", record)
    a = _model(ref, datasets[0], seed=11, **kw)
    la = _train(a)
    monkeypatch.setattr(PW, "warp_candidates",
                        _jax_draws(int(a.opt.random_seed), "resident_mb" in kw))
    b = _model(port, datasets[1], seed=11, **kw)
    lb = _train(b)
    np.testing.assert_allclose(b.P, a.P, **TOL)
    np.testing.assert_allclose(b.Q, a.Q, **TOL)
    assert lb.shape == (3, 3)
    n = len(b._sub_samples[0])
    np.testing.assert_allclose(lb[:, 0], la[:, 0], rtol=0, atol=1.0 / n + 1e-7)
    np.testing.assert_allclose(lb[:, 1:], la[:, 1:], rtol=VAL_TOL)
    if "resident_mb" in kw:
        assert ks == [] and b.iteration_found == [None] * 3
    else:
        assert b.iteration_candidates == ks and len(ks) == 3
        assert all(0 < f <= 1 for f in b.iteration_found)
    assert np.linalg.norm(b.P, axis=1).max() <= 1 + 1e-6


def test_adaptive_schedule_grows_k(datasets, monkeypatch):
    """With few candidates' worth of violators (a high margin) the K budget
    doubles after an epoch with found_frac < 0.98, as in the JAX package."""
    ks = []
    original = JW.warp_epoch

    def record(*args, **kwargs):
        ks.append(kwargs["num_candidates"])
        return original(*args, **kwargs)

    monkeypatch.setattr(JW, "warp_epoch", record)
    kw = dict(threshold=-0.05, num_iters=4)
    a = _model(ref, datasets[0], seed=5, **kw)
    a.train()
    monkeypatch.setattr(PW, "warp_candidates",
                        _jax_draws(int(a.opt.random_seed), False))
    b = _model(port, datasets[1], seed=5, **kw)
    b.train()
    assert b.iteration_candidates == ks
    assert ks[0] == 16 and ks[-1] > 16
    np.testing.assert_allclose(b.P, a.P, **TOL)


def _floor_model(datasets, **kw):
    opt = port.WARPOption().get_default_option()
    opt.d = 16
    opt.num_iters = kw.pop("num_iters", 30)
    opt.validation = {"topk": 10}
    opt.evaluation_period = opt.num_iters
    opt.device = "cpu"
    opt.update(kw)
    m = port.WARP(opt, data=datasets[1])
    m.initialize()
    return m, m.train()


@pytest.mark.parametrize("probe_mode", ["lazy", "all"])
def test_own_rng_accuracy_floor_dot(datasets, probe_mode):
    _, r = _floor_model(datasets, probe_mode=probe_mode)
    assert r["val_ndcg"] > 0.25
    assert r["val_map"] > 0.15


def test_own_rng_l2_floor_and_unit_ball(datasets):
    m, r = _floor_model(datasets, score_func="l2", num_iters=25)
    assert r["val_ndcg"] > 0.06
    assert np.max(np.linalg.norm(m.P, axis=1)) <= 1.0 + 1e-4
    assert np.max(np.linalg.norm(m.Q, axis=1)) <= 1.0 + 1e-4
    assert r["train_loss"] < 1.0


def test_bad_options_raise(datasets):
    for kw, err in ((dict(optimizer="sgd"), ValueError),
                    (dict(epoch_dispatch="bogus"), ValueError),
                    (dict(probe_mode="bogus"), ValueError),
                    # a mesh of two shards, with no card and no devices
                    (dict(num_devices=2), RuntimeError)):
        with pytest.raises(err):
            _model(port, datasets[1], seed=1, **kw).train()


@pytest.mark.parametrize("score_func", ["dot", "l2"])
def test_save_load_both_directions_and_retrieval(datasets, tmp_path,
                                                 score_func):
    a = _model(ref, datasets[0], seed=2, score_func=score_func)
    a.train()
    b = _model(port, datasets[1], seed=2, score_func=score_func)
    b.P, b.Q = (t.numpy() for t in from_jax_factors(a.P, a.Q, device="cpu"))
    port_path, ref_path = str(tmp_path / "port.warp"), str(tmp_path / "r.warp")
    b.save(port_path)
    a.save(ref_path)
    by_ref = ref.WARP.new(port_path)
    np.testing.assert_array_equal(by_ref.Q, b.Q)
    assert by_ref.opt.score_func == score_func
    by_port = port.WARP.new(ref_path, device="cpu")
    np.testing.assert_array_equal(by_port.P, a.P)
    served = load_reference_model(ref_path, device="cpu")
    assert isinstance(served, port.WARP)
    assert type(load_reference_model(port_path, device="cpu")) is port.WARP
    users = ["u1", "u7", "u300"]
    assert served.topk_recommendation(users, topk=8) == \
        a.topk_recommendation(users, topk=8)
    got = served.most_similar("i3", topk=5)
    want = a.most_similar("i3", topk=5)
    assert [k for k, _ in got] == [k for k, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=1e-5)
    pairs = [(1, 2), (40, 7)]
    for k, v in a.get_scores(pairs).items():
        np.testing.assert_allclose(served.get_scores(pairs)[k], v, rtol=1e-6)
    ra, rb = a.get_validation_results(), b.get_validation_results()
    for k in ("ndcg", "map", "auc"):
        np.testing.assert_allclose(rb[k], ra[k], rtol=1e-5)
