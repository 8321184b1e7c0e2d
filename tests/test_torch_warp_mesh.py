"""The port's WARP on a dp mesh against the JAX package's, on the CPU.

The JAX package trains on its 8 fake CPU devices (``tests/conftest.py``,
``num_devices=8``: ``warp_epoch_dp``); the port puts its 8 shards on the
CPU (``devices=["cpu"] * 8``), where every kernel runs its plain version.
Both start from the same ``np.random`` state on the ``ml100k_like``
fixture, with validation.

The packages draw their candidates from different generators, so the
parity runs replace the port's ``warp_candidates`` with the JAX package's
draws: the wrapped ``warp_epoch_dp`` records each epoch's key and K, and a
shard's candidates are the rows ``[slot_offset, slot_offset + N_loc)`` of
``randint(fold_in(key, chunk), (N, K))`` over the whole chunk, as the dp
epoch draws them.  The rule of ``test_torch_warp.py``: after 3 epochs the
factors within rtol 1e-4 / atol 1e-5, the K schedule equal, each epoch's
violation rate within one triplet's 1/n, val metrics within 1e-4.  The
port's mesh on its own generator is held to its single device at the same
(rounded) batch size, at the same tolerance.
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
from buffalo_tpu_torch.data import MatrixMarketOptions as PortMMOptions
from buffalo_tpu_torch.data import load as port_load

D = 8
TOL = dict(rtol=1e-4, atol=1e-5)
VAL_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions' many small ops run fastest on one thread."""
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
                   tmp_path_factory.mktemp("ref_warp_mesh")),
            _build(PortMMOptions, port_load, ml100k_like,
                   tmp_path_factory.mktemp("port_warp_mesh")))


def _model(pkg, data, seed, **kw):
    opt = pkg.WARPOption().get_default_option()
    opt.d = kw.pop("d", 16)
    opt.num_iters = kw.pop("num_iters", 3)
    opt.validation = {"topk": 10}
    opt.evaluation_period = 1  # the training callback sees every epoch
    opt.update(kw)
    if pkg is port:
        opt.device = "cpu"
        if int(opt.num_devices) > 1:
            opt.devices = ["cpu"] * int(opt.num_devices)
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


def _record_dp_keys(monkeypatch):
    """Wrap the JAX package's ``warp_epoch_dp``: each epoch's key, K and
    chunk width."""
    epochs = []
    original = JW.warp_epoch_dp

    def record(P, Q, opt_state, users, positives, indptr, bloom, rng_key,
               step, **kw):
        epochs.append((rng_key, kw["num_candidates"], users.shape[1]))
        return original(P, Q, opt_state, users, positives, indptr, bloom,
                        rng_key, step, **kw)

    monkeypatch.setattr(JW, "warp_epoch_dp", record)
    return epochs


def _jax_draws(epochs):
    """``warp_candidates`` replaced by the rows of the JAX dp epoch's draw."""
    def draw(N, K, num_items, *, seed, epoch, chunk, device, slot_offset=0):
        key, k, width = epochs[epoch]
        assert k == K
        cand = jax.random.randint(jax.random.fold_in(key, chunk), (width, K),
                                  0, num_items, dtype=jnp.int32)
        return torch.from_numpy(np.array(cand[slot_offset:slot_offset + N]))

    return draw


CASES = {
    "adagrad_dot": dict(),
    "adagrad_l2": dict(score_func="l2"),
    "adam_dot_pcn": dict(optimizer="adam", lr=0.02,
                         per_coordinate_normalize=True, reg_u=0.01,
                         reg_i=0.01, reg_j=0.01),
    "adam_l2": dict(optimizer="adam", lr=0.02, score_func="l2"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_matches_jax_mesh(datasets, monkeypatch, case):
    """3 epochs on 8 shards with the JAX package's candidates: factors, the
    K schedule, losses and validation metrics."""
    kw = dict(CASES[case], num_devices=D)
    epochs = _record_dp_keys(monkeypatch)
    a = _model(ref, datasets[0], seed=11, **kw)
    la = _train(a)
    assert len(epochs) == 3 and epochs[0][2] % D == 0
    offsets = []
    draw = _jax_draws(epochs)

    def counted(*args, **kwargs):
        offsets.append(kwargs["slot_offset"])
        return draw(*args, **kwargs)

    monkeypatch.setattr(PW, "warp_candidates", counted)
    b = _model(port, datasets[1], seed=11, **kw)
    lb = _train(b)
    np.testing.assert_allclose(b.P, a.P, **TOL)
    np.testing.assert_allclose(b.Q, a.Q, **TOL)
    assert b.iteration_candidates == [k for _, k, _ in epochs]
    n = len(b._sub_samples[0])
    np.testing.assert_allclose(lb[:, 0], la[:, 0], rtol=0, atol=1.0 / n + 1e-7)
    np.testing.assert_allclose(lb[:, 1:], la[:, 1:], rtol=VAL_TOL)
    N_loc = epochs[0][2] // D
    assert sorted(set(offsets)) == [g * N_loc for g in range(D)]
    assert all(0 < f <= 1 for f in b.iteration_found)
    assert np.linalg.norm(b.P, axis=1).max() <= 1 + 1e-6


@pytest.mark.parametrize("score_func", ["dot", "l2"])
def test_own_rng_mesh_matches_single_device(datasets, score_func):
    """The port's own draws: 8 shards against one device at the same
    (rounded) batch size, with the same found fractions and K schedule."""
    kw = dict(score_func=score_func, batch_size=1024, num_iters=4)
    one = _model(port, datasets[1], seed=4, **kw)
    lo = _train(one)
    mesh = _model(port, datasets[1], seed=4, num_devices=D, **kw)
    lm = _train(mesh)
    np.testing.assert_allclose(mesh.P, one.P, **TOL)
    np.testing.assert_allclose(mesh.Q, one.Q, **TOL)
    np.testing.assert_allclose(lm, lo, rtol=VAL_TOL, atol=1e-7)
    assert mesh.iteration_candidates == one.iteration_candidates
    np.testing.assert_allclose(mesh.iteration_found, one.iteration_found,
                               rtol=1e-6)


def test_split_dispatch_on_a_mesh_request_runs_one_device(datasets,
                                                          monkeypatch):
    """``epoch_dispatch="split"`` is a single-device mode: num_devices=8
    trains as one device does, with the JAX package's warning."""
    sizes, original = [], PW.warp_epoch

    def record(mesh, *args, **kwargs):
        sizes.append(mesh.size)
        return original(mesh, *args, **kwargs)

    monkeypatch.setattr(PW, "warp_epoch", record)
    a = _model(port, datasets[1], seed=2, epoch_dispatch="split",
               num_iters=2)
    a.train()
    b = _model(port, datasets[1], seed=2, epoch_dispatch="split",
               num_iters=2, num_devices=D)
    warned = []
    b.logger.warning = lambda msg, *args: warned.append(msg % args)
    b.train()
    np.testing.assert_array_equal(a.P, b.P)
    assert sizes == [1] * 4
    assert warned == ["epoch_dispatch='split' is a single-device mode; "
                      "running without the mesh"]


def test_mesh_model_saves_and_serves(datasets, tmp_path):
    """Save/load and top-k after a mesh run: the tables are shard 0's
    replica."""
    m = _model(port, datasets[1], seed=3, num_devices=D, num_iters=2)
    r = m.train()
    assert np.isfinite(r["train_loss"]) and r["val_ndcg"] > 0
    path = str(tmp_path / "warp.bin")
    m.save(path)
    back = port.WARP.new(path, device="cpu")
    np.testing.assert_array_equal(back.Q, m.Q)
    users = ["u1", "u7", "u300"]
    assert back.topk_recommendation(users, topk=5) == \
        m.topk_recommendation(users, topk=5)
