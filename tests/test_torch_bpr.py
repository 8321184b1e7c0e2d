"""The port's BPR-MF against the JAX package's, end to end on the CPU.

Same MatrixMarket input (the ``ml100k_like`` fixture, with validation),
built by each package; ``np.random.seed`` set before both ``initialize()``
calls, so both start from the same P, Q, Qb and draw the same loss
triplets; the JAX package on one device, the port with ``device="cpu"``
(the plain versions of K8-K10).

The two packages draw negatives from different generators (threefry and
the port's Philox), so the parity runs inject the JAX package's draws
into the port: the resident epoch's negatives are those the JAX package's
``epoch_dispatch="split"`` run drew (``bpr_sample_negatives_epoch`` on its
per-epoch keys, recorded as it runs); the streaming path's are replayed
through ``sample_verified_negatives`` on the JAX training loop's
per-chunk key sequence and ``COOBatcher`` order.  Tolerance: the same float32 updates in
another summation order (scatter-adds against per-row sums), factors and
biases within rtol 1e-4 / atol 1e-5 after 3 epochs, and each epoch's loss,
val NDCG and AUC within rtol 1e-5 (readings over the 9 runs: factors at
most 2.5e-6 apart, losses and metrics 1.9e-7 relative).  The port's
own-RNG runs are held to the accuracy floors of
``tests/models/test_bpr.py``.
"""
import numpy as np
import pytest
import torch

import buffalo_tpu as ref
import buffalo_tpu.ops.sgd_kernels as JK
import buffalo_tpu_torch as port
import buffalo_tpu_torch.ops.sgd_kernels as PK
from buffalo_tpu.data import MatrixMarketOptions as RefMMOptions
from buffalo_tpu.data import load as ref_load
from buffalo_tpu.data.batching import COOBatcher as RefCOOBatcher
from buffalo_tpu_torch.convert import from_jax_factors, load_reference_model
from buffalo_tpu_torch.data import MatrixMarketOptions as PortMMOptions
from buffalo_tpu_torch.data import load as port_load
from buffalo_tpu_torch.data.batching import COOBatcher

TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-5


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
                   tmp_path_factory.mktemp("ref_bpr")),
            _build(PortMMOptions, port_load, ml100k_like,
                   tmp_path_factory.mktemp("port_bpr")))


def _model(pkg, data, seed, **kw):
    opt = pkg.BPRMFOption().get_default_option()
    opt.d = kw.pop("d", 16)
    opt.num_iters = kw.pop("num_iters", 3)
    opt.validation = {"topk": 10}
    opt.evaluation_period = 1  # the training callback sees every epoch
    opt.update(kw)
    if pkg is ref:
        opt.num_devices = 1
    else:
        opt.device = "cpu"
    model = pkg.BPRMF(opt, data=data)
    np.random.seed(seed)
    model.initialize()
    return model


def _train(model):
    """Per-epoch (train_loss, val_ndcg, val_auc)."""
    out = []
    model.train(training_callback=lambda i, m: out.append(
        (m["train_loss"], m["val_ndcg"], m["val_auc"])))
    return np.array(out)


def _close(a, b):
    np.testing.assert_allclose(b.P, a.P, **TOL)
    np.testing.assert_allclose(b.Q, a.Q, **TOL)
    np.testing.assert_allclose(b.Qb, a.Qb, **TOL)


def test_identical_initial_factors_and_loss_samples(datasets):
    a = _model(ref, datasets[0], seed=3)
    b = _model(port, datasets[1], seed=3)
    assert np.array_equal(a.P, b.P) and np.array_equal(a.Q, b.Q)
    assert np.array_equal(a.Qb, b.Qb)
    np.random.seed(5)
    a.sampling_loss_samples()
    np.random.seed(5)
    b.sampling_loss_samples()
    for x, y in zip(a._sub_samples, b._sub_samples):
        assert np.array_equal(x, y)


def test_coo_batcher_chunks_identical(datasets):
    a = RefCOOBatcher(datasets[0], chunk_size=1000, seed=4)
    b = COOBatcher(datasets[1], chunk_size=1000, seed=4)
    assert a.num_batches == b.num_batches
    for _ in range(2):
        for x, y in zip(a, b):
            for s, t in zip(x, y):
                assert np.array_equal(s, t)


CASES = {
    "sgd_capped": dict(),
    "sgd_uncapped": dict(max_step_norm=0.0, lr=0.02),
    "sgd_two_negatives": dict(num_negative_samples=2),
    "sgd_popularity_no_bias": dict(sampling_power=1.0, use_bias=False),
    "adagrad_pcn": dict(optimizer="adagrad", per_coordinate_normalize=True),
    "adam_pcn": dict(optimizer="adam", lr=0.02,
                     per_coordinate_normalize=True),
    "adam": dict(optimizer="adam", lr=0.02),
    "sgd_wide": dict(d=300),
}


@pytest.mark.parametrize("case", list(CASES))
def test_resident_train_matches_jax(datasets, monkeypatch, case):
    """3 epochs of the resident epoch with the JAX split run's negatives."""
    kw = dict(CASES[case], epoch_dispatch="split")
    drawn = []
    original = JK.bpr_sample_negatives_epoch

    def record(*args, **kwargs):
        out = original(*args, **kwargs)
        drawn.append(np.array(out))
        return out

    monkeypatch.setattr(JK, "bpr_sample_negatives_epoch", record)
    a = _model(ref, datasets[0], seed=11, **kw)
    la = _train(a)
    assert len(drawn) == 3

    def inject(users, num_items, *, epoch, chunk, **_):
        return torch.from_numpy(drawn[epoch][chunk]), None

    monkeypatch.setattr(PK, "sample_negatives", inject)
    b = _model(port, datasets[1], seed=11, **kw)
    lb = _train(b)
    _close(a, b)
    assert lb.shape == (3, 3)
    np.testing.assert_allclose(lb, la, rtol=LOSS_RTOL)
    np.testing.assert_allclose(b.iteration_losses, la[:, 0], rtol=LOSS_RTOL)
    if not kw.get("use_bias", True):
        assert np.all(b.Qb == 0)


def _replayed_stream_negatives(model, data, num_epochs):
    """The negatives the JAX package's streaming epochs draw: one key split per
    chunk from PRNGKey(seed), ``sample_verified_negatives`` on the chunk's
    users repeated per negative, chunks in ``COOBatcher``'s order."""
    import jax
    import jax.numpy as jnp

    opt = model.opt
    group = data.get_group("rowwise")
    words, log2 = JK.build_bloom(np.asarray(group["indptr"]),
                                 np.asarray(group["key"]))
    num_items = data.get_header()["num_items"]
    batch = min(max(model.num_nnz // 32, 1024), 1 << 19)
    coo = RefCOOBatcher(data, chunk_size=batch, shuffle=True,
                        seed=int(opt.random_seed))
    rng = jax.random.PRNGKey(int(opt.random_seed))
    out = []
    for _ in range(num_epochs):
        for users, _, _ in coo:
            rng, sub = jax.random.split(rng)
            u = jnp.repeat(jnp.asarray(users), opt.num_negative_samples)
            out.append(np.array(JK.sample_verified_negatives(
                sub, u, num_items, None, jnp.asarray(words), log2, True)))
    return out


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_streaming_train_matches_jax(datasets, monkeypatch, optimizer):
    """The streaming path (``resident_mb=0``), 3 epochs, on the JAX
    JAX training loop's replayed per-chunk negatives: sgd's capped step with the
    host-side lr decay, adagrad's accumulation and the epoch barrier."""
    kw = dict(optimizer=optimizer, resident_mb=0)
    a = _model(ref, datasets[0], seed=12, **kw)
    negs = iter(_replayed_stream_negatives(a, datasets[0], 3))
    la = _train(a)
    calls = []

    def inject(users, num_items, *, epoch, chunk, **_):
        calls.append((epoch, chunk))
        return torch.from_numpy(next(negs)), None

    monkeypatch.setattr(PK, "sample_negatives", inject)
    b = _model(port, datasets[1], seed=12, **kw)
    lb = _train(b)
    assert next(negs, None) is None and calls[-1][0] == 2
    _close(a, b)
    np.testing.assert_allclose(lb, la, rtol=LOSS_RTOL)


def _floor_model(**kw):
    opt = port.BPRMFOption().get_default_option()
    opt.d = 16
    opt.num_iters = kw.pop("num_iters", 30)
    opt.validation = {"topk": 10}
    opt.evaluation_period = opt.num_iters
    opt.device = "cpu"
    opt.update(kw)
    return opt


def test_own_rng_accuracy_floor_adagrad(datasets):
    m = port.BPRMF(_floor_model(optimizer="adagrad", lr=0.05, num_iters=40),
                   data=datasets[1])
    m.initialize()
    r = m.train()
    assert r["val_ndcg"] > 0.25
    assert r["val_map"] > 0.15


def test_own_rng_adam_trains(datasets):
    m = port.BPRMF(_floor_model(optimizer="adam", lr=0.02, num_iters=20),
                   data=datasets[1])
    m.initialize()
    assert m.train()["train_loss"] < np.log(2.0)


def test_own_rng_sgd_loss_decreases(datasets):
    m = port.BPRMF(_floor_model(optimizer="sgd", lr=0.1, num_iters=30,
                                batch_size=256), data=datasets[1])
    m.initialize()
    assert m.train()["train_loss"] < np.log(2.0)


def test_own_rng_random_positive_trains(datasets):
    runs = []
    for extra in ({}, {"random_positive": True}):
        np.random.seed(13)
        m = port.BPRMF(_floor_model(optimizer="adagrad", num_iters=20,
                                    **extra), data=datasets[1])
        m.initialize()
        runs.append((m, m.train()))
    assert runs[1][1]["val_ndcg"] > 0.2
    assert np.abs(runs[0][0].P - runs[1][0].P).max() > 1e-4


def test_split_and_fused_dispatch_identical(datasets):
    models = [_model(port, datasets[1], seed=7, epoch_dispatch=d)
              for d in ("fused", "split")]
    for m in models:
        m.train()
    assert np.array_equal(models[0].P, models[1].P)
    assert np.array_equal(models[0].Qb, models[1].Qb)
    bad = _model(port, datasets[1], seed=7, epoch_dispatch="bogus")
    with pytest.raises(ValueError, match="epoch_dispatch"):
        bad.train()


def test_multi_device_trains_on_the_mesh(datasets, monkeypatch):
    """num_devices=2 (two shards on the CPU) trains the dp mesh epoch
    (``tests/test_torch_bpr_mesh.py`` holds it to the JAX package)."""
    epochs = []
    original = PK.bpr_epoch

    def record(mesh, *args, **kwargs):
        epochs.append(mesh.size)
        return original(mesh, *args, **kwargs)

    monkeypatch.setattr(PK, "bpr_epoch", record)
    m = _model(port, datasets[1], seed=1, num_devices=2)
    m.opt.devices = ["cpu"] * 2
    r = m.train()
    assert epochs == [2] * 3
    assert np.isfinite(r["train_loss"]) and r["train_loss"] < np.log(2.0)


def test_save_load_both_directions(datasets, tmp_path):
    a = _model(ref, datasets[0], seed=2, optimizer="adagrad")
    a.train()
    b = _model(port, datasets[1], seed=2, optimizer="adagrad")
    b.P, b.Q, b.Qb = (t.numpy() for t in from_jax_factors(
        a.P, a.Q, a.Qb, device="cpu"))
    port_path, ref_path = str(tmp_path / "port.bpr"), str(tmp_path / "ref.bpr")
    b.save(port_path)
    a.save(ref_path)

    by_ref = ref.BPRMF.new(port_path)
    for name in ("P", "Q", "Qb"):
        np.testing.assert_array_equal(getattr(by_ref, name), getattr(b, name))
    assert by_ref.opt.d == b.opt.d
    by_port = port.BPRMF.new(ref_path, device="cpu")
    for name in ("P", "Q", "Qb"):
        np.testing.assert_array_equal(getattr(by_port, name), getattr(a, name))
    assert type(by_port.opt) is port.Option
    served = load_reference_model(ref_path, device="cpu")
    assert isinstance(served, port.BPRMF)
    np.testing.assert_array_equal(served.Qb, a.Qb)
    users = ["u1", "u7", "u300"]
    assert served.topk_recommendation(users, topk=8) == \
        a.topk_recommendation(users, topk=8)


def test_validation_and_scores_match_jax(datasets):
    """The same factors give the JAX package's validation metrics and
    scores (top-k with the item bias, ties to the smaller index)."""
    a = _model(ref, datasets[0], seed=4, optimizer="adagrad")
    a.train()
    b = _model(port, datasets[1], seed=4)
    b.P, b.Q, b.Qb = a.P.copy(), a.Q.copy(), a.Qb.copy()
    ra, rb = a.get_validation_results(), b.get_validation_results()
    for k in ("ndcg", "map", "accuracy", "auc", "rmse"):
        np.testing.assert_allclose(rb[k], ra[k], rtol=1e-5)
    pairs = [(1, 2), (40, 7), (499, 249)]
    for k, v in a.get_scores(pairs).items():
        np.testing.assert_allclose(b.get_scores(pairs)[k], v, rtol=1e-6)
