"""The port's mesh training against the JAX package's, on the CPU.

The JAX package trains on its 8 fake CPU devices (``tests/conftest.py``,
``num_devices=8``); the port puts its 8 shards on the CPU
(``devices=["cpu"] * 8``), where every kernel runs its plain version.  Both
start from the same ``np.random`` state.

ALS, each mesh path the JAX driver has: "dp+tp" on the per-shard range
layout, "dp" (replicated tables, batch rows split over the shards), "tp"
with ``range_layout=False`` (row-sharded tables, scatter by global id) and
the streamed path (``resident_mb=0``, which falls back from the range
intent).  ``llt`` solves each row exactly: one epoch is held to 1e-4
(relative Frobenius norm per table, and the loss).  ``manual_cg`` over 3
epochs is held to a float64 witness (partial gramians summed over shards
round differently from one product): losses per epoch within rtol 1e-3,
and both packages' float32 mesh factors within twice the JAX package's
single-device float32 distance from the port's float64 run of the same
mesh path (see the test for why not the port's own distance).  The
port's mesh is also held to its own single-device run at the JAX package's
tolerances (``tests/models/test_als.py:167-189``).

eALS at the rule of ``test_torch_eals.py`` (Q 1e-4 / 1e-6 abs, each table
within twice the JAX package's own range-vs-COO distance, RMSE 1e-5); pLSI
with P and Q at 1e-4 / 1e-6 abs and the loss at 1e-5.  A fixture whose head
item is past the 8,192-entry row cap runs each model's segment batches
(global ids, written back to the owning shards).
"""
import numpy as np
import pytest
import torch

import buffalo_tpu as ref
import buffalo_tpu_torch as port
from buffalo_tpu.data import MatrixMarketOptions as RefMMOptions
from buffalo_tpu.data import load as ref_load
from buffalo_tpu_torch import parallelism as par
from buffalo_tpu_torch.data import MatrixMarketOptions as PortMMOptions
from buffalo_tpu_torch.data import load as port_load
from buffalo_tpu_torch.data.batching import BatchPlanner
from buffalo_tpu_torch.ops import plsi_kernels as PK

D = 8
TOL = dict(rtol=1e-4, atol=1e-6)


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
    opt.data.validation = {}
    data = load(opt)
    data.create()
    return data


@pytest.fixture(scope="module")
def datasets(ml100k_like, tmp_path_factory):
    return (_build(RefMMOptions, ref_load, ml100k_like,
                   tmp_path_factory.mktemp("ref_mesh")),
            _build(PortMMOptions, port_load, ml100k_like,
                   tmp_path_factory.mktemp("port_mesh")))


@pytest.fixture(scope="module")
def head_datasets(tmp_path_factory):
    """8,300 users x 40 items: item 0 is in every user's list (a head
    item past the 8,192-entry row cap, a segment batch), plus 1-3 other
    items each."""
    root = tmp_path_factory.mktemp("mesh_head")
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
    return (_build(RefMMOptions, ref_load, fixture, root / "ref"),
            _build(PortMMOptions, port_load, fixture, root / "port"))


def _model(pkg, name, data, seed, float64=False, **kw):
    opt = getattr(pkg, name + "Option")().get_default_option()
    opt.d = kw.pop("d", 8)
    opt.num_iters = kw.pop("num_iters", 3)
    opt.validation = {}
    opt.update(kw)
    if pkg is port:
        opt.device = "cpu"
        if int(opt.num_devices) > 1:
            opt.devices = ["cpu"] * int(opt.num_devices)
    model = getattr(pkg, name)(opt, data=data)
    np.random.seed(seed)
    model.initialize()
    if float64:
        model.P, model.Q = model.P.astype(np.float64), \
            model.Q.astype(np.float64)
    return model


def _train(model):
    losses = []
    result = model.train(
        training_callback=lambda i, m: losses.append(m["train_loss"]))
    return result["train_loss"], losses


def _rel(x, y):
    return float(np.linalg.norm(x - y) / np.linalg.norm(y))


ALS_CASES = {
    "dp_tp": dict(sharding="dp+tp"),
    "dp": dict(sharding="dp"),
    "tp_scatter": dict(sharding="dp+tp", range_layout=False),
    "streamed": dict(sharding="dp+tp", resident_mb=0),
}


@pytest.mark.parametrize("case", list(ALS_CASES))
def test_als_llt_one_epoch_matches_jax(datasets, case):
    kw = dict(ALS_CASES[case], optimizer="llt", num_iters=1, d=16,
              num_devices=D)
    a = _model(ref, "ALS", datasets[0], 5, **kw)
    b = _model(port, "ALS", datasets[1], 5, **kw)
    la, _ = _train(a)
    lb, _ = _train(b)
    assert b._mesh_range is None
    assert abs(lb - la) <= 1e-4 * la
    for t in "PQ":
        assert _rel(getattr(b, t), getattr(a, t)) < 1e-4, t


@pytest.mark.parametrize("case", list(ALS_CASES))
def test_als_manual_cg_three_epochs_by_float64_witness(datasets, case):
    """The float64 run of the port's mesh path is the witness.  The JAX
    package's mesh runs are themselves up to about 2x further from it
    than the port's float32 run ("dp" the most), so "the packages within
    2x the port's distance" would hold the port to a noise the reference
    does not meet.  Instead both float32 mesh runs are held within 2x the
    JAX package's own single-device float32 distance from the witness:
    the port's exact math is the reference's up to the reference's own
    float32 noise, and the port adds no more noise than the reference
    has."""
    kw = dict(ALS_CASES[case], optimizer="manual_cg", d=16, num_devices=D)
    a = _model(ref, "ALS", datasets[0], 5, **kw)
    b = _model(port, "ALS", datasets[1], 5, **kw)
    c = _model(port, "ALS", datasets[1], 5, float64=True, **kw)
    s = _model(ref, "ALS", datasets[0], 5, optimizer="manual_cg", d=16,
               num_devices=1)
    _, la = _train(a)
    _, lb = _train(b)
    _train(c)
    _train(s)
    np.testing.assert_allclose(lb, la, rtol=1e-3)
    for t in "PQ":
        noise = _rel(getattr(s, t), getattr(c, t))
        for m in (a, b):
            assert _rel(getattr(m, t), getattr(c, t)) <= 2 * noise, t


@pytest.mark.parametrize("case", ["dp_tp", "tp_scatter"])
def test_als_mesh_matches_single_device(datasets, case):
    """The JAX package's own mesh-vs-one-device tolerances."""
    kw = dict(ALS_CASES[case], d=12, num_iters=4)
    a = _model(port, "ALS", datasets[1], 6, num_devices=1, **kw)
    b = _model(port, "ALS", datasets[1], 6, num_devices=D, **kw)
    la, _ = _train(a)
    lb, _ = _train(b)
    assert b._mesh_range is None
    assert abs(la - lb) < 5e-3
    np.testing.assert_allclose(b.Q, a.Q, rtol=5e-2, atol=5e-3)


def test_als_mesh_counts_collectives(datasets):
    """One "dp+tp" epoch: per half one all-reduce of the gramian and one
    all-gather of the fixed side, and one all-reduce of the loss."""
    m = _model(port, "ALS", datasets[1], 1, num_iters=1, num_devices=D,
               sharding="dp+tp")
    par.reset_counts()
    m.train()
    assert par.all_reduce_sum.calls == 3
    assert par.all_gather_rows.calls == 2 + 2  # + to_host's gathers
    assert par.all_reduce_sum.dist_calls == 0


def _noise(data, seed, **kw):
    """The JAX package's own range-vs-COO eALS distance per table."""
    runs = [_model(ref, "EALS", data, seed, num_devices=1,
                   range_layout=layout, **kw) for layout in (True, False)]
    for m in runs:
        m.train()
    return {t: float(np.abs(getattr(runs[0], t) - getattr(runs[1], t)).max())
            for t in "PQ"}


def _eals_close(a, b, noise):
    np.testing.assert_allclose(b.Q, a.Q, **TOL)
    for t in "PQ":
        diff = float(np.abs(getattr(b, t) - getattr(a, t)).max())
        assert diff <= 2 * noise[t], (t, diff, noise[t])


def test_eals_mesh_matches_jax(datasets):
    a = _model(ref, "EALS", datasets[0], 11, num_devices=D)
    b = _model(port, "EALS", datasets[1], 11, num_devices=D)
    ra, rb = a.train(), b.train()
    _eals_close(a, b, _noise(datasets[0], 11))
    np.testing.assert_allclose(rb["train_loss"], ra["train_loss"], rtol=1e-5)
    assert b.iteration_losses[-1] < b.iteration_losses[0]


def test_plsi_mesh_matches_jax(datasets):
    a = _model(ref, "PLSI", datasets[0], 4, num_devices=D)
    b = _model(port, "PLSI", datasets[1], 4, num_devices=D)
    _, la = _train(a)
    _, lb = _train(b)
    assert b._mesh_range is None
    np.testing.assert_allclose(lb, la, rtol=1e-5)
    for t in "PQ":
        np.testing.assert_allclose(getattr(b, t), getattr(a, t), rtol=1e-4,
                                   atol=1e-6)


def test_head_item_segment_rows_on_the_mesh(head_datasets):
    """Each model's segment batches (the head item's 8,300 entries) on an
    8-shard mesh against the JAX package's."""
    indptr = np.asarray(head_datasets[1].get_group("colwise")["indptr"])
    assert BatchPlanner(indptr).segment_plans
    a = _model(ref, "ALS", head_datasets[0], 3, optimizer="llt",
               num_iters=1, num_devices=D, sharding="dp+tp")
    b = _model(port, "ALS", head_datasets[1], 3, optimizer="llt",
               num_iters=1, num_devices=D, sharding="dp+tp")
    la, _ = _train(a)
    lb, _ = _train(b)
    assert abs(lb - la) <= 1e-4 * la
    for t in "PQ":
        assert _rel(getattr(b, t), getattr(a, t)) < 1e-4, t
    a = _model(ref, "PLSI", head_datasets[0], 3, num_iters=2, num_devices=D)
    b = _model(port, "PLSI", head_datasets[1], 3, num_iters=2, num_devices=D)
    _, la = _train(a)
    _, lb = _train(b)
    np.testing.assert_allclose(lb, la, rtol=1e-5)
    for t in "PQ":
        np.testing.assert_allclose(getattr(b, t), getattr(a, t), rtol=1e-4,
                                   atol=1e-6)
    a = _model(ref, "EALS", head_datasets[0], 3, num_iters=2, num_devices=D)
    b = _model(port, "EALS", head_datasets[1], 3, num_iters=2, num_devices=D)
    ra, rb = a.train(), b.train()
    _eals_close(a, b, _noise(head_datasets[0], 3, num_iters=2))
    np.testing.assert_allclose(rb["train_loss"], ra["train_loss"], rtol=1e-5)


def test_k16_split_matches_the_full_mstep():
    """K16's two sharded halves (column sums, all-reduced, then the
    division) over 4 row shards equal the one-table M-step."""
    rng = np.random.default_rng(0)
    Pn = torch.from_numpy(rng.random((40, 6)).astype(np.float32))
    Qn = torch.from_numpy(rng.random((32, 6)).astype(np.float32))
    pm = torch.from_numpy((rng.random(40) > 0.2).astype(np.float32))
    qm = torch.from_numpy((rng.random(32) > 0.2).astype(np.float32))
    kw = dict(alpha1=0.3, alpha2=0.7, num_items=int(qm.sum()))
    P1, Q1 = Pn.clone(), Qn.clone()
    PK.plsi_mstep(P1, Q1, p_mask=pm, q_mask=qm, **kw)
    mesh = par.get_mesh(4, devices=["cpu"] * 4)
    P2, Q2 = list(Pn.clone().split(10)), list(Qn.clone().split(8))
    sums = [PK.plsi_mstep_sums(p, q, p_mask=a, q_mask=b, **kw)
            for p, q, a, b in zip(P2, Q2, pm.split(10), qm.split(8))]
    total = par.all_reduce_sum(mesh, sums)
    for q, s, b in zip(Q2, total, qm.split(8)):
        PK.plsi_mstep_apply(q, s, alpha2=kw["alpha2"],
                            num_items=kw["num_items"], q_mask=b)
    np.testing.assert_allclose(torch.cat(P2).numpy(), P1.numpy(), rtol=1e-6)
    np.testing.assert_allclose(torch.cat(Q2).numpy(), Q1.numpy(), rtol=1e-5)


def test_par_eals_serves_through_the_mesh(datasets):
    m = _model(port, "EALS", datasets[1], 2, num_iters=1)
    m.train()
    users = [f"u{i}" for i in range(0, 500, 7)]
    a = port.ParEALS(m, num_devices=D, devices=["cpu"] * D)
    b = port.ParEALS(m)
    x = a.topk_recommendation(users, topk=10)
    y = b.topk_recommendation(users, topk=10)
    np.testing.assert_array_equal(x[1], y[1])
    np.testing.assert_allclose(x[2], y[2], rtol=1e-5)
