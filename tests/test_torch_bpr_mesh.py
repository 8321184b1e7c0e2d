"""The port's BPR-MF on a dp mesh against the JAX package's, on the CPU.

The JAX package trains on its 8 fake CPU devices (``tests/conftest.py``,
``num_devices=8``: ``bpr_epoch_dp``); the port puts its 8 shards on the
CPU (``devices=["cpu"] * 8``), where every kernel runs its plain version.
Both start from the same ``np.random`` state on the ``ml100k_like``
fixture.

The packages draw from different generators (threefry and the port's
Philox), so the parity runs inject the JAX package's draws: the wrapped
``bpr_epoch_dp`` records each epoch's key and computes that epoch's
negatives with ``bpr_sample_negatives_epoch`` on the same chunks (the dp
epoch draws the global candidate tensor and slices it, so these are its
negatives bit for bit); the port's ``sample_negatives`` then returns its
shard's slice, by the slot offset.  Tolerance: the same float32 updates
summed over shards in another order, factors and biases within rtol 1e-4
/ atol 1e-5 after 3 epochs, losses within 1e-5 (relative); adagrad, whose
steps magnify the rounding of near-zero gradients, each entry within that
tolerance beyond twice the distance between the two packages' single
devices on the same draws (a float64 witness shows that distance is
float32 rounding).  The port's
mesh on its own generator is held to its single device at the same
(rounded) batch size, at the same tolerance: the shards draw the single
device's negatives.  ``_select_dp_mesh``'s rules are held to the JAX
package's, warning text included, and a 2-process gloo job to the
one-process mesh.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import buffalo_tpu as ref
import buffalo_tpu.ops.sgd_kernels as JK
import buffalo_tpu_torch as port
import buffalo_tpu_torch.ops.sgd_kernels as PK
from buffalo_tpu.data import MatrixMarketOptions as RefMMOptions
from buffalo_tpu.data import load as ref_load
from buffalo_tpu_torch.data import MatrixMarketOptions as PortMMOptions
from buffalo_tpu_torch.data import load as port_load

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 8
TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-5


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
                   tmp_path_factory.mktemp("ref_bpr_mesh")),
            _build(PortMMOptions, port_load, ml100k_like,
                   tmp_path_factory.mktemp("port_bpr_mesh")))


def _model(pkg, data, seed, **kw):
    opt = pkg.BPRMFOption().get_default_option()
    opt.d = kw.pop("d", 16)
    opt.num_iters = kw.pop("num_iters", 3)
    opt.validation = {}
    opt.update(kw)
    if pkg is port:
        opt.device = "cpu"
        if int(opt.num_devices) > 1:
            opt.devices = ["cpu"] * int(opt.num_devices)
    model = pkg.BPRMF(opt, data=data)
    np.random.seed(seed)
    model.initialize()
    return model


def _close(a, b):
    np.testing.assert_allclose(b.P, a.P, **TOL)
    np.testing.assert_allclose(b.Q, a.Q, **TOL)
    np.testing.assert_allclose(b.Qb, a.Qb, **TOL)


def _record_losses(model):
    """The JAX model's per-epoch training losses, as it computes them."""
    out, compute = [], model.compute_loss

    def record():
        out.append(compute())
        return out[-1]

    model.compute_loss = record
    return out


class _Log:
    """Records a model's log calls as formatted messages."""

    def __init__(self):
        self.warnings = []

    def warning(self, msg, *args):
        self.warnings.append(msg % args if args else msg)

    def __getattr__(self, name):
        return lambda *a, **k: None


def _record_dp_draws(monkeypatch):
    """Wrap the JAX package's ``bpr_epoch_dp``: per epoch, the negatives
    its key draws for every chunk, (nchunks, N * num_negatives)."""
    drawn = []
    original = JK.bpr_epoch_dp

    def record(P, Q, Qb, opt_state, users, positives, bloom, cum_table,
               rng_key, step, pos_indptr, pos_keys, **kw):
        drawn.append(np.array(JK.bpr_sample_negatives_epoch(
            users, bloom, cum_table, rng_key, num_items=kw["num_items"],
            num_negatives=kw["num_negatives"], verify_neg=kw["verify_neg"],
            use_cum_table=kw["use_cum_table"],
            bloom_log2=kw["bloom_log2"])))
        return original(P, Q, Qb, opt_state, users, positives, bloom,
                        cum_table, rng_key, step, pos_indptr, pos_keys, **kw)

    monkeypatch.setattr(JK, "bpr_epoch_dp", record)
    return drawn


def _inject(drawn):
    """The port's K8 replaced by its shard's slice of the recorded draws."""
    def inject(users, num_items, *, num_negatives, epoch, chunk,
               slot_offset=0, **_):
        lo = slot_offset * num_negatives
        hi = lo + users.shape[0] * num_negatives
        return torch.from_numpy(drawn[epoch][chunk][lo:hi].copy()), None

    return inject


CASES = {
    "sgd_bias_capped": dict(),
    "sgd_two_negatives": dict(num_negative_samples=2, max_step_norm=0.05),
    "adagrad_pcn": dict(optimizer="adagrad", per_coordinate_normalize=True),
    "adam": dict(optimizer="adam", lr=0.02),
}


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_matches_jax_mesh(datasets, monkeypatch, case):
    """3 epochs on 8 shards, the JAX package's draws injected."""
    kw = dict(CASES[case], num_devices=D)
    drawn = _record_dp_draws(monkeypatch)
    a = _model(ref, datasets[0], seed=11, **kw)
    la = _record_losses(a)
    a.train()
    assert len(drawn) == 3
    calls = []
    inject = _inject(drawn)

    def counted(users, num_items, **k):
        calls.append(k["slot_offset"])
        return inject(users, num_items, **k)

    monkeypatch.setattr(PK, "sample_negatives", counted)
    b = _model(port, datasets[1], seed=11, **kw)
    b.train()
    np.testing.assert_allclose(b.iteration_losses, la, rtol=LOSS_RTOL)
    nchunks = drawn[0].shape[0]
    N_loc = drawn[0].shape[1] // (D * b.opt.num_negative_samples)
    assert calls == [g * N_loc for g in range(D)] * nchunks * 3
    if CASES[case].get("optimizer", "sgd") != "adagrad":
        _close(a, b)
        return
    # adagrad divides by the root of the summed squared gradients, which
    # turns the rounding of a near-zero gradient into a step of lr: the
    # single devices already part there, each float32 run up to 5e-5 from
    # the float64 witness on Q (test_adaptive_allowance_is_float32_
    # rounding).  So each entry is held to TOL beyond twice the two single
    # devices' distance.
    a1 = _model(ref, datasets[0], seed=11, epoch_dispatch="split",
                **CASES[case])
    a1.train()
    monkeypatch.setattr(PK, "sample_negatives", inject)
    b1 = _model(port, datasets[1], seed=11, **CASES[case])
    b1.train()
    for t in ("P", "Q", "Qb"):
        x, y = getattr(b, t), getattr(a, t)
        slack = 2 * np.abs(getattr(b1, t) - getattr(a1, t))
        assert np.all(np.abs(x - y) <= TOL["atol"] + TOL["rtol"] * np.abs(y)
                      + slack), t


@pytest.mark.parametrize("optimizer,extra", [
    ("sgd", {}), ("adagrad", {}), ("adagrad", {"random_positive": True})])
def test_own_rng_mesh_matches_single_device(datasets, optimizer, extra):
    """The port's own draws: 8 shards against one device at the same
    (rounded) batch size; the shards draw the single device's negatives
    (and random positives)."""
    kw = dict(optimizer=optimizer, batch_size=1000, **extra)
    one = _model(port, datasets[1], seed=4, **kw)
    one.train()
    mesh = _model(port, datasets[1], seed=4, num_devices=D, **kw)
    mesh.train()
    _close(one, mesh)
    np.testing.assert_allclose(mesh.iteration_losses, one.iteration_losses,
                               rtol=LOSS_RTOL)


def test_batch_size_rounds_up_to_the_mesh(datasets, monkeypatch):
    """batch_size 1000 runs as 1000 on one device and 1000 on 8 shards (a
    multiple), 1001 as 1008 (``bpr.py:257``)."""
    seen = []
    original = PK.bpr_epoch

    def record(mesh, tables, opt_states, users, positives, step, **kw):
        seen.append(users[0].shape[1] * mesh.size)
        return original(mesh, tables, opt_states, users, positives, step,
                        **kw)

    monkeypatch.setattr(PK, "bpr_epoch", record)
    for bs in (1000, 1001):
        _model(port, datasets[1], seed=1, num_devices=D, batch_size=bs,
               num_iters=1).train()
    assert seen == [1000, 1008]


def _mesh_choice(pkg, data, resident=True, split=False, **kw):
    model = _model(pkg, data, seed=1, **kw)
    model.logger = _Log()
    mesh = model._select_dp_mesh(resident, split)
    return mesh, model.logger.warnings


def test_dp_mesh_needs_an_explicit_num_devices(datasets):
    for n in (0, 1):
        for pkg, data in ((ref, datasets[0]), (port, datasets[1])):
            mesh, warned = _mesh_choice(pkg, data, num_devices=n)
            assert mesh is None and warned == []
    mesh, warned = _mesh_choice(port, datasets[1], num_devices=D)
    assert mesh.size == D and warned == []
    assert _mesh_choice(ref, datasets[0], num_devices=D)[0].size == D


def test_dp_mesh_tp_warns_and_runs_dp(datasets):
    got = _mesh_choice(port, datasets[1], num_devices=D, sharding="tp")
    want = _mesh_choice(ref, datasets[0], num_devices=D, sharding="tp")
    assert got[0].size == want[0].size == D
    assert got[1] == want[1] and len(got[1]) == 1
    assert "sharding='dp' only" in got[1][0]


@pytest.mark.parametrize("resident,split", [(False, False), (True, True)])
def test_dp_mesh_streamed_or_split_runs_on_one_device(datasets, resident,
                                                       split):
    got = _mesh_choice(port, datasets[1], resident, split, num_devices=D)
    want = _mesh_choice(ref, datasets[0], resident, split, num_devices=D)
    assert got[0] is None and want[0] is None
    assert got[1] == want[1] and len(got[1]) == 1


def test_streamed_mesh_request_trains_on_one_device(datasets, monkeypatch):
    """``num_devices=8`` with the positives past ``resident_mb`` trains the
    streaming path, as one device does."""
    monkeypatch.setattr(PK, "bpr_epoch", None)
    a = _model(port, datasets[1], seed=2, resident_mb=0, num_iters=2)
    a.train()
    b = _model(port, datasets[1], seed=2, resident_mb=0, num_iters=2,
               num_devices=D)
    b.train()
    np.testing.assert_array_equal(a.P, b.P)


def test_mesh_model_saves_and_validates(datasets, tmp_path):
    """Save/load and validation after a mesh run: the tables are shard 0's
    replica."""
    m = _model(port, datasets[1], seed=3, num_devices=D, num_iters=2)
    m.train()
    path = str(tmp_path / "bpr.bin")
    m.save(path)
    back = port.BPRMF.new(path, device="cpu")
    np.testing.assert_array_equal(back.P, m.P)
    np.testing.assert_array_equal(back.Qb, m.Qb)
    assert np.isfinite(m.P).all() and m.iteration_losses[-1] < np.log(2.0)


# ---------------------------------------------------------- two processes
_WORKER = textwrap.dedent("""
    import os, sys
    root, pid, world = sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from buffalo_tpu_torch import parallelism
    if world:
        parallelism.initialize_distributed(
            "file://" + os.path.join(root, "store"), world, pid,
            backend="gloo")
    from buffalo_tpu_torch.data import MatrixMarketOptions, load
    from buffalo_tpu_torch.models import BPRMF, BPRMFOption
    rng = np.random.default_rng(42)
    U, I = 300, 120
    lines = []
    for u in range(U):
        for i in rng.choice(I, size=rng.integers(5, 15), replace=False):
            lines.append(f"{u+1} {int(i)+1} 1")
    mm = os.path.join(root, f"m{pid}_{world}.mm")
    with open(mm, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\\n")
        f.write(f"{U} {I} {len(lines)}\\n")
        f.write("\\n".join(lines) + "\\n")
    dopt = MatrixMarketOptions().get_default_option()
    dopt.input.main = mm
    dopt.data.path = os.path.join(root, f"d{pid}_{world}.bfo")
    dopt.data.tmp_dir = os.path.join(root, f"tmp{pid}_{world}")
    dopt.data.validation = {}
    data = load(dopt)
    data.create()
    np.random.seed(5)
    opt = BPRMFOption().get_default_option()
    opt.update(d=8, num_iters=2, validation={}, num_devices=4,
               device="cpu", optimizer=sys.argv[5])
    opt.devices = ["cpu"] * (2 if world else 4)
    m = BPRMF(opt, data=data)
    m.initialize()
    m.train()
    if world:
        assert parallelism.all_reduce_sum.dist_calls > 0
    np.savez(os.path.join(root, f"out{pid}_{world}.npz"), P=m.P, Q=m.Q,
             Qb=m.Qb)
    parallelism.shutdown_distributed()
    print("DONE", flush=True)
""")


def _run(script, args_list, timeout=120):
    procs = [subprocess.Popen(
        [sys.executable, str(script), ROOT, *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
        for args in args_list]
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                pytest.fail("a mesh worker ran past its timeout")
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            assert "DONE" in out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_two_process_gloo_training(tmp_path, optimizer):
    """Two processes of 2 shards each (gloo) train the 4-shard mesh: both
    hold the same tables bit for bit, within 1e-4 (relative Frobenius) of
    one process's 4-shard mesh."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    _run(script, [(str(tmp_path), str(pid), "2", optimizer)
                  for pid in range(2)])
    _run(script, [(str(tmp_path), "0", "0", optimizer)])
    r0, r1 = (np.load(tmp_path / f"out{pid}_2.npz") for pid in range(2))
    one = np.load(tmp_path / "out0_0.npz")
    for t in ("P", "Q", "Qb"):
        assert r0[t].tobytes() == r1[t].tobytes(), t
        rel = np.linalg.norm(r0[t] - one[t]) / np.linalg.norm(one[t])
        assert rel < 1e-4, (t, rel)


@pytest.mark.parametrize("case", ["adagrad_pcn", "adam"])
def test_adaptive_allowance_is_float32_rounding(datasets, monkeypatch, case):
    """The float64 witness behind adagrad's allowance above: the port's
    single device on the JAX package's draws with float64 tables.  Under
    adagrad both packages' float32 single devices sit past TOL's atol from
    it, so float32 rounding alone parts them; under adam they do not (adam
    is held to plain TOL).  Each package's mesh is no further from it than
    twice its own single device, plus TOL's atol: the mesh adds no error
    of its own.  Prints, per table, each run's largest distance from it
    (pytest -s)."""
    kw = CASES[case]
    drawn = _record_dp_draws(monkeypatch)
    a = _model(ref, datasets[0], seed=11, num_devices=D, **kw)
    a.train()
    a1 = _model(ref, datasets[0], seed=11, epoch_dispatch="split", **kw)
    a1.train()
    monkeypatch.setattr(PK, "sample_negatives", _inject(drawn))
    b = _model(port, datasets[1], seed=11, num_devices=D, **kw)
    b.train()
    b1 = _model(port, datasets[1], seed=11, **kw)
    b1.train()
    w = _model(port, datasets[1], seed=11, **kw)
    for t in ("P", "Q", "Qb"):
        setattr(w, t, getattr(w, t).astype(np.float64))
    w.train()
    assert w.P.dtype == np.float64 and b1.P.dtype == np.float32
    one = []
    for t in ("P", "Q", "Qb"):
        x64 = getattr(w, t)
        dist = {n: float(np.abs(getattr(m, t) - x64).max())
                for n, m in (("jax_one", a1), ("port_one", b1),
                             ("jax_mesh", a), ("port_mesh", b))}
        print(case, t, dist)
        for pkg in ("jax", "port"):
            assert dist[f"{pkg}_mesh"] <= 2 * dist[f"{pkg}_one"] + \
                TOL["atol"], (t, dist)
        one.append(min(dist["jax_one"], dist["port_one"]))
    assert (max(one) > TOL["atol"]) == (case == "adagrad_pcn"), one
