"""The port's CoFactor on a dp mesh against the JAX package's, on the CPU.

The JAX package trains on its 8 fake CPU devices (``tests/conftest.py``,
``num_devices=8``: ``cfr_epoch_dp``); the port puts its 8 shards on the
CPU (``devices=["cpu"] * 8``), where K17, K18 and K3 run their plain
versions.  Both start from the same ``np.random`` state on
``test_torch_cfr.py``'s stream file (5 word clusters, SPPMI windows 3, k 1).

Tolerances are ``test_torch_cfr.py``'s: ``llt`` tables within 1e-3 and
losses within 1e-4 after 3 epochs; ``manual_cg`` tables within 2x the
port's own distance from its float64 mesh run, losses within 1e-3.  The
port's mesh gathers the rows its shards solve, so it holds the single
device's tables (within 1e-6, relative Frobenius; the JAX package adds
the summed deltas, an ulp from the rows), and every replica (two device
names, ``cpu`` and ``cpu:0``, hold one each) ends each epoch bit for bit
equal.  A mesh of 3 shards pads batches with sentinel rows, and
``max_len=4`` puts segment batches in every phase.  ``_select_dp_mesh``'s
rules, a 2-process gloo job, save / load and ``ParCFR`` close the file.
"""
import textwrap

import numpy as np
import pytest
import torch

import buffalo_tpu as ref
import buffalo_tpu_torch as port
import buffalo_tpu_torch.ops.cfr_kernels as CK
from buffalo_tpu_torch.models.cfr import _is_segment
from tests.test_torch_bpr_mesh import _Log, _run
from tests.test_torch_cfr import (TABLES, _rel, _train, datasets,  # noqa
                                  stream_file)

D = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions' many small ops run fastest on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(pkg, data, seed, **kw):
    opt = pkg.CFROption().get_default_option()
    opt.d = kw.pop("d", 8)
    opt.num_iters = kw.pop("num_iters", 3)
    opt.validation = kw.pop("validation", {"topk": 10})
    opt.evaluation_period = 1
    opt.update(kw)
    if pkg is port:
        opt.device = "cpu"
        if int(opt.num_devices) > 1 and not opt.get("devices"):
            opt.devices = ["cpu"] * int(opt.num_devices)
    model = pkg.CFR(opt, data=data)
    np.random.seed(seed)
    model.initialize()
    return model


@pytest.mark.parametrize("optimizer", ["llt", "manual_cg"])
def test_mesh_matches_jax_mesh(datasets, optimizer):
    """3 epochs on 8 shards against the JAX package's 8 devices."""
    a = _model(ref, datasets[0], 5, optimizer=optimizer, num_devices=D)
    res_a, loss_a = _train(a)
    b = _model(port, datasets[1], 5, optimizer=optimizer, num_devices=D)
    res_b, loss_b = _train(b)
    assert len(loss_a) == len(loss_b) == 3 and loss_b[-1] < loss_b[0]
    if optimizer == "llt":
        np.testing.assert_allclose(loss_b, loss_a, rtol=1e-4)
        for t in TABLES:
            np.testing.assert_allclose(getattr(b, t), getattr(a, t),
                                       rtol=1e-3, atol=1e-3, err_msg=t)
        assert abs(res_b["vali_ndcg"] - res_a["vali_ndcg"]) < 1e-3
        return
    c = _model(port, datasets[1], 5, optimizer=optimizer, num_devices=D)
    for t in TABLES:
        setattr(c, t, getattr(c, t).astype(np.float64))
    _train(c)
    assert c.U.dtype == np.float64 and b.U.dtype == np.float32
    np.testing.assert_allclose(loss_b, loss_a, rtol=1e-3)
    for t in TABLES:
        noise = _rel(getattr(b, t), getattr(c, t))
        assert noise < 1e-2, (t, noise)
        assert _rel(getattr(b, t), getattr(a, t)) <= 2.0 * noise + 1e-6, t
    assert abs(res_b["vali_ndcg"] - res_a["vali_ndcg"]) < 1e-2


def _replica_check(monkeypatch):
    """Wrap ``CK.cfr_epoch``: after each epoch every replica's tables
    equal the first's bit for bit.  Returns the replicas seen per epoch."""
    original = CK.cfr_epoch
    seen = []

    def wrapped(mesh, tables, *args, **kw):
        out = original(mesh, tables, *args, **kw)
        first = next(iter(tables.values()))
        for T in tables.values():
            assert all(torch.equal(x, y) for x, y in zip(T, first))
        seen.append(len(tables))
        return out

    monkeypatch.setattr(CK, "cfr_epoch", wrapped)
    return seen


@pytest.mark.parametrize("shards,extra", [
    (D, dict()), (D, dict(optimizer="llt")),
    # 3 shards: batches of 8 and more rows need sentinel rows; rows past 4
    # entries make segment batches in every phase
    (3, dict(max_len=4))])
def test_mesh_matches_single_device(datasets, monkeypatch, shards, extra):
    """The mesh against one device: every table within 1e-6 (relative
    Frobenius) after 3 epochs, losses 1e-6; every replica bit-equal after
    each epoch."""
    seen = _replica_check(monkeypatch)
    mesh = _model(port, datasets[1], 6, num_devices=shards,
                  devices=["cpu", "cpu:0"] * (shards // 2) + ["cpu"] * (
                      shards % 2), validation={}, **extra)
    mesh.train()
    assert seen == [2] * 3
    one = _model(port, datasets[1], 6, validation={}, **extra)
    one.train()
    for t in TABLES:
        assert _rel(getattr(mesh, t), getattr(one, t)) <= 1e-6, t
    np.testing.assert_allclose(mesh.iteration_losses, one.iteration_losses,
                               rtol=1e-6)
    if shards == 3:
        batches = mesh._build_batches()
        padded = [e for k in ("user", "item", "context") for e in batches[k]
                  if not _is_segment(e)]
        assert any(len((e if hasattr(e, "rows") else e[0]).rows) % shards
                   for e in padded)
        for k in ("user", "item", "context"):
            assert any(_is_segment(e) for e in batches[k]), k


def test_sentinel_rows_write_nothing(datasets):
    """A padded item entry's row slice with sentinel rows between real
    ones, through K17, the solve and K18: the sentinel rows add no loss,
    and no row or bias outside the slice's real rows moves."""
    from buffalo_tpu_torch.models.cfr import _stage_mesh_entry
    from buffalo_tpu_torch.ops.als_kernels import gramian
    from buffalo_tpu_torch.parallelism import Mesh

    m = _model(port, datasets[1], 2, validation={})
    batches = m._build_batches()
    entry = next(e for e in batches["item"] if not _is_segment(e))
    n = m.I.shape[0]
    rows = np.array(entry[0].rows)
    rows[1::3] = n          # sentinel rows in the middle of the launch
    b = entry[0]._replace(rows=rows, lens=np.where(rows < n, entry[0].lens,
                                                   0).astype(np.int32))
    lens_c = np.where(rows < n, entry[1], 0).astype(np.int32)
    mesh = Mesh(["cpu"] * 3)
    parts = _stage_mesh_entry((b, lens_c) + tuple(entry[2:]), mesh, n)
    T = [torch.from_numpy(t.copy()) for t in (m.U, m.I, m.C, m.Ib, m.Cb)]
    before = [t.clone() for t in T]
    FF = gramian(T[0])
    total = torch.zeros(())
    for part in parts:
        loss = CK.cfr_item_step(T[1], T[0], T[2], T[3], T[4], FF, part,
                                alpha=8.0, l=1.0, reg_i=0.1,
                                optimizer="manual_cg", cg_iters=3,
                                cg_tol=1e-10, compute_loss=True)
        r = part[0].rows
        assert float(loss[r >= n].abs().sum()) == 0.0
        total = total + loss.sum()
    real = rows[rows < n]
    moved = np.nonzero((T[1] != before[1]).any(1).numpy()
                       | (T[3] != before[3]).numpy())[0]
    assert len(moved) > 0 and set(moved) <= set(real)
    assert torch.isfinite(total)


def _mesh_choice(pkg, data, resident=True, **kw):
    model = _model(pkg, data, 1, **kw)
    model.logger = _Log()
    return model._select_dp_mesh(resident, False), model.logger.warnings


def test_tp_warns_and_runs_dp(datasets):
    got = _mesh_choice(port, datasets[1], num_devices=D, sharding="tp")
    want = _mesh_choice(ref, datasets[0], num_devices=D, sharding="tp")
    assert got[0].size == want[0].size == D
    assert got[1] == want[1] and len(got[1]) == 1


def test_streamed_mesh_request_trains_on_one_device(datasets, monkeypatch):
    """Batches past ``resident_mb`` on ``num_devices=8``: the JAX package's
    warning, then the streamed single-device epoch (the same tables)."""
    got = _mesh_choice(port, datasets[1], False, num_devices=D)
    want = _mesh_choice(ref, datasets[0], False, num_devices=D)
    assert got[0] is None and want[0] is None
    assert got[1] == want[1] and len(got[1]) == 1
    meshes = []
    original = CK.cfr_epoch

    def record(mesh, *args, **kw):
        meshes.append(mesh.size)
        return original(mesh, *args, **kw)

    monkeypatch.setattr(CK, "cfr_epoch", record)
    a = _model(port, datasets[1], 2, resident_mb=0, num_iters=2,
               validation={})
    a.train()
    b = _model(port, datasets[1], 2, resident_mb=0, num_iters=2,
               num_devices=D, validation={})
    b.train()
    assert meshes == [1] * 4
    for t in TABLES:
        np.testing.assert_array_equal(getattr(a, t), getattr(b, t))


def test_mesh_model_saves_validates_and_serves(datasets, tmp_path):
    """Save / load and validation after a mesh run; ``ParCFR`` top-10 of
    the mesh model equal to the one-device model's."""
    mesh = _model(port, datasets[1], 3, num_devices=D)
    res = mesh.train()
    assert np.isfinite(res["vali_ndcg"])
    one = _model(port, datasets[1], 3)
    assert one.train()["vali_ndcg"] == res["vali_ndcg"]
    path = str(tmp_path / "m.cfr")
    mesh.save(path)
    back = port.CFR.new(path, device="cpu")
    for t in TABLES:
        np.testing.assert_array_equal(getattr(back, t), getattr(mesh, t))
    users = [str(u) for u in range(1, 301, 7)]
    assert port.ParCFR(mesh).topk_recommendation(users, topk=10)[1].tolist() \
        == port.ParCFR(one).topk_recommendation(users, topk=10)[1].tolist()


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
    from buffalo_tpu_torch.data import StreamOptions, load
    from buffalo_tpu_torch.models import CFR, CFROption
    rng = np.random.default_rng(3)
    cl = rng.integers(0, 5, 60)
    lines = [" ".join(f"w{int(x)}" for x in rng.choice(
        np.nonzero(cl == rng.integers(0, 5))[0], size=10))
        for _ in range(300)]
    main = os.path.join(root, f"s{pid}_{world}.txt")
    with open(main, "w") as f:
        f.write("\\n".join(lines) + "\\n")
    sopt = StreamOptions().get_default_option()
    sopt.input.main = main
    sopt.data.path = os.path.join(root, f"d{pid}_{world}.bfo")
    sopt.data.tmp_dir = os.path.join(root, f"tmp{pid}_{world}")
    sopt.data.internal_data_type = "matrix"
    sopt.data.validation = {}
    sopt.data.sppmi = {"windows": 3, "k": 1}
    data = load(sopt)
    data.create()
    opt = CFROption().get_default_option()
    opt.update(d=8, num_iters=2, validation={}, num_devices=4, device="cpu",
               max_len=4)
    opt.devices = ["cpu"] * (2 if world else 4)
    np.random.seed(5)
    m = CFR(opt, data=data)
    m.initialize()
    m.train()
    if world:
        assert parallelism.all_gather_rows.dist_calls > 0
    np.savez(os.path.join(root, f"out{pid}_{world}.npz"), U=m.U, I=m.I,
             C=m.C, Ib=m.Ib, Cb=m.Cb)
    parallelism.shutdown_distributed()
    print("DONE", flush=True)
""")


def test_two_process_gloo_training(tmp_path):
    """Two processes of 2 shards each (gloo) train the 4-shard mesh, with
    segment batches: both hold the same tables bit for bit, within 1e-6
    (relative Frobenius) of one process's 4-shard mesh."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    _run(script, [(str(tmp_path), str(pid), "2") for pid in range(2)])
    _run(script, [(str(tmp_path), "0", "0")])
    r0, r1 = (np.load(tmp_path / f"out{pid}_2.npz") for pid in range(2))
    one = np.load(tmp_path / "out0_0.npz")
    for t in TABLES:
        assert r0[t].tobytes() == r1[t].tobytes(), t
        assert _rel(r0[t], one[t]) <= 1e-6, t
