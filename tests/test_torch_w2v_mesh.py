"""The port's W2V on a dp mesh against the JAX package's, on the CPU.

The JAX package trains on its 8 fake CPU devices (``tests/conftest.py``,
``num_devices=8``: ``w2v_epoch_dp`` on host pairs, ``w2v_epoch_stream_dp``
with ``pair_gen="device"``); the port puts its 8 shards on the CPU
(``devices=["cpu"] * 8``), where K19-K21 and K8 run their plain versions.
Both start from the same ``np.random`` state on ``test_torch_w2v.py``'s
clustered corpus.

The JAX dp epochs draw the negatives of the global batch and slice them per
shard; the parity runs inject those draws through the port's hooks
(``jax_key_chain`` with ``shards=8``: the global draws sliced at each
shard's ``slot_offset``).  Tolerances are ``test_torch_w2v.py``'s: L0 and
L1 within rtol 1e-4 / atol 1e-5, each epoch's loss within 1e-5 relative
(the union's rows summed in another order than the JAX package's psum of
dense deltas); the stream epoch's pair count equal to the JAX mesh run's.
With the port's own draws the mesh is held to its single device: the host
pairs within 1e-5 (the shards draw the single device's negatives), the
stream epoch's loss within 2% (pairs across a shard's edge are dropped,
the JAX package's rule, ``tests/models/test_w2v_cfr.py:575-600``).  Every
replica (two device names, ``cpu`` and ``cpu:0``, hold one each) ends each
group bit for bit equal.  ``_select_dp_mesh``'s rules, a 2-process gloo
job and save / load / ``ParW2V`` after a mesh run close the file.
"""
import textwrap

import numpy as np
import pytest
import torch

import buffalo_tpu as ref
import buffalo_tpu.ops.w2v_kernels as JW
import buffalo_tpu_torch as port
import buffalo_tpu_torch.ops.w2v_kernels as W
from tests.test_torch_bpr_mesh import _Log, _run
from tests.test_torch_native_ref import jax_native_lib  # noqa: F401
from tests.test_torch_w2v import (LOSS_RTOL, TOL, _train, clustered,  # noqa
                                  corpora, jax_key_chain)

pytestmark = pytest.mark.usefixtures("jax_native_lib")

D = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions' many small ops run fastest on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(pkg, data, seed=5, **kw):
    opt = pkg.W2VOption().get_default_option()
    opt.update(dict(d=8, num_iters=3, min_count=2, window=4, lr=0.05))
    opt.update(kw)
    if pkg is port:
        opt.device = "cpu"
        if int(opt.num_devices) > 1 and not opt.get("devices"):
            opt.devices = ["cpu"] * int(opt.num_devices)
    model = pkg.W2V(opt, data=data)
    np.random.seed(seed)
    model.initialize()
    return model


def _inject(monkeypatch, model, shards=D):
    pair, stream = jax_key_chain(int(model.opt.random_seed), shards)
    monkeypatch.setattr(W, "w2v_negatives", pair)
    monkeypatch.setattr(W, "stream_negatives", stream)


CASES = {
    "host": dict(),
    "host_groups": dict(max_chunks_per_dispatch=2, batch_size=1024),
    "device": dict(pair_gen="device", neg_block=4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_matches_jax_mesh(clustered, monkeypatch, case):
    """3 epochs on 8 shards, the JAX package's draws injected: L0, L1, the
    losses and (stream epoch) each epoch's pair count."""
    kw = dict(CASES[case], num_devices=D)
    jax_pairs = []
    original = JW.w2v_epoch_stream_dp

    def record(*args, **k):
        out = original(*args, **k)
        jax_pairs.append(float(out[3]))
        return out

    monkeypatch.setattr(JW, "w2v_epoch_stream_dp", record)
    a = _model(ref, clustered["ref"], **kw)
    la = _train(a)
    _inject(monkeypatch, a)
    b = _model(port, clustered["port"], **kw)
    lb = _train(b)
    assert len(la) == len(lb) == 3
    np.testing.assert_allclose(lb, la, rtol=LOSS_RTOL)
    np.testing.assert_allclose(b.L0, a.L0, **TOL)
    np.testing.assert_allclose(b.L1, a.L1, **TOL)
    if case == "device":
        assert len(jax_pairs) == sum(s["groups"] for s in b.epoch_stats)
        groups = np.cumsum([0] + [s["groups"] for s in b.epoch_stats])
        assert [s["pairs"] for s in b.epoch_stats] == [
            int(sum(jax_pairs[groups[e]:groups[e + 1]])) for e in range(3)]
    if case == "host_groups":
        assert max(s["groups"] for s in b.epoch_stats) > 1


def _replica_check(monkeypatch, name):
    """Wrap ``W.name``: after each group every replica's tables equal the
    first's bit for bit.  Returns the number of groups seen."""
    original = getattr(W, name)
    seen = []

    def wrapped(mesh, tables, *args, **kw):
        out = original(mesh, tables, *args, **kw)
        first = next(iter(tables.values()))
        for L0, L1 in tables.values():
            assert torch.equal(L0, first[0]) and torch.equal(L1, first[1])
        seen.append(len(tables))
        return out

    monkeypatch.setattr(W, name, wrapped)
    return seen


@pytest.mark.parametrize("pair_gen", ["host", "device"])
def test_own_rng_mesh_matches_single_device(clustered, monkeypatch,
                                            pair_gen):
    """The port's own draws, 8 shards on two replicas against one device,
    every replica bit-equal after each group.  Host pairs: within 1e-5
    (the shards draw the single device's negatives).  The stream epoch, at
    the JAX package's own test's settings (``test_w2v_device_pair_gen_dp``:
    d = 12, min_count 1, the defaults otherwise, each run at its own T):
    the last loss within 2%, the pairs lost no more than the shards' edges
    can cut (window (window + 1) pair terms per edge and chunk)."""
    seen = _replica_check(monkeypatch, "w2v_epoch" if pair_gen == "host"
                          else "w2v_epoch_stream")
    kw = dict(pair_gen=pair_gen)
    if pair_gen == "device":
        kw.update(d=12, min_count=1, window=5, lr=0.025)
    mesh = _model(port, clustered["port"], num_devices=D,
                  devices=["cpu", "cpu:0"] * (D // 2), **kw)
    mesh.train()
    assert seen and set(seen) == {2}
    one = _model(port, clustered["port"], **kw)
    one.train()
    if pair_gen == "host":
        np.testing.assert_allclose(mesh.L0, one.L0, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(mesh.L1, one.L1, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(mesh.iteration_losses,
                                   one.iteration_losses, rtol=1e-5)
        return
    assert mesh.iteration_losses[-1] == pytest.approx(
        one.iteration_losses[-1], rel=0.02)
    for m, o in zip(mesh.epoch_stats, one.epoch_stats):
        cut = 5 * 6 * (D - 1) * m["chunks"]
        assert o["pairs"] - cut <= m["pairs"] < o["pairs"] + cut, (m, o)
    assert np.isfinite(mesh.L0).all() and np.abs(mesh.L0).max() > 0


def test_pair_gen_on_a_mesh(clustered):
    """"auto" is the host pairs on a mesh, the stream epoch only on
    "device" (``w2v.py:495-500``); without a mesh the port's rule stays."""
    m = _model(port, clustered["port"], num_devices=D, num_iters=1)
    assert m._pair_gen() == "host"
    m.train()
    assert "block" not in m.epoch_stats[0]
    assert _model(port, clustered["port"], num_devices=D,
                  pair_gen="device")._pair_gen() == "device"
    assert _model(port, clustered["port"])._pair_gen() == "host"  # CPU


def test_chunks_round_up_to_the_mesh(clustered):
    """T rounds to ``neg_block`` x the mesh size (``w2v.py:296-298``), the
    pair chunk to the mesh size (``w2v.py:476``), as the JAX package's."""
    for bs in (1000, 1003):
        for n in (1, 3, D):
            m = _model(port, clustered["port"], num_devices=n,
                       batch_size=bs, neg_block=4)
            _, T, _ = m._stream_plan()
            q = 4 * max(n, 1)
            assert T % q == 0 and T - q < bs <= T
            chunk = m._pair_chunk()
            assert chunk % n == 0 and chunk - n < bs <= chunk


def _mesh_choice(pkg, data, **kw):
    model = _model(pkg, data, **kw)
    model.logger = _Log()
    return model._select_dp_mesh(True, False), model.logger.warnings


def test_tp_warns_and_runs_dp(clustered):
    got = _mesh_choice(port, clustered["port"], num_devices=D, sharding="tp")
    want = _mesh_choice(ref, clustered["ref"], num_devices=D, sharding="tp")
    assert got[0].size == want[0].size == D
    assert got[1] == want[1] and len(got[1]) == 1


def test_streamed_pairs_on_a_mesh_run_single_device_steps(clustered):
    """Past ``resident_mb`` the host pairs run chunk by chunk, a single
    device's steps on every replica, as the JAX package does: the same
    tables as one device's streamed run."""
    one = _model(port, clustered["port"], resident_mb=0, num_iters=2)
    one.train()
    mesh = _model(port, clustered["port"], resident_mb=0, num_iters=2,
                  num_devices=D, devices=["cpu", "cpu:0"] * (D // 2))
    mesh.train()
    np.testing.assert_array_equal(mesh.L0, one.L0)
    np.testing.assert_array_equal(mesh.L1, one.L1)


def test_mesh_model_saves_loads_and_serves(clustered, tmp_path):
    """Save / load after a mesh run, and ``ParW2V`` top-10 of the loaded
    model against the one-device model's, ids equal off ties."""
    mesh = _model(port, clustered["port"], num_devices=D, d=16)
    mesh.train()
    one = _model(port, clustered["port"], d=16)
    one.train()
    path = str(tmp_path / "m.w2v")
    mesh.build_itemid_map()
    mesh.save(path)
    back = port.W2V.new(path, device="cpu")
    np.testing.assert_array_equal(back.L0, mesh.L0)
    one.build_itemid_map()
    keys = [f"w{i}" for i in range(20)]
    tb, sb = port.ParW2V(back).most_similar(keys, topk=10)
    to, so = port.ParW2V(one).most_similar(keys, topk=10)
    np.testing.assert_allclose(np.asarray(sb), np.asarray(so), rtol=1e-4,
                               atol=1e-5)
    so = np.asarray(so)
    for r, (x, y) in enumerate(zip(tb, to)):
        for c, (u, v) in enumerate(zip(x, y)):
            tie = np.isclose(so[r], so[r, c], rtol=1e-4).sum() > 1
            assert u == v or tie, (r, c, u, v)


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
    from buffalo_tpu_torch.models import W2V, W2VOption
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
    sopt.data.validation = {}
    data = load(sopt)
    data.create()
    opt = W2VOption().get_default_option()
    opt.update(d=8, num_iters=2, min_count=2, window=4, lr=0.05,
               num_devices=4, device="cpu")
    opt.devices = ["cpu"] * (2 if world else 4)
    np.random.seed(5)
    m = W2V(opt, data=data)
    m.initialize()
    m.train()
    if world:
        assert parallelism.all_gather_rows.dist_calls > 0
    np.savez(os.path.join(root, f"out{pid}_{world}.npz"), L0=m.L0, L1=m.L1)
    parallelism.shutdown_distributed()
    print("DONE", flush=True)
""")


def test_two_process_gloo_training(tmp_path):
    """Two processes of 2 shards each (gloo) train the 4-shard host-pair
    mesh: both hold the same tables bit for bit, within 1e-5 (relative
    Frobenius) of one process's 4-shard mesh."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    _run(script, [(str(tmp_path), str(pid), "2") for pid in range(2)])
    _run(script, [(str(tmp_path), "0", "0")])
    r0, r1 = (np.load(tmp_path / f"out{pid}_2.npz") for pid in range(2))
    one = np.load(tmp_path / "out0_0.npz")
    for t in ("L0", "L1"):
        assert r0[t].tobytes() == r1[t].tobytes(), t
        rel = np.linalg.norm(r0[t] - one[t]) / np.linalg.norm(one[t])
        assert rel < 1e-5, (t, rel)
