"""The port's device mesh (``buffalo_tpu_torch.parallelism``), its sharded
retrieval and a two-process job, on the CPU.

The JAX package meshes over its 8 fake CPU devices (``tests/conftest.py``);
the port puts 8 shards on the CPU with ``devices=["cpu"] * 8``.  Sharded
top-k is held to the JAX package's ``batch_topn_sharded`` on the same
inputs (ids equal, scores within 1e-5), over tables whose height is not a
multiple of the mesh, k past a shard's rows, duplicated rows (ties) and
biases; K22's plain version to the JAX program's merge (``lax.top_k`` over
the gathered candidates) bit for bit.  The two-process job mirrors
``tests/test_distributed.py``: 2 processes x 2 local shards (gloo, a
``FileStore`` in the test's directory) train ALS "dp+tp" and agree bit for
bit, and within 1e-4 relative of one process holding all 4 shards (gloo
sums the two processes' partial gramians in its own order).
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import buffalo_tpu.ops.topk as J
import buffalo_tpu_torch.ops.topk as T
from buffalo_tpu import parallelism as JP
from buffalo_tpu_torch import parallelism as par
from buffalo_tpu_torch.ops import retrieval_kernels as R

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_TOL = 1e-5


def test_get_mesh_rules():
    """No card here: one CPU device; more shards only where named."""
    assert par.num_devices() == 1
    m = par.get_mesh()
    assert m.size == 1 and [str(d) for d in m.devices] == ["cpu"]
    assert m.group is None and m.backend is None
    with pytest.raises(RuntimeError, match="name the devices"):
        par.get_mesh(2)
    m = par.get_mesh(8, devices=["cpu"] * 8)
    assert (m.size, m.first, m.local_size, m.shards) == \
        (8, 0, 8, list(range(8)))
    assert [str(d) for d in m.unique_devices] == ["cpu"]
    with pytest.raises(ValueError):
        par.get_mesh(4, devices=["cpu"] * 3)
    assert par.get_mesh(devices=["cpu"] * 3).size == 3
    assert par.world_size() == 1


@pytest.mark.parametrize("cards,local,rank,local_rank,first", [
    (8, 4, 1, None, 4),    # two processes on one 8-card host
    (8, 4, 3, None, 4),    # ranks 2, 3 on a second such host
    (4, 4, 1, None, 0),    # a process that sees only its own cards
    (8, 1, 9, "5", 5),     # torchrun's LOCAL_RANK
    (1, 1, 3, "3", 0),     # LOCAL_RANK with one visible card each
])
def test_first_card_per_process(monkeypatch, cards, local, rank, local_rank,
                                first):
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    assert par._first_card(cards, local, rank) == first


def test_get_mesh_offsets_the_cards_of_a_second_process(monkeypatch):
    """Two processes, 8 cards on their host, a mesh of 8: rank 1 takes
    cuda:4..7, not the cards rank 0 holds."""
    import torch.distributed as dist

    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setattr(par, "_group", lambda: "group")
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    monkeypatch.setattr(dist, "get_rank", lambda *a: 1)
    monkeypatch.setattr(dist, "get_backend", lambda *a: "gloo")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    m = par.get_mesh(8)
    assert [str(d) for d in m.devices] == [f"cuda:{i}" for i in range(4, 8)]
    assert (m.size, m.first, m.shards) == (8, 4, [4, 5, 6, 7])
    with pytest.raises(RuntimeError, match="cards per process"):
        par.get_mesh(18)


def test_collectives_inside_one_process():
    mesh = par.get_mesh(4, devices=["cpu"] * 4)
    par.reset_counts()
    shards = [torch.full((3, 2), float(k)) for k in range(4)]
    full = par.all_gather_rows(mesh, shards)
    assert len(full) == 4 and all(f is full[0] for f in full)
    np.testing.assert_array_equal(full[0][:, 0].numpy(),
                                  np.repeat(np.arange(4.0), 3))
    assert par.all_gather_rows(mesh, shards, first_only=True).shape == (12, 2)
    parts = [torch.tensor([1e8, 1.0]), torch.tensor([-1e8, 1.0]),
             torch.tensor([1.0, 1.0]), torch.tensor([0.5, 1.0])]
    total = par.all_reduce_sum(mesh, parts)
    # added in shard order: (1e8 - 1e8) + 1 + 0.5
    assert total[0].tolist() == [1.5, 4.0] and total[3] is total[0]
    assert (par.all_gather_rows.calls, par.all_reduce_sum.calls) == (2, 1)
    assert par.all_gather_rows.dist_calls == par.all_reduce_sum.dist_calls \
        == 0
    table = np.arange(16, dtype=np.float32).reshape(8, 2)
    sh = par.shard_table(mesh, table)
    assert [tuple(s.shape) for s in sh] == [(2, 2)] * 4
    np.testing.assert_array_equal(par.gather_table(mesh, sh), table)
    with pytest.raises(ValueError):
        par.shard_table(mesh, table[:7])


def _same(got, ref):
    (gk, gs), (rk, rs) = got, ref
    np.testing.assert_array_equal(gk, rk)
    np.testing.assert_allclose(gs, rs, rtol=SCORE_TOL, atol=SCORE_TOL)


CASES = {
    # N not a multiple of 8, k = 10
    "n1001_k10": (1001, 10, False, False),
    # k past a shard's rows (S = 5), biases
    "n37_k10_bias": (37, 10, True, False),
    # k past the catalog, duplicated rows (ties)
    "n37_k400_dup": (37, 400, False, True),
    "n3000_k400_bias_dup": (3000, 400, True, True),
    # k = 2,000, past K5's limit on the card
    "n5000_k2000_bias_dup": (5000, 2000, True, True),
    "n9_k1": (9, 1, False, False),
    # fewer rows than shards: whole shards of padding
    "n3_k5": (3, 5, False, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_batch_topn_sharded_matches_jax(case):
    N, k, bias, dup = CASES[case]
    rng = np.random.default_rng(len(case))
    Q = rng.standard_normal((N, 8)).astype(np.float32)
    if dup:
        Q[N // 2:N // 2 + 5] = Q[0]
        Q[-3:] = Q[1]
    p = rng.standard_normal((40, 8)).astype(np.float32)
    p[:2] = 0.0  # every score ties
    Qb = rng.standard_normal(N).astype(np.float32) if bias else None
    jm = JP.get_mesh(8)
    pm = par.get_mesh(8, devices=["cpu"] * 8)
    got = T.batch_topn_sharded(p, Q, k, pm, Qb=Qb)
    _same(got, J.batch_topn_sharded(p, Q, k, jm, Qb=Qb))
    # and the single-device scan
    _same(got, T.batch_topn(p, Q, k, Qb=Qb, device="cpu"))


def test_sharded_matmul_topk_matches_jax_on_shards():
    """The per-shard program on the JAX package's own padded shards."""
    rng = np.random.default_rng(4)
    N, d, k, D = 203, 6, 30, 8
    S = -(-N // D)
    Q = np.zeros((D * S, d), np.float32)
    Q[:N] = rng.standard_normal((N, d))
    Qb = np.full(D * S, -np.inf, np.float32)
    Qb[:N] = rng.standard_normal(N)
    p = rng.standard_normal((17, d)).astype(np.float32)
    jm = JP.get_mesh(D)
    from jax.sharding import NamedSharding, PartitionSpec as PS
    sh = NamedSharding(jm, PS("d"))
    jv, ji = J.sharded_matmul_topk(p, jax.device_put(Q, sh),
                                   jax.device_put(Qb, sh), k, mesh=jm)
    pm = par.get_mesh(D, devices=["cpu"] * D)
    pv, pi = T.sharded_matmul_topk(
        torch.from_numpy(p), par.shard_table(pm, Q),
        [t.reshape(-1) for t in par.shard_table(pm, Qb[:, None])], k,
        mesh=pm)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=SCORE_TOL)


# the last five: K22's rank form (k past the crossover, kl = k, odd D,
# k = D kl) and its warp form at k = 1
@pytest.mark.parametrize("D,kl,k", [(1, 7, 7), (2, 5, 9), (8, 4, 20),
                                    (32, 3, 96), (4, 64, 10),
                                    (4, 512, 2048), (3, 100, 250),
                                    (5, 64, 1), (33, 16, 400),
                                    (4, 2000, 2000)])
def test_k22_plain_matches_jax_merge(D, kl, k):
    """K22's plain version against the JAX program's merge on sorted
    per-shard lists with ties (across and within shards) and -inf."""
    rng = np.random.default_rng(D * 100 + kl)
    B = 12
    # integer scores: plenty of ties; -inf padding at the end of the
    # last shard's lists
    v = rng.integers(-3, 4, (B, D, kl)).astype(np.float32)
    v[:, -1, kl // 2:] = -np.inf
    v[0] = -np.inf
    v = -np.sort(-v, axis=2)
    S = kl + 3
    i = np.empty((B, D, kl), np.int32)
    for b in range(B):
        for j in range(D):
            # ids ascending within runs of equal score (the local order)
            loc = rng.choice(S, kl, replace=False)
            order = np.lexsort((loc, -v[b, j]))
            i[b, j] = j * S + loc[order]
            v[b, j] = v[b, j][order]
    gv, gi = R.sharded_topk_merge(torch.from_numpy(v), torch.from_numpy(i),
                                  k)
    jv, sel = jax.lax.top_k(jnp.asarray(v.reshape(B, D * kl)), k)
    ji = np.take_along_axis(i.reshape(B, D * kl), np.asarray(sel), axis=1)
    np.testing.assert_array_equal(gi.numpy(), ji)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(jv))


def test_par_facades_serve_through_the_mesh(tmp_path):
    """``ParALS`` with ``num_devices`` / ``devices`` (or a mesh) serves
    through ``batch_topn_sharded``: the same top-k as one device; a pool
    takes the unsharded scan."""
    import buffalo_tpu_torch as port

    rng = np.random.default_rng(2)
    lines = [f"{u + 1} {int(i) + 1} 1" for u in range(60)
             for i in rng.choice(45, 6, replace=False)]
    mm = tmp_path / "m.mm"
    mm.write_text("%%MatrixMarket matrix coordinate real general\n"
                  f"60 45 {len(lines)}\n" + "\n".join(lines) + "\n")
    dopt = port.MatrixMarketOptions().get_default_option()
    dopt.input.main = str(mm)
    dopt.data.path = str(tmp_path / "d.bfo")
    dopt.data.tmp_dir = str(tmp_path / "tmp")
    dopt.data.validation = {}
    data = port.data.load(dopt)
    data.create()
    opt = port.ALSOption().get_default_option()
    opt.update(d=8, num_iters=2, validation={}, device="cpu")
    als = port.ALS(opt, data=data)
    np.random.seed(1)
    als.initialize()
    als.train()
    one = port.ParALS(als)
    users = [str(u) for u in range(60)]
    meshes = (dict(num_devices=8, devices=["cpu"] * 8),
              dict(mesh=par.get_mesh(3, devices=["cpu"] * 3)))
    b = one.topk_recommendation(users, topk=7)
    for kw in meshes:
        sharded = port.ParALS(als, **kw)
        assert sharded.mesh is not None
        a = sharded.topk_recommendation(users, topk=7)
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_allclose(a[2], b[2], rtol=SCORE_TOL)
    items = [str(i) for i in range(45)]
    pool = [str(i) for i in range(10)]
    for kw in meshes:
        sharded = port.ParALS(als, **kw)
        for pl in (None, pool):
            a = sharded.most_similar(items, topk=4, pool=pl)
            b = one.most_similar(items, topk=4, pool=pl)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_allclose(a[1], b[1], rtol=SCORE_TOL,
                                       atol=SCORE_TOL)


_WORKER = textwrap.dedent("""
    import os, sys
    root, pid, world = sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from buffalo_tpu_torch import parallelism
    if world:
        store = "file://" + os.path.join(root, "store")
        assert parallelism.initialize_distributed(store, world, pid,
                                                  backend="gloo") == world
        # a second call is a no-op
        assert parallelism.initialize_distributed(store, world, pid) == world
    from buffalo_tpu_torch.data import MatrixMarketOptions, load
    from buffalo_tpu_torch.models import ALS, ALSOption
    rng = np.random.default_rng(42)
    U, I = 96, 48
    lines = []
    for u in range(U):
        for i in rng.choice(I, size=rng.integers(5, 12), replace=False):
            lines.append(f"{u+1} {int(i)+1} {float(rng.integers(1, 6))}")
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
    opt = ALSOption().get_default_option()
    opt.update(d=8, num_iters=3, validation={}, num_devices=4,
               sharding="dp+tp", device="cpu")
    opt.devices = ["cpu"] * (2 if world else 4)
    m = ALS(opt, data=data)
    m.initialize()
    r = m.train()
    assert np.isfinite(r["train_loss"]) and r["train_loss"] < 1.0
    assert m.Q.shape == (I, 8) and m._mesh_range is None
    if world:
        assert parallelism.all_reduce_sum.dist_calls > 0
        assert parallelism.all_gather_rows.dist_calls > 0
    np.savez(os.path.join(root, f"out{pid}_{world}.npz"), P=m.P, Q=m.Q,
             loss=np.float64(r["train_loss"]))
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


def test_two_process_gloo_training(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    _run(script, [(str(tmp_path), str(pid), "2") for pid in range(2)])
    _run(script, [(str(tmp_path), "0", "0")])
    r0, r1 = (np.load(tmp_path / f"out{pid}_2.npz") for pid in range(2))
    one = np.load(tmp_path / "out0_0.npz")
    for t in ("P", "Q", "loss"):
        assert r0[t].tobytes() == r1[t].tobytes(), t
    for t in ("P", "Q"):
        rel = np.linalg.norm(r0[t] - one[t]) / np.linalg.norm(one[t])
        assert rel < 1e-4, (t, rel)
    assert abs(float(r0["loss"]) - float(one["loss"])) <= \
        1e-4 * float(one["loss"])
