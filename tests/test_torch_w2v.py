"""The port's W2V against the JAX package's, end to end on the CPU.

Two stream files: sentences drawn from 5 word clusters (as in
``tests/models/test_w2v_cfr.py``) and a Zipf(0.8) corpus of ~4,000 tokens
in short sentences, so that sentence ends fall inside negative blocks.
Each is built by each package's ``Stream`` (``stream`` internal type);
``np.random.seed`` is set before both ``initialize()`` calls so both start
from the same L0 and L1; the JAX package on one device, the port with
``device="cpu"`` (the plain versions of K19, K20 and K21, and K8's plain
draws).

The host phases (vocabulary, alias tables, subsample, half-windows, pairs,
the stream epoch's 6-byte wire format, chunk padding and groups) are
numpy in both packages and are held byte for byte.  The packages draw
their negatives from different generators (threefry and the port's
Philox), so the parity runs replace the port's hooks ``w2v_negatives`` and
``stream_negatives`` with the JAX package's draws replayed on its key
chain: ``PRNGKey(seed)``, split once per epoch, ``fold_in`` per group
(when an epoch has more than one), ``fold_in`` per chunk, then a split
into three for the pair path's redraws.  Tolerance after 3 epochs: L0 and
L1 within rtol 1e-4 / atol 1e-5 (the same float32 updates summed in
another order), each epoch's loss within 1e-5 relative.  The port's
own-Philox runs are held to the JAX package's quality gates
(``tests/models/test_w2v_cfr.py:485-516``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import buffalo_tpu as ref
import buffalo_tpu.models.w2v as JM
import buffalo_tpu.ops.sgd_kernels as JS
import buffalo_tpu.ops.w2v_kernels as JW
import buffalo_tpu_torch as port
import buffalo_tpu_torch.ops.sgd_kernels as S
import buffalo_tpu_torch.ops.w2v_kernels as W
from buffalo_tpu.data import StreamOptions as RefStreamOptions
from buffalo_tpu.data import load as ref_load
from buffalo_tpu.parallel import ParW2V as RefParW2V
from buffalo_tpu_torch.convert import load_reference_model
from buffalo_tpu_torch.data import StreamOptions as PortStreamOptions
from buffalo_tpu_torch.data import load as port_load
from tests.test_torch_native_ref import jax_native_lib  # noqa: F401

# the JAX package's native library, built and loaded under a lock
# (see test_torch_native_ref.py)
pytestmark = pytest.mark.usefixtures("jax_native_lib")

TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions' many small ops run fastest on one thread, and
    then do not contend with other test processes' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clustered(rng):
    cl = rng.integers(0, 5, 60)
    lines = []
    for _ in range(300):
        members = np.nonzero(cl == rng.integers(0, 5))[0]
        lines.append(rng.choice(members, size=10, replace=True))
    return lines, cl


def _zipf_lines(rng, V=300, n_lines=600):
    p = 1.0 / np.arange(1, V + 1) ** 0.8
    return [rng.choice(V, size=int(k), p=p / p.sum())
            for k in rng.integers(2, 12, n_lines)], None


def _build(options, load, path, root):
    opt = options().get_default_option()
    opt.input.main = path
    opt.data.path = str(root / "s.bfo")
    opt.data.tmp_dir = str(root / "tmp")
    opt.data.validation = {}
    data = load(opt)
    data.create()
    return data


def _corpus(root, make):
    lines, clusters = make(np.random.default_rng(3))
    path = root / "main.txt"
    path.write_text("\n".join(" ".join(f"w{int(x)}" for x in s)
                              for s in lines) + "\n")
    return dict(clusters=clusters,
                ref=_build(RefStreamOptions, ref_load, str(path),
                           root / "ref"),
                port=_build(PortStreamOptions, port_load, str(path),
                            root / "port"))


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    return {name: _corpus(tmp_path_factory.mktemp(f"w2v_{name}"), make)
            for name, make in (("clustered", _clustered),
                               ("zipf", _zipf_lines))}


@pytest.fixture(scope="module")
def clustered(corpora):
    return corpora["clustered"]


def _model(pkg, data, seed=5, **kw):
    opt = pkg.W2VOption().get_default_option()
    opt.update(dict(d=8, num_iters=3, min_count=2, window=4, lr=0.05))
    opt.update(kw)
    if pkg is ref:
        opt.num_devices = 1
    else:
        opt.device = "cpu"
    model = pkg.W2V(opt, data=data)
    np.random.seed(seed)
    model.initialize()
    return model


def _np_alias(alias):
    return tuple(np.asarray(a) for a in alias)


def jax_key_chain(seed, shards=1):
    """The port's two hooks, drawing as the JAX package's W2V does from
    ``PRNGKey(seed)``; on a mesh of ``shards`` shards the draws of the
    global batch (``shards`` x the shard's rows), sliced at the shard's
    ``slot_offset`` (``_w2v_step_body`` :503-511, ``w2v_epoch_stream_dp``
    :405-411)."""
    state = {"rng": jax.random.PRNGKey(seed), "epoch": None}

    def chunk_key(epoch, group, groups, cidx):
        if epoch != state["epoch"]:
            state["rng"], state["sub"] = jax.random.split(state["rng"])
            state["epoch"] = epoch
        sub = state["sub"]
        if groups > 1:
            sub = jax.random.fold_in(sub, group)
        return jax.random.fold_in(sub, cidx)

    def pair(targets, vocab_size, *, num_negatives, seed, epoch, chunk,
             alias, group, groups, cidx, slot_offset):
        k1, k2, k3 = jax.random.split(chunk_key(epoch, group, groups, cidx),
                                      3)
        prob, al = (jnp.asarray(a) for a in _np_alias(alias))
        t = jnp.asarray(targets.numpy())[:, None]
        B = targets.shape[0]

        def draw(k):
            return JS.draw_from_alias(k, (B * shards, num_negatives), prob,
                                      al)[slot_offset:slot_offset + B]

        negs = draw(k1)
        negs = jnp.where(negs == t, draw(k2), negs)
        negs = jnp.where(negs == t, draw(k3), negs)
        negs = jnp.where(negs == t, (t + 1) % vocab_size, negs)
        return torch.from_numpy(np.array(negs))

    def stream(num_blocks, vocab_size, *, num_negatives, seed, epoch, chunk,
               alias, device, group, groups, cidx, slot_offset):
        prob, al = (jnp.asarray(a) for a in _np_alias(alias))
        return torch.from_numpy(np.array(JS.draw_from_alias(
            chunk_key(epoch, group, groups, cidx),
            (num_blocks * shards, num_negatives), prob, al)
            [slot_offset:slot_offset + num_blocks]))

    return pair, stream


def _train(model):
    seen = []
    model.train(training_callback=lambda i, m: seen.append(m["train_loss"]))
    return seen


# ------------------------------------------------------------ host phases
@pytest.mark.parametrize("name", ["clustered", "zipf"])
def test_vocab_and_alias_tables_match_jax(corpora, name):
    corpus = corpora[name]
    a, b = _model(ref, corpus["ref"]), _model(port, corpus["port"])
    for name in ("index", "inv_index", "scale", "dist"):
        x, y = np.asarray(a._vocab[name]), np.asarray(b._vocab[name])
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name
    assert a._vocab.size == b._vocab.size > 0
    assert a._vocab.total_word_count == b._vocab.total_word_count
    np.testing.assert_array_equal(a.L0, b.L0)
    weights = np.diff(np.asarray(b._vocab.dist, dtype=np.int64), prepend=0)
    for x, y in zip(JS.build_alias_table(weights),
                    S.build_alias_table(weights)):
        assert np.asarray(x).tobytes() == y.tobytes()
    header = b.data.get_header()
    uni = np.bincount(np.asarray(b.data.get_group("rowwise")["key"]),
                      minlength=header["num_items"])
    np.testing.assert_array_equal(
        b.get_sampling_distribution(uni, b._vocab.index, b._vocab.size),
        a.get_sampling_distribution(uni, a._vocab.index, a._vocab.size))


@pytest.mark.parametrize("name", ["clustered", "zipf"])
@pytest.mark.parametrize("native", [True, False])
def test_generate_pairs_byte_equal(corpora, monkeypatch, native, name):
    """One epoch's pairs from one numpy seed: the native library's
    position-major expansion, or both packages' numpy loops."""
    corpus = corpora[name]
    a, b = _model(ref, corpus["ref"]), _model(port, corpus["port"])
    if not native:
        import buffalo_tpu.data.native as jn
        import buffalo_tpu_torch.data.native as pn
        monkeypatch.setattr(jn, "w2v_pairs_native", lambda *a, **k: None)
        monkeypatch.setattr(pn, "w2v_pairs_native", lambda *a, **k: None)
    else:
        from buffalo_tpu_torch.data import native as pn
        assert pn.get_lib() is not None
    for seed in (0, 7):
        x = a._generate_pairs(np.random.default_rng(seed))
        y = b._generate_pairs(np.random.default_rng(seed))
        assert x[2] == y[2] > 0
        for u, v in zip(x[:2], y[:2]):
            assert u.dtype == v.dtype and u.tobytes() == v.tobytes()


def _record(monkeypatch, target, name, calls, n_arrays, jax_side):
    def rec(L0, L1, *args, **kw):
        calls.append(([np.array(a) for a in args[:n_arrays]], args, kw))
        zero = jnp.float32(0) if jax_side else torch.zeros(())
        return ((L0, L1, zero, zero + 1) if jax_side
                else (zero, zero + 1))
    monkeypatch.setattr(target, name, rec)


@pytest.mark.parametrize("pair_gen", ["host", "device"])
def test_epoch_inputs_byte_equal(clustered, monkeypatch, pair_gen):
    """What each group of each epoch hands the epoch kernels, with the
    kernels recorded instead of run: the pair chunks (host) or the token
    chunks' int32 words, uint8 sentence starts and half-windows (device),
    byte for byte, with the group's start (float32), the words per chunk,
    the total and the rates; groups of at most four chunks, so that the
    epochs run as several groups."""
    jcalls, pcalls = [], []
    if pair_gen == "host":
        _record(monkeypatch, JM, "w2v_epoch", jcalls, 2, True)
        _record(monkeypatch, W, "w2v_epoch", pcalls, 2, False)
        kw = dict(max_chunks_per_dispatch=2, batch_size=1024)
        p0_at = 3      # (inputs, targets, alias, processed0)
    else:
        _record(monkeypatch, JW, "w2v_epoch_stream", jcalls, 3, True)
        _record(monkeypatch, W, "w2v_epoch_stream", pcalls, 3, False)
        kw = dict(pair_gen="device", max_chunks_per_dispatch=4)
        p0_at = 4      # (words, bounds, half, alias, processed0)
    _model(ref, clustered["ref"], **kw).train()
    b = _model(port, clustered["port"], **kw)
    b.train()
    assert len(jcalls) == len(pcalls) >= 6
    assert {s["groups"] for s in b.epoch_stats} == {len(pcalls) // 3}
    for (ja, jargs, jkw), (pa, pargs, pkw) in zip(jcalls, pcalls):
        for x, y in zip(ja, pa):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
        # JAX: (..., key, processed0) on the host path, (..., key,
        # processed0, dist) on the stream path: processed0 is args[4]
        assert np.float32(np.asarray(jargs[4])) == pargs[p0_at]
        for k in ("words_per_chunk", "total_words", "lr", "min_lr"):
            assert jkw[k] == pkw[k], k


# --------------------------------------------------------- 3-epoch parity
CASES = {
    "host": dict(),
    "host_groups": dict(max_chunks_per_dispatch=2, batch_size=1024),
    "host_streamed": dict(resident_mb=0),
    "device_block4": dict(pair_gen="device", neg_block=4),
    "device_block16": dict(pair_gen="device", neg_block=16,
                           max_chunks_per_dispatch=4),
    "device_wide": dict(pair_gen="device", neg_block=4, d=300),
}


@pytest.mark.parametrize("name,case", [("clustered", c) for c in CASES]
                         + [("zipf", "host"), ("zipf", "device_block4")])
def test_train_matches_jax(corpora, monkeypatch, name, case):
    """3 epochs with the JAX package's negatives: L0, L1 and the losses."""
    corpus = corpora[name]
    kw = CASES[case]
    a = _model(ref, corpus["ref"], **kw)
    la = _train(a)
    pair, stream = jax_key_chain(int(a.opt.random_seed))
    monkeypatch.setattr(W, "w2v_negatives", pair)
    monkeypatch.setattr(W, "stream_negatives", stream)
    b = _model(port, corpus["port"], **kw)
    lb = _train(b)
    assert len(la) == len(lb) == 3 and lb == b.iteration_losses
    np.testing.assert_allclose(lb, la, rtol=LOSS_RTOL)
    np.testing.assert_allclose(b.L0, a.L0, **TOL)
    np.testing.assert_allclose(b.L1, a.L1, **TOL)
    assert b.L0.shape == (b._vocab.size, int(b.opt.d))
    if "groups" in case or "16" in case:
        assert max(s["groups"] for s in b.epoch_stats) > 1


def _quality_run(data, pair_gen, **kw):
    opt = port.W2VOption().get_default_option()
    opt.update(dict(d=16, num_iters=20, min_count=2, window=4, lr=0.05,
                    pair_gen=pair_gen, device="cpu"), **kw)
    np.random.seed(5)
    m = port.W2V(opt, data=data)
    m.initialize()
    return m, m.train()["train_loss"]


def _purity(model, clusters):
    hits = total = 0
    for w in ["w0", "w1", "w2"]:
        for key, _ in model.most_similar(w, topk=5):
            total += 1
            hits += clusters[int(key[1:])] == clusters[int(w[1:])]
    assert total > 0
    return hits / total


def test_own_philox_runs_meet_the_jax_gates(clustered):
    """The port's own draws, both paths: cluster purity > 0.5 and the
    device path's loss below 1.15x the host path's (the JAX package's
    ``test_w2v_device_pair_gen_quality``)."""
    m_host, loss_host = _quality_run(clustered["port"], "host")
    m_dev, loss_dev = _quality_run(clustered["port"], "device",
                                   neg_block=16)
    assert loss_dev < loss_host * 1.15, (loss_dev, loss_host)
    assert _purity(m_host, clustered["clusters"]) > 0.5
    assert _purity(m_dev, clustered["clusters"]) > 0.5


# -------------------------------------------------- save / load, serving
def test_save_load_both_ways(clustered, tmp_path):
    """A port file opens in the JAX package and a JAX file in the port
    (``load_reference_model``), with no data attached: L0, the vocabulary
    record and the serving calls agree."""
    b = _model(port, clustered["port"], num_iters=2)
    b.train()
    b.build_itemid_map()
    pb = str(tmp_path / "port.w2v")
    b.save(pb)
    ja = ref.W2V.new(pb)
    np.testing.assert_array_equal(ja.L0, b.L0)
    assert ja._vocab.size == b._vocab.size
    a = _model(ref, clustered["ref"], num_iters=2)
    a.train()
    a.build_itemid_map()
    pa = str(tmp_path / "ref.w2v")
    a.save(pa)
    loaded = load_reference_model(pa, device="cpu")
    assert isinstance(loaded, port.W2V) and loaded.data is None
    assert loaded.device.type == "cpu"
    np.testing.assert_array_equal(loaded.L0, a.L0)
    for name in ("index", "inv_index", "scale", "dist"):
        np.testing.assert_array_equal(loaded._vocab[name], a._vocab[name])
    keys = [k for k in a._idmanager.itemids
            if a._vocab.index[int(k[1:])] > 0][:3]
    assert loaded.analogy(*keys, topk=3) == ref.W2V.new(pa).analogy(
        *keys, topk=3)
    got = loaded.most_similar_vec(loaded.L0[0], topk=4)
    want = ref.W2V.new(pa).most_similar_vec(a.L0[0], topk=4)
    assert [k for k, _ in got] == [k for k, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=1e-5)


def test_retrieval_matches_jax(clustered, tmp_path):
    """``most_similar``, ``analogy`` and ``ParW2V`` (pool, ``repr``) of the
    same trained table in both packages: ids equal off ties, scores
    within 1e-5."""
    a = _model(ref, clustered["ref"], num_iters=3, d=16)
    a.train()
    a.build_itemid_map()
    path = str(tmp_path / "m.w2v")
    a.save(path)
    b = load_reference_model(path, device="cpu")
    for w in ("w0", "w5", "w17"):
        x, y = a.most_similar(w, topk=6), b.most_similar(w, topk=6)
        assert [k for k, _ in x] == [k for k, _ in y]
        np.testing.assert_allclose([s for _, s in y], [s for _, s in x],
                                   rtol=1e-5)
    assert b.analogy("w0", "w1", "w2", topk=4) == a.analogy("w0", "w1", "w2",
                                                           topk=4)
    assert b.most_similar("not-a-word") == []
    keys = [f"w{i}" for i in range(12)] + ["not-a-word"]
    pool = [f"w{i}" for i in range(0, 60, 2)]
    for kw in (dict(), dict(pool=pool), dict(repr=True)):
        ti, si = RefParW2V(a).most_similar(keys, topk=5, **kw)
        tp, sp = port.ParW2V(b).most_similar(keys, topk=5, **kw)
        np.testing.assert_allclose(np.asarray(sp), np.asarray(si),
                                   rtol=1e-5, atol=1e-6)
        si = np.asarray(si)
        for r, (x, y) in enumerate(zip(ti, tp)):
            for c, (u, v) in enumerate(zip(x, y)):
                tie = np.isclose(si[r], si[r, c], rtol=1e-5).sum() > 1
                assert u == v or tie, (r, c, u, v)


def test_errors_and_options(clustered):
    """More than one device trains on the dp mesh (once
    ``NotImplementedError``): 2 shards within 1e-5 of one device on the
    port's own draws; an unknown ``pair_gen`` raises; the options are the
    JAX package's plus ``device``."""
    b = _model(port, clustered["port"], num_devices=2, devices=["cpu"] * 2,
               num_iters=1)
    b.train()
    one = _model(port, clustered["port"], num_iters=1)
    one.train()
    np.testing.assert_allclose(b.L0, one.L0, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b.L1, one.L1, rtol=1e-5, atol=1e-6)
    c = _model(port, clustered["port"], pair_gen="tpu")
    with pytest.raises(ValueError, match="pair_gen"):
        c.train()
    assert port.W2VOption().get_default_option() == {
        **ref.W2VOption().get_default_option(), "device": "cuda"}
