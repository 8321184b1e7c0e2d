"""The port's W2V kernels (plain versions of K19, K20 and K21) against
``buffalo_tpu.ops.w2v_kernels`` on the CPU.

The JAX package draws its negatives inside its jitted programs from
threefry keys; the tests recompute the same draws from the same keys
(``draw_from_alias`` and the three-attempt redraw of ``_w2v_step_body``)
and hand them to the port, through ``negatives=`` or by replacing the
hooks ``w2v_negatives`` / ``stream_negatives``, so both sides train on the
same negatives.  Inputs are made with numpy from seeds: tables at the
scale training reaches (so the ±6 clamps and the step-norm cap bind), a
Zipf(0.8) token chunk whose sentence ends fall inside negative blocks,
padding at the chunk's end.  Tolerance: 1e-5 relative to the largest
entry (float32 sums in another order: the JAX package's scatter-adds and
einsums against the port's ``index_add_`` and einsums), counts and
integer outputs exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import buffalo_tpu.ops.sgd_kernels as JS
import buffalo_tpu.ops.w2v_kernels as JW
import buffalo_tpu_torch.ops.sgd_kernels as S
import buffalo_tpu_torch.ops.w2v_kernels as W
from buffalo_tpu_torch.parallelism import Mesh

RTOL = 1e-5
# the epochs' single device: a mesh of one shard on the CPU
_CPU = torch.device("cpu")
_ONE = Mesh([_CPU])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions' many small ops run fastest on one thread, and
    then do not contend with other test processes' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol=RTOL):
    """Within ``rtol`` of the largest entry of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rtol * scale, f"{err:.3g} > {rtol} x {scale:.3g}"


def _tables(V, d, seed, scale=0.5):
    rng = np.random.default_rng(seed)
    L0 = (scale * rng.standard_normal((V, d))).astype(np.float32)
    L1 = (scale * rng.standard_normal((V, d))).astype(np.float32)
    return L0, L1


def _zipf(V, n, rng):
    p = 1.0 / np.arange(1, V + 1) ** 0.8
    return rng.choice(V, size=n, p=p / p.sum()).astype(np.int32)


def _alias(V):
    """The unigram^0.75 alias tables of a Zipf vocabulary, both packages'
    (byte-equal: the same float64 set-up)."""
    w = (1.0 / np.arange(1, V + 1) ** 0.8) ** 0.75
    prob, al = S.build_alias_table(w)
    jprob, jal = JS.build_alias_table(w)
    assert prob.tobytes() == np.asarray(jprob).tobytes()
    assert al.tobytes() == np.asarray(jal).tobytes()
    return prob, al


def jax_pair_negatives(key, targets, V, K, dist):
    """``_w2v_step_body``'s negatives (:500-517) from ``key``."""
    k1, k2, k3 = jax.random.split(key, 3)
    prob, al = (jnp.asarray(a) for a in dist)
    B = targets.shape[0]
    t = jnp.asarray(targets)[:, None]

    def draw(k):
        return JS.draw_from_alias(k, (B, K), prob, al)

    negs = draw(k1)
    negs = jnp.where(negs == t, draw(k2), negs)
    negs = jnp.where(negs == t, draw(k3), negs)
    negs = jnp.where(negs == t, (t + 1) % V, negs)
    return np.asarray(negs)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------- _g
def test_g_matches_jax_at_the_clamps():
    f = np.array([-50, -7, -6.001, -6, -5.999, -1, 0, 0.5, 5.999, 6, 6.001,
                  7, 50], np.float32)
    for label in (0.0, 1.0):
        want = np.asarray(JW._g(label, jnp.asarray(f)))
        got = W.g(label, _t(f)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
        # outside ±6 the clamps, exactly
        out = np.abs(f) > 6
        np.testing.assert_array_equal(got[out], want[out])


# -------------------------------------------------------- _clipped_apply
# d: a narrow row, the W2V path's 32 and 300 (past 256 floats, the wide
# instantiation of K20)
@pytest.mark.parametrize("d", [12, 32, 300])
@pytest.mark.parametrize("cap", [0.0, 0.1, 1e-3])
def test_clipped_apply_and_row_apply_match_jax(cap, d):
    """``_clipped_apply`` of the scattered deltas: the dense form and
    K20's plain version (two parts, each with keys V dropped, a head key of
    20,000 entries, a scale); at cap 1e-3 every touched row's step binds."""
    rng = np.random.default_rng(1)
    V, n = 400, 400
    # W2V-sized table entries (its L0 starts as |N(0, 1 / d^2)|), so that
    # T + step rounds below the check's resolution of the steps
    T = (rng.standard_normal((V, d)) / d).astype(np.float32)
    keys = [np.concatenate([_zipf(V, n, rng), np.full(20000, 3, np.int32)]),
            _zipf(V, n // 2, rng)]
    keys[0] = keys[0][rng.permutation(len(keys[0]))]
    keys[0][::7] = V       # dropped
    keys[1][::5] = V
    rows = [(0.05 * rng.standard_normal((len(k), d))).astype(np.float32)
            for k in keys]
    scale = 0.025
    dT = jnp.zeros((V, d), jnp.float32)
    for k, r in zip(keys, rows):
        dT = dT.at[jnp.asarray(k)].add(scale * jnp.asarray(r), mode="drop")
    want = np.asarray(JW._clipped_apply(jnp.asarray(T), dT, cap))
    close(W.clipped_apply(_t(T), _t(np.asarray(dT)), cap).numpy(), want)
    got = _t(T.copy())
    W.row_apply(got, [(_t(k), _t(r)) for k, r in zip(keys, rows)],
                scale=scale, cap=cap)
    close(got.numpy() - T, want - T)
    untouched = np.setdiff1d(np.arange(V), np.concatenate(keys))
    assert len(untouched) > 0
    np.testing.assert_array_equal(got.numpy()[untouched], T[untouched])
    if cap == 1e-3:
        steps = np.linalg.norm(want - T, axis=1)
        touched = steps > 0
        assert touched.sum() > 10
        np.testing.assert_allclose(steps[touched], cap, rtol=1e-3)


# ------------------------------------------------------- negatives (K19)
def test_pair_negatives_rules():
    """The pair path's draws: never the target; attempt 0 is K8's alias
    draw of the same slot, chunk and epoch; a target holding the whole
    distribution falls back to (t + 1) % V after three attempts."""
    V, B, K = 40, 300, 5
    prob, al = _alias(V)
    alias = (_t(prob), _t(al))
    rng = np.random.default_rng(2)
    targets = _t(_zipf(V, B, rng))
    negs = W.w2v_negatives(targets, V, num_negatives=K, seed=9, epoch=2,
                           chunk=5, alias=alias)
    assert negs.shape == (B, K) and negs.dtype == torch.int32
    assert not (negs == targets[:, None]).any()
    first, _ = S.sample_negatives(torch.zeros(B, dtype=torch.int32), V,
                                  num_negatives=K, seed=9, epoch=2, chunk=5,
                                  alias=alias)
    first = first.reshape(B, K)
    ok = first != targets[:, None]
    assert ok.float().mean() > 0.8
    assert torch.equal(negs[ok], first[ok])
    # one word holds all the mass: every draw is it
    w = np.zeros(V)
    w[7] = 1.0
    p1, a1 = S.build_alias_table(w)
    t7 = torch.full((B,), 7, dtype=torch.int32)
    negs7 = W.w2v_negatives(t7, V, num_negatives=K, seed=9, epoch=0,
                            chunk=0, alias=(_t(p1), _t(a1)))
    assert (negs7 == 8).all()
    # the stream path's draws are K8's, one attempt
    sn = W.stream_negatives(B, V, num_negatives=K, seed=9, epoch=2, chunk=5,
                            alias=alias, device=torch.device("cpu"))
    assert torch.equal(sn, first)


# ------------------------------------------------------------------ K19
def _pair_problem(seed, V=60, B=256, K=5, d=16, pad=20):
    rng = np.random.default_rng(seed)
    L0, L1 = _tables(V, d, seed, scale=0.9)
    inputs, targets = _zipf(V, B, rng), _zipf(V, B, rng)
    inputs[-pad:] = V
    targets[-pad:] = V
    return L0, L1, inputs, targets, _alias(V)


@pytest.mark.parametrize("cap", [0.0, 0.1])
def test_w2v_step_matches_jax(cap):
    """One pair chunk: ``w2v_step`` (JAX, its own draws) against K19 + K20's
    plain versions on the negatives recomputed from the same key."""
    V, K = 60, 5
    L0, L1, inputs, targets, dist = _pair_problem(3)
    key = jax.random.PRNGKey(17)
    kw = dict(num_negatives=K, vocab_size=V, compute_loss=True,
              max_step_norm=cap)
    jl0, jl1, jloss, jcnt = JW.w2v_step(
        jnp.asarray(L0), jnp.asarray(L1), jnp.asarray(inputs),
        jnp.asarray(targets), tuple(jnp.asarray(a) for a in dist), key,
        jnp.float32(0.05), **kw)
    negs = jax_pair_negatives(key, targets, V, K, dist)
    assert not (negs == targets[:, None]).any()
    p0, p1 = _t(L0.copy()), _t(L1.copy())
    loss, cnt = W.w2v_step(p0, p1, _t(inputs), _t(targets), 0.05, seed=0,
                           epoch=0, chunk=0, alias=None,
                           negatives=_t(negs), **kw)
    close(p0.numpy() - L0, np.asarray(jl0) - L0)
    close(p1.numpy() - L1, np.asarray(jl1) - L1)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    assert float(cnt) == float(jcnt) == len(inputs) - 20


def test_pair_step_rows_match_the_jax_body():
    """K19's outputs one by one: the keys (padding pairs keyed V), the
    lr-scaled delta rows of the targets, negatives and inputs, against the
    scatters of ``_w2v_step_body``; the pair count exact."""
    V, K, lr = 60, 5, 0.05
    L0, L1, inputs, targets, dist = _pair_problem(4)
    negs = jax_pair_negatives(jax.random.PRNGKey(4), targets, V, K, dist)
    ng, keys1, d1, d0, _, cnt = W.pair_step(
        _t(L0), _t(L1), _t(inputs), _t(targets), lr, vocab_size=V,
        num_negatives=K, seed=0, epoch=0, chunk=0, alias=None,
        negatives=_t(negs))
    assert torch.equal(ng, _t(negs))
    valid = inputs < V
    np.testing.assert_array_equal(keys1[:len(inputs)].numpy(),
                                  np.where(valid, targets, V))
    np.testing.assert_array_equal(
        keys1[len(inputs):].numpy().reshape(-1, K),
        np.where(valid[:, None], negs, V))
    # the JAX body's dL1 / dL0 before the cap = the rows scattered
    dl1 = np.zeros_like(L1)
    np.add.at(dl1, keys1.numpy()[keys1.numpy() < V],
              d1.numpy()[keys1.numpy() < V])
    dl0 = np.zeros_like(L0)
    np.add.at(dl0, inputs[valid], d0.numpy()[valid])
    # ``w2v_step`` is ``_w2v_step_body`` jitted; cap 0: the plain scatters
    jl0, jl1, _, jcnt = JW.w2v_step(
        jnp.asarray(L0), jnp.asarray(L1), jnp.asarray(inputs),
        jnp.asarray(targets), tuple(jnp.asarray(a) for a in dist),
        jax.random.PRNGKey(4), jnp.float32(lr), num_negatives=K,
        vocab_size=V, compute_loss=True, max_step_norm=0.0)
    close(dl1, np.asarray(jl1) - L1)
    close(dl0, np.asarray(jl0) - L0)
    assert np.abs(d0.numpy()[~valid]).max() == 0.0
    assert float(cnt) == float(jcnt)


def test_w2v_epoch_two_groups_matches_jax(monkeypatch):
    """Two groups of two chunks each (``w2v_epoch`` :48 per group, the rate
    in float32 from each group's start, ``fold_in`` per group and chunk):
    the port's ``w2v_epoch`` with ``w2v_negatives`` replaced by the JAX
    package's draws on the same keys."""
    V, K, N, d = 60, 5, 256, 16
    rng = np.random.default_rng(5)
    L0, L1 = _tables(V, d, 5, scale=0.8)
    dist = _alias(V)
    inputs = _zipf(V, 4 * N, rng).reshape(4, N)
    targets = _zipf(V, 4 * N, rng).reshape(4, N)
    inputs[3, -30:] = V
    targets[3, -30:] = V
    sub = jax.random.PRNGKey(21)
    com = dict(num_negatives=K, vocab_size=V, compute_loss=True, lr=0.05,
               min_lr=0.0001, total_words=3000.0, words_per_chunk=375.0,
               max_step_norm=0.1)

    def jax_draws(targets, vocab_size, *, num_negatives, seed, epoch, chunk,
                  alias, group, groups, cidx, slot_offset):
        key = jax.random.fold_in(jax.random.fold_in(sub, group), cidx)
        assert chunk == group * 2 + cidx and groups == 2 and slot_offset == 0
        return _t(jax_pair_negatives(key, targets.numpy(), vocab_size,
                                     num_negatives, dist))

    monkeypatch.setattr(W, "w2v_negatives", jax_draws)
    jl0, jl1 = jnp.asarray(L0), jnp.asarray(L1)
    p0, p1 = _t(L0.copy()), _t(L1.copy())
    for g in range(2):
        sl = slice(2 * g, 2 * g + 2)
        proc = 1000.0 + g * 2 * 375.0
        jl0, jl1, jloss, jcnt = JW.w2v_epoch(
            jl0, jl1, jnp.asarray(inputs[sl]), jnp.asarray(targets[sl]),
            tuple(jnp.asarray(a) for a in dist),
            jax.random.fold_in(sub, g), jnp.float32(proc), **com)
        loss, cnt = W.w2v_epoch(_ONE, {_CPU: (p0, p1)}, [_t(inputs[sl])],
                                [_t(targets[sl])],
                                {_CPU: (_t(dist[0]), _t(dist[1]))},
                                np.float32(proc), seed=0, epoch=0, group=g,
                                groups=2, **com)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
        assert float(cnt) == float(jcnt)
    close(p0.numpy() - L0, np.asarray(jl0) - L0)
    close(p1.numpy() - L1, np.asarray(jl1) - L1)


def test_rates_match_the_jax_forms():
    """The float32 device rate (:66-70) and the streaming fallback's
    float64 host rate (:609-618)."""
    f = np.float32
    for p0, c, wpc, tot in [(0.0, 0, 375.0, 3000.0), (1234.5, 3, 77.25,
                                                      5e4), (9e6, 31,
                                                             3.3e5, 1.2e7)]:
        progress = jnp.minimum((jnp.float32(p0) + f(c) * f(wpc))
                               / jnp.maximum(f(tot), 1.0), 1.0)
        want = float(jnp.maximum(f(0.025) - (f(0.025) - f(1e-4)) * progress,
                                 f(1e-4)))
        assert W.device_rate(0.025, 1e-4, p0, c, wpc, tot) == want
        prog = min((p0 + c * wpc) / max(tot, 1.0), 1.0)
        assert W.host_rate(0.025, 1e-4, p0 + c * wpc, tot) == float(
            jnp.float32(max(0.025 - (0.025 - 1e-4) * prog, 1e-4)))


# ------------------------------------------------------------------ K21
def _chunk(seed, V=80, T=512, block=4, window=5, pad=37, p_end=0.12):
    """A Zipf token chunk whose sentences end anywhere (inside negative
    blocks too), the JAX wire format's padding at its end."""
    rng = np.random.default_rng(seed)
    wc = _zipf(V, T, rng)
    bnd = (rng.random(T) < p_end).astype(np.uint8)
    bnd[0] = 1
    hc = (window - rng.integers(0, window, T)).astype(np.uint8)
    wc[T - pad:] = V
    bnd[T - pad:] = 1
    hc[T - pad:] = 0
    sc = np.cumsum(bnd.astype(np.int32)).astype(np.int32)
    inside = [i for i in range(1, T - pad) if bnd[i] and i % block]
    assert len(inside) > 10
    return wc, bnd, sc, hc


@pytest.mark.parametrize("offset_mode", ["scan", "unrolled"])
@pytest.mark.parametrize("block", [4, 16])
def test_stream_chunk_deltas_match_jax(offset_mode, block):
    """``_stream_chunk_deltas`` (both JAX offset modes) against K21's plain
    version on the same negatives (the JAX draw)."""
    V, d, K, window = 80, 16, 5, 5
    L0, L1 = _tables(V, d, 7, scale=1.0)
    wc, _, sc, hc = _chunk(8, V=V, block=block, window=window)
    NB = len(wc) // block
    negs = np.asarray(JS.draw_from_alias(
        jax.random.PRNGKey(3), (NB, K), *(jnp.asarray(a) for a in _alias(V))))
    jfn = jax.jit(JW._stream_chunk_deltas, static_argnames=(
        "window", "block", "vocab_size", "compute_loss", "offset_mode"))
    want = jfn(jnp.asarray(L0), jnp.asarray(L1), jnp.asarray(wc),
               jnp.asarray(sc), jnp.asarray(hc.astype(np.int32)),
               jnp.take(jnp.asarray(L1), jnp.asarray(negs), axis=0),
               jnp.asarray(negs), window=window, block=block, vocab_size=V,
               compute_loss=True, offset_mode=offset_mode)
    got = W.stream_chunk_deltas(_t(L0), _t(L1), _t(wc), _t(sc), _t(hc),
                                _t(negs), window=window, block=block,
                                vocab_size=V)
    for a, b in zip(got[:3], want[:3]):
        close(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=RTOL)
    assert float(got[4]) == float(want[4]) > 0


def test_stream_chunk_deltas_padding_and_window():
    """Padding rows stay zero; a chunk of only padding trains nothing; one
    offset fewer moves the deltas past the tolerance (the check's power)."""
    V, d, K, window, block = 80, 8, 5, 5, 4
    L0, L1 = _tables(V, d, 9)
    wc, _, sc, hc = _chunk(10, V=V, window=window)
    negs = _t(np.random.default_rng(0).integers(0, V, (len(wc) // block, K))
              .astype(np.int32))
    args = (_t(L0), _t(L1), _t(wc), _t(sc), _t(hc), negs)
    dL0p, dL1p, dLn, _, _ = W.stream_chunk_deltas(
        *args, window=window, block=block, vocab_size=V)
    pad = wc == V
    assert dL0p[pad].abs().max() == 0 and dL1p[pad].abs().max() == 0
    short = W.stream_chunk_deltas(*args, window=window - 1, block=block,
                                  vocab_size=V)
    for a, b in zip(short[:3], (dL0p, dL1p, dLn)):
        err = float((a - b).abs().max()) / float(b.abs().max())
        assert err > 100 * RTOL
    allpad = torch.full_like(args[2], V)
    z = W.stream_chunk_deltas(args[0], args[1], allpad, args[3], args[4],
                              negs, window=window, block=block, vocab_size=V)
    assert all(float(t.abs().max()) == 0 for t in z)


def test_w2v_epoch_stream_matches_jax(monkeypatch):
    """Two token chunks of one group (``w2v_epoch_stream`` :141): per chunk
    the sentence ids from the uint8 starts, the block-shared draws (the
    port's ``stream_negatives`` replaced by the JAX draw from ``fold_in(key,
    chunk)``), K21's deltas and K20's capped applies, with the float32
    rate."""
    V, d, K, window, block = 80, 16, 5, 5, 4
    L0, L1 = _tables(V, d, 11, scale=0.3)
    dist = _alias(V)
    chunks = [_chunk(12 + c, V=V, window=window) for c in range(2)]
    words = np.stack([c[0] for c in chunks])
    bounds = np.stack([c[1] for c in chunks])
    half = np.stack([c[3] for c in chunks])
    key = jax.random.PRNGKey(5)
    com = dict(window=window, block=block, num_negatives=K, vocab_size=V,
               compute_loss=True, lr=0.05, min_lr=0.0001,
               total_words=4096.0, words_per_chunk=512.0, max_step_norm=0.1)

    def jax_draws(num_blocks, vocab_size, *, num_negatives, seed, epoch,
                  chunk, alias, device, group, groups, cidx, slot_offset):
        assert slot_offset == 0
        return _t(np.asarray(JS.draw_from_alias(
            jax.random.fold_in(key, cidx), (num_blocks, num_negatives),
            *(jnp.asarray(a) for a in dist))))

    monkeypatch.setattr(W, "stream_negatives", jax_draws)
    jl0, jl1, jloss, jcnt = JW.w2v_epoch_stream(
        jnp.asarray(L0), jnp.asarray(L1), jnp.asarray(words),
        jnp.asarray(bounds), jnp.asarray(half), key, jnp.float32(100.0),
        tuple(jnp.asarray(a) for a in dist), **com)
    p0, p1 = _t(L0.copy()), _t(L1.copy())
    loss, cnt = W.w2v_epoch_stream(
        _ONE, {_CPU: (p0, p1)}, [_t(words)], [_t(bounds)], [_t(half)],
        {_CPU: (_t(dist[0]), _t(dist[1]))}, np.float32(100.0), seed=0,
        epoch=0, group=0, groups=1, **com)
    close(p0.numpy() - L0, np.asarray(jl0) - L0)
    close(p1.numpy() - L1, np.asarray(jl1) - L1)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    assert float(cnt) == float(jcnt)


@pytest.mark.parametrize("K", [1, 5, 9])
@pytest.mark.parametrize("shards", [2, 3, 4])
def test_pair_step_shards_at_their_offsets_are_the_chunks(shards, K):
    """A pair chunk cut into ``shards`` shards, each through ``pair_step``
    at its ``slot_offset`` (its first pair of the chunk, as
    ``_w2v_step_body`` :503-511 slices the global batch's draws): the
    negatives and keys bit for bit the single device's for those pairs,
    the delta rows and loss within 1e-5 of its, the pair counts summing
    to its count."""
    V, B, lr = 60, 240, 0.05
    L0, L1, inputs, targets, dist = _pair_problem(6, V=V, B=B, K=K)
    kw = dict(vocab_size=V, num_negatives=K, seed=3, epoch=1, chunk=2,
              alias=(_t(dist[0]), _t(dist[1])))
    L0, L1 = _t(L0), _t(L1)
    negs, keys1, d1, d0, loss, cnt = W.pair_step(
        L0, L1, _t(inputs), _t(targets), lr, **kw)
    n = B // shards
    got_loss = got_cnt = 0.0
    for g in range(shards):
        sl = slice(g * n, (g + 1) * n)
        sn, sk, s1, s0, sloss, scnt = W.pair_step(
            L0, L1, _t(inputs[sl]), _t(targets[sl]), lr, slot_offset=g * n,
            **kw)
        assert torch.equal(sn, negs[sl])
        assert torch.equal(sk[:n], keys1[sl])
        assert torch.equal(sk[n:], keys1[B:].reshape(B, K)[sl].reshape(-1))
        close(s1[:n].numpy(), d1[sl].numpy())
        close(s1[n:].numpy(), d1[B:].reshape(B, K, -1)[sl].reshape(n * K, -1)
              .numpy())
        close(s0.numpy(), d0[sl].numpy())
        got_loss += float(sloss)
        got_cnt += float(scnt)
    np.testing.assert_allclose(got_loss, float(loss), rtol=RTOL)
    assert got_cnt == float(cnt) == B - 20
