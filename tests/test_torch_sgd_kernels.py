"""The port's BPR kernels' plain versions (``ops/sgd_kernels.py``) against
the JAX package's ``sgd_kernels``, on the CPU.

* Host helpers: bloom words, alias tables and ``pad_cols`` byte-identical
  to the JAX package's; the int64 bloom hashes equal to its uint32 ones.
* K8 (the sampler) draws from the port's own Philox4x32-10 stream, so it
  is held to its rules, not to JAX's bits: the generator's known answers
  (Random123's test vectors), a positive never accepted, the uniform and
  the alias draws' counts within 4 sigma of their weights, the draws a
  function of (seed, epoch, chunk) alone, random positives from the
  user's list.
* K9 / K10 on injected negatives: the port's epoch against JAX's
  ``bpr_epoch(precomputed_neg=True)`` (sgd with and without the row cap,
  adagrad and adam with and without per-coordinate normalization, two
  negatives per slot, sentinel negatives, a masked tail, no bias, frozen
  item sides), the streaming steps against ``bpr_sgd_step`` /
  ``bpr_accumulate_step`` + ``apply_deferred_update`` on the same key's
  negatives, and the loss against ``bpr_loss``.  Tolerance: float32 sums
  in another order, rtol 1e-5 / atol 1e-6 on the tables after one epoch
  (readings: at most 1.9e-6 apart, on tables that moved by up to 1.9).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buffalo_tpu.ops import sgd_kernels as J
from buffalo_tpu_torch.ops import sgd_kernels as K
from buffalo_tpu_torch.parallelism import Mesh

TOL = dict(rtol=1e-5, atol=1e-6)


def _toy_csr(num_users=50, num_items=40, seed=0, max_deg=12):
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, max_deg, num_users)
    indptr = np.zeros(num_users + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    keys = rng.integers(0, num_items, int(indptr[-1])).astype(np.int32)
    return indptr, keys


# ------------------------------------------------------------ host helpers
@pytest.mark.parametrize("shape", [(50, 40, 0), (3000, 700, 1), (1, 1, 2)])
def test_bloom_words_identical(shape):
    indptr, keys = _toy_csr(*shape)
    words, log2 = K.build_bloom(indptr, keys)
    ref_words, ref_log2 = J.build_bloom(indptr, keys)
    assert log2 == ref_log2 and words.dtype == ref_words.dtype
    assert words.tobytes() == ref_words.tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_alias_tables_identical(seed):
    rng = np.random.default_rng(seed)
    w = rng.pareto(1.2, 500) * (rng.random(500) > 0.1)
    w[3] = 0.0
    prob, alias = K.build_alias_table(w)
    ref_prob, ref_alias = J.build_alias_table(w)
    assert prob.tobytes() == ref_prob.tobytes()
    assert alias.tobytes() == ref_alias.tobytes()


def test_pad_cols_identical():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    for width in (2, 4, 7):
        assert np.array_equal(K.pad_cols(a, width), J.pad_cols(a, width))


def test_bloom_hashes_plain_equal_uint32():
    rng = np.random.default_rng(5)
    u = rng.integers(0, 1 << 32, 4000, dtype=np.uint64).astype(np.uint32)
    i = rng.integers(0, 1 << 32, 4000, dtype=np.uint64).astype(np.uint32)
    with np.errstate(over="ignore"):
        want = J._bloom_hashes(u, i, 27)
    got = K.bloom_hashes_plain(torch.from_numpy(u.astype(np.int64)),
                               torch.from_numpy(i.astype(np.int64)), 27)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w.astype(np.int64))


# ---------------------------------------------------------------- sampler
@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(ctr, key, want):
    c0 = torch.tensor([ctr[0]], dtype=torch.int64)
    got = K.philox4x32((c0,) + ctr[1:], key)
    assert tuple(int(x[0]) for x in got) == want


def _bloom_t(indptr, keys):
    words, log2 = K.build_bloom(indptr, keys)
    return torch.from_numpy(words.view(np.int32)), log2


@pytest.mark.parametrize("num_negatives", [1, 3])
def test_sampler_never_accepts_a_positive(num_negatives):
    # dense users (up to half the catalog seen) exercise the sentinel
    indptr, keys = _toy_csr(num_users=40, num_items=60, seed=3, max_deg=40)
    bloom, log2 = _bloom_t(indptr, keys)
    users = torch.from_numpy(np.repeat(np.arange(40, dtype=np.int32), 50))
    seen = {(u, int(k)) for u in range(40)
            for k in keys[indptr[u]:indptr[u + 1]]}
    sentinels = 0
    for chunk in range(3):
        neg, pos = K.sample_negatives(
            users, 60, num_negatives=num_negatives, seed=9, epoch=1,
            chunk=chunk, bloom=bloom, bloom_log2=log2)
        assert pos is None and neg.dtype == torch.int32
        assert neg.shape == (users.shape[0] * num_negatives,)
        u = users.repeat_interleave(num_negatives).numpy()
        for uu, n in zip(u, neg.numpy()):
            assert (int(uu), int(n)) not in seen
            assert 0 <= n <= 60
        sentinels += int((neg == 60).sum())
    assert sentinels > 0


def _within_4_sigma(draws, p):
    n = draws.size
    counts = np.bincount(draws, minlength=p.size)
    sigma = np.sqrt(n * p * (1 - p))
    assert np.all(np.abs(counts - n * p) <= 4 * sigma + 1), \
        np.abs(counts - n * p).max()


def test_uniform_draws_match_weights():
    users = torch.zeros(200_000, dtype=torch.int32)
    neg, _ = K.sample_negatives(users, 37, num_negatives=1, seed=1, epoch=0,
                                chunk=0)
    _within_4_sigma(neg.numpy(), np.full(37, 1 / 37))


def test_alias_draws_match_weights():
    rng = np.random.default_rng(0)
    w = rng.pareto(1.0, 300) + 0.01
    w[7] = 0.0
    prob, alias = K.build_alias_table(w)
    users = torch.zeros(100_000, dtype=torch.int32)
    neg, _ = K.sample_negatives(
        users, 300, num_negatives=2, seed=3, epoch=2, chunk=5,
        alias=(torch.from_numpy(prob), torch.from_numpy(alias)))
    draws = neg.numpy()
    assert not np.any(draws == 7)
    _within_4_sigma(draws, w / w.sum())


def test_draws_depend_on_seed_epoch_and_chunk_only():
    indptr, keys = _toy_csr(num_users=20, num_items=500, seed=4)
    bloom, log2 = _bloom_t(indptr, keys)
    users = torch.from_numpy(np.arange(20, dtype=np.int32).repeat(30))
    kw = dict(num_negatives=2, bloom=bloom, bloom_log2=log2)
    base = K.sample_negatives(users, 500, seed=1, epoch=0, chunk=0, **kw)[0]
    again = K.sample_negatives(users, 500, seed=1, epoch=0, chunk=0, **kw)[0]
    assert torch.equal(base, again)
    for other in (dict(seed=2, epoch=0, chunk=0), dict(seed=1, epoch=1,
                                                       chunk=0),
                  dict(seed=1, epoch=0, chunk=1),
                  dict(seed=1 << 40, epoch=0, chunk=0)):
        got = K.sample_negatives(users, 500, **other, **kw)[0]
        assert float((got == base).float().mean()) < 0.05


def test_random_positives_come_from_the_users_lists():
    indptr, keys = _toy_csr(num_users=30, num_items=80, seed=6)
    users = torch.from_numpy(np.arange(30, dtype=np.int32).repeat(40))
    neg, pos = K.sample_negatives(
        users, 80, num_negatives=1, seed=0, epoch=0, chunk=0,
        pos_indptr=torch.from_numpy(indptr), pos_keys=torch.from_numpy(keys))
    for u, p in zip(users.numpy(), pos.numpy()):
        assert p in keys[indptr[u]:indptr[u + 1]]
    picked = {(int(u), int(p)) for u, p in zip(users.numpy(), pos.numpy())}
    assert len(picked) > 30   # not always the first positive


# ---------------------------------------------------------------- K9, K10
U, I, D, NCH, N = 60, 40, 8, 3, 50


def _epoch_inputs(seed, num_negatives, scale=0.5):
    rng = np.random.default_rng(seed)
    P = rng.normal(0, scale, (U, D)).astype(np.float32)
    Q = rng.normal(0, scale, (I, D)).astype(np.float32)
    Qb = rng.normal(0, scale, I).astype(np.float32)
    users = np.sort(rng.integers(0, U, NCH * N)).astype(np.int32)
    pos = rng.integers(0, I, NCH * N).astype(np.int32)
    # about one in 41 negatives is the sentinel (num_items)
    negs = rng.integers(0, I + 1, (NCH, N * num_negatives)).astype(np.int32)
    return P, Q, Qb, users.reshape(NCH, N), pos.reshape(NCH, N), negs


EPOCH_CASES = {
    "sgd_capped": dict(optimizer="sgd", max_step_norm=0.1),
    "sgd_uncapped": dict(optimizer="sgd", max_step_norm=0.0),
    "sgd_capped_two_neg": dict(optimizer="sgd", max_step_norm=0.3,
                               num_negatives=2),
    "sgd_no_bias_no_neg_side": dict(optimizer="sgd", max_step_norm=0.1,
                                    use_bias=False, update_j=False),
    "sgd_no_pos_side": dict(optimizer="sgd", max_step_norm=0.0,
                            update_i=False),
    "adagrad_pcn": dict(optimizer="adagrad", per_coordinate_normalize=True),
    "adagrad": dict(optimizer="adagrad"),
    "adam_pcn_two_neg": dict(optimizer="adam", per_coordinate_normalize=True,
                             num_negatives=2),
    "adam": dict(optimizer="adam"),
}


def _port_epoch(monkeypatch, P, Q, Qb, state, users, pos, step, negs,
                **common):
    """The port's resident epoch on one CPU shard, the negatives (nchunks,
    N * num_negatives) injected in place of K8's draws."""
    cpu = torch.device("cpu")
    monkeypatch.setattr(K, "sample_negatives",
                        lambda users, num_items, *, chunk, **_:
                        (negs[chunk], None))
    K.bpr_epoch(Mesh([cpu]), {cpu: (P, Q, Qb)}, {cpu: state}, [users], [pos],
                step, seed=0, sampling={cpu: {}}, **common)


@pytest.mark.parametrize("case", list(EPOCH_CASES))
@pytest.mark.parametrize("step", [0, 3])
def test_epoch_matches_jax_on_injected_negatives(monkeypatch, case, step):
    kw = dict(EPOCH_CASES[case])
    optimizer = kw.pop("optimizer")
    neg_per = kw.pop("num_negatives", 1)
    flags = dict(use_bias=kw.pop("use_bias", True),
                 update_i=kw.pop("update_i", True),
                 update_j=kw.pop("update_j", True))
    pcn = kw.pop("per_coordinate_normalize", False)
    cap = kw.pop("max_step_norm", 0.0)
    P, Q, Qb, users, pos, negs = _epoch_inputs(step + 7, neg_per)
    num_valid = NCH * N - 17     # a masked tail in the last chunk
    common = dict(optimizer=optimizer, num_items=I, num_negatives=neg_per,
                  per_coordinate_normalize=pcn, lr=0.5, min_lr=0.01,
                  beta1=0.9, beta2=0.999, reg_u=0.03, reg_i=0.02, reg_j=0.04,
                  reg_b=0.05, num_valid=num_valid,
                  total_samples=float(num_valid * 5), max_step_norm=cap,
                  **flags)
    if not flags["use_bias"]:
        Qb[:] = 0
    state = {} if optimizer == "sgd" else {
        k: jnp.zeros_like(v) for k, v in dict(
            mP=P, vP=P, mQ=Q, vQ=Q, mQb=Qb, vQb=Qb).items()}
    want = J.bpr_epoch(
        jnp.array(P), jnp.array(Q), jnp.array(Qb), state, jnp.array(users),
        jnp.array(pos), jnp.zeros(2048, jnp.uint32), jnp.zeros(1, jnp.float32),
        jax.random.PRNGKey(0), jnp.int32(step), jnp.zeros(2, jnp.int32),
        jnp.zeros(1, jnp.int32), jnp.array(negs), verify_neg=True,
        use_cum_table=False, bloom_log2=16, precomputed_neg=True, **common)
    tP, tQ, tQb = (torch.from_numpy(x.copy()) for x in (P, Q, Qb))
    tstate = (K.new_opt_state(tP, tQ, tQb, flags["use_bias"])
              if optimizer != "sgd" else {})
    _port_epoch(monkeypatch, tP, tQ, tQb, tstate, torch.from_numpy(users),
                torch.from_numpy(pos), step, torch.from_numpy(negs), **common)
    for got, ref, start in zip((tP, tQ, tQb), want[:3], (P, Q, Qb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        moved = np.abs(got.numpy() - start).max()
        assert moved > 1e-3 if flags["use_bias"] or got is not tQb \
            else moved == 0
    if optimizer != "sgd":
        for name, t in tstate.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(want[3][name]),
                                       **TOL)


def test_capped_and_uncapped_epochs_differ(monkeypatch):
    """The cap binds on these inputs, so the capped case above has power."""
    P, Q, Qb, users, pos, negs = _epoch_inputs(7, 1)
    out = []
    for cap in (0.1, 0.0):
        t = [torch.from_numpy(x.copy()) for x in (P, Q, Qb)]
        _port_epoch(monkeypatch, *t, {}, torch.from_numpy(users),
                    torch.from_numpy(pos), 0, torch.from_numpy(negs),
                    optimizer="sgd", num_items=I, num_negatives=1,
                    use_bias=True, update_i=True, update_j=True,
                    per_coordinate_normalize=False, lr=0.5, min_lr=0.01,
                    beta1=0.9, beta2=0.999, reg_u=0.03, reg_i=0.02,
                    reg_j=0.04, reg_b=0.05, num_valid=NCH * N,
                    total_samples=float(NCH * N), max_step_norm=cap)
        out.append(t)
    assert float((out[0][1] - out[1][1]).abs().max()) > 0.1


def _stream_inputs(seed, neg_per):
    P, Q, Qb, users, pos, _ = _epoch_inputs(seed, neg_per, scale=0.3)
    indptr, keys = _toy_csr(num_users=U, num_items=I, seed=seed)
    words, log2 = J.build_bloom(indptr, keys)
    key = jax.random.PRNGKey(seed)
    u, p = users.reshape(-1)[:N], pos.reshape(-1)[:N]
    negs = np.array(J.sample_verified_negatives(
        key, jnp.repeat(jnp.asarray(u), neg_per), I, None,
        jnp.asarray(words), log2, True))
    return P, Q, Qb, u, p, negs, (words, log2, key)


@pytest.mark.parametrize("cap", [0.0, 0.1])
@pytest.mark.parametrize("neg_per", [1, 2])
def test_streaming_sgd_step_matches_jax(cap, neg_per):
    P, Q, Qb, u, p, negs, (words, log2, key) = _stream_inputs(2, neg_per)
    flags = dict(num_negatives=neg_per, use_bias=True, update_i=True,
                 update_j=True)
    regs = dict(reg_u=0.03, reg_i=0.02, reg_j=0.04, reg_b=0.05)
    want = J.bpr_sgd_step(
        jnp.array(P), jnp.array(Q), jnp.array(Qb), jnp.asarray(u),
        jnp.asarray(p), jnp.asarray(words), jnp.zeros(1, jnp.float32), key,
        jnp.float32(0.3), num_items=I, verify_neg=True, use_cum_table=False,
        bloom_log2=log2, max_step_norm=cap, **flags, **regs)
    t = [torch.from_numpy(x.copy()) for x in (P, Q, Qb)]
    K.bpr_sgd_step(*t, torch.from_numpy(u), torch.from_numpy(p),
                   torch.from_numpy(negs), 0.3, max_step_norm=cap, **flags,
                   **regs)
    for got, ref in zip(t, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("optimizer", ["adagrad", "adam"])
@pytest.mark.parametrize("pcn", [False, True])
def test_streaming_accumulate_and_barrier_match_jax(optimizer, pcn):
    P, Q, Qb, u, p, negs, (words, log2, key) = _stream_inputs(3, 2)
    flags = dict(num_negatives=2, use_bias=True, update_i=True,
                 update_j=True)
    zeros = [jnp.zeros_like(jnp.array(x)) for x in (P, Q, Qb)]
    acc = J.bpr_accumulate_step(
        jnp.array(P), jnp.array(Q), jnp.array(Qb), *zeros,
        jnp.zeros(U, jnp.float32), jnp.zeros(I, jnp.float32), jnp.asarray(u),
        jnp.asarray(p), jnp.asarray(words), jnp.zeros(1, jnp.float32), key,
        num_items=I, verify_neg=True, use_cum_table=False, bloom_log2=log2,
        per_coordinate_normalize=pcn, **flags)
    t = [torch.from_numpy(x.copy()) for x in (P, Q, Qb)]
    grads = K.new_accumulators(*t)
    K.bpr_accumulate_step(*t, *grads, torch.from_numpy(u),
                          torch.from_numpy(p), torch.from_numpy(negs),
                          per_coordinate_normalize=pcn, **flags)
    for got, ref in zip(grads, acc):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # the barrier on P (step 2, so adam's bias corrections are not 1 - b)
    hp = dict(optimizer=optimizer, lr=0.05, beta1=0.9, beta2=0.999, reg=0.03,
              per_coordinate_normalize=pcn)
    m, v = np.full_like(P, 0.01), np.full_like(P, 0.02)
    want = J.apply_deferred_update(
        jnp.array(P), acc[0], jnp.array(m), jnp.array(v), acc[3], 2, **hp)
    tm, tv = torch.from_numpy(m.copy()), torch.from_numpy(v.copy())
    K.apply_deferred_update(t[0], grads[0], tm, tv, grads[3], 2, **hp)
    for got, ref in zip((t[0], grads[0], tm, tv), want):
        if optimizer == "adagrad" and got is tm:
            continue
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("use_bias", [False, True])
def test_triplet_loss_matches_jax(use_bias):
    P, Q, Qb, users, pos, _ = _epoch_inputs(5, 1)
    negs = np.random.default_rng(5).integers(0, I, N).astype(np.int32)
    u, p = users.reshape(-1)[:N], pos.reshape(-1)[:N]
    want = J.bpr_loss(jnp.array(P), jnp.array(Q), jnp.array(Qb),
                      jnp.asarray(u), jnp.asarray(p), jnp.asarray(negs),
                      use_bias=use_bias)
    got = K.bpr_loss(*(torch.from_numpy(x) for x in (P, Q, Qb, u, p, negs)),
                     use_bias=use_bias)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ------------------------------------------- K9's edge shapes, one step
def _jax_step(monkeypatch, fn, negs, *args, **kw):
    """A JAX step (``bpr_sgd_step`` / ``bpr_accumulate_step``) on injected
    negatives: its sampler replaced, the step run unjitted so that the
    replacement is the one it calls."""
    monkeypatch.setattr(J, "sample_verified_negatives",
                        lambda *a, **k: jnp.asarray(negs))
    return fn.__wrapped__(*args, **kw)


def _edge_chunk(seed, n=300, d=8, neg_per=1, hot_user=0, hot_item=False,
                sentinels=False, shuffled=False, scale=0.3, users=60,
                items=40):
    """Tables and one chunk of n slots, users ascending (CSR order) unless
    ``shuffled``; ``hot_user`` slots of one user (user 3) in the middle,
    70% of the positives on item 7 with ``hot_item``, every negative the
    sentinel (num_items) with ``sentinels``, else about one in 41."""
    rng = np.random.default_rng(seed)
    P = rng.normal(0, scale, (users, d)).astype(np.float32)
    Q = rng.normal(0, scale, (items, d)).astype(np.float32)
    Qb = rng.normal(0, scale, items).astype(np.float32)
    u = np.sort(rng.integers(0, users, n)).astype(np.int32)
    if hot_user:
        lo = (n - hot_user) // 2
        u[lo:lo + hot_user] = 3
        u = np.sort(u)
    if shuffled:
        u = rng.permutation(u)
    p = rng.integers(0, items, n).astype(np.int32)
    if hot_item:
        p[rng.random(n) < 0.7] = 7
    negs = rng.integers(0, items + 1, n * neg_per).astype(np.int32)
    if sentinels:
        negs[:] = items
    return P, Q, Qb, u, p, negs


# the redesigned K9's edges: a user row past one warp's sort (33 slots),
# past a warp's buffer (300) and past one bitmap window (65,600); a hot
# item; only sentinel negatives; one and three negatives per slot; widths
# 13, 100 and 300 (past one warp's 256 columns); users in no order
EDGE_CHUNKS = {
    "hot_user_33": dict(hot_user=33),
    "hot_user_300": dict(n=400, hot_user=300),
    "hot_user_65600": dict(n=65_700, hot_user=65_600, d=4, scale=0.05),
    "hot_item": dict(n=2000, hot_item=True),
    "all_sentinels": dict(sentinels=True),
    "neg_per_1": dict(neg_per=1),
    "neg_per_3": dict(neg_per=3),
    "width_13": dict(d=13),
    "width_100": dict(d=100, scale=0.15),
    "width_300": dict(d=300, scale=0.08),
    "users_unsorted": dict(shuffled=True, hot_item=True),
}


@pytest.mark.parametrize("mode", ["sgd", "accumulate"])
@pytest.mark.parametrize("edge", list(EDGE_CHUNKS))
def test_step_edge_shapes_match_jax(monkeypatch, edge, mode):
    """K9's plain versions against ``bpr_sgd_step`` (row cap 0.1) and
    ``bpr_accumulate_step`` (per-coordinate counts) on the redesigned
    kernel's edge shapes, the JAX step's negatives injected: tables and
    accumulators within 1e-5."""
    opts = EDGE_CHUNKS[edge]
    neg_per = opts.get("neg_per", 1)
    P, Q, Qb, u, p, negs = _edge_chunk(11, **opts)
    nu, ni = P.shape[0], Q.shape[0]
    flags = dict(num_negatives=neg_per, use_bias=True, update_i=True,
                 update_j=True)
    common = dict(num_items=ni, verify_neg=True, use_cum_table=False,
                  bloom_log2=5, **flags)
    jargs = (jnp.asarray(u), jnp.asarray(p), jnp.zeros(1, jnp.uint32),
             jnp.zeros(1, jnp.float32), jax.random.PRNGKey(0))
    t = [torch.from_numpy(x.copy()) for x in (P, Q, Qb)]
    tu, tp, tn = (torch.from_numpy(x) for x in (u, p, negs))
    if mode == "sgd":
        regs = dict(reg_u=0.03, reg_i=0.02, reg_j=0.04, reg_b=0.05)
        want = _jax_step(monkeypatch, J.bpr_sgd_step, negs, jnp.array(P),
                         jnp.array(Q), jnp.array(Qb), *jargs,
                         jnp.float32(0.3), max_step_norm=0.1, **regs,
                         **common)
        K.chunk_update_plain(*t, tu, tp, tn, n_valid=len(u), lr=0.3,
                             max_step_norm=0.1, **regs, **flags)
        got = t
    else:
        zeros = [jnp.zeros_like(jnp.array(x)) for x in (P, Q, Qb)]
        want = _jax_step(monkeypatch, J.bpr_accumulate_step, negs,
                         jnp.array(P), jnp.array(Q), jnp.array(Qb), *zeros,
                         jnp.zeros(nu, jnp.float32),
                         jnp.zeros(ni, jnp.float32), *jargs,
                         per_coordinate_normalize=True, **common)
        got = K.new_accumulators(*t)
        K.chunk_accumulate_plain(*t, *got, tu, tp, tn, n_valid=len(u),
                                 per_coordinate_normalize=True, **flags)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    if edge == "all_sentinels" and mode == "accumulate":
        assert float(got[4].sum()) == len(u)   # the positives alone counted


@pytest.mark.parametrize("mode", ["sgd", "accumulate"])
def test_step_with_no_real_slot_moves_nothing(monkeypatch, mode):
    """n_valid = 0: K9's plain versions leave the tables and accumulators
    as they were, as the JAX step does on a chunk of no slots."""
    P, Q, Qb, u, p, negs = _edge_chunk(12)
    flags = dict(num_negatives=1, use_bias=True, update_i=True,
                 update_j=True)
    common = dict(num_items=Q.shape[0], verify_neg=True,
                  use_cum_table=False, bloom_log2=5, **flags)
    empty = np.zeros(0, np.int32)
    jargs = (jnp.asarray(empty), jnp.asarray(empty), jnp.zeros(1, jnp.uint32),
             jnp.zeros(1, jnp.float32), jax.random.PRNGKey(0))
    t = [torch.from_numpy(x.copy()) for x in (P, Q, Qb)]
    tu, tp, tn = (torch.from_numpy(x) for x in (u, p, negs))
    if mode == "sgd":
        regs = dict(reg_u=0.03, reg_i=0.02, reg_j=0.04, reg_b=0.05)
        want = _jax_step(monkeypatch, J.bpr_sgd_step, empty, jnp.array(P),
                         jnp.array(Q), jnp.array(Qb), *jargs,
                         jnp.float32(0.3), max_step_norm=0.1, **regs,
                         **common)
        K.chunk_update_plain(*t, tu, tp, tn, n_valid=0, lr=0.3,
                             max_step_norm=0.1, **regs, **flags)
        got = t
    else:
        zeros = [jnp.zeros_like(jnp.array(x)) for x in (P, Q, Qb)]
        want = _jax_step(monkeypatch, J.bpr_accumulate_step, empty,
                         jnp.array(P), jnp.array(Q), jnp.array(Qb), *zeros,
                         jnp.zeros(P.shape[0], jnp.float32),
                         jnp.zeros(Q.shape[0], jnp.float32), *jargs,
                         per_coordinate_normalize=True, **common)
        got = K.new_accumulators(*t)
        K.chunk_accumulate_plain(*t, *got, tu, tp, tn, n_valid=0,
                                 per_coordinate_normalize=True, **flags)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("edge", ["hot_user_300", "hot_item", "neg_per_3",
                                  "width_300"])
def test_delta_from_zero_is_the_uncapped_step(monkeypatch, edge):
    """K9's delta path from zero deltas (both launches: the negative side's
    bias from Qb after the positive side's) equals ``bpr_sgd_step`` with
    no row cap less the tables, within 1e-5."""
    opts = EDGE_CHUNKS[edge]
    neg_per = opts.get("neg_per", 1)
    P, Q, Qb, u, p, negs = _edge_chunk(13, **opts)
    flags = dict(num_negatives=neg_per, use_bias=True, update_i=True,
                 update_j=True)
    regs = dict(reg_u=0.03, reg_i=0.02, reg_j=0.04, reg_b=0.05)
    want = _jax_step(
        monkeypatch, J.bpr_sgd_step, negs, jnp.array(P), jnp.array(Q),
        jnp.array(Qb), jnp.asarray(u), jnp.asarray(p),
        jnp.zeros(1, jnp.uint32), jnp.zeros(1, jnp.float32),
        jax.random.PRNGKey(0), jnp.float32(0.3), num_items=Q.shape[0],
        verify_neg=True, use_cum_table=False, bloom_log2=5,
        max_step_norm=0.0, **regs, **flags)
    t = [torch.from_numpy(x) for x in (P, Q, Qb)]
    dl = [torch.zeros_like(x) for x in t]
    h = K.chunk_delta_plain(*t, *dl, *(torch.from_numpy(x) for x in
                                       (u, p, negs)),
                            n_valid=len(u), lr=0.3, **regs, **flags)
    dneg = torch.zeros_like(t[2])
    K.chunk_bias_neg_delta_plain(h, t[2] + dl[2], dneg, lr=0.3,
                                 reg_b=regs["reg_b"])
    for g, w, x in zip((dl[0], dl[1], dl[2] + dneg), want, (P, Q, Qb)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w) - x, **TOL)
