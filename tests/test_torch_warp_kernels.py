"""The port's WARP chunk kernels (plain versions of K11, K12 and K10's
projection mode) against ``buffalo_tpu.ops.warp_kernels`` on the CPU.

The JAX package draws each chunk's (N, K) candidates inside its jitted
programs with ``jax.random.randint``; the tests recompute the same draws
from the same keys and pass them to the port (``candidates=``), so both
sides select among the same candidates.  The bloom filter's bytes are the
same in both packages.  Negatives, trials, counts and ``found_frac`` are
compared for equality; gradients and one epoch's factors within 1e-5
relative (float32 sums in another order: the JAX package's scatter-adds
against the port's ``index_add_``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import buffalo_tpu.ops.sgd_kernels as JS
import buffalo_tpu.ops.warp_kernels as JW
import buffalo_tpu_torch.ops.sgd_kernels as S
import buffalo_tpu_torch.ops.warp_kernels as W
from buffalo_tpu_torch.parallelism import Mesh

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions' many small ops run fastest on one thread, and
    then do not contend with other test processes' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed, U=40, I=30, d=8, N=64, nchunks=1, scale=0.6):
    """Random tables (scaled so that some margins pass the threshold), a
    random CSR of positives, its bloom filter, and chunks of positives."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, 10, U)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    keys = np.concatenate([np.sort(rng.choice(I, k, replace=False))
                           for k in deg]).astype(np.int32)
    words, log2 = S.build_bloom(indptr, keys)
    P = (scale * rng.standard_normal((U, d))).astype(np.float32)
    Q = (scale * rng.standard_normal((I, d))).astype(np.float32)
    users = rng.integers(0, U, (nchunks, N)).astype(np.int32)
    pos = rng.integers(0, I, (nchunks, N)).astype(np.int32)
    return dict(indptr=indptr, keys=keys, words=words, log2=log2, P=P, Q=Q,
                users=users, pos=pos, U=U, I=I)


def _cands(key, N, K, I):
    return np.array(jax.random.randint(key, (N, K), 0, I, dtype=jnp.int32))


def _jax_choice(pb, users, pos, cand, probe, score_func, threshold):
    """The JAX package's (any_v, negative, trial) of one chunk, from its
    own functions (``warp_accumulate_step`` :110-146)."""
    P, Q = jnp.asarray(pb["P"]), jnp.asarray(pb["Q"])
    u, c = jnp.asarray(users), jnp.asarray(cand)
    p = P[u]
    ui = JW._scores(p, Q[jnp.asarray(pos)], score_func)
    uj = JW._scores(p[:, None, :], Q[c], score_func)
    bloom = jnp.asarray(pb["words"])

    def seen_of(col):
        return JS.bloom_contains(bloom, pb["log2"], u, col)

    if probe == "lazy":
        any_v, f, trial = JW._select_violator_lazy(c, seen_of, ui, uj,
                                                   threshold)
    else:
        seen = jax.vmap(seen_of, in_axes=1, out_axes=1)(c)
        violating = (~seen) & ((ui[:, None] - uj) < threshold)
        any_v = jnp.any(violating, axis=1)
        f = jnp.argmax(violating, axis=1)
        tried = jnp.cumsum((~seen).astype(jnp.int32), axis=1)
        trial = jnp.maximum(
            2 * jnp.take_along_axis(tried, f[:, None], axis=1)[:, 0], 1)
    neg = jnp.take_along_axis(c, f[:, None], axis=1)[:, 0]
    return np.asarray(any_v), np.asarray(neg), np.asarray(trial)


CASES = {
    "dot_lazy": dict(score_func="dot", probe="lazy"),
    "dot_all": dict(score_func="dot", probe="all"),
    "l2_lazy": dict(score_func="l2", probe="lazy"),
    "l2_all": dict(score_func="l2", probe="all"),
    "dot_lazy_no_i": dict(score_func="dot", probe="lazy", update_i=False),
    "l2_all_no_j": dict(score_func="l2", probe="all", update_j=False),
    "dot_lazy_pcn": dict(score_func="dot", probe="lazy",
                         per_coordinate_normalize=True),
    "l2_lazy_pcn_reg": dict(score_func="l2", probe="lazy",
                            per_coordinate_normalize=True, reg_u=0.05,
                            reg_i=0.03, reg_j=0.02),
}


# every case at K = 3, 16, 40, and the packing edges of K11's lanes per
# slot (1, 8, 16 | 17, 32 | 33, 64) on two cases: each K compiles a JAX step
STEP_CASES = ([(case, K) for K in (3, 16, 40) for case in CASES]
              + [(case, K) for K in (1, 8, 17, 32, 33, 64)
                 for case in ("dot_lazy", "l2_all")])


@pytest.mark.parametrize("case,K", STEP_CASES)
def test_step_matches_jax_on_injected_candidates(case, K):
    """K11 + K12 (plain) against ``warp_accumulate_step``: the same
    negatives, trials and counts, gradients within 1e-5."""
    kw = dict(dict(update_i=True, update_j=True, reg_u=0.0, reg_i=0.0,
                   reg_j=0.0, per_coordinate_normalize=False), **CASES[case])
    pb = _problem(K)
    users, pos = pb["users"][0], pb["pos"][0]
    N, I = users.shape[0], pb["I"]
    key = jax.random.PRNGKey(K + 1)
    cand = _cands(key, N, K, I)
    threshold = 0.5
    any_j, neg_j, trial_j = _jax_choice(pb, users, pos, cand, kw["probe"],
                                        kw["score_func"], threshold)
    zeros = [jnp.zeros_like(jnp.asarray(pb["P"])),
             jnp.zeros_like(jnp.asarray(pb["Q"])),
             jnp.zeros(pb["U"], jnp.float32), jnp.zeros(I, jnp.float32)]
    gP, gQ, cP, cQ = JW.warp_accumulate_step(
        jnp.asarray(pb["P"]), jnp.asarray(pb["Q"]), *zeros,
        jnp.asarray(users), jnp.asarray(pos), jnp.asarray(pb["indptr"]),
        jnp.asarray(pb["words"]), key, num_items=I, num_candidates=K,
        threshold=threshold, bloom_log2=pb["log2"], **kw)

    tP, tQ = torch.from_numpy(pb["P"]), torch.from_numpy(pb["Q"])
    acc = W.new_accumulators(tP, tQ)
    counts = torch.zeros(1, dtype=torch.int32)
    tu, tp = torch.from_numpy(users), torch.from_numpy(pos)
    neg, w, any_v, trial = W.warp_search(
        tu, tp, tP, tQ, num_items=I, num_candidates=K, seed=0, epoch=0,
        chunk=0, n_valid=N, score_func=kw["score_func"], threshold=threshold,
        probe=kw["probe"], indptr=torch.from_numpy(pb["indptr"]),
        bloom=torch.from_numpy(pb["words"].view(np.int32)),
        bloom_log2=pb["log2"], candidates=torch.from_numpy(cand),
        counts=counts)
    np.testing.assert_array_equal(any_v.numpy(), any_j)
    np.testing.assert_array_equal(neg.numpy(), neg_j)
    np.testing.assert_array_equal(trial.numpy(), trial_j)
    assert int(counts[0]) == int(any_j.sum())
    assert int(any_j.sum()) > 0
    W.warp_accumulate(tP, tQ, *acc, tu, tp, neg, any_v, w, n_valid=N,
                      score_func=kw["score_func"], reg_u=kw["reg_u"],
                      reg_i=kw["reg_i"], reg_j=kw["reg_j"],
                      update_i=kw["update_i"], update_j=kw["update_j"],
                      per_coordinate_normalize=kw[
                          "per_coordinate_normalize"])
    np.testing.assert_allclose(acc[0].numpy(), np.asarray(gP), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(acc[1].numpy(), np.asarray(gQ), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(acc[2].numpy(), np.asarray(cP))
    np.testing.assert_array_equal(acc[3].numpy(), np.asarray(cQ))


def _hot(pb, seed):
    """The chunks' users all one user and 70% of their positives one item
    (rows far longer than a warp's in-register sort on both sides)."""
    rng = np.random.default_rng(seed)
    pb = dict(pb)
    pb["users"] = np.full_like(pb["users"], 3)
    pos = pb["pos"].copy()
    pos[rng.random(pos.shape) < 0.7] = 7
    pb["pos"] = pos
    return pb


# edge shapes of K12's plain version against the JAX body: a hot user and
# item row, no slot violating (nothing added), widths 13 and 100
EDGE_STEPS = {
    "hot_row": dict(),
    "all_dead": dict(threshold=-1e30),
    "width13": dict(d=13),
    "width100": dict(d=100, scale=0.15),
}


@pytest.mark.parametrize("score_func", ["dot", "l2"])
@pytest.mark.parametrize("edge", list(EDGE_STEPS))
def test_step_edge_shapes_match_jax(edge, score_func):
    """K11 + K12 (plain) against ``warp_accumulate_step`` on K12's edge
    shapes, with the reg terms and the per-coordinate counts: the same
    negatives and counts, gradients within 1e-5."""
    opts = dict(EDGE_STEPS[edge])
    threshold = opts.pop("threshold", 0.5)
    pb = _problem(21, N=256, **opts)
    if edge == "hot_row":
        pb = _hot(pb, 21)
    users, pos = pb["users"][0], pb["pos"][0]
    N, I, K = users.shape[0], pb["I"], 16
    key = jax.random.PRNGKey(5)
    cand = _cands(key, N, K, I)
    kw = dict(update_i=True, update_j=True, reg_u=0.05, reg_i=0.03,
              reg_j=0.02, per_coordinate_normalize=True,
              score_func=score_func, probe="lazy")
    zeros = [jnp.zeros_like(jnp.asarray(pb["P"])),
             jnp.zeros_like(jnp.asarray(pb["Q"])),
             jnp.zeros(pb["U"], jnp.float32), jnp.zeros(I, jnp.float32)]
    want = JW.warp_accumulate_step(
        jnp.asarray(pb["P"]), jnp.asarray(pb["Q"]), *zeros,
        jnp.asarray(users), jnp.asarray(pos), jnp.asarray(pb["indptr"]),
        jnp.asarray(pb["words"]), key, num_items=I, num_candidates=K,
        threshold=threshold, bloom_log2=pb["log2"], **kw)
    tP, tQ = torch.from_numpy(pb["P"]), torch.from_numpy(pb["Q"])
    acc = W.new_accumulators(tP, tQ)
    W.warp_accumulate_step(
        tP, tQ, *acc, torch.from_numpy(users), torch.from_numpy(pos),
        torch.from_numpy(pb["indptr"]),
        torch.from_numpy(pb["words"].view(np.int32)), seed=0, epoch=0,
        chunk=0, num_items=I, num_candidates=K, threshold=threshold,
        bloom_log2=pb["log2"], candidates=torch.from_numpy(cand), **kw)
    for got, ref in zip(acc[:2], want[:2]):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)
    for got, ref in zip(acc[2:], want[2:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    found = int(acc[2].sum())
    if edge == "all_dead":
        assert found == 0 and not acc[0].any() and not acc[1].any()
    else:
        assert found > 0
    if edge == "hot_row":
        assert int(acc[2][3]) == found and int(acc[3][7]) > 32


# the resident epoch's n_valid at 0, inside the first chunk, and on a hot
# row / a width of 100 with the last chunk part padding
EDGE_EPOCHS = {
    "n_valid_0": dict(num_valid=0),
    "n_valid_in_chunk_0": dict(num_valid=9),
    "hot_row": dict(hot=True),
    "width100": dict(d=100, scale=0.3),
}


@pytest.mark.parametrize("edge", list(EDGE_EPOCHS))
def test_epoch_edge_shapes_match_jax(edge):
    """One ``warp_epoch`` on K12's edge shapes (adagrad, per-coordinate
    counts): factors within 1e-5, found_frac equal."""
    opts = dict(EDGE_EPOCHS[edge])
    nv = opts.pop("num_valid", 3 * 64 - 17)
    hot = opts.pop("hot", False)
    pb = _problem(22, nchunks=3, **dict(dict(scale=1.2), **opts))
    if hot:
        pb = _hot(pb, 22)
    key = jax.random.PRNGKey(11)
    Pj, Qj, fj = _jax_epoch(pb, 8, "lazy", "adagrad", True, key, step=1,
                            num_valid=nv)
    Pp, Qp, fp = _port_epoch(pb, 8, "lazy", "adagrad", True, key, step=1,
                             num_valid=nv)
    np.testing.assert_allclose(Pp, Pj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(Qp, Qj, rtol=RTOL, atol=ATOL)
    assert fp == fj
    if nv == 0:
        assert fp == 0.0


def _jax_epoch(pb, K, probe, optimizer, pcn, key, step=0, num_valid=None,
               seen_bits=None):
    st = {n: jnp.zeros_like(jnp.asarray(pb["P" if n[1] == "P" else "Q"]))
          for n in ("mP", "vP", "mQ", "vQ")}
    nchunks, N = pb["users"].shape
    out = JW.warp_epoch(
        jnp.asarray(pb["P"]), jnp.asarray(pb["Q"]), st,
        jnp.asarray(pb["users"]), jnp.asarray(pb["pos"]),
        jnp.asarray(pb["indptr"]), jnp.asarray(pb["words"]), key,
        jnp.int32(step), seen_bits, precomputed_probe=seen_bits is not None,
        probe=probe, optimizer=optimizer, num_items=pb["I"],
        num_candidates=K, score_func="dot", threshold=1.0, reg_u=0.01,
        reg_i=0.02, reg_j=0.03, update_i=True, update_j=True,
        per_coordinate_normalize=pcn, lr=0.05, beta1=0.9, beta2=0.999,
        num_valid=nchunks * N if num_valid is None else num_valid,
        bloom_log2=pb["log2"])
    return np.asarray(out[0]), np.asarray(out[1]), float(out[3])


def _port_epoch(pb, K, probe, optimizer, pcn, key, step=0, num_valid=None,
                split=False):
    nchunks, N = pb["users"].shape
    cands = torch.from_numpy(np.stack([
        _cands(jax.random.fold_in(key, c), N, K, pb["I"])
        for c in range(nchunks)]))
    tP, tQ = torch.from_numpy(pb["P"].copy()), torch.from_numpy(pb["Q"].copy())
    users = torch.from_numpy(pb["users"])
    bloom = torch.from_numpy(pb["words"].view(np.int32))
    seen_bits = None
    if split:
        seen_bits = torch.stack([W.warp_probe(
            users[c], num_items=pb["I"], num_candidates=K, seed=0, epoch=step,
            chunk=c, bloom=bloom, bloom_log2=pb["log2"],
            candidates=cands[c]) for c in range(nchunks)])
    cpu = torch.device("cpu")
    ff = W.warp_epoch(
        Mesh([cpu]), {cpu: (tP, tQ)}, {cpu: W.new_opt_state(tP, tQ)}, [users],
        [torch.from_numpy(pb["pos"])], step, seed=0,
        indptr={cpu: torch.from_numpy(pb["indptr"])}, bloom={cpu: bloom},
        optimizer=optimizer, num_items=pb["I"], num_candidates=K,
        score_func="dot", threshold=1.0, reg_u=0.01, reg_i=0.02, reg_j=0.03,
        update_i=True, update_j=True, per_coordinate_normalize=pcn, lr=0.05,
        beta1=0.9, beta2=0.999,
        num_valid=nchunks * N if num_valid is None else num_valid,
        bloom_log2=pb["log2"], probe=probe,
        seen_bits=None if seen_bits is None else [seen_bits],
        candidates=[cands])
    return tP.numpy(), tQ.numpy(), ff


@pytest.mark.parametrize("optimizer,pcn,probe,split", [
    ("adagrad", False, "lazy", False), ("adam", True, "lazy", False),
    ("adagrad", True, "all", True), ("adam", False, "all", False)])
def test_epoch_matches_jax(optimizer, pcn, probe, split):
    """One ``warp_epoch`` (three chunks, the last part padding, K = 4 so
    that some positives find no violator; the deferred step, then the
    unit-ball projection): factors within 1e-5, found_frac equal."""
    pb = _problem(3, nchunks=3, scale=1.2)
    key = jax.random.PRNGKey(9)
    nv = 3 * 64 - 17
    seen = None
    if split:
        seen = JW.warp_probe_epoch(
            jnp.asarray(pb["users"]), jnp.asarray(pb["words"]), key,
            num_items=pb["I"], num_candidates=4, bloom_log2=pb["log2"])
    Pj, Qj, fj = _jax_epoch(pb, 4, probe, optimizer, pcn, key, step=2,
                            num_valid=nv, seen_bits=seen)
    Pp, Qp, fp = _port_epoch(pb, 4, probe, optimizer, pcn, key, step=2,
                             num_valid=nv, split=split)
    np.testing.assert_allclose(Pp, Pj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(Qp, Qj, rtol=RTOL, atol=ATOL)
    assert fp == fj and 0 < fp < 1
    assert np.linalg.norm(Pp, axis=1).max() <= 1 + 1e-6


def test_lazy_and_all_identical_when_nothing_is_seen():
    """With an all-zero bloom filter the lazy rule's choices and trials are
    the all rule's (``tests/models/test_warp.py:61``)."""
    pb = _problem(4, nchunks=2)
    pb["words"] = np.zeros_like(pb["words"])
    key = jax.random.PRNGKey(3)
    lazy = _port_epoch(pb, 8, "lazy", "adagrad", False, key)
    full = _port_epoch(pb, 8, "all", "adagrad", False, key)
    np.testing.assert_array_equal(lazy[0], full[0])
    np.testing.assert_array_equal(lazy[1], full[1])


@pytest.mark.parametrize("K", [5, 32, 64])
def test_probe_bits_match_jax(K):
    pb = _problem(5, nchunks=2)
    key = jax.random.PRNGKey(K)
    want = np.asarray(JW.warp_probe_epoch(
        jnp.asarray(pb["users"]), jnp.asarray(pb["words"]), key,
        num_items=pb["I"], num_candidates=K, bloom_log2=pb["log2"]))
    for c in range(2):
        got = W.warp_probe(
            torch.from_numpy(pb["users"][c]), num_items=pb["I"],
            num_candidates=K, seed=0, epoch=0, chunk=c,
            bloom=torch.from_numpy(pb["words"].view(np.int32)),
            bloom_log2=pb["log2"], candidates=torch.from_numpy(_cands(
                jax.random.fold_in(key, c), 64, K, pb["I"])))
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want[c])
        assert want[c].any()


def test_candidates_are_k8s_philox():
    """Candidate j of slot s is mulhi(x0, I) of Philox4x32-10 at the counter
    (s, chunk, epoch, j), the generator whose known answers K8's tests hold
    (``test_torch_sgd_kernels.py::test_philox_known_answers``); the first
    draws do not depend on K."""
    c16 = W.warp_candidates(50, 16, 1000, seed=7, epoch=2, chunk=3,
                            device="cpu")
    c64 = W.warp_candidates(50, 64, 1000, seed=7, epoch=2, chunk=3,
                            device="cpu")
    assert torch.equal(c64[:, :16], c16)
    s, j = 41, 13
    x0 = S.philox4x32((torch.tensor([s]), 3, 2, j), S._seed_key(7))[0]
    assert int(c64[s, j]) == (int(x0) * 1000) >> 32
    got = S.philox4x32((torch.tensor([0]), 0, 0, 0), (0, 0))
    assert [int(x) for x in got] == [0x6627e8d5, 0xe169c58d, 0xbc57ac4c,
                                     0x9b00dbd8]
    assert 0 <= int(c64.min()) and int(c64.max()) < 1000


@pytest.mark.parametrize("score_func", ["dot", "l2"])
def test_violation_rate_matches_jax(score_func):
    pb = _problem(6)
    rng = np.random.default_rng(0)
    trip = [rng.integers(0, n, 37).astype(np.int32)
            for n in (pb["U"], pb["I"], pb["I"])]
    want = float(JW.warp_loss(jnp.asarray(pb["P"]), jnp.asarray(pb["Q"]),
                              *map(jnp.asarray, trip), score_func=score_func,
                              threshold=0.5))
    got = float(W.warp_loss(torch.from_numpy(pb["P"]),
                            torch.from_numpy(pb["Q"]),
                            *map(torch.from_numpy, trip),
                            score_func=score_func, threshold=0.5))
    # the same count of violations; XLA's mean may round its division
    # another way (1 ulp)
    assert abs(got - want) <= 1e-6 * want and 0 < got < 1
    assert abs(got * 37 - round(got * 37)) < 1e-4


def test_projection_mode_matches_jax():
    """K10 with the projection (plain): the adagrad step then
    ``project_unit_ball``."""
    rng = np.random.default_rng(1)
    X = (2 * rng.standard_normal((30, 6))).astype(np.float32)
    g = rng.standard_normal((30, 6)).astype(np.float32)
    v = np.abs(rng.standard_normal((30, 6))).astype(np.float32)
    delta, v2 = JS.adagrad_update(jnp.asarray(g) - 2 * 0.1 * jnp.asarray(X),
                                  jnp.asarray(v), 0.05)
    want = np.asarray(JW.project_unit_ball(jnp.asarray(X) + delta))
    t = [torch.from_numpy(a.copy()) for a in (X, g, v)]
    S.deferred_update(t[0], t[1], None, t[2], None, step=0,
                      optimizer="adagrad", lr=0.05, beta1=0.9, beta2=0.999,
                      reg=0.1, per_coordinate_normalize=False, project=True)
    np.testing.assert_allclose(t[0].numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t[2].numpy(), np.asarray(v2), rtol=1e-6)
    assert np.linalg.norm(want, axis=1).min() < 1 < np.linalg.norm(
        X, axis=1).max()
    assert np.all(t[1].numpy() == 0)


def test_found_fraction_rounds_as_float32_carries():
    """Past 2^24 samples the float32 totals round: 2^24 found then 1 more
    stays 2^24, as the JAX scan's carry does."""
    found, possible = W.found_totals([1 << 24, 1], [1 << 24, 1])
    f32 = np.float32
    want = f32(f32(f32(1 << 24) + f32(1)))
    assert found == possible == want == f32(1 << 24)
    assert W.found_totals([3, 2], [4, 3]) == (f32(5), f32(7))
