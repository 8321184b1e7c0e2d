"""WARP / CML chunk kernels on one device.

PyTorch counterpart of ``buffalo_tpu.ops.warp_kernels``'s single-device
functions.  Each chunk of positives goes through two hand-written CUDA
kernels on the card (``csrc/*.cu``), each beside its plain PyTorch version
(``*_plain``):

* **K11** ``warp_search`` — per positive, the first margin-violating
  candidate negative the bloom filter does not flag (the JAX package's
  lazy rule, probing at the first four violators only, or its exact "all"
  rule), the reference's trial count and the rank weight
  ``Phi = log(max(1, (|I| - |seen| - 1) // trial))``; ``warp_probe``
  packs every candidate's seen bit (the split epoch's first pass);
  ``warp_violations`` is the violation rate over fixed triplets.
* **K12** ``warp_accumulate`` — the chunk's per-sample deltas of the dot
  or l2 score (with the per-sample reg terms) and counts, summed per row
  onto the epoch's running gradients.

The epoch barrier is K10 (``sgd_kernels.deferred_update``) in its
projection mode: adam or adagrad, then each row scaled into the unit ball.

The candidates are this port's own: a counter-based Philox4x32-10 function
of (seed, epoch, chunk, slot, candidate), K8's generator, drawn inside K11
and by ``warp_candidates`` for the plain version, bit for bit.  JAX's
threefry stream cannot be reproduced, so the tests replace
``warp_candidates`` with the JAX package's draws to compare the math, or
pass ``candidates=`` explicitly.  Scores are summed in float64 and rounded
once, in the kernel and in the plain version, so both compare the same
float32 margins.  K11 stages each slot's user row once per block (as
double for dot) and sums ui once per slot; a group of lanes (K rounded up
to a power of two, at most 16) walks a slot's candidates, so 32 / lanes
slots share a warp.  Rows of any width: K11 reads rows wider than its
shared-memory row from global memory, K12 walks them in 256-column
chunks.
``warp_epoch`` is the resident epoch over a device mesh (one device is a
mesh of one shard).

Each wrapper runs its plain version for CPU tensors and launches its
kernel (or raises) for CUDA tensors; ``launches`` on each wrapper counts
the calls that launched it.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from buffalo_tpu_torch.ops import sgd_kernels as S
from buffalo_tpu_torch.ops.als_kernels import _check, _ptr, _raise_on, _stream

# violators probed per positive under probe="lazy" (warp_kernels.py:38)
LAZY_PROBES = 4
# the adaptive schedule's start and cap (warp.py:273-275)
ADAPTIVE_START, MAX_CANDIDATES = 16, 64

_P, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_float)
# C signatures of the launch functions (csrc/warp_*.cu); each returns the
# cudaError_t of its launches
_SIGNATURES = {
    "warp_search": [_P, _P, _I32, _I32, _I32, _I32, _P, _P, _I32, _I32, _F32,
                    _I32, _P, _P, _P, _I32, _I64, _I32, _I32, _I64, _P, _P, _P,
                    _P, _P, _P, _P],
    "warp_probe": [_P, _I32, _I32, _I32, _P, _P, _I32, _I64, _I32, _I32, _P,
                   _P],
    "warp_violations": [_P, _P, _P, _I32, _P, _P, _I32, _I32, _F32, _P, _P],
    "warp_workspace": [_I32, _I32, _I32, _I32, _P],
    "warp_accumulate": [_P, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _I32,
                        _I32, _I32, _F32, _F32, _F32, _I32, _I32, _I32, _P,
                        _P, _P, _P, _P, _P, _P],
}
_LIBRARY = {"warp_search": "warp_search", "warp_probe": "warp_search",
            "warp_violations": "warp_search",
            "warp_workspace": "warp_accumulate",
            "warp_accumulate": "warp_accumulate"}


def _kernel(name: str):
    from buffalo_tpu_torch.ops._build import launcher

    return launcher(name, _SIGNATURES[name], library=_LIBRARY[name])


def _l2(score_func: str) -> bool:
    return str(score_func) == "l2"


# ---------------------------------------------------------------- plain
def warp_candidates(N, K, num_items, *, seed, epoch, chunk, device,
                    slot_offset=0):
    """(N, K) int32 candidates: candidate j of slot s is mulhi(x0,
    num_items) of the Philox words of the counter (s + slot_offset, chunk,
    epoch, j) under the seed's key, as K11 draws it; a mesh shard's
    ``slot_offset`` is its first global slot of the chunk."""
    slot = (torch.arange(N, device=device, dtype=torch.int64)
            + int(slot_offset)) & S._U32
    j = torch.arange(K, device=device, dtype=torch.int64)
    x0 = S.philox4x32((slot.repeat_interleave(K), chunk, epoch, j.repeat(N)),
                      S._seed_key(seed))[0]
    return ((x0 * num_items) >> 32).to(torch.int32).reshape(N, K)


def scores(p, q, score_func):
    """p . q (dot) or -|p - q|^2 (l2) over the last axis, summed in
    float64 and rounded once to float32 (``warp_kernels.py:30``)."""
    if _l2(score_func):
        diff = (p - q).double()
        return (-(diff * diff).sum(-1)).float()
    return (p.double() * q.double()).sum(-1).float()


def _seen(bloom, bloom_log2, users, cand):
    """Bloom flags of (users[:, None], cand), cand (N, k)."""
    u = users.long()[:, None].expand_as(cand)
    word, b1, b2 = S.bloom_hashes_plain(u, cand.long() & 0xFFFFFFFF,
                                        bloom_log2)
    w = bloom[word].long() & 0xFFFFFFFF
    return ((w >> b1) & (w >> b2) & 1) == 1


def _unpack(bits, K):
    """(N, ceil(K / 32)) int32 words -> (N, K) bool."""
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = bits.long() & 0xFFFFFFFF
    seen = ((words[:, :, None] >> shifts) & 1) == 1
    return seen.reshape(bits.shape[0], -1)[:, :K]


def warp_search_plain(users, positives, P, Q, *, num_items, num_candidates,
                      seed, epoch, chunk, n_valid, score_func, threshold,
                      probe, indptr, bloom=None, bloom_log2=0,
                      seen_bits=None, candidates=None, counts=None,
                      count_index=0, slot_offset=0):
    """Plain version of K11: the JAX package's selection
    (``_select_violator_lazy`` :41 or the all-probe rule :126-138) on
    the chunk's candidates (``candidates`` (N, K), else
    ``warp_candidates``), seen flags from ``seen_bits`` when given, else
    the bloom filter.  Returns (negatives int32, weights float32, any_v
    bool, trials int32), each (N,); ``counts[count_index]`` gains the
    valid slots with any_v."""
    N, K = users.shape[0], int(num_candidates)
    dev = users.device
    cand = (warp_candidates(N, K, num_items, seed=seed, epoch=epoch,
                            chunk=chunk, device=dev, slot_offset=slot_offset)
            if candidates is None else candidates).long()
    u = users.long()
    p = P[u]
    ui = scores(p, Q[positives.long()], score_func)
    uj = scores(p[:, None, :], Q[cand], score_func)
    viol = (ui[:, None] - uj) < threshold

    def seen_at(cols):
        if seen_bits is not None:
            return torch.gather(_unpack(seen_bits, K), 1, cols)
        return _seen(bloom, bloom_log2, users, torch.gather(cand, 1, cols))

    if probe == "lazy":
        J = min(LAZY_PROBES, K)
        rank = torch.cumsum(viol.int(), 1)
        cols = torch.stack([torch.argmax((viol & (rank == j)).int(), 1)
                            for j in range(1, J + 1)], 1)
        found = torch.stack([(viol & (rank == j)).any(1)
                             for j in range(1, J + 1)], 1)
        seen_j = seen_at(cols)
        ok = found & ~seen_j
        any_v = ok.any(1)
        jstar = torch.argmax(ok.int(), 1)
        f = torch.gather(cols, 1, jstar[:, None])[:, 0]
        before = torch.cumsum((seen_j & found).int(), 1)
        sb = torch.where(jstar > 0, torch.gather(
            before, 1, (jstar - 1).clamp(min=0)[:, None])[:, 0],
            torch.zeros_like(jstar))
        trial = torch.clamp(2 * (f + 1 - sb), min=1)
    elif probe == "all":
        seen = seen_at(torch.arange(K, device=dev).expand(N, K))
        violating = ~seen & viol
        any_v = violating.any(1)
        f = torch.argmax(violating.int(), 1)
        tried = torch.cumsum((~seen).int(), 1)
        trial = torch.clamp(2 * torch.gather(tried, 1, f[:, None])[:, 0],
                            min=1)
    else:
        raise ValueError(f"probe must be lazy|all, got {probe!r}")
    seen_size = (indptr[u + 1] - indptr[u]).int()
    avail = torch.clamp(num_items - seen_size - 1, min=0)
    phi = torch.log(torch.clamp(avail // trial, min=1).float())
    valid = any_v & (torch.arange(N, device=dev) < n_valid)
    w = torch.where(valid, phi, torch.zeros_like(phi))
    neg = torch.gather(cand, 1, f[:, None])[:, 0]
    if counts is not None:
        counts[count_index] += valid.sum().to(counts.dtype)
    return neg.to(torch.int32), w, any_v, trial.to(torch.int32)


def warp_probe_plain(users, *, num_items, num_candidates, seed, epoch, chunk,
                     bloom, bloom_log2, candidates=None):
    """Plain version of K11's probe pass (``warp_probe_epoch`` :175 for one
    chunk): every candidate's bloom flag, 32 to an int32 word (bit j % 32
    of word j // 32), padding bits 0.  (N, ceil(K / 32)) int32."""
    N, K = users.shape[0], int(num_candidates)
    cand = (warp_candidates(N, K, num_items, seed=seed, epoch=epoch,
                            chunk=chunk, device=users.device)
            if candidates is None else candidates)
    seen = _seen(bloom, bloom_log2, users, cand)
    nw = -(-K // 32)
    padded = torch.zeros((N, nw * 32), dtype=torch.int64, device=users.device)
    padded[:, :K] = seen.long()
    shifts = torch.arange(32, device=users.device, dtype=torch.int64)
    words = (padded.reshape(N, nw, 32) << shifts).sum(-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(
        torch.int32)


def warp_violations_plain(P, Q, users, positives, negatives, *, score_func,
                          threshold):
    """Plain version of K11's loss mode: the mean of (ui - uj < threshold)
    over fixed triplets (``warp_loss`` :505), a 0-d float32 tensor."""
    p = P[users.long()]
    ui = scores(p, Q[positives.long()], score_func)
    uj = scores(p, Q[negatives.long()], score_func)
    return ((ui - uj) < threshold).float().mean()


def warp_accumulate_plain(P, Q, gP, gQ, cP, cQ, users, positives, negatives,
                          any_v, weight, *, n_valid, score_func, reg_u,
                          reg_i, reg_j, update_i, update_j,
                          per_coordinate_normalize, users_sorted=False):
    """Plain version of K12, in place into the epoch's accumulators
    (``warp_kernels.py:145-170``): the deltas of the valid slots with
    any_v by ``index_add_``; ``users_sorted`` changes nothing here."""
    live = any_v & (torch.arange(users.shape[0], device=users.device)
                    < n_valid)
    u, i, j = users.long()[live], positives.long()[live], \
        negatives.long()[live]
    w = weight[live][:, None]
    p, qi, qj = P[u], Q[i], Q[j]
    if _l2(score_func):
        u_deriv = (2.0 * w) * (qi - qj)
        i_deriv = w * (p - qi)
        j_deriv = -w * (p - qj)
    else:
        u_deriv = w * (qi - qj)
        i_deriv = w * p
        j_deriv = -i_deriv
    gP.index_add_(0, u, u_deriv - reg_u * p)
    if update_i:
        gQ.index_add_(0, i, i_deriv - reg_i * qi)
    if update_j:
        gQ.index_add_(0, j, j_deriv - reg_j * qj)
    if per_coordinate_normalize:
        ones = torch.ones(u.shape[0], dtype=torch.float32, device=P.device)
        cP.index_add_(0, u, ones)
        cQ.index_add_(0, i, ones)
        cQ.index_add_(0, j, ones)


# ------------------------------------------------------------- wrappers
def _check_tables(P, Q, dev):
    _check("P", P, torch.float32, dev, 2)
    _check("Q", Q, torch.float32, dev, 2)
    if Q.shape[1] != P.shape[1]:
        raise ValueError(f"P is {P.shape[1]} wide, Q {Q.shape[1]}")
    return P.shape[1]


def warp_search(users, positives, P, Q, *, num_items, num_candidates, seed,
                epoch, chunk, n_valid, score_func, threshold, probe, indptr,
                bloom=None, bloom_log2=0, seen_bits=None, candidates=None,
                counts=None, count_index=0, slot_offset=0):
    """K11: one chunk's violator search (see ``warp_search_plain``).
    Replaces ``_select_violator_lazy`` :41 and the search of
    ``warp_accumulate_step`` :110-146 / ``warp_epoch`` :259-296
    (``buffalo_tpu/ops/warp_kernels.py``).  ``users``/``positives`` (N,)
    int32, ``indptr`` int64 (U + 1), ``bloom`` int32 words, ``seen_bits``
    (N, ceil(K / 32)) int32, ``candidates`` (N, K) int32, ``counts`` int32;
    ``slot_offset`` a mesh shard's first global slot of the chunk."""
    kw = dict(num_items=num_items, num_candidates=num_candidates, seed=seed,
              epoch=epoch, chunk=chunk, n_valid=n_valid,
              score_func=score_func, threshold=threshold, probe=probe,
              indptr=indptr, bloom=bloom, bloom_log2=bloom_log2,
              seen_bits=seen_bits, candidates=candidates, counts=counts,
              count_index=count_index, slot_offset=slot_offset)
    if users.device.type == "cpu":
        return warp_search_plain(users, positives, P, Q, **kw)
    dev = users.device
    d = _check_tables(P, Q, dev)
    N, K = users.shape[0], int(num_candidates)
    for name, t in (("users", users), ("positives", positives)):
        _check(name, t, torch.int32, dev, 1)
        if t.shape[0] != N:
            raise ValueError("users and positives disagree on the chunk")
    _check("indptr", indptr, torch.int64, dev, 1)
    if probe not in ("lazy", "all"):
        raise ValueError(f"probe must be lazy|all, got {probe!r}")
    if seen_bits is not None:
        _check("seen_bits", seen_bits, torch.int32, dev, 2)
        if tuple(seen_bits.shape) != (N, -(-K // 32)):
            raise ValueError("seen_bits must be (N, ceil(K / 32))")
    else:
        _check("bloom", bloom, torch.int32, dev, 1)
        if bloom.shape[0] != 1 << (bloom_log2 - 5):
            raise ValueError(f"bloom has {bloom.shape[0]} words for "
                             f"log2_bits {bloom_log2}")
    if candidates is not None:
        _check("candidates", candidates, torch.int32, dev, 2)
        if tuple(candidates.shape) != (N, K):
            raise ValueError("candidates must be (N, num_candidates)")
    if counts is None:
        counts = torch.zeros(1, dtype=torch.int32, device=dev)
        count_index = 0
    _check("counts", counts, torch.int32, dev, 1)
    if not 0 <= count_index < counts.shape[0]:
        raise ValueError(f"count_index {count_index} outside counts")
    if K < 1 or not 1 <= num_items < 1 << 31 or slot_offset < 0:
        raise ValueError(f"num_candidates {K}, num_items {num_items}, "
                         f"slot_offset {slot_offset}")
    neg = torch.empty(N, dtype=torch.int32, device=dev)
    w = torch.empty(N, dtype=torch.float32, device=dev)
    any_v = torch.empty(N, dtype=torch.bool, device=dev)
    trial = torch.empty(N, dtype=torch.int32, device=dev)
    rc = _kernel("warp_search")(
        _ptr(users), _ptr(positives), N, int(max(0, min(n_valid, N))), K,
        int(num_items), _ptr(P), _ptr(Q), d, int(_l2(score_func)),
        float(threshold), int(probe == "lazy"), _ptr(candidates),
        _ptr(seen_bits), _ptr(bloom if seen_bits is None else None),
        int(bloom_log2), S.philox_key(seed), int(epoch), int(chunk),
        int(slot_offset), _ptr(indptr),
        _ptr(neg), _ptr(w), _ptr(any_v), _ptr(trial),
        ctypes.c_void_p(counts.data_ptr() + 4 * int(count_index)),
        _stream(dev))
    _raise_on(rc, "warp_search")
    warp_search.launches += 1
    return neg, w, any_v, trial


warp_search.launches = 0


def warp_probe(users, *, num_items, num_candidates, seed, epoch, chunk,
               bloom, bloom_log2, candidates=None):
    """K11, probe pass: the packed seen bits of one chunk's candidates (see
    ``warp_probe_plain``); replaces ``warp_probe_epoch`` :175."""
    kw = dict(num_items=num_items, num_candidates=num_candidates, seed=seed,
              epoch=epoch, chunk=chunk, bloom=bloom, bloom_log2=bloom_log2,
              candidates=candidates)
    if users.device.type == "cpu":
        return warp_probe_plain(users, **kw)
    dev = users.device
    _check("users", users, torch.int32, dev, 1)
    _check("bloom", bloom, torch.int32, dev, 1)
    if bloom.shape[0] != 1 << (bloom_log2 - 5):
        raise ValueError(f"bloom has {bloom.shape[0]} words for log2_bits "
                         f"{bloom_log2}")
    N, K = users.shape[0], int(num_candidates)
    if candidates is not None:
        _check("candidates", candidates, torch.int32, dev, 2)
        if tuple(candidates.shape) != (N, K):
            raise ValueError("candidates must be (N, num_candidates)")
    bits = torch.empty((N, -(-K // 32)), dtype=torch.int32, device=dev)
    rc = _kernel("warp_probe")(
        _ptr(users), N, K, int(num_items), _ptr(candidates), _ptr(bloom),
        int(bloom_log2), S.philox_key(seed), int(epoch), int(chunk),
        _ptr(bits),
        _stream(dev))
    _raise_on(rc, "warp_probe")
    warp_probe.launches += 1
    return bits


warp_probe.launches = 0


def warp_violations(P, Q, users, positives, negatives, *, score_func,
                    threshold):
    """K11, loss mode: the violation rate over fixed (u, i, j) triplets, a
    0-d float32 tensor (``warp_loss`` :505)."""
    kw = dict(score_func=score_func, threshold=threshold)
    if P.device.type == "cpu":
        return warp_violations_plain(P, Q, users, positives, negatives, **kw)
    dev = P.device
    d = _check_tables(P, Q, dev)
    n = users.shape[0]
    for name, t in (("users", users), ("positives", positives),
                    ("negatives", negatives)):
        _check(name, t, torch.int32, dev, 1)
        if t.shape[0] != n:
            raise ValueError("the triplets' arrays disagree")
    out = torch.empty((), dtype=torch.float32, device=dev)
    rc = _kernel("warp_violations")(
        _ptr(users), _ptr(positives), _ptr(negatives), n, _ptr(P), _ptr(Q),
        d, int(_l2(score_func)), float(threshold), _ptr(out), _stream(dev))
    _raise_on(rc, "warp_violations")
    warp_violations.launches += 1
    return out


warp_violations.launches = 0


_WORKSPACE_SIZES = {}


def _workspace(dev, N, U, I, d):
    """K12's scratch (int32 words, float32 words), sized by the C
    interface's own ``warp_workspace`` (asked once per shape: a chunk's
    call is short, and host work per call shows in its time)."""
    key = (N, U, I, d)
    sizes = _WORKSPACE_SIZES.get(key)
    if sizes is None:
        out = (ctypes.c_int64 * 2)()
        rc = _kernel("warp_workspace")(N, U, I, d,
                                       ctypes.cast(out, ctypes.c_void_p))
        _raise_on(rc, "warp_workspace")
        sizes = _WORKSPACE_SIZES[key] = (max(1, out[0]), max(1, out[1]))
    return (torch.empty(sizes[0], dtype=torch.int32, device=dev),
            torch.empty(sizes[1], dtype=torch.float32, device=dev))


def warp_accumulate(P, Q, gP, gQ, cP, cQ, users, positives, negatives,
                    any_v, weight, *, n_valid, score_func, reg_u, reg_i,
                    reg_j, update_i, update_j, per_coordinate_normalize,
                    users_sorted=False):
    """K12: one chunk's gradients (and counts) added onto the epoch's
    accumulators (see ``warp_accumulate_plain``).  Replaces the scatters of
    ``warp_accumulate_step`` :145-170 and ``warp_epoch`` :295-317.
    ``users_sorted``: users[:n_valid] ascend (a resident chunk), so the
    user side's runs are summed where they lie, with no grouping."""
    kw = dict(n_valid=n_valid, score_func=score_func, reg_u=reg_u,
              reg_i=reg_i, reg_j=reg_j, update_i=update_i,
              update_j=update_j,
              per_coordinate_normalize=per_coordinate_normalize,
              users_sorted=users_sorted)
    if P.device.type == "cpu":
        return warp_accumulate_plain(P, Q, gP, gQ, cP, cQ, users, positives,
                                     negatives, any_v, weight, **kw)
    dev = P.device
    d = _check_tables(P, Q, dev)
    N = users.shape[0]
    for name, t in (("users", users), ("positives", positives),
                    ("negatives", negatives)):
        _check(name, t, torch.int32, dev, 1)
        if t.shape[0] != N:
            raise ValueError("the chunk's arrays disagree")
    _check("any_v", any_v, torch.bool, dev, 1)
    _check("weight", weight, torch.float32, dev, 1)
    for name, t, like in (("gP", gP, P), ("gQ", gQ, Q)):
        _check(name, t, torch.float32, dev, 2)
        if t.shape != like.shape:
            raise ValueError(f"{name} must have the shape of its table")
    if per_coordinate_normalize:
        for name, t, n in (("cP", cP, P.shape[0]), ("cQ", cQ, Q.shape[0])):
            _check(name, t, torch.float32, dev, 1)
            if t.shape[0] != n:
                raise ValueError(f"{name} must have one count per row")
    ws_i, ws_f = _workspace(dev, N, P.shape[0], Q.shape[0], d)
    rc = _kernel("warp_accumulate")(
        _ptr(users), _ptr(positives), _ptr(negatives), _ptr(any_v),
        _ptr(weight), _ptr(P), _ptr(Q), N, int(max(0, min(n_valid, N))),
        P.shape[0], Q.shape[0], d, int(_l2(score_func)), float(reg_u),
        float(reg_i), float(reg_j), int(bool(update_i)),
        int(bool(update_j)), int(bool(users_sorted)), _ptr(gP), _ptr(gQ),
        _ptr(cP if per_coordinate_normalize else None),
        _ptr(cQ if per_coordinate_normalize else None), _ptr(ws_i),
        _ptr(ws_f), _stream(dev))
    _raise_on(rc, "warp_accumulate")
    warp_accumulate.launches += 1


warp_accumulate.launches = 0

KERNELS = (warp_search, warp_probe, warp_violations, warp_accumulate)


# -------------------------------------------------------- composed steps
# the JAX names of the plain projection (K10's projection mode on the card)
# and of the optimizer state without an item bias
project_unit_ball = S.project_unit_ball


def new_opt_state(P, Q):
    """Zeroed adam/adagrad moments of P and Q."""
    return S.new_opt_state(P, Q, None, False)


def new_accumulators(P, Q):
    """(gP, gQ, cP, cQ), zeroed."""
    return (torch.zeros_like(P), torch.zeros_like(Q),
            torch.zeros(P.shape[0], dtype=torch.float32, device=P.device),
            torch.zeros(Q.shape[0], dtype=torch.float32, device=Q.device))


def apply_epoch_barrier(P, Q, grads, opt_state, step, *, optimizer, lr,
                        beta1, beta2, reg_u, reg_i,
                        per_coordinate_normalize):
    """The deferred step of P and Q then the unit-ball projection
    (``warp_epoch`` :327-343), through K10's projection mode, in place;
    the gradients are zeroed."""
    gP, gQ, cP, cQ = grads
    kw = dict(step=step, optimizer=optimizer, lr=lr, beta1=beta1,
              beta2=beta2,
              per_coordinate_normalize=per_coordinate_normalize,
              project=True)
    S.deferred_update(P, gP, opt_state["mP"], opt_state["vP"], cP, reg=reg_u,
                      **kw)
    S.deferred_update(Q, gQ, opt_state["mQ"], opt_state["vQ"], cQ, reg=reg_i,
                      **kw)


def found_totals(counts, n_valid):
    """(found, possible) of one shard: its per-chunk found counts and real
    slots added into float32 carries, as the JAX scan carries them, so
    past 2^24 samples the totals round as the reference's do
    (``warp_epoch`` :316-347)."""
    out = []
    for values in (counts, n_valid):
        total = np.float32(0.0)
        for v in values:
            total = np.float32(total + np.float32(v))
        out.append(total)
    return tuple(out)


def warp_accumulate_step(P, Q, gradP, gradQ, countP, countQ, users,
                         positives, indptr, bloom_words, *, seed, epoch,
                         chunk, num_items, num_candidates, score_func,
                         threshold, reg_u, reg_i, reg_j, update_i, update_j,
                         per_coordinate_normalize, bloom_log2, probe="lazy",
                         candidates=None):
    """One streamed megabatch (``warp_accumulate_step`` :103): K11 on the
    chunk's candidates, then K12 into the accumulators (every slot real,
    users in any order).  Returns K11's (negatives, weights, any_v,
    trials)."""
    out = warp_search(users, positives, P, Q, num_items=num_items,
                      num_candidates=num_candidates, seed=seed, epoch=epoch,
                      chunk=chunk, n_valid=users.shape[0],
                      score_func=score_func, threshold=threshold,
                      probe=probe, indptr=indptr, bloom=bloom_words,
                      bloom_log2=bloom_log2, candidates=candidates)
    warp_accumulate(P, Q, gradP, gradQ, countP, countQ, users, positives,
                    out[0], out[2], out[1], n_valid=users.shape[0],
                    score_func=score_func, reg_u=reg_u, reg_i=reg_i,
                    reg_j=reg_j, update_i=update_i, update_j=update_j,
                    per_coordinate_normalize=per_coordinate_normalize)
    return out


def warp_probe_epoch(users, bloom_words, *, seed, epoch, num_items,
                     num_candidates, bloom_log2):
    """The split epoch's first pass (``warp_probe_epoch`` :175): K11's
    probe per chunk, (nchunks, N, ceil(K / 32)) int32 words."""
    return torch.stack([warp_probe(
        users[c], num_items=num_items, num_candidates=num_candidates,
        seed=seed, epoch=epoch, chunk=c, bloom=bloom_words,
        bloom_log2=bloom_log2) for c in range(users.shape[0])])


def warp_epoch(mesh, tables, opt_states, users, positives, step, *, seed,
               indptr, bloom, optimizer, num_items, num_candidates,
               score_func, threshold, reg_u, reg_i, reg_j, update_i,
               update_j, per_coordinate_normalize, lr, beta1, beta2,
               num_valid, bloom_log2, probe="lazy", seen_bits=None,
               candidates=None):
    """One resident WARP epoch (``warp_epoch`` :226, and ``warp_epoch_dp``
    :357 on a mesh): the positives in CSR order as (nchunks, N) chunks,
    entries from ``num_valid`` on padding, split on the batch axis over the
    mesh's shards (one device is a mesh of one shard), the tables
    replicated.  ``tables`` {device: (P, Q)} and ``opt_states`` {device:
    moments} hold one replica per local device; ``users`` / ``positives``
    one (nchunks, N / mesh.size) int32 tensor per local shard; ``indptr``
    / ``bloom`` {device: tensor}.  Per chunk and shard K11 searches the
    shard's rows of the single device's candidates (its slot offset) and
    K12 accumulates (the users already in order); at the barrier the
    gradients, counts and the found / possible totals are reduced over the
    shards, then K10 (adam or adagrad, and the unit-ball projection) runs
    on every replica.  ``seen_bits`` (one (nchunks, N, ceil(K / 32))
    tensor per shard, from ``warp_probe_epoch``) forces the "all" rule on
    those bits; ``candidates`` (one (nchunks, N, K) tensor per shard)
    replaces the draws.  Updates the tables and moments in place; returns
    found_frac."""
    devs = mesh.devices
    reps = S.replica_shards(mesh)
    nchunks, N_loc = users[0].shape
    N = N_loc * mesh.size
    rule = "all" if seen_bits is not None else probe
    grads = [new_accumulators(*tables[dev]) for dev in devs]
    counts = [torch.zeros(nchunks, dtype=torch.int32, device=dev)
              for dev in devs]
    n_valids = [[] for _ in devs]
    for c in range(nchunks):
        for k, dev in enumerate(devs):
            P, Q = tables[dev]
            off, n_valid = S.shard_slots(mesh, k, N_loc, num_valid, c, N)
            neg, w, any_v, _ = warp_search(
                users[k][c], positives[k][c], P, Q, num_items=num_items,
                num_candidates=num_candidates, seed=seed, epoch=step,
                chunk=c, n_valid=n_valid, score_func=score_func,
                threshold=threshold, probe=rule, indptr=indptr[dev],
                bloom=bloom[dev], bloom_log2=bloom_log2,
                seen_bits=None if seen_bits is None else seen_bits[k][c],
                candidates=None if candidates is None else candidates[k][c],
                counts=counts[k], count_index=c, slot_offset=off)
            warp_accumulate(P, Q, *grads[k], users[k][c], positives[k][c],
                            neg, any_v, w, n_valid=n_valid,
                            score_func=score_func, reg_u=reg_u, reg_i=reg_i,
                            reg_j=reg_j, update_i=update_i,
                            update_j=update_j,
                            per_coordinate_normalize=per_coordinate_normalize,
                            users_sorted=True)
            n_valids[k].append(n_valid)
    total = [S.reduced(mesh, [g[i] for g in grads]) for i in range(4)]
    # each shard's found and possible totals, reduced over the shards
    fp = [torch.tensor(found_totals(counts[k].cpu().numpy(), n_valids[k]),
                       dtype=torch.float32, device=dev)
          for k, dev in enumerate(devs)]
    found, poss = S.reduced(mesh, fp)[0].cpu().numpy()
    for dev, k in reps.items():
        apply_epoch_barrier(*tables[dev], [t[k] for t in total],
                            opt_states[dev], step, optimizer=optimizer,
                            lr=lr, beta1=beta1, beta2=beta2, reg_u=reg_u,
                            reg_i=reg_i,
                            per_coordinate_normalize=per_coordinate_normalize)
    return float(found / max(poss, np.float32(1.0)))


def warp_loss(P, Q, users, positives, negatives, *, score_func, threshold):
    """Violation rate over fixed triplets (``warp_loss`` :505), through
    K11's loss mode."""
    return warp_violations(P, Q, users, positives, negatives,
                           score_func=score_func, threshold=threshold)
