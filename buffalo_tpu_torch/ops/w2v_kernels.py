"""Skip-gram negative-sampling (word2vec) kernels.

PyTorch counterpart of ``buffalo_tpu.ops.w2v_kernels``.  Each chunk of an
epoch goes through hand-written CUDA kernels on the card (``csrc/*.cu``),
each beside its plain PyTorch version (``*_plain``):

* **K19** ``pair_step`` — the SGNS forward of one (input, target) pair
  chunk (the host-pair path): the K negatives (three alias draws that
  avoid the target, then ``(t + 1) % V``), f, g with the ±6 clamps, the
  loss, and the delta rows of L1 (targets, negatives) and L0 (inputs),
  each from the tables before the step.  Up to 256 floats a row a team of
  lanes takes a pair (8 pairs a warp at d = 32), the negatives drawn into
  registers and every row read as float4s before the first dot.
* **K20** ``row_apply`` — delta rows grouped by table row, each row's sum
  capped at ``max_step_norm`` (``clipped_apply``) and added; rows keyed
  past the table are dropped.  Both paths apply through it.
* **K21** ``stream_chunk_deltas`` — the on-device window expansion of one
  token chunk (the stream path): position-major deltas of L0 and L1 and
  the block-shared negatives' deltas, the loss and the pair count.  Its
  launcher takes the staged form (a tile's rows staged once in shared
  memory, each term's dot product once) where a tile fits
  (``w2v_stream_staged_tile``: rows up to 256 floats and moderate
  windows), the warp form otherwise.

The stream path's negatives are K8's alias draws
(``sgd_kernels.sample_negatives``, one attempt, no bloom filter).  All
draws are this port's own: Philox4x32-10 of (seed, epoch, chunk, slot,
attempt) with the chunk's index in its epoch, group by group; JAX's
threefry stream cannot be reproduced, so the tests replace the hooks
``w2v_negatives`` (pair path, read by K19's plain version) and
``stream_negatives`` (stream path) with the JAX package's draws to
compare the math.  Sums are deterministic (no float atomics).  Rows of
any width (past 256 floats the kernels walk them from global memory).

The two epochs, ``w2v_epoch`` (host pairs) and ``w2v_epoch_stream``, run
over a device mesh (``parallelism.Mesh``; one device is a mesh of one
shard), as the JAX package's ``w2v_epoch_dp`` and ``w2v_epoch_stream_dp``
do: the chunks split over the shards, the tables replicated, one replica
per device.  Each shard draws its slice of the single device's negatives
(K19 and K8 at its slot offset) and forms its delta rows (K19, K21); the
shards' rows are gathered in shard order and K20 applies their union on
every replica, so the cap sees each row's sum over the whole chunk.

Each wrapper runs its plain version for CPU tensors and launches its
kernel (or raises) for CUDA tensors; ``launches`` on each wrapper counts
the calls that launched it.  ``row_apply`` writes the table in place.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from buffalo_tpu_torch.ops import sgd_kernels as S
from buffalo_tpu_torch.ops.als_kernels import _check, _ptr, _raise_on, _stream

MAX_EXP = 6.0
EPS = 1e-10
# draws of a pair-path negative before the (t + 1) % V fallback (:513-517)
PAIR_ATTEMPTS = 3

_P, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_float)
# C signatures of the launch functions (csrc/w2v_*.cu); each launch returns
# its cudaError_t, the *_parts / workspace helpers their sizes
_SIGNATURES = {
    "w2v_pair_parts": [_I32, _I32],
    "w2v_pair_step": [_P, _P, _P, _P, _I32, _I32, _I32, _I32, _F32, _I64,
                      _I32, _I32, _I64, _P, _P, _P, _P, _P, _P, _P, _I32, _P,
                      _P, _P],
    "w2v_apply_workspace": [_I32, _I32, _I32, _P],
    "w2v_row_apply": [_P, _P, _I32, _P, _P, _I32, _P, _I32, _I32, _F32, _F32,
                      _P, _P, _P],
    "w2v_stream_parts": [_I32, _I32, _I32, _I32, _I32],
    "w2v_stream_staged_tile": [_I32, _I32, _I32, _I32],
    "w2v_stream_chunk": [_P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _I32,
                         _I32, _I32, _I32, _P, _P, _P, _P, _P, _P],
}
_LIBRARY = {"w2v_pair_parts": "w2v_pair_step",
            "w2v_pair_step": "w2v_pair_step",
            "w2v_apply_workspace": "w2v_row_apply",
            "w2v_row_apply": "w2v_row_apply",
            "w2v_stream_parts": "w2v_stream_chunk",
            "w2v_stream_staged_tile": "w2v_stream_chunk",
            "w2v_stream_chunk": "w2v_stream_chunk"}


def _kernel(name: str):
    from buffalo_tpu_torch.ops._build import launcher

    return launcher(name, _SIGNATURES[name], library=_LIBRARY[name])


# ---------------------------------------------------------------- plain
def g(label: float, f):
    """label - sigmoid(f) with hard clamps at ±MAX_EXP (``_g`` :27)."""
    mid = label - torch.sigmoid(f)
    return torch.where(f > MAX_EXP, torch.full_like(f, label - 1.0),
                       torch.where(f < -MAX_EXP, torch.full_like(f, label),
                                   mid))


def clipped_apply(T, dT, cap):
    """T + dT with the per-row L2 step-norm cap (``_clipped_apply`` :34;
    0 / None disables): a new tensor."""
    if not cap:
        return T + dT
    norms = torch.sqrt((dT * dT).sum(-1, keepdim=True))
    return T + dT * torch.clamp(cap / torch.clamp(norms, min=1e-20), max=1.0)


def row_apply_plain(T, parts, *, scale=1.0, cap=0.0):
    """Plain version of K20, in place: the delta rows of ``parts`` (a list
    of (int32 row ids, (n, d) rows)) times ``scale`` summed per row, ids
    outside the table dropped, then ``clipped_apply``."""
    R = T.shape[0]
    dT = torch.zeros_like(T)
    for keys, rows in parts:
        k = keys.long()
        keep = (k >= 0) & (k < R)
        dT.index_add_(0, k[keep], (scale * rows)[keep])
    T.copy_(clipped_apply(T, dT, cap))


def w2v_negatives(targets, vocab_size, *, num_negatives, seed, epoch, chunk,
                  alias, group=0, groups=1, cidx=0, slot_offset=0):
    """A pair chunk's (B, K) int32 negatives as K19 draws them: slot s =
    b K + k takes the first of ``PAIR_ATTEMPTS`` alias draws (K8's: the
    Philox words of the counter (s, chunk, epoch, attempt)) that is not
    ``targets[b]``, else ``(targets[b] + 1) % V``.  A mesh shard passes
    ``slot_offset``, its first pair of the chunk: its slots are then
    (slot_offset + b) K + k, the single device's.  ``group``, ``groups``
    and ``cidx`` (the chunk's index in its group) place the chunk in the
    JAX package's key chain; this generator keys by ``chunk`` alone."""
    B, K, V = targets.shape[0], int(num_negatives), int(vocab_size)
    slot = (torch.arange(B * K, device=targets.device, dtype=torch.int64)
            + int(slot_offset) * K) & S._U32
    t = targets.long().repeat_interleave(K)
    out = (t + 1) % V
    done = torch.zeros_like(slot, dtype=torch.bool)
    prob, al = alias
    for a in range(PAIR_ATTEMPTS):
        x0, x1, _, _ = S.philox4x32((slot, chunk, epoch, a),
                                    S._seed_key(seed))
        cand = (x0 * V) >> 32
        u01 = (x1 >> 8).to(torch.float32) * (2.0 ** -24)
        cand = torch.where(u01 < prob[cand], cand, al[cand].long())
        take = ~done & (cand != t)
        out = torch.where(take, cand, out)
        done |= take
    return out.to(torch.int32).reshape(B, K)


def stream_negatives(num_blocks, vocab_size, *, num_negatives, seed, epoch,
                     chunk, alias, device, group=0, groups=1, cidx=0,
                     slot_offset=0):
    """A token chunk's (NB, K) int32 block-shared negatives: K8's alias
    draws (one attempt, no bloom filter), slot b K + k from the counter
    (slot, chunk, epoch, 0) — through ``sgd_kernels.sample_negatives``, so
    on the card one K8 launch.  A mesh shard passes ``slot_offset``, its
    first block of the chunk, and draws the single device's rows of the
    global (T / block, K) draws.  ``group``, ``groups`` and ``cidx`` as in
    ``w2v_negatives``."""
    users = torch.zeros(num_blocks, dtype=torch.int32, device=device)
    neg, _ = S.sample_negatives(users, int(vocab_size),
                                num_negatives=int(num_negatives), seed=seed,
                                epoch=epoch, chunk=chunk, alias=alias,
                                slot_offset=int(slot_offset))
    return neg.reshape(num_blocks, int(num_negatives))


def pair_step_plain(L0, L1, inputs, targets, negs, lr, *, vocab_size,
                    compute_loss=True):
    """Plain version of K19 on given (B, K) negatives (``_w2v_step_body``
    :477 before its scatters): (keys1, d1, d0, loss, count) with keys1 =
    [targets; negatives] (V where the pair is padding), d1 their lr-scaled
    delta rows, d0 the inputs' (keyed by ``inputs``)."""
    V = int(vocab_size)
    d = L0.shape[1]
    valid_b = inputs < V
    valid = valid_b.to(torch.float32)
    l0 = L0[torch.clamp(inputs, max=V - 1).long()]
    lt = L1[torch.clamp(targets, max=V - 1).long()]
    ln = L1[negs.long()]
    f_pos = (l0 * lt).sum(-1)
    f_neg = torch.einsum("bd,bkd->bk", l0, ln)
    g_pos = g(1.0, f_pos) * valid
    g_neg = g(0.0, f_neg) * valid[:, None]
    if compute_loss:
        loss = (-(valid * torch.log(torch.sigmoid(f_pos) + EPS)).sum()
                - (valid[:, None]
                   * torch.log(1.0 - torch.sigmoid(f_neg) + EPS)).sum())
    else:
        loss = torch.zeros((), dtype=torch.float32, device=L0.device)
    keys1 = torch.cat([
        torch.where(valid_b, targets, V),
        torch.where(valid_b[:, None], negs, V).reshape(-1)]).to(torch.int32)
    d1 = torch.cat([lr * g_pos[:, None] * l0,
                    (lr * g_neg[..., None] * l0[:, None, :]).reshape(-1, d)])
    work = g_pos[:, None] * lt + torch.einsum("bk,bkd->bd", g_neg, ln)
    return keys1, d1, lr * work, loss, valid.sum()


def stream_chunk_deltas_plain(L0, L1, wc, sc, hc, negs, *, window, block,
                              vocab_size, compute_loss=True):
    """Plain version of K21: ``_stream_chunk_deltas`` (:236) for one chunk
    of T positions (words ``wc``, sentence ids ``sc``, half-windows
    ``hc``) with (T / block, K) negatives: (dL0p (T, d), dL1p (T, d), dLn
    (NB, K, d), loss, pair count)."""
    V = int(vocab_size)
    T = wc.shape[0]
    d = L0.shape[1]
    NB, K = negs.shape
    wc, sc, hc = wc.long(), sc.long(), hc.long()
    valid_tok = wc < V
    safe_w = torch.clamp(wc, max=V - 1)
    l0_pos, l1_pos = L0[safe_w], L1[safe_w]
    ln = L1[negs.long()]                                   # (NB, K, d)
    negs_pos = negs.long().repeat_interleave(block, dim=0)  # (T, K)
    pos_idx = torch.arange(T, device=wc.device)

    def pad(x, value):
        return torch.cat([x, torch.full((window,) + tuple(x.shape[1:]),
                                        value, dtype=x.dtype,
                                        device=x.device)])

    wc_p, sc_p, hc_p = pad(wc, V), pad(sc, -2), pad(hc, 0)
    l0_p, l1_p = pad(l0_pos, 0.0), pad(l1_pos, 0.0)
    zpad = torch.zeros((window, d), dtype=torch.float32, device=L0.device)
    dL0p, dL1p = torch.zeros_like(l0_pos), torch.zeros_like(l1_pos)
    dLn = torch.zeros_like(ln)
    loss = torch.zeros((), dtype=torch.float32, device=L0.device)
    cnt = torch.zeros((), dtype=torch.float32, device=L0.device)
    for off in range(1, window + 1):
        def nxt(xp):
            return xp[off:off + T]

        def fwd(c):
            # the contribution computed at i placed on position i + off
            return torch.cat([zpad, c])[window - off:window - off + T]

        in_range = pos_idx < T - off
        same = (sc == nxt(sc_p)) & in_range
        w_next, l0_next, l1_next = nxt(wc_p), nxt(l0_p), nxt(l1_p)
        both = same & valid_tok & (w_next < V)
        va = (both & (off <= hc)).to(torch.float32)
        vb = (both & (off <= nxt(hc_p))).to(torch.float32)
        f_a = (l0_next * l1_pos).sum(-1)
        g_a = g(1.0, f_a) * va
        dL1p = dL1p + g_a[:, None] * l0_next
        contrib_a = g_a[:, None] * l1_pos
        f_b = (l0_pos * l1_next).sum(-1)
        g_b = g(1.0, f_b) * vb
        dL0p = dL0p + g_b[:, None] * l1_next
        contrib_b = g_b[:, None] * l0_pos
        l0n_a = l0_next.reshape(NB, block, d)
        f_na = torch.einsum("nsd,nkd->nsk", l0n_a, ln)
        mask_a = (negs_pos != wc[:, None]).to(torch.float32) \
            .reshape(NB, block, K)
        g_na = g(0.0, f_na) * va.reshape(NB, block, 1) * mask_a
        dLn = dLn + torch.einsum("nsk,nsd->nkd", g_na, l0n_a)
        neg_back_a = torch.einsum("nsk,nkd->nsd", g_na, ln).reshape(T, d)
        l0n_b = l0_pos.reshape(NB, block, d)
        f_nb = torch.einsum("nsd,nkd->nsk", l0n_b, ln)
        mask_b = (negs_pos != w_next[:, None]).to(torch.float32) \
            .reshape(NB, block, K)
        g_nb = g(0.0, f_nb) * vb.reshape(NB, block, 1) * mask_b
        dLn = dLn + torch.einsum("nsk,nsd->nkd", g_nb, l0n_b)
        dL0p = dL0p + torch.einsum("nsk,nkd->nsd", g_nb, ln).reshape(T, d)
        dL0p = dL0p + fwd(contrib_a + neg_back_a)
        dL1p = dL1p + fwd(contrib_b)
        if compute_loss:
            loss = (loss
                    - (va * torch.log(torch.sigmoid(f_a) + EPS)).sum()
                    - (vb * torch.log(torch.sigmoid(f_b) + EPS)).sum()
                    - (va.reshape(NB, block, 1) * mask_a
                       * torch.log(1.0 - torch.sigmoid(f_na) + EPS)).sum()
                    - (vb.reshape(NB, block, 1) * mask_b
                       * torch.log(1.0 - torch.sigmoid(f_nb) + EPS)).sum())
        cnt = cnt + va.sum() + vb.sum()
    return dL0p, dL1p, dLn, loss, cnt


# ------------------------------------------------------------- wrappers
def _check_tables(L0, L1, dev):
    _check("L0", L0, torch.float32, dev, 2)
    _check("L1", L1, torch.float32, dev, 2)
    if L0.shape != L1.shape:
        raise ValueError(f"tables disagree: L0 {tuple(L0.shape)}, L1 "
                         f"{tuple(L1.shape)}")
    return L0.shape[1]


def pair_step(L0, L1, inputs, targets, lr, *, vocab_size, num_negatives,
              seed, epoch, chunk, alias, group=0, groups=1, cidx=0,
              slot_offset=0, negatives=None, compute_loss=True):
    """K19: one pair chunk's negatives and delta rows (see
    ``pair_step_plain``; the negatives as ``w2v_negatives`` draws them, at
    a mesh shard's ``slot_offset``, unless ``negatives`` (B, K) are
    given).  Replaces ``_w2v_step_body`` :477 with its draws at a
    ``row_offset`` (:503-511) and the forward of ``w2v_step`` :462,
    ``w2v_epoch`` :48 and ``w2v_epoch_dp`` :87
    (``buffalo_tpu/ops/w2v_kernels.py``).  Returns (negatives (B, K),
    keys1 (B (1 + K),), d1 (B (1 + K), d), d0 (B, d), loss, count), the
    last two 0-d float32 tensors.  ``launches`` counts the calls;
    ``device_launches`` the kernels they launched."""
    V, K = int(vocab_size), int(num_negatives)
    if inputs.device.type == "cpu":
        negs = negatives if negatives is not None else w2v_negatives(
            targets, V, num_negatives=K, seed=seed, epoch=epoch, chunk=chunk,
            alias=alias, group=group, groups=groups, cidx=cidx,
            slot_offset=slot_offset)
        return (negs,) + pair_step_plain(L0, L1, inputs, targets, negs, lr,
                                         vocab_size=V,
                                         compute_loss=compute_loss)
    dev = inputs.device
    d = _check_tables(L0, L1, dev)
    _check("inputs", inputs, torch.int32, dev, 1)
    _check("targets", targets, torch.int32, dev, 1)
    B = inputs.shape[0]
    if targets.shape[0] != B or L0.shape[0] != V or K < 1 \
            or slot_offset < 0:
        raise ValueError("inputs, targets, the tables and vocab_size "
                         f"disagree, or slot_offset {slot_offset} < 0")
    if negatives is not None:
        _check("negatives", negatives, torch.int32, dev, 2)
        if tuple(negatives.shape) != (B, K):
            raise ValueError("negatives must be (B, num_negatives)")
    else:
        _check("prob", alias[0], torch.float32, dev, 1)
        _check("alias", alias[1], torch.int32, dev, 1)
    negs = torch.empty((B, K), dtype=torch.int32, device=dev)
    keys1 = torch.empty(B * (1 + K), dtype=torch.int32, device=dev)
    d1 = torch.empty((B * (1 + K), d), dtype=torch.float32, device=dev)
    d0 = torch.empty((B, d), dtype=torch.float32, device=dev)
    blocks = _kernel("w2v_pair_parts")(B, d)
    part = torch.empty(2 * max(1, blocks), dtype=torch.float32, device=dev)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    rc = _kernel("w2v_pair_step")(
        _ptr(L0), _ptr(L1), _ptr(inputs), _ptr(targets), B, V, d, K,
        float(lr), S.philox_key(seed), int(epoch), int(chunk),
        int(slot_offset), _ptr(None if negatives is not None else alias[0]),
        _ptr(None if negatives is not None else alias[1]), _ptr(negatives),
        _ptr(negs), _ptr(keys1), _ptr(d1), _ptr(d0), int(bool(compute_loss)),
        _ptr(part), _ptr(out), _stream(dev))
    _raise_on(rc, "pair_step")
    pair_step.launches += 1
    pair_step.device_launches += 1 + int(blocks > 0)  # the pairs, the sums
    return negs, keys1, d1, d0, out[0], out[1]


pair_step.launches = 0
pair_step.device_launches = 0


def row_apply(T, parts, *, scale=1.0, cap=0.0):
    """K20: ``T`` += each row's sum of ``scale`` x its delta rows, capped
    (``row_apply_plain``), in place; ``parts`` one or two (int32 row ids,
    (n, d) rows) pairs: one chunk's, or on a mesh the union of the
    shards' (``apply_union``).  Replaces ``_clipped_apply`` :34 with the
    ``.at[].add(mode="drop")`` scatters feeding it (:221-226, :548-563)
    and the ``psum`` of the dense deltas before it on a mesh (:554, :562;
    :427, :433)."""
    if T.device.type == "cpu":
        return row_apply_plain(T, parts, scale=scale, cap=cap)
    dev = T.device
    _check("T", T, torch.float32, dev, 2)
    R, d = T.shape
    if not 1 <= len(parts) <= 2:
        raise ValueError("row_apply takes one or two (keys, rows) parts")
    for keys, rows in parts:
        _check("keys", keys, torch.int32, dev, 1)
        _check("rows", rows, torch.float32, dev, 2)
        if rows.shape != (keys.shape[0], d):
            raise ValueError(f"rows {tuple(rows.shape)} for "
                             f"{keys.shape[0]} keys of width {d}")
    if float(cap) < 0:
        raise ValueError(f"max_step_norm must be >= 0, got {cap}")
    (ka, ra), (kb, rb) = parts[0], (parts[1] if len(parts) > 1
                                     else (None, None))
    na, nb = ka.shape[0], (kb.shape[0] if kb is not None else 0)
    sizes = (ctypes.c_int64 * 2)()
    rc = _kernel("w2v_apply_workspace")(na + nb, R, d,
                                        ctypes.cast(sizes, ctypes.c_void_p))
    _raise_on(rc, "w2v_apply_workspace")
    ws_i = torch.empty(max(1, sizes[0]), dtype=torch.int32, device=dev)
    ws_f = torch.empty(max(1, sizes[1]), dtype=torch.float32, device=dev)
    rc = _kernel("w2v_row_apply")(
        _ptr(ka), _ptr(ra), na, _ptr(kb), _ptr(rb), nb, _ptr(T), R, d,
        float(scale), float(cap or 0.0), _ptr(ws_i), _ptr(ws_f), _stream(dev))
    _raise_on(rc, "row_apply")
    row_apply.launches += 1


row_apply.launches = 0


def stream_staged_tile(d, num_negatives, window, block):
    """Positions per tile of K21's staged form for rows of ``d`` floats,
    ``num_negatives`` per block of ``block`` positions and ``window``; 0
    where the warp form runs (the C launcher's own rule: rows past 256
    floats, or no tile that fits shared memory)."""
    return _kernel("w2v_stream_staged_tile")(int(d), int(num_negatives),
                                             int(window), int(block))


def stream_chunk_deltas(L0, L1, wc, sc, hc, negs, *, window, block,
                        vocab_size, compute_loss=True):
    """K21: one token chunk's skip-gram deltas (see
    ``stream_chunk_deltas_plain``).  Replaces ``_stream_chunk_deltas``
    :236 and the delta half of ``w2v_epoch_stream`` :200-219.  ``wc`` and
    ``sc`` int32 (T,), ``hc`` uint8 (T,), ``negs`` int32 (T / block, K)."""
    kw = dict(window=int(window), block=int(block),
              vocab_size=int(vocab_size), compute_loss=compute_loss)
    if wc.device.type == "cpu":
        return stream_chunk_deltas_plain(L0, L1, wc, sc, hc, negs, **kw)
    dev = wc.device
    d = _check_tables(L0, L1, dev)
    _check("wc", wc, torch.int32, dev, 1)
    _check("sc", sc, torch.int32, dev, 1)
    _check("hc", hc, torch.uint8, dev, 1)
    _check("negs", negs, torch.int32, dev, 2)
    T, (NB, K), V = wc.shape[0], negs.shape, kw["vocab_size"]
    if sc.shape[0] != T or hc.shape[0] != T or NB * block != T \
            or L0.shape[0] != V:
        raise ValueError(f"chunk of {T} positions, {NB} negative blocks of "
                         f"{block}, tables of {L0.shape[0]} rows for "
                         f"vocab_size {V}")
    if not 0 <= window < 256:
        raise ValueError(f"window must be in [0, 256), got {window}")
    dL0p = torch.empty((T, d), dtype=torch.float32, device=dev)
    dL1p = torch.empty((T, d), dtype=torch.float32, device=dev)
    dLn = torch.empty((NB, K, d), dtype=torch.float32, device=dev)
    part = torch.empty(2 * max(1, _kernel("w2v_stream_parts")(
        T, d, K, kw["window"], kw["block"])), dtype=torch.float32, device=dev)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    rc = _kernel("w2v_stream_chunk")(
        _ptr(L0), _ptr(L1), _ptr(wc), _ptr(sc), _ptr(hc), _ptr(negs), T, V,
        d, K, kw["window"], kw["block"], int(bool(compute_loss)), _ptr(dL0p),
        _ptr(dL1p), _ptr(dLn), _ptr(part), _ptr(out), _stream(dev))
    _raise_on(rc, "stream_chunk_deltas")
    stream_chunk_deltas.launches += 1
    return dL0p, dL1p, dLn, out[0], out[1]


stream_chunk_deltas.launches = 0

KERNELS = (pair_step, row_apply, stream_chunk_deltas)


# -------------------------------------------------------- composed steps
def device_rate(lr, min_lr, processed0, cidx, words_per_chunk, total_words):
    """The decayed rate of chunk ``cidx`` of a group that starts at
    ``processed0`` words, in float32 as the JAX package's scans form it
    on the device (:66-70, :206-209)."""
    f = np.float32
    progress = min((f(processed0) + f(cidx) * f(words_per_chunk))
                   / max(f(total_words), f(1.0)), f(1.0))
    return float(max(f(lr) - (f(lr) - f(min_lr)) * progress, f(min_lr)))


def host_rate(lr, min_lr, processed, total_words):
    """The streaming fallback's rate: float64 on the host, then float32
    (:609-618)."""
    progress = min(processed / max(total_words, 1.0), 1.0)
    return float(np.float32(max(lr - (lr - min_lr) * progress, min_lr)))


def w2v_step(L0, L1, inputs, targets, lr, *, seed, epoch, chunk, alias,
             num_negatives, vocab_size, compute_loss, max_step_norm=0.1,
             group=0, groups=1, cidx=None, negatives=None):
    """One pair-chunk update (``w2v_step`` :462): K19, then K20 on L1 and
    on L0.  Returns (loss, count), 0-d float32 tensors."""
    _, keys1, d1, d0, loss, cnt = pair_step(
        L0, L1, inputs, targets, lr, vocab_size=vocab_size,
        num_negatives=num_negatives, seed=seed, epoch=epoch, chunk=chunk,
        alias=alias, group=group, groups=groups,
        cidx=chunk if cidx is None else cidx, negatives=negatives,
        compute_loss=compute_loss)
    row_apply(L1, [(keys1, d1)], cap=max_step_norm)
    row_apply(L0, [(inputs, d0)], cap=max_step_norm)
    return loss, cnt


def apply_union(mesh, tables, i, shard_parts, *, scale=1.0, cap=0.0):
    """K20 on table ``i`` of every replica (``tables`` {device: (L0, L1)})
    with the union of the mesh's delta rows: ``shard_parts`` holds one
    list of (keys, rows) parts per local shard; each part is gathered over
    the mesh in global shard order (``parallelism.all_gather_rows``), so
    the cap sees each row's sum over every shard, as the JAX package's
    ``psum`` before ``_clipped_apply``.  A mesh of one shard applies its
    own parts."""
    if mesh.size == 1:
        row_apply(tables[mesh.devices[0]][i], shard_parts[0], scale=scale,
                  cap=cap)
        return
    from buffalo_tpu_torch.parallelism import all_gather_rows

    union = [tuple(all_gather_rows(mesh, [p[j][x] for p in shard_parts])
                   for x in (0, 1)) for j in range(len(shard_parts[0]))]
    for dev, k in S.replica_shards(mesh).items():
        row_apply(tables[dev][i], [(keys[k], rows[k]) for keys, rows in union],
                  scale=scale, cap=cap)


def _mesh_total(mesh, parts):
    """The sum over the mesh of the local shards' 0-d ``parts``, on the
    first local device (a single shard's own tensor)."""
    if mesh.size == 1:
        return parts[0]
    from buffalo_tpu_torch.parallelism import all_reduce_sum

    return all_reduce_sum(mesh, [p.reshape(1) for p in parts],
                          first_only=True).reshape(())


def w2v_epoch(mesh, tables, inputs, targets, alias, processed0, *, seed,
              epoch, group, groups, num_negatives, vocab_size, compute_loss,
              lr, min_lr, total_words, words_per_chunk, max_step_norm=0.1):
    """One group of ``w2v_epoch`` (:48), and of ``w2v_epoch_dp`` (:87) on a
    mesh of several shards: its (nchunks, N) pair chunks in order, each
    with the float32 decayed rate of its position; chunk c is the epoch's
    chunk ``group * nchunks + c``.  ``tables`` {device: (L0, L1)} holds one
    replica per local device, updated in place; ``inputs`` / ``targets``
    one (nchunks, N / mesh.size) int32 tensor per local shard, on its
    device; ``alias`` {device: (prob, alias)}.  Per chunk each shard runs
    K19 on its device's replica at its slot offset (its first global pair,
    so it draws the single device's negatives), then ``apply_union`` runs
    K20 on L1 and then on L0, each from the tables before the step: on one
    shard exactly ``w2v_step``.  The union's entries come in the single
    device's order (every shard's targets, then every shard's negatives;
    the inputs), so K20 sums each row as one device does and the mesh
    holds its tables.  Returns (loss, count) summed over the group and the
    mesh in float32."""
    devs = mesh.devices
    nchunks, N_loc = inputs[0].shape
    loss = [torch.zeros((), dtype=torch.float32, device=d) for d in devs]
    cnt = [torch.zeros((), dtype=torch.float32, device=d) for d in devs]
    for c in range(nchunks):
        lr_t = device_rate(lr, min_lr, processed0, c, words_per_chunk,
                           total_words)
        parts1, parts0 = [], []
        for k, dev in enumerate(devs):
            L0, L1 = tables[dev]
            _, keys1, d1, d0, l_, c_ = pair_step(
                L0, L1, inputs[k][c], targets[k][c], lr_t,
                vocab_size=vocab_size, num_negatives=num_negatives,
                seed=seed, epoch=epoch, chunk=group * nchunks + c,
                alias=alias[dev], group=group, groups=groups, cidx=c,
                slot_offset=mesh.shards[k] * N_loc, compute_loss=compute_loss)
            # the targets' rows and the negatives' as two parts: gathered
            # part by part, the union is the single device's entry order
            parts1.append([(keys1[:N_loc], d1[:N_loc]),
                           (keys1[N_loc:], d1[N_loc:])])
            parts0.append([(inputs[k][c], d0)])
            loss[k] = loss[k] + l_
            cnt[k] = cnt[k] + c_
        apply_union(mesh, tables, 1, parts1, cap=max_step_norm)
        apply_union(mesh, tables, 0, parts0, cap=max_step_norm)
    return _mesh_total(mesh, loss), _mesh_total(mesh, cnt)


def w2v_epoch_stream(mesh, tables, words, bounds, half, alias, processed0, *,
                     seed, epoch, group, groups, window, block,
                     num_negatives, vocab_size, compute_loss, lr, min_lr,
                     total_words, words_per_chunk, max_step_norm=0.1):
    """One group of ``w2v_epoch_stream`` (:141), and of
    ``w2v_epoch_stream_dp`` (:366) on a mesh of several shards, over
    (nchunks, T) token chunks (int32 words, uint8 sentence starts and
    half-windows) split on the position axis: ``words`` / ``bounds`` /
    ``half`` one (nchunks, T / mesh.size) tensor per local shard, on its
    device (T / mesh.size a multiple of ``block``); ``tables`` and
    ``alias`` as in ``w2v_epoch``.  Per chunk each shard takes the
    sentence ids of its slice (a cumsum of its starts, so no pair crosses
    a shard's edge: the JAX package drops those pairs too), its rows of
    the block-shared negatives (``stream_negatives``, K8 at its first
    block) and K21's deltas; then ``apply_union`` runs K20 on L0 (the
    positions) and on L1 (the positions, then the negatives), each scaled
    by the chunk's float32 rate.  Returns (loss, count) summed over the
    group and the mesh in float32."""
    devs = mesh.devices
    nchunks, T_loc = words[0].shape
    NB = T_loc // block
    d = tables[devs[0]][0].shape[1]
    loss = [torch.zeros((), dtype=torch.float32, device=x) for x in devs]
    cnt = [torch.zeros((), dtype=torch.float32, device=x) for x in devs]
    for c in range(nchunks):
        lr_t = device_rate(lr, min_lr, processed0, c, words_per_chunk,
                           total_words)
        parts0, parts1 = [], []
        for k, dev in enumerate(devs):
            L0, L1 = tables[dev]
            wc, hc = words[k][c], half[k][c]
            sc = torch.cumsum(bounds[k][c], 0, dtype=torch.int32)
            negs = stream_negatives(
                NB, vocab_size, num_negatives=num_negatives, seed=seed,
                epoch=epoch, chunk=group * nchunks + c, alias=alias[dev],
                device=dev, group=group, groups=groups, cidx=c,
                slot_offset=mesh.shards[k] * NB)
            dL0p, dL1p, dLn, l_, c_ = stream_chunk_deltas(
                L0, L1, wc, sc, hc, negs, window=window, block=block,
                vocab_size=vocab_size, compute_loss=compute_loss)
            parts0.append([(wc, dL0p)])
            parts1.append([(wc, dL1p),
                           (negs.reshape(-1), dLn.reshape(-1, d))])
            loss[k] = loss[k] + l_
            cnt[k] = cnt[k] + c_
        apply_union(mesh, tables, 0, parts0, scale=lr_t, cap=max_step_norm)
        apply_union(mesh, tables, 1, parts1, scale=lr_t, cap=max_step_norm)
    return _mesh_total(mesh, loss), _mesh_total(mesh, cnt)
