"""BPR negative sampling and megabatch SGD on one device.

PyTorch counterpart of ``buffalo_tpu.ops.sgd_kernels``'s single-device
functions.  The host helpers (alias tables, the blocked bloom filter over
the positives, ``pad_cols``) are numpy copies that give the reference's
bytes.  Each chunk of an epoch goes through hand-written CUDA kernels on
the card (``csrc/*.cu``), each beside its plain PyTorch version
(``*_plain``):

* **K8** ``sample_negatives`` — a chunk's negatives: per slot up to
  ``NUM_ATTEMPTS`` uniform or alias draws, the first one the bloom filter
  does not flag as a positive of the user, else the sentinel
  ``num_items``; optionally each slot's positive drawn from the user's
  list (``random_positive``).
* **K9** ``chunk_update`` / ``chunk_accumulate`` / ``chunk_delta`` +
  ``chunk_bias_neg_delta`` / ``triplet_loss`` — the chunk's pairwise
  logits and either the sgd step (per-row summed deltas, the optional
  per-row L2 clip, the positive side's bias applied before the negative
  side reads it), the deferred path's gradient and count accumulation, or
  a mesh shard's sgd deltas added into dense tables (the cap then applies
  to their all-reduced sum); and the loss over fixed triplets.
* **K10** ``deferred_update`` — the epoch barrier's adam or adagrad step
  on one table, optionally followed by WARP's unit-ball projection;
  ``capped_add`` — a table plus its reduced delta, each row capped.

The random draws are this port's own: a counter-based Philox4x32-10
function of (seed, epoch, chunk, slot, attempt), computed in uint32 by
K8 and in int64 torch ops masked to 32 bits by its plain version, which
agree bit for bit.  JAX's threefry stream cannot be reproduced, so the
tests inject the JAX package's negatives (in place of
``sample_negatives``'s) to compare the update math exactly.  Sums are
deterministic: K9 groups a chunk's entries by the rows they touch (a
resident chunk's users, which ascend, where they lie) and adds each row's
terms in entry order, with no float atomics.  Rows of any width: the
kernels hold up to 256 columns of a row per warp and walk wider rows in
256-column chunks.

``bpr_epoch`` is the resident epoch over a device mesh (one device is a
mesh of one shard): the chunks split over the shards, the tables
replicated, each shard's draws keyed by its global slots.

Each wrapper runs its plain version for CPU tensors and launches its
kernel (or raises) for CUDA tensors; ``launches`` on each wrapper counts
the calls that launched it.  The update wrappers write the tables in
place.
"""
from __future__ import annotations

import ctypes
import logging

import numpy as np
import torch

from buffalo_tpu_torch.ops.als_kernels import _check, _ptr, _raise_on, _stream

MAX_EXP = 6.0
FEPS = 1e-8
NUM_ATTEMPTS = 4
# the Philox counter word that tells random-positive draws from the
# negatives' attempts (0 .. NUM_ATTEMPTS - 1)
POSITIVE_STREAM = 0x80000000

_P, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_float)
# C signatures of the launch functions (csrc/bpr_*.cu); each returns the
# cudaError_t of its launches
_SIGNATURES = {
    "bpr_sample": [_P, _I32, _I32, _I32, _I64, _I32, _I32, _I64, _P, _I32,
                   _P, _P, _P, _P, _P, _P, _P],
    "bpr_workspace": [_I32, _I32, _I32, _I32, _I32, _P],
    "bpr_update": [_P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32,
                   _I32, _F32, _F32, _F32, _F32, _F32, _F32, _I32, _I32,
                   _I32, _I32, _P, _P, _P],
    "bpr_accumulate": [_P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32,
                       _I32, _P, _P, _P, _P, _P, _I32, _I32, _I32, _I32,
                       _I32, _P, _P, _P],
    "bpr_delta": [_P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32,
                  _I32, _F32, _F32, _F32, _F32, _F32, _I32, _I32, _I32, _P,
                  _P, _P, _I32, _P, _P, _P],
    "bpr_delta_bias_neg": [_I32, _I32, _I32, _I32, _I32, _F32, _F32, _P, _P,
                           _P, _P, _P],
    "bpr_loss": [_P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _P, _P],
    "bpr_optimizer": [_P, _P, _P, _P, _P, _I64, _I32, _I32, _F32, _F32,
                      _F32, _F32, _F32, _F32, _F32, _F32, _I32, _P],
    "bpr_capped_add": [_P, _P, _I64, _I32, _F32, _I32, _P],
}
# the library holding each launch function
_LIBRARY = {"bpr_sample": "bpr_sample", "bpr_workspace": "bpr_update",
            "bpr_update": "bpr_update", "bpr_accumulate": "bpr_update",
            "bpr_delta": "bpr_update", "bpr_delta_bias_neg": "bpr_update",
            "bpr_loss": "bpr_update", "bpr_optimizer": "bpr_optimizer",
            "bpr_capped_add": "bpr_optimizer"}
_U32 = 0xFFFFFFFF


def _kernel(name: str):
    from buffalo_tpu_torch.ops._build import launcher

    return launcher(name, _SIGNATURES[name], library=_LIBRARY[name])


# ----------------------------------------------------------- host helpers
def build_alias_table(weights):
    """Walker/Vose alias tables for O(1) categorical draws (the JAX
    package's ``build_alias_table``, ``sgd_kernels.py:31``, the same
    float64 set-up, so the same bytes).  Returns (prob float32[N], alias
    int32[N])."""
    w = np.asarray(weights, dtype=np.float64)
    n = int(w.shape[0])
    assert n > 0 and (w >= 0).all(), "weights must be non-negative"
    total = w.sum()
    assert total > 0, "weights must not all be zero"
    p = w * (n / total)
    alias = np.arange(n, dtype=np.int32)
    prob = np.ones(n, dtype=np.float32)
    small = list(np.nonzero(p < 1.0)[0][::-1])
    large = list(np.nonzero(p >= 1.0)[0][::-1])
    while small and large:
        s = int(small.pop())
        big = int(large.pop())
        prob[s] = p[s]
        alias[s] = big
        p[big] -= 1.0 - p[s]
        (large if p[big] >= 1.0 else small).append(big)
    return prob, alias


_MIX_C1 = np.uint32(0x7feb352d)
_MIX_C2 = np.uint32(0x846ca68b)
_SEED_1 = np.uint32(0x9e3779b9)
_SEED_2 = np.uint32(0x85ebca6b)


def _mix32(x):
    """32-bit finalizer on numpy uint32 (``sgd_kernels.py:106``)."""
    x = x ^ (x >> 16)
    x = x * _MIX_C1
    x = x ^ (x >> 15)
    x = x * _MIX_C2
    x = x ^ (x >> 16)
    return x


def _bloom_hashes(u, i, log2_bits):
    """Blocked-bloom coordinates of pairs (u, i), numpy uint32: one word
    index and two bit positions in it (``sgd_kernels.py:117``)."""
    h1 = _mix32(u ^ _mix32(i ^ _SEED_1))
    h2 = _mix32(i ^ _mix32(u ^ _SEED_2))
    word = h1 & np.uint32((1 << (log2_bits - 5)) - 1)
    b1 = h2 & np.uint32(31)
    b2 = (h2 >> 5) & np.uint32(31)
    return word, b1, b2


def pad_cols(arr: np.ndarray, width: int) -> np.ndarray:
    """Zero-pad a host (N, d) table to (N, width); no-op if wide enough."""
    if width <= arr.shape[1]:
        return arr
    out = np.zeros((arr.shape[0], width), arr.dtype)
    out[:, : arr.shape[1]] = arr
    return out


def build_bloom(indptr: np.ndarray, keys: np.ndarray,
                bits_per_entry: int = 12):
    """Blocked bloom filter over every (user, item) positive of a CSR
    (``sgd_kernels.py:184``): both bits of a pair in one uint32 word;
    never false-negative.  Returns (words uint32[2^(log2_bits - 5)],
    log2_bits)."""
    nnz = len(keys)
    log2_bits = max(16, int(np.ceil(np.log2(max(1, nnz * bits_per_entry)))))
    log2_bits = min(log2_bits, 32)
    if nnz * bits_per_entry > (1 << 32):
        logging.getLogger("buffalo_tpu_torch.sgd_kernels").warning(
            "bloom filter capped at 2^32 bits for %d positives; "
            "false-positive rate ~%.1f%%", nnz,
            100.0 * (2.0 * 32.0 * nnz / (1 << 32) / 32.0) ** 2)
    users = np.repeat(
        np.arange(len(indptr) - 1, dtype=np.uint32),
        np.diff(np.asarray(indptr))).astype(np.uint32)
    items = np.asarray(keys, dtype=np.uint32)
    with np.errstate(over="ignore"):
        word, b1, b2 = _bloom_hashes(users, items, log2_bits)
    words = np.zeros(1 << (log2_bits - 5), dtype=np.uint32)
    wi = word.astype(np.int64)
    np.bitwise_or.at(words, wi, np.uint32(1) << b1)
    np.bitwise_or.at(words, wi, np.uint32(1) << b2)
    return words, log2_bits


# ------------------------------------------------- uint32 math on int64
def _mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32) and a constant c, on int64
    tensors without overflow (16-bit halves of c)."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _U32


def _mulhilo(c: int, x):
    """(high, low) 32-bit words of the 64-bit product c * x."""
    t1 = x * (c & 0xFFFF)            # < 2^48
    t2 = x * (c >> 16)               # < 2^48
    mid = t1 + ((t2 & 0xFFFF) << 16)
    return (t2 >> 16) + (mid >> 32), mid & _U32


_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def philox4x32(ctr, key):
    """Philox4x32-10 (Salmon et al., SC 2011) of the counters ``ctr`` (four
    int64 tensors, or ints broadcast to them, each in [0, 2^32)) under the
    key (k0, k1): four int64 tensors of uint32 words, the same bits as
    ``csrc/bpr_sample.cu``'s ``philox``."""
    like = next(c for c in ctr if isinstance(c, torch.Tensor))
    c0, c1, c2, c3 = (c if isinstance(c, torch.Tensor)
                      else torch.full_like(like, int(c)) for c in ctr)
    k0, k1 = int(key[0]), int(key[1])
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _seed_key(seed: int):
    s = int(seed) & ((1 << 64) - 1)
    return s & _U32, s >> 32


def philox_key(seed: int) -> int:
    """The seed's Philox key as the kernels take it: (k1 << 32) | k0, as a
    signed int64."""
    k0, k1 = _seed_key(seed)
    key = (k1 << 32) | k0
    return key - (1 << 64) if key >= 1 << 63 else key


def bloom_hashes_plain(u, i, log2_bits):
    """``_bloom_hashes`` on int64 tensors of uint32 values."""
    def mix(x):
        x = x ^ (x >> 16)
        x = _mul32(x, int(_MIX_C1))
        x = x ^ (x >> 15)
        x = _mul32(x, int(_MIX_C2))
        return x ^ (x >> 16)

    h1 = mix(u ^ mix(i ^ int(_SEED_1)))
    h2 = mix(i ^ mix(u ^ int(_SEED_2)))
    return h1 & ((1 << (log2_bits - 5)) - 1), h2 & 31, (h2 >> 5) & 31


# ------------------------------------------------------------ K8 plain
def sample_negatives_plain(users, num_items, *, num_negatives, seed, epoch,
                           chunk, bloom=None, bloom_log2=0, alias=None,
                           pos_indptr=None, pos_keys=None, slot_offset=0):
    """Plain version of K8.  Slot k = j * num_negatives + n belongs to user
    ``users[j]``; attempt a draws Philox words x0, x1 of the counter (k,
    chunk, epoch, a) under the seed's key: the uniform index is
    mulhi(x0, n), an alias draw keeps it if (x1 >> 8) 2^-24 < prob, else
    takes its alias.  With a bloom filter (int32 view of its uint32 words)
    the first attempt not flagged seen wins, else ``num_items``; without,
    attempt 0.  With ``pos_indptr``/``pos_keys`` (int64 / int32 CSR), slot
    j's positive is ``keys[lo + (x0 >> 2) % max(deg, 1)]`` from the
    counter (j, chunk, epoch, POSITIVE_STREAM).  A mesh shard passes
    ``slot_offset``, its first slot of the chunk: the counters then take
    the global slots (j + slot_offset, and k + slot_offset * num_negatives),
    so its draws are the single device's slice.  Returns (negatives int32
    (N * num_negatives,), positives int32 (N,) or None)."""
    key = _seed_key(seed)
    N = users.shape[0]
    slot = torch.arange(N * num_negatives, device=users.device,
                        dtype=torch.int64) + int(slot_offset) * num_negatives
    u = users.long().repeat_interleave(num_negatives)
    out = torch.full_like(slot, num_items)
    done = torch.zeros_like(slot, dtype=torch.bool)
    for a in range(NUM_ATTEMPTS if bloom is not None else 1):
        x0, x1, _, _ = philox4x32((slot & _U32, chunk, epoch, a), key)
        cand = (x0 * num_items) >> 32
        if alias is not None:
            prob, al = alias
            u01 = (x1 >> 8).to(torch.float32) * (2.0 ** -24)
            cand = torch.where(u01 < prob[cand], cand, al[cand].long())
        if bloom is None:
            out = cand
            break
        word, b1, b2 = bloom_hashes_plain(u, cand, bloom_log2)
        w = bloom[word].long() & _U32
        take = ~done & (((w >> b1) & (w >> b2) & 1) == 0)
        out = torch.where(take, cand, out)
        done |= take
    pos = None
    if pos_indptr is not None:
        j = torch.arange(N, device=users.device,
                         dtype=torch.int64) + int(slot_offset)
        x0 = philox4x32((j & _U32, chunk, epoch, POSITIVE_STREAM), key)[0]
        ul = users.long()
        lo = pos_indptr[ul]
        deg = pos_indptr[ul + 1] - lo
        pos = pos_keys[lo + (x0 >> 2) % deg.clamp(min=1)].to(torch.int32)
    return out.to(torch.int32), pos


# ------------------------------------------------------------ K9 plain
def clipped_logit(x):
    """1 - sigmoid(x) with the reference's hard clamps: > 6 -> 0,
    < -6 -> 1 (``sgd_kernels.py:272``)."""
    base = torch.sigmoid(-x)
    return torch.where(x > MAX_EXP, torch.zeros_like(x),
                       torch.where(x < -MAX_EXP, torch.ones_like(x), base))


def clip_row_norm(delta, cap):
    """Per-row L2 cap on an aggregated update table (1-D: elementwise)."""
    if delta.dim() == 1:
        return delta.clamp(-cap, cap)
    n = torch.sqrt((delta * delta).sum(-1, keepdim=True))
    return delta * torch.clamp(cap / torch.clamp(n, min=1e-12), max=1.0)


def _forward(P, Q, Qb, users, positives, negatives, num_negatives, n_valid,
             use_bias):
    """``_bpr_forward`` with the chunk's mask (``sgd_kernels.py:336,505-
    530``): (u, pos, neg, neg_ok, safe neg, mask, p, qi, qj, logit * mask)
    per sample, samples slot-major."""
    u = users.long().repeat_interleave(num_negatives)
    pos = positives.long().repeat_interleave(num_negatives)
    neg = negatives.long()
    n_items = Q.shape[0]
    neg_ok = neg < n_items
    safe = torch.clamp(neg, max=n_items - 1)
    p, qi, qj = P[u], Q[pos], Q[safe]
    x = (p * (qi - qj)).sum(-1)
    if use_bias:
        x = x + Qb[pos] - Qb[safe]
    slot = torch.arange(neg.shape[0], device=neg.device) // num_negatives
    mask = (slot < n_valid).to(torch.float32)
    logit = clipped_logit(x) * neg_ok.to(torch.float32)
    return u, pos, neg, neg_ok, safe, mask, p, qi, qj, logit * mask


def capped_add_plain(param, delta, cap):
    """Plain version of K10's capped add, in place: ``param +=
    clip_row_norm(delta, cap)`` (cap 0: the delta as it is)."""
    param += clip_row_norm(delta, cap) if cap else delta


def chunk_delta_plain(P, Q, Qb, dP, dQ, dQb, users, positives, negatives, *,
                      n_valid, lr, reg_u, reg_i, reg_j, reg_b, num_negatives,
                      use_bias, update_i, update_j, users_sorted=False):
    """Plain version of K9's delta path: the sgd terms of one chunk
    (``bpr_epoch_dp`` :804-821) added into the dense tables dP, dQ and (the
    bias's positive side) dQb, every term from the chunk's snapshot; the
    tables are not written.  Returns what ``chunk_bias_neg_delta_plain``
    needs for the negative side's bias.  ``users_sorted`` (the kernel's
    promise that users[:n_valid] ascend) changes nothing here."""
    u, pos, neg, ok, safe, mask, p, qi, qj, logit = _forward(
        P, Q, Qb, users, positives, negatives, num_negatives, n_valid,
        use_bias)
    lr_m = lr * mask[:, None]
    item_deriv = logit[:, None] * p
    dP.index_add_(0, u, lr_m * (logit[:, None] * (qi - qj) - reg_u * p))
    if update_i:
        dQ.index_add_(0, pos, lr_m * (item_deriv - reg_i * qi))
        if use_bias:
            dQb.index_add_(0, pos, lr * mask * (logit - reg_b * Qb[pos]))
    if update_j:
        dQ.index_add_(0, neg[ok], (lr_m * (-item_deriv - reg_j * qj))[ok])
    return neg, ok, safe, mask, logit


def chunk_bias_neg_delta_plain(handle, Qb, dQb, *, lr, reg_b):
    """Plain version of K9's second delta launch: the negative side's bias
    step into dQb, its reg term reading Qb after the positive side's
    (``bpr_epoch_dp`` :832-839)."""
    neg, ok, safe, mask, logit = handle
    dQb.index_add_(0, neg[ok], (lr * mask * (-logit - reg_b * Qb[safe]))[ok])


def chunk_update_plain(P, Q, Qb, users, positives, negatives, *, n_valid, lr,
                       reg_u, reg_i, reg_j, reg_b, max_step_norm,
                       num_negatives, use_bias, update_i, update_j,
                       users_sorted=False):
    """Plain version of K9's sgd step, in place: the scan body of
    ``bpr_epoch`` (``sgd_kernels.py:603-651``) for one chunk whose first
    ``n_valid`` slots are real, every term from the chunk's snapshot of
    the tables except the negative side's bias reg term, which reads Qb
    after the positive side's update.  It is the delta path on one shard
    followed by the capped adds, in the mesh epoch's order."""
    cap = float(max_step_norm)
    dP, dQ, dQb = (torch.zeros_like(t) for t in (P, Q, Qb))
    h = chunk_delta_plain(P, Q, Qb, dP, dQ, dQb, users, positives, negatives,
                          n_valid=n_valid, lr=lr, reg_u=reg_u, reg_i=reg_i,
                          reg_j=reg_j, reg_b=reg_b,
                          num_negatives=num_negatives, use_bias=use_bias,
                          update_i=update_i, update_j=update_j)
    if use_bias and update_i:
        capped_add_plain(Qb, dQb, cap)
    if use_bias and update_j:
        dQb.zero_()
        chunk_bias_neg_delta_plain(h, Qb, dQb, lr=lr, reg_b=reg_b)
        capped_add_plain(Qb, dQb, cap)
    capped_add_plain(P, dP, cap)
    capped_add_plain(Q, dQ, cap)


def chunk_accumulate_plain(P, Q, Qb, gP, gQ, gQb, cP, cQ, users, positives,
                           negatives, *, n_valid, num_negatives, use_bias,
                           update_i, update_j, per_coordinate_normalize,
                           users_sorted=False):
    """Plain version of K9's deferred path, in place into the epoch's
    accumulators (``sgd_kernels.py:545-572``): gradients, and with
    ``per_coordinate_normalize`` the counts (the user and the positive
    once per pair, the negative once per sample)."""
    u, pos, neg, ok, _, mask, p, qi, qj, logit = _forward(
        P, Q, Qb, users, positives, negatives, num_negatives, n_valid,
        use_bias)
    gP.index_add_(0, u, logit[:, None] * (qi - qj))
    item_deriv = logit[:, None] * p
    if update_i:
        gQ.index_add_(0, pos, item_deriv)
        if use_bias:
            gQb.index_add_(0, pos, logit)
    if update_j:
        gQ.index_add_(0, neg[ok], -item_deriv[ok])
        if use_bias:
            gQb.index_add_(0, neg[ok], -logit[ok])
    if per_coordinate_normalize:
        valid1 = mask.reshape(-1, num_negatives)[:, 0]
        cP.index_add_(0, users.long(), valid1)
        cQ.index_add_(0, positives.long(), valid1)
        cQ.index_add_(0, neg[ok], mask[ok])


def triplet_loss_plain(P, Q, Qb, users, positives, negatives, *, use_bias):
    """Plain version of K9's loss: mean log(1 + exp(-x_uij)) over fixed
    triplets (``bpr_loss``, ``sgd_kernels.py:859``), a 0-d tensor."""
    u, i, j = users.long(), positives.long(), negatives.long()
    x = (P[u] * (Q[i] - Q[j])).sum(-1)
    if use_bias:
        x = x + Qb[i] - Qb[j]
    return torch.logaddexp(torch.zeros_like(x), -x).mean()


# ----------------------------------------------------------- K10 plain
def project_unit_ball(X):
    """Each row scaled to L2 norm at most 1, in place (``warp_kernels.py``
    ``project_unit_ball`` :498)."""
    norms = torch.sqrt((X * X).sum(-1, keepdim=True))
    return X.div_(torch.clamp(norms, min=1.0))


def _bias_corrections(optimizer, step, beta1, beta2):
    """adam's 1 - beta^(step + 1) in float32, as the reference's traced
    step computes them (1.0 each for adagrad)."""
    if optimizer != "adam":
        return 1.0, 1.0
    f, t = np.float32, np.float32(step + 1)
    return float(f(1) - f(beta1) ** t), float(f(1) - f(beta2) ** t)


def deferred_update_plain(param, grad, m, v, counts, *, step, optimizer, lr,
                          beta1, beta2, reg, per_coordinate_normalize,
                          project=False):
    """Plain version of K10, in place: ``apply_deferred_update``
    (``sgd_kernels.py:315``) — the count divide, the L2 term -2 reg param,
    adam or adagrad, the table moved by the step; the gradient zeroed;
    with ``project`` each row then scaled to L2 norm at most 1
    (``warp_kernels.py:498``)."""
    g = grad
    if per_coordinate_normalize:
        c = torch.clamp(counts, min=1.0)
        g = g / (c[:, None] if g.dim() == 2 else c)
    g = g - 2.0 * reg * param
    if optimizer == "adam":
        c1, c2 = _bias_corrections(optimizer, step, beta1, beta2)
        m.mul_(beta1).add_((1.0 - beta1) * g)
        v.mul_(beta2).add_((1.0 - beta2) * g * g)
        delta = lr * (m / c1) / (torch.sqrt(v / c2) + FEPS)
    else:
        v.add_(g * g)
        delta = lr * g / (torch.sqrt(v) + FEPS)
    param.add_(delta)
    grad.zero_()
    if project:
        project_unit_ball(param)


# ------------------------------------------------------------- wrappers
def sample_negatives(users, num_items, *, num_negatives, seed, epoch, chunk,
                     bloom=None, bloom_log2=0, alias=None, pos_indptr=None,
                     pos_keys=None, slot_offset=0):
    """K8: one chunk's negatives (and, given the CSR, its drawn positives);
    see ``sample_negatives_plain`` for the function.  Replaces
    ``draw_from_alias`` :70, ``draw_negatives`` :82, ``bloom_contains``
    :234, ``sample_verified_negatives`` :243 and the random-positive draw
    of ``bpr_epoch`` :508-519 (``buffalo_tpu/ops/sgd_kernels.py``).
    ``users`` (N,) int32; ``bloom`` int32 words; ``alias`` (prob float32,
    alias int32); ``pos_indptr`` int64, ``pos_keys`` int32; ``slot_offset``
    a mesh shard's first global slot of the chunk."""
    kw = dict(num_negatives=num_negatives, seed=seed, epoch=epoch,
              chunk=chunk, bloom=bloom, bloom_log2=bloom_log2, alias=alias,
              pos_indptr=pos_indptr, pos_keys=pos_keys,
              slot_offset=slot_offset)
    if users.device.type == "cpu":
        return sample_negatives_plain(users, num_items, **kw)
    dev = users.device
    _check("users", users, torch.int32, dev, 1)
    if bloom is not None:
        _check("bloom", bloom, torch.int32, dev, 1)
        if bloom.shape[0] != 1 << (bloom_log2 - 5):
            raise ValueError(f"bloom has {bloom.shape[0]} words for "
                             f"log2_bits {bloom_log2}")
    if alias is not None:
        _check("prob", alias[0], torch.float32, dev, 1)
        _check("alias", alias[1], torch.int32, dev, 1)
        if alias[0].shape[0] != num_items or alias[1].shape[0] != num_items:
            raise ValueError("alias tables must have num_items entries")
    if pos_indptr is not None:
        _check("pos_indptr", pos_indptr, torch.int64, dev, 1)
        _check("pos_keys", pos_keys, torch.int32, dev, 1)
    if not 1 <= num_items < 1 << 31 or num_negatives < 1 or slot_offset < 0:
        raise ValueError(f"num_items {num_items}, num_negatives "
                         f"{num_negatives}, slot_offset {slot_offset}")
    N = users.shape[0]
    neg = torch.empty(N * num_negatives, dtype=torch.int32, device=dev)
    pos = (torch.empty(N, dtype=torch.int32, device=dev)
           if pos_indptr is not None else None)
    rc = _kernel("bpr_sample")(
        _ptr(users), N, num_negatives, num_items, philox_key(seed),
        int(epoch), int(chunk), int(slot_offset), _ptr(bloom),
        int(bloom_log2),
        _ptr(alias[0] if alias is not None else None),
        _ptr(alias[1] if alias is not None else None), _ptr(pos_indptr),
        _ptr(pos_keys), _ptr(neg), _ptr(pos), _stream(dev))
    _raise_on(rc, "sample_negatives")
    sample_negatives.launches += 1
    return neg, pos


sample_negatives.launches = 0


def _check_chunk(P, Q, Qb, users, positives, negatives, num_negatives):
    dev = P.device
    _check("P", P, torch.float32, dev, 2)
    _check("Q", Q, torch.float32, dev, 2)
    _check("Qb", Qb, torch.float32, dev, 1)
    for name, t in (("users", users), ("positives", positives),
                    ("negatives", negatives)):
        _check(name, t, torch.int32, dev, 1)
    d = P.shape[1]
    if Q.shape[1] != d or Qb.shape[0] != Q.shape[0]:
        raise ValueError(f"tables disagree: P {tuple(P.shape)}, Q "
                         f"{tuple(Q.shape)}, Qb {tuple(Qb.shape)}")
    N = users.shape[0]
    if positives.shape[0] != N or negatives.shape[0] != N * num_negatives:
        raise ValueError("users, positives and negatives disagree on the "
                         "chunk's slots")
    return dev, N, d


_WORKSPACE_SIZES = {}


def _workspace(dev, N, num_negatives, num_users, num_items, d):
    """K9's scratch: (int32 words, float32 words), sized by the C
    interface's own ``bpr_workspace`` (asked once per shape: host work per
    call shows in a chunk's time)."""
    key = (N, num_negatives, num_users, num_items, d)
    sizes = _WORKSPACE_SIZES.get(key)
    if sizes is None:
        out = (ctypes.c_int64 * 2)()
        rc = _kernel("bpr_workspace")(N, num_negatives, num_users, num_items,
                                      d, ctypes.cast(out, ctypes.c_void_p))
        _raise_on(rc, "bpr_workspace")
        sizes = _WORKSPACE_SIZES[key] = (max(1, out[0]), max(1, out[1]))
    return (torch.empty(sizes[0], dtype=torch.int32, device=dev),
            torch.empty(sizes[1], dtype=torch.float32, device=dev))


def chunk_update(P, Q, Qb, users, positives, negatives, *, n_valid, lr,
                 reg_u, reg_i, reg_j, reg_b, max_step_norm, num_negatives,
                 use_bias, update_i, update_j, users_sorted=False):
    """K9, sgd: one chunk's update of P, Q and Qb in place (see
    ``chunk_update_plain``).  Replaces ``_bpr_forward`` :336,
    ``clipped_logit`` :272, ``clip_row_norm`` :280, ``bpr_sgd_step`` :390
    and the sgd scan body of ``bpr_epoch`` :600-651
    (``buffalo_tpu/ops/sgd_kernels.py``).  Negatives >= num_items are
    sentinels; slots from ``n_valid`` on are padding.  ``users_sorted``:
    users[:n_valid] ascend (a resident chunk), so each user's slots are
    summed where they lie, with no grouping."""
    kw = dict(n_valid=n_valid, lr=lr, reg_u=reg_u, reg_i=reg_i, reg_j=reg_j,
              reg_b=reg_b, max_step_norm=max_step_norm,
              num_negatives=num_negatives, use_bias=use_bias,
              update_i=update_i, update_j=update_j,
              users_sorted=users_sorted)
    if P.device.type == "cpu":
        return chunk_update_plain(P, Q, Qb, users, positives, negatives, **kw)
    dev, N, d = _check_chunk(P, Q, Qb, users, positives, negatives,
                             num_negatives)
    ws_i, ws_f = _workspace(dev, N, num_negatives, P.shape[0], Q.shape[0], d)
    rc = _kernel("bpr_update")(
        _ptr(users), _ptr(positives), _ptr(negatives), _ptr(P), _ptr(Q),
        _ptr(Qb), N, num_negatives, int(max(0, min(n_valid, N))), P.shape[0],
        Q.shape[0], d, float(lr), float(reg_u), float(reg_i), float(reg_j),
        float(reg_b), float(max_step_norm), int(bool(use_bias)),
        int(bool(update_i)), int(bool(update_j)), int(bool(users_sorted)),
        _ptr(ws_i), _ptr(ws_f), _stream(dev))
    _raise_on(rc, "chunk_update")
    chunk_update.launches += 1


chunk_update.launches = 0


def chunk_accumulate(P, Q, Qb, gP, gQ, gQb, cP, cQ, users, positives,
                     negatives, *, n_valid, num_negatives, use_bias, update_i,
                     update_j, per_coordinate_normalize, users_sorted=False):
    """K9, deferred: one chunk's gradients and counts added into the
    epoch's accumulators (see ``chunk_accumulate_plain``).  Replaces
    ``bpr_accumulate_step`` :355 and the deferred scan body of
    ``bpr_epoch`` :545-572.  ``users_sorted`` as in ``chunk_update``."""
    kw = dict(n_valid=n_valid, num_negatives=num_negatives,
              use_bias=use_bias, update_i=update_i, update_j=update_j,
              per_coordinate_normalize=per_coordinate_normalize,
              users_sorted=users_sorted)
    if P.device.type == "cpu":
        return chunk_accumulate_plain(P, Q, Qb, gP, gQ, gQb, cP, cQ, users,
                                      positives, negatives, **kw)
    dev, N, d = _check_chunk(P, Q, Qb, users, positives, negatives,
                             num_negatives)
    for name, t, like in (("gP", gP, P), ("gQ", gQ, Q), ("gQb", gQb, Qb)):
        _check(name, t, torch.float32, dev, like.dim())
        if t.shape != like.shape:
            raise ValueError(f"{name} must have the shape of its table")
    for name, t, n in (("cP", cP, P.shape[0]), ("cQ", cQ, Q.shape[0])):
        _check(name, t, torch.float32, dev, 1)
        if t.shape[0] != n:
            raise ValueError(f"{name} must have one count per row")
    ws_i, ws_f = _workspace(dev, N, num_negatives, P.shape[0], Q.shape[0], d)
    rc = _kernel("bpr_accumulate")(
        _ptr(users), _ptr(positives), _ptr(negatives), _ptr(P), _ptr(Q),
        _ptr(Qb), N, num_negatives, int(max(0, min(n_valid, N))), P.shape[0],
        Q.shape[0], d, _ptr(gP), _ptr(gQ), _ptr(gQb), _ptr(cP), _ptr(cQ),
        int(bool(use_bias)), int(bool(update_i)), int(bool(update_j)),
        int(bool(per_coordinate_normalize)), int(bool(users_sorted)),
        _ptr(ws_i), _ptr(ws_f), _stream(dev))
    _raise_on(rc, "chunk_accumulate")
    chunk_accumulate.launches += 1


chunk_accumulate.launches = 0


def chunk_delta(P, Q, Qb, dP, dQ, dQb, users, positives, negatives, *,
                n_valid, lr, reg_u, reg_i, reg_j, reg_b, num_negatives,
                use_bias, update_i, update_j, users_sorted=False):
    """K9, delta: one chunk's sgd terms added into the dense delta tables
    dP, dQ and dQb (see ``chunk_delta_plain``); a mesh shard's chunk of
    ``bpr_epoch_dp`` :804-831.  Returns the handle that
    ``chunk_bias_neg_delta`` takes (on the card, the workspace that keeps
    the chunk's item rows).  ``users_sorted`` as in ``chunk_update``."""
    kw = dict(n_valid=n_valid, lr=lr, reg_u=reg_u, reg_i=reg_i, reg_j=reg_j,
              reg_b=reg_b, num_negatives=num_negatives, use_bias=use_bias,
              update_i=update_i, update_j=update_j,
              users_sorted=users_sorted)
    if P.device.type == "cpu":
        return chunk_delta_plain(P, Q, Qb, dP, dQ, dQb, users, positives,
                                 negatives, **kw)
    dev, N, d = _check_chunk(P, Q, Qb, users, positives, negatives,
                             num_negatives)
    for name, t, like in (("dP", dP, P), ("dQ", dQ, Q), ("dQb", dQb, Qb)):
        _check(name, t, torch.float32, dev, like.dim())
        if t.shape != like.shape:
            raise ValueError(f"{name} must have the shape of its table")
    U, I = P.shape[0], Q.shape[0]
    ws_i, ws_f = _workspace(dev, N, num_negatives, U, I, d)
    rc = _kernel("bpr_delta")(
        _ptr(users), _ptr(positives), _ptr(negatives), _ptr(P), _ptr(Q),
        _ptr(Qb), N, num_negatives, int(max(0, min(n_valid, N))), U, I, d,
        float(lr), float(reg_u), float(reg_i), float(reg_j), float(reg_b),
        int(bool(use_bias)), int(bool(update_i)), int(bool(update_j)),
        _ptr(dP), _ptr(dQ), _ptr(dQb), int(bool(users_sorted)), _ptr(ws_i),
        _ptr(ws_f), _stream(dev))
    _raise_on(rc, "chunk_delta")
    chunk_delta.launches += 1
    return ws_i, ws_f, N, num_negatives, U, I, d


chunk_delta.launches = 0


def chunk_bias_neg_delta(handle, Qb, dQb, *, lr, reg_b):
    """K9, the delta path's second launch: the negative side's bias step
    of the chunk that ``chunk_delta`` returned ``handle`` for, from Qb as
    it stands (after the positive side's reduced delta), added into dQb."""
    if Qb.device.type == "cpu":
        return chunk_bias_neg_delta_plain(handle, Qb, dQb, lr=lr,
                                          reg_b=reg_b)
    ws_i, ws_f, N, neg_per, U, I, d = handle
    dev = Qb.device
    for name, t in (("Qb", Qb), ("dQb", dQb)):
        _check(name, t, torch.float32, dev, 1)
        if t.shape[0] != I:
            raise ValueError(f"{name} must have one entry per item")
    rc = _kernel("bpr_delta_bias_neg")(
        N, neg_per, U, I, d, float(lr), float(reg_b), _ptr(Qb), _ptr(dQb),
        _ptr(ws_i), _ptr(ws_f), _stream(dev))
    _raise_on(rc, "chunk_bias_neg_delta")
    chunk_bias_neg_delta.launches += 1


chunk_bias_neg_delta.launches = 0


def triplet_loss(P, Q, Qb, users, positives, negatives, *, use_bias):
    """K9, loss: mean log(1 + exp(-x)) over fixed (u, i, j) triplets in one
    ordered reduction, a 0-d float32 tensor (``bpr_loss`` :859)."""
    if P.device.type == "cpu":
        return triplet_loss_plain(P, Q, Qb, users, positives, negatives,
                                  use_bias=use_bias)
    dev, n, d = _check_chunk(P, Q, Qb, users, positives, negatives, 1)
    out = torch.empty((), dtype=torch.float32, device=dev)
    rc = _kernel("bpr_loss")(
        _ptr(users), _ptr(positives), _ptr(negatives), _ptr(P), _ptr(Q),
        _ptr(Qb), n, d, int(bool(use_bias)), _ptr(out), _stream(dev))
    _raise_on(rc, "triplet_loss")
    triplet_loss.launches += 1
    return out


triplet_loss.launches = 0


def deferred_update(param, grad, m, v, counts, *, step, optimizer, lr, beta1,
                    beta2, reg, per_coordinate_normalize, project=False):
    """K10: the epoch barrier's optimizer step on one table, in place (see
    ``deferred_update_plain``).  Replaces ``apply_deferred_update`` :315,
    ``adam_update`` :295, ``adagrad_update`` :305 and ``bpr_epoch``'s
    inline step :579-597; with ``project`` (a (rows, d) table) also
    ``warp_kernels.py`` ``project_unit_ball`` :498.  ``m`` is unused (may
    be None) for adagrad; ``counts`` is read only with
    ``per_coordinate_normalize``."""
    if optimizer not in ("adam", "adagrad"):
        raise ValueError(f"deferred optimizer must be adam or adagrad, got "
                         f"{optimizer!r}")
    kw = dict(step=step, optimizer=optimizer, lr=lr, beta1=beta1,
              beta2=beta2, reg=reg,
              per_coordinate_normalize=per_coordinate_normalize,
              project=project)
    if param.device.type == "cpu":
        return deferred_update_plain(param, grad, m, v, counts, **kw)
    dev = param.device
    nd = param.dim()
    if nd not in (1, 2) or (project and nd != 2):
        raise ValueError("param must be a table (rows, d) or a vector (no "
                         "projection)")
    adam = optimizer == "adam"
    for name, t in (("param", param), ("grad", grad), ("v", v)) + (
            (("m", m),) if adam else ()):
        _check(name, t, torch.float32, dev, nd)
        if t.shape != param.shape:
            raise ValueError(f"{name} must have the shape of param")
    rows = param.shape[0]
    width = param.shape[1] if nd == 2 else 1
    if per_coordinate_normalize:
        _check("counts", counts, torch.float32, dev, 1)
        if counts.shape[0] != rows:
            raise ValueError("counts must have one entry per row")
    c1, c2 = _bias_corrections(optimizer, step, beta1, beta2)
    rc = _kernel("bpr_optimizer")(
        _ptr(param), _ptr(grad), _ptr(m if adam else None), _ptr(v),
        _ptr(counts if per_coordinate_normalize else None), rows * width,
        width, int(adam), float(lr), float(beta1), float(beta2),
        1.0 - beta1, 1.0 - beta2, float(c1), float(c2), float(reg),
        int(bool(project)), _stream(dev))
    _raise_on(rc, "deferred_update")
    deferred_update.launches += 1


deferred_update.launches = 0

def capped_add(param, delta, *, cap):
    """K10, capped add: ``param += clip_row_norm(delta, cap)`` in place,
    per row of a table or per element of a vector (see
    ``capped_add_plain``); the sgd mesh epoch's apply of a reduced delta
    (``bpr_epoch_dp`` :823-846)."""
    if param.device.type == "cpu":
        return capped_add_plain(param, delta, float(cap))
    dev = param.device
    nd = param.dim()
    if nd not in (1, 2):
        raise ValueError("param must be a table (rows, d) or a vector")
    for name, t in (("param", param), ("delta", delta)):
        _check(name, t, torch.float32, dev, nd)
    if delta.shape != param.shape:
        raise ValueError("delta must have the shape of param")
    if cap < 0:
        raise ValueError(f"cap must be >= 0, got {cap}")
    width = param.shape[1] if nd == 2 else 1
    rc = _kernel("bpr_capped_add")(_ptr(param), _ptr(delta), param.numel(),
                                   width, float(cap), int(nd == 1),
                                   _stream(dev))
    _raise_on(rc, "capped_add")
    capped_add.launches += 1


capped_add.launches = 0


KERNELS = (sample_negatives, chunk_update, chunk_accumulate, chunk_delta,
           chunk_bias_neg_delta, triplet_loss, deferred_update, capped_add)


# -------------------------------------------------------- composed steps
def sgd_lr(lr, min_lr, step, num_valid, cidx, N, total_samples):
    """The resident epoch's decayed rate for chunk ``cidx`` of epoch
    ``step``, in float32 as the reference's scan computes it
    (``sgd_kernels.py:606-608``)."""
    f = np.float32
    progress = (f(step) * f(num_valid) + f(cidx) * f(N)) / f(total_samples)
    return float(max(f(lr) - (f(lr) - f(min_lr)) * progress, f(min_lr)))


def bpr_sgd_step(P, Q, Qb, users, positives, negatives, lr, *, num_negatives,
                 use_bias, update_i, update_j, reg_u, reg_i, reg_j, reg_b,
                 max_step_norm=0.0):
    """The streaming path's sgd megabatch (``bpr_sgd_step`` :390) on
    drawn negatives: every slot real, P, Q and Qb updated in place."""
    chunk_update(P, Q, Qb, users, positives, negatives, n_valid=users.shape[0],
                 lr=lr, reg_u=reg_u, reg_i=reg_i, reg_j=reg_j, reg_b=reg_b,
                 max_step_norm=max_step_norm, num_negatives=num_negatives,
                 use_bias=use_bias, update_i=update_i, update_j=update_j)


def bpr_accumulate_step(P, Q, Qb, gP, gQ, gQb, cP, cQ, users, positives,
                        negatives, *, num_negatives, use_bias, update_i,
                        update_j, per_coordinate_normalize):
    """The streaming path's deferred megabatch (``bpr_accumulate_step``
    :355) on drawn negatives, every slot real."""
    chunk_accumulate(P, Q, Qb, gP, gQ, gQb, cP, cQ, users, positives,
                     negatives, n_valid=users.shape[0],
                     num_negatives=num_negatives, use_bias=use_bias,
                     update_i=update_i, update_j=update_j,
                     per_coordinate_normalize=per_coordinate_normalize)


def apply_deferred_update(param, grad, m, v, counts, step, *, optimizer, lr,
                          beta1, beta2, reg, per_coordinate_normalize):
    """The epoch barrier on one table (``apply_deferred_update`` :315),
    through K10, in place."""
    deferred_update(param, grad, m, v, counts, step=step,
                    optimizer=optimizer, lr=lr, beta1=beta1, beta2=beta2,
                    reg=reg,
                    per_coordinate_normalize=per_coordinate_normalize)


def bpr_loss(P, Q, Qb, users, positives, negatives, *, use_bias):
    """Mean log(1 + exp(-x_uij)) over fixed triplets (``bpr_loss`` :859)."""
    return triplet_loss(P, Q, Qb, users, positives, negatives,
                        use_bias=use_bias)


def new_opt_state(P, Q, Qb, use_bias):
    """Zeroed adam/adagrad moments of the three tables."""
    state = {"mP": torch.zeros_like(P), "vP": torch.zeros_like(P),
             "mQ": torch.zeros_like(Q), "vQ": torch.zeros_like(Q)}
    if use_bias:
        state["mQb"] = torch.zeros_like(Qb)
        state["vQb"] = torch.zeros_like(Qb)
    return state


def apply_epoch_barrier(P, Q, Qb, grads, opt_state, step, *, optimizer, lr,
                        beta1, beta2, reg_u, reg_i, reg_b, use_bias,
                        per_coordinate_normalize):
    """The deferred step on P, Q and (with the bias) Qb from the epoch's
    accumulators ``grads`` = (gP, gQ, gQb, cP, cQ); Qb is normalized by
    the item counts, as in the reference."""
    gP, gQ, gQb, cP, cQ = grads
    kw = dict(optimizer=optimizer, lr=lr, beta1=beta1, beta2=beta2,
              per_coordinate_normalize=per_coordinate_normalize)
    apply_deferred_update(P, gP, opt_state["mP"], opt_state["vP"], cP, step,
                          reg=reg_u, **kw)
    apply_deferred_update(Q, gQ, opt_state["mQ"], opt_state["vQ"], cQ, step,
                          reg=reg_i, **kw)
    if use_bias:
        apply_deferred_update(Qb, gQb, opt_state["mQb"], opt_state["vQb"],
                              cQ, step, reg=reg_b, **kw)


def new_accumulators(P, Q, Qb):
    """(gP, gQ, gQb, cP, cQ), zeroed."""
    return (torch.zeros_like(P), torch.zeros_like(Q), torch.zeros_like(Qb),
            torch.zeros(P.shape[0], dtype=torch.float32, device=P.device),
            torch.zeros(Q.shape[0], dtype=torch.float32, device=Q.device))


# ------------------------------------------------------------- the mesh
def replica_shards(mesh):
    """{device: index of its first local shard}: the replicas of a table
    the dp epochs keep, one per local device, in shard order."""
    out = {}
    for k, dev in enumerate(mesh.devices):
        out.setdefault(dev, k)
    return out


def shard_slots(mesh, k, N_loc, num_valid, c, N):
    """(slot_offset, n_valid) of local shard k's part of chunk c: its first
    global slot within the chunk, and its real slots (the global slots
    below ``num_valid``, ``bpr_epoch_dp`` :704-706)."""
    off = mesh.shards[k] * N_loc
    return off, max(0, min(N_loc, num_valid - c * N - off))


def reduced(mesh, parts):
    """The sum over the mesh of ``parts`` (one tensor per local shard):
    one tensor per local shard, each on its shard's device; a single
    shard's own tensor, unchanged."""
    if mesh.size == 1:
        return list(parts)
    from buffalo_tpu_torch.parallelism import all_reduce_sum
    return all_reduce_sum(mesh, parts)


def bpr_epoch(mesh, tables, opt_states, users, positives, step, *, seed,
              sampling, optimizer, num_items, num_negatives, use_bias,
              update_i, update_j, per_coordinate_normalize, lr, min_lr,
              beta1, beta2, reg_u, reg_i, reg_j, reg_b, num_valid,
              total_samples, max_step_norm=0.0):
    """One resident BPR epoch (``bpr_epoch`` :482, and ``bpr_epoch_dp``
    :664 on a mesh): the positives in CSR order as (nchunks, N) chunks,
    entries from ``num_valid`` on padding, split on the batch axis over
    the mesh's shards (one device is a mesh of one shard), the tables
    replicated.  ``tables`` {device: (P, Q, Qb)} and ``opt_states``
    {device: moments} hold one replica per local device; ``users`` /
    ``positives`` one (nchunks, N / mesh.size) int32 tensor per local
    shard, on its device; ``sampling`` {device: K8's keywords (bloom,
    bloom_log2, alias, pos_indptr, pos_keys)}.

    Per chunk each shard draws its slice of the single device's negatives
    (K8 at its slot offset).  sgd on one shard: K9 applies the step with
    the decayed rate and the row cap.  sgd on a mesh: K9 adds each shard's
    terms into dense deltas, which are all-reduced and applied by K10's
    capped add on every replica: the positive side of the bias, then (K9's
    second launch, from the updated Qb) the negative side, then P and Q,
    so the cap sees the reduced delta.  adam / adagrad accumulate per
    shard (K9) and reduce the gradients and counts once, at the barrier
    (K10 on every replica).  The tables are updated in place."""
    devs = mesh.devices
    reps = replica_shards(mesh)
    nchunks, N_loc = users[0].shape
    N = N_loc * mesh.size
    # the chunks are in CSR order: users[:n_valid] ascend on every shard
    rows = dict(num_negatives=num_negatives, use_bias=use_bias,
                update_i=update_i, update_j=update_j, users_sorted=True)

    def draw(k, c):
        off, n_valid = shard_slots(mesh, k, N_loc, num_valid, c, N)
        neg, drawn = sample_negatives(
            users[k][c], num_items, num_negatives=num_negatives, seed=seed,
            epoch=step, chunk=c, slot_offset=off, **sampling[devs[k]])
        return neg, positives[k][c] if drawn is None else drawn, n_valid

    if optimizer != "sgd":
        grads = [new_accumulators(*tables[dev]) for dev in devs]
        for c in range(nchunks):
            for k, dev in enumerate(devs):
                neg, pos, n_valid = draw(k, c)
                chunk_accumulate(
                    *tables[dev], *grads[k], users[k][c], pos, neg,
                    n_valid=n_valid,
                    per_coordinate_normalize=per_coordinate_normalize, **rows)
        total = [reduced(mesh, [g[i] for g in grads]) for i in range(5)]
        for dev, k in reps.items():
            apply_epoch_barrier(
                *tables[dev], [t[k] for t in total], opt_states[dev], step,
                optimizer=optimizer, lr=lr, beta1=beta1, beta2=beta2,
                reg_u=reg_u, reg_i=reg_i, reg_b=reg_b, use_bias=use_bias,
                per_coordinate_normalize=per_coordinate_normalize)
        return

    regs = dict(reg_u=reg_u, reg_i=reg_i, reg_j=reg_j, reg_b=reg_b)
    if mesh.size == 1:
        for c in range(nchunks):
            neg, pos, n_valid = draw(0, c)
            chunk_update(*tables[devs[0]], users[0][c], pos, neg,
                         n_valid=n_valid,
                         lr=sgd_lr(lr, min_lr, step, num_valid, c, N,
                                   total_samples),
                         max_step_norm=max_step_norm, **regs, **rows)
        return

    cap = float(max_step_norm)
    deltas = [tuple(torch.zeros_like(t) for t in tables[dev]) for dev in devs]

    def apply(i):
        total = reduced(mesh, [dl[i] for dl in deltas])
        for dev, k in reps.items():
            capped_add(tables[dev][i], total[k], cap=cap)

    for c in range(nchunks):
        lr_c = sgd_lr(lr, min_lr, step, num_valid, c, N, total_samples)
        handles = []
        for k, dev in enumerate(devs):
            for t in deltas[k]:
                t.zero_()
            neg, pos, n_valid = draw(k, c)
            handles.append(chunk_delta(
                *tables[dev], *deltas[k], users[k][c], pos, neg,
                n_valid=n_valid, lr=lr_c, **regs, **rows))
        if use_bias and update_i:
            apply(2)
        if use_bias and update_j:
            for k, dev in enumerate(devs):
                deltas[k][2].zero_()
                chunk_bias_neg_delta(handles[k], tables[dev][2],
                                     deltas[k][2], lr=lr_c, reg_b=reg_b)
            apply(2)
        apply(0)
        apply(1)
