"""Scoring + top-k retrieval ops (one device).

PyTorch counterpart of ``buffalo_tpu.ops.topk``'s single-device functions.
``batch_topn`` scores every query against the whole table through K5
(``ops/retrieval_kernels.score_topk``), which never writes the (chunk x N)
score matrix: on the card one launch takes the real queries and the
staged table, whatever their sizes and widths, for k <= 1024; past
that (``k5_route``) query chunks of ``torch.matmul`` scores, each at
most 1 GiB, go through ``ordered_topk``, as ``matmul_topk`` does.  On the
CPU the plain versions run as the reference does: query chunks bucketed
(``_chunked_topn``) and, past the score-matrix gate, the catalog in item
tiles (``_chunked_topn_tiled``, a per-tile top-k with a concat + top-k
merge).
``matmul_topk`` and ``topk`` (any k up to the catalog, the validation's
``topk + max_seen``) order entries as ``lax.top_k`` does: score
descending, ties to the smaller index, rows always sorted.  On the card
``matmul_topk`` goes through K5 for k <= 1024 (any width), and past
that through ``torch.matmul`` + ``retrieval_kernels.ordered_topk`` (a
selection on distinct int64 keys); ``topk`` selects with
``ordered_topk``.  The sharded variants (``sharded_matmul_topk``,
``batch_topn_sharded``) score a row-sharded table over a device mesh
(``parallelism``): each shard takes its own top-k (K5, or the matmul
route past its limits) with global ids, the candidates are all-gathered
and K22 (``retrieval_kernels.sharded_topk_merge``) merges them.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from buffalo_tpu_torch.ops.retrieval_kernels import (MAX_K, ordered_topk,
                                                     score_topk,
                                                     sharded_topk_merge,
                                                     tiled_topk_plain)
from buffalo_tpu_torch.utils import resolve_device


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(
        device)


def k5_route(k: int, d: int) -> bool:
    """Whether a top-k of k entries over rows of d floats goes through K5
    on the card: k <= 1024, at any width; past that the card scores with
    ``torch.matmul`` and selects with ``ordered_topk``."""
    return k <= MAX_K


# the largest (queries x items) float32 score block of the matmul route
_MATMUL_SCORES_BYTES = 1 << 30


def matmul_topn(p, Q, k: int, Qb=None):
    """The route past K5's limits: ``p @ Q^T (+ Qb)`` in query chunks of
    at most 1 GiB of scores, each selected by ``ordered_topk`` (score
    descending, ties to the smaller index).  (vals, idx) (B, k)."""
    rows = max(1, _MATMUL_SCORES_BYTES // (4 * max(Q.shape[0], 1)))
    vals, idx = [], []
    for r0 in range(0, p.shape[0], rows):
        s = torch.matmul(p[r0:r0 + rows].float(), Q.T)
        if Qb is not None:
            s = s + Qb[None, :]
        v, i = ordered_topk(s, k)
        vals.append(v)
        idx.append(i)
    return torch.cat(vals), torch.cat(idx)


def matmul_topk(p, Q, k: int, pb=None, Qb=None, device="cuda"):
    """scores = p @ Q^T (+ biases) then top-k.  p: (B, d), Q: (N, d).

    ``k`` is clamped to the candidate count (``topk.py:47-50``): a
    validation request of ``topk + max_seen`` can exceed a small
    catalog.  Rows are sorted by score descending, ties to the smaller
    index, as ``lax.top_k``.  K5 scores ``p @ Q^T + Qb`` on the card
    (k <= 1024) and its plain version on the CPU; ``pb`` is
    added to the selected scores, since a per-row shift leaves a row's
    order unchanged.  Returns (scores (B, k) float32, indices (B, k)
    int32) on ``device``.
    """
    device = resolve_device(device)
    p = _as_tensor(p, device)
    Q = _as_tensor(Q, device)
    if Qb is not None:
        Qb = _as_tensor(Qb, device)
    k = min(k, Q.shape[0])
    if device.type == "cpu" or k5_route(k, Q.shape[1]):
        vals, idx = score_topk(p, Q, k, Qb)
    else:
        vals, idx = matmul_topn(p, Q, k, Qb)
    if pb is not None:
        vals = vals + _as_tensor(pb, device)[:, None]
    return vals, idx


_stage_cache = None  # lazy OrderedDict[key -> (host array, device tensor)]


def _fingerprint(arr: np.ndarray) -> bytes:
    """Exact positional checksum reading every element once: the raw
    buffer split into 64 contiguous int64-word ranges, each
    wrap-around-summed (tail bytes into the last chunk), as the reference's
    (``topk.py:62``).  Any in-place bit change lands in some chunk's sum;
    only an exact same-chunk cancellation escapes.  The OpenMP
    ``checksum_native`` runs at memory bandwidth; the numpy pass below
    gives the same sums on one thread, where that library is missing."""
    from buffalo_tpu_torch.data.native import checksum_native

    a = np.ascontiguousarray(arr)
    sums = checksum_native(a)
    if sums is not None:
        return sums.tobytes()
    b = a.reshape(-1).view(np.uint8)
    n = b.shape[0]
    words = b[: (n // 8) * 8].view(np.uint64)
    out = np.zeros(64, dtype=np.uint64)
    n_words = words.shape[0]
    with np.errstate(over="ignore"):    # uint64 wrap IS the checksum
        if n_words >= 64:
            per = n_words // 64
            out += words[: per * 64].reshape(64, per).sum(
                axis=1, dtype=np.uint64)
            out[63] += words[per * 64:].sum(dtype=np.uint64)
        elif n_words:
            out[63] += words.sum(dtype=np.uint64)
        tail = b[(n // 8) * 8:]
        if tail.shape[0]:
            out[63] += tail.sum(dtype=np.uint64)
    return out.tobytes()


def _stage(arr: np.ndarray, device) -> torch.Tensor:
    """``arr`` on ``device``, through a 4-slot LRU of staged tables.

    Retrieval is called again and again against the same factor table,
    and uploading a multi-100 MB table costs more than K5's scan of it.
    The key is (buffer address, shape, dtype, full positional checksum,
    device): an in-place write (e.g. ``Algo.normalize``) changes the
    checksum and re-stages.  The entry keeps the host array referenced,
    so its address cannot be recycled while the key lives.
    """
    global _stage_cache
    if _stage_cache is None:
        _stage_cache = OrderedDict()
    key = (arr.__array_interface__["data"][0], arr.shape, arr.dtype.str,
           _fingerprint(arr), str(device))
    hit = _stage_cache.get(key)
    if hit is not None:
        _stage_cache.move_to_end(key)
        return hit[1]
    staged = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    _stage_cache[key] = (arr, staged)
    while len(_stage_cache) > 4:        # bound device-memory footprint
        _stage_cache.popitem(last=False)
    return staged


def _bucket_chunk_count(nc: int) -> int:
    """Round a chunk count up to a bounded grid: exact through 8, then
    ~1.25-geometric multiples of 4 (8, 12, 16, 20, 24, 32, 40, ...), as
    the reference (``topk.py:131``), whose jit compiles one scan length
    per value; the padding waste stays under ~25%."""
    if nc <= 8:
        return nc
    b = 8
    while b < nc:
        b = max(b + 4, -(-int(b * 1.25) // 4) * 4)
    return b


def _bucketed_chunks(p: np.ndarray, chunk: int) -> np.ndarray:
    """Pad queries into (nc_pad, chunk, d) blocks with the chunk count
    bucketed (see ``_bucket_chunk_count``)."""
    B, d = p.shape
    nc_pad = _bucket_chunk_count(max(1, -(-B // chunk)))
    p_pad = np.zeros((nc_pad * chunk, d), dtype=np.float32)
    p_pad[:B] = p
    return p_pad.reshape(nc_pad, chunk, d)


def _assemble_topn(vals, idx, B: int, topk: int, k_eff: int):
    """(nc, chunk, k_eff) results -> (B, topk) -1/0-padded numpy."""
    out_keys = np.full((B, topk), -1, dtype=np.int32)
    out_scores = np.zeros((B, topk), dtype=np.float32)
    out_keys[:, :k_eff] = np.asarray(idx).reshape(-1, k_eff)[:B]
    out_scores[:, :k_eff] = np.asarray(vals).reshape(-1, k_eff)[:B]
    return out_keys, out_scores


def _chunked_topn(p_chunks, Q, Qb, *, k):
    """Top-k of every query chunk against the whole table: one K5 call
    over all chunks (``topk.py:171`` scans them under one ``lax.scan``),
    or on the card past K5's limits the matmul route."""
    nc, chunk, d = p_chunks.shape
    p = p_chunks.reshape(nc * chunk, d)
    if p.device.type == "cuda" and not k5_route(k, d):
        vals, idx = matmul_topn(p, Q, k, Qb)
    else:
        vals, idx = score_topk(p, Q, k, Qb)
    return vals.reshape(nc, chunk, k), idx.reshape(nc, chunk, k)


# on the CPU, the plain versions' (chunk, n_items) score matrix past this
# many bytes takes the tiled path below, as the reference's memory gate
# (``topk.py:191``); K5 never writes that matrix, so the card has no gate
_FLAT_SCORES_BYTES = 8 << 30


def _chunked_topn_tiled(p_chunks, Q_tiles, Qb_tiles, *, k):
    """Catalog-axis tiled variant (``topk.py:195``), the plain version
    only: ``Q_tiles`` (ntiles, tile, d), ``Qb_tiles`` -inf on padding rows
    so they never enter the top-k; a running top-k merged per tile."""
    nc, chunk, d = p_chunks.shape
    vals, idx = tiled_topk_plain(p_chunks.reshape(nc * chunk, d), Q_tiles,
                                 Qb_tiles, k)
    return vals.reshape(nc, chunk, k), idx.reshape(nc, chunk, k)


def _dtype_name(query_dtype) -> str:
    """"float32" or "bfloat16" for a query dtype given as a name, a numpy
    or ``ml_dtypes`` type, or a torch dtype (None: float32)."""
    if query_dtype is None:
        return "float32"
    name = query_dtype if isinstance(query_dtype, str) else (
        getattr(query_dtype, "__name__", None)
        or getattr(query_dtype, "name", None)
        or str(query_dtype).replace("torch.", ""))
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"query_dtype must be float32 or bfloat16, got "
                         f"{query_dtype}")
    return name


def batch_topn(p, Q, topk: int, pool=None, Qb=None, chunk: int = 2048,
               approx: bool = False, query_dtype=None, device="cuda"):
    """Bulk MIPS retrieval: top-k of ``p @ Q^T (+ Qb)`` per query row.

    The counterpart of the reference's ``batch_topn`` (``topk.py:238``).
    On the card K5 scores the B queries against the whole table in one
    launch (past k = 1024, ``k5_route``, the matmul route
    instead): it never writes the score matrix, so ``chunk`` and the
    catalog-tiled path only bound the plain versions' memory on the CPU,
    where queries are padded into (chunk, d) blocks whose count is
    bucketed, as the reference's.  A ``pool`` restricts the candidates
    (indices are mapped back); results are ``-1`` / ``0``-padded when the
    pool (or catalog) is smaller than ``topk``, and an empty pool yields
    padding only.  The full table is staged through a 4-slot LRU
    (``_stage``); pool-sliced tables and biases are per-call temporaries
    and are not cached.

    ``approx=True`` keeps exact selection: the reference's
    ``lax.approx_max_k`` is a TPU partial reduction (exact on its CPU
    backend too), which the card has no counterpart of.
    ``query_dtype="bfloat16"`` rounds the queries to bfloat16 on the host
    (round to nearest even, as ``ml_dtypes``) and uploads them at half
    width; scores still accumulate in float32.

    The CPU's tiled path is gated, as in the reference, on the plain
    versions' score matrix of one chunk, but with the chunk cut to the
    real query count (the reference gates on the nominal chunk, ROADMAP
    queue 3).

    Returns (keys int32[B, topk], scores float32[B, topk]).
    """
    device = resolve_device(device)
    p = np.ascontiguousarray(np.asarray(p, dtype=np.float32))
    Q = np.asarray(Q, dtype=np.float32)
    B, d = p.shape
    padding = (np.full((B, topk), -1, dtype=np.int32),
               np.zeros((B, topk), dtype=np.float32))
    if pool is not None:
        if len(pool) == 0:
            # an empty candidate set yields no recommendations, NOT the
            # full catalog
            return padding
        Q = Q[pool]
        if Qb is not None:
            Qb = np.asarray(Qb)[pool]
    n_items = Q.shape[0]
    k_eff = min(topk, n_items)
    if k_eff <= 0 or B == 0:
        return padding
    with_bias = Qb is not None
    on_cpu = device.type == "cpu"
    chunk = max(1, min(chunk, B))

    chunks = torch.from_numpy(_bucketed_chunks(p, chunk) if on_cpu
                              else p[None])
    if _dtype_name(query_dtype) == "bfloat16":
        chunks = chunks.to(torch.bfloat16)
    chunks = chunks.to(device)
    if on_cpu and chunk * n_items * 4 > _FLAT_SCORES_BYTES:
        # multi-million-item catalogs: tile the item axis so the plain
        # version's (chunk, tile) scores fit
        tile = max(1, _FLAT_SCORES_BYTES // (chunk * 4))
        tile = min(n_items, -(-tile // 1024) * 1024)
        ntiles = -(-n_items // tile)
        Q_t = np.zeros((ntiles * tile, d), np.float32)
        Q_t[:n_items] = Q
        Qb_t = np.full(ntiles * tile, -np.inf, np.float32)
        Qb_t[:n_items] = np.asarray(Qb, np.float32) if with_bias else 0.0
        vals, idx = _chunked_topn_tiled(
            chunks, torch.from_numpy(Q_t.reshape(ntiles, tile, d)),
            torch.from_numpy(Qb_t.reshape(ntiles, tile)), k=k_eff)
    else:
        # cache only the caller's stable full table: pool-sliced tables
        # and biases would churn the LRU with dead addresses
        Q_d = _stage(Q, device) if pool is None else \
            torch.from_numpy(np.ascontiguousarray(Q)).to(device)
        Qb_d = torch.from_numpy(np.ascontiguousarray(
            Qb, dtype=np.float32)).to(device) if with_bias else None
        vals, idx = _chunked_topn(chunks, Q_d, Qb_d, k=k_eff)
    out_keys, out_scores = _assemble_topn(vals.cpu().numpy(),
                                          idx.cpu().numpy(), B, topk, k_eff)
    if pool is not None:
        mapped = np.asarray(pool)[np.maximum(out_keys, 0)]
        out_keys = np.where(out_keys >= 0, mapped, -1).astype(np.int32)
    return out_keys, out_scores


def sharded_matmul_topk(p, Q, Qb, k: int, *, mesh):
    """Distributed MIPS top-k (``sharded_matmul_topk``, ``topk.py:330``):
    ``Q`` / ``Qb`` this process's row shards of a table padded to a
    multiple of the mesh size with bias -inf on the padding rows (lists,
    one tensor per local shard, S rows each); ``p`` (B, d) the queries.
    Each shard keeps its top ``min(k, S)`` of ``p @ Q_j^T + Qb_j`` with
    global indices (K5, or past its limits the matmul route), the
    (B, D, k_loc) candidates are all-gathered, and K22 merges them.
    Returns (scores (B, k') float32, indices (B, k') int32) on the mesh's
    first device, k' = min(k, D * k_loc)."""
    from buffalo_tpu_torch import parallelism as par

    S, d = Q[0].shape
    k_loc = min(int(k), S)
    on_dev = {}
    cands = []
    for g, q, qb in zip(mesh.shards, Q, Qb):
        pp = on_dev.setdefault(q.device, p.to(q.device))
        if q.device.type == "cuda" and not k5_route(k_loc, d):
            v, i = matmul_topn(pp, q, k_loc, qb)
        else:
            v, i = score_topk(pp, q, k_loc, qb)
        # one int32 block per shard: the scores' bits beside the ids
        cands.append(torch.stack([v.view(torch.int32), i + g * S],
                                 dim=-1)[None])
    c = par.all_gather_rows(mesh, cands, first_only=True)  # (D, B, kl, 2)
    c = c.permute(1, 0, 2, 3)
    vals = c[..., 0].contiguous().view(torch.float32)
    idx = c[..., 1].contiguous()
    return sharded_topk_merge(vals, idx, min(int(k), mesh.size * k_loc))


def _table_shards(mesh, Q_d, Qb_d):
    """Row shards of a staged (N, d) table and its bias, padded to a
    multiple of the mesh size with zero rows of bias -inf, on each
    shard's device."""
    N, d = Q_d.shape
    S = -(-N // mesh.size)
    Q, Qb = [], []
    for g, dev in zip(mesh.shards, mesh.devices):
        lo, hi = min(g * S, N), min((g + 1) * S, N)
        q, qb = Q_d[lo:hi], Qb_d[lo:hi]
        if hi - lo < S:
            q = torch.cat([q, q.new_zeros((S - (hi - lo), d))])
            qb = torch.cat([qb, qb.new_full((S - (hi - lo),),
                                            float("-inf"))])
        Q.append(q.to(dev).contiguous())
        Qb.append(qb.to(dev).contiguous())
    return Q, Qb


def batch_topn_sharded(p, Q, topk: int, mesh, Qb=None, chunk: int = 2048,
                       approx: bool = False, query_dtype=None):
    """Bulk sharded MIPS retrieval over a device mesh
    (``batch_topn_sharded``, ``topk.py:393``): the table staged once on
    the mesh's first device (``_stage``), row-sharded (padded to a mesh
    multiple with bias -inf), every query through
    ``sharded_matmul_topk``.  ``chunk`` and ``approx`` are accepted for
    the reference's signature (K5 needs no query chunks; selection stays
    exact, as in ``batch_topn``).  Returns (keys int32[B, topk],
    scores float32[B, topk]), -1 / 0-padded past the catalog."""
    dev0 = mesh.devices[0]
    p = np.ascontiguousarray(np.asarray(p, dtype=np.float32))
    Q = np.asarray(Q, dtype=np.float32)
    B = p.shape[0]
    n_items = Q.shape[0]
    k_eff = min(topk, n_items)
    if k_eff <= 0 or B == 0:
        return (np.full((B, topk), -1, dtype=np.int32),
                np.zeros((B, topk), dtype=np.float32))
    Q_d = _stage(Q, dev0)
    Qb_d = torch.zeros(n_items, device=dev0) if Qb is None else \
        _as_tensor(np.asarray(Qb, dtype=np.float32), dev0)
    Q_sh, Qb_sh = _table_shards(mesh, Q_d, Qb_d)
    q = torch.from_numpy(p)
    if _dtype_name(query_dtype) == "bfloat16":
        q = q.to(torch.bfloat16)
    vals, idx = sharded_matmul_topk(q.to(dev0), Q_sh, Qb_sh, k_eff,
                                    mesh=mesh)
    return _assemble_topn(vals.cpu().numpy(), idx.cpu().numpy(), B, topk,
                          k_eff)


def topk(scores, k: int, sorted: bool = True, num_threads: int = 0,
         device="cuda") -> np.ndarray:
    """Row-wise top-k indices of a host score matrix (quickselect analog).

    Keeps the reference's ``Evaluable.get_topk`` contract
    (``evaluate/base.py:31-42``); ``num_threads`` is accepted for API
    parity and ignored.  Selection runs on ``device`` with
    ``ordered_topk``: rows sorted by score descending, ties to the smaller
    index, as the reference's ``lax.top_k``, whether or not ``sorted`` is
    set.
    """
    scores = _as_tensor(scores, resolve_device(device))
    squeeze = scores.dim() == 1
    if squeeze:
        scores = scores[None, :]
    k = min(k, scores.shape[1])
    assert k > 0, f"k({k}) should be greater than 0"
    idx = ordered_topk(scores.contiguous(), k)[1].cpu().numpy()
    return idx[0] if squeeze else idx
