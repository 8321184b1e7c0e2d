"""Retrieval kernels: scoring + top-k selection and the k-means update.

Hand-written CUDA kernels on the card (``csrc/*.cu``), each beside its
plain PyTorch version (``*_plain``), as ``ops/als_kernels.py`` pairs
K1–K4 with theirs:

* **K5** ``score_topk`` — the k best (score, index) pairs of
  ``p @ Q^T (+ Qb)`` per row of p, never writing the score matrix; the
  scan of ``batch_topn`` (one launch, whatever the catalog's size) and
  the assignment steps of
  ``IVFIndex.build`` (k = 1 and k = spill).
* **K6** ``ivf_tile_topk`` — ``IVFIndex.search``'s tile scorer: per tile,
  gathered queries against a contiguous slice of the cell-ordered table,
  masked, top-kk; the tiles split by their rows (``ivf_tile_classes``)
  between a small form (a lane per row, for the few rows most probed cells
  hold) and the FFMA block scan K5 shares.
* **K7** ``kmeans_update`` — the spherical k-means cell update (member
  mean, normalized; empty cells keep their centroid).
* **K22** ``sharded_topk_merge`` — the merge of a row-sharded table's
  per-shard top-k lists (``ops.topk.sharded_matmul_topk``): the top k of
  the shard-major concatenation; for small k one warp per query, lane j
  holding shard j's head, for large k the lists staged in shared memory
  and merged in pairs by the whole block (``sharded_topk_merge_form``).

Selection everywhere orders entries by score descending, ties to the
smaller index, as ``lax.top_k`` and ``jnp.argmax`` do; ``torch.topk``
promises no order among ties, so the plain versions select on 64-bit keys
(the score's bits mapped to an ordered integer, then the index reversed),
which are distinct.  -inf is a valid, lowest score.  Rows of any width:
past 256 floats K5 and K6 stage the queries' features a chunk at a time,
K7 keeps its means in the output, and K7 past 58,112 cells and K22 past 32
shards take their global / shared-memory forms.  K5 and K6 select at most
k = 1024 (``NotImplementedError`` past it: ``ops/topk.py`` routes larger k
to ``torch.matmul`` + ``ordered_topk``).

Each wrapper runs its plain version for CPU tensors and launches its
kernel (or raises) for CUDA tensors; ``launches`` on each wrapper counts
the calls that launched it.
"""
from __future__ import annotations

import ctypes
from fractions import Fraction

import numpy as np
import torch

from buffalo_tpu_torch.ops.als_kernels import _check, _ptr, _raise_on, _stream

_P, _I32 = ctypes.c_void_p, ctypes.c_int
# C signatures of the launch functions (csrc/*.cu), each returning the
# cudaError_t of its launches
_SIGNATURES = {
    "score_topk": [_P, _I32, _P, _P, _I32, _I32, _I32, _I32, _I32, _I32, _P,
                   _P, _P, _P],
    "score_topk_tc_blocks": [_I32, _I32],
    "ivf_tile_topk": [_P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32,
                      _P, _I32, _I32, _P, _P, _P],
    "ivf_small_rows": [_I32, _I32, _I32],
    "kmeans_update": [_P, _P, _P, _I32, _I32, _I32, _I32, _P, _P, _P, _P],
    "kmeans_update_workspace": [_I32, _I32, _I32, _I32, _P],
    "sharded_topk_merge": [_P, _P, _I32, _I32, _I32, _I32, _P, _P, _P],
    "sharded_topk_merge_as": [_I32, _P, _P, _I32, _I32, _I32, _I32, _P, _P,
                              _P],
    "sharded_topk_merge_form": [_I32, _I32, _I32],
    "sharded_topk_merge_tree_fits": [_I32, _I32, _I32],
}
# launch functions kept in another kernel's library
_LIBRARY = {"score_topk_tc_blocks": "score_topk",
            "sharded_topk_merge_as": "sharded_topk_merge",
            "sharded_topk_merge_form": "sharded_topk_merge",
            "sharded_topk_merge_tree_fits": "sharded_topk_merge",
            "kmeans_update_workspace": "kmeans_update",
            "ivf_small_rows": "ivf_tile_topk"}
MAX_K = 1024
# IVF tile caps the kernel takes (the reference's largest, parallel/ann.py)
MAX_BQ_CAP, MAX_L_CAP = 256, 1024
# K6's small form (csrc/ivf_tile_topk.cu namespace small) takes the tiles of
# at most IVF_SMALL_MAX_L rows (fewer where its staging passes shared
# memory: ivf_small_rows) at kk <= 32 and d >= IVF_SMALL_MIN_D; the rest
# take the scan (at d = 13 the scan was the faster on the brunch searches'
# small tiles: its selection skips the keys under a slot's threshold, the
# small form sorts every key)
IVF_SMALL_MAX_L, IVF_SMALL_MIN_D = 64, 32
QUERY_DTYPES = (torch.float32, torch.bfloat16)
# K5's FFMA block shapes (csrc/topk_select.cuh Cfg): (list length KP,
# queries per block, items per tile) for k <= KP
_K5_SHAPES = ((32, 64, 128), (128, 32, 128), (1024, 8, 256))
# K5's tensor-core form (csrc/score_topk.cu namespace tc): k and d it
# takes, queries per block and items per tile; below TC_MIN_ITEMS items the
# FFMA form was as fast or faster on the card (the k-means assignment's
# 711 centroids; PERF.md §6)
TC_MAX_K, TC_MAX_D, TC_QB, TC_IT = 32, 256, 64, 64
TC_MIN_ITEMS = 2048
# K7 (csrc/kmeans_update.cu kChunk, kRun): rows per histogram and placement
# block, and members a run block sums at most
_K7_CHUNK, _K7_RUN = 512, 128
_U32 = 0xFFFFFFFF
_SIGN = 0x80000000


def _kernel(name: str):
    from buffalo_tpu_torch.ops._build import launcher

    return launcher(name, _SIGNATURES[name], library=_LIBRARY.get(name))


def _check_k(name, k):
    if k > MAX_K:
        raise NotImplementedError(
            f"{name} selects at most {MAX_K} entries per row, got k = {k} "
            "(ops/topk.py routes larger k to torch.matmul + ordered_topk)")


# ---------------------------------------------------------------- plain
def _keys(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """int64 keys ordered as (score descending, index ascending): a larger
    key is a better entry.  ``idx`` broadcasts against ``vals``."""
    b = vals.contiguous().view(torch.int32).to(torch.int64) & _U32
    o = torch.where(b >= _SIGN, _U32 - b, b | _SIGN)  # order-preserving
    return (o - _SIGN) * (1 << 32) + (_U32 - idx.to(torch.int64))


def _decode(keys: torch.Tensor):
    """(float32 scores, int32 indices) of ``_keys``' keys."""
    o = (keys >> 32) + _SIGN
    b = torch.where(o >= _SIGN, o - _SIGN, _U32 - o)
    b = torch.where(b >= _SIGN, b - (1 << 32), b).to(torch.int32)
    return b.view(torch.float32), (_U32 - (keys & _U32)).to(torch.int32)


def ordered_topk(scores: torch.Tensor, k: int):
    """Row-wise top-k of a score matrix by (score descending, column
    ascending), in row blocks that keep the int64 keys under 1 GiB:
    (values (B, k) float32, columns (B, k) int32)."""
    B, N = scores.shape
    cols = torch.arange(N, device=scores.device)[None, :]
    rb = max(1, (1 << 27) // max(N, 1))
    top = [torch.topk(_keys(scores[r0:r0 + rb], cols), k, dim=1).values
           for r0 in range(0, B, rb)]
    return _decode(torch.cat(top))


def merge_topk(vals: torch.Tensor, idx: torch.Tensor, k: int):
    """The k best of candidate (vals, idx) pairs per row, same order."""
    return _decode(torch.topk(_keys(vals, idx), k, dim=1).values)


def score_topk_plain(p, Q, k, Qb=None):
    """Plain version of K5: ``torch.matmul`` + ordered selection, in row
    blocks of at most 2^28 score bytes (the kernel never writes them).
    ``p`` is float32 or bfloat16 (read as float32, exactly)."""
    N = Q.shape[0]
    rb = max(1, (1 << 26) // max(N, 1))
    vals, idx = [], []
    for r0 in range(0, p.shape[0], rb):
        s = torch.matmul(p[r0:r0 + rb].float(), Q.T)
        if Qb is not None:
            s = s + Qb[None, :]
        v, i = ordered_topk(s, k)
        vals.append(v)
        idx.append(i)
    return torch.cat(vals), torch.cat(idx)


def tiled_topk_plain(p, Q_tiles, Qb_tiles, k):
    """Plain version of K5 on a catalog in item tiles (``_chunked_topn_
    tiled``, ``topk.py:195``): per tile the scores of every row of ``p``
    and their top-k, merged into the running top-k by one concat + ordered
    selection.  ``Qb_tiles`` is -inf on padding rows."""
    ntiles, tile, _ = Q_tiles.shape
    run = None
    for t in range(ntiles):
        v, i = score_topk_plain(p, Q_tiles[t], min(k, tile), Qb_tiles[t])
        i = i + t * tile
        if run is None:
            run = (v, i)
        else:
            run = merge_topk(torch.cat([run[0], v], 1),
                             torch.cat([run[1], i], 1), k)
    return run


def ivf_tile_topk_plain(queries, table, qidx, qmask, lo, ln, kk, l_cap):
    """Plain version of K6: ``_tiled_score`` (``parallel/ann.py:54``) in
    blocks of 256 tiles: gather each tile's queries and table rows
    ``[lo, lo + l_cap)`` (clamped to the table; columns past ``ln`` are
    masked), score, mask columns >= ln and masked query slots to -inf,
    ordered top-kk; positions are column + lo."""
    T, bq = qidx.shape
    cols = torch.arange(l_cap, device=queries.device)
    vals, pos = [], []
    for t0 in range(0, T, 256):
        q = qidx[t0:t0 + 256].long()
        lo_b, ln_b = lo[t0:t0 + 256].long(), ln[t0:t0 + 256].long()
        rows = (lo_b[:, None] + cols[None, :]).clamp(
            max=max(table.shape[0] - 1, 0))
        s = torch.bmm(queries[q], table[rows].transpose(1, 2))
        ok = (cols[None, None, :] < ln_b[:, None, None]) \
            & qmask[t0:t0 + 256, :, None]
        s = torch.where(ok, s, torch.full_like(s, float("-inf")))
        v, c = ordered_topk(s.reshape(-1, l_cap), kk)
        vals.append(v.reshape(-1, bq, kk))
        pos.append(c.reshape(-1, bq, kk) + lo[t0:t0 + 256, None, None])
    return torch.cat(vals), torch.cat(pos).to(torch.int32)


def ivf_small_rows(d, kk):
    """The most rows a tile may have for K6's small form at width ``d`` and
    ``kk`` (0: it takes none): IVF_SMALL_MAX_L, fewer where its staging
    passes shared memory (the C query of the same name, which builds the
    kernel), 0 below IVF_SMALL_MIN_D."""
    if d < IVF_SMALL_MIN_D:
        return 0
    return _kernel("ivf_small_rows")(int(d), int(kk), IVF_SMALL_MAX_L)


def ivf_tile_classes(ln, rows):
    """K6's split of the tiles by their rows ``ln`` (numpy): (the tiles of
    at most ``rows`` rows, for the small form; the rest, for the scan),
    each int32 in tile order.  Empty tiles are the small form's (it writes
    their padding without a read); ``rows`` 0 (``ivf_small_rows`` where
    the small form does not take kk and d) puts every tile in the scan."""
    ln = np.asarray(ln)
    small = (ln <= rows) if rows > 0 else np.zeros(ln.shape, dtype=bool)
    return (np.flatnonzero(small).astype(np.int32),
            np.flatnonzero(~small).astype(np.int32))


def kmeans_update_plain(unit, assign, cent):
    """Plain version of K7: ``lloyd``'s update (``parallel/ann.py:228-
    241``) with ``index_add_`` + ``bincount``: rows of zero norm weigh 0,
    the mean of each cell's rows, the old centroid where a cell has none,
    normalized with a 1e-12 floor."""
    C = cent.shape[0]
    w = ((unit * unit).sum(1) > 0).to(unit.dtype)
    a = assign.reshape(-1).long()
    sums = torch.zeros_like(cent).index_add_(0, a, unit * w[:, None])
    cnt = torch.bincount(a, weights=w, minlength=C).to(unit.dtype)
    new = torch.where(cnt[:, None] > 0,
                      sums / torch.clamp(cnt, min=1.0)[:, None], cent)
    norm = torch.linalg.vector_norm(new, dim=1, keepdim=True)
    return new / torch.clamp(norm, min=1e-12)


def kmeans_plan(N, D, C):
    """K7's launch plan for N rows of D floats in C cells: ``chunks`` (the
    histogram's and the placement's blocks, ``_K7_CHUNK`` rows each);
    ``run`` (the members a run block sums: at most ``_K7_RUN`` and the
    first power of two from twice the mean cell's rows, so that small cells
    take small blocks); ``run_blocks`` (N // run + C + 1: more than the runs
    of any assignment, each cell's last run possibly short, so at least one
    block writes the empty cells); the workspace's ``ints`` (four per run
    block, the chunks' histogram rows, five arrays per cell, a count per
    run block, the permutation and a counter) and ``floats`` (a sum of D
    per run block)."""
    mean = -(-N // max(C, 1))
    run = min(_K7_RUN, 1 << max(0, 2 * mean - 1).bit_length())
    chunks = -(-N // _K7_CHUNK)
    run_blocks = N // run + C + 1
    return dict(chunks=chunks, run=run, run_blocks=run_blocks,
                ints=5 * run_blocks + chunks * C + 4 * C + 2 + N + 1,
                floats=run_blocks * D)


# ------------------------------------------------------------- wrappers
def score_topk_form(k, d, n_items):
    """K5's form for k entries of n_items rows of d floats: "tc" (3xTF32
    ``mma.sync`` on the tensor cores) for k <= TC_MAX_K and d <= TC_MAX_D,
    which its 64 queries' lists and staged rows fit in shared memory, over
    at least TC_MIN_ITEMS items; else "ffma" (the float32 scan K6 shares:
    k up to 1024, rows of any width)."""
    return ("tc" if k <= TC_MAX_K and d <= TC_MAX_D
            and n_items >= TC_MIN_ITEMS else "ffma")


def _k5_splits(B, N, k, device):
    """K5's FFMA item splits: enough blocks for ~8 per SM, each split at
    least two item tiles, and S k-lists per query that the merge sorts in
    shared memory."""
    KP, QB, IT = next(s for s in _K5_SHAPES if k <= s[0])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = (8 * sms) // max(1, -(-B // QB))
    return max(1, min(want, -(-N // IT) // 2, 8192 // KP))


def tc_splits(query_blocks, tiles, resident, k):
    """The tensor-core form's item splits S: the blocks (query_blocks x S)
    fill ``resident`` blocks (the card's SMs x blocks per SM) in waves as
    whole as S from a wave's worth to four waves' can make them (the
    smaller S on a tie), with at least one item tile a split and S k-lists
    per query that the merge sorts in shared memory."""
    top = max(1, min(tiles, 16384 // k))
    lo = max(1, min(top, -(-resident // query_blocks)))

    def fill(S):  # exact: equal fills tie
        blocks = query_blocks * S
        return Fraction(blocks, -(-blocks // resident) * resident)
    return max(range(lo, min(top, 4 * lo) + 1),
               key=lambda S: (fill(S), -S))


_TC_BLOCKS = {}


def score_topk_shape(B, N, d, k, dtype, device):
    """(form, item splits) of K5's launch for B queries of ``dtype`` over
    N items of d floats at k."""
    form = score_topk_form(k, d, N)
    if form == "ffma":
        return form, _k5_splits(B, N, k, device)
    bf16 = int(dtype == torch.bfloat16)
    per_sm = _TC_BLOCKS.get((d, bf16))
    if per_sm is None:
        per_sm = _TC_BLOCKS[(d, bf16)] = _kernel("score_topk_tc_blocks")(
            d, bf16)
        if per_sm < 1:
            raise RuntimeError(f"K5's tensor-core form fits no block at "
                               f"d = {d}")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return form, tc_splits(-(-B // TC_QB), -(-N // TC_IT), per_sm * sms, k)


def score_topk(p, Q, k, Qb=None):
    """K5: fused score + top-k, (vals (B, k) float32, idx (B, k) int32)
    sorted by score descending, ties to the smaller index.

    Replaces ``_chunked_topn`` / ``_chunked_topn_tiled`` (``buffalo_tpu/
    ops/topk.py:171,195``) and ``IVFIndex.build``'s assignments
    (``parallel/ann.py:220,245``).  ``p`` (B, d) float32 or bfloat16, ``Q``
    (N, d) float32, ``Qb`` (N,) float32 or None; 1 <= k <= N.  The form
    is routed by shape (``score_topk_form``): the tensor cores take k <=
    32 at d <= 256 over at least 2,048 items (every ``batch_topn`` top-10
    and ALS / BPR / WARP top-10); larger k, whose 64 queries' lists do not
    fit beside the staged rows, wider rows, and catalogs of fewer items
    (the k-means assignments against 711 centroids, where the FFMA scan
    was as fast) take the FFMA scan.
    """
    if p.device.type == "cpu":
        return score_topk_plain(p, Q, k, Qb)
    dev = p.device
    if p.dtype not in QUERY_DTYPES:
        raise TypeError(f"p must be float32 or bfloat16, got {p.dtype}")
    _check("p", p, p.dtype, dev, 2)
    _check("Q", Q, torch.float32, dev, 2)
    (B, d), N = p.shape, Q.shape[0]
    if Q.shape[1] != d:
        raise ValueError(f"p is {d} wide, Q {Q.shape[1]}")
    if Qb is not None:
        _check("Qb", Qb, torch.float32, dev, 1)
        if Qb.shape[0] != N:
            raise ValueError(f"Qb has {Qb.shape[0]} entries for {N} items")
    if not 1 <= k <= N:
        raise ValueError(f"k = {k} outside [1, {N}]")
    _check_k("score_topk", k)
    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0:
        return vals, idx
    form, S = score_topk_shape(B, N, d, k, p.dtype, dev)
    part = torch.empty(S * B * k if S > 1 else 0, dtype=torch.int64,
                       device=dev)
    rc = _kernel("score_topk")(
        _ptr(p), int(p.dtype == torch.bfloat16), _ptr(Q), _ptr(Qb), B, N, d,
        int(k), S, int(form == "tc"), _ptr(part), _ptr(vals), _ptr(idx),
        _stream(dev))
    _raise_on(rc, "score_topk")
    score_topk.launches += 1
    return vals, idx


score_topk.launches = 0


def ivf_tile_topk(queries, table, qidx, qmask, lo, ln, kk, l_cap,
                  ln_host=None):
    """K6: the IVF tile scorer, (vals (T, bq_cap, kk) float32, pos (T,
    bq_cap, kk) int32): per tile t, ``queries[qidx[t]]`` against table
    rows ``[lo[t], lo[t] + ln[t])``, columns >= ln[t] and slots with
    ``qmask`` False at -inf, ordered top-kk, positions column + lo[t].

    Replaces ``_tiled_score`` (``buffalo_tpu/parallel/ann.py:54``).  No
    table row past ``lo[t] + ln[t]`` is read (``ln[t] <= l_cap``).  On the
    card ``ln_host``, the caller's host copy of ``ln``, is required: the
    tiles are split by ``ivf_tile_classes`` from it, with no device sync,
    and each class is launched on its own tile list: the small form and
    the scan.  ``launches`` counts the calls, ``small_launches`` and
    ``scan_launches`` each form's launches.
    """
    if queries.device.type == "cpu":
        return ivf_tile_topk_plain(queries, table, qidx, qmask, lo, ln, kk,
                                   l_cap)
    dev = queries.device
    _check("queries", queries, torch.float32, dev, 2)
    _check("table", table, torch.float32, dev, 2)
    _check("qidx", qidx, torch.int32, dev, 2)
    _check("qmask", qmask, torch.bool, dev, 2)
    _check("lo", lo, torch.int32, dev, 1)
    _check("ln", ln, torch.int32, dev, 1)
    T, bq = qidx.shape
    d = queries.shape[1]
    if table.shape[1] != d or tuple(qmask.shape) != (T, bq) \
            or lo.shape[0] != T or ln.shape[0] != T:
        raise ValueError("shape mismatch in ivf_tile_topk")
    if bq > MAX_BQ_CAP or l_cap > MAX_L_CAP:
        raise NotImplementedError(
            f"ivf_tile_topk takes tiles of at most {MAX_BQ_CAP} queries x "
            f"{MAX_L_CAP} rows, got {bq} x {l_cap}")
    if not 1 <= kk <= l_cap:
        raise ValueError(f"kk = {kk} outside [1, {l_cap}]")
    _check_k("ivf_tile_topk", kk)
    if ln_host is None:
        raise ValueError("ivf_tile_topk: ln_host (ln on the host) is "
                         "required on the card")
    ln_host = np.asarray(ln_host)
    if ln_host.shape != (T,):
        raise ValueError("ln_host disagrees with ln")
    small, scan = ivf_tile_classes(ln_host, ivf_small_rows(d, kk))
    vals = torch.empty((T, bq, kk), dtype=torch.float32, device=dev)
    pos = torch.empty((T, bq, kk), dtype=torch.int32, device=dev)
    tiles = torch.from_numpy(np.concatenate([small, scan])).to(dev)
    at = tiles.data_ptr()
    for form, ids in (("small", small), ("scan", scan)):
        if not len(ids):
            continue
        cap = max(1, int(ln_host[ids].max())) if form == "small" else 0
        rc = _kernel("ivf_tile_topk")(
            _ptr(queries), _ptr(table), _ptr(qidx), _ptr(qmask), _ptr(lo),
            _ptr(ln), T, bq, d, int(kk), int(form == "small"),
            ctypes.c_void_p(at), len(ids), cap, _ptr(vals), _ptr(pos),
            _stream(dev))
        _raise_on(rc, "ivf_tile_topk")
        at += 4 * len(ids)
        if form == "small":
            ivf_tile_topk.small_launches += 1
        else:
            ivf_tile_topk.scan_launches += 1
    ivf_tile_topk.launches += 1
    return vals, pos


ivf_tile_topk.launches = 0
ivf_tile_topk.small_launches = 0
ivf_tile_topk.scan_launches = 0


def kmeans_update(unit, assign, cent):
    """K7: the new centroids (C, D) from unit rows (N, D), their cells
    (N,) or (N, 1) int32 and the old centroids (C, D): the normalized mean
    of each cell's rows of nonzero norm, the old centroid where there are
    none.  Deterministic: no float atomics; a cell's members are summed in
    row order in runs (``kmeans_plan``), the runs' sums added in order.
    Four launches (a memset more past 58,112 cells); the table is read
    once.

    Replaces ``lloyd``'s segment sums and epilogue (``buffalo_tpu/parallel/
    ann.py:228-241``).
    """
    if unit.device.type == "cpu":
        return kmeans_update_plain(unit, assign, cent)
    dev = unit.device
    assign = assign.reshape(-1)
    _check("unit", unit, torch.float32, dev, 2)
    _check("assign", assign, torch.int32, dev, 1)
    _check("cent", cent, torch.float32, dev, 2)
    (N, D), C = unit.shape, cent.shape[0]
    if cent.shape[1] != D or assign.shape[0] != N:
        raise ValueError("shape mismatch in kmeans_update")
    plan = kmeans_plan(N, D, C)
    ws = torch.empty(plan["ints"], dtype=torch.int32, device=dev)
    part = torch.empty(plan["floats"], device=dev)
    out = torch.empty_like(cent)
    rc = _kernel("kmeans_update")(
        _ptr(unit), _ptr(assign), _ptr(cent), N, D, C, plan["run"], _ptr(ws),
        _ptr(part), _ptr(out), _stream(dev))
    _raise_on(rc, "kmeans_update")
    kmeans_update.launches += 1
    return out


kmeans_update.launches = 0

def sharded_topk_merge_plain(vals, idx, k):
    """Plain version of K22: ``merge_topk`` over the shard-major
    concatenation of the (B, D, kl) candidate lists."""
    B = vals.shape[0]
    return merge_topk(vals.reshape(B, -1), idx.reshape(B, -1), k)


MERGE_FORMS = ("warp", "tree")


def sharded_topk_merge_form(D, kl, k):
    """The form K22 takes for D lists of kl at this k on the card: "warp"
    (a warp per query, k serial steps) or "tree" (the lists merged in
    pairs by a block, each thread writing a run of outputs); a function of
    (D, kl, k) alone, from the crossover measured on the H100
    (``csrc/sharded_topk_merge.cu``)."""
    return MERGE_FORMS[_kernel("sharded_topk_merge_form")(D, kl, k)]


def sharded_topk_merge_tree_fits(D, kl, k):
    """Whether K22's tree form takes D lists of kl for the top k on the
    card: one query's lists fit in a block's shared memory."""
    return bool(_kernel("sharded_topk_merge_tree_fits")(D, kl, k))


def sharded_topk_merge(vals, idx, k, form=None):
    """K22: the top k of per-shard candidate lists, (vals (B, k) float32,
    idx (B, k) int32) by score descending, ties to the smaller index.

    ``vals`` (B, D, kl) float32 and ``idx`` (B, D, kl) int32: for each
    query, shard j's top kl with global indices, sorted in that order,
    every index of shard j below shard j+1's; D >= 1, 1 <= k <= D * kl.
    Replaces the all-gathered ``lax.top_k`` merge of
    ``sharded_matmul_topk`` (``buffalo_tpu/ops/topk.py:353-365``).
    ``form`` ("warp" or "tree") forces a form on the card (the tree form
    only where ``sharded_topk_merge_tree_fits``); by default
    ``sharded_topk_merge_form`` chooses.
    """
    if vals.device.type == "cpu":
        return sharded_topk_merge_plain(vals, idx, k)
    dev = vals.device
    _check("vals", vals, torch.float32, dev, 3)
    _check("idx", idx, torch.int32, dev, 3)
    B, D, kl = vals.shape
    if tuple(idx.shape) != (B, D, kl):
        raise ValueError(f"idx {tuple(idx.shape)} and vals {(B, D, kl)} "
                         "disagree")
    if D < 1:
        raise ValueError(f"sharded_topk_merge needs a shard, got D = {D}")
    if not 1 <= k <= D * kl:
        raise ValueError(f"k = {k} outside [1, {D * kl}]")
    if form is not None and form not in MERGE_FORMS:
        raise ValueError(f"form {form!r} is not one of {MERGE_FORMS}")
    if form == "tree" and not sharded_topk_merge_tree_fits(D, kl, k):
        raise ValueError(f"the tree form does not take {D} lists of {kl} "
                         f"at k = {k} (past a block's shared memory)")
    out_v = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    args = (_ptr(vals), _ptr(idx), B, D, kl, int(k), _ptr(out_v), _ptr(out_i),
            _stream(dev))
    rc = (_kernel("sharded_topk_merge")(*args) if form is None else
          _kernel("sharded_topk_merge_as")(MERGE_FORMS.index(form), *args))
    _raise_on(rc, "sharded_topk_merge")
    sharded_topk_merge.launches += 1
    return out_v, out_i


sharded_topk_merge.launches = 0

KERNELS = (score_topk, ivf_tile_topk, kmeans_update)
