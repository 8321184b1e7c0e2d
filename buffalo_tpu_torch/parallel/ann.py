"""Approximate nearest-neighbour retrieval: an IVF (inverted-file) index.

PyTorch counterpart of ``buffalo_tpu.parallel.ann``: spherical k-means
partitions the item vectors into ``n_clusters`` cells (Lloyd iterations:
the assignment by K5 at k = 1, the cell update by K7), and a query scores
only the members of its ``n_probe`` nearest cells (K6, tile by tile, then
a merge on the host).  Probing every cell is exact.  The host steps
(probes, tile construction, merge) are the reference's numpy, and the
``.npz`` files are the same, so each package loads the other's index.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from buffalo_tpu_torch.ops.retrieval_kernels import (ivf_tile_topk,
                                                     kmeans_update,
                                                     score_topk)
from buffalo_tpu_torch.utils import resolve_device

# Tile caps for the scorer (the reference's, ``ann.py:30``).  The inverted
# file is stored cell-major, so a (cell-range x query-chunk) tile scores
# queries against a contiguous slice of the table; the caps adapt to the
# cell and query-count distributions (see _pick_cap).
_BQ_CAPS = (64, 128, 256)     # queries per tile
_L_CAPS = (128, 256, 512, 1024)   # table rows per tile


def _pick_cap(lens: np.ndarray, caps, overhead: int = 256) -> int:
    """Choose the tile size minimizing padded work plus per-tile fixed
    cost: sum over lens of ceil(len/cap) * (cap + overhead).

    ``overhead`` (in row-equivalents) charges each extra tile for its
    launch share, its top-k, and its readback/merge entries — without it
    the smallest cap always "wins" on padding alone.  Fine partitions get
    small tiles, coarse ones large tiles."""
    lens = np.asarray(lens, dtype=np.int64)
    if lens.size == 0:
        return caps[0]
    best, best_cost = caps[-1], None
    for cap in caps:
        cost = int((-(-lens // cap)).sum()) * (cap + overhead)
        if best_cost is None or cost < best_cost:
            best, best_cost = cap, cost
    return best


def _merge_host(vals, pos, qidx, qmask, ids, B, topk, spill):
    """Host-side merge of the per-tile partial top-k (numpy, as the
    reference's ``ann.py:87``): composite int64 keys and one argsort per
    pass; non-finite (masked) entries are dropped, and with ``spill > 1``
    an item found in several cells keeps its best score once."""
    m = qmask[:, :, None] & np.isfinite(vals)
    qq = np.broadcast_to(qidx[:, :, None], vals.shape)[m]
    vv = vals[m]
    item = ids[pos[m]]
    out_i = np.full((B, topk), -1, dtype=np.int32)
    out_v = np.zeros((B, topk), dtype=np.float32)
    if len(qq) == 0:               # every probed cell was empty
        return out_i, out_v
    if spill > 1:
        # keep the max score per (query, item): group by the packed
        # key, then a segmented max (items fit in 31 bits)
        comp = (qq.astype(np.int64) << 32) | item.astype(np.int64)
        o = np.argsort(comp)
        comp = comp[o]
        starts = np.flatnonzero(np.r_[True, comp[1:] != comp[:-1]])
        vv = np.maximum.reduceat(vv[o], starts)
        qq = qq[o][starts]
        item = item[o][starts]
    # IEEE-754 monotone mapping makes "score descending" sortable as
    # an unsigned key: finite floats only (masked above)
    bits = vv.view(np.uint32)
    desc = np.uint32(0xFFFFFFFF) - np.where(
        vv >= 0, bits ^ np.uint32(0x80000000), ~bits)
    o = np.argsort((qq.astype(np.int64) << 32) | desc.astype(np.int64))
    qq, vv, item = qq[o], vv[o], item[o]
    seg_start = np.searchsorted(qq, np.arange(B))
    rank = np.arange(len(qq), dtype=np.int64) - seg_start[qq]
    take = rank < topk
    out_i[qq[take], rank[take]] = item[take]
    out_v[qq[take], rank[take]] = vv[take]
    return out_i, out_v


class IVFIndex:
    """Inverted-file MIPS index over a (N, d) float32 table, on one device.

    Build with :meth:`build`; query with :meth:`search` (the
    ``Parallel.set_ann_index`` contract: ``search(queries, topk) ->
    (ids int32[B, topk] (-1 padded), scores f32[B, topk])``).
    """

    def __init__(self, centroids: np.ndarray, assignments: np.ndarray,
                 table: np.ndarray, n_probe: int = 32, device="cuda"):
        """``assignments`` is (N,) for single-cell assignment or (N, s)
        for spill assignment (each row indexed in its ``s`` best cells;
        raises recall at the cost of an s-times-larger inverted file)."""
        self.device = resolve_device(device)
        self.centroids = np.asarray(centroids, dtype=np.float32)
        assignments = np.asarray(assignments)
        if assignments.ndim == 1:
            assignments = assignments[:, None]
        n_rows, self.spill = assignments.shape
        item = np.repeat(np.arange(n_rows, dtype=np.int64), self.spill)
        cells = assignments.ravel()
        order = np.argsort(cells, kind="stable")
        self.ids = item[order].astype(np.int32)     # rows grouped by cell
        counts = np.bincount(cells, minlength=len(centroids))
        self.cell_ptr = np.zeros(len(centroids) + 1, dtype=np.int64)
        np.cumsum(counts, out=self.cell_ptr[1:])
        self.table = np.ascontiguousarray(
            np.asarray(table, dtype=np.float32)[item[order]])
        self.n_probe = int(n_probe)

    # ----------------------------------------------------------------- build
    @classmethod
    def build(cls, table: np.ndarray, n_clusters: Optional[int] = None,
              n_probe: int = 32, n_iters: int = 10, seed: int = 0,
              spill: int = 2, mips_augment: bool = True,
              device="cuda") -> "IVFIndex":
        """Spherical k-means over the (normalized) table rows, as the
        reference's ``build`` (``ann.py:163``): the same seeded initial
        centroids, ``n_iters`` Lloyd iterations, then (``spill > 1``) each
        row's ``spill`` nearest cells.

        ``mips_augment`` (default on) clusters in the MIPS-to-cosine
        augmented space (Shrivastava & Li 2014): each row gains the
        coordinate ``sqrt(M^2 - |x|^2)`` (M = max row norm) before
        normalization, so nearest-centroid-by-cosine in d+1 dims equals
        nearest-by-inner-product.  Member scoring is unchanged (exact
        full-d dots).

        The assignment runs K5 on chunks of at most 65,536 unit rows (the
        reference's chunk), so the plain version's (chunk, C) scores stay
        bounded; the reference's padding of the last chunk only fed its
        ``lax.scan`` and is dropped (padding rows weigh 0 there).
        """
        device = resolve_device(device)
        table = np.asarray(table, dtype=np.float32)
        N, d = table.shape
        if n_clusters is None:
            n_clusters = max(1, int(np.sqrt(N)))
        n_clusters = min(n_clusters, N)
        rng = np.random.default_rng(seed)
        norms = np.linalg.norm(table, axis=1, keepdims=True)
        cluster_space = table
        if mips_augment:
            M = float(norms.max())
            aug = np.sqrt(np.maximum(M * M - norms[:, 0] ** 2, 0.0)
                          ).astype(np.float32)
            cluster_space = np.concatenate([table, aug[:, None]], axis=1)
        unit = cluster_space / np.maximum(norms if not mips_augment
                                          else np.full_like(norms,
                                                            max(M, 1e-12)),
                                          1e-12)
        cent = unit[rng.choice(N, n_clusters, replace=False)]

        CH = min(1 << 16, 1 << max(0, int(np.ceil(np.log2(max(N, 1))))))
        unit_d = torch.from_numpy(np.ascontiguousarray(unit)).to(device)
        cent_d = torch.from_numpy(np.ascontiguousarray(cent)).to(device)

        def assign(k):
            return torch.cat([score_topk(unit_d[lo:lo + CH], cent_d, k)[1]
                              for lo in range(0, N, CH)])

        a = None
        for _ in range(n_iters):
            # lloyd (ann.py:220): the assignment to the current centroids,
            # then the update from it
            a = assign(1)
            cent_d = kmeans_update(unit_d, a, cent_d)
        spill = max(1, min(int(spill), n_clusters))
        if spill > 1 or a is None:
            a = assign(spill)
        return cls(cent_d.cpu().numpy(), a.cpu().numpy(), table,
                   n_probe=n_probe, device=device)

    # ------------------------------------------------------------- serialize
    def save(self, path: str) -> None:
        """Persist as a single .npz, with the reference's keys."""
        np.savez(path if path.endswith(".npz") else path + ".npz",
                 centroids=self.centroids, ids=self.ids,
                 cell_ptr=self.cell_ptr, table=self.table,
                 n_probe=np.int64(self.n_probe),
                 spill=np.int64(self.spill))

    @classmethod
    def load(cls, path: str, device="cuda") -> "IVFIndex":
        with np.load(path if path.endswith(".npz")
                     else path + ".npz") as z:
            idx = cls.__new__(cls)
            idx.device = resolve_device(device)
            idx.centroids = z["centroids"]
            idx.ids = z["ids"]
            idx.cell_ptr = z["cell_ptr"]
            idx.table = z["table"]
            idx.n_probe = int(z["n_probe"])
            idx.spill = int(z["spill"]) if "spill" in z else 1
        return idx

    # ---------------------------------------------------------------- search
    def search(self, queries: np.ndarray, topk: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Probe the ``n_probe`` nearest cells per query, exact-scan
        their members (K6), return global top-k (ids -1-padded)."""
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        B = queries.shape[0]
        if B == 0:
            return (np.full((0, topk), -1, dtype=np.int32),
                    np.zeros((0, topk), dtype=np.float32))
        n_probe = min(self.n_probe, len(self.centroids))

        qn = queries / np.maximum(
            np.linalg.norm(queries, axis=1, keepdims=True), 1e-12)
        # MIPS-augmented centroids carry one extra coordinate; the
        # augmented query coordinate is 0, so probing slices it off
        cell_scores = qn @ self.centroids[:, :queries.shape[1]].T
        if n_probe < cell_scores.shape[1]:
            # probe order is irrelevant (every candidate is exact-
            # scored), so an O(C) partition beats a full argsort
            probes = np.argpartition(-cell_scores, n_probe - 1,
                                     axis=1)[:, :n_probe]
        else:
            probes = np.argsort(-cell_scores, axis=1)[:, :n_probe]

        # ---- tile construction: group probed (query, cell) pairs by
        # cell, then split each cell's workload into fixed-shape
        # (query-chunk x row-chunk) tiles.  All O(B*P) numpy.
        cells_flat = probes.ravel()
        qid_flat = np.repeat(np.arange(B, dtype=np.int32), n_probe)
        order = np.argsort(cells_flat, kind="stable")
        cells_s = cells_flat[order]
        qid_s = qid_flat[order]
        ucells, first = np.unique(cells_s, return_index=True)
        counts = np.diff(np.append(first, len(cells_s)))      # queries/cell
        cell_lo = self.cell_ptr[ucells]
        cell_len = (self.cell_ptr[ucells + 1] - cell_lo).astype(np.int64)

        l_cap = getattr(self, "_l_cap", None)
        if l_cap is None:
            l_cap = self._l_cap = _pick_cap(
                np.diff(self.cell_ptr), _L_CAPS)
        bq_cap = _pick_cap(counts, _BQ_CAPS, overhead=64)
        nq = -(-counts // bq_cap)                             # ceil-div
        nl = np.maximum(1, -(-cell_len // l_cap))
        tiles_per_cell = nq * nl
        T = int(tiles_per_cell.sum())
        cell_of_tile = np.repeat(np.arange(len(ucells)), tiles_per_cell)
        tstart = np.cumsum(tiles_per_cell) - tiles_per_cell
        t_in_cell = np.arange(T, dtype=np.int64) - tstart[cell_of_tile]
        qchunk = t_in_cell // nl[cell_of_tile]
        lchunk = t_in_cell % nl[cell_of_tile]
        lo_t = (cell_lo[cell_of_tile] + lchunk * l_cap).astype(np.int32)
        ln_t = np.minimum(l_cap, cell_len[cell_of_tile]
                          - lchunk * l_cap).astype(np.int32)
        qoff = qchunk * bq_cap
        bq_t = np.minimum(bq_cap, counts[cell_of_tile] - qoff)
        src = (first[cell_of_tile] + qoff)[:, None] \
            + np.arange(bq_cap, dtype=np.int64)[None, :]
        qmask = np.arange(bq_cap)[None, :] < bq_t[:, None]
        qidx = np.where(qmask,
                        qid_s[np.minimum(src, len(qid_s) - 1)],
                        0).astype(np.int32)
        # the reference pads the tile count to a power of two so that its
        # jitted scorer compiles once per bucket; padded tiles are fully
        # masked and the merge drops them, so the port launches T tiles

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        if getattr(self, "_table_dev", None) is None:
            # staged once per index; K6 reads no row past a tile's ln, so
            # the table needs no tail padding
            self._table_dev = up(self.table)
        vals, pos = ivf_tile_topk(up(queries), self._table_dev, up(qidx),
                                  up(qmask), up(lo_t), up(ln_t),
                                  min(topk, l_cap), l_cap, ln_host=ln_t)
        return _merge_host(vals.cpu().numpy(), pos.cpu().numpy(), qidx,
                           qmask, self.ids, B, topk, self.spill)
