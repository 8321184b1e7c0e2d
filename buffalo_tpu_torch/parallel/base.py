"""Batch retrieval ("Parallels") layer on one device.

PyTorch counterpart of ``buffalo_tpu.parallel.base``: bulk
``most_similar`` / ``topk_recommendation`` over many queries at once,
every query scored against the table by K5 (``ops.topk.batch_topn``);
pool filtering gathers the pool rows first; ``-1`` key padding when a
pool is smaller than topk; an ANN index per group (``set_ann_index``,
e.g. an :class:`~buffalo_tpu_torch.parallel.ann.IVFIndex`) serves
``most_similar`` when set.  ``ParALS`` and ``ParBPRMF`` (scores with the
item bias ``Qb``), ``ParEALS``, ``ParCFR`` and ``ParW2V`` (most-similar
over W2V's input table L0) are ported.  Runs on the model's device
(``opt.device``), or with ``mesh=`` / ``num_devices`` > 1 (and the port's
``devices``) sharded over a device mesh: per-shard top-k with K5, merged
by K22 (``ops.topk.batch_topn_sharded``), whichever model trained the
factors.
"""
from __future__ import annotations

import abc

import numpy as np

from buffalo_tpu_torch.models.als import ALS
from buffalo_tpu_torch.models.bpr import BPRMF
from buffalo_tpu_torch.models.cfr import CFR
from buffalo_tpu_torch.models.eals import EALS
from buffalo_tpu_torch.models.w2v import W2V
from buffalo_tpu_torch.ops.topk import batch_topn, batch_topn_sharded


class Parallel(abc.ABC):
    def __init__(self, algo, *argv, **kwargs):
        super().__init__()
        if not isinstance(algo, (ALS, EALS, CFR, W2V, BPRMF)):
            raise ValueError(f"Not supported algo type: {type(algo)}")
        self.algo = algo
        self.num_workers = int(kwargs["num_workers"])
        self._ann_index = {}    # group -> index (reference _ann_list)
        # optional device mesh: retrieval shards the candidate table and
        # merges the per-shard top-k (ops.topk.batch_topn_sharded); the
        # port's ``devices`` names the shards' devices
        from buffalo_tpu_torch import parallelism

        self.mesh = kwargs.get("mesh")
        if self.mesh is None and int(kwargs.get("num_devices", 0)) > 1:
            self.mesh = parallelism.get_mesh(int(kwargs["num_devices"]),
                                             devices=kwargs.get("devices"))
        if self.mesh is not None and \
                not isinstance(self.mesh, parallelism.Mesh):
            raise TypeError("mesh must be a buffalo_tpu_torch.parallelism."
                            f"Mesh, got {type(self.mesh).__name__}")
        # approx=True keeps exact selection on the card (the reference's
        # lax.approx_max_k is a TPU partial reduction) and, as in the
        # reference, uploads the queries as bfloat16
        self.approx = bool(kwargs.get("approx", False))

    def set_ann_index(self, index, group="item"):
        """Optional ANN hook (the reference's n2/HNSW path): any object
        exposing ``search(queries: (B, d) float32, topk: int) -> (ids,
        scores)``, or a path to a saved :class:`~buffalo_tpu_torch.
        parallel.ann.IVFIndex` (loaded on the model's device).  Indexes are
        kept per ``group``: an index built on item factors must not serve
        ``group="user"`` queries.  When set, ``most_similar`` over that
        group (without a pool) delegates to it instead of the exact
        scan."""
        if isinstance(index, str):
            from buffalo_tpu_torch.parallel.ann import IVFIndex
            index = IVFIndex.load(index, device=self.algo.device)
        if not hasattr(index, "search"):
            raise ValueError("ANN index must expose search(queries, topk)")
        self._ann_index[group] = index

    def _resolve(self, keys, group):
        indexes = self.algo.get_index(list(keys), group=group)
        kept = [(k, i) for k, i in zip(keys, indexes) if i is not None]
        keys = [k for k, _ in kept]
        idx = np.array([i for _, i in kept], dtype=np.int32)
        return keys, idx

    def _resolve_pool(self, pool, group="item"):
        if pool is None:
            return None
        pool = self.algo.get_index_pool(pool, group=group)
        if len(pool) == 0:
            raise RuntimeError("pool is empty")
        return pool.astype(np.int32)

    def _scan(self, queries, Factor, topk, pool, Qb=None):
        """Exact MIPS scan: sharded over the mesh when one is set and no
        pool restricts the candidates (``batch_topn_sharded``), else on
        the model's device (``batch_topn``); approx mode ships the queries
        as bfloat16."""
        if self.mesh is not None and pool is None:
            return batch_topn_sharded(
                queries, Factor, topk, self.mesh, Qb=Qb, approx=self.approx,
                query_dtype="bfloat16" if self.approx else None)
        return batch_topn(queries, Factor, topk, pool=pool, Qb=Qb,
                          approx=self.approx,
                          query_dtype="bfloat16" if self.approx else None,
                          device=self.algo.device)

    def _most_similar(self, group, indexes, Factor, topk, pool):
        ann = self._ann_index.get(group)
        if ann is not None and pool is None:
            return ann.search(np.asarray(Factor)[indexes], topk)
        return self._scan(np.asarray(Factor)[indexes], Factor, topk, pool)

    def _topk_recommendation(self, indexes, FactorP, FactorQ, topk, pool):
        return self._scan(np.asarray(FactorP)[indexes], FactorQ, topk,
                          pool)

    def _topk_recommendation_bias(self, indexes, FactorP, FactorQ,
                                  FactorQb, topk, pool):
        return self._scan(np.asarray(FactorP)[indexes], FactorQ, topk,
                          pool, Qb=FactorQb)

    @abc.abstractmethod
    def most_similar(self, keys, topk=10, group="item", pool=None,
                     repr=False, ef_search=-1, use_mmap=True):
        """Batched top-k most-similar retrieval.

        Returns (topks int32[B, topk] with -1 padding, scores f32) or,
        with ``repr=True``, keys instead of indexes.  ``ef_search`` /
        ``use_mmap`` are the reference's n2/HNSW knobs, accepted and
        ignored (the IVF index tunes with ``n_probe``).
        """
        raise NotImplementedError

    @abc.abstractmethod
    def topk_recommendation(self, keys, topk=10, pool=None, repr=False):
        """Batched top-k recommendation; returns (keys, topks, scores)."""
        raise NotImplementedError


class ParALS(Parallel):
    def __init__(self, algo, **kwargs):
        opt = getattr(algo, "opt", None)
        kwargs["num_workers"] = int(kwargs.get(
            "num_workers", opt.num_workers if opt else 1))
        super().__init__(algo, **kwargs)

    def most_similar(self, keys, topk=10, group="item", pool=None,
                     repr=False, ef_search=-1, use_mmap=True):
        self.algo.normalize(group=group)
        keys, indexes = self._resolve(keys, group)
        pool = self._resolve_pool(pool, group=group)
        if group not in ("item", "user"):
            raise ValueError(f"Not supported group: {group}")
        Factor = self.algo.Q if group == "item" else self.algo.P
        topks, scores = self._most_similar(group, indexes, Factor, topk,
                                           pool)
        if repr:
            ids = (self.algo._idmanager.itemids if group == "item"
                   else self.algo._idmanager.userids)
            topks = [[ids[t] for t in tt if t != -1] for tt in topks]
        return topks, scores

    def topk_recommendation(self, keys, topk=10, pool=None, repr=False):
        if self.algo.opt.get("_nrz_P") or self.algo.opt.get("_nrz_Q"):
            raise RuntimeError(
                "Cannot make topk recommendation with normalized factors")
        keys, indexes = self._resolve(keys, "user")
        pool = self._resolve_pool(pool, group="item")
        topks, scores = self._topk_recommendation(
            indexes, self.algo.P, self.algo.Q, topk, pool)
        if repr:
            topks = [[self.algo._idmanager.itemids[t]
                      for t in tt if t != -1] for tt in topks]
        return keys, topks, scores


class ParEALS(ParALS):
    """``ParALS`` over an eALS model (``parallel/base.py:175``)."""


class ParCFR(ParALS):
    """``ParALS`` over a CoFactor model: user x item factors, U / I aliased
    as P / Q (``parallel/base.py:226``)."""


class ParBPRMF(ParALS):
    """``ParALS`` whose recommendations add the item bias (``Qb``) to the
    scores, through K5 (``parallel/base.py:179-191``)."""

    def topk_recommendation(self, keys, topk=10, pool=None, repr=False):
        if self.algo.opt.get("_nrz_P") or self.algo.opt.get("_nrz_Q"):
            raise RuntimeError(
                "Cannot make topk recommendation with normalized factors")
        keys, indexes = self._resolve(keys, "user")
        pool = self._resolve_pool(pool, group="item")
        topks, scores = self._topk_recommendation_bias(
            indexes, self.algo.P, self.algo.Q, self.algo.Qb, topk, pool)
        if repr:
            topks = [[self.algo._idmanager.itemids[t]
                      for t in tt if t != -1] for tt in topks]
        return keys, topks, scores


class ParW2V(Parallel):
    """Batched ``most_similar`` over a W2V model's normalized L0, through K5
    (``parallel/base.py:194-224``); keys resolve through the vocabulary
    remap, and ``repr=True`` maps the ids back to item keys."""

    def __init__(self, algo, **kwargs):
        opt = getattr(algo, "opt", None)
        kwargs["num_workers"] = int(kwargs.get(
            "num_workers", opt.num_workers if opt else 1))
        super().__init__(algo, **kwargs)

    def most_similar(self, keys, topk=10, pool=None, repr=False,
                     group="item", ef_search=-1, use_mmap=True):
        self.algo.normalize(group="item")
        indexes = self.algo.get_index(list(keys), group="item")
        kept = [(k, i) for k, i in zip(keys, indexes) if i is not None]
        keys = [k for k, _ in kept]
        indexes = np.array([i for _, i in kept], dtype=np.int32)
        if pool is not None:
            pool = np.asarray(
                [i for i in self.algo.get_index(list(pool), group="item")
                 if i is not None], dtype=np.int32)
            if len(pool) == 0:
                raise RuntimeError("pool is empty")
        topks, scores = self._most_similar("item", indexes, self.algo.L0,
                                           topk, pool)
        if repr:
            inv = self.algo._vocab.inv_index
            topks = [[self.algo._idmanager.itemids[inv[t]]
                      for t in tt if t != -1] for tt in topks]
        return topks, scores

    def topk_recommendation(self, keys, topk=10, pool=None, repr=False):
        raise NotImplementedError
