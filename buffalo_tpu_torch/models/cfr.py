"""CoFactor (CFR) on a CUDA device or a device mesh.

PyTorch counterpart of ``buffalo_tpu.models.cfr``: joint factorization of
the user-item implicit matrix and the item-context SPPMI matrix with
shared item embeddings and item/context biases; three-phase epochs (user /
item / context) with the loss scaled by ``l * (alpha * vsum + U * I) +
sppmi_nnz``, the same options, initialization, batches, validation and
save/load byte format.  The item phase takes the colwise padded batches
with each batch's SPPMI block padded alongside (``data.batching.
pad_rows``), the items with SPPMI entries only in extra batches, and rows
long on either side as segment pairs over one row list.  Each batch runs
K17, K3 and K18 (``ops/cfr_kernels.py``; their plain PyTorch versions on
the CPU); the batches stay on the device when they fit ``resident_mb`` and
are staged batch by batch otherwise.  ``num_devices > 1`` trains on a dp
mesh (``Algo._select_dp_mesh``, over ``opt.devices`` when given), as the
JAX package does: the tables replicated, every padded batch's rows padded
to a multiple of the mesh size with sentinel rows and split over the
shards, the segment batches run on every replica, each phase's solved
rows gathered over the mesh (``ops/cfr_kernels.cfr_epoch``); batches past
``resident_mb`` warn and train on one device.  Negative interaction values
raise ``ValueError`` (the JAX package's implicit term takes their square
root).

Reference: Liang et al., Factorization Meets the Item Embedding (RecSys
2016).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from buffalo_tpu_torch.data.base import Data
from buffalo_tpu_torch.data.batching import (DEFAULT_MAX_L, BatchPlanner,
                                             PaddedBatch, SegmentBatch,
                                             build_segment_batch, pad_rows,
                                             stage_batch)
from buffalo_tpu_torch.evaluate import Evaluable
from buffalo_tpu_torch.models.base import Algo, Serializable
from buffalo_tpu_torch.models.options import CFROption
from buffalo_tpu_torch.ops import cfr_kernels as K
from buffalo_tpu_torch.parallelism import Mesh


def _stage_entry(entry, dev):
    """A host batch, or an item entry (a padded batch + its SPPMI block, or
    a segment pair), on ``dev``."""
    if isinstance(entry, (PaddedBatch, SegmentBatch)):
        return stage_batch(entry, dev)
    if isinstance(entry[0], SegmentBatch):
        return tuple(stage_batch(b, dev) for b in entry)
    b, *block = entry
    return (stage_batch(b, dev),) + tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in block)


def _is_segment(entry) -> bool:
    return isinstance(entry, SegmentBatch) or (
        not isinstance(entry, PaddedBatch) and isinstance(entry[0],
                                                          SegmentBatch))


def _stage_mesh_entry(entry, mesh, sentinel):
    """A host entry staged for ``ops.cfr_kernels.cfr_epoch`` on ``mesh``: a
    segment batch or pair once per local device ({device: entry}); a padded
    batch or item entry (with its SPPMI block) padded on its row axis to a
    multiple of the mesh size with sentinel rows (``sentinel``, the table's
    size, no entries; ``cfr.py:356-384`` of the JAX package) and split into
    the local shards' row slices, each on its shard's device (a list)."""
    if _is_segment(entry):
        return {dev: _stage_entry(entry, dev) for dev in mesh.unique_devices}
    b, block = (entry, ()) if isinstance(entry, PaddedBatch) \
        else (entry[0], entry[1:])
    B = len(b.rows)
    n = -(-B // mesh.size)

    def pad(a, fill):
        a = np.asarray(a)
        more = np.full((n * mesh.size - B,) + a.shape[1:], fill, a.dtype)
        return np.concatenate([a, more])

    b = PaddedBatch(rows=pad(b.rows, sentinel), lens=pad(b.lens, 0),
                    cols=pad(b.cols, 0), vals=pad(b.vals, 0))
    block = [pad(a, 0) for a in block]
    out = []
    for g, dev in zip(mesh.shards, mesh.devices):
        sl = slice(g * n, (g + 1) * n)
        part = PaddedBatch(*[a[sl] for a in b])
        out.append(_stage_entry(
            (part,) + tuple(a[sl] for a in block) if block else part, dev))
    return out


def _entry_bytes(entry) -> int:
    if isinstance(entry, (PaddedBatch, SegmentBatch)):
        return sum(np.asarray(a).nbytes for a in entry)
    return sum(_entry_bytes(p) if hasattr(p, "_fields")
               else np.asarray(p).nbytes for p in entry)


class CFR(Algo, CFROption, Evaluable, Serializable):
    """CoFactor training and serving on a torch device."""

    def __init__(self, opt_path=None, *args, **kwargs):
        Algo.__init__(self, *args, **kwargs)
        CFROption.__init__(self, *args, **kwargs)
        Evaluable.__init__(self, *args, **kwargs)
        Serializable.__init__(self, *args, **kwargs)
        self._setup_driver(opt_path, CFROption, "CFR", ["stream"], kwargs)
        self.is_initialized = False
        if self.data:
            assert self.data.has_group("sppmi"), \
                "CFR requires SPPMI data (set data.sppmi options)"
            assert self.data.has_group("colwise"), \
                "CFR requires matrix internal data type"

    @staticmethod
    def new(path, data_fields=[], device="cuda"):
        return CFR.instantiate(CFROption, path, data_fields, device=device)

    def set_data(self, data):
        assert isinstance(data, Data), f"Wrong instance: {type(data)}"
        self.data = data

    def normalize(self, group="item"):
        assert group in ["user", "item", "context"], \
            f"group ({group}) is not properly provided"
        if group == "user" and not self.opt.get("_nrz_U"):
            self.U = self._normalize(self.U)
            # keep the ALS-style P/Q aliases (and their guard flags,
            # checked by ParALS.topk_recommendation) in sync
            self.P = self.U
            self.opt._nrz_U = True
            self.opt._nrz_P = True
        elif group == "item" and not self.opt.get("_nrz_I"):
            self.I = self._normalize(self.I)
            self.Q = self.I
            self.opt._nrz_I = True
            self.opt._nrz_Q = True
        elif group == "context" and not self.opt.get("_nrz_C"):
            self.C = self._normalize(self.C)
            self.opt._nrz_C = True

    def initialize(self):
        """N(0, 1/d^2) U, I and C with numpy in the reference's order, zero
        biases (cfr.py:77-92)."""
        super().initialize()
        assert self.data, "Data is not set"
        header = self.data.get_header()
        num_users, num_items, d = (header["num_users"],
                                   header["num_items"], self.opt.d)
        for attr, shape in [("U", (num_users, d)), ("I", (num_items, d)),
                            ("C", (num_items, d))]:
            setattr(self, attr, np.random.normal(
                scale=1.0 / (d ** 2), size=shape).astype(np.float32))
        self.Ib = np.zeros(num_items, dtype=np.float32)
        self.Cb = np.zeros(num_items, dtype=np.float32)
        self.P = self.U
        self.Q = self.I
        self.is_initialized = True

    # ------------------------------------------------------------- retrieval
    def _get_topk_recommendation(self, rows, topk, pool=None):
        u = self.U[rows]
        topks = super()._get_topk_recommendation(
            u, self.I, pb=None, Qb=None, pool=pool, topk=topk,
            num_workers=self.opt.num_workers)
        return zip(rows, topks)

    def _get_most_similar_item(self, col, topk, pool):
        return super()._get_most_similar_item(
            col, topk, self.I, self.opt.get("_nrz_I", False), pool)

    def get_scores(self, row_col_pairs):
        return {(r, c): float(self.U[r].dot(self.I[c]))
                for r, c in row_col_pairs}

    def _get_scores(self, row, col):
        return (self.U[row] * self.I[col]).sum(axis=1)

    # -------------------------------------------------------------- training
    def compute_scale(self) -> float:
        ret = self.data.get_scale_info(with_sppmi=True)
        alpha, l = self.opt.alpha, self.opt.l
        return float(l * (alpha * ret["vsum"]
                          + ret["num_users"] * ret["num_items"])
                     + ret["sppmi_nnz"])

    def _build_batches(self):
        """Host batches of the three phases (``cfr.py:120-242``): users and
        contexts in degree buckets with long rows as segment batches; items
        as colwise padded batches with their SPPMI block, extra batches for
        items with SPPMI entries only, and segment pairs for rows long on
        either side."""
        batch_mb = int(self.data.opt.data.get("batch_mb", 1024))
        max_len = int(self.opt.get("max_len", DEFAULT_MAX_L))
        # the JAX package's cap on a batch's entries: its gathered (B*L, d)
        # float32 temporary stays within ~2 GB
        d = int(self.opt.d)
        entries = max(min(int(batch_mb) * 1024 * 1024 // 16,
                          (2 << 30) // (4 * d)), 4096)
        out = {}
        rw = self.data.get_group("rowwise")
        planner = BatchPlanner(np.asarray(rw["indptr"]),
                               entries_per_batch=entries, max_len=max_len)
        out["user"] = list(planner.iter_batches(rw["key"], rw.get("val")))

        cw = self.data.get_group("colwise")
        sp = self.data.get_group("sppmi")
        cw_indptr = np.asarray(cw["indptr"])
        sp_indptr = np.asarray(sp["indptr"])
        cw_deg = np.diff(cw_indptr)
        sp_deg = np.diff(sp_indptr)
        # long on either side -> the segment pair path
        long_mask = (cw_deg > max_len) | (sp_deg > max_len)
        planner = BatchPlanner(cw_indptr, entries_per_batch=entries,
                               max_len=max_len)
        item_batches = []
        for b in planner.iter_batches(cw["key"], cw.get("val")):
            if isinstance(b, SegmentBatch):
                continue  # cw-long rows take the segment-pair path below
            # rows that are sppmi-long leave the padded batch (their slot
            # becomes padding) and join the segment set
            keep = ~long_mask[np.minimum(b.rows, len(cw_deg) - 1)] \
                | (b.lens == 0)
            if not keep.all():
                b = PaddedBatch(
                    rows=np.where(keep, b.rows,
                                  len(cw_deg)).astype(np.int32),
                    lens=np.where(keep, b.lens, 0).astype(np.int32),
                    cols=np.where(keep[:, None], b.cols, 0),
                    vals=np.where(keep[:, None], b.vals, 0.0))
            lens_c, cols_c, vals_c = pad_rows(
                sp_indptr, sp["key"], sp["val"], b.rows)
            item_batches.append((b, lens_c, cols_c, vals_c))
        # items with sppmi entries but no colwise entries still need an
        # item update (the reference loops every row of a range)
        leftover = np.nonzero((cw_deg == 0) & (sp_deg > 0) & ~long_mask)[0]
        for beg in range(0, len(leftover), 1024):
            rows = leftover[beg:beg + 1024]
            B = max(8, 1 << int(np.ceil(np.log2(len(rows)))))
            rpad = np.full(B, len(cw_deg), dtype=np.int32)
            rpad[:len(rows)] = rows
            lens_c, cols_c, vals_c = pad_rows(
                sp_indptr, sp["key"], sp["val"], rpad)
            empty = PaddedBatch(
                rows=rpad, lens=np.zeros(B, np.int32),
                cols=np.zeros((B, 8), np.int32),
                vals=np.zeros((B, 8), np.float32))
            item_batches.append((empty, lens_c, cols_c, vals_c))
        # segment pairs: pack long rows bounded by both sides' chunks
        long_rows = np.nonzero(long_mask)[0]
        if len(long_rows):
            budget = max(1, planner.entries_per_batch // max_len)
            order = np.argsort(-(cw_deg[long_rows] + sp_deg[long_rows]),
                               kind="stable")
            cur, cur_chunks, plans = [], 0, []
            for r in long_rows[order]:
                n = int(np.ceil(cw_deg[r] / max_len)
                        + np.ceil(max(sp_deg[r], 1) / max_len))
                if cur and cur_chunks + n > budget:
                    plans.append(cur)
                    cur, cur_chunks = [], 0
                cur.append(int(r))
                cur_chunks += n
            if cur:
                plans.append(cur)
            for plan in plans:
                sb_u = build_segment_batch(cw_indptr, cw["key"],
                                           cw.get("val"), plan, max_len,
                                           len(cw_deg))
                sb_c = build_segment_batch(sp_indptr, sp["key"], sp["val"],
                                           plan, max_len, len(sp_deg))
                item_batches.append((sb_u, sb_c))
        out["item"] = item_batches

        planner = BatchPlanner(sp_indptr, entries_per_batch=entries,
                               max_len=max_len)
        out["context"] = list(planner.iter_batches(sp["key"], sp["val"]))
        return out

    def _check_supported(self):
        val = self.data.get_group("rowwise")["val"]
        if len(val) and float(np.min(val)) < 0:
            raise ValueError(
                "CFR takes non-negative interaction values: the JAX "
                "package's implicit term scales by sqrt(alpha * v), which "
                "is NaN below 0")

    def train(self, training_callback: Optional[
            Callable[[int, Dict[str, float]], None]] = None) -> Dict[str, float]:
        assert self.is_initialized, "embedding matrix is not initialized"
        self._check_supported()
        opt = self.opt
        dev = self.device
        batches = self._build_batches()
        com = dict(optimizer=str(opt.optimizer),
                   cg_iters=int(opt.num_cg_max_iters),
                   cg_tol=float(opt.cg_tolerance),
                   compute_loss=bool(opt.compute_loss_on_training))
        scale = self.compute_scale()

        staged_bytes = sum(_entry_bytes(e) for phase in batches.values()
                           for e in phase)
        resident = staged_bytes <= int(opt.get("resident_mb", 4096)) \
            * 1024 * 1024
        mesh = self._select_dp_mesh(resident, False)
        if mesh is not None:
            # the dp mesh (cfr.py:352-400): padded batches row-sharded with
            # sentinel rows, segment batches on every device
            sentinel = {"user": self.U.shape[0], "item": self.I.shape[0],
                        "context": self.C.shape[0]}
            phases = {k: [_stage_mesh_entry(e, mesh, sentinel[k]) for e in v]
                      for k, v in batches.items()}
        elif resident:
            # stage all three phases' batches on the device once
            mesh = Mesh([dev])
            phases = {k: [_stage_entry(e, dev) for e in v]
                      for k, v in batches.items()}
        else:
            # past resident_mb: each batch is staged as the epoch reaches it
            mesh = Mesh([dev])
            phases = {k: _Staged(v, dev) for k, v in batches.items()}
        # one replica of the tables per device; the first is written back
        tables = {mdev: [torch.from_numpy(t).to(mdev, copy=True) for t in
                         (self.U, self.I, self.C, self.Ib, self.Cb)]
                  for mdev in mesh.unique_devices}

        def to_host():
            self.U, self.I, self.C, self.Ib, self.Cb = (
                t.cpu().numpy() for t in tables[mesh.devices[0]])
            self.P, self.Q = self.U, self.I
        self._sync_host_factors = to_host

        best_loss, loss, self.validation_result = float("inf"), None, {}
        full_st = time.time()
        self.iteration_times = []   # per-epoch train seconds
        self.iteration_losses = []  # per-epoch train loss
        for i in range(opt.num_iters):
            start_t = time.time()
            epoch_loss = K.cfr_epoch(
                mesh, tables, phases["user"], phases["item"],
                phases["context"], alpha=float(opt.alpha), l=float(opt.l),
                reg_u=float(opt.reg_u), reg_i=float(opt.reg_i),
                reg_c=float(opt.reg_c), **com)
            loss = float(epoch_loss) / scale  # a readback: ends the epoch
            train_t = time.time() - start_t
            self.iteration_times.append(train_t)
            self.iteration_losses.append(loss)
            metrics = {"train_loss": loss}
            if opt.get("validation") and opt.evaluation_on_learning and \
                    self.periodical(opt.evaluation_period, i):
                start_t = time.time()
                to_host()
                self.validation_result = self.get_validation_results()
                vali_t = time.time() - start_t
                val_str = " ".join(f"{k}:{v:0.5f}"
                                   for k, v in self.validation_result.items())
                self.logger.info(f"Validation: {val_str} "
                                 f"Elapsed {vali_t:0.3f} secs")
                metrics.update({f"vali_{k}": v
                                for k, v in self.validation_result.items()})
                if training_callback is not None and callable(training_callback):
                    training_callback(i, metrics)
            self.logger.info("Iteration %d: Loss %.3f Elapsed %.3f secs"
                             % (i + 1, loss, train_t))
            best_loss = self.save_best_only(loss, best_loss, i)
            if self.early_stopping(loss):
                break
        to_host()
        self._sync_host_factors = None
        self.logger.info(
            f"elapsed for full epochs: {time.time() - full_st:.2f} sec")
        ret = {"train_loss": loss}
        ret.update({f"vali_{k}": v for k, v in self.validation_result.items()})
        return ret

    # --------------------------------------------------------------- access
    def _get_feature(self, index, group="item"):
        if group == "item":
            return self.I[index]
        elif group == "user":
            return self.U[index]
        elif group == "context":
            return self.C[index]
        return None

    def _get_data(self):
        data = super()._get_data()
        data.extend([("opt", self.opt), ("I", self.I), ("U", self.U),
                     ("C", self.C), ("Ib", self.Ib), ("Cb", self.Cb)])
        return data

    def get_evaluation_metrics(self):
        return ["train_loss", "vali_rmse", "vali_ndcg", "vali_map",
                "vali_accuracy", "vali_error"]


class _Staged:
    """A phase's host batches, staged on the device one at a time as an
    epoch iterates over them (the streamed path)."""

    def __init__(self, entries, dev):
        self.entries, self.dev = entries, dev

    def __iter__(self):
        for e in self.entries:
            yield _stage_entry(e, self.dev)
