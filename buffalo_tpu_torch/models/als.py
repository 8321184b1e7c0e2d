"""Implicit-feedback Alternating Least Squares on one CUDA device.

PyTorch counterpart of ``buffalo_tpu.models.als`` — same epoch structure
(gramian → rowwise half → colwise half → RMSE from (nume, deno) →
validation → save-best/early-stop), same hyperparameters, batches and
solver set (iALS++ chosen at d >= 128, ``als.cc:46``) on one device:
the device-resident bucket-order range layout (bfloat16 values past
100M padded entries), the resident scatter layout
(``range_layout=False``) and, when the padded epoch exceeds
``resident_mb``, the streaming path.  Each batch runs on the
hand-written CUDA kernels of ``ops/als_kernels.py`` (their plain
PyTorch versions on the CPU).  Over a device mesh (``num_devices`` > 1,
``parallelism.get_mesh``; the port's ``devices`` option names the
shards' devices) the same kernels run per shard: "dp+tp" on the
per-shard range layout (``als_epoch_sharded_range``), "dp" on
replicated tables and "tp" with ``range_layout=False`` on row-sharded
ones (``als_epoch_replicated``), streamed when the epoch is not
resident.

Reference: Hu, Koren, Volinsky — Collaborative Filtering for Implicit
Feedback Datasets; iALS++ (arXiv 2110.14044).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from buffalo_tpu_torch.data.base import Data
from buffalo_tpu_torch.data.batching import (DeviceBatcher, build_range_layout,
                                             build_sharded_range_layout,
                                             choose_group_dispatch,
                                             padded_entry_count,
                                             permute_table, stage_batch,
                                             stage_shard_groups)
from buffalo_tpu_torch.evaluate import Evaluable
from buffalo_tpu_torch.models.base import Algo, Serializable
from buffalo_tpu_torch.models.options import ALSOption
from buffalo_tpu_torch.ops.als_kernels import (als_epoch,
                                              als_epoch_replicated,
                                              als_epoch_sharded_range)

def _replicas(mesh, table):
    """``table`` once per device of ``mesh``, listed per local shard."""
    out = {}
    return [out.setdefault(dev, torch.from_numpy(table).to(dev, copy=True))
            for dev in mesh.devices]


# values of the range layout past this many padded entries are staged as
# bfloat16 (the reference's rule, models/als.py:358-366)
BF16_ENTRIES = 100 << 20


class ALS(Algo, ALSOption, Evaluable, Serializable):
    """Python driver for ALS on a torch device."""

    def __init__(self, opt_path=None, *args, **kwargs):
        Algo.__init__(self, *args, **kwargs)
        ALSOption.__init__(self, *args, **kwargs)
        Evaluable.__init__(self, *args, **kwargs)
        Serializable.__init__(self, *args, **kwargs)
        self._setup_driver(opt_path, ALSOption, "ALS", ["matrix"], kwargs)

    @staticmethod
    def new(path, data_fields=[], device="cuda"):
        return ALS.instantiate(ALSOption, path, data_fields, device=device)

    def set_data(self, data):
        assert isinstance(data, Data), f"Wrong instance: {type(data)}"
        self.data = data

    def normalize(self, group="item"):
        if group == "item" and not self.opt.get("_nrz_Q"):
            self.Q = self._normalize(self.Q)
            self.opt._nrz_Q = True
        elif group == "user" and not self.opt.get("_nrz_P"):
            self.P = self._normalize(self.P)
            self.opt._nrz_P = True

    def initialize(self):
        super().initialize()
        self.init_factors()

    def init_factors(self):
        """|N(0, 1/d^2)| init with numpy, matching the reference
        (als.py:85-88): the same ``np.random`` state gives both packages
        the same initial P and Q."""
        assert self.data, "Data is not set"
        header = self.data.get_header()
        d = self.opt.d
        for name, rows in [("P", header["num_users"]),
                           ("Q", header["num_items"])]:
            setattr(self, name, np.abs(
                np.random.normal(scale=1.0 / (d ** 2),
                                 size=(rows, d)).astype("float32")))

    # ------------------------------------------------------------- retrieval
    def _get_topk_recommendation(self, rows, topk, pool=None):
        p = self.P[rows]
        topks = super()._get_topk_recommendation(
            p, self.Q, pb=None, Qb=None, pool=pool, topk=topk,
            num_workers=self.opt.num_workers)
        return zip(rows, topks)

    def _get_most_similar_item(self, col, topk, pool):
        return super()._get_most_similar_item(
            col, topk, self.Q, self.opt.get("_nrz_Q", False), pool)

    def get_scores(self, row_col_pairs):
        return {(r, c): float(self.P[r].dot(self.Q[c]))
                for r, c in row_col_pairs}

    def _get_scores(self, row, col):
        return (self.P[row] * self.Q[col]).sum(axis=1)

    # -------------------------------------------------------------- training
    def _resolve_optimizer(self) -> str:
        """The reference's rule (``models/als.py:99-113``): iALS++ at
        d >= 128 (``als.cc:46``), and under iALS++ at d >= 128 a
        ``block_size`` left at its default of 32 becomes d (the option is
        updated, so a saved model shows it)."""
        optimizer = self.opt.optimizer
        if self.opt.d >= 128:
            optimizer = "ialspp"
        if optimizer == "ialspp" and self.opt.d >= 128 \
                and int(self.opt.block_size) == 32:
            self.opt.block_size = int(self.opt.d)
        return optimizer

    def _epoch_kwargs(self):
        opt = self.opt
        return dict(
            optimizer=self._optimizer, alpha=float(opt.alpha),
            adaptive_reg=bool(opt.adaptive_reg),
            cg_iters=int(opt.num_cg_max_iters),
            cg_tol=float(opt.cg_tolerance),
            block_size=min(int(opt.block_size), int(opt.d)),
            compute_loss=bool(opt.compute_loss_on_training))

    def _vals_dtype(self, padded_entries: int):
        """The range layout's staged value type (the reference's
        ``pick_vals_dtype``): bfloat16 past ``BF16_ENTRIES`` padded
        entries under "auto"; None keeps float32."""
        choice = str(self.opt.get("vals_dtype", "auto"))
        if choice == "auto":
            choice = ("bfloat16" if padded_entries > BF16_ENTRIES
                      else "float32")
        if choice not in ("float32", "bfloat16"):
            raise ValueError("vals_dtype must be auto, float32 or bfloat16, "
                             f"got {choice!r}")
        return torch.bfloat16 if choice == "bfloat16" else None

    def _batchers(self, row_multiple=1, device=None):
        return {group: DeviceBatcher(
            self.data, group,
            batch_mb=int(self.data.opt.data.get("batch_mb", 1024)),
            resident_mb=int(self.opt.get("resident_mb", 4096)),
            row_multiple=row_multiple, d=int(self.opt.d),
            # llt/ldlt materialize the (B, d, d) system at every
            # bucket length; cap rows-per-batch everywhere for them
            matrix_free=self._optimizer not in ("llt", "ldlt"),
            device=device or self.device)
            for group in ("rowwise", "colwise")}

    def _prepare_single(self, kw):
        """One device: (epoch(), to_host(), batchers)."""
        device = self.device
        batchers = self._batchers()
        rb, cb = batchers["rowwise"], batchers["colwise"]
        # buckets and segment chunks, the count the reference's budget
        # rules share
        entries = rb.planner.padded_entries() + cb.planner.padded_entries()

        # the reference's epoch_dispatch choice (from these counts, as it
        # makes it) is validated; it changes no arithmetic here
        if rb.resident and cb.resident and \
                bool(self.opt.get("range_layout", True)):
            # bucket-order range layout: both tables are permuted once so
            # every batch updates a contiguous row range; the permuted,
            # padded tables are locals, so self.P/self.Q stay unpadded even
            # if training stops with an exception
            row_b, col_b, u_pos, i_pos, u_pad, i_pad = build_range_layout(
                rb.planner, cb.planner, rb.key, rb.val, cb.key, cb.val)
            choose_group_dispatch(self.opt, padded_entry_count(row_b + col_b))
            vals_dtype = self._vals_dtype(entries)
            row_batches = [stage_batch(b, device, vals_dtype) for b in row_b]
            col_batches = [stage_batch(b, device, vals_dtype) for b in col_b]
            P = torch.from_numpy(permute_table(self.P, u_pos, u_pad)).to(device)
            Q = torch.from_numpy(permute_table(self.Q, i_pos, i_pad)).to(device)
            order = (u_pos, i_pos)
        else:
            # scatter layout: batches carry row ids and float32 values (as
            # in the reference), staged here once when resident, else
            # streamed through the batchers' staging ring every epoch
            row_batches, col_batches = rb, cb
            choose_group_dispatch(self.opt, entries)
            if rb.resident and cb.resident:
                rb.device_batches()
                cb.device_batches()
            P = torch.from_numpy(self.P).to(device, copy=True)
            Q = torch.from_numpy(self.Q).to(device, copy=True)
            order = None
        num_users, num_items = int(self.P.shape[0]), int(self.Q.shape[0])

        def epoch():
            _, _, nume, deno = als_epoch(
                P, Q, row_batches, col_batches, reg_u=float(self.opt.reg_u),
                reg_i=float(self.opt.reg_i), num_p_rows=num_users,
                num_q_rows=num_items, **kw)
            return nume, deno

        def to_host():
            Ph, Qh = P.cpu().numpy(), Q.cpu().numpy()
            if order is not None:
                Ph, Qh = Ph[order[0]], Qh[order[1]]
            return Ph, Qh
        return epoch, to_host, batchers

    def _prepare_mesh(self, mesh, kw):
        """A device mesh (``models/als.py:260-410``): with "tp" in
        ``sharding`` and the range layout, row-sharded tables in the
        per-shard bucket order of ``build_sharded_range_layout``;
        otherwise padded batches planned with ``row_multiple`` = the mesh
        size whose rows split over the shards, on replicated ("dp") or
        row-sharded ("tp", ``range_layout=False``) tables; the sharded
        range intent falls back to the latter when the epoch is not
        resident (``:299-305``).  Returns (epoch(), to_host(),
        batchers)."""
        from buffalo_tpu_torch import parallelism as par

        opt = self.opt
        sharding = str(opt.get("sharding", "dp"))
        range_intent = "tp" in sharding and bool(
            opt.get("range_layout", True))
        dev0 = mesh.devices[0]
        batchers = self._batchers(1 if range_intent else mesh.size, dev0)
        rb, cb = batchers["rowwise"], batchers["colwise"]
        if range_intent and not (rb.resident and cb.resident):
            range_intent = False
            batchers = self._batchers(mesh.size, dev0)
            rb, cb = batchers["rowwise"], batchers["colwise"]
        num_users, num_items = int(self.P.shape[0]), int(self.Q.shape[0])
        common = dict(mesh=mesh, reg_u=float(opt.reg_u),
                      reg_i=float(opt.reg_i), num_p_rows=num_users,
                      num_q_rows=num_items, **kw)
        if range_intent:
            (row_g, col_g, row_seg, col_seg, u_pos, i_pos, S_u,
             S_i) = build_sharded_range_layout(
                rb.planner, cb.planner, rb.key, rb.val, cb.key, cb.val,
                mesh.size)
            mr = self._mesh_range = {
                "row_groups": stage_shard_groups(row_g, mesh),
                "col_groups": stage_shard_groups(col_g, mesh),
                "row_segments": [stage_batch(b, dev0) for b in row_seg],
                "col_segments": [stage_batch(b, dev0) for b in col_seg],
                "u_pos": u_pos, "i_pos": i_pos, "mesh": mesh}
            P = par.shard_table(mesh, permute_table(self.P, u_pos,
                                                    mesh.size * S_u))
            Q = par.shard_table(mesh, permute_table(self.Q, i_pos,
                                                    mesh.size * S_i))

            def epoch():
                _, _, nume, deno = als_epoch_sharded_range(
                    P, Q, mr["row_groups"], mr["col_groups"],
                    mr["row_segments"], mr["col_segments"], **common)
                return nume, deno

            def to_host():
                return (par.gather_table(mesh, P)[u_pos],
                        par.gather_table(mesh, Q)[i_pos])
            return epoch, to_host, batchers

        row_sharded = "tp" in sharding
        if rb.resident and cb.resident:
            rb.device_batches()
            cb.device_batches()
        if row_sharded:
            # row-sharded tables divide evenly over the mesh: zero rows
            # at the end, never named by a batch
            def mesh_pad(T):
                pad = (-T.shape[0]) % mesh.size
                return np.vstack([T, np.zeros((pad, T.shape[1]), T.dtype)])
            P = par.shard_table(mesh, mesh_pad(self.P))
            Q = par.shard_table(mesh, mesh_pad(self.Q))
        else:
            P = _replicas(mesh, self.P)
            Q = _replicas(mesh, self.Q)

        def epoch():
            _, _, nume, deno = als_epoch_replicated(
                P, Q, rb, cb, row_sharded=row_sharded, **common)
            return nume, deno

        def to_host():
            if row_sharded:
                return (par.gather_table(mesh, P)[:num_users],
                        par.gather_table(mesh, Q)[:num_items])
            return P[0].cpu().numpy(), Q[0].cpu().numpy()
        return epoch, to_host, batchers

    def train(self, training_callback: Optional[
            Callable[[int, Dict[str, float]], None]] = None) -> Dict[str, float]:
        assert self.data, "Data is not set"
        self._optimizer = self._resolve_optimizer()
        kw = self._epoch_kwargs()
        mesh = self._select_mesh(default_all=True)
        self._mesh_range = None
        if mesh is None:
            epoch, to_host, batchers = self._prepare_single(kw)
        else:
            epoch, to_host, batchers = self._prepare_mesh(mesh, kw)
        rb, cb = batchers["rowwise"], batchers["colwise"]
        def _sync_host():
            self.P, self.Q = to_host()
        self._sync_host_factors = _sync_host

        best_loss, rmse, self.validation_result = float("inf"), None, {}
        full_st = time.time()
        self.iteration_times = []  # per-epoch train seconds
        for i in range(self.opt.num_iters):
            start_t = time.time()
            nume, deno = epoch()
            nume, deno = float(nume), float(deno)  # waits for the epoch
            train_t = time.time() - start_t
            self.iteration_times.append(train_t)
            rmse = (nume / (deno + self.opt.eps)) ** 0.5
            metrics = {"train_loss": rmse}
            if self.opt.get("validation") and \
                    self.opt.evaluation_on_learning and \
                    self.periodical(self.opt.evaluation_period, i):
                start_t = time.time()
                self.P, self.Q = to_host()
                self.validation_result = self.get_validation_results()
                vali_t = time.time() - start_t
                val_str = " ".join(f"{k}:{v:0.5f}"
                                   for k, v in self.validation_result.items())
                self.logger.info(f"Validation: {val_str} "
                                 f"Elapsed {vali_t:0.3f} secs")
                metrics.update({f"val_{k}": v
                                for k, v in self.validation_result.items()})
                if training_callback is not None and callable(training_callback):
                    training_callback(i, metrics)
            self.logger.info("Iteration %d: RMSE %.3f Elapsed %.3f secs"
                             % (i + 1, rmse, train_t))
            best_loss = self.save_best_only(rmse, best_loss, i)
            if self.early_stopping(rmse):
                break
        self.P, self.Q = to_host()
        self._sync_host_factors = None
        self._mesh_range = None
        # bytes the streaming path copied to the card (0 when resident)
        self.h2d_bytes = rb.h2d_bytes + cb.h2d_bytes
        self.logger.info(
            f"elapsed for full epochs: {time.time() - full_st:.2f} sec")
        ret = {"train_loss": rmse}
        ret.update({f"val_{k}": v for k, v in self.validation_result.items()})
        return ret

    # --------------------------------------------------------------- access
    def _get_feature(self, index, group="item"):
        if group == "item":
            return self.Q[index]
        elif group == "user":
            return self.P[index]
        return None

    def _get_data(self):
        data = super()._get_data()
        data.extend([("opt", self.opt), ("Q", self.Q), ("P", self.P)])
        return data

    def get_evaluation_metrics(self):
        return ["train_loss", "val_rmse", "val_ndcg", "val_map",
                "val_accuracy", "val_error"]
