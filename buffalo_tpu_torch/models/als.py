"""Implicit-feedback Alternating Least Squares on one CUDA device.

PyTorch counterpart of ``buffalo_tpu.models.als`` — same epoch structure
(gramian → rowwise half → colwise half → RMSE from (nume, deno) →
validation → save-best/early-stop), same hyperparameters, batches and
solver set, for the single-device, device-resident, bucket-order range
layout path.  Each batch runs on the hand-written CUDA kernels of
``ops/als_kernels.py`` (their plain PyTorch versions on the CPU).

Not ported yet, each raising ``NotImplementedError`` at ``train``: more
than one device, the streaming (non-resident) path, the scatter layout
(``range_layout=False``), iALS++ (``optimizer="ialspp"``, auto at
d >= 128) and bfloat16 staged values.

Reference: Hu, Koren, Volinsky — Collaborative Filtering for Implicit
Feedback Datasets.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from buffalo_tpu_torch.data.base import Data
from buffalo_tpu_torch.data.batching import (DeviceBatcher, build_range_layout,
                                             permute_table, stage_batch)
from buffalo_tpu_torch.evaluate import Evaluable
from buffalo_tpu_torch.models.base import Algo, Serializable
from buffalo_tpu_torch.models.options import ALSOption
from buffalo_tpu_torch.ops.als_kernels import IALSPP_TODO, als_epoch


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
        if self.opt.d >= 128 or self.opt.optimizer == "ialspp":
            raise NotImplementedError(IALSPP_TODO)
        return self.opt.optimizer

    def _epoch_kwargs(self):
        opt = self.opt
        return dict(
            optimizer=self._optimizer, alpha=float(opt.alpha),
            adaptive_reg=bool(opt.adaptive_reg),
            cg_iters=int(opt.num_cg_max_iters),
            cg_tol=float(opt.cg_tolerance),
            block_size=min(int(opt.block_size), int(opt.d)),
            compute_loss=bool(opt.compute_loss_on_training))

    def _check_supported(self, batchers):
        """Raise for the reference's paths this port does not run yet
        (ROADMAP queue 1 names each item)."""
        opt = self.opt
        if int(opt.get("num_devices") or 0) > 1:
            raise NotImplementedError(
                "num_devices > 1 is not ported yet: ROADMAP queue 1 item 13 "
                "(multi-device epochs over NCCL)")
        if not all(b.resident for b in batchers.values()):
            raise NotImplementedError(
                "the padded epoch exceeds resident_mb: the streaming path "
                "is not ported yet (ROADMAP queue 1 item 4)")
        if not bool(opt.get("range_layout", True)):
            raise NotImplementedError(
                "range_layout=False (scatter updates) is not ported yet "
                "(ROADMAP queue 1 item 4)")
        choice = str(opt.get("vals_dtype", "auto"))
        if choice == "auto":
            # the reference's rule (models/als.py:358-366)
            entries = sum(b.planner.padded_entries()
                          for b in batchers.values())
            choice = "bfloat16" if entries > (100 << 20) else "float32"
        if choice != "float32":
            raise NotImplementedError(
                f"vals_dtype={choice} is not ported yet: the kernels read "
                "float32 values (ROADMAP queue 1 item 4)")

    def train(self, training_callback: Optional[
            Callable[[int, Dict[str, float]], None]] = None) -> Dict[str, float]:
        assert self.data, "Data is not set"
        self._optimizer = self._resolve_optimizer()
        device = self.device
        batchers = {group: DeviceBatcher(
            self.data, group,
            batch_mb=int(self.data.opt.data.get("batch_mb", 1024)),
            resident_mb=int(self.opt.get("resident_mb", 4096)),
            d=int(self.opt.d),
            # llt/ldlt materialize the (B, d, d) system at every
            # bucket length; cap rows-per-batch everywhere for them
            matrix_free=self._optimizer not in ("llt", "ldlt"))
            for group in ("rowwise", "colwise")}
        self._check_supported(batchers)

        # bucket-order range layout: both tables are permuted once so
        # every batch updates a contiguous row range; the permuted,
        # padded tables are locals, so self.P/self.Q stay unpadded even
        # if training stops with an exception
        rb, cb = batchers["rowwise"], batchers["colwise"]
        row_b, col_b, u_pos, i_pos, u_pad, i_pad = build_range_layout(
            rb.planner, cb.planner, rb.key, rb.val, cb.key, cb.val)
        row_batches = [stage_batch(b, device) for b in row_b]
        col_batches = [stage_batch(b, device) for b in col_b]
        P = torch.from_numpy(permute_table(self.P, u_pos, u_pad)).to(device)
        Q = torch.from_numpy(permute_table(self.Q, i_pos, i_pad)).to(device)
        num_users, num_items = int(self.P.shape[0]), int(self.Q.shape[0])
        kw = self._epoch_kwargs()

        def to_host():
            return (P.cpu().numpy()[u_pos], Q.cpu().numpy()[i_pos])

        def _sync_host():
            self.P, self.Q = to_host()
        self._sync_host_factors = _sync_host

        best_loss, rmse, self.validation_result = float("inf"), None, {}
        full_st = time.time()
        self.iteration_times = []  # per-epoch train seconds
        for i in range(self.opt.num_iters):
            start_t = time.time()
            P, Q, nume, deno = als_epoch(
                P, Q, row_batches, col_batches, reg_u=float(self.opt.reg_u),
                reg_i=float(self.opt.reg_i), num_p_rows=num_users,
                num_q_rows=num_items, **kw)
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
