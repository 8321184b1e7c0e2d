"""Probabilistic Latent Semantic Indexing (EM) on one CUDA device.

PyTorch counterpart of ``buffalo_tpu.models.plsi``: EM over user-item
co-occurrence with double-buffered tables, smoothing alpha1/alpha2,
warm-start ``inherit`` from a previous model by string-id matching, loss
``-sum v log P(i|u) / sum v``, the same options, initialization, validation
and save/load byte format.  The epoch runs on the bucket-order range layout
over both orientations when the colwise group is there and both
orientations' batches fit ``resident_mb`` (``range_layout`` on); otherwise
over the rowwise padded and segment batches, resident or streamed.  K15
accumulates each batch's E-step and K16 runs the M-step
(``ops/plsi_kernels.py``; their plain PyTorch versions on the CPU).  With
``num_devices`` > 1 the range layout runs over a device mesh
(``parallelism.get_mesh``; the port's ``devices`` option names the shards'
devices): ``build_sharded_range_layout`` and
``plsi_epoch_sharded_range``.

Reference: Hofmann, Probabilistic Latent Semantic Indexing (SIGIR 99).
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
                                             padded_entry_count, permute_table,
                                             stage_batch, stage_shard_groups)
from buffalo_tpu_torch.evaluate import Evaluable
from buffalo_tpu_torch.models.base import Algo, Serializable
from buffalo_tpu_torch.models.options import PLSIOption
from buffalo_tpu_torch.ops import plsi_kernels as K


class PLSI(Algo, PLSIOption, Evaluable, Serializable):
    """pLSI training and serving on a torch device."""

    def __init__(self, opt_path=None, *args, **kwargs):
        Algo.__init__(self, *args, **kwargs)
        PLSIOption.__init__(self, *args, **kwargs)
        Evaluable.__init__(self, *args, **kwargs)
        Serializable.__init__(self, *args, **kwargs)
        self._setup_driver(opt_path, PLSIOption, "PLSI", ["matrix", "stream"],
                           kwargs)

    @staticmethod
    def new(path, data_fields=[], device="cuda"):
        return PLSI.instantiate(PLSIOption, path, data_fields, device=device)

    def set_data(self, data):
        assert isinstance(data, Data), f"Wrong instance: {type(data)}"
        self.data = data

    def normalize(self, group="item"):
        if group == "item":
            self.Q /= (np.sum(self.Q, axis=0, keepdims=True) + self.opt.eps)
        elif group == "user":
            self.P /= (np.sum(self.P, axis=1, keepdims=True) + self.opt.eps)

    def initialize(self):
        super().initialize()
        self.init_factors()
        self.inherit()

    def init_factors(self):
        """|N(0, 1/d)| with numpy in the reference's order, P rows and Q
        columns normalized to sum to 1 (plsi.cc:44-70)."""
        assert self.data, "Did not set data"
        header = self.data.get_header()
        self.num_users = header["num_users"]
        self.num_items = header["num_items"]
        self.num_nnz = header["num_nnz"]
        d = self.opt.d
        P = np.abs(np.random.normal(scale=1.0 / d,
                                    size=(self.num_users, d))
                   ).astype("float32")
        self.P = P / P.sum(axis=1, keepdims=True)
        Q = np.abs(np.random.normal(scale=1.0 / d,
                                    size=(self.num_items, d))
                   ).astype("float32")
        self.Q = Q / Q.sum(axis=0, keepdims=True)

    def inherit(self):
        """Warm-start from a previous model (either package's file) by
        string-id matching (plsi.py:62-89)."""
        if not self.opt.get("inherit_opt"):
            return
        inherit_opt = self.opt.inherit_opt
        prev_model = PLSI.new(inherit_opt.model_path, device=self.device)

        def _inherit(which):
            if which == "user":
                self.build_userid_map()
                curr_idmap = self._idmanager.userid_map
                prev_idmap = prev_model._idmanager.userid_map
                curr_obj, prev_obj = self.P, prev_model.P
            else:
                self.build_itemid_map()
                curr_idmap = self._idmanager.itemid_map
                prev_idmap = prev_model._idmanager.itemid_map
                curr_obj, prev_obj = self.Q, prev_model.Q
            assert curr_obj.shape[1] == prev_obj.shape[1], (
                f"Dimension mismatch. Current dimension: "
                f"{curr_obj.shape[1]} / Previous dimension: "
                f"{prev_obj.shape[1]}")
            for key, curr_idx in curr_idmap.items():
                if key in prev_idmap:
                    curr_obj[curr_idx] = prev_obj[prev_idmap[key]]

        if inherit_opt.get("inherit_user", False):
            self.logger.info("Inherit from previous user matrix")
            _inherit("user")
        if inherit_opt.get("inherit_item", False):
            self.logger.info("Inherit from previous item matrix")
            _inherit("item")

    # ------------------------------------------------------------- retrieval
    def _get_topk_recommendation(self, rows, topk, pool=None):
        p = self.P[rows]
        topks = super()._get_topk_recommendation(
            p, self.Q, pb=None, Qb=None, pool=pool, topk=topk,
            num_workers=self.opt.num_workers)
        return zip(rows, topks)

    def _get_most_similar_item(self, col, topk, pool):
        return super()._get_most_similar_item(col, topk, self.Q, True, pool)

    def get_scores(self, row_col_pairs):
        return {(r, c): float(self.P[r].dot(self.Q[c]))
                for r, c in row_col_pairs}

    def _get_scores(self, row, col):
        return (self.P[row] * self.Q[col]).sum(axis=1)

    # -------------------------------------------------------------- training
    def _rowwise_batcher(self):
        """The rowwise orientation's batches (``plsi.py:139-143``)."""
        return DeviceBatcher(
            self.data, "rowwise",
            batch_mb=int(self.data.opt.data.get("batch_mb", 1024)),
            resident_mb=int(self.opt.get("resident_mb", 4096)),
            d=int(self.opt.d), device=self.device)

    def _train_state(self, batcher):
        """The range layout over both orientations (``plsi.py:209-256``)
        staged on the device, or None when the epoch takes the rowwise
        batches (no colwise group, ``range_layout`` off, or an orientation
        past ``resident_mb``)."""
        opt = self.opt
        if not (batcher.resident and self.data.has_group("colwise")
                and bool(opt.get("range_layout", True))):
            return None
        cb = DeviceBatcher(
            self.data, "colwise",
            batch_mb=int(self.data.opt.data.get("batch_mb", 1024)),
            resident_mb=int(opt.get("resident_mb", 4096)), d=int(opt.d),
            device=self.device)
        if not cb.resident:
            return None
        mesh = self._select_mesh()
        if mesh is not None:
            return self._mesh_state(mesh, batcher, cb)
        row_b, col_b, u_pos, i_pos, u_pad, i_pad = build_range_layout(
            batcher.planner, cb.planner, batcher.key, batcher.val, cb.key,
            cb.val)
        # the reference's epoch_dispatch (auto|fused|group), validated;
        # its two dispatches do the same arithmetic, and so does the port
        # (a launch per batch either way)
        choose_group_dispatch(opt, padded_entry_count(row_b + col_b))
        p_mask = np.zeros(u_pad, np.float32)
        p_mask[u_pos] = 1.0
        q_mask = np.zeros(i_pad, np.float32)
        q_mask[i_pos] = 1.0
        dev = self.device
        return {
            "row_groups": [stage_batch(b, dev) for b in row_b],
            "col_groups": [stage_batch(b, dev) for b in col_b],
            "u_pos": u_pos, "i_pos": i_pos, "u_pad": u_pad, "i_pad": i_pad,
            "p_mask": torch.from_numpy(p_mask).to(dev),
            "q_mask": torch.from_numpy(q_mask).to(dev),
        }

    def _mesh_state(self, mesh, rb, cb):
        """The per-shard range layout over ``mesh`` (``plsi.py:147-180``):
        staged groups per local shard, segments on its first device, the
        real-row masks as row shards."""
        from buffalo_tpu_torch import parallelism as par

        (row_g, col_g, row_seg, col_seg, u_pos, i_pos, S_u,
         S_i) = build_sharded_range_layout(rb.planner, cb.planner, rb.key,
                                           rb.val, cb.key, cb.val, mesh.size)
        u_pad, i_pad = mesh.size * S_u, mesh.size * S_i
        p_mask = np.zeros(u_pad, np.float32)
        p_mask[u_pos] = 1.0
        q_mask = np.zeros(i_pad, np.float32)
        q_mask[i_pos] = 1.0
        dev0 = mesh.devices[0]
        self._mesh_range = {
            "mesh": mesh, "row_groups": stage_shard_groups(row_g, mesh),
            "col_groups": stage_shard_groups(col_g, mesh),
            "row_segments": [stage_batch(b, dev0) for b in row_seg],
            "col_segments": [stage_batch(b, dev0) for b in col_seg],
            "u_pos": u_pos, "i_pos": i_pos, "u_pad": u_pad, "i_pad": i_pad,
            "p_mask": par.shard_table(mesh, p_mask),
            "q_mask": par.shard_table(mesh, q_mask),
        }
        return self._mesh_range

    def train(self, training_callback: Optional[
            Callable[[int, Dict[str, float]], None]] = None) -> Dict[str, float]:
        assert self.data, "Data is not set"
        opt = self.opt
        dev = self.device
        batcher = self._rowwise_batcher()
        group = self.data.get_group("rowwise")
        loss_deno = float(np.sum(group["val"], dtype=np.float64))
        self._mesh_range = None
        rs = self._train_state(batcher)
        mesh = None if rs is None else rs.get("mesh")
        if mesh is not None:
            from buffalo_tpu_torch import parallelism as par

            P = par.shard_table(mesh, permute_table(self.P, rs["u_pos"],
                                                    rs["u_pad"]))
            Q = par.shard_table(mesh, permute_table(self.Q, rs["i_pos"],
                                                    rs["i_pad"]))

            def to_host(P, Q):
                return (par.gather_table(mesh, P)[rs["u_pos"]],
                        par.gather_table(mesh, Q)[rs["i_pos"]])
        elif rs is not None:
            P = torch.from_numpy(permute_table(self.P, rs["u_pos"],
                                               rs["u_pad"])).to(dev)
            Q = torch.from_numpy(permute_table(self.Q, rs["i_pos"],
                                               rs["i_pad"])).to(dev)

            def to_host(P, Q):
                return (P.cpu().numpy()[rs["u_pos"]],
                        Q.cpu().numpy()[rs["i_pos"]])
        else:
            P = torch.from_numpy(self.P).to(dev, copy=True)
            Q = torch.from_numpy(self.Q).to(dev, copy=True)

            def to_host(P, Q):
                return P.cpu().numpy(), Q.cpu().numpy()

        self.logger.info(
            f"Train pLSI, K: {opt.d}, alpha1: {opt.alpha1}, "
            f"alpha2: {opt.alpha2}")

        def _sync_host():
            # closure over the loop's current device tables
            self.P, self.Q = to_host(P, Q)
        self._sync_host_factors = _sync_host

        best_loss, loss, self.validation_result = 1e10, None, {}
        full_st = time.time()
        self.iteration_times = []   # per-epoch train seconds
        self.iteration_losses = []  # per-epoch train loss
        alpha1, alpha2 = float(opt.alpha1), float(opt.alpha2)
        for i in range(opt.num_iters):
            start_t = time.time()
            if mesh is not None:
                P, Q, epoch_loss = K.plsi_epoch_sharded_range(
                    P, Q, rs["row_groups"], rs["col_groups"],
                    rs["row_segments"], rs["col_segments"], rs["p_mask"],
                    rs["q_mask"], mesh=mesh, alpha1=alpha1, alpha2=alpha2,
                    num_items=int(self.num_items))
            elif rs is not None:
                P, Q, epoch_loss = K.plsi_epoch_range(
                    P, Q, rs["row_groups"], rs["col_groups"], rs["p_mask"],
                    rs["q_mask"], alpha1=alpha1, alpha2=alpha2,
                    num_items=int(self.num_items))
            else:
                # resident batches are staged once; past resident_mb the
                # batcher stages them as the loop goes
                P, Q, epoch_loss = K.plsi_epoch(P, Q, batcher, alpha1=alpha1,
                                                alpha2=alpha2)
            loss_nume = float(epoch_loss)  # a device readback: ends the epoch
            train_t = time.time() - start_t
            self.iteration_times.append(train_t)
            loss = loss_nume / (loss_deno + opt.eps)
            self.iteration_losses.append(loss)
            metrics = {"train_loss": loss}
            if opt.get("validation") and opt.evaluation_on_learning and \
                    self.periodical(opt.evaluation_period, i):
                start_t = time.time()
                self.P, self.Q = to_host(P, Q)
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
            self.logger.info("Iteration %d: Loss %.3f Elapsed %.3f secs"
                             % (i + 1, loss, train_t))
            best_loss = self.save_best_only(loss, best_loss, i)
            if self.early_stopping(loss):
                break
        self.P, self.Q = to_host(P, Q)
        self._sync_host_factors = None
        self._mesh_range = None
        self.logger.info(
            f"elapsed for full epochs: {time.time() - full_st:.2f} sec")
        ret = {"train_loss": loss}
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
