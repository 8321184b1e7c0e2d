"""Element-wise ALS (eALS) on one CUDA device.

PyTorch counterpart of ``buffalo_tpu.models.eals``: coordinate-descent
implicit MF with popularity-weighted whole-data negative feedback ``C_i =
c0 * pop_i^exponent / sum(pop^exponent)`` (eals.py:104-110), the same
options, initialization, validation and save/load byte format.  The epoch
runs on the bucket-order range layout (both tables permuted once, each
batch a contiguous row range, head rows as segment batches) or, with
``range_layout=False``, over the CSR rows of each orientation with the
residuals carried between the halves through the row-to-column
permutation.  K13 sweeps each batch's dimensions and K14 computes the
residuals and the loss's sums (``ops/eals_kernels.py``; their plain
PyTorch versions on the CPU).  With ``num_devices`` > 1 the range layout
runs over a device mesh (``parallelism.get_mesh``, the shards' devices
named by the port's ``devices`` option): the per-shard layout of
``build_sharded_range_layout`` and ``eals_epoch_sharded_range``.

Reference: He et al., Fast Matrix Factorization for Online Recommendation
with Implicit Feedback (SIGIR 2016).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from buffalo_tpu_torch.data.base import Data
from buffalo_tpu_torch.data.batching import (BatchPlanner, build_range_layout,
                                             build_sharded_range_layout,
                                             choose_group_dispatch,
                                             padded_entry_count, permute_table,
                                             stage_batch, stage_shard_groups)
from buffalo_tpu_torch.evaluate import Evaluable
from buffalo_tpu_torch.models.base import Algo, Serializable
from buffalo_tpu_torch.models.options import EALSOption
from buffalo_tpu_torch.ops import eals_kernels as K


class EALS(Algo, EALSOption, Evaluable, Serializable):
    """eALS training and serving on a torch device."""

    def __init__(self, opt_path=None, *args, **kwargs):
        Algo.__init__(self, *args, **kwargs)
        EALSOption.__init__(self, *args, **kwargs)
        Evaluable.__init__(self, *args, **kwargs)
        Serializable.__init__(self, *args, **kwargs)
        self._setup_driver(opt_path, EALSOption, "EALS", ["matrix"], kwargs)

    @staticmethod
    def new(path, data_fields=[], device="cuda"):
        return EALS.instantiate(EALSOption, path, data_fields, device=device)

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
        """|N(0, 1/d^2)| P and Q with numpy, in the reference's order."""
        assert self.data, "Data is not set"
        header = self.data.get_header()
        d = self.opt.d
        for name, rows in [("P", header["num_users"]),
                           ("Q", header["num_items"])]:
            setattr(self, name, np.abs(np.random.normal(
                scale=1.0 / (d ** 2), size=(rows, d)).astype("float32")))

    def _get_negative_weights(self) -> np.ndarray:
        """C_i = c0 * (pop_i / max_pop)^exponent / sum (eals.py:104-110)."""
        indptr = np.asarray(self.data.get_group("colwise")["indptr"])
        pop = np.diff(indptr).astype(np.float32)
        pop /= max(pop.max(), 1.0)
        pe = pop ** float(self.opt.get("exponent", 0.0))
        return (float(self.opt.get("c0", 1.0)) * pe / pe.sum()
                ).astype(np.float32)

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
    def _train_state(self):
        """The epoch's data on the device (``eals.py:96-198``): the range
        layout's staged batches, the permuted negative weights and the
        permuted COO view for the loss; or (``range_layout=False``) both
        orientations' CSR and the row-to-column permutation."""
        dev = self.device
        header = self.data.get_header()
        num_users = int(header["num_users"])
        num_items = int(header["num_items"])
        rw = self.data.get_group("rowwise")
        rw_indptr = np.asarray(rw["indptr"], dtype=np.int64)
        u_rows = np.repeat(np.arange(num_users, dtype=np.int32),
                           np.diff(rw_indptr))
        u_keys = np.asarray(rw["key"], dtype=np.int32)
        u_vals = np.asarray(rw["val"], dtype=np.float32)
        cw = self.data.get_group("colwise")
        C = self._get_negative_weights()

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        if not bool(self.opt.get("range_layout", True)):
            cw_indptr = np.asarray(cw["indptr"], dtype=np.int64)
            # rowwise position -> colwise position (the cross-index maps
            # ind_u2i_ / ind_i2u_ of eals.cc:83-100)
            u2i = np.lexsort((u_rows, u_keys))
            return {"mode": "coo", "C": put(C),
                    "u": tuple(put(a) for a in (u_rows, u_keys, u_vals)),
                    "rw": (put(rw_indptr), put(u_keys), put(u_vals)),
                    "cw": (put(cw_indptr),
                           put(np.asarray(cw["key"], dtype=np.int32)),
                           put(np.asarray(cw["val"], dtype=np.float32))),
                    "u2i": put(u2i), "num_users": num_users,
                    "num_items": num_items}

        d = int(self.opt.d)
        batch_mb = int(self.data.opt.data.get("batch_mb", 1024))
        entries = max(batch_mb * 1024 * 1024 // (8 + 8 * d), 4096)
        rp = BatchPlanner(rw_indptr, entries_per_batch=entries)
        cp = BatchPlanner(np.asarray(cw["indptr"]), entries_per_batch=entries)
        mesh = self._select_mesh()
        if mesh is not None:
            # mesh training: the per-shard bucket-order layout, as the
            # ALS / pLSI sharded epochs (``eals.py:137-170``)
            from buffalo_tpu_torch import parallelism as par

            (row_g, col_g, row_seg, col_seg, u_pos, i_pos, S_u,
             S_i) = build_sharded_range_layout(
                rp, cp, u_keys, u_vals, np.asarray(cw["key"], np.int32),
                np.asarray(cw["val"], np.float32), mesh.size)
            u_pad, i_pad = mesh.size * S_u, mesh.size * S_i
            C_perm = np.zeros(i_pad, np.float32)
            C_perm[i_pos] = C
            dev0 = mesh.devices[0]

            def put0(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev0)
            return {
                "mode": "mesh", "mesh": mesh,
                "row_groups": stage_shard_groups(row_g, mesh),
                "col_groups": stage_shard_groups(col_g, mesh),
                "row_segments": [stage_batch(b, dev0) for b in row_seg],
                "col_segments": [stage_batch(b, dev0) for b in col_seg],
                "C": par.shard_table(mesh, C_perm), "u_pos": u_pos,
                "i_pos": i_pos, "u_pad": u_pad, "i_pad": i_pad,
                "u": (put0(u_pos[u_rows].astype(np.int32)),
                      put0(i_pos[u_keys].astype(np.int32)), put0(u_vals)),
                "num_users": num_users, "num_items": num_items,
            }
        row_b, col_b, u_pos, i_pos, u_pad, i_pad = build_range_layout(
            rp, cp, u_keys, u_vals, np.asarray(cw["key"], np.int32),
            np.asarray(cw["val"], np.float32))
        C_perm = np.zeros(i_pad, np.float32)
        C_perm[i_pos] = C
        # the reference's epoch_dispatch (auto|fused|group) is validated;
        # its two dispatches do the same arithmetic, and so does the port
        # (a launch per batch either way)
        choose_group_dispatch(self.opt, padded_entry_count(row_b + col_b))
        return {
            "mode": "range",
            "row_groups": [stage_batch(b, dev) for b in row_b],
            "col_groups": [stage_batch(b, dev) for b in col_b],
            "C": put(C_perm), "u_pos": u_pos, "i_pos": i_pos,
            "u_pad": u_pad, "i_pad": i_pad,
            # the permuted COO view for the loss pass
            "u": (put(u_pos[u_rows].astype(np.int32)),
                  put(i_pos[u_keys].astype(np.int32)), put(u_vals)),
            "num_users": num_users, "num_items": num_items,
        }

    def train(self, training_callback: Optional[
            Callable[[int, Dict[str, float]], None]] = None) -> Dict[str, float]:
        assert self.data, "Data is not set"
        opt = self.opt
        dev = self.device
        st = self._train_state()
        C = st["C"]
        du = st["u"]
        alpha, reg_u, reg_i = (float(opt.alpha), float(opt.reg_u),
                               float(opt.reg_i))
        if st["mode"] == "mesh":
            from buffalo_tpu_torch import parallelism as par

            mesh = st["mesh"]
            P = par.shard_table(mesh, permute_table(self.P, st["u_pos"],
                                                    st["u_pad"]))
            Q = par.shard_table(mesh, permute_table(self.Q, st["i_pos"],
                                                    st["i_pad"]))

            def to_host():
                return (par.gather_table(mesh, P)[st["u_pos"]],
                        par.gather_table(mesh, Q)[st["i_pos"]])
        elif st["mode"] == "range":
            P = torch.from_numpy(permute_table(self.P, st["u_pos"],
                                               st["u_pad"])).to(dev)
            Q = torch.from_numpy(permute_table(self.Q, st["i_pos"],
                                               st["i_pad"])).to(dev)

            def to_host():
                return (P.cpu().numpy()[st["u_pos"]],
                        Q.cpu().numpy()[st["i_pos"]])
        else:
            P = torch.from_numpy(self.P).to(dev, copy=True)
            Q = torch.from_numpy(self.Q).to(dev, copy=True)
            vhat_u = K.compute_vhat(P, Q, du[0], du[1])
            vhat_i = torch.empty_like(vhat_u)

            def to_host():
                return P.cpu().numpy(), Q.cpu().numpy()

        def _sync_host():
            self.P, self.Q = to_host()
        self._sync_host_factors = _sync_host

        best_loss, loss, self.validation_result = float("inf"), None, {}
        full_st = time.time()
        self.iteration_times = []   # per-epoch train seconds
        self.iteration_losses = []  # per-epoch RMSE
        for i in range(opt.num_iters):
            start_t = time.time()
            if st["mode"] == "mesh":
                K.eals_epoch_sharded_range(
                    P, Q, st["row_groups"], st["col_groups"],
                    st["row_segments"], st["col_segments"], C, mesh=mesh,
                    alpha=alpha, reg_u=reg_u, reg_i=reg_i)
                # the loss is K14 over the gathered tables
                rmse, total_loss = K.eals_loss(
                    par.all_gather_rows(mesh, P, first_only=True),
                    par.all_gather_rows(mesh, Q, first_only=True), None,
                    du[0], du[1], du[2],
                    par.all_gather_rows(mesh, C, first_only=True), reg_u,
                    reg_i, alpha=alpha)
            elif st["mode"] == "range":
                K.eals_epoch(P, Q, st["row_groups"], st["col_groups"], C,
                             alpha=alpha, reg_u=reg_u, reg_i=reg_i)
                vhat = None  # K14 recomputes the residuals with the sums
            else:
                rw_indptr, u_keys, u_vals = st["rw"]
                cw_indptr, i_keys, i_vals = st["cw"]
                K.eals_half_epoch(P, Q, vhat_u, rw_indptr, u_keys, u_vals, C,
                                  K.eals_gramian(Q, C), item_axis=False,
                                  alpha=alpha, reg=reg_u)
                # item side: the residuals in colwise order and back
                torch.index_select(vhat_u, 0, st["u2i"], out=vhat_i)
                K.eals_half_epoch(Q, P, vhat_i, cw_indptr, i_keys, i_vals, C,
                                  K.eals_gramian(P), item_axis=True,
                                  alpha=alpha, reg=reg_i)
                vhat_u[st["u2i"]] = vhat_i
                vhat = vhat_u
            if st["mode"] != "mesh":
                rmse, total_loss = K.eals_loss(P, Q, vhat, du[0], du[1],
                                               du[2], C, reg_u, reg_i,
                                               alpha=alpha)
            loss = float(rmse)  # a device readback: ends the epoch
            train_t = time.time() - start_t
            self.iteration_times.append(train_t)
            self.iteration_losses.append(loss)
            metrics = {"train_loss": loss}
            if opt.get("validation") and opt.evaluation_on_learning and \
                    self.periodical(opt.evaluation_period, i):
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
            self.logger.info(
                "Iteration %d: RMSE %.3f TotalLoss %.3f Elapsed %.3f secs"
                % (i + 1, loss, float(total_loss) / du[2].shape[0], train_t))
            best_loss = self.save_best_only(loss, best_loss, i)
            if self.early_stopping(loss):
                break
        self.P, self.Q = to_host()
        self._sync_host_factors = None
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
