"""Bayesian Personalized Ranking matrix factorization on one CUDA device.

PyTorch counterpart of ``buffalo_tpu.models.bpr``: the same model (MF +
item bias on sampled (u, i+, j-) triplets, log-sigmoid loss), options,
initialization, loss samples, validation and save/load byte format.  The
epoch is the reference's resident one — the positives in CSR order as
(nchunks, N) chunks on the device, sgd with the linear learning-rate
decay and the per-row step cap, or adam/adagrad with one deferred step
per epoch — or, when the positives exceed ``resident_mb``, its streaming
path over ``COOBatcher``'s shuffled chunks.  Per chunk K8 draws and
verifies the negatives and K9 applies the update (``ops/sgd_kernels.py``;
their plain PyTorch versions on the CPU); K10 is the deferred step.  The
negatives come from the port's own counter-based generator, so a run
draws other negatives than the JAX package's from the same seed (the
tests inject the JAX package's to compare the math).  With
``num_devices > 1`` the resident epoch runs on a dp mesh
(``_select_dp_mesh``; ``sgd_kernels.bpr_epoch``): the chunks, rounded
up to a multiple of the mesh size, split over the shards, the tables
replicated, each shard's draws the single device's.

Reference: Rendle et al., BPR: Bayesian Personalized Ranking from
Implicit Feedback (UAI 2009).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from buffalo_tpu_torch.data.base import Data
from buffalo_tpu_torch.data.batching import (COOBatcher, csr_pair_chunks,
                                              loss_triplets)
from buffalo_tpu_torch.evaluate import Evaluable
from buffalo_tpu_torch.models.base import Algo, Serializable
from buffalo_tpu_torch.models.options import BPRMFOption
from buffalo_tpu_torch.ops import sgd_kernels as K
from buffalo_tpu_torch.parallelism import Mesh


class BPRMF(Algo, BPRMFOption, Evaluable, Serializable):
    """BPR-MF training and serving on a torch device."""

    def __init__(self, opt_path=None, *args, **kwargs):
        Algo.__init__(self, *args, **kwargs)
        BPRMFOption.__init__(self, *args, **kwargs)
        Evaluable.__init__(self, *args, **kwargs)
        Serializable.__init__(self, *args, **kwargs)
        self._setup_driver(opt_path, BPRMFOption, "BPRMF", ["matrix"], kwargs)

    @staticmethod
    def new(path, data_fields=[], device="cuda"):
        return BPRMF.instantiate(BPRMFOption, path, data_fields, device=device)

    def set_data(self, data):
        assert isinstance(data, Data), f"Wrong instance: {type(data)}"
        self.data = data

    def normalize(self, group="item"):
        if group == "item" and not self.opt.get("_nrz_Q"):
            self.Q = self._normalize(self.Q)
            self.Qb = np.zeros_like(self.Qb)
            self.opt._nrz_Q = True
        elif group == "user" and not self.opt.get("_nrz_P"):
            self.P = self._normalize(self.P)
            self.opt._nrz_P = True

    def initialize(self):
        super().initialize()
        self.init_factors()
        self.prepare_sampling()

    def init_factors(self):
        """|N(0, 1/d^2)| P, Q and Qb with numpy, in the reference's order
        (``bpr.py:65-78``): the same ``np.random`` state gives both
        packages the same tables."""
        assert self.data, "Data is not set"
        header = self.data.get_header()
        d = self.opt.d
        self.num_nnz = header["num_nnz"]
        for name, rows in [("P", header["num_users"]),
                           ("Q", header["num_items"])]:
            setattr(self, name, np.abs(np.random.normal(
                scale=1.0 / (d ** 2), size=(rows, d)).astype("float32")))
        self.Qb = np.abs(np.random.normal(
            scale=1.0 / (d ** 2),
            size=(header["num_items"],)).astype("float32"))
        if not self.opt.use_bias:
            self.Qb *= 0

    def prepare_sampling(self):
        """Popularity^power CDF as a normalized int32 table (``bpr.py:80-
        97``); None for uniform negatives."""
        self._cum_table = None
        if self.opt.sampling_power > 0.0:
            group = self.data.get_group("colwise")
            counts = np.diff(np.asarray(group["indptr"])).astype(np.float64)
            counts = counts ** float(self.opt.sampling_power)
            cum = np.cumsum(counts)
            cum /= max(cum[-1], 1.0)
            self._cum_table = (cum * 0x7FFFFFFF).astype(np.int32)

    # ------------------------------------------------------------- retrieval
    def _get_topk_recommendation(self, rows, topk, pool=None):
        p = self.P[rows]
        Qb = self.Qb if self.opt.use_bias else None
        topks = super()._get_topk_recommendation(
            p, self.Q, pb=None, Qb=Qb, pool=pool, topk=topk,
            num_workers=self.opt.num_workers)
        return zip(rows, topks)

    def _get_most_similar_item(self, col, topk, pool):
        return super()._get_most_similar_item(
            col, topk, self.Q, self.opt.get("_nrz_Q", False), pool)

    def get_scores(self, row_col_pairs):
        return {(r, c): float(self.P[r].dot(self.Q[c]) + self.Qb[c])
                for r, c in row_col_pairs}

    def _get_scores(self, row, col):
        return (self.P[row] * self.Q[col]).sum(axis=1) + self.Qb[col]

    # -------------------------------------------------------------- training
    def sampling_loss_samples(self):
        """sqrt(U) fixed (u, i+, j-) triplets for the loss, drawn with
        ``np.random`` as the reference draws them (``bpr.py:120-144``)."""
        self._sub_samples = [np.zeros(0, np.int32)] * 3
        if self.opt.compute_loss_on_training:
            self._sub_samples = loss_triplets(self.data, self.P.shape[0],
                                              self.Q.shape[0])
            self.logger.info(f"Generated {len(self._sub_samples[0])} loss "
                             "samples.")

    def compute_loss(self) -> float:
        users, positives, negatives = self._sub_samples
        if len(users) == 0:
            return 0.0
        dev = self._P.device
        return float(K.bpr_loss(
            self._P, self._Q, self._Qb,
            *(torch.from_numpy(a).to(dev) for a in (users, positives,
                                                     negatives)),
            use_bias=bool(self.opt.use_bias)))

    def _check_supported(self):
        opt = self.opt
        if opt.optimizer not in ("sgd", "adam", "adagrad"):
            raise ValueError(f"optimizer must be sgd, adam or adagrad, got "
                             f"{opt.optimizer!r}")

    def _batch_size(self) -> int:
        """Pairs per chunk: the option, else min(max(nnz // 32, 1024),
        2^19) (``bpr.py:200-206``: at least 32 sequential steps)."""
        batch_size = int(self.opt.get("batch_size") or 0)
        if batch_size <= 0:
            batch_size = min(max(self.num_nnz // 32, 1024), 1 << 19)
        return batch_size

    def train(self, training_callback: Optional[
            Callable[[int, Dict[str, float]], None]] = None) -> Dict[str, float]:
        assert self.data, "Data is not set"
        self._check_supported()
        opt = self.opt
        dev = self.device
        optimizer = opt.optimizer
        deferred = optimizer != "sgd"
        use_bias = bool(opt.use_bias)
        pcn = bool(opt.per_coordinate_normalize)
        num_items = int(self.data.get_header()["num_items"])
        batch_size = self._batch_size()
        group = self.data.get_group("rowwise")

        # K8's inputs: the seed, the bloom filter of the positives
        # (verify_neg) and the alias tables (sampling_power > 0)
        sampling = dict(seed=int(opt.random_seed), bloom=None, bloom_log2=0,
                        alias=None)
        if bool(opt.verify_neg):
            words, log2 = K.build_bloom(np.asarray(group["indptr"]),
                                        np.asarray(group["key"]))
            sampling.update(bloom=torch.from_numpy(words.view(np.int32)).to(
                dev), bloom_log2=log2)
        if self._cum_table is not None:
            # popularity draws through Walker alias tables built from the
            # int32 CDF (CDF -> weights by diff), as the reference
            prob, alias = K.build_alias_table(
                np.diff(self._cum_table.astype(np.int64), prepend=0))
            sampling["alias"] = (torch.from_numpy(prob).to(dev),
                                 torch.from_numpy(alias).to(dev))
        rows = dict(num_negatives=int(opt.num_negative_samples),
                    use_bias=use_bias, update_i=bool(opt.update_i),
                    update_j=bool(opt.update_j))
        rates = dict(lr=float(opt.lr), beta1=float(opt.beta1),
                     beta2=float(opt.beta2))
        regs = dict(reg_u=float(opt.reg_u), reg_i=float(opt.reg_i),
                    reg_j=float(opt.reg_j), reg_b=float(opt.reg_b))
        max_step_norm = float(opt.get("max_step_norm", 0.0))

        resident = (self.num_nnz * 8) <= int(opt.get("resident_mb", 4096)) \
            * 1024 * 1024
        dispatch = str(opt.get("epoch_dispatch") or "auto")
        if dispatch not in ("auto", "fused", "split"):
            raise ValueError(
                f"epoch_dispatch must be auto|fused|split, got {dispatch!r}")
        random_positive = bool(opt.get("random_positive"))
        mesh = self._select_dp_mesh(resident, dispatch == "split")
        if resident:
            # the resident epoch runs on a dp mesh, one device being a mesh
            # of one shard; the chunk width divides over it (bpr.py:257)
            mesh = mesh or Mesh([dev])
            batch_size = -(-batch_size // mesh.size) * mesh.size
            if random_positive:
                sampling.update(
                    pos_indptr=torch.from_numpy(np.array(
                        group["indptr"], dtype=np.int64)),
                    pos_keys=torch.from_numpy(np.array(
                        group["key"], dtype=np.int32)))
            # one replica of the tables, the moments and K8's inputs per
            # device of the mesh; self._P / _Q / _Qb are the first shard's
            tables, opt_states, shard_sampling = {}, {}, {}
            for mdev in K.replica_shards(mesh):
                tables[mdev] = tuple(torch.from_numpy(a).to(mdev, copy=True)
                                     for a in (self.P, self.Q, self.Qb))
                opt_states[mdev] = (K.new_opt_state(*tables[mdev], use_bias)
                                    if deferred else {})
                shard_sampling[mdev] = {
                    k: (tuple(t.to(mdev) for t in v) if isinstance(v, tuple)
                        else v.to(mdev) if isinstance(v, torch.Tensor)
                        else v)
                    for k, v in sampling.items() if k != "seed"}
            self._P, self._Q, self._Qb = tables[mesh.devices[0]]
            users_np, items_np, nnz = csr_pair_chunks(self.data, batch_size)
            users_s, items_s = self._stage_dp_shards(mesh,
                                                     (users_np, items_np))
        else:
            if random_positive:
                # reference parity: the streaming path walks positives in
                # its shuffled order (options.py:216)
                self.logger.warning(
                    "random_positive is honored on the resident epoch "
                    "only; streaming epochs walk the shuffled positives")
            # the tables live on the device; self.P/Q/Qb are synced back
            self._P = torch.from_numpy(self.P).to(dev, copy=True)
            self._Q = torch.from_numpy(self.Q).to(dev, copy=True)
            self._Qb = torch.from_numpy(self.Qb).to(dev, copy=True)
            opt_state = (K.new_opt_state(self._P, self._Q, self._Qb,
                                         use_bias) if deferred else {})
            coo = COOBatcher(self.data, chunk_size=batch_size, shuffle=True,
                             seed=int(opt.random_seed))
            grads = (K.new_accumulators(self._P, self._Q, self._Qb)
                     if deferred else None)

        self.sampling_loss_samples()
        total_samples = float(self.num_nnz) * opt.num_iters
        processed = 0.0

        def _sync_host():
            self.P = self._P.cpu().numpy()
            self.Q = self._Q.cpu().numpy()
            self.Qb = self._Qb.cpu().numpy()
        self._sync_host_factors = _sync_host

        best_loss, loss, self.validation_result = float("inf"), None, {}
        full_st = time.time()
        self.iteration_times = []   # per-epoch train seconds
        self.iteration_losses = []  # per-epoch train loss
        for i in range(opt.num_iters):
            start_t = time.time()
            if resident:
                K.bpr_epoch(
                    mesh, tables, opt_states, users_s, items_s, i,
                    seed=sampling["seed"], sampling=shard_sampling,
                    optimizer=optimizer, num_items=num_items,
                    per_coordinate_normalize=pcn, min_lr=float(opt.min_lr),
                    num_valid=nnz, total_samples=total_samples,
                    max_step_norm=max_step_norm, **rows, **rates, **regs)
            else:
                for c, (users, positives, _vals) in enumerate(coo):
                    u = torch.from_numpy(users).to(dev)
                    p = torch.from_numpy(positives).to(dev)
                    neg, _ = K.sample_negatives(
                        u, num_items, num_negatives=rows["num_negatives"],
                        epoch=i, chunk=c, **sampling)
                    if deferred:
                        K.bpr_accumulate_step(
                            self._P, self._Q, self._Qb, *grads, u, p, neg,
                            per_coordinate_normalize=pcn, **rows)
                    else:
                        # linear lr decay by progress (algo.cc:283-287)
                        progress = processed / total_samples
                        lr = max(opt.lr - (opt.lr - opt.min_lr) * progress,
                                 opt.min_lr)
                        K.bpr_sgd_step(
                            self._P, self._Q, self._Qb, u, p, neg,
                            float(np.float32(lr)),
                            max_step_norm=max_step_norm, **rows, **regs)
                    processed += len(users)
                if deferred:
                    K.apply_epoch_barrier(
                        self._P, self._Q, self._Qb, grads, opt_state, i,
                        optimizer=optimizer, use_bias=use_bias,
                        per_coordinate_normalize=pcn, reg_u=regs["reg_u"],
                        reg_i=regs["reg_i"], reg_b=regs["reg_b"], **rates)
                    if pcn:
                        grads[3].zero_()
                        grads[4].zero_()

            loss = self.compute_loss()  # a device readback: ends the epoch
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            train_t = time.time() - start_t
            self.iteration_times.append(train_t)
            self.iteration_losses.append(loss)
            metrics = {"train_loss": loss}
            if opt.get("validation") and opt.evaluation_on_learning and \
                    self.periodical(opt.evaluation_period, i):
                start_t = time.time()
                _sync_host()
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
                "Iteration %d: Loss %.3f Elapsed %.3f secs (%.0f samples/s)"
                % (i + 1, loss, train_t,
                   self.num_nnz / max(train_t, 1e-9)))
            best_loss = self.save_best_only(loss, best_loss, i)
            if self.early_stopping(loss):
                break
        _sync_host()
        del self._P, self._Q, self._Qb
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
        data.extend([("opt", self.opt), ("P", self.P), ("Q", self.Q),
                     ("Qb", self.Qb)])
        return data

    def get_evaluation_metrics(self):
        return ["train_loss", "val_ndcg", "val_map", "val_accuracy",
                "val_auc"]
