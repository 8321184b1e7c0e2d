"""WARP (Weighted Approximate-Rank Pairwise) MF / CML on one CUDA device.

PyTorch counterpart of ``buffalo_tpu.models.warp``: the same model
(rank-weighted pairwise updates with adaptive negative search, ``dot`` or
``l2`` (collaborative metric learning) scores, deferred adagrad/adam with
optional per-coordinate normalization, per-epoch unit-ball projection,
violation-rate training loss), options, initialization, loss samples,
validation and save/load byte format.  The epoch is the reference's
resident one — the positives in CSR order as (nchunks, N) chunks on the
device, the candidate budget K adaptive from 16 — or, when the positives
exceed ``resident_mb``, its streaming path over ``COOBatcher``'s shuffled
chunks.  Per chunk K11 searches the violators and K12 accumulates the
gradients (``ops/warp_kernels.py``; their plain PyTorch versions on the
CPU); K10's projection mode is the epoch barrier.  The candidates come
from the port's own counter-based generator, so a run draws other
candidates than the JAX package's from the same seed (the tests inject the
JAX package's to compare the math).  With ``num_devices > 1`` the
resident epoch runs on a dp mesh (``_select_dp_mesh``;
``warp_kernels.warp_epoch``): the chunks split over the shards, the
tables replicated, one all-reduce at the epoch barrier.

Reference: Weston et al., WSABIE (IJCAI 2011); Hsieh et al.,
Collaborative Metric Learning (WWW 2017).
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
from buffalo_tpu_torch.models.options import WARPOption
from buffalo_tpu_torch.ops import sgd_kernels as S
from buffalo_tpu_torch.ops import warp_kernels as W
from buffalo_tpu_torch.parallelism import Mesh


def default_batch_size(nnz: int, d: int, max_trials: int) -> int:
    """Positives per chunk (``warp.py:29``): at least 32 sequential steps
    per epoch, and the JAX package's 512 MB budget for a (batch, K, d)
    candidate tensor at the worst K (K11 never builds it; the rule is kept
    so both packages step through the same chunks)."""
    batch_size = min(max(nnz // 32, 1024), 1 << 18)
    k_worst = int(min(max(int(max_trials), 2), W.MAX_CANDIDATES))
    cap = (512 << 20) // max(k_worst * int(d) * 4, 1)
    return max(min(batch_size, cap), 1024)


class WARP(Algo, WARPOption, Evaluable, Serializable):
    """WARP training and serving on a torch device."""

    def __init__(self, opt_path=None, *args, **kwargs):
        Algo.__init__(self, *args, **kwargs)
        WARPOption.__init__(self, *args, **kwargs)
        Evaluable.__init__(self, *args, **kwargs)
        Serializable.__init__(self, *args, **kwargs)
        self._setup_driver(opt_path, WARPOption, "WARP", ["matrix"], kwargs)

    @staticmethod
    def new(path, data_fields=[], device="cuda"):
        return WARP.instantiate(WARPOption, path, data_fields, device=device)

    def set_data(self, data):
        assert isinstance(data, Data), f"Wrong instance: {type(data)}"
        self.data = data

    def normalize(self, group="item"):
        if str(self.opt.score_func) == "l2":
            # distances are not scale-invariant (warp.py:63-64)
            self.logger.warning(
                "Normalization will harm performance if score func is L2")
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
        """|N(0, 1/d^2)| P and Q with numpy, in the reference's order: the
        same ``np.random`` state gives both packages the same tables."""
        assert self.data, "Data is not set"
        header = self.data.get_header()
        d = self.opt.d
        self.num_nnz = header["num_nnz"]
        for name, rows in [("P", header["num_users"]),
                           ("Q", header["num_items"])]:
            setattr(self, name, np.abs(np.random.normal(
                scale=1.0 / (d ** 2), size=(rows, d)).astype("float32")))

    # ------------------------------------------------------------- retrieval
    def _get_topk_recommendation(self, rows, topk, pool=None):
        """dot: plain MIPS; l2: the top of -(|p - q|^2), i.e. of 2 p.q -
        |q|^2 (|p|^2 is constant per row; ``warp.py:94-107``), through K5
        with the query 2p and the item bias -|q|^2."""
        p = self.P[rows]
        if str(self.opt.score_func) == "l2":
            topks = super()._get_topk_recommendation(
                2.0 * p, self.Q, pb=None, Qb=-(self.Q * self.Q).sum(axis=1),
                pool=pool, topk=topk, num_workers=self.opt.num_workers)
        else:
            topks = super()._get_topk_recommendation(
                p, self.Q, pb=None, Qb=None, pool=pool, topk=topk,
                num_workers=self.opt.num_workers)
        return zip(rows, topks)

    def _get_most_similar_item(self, col, topk, pool):
        if str(self.opt.score_func) == "l2":
            # CML neighbours rank by squared L2 distance, not cosine
            # (warp.py:109-137); the returned scores are the distances
            if isinstance(col, np.ndarray):
                q = col
            else:
                q = self.Q[col]
                topk += 1  # the query itself ranks first, dropped later
            candidates = self.Q if pool is None else self.Q[pool]
            neg_dist = -((candidates - q) ** 2).sum(axis=-1)
            picked = self.get_topk(neg_dist, k=topk,
                                   num_threads=self.opt.num_workers)
            best = -neg_dist[picked]
            if pool is not None:
                picked = np.asarray(pool)[picked]
            return picked, best
        return super()._get_most_similar_item(
            col, topk, self.Q, self.opt.get("_nrz_Q", False), pool)

    def get_scores(self, row_col_pairs):
        if str(self.opt.score_func) == "l2":
            return {(r, c): -float(((self.P[r] - self.Q[c]) ** 2).sum())
                    for r, c in row_col_pairs}  # warp.py:139-143
        return {(r, c): float(self.P[r].dot(self.Q[c]))
                for r, c in row_col_pairs}

    def _get_scores(self, row, col):
        if str(self.opt.score_func) == "l2":
            # the reference's validation variant offsets by +1
            # (warp.py:146-150), kept for metric parity
            return 1.0 - ((self.P[row] - self.Q[col]) ** 2).sum(axis=-1)
        return (self.P[row] * self.Q[col]).sum(axis=1)

    # -------------------------------------------------------------- training
    def sampling_loss_samples(self):
        """sqrt(U) fixed (u, i+, j-) triplets for the violation rate, drawn
        with ``np.random`` as the reference draws them
        (``warp.py:145-168``)."""
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
        return float(W.warp_loss(
            self._P, self._Q,
            *(torch.from_numpy(a).to(dev) for a in (users, positives,
                                                     negatives)),
            score_func=str(self.opt.score_func),
            threshold=float(self.opt.threshold)))

    def _check_supported(self):
        opt = self.opt
        if opt.optimizer not in ("adam", "adagrad"):
            raise ValueError(f"optimizer must be adagrad or adam, got "
                             f"{opt.optimizer!r}")

    def _batch_size(self) -> int:
        """Positives per chunk: the option, else ``default_batch_size`` at
        the stored width d."""
        batch_size = int(self.opt.get("batch_size") or 0)
        if batch_size <= 0:
            batch_size = default_batch_size(self.num_nnz, int(self.opt.d),
                                            int(self.opt.max_trials))
        return batch_size

    def train(self, training_callback: Optional[
            Callable[[int, Dict[str, float]], None]] = None) -> Dict[str, float]:
        assert self.data, "Data is not set"
        self._check_supported()
        opt = self.opt
        dev = self.device
        num_items = int(self.data.get_header()["num_items"])
        batch_size = self._batch_size()
        group = self.data.get_group("rowwise")
        indptr = torch.from_numpy(np.array(group["indptr"],
                                           dtype=np.int64)).to(dev)
        words, bloom_log2 = S.build_bloom(np.asarray(group["indptr"]),
                                          np.asarray(group["key"]))
        bloom = torch.from_numpy(words.view(np.int32)).to(dev)

        resident = (self.num_nnz * 8) <= int(opt.get("resident_mb", 4096)) \
            * 1024 * 1024
        dispatch = str(opt.get("epoch_dispatch") or "auto")
        if dispatch not in ("auto", "fused", "split"):
            raise ValueError(
                f"epoch_dispatch must be auto|fused|split, got {dispatch!r}")
        split_probe = dispatch == "split"
        if split_probe and not resident:
            self.logger.warning(
                "epoch_dispatch='split' applies to the device-resident "
                "fused epoch only; the streaming path ignores it")
            split_probe = False
        # dp mesh opt-in (the BPR rule: an explicit num_devices > 1)
        mesh = self._select_dp_mesh(resident, split_probe)
        if resident:
            # the resident epoch runs on a dp mesh, one device being a mesh
            # of one shard; the chunk width divides over it (warp.py:234)
            mesh = mesh or Mesh([dev])
            batch_size = -(-batch_size // mesh.size) * mesh.size
            # one replica of the tables, the moments, indptr and the bloom
            # filter per device; self._P / _Q are the first shard's
            tables, opt_states, idx, blm = {}, {}, {}, {}
            for mdev in S.replica_shards(mesh):
                tables[mdev] = tuple(torch.from_numpy(a).to(mdev, copy=True)
                                     for a in (self.P, self.Q))
                opt_states[mdev] = W.new_opt_state(*tables[mdev])
                idx[mdev], blm[mdev] = indptr.to(mdev), bloom.to(mdev)
            self._P, self._Q = tables[mesh.devices[0]]
            users_np, items_np, nnz = csr_pair_chunks(self.data, batch_size)
            users_s, items_s = self._stage_dp_shards(mesh,
                                                     (users_np, items_np))
        else:
            # the tables live on the device; self.P/Q are synced back
            self._P = torch.from_numpy(self.P).to(dev, copy=True)
            self._Q = torch.from_numpy(self.Q).to(dev, copy=True)
            opt_state = W.new_opt_state(self._P, self._Q)
            coo = COOBatcher(self.data, chunk_size=batch_size, shuffle=True,
                             seed=int(opt.random_seed))
            grads = W.new_accumulators(self._P, self._Q)

        cand_cap = int(min(max(int(opt.max_trials), 2), W.MAX_CANDIDATES))
        adaptive = bool(opt.get("adaptive_trials", False)) and resident
        num_candidates = (min(W.ADAPTIVE_START, cand_cap) if adaptive
                          else cand_cap)
        probe_mode = str(opt.get("probe_mode") or "lazy")
        if probe_mode not in ("lazy", "all"):
            raise ValueError(
                f"probe_mode must be lazy|all, got {probe_mode!r}")
        if split_probe and probe_mode == "lazy":
            # the split pass ships every candidate's bit (warp.py:280-285)
            self.logger.debug("epoch_dispatch='split' forces "
                              "probe_mode='all'")
            probe_mode = "all"
        statics = dict(num_items=num_items, score_func=str(opt.score_func),
                       threshold=float(opt.threshold),
                       reg_u=float(opt.reg_u), reg_i=float(opt.reg_i),
                       reg_j=float(opt.reg_j), update_i=bool(opt.update_i),
                       update_j=bool(opt.update_j),
                       per_coordinate_normalize=bool(
                           opt.per_coordinate_normalize),
                       bloom_log2=bloom_log2, probe=probe_mode)
        rates = dict(optimizer=str(opt.optimizer), lr=float(opt.lr),
                     beta1=float(opt.beta1), beta2=float(opt.beta2))
        seed = int(opt.random_seed)

        self.sampling_loss_samples()

        def _sync_host():
            self.P = self._P.cpu().numpy()
            self.Q = self._Q.cpu().numpy()
        self._sync_host_factors = _sync_host

        best_loss, loss, self.validation_result = float("inf"), None, {}
        full_st = time.time()
        self.iteration_times = []         # per-epoch train seconds
        self.iteration_losses = []        # per-epoch violation rate
        self.iteration_candidates = []    # K per epoch
        self.iteration_found = []         # found_frac per epoch (resident)
        for i in range(opt.num_iters):
            start_t = time.time()
            found_frac = None
            self.iteration_candidates.append(num_candidates)
            if resident:
                seen_bits = None
                if split_probe:
                    # pass 1: every candidate's seen bit; the update pass
                    # redraws the same candidates and reads the bits
                    seen_bits = [W.warp_probe_epoch(
                        users_s[0], bloom, seed=seed, epoch=i,
                        num_items=num_items, num_candidates=num_candidates,
                        bloom_log2=bloom_log2)]
                found_frac = W.warp_epoch(
                    mesh, tables, opt_states, users_s, items_s, i, seed=seed,
                    indptr=idx, bloom=blm, num_candidates=num_candidates,
                    num_valid=nnz, seen_bits=seen_bits, **statics, **rates)
            else:
                for c, (users, positives, _vals) in enumerate(coo):
                    W.warp_accumulate_step(
                        self._P, self._Q, *grads,
                        torch.from_numpy(users).to(dev),
                        torch.from_numpy(positives).to(dev), indptr, bloom,
                        seed=seed, epoch=i, chunk=c,
                        num_candidates=num_candidates, **statics)
                W.apply_epoch_barrier(
                    self._P, self._Q, grads, opt_state, i,
                    reg_u=statics["reg_u"], reg_i=statics["reg_i"],
                    per_coordinate_normalize=statics[
                        "per_coordinate_normalize"], **rates)
                if statics["per_coordinate_normalize"]:
                    grads[2].zero_()
                    grads[3].zero_()

            loss = self.compute_loss()  # a device readback: ends the epoch
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            train_t = time.time() - start_t
            self.iteration_times.append(train_t)
            self.iteration_losses.append(loss)
            self.iteration_found.append(found_frac)
            if adaptive and found_frac is not None and found_frac < 0.98 \
                    and num_candidates < cand_cap:
                # more candidates as violators get rarer (warp.py:364-376)
                num_candidates = min(2 * num_candidates, cand_cap)
                self.logger.debug(f"found_frac {found_frac:0.3f}: raising "
                                  f"num_candidates to {num_candidates}")
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
        del self._P, self._Q
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
        data.extend([("opt", self.opt), ("P", self.P), ("Q", self.Q)])
        return data

    def get_evaluation_metrics(self):
        return ["train_loss", "val_ndcg", "val_map", "val_accuracy",
                "val_auc"]
