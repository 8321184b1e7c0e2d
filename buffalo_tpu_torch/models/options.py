"""Per-algorithm option factories: defaults + validation.

Copy of ``buffalo_tpu.models.options`` for the PyTorch port, with the
algorithms this port has so far (``AlgoOption``, ``ALSOption``,
``BPRMFOption``, ``WARPOption``, ``EALSOption``, ``PLSIOption``,
``CFROption``, ``W2VOption``): same
hyperparameter names and defaults, so configurations port over
unchanged.  One key is the port's own: ``device`` ("cuda" by default;
"cpu" runs the plain PyTorch versions of the kernels), and an optional
``devices`` list naming the shards' devices of a mesh.  The reference's
device keys (``num_devices``, ``sharding``, ``resident_mb``,
``range_layout``, ``epoch_dispatch``, ``vals_dtype``) keep their
defaults; more than one device trains ALS, eALS and pLSI over a device
mesh, and BPR-MF, WARP, CoFactor and W2V over a dp mesh (replicated
tables, batch-sharded chunks or batches).
"""
from __future__ import annotations

from buffalo_tpu_torch.utils import Option
from buffalo_tpu_torch.utils.option import InputOptions


class AlgoOption(InputOptions):
    def get_default_option(self) -> Option:
        """Common options (reference options.py:8-30).

        :ivar bool evaluation_on_learning: run evaluation during training.
        :ivar bool compute_loss_on_training: compute loss during training.
        :ivar int early_stopping_rounds: epochs of patience after minimum
            loss (0 disables).
        :ivar bool save_best: save the model whenever loss improves.
        :ivar int evaluation_period: evaluation cadence in epochs.
        :ivar int save_period: save_best cadence in epochs.
        :ivar int random_seed: seed for factor init and sampling.
        :ivar dict validation: validation options (topk, batch, eval_samples).
        :ivar str device: torch device the model trains and serves on
            ("cuda" or "cpu"); a CUDA device without a card raises.
        :ivar list devices: optional, the port's own: the devices of a
            mesh's local shards (repeats put several shards on one
            device, e.g. ``["cuda:0"] * 4`` or ``["cpu"] * 8``); unset,
            a mesh takes the first cards and raises when there are
            fewer than ``num_devices``.

        Reference device keys (same defaults): ``num_devices`` (mesh size
        of every model's training; ALS meshes over every card at 0 when
        there are several, the others only past 1), ``sharding``
        ("dp", "dp+tp"), ``resident_mb``
        (budget for keeping the epoch's batches on the device; past it
        they stream), ``range_layout`` (False: the scatter layout),
        ``epoch_dispatch`` (validated; the port launches per batch
        either way) and ``vals_dtype`` (auto, float32 or bfloat16, for
        the range layout's values).
        """
        return Option({
            "evaluation_on_learning": True,
            "compute_loss_on_training": True,
            "early_stopping_rounds": 0,
            "save_best": False,
            "evaluation_period": 1,
            "save_period": 10,
            "random_seed": 0,
            "validation": {},
            "device": "cuda",
            "num_devices": 0,
            "sharding": "dp",
            "resident_mb": 4096,
            "range_layout": True,
            "epoch_dispatch": "auto",
            "vals_dtype": "auto",
        })

    def is_valid_option(self, opt) -> bool:
        b = super().is_valid_option(opt)
        for f in ["num_workers"]:
            if f not in opt:
                raise RuntimeError(f"{f} not defined")
        return b


class ALSOption(AlgoOption):
    def get_default_option(self) -> Option:
        """Alternating Least Squares (reference options.py:40-86).

        :ivar bool adaptive_reg: scale L2 by per-row interaction count.
        :ivar int d: latent dimension.
        :ivar float reg_u / reg_i: L2 coefficients.
        :ivar float alpha: implicit-feedback confidence coefficient.
        :ivar str optimizer: llt | ldlt | manual_cg | eigen_cg | eigen_bicg |
            eigen_gmres | eigen_dgmres | eigen_minres | ialspp.
        :ivar int num_cg_max_iters: CG iteration cap.
        :ivar int block_size: iALS++ subspace block size.
        :ivar int stored_width: accepted for parity; the reference's
            zero-padding rule is a TPU tuning, so the port stores at d
            (padding is exact, so results do not depend on it).
        """
        opt = super().get_default_option()
        opt.update({
            "adaptive_reg": False,
            "save_factors": False,
            "accelerator": False,
            "stored_width": 0,
            "d": 20,
            "num_iters": 10,
            "num_workers": 1,
            "hyper_threads": 256,
            "num_cg_max_iters": 3,
            "reg_u": 0.1,
            "reg_i": 0.1,
            "alpha": 8.0,
            "optimizer": "manual_cg",
            "cg_tolerance": 1e-10,
            "block_size": 32,
            "eps": 1e-10,
            "model_path": "",
            "data_opt": {},
        })
        return Option(opt)

    def is_valid_option(self, opt) -> bool:
        b = super().is_valid_option(opt)
        possible = ["llt", "ldlt", "manual_cg", "eigen_cg", "eigen_bicg",
                    "eigen_gmres", "eigen_dgmres", "eigen_minres", "ialspp"]
        if opt.optimizer not in possible:
            raise RuntimeError(
                f"optimizer ({opt.optimizer}) should be in {possible}")
        return b


class BPRMFOption(AlgoOption):
    def get_default_option(self) -> Option:
        """Bayesian Personalized Ranking MF (reference options.py:189-253;
        the JAX package's ``BPRMFOption``, same names and defaults).

        :ivar bool use_bias: item bias term.
        :ivar str optimizer: sgd | adagrad | adam.
        :ivar float lr / min_lr: learning rate and its decay floor (sgd
            decays linearly with progress inside the epoch).
        :ivar bool per_coordinate_normalize: divide the epoch's
            accumulated gradients by per-row sample counts (adam/adagrad).
        :ivar float sampling_power: 0 = uniform negatives, > 0 =
            popularity^power (alias tables built from the int32 CDF).
        :ivar bool verify_neg: reject negatives present in the user's
            positives (a blocked bloom filter; 4 attempts, else a
            sentinel that trains nothing).
        :ivar bool random_positive: draw each slot's positive uniformly
            from the user's list (resident epoch only).
        :ivar float max_step_norm: per-row L2 cap on each chunk's
            aggregated sgd update (0 disables).
        :ivar int batch_size: (user, positive) pairs per chunk; 0 =
            min(max(nnz // 32, 1024), 2^19).
        :ivar str epoch_dispatch: auto | fused | split, validated; on the
            card every choice runs the same sample-then-update launches
            per chunk (the JAX package's split is bit-identical to its
            fused epoch).
        :ivar int stored_width: accepted for parity; the reference pads
            sub-64 tables on a TPU backend only, so the port stores at d.
        """
        opt = super().get_default_option()
        opt.update({
            "accelerator": False,
            "use_bias": True,
            "evaluation_period": 100,
            "num_workers": 1,
            "hyper_threads": 256,
            "num_iters": 100,
            "d": 20,
            "update_i": True,
            "update_j": True,
            "reg_u": 0.025,
            "reg_i": 0.025,
            "reg_j": 0.025,
            "reg_b": 0.025,
            "optimizer": "sgd",
            "lr": 0.05,
            "min_lr": 0.0001,
            "beta1": 0.9,
            "beta2": 0.999,
            "eps": 1e-10,
            "per_coordinate_normalize": False,
            "num_negative_samples": 1,
            "sampling_power": 0.0,
            "verify_neg": True,
            "random_positive": False,
            "max_step_norm": 0.1,
            "batch_size": 0,
            "epoch_dispatch": "auto",
            "stored_width": 0,
            "model_path": "",
            "data_opt": {},
        })
        return Option(opt)


class EALSOption(AlgoOption):
    def get_default_option(self) -> Option:
        """Element-wise ALS (reference options.py:98-132; the JAX package's
        ``EALSOption``, same names and defaults).

        :ivar float c0: strength of negative feedback.
        :ivar float exponent: popularity exponent for negative weights.
        """
        opt = super().get_default_option()
        opt.update({
            "save_factors": False,
            "d": 20,
            "num_iters": 10,
            "num_workers": 1,
            "reg_u": 0.1,
            "reg_i": 0.1,
            "alpha": 8.0,
            "c0": 512.0,
            "exponent": 0.5,
            "model_path": "",
            "data_opt": {},
        })
        return Option(opt)


class WARPOption(AlgoOption):
    def get_default_option(self) -> Option:
        """WARP / CML (reference options.py:256-312; the JAX package's
        ``WARPOption``, same names and defaults).

        :ivar int max_trials: negative-search attempt cap; the candidates
            per positive are min(max(max_trials, 2), 64).
        :ivar str score_func: dot | l2 (CML).
        :ivar float threshold: margin.
        :ivar str optimizer: adagrad | adam (deferred, one step per epoch).
        :ivar bool adaptive_trials: start at 16 candidates and double them
            (up to the cap) after an epoch in which fewer than 98% of the
            positives found a violator (resident epoch only).
        :ivar str probe_mode: "lazy" (probe the bloom filter at the first
            four margin violators only) | "all" (every candidate: the
            reference's exact trial ranks).
        :ivar str epoch_dispatch: auto | fused | split; "split" probes
            every candidate into packed seen-bits first and forces
            probe_mode "all", as in the JAX package.
        :ivar int stored_width: accepted for parity; the reference pads
            sub-64 tables on a TPU backend only, so the port stores at d.
        """
        opt = super().get_default_option()
        opt.update({
            "accelerator": False,
            "evaluation_period": 5,
            "num_workers": 1,
            "hyper_threads": 256,
            "num_iters": 40,
            "d": 64,
            "threshold": 1.0,
            "score_func": "dot",
            "max_trials": 500,
            "adaptive_trials": True,
            "probe_mode": "lazy",
            "epoch_dispatch": "auto",
            "stored_width": 0,
            "update_i": True,
            "update_j": True,
            "reg_u": 0.0,
            "reg_i": 0.0,
            "reg_j": 0.0,
            "optimizer": "adagrad",
            "lr": 0.05,
            "min_lr": 0.0001,
            "beta1": 0.9,
            "beta2": 0.999,
            "eps": 1e-10,
            "per_coordinate_normalize": False,
            "batch_size": 0,
            "model_path": "",
            "data_opt": {},
        })
        return Option(opt)


class CFROption(AlgoOption):
    def get_default_option(self) -> Option:
        """CoFactor (reference options.py:135-177; the JAX package's
        ``CFROption``, same names and defaults).

        :ivar float reg_c: L2 for the context embedding.
        :ivar float l: weight of user-item loss vs item-context loss.
        """
        opt = super().get_default_option()
        opt.update({
            "save_factors": False,
            "d": 20,
            "num_iters": 10,
            "num_workers": 1,
            "num_cg_max_iters": 3,
            "cg_tolerance": 1e-10,
            "eps": 1e-10,
            "reg_u": 0.1,
            "reg_i": 0.1,
            "reg_c": 0.1,
            "alpha": 8.0,
            "l": 1.0,
            "optimizer": "manual_cg",
            "model_path": "",
            "data_opt": {},
        })
        return Option(opt)

    def is_valid_option(self, opt) -> bool:
        b = super().is_valid_option(opt)
        possible = ["llt", "ldlt", "manual_cg", "eigen_cg", "eigen_bicg",
                    "eigen_gmres", "eigen_dgmres", "eigen_minres"]
        if opt.optimizer not in possible:
            raise RuntimeError(
                f"optimizer ({opt.optimizer}) should be in {possible}")
        return b


class PLSIOption(AlgoOption):
    def get_default_option(self) -> Option:
        """pLSI EM (reference options.py:355-385; the JAX package's
        ``PLSIOption``, same names and defaults).

        :ivar float alpha1: smoothing for cluster assignment P(z|u).
        :ivar float alpha2: smoothing for item preference P(i|z).
        """
        opt = super().get_default_option()
        opt.update({
            "d": 20,
            "num_iters": 10,
            "num_workers": 1,
            "alpha1": 1.0,
            "alpha2": 1.0,
            "eps": 1e-10,
            "model_path": "",
            "save_factors": False,
            "data_opt": {},
            "inherit_opt": {},
        })
        return Option(opt)


class W2VOption(AlgoOption):
    def get_default_option(self) -> Option:
        """Skip-gram word2vec over streams (reference options.py:315-352;
        the JAX package's ``W2VOption``, same names and defaults).

        :ivar int window: context window size (< 256: the stream epoch's
            half-windows travel as uint8).
        :ivar int min_count: vocabulary frequency floor.
        :ivar float sample: frequent-word subsampling threshold.
        :ivar int num_negative_samples: negatives per (center, context).
        :ivar float max_step_norm: per-row L2 cap on each chunk's
            aggregated update (0 disables).
        :ivar int max_chunks_per_dispatch: chunks per group; an epoch of
            more chunks runs as groups of this many (padded with sentinel
            chunks), each group keyed and rated as in the JAX package.
        :ivar int stored_width: accepted for parity; the reference pads
            sub-64 tables on a TPU backend only, so the port stores at d.
        :ivar str pair_gen: where skip-gram pairs are expanded.  "host"
            generates (input, target) pairs on the host each epoch and
            trains on them in chunks (K19 + K20); "device" ships the
            subsampled token stream (6 bytes a token) and expands the
            windows on the card with block-shared negatives (K8 + K21 +
            K20).  "auto" = "device" when the model's device is CUDA and
            "host" on the CPU: the JAX package's rule ("device" on its
            accelerator) mapped onto the card.
        :ivar str offset_mode: "scan" | "unrolled", validated; both run
            the same offsets in order on the card (the JAX package's two
            programs agree to float32 reordering).
        :ivar int neg_block: "device" pair_gen only: consecutive tokens
            sharing one set of negative draws (shrunk for micro-corpora).
        :ivar int batch_size: pairs per chunk ("host") or tokens per chunk
            ("device"); 0 picks the JAX package's sizes.
        """
        opt = super().get_default_option()
        opt.update({
            "evaluation_on_learning": False,
            "num_workers": 1,
            "num_iters": 3,
            "d": 20,
            "window": 5,
            "min_count": 5,
            "sample": 0.001,
            "num_negative_samples": 5,
            "lr": 0.025,
            "min_lr": 0.0001,
            "max_step_norm": 0.1,
            "max_chunks_per_dispatch": 32,
            "stored_width": 0,
            "pair_gen": "auto",
            "offset_mode": "scan",
            "neg_block": 4,
            "batch_size": 0,
            "model_path": "",
            "data_opt": {},
        })
        return Option(opt)
