"""Skip-gram word2vec over item streams on a CUDA device or a device mesh.

PyTorch counterpart of ``buffalo_tpu.models.w2v``: the same vocabulary
build (``min_count`` cut, the uint32 subsample scale table, the
cumulative unigram^0.75 table kept in the model file), initialization,
per-position shrunken windows, the linear rate decay by raw words,
``most_similar`` / ``most_similar_vec`` / ``analogy`` over the input
table L0 with the vocabulary remap, and the save/load byte format (the
``opt``, ``L0`` and ``_vocab`` records).  Two epochs, as in the JAX
package:

* **device** (``pair_gen`` "device"; "auto" on one CUDA device): per epoch
  the host subsamples the cached token stream and draws the half-windows
  (6 bytes a token: int32 word, uint8 sentence start, uint8 half-window);
  the card expands the windows per token chunk with block-shared
  negatives: K8's draws, K21's deltas, K20's capped adds
  (``ops/w2v_kernels.w2v_epoch_stream``).
* **host** (``pair_gen`` "host"; "auto" on the CPU or a mesh): the host
  expands every (input, target) pair (``data.native.w2v_pairs_native``,
  else numpy) and the card trains fixed-size pair chunks, K19 + K20 each
  (``w2v_epoch``), or, past ``resident_mb``, chunk by chunk with a host
  rate (``w2v_step``).

Chunks run in groups of ``max_chunks_per_dispatch`` with the JAX
package's padding, rates and group structure.  The negatives come from
the port's own counter-based generator, so a run draws other negatives
than the JAX package's from the same seed (the tests inject the JAX
package's to compare the math).

``num_devices > 1`` trains on a dp mesh (``Algo._select_dp_mesh``, over
``opt.devices`` when given), as the JAX package does: the tables
replicated, each pair chunk split on its batch axis (the chunk rounded up
to the mesh) or each token chunk on its position axis (T rounded up to
``neg_block`` x the mesh size); the shards draw the single device's
negatives, and the union of their delta rows is applied on every replica
(``ops/w2v_kernels``).  On a mesh "auto" means the host pairs; the stream
epoch runs there only on ``pair_gen="device"``.  Past ``resident_mb`` the
host pairs run chunk by chunk on every replica, a single device's steps.

Reference: Mikolov et al., Distributed Representations of Words and
Phrases and their Compositionality (NIPS 2013).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from buffalo_tpu_torch.data.base import Data
from buffalo_tpu_torch.evaluate import Evaluable
from buffalo_tpu_torch.models.base import Algo, Serializable
from buffalo_tpu_torch.models.options import W2VOption
from buffalo_tpu_torch.ops import sgd_kernels as S
from buffalo_tpu_torch.ops import w2v_kernels as W
from buffalo_tpu_torch.parallelism import Mesh
from buffalo_tpu_torch.utils import Option


class W2V(Algo, W2VOption, Evaluable, Serializable):
    """Skip-gram negative-sampling training and serving on a torch
    device."""

    def __init__(self, opt_path=None, *args, **kwargs):
        Algo.__init__(self, *args, **kwargs)
        W2VOption.__init__(self, *args, **kwargs)
        Evaluable.__init__(self, *args, **kwargs)
        Serializable.__init__(self, *args, **kwargs)
        self._setup_driver(opt_path, W2VOption, "W2V", ["stream"], kwargs)
        self._vocab = Option({"size": 0, "index": None, "inv_index": None,
                              "scale": None, "dist": None,
                              "total_word_count": 0})

    @staticmethod
    def new(path, data_fields=[], device="cuda"):
        return W2V.instantiate(W2VOption, path, data_fields, device=device)

    def set_data(self, data):
        assert isinstance(data, Data), f"Wrong instance: {type(data)}"
        self.data = data
        self._token_stream_cache = None

    def normalize(self, group="item"):
        if group == "item" and not self.opt.get("_nrz_L0"):
            self.L0 = self._normalize(self.L0)
            self.opt._nrz_L0 = True

    def get_index(self, key, group="item"):
        """Item key -> dense vocabulary index (``w2v.py:60-70``)."""
        is_many = isinstance(key, list)
        indexes = super().get_index(key, group)
        if not is_many:
            indexes = [indexes]
        indexes = [None if i is None or self._vocab.index[i] < 1
                   else self._vocab.index[i] - 1 for i in indexes]
        if not is_many:
            return indexes[0]
        return indexes

    def _get_feature(self, index, group="item"):
        if group == "item" and index is not None:
            return self.L0[index]
        return None

    def initialize(self):
        super().initialize()
        assert self.data, "Data is not set"
        self.build_vocab()
        self.init_factors(self._vocab.size)

    def build_vocab(self):
        """The ``min_count`` cut, the subsample scale table and the
        cumulative unigram^0.75 table (``w2v.py:83-119``)."""
        self._token_stream_cache = None   # the vocabulary remap changes
        header = self.data.get_header()
        group = self.data.get_group("rowwise")
        keys = np.asarray(group["key"])
        uni = np.bincount(keys, minlength=header["num_items"]).astype(np.int64)
        total_word_count = int(len(keys))

        use_mask = uni >= self.opt.min_count
        total_vocab = int(use_mask.sum())
        use = np.zeros(header["num_items"], dtype=np.int32)
        use[use_mask] = np.arange(1, total_vocab + 1)

        threshold_count = float(uni[use_mask].sum())
        if self.opt.sample > 0.0:
            threshold_count *= self.opt.sample
        scale = np.zeros(total_vocab, dtype=np.uint32)
        cnt = uni[use_mask].astype(np.float64)
        p = (np.sqrt(cnt / threshold_count) + 1.0) * (threshold_count / cnt)
        p = np.minimum(p, 1.0)
        scale[:] = (p * 0xFFFFFFFF).astype(np.uint64).astype(np.uint32)
        self.logger.info(
            f"Downsampled {int((p < 1.0).sum())} most-common words.")

        dist0 = cnt ** 0.75
        dist0 /= dist0.sum()
        dist = (np.cumsum(dist0) * 0x7FFFFFFF).astype(np.int32)

        self._vocab.size = total_vocab
        self._vocab.scale = scale
        self._vocab.index = use
        self._vocab.inv_index = np.nonzero(use_mask)[0].astype(np.int32)
        self._vocab.dist = dist
        self._vocab.total_word_count = total_word_count
        self.logger.info(f"Vocab({total_vocab}) TotalWords({total_word_count})")

    def get_sampling_distribution(self, uni, use, total_vocab):
        """The cumulative unigram^0.75 table from per-item counts ``uni``
        and the 1-based vocabulary index ``use`` (0 = dropped): int32,
        scaled to 2^31 - 1 (``w2v.py:121-134``)."""
        dist0 = np.zeros(total_vocab, dtype=np.float64)
        use = np.asarray(use)
        uni = np.asarray(uni)
        kept = use > 0
        dist0[use[kept] - 1] = uni[kept]
        dist0 = dist0 ** 0.75
        dist0 /= dist0.sum()
        return (np.cumsum(dist0) * 0x7FFFFFFF).astype(np.int32)

    def init_factors(self, vocab_size):
        """|N(0, 1/d^2)| L0 with ``np.random`` and a zero L1, in the
        reference's order: the same ``np.random`` state gives both
        packages the same tables."""
        d = self.opt.d
        self.L0 = np.abs(np.random.normal(
            scale=1.0 / (d ** 2), size=(vocab_size, d)).astype("float32"))
        self.L1 = np.zeros((vocab_size, d), dtype=np.float32)

    # ------------------------------------------------------------- retrieval
    def _get_topk_recommendation(self, rows, topk, pool=None):
        raise NotImplementedError

    def _get_most_similar_item(self, col, topk, pool):
        if not isinstance(col, np.ndarray):
            col = self._vocab.index[col] - 1
            if col < 0:
                return [], []
        topks, scores = super()._get_most_similar_item(
            col, topk, self.L0, self.opt.get("_nrz_L0", False), pool)
        topks = self._vocab.inv_index[topks]
        return topks, scores

    def most_similar_vec(self, vec, topk=10, exclude=()):
        """Top-k vocabulary keys by cosine to a d-vector."""
        L0 = self.L0 / (np.linalg.norm(self.L0, axis=1, keepdims=True)
                        + 1e-12)
        scores = L0 @ (vec / (np.linalg.norm(vec) + 1e-12))
        if exclude:
            scores[list(exclude)] = -np.inf
        top = np.argsort(-scores)[:topk]
        # a loaded model has its id map restored but no data attached
        keys, _ = self._id_state("item")
        return [(keys[self._vocab.inv_index[t]], float(scores[t]))
                for t in top]

    def analogy(self, a: str, b: str, c: str, topk: int = 10):
        """``a : b :: c : ?`` by the vector offset b - a + c
        (``w2v.py:171-181``)."""
        idx = self.get_index([a, b, c])
        if any(i is None for i in idx):
            return []
        va, vb, vc = (self.L0[i] / (np.linalg.norm(self.L0[i]) + 1e-12)
                      for i in idx)
        return self.most_similar_vec(vb - va + vc, topk=topk,
                                     exclude=idx)

    def get_scores(self, row_col_pairs):
        return []

    def _get_scores(self, row, col):
        return np.zeros(len(row), dtype=np.float32)

    # -------------------------------------------------------------- training
    def _token_stream(self):
        """The in-vocabulary token stream, cached across epochs: vocabulary
        ids and sentence ids of every token that survived the
        ``min_count`` cut (``w2v.py:190-207``)."""
        cached = getattr(self, "_token_stream_cache", None)
        if cached is not None:
            return cached
        group = self.data.get_group("rowwise")
        indptr = np.asarray(group["indptr"])
        keys = np.asarray(group["key"])
        vocab_idx = self._vocab.index[keys] - 1     # -1 = out of vocab
        sent_ids = np.repeat(
            np.arange(len(indptr) - 1, dtype=np.int32), np.diff(indptr))
        in_vocab = vocab_idx >= 0
        cached = (vocab_idx[in_vocab].astype(np.int32),
                  sent_ids[in_vocab])
        self._token_stream_cache = cached
        return cached

    def _generate_pairs(self, rng: np.random.Generator):
        """One epoch's (inputs, targets, kept words): the subsample and the
        shrunken windows drawn with numpy, the pairs expanded by the native
        library (position-major) or the numpy loop (offset-major), the
        same multiset (``w2v.py:209-248``)."""
        all_words, all_sents = self._token_stream()
        # subsample: keep while scale > rand32 (w2v.cc:233-235)
        r = rng.integers(0, 1 << 32, size=len(all_words), dtype=np.uint64)
        keep = self._vocab.scale[all_words].astype(np.uint64) > r
        words = all_words[keep]
        sents = all_sents[keep]
        n = len(words)
        if n < 2:
            return (np.zeros(0, np.int32), np.zeros(0, np.int32), 0)

        window = int(self.opt.window)
        # per-center shrunken half-width: window - b, b ~ U[0, window)
        h = window - rng.integers(0, window, size=n)

        from buffalo_tpu_torch.data import native
        got = native.w2v_pairs_native(words, sents, h, window)
        if got is not None:
            return (got[0], got[1], n)
        inputs, targets = [], []
        for off in range(1, window + 1):
            same = sents[:-off] == sents[off:]
            # center i, context i+off (context within center's window)
            m = same & (off <= h[:-off])
            targets.append(words[:-off][m])
            inputs.append(words[off:][m])
            # center i+off, context i
            m2 = same & (off <= h[off:])
            targets.append(words[off:][m2])
            inputs.append(words[:-off][m2])
        return (np.concatenate(inputs), np.concatenate(targets), n)

    def _dp_size(self) -> int:
        """The dp mesh's size: ``num_devices`` past 1, else 1."""
        n = int(self.opt.get("num_devices") or 0)
        return n if n > 1 else 1

    def _pair_gen(self) -> str:
        pair_gen = str(self.opt.get("pair_gen", "auto"))
        if pair_gen not in ("auto", "host", "device"):
            raise ValueError(
                f"pair_gen must be auto|host|device, got {pair_gen!r}")
        if str(self.opt.get("offset_mode", "scan")) not in ("scan",
                                                             "unrolled"):
            raise ValueError(f"offset_mode must be scan|unrolled, got "
                             f"{self.opt.offset_mode!r}")
        if pair_gen == "auto":
            # the stream epoch is opt-in on a mesh (w2v.py:495-500)
            return "device" if self.device.type == "cuda" \
                and self._dp_size() == 1 else "host"
        return pair_gen

    def _epoch_done(self, i, loss, pairs, start_t, training_callback,
                    **stats):
        self.iteration_times.append(time.time() - start_t)
        self.iteration_losses.append(loss)
        self.epoch_stats.append(dict(pairs=pairs, **stats))
        self.logger.info(
            "Iteration %d: Loss %.5f (%d pairs) Elapsed %.3f secs"
            % (i + 1, loss, pairs, time.time() - start_t))
        if training_callback is not None and callable(training_callback):
            training_callback(i, {"train_loss": loss})

    def _stream_plan(self):
        """The stream epoch's negative block and chunk width T, by the JAX
        package's rules (``w2v.py:282-298``), on the epoch-invariant token
        count; T a multiple of ``block`` x the dp mesh's size, so that each
        shard's slice is block-aligned."""
        opt = self.opt
        n_all = len(self._token_stream()[0])
        # the shared-negative block stays small; auto shrinks it below the
        # configured block only for micro-corpora
        block = int(opt.get("neg_block", 4))
        block = min(block,
                    max(4, 1 << int(np.log2(max(n_all // 256, 4)))))
        T = int(opt.get("batch_size") or 0)
        if T <= 0:
            # >= 16 sequential chunk updates per epoch
            T = 1 << 17
            T = min(T, max(block, -(-n_all // (16 * block)) * block))
        quantum = block * self._dp_size()
        T = -(-T // quantum) * quantum
        return block, T, n_all

    def _stream_host_phase(self, rng_np, T, G):
        """One epoch's token chunks (``w2v.py:313-344``): the subsample, the
        compaction and the half-window draws, in the 6-byte wire format
        (int32 word, uint8 sentence start, uint8 half-window), padded to a
        multiple-of-4 chunk count and then of G.  Returns (words, starts,
        halves, nchunks, kept tokens)."""
        V = int(self._vocab.size)
        window = int(self.opt.window)
        all_words, all_sents = self._token_stream()
        r = rng_np.integers(0, 1 << 32, size=len(all_words), dtype=np.uint64)
        keep = self._vocab.scale[all_words].astype(np.uint64) > r
        words = all_words[keep]
        sents = all_sents[keep]
        n = len(words)
        h = (window - rng_np.integers(0, window, size=n)).astype(np.uint8)
        bnd = np.ones(n, np.uint8)
        if n > 1:
            bnd[1:] = sents[1:] != sents[:-1]
        nchunks = -(-max(1, -(-n // T)) // 4) * 4
        if nchunks > G:
            nchunks = -(-nchunks // G) * G
        pad = nchunks * T - n
        wc = np.concatenate([words, np.full(pad, V, np.int32)]) \
            .reshape(nchunks, T)
        bc = np.concatenate([bnd, np.ones(pad, np.uint8)]) \
            .reshape(nchunks, T)
        hc = np.concatenate([h, np.zeros(pad, np.uint8)]) \
            .reshape(nchunks, T)
        return wc, bc, hc, nchunks, n

    def _train_stream(self, mesh, tables, alias, rng_np, statics,
                      training_callback):
        """The ``pair_gen="device"`` epochs (``w2v.py:250-426``): per epoch
        the host subsamples, compacts and draws the half-windows; the card
        expands the windows, group by group of token chunks, each chunk
        split on its position axis over the mesh."""
        opt = self.opt
        window = int(opt.window)
        assert window < 256, "uint8 half-window wire format"
        block, T, n_all = self._stream_plan()
        G = int(opt.get("max_chunks_per_dispatch", 32))
        raw_words = float(self._vocab.total_word_count)
        total_words = raw_words * opt.num_iters
        processed_words = 0.0
        seed = int(opt.random_seed)
        loss = None

        def host_phase():
            st = time.time()
            return self._stream_host_phase(rng_np, T, G) + (time.time() - st,)

        # two epochs of chunk arrays on the card, or staging per group
        epoch_bytes = 6 * (-(-n_all // T)) * T
        upload_prefetch = 2 * epoch_bytes <= int(
            opt.get("resident_mb", 4096)) * 1024 * 1024

        def put(part):
            return self._stage_dp_shards(mesh, part)

        def stage(arrays):
            """Every group's chunk slices (each shard's), on the card when
            prefetching: the next epoch's uploads queue behind this
            epoch's kernels."""
            wc, bc, hc, nchunks, n, host_s = arrays
            g_len = min(G, nchunks)
            staged = []
            for g in range(nchunks // g_len):
                sl = slice(g * g_len, (g + 1) * g_len)
                part = (wc[sl], bc[sl], hc[sl])
                staged.append(put(part) if upload_prefetch else part)
            h2d = wc.nbytes + bc.nbytes + hc.nbytes
            return staged, nchunks, g_len, n, host_s, h2d

        staged_next = None
        for i in range(opt.num_iters):
            start_t = time.time()
            if staged_next is None:
                staged_next = stage(host_phase())
            staged, nchunks, g_len, n_tok, host_s, h2d = staged_next
            staged_next = None
            groups = nchunks // g_len
            wpc = raw_words / max(nchunks, 1)
            loss_sums, pair_cnts = [], []
            for g, arrays in enumerate(staged):
                if not upload_prefetch:
                    arrays = put(arrays)
                p0 = np.float32(processed_words + g * g_len * wpc)
                l_, c_ = W.w2v_epoch_stream(
                    mesh, tables, *arrays, alias, p0, seed=seed, epoch=i,
                    group=g, groups=groups, window=window, block=block,
                    lr=float(opt.lr), min_lr=float(opt.min_lr),
                    total_words=float(total_words),
                    words_per_chunk=float(wpc), **statics)
                loss_sums.append(l_)
                pair_cnts.append(c_)
            # every group is launched; the next epoch's host phase and
            # uploads overlap the card's work, the readback below syncs
            if i + 1 < opt.num_iters:
                staged_next = stage(host_phase())
            loss_sum = float(np.sum([x.cpu().numpy() for x in loss_sums]))
            pair_cnt = float(np.sum([x.cpu().numpy() for x in pair_cnts]))
            loss = loss_sum / max(pair_cnt, 1.0)
            processed_words += raw_words
            self._epoch_done(i, loss, int(pair_cnt), start_t,
                             training_callback, tokens=n_tok, chunk=T,
                             block=block, chunks=nchunks, groups=groups,
                             h2d_bytes=h2d, host_seconds=host_s)
        return loss

    def train(self, training_callback: Optional[
            Callable[[int, Dict[str, float]], None]] = None) -> Dict[str, float]:
        assert self.data, "Data is not set"
        opt = self.opt
        dev = self.device
        V = int(self._vocab.size)
        self.iteration_times = []     # per-epoch train seconds
        self.iteration_losses = []    # per-epoch loss per pair
        self.epoch_stats = []         # per-epoch pairs, chunks, bytes, ...
        if V == 0:
            self.logger.warning("Empty vocabulary; nothing to train.")
            return {}
        pair_gen = self._pair_gen()
        d = int(opt.d)
        # the dp mesh on num_devices > 1 (w2v.py:470), one device being a
        # mesh of one shard; one replica of the tables (and of the alias
        # tables) per device, the first device's written back
        mesh = self._select_dp_mesh(True, False) or Mesh([dev])
        # the model file keeps the int32 CDF; the draws use alias tables
        prob, al = S.build_alias_table(
            np.diff(np.asarray(self._vocab.dist, dtype=np.int64), prepend=0))
        tables, alias = {}, {}
        for mdev in S.replica_shards(mesh):
            tables[mdev] = tuple(torch.from_numpy(t).to(mdev, copy=True)
                                 for t in (self.L0, self.L1))
            alias[mdev] = (torch.from_numpy(prob).to(mdev),
                           torch.from_numpy(al).to(mdev))
        rng_np = np.random.default_rng(int(opt.random_seed))
        seed = int(opt.random_seed)
        statics = dict(num_negatives=int(opt.num_negative_samples),
                       vocab_size=V,
                       compute_loss=bool(opt.compute_loss_on_training),
                       max_step_norm=float(opt.get("max_step_norm", 0.1)))
        full_st = time.time()
        if pair_gen == "device":
            loss = self._train_stream(mesh, tables, alias, rng_np, statics,
                                      training_callback)
        else:
            loss = self._train_pairs(mesh, tables, alias, rng_np, seed,
                                     statics, training_callback)
        L0, L1 = tables[mesh.devices[0]]
        self.L0 = np.ascontiguousarray(L0.cpu().numpy()[:, :d])
        self.L1 = np.ascontiguousarray(L1.cpu().numpy()[:, :d])
        self.logger.info(
            f"elapsed for full epochs: {time.time() - full_st:.2f} sec")
        return {"train_loss": loss} if loss is not None else {}

    def _pair_chunk(self) -> int:
        """Pairs per chunk (``w2v.py:455-462``): >= 16 sequential steps per
        epoch, 2^12 to 2^18; rounded up to a multiple of the dp mesh's size
        (``w2v.py:476``)."""
        chunk = int(self.opt.get("batch_size") or 0)
        if chunk <= 0:
            est_pairs = self._vocab.total_word_count * int(self.opt.window)
            chunk = 1 << max(12, min(18, int(np.log2(max(est_pairs // 16,
                                                         1)))))
        D = self._dp_size()
        return -(-chunk // D) * D

    def _train_pairs(self, mesh, tables, alias, rng_np, seed, statics,
                     training_callback):
        """The ``pair_gen="host"`` epochs (``w2v.py:506-635``): the pairs in
        resident groups of chunks, each chunk split on its batch axis over
        the mesh, or past ``resident_mb`` chunk by chunk with the host's
        rate, a single device's step on every replica."""
        opt = self.opt
        V = int(self._vocab.size)
        chunk = self._pair_chunk()
        raw_words = float(self._vocab.total_word_count)
        total_words = raw_words * opt.num_iters
        processed_words = 0.0
        G = int(opt.get("max_chunks_per_dispatch", 32))
        loss = None
        def generate():
            st = time.time()
            return self._generate_pairs(rng_np) + (time.time() - st,)

        next_pairs = None  # the next epoch's pairs, made while the card works
        for i in range(opt.num_iters):
            start_t = time.time()
            if next_pairs is None:
                next_pairs = generate()
            inputs, targets, n_words, host_s = next_pairs
            next_pairs = None
            n_pairs = len(inputs)
            # a multiple-of-4 chunk count, padded with sentinel pairs
            nchunks = -(-max(1, -(-n_pairs // chunk)) // 4) * 4
            pad = nchunks * chunk - n_pairs
            if pad:
                inputs = np.concatenate(
                    [inputs, np.full(pad, V, dtype=np.int32)])
                targets = np.concatenate(
                    [targets, np.full(pad, V, dtype=np.int32)])
            # epochs of more than G chunks run as groups of G
            if nchunks > G:
                nchunks_pad = -(-nchunks // G) * G
                extra = (nchunks_pad - nchunks) * chunk
                if extra:
                    inputs = np.concatenate(
                        [inputs, np.full(extra, V, dtype=np.int32)])
                    targets = np.concatenate(
                        [targets, np.full(extra, V, dtype=np.int32)])
                nchunks = nchunks_pad
                g_len = G
            else:
                g_len = nchunks
            groups = nchunks // g_len
            # the decay advances by raw corpus words (w2v.cc:340)
            wpc = raw_words / max(nchunks, 1)
            resident = (len(inputs) * 8) <= int(
                opt.get("resident_mb", 4096)) * 1024 * 1024
            inputs2 = inputs.reshape(nchunks, chunk)
            targets2 = targets.reshape(nchunks, chunk)
            losses, counts = [], []
            if resident:
                for g in range(groups):
                    sl = slice(g * g_len, (g + 1) * g_len)
                    p0 = np.float32(processed_words + g * g_len * wpc)
                    l_, c_ = W.w2v_epoch(
                        mesh, tables, *self._stage_dp_shards(
                            mesh, (inputs2[sl], targets2[sl])), alias, p0,
                        seed=seed, epoch=i, group=g, groups=groups,
                        lr=float(opt.lr), min_lr=float(opt.min_lr),
                        total_words=float(total_words),
                        words_per_chunk=float(wpc), **statics)
                    losses.append(l_)
                    counts.append(c_)
                # the next epoch's pairs while the card works (resident
                # only: the fallback exists for bounded host memory)
                if i + 1 < opt.num_iters:
                    next_pairs = generate()
            else:
                for ci in range(nchunks):
                    lr_t = W.host_rate(float(opt.lr), float(opt.min_lr),
                                       processed_words + ci * wpc,
                                       total_words)
                    for r, (mdev, (L0, L1)) in enumerate(tables.items()):
                        l_, c_ = W.w2v_step(
                            L0, L1, torch.from_numpy(inputs2[ci]).to(mdev),
                            torch.from_numpy(targets2[ci]).to(mdev), lr_t,
                            seed=seed, epoch=i, chunk=ci, alias=alias[mdev],
                            **statics)
                        if r == 0:
                            losses.append(l_)
                            counts.append(c_)
            loss_sum = float(np.sum([x.cpu().numpy() for x in losses]))
            pair_cnt = float(np.sum([x.cpu().numpy() for x in counts]))
            loss = loss_sum / max(pair_cnt, 1.0)
            processed_words += raw_words
            self._epoch_done(i, loss, n_pairs, start_t, training_callback,
                             tokens=n_words, chunk=chunk, chunks=nchunks,
                             groups=groups, h2d_bytes=int(len(inputs) * 8),
                             host_seconds=host_s)
        return loss

    # --------------------------------------------------------------- access
    def _get_data(self):
        data = super()._get_data()
        data.extend([("opt", self.opt), ("L0", self.L0),
                     ("_vocab", self._vocab)])
        return data

    def get_evaluation_metrics(self):
        return []
