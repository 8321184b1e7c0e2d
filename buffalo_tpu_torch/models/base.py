"""Model base classes: id mapping, retrieval, early stopping, serialization.

Behavioral counterpart of the reference ``buffalo/algo/base.py`` —
``Algo`` (id<->index maps, top-k recommendation, most-similar, early
stopping, save-best, feature access, L2 normalize; ``base.py:12-268``)
and ``Serializable`` (length-prefixed pickled record container with
partial-field load and the ``instantiate`` factory; ``base.py:271-318``).
The on-disk serialization format is kept byte-compatible so models
written by either implementation share tooling; the code is an
independent design: one parameterized id-map path instead of duplicated
user/item branches, vectorized key<->index translation through numpy
object arrays, and device-side scoring via ``ops.topk``.

A copy of ``buffalo_tpu.models.base`` for the PyTorch port.  Files saved
by either package load in the other: ``load`` maps the reference's
pickled ``buffalo_tpu.utils.option`` classes onto this package's, so a
reference model loads without importing the JAX package.
"""
from __future__ import annotations

import abc
import io
import json
import pickle
import struct

import numpy as np

from buffalo_tpu_torch.ops.topk import matmul_topk
from buffalo_tpu_torch.utils import Option, log, resolve_device

EPS = 1e-8

# module names of the reference's pickled classes -> this package's copies
_PICKLE_MODULES = {
    "buffalo_tpu.utils.option": "buffalo_tpu_torch.utils.option",
}


class _Unpickler(pickle.Unpickler):
    """Resolves the reference package's option classes to this port's,
    and refuses any other ``buffalo_tpu`` class (which would import
    JAX)."""

    def find_class(self, module, name):
        module = _PICKLE_MODULES.get(module, module)
        if module == "buffalo_tpu" or module.startswith("buffalo_tpu."):
            raise pickle.UnpicklingError(
                f"{module}.{name} has no counterpart in buffalo_tpu_torch")
        return super().find_class(module, name)


def _loads(payload: bytes):
    return _Unpickler(io.BytesIO(payload)).load()


_GROUP_ATTRS = {
    # group -> (ids attr, map attr, mapped-flag attr, idmap dataset, header key)
    "user": ("userids", "userid_map", "userid_mapped", "rows", "num_users"),
    "item": ("itemids", "itemid_map", "itemid_mapped", "cols", "num_items"),
}


def l2_normalize(feat: np.ndarray) -> np.ndarray:
    """Row-wise L2 normalization with an epsilon guard for zero rows."""
    feat = np.asarray(feat)
    norm_sq = np.einsum("...d,...d->...", feat, feat)
    return feat / np.sqrt(norm_sq + EPS)[..., np.newaxis]


class Algo(abc.ABC):
    """Shared driver surface: id maps, retrieval, training aids."""

    def __init__(self, *args, **kwargs):
        self._idmanager = Option({"userid": [], "userid_map": {},
                                  "itemid": [], "itemid_map": {},
                                  "userid_mapped": False,
                                  "itemid_mapped": False})

    def get_option(self, opt_source):
        opt = Option(opt_source)
        self.is_valid_option(opt)
        return Option(opt), opt_source

    def _setup_driver(self, opt_path, opt_cls, name, data_types,
                      kwargs):
        """Shared driver construction: options, logger, device, data.

        Every model driver runs the same sequence — default options,
        validation, logger, the torch device (``opt.device``; a CUDA
        device without a card raises), then bind ``data``/``data_opt``
        (building the database when an option tree is given).
        """
        if opt_path is None:
            opt_path = opt_cls().get_default_option()
        self.logger = log.get_logger(name)
        self.opt, self.opt_path = self.get_option(opt_path)
        self.device = resolve_device(self.opt.get("device", "cuda"))

        self.data = None
        data = kwargs.get("data")
        data_opt = kwargs.get("data_opt", self.opt.get("data_opt"))
        if data_opt:
            import buffalo_tpu_torch.data as _data
            self.data = _data.load(data_opt)
            self.data.create()
        elif data is not None:
            from buffalo_tpu_torch.data.base import Data
            assert isinstance(data, Data), f"Wrong instance: {type(data)}"
            self.data = data
        self.logger.info("%s(%s)" % (
            name, json.dumps(self.opt.to_dict(), indent=2)))
        if self.data:
            self.logger.info(self.data.show_info())
            assert self.data.data_type in data_types

    # Kept as a staticmethod named ``_normalize`` for API parity with the
    # per-model ``normalize(group=...)`` entry points that call it.
    _normalize = staticmethod(l2_normalize)

    def initialize(self):
        self._es_bad_rounds = 0
        self._es_best_loss = float("inf")
        seed = self.opt.get("random_seed")
        if seed:
            np.random.seed(seed)

    @abc.abstractmethod
    def normalize(self, group="item"):
        raise NotImplementedError

    # -------------------------------------------------------------- id maps
    def _id_state(self, group: str):
        """Return (ids, key->index map) for ``group``, building lazily."""
        ids_attr, map_attr, flag_attr, _, _ = _GROUP_ATTRS[group]
        if not self._idmanager.get(flag_attr):
            self._materialize_id_map(group)
        return (getattr(self._idmanager, ids_attr),
                getattr(self._idmanager, map_attr))

    def _materialize_id_map(self, group: str):
        ids_attr, map_attr, flag_attr, dataset, header_key = _GROUP_ATTRS[group]
        raw = self.data.get_group("idmap").get(dataset)
        if raw is None or len(raw) == 0:
            count = self.data.get_header()[header_key]
            ids = [str(i) for i in range(count)]
        else:
            ids = [x.decode("utf-8", "ignore") if isinstance(x, bytes)
                   else str(x) for x in np.asarray(raw)]
        setattr(self._idmanager, ids_attr, ids)
        setattr(self._idmanager, map_attr,
                {key: i for i, key in enumerate(ids)})
        setattr(self._idmanager, flag_attr, True)

    def build_itemid_map(self):
        self._materialize_id_map("item")

    def build_userid_map(self):
        self._materialize_id_map("user")

    def get_index(self, keys, group="item"):
        """Map key(s) to internal indices; ``None`` marks unknown keys."""
        if group not in _GROUP_ATTRS:
            return np.array([]) if isinstance(keys, list) else None
        _, key_to_idx = self._id_state(group)
        if isinstance(keys, list):
            return np.array([key_to_idx.get(k) for k in keys])
        return key_to_idx.get(keys)

    def get_index_pool(self, pool, group="item"):
        """Resolve a candidate pool (key list or prebuilt index array)."""
        if isinstance(pool, np.ndarray):
            return pool
        if isinstance(pool, list):
            resolved = self.get_index(pool, group)
            return np.array([i for i in resolved if i is not None])
        raise ValueError(f"Unexpected type for pool: {type(pool)}")

    def _decode(self, indices, group: str):
        """Vectorized index -> key translation via an object ndarray."""
        ids, _ = self._id_state(group)
        table = np.asarray(ids, dtype=object)
        return table[np.asarray(indices, dtype=np.int64)]

    # ------------------------------------------------------------- retrieval
    def _get_topk_recommendation(self, p, Q, pb, Qb, pool, topk, num_workers):
        """Device-side scores + top-k (counterpart of ``base.py:40-55``)."""
        candidates = Q if pool is None else Q[pool]
        cand_bias = Qb if (Qb is None or pool is None) else Qb[pool]
        _, picked = matmul_topk(p, candidates, topk, pb=pb, Qb=cand_bias,
                                device=self.device)
        picked = picked.cpu().numpy()
        if pool is not None:
            picked = np.asarray(pool)[picked]
        return picked

    def topk_recommendation(self, keys, topk=10, pool=None):
        """Top-k item keys per user key: dict for a list query, list else."""
        batched = isinstance(keys, list)
        queries = keys if batched else [keys]
        _, user_map = self._id_state("user")
        self._id_state("item")
        if pool is not None:
            pool = self.get_index_pool(pool, group="item")
            if pool.size == 0:
                return []
        rows = [user_map[k] for k in queries if k in user_map]
        if not rows:
            return []
        ranked = list(self._get_topk_recommendation(rows, topk, pool))
        if not ranked:
            return []
        user_keys = self._decode([row for row, _ in ranked], "user")
        # one decode of the (users, k) index block, not one id-table
        # build per user (each build copies the whole catalog's keys)
        item_keys = [list(keys) for keys in self._decode(
            np.stack([np.asarray(items) for _, items in ranked]), "item")]
        if batched:
            return dict(zip(user_keys, item_keys))
        return item_keys[0]

    def most_similar(self, key, topk=10, group="item", pool=None):
        """Top-k most similar items as ``(key, score)`` tuples."""
        if group != "item":
            return []
        query_is_vector = isinstance(key, np.ndarray)
        if not query_is_vector:
            _, item_map = self._id_state("item")
            query = item_map.get(key)
            if query is None:
                return []
        else:
            query = key
        if pool is not None:
            pool = self.get_index_pool(pool, group="item")
            if pool.size == 0:
                return []
        picked, scores = self._get_most_similar_item(query, topk, pool)
        pairs = zip(self._decode(picked, "item"), scores)
        if query_is_vector:
            return list(pairs)
        # the internal call over-fetches one candidate assuming the
        # query ranks first; when it doesn't (e.g. a pool that excludes
        # it), trim back to the requested k after filtering
        return [(k, s) for (i, (k, s)) in zip(picked, pairs)
                if i != query][:topk]

    def _get_most_similar_item(self, col, topk, Factor, nrz, pool):
        """Similarity scan: dot product, or cosine when not pre-normalized."""
        if isinstance(col, np.ndarray):
            q = col
        else:
            q = Factor[col]
            topk += 1  # the query itself will rank first and be dropped
        candidates = Factor if pool is None else Factor[pool]
        scores = candidates @ q
        if not nrz:
            denom = np.linalg.norm(q) * np.linalg.norm(candidates, axis=1)
            scores = scores / (denom + EPS)
        picked = self.get_topk(scores, k=topk,
                               num_threads=self.opt.num_workers)
        best = scores[picked]
        if pool is not None:
            picked = np.asarray(pool)[picked]
        return picked, best

    # ------------------------------------------------------------- features
    def get_feature(self, name, group="item"):
        index = self.get_index(name, group=group)
        if index is None:
            return None
        return self._get_feature(index, group)

    @abc.abstractmethod
    def _get_feature(self, index, group="item"):
        raise NotImplementedError

    def get_weighted_feature(self, weights, group="item", min_length=1):
        """Weighted mean feature over keys, L2-normalized.

        Unlike the reference (``base.py:191-200``), the epsilon lands in
        the denominator — ``feat / (norm + EPS)`` — and the list form
        also drops unknown keys.
        """
        if isinstance(weights, dict):
            pairs = weights.items()
        else:
            pairs = [(k, 1.0) for k, _ in weights]
        feats = [(self.get_feature(k, group), w) for k, w in pairs]
        feats = [f * w for f, w in feats if f is not None]
        if len(feats) < min_length:
            return None
        mean = np.mean(np.asarray(feats, dtype=np.float64), axis=0)
        return (mean / (np.linalg.norm(mean) + EPS)).astype(np.float32)

    # -------------------------------------------------------- training aids
    def _select_mesh(self, default_all: bool = False):
        """The device mesh the options ask for, or None for one device.

        ``num_devices`` 1 forces one device; more than 1 asks for a mesh
        of that many shards (across processes once
        ``parallelism.initialize_distributed`` has run), on the cards or
        on the devices ``opt.devices`` names (the port's own key, e.g.
        ``["cuda:0"] * 4`` or ``["cpu"] * 8``).  With ``default_all`` (the
        ALS rule, ``models/als.py:261-265``), 0 meshes over every card
        when this process sees more than one, or over every process of a
        distributed job.
        """
        from buffalo_tpu_torch import parallelism

        n_dev = int(self.opt.get("num_devices") or 0)
        devices = self.opt.get("devices") or None
        if n_dev == 1:
            return None
        if n_dev > 1:
            return parallelism.get_mesh(n_dev, devices=devices)
        if not default_all:
            return None
        local = len(devices) if devices else (
            parallelism.num_devices() if self.device.type == "cuda" else 1)
        if local * parallelism.world_size() > 1:
            return parallelism.get_mesh(None, devices=devices)
        return None

    def _select_dp_mesh(self, resident, split_dispatch):
        """The dp mesh of the SGD / EM families (``models/base.py:270-295``
        of the JAX package), or None for one device.  A mesh only on an
        explicit ``num_devices > 1`` (over ``opt.devices`` when given);
        "tp" warns and runs dp (replicated tables, batch-sharded chunks);
        a streamed run or ``epoch_dispatch="split"`` warns and runs on one
        device.  The warnings are the JAX package's, word for word."""
        from buffalo_tpu_torch import parallelism

        opt = self.opt
        n_dev = int(opt.get("num_devices") or 0)
        if n_dev <= 1:
            return None
        if "tp" in str(opt.get("sharding", "dp")):
            self.logger.warning(
                "%s supports sharding='dp' only (replicated tables, "
                "batch-sharded chunks); using dp", type(self).__name__)
        if not resident:
            self.logger.warning(
                "mesh training applies to the device-resident fused "
                "epoch only; streaming path runs single-device")
            return None
        if split_dispatch:
            self.logger.warning(
                "epoch_dispatch='split' is a single-device mode; "
                "running without the mesh")
            return None
        return parallelism.get_mesh(n_dev,
                                    devices=opt.get("devices") or None)

    def _stage_dp_shards(self, mesh, tensors):
        """Each (nchunks, N) host array of ``tensors`` split on its batch
        axis into the local shards' (nchunks, N / mesh.size) int32 tensors,
        each on its shard's device."""
        import torch

        out = []
        for a in tensors:
            N_loc = a.shape[1] // mesh.size
            out.append([torch.from_numpy(np.ascontiguousarray(
                a[:, g * N_loc:(g + 1) * N_loc])).to(dev)
                for g, dev in zip(mesh.shards, mesh.devices)])
        return out

    def periodical(self, period, current):
        """True when iteration ``current`` falls on the save/eval period."""
        return not period or (current + 1) % period == 0

    def save_best_only(self, loss, best_loss, i):
        if (self.opt.save_best and loss < best_loss
                and self.periodical(self.opt.save_period, i)):
            # the epoch loops keep factors device-resident and only
            # copy them to the host attributes serialization reads on
            # validation epochs — sync before writing the checkpoint,
            # or the "best" model on disk holds stale (often initial
            # random) factors
            sync = getattr(self, "_sync_host_factors", None)
            if sync is not None:
                sync()
            self.save(self.opt.model_path)
            return loss
        return best_loss

    def early_stopping(self, loss):
        """Count consecutive non-improving epochs; True when over budget."""
        patience = self.opt.early_stopping_rounds
        if patience < 1:
            return False
        if loss > self._es_best_loss:
            self._es_bad_rounds += 1
        else:
            self._es_bad_rounds = 0
        self._es_best_loss = loss
        if self._es_bad_rounds >= patience:
            self.logger.info("Reached at early_stopping rounds, stopping train.")
            return True
        return False


class Serializable(abc.ABC):
    """Length-prefixed pickle record container.

    Byte-compatible with the reference format (``base.py:275-311``):
    ``Q`` record count, then per record ``Q`` name length + name bytes +
    ``Q`` pickle length + pickle bytes.  ``data_fields`` filters both on
    save and on load (unmatched records are seek-skipped, enabling e.g.
    a serving-only load of ``Q`` + ``_idmanager``).
    """

    _LEN = struct.Struct("Q")

    def __init__(self, *args, **kwargs):
        pass

    @classmethod
    def _write_block(cls, fh, payload: bytes):
        fh.write(cls._LEN.pack(len(payload)))
        fh.write(payload)

    @classmethod
    def _read_len(cls, fh) -> int:
        return cls._LEN.unpack(fh.read(cls._LEN.size))[0]

    def save(self, path=None, with_itemid_map=True, with_userid_map=True,
             data_fields=[]):
        path = path or self.opt.model_path
        if with_itemid_map:
            self._id_state("item")
        if with_userid_map:
            self._id_state("user")
        records = self._get_data()
        if data_fields:
            wanted = set(data_fields)
            records = [(n, o) for n, o in records if n in wanted]
        with open(path, "wb") as fh:
            fh.write(self._LEN.pack(len(records)))
            for name, obj in records:
                self._write_block(fh, name.encode("utf-8"))
                self._write_block(fh, pickle.dumps(obj, protocol=4))

    def _get_data(self):
        return [("_idmanager", self._idmanager)]

    def load(self, path, data_fields=[]):
        wanted = set(data_fields) if data_fields else None
        with open(path, "rb") as fh:
            for _ in range(self._read_len(fh)):
                name = fh.read(self._read_len(fh)).decode("utf8")
                size = self._read_len(fh)
                if wanted is not None and name not in wanted:
                    fh.seek(size, 1)
                else:
                    setattr(self, name, _loads(fh.read(size)))

    @classmethod
    def record_names(cls, path):
        """The names of a saved file's records, in order, unpickling
        none."""
        names = []
        with open(path, "rb") as fh:
            for _ in range(cls._read_len(fh)):
                names.append(fh.read(cls._read_len(fh)).decode("utf8"))
                fh.seek(cls._read_len(fh), 1)
        return names

    @classmethod
    def read_record(cls, path, name):
        """The unpickled record ``name`` of a saved file (KeyError when it
        has none), the others skipped."""
        with open(path, "rb") as fh:
            for _ in range(cls._read_len(fh)):
                rec = fh.read(cls._read_len(fh)).decode("utf8")
                size = cls._read_len(fh)
                if rec == name:
                    return _loads(fh.read(size))
                fh.seek(size, 1)
        raise KeyError(f"{path} has no record {name!r}")

    @classmethod
    def instantiate(cls, cls_opt, path, data_fields, device="cuda"):
        opt = cls_opt().get_default_option()
        opt.device = str(device)
        model = cls(opt)
        model.load(path, data_fields)
        return model
