"""Stream input (one user's item sequence per line) → compiled dataset.

Counterpart of the reference ``buffalo/data/stream.py``: same option
tree (``StreamOptions``), same vocabulary scan over the main file when
no ``iid`` list is given (first-appearance order, ``stream.py:81-158``),
the same two internal data types — ``stream`` (order-preserving, no
colwise group) and ``matrix`` (per-user Counter dedupe) — the
``newest``/``sample`` validation carve-outs and the SPPMI co-occurrence
build (``stream.py:169-195`` + ``fileio.hpp:109-250``).  A copy of
``buffalo_tpu.data.stream`` for the PyTorch port: the two packages build
the same compiled directory from the same stream file.
"""
from __future__ import annotations

import os
from collections import Counter

import numpy as np

from buffalo_tpu_torch.data.base import DataBuilder, DataOption
from buffalo_tpu_torch.data.fileio import build_sppmi
from buffalo_tpu_torch.utils import Option


class StreamOptions(DataOption):
    def get_default_option(self) -> Option:
        opt = {
            "type": "stream",
            "input": {
                "main": "",
                "uid": "",  # if not set, row-id is used as userid
                "iid": "",  # if not set, token string is used as itemid
            },
            "data": {
                "validation": {
                    "name": "newest",  # sample or newest
                    "p": 0.01,         # if newest, ignored
                    "n": 1,            # if sample, ignored
                    "max_samples": 500,
                },
                "sppmi": {
                    # "windows": 5,
                    # "k": 1
                },
                "batch_mb": 1024,
                "use_cache": False,
                "tmp_dir": "/tmp/",
                "path": "./stream.bfo",
                "internal_data_type": "stream",
                "disk_based": False,
                "random_seed": 0,
            },
        }
        return Option(opt)

    def is_valid_option(self, opt) -> bool:
        assert super().is_valid_option(opt)
        if not opt["type"] == "stream":
            raise RuntimeError(f"Invalid data type: {opt['type']}")
        return True


class Stream(DataBuilder):
    name = "Stream"

    def __init__(self, opt, *args, **kwargs):
        super().__init__(opt, *args, **kwargs)
        self.name = "Stream"
        self.data_type = "stream"

    def _iter_lines(self, path: str):
        """Token lists, one line at a time (the corpus is never
        materialized whole — at KakaoBrunch scale the per-token Python
        strings would be tens of GB; the reference also streams
        line-by-line, ``stream.py:197-271``)."""
        with open(path) as fin:
            for line in fin:
                yield line.strip().split()

    def create(self) -> None:
        data_path = self.opt.data.path
        if self.opt.data.use_cache and os.path.isdir(data_path):
            try:
                self.open(data_path)
                self.logger.info(f"Use cached DB on {data_path}")
                return
            except Exception:
                self.close()
        self.logger.info("Create database from stream data")
        if self.opt.data.get("disk_based"):
            self.logger.warning(
                "disk_based is not implemented for the stream builder; "
                "building in host memory (token sequences stream "
                "line-by-line, accumulators are packed arrays)")

        main_path = self.opt.input.main
        uid_path = self.opt.input.get("uid")
        iid_path = self.opt.input.get("iid")

        # ---- pass 1: vocabulary scan + corpus size (stream.py:81-158)
        if iid_path:
            with open(iid_path) as fin:
                itemid_list = [line.strip() for line in fin]
            itemids = {tok: idx for idx, tok in enumerate(itemid_list)}
            num_users = sum(1 for _ in self._iter_lines(main_path))
            total_tokens = None  # counted on demand below
        else:
            itemids = {}
            num_users = 0
            total_tokens = 0
            for data in self._iter_lines(main_path):
                num_users += 1
                total_tokens += len(data)
                for tok in data:
                    if tok not in itemids:
                        itemids[tok] = len(itemids)
            itemid_list = [None] * len(itemids)
            for tok, idx in itemids.items():
                itemid_list[idx] = tok
        num_items = len(itemids)
        self.logger.info(f"Found {num_items} unique itemids")

        if uid_path:
            with open(uid_path) as fin:
                userid_list = [line.strip() for line in fin]
        else:
            userid_list = [str(i) for i in range(1, num_users + 1)]

        internal = self.opt.data.internal_data_type
        vopt = self.opt.data.get("validation")
        vali_method = vopt["name"] if vopt else None
        vali_n = int(vopt.get("n", 0)) if vali_method == "newest" else 0
        rng = np.random.default_rng(self.opt.data.get("random_seed", 0))

        # ---- pass 2: tokenize into train/vali index sequences per user
        # (for internal == "stream" the train lists ARE order-preserving,
        # so the SPPMI build reuses them instead of a duplicate copy);
        # accumulators are packed C arrays (8 B/entry), not Python lists
        import array

        sppmi_opt_present = bool(self.opt.data.get("sppmi"))
        ordered_rows = array.array("q")  # order-preserving, for SPPMI
        ordered_cols = array.array("q")
        train_rows, train_cols = array.array("q"), array.array("q")
        train_vals = array.array("f")
        vali_rows, vali_cols = array.array("q"), array.array("q")
        vali_vals = array.array("f")
        # "sample" carve-out draws from global nnz positions of the raw stream
        sample_indexes: set = set()
        if vali_method == "sample":
            if total_tokens is None:
                total_tokens = sum(
                    len(d) for d in self._iter_lines(main_path))
            sz = min(int(vopt.max_samples),
                     int(total_tokens * float(vopt.p)),
                     max(total_tokens - 1, 0))
            if sz > 0 and total_tokens > 1:
                sample_indexes = set(
                    rng.choice(total_tokens - 1, size=sz, replace=False).tolist())

        total_index = 0
        for u, data in enumerate(self._iter_lines(main_path)):
            cols = [itemids[tok] for tok in data]
            vali_part, train_part = [], []
            if vali_method == "newest":
                vali_sz = min(vali_n, len(cols) - 1) if cols else 0
                if vali_sz > 0:
                    # the reference Counter-dedupes the newest carve-out
                    # before writing it (stream.py:229-231)
                    vali_part = list(dict.fromkeys(
                        cols[len(cols) - vali_sz:]))
                    cols = cols[:len(cols) - vali_sz]
            for idx, c in enumerate(cols):
                if (idx + total_index) in sample_indexes:
                    vali_part.append(c)
                else:
                    train_part.append(c)
            total_index += len(cols)

            if sppmi_opt_present and internal != "stream":
                ordered_rows.extend([u] * len(train_part))
                ordered_cols.extend(train_part)
            if internal == "stream":
                train_rows.extend([u] * len(train_part))
                train_cols.extend(train_part)
                train_vals.extend([1.0] * len(train_part))
                vali_rows.extend([u] * len(vali_part))
                vali_cols.extend(vali_part)
                vali_vals.extend([1.0] * len(vali_part))
            else:  # matrix: Counter dedupe (stream.py:252-256)
                for c, v in Counter(train_part).items():
                    train_rows.append(u)
                    train_cols.append(c)
                    train_vals.append(float(v))
                for c, v in Counter(vali_part).items():
                    vali_rows.append(u)
                    vali_cols.append(c)
                    vali_vals.append(float(v))

        out_dir = self._start_artifact(data_path)
        try:
            trows = np.asarray(train_rows, dtype=np.int64)
            tcols = np.asarray(train_cols, dtype=np.int64)
            tvals = self.value_prepro(np.asarray(train_vals, dtype=np.float32))

            if internal == "stream":
                # order-preserving rowwise only: no sort, no colwise group
                indptr = np.zeros(num_users + 1, dtype=np.int64)
                np.cumsum(np.bincount(trows, minlength=num_users), out=indptr[1:])
                self._write_group(out_dir, "rowwise",
                                  indptr=indptr,
                                  key=tcols.astype(np.int32),
                                  val=self.value_prepro.post(
                                      tvals.astype(np.float32)))
            else:
                indptr, key, val = self._build_csr(trows, tcols, tvals, num_users)
                self._write_group(out_dir, "rowwise", indptr=indptr, key=key,
                                  val=self.value_prepro.post(val))
                cindptr, ckey, cval = self._build_csr(tcols, trows, tvals, num_items)
                self._write_group(out_dir, "colwise", indptr=cindptr, key=ckey,
                                  val=self.value_prepro.post(cval))

            if vali_rows:
                self._write_group(out_dir, "vali",
                                  row=np.asarray(vali_rows, dtype=np.int32),
                                  col=np.asarray(vali_cols, dtype=np.int32),
                                  val=np.asarray(vali_vals, dtype=np.float32))

            self._write_group(out_dir, "idmap",
                              rows=np.asarray(userid_list, dtype=np.str_),
                              cols=np.asarray(itemid_list, dtype=np.str_))

            attrs = {
                "num_users": int(num_users),
                "num_items": int(num_items),
                "num_nnz": int(len(trows)),
                "num_validation_samples": int(len(vali_rows)),
            }

            sppmi_opt = self.opt.data.get("sppmi")
            if sppmi_opt:
                # SPPMI pairs come from the ORDER-PRESERVING train sequences
                # regardless of internal_data_type (stream.py:236-271);
                # for "stream" internal the train lists already preserve
                # order, so no duplicate copy was kept
                if internal == "stream":
                    orows, ocols = trows, tcols
                else:
                    orows = np.asarray(ordered_rows, dtype=np.int64)
                    ocols = np.asarray(ordered_cols, dtype=np.int64)
                indptr_now = np.zeros(num_users + 1, dtype=np.int64)
                np.cumsum(np.bincount(orows, minlength=num_users),
                          out=indptr_now[1:])
                result = build_sppmi(indptr_now, ocols, num_items,
                                     window=int(sppmi_opt.windows),
                                     k=int(sppmi_opt.k))
                if result is not None:
                    sindptr, skey, sval = result
                    self._write_group(out_dir, "sppmi",
                                      indptr=sindptr, key=skey, val=sval)
                    attrs["sppmi_nnz"] = int(len(skey))
                else:
                    attrs["sppmi_nnz"] = 0
                self.logger.info(f"sppmi nnz: {attrs['sppmi_nnz']}")

            self._finalize_artifact(out_dir, attrs)
        except Exception:
            import shutil
            shutil.rmtree(out_dir, ignore_errors=True)
            raise
        self.open(data_path)
        self.logger.info(f"DB built on {data_path}")
