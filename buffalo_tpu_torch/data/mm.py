"""MatrixMarket input → compiled dataset artifact.

Counterpart of the reference ``buffalo/data/mm.py`` — same option tree
(``MatrixMarketOptions``, ``mm.py:14-55``), same accepted inputs for
``input.main`` (file path, scipy sparse matrix, or dense 2-D ndarray —
``mm.py:62-80``) and for ``input.uid/iid`` (path, list, or 1-D array),
same build flow: parse header, carve validation, build rowwise+colwise
CSR, store id maps (``mm.py:110-234``).
"""
from __future__ import annotations

import os

import numpy as np
import scipy.sparse

from buffalo_tpu_torch.data.base import DataBuilder, DataOption
from buffalo_tpu_torch.data.fileio import parse_triples_file
from buffalo_tpu_torch.utils import Option


class MatrixMarketOptions(DataOption):
    def get_default_option(self) -> Option:
        opt = {
            "type": "matrix_market",
            "input": {
                "main": "",
                "uid": "",  # if not set, row-id is used as userid
                "iid": "",  # if not set, col-id is used as itemid
            },
            "data": {
                "internal_data_type": "matrix",
                "validation": {
                    "name": "sample",
                    "p": 0.01,
                    "max_samples": 500,
                },
                "batch_mb": 1024,
                "use_cache": False,
                "tmp_dir": "/tmp/",
                "path": "./mm.bfo",
                "disk_based": False,
                "random_seed": 0,
            },
        }
        return Option(opt)

    def is_valid_option(self, opt) -> bool:
        assert super().is_valid_option(opt)
        if not opt["type"] == "matrix_market":
            raise RuntimeError(f"Invalid data type: {opt['type']}")
        if opt["data"]["internal_data_type"] != "matrix":
            raise RuntimeError("MatrixMarket only support internal data type(matrix)")
        for field in ["uid", "iid"]:
            id_path = opt["input"][field]
            is_1d_dense = isinstance(id_path, np.ndarray) and id_path.ndim == 1
            msg = (f"Not supported data type for "
                   f"MatrixMarketOption.input.{field}: {type(id_path)}")
            assert isinstance(id_path, (str, list)) or is_1d_dense, msg
        main = opt["input"]["main"]
        is_2d_dense = isinstance(main, np.ndarray) and main.ndim == 2
        is_sparse = scipy.sparse.issparse(main)
        msg = (f"Not supported data type for "
               f"MatrixMarketOption.input.main field: {type(main)}")
        assert isinstance(main, str) or is_2d_dense or is_sparse, msg
        return True


def _load_id_list(source) -> list | None:
    if source is None:
        return None
    if isinstance(source, str):
        if not source:
            return None
        with open(source) as fin:
            return [line.strip() for line in fin]
    if isinstance(source, np.ndarray):
        return [str(x) for x in source.tolist()]
    if isinstance(source, list):
        return [str(x) for x in source]
    raise RuntimeError(f"Unexpected type for id list: {type(source)}")


class MatrixMarket(DataBuilder):
    name = "MatrixMarket"

    def __init__(self, opt, *args, **kwargs):
        super().__init__(opt, *args, **kwargs)
        self.name = "MatrixMarket"
        from buffalo_tpu_torch.data.prepro import SPPMI
        if isinstance(self.value_prepro, SPPMI):
            # reference contract (mm.py:104-106): SPPMI weights come
            # from the Stream builder's co-occurrence pass, not from a
            # rating matrix
            raise RuntimeError(
                f"{self.opt.data.value_prepro.name} does not support "
                "MatrixMarket")
        self.data_type = "matrix"

    def _parse_main(self):
        """Return (rows0, cols0, vals, num_users, num_items) — 0-based."""
        main = self.opt.input.main
        if isinstance(main, np.ndarray) and main.ndim == 2:
            main = scipy.sparse.csr_matrix(main)
        if scipy.sparse.issparse(main):
            coo = main.tocoo()
            return (coo.row.astype(np.int64), coo.col.astype(np.int64),
                    coo.data.astype(np.float32),
                    int(main.shape[0]), int(main.shape[1]))
        # path to a MatrixMarket file
        if not os.path.isfile(main):
            raise RuntimeError(f"Input file not found: {main}")
        with open(main) as fin:
            header = fin.readline()
            if not header.startswith("%%MatrixMarket"):
                raise RuntimeError(f"Not a MatrixMarket file: {main}")
            line = fin.readline()
            while line.startswith("%"):
                line = fin.readline()
            num_users, num_items, num_nnz = map(int, line.strip().split())
            skip_bytes = fin.tell()
        rows, cols, vals = parse_triples_file(main, skip_bytes)
        if len(rows) != num_nnz:
            raise RuntimeError(
                f"MatrixMarket header declares {num_nnz} entries "
                f"but {len(rows)} were parsed")
        return rows - 1, cols - 1, vals, num_users, num_items

    def create(self) -> None:
        """Build the database; no-op when use_cache and a completed DB exists."""
        path = self.opt.data.path
        if self.opt.data.use_cache and os.path.isdir(path):
            try:
                self.open(path)
                self.logger.info("Cached database loaded.")
                return
            except Exception:
                self.close()
        self.logger.info("Create database from matrix market input")
        disk_based = bool(self.opt.data.get("disk_based", False)) and \
            isinstance(self.opt.input.main, str)
        if disk_based:
            num_users, num_items, declared_nnz, chunk_iter = \
                self._chunked_reader()
        else:
            rows, cols, vals, num_users, num_items = self._parse_main()
        userids = _load_id_list(self.opt.input.get("uid"))
        itemids = _load_id_list(self.opt.input.get("iid"))
        if userids is not None and len(userids) != num_users:
            raise RuntimeError(
                f"Mismatch between number of user ids({len(userids)}) "
                f"and number of rows({num_users})")
        if itemids is not None and len(itemids) != num_items:
            raise RuntimeError(
                f"Mismatch between number of item ids({len(itemids)}) "
                f"and number of cols({num_items})")

        out_dir = self._start_artifact(path)
        rng = np.random.default_rng(self.opt.data.get("random_seed", 0))
        try:
            if disk_based:
                attrs = self._build_core_disk(
                    out_dir, chunk_iter, num_users, num_items,
                    userids, itemids, rng, declared_nnz=declared_nnz)
            else:
                attrs = self._build_core(out_dir, rows, cols, vals,
                                         num_users, num_items,
                                         userids, itemids, rng)
            self._finalize_artifact(out_dir, attrs)
        except Exception:
            import shutil
            shutil.rmtree(out_dir, ignore_errors=True)
            raise
        self.open(path)
        self.logger.info(self.show_info())

    def _chunked_reader(self, chunk_lines: int = 4_000_000):
        """Out-of-core input: (num_users, num_items, declared_nnz,
        chunk_iter) where
        chunk_iter() re-reads the file in bounded chunks (disk_based
        path; the reference streams 4 MB chunks, ``mm.py:167-234``)."""
        main = self.opt.input.main
        with open(main) as fin:
            header = fin.readline()
            if not header.startswith("%%MatrixMarket"):
                raise RuntimeError(f"Not a MatrixMarket file: {main}")
            line = fin.readline()
            while line.startswith("%"):
                line = fin.readline()
            num_users, num_items, num_nnz = map(int, line.strip().split())
            body_start = fin.tell()

        def chunk_iter():
            # stdlib/numpy chunked parser (no pandas dependency): read
            # `chunk_lines` text lines past the header, parse with
            # np.fromstring-style splitting; tolerant of 2-column
            # (implicit value 1.0) and comment lines
            with open(main) as fin:
                fin.seek(body_start)
                while True:
                    lines = fin.readlines(chunk_lines * 24)
                    if not lines:
                        return
                    arr = np.loadtxt(
                        [ln for ln in lines
                         if ln.strip() and not ln.startswith("%")],
                        dtype=np.float64, ndmin=2)
                    if arr.size == 0:
                        continue
                    rows = arr[:, 0].astype(np.int64) - 1
                    cols = arr[:, 1].astype(np.int64) - 1
                    vals = (arr[:, 2].astype(np.float32) if arr.shape[1] > 2
                            else np.ones(len(rows), np.float32))
                    yield rows, cols, vals

        return num_users, num_items, num_nnz, chunk_iter
