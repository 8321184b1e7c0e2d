"""Compiled interaction database: a directory of memmap-able npy arrays.

Behavioral counterpart of the reference's HDF5 "database"
(``buffalo/data/base.py:15-451``): groups ``rowwise`` / ``colwise`` /
``vali`` / ``idmap`` / ``sppmi``, a header with
``num_users/num_items/num_nnz`` and a ``completed`` flag that rejects
partially built artifacts, validation carve-outs (``sample`` — random
nnz, ``newest`` — last-n per row), value preprocessing, and the same
iteration/get access APIs.  Instead of h5py chunked datasets we store
plain ``.npy`` files opened with ``np.load(mmap_mode="r")`` — zero-copy
host RAM views that the batcher slices into fixed-shape padded device
batches.  A copy of ``buffalo_tpu.data.base`` for the PyTorch port: the
two packages read and write the same directory format.

CSR layout note: we use the standard ``indptr`` of length ``rows+1``
(``indptr[0] == 0``), unlike the reference's length-``rows``
"ends-only" variant (``data/base.py:191``); accessors keep identical
semantics.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from buffalo_tpu_torch.data import prepro
from buffalo_tpu_torch.utils import Option, log

GROUP_ARRAYS = {
    "rowwise": ("indptr", "key", "val"),
    "colwise": ("indptr", "key", "val"),
    "sppmi": ("indptr", "key", "val"),
    "vali": ("row", "col", "val"),
    "idmap": ("rows", "cols"),
}


class Data:
    """An opened (or openable) compiled dataset directory."""

    name = "Data"

    def __init__(self, opt, *args, **kwargs):
        self.opt = Option(opt)
        self.logger = log.get_logger(self.name)
        self.tmp_root = self.opt.data.tmp_dir
        os.makedirs(self.tmp_root, exist_ok=True)
        self.path: Optional[str] = None
        self.handle: Optional[Dict[str, Dict[str, np.ndarray]]] = None
        self.header = None
        self.attrs: Dict = {}
        self.prepro = prepro.PreProcess(self.opt.data)
        if self.opt.data.get("value_prepro"):
            self.prepro = getattr(prepro, self.opt.data.value_prepro.name)(
                self.opt.data.value_prepro)
        self.value_prepro = self.prepro
        self.data_type: Optional[str] = None

    # ------------------------------------------------------------------ open
    def open(self, data_path: str) -> None:
        data_path = str(data_path)
        if not os.path.isdir(data_path):
            raise RuntimeError(f"Database not found at {data_path}")
        with open(os.path.join(data_path, "header.json")) as fin:
            self.attrs = json.load(fin)
        self.handle = {}
        for group, arrays in GROUP_ARRAYS.items():
            gdict = {}
            for arr in arrays:
                fpath = os.path.join(data_path, f"{group}.{arr}.npy")
                if os.path.isfile(fpath):
                    gdict[arr] = np.load(fpath, mmap_mode="r")
            if gdict:
                self.handle[group] = gdict
        self.path = data_path
        self.header = None
        self.verify()

    def verify(self) -> None:
        assert self.handle is not None, "Database is not opened"
        if self.get_header()["completed"] != 1:
            raise RuntimeError(
                "Database is corrupted or partially built. "
                "Please try again, after removing it.")

    def close(self) -> None:
        self.handle = None
        self.header = None

    # ---------------------------------------------------------------- access
    def get_header(self) -> dict:
        assert self.handle is not None, "Database is not opened"
        if not self.header:
            self.header = {
                "num_nnz": self.attrs["num_nnz"],
                "num_users": self.attrs["num_users"],
                "num_items": self.attrs["num_items"],
                "completed": self.attrs["completed"],
            }
        return self.header

    def get_scale_info(self, with_sppmi: bool = False) -> dict:
        ret = {k: self.attrs[k] for k in ["num_users", "num_items", "num_nnz"]}
        if with_sppmi:
            ret["sppmi_nnz"] = self.attrs.get("sppmi_nnz", 0)
        ret["vsum"] = float(np.sum(self.handle["rowwise"]["val"], dtype=np.float64))
        return ret

    def get_group(self, group_name: str = "rowwise") -> Dict[str, np.ndarray]:
        assert group_name in GROUP_ARRAYS, f"Unexpected group_name: {group_name}"
        assert self.handle is not None, "DB is not opened"
        return self.handle[group_name]

    def has_group(self, name: str) -> bool:
        return self.handle is not None and name in self.handle

    def get(self, index: int, axis: str = "rowwise") -> Tuple[np.ndarray, ...]:
        """Return the (keys, vals) — or (keys,) for stream data — of one row."""
        assert self.handle is not None, "Database is not opened"
        group = self.handle[axis]
        indptr = group["indptr"]
        begin, end = int(indptr[index]), int(indptr[index + 1])
        if self.opt.data.internal_data_type == "stream":
            assert axis == "rowwise", f"Unexpected data axis: {axis}"
            return (group["key"][begin:end],)
        assert axis in ("rowwise", "colwise"), f"Unexpected data axis: {axis}"
        return (group["key"][begin:end], group["val"][begin:end])

    def iterate(self, axis: str = "rowwise", use_repr_name: bool = False) -> Iterator:
        """Yield (row, key[, val]) triples over the whole database."""
        assert self.handle is not None, "Database is not opened"
        userids = itemids = None
        if use_repr_name:
            idmap = self.get_group("idmap")
            rows_map, cols_map = idmap.get("rows"), idmap.get("cols")
            userids = (lambda x: str(x)) if rows_map is None or rows_map.shape[0] == 0 \
                else (lambda x: str(rows_map[x]))
            itemids = (lambda x: str(x)) if cols_map is None or cols_map.shape[0] == 0 \
                else (lambda x: str(cols_map[x]))
            if axis == "colwise":
                userids, itemids = itemids, userids

        group = self.handle[axis]
        indptr = group["indptr"]
        keys = group["key"]
        is_stream = self.opt.data.internal_data_type == "stream"
        vals = None if is_stream else group["val"]
        for u in range(len(indptr) - 1):
            beg, end = int(indptr[u]), int(indptr[u + 1])
            for idx in range(beg, end):
                k = int(keys[idx])
                uu, kk = (userids(u), itemids(k)) if use_repr_name else (u, k)
                if is_stream:
                    yield uu, kk
                else:
                    yield uu, kk, float(vals[idx])

    def show_info(self) -> str:
        header = self.get_header()
        vali_size = 0
        if self.has_group("vali"):
            vali_size = self.attrs.get("num_validation_samples", 0)
        return (f"{self.name} Header({header['num_users']}, "
                f"{header['num_items']}, {header['num_nnz']}) "
                f"Validation({vali_size} samples)")

    # ------------------------------------------------------------ validation
    def _prepare_validation_data(self) -> bool:
        """Materialize per-row ground-truth and seen sets for evaluation.

        Same outputs as the reference ``data/base.py:255-290``:
        ``vali_data`` with row/col/val plus ``vali_rows``, ``vali_gt``,
        ``validation_seen`` and ``validation_max_seen_size``.
        """
        if hasattr(self, "vali_data"):
            return True
        vali = self.get_group("vali")
        row = np.asarray(vali["row"])
        col = np.asarray(vali["col"])
        val = np.asarray(vali["val"])

        order = np.argsort(row, kind="stable")
        sorted_rows = row[order]
        sorted_cols = col[order]
        vali_rows, first_idx = np.unique(sorted_rows, return_index=True)
        boundaries = np.append(first_idx, len(sorted_rows))
        vali_gt = {
            int(u): set(map(int, sorted_cols[boundaries[i]:boundaries[i + 1]]))
            for i, u in enumerate(vali_rows)
        }
        validation_seen = {}
        max_seen_size = 0
        for u in vali_rows:
            seen, *_ = self.get(int(u))
            validation_seen[int(u)] = set(map(int, seen))
            max_seen_size = max(max_seen_size, len(seen))
        self.vali_data = {
            "row": row,
            "col": col,
            "val": val,
            "vali_rows": vali_rows.astype(np.int64),
            "vali_gt": vali_gt,
            "validation_seen": validation_seen,
            "validation_max_seen_size": max_seen_size,
        }
        return True


class DataBuilder(Data):
    """Shared builder machinery: carve validation, write CSR groups, finalize.

    Counterpart of the build half of the reference ``Data``
    (``_create_database``/``_create_validation``/``_build_data``,
    ``data/base.py:176-451``), but operating on in-memory triple arrays:
    parsing produces ``(rows, cols, vals)`` numpy arrays, validation
    indices are cut out, both CSR orientations are built with
    ``np.lexsort`` (native C++ sort kernels slot in here for the
    out-of-core path) and written as ``.npy`` files.
    """

    def _carve_validation(self, rows: np.ndarray, cols: np.ndarray,
                          vals: np.ndarray, rng: np.random.Generator):
        """Split triples into (train, validation) according to opt.data.validation.

        ``sample``: uniformly drawn nnz indices (``data/base.py:220-227``).
        ``newest``: the last ``n`` entries of each row in input order
        (``data/stream.py``), capped at ``max_samples`` total.
        Returns (train_triples, vali_triples or None).
        """
        vopt = self.opt.data.get("validation")
        n_total = len(rows)
        if not vopt or n_total == 0:
            return (rows, cols, vals), None
        name = vopt["name"]
        if name == "sample":
            # keep at least one train entry (stream.py caps likewise)
            sz = min(int(vopt.max_samples), int(n_total * float(vopt.p)),
                     max(n_total - 1, 0))
            if sz <= 0:
                return (rows, cols, vals), None
            vali_idx = rng.choice(n_total, size=sz, replace=False)
        elif name == "newest":
            n = int(vopt["n"])
            # last-n per row in input order, capped at degree-1 so no
            # row is carved empty (reference stream.py:
            # ``min(vali_n, len(data) - 1)``)
            degrees = np.bincount(np.asarray(rows, dtype=np.int64))
            seen_count: Dict[int, int] = {}
            picks = []
            for idx in range(n_total - 1, -1, -1):
                r = int(rows[idx])
                c = seen_count.get(r, 0)
                if c < min(n, int(degrees[r]) - 1):
                    picks.append(idx)
                    seen_count[r] = c + 1
            vali_idx = np.array(sorted(picks), dtype=np.int64)
            max_samples = int(vopt.get("max_samples", len(vali_idx)))
            if len(vali_idx) > max_samples:
                vali_idx = rng.choice(vali_idx, size=max_samples, replace=False)
        else:
            raise RuntimeError(f"Unknown validation.name: {name}")
        mask = np.ones(n_total, dtype=bool)
        mask[vali_idx] = False
        train = (rows[mask], cols[mask], vals[mask])
        vali = (rows[vali_idx], cols[vali_idx], vals[vali_idx])
        return train, vali

    @staticmethod
    def _build_csr(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                   num_rows: int):
        """Sort triples by (row, col) and emit (indptr[int64], key, val).

        Delegates to the native OpenMP counting-sort kernel when built
        (``data/native/fileio.cc``), numpy lexsort otherwise.
        """
        from buffalo_tpu_torch.data.fileio import build_csr
        return build_csr(rows, cols, vals, num_rows)

    def _write_group(self, out_dir: str, group: str, **arrays: np.ndarray) -> None:
        for name, arr in arrays.items():
            np.save(os.path.join(out_dir, f"{group}.{name}.npy"), arr)

    def _start_artifact(self, path: str) -> str:
        if os.path.exists(path):
            self.logger.info(
                f"File {path} exists. To build new database, "
                f"existing file {path} will be deleted.")
            shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
        os.makedirs(path)
        return path

    def _finalize_artifact(self, out_dir: str, attrs: dict) -> None:
        attrs = dict(attrs)
        attrs["completed"] = 1
        with open(os.path.join(out_dir, "header.json"), "w") as fout:
            json.dump(attrs, fout)

    def _build_core(self, out_dir: str, rows: np.ndarray, cols: np.ndarray,
                    vals: np.ndarray, num_users: int, num_items: int,
                    userids, itemids, rng: np.random.Generator,
                    with_colwise: bool = True) -> dict:
        """Carve validation, apply value-prepro, write both CSR orientations."""
        vals = self.value_prepro(np.asarray(vals, dtype=np.float32))
        (trows, tcols, tvals), vali = self._carve_validation(rows, cols, vals, rng)

        indptr, key, val = self._build_csr(trows, tcols, tvals, num_users)
        val = self.value_prepro.post(val)
        self._write_group(out_dir, "rowwise", indptr=indptr, key=key, val=val)
        if with_colwise:
            cindptr, ckey, cval = self._build_csr(tcols, trows, tvals, num_items)
            cval = self.value_prepro.post(cval)
            self._write_group(out_dir, "colwise", indptr=cindptr, key=ckey, val=cval)

        num_validation_samples = 0
        if vali is not None:
            vrows, vcols, vvals = vali
            self._write_group(out_dir, "vali",
                              row=vrows.astype(np.int32),
                              col=vcols.astype(np.int32),
                              val=vvals.astype(np.float32))
            num_validation_samples = len(vrows)

        self._write_group(
            out_dir, "idmap",
            rows=np.asarray(userids if userids is not None else [], dtype=np.str_),
            cols=np.asarray(itemids if itemids is not None else [], dtype=np.str_))

        return {
            "num_users": int(num_users),
            "num_items": int(num_items),
            "num_nnz": int(len(trows)),
            "num_validation_samples": int(num_validation_samples),
        }


    # ------------------------------------------------------- disk-based build
    def _build_core_disk(self, out_dir: str, chunk_iter,
                         num_users: int, num_items: int,
                         userids, itemids, rng: np.random.Generator,
                         with_colwise: bool = True,
                         declared_nnz: Optional[int] = None) -> dict:
        """Out-of-core two-pass counting-sort build (``disk_based=True``).

        Counterpart of the reference's external-sort path
        (``aux.psort`` + ``chunking_into_bins`` + compressed
        binarization, ``data/base.py:399-451``): the triple stream is
        consumed twice via ``chunk_iter()`` (a callable returning an
        iterator of (rows, cols, vals) numpy chunks); only
        O(num_users + num_items) host RAM is held — payload arrays are
        np.memmap files inside the artifact.

        Validation: ``sample`` (per-entry Bernoulli with rate p capped
        at max_samples via thinning) or none; ``newest`` requires the
        in-memory path.
        """
        vopt = self.opt.data.get("validation") or {}
        vname = vopt.get("name")
        if vname == "newest":
            raise NotImplementedError(
                "validation.name='newest' requires disk_based=False")

        # ---- pass 1: degrees + nnz + value-prepro statistics
        deg_u = np.zeros(num_users, dtype=np.int64)
        deg_i = np.zeros(num_items, dtype=np.int64)
        n_total = 0
        for rows, cols, vals in chunk_iter():
            self.value_prepro.update_stats(vals)
            deg_u += np.bincount(rows, minlength=num_users)
            deg_i += np.bincount(cols, minlength=num_items)
            n_total += len(rows)
        if declared_nnz is not None and n_total != declared_nnz:
            # same loud failure as the in-memory path: a truncated file
            # must not become a silently smaller completed database
            raise RuntimeError(
                f"header declares {declared_nnz} entries but {n_total} "
                "were parsed")

        # choose validation entries by global index (deterministic)
        vali_mask_of = None
        n_vali = 0
        if vname == "sample":
            p = float(vopt.get("p", 0.01))
            max_samples = int(vopt.get("max_samples", 500))
            want = min(int(n_total * p), max_samples)
            if want > 0:
                vali_idx = np.sort(rng.choice(n_total, size=want,
                                              replace=False))
                n_vali = want

                def vali_mask_of(beg, end):
                    lo = np.searchsorted(vali_idx, beg)
                    hi = np.searchsorted(vali_idx, end)
                    mask = np.zeros(end - beg, dtype=bool)
                    mask[vali_idx[lo:hi] - beg] = True
                    return mask

        nnz = n_total - n_vali

        def _mm(where, name, dtype, shape):
            return np.lib.format.open_memmap(
                os.path.join(where, name), mode="w+", dtype=dtype,
                shape=shape)

        vali_row = vali_col = vali_val = None
        if n_vali:
            vali_row = np.zeros(n_vali, dtype=np.int32)
            vali_col = np.zeros(n_vali, dtype=np.int32)
            vali_val = np.zeros(n_vali, dtype=np.float32)

        # scatter targets are sized for the FULL stream (validation
        # entries leave holes compacted away afterwards)
        cap = max(n_total, 1)
        # unique scratch dir: two concurrent builds sharing tmp_dir
        # must not interleave writes into the same memmaps
        import tempfile
        tmp_dir = tempfile.mkdtemp(prefix="disk_build_", dir=self.tmp_root)
        tkey_r = _mm(tmp_dir, "r.key.npy", np.int32, (cap,))
        tval_r = _mm(tmp_dir, "r.val.npy", np.float32, (cap,))
        key_r = _mm(out_dir, "rowwise.key.npy", np.int32, (max(nnz, 1),))
        val_r = _mm(out_dir, "rowwise.val.npy", np.float32, (max(nnz, 1),))
        if with_colwise:
            tkey_c = _mm(tmp_dir, "c.key.npy", np.int32, (cap,))
            tval_c = _mm(tmp_dir, "c.val.npy", np.float32, (cap,))
            key_c = _mm(out_dir, "colwise.key.npy", np.int32,
                        (max(nnz, 1),))
            val_c = _mm(out_dir, "colwise.val.npy", np.float32,
                        (max(nnz, 1),))

        indptr_u = np.zeros(num_users + 1, dtype=np.int64)
        np.cumsum(deg_u, out=indptr_u[1:])
        indptr_i = np.zeros(num_items + 1, dtype=np.int64)
        np.cumsum(deg_i, out=indptr_i[1:])
        cur_u = indptr_u[:-1].copy()
        cur_i = indptr_i[:-1].copy()

        # ---- pass 2: scatter into CSR payloads
        def _scatter(cursor, rws, cls, vls, key_mm, val_mm):
            order = np.argsort(rws, kind="stable")
            r_s, c_s, v_s = rws[order], cls[order], vls[order]
            uniq, start_idx, counts = np.unique(
                r_s, return_index=True, return_counts=True)
            within = np.arange(len(r_s), dtype=np.int64) - np.repeat(
                start_idx, counts)
            pos = cursor[r_s] + within
            key_mm[pos] = c_s
            val_mm[pos] = v_s
            np.add.at(cursor, uniq, counts)

        seen = 0
        placed_v = 0
        for rows, cols, vals in chunk_iter():
            vals = self.value_prepro(np.asarray(vals, np.float32))
            n = len(rows)
            if vali_mask_of is not None:
                vm = vali_mask_of(seen, seen + n)
                nv = int(vm.sum())
                if nv:
                    vali_row[placed_v:placed_v + nv] = rows[vm]
                    vali_col[placed_v:placed_v + nv] = cols[vm]
                    vali_val[placed_v:placed_v + nv] = vals[vm]
                    placed_v += nv
                keep = ~vm
                rows, cols, vals = rows[keep], cols[keep], vals[keep]
            seen += n
            _scatter(cur_u, rows.astype(np.int64), cols.astype(np.int32),
                     vals, tkey_r, tval_r)
            if with_colwise:
                _scatter(cur_i, cols.astype(np.int64),
                         rows.astype(np.int32), vals, tkey_c, tval_c)

        # cursors now hold per-row ends (train-only); rebuild indptr
        new_indptr_u = np.zeros(num_users + 1, dtype=np.int64)
        lens_u = cur_u - indptr_u[:-1]
        np.cumsum(lens_u, out=new_indptr_u[1:])
        if with_colwise:
            new_indptr_i = np.zeros(num_items + 1, dtype=np.int64)
            lens_i = cur_i - indptr_i[:-1]
            np.cumsum(lens_i, out=new_indptr_i[1:])

        # compact (drop validation holes) + per-row col sort, blockwise
        def _compact_sort(indptr_old, cursor, new_indptr, src_k, src_v,
                          dst_k, dst_v, block=1 << 14):
            n_rows = len(indptr_old) - 1
            for beg in range(0, n_rows, block):
                end = min(beg + block, n_rows)
                parts_k, parts_v = [], []
                for r in range(beg, end):
                    s, e = indptr_old[r], cursor[r]
                    k = np.asarray(src_k[s:e])
                    v = np.asarray(src_v[s:e])
                    o = np.argsort(k, kind="stable")
                    parts_k.append(k[o])
                    parts_v.append(v[o])
                k = np.concatenate(parts_k) if parts_k else \
                    np.zeros(0, src_k.dtype)
                v = np.concatenate(parts_v) if parts_v else \
                    np.zeros(0, src_v.dtype)
                dst_k[new_indptr[beg]:new_indptr[end]] = k
                dst_v[new_indptr[beg]:new_indptr[end]] = \
                    self.value_prepro.post(v)

        _compact_sort(indptr_u, cur_u, new_indptr_u, tkey_r, tval_r,
                      key_r, val_r)
        np.save(os.path.join(out_dir, "rowwise.indptr.npy"), new_indptr_u)
        key_r.flush(); val_r.flush()
        if with_colwise:
            _compact_sort(indptr_i, cur_i, new_indptr_i, tkey_c, tval_c,
                          key_c, val_c)
            np.save(os.path.join(out_dir, "colwise.indptr.npy"),
                    new_indptr_i)
            key_c.flush(); val_c.flush()
        shutil.rmtree(tmp_dir, ignore_errors=True)

        if n_vali:
            self._write_group(out_dir, "vali", row=vali_row[:placed_v],
                              col=vali_col[:placed_v],
                              val=vali_val[:placed_v])
        self._write_group(
            out_dir, "idmap",
            rows=np.asarray(userids if userids is not None else [],
                            dtype=np.str_),
            cols=np.asarray(itemids if itemids is not None else [],
                            dtype=np.str_))
        return {
            "num_users": int(num_users),
            "num_items": int(num_items),
            "num_nnz": int(nnz),
            "num_validation_samples": int(placed_v),
        }


class DataOption:
    """Validation of the data-option subtree (reference ``data/base.py:454-473``)."""

    def get_default_option(self) -> Option:
        raise NotImplementedError

    def is_valid_option(self, opt) -> bool:
        assert "data" in opt, "data options not defined"
        assert "disk_based" in opt["data"], "disk_based not defined on data"
        assert isinstance(opt["data"]["disk_based"], bool), \
            "invalid type for data.disk_based"
        if opt["data"].get("validation"):
            vali = opt["data"]["validation"]
            assert vali["name"] in ["sample", "newest"], "Unknown validation.name."
            if vali["name"] == "sample":
                assert "max_samples" in vali, "max_samples not defined on data.validation."
                assert isinstance(vali["max_samples"], int), \
                    "invalid type for data.validation.max_samples"
                assert "p" in vali, "not defined on data.validation.p"
                assert isinstance(vali["p"], float), "invalid type for data.validation.p"
            if vali["name"] == "newest":
                assert "max_samples" in vali, "max_samples not defined on data.validation."
                assert isinstance(vali["max_samples"], int), \
                    "invalid type for data.validation.max_samples"
                assert "n" in vali, "not defined on data.validation.n"
                assert isinstance(vali["n"], int), "invalid type for data.validation.n"
        return True
