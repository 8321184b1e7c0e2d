"""Bulk text-triple parsing and CSR construction.

Copy of ``buffalo_tpu.data.fileio`` for the PyTorch port: triple parsing
+ CSR compression (``sort_and_compressed_binarization``,
``fileio.hpp:263-419``) and the two-pass SPPMI co-occurrence builder
(``parallel_build_sppmi``, ``fileio.hpp:109-250``) that the ``Stream``
data type runs.  The hot path is vectorized numpy/pandas (C parsers); an
optional OpenMP C++ kernel (``native/``) accelerates the parse+sort path
and the SPPMI pair counting, and is used when available.
"""
from __future__ import annotations

import io
from typing import Optional, Tuple

import numpy as np

try:
    import pandas as pd
except ImportError:  # pragma: no cover
    pd = None


def parse_triples(path_or_buf, num_header_lines: int = 0
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse whitespace-separated ``row col [val]`` lines into numpy arrays.

    Returns (rows[int64], cols[int64], vals[float32]); a missing third
    column defaults to 1.0.  Indices are returned as found in the file
    (callers handle 1-based MatrixMarket offsets).
    """
    if pd is not None:
        df = pd.read_csv(
            path_or_buf, sep=r"\s+", header=None, skiprows=num_header_lines,
            comment="%", engine="c", dtype=np.float64)
        if df.shape[1] < 2:
            raise RuntimeError("Expected at least 2 columns of triple data")
        rows = df.iloc[:, 0].to_numpy(np.int64)
        cols = df.iloc[:, 1].to_numpy(np.int64)
        if df.shape[1] >= 3:
            vals = df.iloc[:, 2].to_numpy(np.float32)
        else:
            vals = np.ones(len(rows), dtype=np.float32)
        return rows, cols, vals
    # numpy fallback
    data = np.loadtxt(path_or_buf, comments="%", skiprows=num_header_lines,
                      ndmin=2)
    rows = data[:, 0].astype(np.int64)
    cols = data[:, 1].astype(np.int64)
    vals = (data[:, 2] if data.shape[1] >= 3
            else np.ones(len(rows))).astype(np.float32)
    return rows, cols, vals


def parse_triples_text(text: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    return parse_triples(io.StringIO(text))


def parse_triples_file(path: str, skip_bytes: int = 0
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse a triples file from a byte offset; native kernel when built."""
    from buffalo_tpu_torch.data import native
    result = native.parse_triples_native(path, skip_bytes)
    if result is not None:
        return result
    with open(path) as fin:
        fin.seek(skip_bytes)
        return parse_triples(fin)


def build_csr(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
              num_rows: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sort triples by (row, col) into CSR; native counting sort when
    available, np.lexsort otherwise."""
    from buffalo_tpu_torch.data import native
    if len(rows) and (rows.min() < 0 or rows.max() >= num_rows):
        bad = int(np.sum((rows < 0) | (rows >= num_rows)))
        raise ValueError(
            f"{bad} triples reference rows outside [0, {num_rows}); "
            "the input header row count is wrong")
    result = native.build_csr_native(rows, cols, vals, num_rows)
    if result is not None:
        return result
    order = np.lexsort((cols, rows))
    key = cols[order].astype(np.int32, copy=False)
    val = vals[order].astype(np.float32, copy=False)
    indptr = np.zeros(num_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=num_rows), out=indptr[1:])
    return indptr, key, val


def _row_chunks(indptr: np.ndarray, max_entries: int):
    """Yield (row_beg, row_end) covering all rows, each chunk holding
    at most ~max_entries nnz (single rows may exceed it)."""
    n_rows = len(indptr) - 1
    beg = 0
    while beg < n_rows:
        end = int(np.searchsorted(indptr, indptr[beg] + max_entries,
                                  side="right")) - 1
        end = min(max(end, beg + 1), n_rows)
        yield beg, end
        beg = end


def _numpy_sppmi_parts(indptr, keys, num_items, window, k, head_chunk,
                       chunk_entries=1 << 22):
    """Bounded-memory fallback: pair counting partitioned by head item.

    Peak memory is one partition's distinct pairs plus one row-chunk's
    window-shifted pair arrays — never the full pair stream (which is
    ~2 GB at KakaoBrunch scale in the old all-at-once formulation).
    """
    indptr = np.asarray(indptr, dtype=np.int64)
    keys = np.asarray(keys)
    n_rows = len(indptr) - 1
    degrees = np.diff(indptr)

    def chunk_pairs(r0, r1):
        sl = slice(int(indptr[r0]), int(indptr[r1]))
        kk = keys[sl]
        rid = np.repeat(np.arange(r0, r1, dtype=np.int64), degrees[r0:r1])
        for off in range(1, window + 1):
            if off >= len(kk):
                break
            same = rid[:-off] == rid[off:]
            yield kk[:-off][same].astype(np.int64), \
                kk[off:][same].astype(np.int64)

    occ = np.zeros(num_items, dtype=np.float64)
    d_total = 0.0
    for r0, r1 in _row_chunks(indptr, chunk_entries):
        for a, b in chunk_pairs(r0, r1):
            occ += np.bincount(a, minlength=num_items)
            occ += np.bincount(b, minlength=num_items)
            d_total += 2.0 * len(a)
    if d_total == 0:
        return []

    parts = []
    logk = np.log(float(k))
    for beg in range(0, num_items, head_chunk):
        end = min(num_items, beg + head_chunk)
        codes = []
        for r0, r1 in _row_chunks(indptr, chunk_entries):
            for a, b in chunk_pairs(r0, r1):
                m = (a >= beg) & (a < end)
                codes.append(a[m] * num_items + b[m])
                m = (b >= beg) & (b < end)
                codes.append(b[m] * num_items + a[m])
        if not codes:
            continue
        lin = np.concatenate(codes)
        if len(lin) == 0:
            continue
        uniq, counts = np.unique(lin, return_counts=True)
        rr = uniq // num_items
        cc = uniq % num_items
        sppmi = np.log(counts.astype(np.float64) * d_total
                       / (occ[rr] * occ[cc])) - logk
        keep = sppmi > 0
        parts.append((rr[keep].astype(np.int32),
                      cc[keep].astype(np.int32),
                      sppmi[keep].astype(np.float32)))
    return parts


def build_sppmi(indptr: np.ndarray, keys: np.ndarray, num_items: int,
                window: int = 5, k: int = 1, logger=None,
                max_pairs_in_memory: int = 1 << 26
                ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Build the shifted-positive-PMI co-occurrence matrix from streams.

    Same math as the reference (``fileio.hpp:109-250``): for every row
    (user sequence), each ordered pair of items within ``window`` of
    each other counts one symmetric co-occurrence; then
    ``sppmi = max(0, log(#(w,c) * D / (#w * #c)) - log k)`` and only
    positive entries are kept.  Returns CSR (indptr, key, val) over
    ``num_items`` rows, or None when no pair survives.

    Bounded memory: the pair space is partitioned by head item
    (``max_pairs_in_memory`` pairs per pass), with the C++/OpenMP
    kernel (``native/fileio.cc``) doing the counting when available
    and a chunked numpy path otherwise — the reference's chunked
    two-pass C++ builder is the model for both.
    """
    from buffalo_tpu_torch.data import native

    nnz = len(keys)
    est_total = 2 * window * max(nnz, 1)
    n_parts = max(1, -(-est_total // max_pairs_in_memory))
    head_chunk = max(1, -(-num_items // n_parts))

    parts = native.build_sppmi_native(indptr, keys, num_items, window, k,
                                      head_chunk)
    if parts is None:
        parts = _numpy_sppmi_parts(indptr, keys, num_items, window, k,
                                   head_chunk)
    parts = [p for p in parts if len(p[0])]
    if not parts:
        return None
    # both builders emit each head partition in (row, col) order and the
    # partitions in head order, so the concatenation is the CSR
    rr = np.concatenate([p[0] for p in parts]).astype(np.int64)
    cc = np.concatenate([p[1] for p in parts]).astype(np.int32)
    vv = np.concatenate([p[2] for p in parts])
    out_indptr = np.zeros(num_items + 1, dtype=np.int64)
    np.cumsum(np.bincount(rr, minlength=num_items), out=out_indptr[1:])
    return out_indptr, cc, vv
