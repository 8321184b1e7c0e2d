"""Bulk text-triple parsing and CSR construction.

Copy of ``buffalo_tpu.data.fileio`` for the PyTorch port, less the SPPMI
builder (only the ``Stream`` data type needs it, and the port does not
have it yet): triple parsing + CSR compression
(``sort_and_compressed_binarization``, ``fileio.hpp:263-419``).  The hot
path is vectorized numpy/pandas (C parsers); an optional OpenMP C++
kernel (``native/``) accelerates the parse+sort path and is used when
available.
"""
from __future__ import annotations

import io
from typing import Tuple

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
