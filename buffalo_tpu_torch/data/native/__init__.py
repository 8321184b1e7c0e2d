"""Native (C++/OpenMP) data kernels, bound via ctypes.

Copy of ``buffalo_tpu.data.native`` for the PyTorch port: the same
``fileio.cc`` source, compiled on first use with g++.  The library is
built into ``build/buffalo_tpu_torch/native/`` beside the package (a
git-ignored directory), never into the source tree, and keyed by a
hash of the source.  When no compiler is available the callers fall
back to the vectorized numpy paths in ``buffalo_tpu_torch.data.fileio``
and ``data.batching``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fileio.cc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    _HERE))), "build", "buffalo_tpu_torch", "native")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _lib_path() -> str:
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"_fileio_{digest}.so")


def _build(path: str) -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    # no -march=native: the build directory may travel with the checkout
    # to another host
    cmd = ["g++", "-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17",
           _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, path)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None."""
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    with _lock:
        if _lib is not None:
            return _lib
        path = _lib_path()
        if not os.path.isfile(path) and not _build(path):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            _build_failed = True
            return None
        lib.fileio_count_lines.restype = ctypes.c_int64
        lib.fileio_count_lines.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.fileio_parse_fill.restype = ctypes.c_int64
        lib.fileio_parse_fill.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib.fileio_build_csr.restype = ctypes.c_int
        lib.fileio_build_csr.argtypes = [
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int]
        lib.fileio_gather_remapped.restype = None
        lib.fileio_gather_remapped.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_void_p, ctypes.c_int]
        lib.fileio_sppmi_occ.restype = ctypes.c_int64
        lib.fileio_sppmi_occ.argtypes = [
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_double)]
        lib.fileio_sppmi_part.restype = ctypes.c_int64
        lib.fileio_sppmi_part.argtypes = [
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_double,
            ctypes.POINTER(ctypes.c_double), ctypes.c_double,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib.fileio_checksum.restype = None
        lib.fileio_checksum.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        lib.fileio_w2v_pairs_count.restype = ctypes.c_int64
        lib.fileio_w2v_pairs_count.argtypes = [
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64)]
        lib.fileio_w2v_pairs_fill.restype = None
        lib.fileio_w2v_pairs_fill.argtypes = [
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
        return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def parse_triples_native(path: str, skip_bytes: int = 0):
    """Parse ``row col [val]`` lines with the OpenMP kernel.

    Returns (rows int64, cols int64, vals float32) or None when the
    native library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    bpath = path.encode()
    n = lib.fileio_count_lines(bpath, skip_bytes)
    if n < 0:
        return None
    rows = np.empty(n, dtype=np.int64)
    cols = np.empty(n, dtype=np.int64)
    vals = np.empty(n, dtype=np.float32)
    got = lib.fileio_parse_fill(bpath, skip_bytes,
                                _ptr(rows, ctypes.c_int64),
                                _ptr(cols, ctypes.c_int64),
                                _ptr(vals, ctypes.c_float), n)
    if got < 0:
        return None
    return rows[:got], cols[:got], vals[:got]


def build_csr_native(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                     num_rows: int, sort_cols: bool = True):
    """Counting-sort CSR build.  Returns (indptr, key, val) or None."""
    lib = get_lib()
    if lib is None:
        return None
    nnz = len(rows)
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    indptr = np.zeros(num_rows + 1, dtype=np.int64)
    out_key = np.empty(nnz, dtype=np.int32)
    out_val = np.empty(nnz, dtype=np.float32)
    rc = lib.fileio_build_csr(nnz, _ptr(rows, ctypes.c_int64),
                              _ptr(cols, ctypes.c_int64),
                              _ptr(vals, ctypes.c_float), num_rows,
                              _ptr(indptr, ctypes.c_int64),
                              _ptr(out_key, ctypes.c_int32),
                              _ptr(out_val, ctypes.c_float),
                              1 if sort_cols else 0)
    if rc != 0:
        # the kernel drops out-of-range rows; a silent drop would leave
        # indptr[-1] < nnz with a garbage tail — corrupt input, not a
        # reason to fall back
        raise ValueError(
            f"{rc} triples reference rows outside [0, {num_rows}); "
            "the input header row count is wrong")
    return indptr, out_key, out_val


def build_sppmi_native(indptr: np.ndarray, keys: np.ndarray,
                       num_items: int, window: int, k: int,
                       head_chunk: int):
    """Partitioned SPPMI build (see fileio.cc).  Yields per-partition
    (rows, cols, vals) triple arrays, or returns None when the native
    library is unavailable."""
    import math

    lib = get_lib()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    keys = np.ascontiguousarray(keys, dtype=np.int32)
    n_rows = len(indptr) - 1
    occ = np.zeros(num_items, dtype=np.float64)
    d_total = lib.fileio_sppmi_occ(n_rows, _ptr(indptr, ctypes.c_int64),
                                   _ptr(keys, ctypes.c_int32), num_items,
                                   window, _ptr(occ, ctypes.c_double))
    if d_total <= 0:
        return []

    def parts():
        cap = max(1 << 16, 4 * d_total // max(
            1, -(-num_items // head_chunk)))
        for beg in range(0, num_items, head_chunk):
            end = min(num_items, beg + head_chunk)
            while True:
                out_r = np.empty(cap, dtype=np.int32)
                out_c = np.empty(cap, dtype=np.int32)
                out_v = np.empty(cap, dtype=np.float32)
                got = lib.fileio_sppmi_part(
                    n_rows, _ptr(indptr, ctypes.c_int64),
                    _ptr(keys, ctypes.c_int32), num_items, window,
                    math.log(float(k)), _ptr(occ, ctypes.c_double),
                    float(d_total), beg, end,
                    _ptr(out_r, ctypes.c_int32),
                    _ptr(out_c, ctypes.c_int32),
                    _ptr(out_v, ctypes.c_float), cap)
                if got >= 0:
                    yield out_r[:got], out_c[:got], out_v[:got]
                    break
                cap = -got

    return list(parts())


def checksum_native(arr: np.ndarray, n_chunks: int = 64):
    """Exact parallel positional checksum (``fileio_checksum``): the
    buffer's int64 words split into ``n_chunks`` contiguous ranges, each
    wrap-around summed, tail bytes into the last.

    Returns int64[n_chunks], or None when the native library is missing
    or the buffer is non-contiguous, unaligned or shorter than
    ``n_chunks`` words (the caller, ``ops.topk._fingerprint``, then runs
    its numpy pass, which gives the same sums).
    """
    lib = get_lib()
    if lib is None:
        return None
    if not arr.flags.c_contiguous or arr.ctypes.data % 8 != 0 \
            or arr.nbytes < 8 * n_chunks:
        return None
    out = np.zeros(n_chunks, dtype=np.int64)
    lib.fileio_checksum(arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes,
                        _ptr(out, ctypes.c_int64), n_chunks)
    return out


def w2v_pairs_native(words: np.ndarray, sents: np.ndarray,
                     h: np.ndarray, window: int):
    """Skip-gram pair generation (``fileio_w2v_pairs_count/fill``; the JAX
    package's ``w2v_pairs_native``).

    ``words`` int32 vocab ids of the subsampled token stream, ``sents``
    the int32 sentence id per token (non-decreasing), ``h`` the
    per-position shrunken half-width (the target position's h admits a
    pair).  Returns ``(inputs, targets)`` int32 arrays in position-major
    order — the same pair multiset as the numpy offset-major path of
    ``models/w2v.py`` — or None when the native library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    n = len(words)
    words = np.ascontiguousarray(words, dtype=np.int32)
    sents = np.ascontiguousarray(sents, dtype=np.int32)
    h = np.ascontiguousarray(h, dtype=np.int32)
    prefix = np.empty(n + 1, dtype=np.int64)
    total = lib.fileio_w2v_pairs_count(
        n, _ptr(sents, ctypes.c_int32), _ptr(h, ctypes.c_int32),
        int(window), _ptr(prefix, ctypes.c_int64))
    inputs = np.empty(total, dtype=np.int32)
    targets = np.empty(total, dtype=np.int32)
    if total:
        lib.fileio_w2v_pairs_fill(
            n, _ptr(words, ctypes.c_int32), _ptr(sents, ctypes.c_int32),
            _ptr(h, ctypes.c_int32), int(window),
            _ptr(prefix, ctypes.c_int64), _ptr(inputs, ctypes.c_int32),
            _ptr(targets, ctypes.c_int32))
    return inputs, targets


def gather_remapped_native(indptr: np.ndarray, key: np.ndarray,
                           val: Optional[np.ndarray], rows: np.ndarray,
                           B: int, L: int,
                           other_newpos: Optional[np.ndarray],
                           vals_dtype=np.float32):
    """One-pass padded ragged-CSR gather (see fileio.cc).

    Returns (lens int32[B], cols int32[B, L], vals float32[B, L]) or
    None when the native library is unavailable or an input layout the
    kernel does not handle is passed (caller falls back to numpy).  The
    port stages float32 values only.
    """
    lib = get_lib()
    if lib is None:
        return None
    if key.dtype == np.int64:
        key_is64 = 1
    elif key.dtype == np.int32:
        key_is64 = 0
    else:
        return None
    if np.dtype(vals_dtype) != np.float32:
        return None
    if val is not None and (val.dtype != np.float32
                            or not val.flags.c_contiguous):
        return None
    if not (key.flags.c_contiguous and indptr.dtype == np.int64
            and indptr.flags.c_contiguous):
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    if other_newpos is not None and not (
            other_newpos.dtype == np.int64
            and other_newpos.flags.c_contiguous):
        other_newpos = np.ascontiguousarray(other_newpos, dtype=np.int64)
    out_lens = np.zeros(B, dtype=np.int32)
    out_cols = np.zeros((B, L), dtype=np.int32)
    out_vals = np.zeros((B, L), dtype=np.float32)
    lib.fileio_gather_remapped(
        _ptr(indptr, ctypes.c_int64), _ptr(rows, ctypes.c_int64),
        len(rows), key.ctypes.data_as(ctypes.c_void_p), key_is64,
        None if val is None else _ptr(val, ctypes.c_float),
        None if other_newpos is None else _ptr(other_newpos,
                                               ctypes.c_int64),
        L, _ptr(out_lens, ctypes.c_int32), _ptr(out_cols, ctypes.c_int32),
        out_vals.ctypes.data_as(ctypes.c_void_p), 0)
    return out_lens, out_cols, out_vals
