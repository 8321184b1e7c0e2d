"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each kernel source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``; the
first use builds every source at once, one ``nvcc`` process each, in
parallel.  Libraries go to ``build/buffalo_tpu_torch/<hash>/`` beside
the package (a git-ignored directory), keyed by a hash of all sources
and flags, so an edited source is rebuilt and an unchanged one is not.
Nothing is imported or built until a kernel is first launched.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(_CSRC)),
                           "build", "buffalo_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas=-v"]
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from csrc/ at first use")


def sources():
    """Kernel name -> .cu path, one library per source."""
    return {os.path.splitext(os.path.basename(p))[0]: p
            for p in sorted(glob.glob(os.path.join(_CSRC, "*.cu")))}


def _build_dir() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(_CSRC, "*.cu*"))):
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode() + fh.read())
    return os.path.join(_BUILD_ROOT, h.hexdigest()[:16])


def build_all() -> str:
    """Compile every missing library in parallel; returns the build dir."""
    out = _build_dir()
    todo = {name: src for name, src in sources().items()
            if not os.path.isfile(os.path.join(out, f"lib{name}.so"))}
    if not todo:
        return out
    os.makedirs(out, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, src in todo.items():
        tmp = os.path.join(out, f"lib{name}.{os.getpid()}.tmp.so")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", _CSRC, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        with open(os.path.join(out, f"{name}.log"), "w") as fh:
            fh.write(log)  # ptxas: registers, shared memory, spills
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, os.path.join(out, f"lib{name}.so"))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load_kernel(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (building all on first use)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            out = build_all()
            for n in sources():
                _libs[n] = ctypes.CDLL(os.path.join(out, f"lib{n}.so"))
        return _libs[name]


_launchers: Dict[str, object] = {}


def launcher(name: str, argtypes, library: str = None):
    """The C launch function ``name`` of library ``library`` (default:
    ``name``) with its ``argtypes``; every launch function returns its
    ``cudaError_t``."""
    f = _launchers.get(name)
    if f is None:
        f = getattr(load_kernel(library or name), name)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _launchers[name] = f
    return f
