"""Where K2's time goes: K2 rebuilt with parts of its work switched off.

    python3 tools/k2_breakdown.py        # on a machine with an NVIDIA card

The card's profilers that count instructions (ncu, nsys) are not always at
hand, so this builds copies of ``buffalo_tpu_torch/csrc/als_normal_
equations.cu`` with one part of the work cut out by a source edit, and
times each on random dense batches (CUDA events, 20 launches after 3 warm
ones, the C launch function called directly, so no Python checks or
allocations are timed):

* ``kernel``: the kernel as it is;
* ``no_gather``: the Bf rows are not copied (the product runs on stale
  shared memory);
* ``no_product``: the tensor-core loop is skipped;
* ``neither``: both, leaving per-row set-up, the stage loop's barriers and
  index loads, and the A write;
* ``setup_only``: no stage loop at all;
* ``one_tf32``: one TF32 product per tile instead of the three of 3xTF32;
* ``l1_copies``: the gather's 16-byte copies through L1 (``cp.async.ca``)
  instead of L2 only (``cp.async.cg``), as K1's are.

Only ``kernel`` and ``l1_copies`` are right; the others show the share of
the part they cut.
Each line printed is one batch: its shape and, per variant, milliseconds.
The edits match the source text exactly and fail loudly when it changes.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from buffalo_tpu_torch.ops import _build  # noqa: E402
from buffalo_tpu_torch.ops import als_kernels as K  # noqa: E402

NAME = "als_normal_equations"
LOOP = "  for (int ks = eg; ks * 8 < tl; ks += p.EG) {"
COPY16 = "        if (p.vec) cp_async16(Fst + l * S + c, from, col >= 0);"
COPY4 = "        else cp_async4(Fst + l * S + c, from, col >= 0);"
STAGES = "  for (int i = 0; i < ntiles; ++i) {"
THREE = """            mma_tf32_first(step, as, bb);
            mma_tf32(step, ab, bs);
            mma_tf32(step, ab, bb);"""
L2ONLY = "cp.async.cg.shared.global [%0], [%1], 16, %2;"
NO_GATHER = [(COPY16, COPY16.replace("if (p.vec)", "if (false)")),
             (COPY4, COPY4.replace("else ", "else if (false) "))]
NO_PRODUCT = [(LOOP, LOOP.replace("ks * 8 < tl", "ks * 8 < tl && tl < 0"))]
VARIANTS = {
    "kernel": [],
    "no_gather": NO_GATHER,
    "no_product": NO_PRODUCT,
    "neither": NO_GATHER + NO_PRODUCT,
    "setup_only": [(STAGES, STAGES.replace("i < ntiles", "i < 0"))],
    "one_tf32": [(THREE, "            mma_tf32_first(step, ab, bb);")],
    "l1_copies": [(L2ONLY, L2ONLY.replace(".cg.", ".ca."))],
}
# (d, rows, padded length, fixed-side rows, item axis, power-law ids): the
# ML-20M dense batch shape of both halves at d = 40, the widest d the
# kernel takes, and the user half again with item ids drawn from the
# ML-20M synthetic's power-law popularity (chip_smoke.synth_ml20m) instead
# of uniformly, so that popular rows repeat as they do in training
CASES = [(40, 1128, 944, 26_744, False, False),
         (40, 1128, 944, 138_493, True, False),
         (128, 512, 944, 26_744, True, False),
         (40, 1128, 944, 26_744, False, True)]


def build(out):
    """Compile every variant in parallel; name -> C launch function."""
    with open(os.path.join(_build._CSRC, f"{NAME}.cu")) as fh:
        base = fh.read()
    procs = {}
    for name, edits in VARIANTS.items():
        src = base
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"{name}: source text not found: {old!r}")
            src = src.replace(old, new)
        path = os.path.join(out, f"{name}.cu")
        with open(path, "w") as fh:
            fh.write(src)
        lib = os.path.join(out, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build._CSRC, "-o", lib,
             path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        fn = getattr(ctypes.CDLL(lib), NAME)
        fn.argtypes = K._SIGNATURES[NAME]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k2_breakdown: needs an NVIDIA card")
    out = os.path.join(ROOT, "build", "k2_breakdown")
    os.makedirs(out, exist_ok=True)
    fns = build(out)
    dev = torch.device("cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    rng = np.random.default_rng(0)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    for d, B, L, m, item_axis, zipf in CASES:
        def tensor(a, dtype=torch.float32):
            return torch.tensor(a, dtype=dtype, device=dev)

        table = tensor(np.abs(rng.normal(size=(B, d))) / d)
        Bf = tensor(np.abs(rng.normal(size=(m, d))) / d)
        FF = Bf.T @ Bf
        lens = rng.integers(int(0.8 * L), L + 1, size=B)
        mask = np.arange(L)[None, :] < lens[:, None]
        lens = tensor(lens, torch.int32)
        if zipf:
            cum = np.cumsum(1.0 / np.arange(1, m + 1) ** 0.9)
            ids = np.minimum(np.searchsorted(cum / cum[-1],
                                             rng.random((B, L))), m - 1)
        else:
            ids = rng.integers(0, m, (B, L))
        cols = tensor(np.where(mask, ids, 0), torch.int32)
        vals = tensor(np.where(mask, 1.0 + rng.integers(0, 5, (B, L)), 0.0))
        outs = [torch.empty(B, d, d, device=dev), torch.empty(B, d, device=dev),
                torch.empty(B, device=dev), torch.empty(B, device=dev)]
        ptr = [ctypes.c_void_p(t.data_ptr()) for t in
               (table, Bf, FF, lens, cols, vals, *outs)]

        def launch(fn):
            rc = fn(*ptr[:4], None, 0, None, None, ptr[4], ptr[5], 0, L, 0, None,
                    None, None, None, *ptr[6:], B, B, d, 8.0, 0.1, 0,
                    int(item_axis), float(m), 1, stream)
            if rc:
                raise SystemExit(f"launch failed: {rc}")

        ms = {}
        for name, fn in fns.items():
            for _ in range(3):
                launch(fn)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                launch(fn)
            end.record()
            torch.cuda.synchronize()
            ms[name] = start.elapsed_time(end) / 20
        print(json.dumps({"d": d, "rows": B, "L": L, "fixed_rows": m,
                          "item_axis": item_axis, "power_law_ids": zipf,
                          "entries": int(lens.sum()), "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
