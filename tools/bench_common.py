"""What the fresh-process kernel benches (``tools/k9_k22_bench.py``,
``tools/k13_k21_bench.py``) share: another checkout's package in place of
this one's (``--tree``), ``chip_smoke.py``'s measuring helpers, one JSON
line per case, and kernels rebuilt with one part changed (``VARIANTS``
tables: tag -> (source in ``csrc/``, [C launch functions swapped in],
[(old, new)] edits that match the source's text exactly and fail loudly
when it changes)).

A bench's ``main`` runs ``args = parse(ap)``, ``cs, out = start(args,
name)``, its cases, then ``finish(out, name, args.tag)``: the lines go to
stdout and, all of them, to ``chiprun_out/<name>_<tag>.json``.
"""
from __future__ import annotations

import contextlib
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(ap):
    """``ap``'s arguments, with ``--tree`` (another checkout's root, whose
    ``buffalo_tpu_torch`` is imported in place of this one's) and
    ``--tag`` added; the tree goes first on ``sys.path``."""
    ap.add_argument("--tree", default=None, help="another checkout's root")
    ap.add_argument("--tag", default="current")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree) if args.tree else ROOT)
    return args


def start(args, name):
    """(this tree's ``chip_smoke`` module, the output lines begun with the
    tree, tag and card); exits without a card."""
    import torch

    if not torch.cuda.is_available():
        sys.exit(f"{name}.py needs a card")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import buffalo_tpu_torch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = []
    emit(out, tree=args.tree or ".", tag=args.tag, card=card.strip(),
         package=os.path.dirname(buffalo_tpu_torch.__file__))
    return cs, out


def emit(out, **line):
    out.append(line)
    print(json.dumps(line), flush=True)


def finish(out, name, tag):
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"{name}_{tag}.json"),
              "w") as fh:
        json.dump(out, fh, indent=1)


def by_kernel(cs, torch, fn, calls=5, top=16):
    """Device milliseconds per call of ``fn`` by kernel name (CUPTI)."""
    prof = cs.profile_call(torch, lambda: [fn() for _ in range(calls)],
                           top=top)
    return {k: v / calls for k, v in prof["device_ms_by_name"].items()}


def build_variants(variants, out_dir):
    """{tag: the library built with that variant's edits}, the nvcc runs
    in parallel."""
    from buffalo_tpu_torch.ops import _build

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for tag, (src_name, _, edits) in variants.items():
        with open(os.path.join(_build._CSRC, src_name)) as fh:
            src = fh.read()
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"{tag}: source text not found: {old!r}")
            src = src.replace(old, new)
        path = os.path.join(out_dir, f"{tag}.cu")
        with open(path, "w") as fh:
            fh.write(src)
        lib = os.path.join(out_dir, f"lib{tag}.so")
        procs[tag] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build._CSRC, "-o",
             lib, path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for tag, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {tag}:\n{log}")
        libs[tag] = ctypes.CDLL(lib)
    return libs


@contextlib.contextmanager
def swapped(lib, names):
    """The wrappers' C launch functions ``names`` taken from ``lib`` (with
    the built ones' signatures, so each must have been loaded once) inside
    the block."""
    from buffalo_tpu_torch.ops import _build

    real = {n: _build._launchers[n] for n in names}
    for n in names:
        fn = getattr(lib, n)
        fn.argtypes, fn.restype = real[n].argtypes, real[n].restype
        _build._launchers[n] = fn
    try:
        yield
    finally:
        _build._launchers.update(real)
