"""K1 and K3 on ``chip_smoke.py``'s batches: block sizes, parts switched
off, an older version beside the current one, and which batch of an epoch
puts the kernels furthest from the plain path.

    python3 tools/cg_bench.py [--baseline DIR]             # with a card
    python3 tools/cg_bench.py --parity [--baseline DIR]

Every kernel build is launched through the wrappers of
``ops/als_kernels.py``, their C launch function swapped for the build's.
``--baseline DIR`` adds the kernels built from ``DIR``'s
``als_cg_matrix_free.cu``, ``batched_cg_dense.cu`` and ``als_common.cuh``
(an older ``buffalo_tpu_torch/csrc``, e.g. a commit's unpacked with
``git archive``).

Timing (the default) takes ``chip_smoke.py``'s ML-20M layout (d = 40,
random factors) and its kernel lines' batches (K1: the largest
matrix-free batch and the short one with the most rows; K3: the systems
of the dense batch nearest L = 1024), and times by device time alone
(CUPTI through torch.profiler, median of 20-22 launches,
``chip_smoke.device_ms``):

* the kernels as they are, and rebuilt with another number of warps per
  block (their ``kWarps``; one row or system per warp);
* K1 with 0 .. cg_iters - 1 CG steps (the cost of a step), and K1 rebuilt
  with one part changed (``VARIANTS``: F in shared memory instead of
  registers; the gather's copies zero-filled instead of read; every copy
  from Bf's first row; no gather after the first row; no solve; 16-byte
  copies that bypass L1);
* the baseline kernels before and after the current ones (baseline,
  current, current, baseline).

Builds that compute the same function (``SAME``) and the baseline are held
to the current kernel's rows first (TOL_X).  One JSON line per batch.

``--parity`` takes ``chip_smoke.py``'s plain-path configuration (20,000 x
5,000, 2M interactions) after one kernel epoch and prints the next
epoch's ``chip_smoke.py`` check through the kernels (and the baseline
K1 and K3), then, for each batch of the user half, each kernel build's and
the plain float32 version's largest distance from the plain float64 rows,
and the current kernel's largest difference from the plain float32 rows.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from buffalo_tpu_torch.data.batching import (RangeBatch,  # noqa: E402
                                             stage_batch)
from buffalo_tpu_torch.ops import _build  # noqa: E402
from buffalo_tpu_torch.ops import als_kernels as K  # noqa: E402

K1, K3 = "als_cg_matrix_free", "batched_cg_dense"


def warps(name, now, new):
    return [(f"{name}.cu", f"constexpr int kWarps = {now};",
             f"constexpr int kWarps = {new};")]


# (kernel, tag) -> [(file, old, new)]: a kernel rebuilt with edits that
# match the text of csrc/ exactly (and fail loudly when it changes)
VARIANTS = {
    **{(K1, f"warps_{w}"): warps(K1, 4, w) for w in (1, 2, 8)},
    **{(K3, f"warps_{w}"): warps(K3, 2, w) for w in (1, 4, 8)},
    (K1, "f_in_shared"): [("als_cg_matrix_free.cu",
                           "constexpr int kRegFloats = 120;",
                           "constexpr int kRegFloats = 0;")],
    (K1, "no_gather"): [("als_cg_matrix_free.cu",
                         "const bool full = col >= 0 && 4 * q < d;",
                         "const bool full = false;")],
    (K1, "one_row"): [("als_cg_matrix_free.cu",
                       "p.Bf + (full ? (int64_t)col * d + 4 * q : 0)",
                       "p.Bf + (full ? 4 * q : 0)")],
    (K1, "no_copies"): [("als_cg_matrix_free.cu",
                         "if (next < p.B) gather(c2);  // lands",
                         "if (next < 0) gather(c2);  // lands")],
    (K1, "no_solve"): [("als_cg_matrix_free.cu", "    if (n > 0) {",
                        "    if (n < 0) {")],
    (K1, "l2_copies"): [("als_common.cuh",
                         "cp.async.ca.shared.global [%0], [%1], 16, %2;",
                         "cp.async.cg.shared.global [%0], [%1], 16, %2;")],
}
SAME = {"warps_1", "warps_2", "warps_4", "warps_8", "f_in_shared",
        "l2_copies"}


def build(variants, baseline, out):
    """Compile the variants' sources and the baseline's K1 and K3 in
    parallel; {tag: {kernel: C launch function}}."""
    jobs = {}
    for (name, tag), edits in variants.items():
        vdir = os.path.join(out, f"{name}_{tag}")
        os.makedirs(vdir, exist_ok=True)
        for fname in (f"{name}.cu", "als_common.cuh"):
            with open(os.path.join(_build._CSRC, fname)) as fh:
                src = fh.read()
            for where, old, new in edits:
                if where == fname:
                    if old not in src:
                        raise SystemExit(f"{tag}: source text not found: "
                                         f"{old!r}")
                    src = src.replace(old, new)
            with open(os.path.join(vdir, fname), "w") as fh:
                fh.write(src)
        jobs[(tag, name)] = (os.path.join(vdir, f"{name}.cu"), vdir)
    if baseline:
        for name in (K1, K3):
            jobs[("baseline", name)] = (os.path.join(baseline, f"{name}.cu"),
                                        baseline)
    procs = {}
    for (tag, name), (src, inc) in jobs.items():
        lib = os.path.join(out, f"lib{name}_{tag}.so")
        procs[(tag, name)] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", inc, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for (tag, name), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name} {tag}:\n{log}")
        fn = getattr(ctypes.CDLL(lib), name)
        fn.argtypes = K._SIGNATURES[name]
        fn.restype = ctypes.c_int
        fns.setdefault(tag, {})[name] = fn
    return fns


@contextlib.contextmanager
def launchers(fns):
    """Inside the block the wrappers launch ``fns`` ({kernel: C launch
    function}) instead of the current build's."""
    old = {name: K._kernel(name) for name in fns}
    _build._launchers.update(fns)
    try:
        yield
    finally:
        _build._launchers.update(old)


def timing(built, dev):
    groups, _ = cs.synth_ml20m(cs.ML20M_USERS, cs.ML20M_ITEMS, cs.ML20M_NNZ)
    row_b, col_b, P, Q = cs.range_layout(cs.ArrayData(groups),
                                         cs.ML20M_USERS, cs.ML20M_ITEMS, 7)
    P, Q = torch.from_numpy(P).to(dev), torch.from_numpy(Q).to(dev)
    halves = {"rowwise": (P, Q, row_b, False, cs.ML20M_ITEMS),
              "colwise": (Q, P, col_b, True, cs.ML20M_USERS)}
    picked = cs.pick_batches(row_b, col_b)
    cg = dict(cg_iters=cs.CG_ITERS, cg_tol=cs.CG_TOL)

    for name, kind in ((K1, "largest"), (K1, "short"), (K3, "dense")):
        half, i = picked[kind]
        table, Bf, batches, item_axis, n_fixed = halves[half]
        sb = stage_batch(batches[i], dev)
        FF = Bf.T @ Bf
        B, L = sb.cols.shape
        kw = dict(alpha=cs.ALPHA, reg=cs.REG, adaptive_reg=False,
                  item_axis=item_axis, num_fixed_rows=n_fixed)
        scratch = table.clone()
        if name == K1:
            def call(**over):
                K.als_cg_matrix_free(scratch, Bf, FF, sb.row_start, sb.lens,
                                     sb.cols, sb.vals, compute_loss=True,
                                     **kw, **dict(cg, **over))
            shape = dict(B=B, L=L, entries=int(sb.lens.sum()))
        else:
            A, y, _, _ = K.als_normal_equations_plain(
                table, Bf, FF, sb.lens, sb.cols, sb.vals,
                row_start=sb.row_start, compute_loss=False, **kw)

            def call(**over):
                K.batched_cg_dense(A, y, scratch, sb.lens,
                                   row_start=sb.row_start,
                                   **dict(cg, **over))
            shape = dict(systems=B, L=L)

        def result():
            scratch.copy_(table)
            call()
            return scratch[sb.row_start:sb.row_start + B].clone()

        def timed(tag, fns):
            with launchers(fns):
                if tag in SAME or tag.startswith("baseline"):
                    diff = cs.rel_err(result(), ref)[1]
                    if diff > cs.TOL_X:
                        raise SystemExit(f"{name} {tag} differs: {diff:.3g}")
                return cs.device_ms(call, name)

        ref = result()
        ms = {}
        if "baseline" in built:
            ms["baseline_first"] = timed("baseline", built["baseline"])
        ms["current"] = cs.device_ms(call, name)
        for tag, fns in built.items():
            if tag != "baseline" and name in fns:
                ms[tag] = timed(tag, {name: fns[name]})
        if name == K1:  # the cost of a CG step
            for it in range(cs.CG_ITERS):
                ms[f"cg_iters_{it}"] = cs.device_ms(
                    lambda: call(cg_iters=it), name)
        if "baseline" in built:
            ms["baseline_last"] = timed("baseline_last", built["baseline"])
        print(json.dumps({"kernel": name, "batch": kind, "half": half,
                          **shape, "device_ms": ms}), flush=True)


def parity(built, dev):
    pp = cs.PlainPath(torch, K, dev)
    builds = {"kernel": {}, **built}
    for tag, fns in builds.items():
        with launchers(fns):
            ok, fields = pp.readings(*pp.kernel_epoch()[0])
        print(json.dumps({"epoch": tag, "passes": ok, **fields}), flush=True)
    FF = K.gramian(pp.Q1)
    common = dict(optimizer="manual_cg", alpha=cs.ALPHA, reg=cs.REG,
                  adaptive_reg=False, cg_iters=cs.CG_ITERS, cg_tol=cs.CG_TOL,
                  compute_loss=True, item_axis=False,
                  num_fixed_rows=cs.SMALL_ITEMS)
    for on_card, on_cpu in zip(K._flat(pp.cuda_b[0]), K._flat(pp.cpu_b[0])):
        out = {}
        for tag, fns in builds.items():
            A = pp.P1.clone()
            with launchers(fns):
                K._apply_batch(A, pp.Q1, FF, on_card, **common)
            out[tag] = A.double().cpu()
        for tag, dt in (("plain32", torch.float32), ("plain64", torch.float64)):
            A = pp.P1.to("cpu", dt, copy=True)
            K._apply_batch(A, pp.Q1.cpu().to(dt), FF.cpu().to(dt), on_cpu,
                           **common)
            out[tag] = A.double()
        diff = (out["kernel"] - out["plain32"]).abs().max(dim=1).values
        print(json.dumps(dict(
            kind="range" if isinstance(on_card, RangeBatch) else "segment",
            L=on_card.cols.shape[1], rows=int(on_card.lens.shape[0]),
            max_err=float(diff.max()), worst_row=int(diff.argmax()),
            scale=float(out["plain64"].abs().max()),
            **{f"{tag}_vs_f64": float((out[tag] - out["plain64"]).abs().max())
               for tag in out if tag != "plain64"})), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", help="directory of older K1/K3 sources")
    ap.add_argument("--parity", action="store_true",
                    help="per-batch parity of the plain-path epoch")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("cg_bench: needs an NVIDIA card")
    dev = torch.device("cuda")
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    out = os.path.join(ROOT, "build", "cg_bench")
    os.makedirs(out, exist_ok=True)
    built = build({} if args.parity else VARIANTS,
                  args.baseline and os.path.abspath(args.baseline), out)
    (parity if args.parity else timing)(built, dev)


if __name__ == "__main__":
    main()
