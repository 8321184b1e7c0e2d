"""K15 (pLSI's E-step) and K7 (the k-means cell update) at
``chip_smoke.py``'s shapes, on one card: event and CUPTI milliseconds per
call beside the bounds, K15's busy milliseconds per pLSI epoch by batch
class, and K7's device time by launch.

    python3 tools/k15_k7_bench.py [--tree DIR] [--tag NAME] [--skip-k15]
        [--skip-k7] [--widths D ...] [--variants parent|change]

``--tree DIR`` runs the kernels of another checkout of the repository
(e.g. a parent commit unpacked with ``git archive`` into a git-ignored
directory): its ``buffalo_tpu_torch`` is imported in place of this one's,
so two trees are compared by running the script once per tree in one
chip call (parent, change, change, parent).  The measuring helpers are
this tree's ``chip_smoke.py``.

K15: the ML-20M synthetic (``chip_smoke.synth_ml20m``, written once into
``build/k13_k21_bench/`` and shared with ``tools/k13_k21_bench.py``),
pLSI at the defaults (d = 20) trained K15_BENCH_EPOCHS epochs in the range
layout (its tables kept in ``build/k15_k7_bench/plsi.npz`` for the later
runs of a call, so every tree reads the same rows).  Four batches
(``K15_CASES``): the user half's largest range batch, the item half's
range batch with the most rows of fewer than 32 entries (the user half's
where the item half has none, as on this synthetic), the item half's
largest segment batch, and the rowwise padded batch (the fallback path)
with the most entries; each with its distance from the plain version,
repeatable, event and CUPTI ms and the bound (``chip_smoke.k15_work``).
Then one range epoch by events and by kernel (CUPTI), and every K15 call
of it replayed alone, summed by half and by batch class (range batches
of width < 32, 32-255 and >= 256, segment batches): calls, entries,
event and CUPTI ms, entries per second, bound.  ``--widths D ...`` runs
the four batches again at each width on random stochastic tables (the
same entries).

K7: three Lloyd updates, each the second of its build (the unit rows'
assignment to the centroids one update from IVFIndex.build's seed-0
start, K5 at k = 1): the brunch catalog (``catalog_path``'s 505,840 x 100
rows, MIPS-augmented to 101, 711 cells), ML-20M's item count at
``retrieval_path``'s width and cells (26,744 random rows of 40 floats,
augmented to 41, 163 cells), and ``wide_rows``' index (120,000 x 300,
augmented to 301, 60,000 cells: the global-counter form).  Each: the
distance from the plain version, repeatable, event and CUPTI ms, CUPTI ms
by launch, the plain version's and the library call's ms, the bound.

``--variants parent`` times the parent's kernels (run with ``--tree``)
as they are and rebuilt with one part changed (``PARENT_VARIANTS``): K15
(a) the lanes-on-entries walk reading each row as float4s, (b) a query of
the registers and resident warps of ``rows_kernel<24, true, false>``
(occupancy API: theoretical, not achieved); K7 (a) ``cell_histogram``
counting from ``assign`` alone (its norm test dropped; timing only).
``--variants change`` times this tree's kernels with their shape rules'
constants patched (``PATCH_VARIANTS``: K15 in the team form only, in one
lane an entry only from width 256, lanes on the columns past 32 floats,
long rows whole or in other pieces; K7 at runs of 64) and
rebuilt with one constant changed (``CHANGE_VARIANTS``: K15 with more
entries in flight), K15's with the range epoch's calls replayed by
class.

One JSON line per case on stdout, all of them in the file that
``tools/bench_common.py``'s ``finish`` writes (``k15_k7_bench_<tag>.json``).
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import os
import time

import numpy as np
from bench_common import (ROOT, build_variants, by_kernel, emit, finish,
                          parse, start, swapped)

WORK = os.path.join(ROOT, "build", "k15_k7_bench")
DEVICE = "cuda"
K15_BENCH_EPOCHS = 2
K15_CASES = ("user_range_largest", "range_short", "item_segment",
             "padded_largest")
SHORT_ROW = 32
# the K7 updates: name -> (rows, width before the augmentation, cells,
# numpy seed of the rows)
K7_CASES = {"brunch": (505_840, 100, 711, 21),
            "ml20m": (26_744, 40, 163, 5),
            "wide_cells": (120_000, 300, 60_000, 31)}


# ------------------------------------------------------------------ K15
def plsi_setup(cs, bt, torch):
    """(the pLSI d = 20 model trained K15_BENCH_EPOCHS epochs, its range
    layout state, the permuted P and Q on the card)."""
    import k13_k21_bench

    os.makedirs(k13_k21_bench.WORK, exist_ok=True)
    data = k13_k21_bench.ml20m_data(cs)
    model = cs.plsi_model(bt, data, cs.plsi_opt(
        bt, num_iters=K15_BENCH_EPOCHS, validation={}))
    path = os.path.join(WORK, "plsi.npz")
    if os.path.isfile(path):
        z = np.load(path)
        model.P, model.Q = z["P"], z["Q"]
    else:
        model.train()
        np.savez(path, P=model.P, Q=model.Q)
    st, P, Q = cs.plsi_inputs(torch, model)
    return model, st, P, Q


def k15_picks(torch, model, st):
    """name -> (batch, half, padded) of K15_CASES."""
    from buffalo_tpu_torch.data.batching import (PaddedBatch, RangeBatch,
                                                 StagedSegmentBatch)
    from buffalo_tpu_torch.ops.als_kernels import _flat

    rows = list(_flat(st["row_groups"]))
    cols = list(_flat(st["col_groups"]))
    ranges_u = [b for b in rows if isinstance(b, RangeBatch)]
    ranges_i = [b for b in cols if isinstance(b, RangeBatch)]
    segs_i = [b for b in cols if isinstance(b, StagedSegmentBatch)]
    padded = [b for b in model._rowwise_batcher().device_batches()
              if isinstance(b, PaddedBatch)]
    def short(b):
        return int(((b.lens > 0) & (b.lens < SHORT_ROW)).sum())
    # the range batch with the most rows of fewer than SHORT_ROW entries:
    # the item half's, or the user half's where the item half has none
    halves = [("item", ranges_i), ("user", ranges_u)]
    half, batches = next((h, bs) for h, bs in halves
                         if max(map(short, bs)) > 0 or h == "user")
    return {
        "user_range_largest": (max(ranges_u, key=lambda b: int(
            b.lens.sum())), "user", False),
        "range_short": (max(batches, key=short), half, False),
        "item_segment": (max(segs_i, key=lambda b: int(
            b.chunk_lens.sum())), "item", False),
        "padded_largest": (max(padded, key=lambda b: int(b.lens.sum())),
                           "rowwise", True),
    }


def entries_of(b):
    from buffalo_tpu_torch.data.batching import StagedSegmentBatch

    return int((b.chunk_lens if isinstance(b, StagedSegmentBatch)
                else b.lens).sum())


def k15_main(b):
    """The launch that comes once per K15 call of this batch's mode."""
    from buffalo_tpu_torch.data.batching import StagedSegmentBatch

    return "chunk_rows" if isinstance(b, StagedSegmentBatch) else \
        "rows_kernel"


def k15_call(PK, torch, A, Bf, b, padded):
    """(the K15 call on a fresh accumulator, the plain version's result,
    the accumulators)."""
    from buffalo_tpu_torch.data.batching import RangeBatch

    An = torch.zeros_like(A)
    Qn = torch.zeros_like(Bf) if padded else None
    kw = dict(padded=True, Qn=Qn) if padded else {}

    def fn():
        return PK.plsi_estep(An, A, Bf, b, **kw)

    def plain():
        Ar, Qr = torch.zeros_like(A), torch.zeros_like(Bf)
        if padded:
            loss = PK.estep_padded_plain(Ar, Qr, A, Bf, b)
        elif isinstance(b, RangeBatch):
            loss = PK.estep_range_plain(Ar, A, Bf, int(b.row_start), b.lens,
                                        b.cols, b.vals)
        else:
            loss = PK.estep_segment_plain(Ar, A, Bf, b)
        return [Ar] + ([Qr] if padded else []), loss
    return fn, plain


def k15_one(cs, PK, torch, out, name, A, Bf, b, padded, d, **extra):
    fn, plain = k15_call(PK, torch, A, Bf, b, padded)
    runs = []
    for _ in range(2):
        An, Qn = torch.zeros_like(A), torch.zeros_like(Bf)
        kw = dict(padded=True, Qn=Qn) if padded else {}
        loss = PK.plsi_estep(An, A, Bf, b, **kw)
        runs.append(([An] + ([Qn] if padded else []), loss))
    ref, ref_loss = plain()
    torch.cuda.synchronize()
    err = max(cs.rel_err(g, r)[1] for g, r in zip(runs[0][0], ref))
    loss_err = float((runs[0][1].double().sum() - ref_loss.double().sum())
                     .abs() / ref_loss.double().sum().abs())
    same = all(torch.equal(x, y) for x, y in zip(runs[0][0], runs[1][0])) \
        and torch.equal(runs[0][1], runs[1][1])
    bms, by = cs.bound_ms(*cs.k15_work(torch, b, d, padded))
    main = k15_main(b)
    emit(out, kernel="K15", case=name, d=d, shape=list(b.cols.shape),
         entries=entries_of(b),
         short_rows=int(((b.lens > 0) & (b.lens < SHORT_ROW)).sum())
         if hasattr(b, "lens") else None, rel_err=err, loss_rel_err=loss_err,
         repeatable=same,
         ms=cs.time_ms(fn), device_ms=cs.trace_ms(fn, main),
         by_kernel_ms=by_kernel(cs, torch, fn, top=8), bound_ms=bms,
         bound_by=by, **extra)


def k15_tables(torch, shape_p, shape_q, d, dev, seed):
    """Random row-stochastic P and column-stochastic Q of width d."""
    rng = np.random.default_rng(seed)
    P = np.abs(rng.normal(size=(shape_p, d)))
    Q = np.abs(rng.normal(size=(shape_q, d)))
    P /= P.sum(1, keepdims=True)
    Q /= Q.sum(0, keepdims=True)
    return (torch.tensor(P, dtype=torch.float32, device=dev),
            torch.tensor(Q, dtype=torch.float32, device=dev))


def k15_cases(cs, bt, PK, torch, out, widths=None, variants=False):
    model, st, P, Q = plsi_setup(cs, bt, torch)
    dev = P.device
    Pu = torch.from_numpy(model.P).to(dev)
    Qu = torch.from_numpy(model.Q).to(dev)
    picks = k15_picks(torch, model, st)

    def tables(half, P, Q, Pu, Qu):
        return {"user": (P, Q), "item": (Q, P), "rowwise": (Pu, Qu)}[half]

    calls = {}
    for name in K15_CASES:
        b, half, padded = picks[name]
        A, Bf = tables(half, P, Q, Pu, Qu)
        if variants:
            calls[name] = k15_call(PK, torch, A, Bf, b, padded)[0]
        else:
            k15_one(cs, PK, torch, out, name, A, Bf, b, padded, P.shape[1])
    if variants:
        return calls
    k15_epoch(cs, PK, torch, out, model, st, P, Q)
    for d in widths or ():
        tp = k15_tables(torch, P.shape[0], Q.shape[0], d, dev, d)
        tu = k15_tables(torch, Pu.shape[0], Qu.shape[0], d, dev, d + 1)
        for name in K15_CASES:
            b, half, padded = picks[name]
            A, Bf = tables(half, *tp, *tu)
            k15_one(cs, PK, torch, out, name, A, Bf, b, padded, d,
                    tables="random")
        del tp, tu
        torch.cuda.empty_cache()
    return calls


def batch_class(b):
    from buffalo_tpu_torch.data.batching import StagedSegmentBatch

    if isinstance(b, StagedSegmentBatch):
        return "segment"
    L = b.cols.shape[1]
    return "range_lt32" if L < 32 else ("range_32_255" if L < 256 else
                                        "range_ge256")


def k15_epoch(cs, PK, torch, out, model, st, P, Q):
    """One range epoch by events and by kernel, then every K15 call of it
    replayed alone, summed by half and batch class."""
    o = model.opt
    kw = dict(alpha1=float(o.alpha1), alpha2=float(o.alpha2),
              num_items=cs.ML20M_ITEMS)

    def epoch():
        return float(PK.plsi_epoch_range(
            P, Q, st["row_groups"], st["col_groups"], st["p_mask"],
            st["q_mask"], **kw)[2])

    prof = cs.profile_call(torch, epoch, top=12)
    emit(out, kernel="K15", epoch_ms=cs.time_ms(epoch, reps=5, warmup=1),
         epoch_profile=prof)
    emit(out, kernel="K15", per_epoch=k15_replay(cs, PK, torch, model, st,
                                                  P, Q))


def k15_replay(cs, PK, torch, model, st, P, Q):
    """Every K15 call of a range epoch replayed alone: calls, entries,
    event and CUPTI ms, bound, entries per second, by half and batch
    class."""
    from buffalo_tpu_torch.ops.als_kernels import _flat

    d = P.shape[1]
    sums = {}
    for half, groups, A, Bf in (("user", st["row_groups"], P, Q),
                                ("item", st["col_groups"], Q, P)):
        for b in _flat(groups):
            An = torch.zeros_like(A)

            def fn(An=An, A=A, Bf=Bf, b=b):
                PK.plsi_estep(An, A, Bf, b, with_loss=half == "user")
            ms = cs.time_ms(fn, reps=5, warmup=1)
            dms = cs.trace_ms(fn, k15_main(b), reps=6, warmup=1)
            bms = cs.bound_ms(*cs.k15_work(torch, b, d, False))[0]
            n = entries_of(b)
            for key in (f"{half}_{batch_class(b)}", half, "epoch"):
                s = sums.setdefault(key, dict(calls=0, entries=0, ms=0.0,
                                              device_ms=0.0, bound_ms=0.0))
                s["calls"] += 1
                s["entries"] += n
                s["ms"] += ms
                s["device_ms"] += dms if dms is not None else float("nan")
                s["bound_ms"] += bms
            del An
    for s in sums.values():
        s["entries_per_s"] = s["entries"] / (s["device_ms"] / 1e3)
    return sums


# ------------------------------------------------------------------- K7
def k7_inputs(cs, R, torch, name):
    """(unit rows, their cells after one update, the centroids of that
    update) of K7_CASES[name] on the card."""
    N, d, C, seed = K7_CASES[name]
    rng = np.random.default_rng(seed)
    if name == "brunch":
        table = cs.brunch_tables(rng, N, d, 1)[0]
    else:
        table = rng.standard_normal((N, d), dtype=np.float32)
    dev = torch.device(DEVICE)
    unit = torch.from_numpy(np.ascontiguousarray(cs.ivf_unit(table))).to(dev)
    pick = np.random.default_rng(0).choice(N, C, replace=False)
    cent = unit[torch.from_numpy(pick).to(dev)]

    def assign(cent):
        return torch.cat([R.score_topk(unit[c:c + (1 << 16)], cent, 1)[1]
                          for c in range(0, N, 1 << 16)])
    cent = R.kmeans_update(unit, assign(cent), cent)
    return unit, assign(cent), cent


def k7_cases(cs, R, torch, out, variants=False):
    calls = {}
    for name in K7_CASES:
        unit, assign, cent = k7_inputs(cs, R, torch, name)

        def fn(unit=unit, assign=assign, cent=cent):
            return R.kmeans_update(unit, assign, cent)
        if variants:
            calls[name] = fn
            continue
        got, again = fn(), fn()
        ref = R.kmeans_update_plain(unit, assign, cent)
        torch.cuda.synchronize()
        a = assign.reshape(-1).long()

        def lib():
            torch.zeros_like(cent).index_add_(0, a, unit)
            torch.bincount(a, minlength=cent.shape[0])
        (N, D), C = unit.shape, cent.shape[0]
        bms, by = cs.bound_ms(*cs.k7_work(N, D, C))
        emit(out, kernel="K7", case=name, N=N, D=D, cells=C,
             empty_cells=int((torch.bincount(a, minlength=C) == 0).sum()),
             max_abs_err=float((got - ref).abs().max()),
             repeatable=bool(torch.equal(got, again)),
             ms=cs.time_ms(fn, reps=10, warmup=2),
             device_ms=cs.trace_ms(fn, "cell_histogram"),
             by_launch_ms=by_kernel(cs, torch, fn, top=10),
             plain_ms=cs.time_ms(lambda: R.kmeans_update_plain(
                 unit, assign, cent), reps=5, warmup=1),
             library_ms=cs.time_ms(lib, reps=5, warmup=1), bound_ms=bms,
             bound_by=by)
        del unit, assign, cent, got, again, ref
        torch.cuda.empty_cache()
    return calls


# ------------------------------------------------------------- variants
# tag -> (source, [launch functions swapped in], [(old, new)]): the
# parent's K15 and K7 rebuilt with edits that match their text exactly
K15_V = ("plsi_estep.cu", ["plsi_estep", "plsi_estep_workspace"])
K7_V = ("kmeans_update.cu", ["kmeans_update"])
_K15_A = [(
    "                                         float (&v)[W]) {\n"
    "#pragma unroll\n  for (int h = 0; h < W; ++h) {",
    "                                         float (&v)[W]) {\n"
    "  if constexpr (kEntries) {\n    if ((d & 3) == 0) {\n"
    "#pragma unroll\n      for (int h = 0; h < W; h += 4) {\n"
    "        if (h < d) {\n"
    "          const float4 x = __ldg(reinterpret_cast<const float4*>"
    "(t + h));\n"
    "          v[h] = x.x; v[h + 1] = x.y; v[h + 2] = x.z; v[h + 3] = x.w;\n"
    "        } else {\n"
    "          v[h] = v[h + 1] = v[h + 2] = v[h + 3] = 0.f;\n        }\n"
    "      }\n      return;\n    }\n  }\n"
    "#pragma unroll\n  for (int h = 0; h < W; ++h) {")]
_WIDE_Q = ("extern \"C\" int plsi_estep_wide(int d) "
           "{ return d > 32 * kMaxH ? 1 : 0; }")
_K15_B = [(
    _WIDE_Q,
    _WIDE_Q + "\n\nextern \"C\" int plsi_estep_occupancy(int* out) {\n"
    "  cudaFuncAttributes at;\n"
    "  cudaError_t e = cudaFuncGetAttributes(&at, rows_kernel<24, true, "
    "false>);\n  if (e != cudaSuccess) return (int)e;\n  int blocks = 0;\n"
    "  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, "
    "rows_kernel<24, true, false>, kThreads, 0);\n"
    "  out[0] = at.numRegs;\n  out[1] = blocks * kWarps;\n"
    "  out[2] = (int)at.localSizeBytes;\n  return (int)e;\n}")]
_K7_A = [(
    "    const float* row = unit + (int64_t)r * D;\n    float ss = 0.f;\n"
    "    for (int j = lane; j < D; j += 32) ss = fmaf(row[j], row[j], ss);\n"
    "    const bool in = warp_sum(ss) > 0.f;",
    "    const bool in = true;")]
PARENT_VARIANTS = {
    "k15_as_is": (*K15_V, []), "k15_a_ldg128": (*K15_V, _K15_A),
    "k15_b_occupancy": (*K15_V, _K15_B),
    "k7_as_is": (*K7_V, []), "k7_a_assign_only": (*K7_V, _K7_A),
}
# this tree's K15 and K7 rebuilt with one constant changed
CHANGE_VARIANTS = {
    "k15_as_is": (*K15_V, []),
    "k15_unroll_32_floats": (*K15_V, [("constexpr int kUnrollFloats = 16;",
                                       "constexpr int kUnrollFloats = 32;")]),
    "k7_as_is": (*K7_V, []),
}
# this tree's K15 and K7 with the shape rules' constants patched (module,
# {name: value}): every range batch in the team form, or in one lane an
# entry only from width 256; rows of 33-128 floats on the columns; no pieces, pieces of 128 or 512 entries, pieces from width 257;
# K7's runs of 64 and 32 members
PATCH_VARIANTS = {
    "k15_team_only": ("PK", {"ENTRIES_MIN_L": 1 << 30}),
    "k15_entries_from_256": ("PK", {"ENTRIES_MIN_L": 256}),
    "k15_columns_past_32": ("PK", {"TEAM_MAX_D": 32,
                                   "SEGMENT_TEAM_MAX_D": 32}),
    "k15_no_pieces": ("PK", {"PIECE_MIN_L": 1 << 30}),
    "k15_pieces_128": ("PK", {"ROW_PIECE": 128}),
    "k15_pieces_512": ("PK", {"ROW_PIECE": 512}),
    "k15_pieces_past_256": ("PK", {"PIECE_MIN_L": 256}),
    "k7_run_64": ("R", {"_K7_RUN": 64}),
    "k7_run_32": ("R", {"_K7_RUN": 32}),
}


@contextlib.contextmanager
def patched(module, values):
    """``module``'s attributes set to ``values`` inside the block."""
    real = {k: getattr(module, k) for k in values}
    for k, v in values.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in real.items():
            setattr(module, k, v)


def time_variants(cs, bt, PK, R, torch, out, which, widths, skip_k15=False):
    table = PARENT_VARIANTS if which == "parent" else CHANGE_VARIANTS
    if skip_k15:
        table = {k: v for k, v in table.items() if not k.startswith("k15")}
    k15 = {} if skip_k15 else k15_cases(cs, bt, PK, torch, out,
                                        variants=True)
    k15_w = {}
    model, st, P, Q = (None,) * 4 if skip_k15 else plsi_setup(cs, bt, torch)
    if widths and not skip_k15:
        picks = k15_picks(torch, model, st)
        for d in widths:
            tp = k15_tables(torch, P.shape[0], Q.shape[0], d, P.device, d)
            for name in ("user_range_largest", "range_short",
                         "item_segment"):
                b, half, _ = picks[name]
                A, Bf = tp if half == "user" else tp[::-1]
                k15_w[f"{name}_d{d}"] = k15_call(PK, torch, A, Bf, b,
                                                 False)[0]
    k7 = k7_cases(cs, R, torch, out, variants=True)
    for fn in (*k15.values(), *k15_w.values(), *k7.values()):
        fn()
    torch.cuda.synchronize()

    def run(tag, todo):
        for what, fn in todo.items():
            emit(out, variant=tag, call=what, ms=cs.time_ms(fn),
                 by_kernel_ms=by_kernel(cs, torch, fn, top=10))

    if which == "change":
        modules = {"PK": PK, "R": R}
        for tag, (mod, values) in PATCH_VARIANTS.items():
            if skip_k15 and tag.startswith("k15"):
                continue
            with patched(modules[mod], values):
                if tag.startswith("k15"):
                    run(tag, {**k15, **k15_w})
                    emit(out, variant=tag, k15_epoch_replay=k15_replay(
                        cs, PK, torch, model, st, P, Q))
                else:
                    run(tag, k7)
    libs = build_variants(table, os.path.join(
        ROOT, "build", f"k15_k7_variants_{which}"))
    for tag, lib in libs.items():
        if tag == "k15_b_occupancy":
            regs = (ctypes.c_int * 3)()
            rc = lib.plsi_estep_occupancy(regs)
            emit(out, variant=tag, rc=rc, registers_per_thread=regs[0],
                 resident_warps_per_sm=regs[1], local_bytes=regs[2],
                 kernel="rows_kernel<24, true, false>")
        with swapped(lib, table[tag][1]):
            if tag.startswith("k15"):
                run(tag, {**k15, **k15_w})
                if which == "change":
                    emit(out, variant=tag, k15_epoch_replay=k15_replay(
                        cs, PK, torch, model, st, P, Q))
            else:
                run(tag, k7)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--skip-k15", action="store_true")
    ap.add_argument("--skip-k7", action="store_true")
    ap.add_argument("--widths", type=int, nargs="+", default=None,
                    help="K15's batches again at these widths")
    ap.add_argument("--variants", choices=("parent", "change"), default=None,
                    help="the parent's kernels rebuilt with parts changed, "
                         "or this tree's at other constants")
    args = parse(ap)
    cs, out = start(args, "k15_k7_bench")
    import torch

    import buffalo_tpu_torch as bt
    import buffalo_tpu_torch.ops.plsi_kernels as PK
    import buffalo_tpu_torch.ops.retrieval_kernels as R
    from buffalo_tpu_torch.ops import _build

    bt.set_log_level(1)
    st = time.perf_counter()
    _build.build_all()
    emit(out, build_seconds=time.perf_counter() - st)
    os.makedirs(WORK, exist_ok=True)
    if args.variants:
        time_variants(cs, bt, PK, R, torch, out, args.variants, args.widths,
                      args.skip_k15)
    else:
        if not args.skip_k15:
            st = time.perf_counter()
            k15_cases(cs, bt, PK, torch, out, widths=args.widths)
            emit(out, k15_seconds=time.perf_counter() - st)
            torch.cuda.empty_cache()
        if not args.skip_k7:
            st = time.perf_counter()
            k7_cases(cs, R, torch, out)
            emit(out, k7_seconds=time.perf_counter() - st)
    finish(out, "k15_k7_bench", args.tag)


if __name__ == "__main__":
    main()
