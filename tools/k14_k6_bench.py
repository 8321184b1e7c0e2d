"""K14 (eALS's loss pass) and K6 (the IVF tile top-k) at ``chip_smoke.py``'s
shapes, on one card: event and CUPTI milliseconds per call, by kernel,
beside the bounds, the plain versions and the library calls.

    python3 tools/k14_k6_bench.py [--tree DIR] [--tag NAME] [--skip-k14]
        [--skip-k6] [--variants] [--walls N]

``--tree DIR`` runs the kernels of another checkout of the repository
(e.g. a parent commit unpacked with ``git archive`` into a git-ignored
directory): its ``buffalo_tpu_torch`` is imported in place of this one's,
so two trees are compared by running the script once per tree in one
chip call (parent, change, change, parent).  The measuring helpers are
this tree's ``chip_smoke.py``.

K14: the ML-20M synthetic (``chip_smoke.synth_ml20m``, written once into
``build/k13_k21_bench/`` and shared with the other benches), eALS at the
defaults (d = 40) trained K14_BENCH_EPOCHS epochs (its tables kept in
``build/k14_k6_bench/eals.npz`` for the later runs of a call, so every
tree reads the same rows).  The share of the loss view's entries whose
item is among the H hottest (K14_HOT_SHARES); then each case against the
plain version (residuals and sums), repeatable, event and CUPTI ms, by
kernel, the bound (``chip_smoke.k14_work``): the range mode's permuted COO
view, sums only (the path's call, with the plain version's and the
library call's ms beside it); the rows mode's residuals-only call on the
unpermuted CSR (``compute_vhat``); the loss of a MESH_SHARDS-shard mesh
on the gathered tables; the range view again at K14_WIDTHS on random
tables.

K6: the brunch catalog (``catalog_path``'s 505,840 x 100 rows, seed 21,
its 711-cell index with spill 2 and 10 iterations): the K6 calls of the
searches of 10,000 queries at n_probe 8 and 32, of BRUNCH_EXACT queries
at every cell (tiles of hundreds of rows), and of the n_probe 32 search on
the same catalog at d = 13; each through ``chip_smoke.k6_entry`` (against
the plain version, repeatable, the forms' launches, event and CUPTI ms
and by kernel, the plain version's and the library call's ms, the bound)
and with the search's warm host walls (``--walls``, 3 by default: their
median and each one).

``--variants`` times this tree's kernels rebuilt with one part changed
(``VARIANTS``: K14 in blocks of 512 threads; K6 with 4 slots a warp) and
with the class bound
patched (``IVF_SMALL_MAX_L`` 32, 128, 256), each swapped in for the
wrapper's C launch functions.

One JSON line per case on stdout, all of them in the file that
``tools/bench_common.py``'s ``finish`` writes (``k14_k6_bench_<tag>.json``).
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
from bench_common import (ROOT, build_variants, by_kernel, emit, finish,
                          parse, start, swapped)

WORK = os.path.join(ROOT, "build", "k14_k6_bench")
K14_BENCH_EPOCHS = 2
K14_WIDTHS = (13, 64, 128)
K14_HOT_SHARES = (512, 1024, 2048)


# ------------------------------------------------------------------ K14
def eals_setup(cs, bt, torch):
    """(the eALS d = 40 model trained K14_BENCH_EPOCHS epochs, its range
    layout state, the permuted P and Q on the card)."""
    import k13_k21_bench

    os.makedirs(k13_k21_bench.WORK, exist_ok=True)
    model = bt.EALS(cs.eals_opt(bt, num_iters=K14_BENCH_EPOCHS,
                                validation={}),
                    data=k13_k21_bench.ml20m_data(cs))
    np.random.seed(0)
    model.initialize()
    path = os.path.join(WORK, "eals.npz")
    if os.path.isfile(path):
        z = np.load(path)
        model.P, model.Q = z["P"], z["Q"]
    else:
        model.train()
        np.savez(path, P=model.P, Q=model.Q)
    st, P, Q = cs.eals_inputs(torch, model)
    return model, st, P, Q


def k14_call(E, P, Q, rows, keys, vals, C, alpha, sums):
    if sums:
        return lambda: E.eals_residual(P, Q, rows, keys, vals, C,
                                       alpha=alpha)
    return lambda: E.compute_vhat(P, Q, rows, keys)


def k14_one(cs, E, torch, out, name, P, Q, rows, keys, vals, C, alpha,
            sums=True, **extra):
    """One K14 call against the plain version: residuals and sums, two
    launches bitwise equal, event and CUPTI ms, by kernel, the bound."""
    v_ref, s_ref = E.eals_residual_plain(P, Q, rows, keys, vals, C,
                                         alpha=alpha)
    v = [E.compute_vhat(P, Q, rows, keys) for _ in range(2)]
    s = [E.eals_residual(P, Q, rows, keys, vals, C, alpha=alpha)[1]
         for _ in range(2)]
    torch.cuda.synchronize()
    fn = k14_call(E, P, Q, rows, keys, vals, C, alpha, sums)
    # the kernel each call launches once (the parent's residual_kernel)
    main = "total_kernel" if sums else "_kernel"
    d = P.shape[1]
    bms, by = cs.bound_ms(*cs.k14_work(torch, rows, keys, d, sums))
    emit(out, kernel="K14", case=name, d=d, entries=int(rows.shape[0]),
         sums=sums, vhat_rel_err=cs.rel_err(v[0], v_ref)[1],
         sums_rel_err=float(((s[0] - s_ref).abs() / s_ref.abs()).max()),
         repeatable=bool(torch.equal(v[0], v[1])
                         and torch.equal(s[0], s[1])),
         ms=cs.time_ms(fn), device_ms=cs.trace_ms(fn, main),
         by_kernel_ms=by_kernel(cs, torch, fn, top=6), bound_ms=bms,
         bound_by=by, **extra)


def k14_cases(cs, bt, E, torch, out, variants=False):
    """K14's cases (see the module's docstring); with ``variants`` only
    {name: (call, arguments)} of the range view's calls."""
    from buffalo_tpu_torch.data.batching import permute_table

    model, st, P, Q = eals_setup(cs, bt, torch)
    dev = P.device
    rows, keys, vals = st["u"]
    C, alpha = st["C"], float(model.opt.alpha)
    if variants:
        return {"range_sums": (P, Q, rows, keys, vals, C, alpha)}
    counts = np.bincount(keys.cpu().numpy(), minlength=Q.shape[0])
    top = np.sort(counts)[::-1]
    emit(out, kernel="K14", entries=int(rows.shape[0]),
         items_with_entries=int((counts > 0).sum()),
         hot_share={H: float(top[:H].sum() / counts.sum())
                    for H in K14_HOT_SHARES})

    def library():
        v = (P[rows.long()] * Q[keys.long()]).sum(-1)
        err = vals - v
        return torch.stack([((1 + alpha * vals) * err * err).sum(),
                            (C[keys.long()] * v * v).sum(),
                            (err * err).sum()])

    k14_one(cs, E, torch, out, "range_sums", P, Q, rows, keys, vals, C, alpha,
            plain_ms=cs.time_ms(lambda: E.eals_residual_plain(
                P, Q, rows, keys, vals, C, alpha=alpha), reps=5, warmup=1),
            library_ms=cs.time_ms(library, reps=5, warmup=1))
    # the rows mode: residuals only, on the unpermuted CSR
    group = model.data.get_group("rowwise")
    indptr = np.asarray(group["indptr"], np.int64)
    Pu = torch.from_numpy(model.P).to(dev)
    Qu = torch.from_numpy(model.Q).to(dev)
    rows_u = torch.from_numpy(np.repeat(np.arange(len(indptr) - 1,
                                                  dtype=np.int32),
                                        np.diff(indptr))).to(dev)
    keys_u = torch.from_numpy(np.asarray(group["key"], np.int32)).to(dev)
    vals_u = torch.from_numpy(np.asarray(group["val"], np.float32)).to(dev)
    Cu = torch.from_numpy(model._get_negative_weights()).to(dev)
    k14_one(cs, E, torch, out, "rows_residuals", Pu, Qu, rows_u, keys_u,
            vals_u, Cu, alpha, sums=False)
    del Pu, Qu, rows_u, keys_u, vals_u, Cu
    # the mesh's loss on the gathered tables
    mesh_model = bt.EALS(cs.eals_opt(bt, validation={},
                                     **cs.mesh_opt(cs.MESH_SHARDS)),
                         data=model.data)
    sm = mesh_model._train_state()
    Pm, Qm = (torch.from_numpy(permute_table(t, sm[f"{a}_pos"],
                                             sm[f"{a}_pad"])).to(dev)
              for t, a in ((model.P, "u"), (model.Q, "i")))
    Cm = bt.parallelism.all_gather_rows(sm["mesh"], sm["C"], first_only=True)
    k14_one(cs, E, torch, out, "mesh_gathered", Pm, Qm, *sm["u"], Cm, alpha,
            shards=cs.MESH_SHARDS)
    del Pm, Qm, Cm, sm, mesh_model
    # other widths on random tables, the same entries
    for dw in K14_WIDTHS:
        rng = np.random.default_rng(dw)
        Pw, Qw = (torch.tensor(0.3 * rng.standard_normal((len(t), dw)),
                               dtype=torch.float32, device=dev)
                  for t in (P, Q))
        k14_one(cs, E, torch, out, f"range_sums_d{dw}", Pw, Qw, rows, keys,
                vals, C, alpha)
        del Pw, Qw
    torch.cuda.empty_cache()
    return {}


# ------------------------------------------------------------------- K6
def k6_index(cs, bt, d, seed):
    """The brunch-shaped catalog at width d, its queries and its IVF index
    (``catalog_path``'s build)."""
    rng = np.random.default_rng(seed)
    table, queries = cs.brunch_tables(rng, cs.BRUNCH_ITEMS, d,
                                      cs.BRUNCH_QUERIES)
    index = bt.IVFIndex.build(table, n_clusters=cs.BRUNCH_CELLS, spill=2,
                              n_iters=10, device="cuda")
    return table, queries, index


def k6_searches(cs, bt):
    """{case: (the search's K6 call, the search)}: n_probe 8 and 32 and
    every cell on the brunch catalog, n_probe 32 at d = 13."""
    from buffalo_tpu_torch.parallel import ann

    calls = {}
    for d, seed, cases in ((cs.BRUNCH_D, 21, (8, 32, "all")), (13, 13, (32,))):
        table, queries, index = k6_index(cs, bt, d, seed)
        for n_probe in cases:
            q = queries[:cs.BRUNCH_EXACT] if n_probe == "all" else queries
            index.n_probe = cs.BRUNCH_CELLS if n_probe == "all" else n_probe

            def search(index=index, q=q, n=index.n_probe):
                index.n_probe = n
                return index.search(q, cs.TOPK)
            _, call = cs.capture_k6(ann, search)
            name = f"d{d}_probe{n_probe}" if d != cs.BRUNCH_D \
                else f"probe{n_probe}"
            calls[name] = (call, search)
        del table
    return calls


def k6_cases(cs, bt, R, torch, out, variants=False, walls=3):
    calls = k6_searches(cs, bt)
    if variants:
        return calls
    for name, (call, search) in calls.items():
        ms = []
        for _ in range(walls):
            st = time.perf_counter()
            search()
            ms.append(1e3 * (time.perf_counter() - st))
        emit(out, kernel="K6", case=name, **cs.k6_entry(R, torch, call),
             search_host_ms_warm=float(np.median(ms)), search_host_ms=ms)
    return calls


# ------------------------------------------------------------- variants
# tag -> (source, [launch functions swapped in], [(old, new)]): this
# tree's K14 and K6 rebuilt with one part changed
K14_V = ("eals_loss.cu", ["eals_loss", "eals_loss_workspace"])
K6_V = ("ivf_tile_topk.cu", ["ivf_tile_topk"])
VARIANTS = {
    "k14_as_is": (*K14_V, []),
    "k14_threads_512": (*K14_V, [("kThreads = 1024,", "kThreads = 512,")]),
    "k6_as_is": (*K6_V, []),
    "k6_slots_4": (*K6_V, [("constexpr int kSlots = 8;",
                            "constexpr int kSlots = 4;")]),
}
# K6's class bound patched (IVF_SMALL_MAX_L)
K6_BOUNDS = (32, 128, 256)


@contextlib.contextmanager
def patched(module, **values):
    real = {k: getattr(module, k) for k in values}
    for k, v in values.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in real.items():
            setattr(module, k, v)


def time_variants(cs, bt, E, R, torch, out, skip_k14, skip_k6):
    k14 = {} if skip_k14 else k14_cases(cs, bt, E, torch, out, variants=True)
    k6 = {} if skip_k6 else k6_cases(cs, bt, R, torch, out, variants=True)
    fns = {}
    for name, args in k14.items():
        fns[name] = k14_call(E, *args, True)
    for name, ((args, kw), _) in k6.items():
        fns[name] = (lambda args=args, kw=kw: R.ivf_tile_topk(*args, **kw))
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()

    def run(tag, prefix):
        for name, fn in fns.items():
            if name.startswith(prefix):
                emit(out, variant=tag, call=name, ms=cs.time_ms(fn),
                     by_kernel_ms=by_kernel(cs, torch, fn, top=6))

    if not skip_k6:
        for bound in K6_BOUNDS:
            with patched(R, IVF_SMALL_MAX_L=bound):
                for name, ((args, kw), _) in k6.items():
                    got = R.ivf_tile_topk(*args, **kw)
                    cs.kernel_topk_check(got, R.ivf_tile_topk_plain(*args),
                                         f"K6 at a bound of {bound} rows")
                run(f"k6_small_max_{bound}", "probe")
                run(f"k6_small_max_{bound}", "d13")
    table = {k: v for k, v in VARIANTS.items()
             if not (skip_k14 and k.startswith("k14"))
             and not (skip_k6 and k.startswith("k6"))}
    libs = build_variants(table, os.path.join(ROOT, "build",
                                              "k14_k6_variants"))
    for tag, lib in libs.items():
        with swapped(lib, table[tag][1]):
            if tag.startswith("k14"):
                run(tag, "range")
            else:
                run(tag, "probe")
                run(tag, "d13")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--skip-k14", action="store_true")
    ap.add_argument("--skip-k6", action="store_true")
    ap.add_argument("--variants", action="store_true",
                    help="this tree's kernels rebuilt with parts changed")
    ap.add_argument("--walls", type=int, default=3,
                    help="warm host walls timed per K6 search (each kept)")
    args = parse(ap)
    cs, out = start(args, "k14_k6_bench")
    import torch

    import buffalo_tpu_torch as bt
    import buffalo_tpu_torch.ops.eals_kernels as E
    import buffalo_tpu_torch.ops.retrieval_kernels as R
    from buffalo_tpu_torch.ops import _build

    bt.set_log_level(1)
    st = time.perf_counter()
    _build.build_all()
    emit(out, build_seconds=time.perf_counter() - st)
    os.makedirs(WORK, exist_ok=True)
    if args.variants:
        time_variants(cs, bt, E, R, torch, out, args.skip_k14, args.skip_k6)
    else:
        if not args.skip_k14:
            st = time.perf_counter()
            k14_cases(cs, bt, E, torch, out)
            emit(out, k14_seconds=time.perf_counter() - st)
            torch.cuda.empty_cache()
        if not args.skip_k6:
            st = time.perf_counter()
            k6_cases(cs, bt, R, torch, out, walls=args.walls)
            emit(out, k6_seconds=time.perf_counter() - st)
    finish(out, "k14_k6_bench", args.tag)


if __name__ == "__main__":
    main()
