"""K13 (the eALS dimension sweep) and K21 (the W2V stream chunk deltas) at
``chip_smoke.py``'s shapes, on one card: event and CUPTI milliseconds per
launch, by half and mode, beside bound, plain version and library route.

    python3 tools/k13_k21_bench.py [--tree DIR] [--tag NAME]

``--tree DIR`` runs the kernels of another checkout of the repository
(e.g. a parent commit unpacked with ``git archive`` into a git-ignored
directory): its ``buffalo_tpu_torch`` is imported in place of this one's,
so two trees are compared by running the script once per tree in one
chip call (parent, change, change, parent).  The measuring helpers are
this tree's ``chip_smoke.py``.

K13: the ML-20M synthetic (``chip_smoke.synth_ml20m``, written once into
``build/k13_k21_bench/`` and reused by later runs of the call), eALS at
the defaults and d = 40 (``chip_smoke.eals_opt``), its random initial
tables: every batch of one epoch's range layout, user half then item
half, one line each (half, mode, shape, entries, event ms, bound, the
library route ``chip_smoke.k13_library``), then per (half, mode) the sum,
the whole epoch (``eals_epoch``) by events and its device time by kernel
(CUPTI); the plain version on the largest user range batch, the largest
item range batch and the largest segment batch.

K21: the brunch corpus (``chip_smoke.brunch_corpus``, built as a
``stream`` as ``w2v_path`` does, once per call) at W2V's stream settings
(d = 32, window 5, 5 negatives, block 4): one epoch's host phase with
numpy seed 1, N(0, 0.1) tables from seed 0; chunk 0 through K21 (event
and CUPTI ms, bound as ``w2v_kernels`` counts it, the plain version's ms,
its distance from the plain version), then one device epoch over all the
chunks (``w2v_epoch_stream``, as ``w2v_path`` profiles it) by events and
by kernel.

``--variants`` instead times K13 on four batches (user 16, 304 and
8,192 entries wide, the item half's first segment batch) and K21 on the
brunch chunk as they are and rebuilt with one part changed or switched off
(``VARIANTS``: source edits of ``csrc/eals_sweep.cu`` and
``csrc/w2v_stream_chunk.cu`` that match their text and fail loudly when it
changes), each build swapped in for the wrapper's C launch functions
(``tools/bench_common.py``).

One JSON line per case on stdout, all of them in
``chiprun_out/k13_k21_bench_<tag>.json``.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
from bench_common import (ROOT, build_variants, by_kernel, emit, finish,
                          parse, start, swapped)

WORK = os.path.join(ROOT, "build", "k13_k21_bench")


def ml20m_data(cs):
    from buffalo_tpu_torch.data.mm import MatrixMarket, MatrixMarketOptions

    path = os.path.join(WORK, "ml20m.bfo")
    if not os.path.isfile(os.path.join(path, "header.json")):
        groups, _ = cs.synth_ml20m(cs.ML20M_USERS, cs.ML20M_ITEMS,
                                   cs.ML20M_NNZ)
        cs.write_compiled(groups, cs.ML20M_USERS, cs.ML20M_ITEMS, path,
                          num_vali=2000, seed=1)
    dopt = MatrixMarketOptions().get_default_option()
    dopt.data.tmp_dir = os.path.join(WORK, "tmp")
    dopt.data.path = path
    data = MatrixMarket(dopt)
    data.open(path)
    return data


def k13_setup(cs, bt, E, torch):
    """(state, P, Q, C, alpha, the two halves: (name, batches, X, Y, S,
    item_axis, reg)) of the eALS d = 40 layout with random initial
    tables."""
    model = bt.EALS(cs.eals_opt(bt), data=ml20m_data(cs))
    np.random.seed(0)
    model.initialize()
    st = model._train_state()
    _, P, Q = cs.eals_inputs(torch, model, st)
    C = st["C"]
    o = model.opt
    halves = (("user", st["row_groups"], P, Q, E.eals_gramian(Q, C), False,
               float(o.reg_u)),
              ("item", st["col_groups"], Q, P, E.eals_gramian(P), True,
               float(o.reg_i)))
    return model, st, P, Q, C, float(o.alpha), halves


def k13_cases(cs, bt, E, torch, out):
    from buffalo_tpu_torch.data.batching import RangeBatch

    model, st, P, Q, C, alpha, halves = k13_setup(cs, bt, E, torch)
    o = model.opt
    sums, plain = {}, {}
    for half, batches, X, Y, S, item, reg in halves:
        kw = dict(item_axis=item, alpha=alpha, reg=reg)
        for i, b in enumerate(batches):
            rng_mode = isinstance(b, RangeBatch)
            mode = "range" if rng_mode else "segment"
            if rng_mode:
                entries = int(b.lens.sum())
                nbytes, flops = cs.k13_work(b, X.shape[1], item)
            else:
                entries = int(b.chunk_lens.sum())
                nbytes, flops = cs.k13_segment_work(b, X.shape[1], item,
                                                    X.shape[0])
            bms, by = cs.bound_ms(nbytes, flops)
            Xw = X.clone()
            ms = cs.time_ms(lambda: E.dim_sweep(Xw, Y, S, C, batch=b, **kw),
                            reps=5, warmup=1)
            lib = cs.time_ms(lambda: cs.k13_library(
                torch, Xw, Y, S, C, b, **kw), reps=3, warmup=1)
            emit(out, kernel="K13", half=half, mode=mode, batch=i,
                 shape=list(b.cols.shape), entries=entries, ms=ms,
                 bound_ms=bms, bound_by=by, library_ms=lib)
            s = sums.setdefault((half, mode), dict(launches=0, ms=0.0,
                                                   library_ms=0.0,
                                                   bound_ms=0.0))
            s["launches"] += 1
            s["ms"] += ms
            s["library_ms"] += lib
            s["bound_ms"] += bms
            key = (half, mode)
            if key not in plain or entries > plain[key][0]:
                plain[key] = (entries, b, X, Y, S, kw, ms, bms, lib)
            del Xw
    for (half, mode), s in sums.items():
        emit(out, kernel="K13", half=half, mode=mode, per_epoch=s)
    for (half, mode), (entries, b, X, Y, S, kw, ms, bms, lib) in \
            plain.items():
        Xw = X.clone()
        if isinstance(b, RangeBatch):
            args = (int(b.row_start), b.lens, b.cols, b.vals)
            fn = (lambda: E.range_sweep_plain(Xw, Y, S, C, *args, **kw))
        else:
            fn = (lambda: E.segment_sweep_plain(Xw, Y, S, C, b, **kw))
        dev_ms = cs.trace_ms(lambda: E.dim_sweep(Xw, Y, S, C, batch=b, **kw),
                             "sweep")
        emit(out, kernel="K13", largest=f"{half} {mode}",
             shape=list(b.cols.shape), entries=entries, ms=ms,
             device_ms=dev_ms, bound_ms=bms, library_ms=lib,
             plain_ms=cs.time_ms(fn, reps=2, warmup=1))
        del Xw

    def epoch():
        E.eals_epoch(P, Q, st["row_groups"], st["col_groups"], C,
                     alpha=alpha, reg_u=float(o.reg_u),
                     reg_i=float(o.reg_i))

    emit(out, kernel="K13", epoch_ms=cs.time_ms(epoch, reps=3, warmup=1),
         epoch_profile=cs.profile_call(torch, epoch, top=10),
         launches_per_epoch=len(st["row_groups"]) + len(st["col_groups"]))
    del P, Q, model, st
    torch.cuda.empty_cache()


# tag -> (source, [launch functions swapped in], [(old, new)]): K13 or K21
# rebuilt with edits that match csrc's text exactly; the switched-off
# builds compute something else and are timed only
K13_V = ("eals_sweep.cu", ["eals_gram_sweep", "eals_gram_workspace"])
K21_V = ("w2v_stream_chunk.cu", ["w2v_stream_chunk", "w2v_stream_parts"])
VARIANTS = {
    "k13_as_is": (*K13_V, []),
    "k13_no_sweep": (*K13_V, [("  if (tid < 32) {\n    float rr[4];",
                               "  if (tid < 32 && p.d < 0) {\n"
                               "    float rr[4];")]),
    "k13_no_mma": (*K13_V, [("for (int ks = eg; ks * 8 < tl; ks += p.EG)",
                             "for (int ks = eg; ks * 8 < tl && d < 0; "
                             "ks += p.EG)")]),
    "k13_no_gather": (*K13_V, [(
        "if (p.vec) cp_async16_l1(Fst + l * FS + c, from, col >= 0);",
        "if (p.vec) cp_async16_l1(Fst + l * FS + c, from, false);")]),
    "k13_stages_3": (*K13_V, [("constexpr int kGStages = 2;",
                               "constexpr int kGStages = 3;")]),
    "k21_as_is": (*K21_V, []),
    "k21_no_phase1": (*K21_V, [(
        "for (int slot = tid; slot < n_all; slot += kThreads)",
        "for (int slot = tid; slot < n_all && d < 0; slot += kThreads)")]),
    "k21_no_phase2": (*K21_V, [(
        "for (int row = warp * rpw + lane / LPR; row < nrow;",
        "for (int row = warp * rpw + lane / LPR; row < nrow && d < 0;")]),
    **{f"k21_tile_{n}": (*K21_V, [("constexpr int kStagedTile = 64;",
                                   f"constexpr int kStagedTile = {n};")])
       for n in (32, 128)},
}


def time_variants(cs, bt, E, W, S, torch, out):
    """K13 on four batches of the eALS layout (user 1, 16 entries; user
    12, 304; user 27, 8,192; the item half's first segment batch) and K21
    on the brunch chunk, for each build of ``VARIANTS``: event ms and
    CUPTI ms by kernel."""
    from buffalo_tpu_torch.data.batching import RangeBatch

    _, st, P, Q, C, alpha, halves = k13_setup(cs, bt, E, torch)
    calls = {}
    for half, batches, X, Y, Sm, item, reg in halves:
        picks = ([1, 12, 27] if half == "user" else
                 [next(i for i, b in enumerate(batches)
                       if not isinstance(b, RangeBatch))])
        for i in picks:
            b = batches[i]
            Xw = X.clone()
            calls[f"{half}_{i}_{list(b.cols.shape)}"] = (
                lambda Xw=Xw, Y=Y, Sm=Sm, b=b, item=item, reg=reg:
                E.dim_sweep(Xw, Y, Sm, C, batch=b, item_axis=item,
                            alpha=alpha, reg=reg))
    k21_fn = k21_chunk(cs, bt, W, S, torch)[0]
    for fn in calls.values():
        fn()
    k21_fn()
    libs = build_variants(VARIANTS,
                          os.path.join(ROOT, "build", "k13_k21_variants"))
    for tag, lib in libs.items():
        todo = calls if tag.startswith("k13") else {"k21_chunk": k21_fn}
        with swapped(lib, VARIANTS[tag][1]):
            for what, call in todo.items():
                emit(out, variant=tag, call=what, ms=cs.time_ms(call),
                     by_kernel_ms=by_kernel(cs, torch, call, top=6))


def brunch_chunks(cs, bt):
    """(the host phase's arrays, V, the vocabulary's counts, block, T, G,
    options) of the brunch corpus, cached in WORK."""
    cache = os.path.join(WORK, "brunch_epoch.npz")
    if not os.path.isfile(cache):
        cs.WORK = WORK
        os.makedirs(WORK, exist_ok=True)
        cs.brunch_corpus(os.path.join(WORK, "brunch.txt"))
        data, _ = cs.w2v_build(bt)
        model = cs.w2v_model(bt, data, cs.w2v_opt(bt))
        block, T, _ = model._stream_plan()
        G = int(model.opt.max_chunks_per_dispatch)
        wc, bc, hc, nchunks, _ = model._stream_host_phase(
            np.random.default_rng(1), T, G)
        o = model.opt
        np.savez(cache, wc=wc[:nchunks], bc=bc[:nchunks], hc=hc[:nchunks],
                 dist=np.asarray(model._vocab.dist, dtype=np.int64),
                 V=int(model._vocab.size), block=block, T=T, G=G,
                 window=int(o.window), K=int(o.num_negative_samples),
                 lr=float(o.lr), min_lr=float(o.min_lr),
                 max_step_norm=float(o.max_step_norm),
                 total_words=float(model._vocab.total_word_count))
    return dict(np.load(cache))


def k21_chunk(cs, bt, W, S, torch):
    """(K21 on chunk 0 of the brunch epoch as a call, its inputs)."""
    z = brunch_chunks(cs, bt)
    dev = torch.device("cuda")
    V, block, T = (int(z[k]) for k in ("V", "block", "T"))
    g = torch.Generator().manual_seed(0)
    L0 = (0.1 * torch.randn(V, cs.W2V_D, generator=g)).to(dev)
    L1 = (0.1 * torch.randn(V, cs.W2V_D, generator=g)).to(dev)
    prob, al = S.build_alias_table(np.diff(z["dist"], prepend=0))
    alias = (torch.from_numpy(prob).to(dev), torch.from_numpy(al).to(dev))
    wc = torch.from_numpy(z["wc"][0]).to(dev)
    hc = torch.from_numpy(z["hc"][0]).to(dev)
    sc = torch.cumsum(torch.from_numpy(z["bc"][0]).to(dev), 0,
                      dtype=torch.int32)
    negs = W.stream_negatives(T // block, V, device=dev,
                              num_negatives=int(z["K"]), seed=0, epoch=0,
                              chunk=0, alias=alias)
    kw = dict(window=int(z["window"]), block=block, vocab_size=V)

    def fn():
        return W.stream_chunk_deltas(L0, L1, wc, sc, hc, negs, **kw)

    return fn, (z, L0, L1, alias, wc, sc, hc, negs, kw)


def k21_cases(cs, bt, W, S, torch, out):
    fn, (z, L0, L1, alias, wc, sc, hc, negs, kw) = k21_chunk(cs, bt, W, S,
                                                             torch)
    dev = torch.device("cuda")
    V, block, T, G = (int(z[k]) for k in ("V", "block", "T", "G"))
    window, K = int(z["window"]), int(z["K"])
    d = cs.W2V_D
    NB = T // block
    got, again = fn(), fn()
    ref = W.stream_chunk_deltas_plain(L0, L1, wc, sc, hc, negs, **kw)
    torch.cuda.synchronize()
    err = max(cs.rel_err(a, b)[1] for a, b in zip(got[:3], ref[:3]))
    pairs = float(got[4])
    u0 = cs.distinct_rows(torch, wc, R=V)
    u1 = cs.distinct_rows(torch, wc, negs, R=V)
    bms, by = cs.bound_ms(9 * T + 4 * NB * K + 4 * d * (u0 + u1)
                          + 4 * d * (2 * T + NB * K),
                          pairs * 2 * d * (3 + 3 * K))
    emit(out, kernel="K21", positions=T, d=d, K=K, block=block,
         window=window, pair_terms=pairs, count_equal=float(ref[4]) == pairs,
         rel_err=err, loss_rel_err=abs(float(got[3]) - float(ref[3]))
         / abs(float(ref[3])), repeatable=all(torch.equal(a, b)
                                              for a, b in zip(got, again)),
         ms=cs.time_ms(fn), device_ms=cs.trace_ms(fn, "chunk_deltas"),
         bound_ms=bms, bound_by=by,
         plain_ms=cs.time_ms(lambda: W.stream_chunk_deltas_plain(
             L0, L1, wc, sc, hc, negs, **kw), reps=5, warmup=1))
    nchunks = z["wc"].shape[0]
    g_len = min(G, nchunks)
    staged = [tuple(torch.from_numpy(z[k][i * g_len:(i + 1) * g_len]).to(dev)
                    for k in ("wc", "bc", "hc"))
              for i in range(nchunks // g_len)]
    com = dict(seed=0, epoch=0, groups=len(staged), window=window,
               block=block, num_negatives=K, vocab_size=V, compute_loss=True,
               lr=float(z["lr"]), min_lr=float(z["min_lr"]),
               total_words=float(z["total_words"]), words_per_chunk=1.0,
               max_step_norm=float(z["max_step_norm"]))
    one = bt.parallelism.Mesh([dev])

    def epoch():
        for i, arr in enumerate(staged):
            W.w2v_epoch_stream(one, {dev: (L0, L1)}, *([a] for a in arr),
                               {dev: alias}, np.float32(0), group=i, **com)

    emit(out, kernel="K21", chunks=nchunks,
         device_epoch_ms=cs.time_ms(epoch, reps=3, warmup=1),
         epoch_profile=cs.profile_call(torch, epoch, top=10))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--skip-k13", action="store_true")
    ap.add_argument("--skip-k21", action="store_true")
    ap.add_argument("--variants", action="store_true",
                    help="K13 and K21 rebuilt with parts changed (VARIANTS)")
    args = parse(ap)
    cs, out = start(args, "k13_k21_bench")
    import torch

    import buffalo_tpu_torch as bt
    import buffalo_tpu_torch.ops.eals_kernels as E
    import buffalo_tpu_torch.ops.sgd_kernels as S
    import buffalo_tpu_torch.ops.w2v_kernels as W
    from buffalo_tpu_torch.ops import _build

    bt.set_log_level(1)
    st = time.perf_counter()
    _build.build_all()
    emit(out, build_seconds=time.perf_counter() - st)
    os.makedirs(WORK, exist_ok=True)
    if args.variants:
        time_variants(cs, bt, E, W, S, torch, out)
        args.skip_k13 = args.skip_k21 = True
    if not args.skip_k13:
        k13_cases(cs, bt, E, torch, out)
    if not args.skip_k21:
        k21_cases(cs, bt, W, S, torch, out)
    finish(out, "k13_k21_bench", args.tag)


if __name__ == "__main__":
    main()
