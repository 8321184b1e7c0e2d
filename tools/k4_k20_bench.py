"""K4 (the iALS++ block solve) and K20 (the W2V capped row apply) at
``chip_smoke.py``'s shapes, on one card: event and CUPTI milliseconds per
launch, by half and row class, beside bound, plain version and library
route.

    python3 tools/k4_k20_bench.py [--tree DIR] [--tag NAME] [--skip-k4]
        [--skip-k20] [--sweep] [--variants]

``--tree DIR`` runs the kernels of another checkout of the repository
(e.g. a parent commit unpacked with ``git archive`` into a git-ignored
directory): its ``buffalo_tpu_torch`` is imported in place of this one's,
so two trees are compared by running the script once per tree in one
chip call (parent, change, change, parent).  The measuring helpers are
this tree's ``chip_smoke.py``.

K4: the ML-20M synthetic (``tools/k13_k21_bench.py``'s copy in
``build/k13_k21_bench/``, written by the first run of a call), the
range layout at d = 160 with ``chip_smoke.wide_kernel_phase``'s tables
(|N(0, 1/d^2)| from seed 17, then one iALS++ epoch): every range batch of
the next epoch, user half then item half, one line each (shape, rows,
entries, event ms, bound), and the same batch with only its short rows
(``lens`` of the others set to 0, so the kernel skips them) and with
only its long ones.  The split is the tree's own: the new forms' class
bounds (``ops.als_kernels.IALSPP_SHORT_MAX`` / ``IALSPP_GRAM_MIN``:
short, tile and Gram rows), or for a tree without them the old kernel's
shared-memory tile (rows that fit it, gathered once, and rows that
stream through it).  Then per half and class the sums, the whole epoch (``als_epoch``)
by events and its device time by kernel (CUPTI), the plain version and
the bound on the 880-row batch, and the forms' shared memory and blocks
per SM.

K20: the brunch corpus at W2V's stream settings (``tools/k13_k21_bench.py``
``k21_chunk``): chunk 0's K21 deltas, then K20 on its L1 update (the
positions' and negatives' rows, 294,912 entries) and its L0 update (the
positions', 131,072): event and CUPTI ms, the device operations per call,
CUPTI ms by kernel, the plain version and ``index_add_`` + the clip;
then one device stream epoch (``w2v_epoch_stream``) by kernel.

``--sweep`` times the K4 epoch's range batches for each pair of class
bounds of ``SWEEP_SHORT`` / ``SWEEP_GRAM`` (the new forms only).
``--variants`` times K4 on four batches (the tile form's rows of 56, 120
and 304 entries, a Gram batch of 8,192) and K20 on the L1 update as they are and rebuilt with one part switched
off (``VARIANTS``: source edits that match ``csrc/ialspp_solve.cu`` and
``csrc/w2v_row_apply.cu`` and fail loudly when they change).

One JSON line per case on stdout, all of them in
``chiprun_out/k4_k20_bench_<tag>.json``.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
from bench_common import (ROOT, build_variants, by_kernel, emit, finish,
                          parse, start, swapped)

import k13_k21_bench as kb

# (short_max, gram_min) pairs: the short class's bound at the default Gram
# bound, then the Gram class's at the default short bound
SWEEP_SHORT = (0, 16, 24, 32, 48)
SWEEP_GRAM = (0, 192, 256, 304, 384, 480, 600, 1 << 30)


def old_tile(d, L):
    """Entries of the old kernel's shared-memory tile for a batch of
    padded length L at width d (its launcher's rule), and its shared
    memory in bytes."""
    r4 = lambda n: (n + 3) // 4 * 4  # noqa: E731
    budget, S = 227 * 1024 // 4, r4(d)
    fixed = 2 * r4(d) + r4(L) + 33
    T = min((budget - fixed - 9) // (S + 3), L)
    return T, 4 * (T * S + 2 * r4(d) + r4(L) + 3 * r4(T) + 33)


def k4_setup(cs, K, torch):
    from buffalo_tpu_torch.data.batching import stage_batch

    data = kb.ml20m_data(cs)
    d = cs.D_WIDE
    row_b, col_b, P, Q = cs.range_layout(data, cs.ML20M_USERS,
                                         cs.ML20M_ITEMS, seed=17, d=d)
    dev = torch.device("cuda")
    P, Q = torch.from_numpy(P).to(dev), torch.from_numpy(Q).to(dev)
    row_s = [stage_batch(b, dev) for b in row_b]
    col_s = [stage_batch(b, dev) for b in col_b]
    kw_w = dict(cs.epoch_kw(cs.ML20M_USERS, cs.ML20M_ITEMS),
                optimizer="ialspp", block_size=d)
    K.als_epoch(P, Q, row_s, col_s, **kw_w)
    torch.cuda.synchronize()
    halves = (("user", P, Q, row_s, False, cs.ML20M_ITEMS),
              ("item", Q, P, col_s, True, cs.ML20M_USERS))
    return d, P, Q, row_s, col_s, kw_w, halves


def k4_call(cs, K, torch, table, Bf, FF, b, lens, item, n_fixed, d):
    kw = dict(alpha=cs.ALPHA, reg=cs.REG, adaptive_reg=False,
              item_axis=item, num_fixed_rows=n_fixed, compute_loss=True,
              block_size=d, cg_tol=cs.CG_TOL, row_start=b.row_start)
    return lambda: K.ialspp_solve_batch(table, Bf, FF, lens, b.cols, b.vals,
                                        **kw)


def range_batches(halves, torch):
    from buffalo_tpu_torch.data.batching import RangeBatch

    for half, table, Bf, batches, item, n_fixed in halves:
        FF = Bf.T @ Bf
        for i, b in enumerate(batches):
            if isinstance(b, RangeBatch):
                yield half, i, b, table, Bf, FF, item, n_fixed


def k4_cases(cs, K, torch, out):
    d, P, Q, row_s, col_s, kw_w, halves = k4_setup(cs, K, torch)
    new = hasattr(K, "IALSPP_GRAM_MIN")
    if new:
        emit(out, kernel="K4", forms=K.ialspp_forms(d, d))
    sums = {}
    for half, i, b, table, Bf, FF, item, n_fixed in range_batches(halves,
                                                                  torch):
        B, L = b.cols.shape
        if new:
            lo, hi = K.IALSPP_SHORT_MAX, K.IALSPP_GRAM_MIN
            bounds = (("short", 0, lo), ("tile", lo, hi),
                      ("gram", hi, 1 << 30))
        else:
            T = old_tile(d, L)[0]
            bounds = (("fits", 0, T), ("streams", T, 1 << 30))
        lens = b.lens
        scratch = table.clone()
        line = dict(kernel="K4", half=half, batch=i, shape=[B, L])
        zero = torch.zeros_like(lens)
        for cls, sel in [("all", lens)] + [
                (c, torch.where((lens > lo) & (lens <= hi), lens, zero))
                for c, lo, hi in bounds]:
            rows = int((sel > 0).sum())
            if rows == 0:
                continue
            ms = cs.time_ms(k4_call(cs, K, torch, scratch, Bf, FF, b, sel,
                                    item, n_fixed, d), reps=5, warmup=1)
            line[cls] = dict(rows=rows, entries=int(sel.sum()), ms=ms)
            s = sums.setdefault((half, cls), dict(launches=0, rows=0,
                                                  entries=0, ms=0.0))
            s["launches"] += 1
            s["rows"] += rows
            s["entries"] += int(sel.sum())
            s["ms"] += ms
        if not new:
            line["smem_bytes"] = old_tile(d, L)[1]
        real, nnz, nbytes, flops = cs.ialspp_work(b, b.vals, d, d, item)
        line["bound_ms"], line["bound_by"] = cs.bound_ms(nbytes, flops)
        emit(out, **line)
        del scratch
    for (half, cls), s in sums.items():
        emit(out, kernel="K4", half=half, cls=cls, per_epoch=s)
    # the measured batch: the item half's batch nearest L = 1024
    best = None
    for half, i, b, table, Bf, FF, item, n_fixed in range_batches(halves,
                                                                  torch):
        L = b.cols.shape[1]
        if L > 96 and (best is None or abs(L - 1024) < best[0]):
            best = (abs(L - 1024), half, i, b, table, Bf, FF, item, n_fixed)
    _, half, i, b, table, Bf, FF, item, n_fixed = best
    scratch = table.clone()
    fn = k4_call(cs, K, torch, scratch, Bf, FF, b, b.lens, item, n_fixed, d)
    real, nnz, nbytes, flops = cs.ialspp_work(b, b.vals, d, d, item)
    kw = dict(alpha=cs.ALPHA, reg=cs.REG, adaptive_reg=False,
              item_axis=item, num_fixed_rows=n_fixed, compute_loss=True,
              block_size=d, cg_tol=cs.CG_TOL, row_start=b.row_start)
    emit(out, kernel="K4", measured_batch=f"{half} {i}",
         shape=list(b.cols.shape), rows=real, entries=nnz, ms=cs.time_ms(fn),
         by_kernel_ms=by_kernel(cs, torch, fn, top=6),
         bound_ms=cs.bound_ms(nbytes, flops)[0],
         plain_ms=cs.time_ms(lambda: K.ialspp_solve_batch_plain(
             scratch, Bf, FF, b.lens, b.cols, b.vals, **kw), reps=3,
             warmup=1))
    Pc, Qc = P.clone(), Q.clone()

    def epoch():
        K.als_epoch(Pc, Qc, row_s, col_s, **kw_w)

    emit(out, kernel="K4", epoch_ms=cs.time_ms(epoch, reps=3, warmup=1),
         epoch_profile=cs.profile_call(torch, epoch, top=10))
    return d, P, Q, halves


def k4_sweep(cs, K, torch, out, d, halves):
    """The K4 batches of one epoch for each pair of class bounds of
    SWEEP_SHORT and SWEEP_GRAM."""
    if not hasattr(K, "IALSPP_GRAM_MIN"):
        return
    real = K.IALSPP_SHORT_MAX, K.IALSPP_GRAM_MIN
    pairs = ([(lo, real[1]) for lo in SWEEP_SHORT]
             + [(real[0], hi) for hi in SWEEP_GRAM])
    try:
        for lo, hi in pairs:
            K.IALSPP_SHORT_MAX, K.IALSPP_GRAM_MIN = lo, hi
            tot = 0.0
            for half, i, b, table, Bf, FF, item, n_fixed in range_batches(
                    halves, torch):
                scratch = table.clone()
                tot += cs.time_ms(k4_call(cs, K, torch, scratch, Bf, FF, b,
                                          b.lens, item, n_fixed, d),
                                  reps=5, warmup=1)
                del scratch
            emit(out, kernel="K4", sweep_short_max=lo, sweep_gram_min=hi,
                 per_epoch_ms=tot)
    finally:
        K.IALSPP_SHORT_MAX, K.IALSPP_GRAM_MIN = real


def k20_inputs(cs, bt, W, S, torch):
    fn21, (z, L0, L1, alias, wc, sc, hc, negs, kw) = kb.k21_chunk(
        cs, bt, W, S, torch)
    dL0p, dL1p, dLn = fn21()[:3]
    d = L1.shape[1]
    lr, cap = float(z["lr"]), float(z["max_step_norm"])
    return dict(
        L1=(L1, [(wc, dL1p), (negs.reshape(-1), dLn.reshape(-1, d))]),
        L0=(L0, [(wc, dL0p)])), lr, cap, (fn21, z, L0, L1, alias)


def k20_cases(cs, bt, W, S, torch, out):
    updates, lr, cap, (_, z, L0, L1, alias) = k20_inputs(cs, bt, W, S, torch)
    V = L1.shape[0]
    d = L1.shape[1]
    for name, (table, parts) in updates.items():
        outs = [table.clone() for _ in range(3)]
        W.row_apply(outs[0], parts, scale=lr, cap=cap)
        W.row_apply(outs[1], parts, scale=lr, cap=cap)
        W.row_apply_plain(outs[2], parts, scale=lr, cap=cap)
        torch.cuda.synchronize()
        keys = torch.cat([k for k, _ in parts])
        rows = torch.cat([r for _, r in parts])
        keep = (keys >= 0) & (keys < V)
        keys_l, rows_l = keys[keep].long(), rows[keep]
        n, t = int(keys.numel()), int(torch.unique(keys_l).numel())
        scratch = table.clone()

        def fn():
            W.row_apply(scratch, parts, scale=lr, cap=cap)

        def library():
            D = torch.zeros_like(table).index_add_(0, keys_l, rows_l,
                                                   alpha=lr)
            nn = (D * D).sum(1, keepdim=True).sqrt()
            return scratch.add_(D * torch.clamp(cap / nn.clamp(min=1e-20),
                                                max=1.0))

        kern = by_kernel(cs, torch, fn, top=12)
        main = ("apply_pieces" if any("apply_pieces" in k for k in kern)
                else "apply_rows")
        dev_ms, ops = cs.trace_stats(fn, main)
        emit(out, kernel="K20", update=name, entries=n, touched_rows=t, d=d,
             max_abs_err=float((outs[0] - outs[2]).abs().max()),
             repeatable=torch.equal(outs[0], outs[1]), ms=cs.time_ms(fn),
             device_ms=dev_ms, stream_ops_per_call=ops, by_kernel_ms=kern,
             bound_ms=cs.bound_ms(4 * n + 4 * d * n + 8 * d * t,
                                  2 * d * n)[0],
             plain_ms=cs.time_ms(lambda: W.row_apply_plain(
                 scratch, parts, scale=lr, cap=cap), reps=5, warmup=1),
             library_ms=cs.time_ms(library))
        del outs, scratch
    dev = torch.device("cuda")
    nchunks = z["wc"].shape[0]
    G = int(z["G"])
    g_len = min(G, nchunks)
    staged = [tuple(torch.from_numpy(z[k][i * g_len:(i + 1) * g_len]).to(dev)
                    for k in ("wc", "bc", "hc"))
              for i in range(nchunks // g_len)]
    com = dict(seed=0, epoch=0, groups=len(staged), window=int(z["window"]),
               block=int(z["block"]), num_negatives=int(z["K"]),
               vocab_size=V, compute_loss=True, lr=float(z["lr"]),
               min_lr=float(z["min_lr"]),
               total_words=float(z["total_words"]), words_per_chunk=1.0,
               max_step_norm=float(z["max_step_norm"]))
    one = bt.parallelism.Mesh([dev])

    def epoch():
        for i, arr in enumerate(staged):
            W.w2v_epoch_stream(one, {dev: (L0, L1)}, *([a] for a in arr),
                               {dev: alias}, np.float32(0), group=i, **com)

    emit(out, kernel="K20", chunks=nchunks,
         device_epoch_ms=cs.time_ms(epoch, reps=3, warmup=1),
         epoch_profile=cs.profile_call(torch, epoch, top=16))


# tag -> (source, [launch functions swapped in], [(old, new)]): K4 or K20
# rebuilt with edits that match csrc's text exactly; the switched-off
# builds compute something else and are timed only
K4_V = ("ialspp_solve.cu", ["ialspp_solve"])
K20_V = ("w2v_row_apply.cu", ["w2v_row_apply", "w2v_apply_workspace"])
VARIANTS = {
    "k4_as_is": (*K4_V, []),
    "k4_no_mma": (*K4_V, [("for (int ks = eg; ks * 8 < tl; ks += p.EG)",
                           "for (int ks = eg; ks * 8 < tl && d < 0; "
                           "ks += p.EG)")]),
    "k4_no_gram_cg": (*K4_V, [("for (int blk = 0; blk < nblk; ++blk) {  // gram",
                               "for (int blk = 0; blk < nblk && d < 0; ++blk) {"
                               "  // gram")]),
    "k4_no_short_entries": (*K4_V, [(
        "for (int q = warp; q < n; q += kSWarps) {  // entries",
        "for (int q = warp; q < n && d < 0; q += kSWarps) {  // entries")]),
    "k4_no_short_dense": (*K4_V, [(
        "for (int mt = warp; mt < MT; mt += kSWarps) {  // dense",
        "for (int mt = warp; mt < MT && d < 0; mt += kSWarps) {  // dense")]),
    "k4_no_a_reuse": (*K4_V, [("        if (newa[uu]) {", "        if (true) {")]),
    "k4_gram_b_in_registers": (*K4_V, [(
        "          split_tf32(r0[c] * (ecol[uu][h] ? g0 : w0), bb[0], bs[0]);\n"
        "          split_tf32(r1[c] * (ecol[uu][h] ? g1 : w1), bb[1], bs[1]);",
        "          bb[0] = ab[h]; bs[0] = as[h]; bb[1] = ab[h + 2]; "
        "bs[1] = as[h + 2];")]),
    "k4_gram_two_mma": (*K4_V, [("          mma_tf32(step, ab, bs);\n", "")]),
    "k4_tile_no_dense": (*K4_V, [
        ("        for (int k = 0; k < d; ++k)\n          dense[m] = fmaf(",
         "        for (int k = 0; k < d && d < 0; ++k)\n          dense[m] = fmaf("),
        ("          for (int i = 0; i < bs; ++i)\n            Ap[m] = fmaf(",
         "          for (int i = 0; i < bs && d < 0; ++i)\n            Ap[m] = fmaf(")]),
    "k4_tile_no_sums": (*K4_V, [
        ("if (tid + m * kThreads < bs) data[m] += sum_rows(",
         "if (tid + m * kThreads < bs && d < 0) data[m] += sum_rows("),
        ("if (tid + m * kThreads < bs) acc[m] += sum_rows(",
         "if (tid + m * kThreads < bs && d < 0) acc[m] += sum_rows(")]),
    "k4_tile_no_dots": (*K4_V, [(
        "    for (int l = warp; l < tl; l += kWarps) {\n      const float* f = Fs + l * S + beg;",
        "    for (int l = warp; l < tl && d < 0; l += kWarps) {\n"
        "      const float* f = Fs + l * S + beg;")]),
    "k20_as_is": (*K20_V, []),
    "k20_no_rows": (*K20_V, [(
        "    const int e = rows_sorted(G.ids + s0, m);  // short rows",
        "    if (a.d > 0) continue;\n"
        "    const int e = rows_sorted(G.ids + s0, m);  // short rows")]),
    "k20_no_pieces": (*K20_V, [(
        "for (int q = blockIdx.x * kWarps + warp; q < np; q += gridDim.x * kWarps) {",
        "for (int q = blockIdx.x * kWarps + warp; q < np && d < 0; "
        "q += gridDim.x * kWarps) {")]),
}


def time_variants(cs, bt, K, W, S, torch, out):
    d, P, Q, row_s, col_s, kw_w, halves = k4_setup(cs, K, torch)
    calls = {}
    picked = []
    for half, i, b, table, Bf, FF, item, n_fixed in range_batches(halves,
                                                                  torch):
        picked.append((b.cols.shape[1], half, i, b, table, Bf, FF, item,
                       n_fixed))
    # the tile form's rows of 56, 120 and 304 entries, a Gram batch
    chosen = [min(picked, key=lambda x: abs(x[0] - want))
              for want in (56, 120, 304, 8192)]
    for L, half, i, b, table, Bf, FF, item, n_fixed in chosen:
        calls[f"k4_{half}_{i}_{list(b.cols.shape)}"] = k4_call(
            cs, K, torch, table.clone(), Bf, FF, b, b.lens, item, n_fixed, d)
    updates, lr, cap, _ = k20_inputs(cs, bt, W, S, torch)
    L1, parts = updates["L1"]
    T1 = L1.clone()
    calls["k20_L1"] = lambda: W.row_apply(T1, parts, scale=lr, cap=cap)
    for fn in calls.values():
        fn()
    libs = build_variants(VARIANTS,
                          os.path.join(ROOT, "build", "k4_k20_variants"))
    for tag, lib in libs.items():
        todo = {k: v for k, v in calls.items() if k[:3] == tag[:3]}
        with swapped(lib, VARIANTS[tag][1]):
            for what, call in todo.items():
                emit(out, variant=tag, call=what, ms=cs.time_ms(call),
                     by_kernel_ms=by_kernel(cs, torch, call, top=6))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--skip-k4", action="store_true")
    ap.add_argument("--skip-k20", action="store_true")
    ap.add_argument("--sweep", action="store_true",
                    help="the K4 epoch's batches per class bound (SWEEP)")
    ap.add_argument("--variants", action="store_true",
                    help="K4 and K20 rebuilt with parts changed (VARIANTS)")
    args = parse(ap)
    cs, out = start(args, "k4_k20_bench")
    import torch

    import buffalo_tpu_torch as bt
    import buffalo_tpu_torch.ops.als_kernels as K
    import buffalo_tpu_torch.ops.sgd_kernels as S
    import buffalo_tpu_torch.ops.w2v_kernels as W
    from buffalo_tpu_torch.ops import _build

    bt.set_log_level(1)
    st = time.perf_counter()
    _build.build_all()
    emit(out, build_seconds=time.perf_counter() - st)
    os.makedirs(kb.WORK, exist_ok=True)
    if args.variants:
        time_variants(cs, bt, K, W, S, torch, out)
        args.skip_k4 = args.skip_k20 = True
    if not args.skip_k4:
        d, P, Q, halves = k4_cases(cs, K, torch, out)
        if args.sweep:
            k4_sweep(cs, K, torch, out, d, halves)
        del P, Q, halves
        torch.cuda.empty_cache()
    if not args.skip_k20:
        k20_cases(cs, bt, W, S, torch, out)
    finish(out, "k4_k20_bench", args.tag)


if __name__ == "__main__":
    main()
