"""K9 (the BPR chunk update) and K22 (the sharded top-k merge) at
``chip_smoke.py``'s shapes, on one card: event and CUPTI milliseconds,
stream operations per call, bound, library call.

    python3 tools/k9_k22_bench.py [--tree DIR] [--tag NAME]

``--tree DIR`` runs the kernels of another checkout of the repository
(e.g. a parent commit unpacked with ``git archive`` into a git-ignored
directory): its ``buffalo_tpu_torch`` is imported in place of this one's,
so two trees are compared by running the script once per tree in one
chip call (parent, change, change, parent).  The measuring helpers are
this tree's ``chip_smoke.py``.

K9: a 524,288-slot chunk of a synthetic ML-20M (``chip_smoke.synth_ml20m``:
138,493 x 26,744, users in CSR order, uniform negatives from numpy seed 0,
random N(0, 0.1) factors) at d = 40 and d = 300 (``--d``): the sgd step
(``chunk_update``, cap 0.1) and the accumulation (``chunk_accumulate``)
on the whole chunk, the delta path (``chunk_delta``) and its bias
launch (``chunk_bias_neg_delta``) on a quarter of it (a 4-shard mesh's
shard 1); each with the users presorted (a resident chunk) and, where the
tree takes ``users_sorted``, grouped (a streamed chunk); with each call's
device time by kernel.  K22: 10,000 queries x 4 lists of 10 at k = 10
(brunch) and 1,000 x 4 x 2,000 at k = 2,000 (``chip_smoke.merge_lists``:
random scores, keys sorted as the contract asks), in each form the tree
has; with ``--sweep``, both forms over k (kl = k) at D = 3, 4 and 8 for
1,000 and 10,000 queries, and at D = 16 and 33 (the tree form where it
fits).

``--variants`` instead times K9's sgd step and delta path (d = 40, users
presorted) and K22's tree form (1,000 x 4 x 2,000) by kernel as they
are and rebuilt
with one part changed or switched off (``VARIANTS``: source edits of
``csrc/bpr_update.cu`` and ``csrc/sharded_topk_merge.cu`` that match their
text and fail loudly when it changes), each build swapped in for the
wrapper's C launch functions (``tools/bench_common.py``); the
switched-off builds compute something else and are timed only.

One JSON line per case on stdout, all of them in
``chiprun_out/k9_k22_bench_<tag>.json``.
"""
from __future__ import annotations

import argparse
import inspect
import os

import numpy as np
from bench_common import (ROOT, build_variants, by_kernel, emit, finish,
                          parse, start, swapped)

CAP = 0.1
K9_BATCH, K9_SHARDS = 524_288, 4
K22_SHAPES = ((10_000, 4, 10, 10), (1_000, 4, 2_000, 2_000))
SWEEP_K = (10, 16, 32, 48, 64, 96, 128, 256, 512, 2_000)


# tag -> (source, [launch functions swapped in], [(old, new)]): K9 or K22
# rebuilt with edits that match csrc's text exactly (a K9 build sizes its
# own workspace)
K9_V = ("bpr_update.cu", ["bpr_update", "bpr_delta", "bpr_workspace"])
K22_V = ("sharded_topk_merge.cu", ["sharded_topk_merge_as"])
VARIANTS = {
    "k9_as_is": (*K9_V, []),
    **{f"k9_run_piece_{n}": (*K9_V, [(
        "constexpr int kPiece = 256, kRunPiece = 64;",
        f"constexpr int kPiece = 256, kRunPiece = {n};")]) for n in (32, 128)},
    **{f"k9_piece_{n}": (*K9_V, [(
        "constexpr int kPiece = 256, kRunPiece = 64;",
        f"constexpr int kPiece = {n}, kRunPiece = 64;")]) for n in (128, 512)},
    "k9_no_row_loads": (*K9_V, [(
        "if (cf[i] != 0.f && c < d) v[i][h] = kDiff ? ra[i][c] - rb[i][c] : "
        "ra[i][c];", "if (cf[i] != 0.f && c < d) v[i][h] = 1.f;")]),
    "k22_as_is": (*K22_V, []),
    "k22_staging_only": (*K22_V, [("  __syncthreads();\n  int m = D;",
                                   "  __syncthreads();\n  if (D > 0) return;\n"
                                   "  int m = D;")]),
    **{f"k22_run_{n}": (*K22_V, [("constexpr int kMergeRun = 8; ",
                                  f"constexpr int kMergeRun = {n}; ")])
       for n in (4, 16)},
}


def time_variants(cs, S, R, torch, dev, out):
    """K9's sgd step and delta path (d = 40, presorted) and K22's tree form
    (1,000 x 4 x 2,000) by kernel for each build of ``VARIANTS``."""
    users, pos, neg = k9_chunk(cs, torch, dev)
    P0, Q0, Qb0 = tables(torch, dev, 40)
    t = [P0.clone(), Q0.clone(), Qb0.clone()]

    def step():
        S.chunk_update(*t, users, pos, neg, n_valid=users.shape[0], lr=0.05,
                       reg_u=0.025, reg_i=0.025, reg_j=0.025, reg_b=0.025,
                       max_step_norm=CAP, num_negatives=1, use_bias=True,
                       update_i=True, update_j=True, users_sorted=True)

    n_loc = K9_BATCH // K9_SHARDS
    su, sp, sn = (x[n_loc:2 * n_loc].contiguous() for x in (users, pos, neg))
    dl = [torch.zeros_like(x) for x in (P0, Q0, Qb0)]

    def delta():
        S.chunk_delta(P0, Q0, Qb0, *dl, su, sp, sn, n_valid=n_loc, lr=0.05,
                      reg_u=0.025, reg_i=0.025, reg_j=0.025, reg_b=0.025,
                      num_negatives=1, use_bias=True, update_i=True,
                      update_j=True, users_sorted=True)

    vals, idx = cs.merge_lists(R, torch, 1_000, 4, 2_000)

    def merge():
        R.sharded_topk_merge(vals, idx, 2_000, form="tree")

    step()
    delta()
    merge()
    S._kernel("bpr_workspace")  # loaded, so that it can be swapped
    libs = build_variants(VARIANTS,
                          os.path.join(ROOT, "build", "k9_k22_variants"))
    for tag, lib in libs.items():
        k9 = tag.startswith("k9")
        S._WORKSPACE_SIZES.clear()
        try:
            with swapped(lib, VARIANTS[tag][1]):
                calls = ({"step": step, "delta": delta} if k9
                         else {"merge": merge})
                for what, call in calls.items():
                    emit(out, variant=tag, call=what, ms=cs.time_ms(call),
                         by_kernel_ms=by_kernel(cs, torch, call))
        finally:
            S._WORKSPACE_SIZES.clear()


def k9_chunk(cs, torch, dev):
    """(users, positives, negatives) of chunk nchunks // 2, U, I."""
    cache = os.path.join(ROOT, "build", "k9_bench_chunk.npz")
    if not os.path.isfile(cache):
        groups, _ = cs.synth_ml20m(cs.ML20M_USERS, cs.ML20M_ITEMS,
                                   cs.ML20M_NNZ)
        rw = groups["rowwise"]
        users = np.repeat(np.arange(cs.ML20M_USERS, dtype=np.int32),
                          np.diff(rw["indptr"]))
        c = (len(users) // K9_BATCH) // 2
        sl = slice(c * K9_BATCH, (c + 1) * K9_BATCH)
        neg = np.random.default_rng(0).integers(
            0, cs.ML20M_ITEMS, K9_BATCH).astype(np.int32)
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        np.savez(cache, users=users[sl], pos=rw["key"][sl], neg=neg)
    z = np.load(cache)
    return [torch.from_numpy(z[k]).to(dev) for k in ("users", "pos", "neg")]


def tables(torch, dev, d):
    g = torch.Generator(device="cpu").manual_seed(d)
    P = 0.1 * torch.randn(138_493, d, generator=g)
    Q = 0.1 * torch.randn(26_744, d, generator=g)
    Qb = 0.1 * torch.randn(26_744, generator=g)
    return P.to(dev), Q.to(dev), Qb.to(dev)


def k9_cases(cs, S, torch, dev, out, widths):
    users, pos, neg = k9_chunk(cs, torch, dev)
    I = 26_744
    sig = inspect.signature(S.chunk_update).parameters
    modes = (True, False) if "users_sorted" in sig else (None,)
    main = "epilogue_kernel" if "users_sorted" in sig else "user_rows"
    n_loc = K9_BATCH // K9_SHARDS
    su, sp, sn = (t[n_loc:2 * n_loc].contiguous() for t in (users, pos, neg))
    for d in widths:
        P0, Q0, Qb0 = tables(torch, dev, d)
        lr, reg = 0.05, dict(reg_u=0.025, reg_i=0.025, reg_j=0.025,
                             reg_b=0.025)
        rows = dict(num_negatives=1, use_bias=True, update_i=True,
                    update_j=True)
        n_u = int(torch.unique(users).numel())
        n_i = int(torch.unique(torch.cat([pos, neg])).numel())
        N = users.shape[0]
        # sgd and accumulate: ids read; touched rows of P, Q (and Qb) read
        # once; the step's rows written, or the gradients and counts read
        # and written
        ops = 8 * d * N + 2 * d * N + 6 * d * (n_u + n_i)
        step_bms, step_by = cs.bound_ms(
            12 * N + 8 * d * (n_u + n_i) + 8 * n_i, ops)
        acc_bms, acc_by = cs.bound_ms(
            12 * N + 12 * d * (n_u + n_i) + 8 * (n_u + n_i) + 12 * n_i, ops)
        t = [P0.clone(), Q0.clone(), Qb0.clone()]
        acc = S.new_accumulators(P0, Q0, Qb0)
        _, _, _, _, safe, mask, p_r, qi, qj, logit = S._forward(
            P0, Q0, Qb0, users, pos, neg, 1, N, True)
        rows_p = lr * (logit[:, None] * (qi - qj) - reg["reg_u"] * p_r)
        rows_q = torch.cat([lr * (logit[:, None] * p_r - reg["reg_i"] * qi),
                            lr * (-logit[:, None] * p_r - reg["reg_j"] * qj)])
        g_p = logit[:, None] * (qi - qj)
        g_q = torch.cat([logit[:, None] * p_r, -logit[:, None] * p_r])
        idx_u, idx_q = users.long(), torch.cat([pos, neg]).long()
        lib = [torch.zeros_like(P0), torch.zeros_like(Q0)]

        def lib_step():
            t[0] += S.clip_row_norm(torch.zeros_like(P0).index_add_(
                0, idx_u, rows_p), CAP)
            t[1] += S.clip_row_norm(torch.zeros_like(Q0).index_add_(
                0, idx_q, rows_q), CAP)

        def lib_acc():
            lib[0].index_add_(0, idx_u, g_p)
            lib[1].index_add_(0, idx_q, g_q)
            torch.bincount(idx_u, minlength=P0.shape[0])
            torch.bincount(idx_q, minlength=Q0.shape[0])

        lib_ms = {"chunk_update": cs.time_ms(lib_step, reps=10, warmup=2),
                  "chunk_accumulate": cs.time_ms(lib_acc, reps=10, warmup=2)}
        for sorted_ in modes:
            extra = {} if sorted_ is None else {"users_sorted": sorted_}
            form = "radix" if sorted_ is None else (
                "presorted" if sorted_ else "grouped")
            fns = {
                "chunk_update": lambda: S.chunk_update(
                    *t, users, pos, neg, n_valid=N, lr=lr,
                    max_step_norm=CAP, **reg, **rows, **extra),
                "chunk_accumulate": lambda: S.chunk_accumulate(
                    P0, Q0, Qb0, *acc, users, pos, neg, n_valid=N,
                    per_coordinate_normalize=True, **rows, **extra)}
            for name, fn in fns.items():
                dev_ms, n_ops = cs.trace_stats(fn, main)
                bms, by = ((step_bms, step_by) if name == "chunk_update"
                           else (acc_bms, acc_by))
                emit(out, kernel="K9", entry=name, d=d, users=form, slots=N,
                     ms=cs.time_ms(fn), device_ms=dev_ms,
                     stream_ops_per_call=n_ops, bound_ms=bms, bound_by=by,
                     library_ms=lib_ms[name], by_kernel_ms=by_kernel(
                         cs, torch, fn))
        # the delta path on shard 1 of a 4-shard chunk
        dl = [torch.zeros_like(x) for x in (P0, Q0, Qb0)]
        n_u = int(torch.unique(su).numel())
        n_i = int(torch.unique(torch.cat([sp, sn])).numel())
        n_n = int(torch.unique(sn).numel())
        bms, by = cs.bound_ms(12 * n_loc + 12 * d * (n_u + n_i) + 12 * n_i,
                              8 * d * n_loc + 2 * d * n_loc
                              + 6 * d * (n_u + n_i))
        _, _, _, _, _, mask, p_r, qi, qj, logit = S._forward(
            P0, Q0, Qb0, su, sp, sn, 1, n_loc, True)
        d_p = lr * (logit[:, None] * (qi - qj) - reg["reg_u"] * p_r)
        d_q = torch.cat([lr * (logit[:, None] * p_r - reg["reg_i"] * qi),
                         lr * (-logit[:, None] * p_r - reg["reg_j"] * qj)])
        i_u, i_q = su.long(), torch.cat([sp, sn]).long()

        def lib_delta():
            dl[0].index_add_(0, i_u, d_p)
            dl[1].index_add_(0, i_q, d_q)

        neg_rows = lr * (-logit - reg["reg_b"] * Qb0[sn.long()])
        delta_lib = cs.time_ms(lib_delta, reps=10, warmup=2)
        neg_lib = cs.time_ms(lambda: dl[2].index_add_(0, sn.long(), neg_rows))
        nbms, nby = cs.bound_ms(8 * n_loc + 12 * n_n, 4 * n_loc)
        for sorted_ in modes:
            extra = {} if sorted_ is None else {"users_sorted": sorted_}
            form = "radix" if sorted_ is None else (
                "presorted" if sorted_ else "grouped")

            def delta():
                return S.chunk_delta(P0, Q0, Qb0, *dl, su, sp, sn,
                                     n_valid=n_loc, lr=lr, **reg, **rows,
                                     **extra)

            dev_ms, n_ops = cs.trace_stats(delta, main)
            emit(out, kernel="K9", entry="chunk_delta", d=d, users=form,
                 slots=n_loc, ms=cs.time_ms(delta), device_ms=dev_ms,
                 stream_ops_per_call=n_ops, bound_ms=bms, bound_by=by,
                 library_ms=delta_lib, by_kernel_ms=by_kernel(cs, torch,
                                                             delta))
            h = delta()

            def bias_neg():
                S.chunk_bias_neg_delta(h, Qb0, dl[2], lr=lr,
                                       reg_b=reg["reg_b"])

            dev_ms, n_ops = cs.trace_stats(bias_neg, "bias_neg")
            emit(out, kernel="K9", entry="chunk_bias_neg_delta", d=d,
                 users=form, slots=n_loc, ms=cs.time_ms(bias_neg),
                 device_ms=dev_ms, stream_ops_per_call=n_ops, bound_ms=nbms,
                 bound_by=nby, library_ms=neg_lib)
        del P0, Q0, Qb0, t, acc, lib, dl
        torch.cuda.empty_cache()


def k22_cases(cs, R, torch, out, sweep):
    forms = ((None,) if "form" not in inspect.signature(
        R.sharded_topk_merge).parameters else (None, 0, 1))
    shapes = list(K22_SHAPES)
    if sweep:
        shapes += [(B, D, k, k) for D in (3, 4, 8) for B in (1_000, 10_000)
                   for k in SWEEP_K if (B, D, k, k) not in K22_SHAPES]
        shapes += [(1_000, D, k, k) for D in (16, 33)
                   for k in (10, 64, 256, 2_000)]
    for B, D, kl, k in shapes:
        vals, idx = cs.merge_lists(R, torch, B, D, kl)
        ref = R.sharded_topk_merge_plain(vals, idx, k)
        flat = vals.reshape(B, -1)
        lib = cs.time_ms(lambda: torch.topk(flat, k, dim=1), reps=5,
                         warmup=1)
        nbytes, _ = cs.k22_bytes(torch, ref[1], D, kl, 2 * kl)
        bms, by = cs.bound_ms(nbytes, 0)
        for form in forms:
            if form == 1 and not R.sharded_topk_merge_tree_fits(D, kl, k):
                continue
            extra = {} if form is None else {"form": ("warp", "tree")[form]}

            def fn():
                return R.sharded_topk_merge(vals, idx, k, **extra)

            got = fn()
            same = bool(torch.equal(got[1], ref[1]) and torch.equal(
                got[0].view(torch.int32), ref[0].view(torch.int32)))
            emit(out, kernel="K22", B=B, D=D, kl=kl, k=k,
                 form="rule" if form is None else ("warp", "tree")[form],
                 bit_equal=same, ms=cs.time_ms(fn),
                 device_ms=cs.trace_stats(fn, "merge")[0], bound_ms=bms,
                 bound_by=by, library_ms=lib)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="both K22 forms over k")
    ap.add_argument("--skip-k9", action="store_true")
    ap.add_argument("--skip-k22", action="store_true")
    ap.add_argument("--variants", action="store_true",
                    help="K9 and K22 rebuilt with parts changed (VARIANTS)")
    ap.add_argument("--d", type=int, nargs="+", default=[40, 300],
                    help="K9's widths")
    args = parse(ap)
    cs, out = start(args, "k9_k22_bench")
    import torch

    import buffalo_tpu_torch.ops.retrieval_kernels as R
    import buffalo_tpu_torch.ops.sgd_kernels as S

    if args.variants:
        time_variants(cs, S, R, torch, torch.device("cuda"), out)
    elif not args.skip_k9:
        k9_cases(cs, S, torch, torch.device("cuda"), out, args.d)
    if not args.skip_k22:
        k22_cases(cs, R, torch, out, args.sweep)
    finish(out, "k9_k22_bench", args.tag)


if __name__ == "__main__":
    main()
