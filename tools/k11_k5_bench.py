"""K11 (WARP's violator search) and K5 (fused score + top-k) at
``chip_smoke.py``'s shapes, on one card: event and CUPTI milliseconds per
launch beside the bounds.

    python3 tools/k11_k5_bench.py [--tree DIR] [--tag NAME] [--skip-k11]
        [--skip-k5] [--variants parent|change|splits]

``--tree DIR`` runs the kernels of another checkout of the repository
(e.g. a parent commit unpacked with ``git archive`` into a git-ignored
directory): its ``buffalo_tpu_torch`` is imported in place of this one's,
so two trees are compared by running the script once per tree in one
chip call (parent, change, change, parent).  The measuring helpers are
this tree's ``chip_smoke.py``.

K11: WARP with ``chip_smoke.warp_opt``'s defaults (d = 64, lazy probes)
trained ``chip_smoke.WARP_EPOCHS`` epochs on the ML-20M synthetic
(``tools/k13_k21_bench.py``'s copy in ``build/k13_k21_bench/``); the
trained tables go to ``build/k11_k5_bench/warp.npz`` on the first run of
a call and later runs start from them, so every tree searches the same
chunk: ``chip_smoke.warp_inputs``' middle chunk (32,768 positives) at
K = 16 and K = 64, lazy and all, dot and l2 at K = 16, and shard 1 of 4
at its slot offset.  Each case prints a digest of its outputs (the trees
must agree bit for bit), event and CUPTI ms and the bounds (bytes, and
the float64 operations of the scores the choices need).  Then one
resident WARP epoch by events and by kernel.

K5: the brunch call (10,000 x 505,840 x 100, seed 21, k = 10; float32
and bfloat16 queries), ML-20M's shape (10,000 x 26,744 x 40 random
rows, k = 10, and k = 100, 1,000 for the other list lengths), the
k-means assignment chunk (65,536 of the brunch table's unit rows against
711 of them, k = 1) and 5M x 64 on 2,048 queries: the form and splits,
event and CUPTI ms, the FP32 and 3xTF32 bounds, the largest score
error against the plain version on the first queries; then the brunch
``batch_topn`` host wall, first and warm.

``--variants parent`` times the parent's K11 (run with ``--tree``) as it
is and rebuilt with the user row staged as double ("a"), ui computed once
per slot ("b"), and both; ``--variants change`` times this tree's K11
rebuilt at other lane widths (``kMaxLanes`` in ``csrc/warp_search.cu``)
and K5 in its other form where both take the call; ``--variants splits``
times K5's tensor-core form on the calls it takes at the splits of its
own rule (``retrieval_kernels.tc_splits``) and of the FFMA form's
(``_k5_splits``), in the order own, FFMA's, FFMA's, own.

One JSON line per case on stdout, all of them in
``chiprun_out/k11_k5_bench_<tag>.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import os
import time

import numpy as np
from bench_common import (ROOT, build_variants, emit, finish, parse, start,
                          swapped)

import k13_k21_bench as kb

WORK = os.path.join(ROOT, "build", "k11_k5_bench")


# ------------------------------------------------------------------ K11
def warp_model(cs, bt, W, S, torch):
    """The trained WARP (its tables from WORK/warp.npz when a run of this
    call already trained them)."""
    data = kb.ml20m_data(cs)
    opt = cs.warp_opt(bt)
    path = os.path.join(WORK, "warp.npz")
    if os.path.isfile(path):
        model = bt.WARP(opt, data=data)
        np.random.seed(0)
        model.initialize()
        z = np.load(path)
        model.P, model.Q = z["P"], z["Q"]
        return model, int(z["K"])
    model = cs.warp_train(bt, W, S, torch, data, opt)[0]
    K = int(model.iteration_candidates[-1])
    np.savez(path, P=model.P, Q=model.Q, K=K)
    return model, K


def digest(torch, outs, counts):
    h = hashlib.sha256()
    for t in (*outs, counts):
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def k11_bounds(cs, W, torch, users, pos, cand_fn, neg, any_v, K, d):
    """(bytes bound, FP64 bound) in ms: the chunk's ids, probes and
    outputs and each distinct row read once; 2 d float64 operations per
    score the choices need (chip_smoke.warp_kernels' count)."""
    N = users.shape[0]
    cand = cand_fn()
    first = torch.argmax((cand == neg[:, None]).int(), 1) + 1
    upto = torch.where(any_v, first, torch.full_like(first, K))
    need = int(upto.sum())
    walked = torch.arange(K, device=cand.device)[None, :] < upto[:, None]
    n_u = int(torch.unique(users).numel())
    n_i = int(torch.unique(torch.cat([pos, cand[walked]])).numel())
    nbytes = N * (8 + 16 + 13 + 4) + 4 * d * (n_u + n_i)
    return (1e3 * nbytes / cs.PEAK_BYTES_S,
            1e3 * 2 * d * (need + N) / cs.PEAK_FP64_S, need)


def k11_cases(cs, bt, W, S, torch, out, variants=None):
    model, K_model = warp_model(cs, bt, W, S, torch)
    users_c, items_c, nnz, indptr, bloom, log2, P0, Q0 = cs.warp_inputs(
        S, torch, model)
    c = users_c.shape[0] // 2
    users, pos = users_c[c].contiguous(), items_c[c].contiguous()
    N, d, I = users.shape[0], P0.shape[1], Q0.shape[0]
    o = model.opt
    dev = P0.device
    base = dict(num_items=I, seed=int(o.random_seed), epoch=cs.WARP_EPOCHS,
                chunk=c, n_valid=N, score_func=o.score_func,
                threshold=float(o.threshold), indptr=indptr, bloom=bloom,
                bloom_log2=log2)
    shard = N // 4  # shard 1 of 4: its slots at their global offset
    cases = {f"K{k}_{p}": (users, pos, dict(base, num_candidates=k, probe=p))
             for k in (16, 64) for p in ("lazy", "all")}
    cases["K16_lazy_l2"] = (users, pos, dict(base, num_candidates=16,
                                             probe="lazy", score_func="l2"))
    cases["K16_lazy_shard1of4"] = (
        users[shard:2 * shard].contiguous(), pos[shard:2 * shard].contiguous(),
        dict(base, num_candidates=16, probe="lazy", n_valid=shard,
             slot_offset=shard))
    emit(out, kernel="K11", chunk=c, slots=N, d=d, trained_K=K_model)
    fns = {}
    for name, (u, p, kw) in cases.items():
        counts = torch.zeros(1, dtype=torch.int32, device=dev)
        got = W.warp_search(u, p, P0, Q0, counts=counts, **kw)
        torch.cuda.synchronize()

        def fn(u=u, p=p, kw=kw):
            return W.warp_search(u, p, P0, Q0, **kw)
        fns[name] = fn
        if variants is not None:
            continue
        k = kw["num_candidates"]
        t_b, t_o, need = k11_bounds(
            cs, W, torch, u, p, lambda u=u, kw=kw, k=k: W.warp_candidates(
                u.shape[0], k, I, seed=kw["seed"], epoch=kw["epoch"],
                chunk=c, device=dev, slot_offset=kw.get("slot_offset", 0)),
            got[0], got[2], k, d)
        emit(out, kernel="K11", case=name, slots=int(u.shape[0]),
             digest=digest(torch, got, counts), found=int(counts[0]),
             candidates_needed=need, ms=cs.time_ms(fn),
             device_ms=cs.trace_ms(fn, "search_kernel"),
             bound_bytes_ms=t_b, bound_fp64_ms=t_o)
    if variants is not None:
        return fns
    # one resident epoch, as warp_path profiles it
    Pc, Qc = P0.clone(), Q0.clone()

    def epoch():
        W.warp_epoch(
            cs.one_shard(dev), {dev: (Pc, Qc)}, {dev: W.new_opt_state(Pc, Qc)},
            [users_c], [items_c], cs.WARP_EPOCHS, indptr={dev: indptr},
            bloom={dev: bloom}, seed=int(o.random_seed),
            optimizer=o.optimizer, num_items=I, num_candidates=K_model,
            score_func=o.score_func, threshold=float(o.threshold),
            reg_u=o.reg_u, reg_i=o.reg_i, reg_j=o.reg_j, update_i=o.update_i,
            update_j=o.update_j,
            per_coordinate_normalize=o.per_coordinate_normalize, lr=o.lr,
            beta1=o.beta1, beta2=o.beta2, num_valid=nnz, bloom_log2=log2,
            probe=o.probe_mode)
    emit(out, kernel="K11", epoch_K=K_model,
         epoch_ms=cs.time_ms(epoch, reps=3, warmup=1),
         epoch_profile=cs.profile_call(torch, epoch, top=12))
    return fns


# ------------------------------------------------------------------- K5
def k5_shape(R, B, N, d, k, dtype, dev):
    """(form, splits) the tree's wrapper takes for the call."""
    if hasattr(R, "score_topk_shape"):
        return R.score_topk_shape(B, N, d, k, dtype, dev)
    return "ffma", R._k5_splits(B, N, k, dev)


def k5_calls(cs, torch, dev):
    """name -> (p, Q, k, Qb, queries checked against the plain version)."""
    rng = np.random.default_rng(21)
    table, queries = cs.brunch_tables(rng, cs.BRUNCH_ITEMS, cs.BRUNCH_D,
                                      cs.BRUNCH_QUERIES)
    Q = torch.from_numpy(table).to(dev)
    p = torch.from_numpy(queries).to(dev)
    unit = cs.ivf_unit(table)
    cells = np.random.default_rng(3).choice(len(unit), cs.BRUNCH_CELLS,
                                            replace=False)
    ml_t, ml_q = cs.brunch_tables(np.random.default_rng(40),
                                  cs.ML20M_ITEMS, cs.D, 10_000)
    Qm, pm = (torch.from_numpy(a).to(dev) for a in (ml_t, ml_q))
    calls = {
        "brunch_k10": (p, Q, 10, None, 256),
        "brunch_k10_bf16": (p.to(torch.bfloat16), Q, 10, None, 256),
        "ml20m_k10": (pm, Qm, 10, None, 1024),
        "ml20m_k100": (pm, Qm, 100, None, 1024),
        "ml20m_k1000": (pm, Qm, 1000, None, 256),
        "kmeans_chunk_k1": (
            torch.from_numpy(np.ascontiguousarray(unit[:1 << 16])).to(dev),
            torch.from_numpy(np.ascontiguousarray(unit[cells])).to(dev), 1,
            None, 4096),
    }
    big, bq = cs.brunch_tables(rng, cs.BIG_ITEMS, cs.BIG_D, cs.BIG_QUERIES)
    calls["5m_k10"] = (torch.from_numpy(bq).to(dev),
                       torch.from_numpy(big).to(dev), 10, None, 64)
    return calls, (queries, table)


def k5_cases(cs, R, torch, out, dev, variants=False):
    calls, (queries, table) = k5_calls(cs, torch, dev)
    for name, (p, Q, k, Qb, nchk) in calls.items():
        B, d = p.shape
        N = Q.shape[0]
        form, S = k5_shape(R, B, N, d, k, p.dtype, dev)
        forms = [form]
        if variants:
            if not hasattr(R, "score_topk_shape"):
                continue
            tc = k <= R.TC_MAX_K and d <= R.TC_MAX_D
            forms = [f for f in ("tc", "ffma") if f != form
                     and (tc or f == "ffma")]
        for f in forms:
            with forced_form(R, f):
                fn = (lambda: R.score_topk(p, Q, k, Qb))
                got = R.score_topk(p[:nchk], Q, k, Qb)
                err, ties = cs.kernel_topk_check(
                    got, R.score_topk_plain(p[:nchk], Q, k, Qb),
                    f"K5 {name}")
                nbytes, flops = cs.k5_work(B, N, d, k, Qb is not None,
                                           p.element_size())
                dev_ms, ops = cs.trace_stats(fn, "score_topk")
                emit(out, kernel="K5", call=name, B=B, N=N, d=d, k=k,
                     dtype=str(p.dtype).split(".")[-1], form=f,
                     splits=k5_shape(R, B, N, d, k, p.dtype, dev)[1],
                     ms=cs.time_ms(fn, reps=10, warmup=2), device_ms=dev_ms,
                     stream_ops_per_call=ops,
                     bound_ms=cs.bound_ms(nbytes, flops)[0],
                     bound_tf32_ms=cs.bound_tf32_ms(
                         nbytes, flops * (2 / 3 if p.dtype == torch.bfloat16
                                          else 1)),
                     max_abs_err=err, ids_differing_at_ties=ties,
                     checked_queries=min(nchk, B))
    if variants:
        return
    from buffalo_tpu_torch.ops.topk import batch_topn

    first, _ = cs.wall_ms(lambda: batch_topn(queries, table, cs.TOPK,
                                             device=dev))
    warm = [cs.wall_ms(lambda: batch_topn(queries, table, cs.TOPK,
                                          device=dev))[0] for _ in range(3)]
    emit(out, kernel="K5", batch_topn="brunch", queries=len(queries),
         host_ms_first=first, host_ms_warm=warm)


@contextlib.contextmanager
def forced_shape(R, form, splits):
    """K5's wrapper launching every call in ``form`` at ``splits`` inside
    the block."""
    real = R.score_topk_shape
    R.score_topk_shape = lambda *a: (form, splits)
    try:
        yield
    finally:
        R.score_topk_shape = real


def k5_split_rules(cs, R, torch, out, dev):
    """The tensor-core form at its own rule's splits and at the FFMA
    form's rule's, on each call it takes, timed own, FFMA's, FFMA's, own."""
    calls, _ = k5_calls(cs, torch, dev)
    for name in ("brunch_k10", "brunch_k10_bf16", "ml20m_k10", "5m_k10"):
        p, Q, k, Qb, _ = calls[name]
        (B, d), N = p.shape, Q.shape[0]
        form, own = R.score_topk_shape(B, N, d, k, p.dtype, dev)
        splits = {"tc_splits": own, "k5_splits": R._k5_splits(B, N, k, dev)}
        for rule in ("tc_splits", "k5_splits", "k5_splits", "tc_splits"):
            with forced_shape(R, form, splits[rule]):
                def fn():
                    return R.score_topk(p, Q, k, Qb)
                dev_ms, _ = cs.trace_stats(fn, "score_topk")
                emit(out, kernel="K5", call=name, form=form, rule=rule,
                     splits=splits[rule], ms=cs.time_ms(fn, reps=10, warmup=2),
                     device_ms=dev_ms)


@contextlib.contextmanager
def forced_form(R, form):
    """K5's wrapper routing every call to ``form`` inside the block (a
    tree without forms is left as it is)."""
    real = getattr(R, "score_topk_form", None)
    if real is not None:
        R.score_topk_form = lambda *a: form
    try:
        yield
    finally:
        if real is not None:
            R.score_topk_form = real


# ------------------------------------------------------------- variants
# tag -> (source, [launch functions swapped in], [(old, new)]): the parent's
# K11 rebuilt with edits that match its csrc/warp_search.cu exactly
K11_V = ("warp_search.cu", ["warp_search"])
_A = [
    ("__device__ __forceinline__ float row_score(const float* p, ",
     "template <class PT>\n__device__ __forceinline__ float row_score("
     "const PT* p, "),
    ("__shared__ float ps[kWarps][kWide ? 1 : kMaxD];",
     "__shared__ double ps[kWarps][kWide ? 1 : kMaxD];"),
    ("    const float* p = P + (int64_t)u * d;\n"
     "    if (!kWide) {\n"
     "      float* pw = ps[warp];\n"
     "      for (int c = lane; c < d; c += 32) pw[c] = p[c];\n"
     "      __syncwarp();\n"
     "      p = pw;\n"
     "    }\n",
     "    const float* pg = P + (int64_t)u * d;\n"
     "    double* p = ps[warp];\n"
     "    for (int c = lane; c < d; c += 32) p[c] = pg[c];\n"
     "    __syncwarp();\n"),
]
_B = [
    ("  const int slot = blockIdx.x * kWarps + warp;\n  const int K = draw.K",
     "  const int slot = blockIdx.x * kWarps + warp;\n"
     "  __shared__ float uis[kWarps];\n"
     "  if (threadIdx.x < kWarps) {\n"
     "    const int s = blockIdx.x * kWarps + threadIdx.x;\n"
     "    if (s < N) uis[threadIdx.x] = row_score(P + (int64_t)users[s] * d,"
     " Q + (int64_t)pos[s] * d, d, l2, vec);\n"
     "  }\n"
     "  __syncthreads();\n"
     "  const int K = draw.K"),
    ("    const float ui = row_score(p, Q + (int64_t)pos[slot] * d, d, l2, "
     "vec);", "    const float ui = uis[warp];"),
]
PARENT_VARIANTS = {"k11_as_is": (*K11_V, []), "k11_a_p_double": (*K11_V, _A),
                   "k11_b_ui_once": (*K11_V, _B),
                   "k11_ab": (*K11_V, _A + _B)}
# this tree's K11 rebuilt with its lanes per slot, its tile's chunk or its
# load batch changed
K11_VARIANTS = {
    "k11_as_is": (*K11_V, []),
    **{f"k11_max_lanes_{n}": (*K11_V, [("constexpr int kMaxLanes = 16;",
                                        f"constexpr int kMaxLanes = {n};")])
       for n in (4, 8, 32)},
    "k11_batch8": (*K11_V, [("kRowLd = kDC + 4, kBatch = 4;",
                             "kRowLd = kDC + 4, kBatch = 8;")]),
    "k11_dc16": (*K11_V, [("constexpr int kDC = 32, kRowLd", "constexpr int kDC = 16, kRowLd"),
                          ("? e >> 3 : e / n4", "? e >> 2 : e / n4")]),
    "k11_dc64": (*K11_V, [("constexpr int kDC = 32, kRowLd", "constexpr int kDC = 64, kRowLd"),
                          ("? e >> 3 : e / n4", "? e >> 4 : e / n4")]),
}
# this tree's K5 tensor-core form rebuilt with one part changed (timed
# only: the switched-off builds compute something else)
K5_V = ("score_topk.cu", ["score_topk"])
K5_VARIANTS = {
    "k5_as_is": (*K5_V, []),
    "k5_kc32": (*K5_V, [("constexpr int KC = 16;", "constexpr int KC = 32;")]),
    "k5_stages2": (*K5_V, [("constexpr int STAGES = 3;",
                            "constexpr int STAGES = 2;")]),
    "k5_no_select": (*K5_V, [("if (st % nch != nch - 1) continue;",
                              "if (st % nch != nch - 1 || d > 0) continue;")]),
    "k5_two_products": (*K5_V, [("          mma_tf32(sum[nt], ab, bs);\n",
                                 "")]),
}
K5_VARIANT_CALLS = ("brunch_k10", "ml20m_k10", "kmeans_chunk_k1", "5m_k10")
# the k-means chunk's shape over more cells: where the forms cross
KMEANS_CELLS = (711, 1422, 2844, 5688, 11376)


def time_variants(cs, bt, W, S, R, torch, out, which, dev):
    fns = k11_cases(cs, bt, W, S, torch, out, variants=True)
    if which == "parent":
        libs = build_variants(PARENT_VARIANTS,
                              os.path.join(ROOT, "build", "k11_variants"))
        for tag, lib in libs.items():
            with swapped(lib, PARENT_VARIANTS[tag][1]):
                for what, fn in fns.items():
                    emit(out, variant=tag, call=what, ms=cs.time_ms(fn),
                         device_ms=cs.trace_ms(fn, "search_kernel"))
        return
    libs = build_variants(K11_VARIANTS,
                          os.path.join(ROOT, "build", "k11_variants"))
    for tag, lib in libs.items():
        with swapped(lib, K11_VARIANTS[tag][1]):
            for what, fn in fns.items():
                emit(out, variant=tag, call=what, ms=cs.time_ms(fn),
                     device_ms=cs.trace_ms(fn, "search_kernel"))
    k5_cases(cs, R, torch, out, dev, variants=True)
    calls, (_, table) = k5_calls(cs, torch, dev)
    unit = torch.from_numpy(np.ascontiguousarray(
        cs.ivf_unit(table[:1 << 17]))).to(dev)
    for cells in KMEANS_CELLS:
        cent = unit[-cells:]
        for f in ("tc", "ffma"):
            with forced_form(R, f):
                emit(out, kernel="K5", kmeans_cells=cells, queries=1 << 14,
                     form=f, ms=cs.time_ms(
                         lambda: R.score_topk(unit[:1 << 14], cent, 1),
                         reps=10, warmup=2))
    libs = build_variants(K5_VARIANTS,
                          os.path.join(ROOT, "build", "k5_variants"))
    for tag, lib in libs.items():
        with swapped(lib, K5_VARIANTS[tag][1]):
            for what in K5_VARIANT_CALLS:
                p, Q, k, Qb, _ = calls[what]
                fn = (lambda: R.score_topk(p, Q, k, Qb))
                emit(out, variant=tag, call=what,
                     ms=cs.time_ms(fn, reps=5, warmup=1))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--skip-k11", action="store_true")
    ap.add_argument("--skip-k5", action="store_true")
    ap.add_argument("--variants", choices=("parent", "change", "splits"),
                    default=None,
                    help="K11 rebuilt with parts changed (the parent's) or "
                         "at other lane widths, and K5's other form; or K5's "
                         "tensor-core form at either rule's splits")
    args = parse(ap)
    cs, out = start(args, "k11_k5_bench")
    import torch

    import buffalo_tpu_torch as bt
    import buffalo_tpu_torch.ops.retrieval_kernels as R
    import buffalo_tpu_torch.ops.sgd_kernels as S
    import buffalo_tpu_torch.ops.warp_kernels as W
    from buffalo_tpu_torch.ops import _build

    bt.set_log_level(1)
    st = time.perf_counter()
    _build.build_all()
    emit(out, build_seconds=time.perf_counter() - st)
    os.makedirs(kb.WORK, exist_ok=True)
    os.makedirs(WORK, exist_ok=True)
    dev = torch.device("cuda")
    if args.variants == "splits":
        k5_split_rules(cs, R, torch, out, dev)
    elif args.variants:
        time_variants(cs, bt, W, S, R, torch, out, args.variants, dev)
    else:
        if not args.skip_k11:
            k11_cases(cs, bt, W, S, torch, out)
            torch.cuda.empty_cache()
        if not args.skip_k5:
            k5_cases(cs, R, torch, out, dev)
    finish(out, "k11_k5_bench", args.tag)


if __name__ == "__main__":
    main()
