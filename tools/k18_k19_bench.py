"""K18 (CoFactor's closed-form bias) and K19 (the W2V pair step) at
``chip_smoke.py``'s shapes, on one card: event and CUPTI milliseconds per
call beside the bounds, and their busy milliseconds per epoch.

    python3 tools/k18_k19_bench.py [--tree DIR] [--tag NAME] [--skip-k18]
        [--skip-k19] [--widths D ...] [--variants parent|change]

``--tree DIR`` runs the kernels of another checkout of the repository
(e.g. a parent commit unpacked with ``git archive`` into a git-ignored
directory): its ``buffalo_tpu_torch`` is imported in place of this one's,
so two trees are compared by running the script once per tree in one
chip call (parent, change, change, parent).  The measuring helpers are
this tree's ``chip_smoke.py``.

K18: the brunch corpus (``chip_smoke.brunch_corpus``) built through
``Stream`` with ``stream_build``'s settings (matrix, SPPMI windows 5 and
k 10) into ``build/k18_k19_bench/`` once and reused; for each of
``--widths`` (default 32), CFR at that d with the defaults trained 2
epochs (its tables kept in ``cfr_d<d>.npz`` for the later runs of a
call, so every tree reads the same rows).  On item batch 1 (the
largest), item batch 20 (long SPPMI rows), the item segment pair,
context batches 7 and 27 and the context segment batch: K17 and K3 on
the batch's rows, then K18 on the solved rows (event and CUPTI ms, the
bound, its distance from the plain version, repeatable).  Then, at d =
32, one CFR epoch by events and by kernel (CUPTI), and every K18 call of
that epoch replayed on its own: event and CUPTI ms summed by phase and
by launches of fewer and more than 2,048 rows, beside the calls' bounds.

K19: the brunch corpus built as ``stream`` (``w2v_build``), W2V with
``w2v_opt``'s settings (d = 32, 5 negatives) and its initial tables; the
first pair chunk of a host-pair epoch (numpy seed 0; 262,144 pairs):
own draws with and without the loss, the same draws injected, and shard
1 of 4 at its slot offset.  Each case prints a digest of its draws and
keys (the trees must agree bit for bit), its rows' distance from the
plain version, event and CUPTI ms and the bound.  Then one host-pair
epoch by kernel (CUPTI).

``--variants parent`` times the parent's K18 and K19 (run with
``--tree``) as they are and rebuilt with one part changed
(``PARENT_VARIANTS``): K18 (a) its warps split over pieces of 256
entries (timing only: the pieces race on the bias), (b) a warp per row
whose lanes read each entry's row as 16-byte loads (the same sums); K19
(a) the negatives broadcast from registers by shuffles and every row
loaded before the first dot (the same sums, up to 8 negatives).
``--variants change`` times this tree's K18 at other piece sizes
(``cfr_kernels.BIAS_PIECE``), and both kernels rebuilt (``CHANGE_VARIANTS``)
at other lanes an entry (``kMaxLanes`` in ``csrc/cfr_bias.cu``; 1 is a
lane per entry reading its row as 8 float4s) and at other lanes a pair
(``kLaneFloats`` in ``csrc/w2v_pair_step.cu``: 8, 4, 2 and 1 floats a
lane are 4, 8, 16 and 32 lanes at d = 32).

One JSON line per case on stdout, all of them in
``chiprun_out/k18_k19_bench_<tag>.json``.
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

WORK = os.path.join(ROOT, "build", "k18_k19_bench")
CFR_BENCH_EPOCHS = 2
# the K18 cases: (phase, index among the phase's entries); "segment" is
# the phase's first segment entry
K18_CASES = (("item", 1), ("item", 20), ("item", "segment"),
             ("context", 7), ("context", 27), ("context", "segment"))
SMALL_LAUNCH_ROWS = 2048


def stream_data(cs, bt, kind):
    """The brunch corpus built as ``kind`` ("matrix" with SPPMI, or
    "stream"), reused when a run of this call built it."""
    text = os.path.join(WORK, "brunch.txt")
    if not os.path.isfile(text):
        cs.brunch_corpus(text + ".tmp")
        os.replace(text + ".tmp", text)
    sopt = bt.StreamOptions().get_default_option()
    sopt.input.main = text
    sopt.data.path = os.path.join(WORK, f"brunch_{kind}.bfo")
    sopt.data.tmp_dir = os.path.join(WORK, "tmp")
    sopt.data.internal_data_type = kind
    sopt.data.validation = {}
    sopt.data.use_cache = True
    if kind == "matrix":
        sopt.data.sppmi = {"windows": 5, "k": 10}
    data = bt.data.load(sopt)
    data.create()
    return data


# ------------------------------------------------------------------ K18
def cfr_model(cs, bt, K, CK, torch, d):
    """(the CFR model at ``d`` trained, its staged batches, its tables on
    the card (U, I, C, Ib, Cb))."""
    from buffalo_tpu_torch.models.cfr import _stage_entry

    data = stream_data(cs, bt, "matrix")
    opt = bt.CFROption().get_default_option()
    opt.update(d=d, num_iters=CFR_BENCH_EPOCHS, device="cuda",
               validation={})
    model = bt.CFR(opt, data=data)
    np.random.seed(0)
    model.initialize()
    path = os.path.join(WORK, f"cfr_d{d}.npz")
    if os.path.isfile(path):
        z = np.load(path)
        for t in ("U", "I", "C", "Ib", "Cb"):
            setattr(model, t, z[t])
    else:
        model.train()
        np.savez(path, **{t: getattr(model, t)
                          for t in ("U", "I", "C", "Ib", "Cb")})
    host = model._build_batches()
    staged = {k: [_stage_entry(e, model.device) for e in v]
              for k, v in host.items()}
    return model, staged, cs.cfr_tables(torch, model)


def k18_case(cs, CK, K, torch, model, staged, tabs, phase, which):
    """(the K18 call on the case's solved rows, its explicit side, rows,
    X, the other table's bias, the bias written, a description)."""
    from buffalo_tpu_torch.data.batching import StagedSegmentBatch
    from buffalo_tpu_torch.ops.als_kernels import gramian
    from buffalo_tpu_torch.ops.cfr_kernels import Side

    U, I, C, Ib, Cb = tabs
    o = model.opt
    entries = staged[phase]
    if which == "segment":
        which = next(i for i, e in enumerate(entries)
                     if isinstance(e, StagedSegmentBatch)
                     or (isinstance(e, tuple) and len(e) == 2))
    e = entries[which]
    if phase == "item":
        if len(e) == 2:
            sb_u, sb_c = e
            rows, imp, exp = sb_u.rows, Side.of(U, sb_u), Side.of(C, sb_c)
        else:
            b, lens_c, cols_c, vals_c = e
            rows, imp = b.rows, Side.of(U, b)
            exp = Side(C, lens_c, cols_c, vals_c)
        X, own, other = I, Ib, Cb
        kw = dict(implicit=imp, explicit=exp, FF=gramian(U), rbias=Ib,
                  cbias=Cb, alpha=float(o.alpha), l=float(o.l),
                  reg=float(o.reg_i))
    else:
        rows, exp = e.rows, Side.of(I, e)
        X, own, other = C, Cb, Ib
        kw = dict(explicit=exp, rbias=Cb, cbias=Ib, reg=float(o.reg_c))
    A, y, _, total = CK.cfr_normal_equations(X, rows, **kw)
    X_new = X.clone()
    K.batched_cg_dense(A, y, X_new, total, rows=rows,
                       cg_iters=int(o.num_cg_max_iters),
                       cg_tol=float(o.cg_tolerance))
    bias = own.clone()
    seg = exp.chunk_ptr is not None
    desc = dict(phase=phase, index=which, segment=seg,
                rows=int(rows.shape[0]),
                width=int(exp.cols.shape[1]),
                chunks=int(exp.cols.shape[0]) if seg else None,
                entries=int((exp.chunk_lens if seg else exp.lens).sum()))

    def fn():
        CK.cfr_bias(X_new, rows, total, explicit=exp, bias=bias,
                    cbias=other)
    return fn, dict(X=X_new, rows=rows, total=total, exp=exp, own=own,
                    other=other, bias=bias), desc


def k18_cases(cs, bt, CK, K, torch, out, variants=False, d=None):
    d = d or cs.CFR_D
    model, staged, tabs = cfr_model(cs, bt, K, CK, torch, d)
    fns = {}
    for phase, which in K18_CASES:
        fn, a, desc = k18_case(cs, CK, K, torch, model, staged, tabs, phase,
                               which)
        name = f"{phase}_{which}"
        fns[name] = fn
        if variants:
            continue
        got, again, ref = a["own"].clone(), a["own"].clone(), \
            a["own"].clone()
        for buf in (got, again):
            CK.cfr_bias(a["X"], a["rows"], a["total"], explicit=a["exp"],
                        bias=buf, cbias=a["other"])
        CK.cfr_bias_plain(a["X"], a["rows"], a["total"], explicit=a["exp"],
                          bias=ref, cbias=a["other"])
        torch.cuda.synchronize()
        live = (a["total"] > 0) & (a["rows"] < a["X"].shape[0])
        idx = a["rows"].long()[live]
        nbytes, flops = cs.k18_work(torch, a["rows"], a["exp"], d)
        bms, by = cs.bound_ms(nbytes, flops)
        emit(out, kernel="K18", case=name, d=d, **desc,
             rel_err=cs.rel_err(got[idx], ref[idx])[1],
             repeatable=torch.equal(got, again), ms=cs.time_ms(fn),
             device_ms=cs.trace_ms(fn, "bias_kernel"), bound_ms=bms,
             bound_by=by)
    if variants or d != cs.CFR_D:
        return fns
    k18_epoch(cs, CK, torch, out, model, staged, tabs)
    return fns


def k18_epoch(cs, CK, torch, out, model, staged, tabs):
    """One CFR epoch by events and by kernel; every K18 call of it
    replayed alone, summed by phase and by launch size."""
    import buffalo_tpu_torch as bt

    o = model.opt
    dev = model.device
    kw = dict(alpha=float(o.alpha), l=float(o.l), reg_u=float(o.reg_u),
              reg_i=float(o.reg_i), reg_c=float(o.reg_c),
              optimizer=str(o.optimizer), cg_iters=int(o.num_cg_max_iters),
              cg_tol=float(o.cg_tolerance), compute_loss=True)
    one = bt.parallelism.Mesh([dev])
    work = [t.clone() for t in tabs]

    def epoch():
        return float(CK.cfr_epoch(one, {dev: work}, staged["user"],
                                  staged["item"], staged["context"], **kw))

    emit(out, kernel="K18", epoch_ms=cs.time_ms(epoch, reps=3, warmup=1),
         epoch_profile=cs.profile_call(torch, epoch, top=12))
    calls, real = [], CK.cfr_bias
    phase_of = {work[0].data_ptr(): "user", work[1].data_ptr(): "item",
                work[2].data_ptr(): "context"}

    def record(X, rows, total, **k):
        calls.append((phase_of[X.data_ptr()], X, rows, total, k))
        return real(X, rows, total, **k)

    # the wrapper counts its launches on the module's name, now record's
    record.launches = record.device_launches = 0
    CK.cfr_bias = record
    try:
        epoch()
    finally:
        CK.cfr_bias = real
    torch.cuda.synchronize()
    sums = {}
    for ph, X, rows, total, k in calls:
        def fn(X=X, rows=rows, total=total, k=k):
            real(X, rows, total, **k)
        nbytes, flops = cs.k18_work(torch, rows, k.get("explicit"),
                                    X.shape[1])
        bms = cs.bound_ms(nbytes, flops)[0]
        ms = cs.time_ms(fn, reps=5, warmup=1)
        dms = cs.trace_ms(fn, "bias_kernel", reps=6, warmup=1)
        size = "small" if rows.shape[0] < SMALL_LAUNCH_ROWS else "large"
        for key in (ph, size, "all"):
            s = sums.setdefault(key, dict(launches=0, ms=0.0, device_ms=0.0,
                                          bound_ms=0.0, entries=0))
            s["launches"] += 1
            s["ms"] += ms
            s["device_ms"] += dms if dms is not None else float("nan")
            s["bound_ms"] += bms
            side = k.get("explicit")
            if side is not None:
                s["entries"] += int((side.lens if side.chunk_ptr is None
                                     else side.chunk_lens).sum())
    emit(out, kernel="K18", per_epoch=sums,
         small_launch_rows=SMALL_LAUNCH_ROWS)


# ------------------------------------------------------------------ K19
def w2v_chunk(cs, bt, S, torch):
    """(the W2V model, the first pair chunk's inputs and targets on the
    card, the tables, the alias tables)."""
    data = stream_data(cs, bt, "stream")
    model = cs.w2v_model(bt, data, cs.w2v_opt(bt, num_iters=1,
                                              pair_gen="host"))
    dev = model.device
    chunk = model._pair_chunk()
    inp_h, tgt_h, _ = model._generate_pairs(np.random.default_rng(0))
    inputs = torch.from_numpy(inp_h[:chunk].copy()).to(dev)
    targets = torch.from_numpy(tgt_h[:chunk].copy()).to(dev)
    prob, al = S.build_alias_table(
        np.diff(np.asarray(model._vocab.dist, dtype=np.int64), prepend=0))
    alias = (torch.from_numpy(prob).to(dev), torch.from_numpy(al).to(dev))
    L0 = torch.from_numpy(model.L0).to(dev, copy=True)
    L1 = torch.from_numpy(model.L1).to(dev, copy=True)
    return model, inputs, targets, L0, L1, alias


def digest(torch, *ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def k19_calls(cs, bt, W, S, torch):
    """name -> (the K19 call, its inputs) and the model."""
    model, inputs, targets, L0, L1, alias = w2v_chunk(cs, bt, S, torch)
    o = model.opt
    V, K, lr = int(model._vocab.size), int(o.num_negative_samples), \
        float(o.lr)
    B = inputs.shape[0]
    base = dict(vocab_size=V, num_negatives=K, seed=0, epoch=0, chunk=0,
                alias=alias)
    negs = W.pair_step(L0, L1, inputs, targets, lr, **base)[0]
    q = B // 4
    cases = {
        "own_loss": (inputs, targets, base),
        "own_no_loss": (inputs, targets, dict(base, compute_loss=False)),
        "injected_loss": (inputs, targets, dict(base, negatives=negs)),
        "shard1of4": (inputs[q:2 * q].contiguous(),
                      targets[q:2 * q].contiguous(),
                      dict(base, slot_offset=q)),
    }
    calls = {}
    for name, (inp, tgt, kw) in cases.items():
        def fn(inp=inp, tgt=tgt, kw=kw):
            return W.pair_step(L0, L1, inp, tgt, lr, **kw)
        calls[name] = (fn, inp, tgt, kw)
    return calls, model, (L0, L1, lr, V, K)


def k19_cases(cs, bt, W, S, torch, out, variants=False):
    calls, model, (L0, L1, lr, V, K) = k19_calls(cs, bt, W, S, torch)
    if variants:
        return {k: v[0] for k, v in calls.items()}
    d = L0.shape[1]
    for name, (fn, inp, tgt, kw) in calls.items():
        got, again = fn(), fn()
        ref = W.pair_step_plain(L0, L1, inp, tgt, got[0], lr, vocab_size=V,
                                compute_loss=kw.get("compute_loss", True))
        torch.cuda.synchronize()
        B = inp.shape[0]
        bms, by = cs.bound_ms(*cs.k19_work(torch, inp, tgt, got[0], V, d, K))
        emit(out, kernel="K19", case=name, pairs=B, d=d, K=K,
             draws_keys_digest=digest(torch, got[0], got[1]),
             keys_equal_plain=torch.equal(got[1], ref[0]),
             rel_err=max(cs.rel_err(a, b)[1]
                         for a, b in zip(got[2:4], ref[1:3])),
             loss_rel_err=(abs(float(got[4]) - float(ref[3]))
                           / max(abs(float(ref[3])), 1e-30)),
             count=float(got[5]),
             repeatable=all(torch.equal(a, b) for a, b in zip(got, again)),
             ms=cs.time_ms(fn), device_ms=cs.trace_ms(fn, "pair_step"),
             bound_ms=bms, bound_by=by)
    model.opt.update(num_iters=1)
    prof = cs.profile_call(torch, model.train, top=12)
    st = model.epoch_stats[0]
    k19 = sum(v for k, v in prof["device_ms_by_name"].items()
              if "pair_step" in k or "sum_parts" in k)
    emit(out, kernel="K19", host_pair_epoch=dict(
        chunks=st["chunks"], pairs=st["pairs"], k19_busy_ms=k19,
        profile=prof))


# ------------------------------------------------------------- variants
# tag -> (source, [launch functions swapped in], [(old, new)]): the
# parent's K18 and K19 rebuilt with edits that match their text exactly
K18_V = ("cfr_bias.cu", ["cfr_bias"])
K19_V = ("w2v_pair_step.cu", ["w2v_pair_step", "w2v_pair_parts"])
_K18_A = [
    ("  const int lane = threadIdx.x & 31, b = blockIdx.x * kWarps + "
     "(threadIdx.x >> 5);\n  if (b >= g.R) return;\n  const int row = "
     "g.rows[b];\n  if (g.total[b] <= 0 || row < 0 || row >= g.n) return;\n"
     "  const float* xr = g.X + (int64_t)row * g.d;\n  float x[N];",
     "  constexpr int kPieceV = 256;\n"
     "  const int ppr = g.L > kPieceV ? (g.L + kPieceV - 1) / kPieceV : 1;\n"
     "  const int lane = threadIdx.x & 31, wq = blockIdx.x * kWarps + "
     "(threadIdx.x >> 5);\n  const int b = wq / ppr, pc = wq % ppr;\n"
     "  if (b >= g.R) return;\n  const int row = g.rows[b];\n"
     "  if (g.total[b] <= 0 || row < 0 || row >= g.n) return;\n"
     "  const float* xr = g.X + (int64_t)row * g.d;\n  float x[N];"),
    ("  if (g.loss) {\n    const float s = kEntries ?",
     "  if (g.loss && pc == 0) {\n    const float s = kEntries ?"),
    ("    for (int e = kEntries ? lane : 0; e < len; e += kEntries ? 32 : 1)"
     " {",
     "    const int e_end = min(len, (pc + 1) * kPieceV);\n"
     "    for (int e = pc * kPieceV + (kEntries ? lane : 0); e < e_end; "
     "e += kEntries ? 32 : 1) {"),
    ("  const unsigned grid = (R + kWarps - 1) / kWarps;",
     "  const int64_t ppr_v = L > 256 ? (L + 255) / 256 : 1;\n"
     "  const unsigned grid = (unsigned)((R * ppr_v + kWarps - 1) / kWarps);"),
]
_K18_B = [
    ("      float part = 0.f;\n#pragma unroll\n      for (int h = 0; h < N; "
     "++h) {\n        const int c = kEntries ? h : lane + 32 * h;\n"
     "        if (c < g.d) part = fmaf(x[h], __ldg(f + c), part);\n      }",
     "      float part = 0.f;\n"
     "      if (kEntries && (g.d & 3) == 0) {\n#pragma unroll\n"
     "        for (int h = 0; h < N; h += 4) {\n"
     "          if (h < g.d) {\n"
     "            const float4 v = __ldg(reinterpret_cast<const float4*>"
     "(f + h));\n"
     "            part = fmaf(x[h], v.x, part);\n"
     "            part = fmaf(x[h + 1], v.y, part);\n"
     "            part = fmaf(x[h + 2], v.z, part);\n"
     "            part = fmaf(x[h + 3], v.w, part);\n"
     "          }\n        }\n      } else {\n#pragma unroll\n"
     "        for (int h = 0; h < N; ++h) {\n"
     "          const int c = kEntries ? h : lane + 32 * h;\n"
     "          if (c < g.d) part = fmaf(x[h], __ldg(f + c), part);\n"
     "        }\n      }"),
]
_K19_A = [
    ("  float loss = 0.f, cnt = 0.f;\n  if (b < B) {",
     "  float loss = 0.f, cnt = 0.f;\n  int32_t myneg = 0;\n  if (b < B) {"),
    ("      negs[s] = n;\n", "      negs[s] = n;\n      myneg = n;\n"),
    ("    load_row<H>(L1 + (int64_t)min(tg, V - 1) * d, d, lane, lt);\n"
     "    const float fp = dot<H>(l0, lt);",
     "    load_row<H>(L1 + (int64_t)min(tg, V - 1) * d, d, lane, lt);\n"
     "    constexpr int kMaxKV = 8;\n    float lnv[kMaxKV][H];\n"
     "#pragma unroll\n    for (int k = 0; k < kMaxKV; ++k) {\n"
     "      const int nk = __shfl_sync(kFull, myneg, k);\n"
     "      if (k < K) load_row<H>(L1 + (int64_t)nk * d, d, lane, lnv[k]);\n"
     "    }\n    const float fp = dot<H>(l0, lt);"),
    ("    for (int k = 0; k < K; ++k) {\n"
     "      const int64_t s = (int64_t)b * K + k;\n"
     "      load_row<H>(L1 + (int64_t)negs[s] * d, d, lane, ln);\n"
     "      const float fn = dot<H>(l0, ln);",
     "#pragma unroll\n    for (int k = 0; k < kMaxKV; ++k) {\n"
     "      if (k >= K) break;\n"
     "      const int64_t s = (int64_t)b * K + k;\n"
     "#pragma unroll\n      for (int h = 0; h < H; ++h) ln[h] = lnv[k][h];\n"
     "      const float fn = dot<H>(l0, ln);"),
]
PARENT_VARIANTS = {
    "k18_as_is": (*K18_V, []), "k18_a_pieces": (*K18_V, _K18_A),
    "k18_b_ldg128": (*K18_V, _K18_B),
    "k19_as_is": (*K19_V, []), "k19_a_regs": (*K19_V, _K19_A),
}
# this tree's K18 at other pieces, and rebuilt at other lanes an entry,
# and K19 rebuilt at other lanes a pair, all at d = 32
K18_PIECES = (128, 256, 512, 1024)
CHANGE_VARIANTS = {f"k18_lanes_{n}": (*K18_V, [(
    "constexpr int kMaxLanes = 8;", f"constexpr int kMaxLanes = {n};")])
    for n in (1, 4, 8)}
CHANGE_VARIANTS.update({f"k19_lanes_{n}": (*K19_V, [(
    "constexpr int kLaneFloats = 8;",
    f"constexpr int kLaneFloats = {32 // n};")]) for n in (4, 8, 16, 32)})


@contextlib.contextmanager
def patched(module, name, value):
    """``module.name`` set to ``value`` inside the block."""
    real = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, real)


def time_variants(cs, bt, CK, K, W, S, torch, out, which):
    k18 = k18_cases(cs, bt, CK, K, torch, out, variants=True)
    k19 = k19_cases(cs, bt, W, S, torch, out, variants=True)
    for fn in (*k18.values(), *k19.values()):
        fn()
    torch.cuda.synchronize()

    def run(tag, todo, main):
        for what, fn in todo.items():
            emit(out, variant=tag, call=what, ms=cs.time_ms(fn),
                 device_ms=cs.trace_ms(fn, main))

    table = PARENT_VARIANTS
    if which == "change":
        for piece in K18_PIECES:
            with patched(CK, "BIAS_PIECE", piece):
                run(f"k18_piece_{piece}", k18, "bias_kernel")
        table = CHANGE_VARIANTS
    libs = build_variants(table, os.path.join(ROOT, "build",
                                              f"k18_k19_variants_{which}"))
    for tag, lib in libs.items():
        with swapped(lib, table[tag][1]):
            if tag.startswith("k18"):
                run(tag, k18, "bias_kernel")
            else:
                run(tag, k19, "pair_step")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--skip-k18", action="store_true")
    ap.add_argument("--skip-k19", action="store_true")
    ap.add_argument("--widths", type=int, nargs="+", default=None,
                    help="K18's row widths (default: chip_smoke's CFR_D)")
    ap.add_argument("--variants", choices=("parent", "change"), default=None,
                    help="the parent's K18 and K19 rebuilt with parts "
                         "changed, or this tree's at other pieces and lanes")
    args = parse(ap)
    cs, out = start(args, "k18_k19_bench")
    import torch

    import buffalo_tpu_torch as bt
    import buffalo_tpu_torch.ops.als_kernels as K
    import buffalo_tpu_torch.ops.cfr_kernels as CK
    import buffalo_tpu_torch.ops.sgd_kernels as S
    import buffalo_tpu_torch.ops.w2v_kernels as W
    from buffalo_tpu_torch.ops import _build

    bt.set_log_level(1)
    st = time.perf_counter()
    _build.build_all()
    emit(out, build_seconds=time.perf_counter() - st)
    os.makedirs(WORK, exist_ok=True)
    cs.WORK = WORK
    if args.variants:
        time_variants(cs, bt, CK, K, W, S, torch, out, args.variants)
    else:
        if not args.skip_k18:
            for d in args.widths or (cs.CFR_D,):
                st = time.perf_counter()
                k18_cases(cs, bt, CK, K, torch, out, d=d)
                emit(out, k18_seconds=time.perf_counter() - st, d=d)
                torch.cuda.empty_cache()
        if not args.skip_k19:
            st = time.perf_counter()
            k19_cases(cs, bt, W, S, torch, out)
            emit(out, k19_seconds=time.perf_counter() - st)
    finish(out, "k18_k19_bench", args.tag)


if __name__ == "__main__":
    main()
