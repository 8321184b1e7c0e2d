"""Smoke run of the PyTorch port on one NVIDIA card.

Drives ``buffalo_tpu_torch`` the way a user would — compiled data,
``ALS.initialize/train``, ``topk_recommendation``, ``save``/``load`` —
at the full width of the ML-20M configuration (138,493 x 26,744,
~20M interactions, d = 40; synthetic, power-law popularity, made from a
seed), builds every CUDA kernel of that path from ``buffalo_tpu_torch/
csrc``, holds each kernel against its plain PyTorch version on real
batches of the ML-20M layout, and checks that training went through the
kernels.  Phases, one line each: device, build, layout, kernels (K1 on
the largest and on the short matrix-free batch; K1, K2 and K3 also at
d = 13 and 128 on small random batches), epoch profile, path, plain
path, text path.  Every phase that fails ends the run with a non-zero
exit; without a card it exits 1 and prints no result.

    python3 chip_smoke.py

The line before the last is ``nvidia-smi``'s name and power limit, the
one before it a JSON object with each kernel's launches on the main
path, its error against the plain version and its times (CUDA events,
median of 20 runs, batches L2-warm as in the epoch loop) beside the
bound computed from this run's inputs; the kernel lines of K1 and K3
also give the kernel's device time alone (CUPTI through torch.profiler,
median of 20-22 launches), since events around a short launch also catch
the wrapper's host work (K2's kernel line also gives the
segment batch's bound and both bounds at the tensor cores' TF32 rate);
the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ML20M_USERS = 138_493
ML20M_ITEMS = 26_744
ML20M_NNZ = 20_000_000
D = 40
# the plain-path epoch: kernels against plain versions at a reduced size
SMALL_USERS, SMALL_ITEMS, SMALL_NNZ = 20_000, 5_000, 2_000_000
ALPHA, REG, CG_ITERS, CG_TOL = 8.0, 0.1, 3, 1e-10
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, dense FP32 (non-tensor) rate
# and dense TF32 tensor-core rate.  The kernels' work is float32; K2 runs
# its product on tensor cores as 3xTF32 (three TF32 products per float32
# one), so it also gets a second bound: 3x its operations at the TF32 rate
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_TF32_S = 495e12
# tolerances against the plain version (float32, other summation order):
# solved rows 1e-4 relative to the largest magnitude, loss terms 1e-3.
# Where the CG steps amplify float32 rounding (a head item's 1M-entry
# normal equations, whose residual cancels a large y, so that the plain
# float32 solve is ~1% from float64), a solve is held to the noise floor
# instead: its error against a float64 run of the plain code may be at
# most NOISE_FACTOR times the plain float32 version's, plus TOL_X
# relative.  Two float32 summation orders land independently in that
# noise; PERF.md has the readings on the H100 (K3 on the head-item
# systems, K1 at d = 128 on all-positive factors, the plain-path epoch).
# Each such check is shown to have power: the plain version with one CG
# step fewer must fail it.  K3's scatter mode is also held to TOL_X on the
# dense batch's systems.
TOL_X, TOL_LOSS, NOISE_FACTOR = 1e-4, 1e-3, 2.0
WORK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                    "chip_smoke")


def synth_ml20m(num_users, num_items, nnz, seed=0):
    """Synthetic CSR with power-law item popularity, ML-20M shaped."""
    rng = np.random.default_rng(seed)
    # item popularity ~ zipf(1.0), user degree ~ lognormal
    pop = 1.0 / np.arange(1, num_items + 1) ** 0.9
    cum = np.cumsum(pop / pop.sum())
    deg = rng.lognormal(mean=0.0, sigma=1.1, size=num_users)
    deg = np.maximum(1, (deg / deg.sum() * nnz)).astype(np.int64)
    total = int(deg.sum())
    items = np.searchsorted(cum, rng.random(total)).astype(np.int32)
    items = np.minimum(items, num_items - 1)
    vals = (1.0 + rng.integers(0, 5, size=total)).astype(np.float32)

    indptr = np.zeros(num_users + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    rows = np.repeat(np.arange(num_users, dtype=np.int32), deg)
    # colwise orientation
    order = np.argsort(items, kind="stable")
    ckey = rows[order]
    cval = vals[order]
    cindptr = np.zeros(num_items + 1, dtype=np.int64)
    np.cumsum(np.bincount(items, minlength=num_items), out=cindptr[1:])
    return {
        "rowwise": {"indptr": indptr, "key": items, "val": vals},
        "colwise": {"indptr": cindptr, "key": ckey, "val": cval},
    }, total


class ArrayData:
    """The two CSR groups of ``synth_ml20m``, for ``DeviceBatcher``."""

    def __init__(self, groups):
        self.groups = groups

    def get_group(self, g):
        return self.groups[g]


def epoch_kw(num_users, num_items):
    """``als_epoch``'s options for this script's training (d = D)."""
    return dict(optimizer="manual_cg", alpha=ALPHA, reg_u=REG, reg_i=REG,
                adaptive_reg=False, cg_iters=CG_ITERS, cg_tol=CG_TOL,
                block_size=32, compute_loss=True, num_p_rows=num_users,
                num_q_rows=num_items)


def range_layout(data, num_users, num_items, seed):
    """``data``'s range layout (host batches of the user and the item
    half) and random factor tables in its row order, |N(0, 1/D^2)| from
    ``seed``, users first: (row batches, col batches, P, Q), numpy."""
    from buffalo_tpu_torch.data.batching import (DeviceBatcher,
                                                 build_range_layout,
                                                 permute_table)

    b = {g: DeviceBatcher(data, g, batch_mb=1024, d=D)
         for g in ("rowwise", "colwise")}
    row_b, col_b, u_pos, i_pos, u_pad, i_pad = build_range_layout(
        b["rowwise"].planner, b["colwise"].planner, b["rowwise"].key,
        b["rowwise"].val, b["colwise"].key, b["colwise"].val)
    rng = np.random.default_rng(seed)

    def table(n, pos, pad):
        t = np.abs(rng.normal(scale=1.0 / D ** 2, size=(n, D)))
        return permute_table(t.astype(np.float32), pos, pad)

    P = table(num_users, u_pos, u_pad)
    return row_b, col_b, P, table(num_items, i_pos, i_pad)


def pick_batches(row_b, col_b):
    """The batches of the kernel lines, {kind: (half, index)}: K1's
    ``largest`` matrix-free batch (most padded entries) and its ``short``
    one (L <= 32: one entry slot per lane, the most rows), the ``dense``
    batch nearest L = 1024 and the ``segment`` batch with the most padded
    entries (K2 and K3)."""
    from buffalo_tpu_torch.data.batching import MATRIX_FREE_MAX_L, RangeBatch

    def is_range(b, lo, hi):
        return isinstance(b, RangeBatch) and lo < b.cols.shape[1] <= hi

    kinds = {
        "largest": (lambda b: is_range(b, 0, MATRIX_FREE_MAX_L),
                    lambda b: b.cols.shape[0] * b.cols.shape[1]),
        "short": (lambda b: is_range(b, 0, 32), lambda b: b.cols.shape[0]),
        "dense": (lambda b: is_range(b, MATRIX_FREE_MAX_L, 1 << 30),
                  lambda b: -abs(b.cols.shape[1] - 1024)),
        "segment": (lambda b: not isinstance(b, RangeBatch),
                    lambda b: int(np.prod(b.cols.shape))),
    }
    out = {}
    for kind, (pred, score) in kinds.items():
        best = None
        for half, batches in (("rowwise", row_b), ("colwise", col_b)):
            for i, b in enumerate(batches):
                if pred(b) and (best is None or score(b) > best[0]):
                    best = (score(b), half, i)
        check(best is not None, f"the layout lacks a {kind} batch")
        out[kind] = best[1:]
    return out


def write_compiled(groups, num_users, num_items, path, num_vali, seed):
    """Write ``groups`` as a compiled data directory (the format
    ``buffalo_tpu_torch.data.base.Data.open`` reads), moving ``num_vali``
    random interactions into the validation group."""
    rng = np.random.default_rng(seed)
    rw = groups["rowwise"]
    rows = np.repeat(np.arange(num_users, dtype=np.int32),
                     np.diff(rw["indptr"]))
    vali = np.sort(rng.choice(len(rows), size=num_vali, replace=False))
    keep = np.ones(len(rows), dtype=bool)
    keep[vali] = False
    r, c, v = rows[keep], rw["key"][keep], rw["val"][keep]
    os.makedirs(path)

    def save(name, arr):
        np.save(os.path.join(path, f"{name}.npy"), arr)

    def indptr(major, n):
        out = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(major, minlength=n), out=out[1:])
        return out

    save("rowwise.indptr", indptr(r, num_users))
    save("rowwise.key", c)
    save("rowwise.val", v)
    order = np.argsort(c, kind="stable")
    save("colwise.indptr", indptr(c, num_items))
    save("colwise.key", r[order])
    save("colwise.val", v[order])
    save("vali.row", rows[vali])
    save("vali.col", rw["key"][vali])
    save("vali.val", rw["val"][vali])
    save("idmap.rows", np.asarray([], dtype=np.str_))
    save("idmap.cols", np.asarray([], dtype=np.str_))
    with open(os.path.join(path, "header.json"), "w") as fh:
        json.dump({"num_users": num_users, "num_items": num_items,
                   "num_nnz": int(keep.sum()), "completed": 1,
                   "num_validation_samples": num_vali}, fh)


def phase(tag, /, **fields):
    print(json.dumps({"phase": tag, **fields}), flush=True)


def check(ok, what):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def rel_err(got, ref):
    """(max |got - ref|, that over max |ref|)."""
    err = float((got - ref).abs().max())
    return err, err / max(float(ref.abs().max()), 1e-30)


def noise_floor_check(got, plain32, plain64):
    """(passes, error fields) of a float32 solve against the plain
    version: within TOL_X of it, or no worse than NOISE_FACTOR times the
    plain float32 version's own error against float64 (+ TOL_X)."""
    got, plain32 = got.double(), plain32.double()
    scale = max(float(plain64.abs().max()), 1e-30)
    err = float((got - plain32).abs().max())
    err64 = float((got - plain64).abs().max())
    floor64 = float((plain32 - plain64).abs().max())
    ok = (err <= TOL_X * scale
          or err64 <= NOISE_FACTOR * floor64 + TOL_X * scale)
    return ok, dict(max_abs_err=err, rel_err=err / scale,
                    rel_err_vs_f64=err64 / scale,
                    plain_rel_err_vs_f64=floor64 / scale)


def floor_check(kernel, plain, base, idx):
    """A kernel's solve held to the noise floor, and the check's power:
    ``kernel(t)`` and ``plain(t, cg_iters)`` solve into copies of table
    ``base`` (``plain`` casting its inputs to ``t``'s dtype); rows ``idx``
    of the kernel's result are held to the plain float32 and float64 ones
    (``noise_floor_check``), and so are those of the plain float32 version
    with one CG step fewer.  Returns (kernel passes, its fields with the
    shorter solve's distance from float64, shorter solve passes)."""
    outs = [base.clone(), base.clone(), base.double(), base.clone()]
    kernel(outs[0])
    plain(outs[1], CG_ITERS)
    plain(outs[2], CG_ITERS)
    plain(outs[3], CG_ITERS - 1)
    got, p32, p64, short = [o[idx] for o in outs]
    ok, fields = noise_floor_check(got, p32, p64)
    short_ok, short_fields = noise_floor_check(short, p32, p64)
    fields["one_step_fewer_rel_err_vs_f64"] = short_fields["rel_err_vs_f64"]
    return ok, fields, short_ok


def time_ms(fn, reps=20, warmup=3):
    """Median milliseconds of ``fn`` on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in ev:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


def device_ms(fn, name, reps=20, warmup=3):
    """Median device milliseconds of the kernel ``name`` launched by
    ``fn``, over the ``reps`` or more calls traced by torch.profiler
    (CUPTI): the kernel's own time, without the wrapper's host work that
    CUDA events around the call also catch.  The trace can miss a
    launch of a few-µs kernel (on the H100 it once held 19 of 20 of K3's),
    so it holds two calls more than the median needs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps + 2):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and name in e.name]
    check(reps <= len(us) <= reps + 2, f"profiler saw {len(us)} launches "
          f"of {name}, expected {reps} to {reps + 2}")
    return float(np.median(us)) / 1e3


def bound_ms(nbytes, flops):
    """Least time for the work on an H100 SXM: the larger of the bytes
    over HBM bandwidth and the FP32 operations over the FP32 peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FP32_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bound_tf32_ms(nbytes, flops):
    """The bound of work done as 3xTF32 on the tensor cores: the larger of
    the bytes over HBM bandwidth and 3x the operations over the TF32 peak."""
    return 1e3 * max(nbytes / PEAK_BYTES_S, 3 * flops / PEAK_TF32_S)


def k2_work(cols_valid, real, R, d, item_axis, index_bytes):
    """(bytes, operations) K2's function needs on one batch: the index
    arrays, cols/vals and the distinct gathered rows read once, p of the
    real rows and FF read, A, y and the loss terms written once.  A is
    symmetric, so d(d+1) operations per entry (upper triangle) plus 2d for
    y; per row FF + reg I added once and, on the item axis, the loss from
    A and y (p^T A p - 2 p.y + ...: 2d^2 + 4d)."""
    n = int(cols_valid.numel())
    nbytes = (index_bytes + 8 * n + gathered_bytes(cols_valid, d)
              + 4 * real * d + 4 * d * d + 4 * R * d * (d + 1) + 8 * R)
    flops = (n * (d * (d + 1) + 2 * d)
             + real * (d * (d + 1) // 2
                       + (2 * d * d + 4 * d if item_axis else 0)))
    return nbytes, flops


def gathered_bytes(cols_valid, d):
    """Bytes of the distinct fixed-side rows a batch reads, once each."""
    import torch

    return int(torch.unique(cols_valid).numel()) * d * 4


def k1_work(batch, d):
    """(bytes, operations) K1's function needs on one RangeBatch: lens,
    cols/vals and the distinct gathered rows read once, p read and x
    written for the real rows, FF read, the loss terms written; y, then
    (1 + CG_ITERS) matvecs of 4 n d (F x and F^T g) + 2 d^2 + 2 d per row,
    and the CG vector work."""
    import torch

    B, L = batch.cols.shape
    lens = batch.lens.long()
    real, nnz = int((lens > 0).sum()), int(lens.sum())
    valid = torch.arange(L, device=lens.device)[None, :] < lens[:, None]
    nbytes = (4 * B + 8 * nnz + gathered_bytes(batch.cols[valid], d)
              + 8 * real * d + 4 * d * d + 8 * B)
    flops = (2 * nnz * d
             + (1 + CG_ITERS) * (4 * nnz * d + real * (2 * d * d + 2 * d))
             + real * CG_ITERS * 10 * d)
    return real, nnz, nbytes, flops


def layout_stats(batches):
    """Rows, padded entries and batches of each solve path of one half."""
    from buffalo_tpu_torch.data.batching import MATRIX_FREE_MAX_L, RangeBatch

    out = {"matrix_free": [0, 0, 0], "dense": [0, 0, 0], "segment": [0, 0, 0]}
    for b in batches:
        if isinstance(b, RangeBatch):
            key = ("matrix_free" if b.cols.shape[1] <= MATRIX_FREE_MAX_L
                   else "dense")
        else:
            key = "segment"
        s = out[key]
        s[0] += int((np.asarray(b.lens) > 0).sum())
        s[1] += int(np.prod(b.cols.shape))
        s[2] += 1
    return {k: dict(zip(("rows", "padded_entries", "batches"), v))
            for k, v in out.items()}


def kernel_name(key):
    """A profiler key without return type, anonymous namespace and
    arguments, cut to 60 characters."""
    key = key.replace("(anonymous namespace)::", "")
    if key.startswith("void "):
        key = key[5:]
    return key.split("(")[0][:60]


def profile_epoch(torch, K, P, Q, row_s, col_s, kw):
    """Device time of one training epoch by kernel name (torch.profiler
    over CUPTI), its sum, the epoch's wall time and the device's idle
    share of it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        st = time.perf_counter()
        K.als_epoch(P, Q, row_s, col_s, **kw)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - st)
    by_name = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us > 0:
            name = kernel_name(evt.key)
            by_name[name] = by_name.get(name, 0.0) + us / 1e3
    busy_ms = sum(by_name.values())
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    return dict(wall_ms=wall_ms,
                device_busy_ms=busy_ms if busy_ms else "not measured",
                idle_share=(1 - busy_ms / wall_ms) if busy_ms
                else "not measured", device_ms_by_name=top)


def k2_widths(torch, K, dev):
    """K2 against its plain version at the narrowest and widest widths the
    tests cover (d = 13: 4-byte gather and feature padding; d = 128: the
    wrapper's maximum), on one range batch (B 128, 97 <= len <= 1000) and
    one segment batch (head rows of 20,000 and 9,000 entries in 8192-entry
    chunks) of random rows; A and y to TOL_X, loss terms to TOL_LOSS."""
    from buffalo_tpu_torch.data.batching import (build_segment_batch,
                                                 stage_batch)

    out = {}
    for d in (13, 128):
        rng = np.random.default_rng(d)
        n, m, B, L = 2000, 5000, 128, 1000

        def tensor(a, dtype=torch.float32):
            return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                                device=dev)

        table = tensor(np.abs(rng.normal(size=(n, d))) / d)
        Bf = tensor(np.abs(rng.normal(size=(m, d))) / d)
        FF = Bf.T @ Bf
        kw = dict(alpha=ALPHA, reg=REG, adaptive_reg=False, item_axis=True,
                  num_fixed_rows=m, compute_loss=True)
        lens = rng.integers(97, L + 1, size=B)
        mask = np.arange(L)[None, :] < lens[:, None]
        cols = np.where(mask, rng.integers(0, m, size=(B, L)), 0)
        vals = np.where(mask, 1.0 + rng.integers(0, 5, size=(B, L)), 0.0)
        batch = (tensor(lens, torch.int32), tensor(cols, torch.int32),
                 tensor(vals))
        degs = rng.integers(1, 5, size=n)
        degs[[7, 1500]] = [20_000, 9_000]
        indptr = np.concatenate([[0], np.cumsum(degs)])
        key = rng.integers(0, m, size=int(indptr[-1])).astype(np.int32)
        val = (1.0 + rng.integers(0, 5, size=key.size)).astype(np.float32)
        sg = stage_batch(build_segment_batch(indptr, key, val, [7, 1500],
                                             8192, n), dev)
        seg = dict(rows=sg.rows, chunk_ptr=sg.chunk_ptr,
                   chunk_lens=sg.chunk_lens)
        res = {}
        for mode, args, where in (
                ("range", batch, dict(row_start=0)),
                ("segment", (sg.lens, sg.cols, sg.vals), seg)):
            ref = K.als_normal_equations_plain(table, Bf, FF, *args, **where,
                                               **kw)
            got = K.als_normal_equations(table, Bf, FF, *args, **where, **kw)
            rel = max(rel_err(got[0], ref[0])[1], rel_err(got[1], ref[1])[1])
            loss = max(rel_err(got[2].sum(), ref[2].sum())[1],
                       rel_err(got[3].sum(), ref[3].sum())[1])
            check(rel <= TOL_X and loss <= TOL_LOSS,
                  f"K2 at d = {d} ({mode}) disagrees with its plain version: "
                  f"A/y {rel:.3g}, loss {loss:.3g}")
            res[mode] = dict(rel_err_Ay=rel, loss_rel_err=loss)
        out[f"d{d}"] = res
    torch.cuda.synchronize()
    return out


def cg_widths(torch, K, dev):
    """K1 and K3 against their plain versions at d = 13 (a width that is
    no multiple of 4: 4-byte gather and loads, padded rows) and d = 128
    (the widest: F and A read from shared memory): K1 on a RangeBatch of
    B 257 rows of up to 96 entries with empty and one-entry rows, both
    halves; K3 on K2's systems of a 300-entry batch, range and scatter
    writes.  Rows to TOL_X, loss terms to TOL_LOSS, on signed random
    factors.  At d = 128 K1 also runs on all-positive factors, as the main
    path's are (|N| / d, as ``k2_widths`` uses): FF is then dominated by one
    direction and three CG steps amplify float32 rounding, so there its
    rows are held to the noise floor against a float64 run of the plain
    version, which the plain version with one CG step fewer must fail."""
    out = {}
    for d in (13, 128):
        rng = np.random.default_rng(100 + d)
        n, m, B = 2000, 5000, 257

        def tensor(a, dtype=torch.float32):
            return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                                device=dev)

        def batch(L):
            lens = rng.integers(1, L + 1, size=B)
            lens[[0, 100]] = 0
            lens[1] = 1
            mask = np.arange(L)[None, :] < lens[:, None]
            cols = np.where(mask, rng.integers(0, m, size=(B, L)), 0)
            vals = np.where(mask, 1.0 + rng.integers(0, 5, (B, L)), 0.0)
            return (tensor(lens, torch.int32), tensor(cols, torch.int32),
                    tensor(vals))

        table = tensor(rng.normal(size=(n, d)) * 0.3)
        Bf = tensor(rng.normal(size=(m, d)) * 0.3 / np.sqrt(m / 200))
        FF = Bf.T @ Bf
        cg = dict(cg_iters=CG_ITERS, cg_tol=CG_TOL)
        res = {}
        lens, cols, vals = batch(96)
        for item_axis in (False, True):
            kw = dict(alpha=ALPHA, reg=REG, adaptive_reg=False,
                      item_axis=item_axis, num_fixed_rows=m,
                      compute_loss=True)
            half = "items" if item_axis else "users"
            ref, got = table.clone(), table.clone()
            n_ref, d_ref = K.als_cg_matrix_free_plain(
                ref, Bf, FF, 7, lens, cols, vals, **cg, **kw)
            n_got, d_got = K.als_cg_matrix_free(
                got, Bf, FF, 7, lens, cols, vals, **cg, **kw)
            rel = rel_err(got, ref)[1]
            loss = max(rel_err(n_got.sum(), n_ref.sum())[1],
                       rel_err(d_got.sum(), d_ref.sum())[1])
            check(rel <= TOL_X and loss <= TOL_LOSS,
                  f"K1 at d = {d} ({half}) disagrees with its plain "
                  f"version: x {rel:.3g}, loss {loss:.3g}")
            res[f"K1_{half}"] = dict(rel_err=rel, loss_rel_err=loss)
        if d == 128:  # all-positive factors (the half changes no row)
            prng = np.random.default_rng(1000 + d)
            ptab = tensor(np.abs(prng.normal(size=(n, d))) / d)
            pBf = tensor(np.abs(prng.normal(size=(m, d))) / d)
            pFF = pBf.T @ pBf

            def plain(t, iters):
                K.als_cg_matrix_free_plain(
                    t, pBf.to(t.dtype), pFF.to(t.dtype), 7, lens, cols, vals,
                    cg_iters=iters, cg_tol=CG_TOL, **kw)

            ok, fields, weak = floor_check(
                lambda t: K.als_cg_matrix_free(t, pBf, pFF, 7, lens, cols,
                                               vals, **cg, **kw),
                plain, ptab, slice(7, 7 + B))
            check(ok, f"K1 at d = {d} on all-positive factors misses the "
                  f"noise floor: {fields}")
            check(not weak, f"K1's check at d = {d} on all-positive factors "
                  f"passes one CG step fewer: {fields}")
            res["K1_positive"] = fields
        lens, cols, vals = batch(300)
        A, y, _, _ = K.als_normal_equations_plain(
            table, Bf, FF, lens, cols, vals, row_start=7, alpha=ALPHA,
            reg=REG, adaptive_reg=False, item_axis=True, num_fixed_rows=m,
            compute_loss=False)
        rows = torch.arange(B + 6, 6, -1, dtype=torch.int32, device=dev)
        rows[::31] = 1 << 30
        for mode, where in (("range", dict(row_start=7)),
                            ("scatter", dict(rows=rows))):
            ref, got = table.clone(), table.clone()
            K.batched_cg_dense_plain(A, y, ref, lens, **where, **cg)
            K.batched_cg_dense(A, y, got, lens, **where, **cg)
            rel = rel_err(got, ref)[1]
            check(rel <= TOL_X, f"K3 at d = {d} ({mode}) disagrees with its "
                  f"plain version: {rel:.3g}")
            res[f"K3_{mode}"] = dict(rel_err=rel)
        out[f"d{d}"] = res
    torch.cuda.synchronize()
    return out


def kernel_phase(torch, K, P, Q, row_b, col_b, row_s, col_s, num_users,
                 num_items):
    """Each kernel against its plain version on ML-20M layout batches;
    returns the kernels' JSON entries (launches filled in later)."""
    from buffalo_tpu_torch.data.batching import StagedSegmentBatch

    d = P.shape[1]
    halves = {"rowwise": (P, Q, row_s, False, num_items),
              "colwise": (Q, P, col_s, True, num_users)}
    picked = {kind: (half, halves[half][2][i])
              for kind, (half, i) in pick_batches(row_b, col_b).items()}
    mf_half, mf = picked["largest"]
    sh_half, sh = picked["short"]
    dn_half, dn = picked["dense"]
    sg_half, sg = picked["segment"]
    check(isinstance(sg, StagedSegmentBatch), "segment batch not staged")

    def args(half):
        table, Bf, _, item_axis, n_fixed = halves[half]
        return table, Bf, Bf.T @ Bf, dict(
            alpha=ALPHA, reg=REG, adaptive_reg=False, item_axis=item_axis,
            num_fixed_rows=n_fixed, compute_loss=True)

    entries = {}
    cg = dict(cg_iters=CG_ITERS, cg_tol=CG_TOL)

    def k1_batch(half, mb):
        """K1 against its plain version on one batch, and its times."""
        table, Bf, FF, kw = args(half)
        B, L = mb.cols.shape
        t_ref, t_got = table.clone(), table.clone()
        batch = (Bf, FF, mb.row_start, mb.lens, mb.cols, mb.vals)
        n_ref, d_ref = K.als_cg_matrix_free_plain(t_ref, *batch, **cg, **kw)
        n_got, d_got = K.als_cg_matrix_free(t_got, *batch, **cg, **kw)
        rows = slice(mb.row_start, mb.row_start + B)
        err, rel = rel_err(t_got[rows], t_ref[rows])
        loss_rel = max(rel_err(n_got.sum(), n_ref.sum())[1],
                       rel_err(d_got.sum(), d_ref.sum())[1])
        check(rel <= TOL_X and loss_rel <= TOL_LOSS,
              f"K1 disagrees with its plain version (L = {L}): x {rel:.3g}, "
              f"loss {loss_rel:.3g}")
        scratch = table.clone()

        def run():
            K.als_cg_matrix_free(scratch, *batch, **cg, **kw)

        ms = time_ms(run)
        dev_ms = device_ms(run, "als_cg_matrix_free")
        plain_ms = time_ms(lambda: K.als_cg_matrix_free_plain(
            scratch, *batch, **cg, **kw))
        real, nnz, nbytes, flops = k1_work(mb, d)
        bms, by = bound_ms(nbytes, flops)
        return dict(half=half, B=B, L=L, real_rows=real, entries=nnz,
                    max_abs_err=err, rel_err=rel, loss_rel_err=loss_rel,
                    tol=TOL_X, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                    bound_ms=bms, bound_by=by)

    # ---- K1 on the largest matrix-free batch and on the short one
    k1 = k1_batch(mf_half, mf)
    k1_short = k1_batch(sh_half, sh)
    cg_w = cg_widths(torch, K, P.device)
    entries["als_cg_matrix_free"] = dict(
        route="cuda", source="buffalo_tpu_torch/csrc/als_cg_matrix_free.cu",
        replaces="buffalo_tpu/ops/als_kernels.py:103",
        max_abs_err=max(k1["max_abs_err"], k1_short["max_abs_err"]),
        ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
        bound_by=k1["bound_by"], library_ms=None)
    phase("kernel", name="als_cg_matrix_free", **k1, short=k1_short,
          widths=cg_w)

    # ---- K2 on the dense batch nearest L = 1024, and on a segment batch
    table, Bf, FF, kw = args(dn_half)
    B, L = dn.cols.shape
    ref = K.als_normal_equations_plain(table, Bf, FF, dn.lens, dn.cols,
                                       dn.vals, row_start=dn.row_start, **kw)
    got = K.als_normal_equations(table, Bf, FF, dn.lens, dn.cols, dn.vals,
                                 row_start=dn.row_start, **kw)
    err_A, rel_A = rel_err(got[0], ref[0])
    err_y, rel_y = rel_err(got[1], ref[1])
    loss_rel = max(rel_err(got[2].sum(), ref[2].sum())[1],
                   rel_err(got[3].sum(), ref[3].sum())[1])
    sg_table, sg_Bf, sg_FF, sg_kw = args(sg_half)
    seg = dict(rows=sg.rows, chunk_ptr=sg.chunk_ptr, chunk_lens=sg.chunk_lens)
    sref = K.als_normal_equations_plain(sg_table, sg_Bf, sg_FF, sg.lens,
                                        sg.cols, sg.vals, **seg, **sg_kw)
    sgot = K.als_normal_equations(sg_table, sg_Bf, sg_FF, sg.lens, sg.cols,
                                  sg.vals, **seg, **sg_kw)
    err_sA, rel_sA = rel_err(sgot[0], sref[0])
    err_sy, rel_sy = rel_err(sgot[1], sref[1])
    loss_rel_s = max(rel_err(sgot[2].sum(), sref[2].sum())[1],
                     rel_err(sgot[3].sum(), sref[3].sum())[1])
    worst = max(rel_A, rel_y, rel_sA, rel_sy)
    check(worst <= TOL_X and max(loss_rel, loss_rel_s) <= TOL_LOSS,
          f"K2 disagrees with its plain version: A/y {worst:.3g}, "
          f"loss {max(loss_rel, loss_rel_s):.3g}")
    ms = time_ms(lambda: K.als_normal_equations(
        table, Bf, FF, dn.lens, dn.cols, dn.vals, row_start=dn.row_start,
        **kw))
    plain_ms = time_ms(lambda: K.als_normal_equations_plain(
        table, Bf, FF, dn.lens, dn.cols, dn.vals, row_start=dn.row_start,
        **kw))
    # library yardstick: the same rank-L products as one batched GEMM on
    # pre-gathered, pre-weighted rows (never called by the port)
    F = Bf[dn.cols.long()]
    Fw = (F * (dn.vals * ALPHA)[:, :, None]).transpose(1, 2).contiguous()
    library_ms = time_ms(lambda: torch.bmm(Fw, F))
    del F, Fw
    seg_ms = time_ms(lambda: K.als_normal_equations(
        sg_table, sg_Bf, sg_FF, sg.lens, sg.cols, sg.vals, **seg, **sg_kw),
        reps=5, warmup=1)
    lens = dn.lens.long()
    real, nnz = int((lens > 0).sum()), int(lens.sum())
    valid = torch.arange(L, device=lens.device)[None, :] < lens[:, None]
    nbytes, flops = k2_work(dn.cols[valid], real, B, d, kw["item_axis"],
                            4 * B)
    bms, by = bound_ms(nbytes, flops)
    Rs, (Nc, Cs) = len(sg.lens), sg.cols.shape
    svalid = (torch.arange(Cs, device=sg.cols.device)[None, :]
              < sg.chunk_lens.long()[:, None])
    s_bytes, s_flops = k2_work(sg.cols[svalid], int((sg.lens > 0).sum()), Rs,
                               d, sg_kw["item_axis"], 12 * Rs + 4 + 4 * Nc)
    seg_bms, seg_by = bound_ms(s_bytes, s_flops)
    widths = k2_widths(torch, K, Bf.device)
    entries["als_normal_equations"] = dict(
        route="cuda", source="buffalo_tpu_torch/csrc/als_normal_equations.cu",
        replaces="buffalo_tpu/ops/als_kernels.py:65",
        max_abs_err=max(err_A, err_y, err_sA, err_sy), ms=ms,
        plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms)
    phase("kernel", name="als_normal_equations", half=dn_half, B=B, L=L,
          real_rows=real, entries=nnz, rel_err_A=rel_A, rel_err_y=rel_y,
          loss_rel_err=loss_rel, tol=TOL_X, ms=ms, plain_ms=plain_ms,
          library_ms=library_ms, bound_ms=bms, bound_by=by,
          bound_tf32_ms=bound_tf32_ms(nbytes, flops),
          segment=dict(half=sg_half, rows=int((sg.lens > 0).sum()),
                       chunks=int(sg.cols.shape[0]),
                       entries=int(sg.chunk_lens.sum()), rel_err_A=rel_sA,
                       rel_err_y=rel_sy, loss_rel_err=loss_rel_s,
                       ms=seg_ms, bound_ms=seg_bms, bound_by=seg_by,
                       bound_tf32_ms=bound_tf32_ms(s_bytes, s_flops)),
          widths=widths)

    # ---- K3 on the dense batch's systems (range write) and the segment
    # batch's (scatter write, padding ids skipped)
    def k3_check(A, y, base, lens, **where):
        """K3 on (A, y) from ``base`` held to the noise floor
        (``floor_check``) on the written rows only."""
        idx = (torch.arange(where["row_start"], where["row_start"] + len(lens),
                            device=lens.device) if "row_start" in where
               else where["rows"].long())
        keep = (lens > 0) & (idx < base.shape[0])
        return floor_check(
            lambda t: K.batched_cg_dense(A, y, t, lens, **where, **cg),
            lambda t, iters: K.batched_cg_dense_plain(
                A.to(t.dtype), y.to(t.dtype), t, lens, **where,
                cg_iters=iters, cg_tol=CG_TOL),
            base, idx[keep])

    A, y = ref[0], ref[1]
    ok, k3, weak = k3_check(A, y, table, dn.lens, row_start=dn.row_start)
    # the head-item systems from K2 (the plain segment sum adds with
    # atomics on the card, so its float32 rounding differs run to run)
    ok_s, k3_s, weak_s = k3_check(sgot[0], sgot[1], sg_table, sg.lens,
                                  rows=sg.rows)
    check(ok and ok_s, f"K3 disagrees with its plain version: {k3}, "
          f"segment {k3_s}")
    check(not (weak or weak_s), "K3's check passes a solve with one CG "
          f"step fewer: {k3}, segment {k3_s}")
    # scatter mode at TOL_X: the dense systems written through a reversed
    # row list with padding ids (1 << 30, the table's row count) in it;
    # the whole table is compared, so a stray or missing write shows
    R = len(dn.lens)
    rows = torch.arange(dn.row_start + R - 1, dn.row_start - 1, -1,
                        dtype=torch.int32, device=A.device)
    rows[::97] = 1 << 30
    rows[1::97] = table.shape[0]
    outs = [table.clone(), table.clone()]
    K.batched_cg_dense(A, y, outs[0], dn.lens, rows=rows, **cg)
    K.batched_cg_dense_plain(A, y, outs[1], dn.lens, rows=rows, **cg)
    err_sc, rel_sc = rel_err(outs[0], outs[1])
    check(rel_sc <= TOL_X and bool((outs[0] != table).any()),
          f"K3 scatter mode disagrees with its plain version: {rel_sc:.3g}")
    del outs
    scratch = table.clone()

    def run_k3():
        K.batched_cg_dense(A, y, scratch, dn.lens, row_start=dn.row_start,
                           **cg)

    ms = time_ms(run_k3)
    dev_ms = device_ms(run_k3, "batched_cg_dense")
    plain_ms = time_ms(lambda: K.batched_cg_dense_plain(
        A, y, scratch, dn.lens, row_start=dn.row_start, **cg))
    nbytes = 4 * B + real * (4 * d * d + 4 * d + 8 * d)
    flops = real * ((1 + CG_ITERS) * 2 * d * d + CG_ITERS * 10 * d)
    bms, by = bound_ms(nbytes, flops)
    entries["batched_cg_dense"] = dict(
        route="cuda", source="buffalo_tpu_torch/csrc/batched_cg_dense.cu",
        replaces="buffalo_tpu/ops/solve.py:83",
        max_abs_err=max(k3["max_abs_err"], k3_s["max_abs_err"], err_sc),
        ms=ms,
        plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None)
    phase("kernel", name="batched_cg_dense", half=dn_half, B=B,
          real_rows=real, **k3, segment=k3_s,
          scatter=dict(max_abs_err=err_sc, rel_err=rel_sc), tol=TOL_X,
          noise_factor=NOISE_FACTOR, ms=ms, device_ms=dev_ms,
          plain_ms=plain_ms, bound_ms=bms, bound_by=by)
    torch.cuda.synchronize()
    return entries


class PlainPath:
    """The plain-path configuration (SMALL_*, data from seed 3, tables
    from seed 11) one kernel epoch from its random start, and the next
    epoch from there through the plain versions on the CPU: in float32,
    in float64, and in float32 with one CG step fewer (segments keep 3).
    ``kernel_epoch`` runs that epoch through the kernels and ``readings``
    holds a result to the plain ones."""

    def __init__(self, torch, K, dev):
        from buffalo_tpu_torch.data.batching import stage_batch

        groups, self.nnz = synth_ml20m(SMALL_USERS, SMALL_ITEMS, SMALL_NNZ,
                                       seed=3)
        r2, c2, P0, Q0 = range_layout(ArrayData(groups), SMALL_USERS,
                                      SMALL_ITEMS, seed=11)
        self.torch, self.K = torch, K
        self.kw = epoch_kw(SMALL_USERS, SMALL_ITEMS)
        self.cuda_b = ([stage_batch(b, dev) for b in r2],
                       [stage_batch(b, dev) for b in c2])
        self.cpu_b = ([stage_batch(b, "cpu") for b in r2],
                      [stage_batch(b, "cpu") for b in c2])
        self.P1, self.Q1, _, _ = K.als_epoch(
            torch.from_numpy(P0).to(dev), torch.from_numpy(Q0).to(dev),
            *self.cuda_b, **self.kw)
        Pc, Qc = self.P1.cpu(), self.Q1.cpu()
        st = time.perf_counter()
        self.plain = K.als_epoch(Pc.clone(), Qc.clone(), *self.cpu_b,
                                 **self.kw)
        self.plain_s = time.perf_counter() - st
        self.plain_loss = (float(self.plain[2]), float(self.plain[3]))
        self.f64 = K.als_epoch(Pc.double(), Qc.double(), *self.cpu_b,
                               **self.kw)[:2]
        self.short = K.als_epoch(Pc.clone(), Qc.clone(), *self.cpu_b,
                                 **dict(self.kw, cg_iters=CG_ITERS - 1))[:2]

    def kernel_epoch(self):
        """((P, Q on the CPU, nume, deno), seconds) of the epoch through
        the kernels, from the same state."""
        torch = self.torch
        P, Q = self.P1.clone(), self.Q1.clone()
        torch.cuda.synchronize()
        st = time.perf_counter()
        P, Q, nume, deno = self.K.als_epoch(P, Q, *self.cuda_b, **self.kw)
        nume, deno = float(nume), float(deno)
        return (P.cpu(), Q.cpu(), nume, deno), time.perf_counter() - st

    def readings(self, P, Q, nume, deno):
        """(passes, fields): P and Q held to the plain epoch's by
        ``noise_floor_check``, the loss terms to TOL_LOSS."""
        (okP, eP), (okQ, eQ) = (noise_floor_check(t, t32, t64) for t, t32, t64
                                in zip((P, Q), self.plain, self.f64))
        e_loss = max(abs(nume / self.plain_loss[0] - 1),
                     abs(deno / self.plain_loss[1] - 1))
        return (okP and okQ and e_loss <= TOL_LOSS,
                dict(P=eP, Q=eQ, loss_rel_err=e_loss))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    import buffalo_tpu_torch as bt
    from buffalo_tpu_torch.data.batching import stage_batch
    from buffalo_tpu_torch.data.mm import MatrixMarket, MatrixMarketOptions
    from buffalo_tpu_torch.ops import _build
    from buffalo_tpu_torch.ops import als_kernels as K

    bt.set_log_level(1)
    dev = bt.utils.resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    check(len(smi) >= 1, "nvidia-smi printed nothing")
    kind = torch.cuda.get_device_name(0)
    phase("device", name=kind, count=torch.cuda.device_count(),
          nvidia_smi=smi[0], torch=torch.__version__,
          cuda=torch.version.cuda)

    st = time.perf_counter()
    out = _build.build_all()
    regs = {}
    for name in _build.sources():
        with open(os.path.join(out, f"{name}.log")) as fh:
            regs[name] = [ln.split("info    : ")[-1].strip()
                          for ln in fh if "registers" in ln or "spill" in ln]
    phase("build", seconds=time.perf_counter() - st, dir=out, ptxas=regs)

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        # ---- data: the ML-20M-shaped synthetic as a compiled directory
        st = time.perf_counter()
        groups, total = synth_ml20m(ML20M_USERS, ML20M_ITEMS, ML20M_NNZ)
        data_path = os.path.join(WORK, "ml20m.bfo")
        write_compiled(groups, ML20M_USERS, ML20M_ITEMS, data_path,
                       num_vali=2000, seed=1)
        del groups
        dopt = MatrixMarketOptions().get_default_option()
        dopt.data.tmp_dir = os.path.join(WORK, "tmp")
        dopt.data.path = data_path
        data = MatrixMarket(dopt)
        data.open(data_path)
        header = data.get_header()
        data_s = time.perf_counter() - st

        # ---- kernels: the main path's layout (and random tables), one
        # epoch to a trained state, then each kernel against its plain
        # version
        st = time.perf_counter()
        row_b, col_b, P, Q = range_layout(data, ML20M_USERS, ML20M_ITEMS,
                                          seed=7)
        layout_s = time.perf_counter() - st
        row_s = [stage_batch(b, dev) for b in row_b]
        col_s = [stage_batch(b, dev) for b in col_b]
        P, Q = torch.from_numpy(P).to(dev), torch.from_numpy(Q).to(dev)
        kw = epoch_kw(ML20M_USERS, ML20M_ITEMS)
        K.als_epoch(P, Q, row_s, col_s, **kw)
        torch.cuda.synchronize()
        phase("layout", users=header["num_users"], items=header["num_items"],
              nnz=header["num_nnz"], data_seconds=data_s,
              layout_seconds=layout_s, rowwise=layout_stats(row_b),
              colwise=layout_stats(col_b))
        entries = kernel_phase(torch, K, P, Q, row_b, col_b, row_s, col_s,
                               ML20M_USERS, ML20M_ITEMS)
        # the gramian's bound, both halves: 2 n d^2 operations and the
        # table's n d floats read (its d x d output is negligible)
        gram_bound = sum(bound_ms(4 * len(t) * D, 2 * len(t) * D * D)[0]
                         for t in (P, Q))
        phase("epoch_profile", **profile_epoch(torch, K, P, Q, row_s, col_s,
                                               kw),
              gramian_bound_ms=gram_bound)
        del P, Q, row_s, col_s, row_b, col_b
        torch.cuda.empty_cache()

        # ---- path: the user's entry points at ML-20M width, d = 40
        opt = bt.ALSOption().get_default_option()
        opt.update(d=D, num_iters=4, optimizer="manual_cg", alpha=ALPHA,
                   reg_u=REG, reg_i=REG, num_cg_max_iters=CG_ITERS,
                   compute_loss_on_training=True, validation={"topk": 10},
                   device="cuda")
        als = bt.ALS(opt, data=data)
        np.random.seed(0)
        als.initialize()
        epochs = []
        torch.cuda.reset_peak_memory_stats()
        for kern in K.KERNELS:
            kern.launches = 0
        st = time.perf_counter()
        als.train(training_callback=lambda i, m: epochs.append(m))
        train_s = time.perf_counter() - st
        launches = {k.__name__: k.launches for k in K.KERNELS}
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
        losses = [m["train_loss"] for m in epochs]
        check(len(losses) == 4 and all(np.isfinite(losses)),
              f"train_loss not finite: {losses}")
        check(all(b < a for a, b in zip(losses, losses[1:])),
              f"train_loss not falling after epoch 1: {losses}")
        check(all(v > 0 for v in launches.values()),
              f"a kernel of the path never launched: {launches}")
        check(als.P.shape == (ML20M_USERS, D) and np.isfinite(als.P).all()
              and np.isfinite(als.Q).all(), "trained factors not finite")
        users = [str(u) for u in range(1000)]
        als.topk_recommendation(users[:10], topk=10)  # warm
        st = time.perf_counter()
        recs = als.topk_recommendation(users, topk=10)
        topk_ms = 1e3 * (time.perf_counter() - st)
        check(len(recs) == 1000 and all(
            len(set(v)) == 10 and all(0 <= int(i) < ML20M_ITEMS for i in v)
            for v in recs.values()), "top-10 recommendations malformed")
        p, q = als.P[:1000], als.Q
        best = np.argsort(-(p @ q.T), axis=1, kind="stable")[:, :10]
        same = np.mean([set(map(int, recs[str(u)])) == set(best[u])
                        for u in range(1000)])
        check(same >= 0.99, f"top-10 differs from numpy for {1 - same:.3f}")
        phase("path", epochs=len(losses), train_loss=losses,
              val_ndcg=[m.get("val_ndcg") for m in epochs],
              epoch_seconds=als.iteration_times,
              median_epoch_seconds_2_4=float(np.median(
                  als.iteration_times[1:])),
              train_seconds=train_s, launches=launches,
              launches_per_epoch={k: v / len(losses)
                                  for k, v in launches.items()},
              max_memory_allocated_mb=peak_mb, topk_users=1000, topk_k=10,
              topk_ms=topk_ms, topk_same_as_numpy=same,
              # scores for every user and item, and the item table read
              topk_bound_ms=bound_ms(4 * ML20M_ITEMS * D,
                                     2 * len(users) * ML20M_ITEMS * D)[0])
        del als, data

        # ---- plain path: one epoch at 20k x 5k, 2M nnz from a trained
        # state, through the kernels and through the plain versions
        pp = PlainPath(torch, K, dev)
        (Pk, Qk, nk, dk), kernel_s = pp.kernel_epoch()
        ok, fields = pp.readings(Pk, Qk, nk, dk)
        # the check's power: one CG step fewer (segments keep 3) fails it
        weak, weak_fields = pp.readings(*pp.short, *pp.plain_loss)
        check(ok, f"kernel epoch vs plain epoch: {fields}")
        check(not weak, "the epoch check passes an epoch with one CG step "
              f"fewer: {weak_fields}")
        phase("plain_path", users=SMALL_USERS, items=SMALL_ITEMS,
              nnz=pp.nnz, **fields, tol=TOL_X,
              one_step_fewer_rel_err_vs_f64=[weak_fields[t]["rel_err_vs_f64"]
                                             for t in "PQ"],
              noise_factor=NOISE_FACTOR, kernel_epoch_seconds=kernel_s,
              plain_cpu_epoch_seconds=pp.plain_s)
        del pp

        # ---- text path: MatrixMarket -> ALS -> save -> load
        mm = os.path.join(WORK, "tiny.mtx")
        rng = np.random.default_rng(5)
        cells = sorted({(int(u), int(i)) for u, i in zip(
            rng.integers(1, 31, 300), rng.integers(1, 21, 300))})
        with open(mm, "w") as fh:
            fh.write("%%MatrixMarket matrix coordinate real general\n")
            fh.write(f"30 20 {len(cells)}\n")
            for u, i in cells:
                fh.write(f"{u} {i} {int(rng.integers(1, 6))}\n")
        mopt = MatrixMarketOptions().get_default_option()
        mopt.input.main = mm
        mopt.data.path = os.path.join(WORK, "tiny.bfo")
        mopt.data.tmp_dir = os.path.join(WORK, "tmp")
        mopt.data.validation = {}
        tiny = MatrixMarket(mopt)
        tiny.create()
        topt = bt.ALSOption().get_default_option()
        topt.update(d=8, num_iters=3, device="cuda")
        model = bt.ALS(topt, data=tiny)
        model.initialize()
        res = model.train()
        path = os.path.join(WORK, "tiny.als")
        model.save(path)
        loaded = bt.ALS.new(path, device="cuda")
        check(np.array_equal(loaded.P, model.P)
              and np.array_equal(loaded.Q, model.Q)
              and loaded.topk_recommendation("0", topk=3)
              == model.topk_recommendation("0", topk=3)
              and np.isfinite(res["train_loss"]), "text path round trip")
        phase("text_path", nnz=len(cells), train_loss=res["train_loss"],
              saved_bytes=os.path.getsize(path))
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    kernels = []
    for name, entry in entries.items():
        kernels.append({"name": name, "route": entry["route"],
                        "source": entry["source"],
                        "replaces": entry["replaces"],
                        "launches": launches[name],
                        "max_abs_err": entry["max_abs_err"],
                        "ms": entry["ms"], "plain_ms": entry["plain_ms"],
                        "bound_ms": entry["bound_ms"],
                        "bound_by": entry["bound_by"],
                        "library_ms": entry["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
