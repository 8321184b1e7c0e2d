"""Smoke run of the PyTorch port on one NVIDIA card.

Drives ``buffalo_tpu_torch`` the way a user would — compiled data,
``ALS.initialize/train``, ``topk_recommendation``, ``save``/``load`` —
on the ML-20M configuration (138,493 x 26,744, ~20M interactions;
synthetic, power-law popularity, made from a seed) at d = 40 and, on
iALS++ (chosen at d >= 128), at d = 160; builds every CUDA kernel from
``buffalo_tpu_torch/csrc``, holds each against its plain PyTorch
version on real batches of the ML-20M layout (the retrieval kernels on
the serving path's queries and tables), and checks that training and
serving went through the kernels.  Phases, one line each: device, build,
layout, kernels (K1 on the largest and the short matrix-free batch, K1
and K2 in rows mode and on bfloat16 values, K1, K2 and K3 at d = 13 and
128 on small random batches), epoch profile, path (d = 40), retrieval path
(that model served through ``ParALS`` and an ``IVFIndex``, against
numpy), bf16 path, scatter path and stream path (one epoch each against
the range layout), plain path, ialspp kernels (K4 at d = 160 on three
batches, range and rows modes, bfloat16, and small random widths up to
256), kernel wide (K2 and K3 at d = 160), ialspp path (d = 160), bpr
path (BPRMF on the ML-20M data at d = 40 with the default options, 4 sgd
epochs, then validation and top-10 through ``ParBPRMF``), bpr variants
(one adagrad, adam and streamed epoch each), bpr kernels (K8 bit for bit,
K9's sgd step, accumulation and loss, K10's adam and adagrad steps against
their plain versions on one of the epoch's 39 chunks), warp path
(WARP on the ML-20M data with the default options, d = 64, 4 epochs:
exactly one K11 and one K12 launch per chunk and two K10 launches in
projection mode per epoch, K and found_frac per epoch, rows in the unit
ball, validation, a profiled epoch, top-10 through K5), warp variants
(one l2, probe "all" + split, adam with per-coordinate normalization and
streamed epoch each), warp kernels (K11 bit for bit on its own and on
injected candidates, at the model's last K and at K = 64, K12 within 1e-5 with a run without the reg terms
failing the check, K10's projection), eals path (eALS at d = 40, 4
epochs, the RMSE falling every epoch, ParEALS top-10), eals kernels (K13
on a range batch of every length bucket, the segment batches and the CSR
rows, a Jacobi sweep failing the check, widths 13 to 256; K14's residuals
and sums), top-k past 1024 (k = 2,000 through the matmul route), plsi
path (pLSI at its defaults, d = 20, 4 epochs in the range layout: one K15
launch per batch and one K16 per epoch, the loss falling, P's rows and Q's
columns stochastic, top-10), plsi variants (one epoch each of group
dispatch, range_layout=False and streamed batches from the trained
tables), plsi kernels (K15's range, segment and padded modes, a variant
with the padded floor in the range mode failing the check; K16 masked and
unmasked), stream build (the KakaoBrunch12M-shaped corpus, 306,291 lines
over 505,926 items, through ``Stream`` with SPPMI windows 5, k 10; the
native SPPMI byte-equal to numpy's on a slice), cfr path (CoFactor at
d = 32, 4 epochs: one K17, K3 and K18 launch per batch, the loss falling,
top-10 through ``ParCFR``), cfr kernels (K17 on user, item, context and
segment-pair batches, a run without the explicit term failing; K3 on its
systems by the CG rule; K18, a run on the old rows failing), w2v path (the
brunch corpus built again as a token stream; W2V at d = 32 on its device
epoch, 4 epochs: one K8, one K21 and two K20 launches per token chunk, the
loss falling every epoch, a profiled epoch, top-10 for 10,000 keys through
``ParW2V``), w2v kernels (K8's draws bit for bit, K21 and K20 on a token
chunk, K19 on a pair chunk, a K20 run with the cap off and a K21 run at
window - 1 failing), w2v variants (one epoch each of the device path and
the host-pair path, resident and streamed), w2v quality (the clustered
corpus's purity gate, both paths), catalog
path (the README's serving configuration: 10,000 queries over a
505,840 x 100 KakaoBrunch-shaped catalog through ``batch_topn``, float32
and bfloat16 queries, its ``IVFIndex`` build and search; K5, K6 and K7
against their plain versions there, and two calls on a 5M x 64 catalog,
K5 held to the plain tiled version), retrieval widths (K5 and K6 at d = 13
to 256 and k = 1 to 1024), text path.  Every phase that fails ends the
run with a non-zero exit; without a card it exits 1 and prints no result.

    python3 chip_smoke.py

The line before the last is ``nvidia-smi``'s name and power limit, the
one before it a JSON object with each kernel's launches on the main
path, its error against the plain version and its times (CUDA events,
median of 20 runs, batches L2-warm as in the epoch loop; K5-K7 median of
10) beside the bound computed from this run's inputs (K1–K3's launches
are the d = 40 path's, K4's the d = 160 path's, K5–K7's the catalog
path's, K8's and K9's the BPR path's with K9's accumulation from the
adagrad and adam epochs, K10's those epochs' and the WARP path's, K11's
(with its loss mode) and K12's the WARP path's, K13's and K14's the eALS
path's, K15's and K16's the pLSI path's, K17's and K18's the CFR path's;
K10's times are of the BPR shapes; K8's count adds the W2V path's, K20's
and K21's are the W2V path's and K19's the host-pair W2V epoch's); the
kernel lines of K1, K3 and
K4 also give the kernel's device time alone (CUPTI through
torch.profiler, median of the 11-22 of 22 launches the trace holds),
since events around a short launch also catch the wrapper's host work
(K2's kernel line also gives the segment batch's bound and both bounds
at the tensor cores' TF32 rate).  K5-K7 have event times only: late in
a run the trace held few or none of their launches, so their device
time is not measured; each of their calls keeps the card busy 0.2 ms or
more, so the calls queue on it and the events catch little host work.
The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
import types

import numpy as np

ML20M_USERS = 138_493
ML20M_ITEMS = 26_744
ML20M_NNZ = 20_000_000
D = 40
# the iALS++ path's width: ALS at d >= 128 runs iALS++ with block d (the
# JAX package's benchmark sweeps ML-20M up to d = 160)
D_WIDE = 160
# the streaming path: a device budget the padded epoch (~360 MB of cols
# and values at d = 40) exceeds, and batches of 256 MB of working set
# (~0.8M entries, some 30 per half)
STREAM_RESIDENT_MB, STREAM_BATCH_MB = 64, 256
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
# the scatter and streaming layouts against the range layout after one
# epoch from the same trained factors: the same rows meet the same
# kernels, and only the gramians' summation order differs (the range
# layout's tables are permuted and padded), which three CG steps amplify
# to float32's noise: factors within 1e-3 (relative Frobenius norm), the
# loss terms (of the shared starting factors) within 1e-5.  From the
# |N(0, 1/d^2)| start the warm start's choice flips on rounding, and two
# float32 orders there differ by tens of percent (float64 agrees)
TOL_LAYOUT_X, TOL_LAYOUT_LOSS = 1e-3, 1e-5
# bfloat16 values against float32 after 4 epochs: the JAX package's own
# tolerance on the final loss (tests/models/test_als.py:215-223)
TOL_BF16_LOSS = 5e-3
# retrieval (K5-K7): scores are float32 sums in another order than the
# plain version's (and numpy's), so within 1e-5 relative (1e-6 absolute
# near 0); ids equal except where the two scores are that close (ties);
# K7's centroids within 1e-5.  Top-10 sets equal to numpy's for 99% of
# queries (near-ties at the 10th place may swap)
TOL_SCORE, TOL_SCORE_ABS, TOL_CENT, MIN_SAME_TOPK = 1e-5, 1e-6, 1e-5, 0.99
# K7's kernel launches a call (csrc/kmeans_update.cu: histogram, scan,
# placement, run sums; a memset more past 58,112 cells)
K7_MAX_LAUNCHES = 4
TOPK = 10
# retrieval_path: ParALS on the d = 40 ML-20M model
RETRIEVAL_USERS, RETRIEVAL_ITEMS, RETRIEVAL_PROBE = 10_000, 1_000, 32
# catalog_path: the README's serving configuration, 10k queries over a
# KakaoBrunch-shaped catalog (505,840 x 100), its IVF index (sqrt(N) = 711
# cells, spill 2), and one call on a 5M x 64 catalog
BRUNCH_ITEMS, BRUNCH_D, BRUNCH_QUERIES = 505_840, 100, 10_000
BRUNCH_CELLS = 711
BRUNCH_PROBES = (8, 32)
BRUNCH_EXACT = 1_000  # queries of the search that probes every cell
BIG_ITEMS, BIG_D, BIG_QUERIES = 5_000_000, 64, 2_048
# BPR (bpr_path, bpr_kernels): BPRMF on the ML-20M data at d = D with the
# default options (sgd, uniform negatives, verify_neg, max_step_norm 0.1):
# chunks of 524,288 pairs by the batch-size rule, 39 per epoch, a bloom
# filter of 2^23 words; top-10 through ParBPRMF for BPR_USERS users; the
# streamed epoch over COOBatcher chunks past BPR_STREAM_RESIDENT_MB.  K9's
# steps are held to its plain version within TOL_BPR_STEP of the largest
# step (plus two float32 spacings of the table: each side rounds start +
# step once), and a K9 run with the row clip off must fail that check; K10
# within TOL_K10 (rtol, elementwise: the same formula, fused or not).  K9
# makes at most K9_MAX_STREAM_OPS stream operations (kernels and memsets)
# per call; a chunk of one user whose positives are HOT_ITEM_SHARE one item
# is held to the plain version run in float64 (a float32 sum of 10^5 terms
# in any one order is as far from the exact sum as the tolerance)
BPR_EPOCHS, BPR_USERS, BPR_STREAM_RESIDENT_MB = 4, 10_000, 64
TOL_BPR_STEP, TOL_K10 = 1e-5, 1e-6
K9_MAX_STREAM_OPS, HOT_ITEM_SHARE = 8, 0.7
K9_MAIN = "epilogue_kernel"   # K9's last launch, once per call
# the kernels line's keys past the contract's, for the kernels that report
# them: the form a call took, its CUPTI time and its stream operations
KERNEL_EXTRAS = ("form", "device_ms", "stream_ops_per_call",
                 "device_launches_per_epoch", "epoch_device_ms",
                 "epoch_bound_ms")
# H100 SXM int32 rate: 64 INT32 lanes per SM (Hopper white paper) x 132
# SMs x 1.98 GHz boost; K8's work is integer (Philox, the bloom hashes)
PEAK_INT32_S = 64 * 132 * 1.98e9
# H100 SXM FP64 rate outside the tensor cores (data sheet); K11 sums its
# scores in float64
PEAK_FP64_S = 34e12
# WARP (warp_path, warp_variants, warp_kernels): WARP on the ML-20M data with
# the default options (d = 64, adagrad, lazy probes, K adaptive from 16):
# chunks of 32,768 positives by default_batch_size, 609 per epoch; top-10
# for WARP_USERS users through K5; one epoch each of the variants, the
# streamed one past WARP_STREAM_RESIDENT_MB.  K11 is held bit for bit to its
# plain version (ids, trials, any_v; weights within TOL_WARP_W relative: the
# same logf); K12 within TOL_WARP_STEP of the largest entry (plus two
# float32 spacings of the running gradient), with reg terms WARP_CHECK_REG
# so that a plain run without them must fail the check; K10's projection
# mode within TOL_K10
WARP_EPOCHS, WARP_USERS, WARP_STREAM_RESIDENT_MB = 4, 10_000, 64
TOL_WARP_W, TOL_WARP_STEP, WARP_CHECK_REG = 2 ** -23, 1e-5, 0.05
# K12's stream operations (kernels and memsets) per call on a resident chunk
K12_MAX_STREAM_OPS = 6
# eALS (eals_path, eals_kernels): EALSOption defaults (alpha 8, c0 512,
# exponent 0.5, reg 0.1) at d = D; K13 within TOL_EALS relative of its
# plain version (a sweep in Jacobi order must fail that), K14's residuals
# within TOL_VHAT and its sums within TOL_EALS_SUM relative; K13 also at
# EALS_WIDTHS on random batches
EALS_EPOCHS, EALS_USERS = 4, 10_000
TOL_EALS, TOL_VHAT, TOL_EALS_SUM = 1e-4, 1e-6, 1e-5
EALS_WIDTHS = (13, 64, 128, 256)
# topk_past_1024: k = TOPK_PAST items for TOPK_PAST_USERS users of the eALS
# model through batch_topn's matmul route
TOPK_PAST, TOPK_PAST_USERS = 2_000, 1_000
# pLSI (plsi_path, plsi_variants, plsi_kernels): PLSIOption defaults (d = 20,
# alpha1 = alpha2 = 1) on the ML-20M data in the range layout, PLSI_EPOCHS
# epochs, top-10 for PLSI_USERS users.  The variants (group dispatch,
# range_layout=False, the streamed batches at resident_mb 0) run one epoch
# each from the trained tables, held at the CPU tests' tolerance (tables
# TOL_PLSI_X relative, TOL_PLSI_ABS absolute; loss TOL_PLSI_LOSS) to the
# same function from the same start: group dispatch to the range layout's
# epoch, the other two (the padded path's element floor, which binds on
# ML-20M's smallest Q entries) to its plain versions, or where their
# float32 sums of a head item's ~1M latent rows part, to a float64 run of
# them within NOISE_FACTOR times the float32 run's distance.  K15's sums within
# TOL_K15 of its plain version (relative to the largest), its loss within
# TOL_K15 relative, and a variant with the padded path's element floor must
# fail that on Dirichlet(PLSI_SPARSE_CONC) tables, where latent products
# fall below the floors; K16 within TOL_K16.  P's rows and Q's columns sum
# to 1 within TOL_STOCHASTIC.
PLSI_EPOCHS, PLSI_USERS = 4, 1_000
# K15's kernels in a range epoch's trace (csrc/plsi_estep.cu: the range
# rows, the segment chunks and their rows' sums), and the width under which
# a range row is short (the team form's groups share a warp there)
K15_EPOCH_KERNELS = ("rows_kernel", "chunk_kernel", "chunk_rows")
K15_SHORT_ROW = 32
TOL_PLSI_X, TOL_PLSI_ABS, TOL_PLSI_LOSS = 1e-4, 1e-6, 1e-5
TOL_K15, TOL_K16, PLSI_SPARSE_CONC, TOL_STOCHASTIC = 1e-5, 1e-6, 0.02, 1e-5
# Stream + CoFactor (stream_build, cfr_path, cfr_kernels): the KakaoBrunch12M
# shape of the JAX package's stream benchmark (306,291 lines over 505,926
# items, 12M tokens, Zipf 0.8 popularity, seed 7), `matrix` internal type,
# SPPMI windows 5 and k 10; the native SPPMI byte-equal to numpy's on the
# first STREAM_SLICE lines.  CFR at d = CFR_D (that benchmark's width),
# CFROption defaults otherwise (manual_cg, 3 CG steps, alpha 8, l 1, regs
# 0.1), CFR_EPOCHS epochs, top-10 for CFR_USERS users through ParCFR (held
# to numpy's ranking on the first CFR_CHECK_USERS).  K17's
# A and y within TOL_K17 relative of its plain version (a run without the
# explicit term must fail that), K18 within TOL_K18 of the largest bias (a
# run on the rows before the solve must fail that), K3's solves of K17's
# systems by the CG rule (TOL_X or the noise floor).
BRUNCH_LINES, BRUNCH_VOCAB, BRUNCH_TOKENS = 306_291, 505_926, 12_000_000
STREAM_SLICE = 20_000
CFR_D, CFR_EPOCHS, CFR_USERS, CFR_CHECK_USERS = 32, 4, 10_000, 1_000
TOL_K17, TOL_K18 = 1e-4, 1e-5
# W2V (w2v_path, w2v_kernels, w2v_variants, w2v_quality): the brunch corpus
# built again as `stream` (token order kept, no SPPMI); W2V at the JAX
# package's stream benchmark settings (benchmark/test_stream_scale.py:
# 129-134: d = W2V_D, min_count 2, the defaults otherwise: window 5, 5
# negatives, sample 1e-3, neg_block 4; pair_gen auto = the device epoch on
# the card), W2V_EPOCHS epochs, ParW2V top-10 for W2V_QUERIES keys (the
# first W2V_CHECK_QUERIES held to numpy's float64 ranking on the normalized
# L0: numpy's top-10 set where its 10th and 11th scores are not near-tied,
# w2v_topk_check).  K19's rows and K21's outputs within TOL_W2V of their
# largest entry (losses TOL_W2V relative, counts exact, K8's draws
# bit for bit); K20 within TOL_W2V of the largest summed row delta before
# the cap (the sums' rounding, which the cap scales with the row) plus two
# float32 spacings of the table (each side rounds table + step once); a K20 run
# with the cap off and a K21 run at window - 1 must fail those checks.  The
# variants: one epoch each of the device and host-pair paths from one start,
# the device loss below W2V_DEVICE_BAND x the host loss (the JAX package's
# band, tests/models/test_w2v_cfr.py:508), the streamed host epoch within
# TOL_W2V_STREAMED of the resident one (the same pairs and draws)
W2V_D, W2V_EPOCHS, W2V_QUERIES, W2V_CHECK_QUERIES = 32, 4, 10_000, 1_000
TOL_W2V, W2V_DEVICE_BAND, TOL_W2V_STREAMED = 1e-5, 1.15, 1e-3
# the device mesh (mesh_als, mesh_nccl, mesh_eals, mesh_plsi, sharded_topk):
# MESH_SHARDS shards named on the one card (devices=["cuda:0"] * n), so
# every collective is a copy or a sum on it; MESH_EPOCHS epochs from the
# trained ALS factors, each mesh run's first epoch held by the layouts rule
# (TOL_LAYOUT_X, TOL_LAYOUT_LOSS) to the single-device range epoch from the
# same start, its losses within TOL_LAYOUT_LOSS, and every epoch's factors
# within NOISE_FACTOR x the largest distance of three single-device float32
# runs from the float64 witness (the same epochs through the plain versions
# on the CPU); the NCCL
# run (a 1-rank process group, NCCL_SHARDS local shards) to the 4-shard run
# and the witness by the same rules; eALS and pLSI (from seed 0) to their
# single-device epochs: eALS each table's largest difference within
# NOISE_FACTOR x the single-device range-vs-rows distance and the RMSE
# within TOL_EALS_SUM, pLSI at TOL_PLSI_X / TOL_PLSI_ABS and TOL_PLSI_LOSS.
# Sharded top-k over MESH_SHARDS shards: SHARDED_USERS ML-20M users and the
# brunch catalog's queries at k = TOPK, SHARDED_PAST_USERS users at k =
# TOPK_PAST, each equal to batch_topn's (ids off ties, scores TOL_SCORE);
# K22 bit for bit to its plain version on the real candidates
MESH_SHARDS, NCCL_SHARDS, MESH_EPOCHS = 4, 2, 2
# BPR-MF's and WARP's dp mesh (mesh_bpr, mesh_warp) against one device at
# the same batch size (the same draws): every epoch's tables within
# TOL_MESH_X (relative Frobenius norm), its loss within TOL_MESH_LOSS
# relative (WARP's violation rate one triplet's 1 / n more)
TOL_MESH_X, TOL_MESH_LOSS = 1e-4, 1e-5
# mesh_w2v: the stream epoch on a mesh drops the pairs across its shards'
# edges, so each epoch's loss is held within W2V_MESH_STREAM_LOSS of one
# device's (the JAX package's rule, tests/models/test_w2v_cfr.py:575-600);
# the host pairs draw the single device's negatives: L0 and L1 within
# W2V_MESH_HOST_X (relative Frobenius) after one epoch
W2V_MESH_STREAM_LOSS, W2V_MESH_HOST_X = 0.02, 1e-5
# wide_rows: each model WIDE_EPOCHS epochs at d = WIDE_D on the SMALL_*
# synthetic or a stream corpus of WIDE_LINES lines over WIDE_VOCAB words
WIDE_EPOCHS = 2
WIDE_LINES, WIDE_VOCAB, WIDE_TOKENS = 20_000, 20_000, 800_000
SHARDED_USERS, SHARDED_PAST_USERS = 10_000, 1_000
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


def range_layout(data, num_users, num_items, seed, d=D):
    """``data``'s range layout at width ``d`` (host batches of the user and
    the item half) and random factor tables in its row order,
    |N(0, 1/d^2)| from ``seed``, users first: (row batches, col batches,
    P, Q), numpy."""
    from buffalo_tpu_torch.data.batching import (DeviceBatcher,
                                                 build_range_layout,
                                                 permute_table)

    b = {g: DeviceBatcher(data, g, batch_mb=1024, d=d)
         for g in ("rowwise", "colwise")}
    row_b, col_b, u_pos, i_pos, u_pad, i_pad = build_range_layout(
        b["rowwise"].planner, b["colwise"].planner, b["rowwise"].key,
        b["rowwise"].val, b["colwise"].key, b["colwise"].val)
    rng = np.random.default_rng(seed)

    def table(n, pos, pad):
        t = np.abs(rng.normal(scale=1.0 / d ** 2, size=(n, d)))
        return permute_table(t.astype(np.float32), pos, pad)

    P = table(num_users, u_pos, u_pad)
    return row_b, col_b, P, table(num_items, i_pos, i_pad)


def pick_batches(row_b, col_b):
    """The batches of the kernel lines, {kind: (half, index)}: K1's
    ``largest`` matrix-free batch (most padded entries) and its ``short``
    one (L <= 32: one entry slot per lane, the most rows), the ``dense``
    batch nearest L = 1024, the ``longest`` range batch and the
    ``segment`` batch with the most padded entries (K2 and K3; K4 takes
    the range batches)."""
    from buffalo_tpu_torch.data.batching import MATRIX_FREE_MAX_L, RangeBatch

    def is_range(b, lo, hi):
        return isinstance(b, RangeBatch) and lo < b.cols.shape[1] <= hi

    kinds = {
        "largest": (lambda b: is_range(b, 0, MATRIX_FREE_MAX_L),
                    lambda b: b.cols.shape[0] * b.cols.shape[1]),
        "short": (lambda b: is_range(b, 0, 32), lambda b: b.cols.shape[0]),
        "dense": (lambda b: is_range(b, MATRIX_FREE_MAX_L, 1 << 30),
                  lambda b: -abs(b.cols.shape[1] - 1024)),
        "longest": (lambda b: is_range(b, MATRIX_FREE_MAX_L, 1 << 30),
                    lambda b: b.cols.shape[1]),
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


_START = 0.0  # set when main() starts


def phase(tag, /, **fields):
    """One phase's readings as a JSON line, with the script's elapsed
    seconds at its end (``at_seconds``)."""
    print(json.dumps({"phase": tag, **fields,
                      "at_seconds": time.perf_counter() - _START}),
          flush=True)


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
    CUDA events around the call also catch.  The trace can miss launches
    of a short kernel (on the H100 it has held 19 of 20 and 19 of 22 of
    K3's, and once 8 of 22), so it holds two calls more than the median
    needs and takes the median of those it saw, at least half of them; a
    trace that saw fewer is taken again, up to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        try:   # keep every cycle's events (torch.profiler's own advice)
            prof = profile(activities=[ProfilerActivity.CUDA],
                           acc_events=True)
        except TypeError:
            prof = profile(activities=[ProfilerActivity.CUDA])
        with prof:
            for _ in range(reps + 2):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and name in e.name]
        if len(us) >= reps // 2:
            break
    check(reps // 2 <= len(us) <= reps + 2, f"profiler saw {len(us)} "
          f"launches of {name}, expected {reps // 2} to {reps + 2}")
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


def ialspp_work(batch, vals, d, block_size, item_axis):
    """(real rows, entries, bytes, operations) K4's function needs on one
    batch: lens, cols, vals and the distinct gathered rows read once, p
    read and written for the real rows, FF read, the loss terms written;
    per row Yui (2 n d) and, on the item axis, p FF p (2 d^2); per block
    of width w, b (2 d w + 2 n w), CG_ITERS steps of a matvec (2 w^2 +
    4 n w) and the vector work (10 w), and the Yui update (2 n w) except
    after the last block."""
    import torch

    B, L = batch.cols.shape
    lens = batch.lens.long()
    real, nnz = int((lens > 0).sum()), int(lens.sum())
    valid = torch.arange(L, device=lens.device)[None, :] < lens[:, None]
    nbytes = (4 * B + (4 + vals.element_size()) * nnz
              + gathered_bytes(batch.cols[valid], d) + 8 * real * d
              + 4 * d * d + 8 * B)
    flops = 2 * nnz * d + (2 * real * d * d if item_axis else 0)
    for beg in range(0, d, block_size):
        w = min(block_size, d - beg)
        flops += (2 * d * w * real + 2 * nnz * w
                  + CG_ITERS * (2 * w * w * real + 4 * nnz * w + 10 * w * real)
                  + (2 * nnz * w if beg + w < d else 0))
    return real, nnz, nbytes, flops


def rows_mode(torch, lens, row_start, n):
    """A PaddedBatch's view of a range batch's rows: the ids in reverse,
    two of every 97 replaced by a padding id (``n``, the table's row count, or
    ``1 << 30``) whose row is emptied, as the planner pads: (rows, lens,
    table rows written)."""
    R = len(lens)
    rows = torch.arange(row_start + R - 1, row_start - 1, -1,
                        dtype=torch.int32, device=lens.device)
    rows[1::97] = n
    rows[2::97] = 1 << 30
    lens = torch.where(rows >= n, torch.zeros_like(lens), lens)
    return rows, lens, rows.long()[(lens > 0)]


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
    """``profile_call`` of one ALS training epoch."""
    return profile_call(torch, lambda: K.als_epoch(P, Q, row_s, col_s, **kw))


def profile_call(torch, fn, top=8):
    """Device time of ``fn()`` by kernel name (torch.profiler over CUPTI;
    the ``top`` largest), the device's busy time (the union of its
    activities' intervals: kernels, copies and fills, overlapping ones
    counted once), the call's wall time and the device's idle share of
    it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        st = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - st)
    by_name, spans = {}, []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = kernel_name(e.name)
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
        spans.append((e.time_range.start, e.time_range.end))
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    busy_ms = busy_us / 1e3
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:top])
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
    """Each kernel against its plain version on ML-20M layout batches, K1
    and K2 also in rows mode (a PaddedBatch's reversed ids with padding)
    and on bfloat16 values; returns the kernels' JSON entries (launches
    filled in later) and K1's and K2's device ms on float32 and bfloat16
    values."""
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

    def variants(mb, run, name, n_table):
        """``run(lens, vals, where, plain)`` -> (outputs, nume, deno) of K1
        (the table after the solve) or K2 (A and y) on batch ``mb``, in
        rows mode and on bfloat16 values, against the plain version: the
        outputs to TOL_X, the loss terms to TOL_LOSS; the kernel
        ``name``'s device ms on float32 and bfloat16 values and in rows
        mode."""
        out = {}
        rows, lens_r, _ = rows_mode(torch, mb.lens, mb.row_start, n_table)
        vals16 = mb.vals.to(torch.bfloat16)
        for tag, lens, vals, where in (
                ("rows", lens_r, mb.vals, dict(rows=rows)),
                ("bf16", mb.lens, vals16, dict(row_start=mb.row_start))):
            ref, n_ref, d_ref = run(lens, vals, where, True)
            got, n_got, d_got = run(lens, vals, where, False)
            errs = [rel_err(g, r) for g, r in zip(got, ref)]
            err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
            loss = max(rel_err(n_got.sum(), n_ref.sum())[1],
                       rel_err(d_got.sum(), d_ref.sum())[1])
            check(rel <= TOL_X and loss <= TOL_LOSS,
                  f"{name} ({tag}) disagrees with its plain version: "
                  f"{rel:.3g}, loss {loss:.3g}")
            out[tag] = dict(max_abs_err=err, rel_err=rel, loss_rel_err=loss)
        where = dict(row_start=mb.row_start)
        out["device_ms_f32"] = device_ms(
            lambda: run(mb.lens, mb.vals, where, False), name)
        out["device_ms_bf16"] = device_ms(
            lambda: run(mb.lens, vals16, where, False), name)
        out["device_ms_rows"] = device_ms(
            lambda: run(lens_r, mb.vals, dict(rows=rows), False), name)
        return out

    # ---- K1 on the largest matrix-free batch and on the short one, and
    # in rows mode and on bfloat16 values on the largest
    k1 = k1_batch(mf_half, mf)
    k1_short = k1_batch(sh_half, sh)
    cg_w = cg_widths(torch, K, P.device)
    table, Bf, FF, kw = args(mf_half)

    def run_k1(lens, vals, where, plain):
        t = table.clone()
        fn = K.als_cg_matrix_free_plain if plain else K.als_cg_matrix_free
        nume, deno = fn(t, Bf, FF, where.get("row_start", 0), lens, mf.cols,
                        vals, rows=where.get("rows"), **cg, **kw)
        return [t], nume, deno
    k1_modes = variants(mf, run_k1, "als_cg_matrix_free", table.shape[0])
    entries["als_cg_matrix_free"] = dict(
        route="cuda", source="buffalo_tpu_torch/csrc/als_cg_matrix_free.cu",
        replaces="buffalo_tpu/ops/als_kernels.py:103",
        max_abs_err=max(k1["max_abs_err"], k1_short["max_abs_err"],
                        k1_modes["rows"]["max_abs_err"],
                        k1_modes["bf16"]["max_abs_err"]),
        ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
        bound_by=k1["bound_by"], library_ms=None)
    phase("kernel", name="als_cg_matrix_free", **k1, short=k1_short,
          widths=cg_w, modes=k1_modes)

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

    def run_k2(lens, vals, where, plain):
        A, y, nume, deno = (K.als_normal_equations_plain if plain
                            else K.als_normal_equations)(
            table, Bf, FF, lens, dn.cols, vals, **where, **kw)
        return [A, y], nume, deno
    k2_modes = variants(dn, run_k2, "als_normal_equations_range",
                        table.shape[0])
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
          widths=widths, modes=k2_modes)

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
    scatter_dev_ms = device_ms(lambda: K.batched_cg_dense(
        A, y, outs[0], dn.lens, rows=rows, **cg), "batched_cg_dense")
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
    # the llt / ldlt path's solve of the same systems (torch.linalg, so a
    # library call, no hand kernel): A and y read, x written; d^3 / 3
    # operations to factor and 2 d^2 for the two triangular solves
    chol = dict(ms=time_ms(lambda: K.solve_cholesky(A, y)))
    chol["bound_ms"], chol["bound_by"] = bound_ms(
        B * 4 * (d * d + 2 * d), B * (d ** 3 / 3 + 2 * d * d))
    entries["batched_cg_dense"] = dict(
        route="cuda", source="buffalo_tpu_torch/csrc/batched_cg_dense.cu",
        replaces="buffalo_tpu/ops/solve.py:83",
        max_abs_err=max(k3["max_abs_err"], k3_s["max_abs_err"], err_sc),
        ms=ms,
        plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None)
    phase("kernel", name="batched_cg_dense", half=dn_half, B=B,
          real_rows=real, **k3, segment=k3_s,
          scatter=dict(max_abs_err=err_sc, rel_err=rel_sc,
                       device_ms=scatter_dev_ms), tol=TOL_X,
          noise_factor=NOISE_FACTOR, ms=ms, device_ms=dev_ms,
          plain_ms=plain_ms, bound_ms=bms, bound_by=by, cholesky=chol)
    torch.cuda.synchronize()
    bf16_ms = {name: {k: v for k, v in modes.items()
                      if k in ("device_ms_f32", "device_ms_bf16")}
               for name, modes in (("K1", k1_modes), ("K2", k2_modes))}
    return entries, bf16_ms


def ialspp_widths(torch, K, dev):
    """K4 against its plain version on small random batches (B 257 rows of
    up to 300 entries with empty and one-entry rows, item half, signed
    factors): d = 13 (one block, 4-byte gather), 64 in blocks of 32 (two
    blocks), 150 in blocks of 32 (a 22-wide tail block) and 256 (the
    widest, F streamed through the tile); each held by ``floor_check``,
    which the plain solve with one CG step fewer must fail, and its loss
    terms to TOL_LOSS."""
    out = {}
    for d, block in ((13, 13), (64, 32), (150, 32), (256, 256)):
        rng = np.random.default_rng(200 + d)
        n, m, B, L = 2000, 5000, 257, 300

        def tensor(a, dtype=torch.float32):
            return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                                device=dev)

        table = tensor(rng.normal(size=(n, d)) * 0.3)
        Bf = tensor(rng.normal(size=(m, d)) * 0.3 / np.sqrt(m / 200))
        FF = Bf.T @ Bf
        lens = rng.integers(1, L + 1, size=B)
        lens[[0, 100]] = 0
        lens[1] = 1
        mask = np.arange(L)[None, :] < lens[:, None]
        lens_t = tensor(lens, torch.int32)
        cols = tensor(np.where(mask, rng.integers(0, m, size=(B, L)), 0),
                      torch.int32)
        vals = tensor(np.where(mask, 1.0 + rng.integers(0, 5, (B, L)), 0.0))
        kw = dict(alpha=ALPHA, reg=REG, adaptive_reg=False, item_axis=True,
                  num_fixed_rows=m, compute_loss=True, block_size=block,
                  cg_tol=CG_TOL, row_start=7)
        out[f"d{d}_block{block}"] = k4_check(
            K, table, Bf, FF, lens_t, cols, vals,
            torch.arange(7, 7 + B, device=dev)[lens_t > 0],
            f"d = {d}, block {block}", **kw)
    torch.cuda.synchronize()
    return out


def k4_check(K, table, Bf, FF, lens, cols, vals, written, what, **kw):
    """K4 against its plain version on one batch: the rows ``written``
    held by ``floor_check`` (which the plain solve with one CG step fewer
    must fail), the loss terms to TOL_LOSS.  Returns the readings."""
    ok, fields, weak = floor_check(
        lambda t: K.ialspp_solve_batch(t, Bf, FF, lens, cols, vals, **kw),
        lambda t, steps: K.ialspp_solve_batch_plain(
            t, Bf.to(t.dtype), FF.to(t.dtype), lens, cols, vals,
            steps=steps, **kw),
        table, written)
    n_ref, d_ref = K.ialspp_solve_batch_plain(table.clone(), Bf, FF, lens,
                                              cols, vals, **kw)
    n_got, d_got = K.ialspp_solve_batch(table.clone(), Bf, FF, lens, cols,
                                        vals, **kw)
    loss = max(rel_err(n_got.sum(), n_ref.sum())[1],
               rel_err(d_got.sum(), d_ref.sum())[1])
    check(ok and loss <= TOL_LOSS, f"K4 ({what}) disagrees with its plain "
          f"version: {fields}, loss {loss:.3g}")
    check(not weak, f"K4's check ({what}) passes one CG step fewer: "
          f"{fields}")
    return dict(fields, loss_rel_err=loss)


def wide_kernel_phase(torch, K, data, dev):
    """iALS++ at d = D_WIDE on the ML-20M layout (random |N(0, 1/d^2)|
    tables, seed 17, then one iALS++ epoch: from the random start A is
    nearly reg I plus a rank-one term, where 2 CG steps are exact and no
    check could show its power; the next epoch is profiled): K4 against
    its plain version on the largest
    matrix-free batch, the dense batch nearest L = 1024 and the longest
    range batch, each in range mode, in rows mode and on bfloat16 values,
    held by ``floor_check`` (which the plain solve with one CG step fewer
    must fail) and its loss terms to TOL_LOSS, with its times and bound;
    the small random cases of ``ialspp_widths``; then K2 and K3 at
    d = D_WIDE on the dense and segment batches (``wide_k2_k3``).  Returns
    K4's kernel-line entry."""
    from buffalo_tpu_torch.data.batching import stage_batch

    d = D_WIDE
    st = time.perf_counter()
    row_b, col_b, P, Q = range_layout(data, ML20M_USERS, ML20M_ITEMS,
                                      seed=17, d=d)
    layout_s = time.perf_counter() - st
    picked = pick_batches(row_b, col_b)
    P, Q = torch.from_numpy(P).to(dev), torch.from_numpy(Q).to(dev)
    row_s = [stage_batch(b, dev) for b in row_b]
    col_s = [stage_batch(b, dev) for b in col_b]
    kw_w = dict(epoch_kw(ML20M_USERS, ML20M_ITEMS), optimizer="ialspp",
                block_size=d)
    st = time.perf_counter()
    K.als_epoch(P, Q, row_s, col_s, **kw_w)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - st
    # the next epoch profiled, from a copy of the trained tables
    profile = profile_epoch(torch, K, P.clone(), Q.clone(), row_s, col_s,
                            kw_w)
    halves = {"rowwise": (P, Q, row_s, False, ML20M_ITEMS),
              "colwise": (Q, P, col_s, True, ML20M_USERS)}

    def args(half):
        table, Bf, _, item_axis, n_fixed = halves[half]
        return table, Bf, Bf.T @ Bf, dict(
            alpha=ALPHA, reg=REG, adaptive_reg=False, item_axis=item_axis,
            num_fixed_rows=n_fixed, compute_loss=True)

    out, worst = {}, 0.0
    for kind in ("largest", "dense", "longest"):
        half, i = picked[kind]
        mb = halves[half][2][i]
        table, Bf, FF, kw = args(half)
        B, L = mb.cols.shape
        res = dict(half=half, B=B, L=L)
        for mode, bf16 in (("range", False), ("rows", False),
                           ("range", True)):
            vals = mb.vals.to(torch.bfloat16) if bf16 else mb.vals
            if mode == "rows":
                rows, lens, written = rows_mode(torch, mb.lens, mb.row_start,
                                                table.shape[0])
                where = dict(rows=rows)
            else:
                lens, where = mb.lens, dict(row_start=mb.row_start)
                written = torch.arange(mb.row_start, mb.row_start + B,
                                       device=dev)[lens > 0]
            tag = mode + ("_bf16" if bf16 else "")
            res[tag] = k4_check(K, table, Bf, FF, lens, mb.cols, vals,
                                written, f"{kind}, {tag}", block_size=d,
                                cg_tol=CG_TOL, **where, **kw)
            worst = max(worst, res[tag]["max_abs_err"])
        scratch = table.clone()
        vals16 = mb.vals.to(torch.bfloat16)

        def run(vals=mb.vals):
            K.ialspp_solve_batch(scratch, Bf, FF, mb.lens, mb.cols, vals,
                                 row_start=mb.row_start, block_size=d,
                                 cg_tol=CG_TOL, **kw)

        res["ms"] = time_ms(run)
        # every call launches the short form's kernel where the width takes
        # it (its blocks skip the longer rows), else the tile form's
        res["forms"] = K.ialspp_forms(d, d, L)
        main = ("ialspp_tile" if res["forms"]["form"] == "tile"
                else "ialspp_short")
        res["device_ms"], res["device_ops_per_call"] = trace_stats(run, main)
        res["device_ms_bf16"] = trace_ms(lambda: run(vals16), main)
        res["plain_ms"] = time_ms(lambda: K.ialspp_solve_batch_plain(
            scratch, Bf, FF, mb.lens, mb.cols, mb.vals,
            row_start=mb.row_start, block_size=d, cg_tol=CG_TOL, **kw),
            reps=5, warmup=1)
        real, nnz, nbytes, flops = ialspp_work(mb, mb.vals, d, d,
                                               kw["item_axis"])
        res.update(real_rows=real, entries=nnz)
        res["bound_ms"], res["bound_by"] = bound_ms(nbytes, flops)
        out[kind] = res
        del mb, scratch
    phase("ialspp_kernels", d=d, block_size=d, layout_seconds=layout_s,
          first_epoch_seconds=epoch_s, epoch_profile=profile,
          tol=TOL_X, noise_factor=NOISE_FACTOR, **out,
          widths=ialspp_widths(torch, K, dev))
    wide_k2_k3(torch, K, picked, halves, args, dev)
    dense = out["dense"]
    return dict(route="cuda", source="buffalo_tpu_torch/csrc/ialspp_solve.cu",
                replaces="buffalo_tpu/ops/als_kernels.py:174",
                max_abs_err=worst, ms=dense["ms"],
                form=dense["forms"]["form"], device_ms=dense["device_ms"],
                plain_ms=dense["plain_ms"], bound_ms=dense["bound_ms"],
                bound_by=dense["bound_by"], library_ms=None)


def wide_k2_k3(torch, K, picked, halves, args, dev):
    """K2 and K3 at d = D_WIDE, where K2 passes over the entries twice and
    builds A in its output: K2 on the dense and segment batches against
    its plain version (A and y to TOL_X, loss terms to TOL_LOSS), K3 on
    their systems held by ``floor_check``; K2's and K3's times on the
    dense batch."""
    cg = dict(cg_iters=CG_ITERS, cg_tol=CG_TOL)
    res = {}
    for kind in ("dense", "segment"):
        half, i = picked[kind]
        b = halves[half][2][i]
        table, Bf, FF, kw = args(half)
        if kind == "dense":
            where = dict(row_start=b.row_start)
            idx = torch.arange(b.row_start, b.row_start + len(b.lens),
                               device=dev)
        else:
            where = dict(rows=b.rows, chunk_ptr=b.chunk_ptr,
                         chunk_lens=b.chunk_lens)
            idx = b.rows.long()
        ref = K.als_normal_equations_plain(table, Bf, FF, b.lens, b.cols,
                                           b.vals, **where, **kw)
        got = K.als_normal_equations(table, Bf, FF, b.lens, b.cols, b.vals,
                                     **where, **kw)
        rel = max(rel_err(got[0], ref[0])[1], rel_err(got[1], ref[1])[1])
        loss = max(rel_err(got[2].sum(), ref[2].sum())[1],
                   rel_err(got[3].sum(), ref[3].sum())[1])
        check(rel <= TOL_X and loss <= TOL_LOSS, f"K2 at d = {D_WIDE} "
              f"({kind}) disagrees with its plain version: A/y {rel:.3g}, "
              f"loss {loss:.3g}")
        # K3 on the kernel's systems (the plain segment sum adds with
        # atomics on the card), rows with entries and ids in the table
        A, y = got[0], got[1]
        solve_at = {k: v for k, v in where.items() if k in ("row_start",
                                                             "rows")}
        keep = (b.lens > 0) & (idx < table.shape[0])
        ok, k3, weak = floor_check(
            lambda t: K.batched_cg_dense(A, y, t, b.lens, **solve_at, **cg),
            lambda t, iters: K.batched_cg_dense_plain(
                A.to(t.dtype), y.to(t.dtype), t, b.lens, **solve_at,
                cg_iters=iters, cg_tol=CG_TOL),
            table, idx[keep])
        check(ok, f"K3 at d = {D_WIDE} ({kind}) disagrees with its plain "
              f"version: {k3}")
        check(not weak, f"K3's check at d = {D_WIDE} ({kind}) passes one "
              f"CG step fewer: {k3}")
        res[kind] = dict(half=half, rows=int((b.lens > 0).sum()),
                         shape=list(b.cols.shape), k2_rel_err_Ay=rel,
                         k2_loss_rel_err=loss, k3=k3)
        if kind == "dense":
            scratch = table.clone()
            res[kind].update(
                k2_ms=time_ms(lambda: K.als_normal_equations(
                    table, Bf, FF, b.lens, b.cols, b.vals, **where, **kw)),
                k2_device_ms=device_ms(lambda: K.als_normal_equations(
                    table, Bf, FF, b.lens, b.cols, b.vals, **where, **kw),
                    "als_normal_equations_range"),
                k3_device_ms=device_ms(lambda: K.batched_cg_dense(
                    A, y, scratch, b.lens, **solve_at, **cg),
                    "batched_cg_dense"))
        else:
            res[kind]["k2_ms"] = time_ms(lambda: K.als_normal_equations(
                table, Bf, FF, b.lens, b.cols, b.vals, **where, **kw),
                reps=5, warmup=1)
        del b, A, y, ref, got
    phase("kernel_wide", d=D_WIDE, tol=TOL_X, noise_factor=NOISE_FACTOR,
          **res)
    torch.cuda.synchronize()


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


def als_opt(bt, **kw):
    """ALS options of this script's runs (``manual_cg``, chosen as iALS++
    at d >= 128), on the card, with ``kw`` on top."""
    opt = bt.ALSOption().get_default_option()
    opt.update(optimizer="manual_cg", alpha=ALPHA, reg_u=REG, reg_i=REG,
               num_cg_max_iters=CG_ITERS, compute_loss_on_training=True,
               device="cuda")
    opt.update(kw)
    return opt


def train_path(bt, K, torch, data, opt, start=None):
    """A model of ``opt`` on ``data`` from the factors of seed 0 (or the
    copies of ``start``'s (P, Q)), trained with every kernel's count set
    to 0 just before: (model, per-epoch metrics, launches, peak device
    MB, train seconds)."""
    als = bt.ALS(opt, data=data)
    np.random.seed(0)
    als.initialize()
    if start is not None:
        als.P, als.Q = start[0].copy(), start[1].copy()
    epochs = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in K.KERNELS:
        kern.launches = 0
    st = time.perf_counter()
    res = als.train(training_callback=lambda i, m: epochs.append(m))
    train_s = time.perf_counter() - st
    launches = {k.__name__: k.launches for k in K.KERNELS}
    if not epochs:  # no validation: the result holds the last loss
        epochs = [{"train_loss": res["train_loss"]}]
    return (als, epochs, launches,
            torch.cuda.max_memory_allocated() / 2 ** 20, train_s)


def check_training(als, epochs, launches, kernels, num_epochs, d):
    """Losses finite and falling, the path's kernels launched, factors of
    the data's shape and finite."""
    losses = [m["train_loss"] for m in epochs]
    check(len(losses) == num_epochs and all(np.isfinite(losses)),
          f"train_loss not finite: {losses}")
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"train_loss not falling after epoch 1: {losses}")
    check(all(launches[k.__name__] > 0 for k in kernels),
          f"a kernel of the path never launched: {launches}")
    check(als.P.shape == (ML20M_USERS, d) and np.isfinite(als.P).all()
          and np.isfinite(als.Q).all(), "trained factors not finite")
    return losses


def ranked_topk(s, k):
    """The k best columns of each row of ``s`` by score descending, ties to
    the smaller index, as a full stable argsort gives them: the best
    m = 2k + 8 by ``argpartition``, sorted; a row where the m-th score ties
    the k-th (so an excluded column could belong) is sorted in full."""
    n = s.shape[1]
    m = min(n, 2 * k + 8)
    if m == n:
        return np.argsort(-s, axis=1, kind="stable")[:, :k]
    part = np.argpartition(-s, m - 1, axis=1)[:, :m]
    ps = np.take_along_axis(s, part, axis=1)
    order = np.lexsort((part, -ps), axis=-1)
    out = np.take_along_axis(part, order, axis=1)
    cs = np.take_along_axis(ps, order, axis=1)
    tie = cs[:, m - 1] >= cs[:, k - 1]
    if tie.any():
        out[tie, :k] = np.argsort(-s[tie], axis=1, kind="stable")[:, :k]
    return out[:, :k]


def ids_match_numpy(ids, P, Q, Qb=None, what="top-k"):
    """Ranked ids (B, k) against numpy's float64 ranking of P @ Q^T (+ Qb),
    ties to the smaller index: equal except where numpy's scores of the
    two ids are within TOL_SCORE (float32 near-ties), and in index order
    wherever numpy's scores are exactly equal.  Returns the share of rows
    equal to numpy's outright."""
    s = P.astype(np.float64) @ Q.astype(np.float64).T
    if Qb is not None:
        s = s + Qb.astype(np.float64)[None, :]
    k = ids.shape[1]
    ref = ranked_topk(s, k)
    got_s = np.take_along_axis(s, ids, axis=1)
    ref_s = np.take_along_axis(s, ref, axis=1)
    near = np.isclose(got_s, ref_s, rtol=TOL_SCORE, atol=TOL_SCORE_ABS)
    check(bool(((ids == ref) | near).all()),
          f"{what}: ids differ from numpy's off near-ties")
    tie = got_s[:, 1:] == got_s[:, :-1]
    check(bool((~tie | (ids[:, 1:] > ids[:, :-1])).all()),
          f"{what}: tied scores not in index order")
    return float(np.mean((ids == ref).all(axis=1)))


def topk_check(als, R):
    """Top-10 for 1,000 users through the entry point, with K5's count set
    to 0 just before: (host ms, share of users whose top-10 equals numpy's
    (float64, ties to the smaller index), K5 launches)."""
    users = [str(u) for u in range(1000)]
    als.topk_recommendation(users[:10], topk=10)  # warm
    R.score_topk.launches = 0
    st = time.perf_counter()
    recs = als.topk_recommendation(users, topk=10)
    topk_ms = 1e3 * (time.perf_counter() - st)
    launches = R.score_topk.launches
    check(launches >= 1, "topk_recommendation did not launch K5")
    check(len(recs) == 1000 and all(
        len(set(v)) == 10 and all(0 <= int(i) < ML20M_ITEMS for i in v)
        for v in recs.values()), "top-10 recommendations malformed")
    ids = np.array([[int(i) for i in recs[u]] for u in users])
    same = ids_match_numpy(ids, als.P[:1000], als.Q, what="ALS top-10")
    return topk_ms, same, launches


def per_epoch(launches, epochs):
    return {k: v / epochs for k, v in launches.items()}


def layout_paths(bt, K, torch, data, dev, start):
    """One epoch at d = D from the same trained factors ``start`` in the
    range layout, the scatter layout (``range_layout=False``) and the streaming
    path (``resident_mb`` STREAM_RESIDENT_MB, ``batch_mb``
    STREAM_BATCH_MB), the last two held to the first (factors to
    TOL_LAYOUT_X, relative Frobenius norm; loss to TOL_LAYOUT_LOSS); then
    one streaming epoch from the trained factors, profiled (device idle
    share, bytes copied to the card)."""
    from buffalo_tpu_torch.data.batching import DeviceBatcher

    runs = {}
    data_opt = data.opt.data
    had = "batch_mb" in data_opt
    saved = data_opt.get("batch_mb")
    try:
        for name, extra in (("range", {}),
                            ("scatter", dict(range_layout=False)),
                            ("stream", dict(resident_mb=STREAM_RESIDENT_MB))):
            if name == "stream":
                data_opt["batch_mb"] = STREAM_BATCH_MB
            als, epochs, launches, peak_mb, train_s = train_path(
                bt, K, torch, data, als_opt(bt, d=D, num_iters=1, **extra),
                start=start)
            runs[name] = dict(P=als.P, Q=als.Q,
                              loss=epochs[-1]["train_loss"],
                              epoch_seconds=als.iteration_times[0],
                              h2d_bytes=als.h2d_bytes, launches=launches,
                              max_memory_allocated_mb=peak_mb)
            del als
    finally:
        if had:
            data_opt["batch_mb"] = saved
        else:
            data_opt.pop("batch_mb", None)

    def rel(a, b):
        return float(np.linalg.norm(a.astype(np.float64) - b)
                     / np.linalg.norm(b.astype(np.float64)))

    base = runs["range"]
    out = {}
    for name in ("scatter", "stream"):
        r = runs[name]
        fields = dict(P_rel=rel(r["P"], base["P"]), Q_rel=rel(r["Q"], base["Q"]),
                      loss=r["loss"], range_loss=base["loss"],
                      loss_rel=abs(r["loss"] / base["loss"] - 1))
        check(fields["P_rel"] <= TOL_LAYOUT_X
              and fields["Q_rel"] <= TOL_LAYOUT_X
              and fields["loss_rel"] <= TOL_LAYOUT_LOSS,
              f"the {name} layout's epoch differs from the range layout's: "
              f"{fields}")
        check(all(r["launches"][k.__name__] > 0 for k in
                  (K.als_cg_matrix_free, K.als_normal_equations,
                   K.batched_cg_dense)),
              f"a kernel of the {name} path never launched: {r['launches']}")
        out[name] = dict(fields, epoch_seconds=r["epoch_seconds"],
                         range_epoch_seconds=base["epoch_seconds"],
                         launches=r["launches"],
                         max_memory_allocated_mb=r["max_memory_allocated_mb"])
    check(runs["stream"]["h2d_bytes"] > 0, "the stream path staged nothing")
    out["stream"]["h2d_bytes_first_epoch"] = runs["stream"]["h2d_bytes"]

    # one more streaming epoch from the trained factors, profiled
    rb, cb = (DeviceBatcher(data, g, batch_mb=STREAM_BATCH_MB,
                            resident_mb=STREAM_RESIDENT_MB, d=D, device=dev)
              for g in ("rowwise", "colwise"))
    check(not rb.resident and not cb.resident,
          "the streaming batchers hold the epoch resident")
    P = torch.from_numpy(runs["stream"]["P"]).to(dev)
    Q = torch.from_numpy(runs["stream"]["Q"]).to(dev)
    prof = profile_epoch(torch, K, P, Q, rb, cb,
                         epoch_kw(ML20M_USERS, ML20M_ITEMS))
    out["stream"].update(profiled_epoch=prof,
                         h2d_bytes_per_epoch=rb.h2d_bytes + cb.h2d_bytes,
                         batches_per_half=[rb.num_batches, cb.num_batches],
                         resident_mb=STREAM_RESIDENT_MB,
                         batch_mb=STREAM_BATCH_MB)
    tol = dict(tol_factors=TOL_LAYOUT_X, tol_loss=TOL_LAYOUT_LOSS)
    phase("scatter_path", d=D, epochs=1, **out["scatter"], **tol)
    phase("stream_path", d=D, epochs=1, **out["stream"], **tol)
    del P, Q
    torch.cuda.empty_cache()


def reset_counts(kernels):
    for kern in kernels:
        kern.launches = 0


def read_counts(kernels):
    return {k.__name__: k.launches for k in kernels}


def kernel_topk_check(got, ref, what):
    """A kernel's (scores, ids) against its plain version's: scores within
    TOL_SCORE relative (TOL_SCORE_ABS near 0, equal infinities), ids equal
    except where the two scores are that close, and ties in index order.
    Returns (max abs score error, ids that differ at ties)."""
    import torch

    (gv, gi), (rv, ri) = got, ref
    close = torch.isclose(gv, rv, rtol=TOL_SCORE, atol=TOL_SCORE_ABS)
    check(bool(close.all()), f"{what}: scores differ from the plain version "
          f"by up to {float((gv - rv).abs().nan_to_num().max()):.3g}")
    check(bool(((gi == ri) | close).all()),
          f"{what}: ids differ from the plain version off ties")
    g2, i2 = gv.reshape(-1, gv.shape[-1]), gi.reshape(-1, gi.shape[-1])
    same = g2[:, 1:] == g2[:, :-1]
    check(bool((~same | (i2[:, 1:] > i2[:, :-1])).all()),
          f"{what}: equal scores not in index order")
    fin = torch.isfinite(rv)
    err = float((gv - rv)[fin].abs().max()) if bool(fin.any()) else 0.0
    return err, int((gi != ri).sum())


def numpy_topk(queries, table, k):
    """float64 top-k by score, ties to the smaller index: (ids, scores)."""
    s = queries.astype(np.float64) @ table.astype(np.float64).T
    ids = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return ids, np.take_along_axis(s, ids, axis=1)


def agree_with_numpy(ids, scores, ref_ids, ref_scores, what):
    """Share of queries whose top-k set equals numpy's (at least
    MIN_SAME_TOPK) and the largest score error (TOL_SCORE relative)."""
    same = float(np.mean([set(a) == set(b) for a, b in zip(ids, ref_ids)]))
    ok = np.isclose(scores, ref_scores, rtol=TOL_SCORE, atol=TOL_SCORE_ABS)
    check(same >= MIN_SAME_TOPK, f"{what}: top-{ids.shape[1]} equals numpy's "
          f"for only {same:.4f} of queries")
    check(bool(ok.all()), f"{what}: scores off numpy's by up to "
          f"{float(np.abs(scores - ref_scores).max()):.3g}")
    return same, float(np.abs(scores - ref_scores).max())


def recall_at(ids, exact_ids):
    k = exact_ids.shape[1]
    return float(np.mean([len(set(a) & set(b)) / k
                          for a, b in zip(ids, exact_ids)]))


def wall_ms(fn):
    """(host milliseconds of ``fn()`` ending in a device sync, result)."""
    import torch

    torch.cuda.synchronize()
    st = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - st), out


def retrieval_path(bt, R, torch, als):
    """The d = 40 ML-20M model served through ParALS, with K5-K7's counts
    set to 0 just before: top-10 for RETRIEVAL_USERS users (first call
    stages the item table, the second finds it in the cache), most_similar
    for RETRIEVAL_ITEMS items (after normalize), each against numpy; then
    an IVFIndex on the normalized items (sqrt(N) cells, spill 2, 10
    iterations) serving those items at n_probe RETRIEVAL_PROBE (recall@10
    against the exact scan) and probing every cell (the exact scan up to
    ties).  Host wall ms for each call; then K5 alone at the top-10 call's
    shape and K7 on the index's last update against their plain versions,
    with their times and bounds."""
    out = {}
    reset_counts(R.KERNELS)
    par = bt.ParALS(als)
    users = [str(u) for u in range(RETRIEVAL_USERS)]
    ms_first, (keys, ids, scores) = wall_ms(
        lambda: par.topk_recommendation(users, topk=TOPK))
    ms_warm, (_, ids2, _) = wall_ms(
        lambda: par.topk_recommendation(users, topk=TOPK))
    check(keys == users and ids.shape == (RETRIEVAL_USERS, TOPK)
          and np.array_equal(ids, ids2), "ParALS top-10 malformed")
    same, err = agree_with_numpy(ids, scores, *numpy_topk(
        als.P[:RETRIEVAL_USERS], als.Q, TOPK), "ParALS.topk_recommendation")
    out["topk_recommendation"] = dict(
        users=RETRIEVAL_USERS, topk=TOPK, host_ms_first=ms_first,
        host_ms_warm=ms_warm, same_as_numpy=same, max_abs_score_err=err)
    users_items = (als.P[:RETRIEVAL_USERS], als.Q)  # before normalize

    items = [str(i) for i in range(RETRIEVAL_ITEMS)]
    ms_first, (sim_ids, sim_scores) = wall_ms(
        lambda: par.most_similar(items, topk=TOPK))
    ms_warm, _ = wall_ms(lambda: par.most_similar(items, topk=TOPK))
    Qn = als.Q
    same, err = agree_with_numpy(sim_ids, sim_scores, *numpy_topk(
        Qn[:RETRIEVAL_ITEMS], Qn, TOPK), "ParALS.most_similar")
    out["most_similar"] = dict(items=RETRIEVAL_ITEMS, host_ms_first=ms_first,
                               host_ms_warm=ms_warm, same_as_numpy=same,
                               max_abs_score_err=err)

    cells = int(np.sqrt(len(Qn)))
    build_ms, index = wall_ms(lambda: bt.IVFIndex.build(
        Qn, n_clusters=cells, n_probe=RETRIEVAL_PROBE, spill=2, n_iters=10,
        device=als.device))
    par.set_ann_index(index)
    ms_first, (ann_ids, _) = wall_ms(
        lambda: par.most_similar(items, topk=TOPK))
    ms_warm, _ = wall_ms(lambda: par.most_similar(items, topk=TOPK))
    index.n_probe = cells
    full_ids, full_scores = par.most_similar(items, topk=TOPK)
    ok = np.isclose(full_scores, sim_scores, rtol=TOL_SCORE,
                    atol=TOL_SCORE_ABS)
    check(bool(ok.all() and ((full_ids == sim_ids) | ok).all()),
          "probing every cell differs from the exact scan")
    launches = read_counts(R.KERNELS)
    check(all(v > 0 for v in launches.values()),
          f"a retrieval kernel never launched: {launches}")
    p, Q = (torch.from_numpy(np.ascontiguousarray(a)).to(als.device)
            for a in users_items)
    out["k5"] = k5_entry(R, torch, p, Q, TOPK, "K5 (ML-20M users)")
    # K7 on the index's last centroids and the assignment to them
    unit = torch.from_numpy(np.ascontiguousarray(ivf_unit(Qn))).to(als.device)
    cent = torch.from_numpy(index.centroids).to(als.device)
    out["k7"] = k7_entry(R, torch, unit, R.score_topk(unit, cent, 1)[1], cent)
    del unit, cent
    out["ivf"] = dict(cells=cells, spill=2, n_iters=10, build_host_ms=build_ms,
                      n_probe=RETRIEVAL_PROBE, host_ms_first=ms_first,
                      host_ms_warm=ms_warm,
                      recall_at_10=recall_at(ann_ids, sim_ids),
                      full_probe_equals_exact=True)
    phase("retrieval_path", d=als.Q.shape[1], items=len(Qn), **out,
          launches=launches)


def brunch_tables(rng, n, d, b):
    """A KakaoBrunch-shaped catalog (rows N(0, 1) scaled by lognormal(0,
    0.7) norms) and b N(0, 1) queries, float32."""
    table = rng.standard_normal((n, d), dtype=np.float32)
    table *= rng.lognormal(0.0, 0.7, n).astype(np.float32)[:, None]
    return table, rng.standard_normal((b, d), dtype=np.float32)


def k5_work(B, N, d, k, bias, p_bytes=4):
    """(bytes, operations) of K5's function: p, Q (and Qb) read once, the
    k (score, index) pairs written; 2 d operations per (query, item)
    score, one more with a bias."""
    return (p_bytes * B * d + 4 * N * d + (4 * N if bias else 0) + 8 * B * k,
            B * N * (2 * d + (1 if bias else 0)))


def k5_entry(R, torch, p, Q, k, what, Qb=None, plain=None, library=True):
    """K5 on (p, Q, k) against its plain version (``plain``, else
    ``score_topk_plain``): its form and splits, event and CUPTI ms (the
    launch and the split merge) and device operations per call, the plain
    version's ms and (``library``) one torch.matmul + torch.topk per
    2048-query chunk, and the bound of the form: the FP32 one for the FFMA
    form, for the tensor-core form the lesser of that and the 3xTF32 one
    (two products per pair with bfloat16 queries, which are exact in
    TF32)."""
    got = R.score_topk(p, Q, k, Qb)
    ref = plain() if plain is not None else R.score_topk_plain(p, Q, k, Qb)
    err, tie_ids = kernel_topk_check(got, ref, what)
    del got, ref

    def fn():
        return R.score_topk(p, Q, k, Qb)
    ms = time_ms(fn, reps=10, warmup=2)
    dev_ms, ops = trace_stats(fn, "score_topk")
    form, splits = R.score_topk_shape(p.shape[0], Q.shape[0], Q.shape[1], k,
                                      p.dtype, p.device)
    plain_ms = time_ms(plain or (lambda: R.score_topk_plain(p, Q, k, Qb)),
                       reps=3, warmup=1)
    lib_ms = None
    if library:
        def lib():
            for c in range(0, p.shape[0], 2048):
                s = torch.matmul(p[c:c + 2048].float(), Q.T)
                torch.topk(s if Qb is None else s + Qb, k, dim=1)
        lib_ms = time_ms(lib, reps=3, warmup=1)
    nbytes, flops = k5_work(p.shape[0], Q.shape[0], Q.shape[1], k,
                            Qb is not None, p.element_size())
    bms, by = bound_ms(nbytes, flops)
    if form == "tc":
        products = 2 / 3 if p.dtype == torch.bfloat16 else 1
        tf32 = bound_tf32_ms(nbytes, flops * products)
        if tf32 < bms:
            bms, by = tf32, ("bytes" if 1e3 * nbytes / PEAK_BYTES_S >= tf32
                             else "operations")
    return dict(B=p.shape[0], N=Q.shape[0], d=Q.shape[1], k=k, form=form,
                splits=splits, max_abs_err=err,
                ids_differing_at_ties=tie_ids, ms=ms, device_ms=dev_ms,
                stream_ops_per_call=ops, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bms, bound_by=by)


def capture_k6(ann, fn):
    """Run ``fn`` with the IVF search's K6 call recorded: (fn's result,
    the call's (arguments, keyword arguments))."""
    seen = []
    real = ann.ivf_tile_topk

    def spy(*args, **kwargs):
        seen.append((args, kwargs))
        return real(*args, **kwargs)
    ann.ivf_tile_topk = spy
    try:
        out = fn()
    finally:
        ann.ivf_tile_topk = real
    check(len(seen) == 1, f"search made {len(seen)} K6 calls")
    return out, seen[0]


def k6_main(R, args, kwargs):
    """The kernel name K6's call launches once (for ``trace_ms``): the
    small form's where the call has small tiles, else the scan's."""
    if not hasattr(R, "ivf_tile_classes"):
        return "ivf_tile_topk_kernel"
    queries, kk = args[0], args[6]
    small, _ = R.ivf_tile_classes(kwargs["ln_host"], R.ivf_small_rows(
        queries.shape[1], kk))
    return "ivf_tile_topk_small" if len(small) else "ivf_tile_topk_kernel"


def k6_forms_of(R, fn):
    """{form: launches} of K6's forms in one call of ``fn`` (the wrapper's
    counters; {} where it has none)."""
    names = ("small_launches", "scan_launches")
    if not hasattr(R.ivf_tile_topk, names[0]):
        return {}
    before = [getattr(R.ivf_tile_topk, n) for n in names]
    fn()
    return {n.split("_")[0]: getattr(R.ivf_tile_topk, n) - b
            for n, b in zip(names, before)}


def k6_entry(R, torch, call):
    """K6 on one search's tiles (``call``: its arguments and keyword
    arguments) against its plain version, two launches bitwise equal, with
    its forms' launches, event ms, CUPTI ms (and by kernel), the plain
    version's ms, the library yardstick (one torch.bmm of the gathered
    queries against the gathered slices + one torch.topk over all tiles)
    and the bound: 2 d operations per (live slot, real column) pair; the
    distinct table rows, the queries and the tile arrays read once, the
    (score, position) pairs written."""
    args, kw = call
    queries, table, qidx, qmask, lo, ln, kk, l_cap = args
    got = R.ivf_tile_topk(*args, **kw)
    again = R.ivf_tile_topk(*args, **kw)
    ref = R.ivf_tile_topk_plain(*args)
    T, bq, _ = ref[0].shape
    err, tie_ids = kernel_topk_check(got, ref,
                                     f"K6 (l_cap {l_cap}, bq {bq})")
    check(not bool(torch.isnan(got[0]).any()), "K6 wrote NaN")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "K6 is not repeatable")
    del got, again, ref

    def fn():
        return R.ivf_tile_topk(*args, **kw)
    forms = k6_forms_of(R, fn)
    ms = time_ms(fn, reps=10, warmup=2)
    acts = trace_activities(fn, k6_main(R, args, kw))
    dev_ms = None if acts is None else sum(t * n for t, n in acts.values())
    plain_ms = time_ms(lambda: R.ivf_tile_topk_plain(*args), reps=3,
                       warmup=1)
    cols = torch.arange(l_cap, device=lo.device)

    def lib():
        rows = (lo.long()[:, None] + cols[None, :]).clamp(
            max=table.shape[0] - 1)
        s = torch.bmm(queries[qidx.long()], table[rows].transpose(1, 2))
        torch.topk(s, kk, dim=2)
    lib_ms = time_ms(lib, reps=3, warmup=1)
    live = qmask.sum(1).long()
    pairs = int((live * ln.long()).sum())
    covered = torch.zeros(table.shape[0] + 1, dtype=torch.int32,
                          device=lo.device)
    covered.index_add_(0, lo.long(), torch.ones_like(lo))
    covered.index_add_(0, (lo + ln).long(), -torch.ones_like(lo))
    rows_read = int((covered.cumsum(0) > 0).sum())
    d = queries.shape[1]
    nbytes = (4 * d * (rows_read + queries.shape[0]) + 9 * T * bq + 8 * T
              + 8 * T * bq * kk)
    bms, by = bound_ms(nbytes, 2 * d * pairs)
    return dict(tiles=T, bq_cap=bq, l_cap=l_cap, kk=kk, d=d,
                live_slots=int(live.sum()), live_pairs=pairs,
                table_rows_read=rows_read, forms=forms, max_abs_err=err,
                ids_differing_at_ties=tie_ids, ms=ms, device_ms=dev_ms,
                device_ms_by_kernel=None if acts is None else {
                    k: t * n for k, (t, n) in acts.items()},
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                bound_by=by)


def k6_tiles(R, rng, d, kk, l_cap=256, bq=64, B=500, N=3000):
    """K6 arguments on random rows with tiles at every class edge: empty,
    one row, fewer rows than kk, the small form's last row count and one
    past it, l_cap rows, the table's last rows, an all-masked tile, and
    random ones; 80% of the other slots live.  (args, ln on the host)."""
    edge = R.ivf_small_rows(d, kk)
    ln = [0, 1, max(kk - 1, 1), l_cap, 5] + ([edge, edge + 1] if edge else [])
    T = len(ln) + 24
    ln = np.array(ln + list(rng.integers(0, l_cap + 1, T - len(ln))),
                  dtype=np.int32)
    lo = rng.integers(0, N - l_cap, size=T).astype(np.int32)
    lo[4] = N - 5
    qmask = rng.random((T, bq)) < 0.8
    qmask[-1] = False
    qidx = rng.integers(0, B, size=(T, bq)).astype(np.int32)
    args = (rng.standard_normal((B, d), dtype=np.float32),
            rng.standard_normal((N, d), dtype=np.float32), qidx, qmask, lo,
            ln)
    return args, ln


def topk_agrees(got, ref):
    """``kernel_topk_check``'s verdict without failing the run."""
    import torch

    (gv, gi), (rv, ri) = got, ref
    close = torch.isclose(gv, rv, rtol=TOL_SCORE, atol=TOL_SCORE_ABS)
    return bool(close.all()) and bool(((gi == ri) | close).all())


def k6_forms(R, torch, dev):
    """K6's two forms against the plain version on tiles at every class
    edge (``k6_tiles``), d = 13 (the scan), 100 and 300 at kk = 10 (both
    forms), each at kk = 100 (the scan): each form launched (its counter),
    two calls bitwise equal; a mutant that drops each tile's last row (the
    kernel given ln - 1, against the plain version on ln) must fail, for
    the tiles of each form."""
    out = {}
    for d in (13, 100, 300):
        for kk in (10, 100):
            rng = np.random.default_rng(d + kk)
            host, ln = k6_tiles(R, rng, d, kk)
            args = [torch.from_numpy(a).to(dev) for a in host]
            small, scan = R.ivf_tile_classes(ln, R.ivf_small_rows(d, kk))
            forms = k6_forms_of(R, lambda: R.ivf_tile_topk(
                *args, kk, 256, ln_host=ln))
            want = dict(small=int(len(small) > 0), scan=int(len(scan) > 0))
            check(forms == want and want["scan"] == 1 and want["small"]
                  == (kk <= 32 and d >= R.IVF_SMALL_MIN_D),
                  f"K6 at d = {d}, kk = {kk} launched {forms}, expected "
                  f"{want}")
            got = R.ivf_tile_topk(*args, kk, 256, ln_host=ln)
            again = R.ivf_tile_topk(*args, kk, 256, ln_host=ln)
            ref = R.ivf_tile_topk_plain(*args, kk, 256)
            err, _ = kernel_topk_check(got, ref, f"K6 forms at d = {d}, "
                                       f"kk = {kk}")
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"K6 at d = {d}, kk = {kk} is not repeatable")
            mutants = {}
            for form, tiles in (("small", small), ("scan", scan)):
                cut = ln.copy()
                sel = tiles[ln[tiles] > 0]
                if not len(sel):
                    continue
                cut[sel] -= 1
                bad = R.ivf_tile_topk(*args[:5], torch.from_numpy(cut).to(
                    dev), kk, 256, ln_host=ln)
                mutants[form] = topk_agrees(bad, ref)
                check(not mutants[form], f"K6's check at d = {d}, kk = {kk} "
                      f"passes its {form} tiles' last rows dropped")
            out[f"d{d}_kk{kk}"] = dict(
                tiles=len(ln), small_tiles=len(small), scan_tiles=len(scan),
                small_max_rows=R.ivf_small_rows(d, kk), max_abs_err=err,
                forms=forms, mutant_passes=mutants)
    torch.cuda.synchronize()
    return dict(cases=out, max_abs_err=max(c["max_abs_err"]
                                           for c in out.values()))


def k7_work(N, D, C):
    """(bytes, operations) of K7's function: the rows, the assignment and
    the old centroids read once, the new written; one add per row
    element."""
    return 4 * N * D + 4 * N + 8 * C * D, N * D


def k7_entry(R, torch, unit, assign, cent):
    """K7 on one Lloyd update against its plain version (centroids within
    TOL_CENT), two launches bitwise equal, at most K7_MAX_LAUNCHES kernel
    launches a call; its event ms, CUPTI ms in all and by launch, the plain
    version's, the library yardstick (index_add_ + bincount) and the bound
    (``k7_work``)."""
    got = R.kmeans_update(unit, assign, cent)
    again = R.kmeans_update(unit, assign, cent)
    ref = R.kmeans_update_plain(unit, assign, cent)
    err = float((got - ref).abs().max())
    check(err <= TOL_CENT, f"K7 centroids off the plain version by {err:.3g}")
    check(bool(torch.equal(got, again)), "K7 is not deterministic")
    ms = time_ms(lambda: R.kmeans_update(unit, assign, cent), reps=10,
                 warmup=2)
    # its launches, cell_histogram the first, once per call
    acts = trace_activities(lambda: R.kmeans_update(unit, assign, cent),
                            "cell_histogram")
    check(acts is not None, "K7's trace holds too few calls")
    launches = sum(n for k, (_, n) in acts.items() if "emset" not in k)
    check(launches <= K7_MAX_LAUNCHES, f"K7 made {launches} launches a "
          f"call, more than {K7_MAX_LAUNCHES}: {sorted(acts)}")
    dev_ms = sum(t * n for t, n in acts.values())
    plain_ms = time_ms(lambda: R.kmeans_update_plain(unit, assign, cent),
                       reps=5, warmup=1)
    a = assign.reshape(-1).long()

    def lib():
        torch.zeros_like(cent).index_add_(0, a, unit)
        torch.bincount(a, minlength=cent.shape[0])
    lib_ms = time_ms(lib, reps=5, warmup=1)
    (N, D), C = unit.shape, cent.shape[0]
    bms, by = bound_ms(*k7_work(N, D, C))
    return dict(N=N, D=D, cells=C, max_abs_err=err, ms=ms, device_ms=dev_ms,
                launches_per_call=launches,
                device_ms_by_launch={k: t * n for k, (t, n) in acts.items()},
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                bound_by=by)


def ivf_unit(table):
    """IVFIndex.build's MIPS-augmented unit rows (parallel/ann.py)."""
    norms = np.linalg.norm(table, axis=1, keepdims=True)
    M = float(norms.max())
    aug = np.sqrt(np.maximum(M * M - norms[:, 0] ** 2, 0.0)).astype(np.float32)
    return np.concatenate([table, aug[:, None]], axis=1) / max(M, 1e-12)


def catalog_path(bt, R, torch, dev):
    """The README's serving configuration on a KakaoBrunch-shaped catalog
    (BRUNCH_ITEMS x BRUNCH_D, seed 21): with K5-K7's counts set to 0 just
    before, 10,000 queries through batch_topn (float32, then bfloat16
    queries), an IVFIndex (BRUNCH_CELLS cells, spill 2, 10 iterations) and
    its search at each of BRUNCH_PROBES; then each kernel against its
    plain version at these shapes with its times and bound; and one call
    on a BIG_ITEMS x BIG_D catalog (the tiled path), held to the plain
    tiled version.  Returns the kernels line's K5-K7 entries and their
    launches."""
    from buffalo_tpu_torch.ops.topk import batch_topn
    from buffalo_tpu_torch.parallel import ann

    rng = np.random.default_rng(21)
    table, queries = brunch_tables(rng, BRUNCH_ITEMS, BRUNCH_D,
                                   BRUNCH_QUERIES)
    out = {}
    reset_counts(R.KERNELS)
    # ---- the user's calls
    ms_first, (ids, scores) = wall_ms(
        lambda: batch_topn(queries, table, TOPK, device=dev))
    ms_warm, (ids2, _) = wall_ms(
        lambda: batch_topn(queries, table, TOPK, device=dev))
    ms_bf16, (ids16, scores16) = wall_ms(
        lambda: batch_topn(queries, table, TOPK, query_dtype="bfloat16",
                           device=dev))
    check(np.array_equal(ids, ids2), "two batch_topn calls differ")
    probe = BRUNCH_QUERIES // 10  # numpy's exact scan on a tenth
    same, err = agree_with_numpy(ids[:probe], scores[:probe], *numpy_topk(
        queries[:probe], table, TOPK), "batch_topn (brunch)")
    out["batch_topn"] = dict(queries=BRUNCH_QUERIES, topk=TOPK,
                             host_ms_first=ms_first, host_ms_warm=ms_warm,
                             host_ms_bf16=ms_bf16,
                             same_as_numpy_first_tenth=same,
                             max_abs_score_err=err,
                             bf16_recall_at_10=recall_at(ids16, ids))
    build_ms, index = wall_ms(lambda: bt.IVFIndex.build(
        table, n_clusters=BRUNCH_CELLS, spill=2, n_iters=10, device=dev))
    out["ivf_build"] = dict(cells=BRUNCH_CELLS, spill=2, n_iters=10,
                            host_ms=build_ms,
                            inverted_file_rows=int(len(index.ids)))
    k6_args = {}
    R.ivf_tile_topk.small_launches = R.ivf_tile_topk.scan_launches = 0
    for n_probe in BRUNCH_PROBES:
        index.n_probe = n_probe
        (ms, (aids, _)), k6_args[n_probe] = capture_k6(
            ann, lambda: wall_ms(lambda: index.search(queries, TOPK)))
        ms_warm, _ = wall_ms(lambda: index.search(queries, TOPK))
        out[f"ivf_search_probe{n_probe}"] = dict(
            host_ms_first=ms, host_ms_warm=ms_warm,
            recall_at_10=recall_at(aids, ids))
    # the exact search: BRUNCH_EXACT queries probing every cell, whose
    # tiles carry hundreds of rows
    index.n_probe = BRUNCH_CELLS
    exact = queries[:BRUNCH_EXACT]
    (ms, (aids, ascores)), k6_args["all"] = capture_k6(
        ann, lambda: wall_ms(lambda: index.search(exact, TOPK)))
    ms_warm, _ = wall_ms(lambda: index.search(exact, TOPK))
    same, err = agree_with_numpy(aids[:probe // 10], ascores[:probe // 10],
                                 *numpy_topk(exact[:probe // 10], table,
                                             TOPK), "IVF search, every cell")
    out["ivf_search_all_cells"] = dict(
        queries=BRUNCH_EXACT, host_ms_first=ms, host_ms_warm=ms_warm,
        recall_at_10=recall_at(aids, ids[:BRUNCH_EXACT]),
        same_as_numpy_first=probe // 10, max_abs_score_err=err)
    launches = read_counts(R.KERNELS)
    k6_forms_run = dict(small=R.ivf_tile_topk.small_launches,
                        scan=R.ivf_tile_topk.scan_launches)
    check(all(v > 0 for v in launches.values())
          and all(v > 0 for v in k6_forms_run.values()),
          f"a retrieval kernel never launched on the catalog: {launches}, "
          f"K6's forms {k6_forms_run}")

    # ---- each kernel against its plain version at these shapes
    p = torch.from_numpy(queries).to(dev)
    Q = torch.from_numpy(table).to(dev)
    k5 = k5_entry(R, torch, p, Q, TOPK, "K5 (brunch)")
    k5["bf16"] = k5_entry(R, torch, p.to(torch.bfloat16), Q, TOPK,
                          "K5 (brunch, bfloat16 queries)", library=False)
    unit = torch.from_numpy(np.ascontiguousarray(ivf_unit(table))).to(dev)
    cent = torch.from_numpy(index.centroids).to(dev)
    chunk = unit[:1 << 16]

    def assign():
        return torch.cat([R.score_topk(unit[c:c + (1 << 16)], cent, 1)[1]
                          for c in range(0, len(unit), 1 << 16)])
    k5_assign = k5_entry(R, torch, chunk, cent, 1, "K5 (k-means, k = 1)",
                         library=False)
    k5_assign["full_assignment_ms"] = time_ms(assign, reps=5, warmup=1)
    k5_spill = k5_entry(R, torch, chunk, cent, 2, "K5 (spill, k = 2)",
                        library=False)
    k7 = k7_entry(R, torch, unit, assign(), cent)
    k6 = {n: k6_entry(R, torch, k6_args[n]) for n in (*BRUNCH_PROBES, "all")}
    del unit, cent, chunk, k6_args
    phase("catalog_path", items=BRUNCH_ITEMS, d=BRUNCH_D, **out,
          launches=launches, k6_form_launches=k6_forms_run, k5=k5,
          k5_kmeans_assign=k5_assign,
          k5_spill_assign=k5_spill, k6=k6, k7=k7)
    del p, Q, index, table, queries
    torch.cuda.empty_cache()

    # ---- a 5M x 64 catalog: the JAX package's gate would tile it (a
    # 2048 x 5M score matrix), K5 scans the staged table whole in one
    # launch; held to the plain tiled version (per-tile top-k + merge over
    # a padded copy made for it alone)
    from buffalo_tpu_torch.ops import topk as T

    big, bq = brunch_tables(rng, BIG_ITEMS, BIG_D, BIG_QUERIES)
    check(min(2048, BIG_QUERIES) * BIG_ITEMS * 4 > T._FLAT_SCORES_BYTES,
          "the 5M catalog is not past the plain versions' gate")
    reset_counts(R.KERNELS)
    ms_big, (bids, bscores) = wall_ms(
        lambda: batch_topn(bq, big, TOPK, device=dev))
    ms_big_warm, (bids2, _) = wall_ms(
        lambda: batch_topn(bq, big, TOPK, device=dev))
    big_launches = read_counts(R.KERNELS)
    check(big_launches["score_topk"] == 2, f"the 5M calls: {big_launches}")
    check(np.array_equal(bids, bids2), "two 5M batch_topn calls differ")
    same, err = agree_with_numpy(bids[:64], bscores[:64], *numpy_topk(
        bq[:64], big, TOPK), "batch_topn (5M)")
    tile = 1 << 20
    ntiles = -(-BIG_ITEMS // tile)
    Qg = torch.from_numpy(big).to(dev)
    Q_t = torch.zeros(ntiles * tile, BIG_D, device=dev)
    Q_t[:BIG_ITEMS] = Qg
    Qb_t = torch.full((ntiles * tile,), float("-inf"), device=dev)
    Qb_t[:BIG_ITEMS] = 0.0
    pb = torch.from_numpy(bq).to(dev)
    del big
    big_entry = k5_entry(
        R, torch, pb, Qg, TOPK, "K5 (5M)", library=False,
        plain=lambda: R.tiled_topk_plain(pb, Q_t.reshape(ntiles, tile, -1),
                                         Qb_t.reshape(ntiles, tile), TOPK))
    phase("catalog_path_5m", items=BIG_ITEMS, d=BIG_D, queries=BIG_QUERIES,
          host_ms_first=ms_big, host_ms_warm=ms_big_warm,
          launches=big_launches, same_as_numpy_first_64=same,
          max_abs_score_err=err, k5=big_entry)
    del Qg, Q_t, Qb_t, pb
    T._stage_cache = None  # the staged 5M table
    torch.cuda.empty_cache()
    entries = {
        "score_topk": dict(
            route="cuda", source="buffalo_tpu_torch/csrc/score_topk.cu",
            replaces="buffalo_tpu/ops/topk.py:171",
            max_abs_err=max(k5["max_abs_err"], k5["bf16"]["max_abs_err"],
                            k5_assign["max_abs_err"],
                            k5_spill["max_abs_err"],
                            big_entry["max_abs_err"]),
            **{f: k5[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "form", "device_ms",
                                  "stream_ops_per_call")}),
        "ivf_tile_topk": dict(
            route="cuda", source="buffalo_tpu_torch/csrc/ivf_tile_topk.cu",
            replaces="buffalo_tpu/parallel/ann.py:54",
            max_abs_err=max(e["max_abs_err"] for e in k6.values()),
            **{f: k6[32][f] for f in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms",
                                      "device_ms")},
            form=k6_forms_run),
        "kmeans_update": dict(
            route="cuda", source="buffalo_tpu_torch/csrc/kmeans_update.cu",
            replaces="buffalo_tpu/parallel/ann.py:220",
            **{f: k7[f] for f in ("max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms",
                                  "device_ms")}),
    }
    return entries, launches


def retrieval_widths(R, torch, dev):
    """K5 and K6 against their plain versions on small random inputs at
    d = 13, 40, 100, 160, 256 and k = 1, 10, 100, 1024, K5 with and without
    a bias, N = 2,500 (no multiple of an item tile), B = 300 (none of a
    query block), three rows duplicating a fourth (their equal scores must
    come back in index order); K6 on 40 tiles with empty, one-row, full and
    last-rows-of-the-table tiles and 20% of the slots masked."""
    out = {}
    for d in (13, 40, 100, 160, 256):
        rng = np.random.default_rng(d)
        Q = rng.standard_normal((2500, d), dtype=np.float32)
        Q[5] *= 10  # the best match of p[0]
        Q[[17, 400, 1999]] = Q[5]
        p = rng.standard_normal((300, d), dtype=np.float32)
        p[:3] = Q[5]
        Qb = rng.standard_normal(2500, dtype=np.float32)
        p, Q, Qb = (torch.from_numpy(a).to(dev) for a in (p, Q, Qb))
        table = rng.standard_normal((3000, d), dtype=np.float32)
        queries = rng.standard_normal((500, d), dtype=np.float32)
        for k in (1, 10, 100, 1024):
            for bias in (None, Qb):
                got = R.score_topk(p, Q, k, bias)
                err, _ = kernel_topk_check(
                    got, R.score_topk_plain(p, Q, k, bias),
                    f"K5 at d = {d}, k = {k}")
                if bias is None and k >= 4:
                    check(got[1][0, :4].tolist() == [5, 17, 400, 1999],
                          f"K5 at d = {d}: duplicated rows out of order")
                out[f"K5_d{d}_k{k}" + ("_bias" if bias is not None
                                        else "")] = err
            l_cap, bq = (1024, 256) if k == 1024 else (256, 64)
            ln = rng.integers(0, l_cap + 1, size=40).astype(np.int32)
            ln[:3] = [0, 1, l_cap]
            lo = rng.integers(0, 3000 - l_cap, size=40).astype(np.int32)
            lo[-1], ln[-1] = 3000 - 5, 5
            args = [torch.from_numpy(a).to(dev) for a in (
                queries, table,
                rng.integers(0, 500, size=(40, bq)).astype(np.int32),
                rng.random((40, bq)) < 0.8, lo, ln)]
            got = R.ivf_tile_topk(*args, k, l_cap, ln_host=ln)
            check(not bool(torch.isnan(got[0]).any()), "K6 wrote NaN")
            out[f"K6_d{d}_k{k}"], _ = kernel_topk_check(
                got, R.ivf_tile_topk_plain(*args, k, l_cap),
                f"K6 at d = {d}, kk = {k}")
    torch.cuda.synchronize()
    return dict(max_abs_err=max(out.values()), cases=len(out))


def trace_ms(fn, main, reps=10, warmup=2):
    """Device milliseconds per call of ``fn`` from a torch.profiler (CUPTI)
    trace (``trace_stats``)."""
    return trace_stats(fn, main, reps, warmup)[0]


def trace_stats(fn, main, reps=10, warmup=2, tries=3):
    """(device milliseconds per call of ``fn`` from a torch.profiler
    (CUPTI) trace of ``reps`` calls: for each distinct device activity
    (kernels, memsets, copies) its median duration times its launches per
    call (its count over the calls, rounded), summed; the device activities
    per call, the same counts summed).  A trace can drop events (on the
    H100 one has held 19 of 20 launches of a kernel, and fewer late in a
    run), so the medians and the rounded counts are what a few dropped
    events leave unchanged.  A trace that holds fewer than half the
    calls (counted by the launches of ``main``) is taken again, up to
    ``tries`` times; then (None, None)."""
    acts = trace_activities(fn, main, reps, warmup, tries)
    if acts is None:
        return None, None
    return (sum(ms * n for ms, n in acts.values()),
            sum(n for _, n in acts.values()))


def trace_activities(fn, main, reps=10, warmup=2, tries=3):
    """``trace_stats``' reading by device activity: {name: (its median
    milliseconds, its launches per call)}, or None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        try:   # keep every cycle's events (torch.profiler's own advice)
            prof = profile(activities=[ProfilerActivity.CUDA],
                           acc_events=True)
        except TypeError:
            prof = profile(activities=[ProfilerActivity.CUDA])
        with prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                us.setdefault(e.name, []).append(e.time_range.elapsed_us())
        calls = sum(len(v) for k, v in us.items() if main in k)
        if reps // 2 <= calls <= reps:
            return {k: (float(np.median(v)) / 1e3,
                        max(1, round(len(v) / calls)))
                    for k, v in us.items()}
    return None


def epoch_chunks(torch, model, batch):
    """A trained BPR-MF's or WARP's resident epoch chunks on its device:
    (nchunks, batch) users and positives in CSR order, padded with zeros
    past nnz, and nnz."""
    from buffalo_tpu_torch.data.batching import csr_pair_chunks

    users, items, nnz = csr_pair_chunks(model.data, batch)
    return (torch.from_numpy(users).to(model.device),
            torch.from_numpy(items).to(model.device), nnz)


def one_shard(dev):
    """The mesh of one shard on ``dev``: the single device's epoch."""
    from buffalo_tpu_torch.parallelism import Mesh

    return Mesh([dev])


def bpr_opt(bt, **kw):
    """BPRMF options of this script's runs: the defaults at d = D on the
    card, no validation inside the epochs (it runs after training), with
    ``kw`` on top."""
    opt = bt.BPRMFOption().get_default_option()
    opt.update(d=D, num_iters=BPR_EPOCHS, device="cuda",
               validation={"topk": TOPK}, evaluation_on_learning=False)
    opt.update(kw)
    return opt


def bpr_train(bt, S, torch, data, opt):
    """A BPRMF of ``opt`` from the factors of seed 0, trained with the BPR
    kernels' counts set to 0 just before: (model, launches, peak MB)."""
    model = bt.BPRMF(opt, data=data)
    np.random.seed(0)
    model.initialize()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(S.KERNELS)
    model.train()
    launches = read_counts(S.KERNELS)
    losses = model.iteration_losses
    check(len(losses) == opt.num_iters and all(np.isfinite(losses))
          and all(np.isfinite(t).all() for t in (model.P, model.Q, model.Qb)),
          f"BPR ({opt.optimizer}) trained non-finite values: {losses}")
    return model, launches, torch.cuda.max_memory_allocated() / 2 ** 20


def bpr_path(bt, S, R, torch, data):
    """BPRMF on the ML-20M data at d = D with the default options, BPR_EPOCHS
    epochs through the user's entry points: the loss falls, each epoch
    launches K8 and K9 once per chunk (and K9's loss once) and nothing
    else, validation after training; top-10 for BPR_USERS users through
    ParBPRMF (K5 with the item bias) equal to numpy with ties by index;
    then one epoch each of adagrad and adam (K9's accumulation, K10 on P, Q
    and Qb) and one streamed epoch.  Returns (the sgd model, the path's
    launches for the kernels line)."""
    model, launches, peak_mb = bpr_train(bt, S, torch, data, bpr_opt(bt))
    nchunks = -(-model.num_nnz // model._batch_size())
    losses = model.iteration_losses
    check(losses[-1] < losses[0], f"BPR loss did not fall: {losses}")
    want = dict(sample_negatives=nchunks * BPR_EPOCHS,
                chunk_update=nchunks * BPR_EPOCHS, triplet_loss=BPR_EPOCHS,
                chunk_accumulate=0, deferred_update=0, chunk_delta=0,
                chunk_bias_neg_delta=0, capped_add=0)
    check(launches == want, f"BPR sgd epochs launched {launches}, "
          f"expected {want}")
    st = time.perf_counter()
    val = model.get_validation_results()
    val_s = time.perf_counter() - st
    check(np.isfinite(val["ndcg"]) and 0.5 < val["auc"] <= 1.0,
          f"BPR validation: {val}")
    med = float(np.median(model.iteration_times[1:]))

    reset_counts(R.KERNELS)
    users = [str(u) for u in range(BPR_USERS)]
    par = bt.ParBPRMF(model)
    ms_first, (keys, ids, scores) = wall_ms(
        lambda: par.topk_recommendation(users, topk=TOPK))
    ms_warm, _ = wall_ms(lambda: par.topk_recommendation(users, topk=TOPK))
    k5 = R.score_topk.launches
    check(keys == users and ids.shape == (BPR_USERS, TOPK) and k5 == 2,
          f"ParBPRMF top-10 malformed or not one K5 launch per call ({k5})")
    same = ids_match_numpy(ids, model.P[:BPR_USERS], model.Q, model.Qb,
                           "ParBPRMF.topk_recommendation")
    phase("bpr_path", d=D, epochs=BPR_EPOCHS, optimizer="sgd",
          chunks_per_epoch=nchunks, chunk=model._batch_size(),
          train_loss=losses, val_ndcg=val["ndcg"], val_auc=val["auc"],
          val_map=val["map"], validation_seconds=val_s,
          epoch_seconds=model.iteration_times,
          median_epoch_seconds_2_4=med, samples_per_s=model.num_nnz / med,
          launches=launches, launches_per_epoch=per_epoch(launches,
                                                          BPR_EPOCHS),
          max_memory_allocated_mb=peak_mb, topk_users=BPR_USERS,
          topk_k5_launches=k5, topk_host_ms_first=ms_first,
          topk_host_ms_warm=ms_warm, topk_same_as_numpy=same)
    path_launches = {
        "sample_negatives": launches["sample_negatives"],
        "bpr_chunk_update": launches["chunk_update"]
        + launches["triplet_loss"], "deferred_update": 0}

    runs = {}
    for name, extra in (("adagrad", dict(optimizer="adagrad")),
                        ("adam", dict(optimizer="adam", lr=0.02)),
                        ("stream", dict(resident_mb=BPR_STREAM_RESIDENT_MB))):
        m, ln, mb = bpr_train(bt, S, torch, data,
                              bpr_opt(bt, num_iters=1, **extra))
        if name == "stream":
            check(model.num_nnz * 8 > BPR_STREAM_RESIDENT_MB << 20
                  and ln["sample_negatives"] == ln["chunk_update"]
                  == nchunks and ln["deferred_update"] == 0,
                  f"the streamed BPR epoch launched {ln}")
        else:
            check(ln["chunk_accumulate"] == nchunks
                  and ln["deferred_update"] == 3 and ln["chunk_update"] == 0,
                  f"the {name} BPR epoch launched {ln}")
            path_launches["deferred_update"] += ln["deferred_update"]
            path_launches["bpr_chunk_update"] += ln["chunk_accumulate"]
        runs[name] = dict(train_loss=m.iteration_losses[0],
                          epoch_seconds=m.iteration_times[0], launches=ln,
                          max_memory_allocated_mb=mb)
        del m
    phase("bpr_variants", d=D, sgd_first_epoch_loss=losses[0], **runs)
    return model, path_launches


def k8_work(S, torch, users, bloom, log2, num_items, seed, chunk):
    """(bytes, int32 operations) of K8's function on a chunk: the user ids
    read, the negatives written, one bloom word read per attempt made (the
    attempts this chunk's draws need); per attempt Philox4x32-10 (10
    rounds of 2 wide multiplies, 4 xors and 2 key adds: ~100 operations),
    the two bloom hashes (~22) and the draw (~4)."""
    slot = torch.arange(users.shape[0], device=users.device,
                        dtype=torch.int64)
    u = users.long()
    done = torch.zeros_like(slot, dtype=torch.bool)
    attempts = 0
    for a in range(S.NUM_ATTEMPTS):
        attempts += int((~done).sum())
        x0 = S.philox4x32((slot, chunk, 0, a), S._seed_key(seed))[0]
        cand = (x0 * num_items) >> 32
        word, b1, b2 = S.bloom_hashes_plain(u, cand, log2)
        w = bloom[word].long() & 0xFFFFFFFF
        done |= ((w >> b1) & (w >> b2) & 1) == 0
    return 8 * users.shape[0] + 4 * attempts, 126 * attempts, attempts


def k9_work(users, pos, neg, d, num_items):
    """(bytes, operations) of K9's sgd function on a chunk: ids read, the
    touched rows of P, Q and Qb read and written once; per sample the
    logit (3 d), its user term (3 d) and its negative's item term (2 d),
    per slot its positive's item term (2 d), per touched row the step,
    its norm and the write (6 d)."""
    import torch

    n_u = int(torch.unique(users).numel())
    ok = neg[neg < num_items]
    n_i = int(torch.unique(torch.cat([pos, ok])).numel())
    B, N = neg.shape[0], users.shape[0]
    nbytes = 8 * N + 4 * B + 8 * d * (n_u + n_i) + 8 * n_i
    return nbytes, 8 * d * B + 2 * d * N + 6 * d * (n_u + n_i)


def step_check(got, ref, start, tol=TOL_BPR_STEP):
    """(passes, max |got - ref|, the limit): a kernel's step against the
    plain version's, within ``tol`` of the plain version's largest step plus
    two float32 spacings of the table's largest value."""
    err = float((got - ref).abs().max())
    limit = (tol * float((ref - start).abs().max())
             + 2 * 2 ** -23 * float(start.abs().max()))
    return err <= limit, err, limit


def k9_hot_chunk(torch, users, pos):
    """The chunk of one user (the chunk's first) whose positives are
    HOT_ITEM_SHARE its first slot's item, the rest as they were: the
    longest user and item rows a chunk can hold."""
    g = torch.Generator(device="cpu").manual_seed(7)
    hot = (torch.rand(pos.shape[0], generator=g) < HOT_ITEM_SHARE).to(
        pos.device)
    return (torch.full_like(users, int(users[0])),
            torch.where(hot, pos[:1].expand_as(pos), pos).contiguous())


def k9_hot_check(S, torch, fn, tables, users, pos, neg, kw, what):
    """K9's sgd step (``fn`` chunk_update) or delta (chunk_delta, from zero
    deltas) on a hot chunk with the users presorted and grouped: each run
    twice bitwise equal, within TOL_BPR_STEP of the plain version run in
    float64.  Returns the largest error."""
    hot_u, hot_p = k9_hot_chunk(torch, users, pos)
    delta = fn is S.chunk_delta

    def run(f, ts, **over):
        out = [torch.zeros_like(t) for t in ts] if delta else \
            [t.clone() for t in ts]
        if delta:
            f(*ts, *out, hot_u, hot_p, neg, **dict(kw, **over))
        else:
            f(*out, hot_u, hot_p, neg, **dict(kw, **over))
        return out

    ref = run(S.chunk_delta_plain if delta else S.chunk_update_plain,
              [t.double() for t in tables])
    err = 0.0
    for flag in (True, False):
        a, b = run(fn, tables, users_sorted=flag), \
            run(fn, tables, users_sorted=flag)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"{what} on the hot chunk (users_sorted={flag}) is not "
              "bitwise repeatable")
        for x, r, t in zip(a, ref, tables):
            ok, e, limit = step_check(x, r.float(),
                                      torch.zeros_like(t) if delta else t)
            check(ok, f"{what} on the hot chunk (users_sorted={flag}) is "
                  f"{e:.3g} from the float64 plain version (limit "
                  f"{limit:.3g})")
            err = max(err, e)
    return err


def bpr_kernels(S, torch, model):
    """K8, K9 and K10 against their plain versions on an ML-20M chunk of the
    sgd model's resident epoch (users in CSR order, its trained tables, the
    2^23-word bloom filter): K8 bit for bit; K9's sgd step within
    TOL_BPR_STEP, bitwise repeatable, the users presorted (as the resident
    epoch calls it) and grouped by row agreeing within TOL_BPR_STEP, a K9
    run with the clip off failing the check, the hot chunk
    (``k9_hot_check``), at most K9_MAX_STREAM_OPS stream operations per
    call; its accumulation (bitwise repeatable) and loss; K10's adam and
    adagrad steps on the item and user tables within TOL_K10.  Event ms,
    CUPTI ms (``trace_stats``), the plain and library ms and the bounds.
    Returns the kernels line's K8-K10 entries."""
    dev = model.device
    batch = model._batch_size()
    users_c, items_c, nnz = epoch_chunks(torch, model, batch)
    c = users_c.shape[0] // 2
    users, pos = users_c[c].contiguous(), items_c[c].contiguous()
    group = model.data.get_group("rowwise")
    words, log2 = S.build_bloom(np.asarray(group["indptr"]),
                                np.asarray(group["key"]))
    bloom = torch.from_numpy(words.view(np.int32)).to(dev)
    I = model.Q.shape[0]
    seed = int(model.opt.random_seed)
    kw8 = dict(num_negatives=1, seed=seed, epoch=0, chunk=c, bloom=bloom,
               bloom_log2=log2)
    neg, _ = S.sample_negatives(users, I, **kw8)
    ref_neg, _ = S.sample_negatives_plain(users, I, **kw8)
    check(torch.equal(neg, ref_neg), "K8 differs from its plain version")
    sentinels = int((neg == I).sum())
    nbytes, ops, attempts = k8_work(S, torch, users, bloom, log2, I, seed, c)
    t_b, t_o = nbytes / PEAK_BYTES_S, ops / PEAK_INT32_S
    k8 = dict(route="cuda", source="buffalo_tpu_torch/csrc/bpr_sample.cu",
              replaces="buffalo_tpu/ops/sgd_kernels.py:243", max_abs_err=0.0,
              ms=time_ms(lambda: S.sample_negatives(users, I, **kw8)),
              device_ms=trace_ms(lambda: S.sample_negatives(users, I, **kw8),
                                 "sample_kernel"),
              plain_ms=time_ms(lambda: S.sample_negatives_plain(users, I,
                                                                **kw8),
                               reps=5, warmup=1),
              bound_ms=1e3 * max(t_b, t_o),
              bound_by="bytes" if t_b >= t_o else "operations",
              library_ms=None, slots=int(users.shape[0]),
              attempts=attempts, sentinels=sentinels, bloom_words=len(words))

    P0 = torch.from_numpy(model.P).to(dev)
    Q0 = torch.from_numpy(model.Q).to(dev)
    Qb0 = torch.from_numpy(model.Qb).to(dev)
    o = model.opt
    lr = S.sgd_lr(o.lr, o.min_lr, 0, nnz, c, batch, float(nnz) * o.num_iters)
    kw9 = dict(n_valid=batch, lr=lr, reg_u=o.reg_u, reg_i=o.reg_i,
               reg_j=o.reg_j, reg_b=o.reg_b, max_step_norm=o.max_step_norm,
               num_negatives=1, use_bias=True, update_i=True, update_j=True,
               users_sorted=True)

    def run(fn, **over):
        t = [P0.clone(), Q0.clone(), Qb0.clone()]
        fn(*t, users, pos, neg, **dict(kw9, **over))
        return t

    got, again, ref = run(S.chunk_update), run(S.chunk_update), \
        run(S.chunk_update_plain)
    grouped = run(S.chunk_update, users_sorted=False)
    unclipped = run(S.chunk_update, max_step_norm=0.0)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "K9 is not bitwise repeatable")
    fields, errs = {}, []
    for name, g, r, s0, w, gr in zip(("P", "Q", "Qb"), got, ref,
                                     (P0, Q0, Qb0), unclipped, grouped):
        ok, err, limit = step_check(g, r, s0)
        check(ok, f"K9's {name} step is {err:.3g} from the plain version's "
              f"(limit {limit:.3g})")
        ok_g, err_g, limit_g = step_check(gr, g, s0)
        check(ok_g, f"K9's {name} step with the users grouped is {err_g:.3g}"
              f" from the presorted call's (limit {limit_g:.3g})")
        errs.append(err)
        fields[f"{name}_err"], fields[f"{name}_limit"] = err, limit
        fields[f"{name}_grouped_vs_presorted"] = err_g
        fields[f"{name}_max_step"] = float((r - s0).abs().max())
        fields[f"{name}_unclipped_err"] = step_check(w, r, s0)[1]
    check(not all(step_check(w, r, s0)[0] for w, r, s0 in
                  zip(unclipped, ref, (P0, Q0, Qb0))),
          "the K9 check passes a run with the row clip off")
    fields["hot_chunk_err"] = k9_hot_check(
        S, torch, S.chunk_update, (P0, Q0, Qb0), users, pos, neg,
        {k: v for k, v in kw9.items() if k != "users_sorted"},
        "K9's sgd step")
    # the accumulation and the loss
    kw9a = dict(n_valid=batch, num_negatives=1, use_bias=True,
                update_i=True, update_j=True, per_coordinate_normalize=True,
                users_sorted=True)
    acc = [S.new_accumulators(P0, Q0, Qb0) for _ in range(4)]
    for a, fn, over in ((acc[0], S.chunk_accumulate, {}),
                        (acc[1], S.chunk_accumulate, {}),
                        (acc[2], S.chunk_accumulate_plain, {}),
                        (acc[3], S.chunk_accumulate,
                         {"users_sorted": False})):
        fn(P0, Q0, Qb0, *a, users, pos, neg, **dict(kw9a, **over))
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(acc[0], acc[1])),
          "K9's accumulation is not bitwise repeatable")
    for name, g, r, gr in zip(("gP", "gQ", "gQb", "cP", "cQ"), acc[0],
                              acc[2], acc[3]):
        ok, err, limit = step_check(g, r, torch.zeros_like(r))
        check(ok, f"K9's accumulated {name} is {err:.3g} from the plain "
              f"version's (limit {limit:.3g})")
        check(step_check(gr, g, torch.zeros_like(r))[0],
              f"K9's accumulated {name} with the users grouped is off the "
              "presorted call's")
        errs.append(err)
    sub = [torch.from_numpy(a).to(dev) for a in model._sub_samples]
    loss = float(S.triplet_loss(P0, Q0, Qb0, *sub, use_bias=True))
    loss_ref = float(S.triplet_loss_plain(P0, Q0, Qb0, *sub, use_bias=True))
    check(abs(loss - loss_ref) <= 1e-6 * abs(loss_ref),
          f"K9's loss {loss} vs plain {loss_ref}")

    t9 = [P0.clone(), Q0.clone(), Qb0.clone()]
    u_s, p_s, n_ok = users.long(), pos.long(), neg.long() < I
    _, _, _, _, safe, mask, p_r, qi, qj, logit = S._forward(
        P0, Q0, Qb0, users, pos, neg, 1, batch, True)
    rows_p = lr * (logit[:, None] * (qi - qj) - o.reg_u * p_r)
    rows_q = torch.cat([lr * (logit[:, None] * p_r - o.reg_i * qi),
                        (lr * (-logit[:, None] * p_r - o.reg_j * qj))[n_ok]])
    idx_q = torch.cat([p_s, neg.long()[n_ok]])

    def library():
        # the scatter as index_add_ + the clip, from per-sample rows
        t9[0] += S.clip_row_norm(torch.zeros_like(P0).index_add_(
            0, u_s, rows_p), o.max_step_norm)
        t9[1] += S.clip_row_norm(torch.zeros_like(Q0).index_add_(
            0, idx_q, rows_q), o.max_step_norm)

    nbytes, flops = k9_work(users, pos, neg, D, I)
    bms, by = bound_ms(nbytes, flops)

    def fn9(presorted=True):
        S.chunk_update(*t9, users, pos, neg,
                       **dict(kw9, users_sorted=presorted))

    # stream operations per call (kernels and memsets in a CUPTI trace)
    dev_ms, ops = trace_stats(fn9, K9_MAIN)
    ops_grouped = trace_stats(lambda: fn9(False), K9_MAIN)[1]
    check(ops is not None and ops_grouped is not None
          and max(ops, ops_grouped) <= K9_MAX_STREAM_OPS,
          f"K9 makes {ops} (presorted) / {ops_grouped} (grouped) stream "
          f"operations per call (at most {K9_MAX_STREAM_OPS})")
    k9 = dict(route="cuda", source="buffalo_tpu_torch/csrc/bpr_update.cu",
              replaces="buffalo_tpu/ops/sgd_kernels.py:390",
              max_abs_err=max(errs), ms=time_ms(fn9), device_ms=dev_ms,
              stream_ops_per_call=ops, form="presorted",
              grouped_ms=time_ms(lambda: fn9(False)),
              stream_ops_per_call_grouped=ops_grouped,
              plain_ms=time_ms(lambda: S.chunk_update_plain(
                  *t9, users, pos, neg, **kw9), reps=5, warmup=1),
              bound_ms=bms, bound_by=by,
              library_ms=time_ms(library, reps=10, warmup=2),
              slots=int(users.shape[0]), lr=lr, loss=loss, **fields)
    # the accumulation (the adagrad / adam epochs' K9): its bound counts
    # the gradients and counts read and written, the touched P / Q rows
    # read once; the library call index_add_ of the gradient rows computed
    # outside the timing and bincount of the counts
    g9 = S.new_accumulators(P0, Q0, Qb0)
    g_rows_p = logit[:, None] * (qi - qj)
    g_rows_q = torch.cat([logit[:, None] * p_r,
                          (-logit[:, None] * p_r)[n_ok]])

    def library_acc():
        g9[0].index_add_(0, u_s, g_rows_p)
        g9[1].index_add_(0, idx_q, g_rows_q)
        torch.bincount(u_s, minlength=P0.shape[0])
        torch.bincount(idx_q, minlength=Q0.shape[0])

    def fn9a():
        S.chunk_accumulate(P0, Q0, Qb0, *g9, users, pos, neg, **kw9a)

    n_u = int(torch.unique(users).numel())
    n_i = int(torch.unique(idx_q).numel())
    abms, aby = bound_ms(8 * users.shape[0] + 4 * neg.shape[0]
                         + (12 * D + 8) * (n_u + n_i) + 8 * n_i, flops)
    adev_ms, aops = trace_stats(fn9a, K9_MAIN)
    k9["accumulate"] = dict(
        ms=time_ms(fn9a), device_ms=adev_ms, stream_ops_per_call=aops,
        plain_ms=time_ms(lambda: S.chunk_accumulate_plain(
            P0, Q0, Qb0, *g9, users, pos, neg, **kw9a), reps=5, warmup=1),
        bound_ms=abms, bound_by=aby,
        library_ms=time_ms(library_acc, reps=10, warmup=2))

    # K10 on the user and item tables and the bias
    entries = {}
    for opt_name in ("adam", "adagrad"):
        for tname, table in (("P", P0), ("Q", Q0), ("Qb", Qb0)):
            rng = torch.Generator(device=dev).manual_seed(5)
            g = 0.1 * torch.randn(table.shape, generator=rng, device=dev)
            m = 0.01 * torch.randn(table.shape, generator=rng, device=dev)
            v = 0.01 * torch.rand(table.shape, generator=rng, device=dev)
            cnt = torch.randint(0, 9, (table.shape[0],), generator=rng,
                                device=dev).float()
            kw10 = dict(step=3, optimizer=opt_name, lr=0.02, beta1=0.9,
                        beta2=0.999, reg=0.025, per_coordinate_normalize=True)
            a = [table.clone(), g.clone(), m.clone(), v.clone()]
            b = [table.clone(), g.clone(), m.clone(), v.clone()]
            S.deferred_update(*a, cnt, **kw10)
            S.deferred_update_plain(*b, cnt, **kw10)
            err = max(float((x - y).abs().max()) for x, y in zip(a, b))
            check(all(torch.allclose(x, y, rtol=TOL_K10, atol=1e-7)
                      for x, y in zip(a, b)),
                  f"K10 ({opt_name}, {tname}) is {err:.3g} from its plain "
                  "version")
            if tname == "P":
                n = table.numel()
                nbytes = (32 if opt_name == "adam" else 24) * n \
                    + 4 * table.shape[0]
                bms, by = bound_ms(nbytes, 14 * n)
                fn = (lambda: S.deferred_update(*a, cnt, **kw10))
                entries[opt_name] = dict(
                    ms=time_ms(fn), device_ms=trace_ms(fn, "optimizer_kernel"),
                    plain_ms=time_ms(lambda: S.deferred_update_plain(
                        *b, cnt, **kw10)), bound_ms=bms, bound_by=by,
                    elements=n)
            entries.setdefault("max_abs_err", 0.0)
            entries["max_abs_err"] = max(entries["max_abs_err"], err)
    k10 = dict(route="cuda", source="buffalo_tpu_torch/csrc/bpr_optimizer.cu",
               replaces="buffalo_tpu/ops/sgd_kernels.py:315",
               max_abs_err=entries["max_abs_err"], library_ms=None,
               **{f: entries["adam"][f] for f in ("ms", "plain_ms",
                                                  "bound_ms", "bound_by")},
               adam=entries["adam"], adagrad=entries["adagrad"])
    # one sgd epoch's device work (K8 + K9 per chunk) by kernel name
    t = [P0.clone(), Q0.clone(), Qb0.clone()]
    prof = profile_call(torch, lambda: S.bpr_epoch(
        one_shard(dev), {dev: tuple(t)}, {dev: {}}, [users_c], [items_c], 0,
        seed=seed, optimizer="sgd", num_items=I, num_negatives=1,
        use_bias=True, update_i=True, update_j=True,
        sampling={dev: dict(bloom=bloom, bloom_log2=log2)},
        per_coordinate_normalize=False, lr=o.lr, min_lr=o.min_lr,
        beta1=o.beta1, beta2=o.beta2, reg_u=o.reg_u, reg_i=o.reg_i,
        reg_j=o.reg_j, reg_b=o.reg_b, num_valid=nnz,
        total_samples=float(nnz) * o.num_iters,
        max_step_norm=o.max_step_norm), top=16)
    phase("bpr_kernels", d=D, chunk_index=c, chunks=int(users_c.shape[0]),
          k8=k8, k9=k9, k10=k10, tol_step=TOL_BPR_STEP, tol_k10=TOL_K10,
          epoch_profile=prof)
    del users_c, items_c, bloom, t, t9, got, again, ref, unclipped, acc, g9
    del grouped
    torch.cuda.empty_cache()
    return {"sample_negatives": k8, "bpr_chunk_update": k9,
            "deferred_update": k10}


# ------------------------------------------------------------------ WARP
def warp_opt(bt, **kw):
    """WARPOption defaults on the card (d = 64), no validation inside the
    epochs (it runs after training), with ``kw`` on top."""
    opt = bt.WARPOption().get_default_option()
    opt.update(num_iters=WARP_EPOCHS, device="cuda",
               validation={"topk": TOPK}, evaluation_on_learning=False)
    opt.update(kw)
    return opt


def warp_train(bt, W, S, torch, data, opt):
    """A WARP of ``opt`` from the factors of seed 0, trained with the WARP
    kernels' and K10's counts set to 0 just before: (model, launches, peak
    MB, the largest row norm)."""
    model = bt.WARP(opt, data=data)
    np.random.seed(0)
    model.initialize()
    kernels = W.KERNELS + (S.deferred_update,)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    model.train()
    launches = read_counts(kernels)
    losses = model.iteration_losses
    check(len(losses) == opt.num_iters and all(np.isfinite(losses))
          and np.isfinite(model.P).all() and np.isfinite(model.Q).all(),
          f"WARP ({opt.optimizer}) trained non-finite values: {losses}")
    norm = max(float(np.linalg.norm(t, axis=1).max())
               for t in (model.P, model.Q))
    check(norm <= 1 + 1e-6, f"WARP rows left the unit ball: {norm}")
    return model, launches, torch.cuda.max_memory_allocated() / 2 ** 20, norm


def warp_inputs(S, torch, model):
    """The resident epoch's inputs of a trained WARP: (users, items,
    nnz, indptr, bloom words, log2 bits, P, Q)."""
    dev = model.device
    group = model.data.get_group("rowwise")
    users_c, items_c, nnz = epoch_chunks(torch, model,
                                         model._batch_size())
    indptr = torch.from_numpy(np.array(group["indptr"],
                                       dtype=np.int64)).to(dev)
    words, log2 = S.build_bloom(np.asarray(group["indptr"]),
                                np.asarray(group["key"]))
    return (users_c, items_c, nnz, indptr,
            torch.from_numpy(words.view(np.int32)).to(dev), log2,
            torch.from_numpy(model.P).to(dev), torch.from_numpy(model.Q).to(dev))


def warp_path(bt, W, S, R, torch, data):
    """WARP on the ML-20M data with the default options, WARP_EPOCHS epochs
    through the user's entry points: per chunk exactly one K11 and one K12
    launch, two K10 launches (projection mode) and one K11 loss per epoch;
    K and found_frac per epoch, the violation rate, rows in the unit ball,
    validation after training, a profiled epoch, top-10 for WARP_USERS
    users through K5 held to numpy; then one epoch of each variant.
    Returns (the model, the path's launches for the kernels line)."""
    model, launches, peak_mb, norm = warp_train(bt, W, S, torch, data,
                                                warp_opt(bt))
    batch = model._batch_size()
    nchunks = -(-model.num_nnz // batch)
    E = WARP_EPOCHS
    want = dict(warp_search=nchunks * E, warp_probe=0, warp_violations=E,
                warp_accumulate=nchunks * E, deferred_update=2 * E)
    check(launches == want, f"WARP epochs launched {launches}, expected "
          f"{want}")
    st = time.perf_counter()
    val = model.get_validation_results()
    val_s = time.perf_counter() - st
    check(all(np.isfinite(v) for v in val.values()),
          f"WARP validation: {val}")
    med = float(np.median(model.iteration_times[1:]))
    o = model.opt
    users_c, items_c, nnz, indptr, bloom, log2, P, Q = warp_inputs(
        S, torch, model)
    dev = P.device
    prof = profile_call(torch, lambda: W.warp_epoch(
        one_shard(dev), {dev: (P, Q)}, {dev: W.new_opt_state(P, Q)},
        [users_c], [items_c], E, indptr={dev: indptr}, bloom={dev: bloom},
        seed=int(o.random_seed), optimizer=o.optimizer,
        num_items=Q.shape[0], num_candidates=model.iteration_candidates[-1],
        score_func=o.score_func, threshold=float(o.threshold),
        reg_u=o.reg_u, reg_i=o.reg_i, reg_j=o.reg_j, update_i=o.update_i,
        update_j=o.update_j,
        per_coordinate_normalize=o.per_coordinate_normalize, lr=o.lr,
        beta1=o.beta1, beta2=o.beta2, num_valid=nnz, bloom_log2=log2,
        probe=o.probe_mode), top=12)
    del users_c, items_c, P, Q, bloom

    reset_counts(R.KERNELS)
    users = [str(u) for u in range(WARP_USERS)]
    ms_first, recs = wall_ms(lambda: model.topk_recommendation(users,
                                                               topk=TOPK))
    ms_warm, _ = wall_ms(lambda: model.topk_recommendation(users, topk=TOPK))
    k5 = R.score_topk.launches
    check(len(recs) == WARP_USERS and k5 == 2,
          f"WARP top-10 malformed or not one K5 launch per call ({k5})")
    ids = np.array([[int(i) for i in recs[u]] for u in users])
    same = ids_match_numpy(ids, model.P[:WARP_USERS], model.Q,
                           what="WARP top-10")
    phase("warp_path", d=int(o.d), epochs=E, optimizer=o.optimizer,
          probe_mode=o.probe_mode, chunks_per_epoch=nchunks, chunk=batch,
          num_candidates=model.iteration_candidates,
          found_frac=model.iteration_found,
          violation_rate=model.iteration_losses, val_ndcg=val["ndcg"],
          val_auc=val["auc"], val_map=val["map"], validation_seconds=val_s,
          epoch_seconds=model.iteration_times,
          median_epoch_seconds_2_4=med, samples_per_s=model.num_nnz / med,
          launches=launches,
          launches_per_chunk={k: launches[k] / (nchunks * E)
                              for k in ("warp_search", "warp_accumulate")},
          deferred_update_per_epoch=launches["deferred_update"] / E,
          max_row_norm=norm, max_memory_allocated_mb=peak_mb,
          epoch_profile=prof, topk_users=WARP_USERS, topk_k5_launches=k5,
          topk_host_ms_first=ms_first, topk_host_ms_warm=ms_warm,
          topk_same_as_numpy=same)
    path_launches = {
        "warp_search": launches["warp_search"] + launches["warp_violations"],
        "warp_accumulate": launches["warp_accumulate"],
        "deferred_update": launches["deferred_update"]}

    runs = {}
    for name, extra in (
            ("l2", dict(score_func="l2")),
            ("all_split", dict(probe_mode="all", epoch_dispatch="split")),
            ("adam_pcn", dict(optimizer="adam", lr=0.02,
                              per_coordinate_normalize=True)),
            ("stream", dict(resident_mb=WARP_STREAM_RESIDENT_MB))):
        m, ln, mb, nrm = warp_train(bt, W, S, torch, data,
                                    warp_opt(bt, num_iters=1, **extra))
        want = dict(warp_search=nchunks,
                    warp_probe=nchunks if name == "all_split" else 0,
                    warp_violations=1, warp_accumulate=nchunks,
                    deferred_update=2)
        check(ln == want and (name != "stream" or model.num_nnz * 8
                              > WARP_STREAM_RESIDENT_MB << 20),
              f"the {name} WARP epoch launched {ln}, expected {want}")
        runs[name] = dict(violation_rate=m.iteration_losses[0],
                          found_frac=m.iteration_found[0],
                          epoch_seconds=m.iteration_times[0], launches=ln,
                          max_memory_allocated_mb=mb, max_row_norm=nrm)
        del m
    phase("warp_variants", d=int(o.d), default_first_epoch_violation_rate=
          model.iteration_losses[0], **runs)
    return model, path_launches


def warp_kernels(W, S, torch, model):
    """K11, K12 and K10's projection mode against their plain versions on
    chunk nchunks // 2 of the trained model's resident epoch (K11 at the
    model's last K and at K = 64, lazy and all, on its own draws and on
    injected candidates; K12 with reg terms WARP_CHECK_REG, bitwise
    repeatable, with its user side presorted (the resident chunk) and
    grouped by row (as a streamed chunk's is), a plain run without the reg
    terms failing the check; at most K12_MAX_STREAM_OPS stream operations
    per resident chunk, counted in a CUPTI trace).  Event ms, CUPTI ms,
    plain and library ms and the bounds; K11's event and CUPTI ms at K =
    64, its bytes and FP64 bounds, and K12's with each user side and its
    stream operations per call.  Returns the kernels line's K11 and K12
    entries."""
    dev = model.device
    users_c, items_c, nnz, indptr, bloom, log2, P0, Q0 = warp_inputs(
        S, torch, model)
    c = users_c.shape[0] // 2
    users, pos = users_c[c].contiguous(), items_c[c].contiguous()
    N, d, I = users.shape[0], P0.shape[1], Q0.shape[0]
    o = model.opt
    K = model.iteration_candidates[-1]
    base = dict(num_items=I, num_candidates=K, seed=int(o.random_seed),
                epoch=WARP_EPOCHS, chunk=c, n_valid=N,
                score_func=o.score_func, threshold=float(o.threshold),
                probe=o.probe_mode, indptr=indptr, bloom=bloom,
                bloom_log2=log2)
    # the model's last K, then K = 64 (lazy and all), which a default
    # 40-epoch run reaches once found_frac drops below 0.98
    out, w_err = {}, 0.0
    for k, probe in sorted({(K, o.probe_mode), (64, "lazy"), (64, "all")}):
        injected = W.warp_candidates(N, k, I, seed=1234, epoch=0, chunk=0,
                                     device=dev)
        for name, extra in (("own", {}), ("injected",
                                          {"candidates": injected})):
            kw = dict(base, num_candidates=k, probe=probe, **extra)
            cnt = [torch.zeros(1, dtype=torch.int32, device=dev)
                   for _ in range(2)]
            got = W.warp_search(users, pos, P0, Q0, counts=cnt[0], **kw)
            ref = W.warp_search_plain(users, pos, P0, Q0, counts=cnt[1], **kw)
            torch.cuda.synchronize()
            what = f"K11 (K = {k}, {probe}, {name} candidates)"
            check(all(torch.equal(got[i], ref[i]) for i in (0, 2, 3))
                  and torch.equal(cnt[0], cnt[1]),
                  f"{what}: ids, any_v, trials or counts differ from the "
                  "plain version")
            check(torch.allclose(got[1], ref[1], rtol=TOL_WARP_W, atol=0),
                  f"{what}: weights beyond 1 ulp")
            w_err = max(w_err, float((got[1] - ref[1]).abs().max()))
            out[(k, probe, name)] = dict(found=int(cnt[0][0]), got=got)
    neg, w, any_v, trial = out[(K, o.probe_mode, "own")]["got"]
    # the bytes this chunk's data needs: the slots' ids, probes and outputs,
    # each distinct P row and each distinct Q row of the positives and of
    # the candidates up to each slot's choice (all K without one) read once;
    # per needed candidate a Philox draw and a float64 score
    cand = W.warp_candidates(N, K, I, seed=int(o.random_seed),
                             epoch=WARP_EPOCHS, chunk=c, device=dev)
    first = torch.argmax((cand == neg[:, None]).int(), 1) + 1
    upto = torch.where(any_v, first, torch.full_like(first, K))
    need = int(upto.sum())
    walked = torch.arange(K, device=dev)[None, :] < upto[:, None]
    n_u = int(torch.unique(users).numel())
    n_i = int(torch.unique(torch.cat([pos, cand[walked]])).numel())
    nbytes = N * (8 + 16 + 13 + 4) + 4 * d * (n_u + n_i)
    t_b, t_o = nbytes / PEAK_BYTES_S, 2 * d * (need + N) / PEAK_FP64_S
    t_i = 100 * need / PEAK_INT32_S
    fn11 = (lambda: W.warp_search(users, pos, P0, Q0, **base))
    k11 = dict(route="cuda", source="buffalo_tpu_torch/csrc/warp_search.cu",
               replaces="buffalo_tpu/ops/warp_kernels.py:41",
               max_abs_err=w_err, ms=time_ms(fn11),
               device_ms=trace_ms(fn11, "search_kernel"),
               plain_ms=time_ms(lambda: W.warp_search_plain(
                   users, pos, P0, Q0, **base), reps=3, warmup=1),
               bound_ms=1e3 * max(t_b, t_o, t_i),
               bound_by="bytes" if t_b >= max(t_o, t_i) else "operations",
               library_ms=None, bound_bytes_ms=1e3 * t_b,
               bound_fp64_ms=1e3 * t_o, slots=N, num_candidates=K,
               candidates_needed=need, user_rows=n_u, item_rows=n_i,
               found={f"K{k}_{p}_{n}": v["found"]
                      for (k, p, n), v in out.items()},
               probe_mode=o.probe_mode)
    for probe in ("lazy", "all"):
        def fn64():
            return W.warp_search(users, pos, P0, Q0,
                                 **dict(base, num_candidates=64, probe=probe))
        k11[f"ms_k64_{probe}"] = time_ms(fn64)
        k11[f"device_ms_k64_{probe}"] = trace_ms(fn64, "search_kernel")

    kw12 = dict(n_valid=N, score_func=o.score_func, reg_u=WARP_CHECK_REG,
                reg_i=WARP_CHECK_REG, reg_j=WARP_CHECK_REG, update_i=True,
                update_j=True, per_coordinate_normalize=True,
                users_sorted=True)

    def acc12(fn, **over):
        acc = W.new_accumulators(P0, Q0)
        fn(P0, Q0, *acc, users, pos, neg, any_v, w, **dict(kw12, **over))
        return acc

    def check12(a, r):
        return step_check(a, r, torch.zeros_like(r), TOL_WARP_STEP)

    got, again, grouped = (acc12(W.warp_accumulate),
                           acc12(W.warp_accumulate),
                           acc12(W.warp_accumulate, users_sorted=False))
    ref = acc12(W.warp_accumulate_plain)
    noreg = acc12(W.warp_accumulate_plain, reg_u=0.0, reg_i=0.0, reg_j=0.0)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "K12 is not bitwise repeatable")
    check(all(check12(a, r)[0] for a, r in zip(grouped, ref)),
          "K12 with the user side grouped by row is off the plain version")
    errs, fields = [], {}
    for name, g, r, n0 in zip(("gP", "gQ", "cP", "cQ"), got, ref, noreg):
        ok, err, limit = check12(g, r)
        check(ok, f"K12's {name} is {err:.3g} from the plain version's "
              f"(limit {limit:.3g})")
        errs.append(err)
        fields[f"{name}_err"], fields[f"{name}_limit"] = err, limit
        fields[f"{name}_no_reg_err"] = check12(n0, r)[1]
    check(not all(check12(n0, r)[0] for n0, r in zip(noreg, ref)),
          "the K12 check passes a plain run without the reg terms")
    # the library call: index_add_ of the per-sample rows (computed once)
    live = any_v
    u, i, j = users.long()[live], pos.long()[live], neg.long()[live]
    ww = w[live][:, None]
    p, qi, qj = P0[u], Q0[i], Q0[j]
    rows_p = ww * (qi - qj) - WARP_CHECK_REG * p
    rows_q = torch.cat([ww * p - WARP_CHECK_REG * qi,
                        -ww * p - WARP_CHECK_REG * qj])
    idx_q = torch.cat([i, j])
    lib = W.new_accumulators(P0, Q0)

    def library():
        lib[0].index_add_(0, u, rows_p)
        lib[1].index_add_(0, idx_q, rows_q)

    n_live = int(live.sum())
    n_u = int(torch.unique(u).numel())
    n_i = int(torch.unique(idx_q).numel())
    # the slots' ids, flags and weights; each touched row of P and Q read
    # once, its gradient and count read and written once
    nbytes = 17 * N + (12 * d + 8) * (n_u + n_i)
    bms, by = bound_ms(nbytes, 10 * d * n_live)
    acc = W.new_accumulators(P0, Q0)

    def fn12(presorted=True):
        return W.warp_accumulate(P0, Q0, *acc, users, pos, neg, any_v, w,
                                 **dict(kw12, users_sorted=presorted))

    # the user side presorted and grouped by row (as a streamed chunk's
    # is), alternated so that the spread of the two runs of each shows the
    # noise
    sort_ms = {f"{name}_{r}": time_ms(lambda: fn12(flag))
               for r in (1, 2) for name, flag in (("presorted", True),
                                                  ("grouped", False))}
    # stream operations per call (kernels and memsets in a CUPTI trace):
    # the resident chunk's at most K12_MAX_STREAM_OPS
    dev_ms, ops = trace_stats(fn12, "rows_kernel")
    ops_grouped = trace_stats(lambda: fn12(False), "rows_kernel")[1]
    check(ops is not None and ops <= K12_MAX_STREAM_OPS,
          f"K12 makes {ops} stream operations per resident chunk (at most "
          f"{K12_MAX_STREAM_OPS})")
    k12 = dict(route="cuda",
               source="buffalo_tpu_torch/csrc/warp_accumulate.cu",
               replaces="buffalo_tpu/ops/warp_kernels.py:160",
               max_abs_err=max(errs), ms=time_ms(fn12),
               device_ms=dev_ms, stream_ops_per_call=ops,
               stream_ops_per_call_grouped=ops_grouped,
               plain_ms=time_ms(lambda: W.warp_accumulate_plain(
                   P0, Q0, *acc, users, pos, neg, any_v, w, **kw12),
                   reps=5, warmup=1),
               bound_ms=bms, bound_by=by,
               library_ms=time_ms(library, reps=10, warmup=2),
               live_slots=n_live, user_rows=n_u, item_rows=n_i,
               users_sort_ms=sort_ms, **fields)

    proj = {}
    for opt_name in ("adagrad", "adam"):
        rng = torch.Generator(device=dev).manual_seed(6)
        g = 0.1 * torch.randn(P0.shape, generator=rng, device=dev)
        m = 0.01 * torch.randn(P0.shape, generator=rng, device=dev)
        v = 0.01 * torch.rand(P0.shape, generator=rng, device=dev)
        cnt = torch.randint(0, 9, (P0.shape[0],), generator=rng,
                            device=dev).float()
        kw10 = dict(step=3, optimizer=opt_name, lr=0.05, beta1=0.9,
                    beta2=0.999, reg=0.0, per_coordinate_normalize=True,
                    project=True)
        a = [P0.clone(), g.clone(), m.clone(), v.clone()]
        b = [P0.clone(), g.clone(), m.clone(), v.clone()]
        S.deferred_update(*a, cnt, **kw10)
        S.deferred_update_plain(*b, cnt, **kw10)
        err = max(float((x - y).abs().max()) for x, y in zip(a, b))
        check(all(torch.allclose(x, y, rtol=TOL_K10, atol=1e-7)
                  for x, y in zip(a, b)),
              f"K10's projection ({opt_name}) is {err:.3g} from its plain "
              "version")
        n = P0.numel()
        bms, by = bound_ms((32 if opt_name == "adam" else 24) * n
                           + 4 * P0.shape[0], 17 * n)
        fn = (lambda: S.deferred_update(*a, cnt, **kw10))
        ms = time_ms(fn)
        # the same update without the projection: what the projection adds
        # is ms less this, the function torch.renorm computes
        unprojected_ms = time_ms(lambda: S.deferred_update(
            *a, cnt, **dict(kw10, project=False)))
        proj[opt_name] = dict(max_abs_err=err, ms=ms,
                              device_ms=trace_ms(fn, "project_kernel"),
                              plain_ms=time_ms(lambda: S.deferred_update_plain(
                                  *b, cnt, **kw10)),
                              bound_ms=bms, bound_by=by, elements=n,
                              unprojected_ms=unprojected_ms,
                              projection_ms=ms - unprojected_ms,
                              # project_unit_ball (X / max(1, |x|)) alone, up
                              # to renorm's 1e-7 in the divisor: a part of
                              # the function, beside projection_ms
                              library_ms=time_ms(lambda: torch.renorm(
                                  a[0], 2, 0, 1.0)),
                              library="torch.renorm(P, 2, 0, 1.0), the "
                                      "projection alone")
    phase("warp_kernels", d=d, chunk_index=c, chunks=int(users_c.shape[0]),
          k11=k11, k12=k12, k10_projection=proj, tol_w=TOL_WARP_W,
          tol_step=TOL_WARP_STEP, check_reg=WARP_CHECK_REG, tol_k10=TOL_K10)
    del users_c, items_c, bloom, got, again, grouped, ref, noreg, lib, acc, out
    torch.cuda.empty_cache()
    return {"warp_search": k11, "warp_accumulate": k12}


# ------------------------------------------------------------------ eALS
def eals_opt(bt, **kw):
    """EALSOption defaults on the card at d = D, no validation inside the
    epochs, with ``kw`` on top."""
    opt = bt.EALSOption().get_default_option()
    opt.update(d=D, num_iters=EALS_EPOCHS, device="cuda",
               validation={"topk": TOPK}, evaluation_on_learning=False)
    opt.update(kw)
    return opt


def eals_inputs(torch, model, st=None):
    """A trained eALS's range layout on the card (``st``, else built anew):
    (state, permuted P, Q)."""
    from buffalo_tpu_torch.data.batching import permute_table

    st = st or model._train_state()
    P = torch.from_numpy(permute_table(model.P, st["u_pos"],
                                       st["u_pad"])).to(model.device)
    Q = torch.from_numpy(permute_table(model.Q, st["i_pos"],
                                       st["i_pad"])).to(model.device)
    return st, P, Q


def eals_path(bt, E, R, torch, data):
    """eALS on the ML-20M data (EALSOption defaults, d = D), EALS_EPOCHS
    epochs through the user's entry points: one K13 launch per batch and
    one K14 per epoch, the RMSE falling every epoch, validation after
    training, a profiled epoch; ParEALS top-10 for EALS_USERS users held
    to numpy.  Returns (model, its range-layout inputs, the path's
    launches)."""
    model = bt.EALS(eals_opt(bt), data=data)
    np.random.seed(0)
    model.initialize()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(E.KERNELS)
    model.train()
    launches = read_counts(E.KERNELS)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    losses = model.iteration_losses
    check(len(losses) == EALS_EPOCHS and all(np.isfinite(losses))
          and all(b < a for a, b in zip(losses, losses[1:]))
          and np.isfinite(model.P).all() and np.isfinite(model.Q).all(),
          f"eALS RMSE not finite and falling: {losses}")
    st, P, Q = eals_inputs(torch, model)
    nb = len(st["row_groups"]) + len(st["col_groups"])
    want = dict(dim_sweep=nb * EALS_EPOCHS, eals_residual=EALS_EPOCHS)
    check(launches == want, f"eALS epochs launched {launches}, expected "
          f"{want}")
    t0 = time.perf_counter()
    val = model.get_validation_results()
    val_s = time.perf_counter() - t0
    check(all(np.isfinite(v) for v in val.values()), f"eALS validation: "
          f"{val}")
    o = model.opt

    def epoch():
        E.eals_epoch(P, Q, st["row_groups"], st["col_groups"], st["C"],
                     alpha=o.alpha, reg_u=o.reg_u, reg_i=o.reg_i)
        float(E.eals_loss(P, Q, None, *st["u"], st["C"], o.reg_u, o.reg_i,
                          alpha=o.alpha)[0])

    prof = profile_call(torch, epoch, top=10)
    reset_counts(R.KERNELS)
    users = [str(u) for u in range(EALS_USERS)]
    par = bt.ParEALS(model)
    ms_first, (keys, ids, _) = wall_ms(
        lambda: par.topk_recommendation(users, topk=TOPK))
    ms_warm, _ = wall_ms(lambda: par.topk_recommendation(users, topk=TOPK))
    k5 = R.score_topk.launches
    check(keys == users and ids.shape == (EALS_USERS, TOPK) and k5 == 2,
          f"ParEALS top-10 malformed or not one K5 launch per call ({k5})")
    same = ids_match_numpy(ids, model.P[:EALS_USERS], model.Q,
                           what="ParEALS.topk_recommendation")
    med = float(np.median(model.iteration_times[1:]))
    phase("eals_path", d=D, epochs=EALS_EPOCHS, alpha=o.alpha, c0=o.c0,
          exponent=o.exponent, reg=o.reg_u, batches_per_epoch=nb,
          train_rmse=losses, val_ndcg=val["ndcg"], val_auc=val["auc"],
          val_map=val["map"], validation_seconds=val_s,
          epoch_seconds=model.iteration_times,
          median_epoch_seconds_2_4=med, launches=launches,
          launches_per_epoch=per_epoch(launches, EALS_EPOCHS),
          max_memory_allocated_mb=peak_mb, epoch_profile=prof,
          topk_users=EALS_USERS, topk_k5_launches=k5,
          topk_host_ms_first=ms_first, topk_host_ms_warm=ms_warm,
          topk_same_as_numpy=same)
    del P, Q
    return model, st, launches


def eals_batch_check(E, torch, X, Y, S, C, batch, rows, item_axis, alpha,
                     reg):
    """K13 on one batch against its plain version (and the plain version in Jacobi order), launched
    twice: (relative error, Jacobi's relative error, the two launches
    bitwise equal)."""
    from buffalo_tpu_torch.data.batching import RangeBatch

    outs = [X.clone() for _ in range(4)]
    kw = dict(item_axis=item_axis, alpha=alpha, reg=reg)
    E.dim_sweep(outs[0], Y, S, C, batch=batch, **kw)
    E.dim_sweep(outs[3], Y, S, C, batch=batch, **kw)
    if isinstance(batch, RangeBatch):
        args = (int(batch.row_start), batch.lens, batch.cols, batch.vals)
        E.range_sweep_plain(outs[1], Y, S, C, *args, **kw)
        E.range_sweep_plain(outs[2], Y, S, C, *args, jacobi=True, **kw)
    else:
        E.segment_sweep_plain(outs[1], Y, S, C, batch, **kw)
        E.segment_sweep_plain(outs[2], Y, S, C, batch, jacobi=True, **kw)
    scale = max(float(outs[1][rows].abs().max()), 1e-30)
    return (float((outs[0] - outs[1]).abs().max()) / scale,
            float((outs[2] - outs[1]).abs().max()) / scale,
            bool(torch.equal(outs[0], outs[3])))


def k13_work(batch, d, item_axis):
    """(bytes, operations) of K13's function on a range batch: the lens,
    the entries' ids and values, the batch's rows read and written, S, and
    each distinct row of the fixed side (with its C in the user pass) read
    once; per entry and dimension ~12 operations (the residual and the
    num/den terms)."""
    import torch

    B, L = batch.cols.shape
    live = torch.arange(L, device=batch.cols.device)[None, :] < \
        batch.lens[:, None]
    n = int(batch.lens.sum())
    n_y = int(torch.unique(batch.cols[live]).numel())
    nbytes = (4 * B + 8 * n + 8 * B * d + 4 * d * d
              + (4 * d + (0 if item_axis else 4)) * n_y)
    return nbytes, n * d * 12


def k13_segment_work(batch, d, item_axis, num_rows):
    """``k13_work`` of a segment batch: its chunks' lens, the live entries'
    ids and values, the real rows read and written, S, each distinct row
    of the fixed side (with its C in the user pass) read once."""
    import torch

    Nc, Cw = batch.cols.shape
    live = torch.arange(Cw, device=batch.cols.device)[None, :] < \
        batch.chunk_lens[:, None]
    n = int(batch.chunk_lens.sum())
    n_y = int(torch.unique(batch.cols[live]).numel())
    R = int((batch.rows < num_rows).sum())
    nbytes = (4 * Nc + 8 * n + 8 * R * d + 4 * d * d
              + (4 * d + (0 if item_axis else 4)) * n_y)
    return nbytes, n * d * 12


def k13_library(torch, X, Y, S, C, batch, *, item_axis, alpha, reg):
    """K13's function on one staged batch by library calls (a yardstick,
    used nowhere in the port): each row's system A = F^T diag(w - C_e) F +
    c_row S^T + reg I and b = F^T (w v) by ``torch.bmm`` over the gathered
    rows (a segment batch's chunks added per row with ``index_add_``), then
    the Gauss-Seidel sweep x = (L_A + D_A)^-1 (b - U_A x) by
    ``torch.linalg.solve_triangular``; X in place."""
    from buffalo_tpu_torch.data.batching import RangeBatch

    dev, d, n = X.device, X.shape[1], X.shape[0]
    if isinstance(batch, RangeBatch):
        rs = int(batch.row_start)
        B, L = batch.cols.shape
        rows = torch.arange(rs, rs + B, device=dev)
        lens = batch.lens
        c_row = (C[rs:rs + B] if item_axis
                 else torch.ones(B, dtype=torch.float32, device=dev))
        seg = None
    else:
        R = batch.rows.shape[0]
        rows = torch.clamp(batch.rows.long(), max=n - 1)
        lens = batch.chunk_lens
        seg = torch.clamp(batch.seg_ids.long(), max=R)
        c_row = (torch.where(batch.lens > 0, C[rows], torch.zeros_like(
            C[rows])) if item_axis else torch.ones(R, dtype=torch.float32,
                                                    device=dev))
    cols = batch.cols.long()
    Lw = cols.shape[1]
    mask = (torch.arange(Lw, device=dev)[None, :] < lens[:, None]).float()
    v = batch.vals.float()
    w = (1.0 + alpha * v) * mask
    if item_axis:
        ce = (c_row if seg is None else torch.cat([c_row, c_row.new_zeros(
            1)])[seg])[:, None]
    else:
        ce = C[cols]
    F = Y[cols]
    Ft = F.transpose(1, 2)
    G = torch.bmm(Ft * (w - ce * mask)[:, None, :], F)
    b = torch.bmm(Ft, (w * v)[:, :, None])[..., 0]
    if seg is not None:
        G = torch.zeros((R + 1, d, d), device=dev).index_add_(0, seg, G)[:R]
        b = torch.zeros((R + 1, d), device=dev).index_add_(0, seg, b)[:R]
    A = G + c_row[:, None, None] * S.T[None] + reg * torch.eye(d, device=dev)
    rhs = b - (torch.triu(A, 1) @ X[rows][..., None])[..., 0]
    x = torch.linalg.solve_triangular(torch.tril(A), rhs[..., None],
                                      upper=False)[..., 0]
    if seg is None:
        X[rows] = x
    else:
        keep = batch.rows.long() < n
        X[batch.rows.long()[keep]] = x[keep]


def eals_kernels(E, torch, model, st):
    """K13 and K14 against their plain versions on the trained model's
    ML-20M layout: K13 on the first range batch of every length bucket of
    both halves, on each segment batch and on the user side's CSR rows
    (rows mode), within TOL_EALS relative (a Jacobi sweep must fail) and
    bitwise repeatable, and at EALS_WIDTHS on random batches; its times on
    the largest user and item range batches and item segment batch, beside the bound and the library route (``k13_library``); K14's
    residuals within TOL_VHAT and sums within TOL_EALS_SUM.  Returns the
    kernels line's entries."""
    from buffalo_tpu_torch.data.batching import RangeBatch

    dev = model.device
    o = model.opt
    alpha, reg = float(o.alpha), float(o.reg_u)
    _, P, Q = eals_inputs(torch, model, st)
    C = st["C"]
    halves = (("rowwise", st["row_groups"], P, Q, E.eals_gramian(Q, C),
               False), ("colwise", st["col_groups"], Q, P,
                        E.eals_gramian(P), True))
    errs, jac, seen, checked = [], [], set(), 0
    for half, batches, X, Y, S, item in halves:
        for b in batches:
            if isinstance(b, RangeBatch):
                key = (half, b.cols.shape[1])
                if key in seen:
                    continue
                seen.add(key)
                rs = int(b.row_start)
                rows = slice(rs, rs + b.cols.shape[0])
            else:
                rows = b.rows.long()[b.rows.long() < X.shape[0]]
            e, j, rep = eals_batch_check(E, torch, X, Y, S, C, b, rows,
                                         item, alpha, reg)
            check(e <= TOL_EALS and rep, f"K13 on a {half} batch "
                  f"{tuple(b.cols.shape)} is {e:.3g} from its plain version "
                  f"(repeatable: {rep})")
            check(j > TOL_EALS, f"the K13 check passes a Jacobi sweep on a "
                  f"{half} batch {tuple(b.cols.shape)} ({j:.3g})")
            errs.append(e)
            jac.append(j)
            checked += 1
    # rows mode: the user side's CSR with carried residuals (unpermuted)
    group = model.data.get_group("rowwise")
    indptr = torch.from_numpy(np.array(group["indptr"], np.int64)).to(dev)
    keys = torch.from_numpy(np.array(group["key"], np.int32)).to(dev)
    vals = torch.from_numpy(np.array(group["val"], np.float32)).to(dev)
    Pu = torch.from_numpy(model.P).to(dev)
    Qu = torch.from_numpy(model.Q).to(dev)
    Cu = torch.from_numpy(model._get_negative_weights()).to(dev)
    rows_u = torch.repeat_interleave(
        torch.arange(Pu.shape[0], device=dev, dtype=torch.int32),
        indptr[1:] - indptr[:-1])
    vh0 = E.compute_vhat(Pu, Qu, rows_u, keys)
    Su = E.eals_gramian(Qu, Cu)
    a, b = [Pu.clone(), vh0.clone()], [Pu.clone(), vh0.clone()]
    E.eals_half_epoch(a[0], Qu, a[1], indptr, keys, vals, Cu, Su,
                      item_axis=False, alpha=alpha, reg=reg)
    E.rows_sweep_plain(b[0], Qu, Su, Cu, indptr, keys, vals, b[1],
                       item_axis=False, alpha=alpha, reg=reg)
    rows_err = max(rel_err(a[0], b[0])[1], rel_err(a[1], b[1])[1])
    check(rows_err <= TOL_EALS, f"K13's rows mode is {rows_err:.3g} from "
          "its plain version")
    # random batches at other widths (range, L = 96 and 1024)
    widths = {}
    for dw in EALS_WIDTHS:
        rng = np.random.default_rng(dw)
        X = torch.tensor(0.2 * rng.standard_normal((2000, dw)),
                         dtype=torch.float32, device=dev)
        Y = torch.tensor(0.2 * rng.standard_normal((3000, dw)),
                         dtype=torch.float32, device=dev)
        Cw = torch.tensor(rng.uniform(0.05, 0.5, 3000), dtype=torch.float32,
                          device=dev)
        Sw = E.eals_gramian(Y, Cw)
        for L in (96, 1024):
            lens = rng.integers(0, L + 1, 64).astype(np.int32)
            cols = rng.integers(0, 3000, (64, L)).astype(np.int32)
            vv = (rng.integers(1, 5, (64, L))
                  * (np.arange(L) < lens[:, None])).astype(np.float32)
            bw = RangeBatch(100, *[torch.from_numpy(x).to(dev)
                                   for x in (lens, cols, vv)])
            e, j, rep = eals_batch_check(E, torch, X, Y, Sw, Cw, bw,
                                         slice(100, 164), False, alpha, reg)
            form = E.dim_sweep_form(dw, bw)
            check(e <= TOL_EALS and j > TOL_EALS and rep,
                  f"K13's {form} form at d = {dw}, L = {L}: {e:.3g} "
                  f"(Jacobi {j:.3g}, repeatable {rep})")
            widths[f"d{dw}_L{L}_{form}"] = e
    # timing: the user half's and the item half's range batch with the
    # most entries and the item half's segment batch with the most, each
    # beside the library route (k13_library)
    def most(groups, kind):
        return max((b for b in groups if isinstance(b, RangeBatch) == kind),
                   key=lambda b: int(b.lens.sum() if kind
                                     else b.chunk_lens.sum()))

    timed = {}
    for name, batch, X0, Y, S, item in (
            ("user_range", most(st["row_groups"], True), P, Q, halves[0][4],
             False),
            ("item_range", most(st["col_groups"], True), Q, P, halves[1][4],
             True),
            ("item_segment", most(st["col_groups"], False), Q, P,
             halves[1][4], True)):
        X = X0.clone()
        kw = dict(item_axis=item, alpha=alpha, reg=reg)
        if isinstance(batch, RangeBatch):
            nbytes, flops = k13_work(batch, D, item)
            entries = int(batch.lens.sum())
        else:
            nbytes, flops = k13_segment_work(batch, D, item, X.shape[0])
            entries = int(batch.chunk_lens.sum())
        bms, by = bound_ms(nbytes, flops)

        def fn13(X=X, Y=Y, S=S, batch=batch, kw=kw):
            E.dim_sweep(X, Y, S, C, batch=batch, **kw)

        timed[name] = dict(
            batch=list(batch.cols.shape), entries=entries,
            form=E.dim_sweep_form(D, batch), ms=time_ms(fn13),
            device_ms=trace_ms(fn13, "sweep"), bound_ms=bms, bound_by=by,
            library_ms=time_ms(lambda: k13_library(
                torch, X, Y, S, C, batch, **kw), reps=5, warmup=1))
    big = most(st["row_groups"], True)
    X = P.clone()
    kw = dict(item_axis=False, alpha=alpha, reg=reg)
    args = (int(big.row_start), big.lens, big.cols, big.vals)
    main = timed["user_range"]
    k13 = dict(route="cuda", source="buffalo_tpu_torch/csrc/eals_sweep.cu",
               replaces="buffalo_tpu/ops/eals_kernels.py:71",
               max_abs_err=max(errs + [rows_err] + list(widths.values())),
               ms=main["ms"], device_ms=main["device_ms"],
               plain_ms=time_ms(lambda: E.range_sweep_plain(
                   X, Q, halves[0][4], C, *args, **kw), reps=3, warmup=1),
               bound_ms=main["bound_ms"], bound_by=main["bound_by"],
               library_ms=main["library_ms"],
               library="torch.bmm for A and b, then "
               "torch.linalg.solve_triangular (k13_library)",
               batch=main["batch"], entries=main["entries"],
               form=main["form"], modes=timed,
               checked_batches=checked, max_rel_err=max(errs),
               min_jacobi_rel_err=min(jac), rows_mode_rel_err=rows_err,
               widths=widths)
    # K14 over all the nnz of the permuted COO view, then at d = 13 on
    # random tables
    rows, keys_p, vals_p = st["u"]
    k14 = k14_entry(E, torch, P, Q, rows, keys_p, vals_p, C, alpha,
                    f"the trained d = {D} tables")
    rng = np.random.default_rng(13)
    P13, Q13 = (torch.tensor(0.3 * rng.standard_normal((len(t), 13)),
                             dtype=torch.float32, device=dev) for t in (P, Q))
    k14["d13"] = k14_entry(E, torch, P13, Q13, rows, keys_p, vals_p, C,
                           alpha, "random d = 13 tables", timed=False)
    k14["max_abs_err"] = max(k14["max_abs_err"], k14["d13"]["max_abs_err"])
    del P13, Q13
    phase("eals_kernels", d=D, k13=k13, k14=k14, tol=TOL_EALS,
          tol_vhat=TOL_VHAT, tol_sums=TOL_EALS_SUM)
    del P, Q, X, a, b, Pu, Qu
    torch.cuda.empty_cache()
    return {"dim_sweep": k13, "eals_residual": k14}


def k14_work(torch, rows, keys, d, sums=True, given=False):
    """(bytes, operations) of K14's function: three 4-byte words per entry
    in each mode (sums: rows, keys and vals read; residuals only: rows and
    keys read, vhat written; residuals ``given``: keys, vals and vhat
    read), each distinct row of P and Q read once unless the residuals are
    given, C per distinct item with the sums; 2 d + 10 operations an
    entry."""
    n = rows.shape[0]
    n_i = n_distinct(torch, keys)
    tables = 0 if given else 4 * d * (n_distinct(torch, rows) + n_i)
    return (12 * n + tables + (4 * n_i if sums else 0),
            n * (2 * d + 10))


def k14_entry(E, torch, P, Q, rows, keys, vals, C, alpha, what, timed=True):
    """K14 against its plain version: the residuals-only call within
    TOL_VHAT, the sums within TOL_EALS_SUM, both bitwise repeatable; the
    check must fail on residuals read with each entry's key shifted to the
    next column.  With ``timed``, its event and CUPTI ms, the plain
    version's, the library call's and the bound."""
    v_got = E.compute_vhat(P, Q, rows, keys)
    v_again = E.compute_vhat(P, Q, rows, keys)
    v_ref, s_ref = E.eals_residual_plain(P, Q, rows, keys, vals, C,
                                         alpha=alpha)
    _, s_got = E.eals_residual(P, Q, rows, keys, vals, C, alpha=alpha)
    _, s_again = E.eals_residual(P, Q, rows, keys, vals, C, alpha=alpha)
    torch.cuda.synchronize()
    v_err = rel_err(v_got, v_ref)[1]
    s_err = float(((s_got - s_ref).abs() / s_ref.abs()).max())
    check(v_err <= TOL_VHAT and s_err <= TOL_EALS_SUM
          and torch.equal(s_got, s_again) and torch.equal(v_got, v_again),
          f"K14 on {what}: residuals {v_err:.3g}, sums {s_err:.3g} from the "
          "plain version (or not repeatable)")
    shifted = ((keys + 1) % Q.shape[0]).to(torch.int32)
    mutant = rel_err(E.compute_vhat(P, Q, rows, shifted), v_ref)[1]
    check(mutant > TOL_VHAT, f"K14's check on {what} passes residuals read "
          f"from the next column's rows ({mutant:.3g})")
    out = dict(d=P.shape[1], entries=rows.shape[0],
               max_abs_err=float((v_got - v_ref).abs().max()),
               vhat_rel_err=v_err, sums_rel_err=s_err,
               shifted_keys_rel_err=mutant)
    del v_got, v_again, v_ref, shifted
    if not timed:
        return out
    d = P.shape[1]
    bms, by = bound_ms(*k14_work(torch, rows, keys, d))

    def library():
        v = (P[rows.long()] * Q[keys.long()]).sum(-1)
        err = vals - v
        return torch.stack([((1 + alpha * vals) * err * err).sum(),
                            (C[keys.long()] * v * v).sum(),
                            (err * err).sum()])

    def fn14():
        return E.eals_residual(P, Q, rows, keys, vals, C, alpha=alpha)
    out.update(
        route="cuda", source="buffalo_tpu_torch/csrc/eals_loss.cu",
        replaces="buffalo_tpu/ops/eals_kernels.py:356",
        ms=time_ms(fn14), device_ms=trace_ms(fn14, "total_kernel"),
        plain_ms=time_ms(lambda: E.eals_residual_plain(
            P, Q, rows, keys, vals, C, alpha=alpha), reps=5, warmup=1),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(library, reps=5, warmup=1),
        user_rows=n_distinct(torch, rows), item_rows=n_distinct(torch, keys))
    return out


def topk_past_1024(R, torch, model):
    """``batch_topn`` past K5's k limit on the card: TOPK_PAST items for
    TOPK_PAST_USERS users of the eALS model (26,744 items), through the
    matmul route (no K5 launch), held to numpy with ties by index."""
    from buffalo_tpu_torch.ops.topk import batch_topn

    q = model.P[:TOPK_PAST_USERS]
    reset_counts(R.KERNELS)
    ms, (ids, scores) = wall_ms(lambda: batch_topn(q, model.Q, TOPK_PAST,
                                                   device="cuda"))
    k5 = R.score_topk.launches
    check(k5 == 0 and ids.shape == (TOPK_PAST_USERS, TOPK_PAST),
          f"batch_topn k = {TOPK_PAST}: {k5} K5 launches, {ids.shape}")
    same = ids_match_numpy(ids, q, model.Q, what=f"batch_topn k = "
                           f"{TOPK_PAST}")
    phase("topk_past_1024", k=TOPK_PAST, users=TOPK_PAST_USERS,
          items=int(model.Q.shape[0]), host_ms=ms, k5_launches=k5,
          same_as_numpy=same)


def plsi_opt(bt, **kw):
    """PLSIOption defaults on the card, PLSI_EPOCHS epochs, no validation
    inside the epochs, with ``kw`` on top."""
    opt = bt.PLSIOption().get_default_option()
    opt.update(num_iters=PLSI_EPOCHS, device="cuda",
               validation={"topk": TOPK}, evaluation_on_learning=False)
    opt.update(kw)
    return opt


def plsi_model(bt, data, opt, start=None):
    """A PLSI model on ``data``, initialized from numpy seed 0, or holding
    the tables ``start`` (P, Q)."""
    model = bt.PLSI(opt, data=data)
    np.random.seed(0)
    model.initialize()
    if start is not None:
        model.P, model.Q = start[0].copy(), start[1].copy()
    return model


def plsi_inputs(torch, model):
    """A trained pLSI's range layout on the card: (state, permuted P, Q)."""
    from buffalo_tpu_torch.data.batching import permute_table

    st = model._train_state(model._rowwise_batcher())
    P = torch.from_numpy(permute_table(model.P, st["u_pos"],
                                       st["u_pad"])).to(model.device)
    Q = torch.from_numpy(permute_table(model.Q, st["i_pos"],
                                       st["i_pad"])).to(model.device)
    return st, P, Q


def plsi_path(bt, PK, R, torch, data):
    """pLSI on the ML-20M data (PLSIOption defaults, d = 20), PLSI_EPOCHS
    epochs in the range layout through the user's entry points: one K15
    launch per batch of both orientations and one K16 per epoch, the loss
    falling every epoch, P's rows and Q's columns stochastic, validation
    after training, a profiled epoch (K15's busy ms in it beside its calls'
    bound), top-10 for PLSI_USERS users held to numpy.  Returns (model, its
    range-layout inputs, the path's launches, K15's epoch figures)."""
    model = plsi_model(bt, data, plsi_opt(bt))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(PK.KERNELS)
    model.train()
    launches = read_counts(PK.KERNELS)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    losses = model.iteration_losses
    check(len(losses) == PLSI_EPOCHS and all(np.isfinite(losses))
          and all(b < a for a, b in zip(losses, losses[1:])),
          f"pLSI loss not finite and falling: {losses}")
    p_err = float(np.abs(model.P.sum(1, dtype=np.float64) - 1).max())
    q_err = float(np.abs(model.Q.sum(0, dtype=np.float64) - 1).max())
    check(p_err <= TOL_STOCHASTIC and q_err <= TOL_STOCHASTIC,
          f"pLSI tables not stochastic: rows of P {p_err:.3g}, columns of "
          f"Q {q_err:.3g} from 1")
    st, P, Q = plsi_inputs(torch, model)
    nb = len(st["row_groups"]) + len(st["col_groups"])
    want = dict(plsi_estep=nb * PLSI_EPOCHS, plsi_mstep=PLSI_EPOCHS)
    check(launches == want, f"pLSI epochs launched {launches}, expected "
          f"{want}")
    t0 = time.perf_counter()
    val = model.get_validation_results()
    val_s = time.perf_counter() - t0
    check(all(np.isfinite(v) for v in val.values()), f"pLSI validation: "
          f"{val}")
    o = model.opt
    kw = dict(alpha1=float(o.alpha1), alpha2=float(o.alpha2),
              num_items=ML20M_ITEMS)
    prof = profile_call(torch, lambda: float(PK.plsi_epoch_range(
        P, Q, st["row_groups"], st["col_groups"], st["p_mask"],
        st["q_mask"], **kw)[2]), top=30)
    # K15's busy ms in that epoch (its range and segment modes' kernels)
    # beside the bound of its calls
    from buffalo_tpu_torch.ops.als_kernels import _flat
    k15_epoch = dict(
        epoch_device_ms=sum(v for k, v in prof["device_ms_by_name"].items()
                            if k.startswith(K15_EPOCH_KERNELS)),
        epoch_bound_ms=sum(bound_ms(*k15_work(torch, b, P.shape[1]))[0]
                           for g in (st["row_groups"], st["col_groups"])
                           for b in _flat(g)))
    users = [str(u) for u in range(PLSI_USERS)]
    model.topk_recommendation(users[:10], topk=TOPK)  # warm
    reset_counts(R.KERNELS)
    ms, recs = wall_ms(lambda: model.topk_recommendation(users, topk=TOPK))
    k5 = R.score_topk.launches
    ids = np.array([[int(i) for i in recs[u]] for u in users])
    check(k5 >= 1 and ids.shape == (PLSI_USERS, TOPK),
          f"pLSI top-10 malformed or without K5 ({k5})")
    same = ids_match_numpy(ids, model.P[:PLSI_USERS], model.Q,
                           what="PLSI.topk_recommendation")
    med = float(np.median(model.iteration_times[1:]))
    phase("plsi_path", d=int(o.d), epochs=PLSI_EPOCHS, alpha1=o.alpha1,
          alpha2=o.alpha2, batches_per_epoch=nb, train_loss=losses,
          rows_of_P_sum_err=p_err, cols_of_Q_sum_err=q_err,
          val_ndcg=val["ndcg"], val_auc=val["auc"], validation_seconds=val_s,
          epoch_seconds=model.iteration_times, median_epoch_seconds_2_4=med,
          launches=launches,
          launches_per_epoch=per_epoch(launches, PLSI_EPOCHS),
          max_memory_allocated_mb=peak_mb, epoch_profile=prof,
          topk_users=PLSI_USERS, topk_k5_launches=k5, topk_host_ms=ms,
          topk_same_as_numpy=same, k15_epoch=k15_epoch)
    return model, st, launches, k15_epoch


def plsi_variants(bt, PK, torch, data, model):
    """One epoch from the trained tables in each other route: group
    dispatch against the range layout's epoch from the same start (the
    same function); range_layout=False and the streamed batches
    (resident_mb 0), which take the padded path's element floor, against
    that function's plain versions on the card from the same start.  Each
    within TOL_PLSI_X relative (TOL_PLSI_ABS absolute), its loss within
    TOL_PLSI_LOSS; the padded route's distance from the range epoch (the
    floors differ where latent products fall below 1e-10) is reported."""
    start = (model.P, model.Q)
    o = model.opt
    a1, a2 = float(o.alpha1), float(o.alpha2)

    def epoch(**kw):
        m = plsi_model(bt, data, plsi_opt(bt, num_iters=1, validation={},
                                          **kw), start)
        reset_counts(PK.KERNELS)
        m.train()
        return m, read_counts(PK.KERNELS)

    base, _ = epoch()
    deno = float(np.sum(data.get_group("rowwise")["val"], dtype=np.float64))
    batches = model._rowwise_batcher().device_batches()

    def plain_epoch(dtype):
        """The padded route's function through the plain versions on the
        card, from the same start, in ``dtype``."""
        P0, Q0 = (torch.from_numpy(t).to(model.device, dtype) for t in start)
        Pn, Qn = torch.zeros_like(P0), torch.zeros_like(Q0)
        loss = sum(float(PK.estep_padded_plain(Pn, Qn, P0, Q0, b).double()
                         .sum()) for b in batches)
        PK.mstep_plain(Pn, Qn, alpha1=a1, alpha2=a2)
        return types.SimpleNamespace(
            P=Pn.cpu().numpy(), Q=Qn.cpu().numpy(),
            iteration_losses=[loss / (deno + o.eps)])

    # the padded Qn sums add up to ~1M latent rows per head item in float32:
    # the padded routes are held to the plain float32 epoch, or to the
    # float64 one within NOISE_FACTOR times the float32 epoch's distance
    plain, plain64 = plain_epoch(torch.float32), plain_epoch(torch.float64)
    del batches
    torch.cuda.empty_cache()
    out = {}
    for name, ref, kw in (("group", base, dict(epoch_dispatch="group")),
                          ("padded", plain, dict(range_layout=False)),
                          ("streamed", plain, dict(resident_mb=0))):
        m, launches = epoch(**kw)
        errs, ok = {}, True
        for t in "PQ":
            got, want = getattr(m, t), getattr(ref, t)
            errs[t] = float(np.abs(got - want).max())
            close = np.allclose(got, want, rtol=TOL_PLSI_X, atol=TOL_PLSI_ABS)
            if ref is plain and not close:
                t64 = getattr(plain64, t)
                floor64 = float(np.abs(want - t64).max())
                errs[f"{t}_vs_f64"] = float(np.abs(got - t64).max())
                errs[f"{t}_plain_vs_f64"] = floor64
                close = errs[f"{t}_vs_f64"] <= NOISE_FACTOR * floor64 + \
                    TOL_PLSI_ABS
            ok = ok and close
        loss_err = abs(m.iteration_losses[0] - ref.iteration_losses[0]) / \
            abs(ref.iteration_losses[0])
        check(ok and loss_err <= TOL_PLSI_LOSS, f"pLSI {name} epoch off "
              f"its reference: {errs}, loss {loss_err:.3g}")
        out[name] = dict(epoch_seconds=m.iteration_times[0],
                         max_abs_err=errs, loss_rel_err=loss_err,
                         launches=launches)
        if name == "padded":
            out[name]["vs_range_epoch"] = dict(
                max_abs_diff={t: float(np.abs(getattr(m, t)
                                              - getattr(base, t)).max())
                              for t in "PQ"},
                loss_rel_diff=abs(m.iteration_losses[0]
                                  - base.iteration_losses[0])
                / abs(base.iteration_losses[0]))
    phase("plsi_variants", range_epoch_seconds=base.iteration_times[0],
          tol=TOL_PLSI_X, tol_abs=TOL_PLSI_ABS, tol_loss=TOL_PLSI_LOSS,
          **out)


def dirichlet_tables(torch, n, m, d, dev, seed):
    """Row-stochastic (n, d) and column-stochastic (m, d) tables drawn from
    Dirichlet(PLSI_SPARSE_CONC): many latent products below 1e-10."""
    rng = np.random.default_rng(seed)
    X = rng.dirichlet(np.full(d, PLSI_SPARSE_CONC), n)
    Y = rng.dirichlet(np.full(m, PLSI_SPARSE_CONC), d).T
    return tuple(torch.tensor(np.ascontiguousarray(t / t.sum(axis, keepdims=True)),
                              dtype=torch.float32, device=dev)
                 for t, axis in ((X, 1), (Y, 0)))


def distinct(torch, cols, lens):
    """The distinct ids of a padded block's live entries."""
    live = torch.arange(cols.shape[1], device=cols.device)[None, :] < \
        lens[:, None]
    return int(torch.unique(cols[live]).numel())


def k15_work(torch, batch, d, padded=False):
    """(bytes, operations) of K15 on one batch: each live entry's column
    and value read once, the distinct gathered rows of the other side, the
    batch's rows of A read and of An read and written (and in the padded
    modes the gathered columns' rows of Qn read and written), the lengths
    and losses; 4 d + 8 operations per entry (5 d + 8 with the element
    floor)."""
    from buffalo_tpu_torch.data.batching import StagedSegmentBatch

    seg = isinstance(batch, StagedSegmentBatch)
    lens = batch.chunk_lens if seg else batch.lens
    n, R = int(lens.sum()), (batch.rows if seg else lens).shape[0]
    cols = distinct(torch, batch.cols, lens)
    if padded:
        return 12 * R + 8 * n + 4 * d * (3 * R + 3 * cols), n * (5 * d + 8)
    return ((0 if seg else 8 * R) + 8 * n + 4 * d * (cols + 3 * R),
            n * (4 * d + 8))


def k15_check(PK, torch, An0, A, Bf, batch, *, padded=False, Qn0=None):
    """K15 on one batch against its plain version: (largest absolute error
    of the sums, that relative to the largest sum, the loss's relative
    error, bitwise repeatable)."""
    from buffalo_tpu_torch.data.batching import RangeBatch

    outs = [[An0.clone()] + ([Qn0.clone()] if padded else [])
            for _ in range(3)]
    kw = dict(padded=True, Qn=outs[0][1]) if padded else {}
    loss = PK.plsi_estep(outs[0][0], A, Bf, batch, **kw)
    kw = dict(padded=True, Qn=outs[1][1]) if padded else {}
    again = PK.plsi_estep(outs[1][0], A, Bf, batch, **kw)
    if padded:
        ref = PK.estep_padded_plain(outs[2][0], outs[2][1], A, Bf, batch)
    elif isinstance(batch, RangeBatch):
        ref = PK.estep_range_plain(outs[2][0], A, Bf, int(batch.row_start),
                                   batch.lens, batch.cols, batch.vals)
    else:
        ref = PK.estep_segment_plain(outs[2][0], A, Bf, batch)
    torch.cuda.synchronize()
    errs = [rel_err(g, r) for g, r in zip(outs[0], outs[2])]
    loss_err = float((loss.double().sum() - ref.double().sum()).abs()
                     / ref.double().sum().abs())
    same = all(torch.equal(a, b) for a, b in zip(outs[0], outs[1])) and \
        torch.equal(loss, again)
    return (max(e[0] for e in errs), max(e[1] for e in errs), loss_err,
            same)


def short_range_batch(st):
    """(half, the range batch with the most rows of fewer than
    K15_SHORT_ROW entries, that count): the item half's, or the user
    half's where the item half has none (the ML-20M synthetic's items all
    have 32 users or more)."""
    from buffalo_tpu_torch.data.batching import RangeBatch
    from buffalo_tpu_torch.ops.als_kernels import _flat

    def short(b):
        return int(((b.lens > 0) & (b.lens < K15_SHORT_ROW)).sum())
    for half in ("item", "user"):
        batches = [b for b in _flat(st["col_groups" if half == "item" else
                                       "row_groups"])
                   if isinstance(b, RangeBatch)]
        b = max(batches, key=short)
        if short(b) > 0 or half == "user":
            return half, b, short(b)


def plsi_kernels(PK, torch, model, st, k15_epoch):
    """K15 and K16 against their plain versions on the trained model's
    ML-20M layout: K15's range mode on the user half's range batch with the
    most entries (and on Dirichlet tables, where the element floor must fail
    the check) and on the range batch with the most short rows
    (``short_range_batch``), its segment mode on the item half's largest
    segment batch, its padded mode on the rowwise padded batch with the
    most entries; K16 masked on the permuted tables and unmasked on the
    model's.  Returns the kernels line's entries, K15's with
    ``plsi_path``'s epoch figures ``k15_epoch``."""
    import torch.nn.functional as F
    from buffalo_tpu_torch.data.batching import (PaddedBatch, RangeBatch,
                                                 StagedSegmentBatch)

    dev = model.device
    _, P, Q = plsi_inputs(torch, model)
    d = P.shape[1]
    big = max((b for b in st["row_groups"] if isinstance(b, RangeBatch)),
              key=lambda b: int(b.lens.sum()))
    abs_err, err, loss_err, same = k15_check(PK, torch, torch.zeros_like(P),
                                             P, Q, big)
    Ps, Qs = dirichlet_tables(torch, P.shape[0], Q.shape[0], d, dev, 15)
    _, s_err, s_loss_err, s_same = k15_check(
        PK, torch, torch.zeros_like(P), Ps, Qs, big)
    B = big.cols.shape[0]
    rs = int(big.row_start)
    wrong, ref = torch.zeros_like(Ps), torch.zeros_like(Ps)
    PK.estep_range_plain(ref, Ps, Qs, rs, big.lens, big.cols, big.vals)
    PK.estep_padded_plain(wrong, torch.zeros_like(Qs), Ps, Qs, PaddedBatch(
        torch.arange(rs, rs + B, device=dev, dtype=torch.int32), big.lens,
        big.cols, big.vals))
    wrong_err = rel_err(wrong, ref)[1]
    check(max(err, s_err) <= TOL_K15 and max(loss_err, s_loss_err) <= TOL_K15
          and same and s_same, f"K15 range mode: sums {err:.3g} / "
          f"{s_err:.3g}, loss {loss_err:.3g} / {s_loss_err:.3g} from the "
          f"plain version (repeatable: {same}, {s_same})")
    check(wrong_err > TOL_K15, f"the K15 check passes the element floor in "
          f"the range mode ({wrong_err:.3g})")
    # short rows: the team form (four floats a lane)
    s_half, sb, n_short = short_range_batch(st)
    A_s, B_s = (P, Q) if s_half == "user" else (Q, P)
    An_s = torch.zeros_like(A_s)
    _, sh_err, sh_loss_err, sh_same = k15_check(
        PK, torch, torch.zeros_like(A_s), A_s, B_s, sb)
    check(sh_err <= TOL_K15 and sh_loss_err <= TOL_K15 and sh_same,
          f"K15 range mode on short rows ({s_half} half): {sh_err:.3g}, "
          f"loss {sh_loss_err:.3g}, repeatable {sh_same}")
    seg = max((b for b in st["col_groups"]
               if isinstance(b, StagedSegmentBatch)),
              key=lambda b: int(b.chunk_lens.sum()), default=None)
    check(seg is not None, "the item half has no segment batch")
    _, g_err, g_loss_err, g_same = k15_check(PK, torch, torch.zeros_like(Q),
                                             Q, P, seg)
    check(g_err <= TOL_K15 and g_loss_err <= TOL_K15 and g_same,
          f"K15 segment mode: {g_err:.3g}, loss {g_loss_err:.3g}, "
          f"repeatable {g_same}")
    # the padded mode on the rowwise batches of the fallback path
    batcher = model._rowwise_batcher()
    pb = max((b for b in batcher.device_batches()
              if isinstance(b, PaddedBatch)),
             key=lambda b: int(b.lens.sum()))
    Pu = torch.from_numpy(model.P).to(dev)
    Qu = torch.from_numpy(model.Q).to(dev)
    _, p_err, p_loss_err, p_same = k15_check(
        PK, torch, torch.zeros_like(Pu), Pu, Qu, pb, padded=True,
        Qn0=torch.zeros_like(Qu))
    check(p_err <= TOL_K15 and p_loss_err <= TOL_K15 and p_same,
          f"K15 padded mode: {p_err:.3g}, loss {p_loss_err:.3g}, "
          f"repeatable {p_same}")
    # times and bounds: range mode (the kernels line), segment and padded
    An = torch.zeros_like(P)
    n = int(big.lens.sum())
    bms, by = bound_ms(*k15_work(torch, big, d))
    n_seg = int(seg.chunk_lens.sum())
    R_seg = seg.rows.shape[0]
    n_pad = int(pb.lens.sum())
    AnQ, AnP, Qn = (torch.zeros_like(t) for t in (Q, Pu, Qu))
    k15 = dict(
        route="cuda", source="buffalo_tpu_torch/csrc/plsi_estep.cu",
        replaces="buffalo_tpu/ops/plsi_kernels.py:111", max_abs_err=abs_err,
        ms=time_ms(lambda: PK.plsi_estep(An, P, Q, big)),
        device_ms=trace_ms(lambda: PK.plsi_estep(An, P, Q, big),
                           "rows_kernel"),
        plain_ms=time_ms(lambda: PK.estep_range_plain(
            An, P, Q, rs, big.lens, big.cols, big.vals), reps=5, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=None, **k15_epoch,
        batch=list(big.cols.shape), entries=n, rel_err=err,
        loss_rel_err=loss_err, dirichlet_rel_err=s_err,
        dirichlet_loss_rel_err=s_loss_err,
        element_floor_rel_err=wrong_err, repeatable=same and s_same,
        short_rows=dict(
            half=s_half, batch=list(sb.cols.shape), rows_under_32=n_short,
            entries=int(sb.lens.sum()), rel_err=sh_err,
            loss_rel_err=sh_loss_err, repeatable=sh_same,
            device_ms=trace_ms(lambda: PK.plsi_estep(An_s, A_s, B_s, sb),
                               "rows_kernel"),
            bound_ms=bound_ms(*k15_work(torch, sb, d))[0]),
        segment=dict(
            rows=R_seg, chunks=int(seg.chunk_lens.numel()), entries=n_seg,
            rel_err=g_err, loss_rel_err=g_loss_err,
            ms=time_ms(lambda: PK.plsi_estep(AnQ, Q, P, seg)),
            device_ms=trace_ms(lambda: PK.plsi_estep(AnQ, Q, P, seg),
                               "chunk_rows"),
            plain_ms=time_ms(lambda: PK.estep_segment_plain(
                AnQ, Q, P, seg), reps=5, warmup=1),
            bound_ms=bound_ms(*k15_work(torch, seg, d))[0]),
        padded=dict(
            batch=list(pb.cols.shape), entries=n_pad, rel_err=p_err,
            loss_rel_err=p_loss_err,
            ms=time_ms(lambda: PK.plsi_estep(AnP, Pu, Qu, pb, padded=True,
                                             Qn=Qn)),
            plain_ms=time_ms(lambda: PK.estep_padded_plain(
                AnP, Qn, Pu, Qu, pb), reps=5, warmup=1),
            bound_ms=bound_ms(*k15_work(torch, pb, d, padded=True))[0]))
    # K16: masked on the permuted tables after one accumulation, unmasked
    # on the model's
    o = model.opt
    Pn, Qn2 = torch.zeros_like(P), torch.zeros_like(Q)
    for g in st["row_groups"]:
        PK.plsi_accumulate_group(Pn, P, Q, g, with_loss=False)
    for g in st["col_groups"]:
        PK.plsi_accumulate_group(Qn2, Q, P, g, with_loss=False)
    kw_m = dict(alpha1=float(o.alpha1), alpha2=float(o.alpha2),
                num_items=ML20M_ITEMS, p_mask=st["p_mask"],
                q_mask=st["q_mask"])
    kw_u = dict(alpha1=float(o.alpha1), alpha2=float(o.alpha2))
    m_err, errs = 0.0, {}
    for name, (tp, tq), kw in (("masked", (Pn, Qn2), kw_m),
                               ("unmasked", (Pu, Qu), kw_u)):
        runs = [[tp.clone(), tq.clone()] for _ in range(3)]
        PK.plsi_mstep(*runs[0], **kw)
        PK.plsi_mstep(*runs[1], **kw)
        PK.mstep_plain(*runs[2], **kw)
        torch.cuda.synchronize()
        e = max(float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
                for a, b in zip(runs[0], runs[2]))
        rep = all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
        check(e <= TOL_K16 and rep, f"K16 {name}: {e:.3g} from the plain "
              f"version (repeatable: {rep})")
        errs[name] = e
        m_err = max(m_err, max(float((a - b).abs().max())
                               for a, b in zip(runs[0], runs[2])))
    Pt, Qt = Pn.clone(), Qn2.clone()
    nel = Pt.numel() + Qt.numel()
    # each table read once and written once, and the masks read

    def library():
        F.normalize(Pt + float(o.alpha1) / d, p=1, dim=1)
        F.normalize(Qt + float(o.alpha2) / ML20M_ITEMS, p=1, dim=0)

    bms, by = bound_ms(4 * (2 * nel + Pt.shape[0] + Qt.shape[0]), 3 * nel)
    k16 = dict(route="cuda", source="buffalo_tpu_torch/csrc/plsi_mstep.cu",
               replaces="buffalo_tpu/ops/plsi_kernels.py:209",
               max_abs_err=m_err,
               ms=time_ms(lambda: PK.plsi_mstep(Pt, Qt, **kw_m)),
               plain_ms=time_ms(lambda: PK.mstep_plain(Pt, Qt, **kw_m)),
               bound_ms=bms, bound_by=by, library_ms=time_ms(library),
               tables=[list(Pt.shape), list(Qt.shape)], rel_err=errs)
    phase("plsi_kernels", d=d, k15=k15, k16=k16, tol_k15=TOL_K15,
          tol_k16=TOL_K16)
    del P, Q, Ps, Qs, Pu, Qu, An, AnQ, AnP, Pn, Qn, Qn2, Pt, Qt, wrong, ref
    del A_s, B_s, An_s
    torch.cuda.empty_cache()
    return {"plsi_estep": k15, "plsi_mstep": k16}


def brunch_corpus(path):
    """The KakaoBrunch12M-shaped stream file (the JAX package's stream
    benchmark's synthesis, seed 7): Zipf(0.8) item popularity over
    BRUNCH_VOCAB items, Poisson line lengths scaled to BRUNCH_TOKENS."""
    rng = np.random.default_rng(7)
    pop = 1.0 / np.arange(1, BRUNCH_VOCAB + 1) ** 0.8
    pop /= pop.sum()
    lens = np.maximum(1, rng.poisson(BRUNCH_TOKENS / BRUNCH_LINES,
                                     BRUNCH_LINES))
    lens = np.maximum(1, (lens * (BRUNCH_TOKENS / lens.sum())).astype(
        np.int64))
    items = rng.choice(BRUNCH_VOCAB, size=int(lens.sum()), p=pop)
    with open(path, "w") as fh:
        pos = 0
        for n in lens:
            fh.write(" ".join(map(str, items[pos:pos + n])) + "\n")
            pos += n
    return int(lens.sum())


def stream_build(bt, torch):
    """The brunch corpus written and built through ``Stream`` (matrix
    internal type, SPPMI windows 5 and k 10); the native SPPMI builder
    byte-equal to the numpy one on the corpus's first STREAM_SLICE lines.
    Returns the opened data."""
    from buffalo_tpu_torch.data import fileio, native

    path = os.path.join(WORK, "brunch.txt")
    st = time.perf_counter()
    tokens = brunch_corpus(path)
    corpus_s = time.perf_counter() - st
    sopt = bt.StreamOptions().get_default_option()
    sopt.input.main = path
    sopt.data.path = os.path.join(WORK, "brunch.bfo")
    sopt.data.tmp_dir = os.path.join(WORK, "tmp")
    sopt.data.internal_data_type = "matrix"
    sopt.data.validation = {}
    sopt.data.sppmi = {"windows": 5, "k": 10}
    st = time.perf_counter()
    data = bt.data.load(sopt)
    data.create()
    build_s = time.perf_counter() - st
    header = data.get_header()
    # the slice: the first lines' order-preserving token ids
    seqs = []
    with open(path) as fh:
        for _ in range(STREAM_SLICE):
            seqs.append(np.array(fh.readline().split(), dtype=np.int64))
    indptr = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=indptr[1:])
    keys = np.concatenate(seqs).astype(np.int32)
    have_native = native.get_lib() is not None
    st = time.perf_counter()
    got = fileio.build_sppmi(indptr, keys, BRUNCH_VOCAB, window=5, k=10)
    native_s = time.perf_counter() - st
    lib = native.build_sppmi_native
    native.build_sppmi_native = lambda *a, **k: None
    try:
        st = time.perf_counter()
        ref = fileio.build_sppmi(indptr, keys, BRUNCH_VOCAB, window=5, k=10)
        numpy_s = time.perf_counter() - st
    finally:
        native.build_sppmi_native = lib
    equal = all(a.dtype == b.dtype and np.array_equal(a, b)
                for a, b in zip(got, ref))
    check(have_native and equal, f"SPPMI on the slice: native library "
          f"{have_native}, native and numpy byte-equal {equal}")
    phase("stream_build", lines=BRUNCH_LINES, vocab=BRUNCH_VOCAB,
          tokens=tokens, users=header["num_users"],
          items=header["num_items"], nnz=header["num_nnz"],
          sppmi_nnz=int(data.attrs["sppmi_nnz"]),
          corpus_write_seconds=corpus_s, build_host_seconds=build_s,
          slice_lines=STREAM_SLICE, slice_sppmi_nnz=int(len(got[1])),
          slice_native_seconds=native_s, slice_numpy_seconds=numpy_s,
          slice_byte_equal=equal)
    return data


def cfr_tables(torch, model):
    """Copies of the CFR model's tables on the card: (U, I, C, Ib, Cb)."""
    return tuple(torch.from_numpy(t).to(model.device, copy=True) for t in
                 (model.U, model.I, model.C, model.Ib, model.Cb))


def cfr_path(bt, CK, K, R, torch, data):
    """CoFactor on the brunch data at d = CFR_D (CFROption defaults
    otherwise), CFR_EPOCHS epochs through the user's entry points: one K17,
    one K3 and one K18 launch per batch of each phase, the loss finite and
    falling, a profiled epoch; ParCFR top-10 for CFR_USERS users held to
    numpy.  Returns (model, the path's launches, its batches staged on the
    card, K18's device launches and busy ms per epoch)."""
    from buffalo_tpu_torch.models.cfr import _stage_entry

    opt = bt.CFROption().get_default_option()
    opt.update(d=CFR_D, num_iters=CFR_EPOCHS, device="cuda", validation={})
    model = bt.CFR(opt, data=data)
    np.random.seed(0)
    model.initialize()
    kernels = CK.KERNELS + (K.batched_cg_dense,)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    CK.cfr_bias.device_launches = 0
    st = time.perf_counter()
    model.train()
    train_s = time.perf_counter() - st
    launches = read_counts(kernels)
    k18_device_launches = CK.cfr_bias.device_launches
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    losses = model.iteration_losses
    check(len(losses) == CFR_EPOCHS and all(np.isfinite(losses))
          and all(b < a for a, b in zip(losses, losses[1:]))
          and all(np.isfinite(getattr(model, t)).all()
                  for t in ("U", "I", "C", "Ib", "Cb")),
          f"CFR loss not finite and falling: {losses}")
    host = model._build_batches()
    staged = {k: [_stage_entry(e, model.device) for e in v]
              for k, v in host.items()}
    tabs = cfr_tables(torch, model)
    sizes = {k: len(v) for k, v in host.items()}
    nb = sum(sizes.values())
    want = dict(cfr_normal_equations=nb * CFR_EPOCHS,
                cfr_bias=nb * CFR_EPOCHS, batched_cg_dense=nb * CFR_EPOCHS)
    check(launches == want, f"CFR epochs launched {launches}, expected "
          f"{want}")
    o = model.opt
    kw = dict(alpha=float(o.alpha), l=float(o.l), reg_u=float(o.reg_u),
              reg_i=float(o.reg_i), reg_c=float(o.reg_c),
              optimizer=str(o.optimizer), cg_iters=int(o.num_cg_max_iters),
              cg_tol=float(o.cg_tolerance), compute_loss=True)
    one = bt.parallelism.Mesh([model.device])
    prof = profile_call(torch, lambda: float(CK.cfr_epoch(
        one, {model.device: list(tabs)}, staged["user"], staged["item"],
        staged["context"], **kw)), top=30)
    k18_epoch = dict(
        device_launches_per_epoch=k18_device_launches / CFR_EPOCHS,
        epoch_device_ms=sum(v for k, v in prof["device_ms_by_name"].items()
                            if k.startswith("bias_")))
    users = [str(u) for u in range(1, CFR_USERS + 1)]
    par = bt.ParCFR(model)
    reset_counts(R.KERNELS)
    ms_first, (keys, ids, _) = wall_ms(
        lambda: par.topk_recommendation(users, topk=TOPK))
    ms_warm, _ = wall_ms(lambda: par.topk_recommendation(users, topk=TOPK))
    k5 = R.score_topk.launches
    check(keys == users and ids.shape == (CFR_USERS, TOPK) and k5 == 2,
          f"ParCFR top-10 malformed or not one K5 launch per call ({k5})")
    # numpy's float64 scores of the first CFR_CHECK_USERS users (all 10,000
    # would take 40 GB of host memory)
    rows = np.asarray(model.get_index(users[:CFR_CHECK_USERS], group="user"),
                      dtype=np.int64)
    same = ids_match_numpy(ids[:CFR_CHECK_USERS], model.U[rows], model.I,
                           what="ParCFR.topk_recommendation")
    med = float(np.median(model.iteration_times[1:]))
    phase("cfr_path", d=CFR_D, epochs=CFR_EPOCHS, alpha=o.alpha, l=o.l,
          reg=o.reg_u, optimizer=o.optimizer, cg_iters=o.num_cg_max_iters,
          batches=sizes, segment_pairs=sum(len(e) == 2 for e in host["item"]),
          train_loss=losses, epoch_seconds=model.iteration_times,
          median_epoch_seconds_2_4=med, train_seconds=train_s,
          launches=launches, launches_per_epoch=per_epoch(launches,
                                                          CFR_EPOCHS),
          max_memory_allocated_mb=peak_mb, epoch_profile=prof,
          topk_users=CFR_USERS, topk_checked_users=CFR_CHECK_USERS,
          topk_k5_launches=k5,
          topk_host_ms_first=ms_first, topk_host_ms_warm=ms_warm,
          topk_same_as_numpy=same)
    del tabs
    torch.cuda.empty_cache()
    return model, {k: launches[k] for k in ("cfr_normal_equations",
                                            "cfr_bias")}, staged, k18_epoch


def k17_check(CK, torch, X, rows, kw):
    """K17 against its plain version on one batch: (A and y errors relative
    to their largest, loss error, totals equal, repeatable, the outputs)."""
    got = CK.cfr_normal_equations(X, rows, **kw)
    again = CK.cfr_normal_equations(X, rows, **kw)
    ref = CK.cfr_normal_equations_plain(X, rows, **kw)
    torch.cuda.synchronize()
    errs = [rel_err(a, b)[1] for a, b in zip(got[:2], ref[:2])]
    loss_err = rel_err(got[2], ref[2])[1]
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    return max(errs), loss_err, torch.equal(got[3], ref[3]), same, got, ref


def k17_bound(torch, kw, rows, d):
    """K17's bound on one batch: each side's entries (col, value), each
    distinct gathered row and the batch's rows of X read once, FF once, A,
    y, loss and total written once; d (d + 1) + 4 d operations per entry
    (the symmetric A, y and the loss).  (ms, "bytes" or "operations",
    entries)."""
    B = rows.shape[0]
    n, nbytes = 0, 16 * B + 4 * d * B + 4 * B * (d * d + d + 2)
    for side in (kw.get("implicit"), kw.get("explicit")):
        if side is None:
            continue
        lens = side.lens if side.chunk_ptr is None else side.chunk_lens
        m = int(lens.sum())
        n += m
        nbytes += 8 * m + 4 * d * distinct(torch, side.cols, lens)
    if kw.get("implicit") is not None:
        nbytes += 4 * d * d
    ms, by = bound_ms(nbytes, n * (d * (d + 1) + 4 * d))
    return ms, by, n


def k18_work(torch, rows, side, d):
    """(bytes, operations) of one K18 call: each live entry's id and value,
    the rows' ids, totals and lengths, each distinct gathered row and its
    cbias entry, the batch's rows of X read once, the bias written once;
    2 d + 3 operations per entry.  The loss term alone (no side): each
    row's x read, its loss entry read and written, 2 d operations."""
    B = rows.shape[0]
    if side is None:
        return 4 * d * B + 8 * B, 2 * d * B
    c = live_cols(torch, side)
    n = int(c.numel())
    dist = n_distinct(torch, c) if n else 0
    return (8 * n + 12 * B + 4 * d * (dist + B) + 4 * dist + 4 * B,
            n * (2 * d + 3))


def k18_epoch_bound(CK, torch, staged, d):
    """K18's bound over one CFR epoch on its staged batches: the sum of its
    calls' ``k18_work`` (the user batches' loss term, each item entry's
    SPPMI side, each context batch), as (ms, "bytes" or "operations")."""
    nbytes = flops = 0
    calls = [(b.rows, None) for b in staged["user"]]
    for e in staged["item"]:
        if len(e) == 2:
            calls.append((e[0].rows, e[1]))
        else:
            calls.append((e[0].rows, CK.Side(None, *e[1:])))
    calls += [(b.rows, b) for b in staged["context"]]
    for rows, side in calls:
        nb, fl = k18_work(torch, rows, side, d)
        nbytes += nb
        flops += fl
    return bound_ms(nbytes, flops)


def k18_check(CK, K, torch, X, rows, kw, sys_, cg, own, other):
    """K18 on the rows K3 solves from K17's systems ``sys_`` (A, y, total)
    of one batch (K17's arguments ``kw``; ``own`` the bias it writes,
    ``other`` the bias of its columns): within TOL_K18 of the largest bias
    of the plain version, bitwise repeatable, and the check failing on the
    rows before the solve.  Returns (fields: errors, event and CUPTI ms,
    bound; the four bias runs: kernel, kernel, plain, plain on the old
    rows; the solved table)."""
    A, y, total = sys_
    exp = kw["explicit"]
    idx = rows.long()[(total > 0) & (rows < X.shape[0])]
    X_new = X.clone()
    K.batched_cg_dense(A, y, X_new, total, rows=rows, **cg)
    runs = [own.clone() for _ in range(4)]
    CK.cfr_bias(X_new, rows, total, explicit=exp, bias=runs[0], cbias=other)
    CK.cfr_bias(X_new, rows, total, explicit=exp, bias=runs[1], cbias=other)
    CK.cfr_bias_plain(X_new, rows, total, explicit=exp, bias=runs[2],
                      cbias=other)
    CK.cfr_bias_plain(X, rows, total, explicit=exp, bias=runs[3],
                      cbias=other)
    torch.cuda.synchronize()
    err = rel_err(runs[0][idx], runs[2][idx])[1]
    old_err = rel_err(runs[3][idx], runs[2][idx])[1]
    rep = torch.equal(runs[0], runs[1])
    seg = exp.chunk_ptr is not None
    what = (f"{rows.shape[0]} rows, {'chunks' if seg else 'L'} "
            f"{exp.cols.shape[0 if seg else 1]}")
    check(err <= TOL_K18 and rep, f"K18 ({what}): {err:.3g} from the plain "
          f"version (repeatable {rep})")
    check(old_err > TOL_K18, f"the K18 check ({what}) passes the rows "
          f"before the solve ({old_err:.3g})")

    def fn():
        CK.cfr_bias(X_new, rows, total, explicit=exp, bias=runs[1],
                    cbias=other)

    bms, by = bound_ms(*k18_work(torch, rows, exp, X.shape[1]))
    return (dict(rel_err=err, old_rows_rel_err=old_err, rows=int(rows.shape[0]),
                 width=int(exp.cols.shape[1]),
                 chunks=int(exp.cols.shape[0]) if seg else None,
                 entries=int(live_cols(torch, exp).numel()),
                 ms=time_ms(fn), device_ms=trace_ms(fn, "bias_kernel"),
                 bound_ms=bms, bound_by=by), runs, X_new)


def cfr_kernels(CK, K, torch, model, staged, k18_epoch):
    """K17 and K18 against their plain versions on the trained model's
    brunch batches: K17 on the user batch, the padded item entry and the
    context batch with the most entries and on the item segment pair with
    the most chunks (a run without the explicit term must fail the item
    check); K3's solves of the item systems by the CG rule; K18 after K3's
    solve of the item entry, the segment pair and the padded context batch
    with the longest rows (``k18_check``).  Returns the kernels line's
    entries, K18's with ``k18_epoch`` (``cfr_path``'s device launches and
    busy ms per epoch) and its bound over an epoch."""
    from buffalo_tpu_torch.data.batching import StagedSegmentBatch
    from buffalo_tpu_torch.ops.als_kernels import gramian
    from buffalo_tpu_torch.ops.cfr_kernels import (LOSS_EXPLICIT,
                                                   LOSS_IMPLICIT, LOSS_REG,
                                                   Side)

    o = model.opt
    d = CFR_D
    U, I, C, Ib, Cb = cfr_tables(torch, model)
    alpha, l, reg = float(o.alpha), float(o.l), float(o.reg_i)
    flags = LOSS_IMPLICIT | LOSS_EXPLICIT | LOSS_REG

    def entries(e):
        """Live entries of a staged batch, item entry or segment pair."""
        if hasattr(e, "lens"):
            return int(e.lens.sum())
        other = e[1].lens if hasattr(e[1], "lens") else e[1]
        return int(e[0].lens.sum()) + int(other.sum())

    padded = [e for e in staged["item"] if len(e) == 4]
    pairs = [e for e in staged["item"] if len(e) == 2]
    check(bool(padded) and bool(pairs), "the item phase lacks a padded "
          "entry or a segment pair")
    ub = max(staged["user"], key=entries)
    ie = max(padded, key=entries)
    cb = max(staged["context"], key=entries)
    FFi, FFu = gramian(I), gramian(U)
    b, lens_c, cols_c, vals_c = ie
    item_kw = dict(implicit=Side.of(U, b),
                   explicit=Side(C, lens_c, cols_c, vals_c), FF=FFu,
                   rbias=Ib, cbias=Cb, alpha=alpha, l=l, reg=reg, loss=flags)
    cases = {
        "user": (U, ub.rows, dict(implicit=Side.of(I, ub), FF=FFi,
                                  alpha=alpha, l=l, reg=float(o.reg_u))),
        "item": (I, b.rows, item_kw),
        "context": (C, cb.rows, dict(explicit=Side.of(I, cb), rbias=Cb,
                                     cbias=Ib, reg=float(o.reg_c),
                                     loss=LOSS_REG)),
    }
    sb_u, sb_c = max(pairs, key=lambda e: int(e[0].chunk_lens.numel()
                                              + e[1].chunk_lens.numel()))
    cases["segment_pair"] = (I, sb_u.rows, dict(
        item_kw, implicit=Side.of(U, sb_u), explicit=Side.of(C, sb_c)))
    k17_errs, out = {}, {}
    for name, (X, rows, kw) in cases.items():
        e, le, tot, rep, got, ref = k17_check(CK, torch, X, rows, kw)
        check(e <= TOL_K17 and le <= TOL_K17 and tot and rep,
              f"K17 {name}: A/y {e:.3g}, loss {le:.3g} from the plain "
              f"version (totals equal {tot}, repeatable {rep})")
        k17_errs[name] = dict(rel_err=e, loss_rel_err=le)
        out[name] = (got, ref)
    got, ref = out["item"]
    no_exp = CK.cfr_normal_equations_plain(I, b.rows,
                                           **dict(item_kw, explicit=None))
    wrong_err = rel_err(got[0], no_exp[0])[1]
    check(wrong_err > TOL_K17, f"the K17 check passes a run without the "
          f"explicit term ({wrong_err:.3g})")
    # K3 on the item systems, by the CG rule, from the rows K17 read
    A, y, _, total = got
    live = (total > 0) & (b.rows < I.shape[0])
    idx = b.rows.long()[live]
    cg = dict(cg_iters=int(o.num_cg_max_iters), cg_tol=float(o.cg_tolerance))
    ok, solve_fields, short_ok = floor_check(
        lambda t: K.batched_cg_dense(A, y, t, total, rows=b.rows, **cg),
        lambda t, it: K.batched_cg_dense_plain(
            A.to(t.dtype), y.to(t.dtype), t, total, rows=b.rows,
            cg_iters=it, cg_tol=cg["cg_tol"]), I, idx)
    check(ok, f"K3 on the CFR item systems: {solve_fields}")
    # K18 after K3's solve of the item entry's rows, of the item segment
    # pair's and of the padded context batch with the longest rows: the new
    # rows' biases; on the rows before the solve each check misses
    sb_rows, sb_kw = cases["segment_pair"][1], cases["segment_pair"][2]
    cl = max((e for e in staged["context"]
              if not isinstance(e, StagedSegmentBatch)),
             key=lambda e: int(e.lens.max()))
    cl_kw = dict(explicit=Side.of(I, cl), rbias=Cb, cbias=Ib,
                 reg=float(o.reg_c), loss=LOSS_REG)
    k18_cases = {}
    for name, X, rows, kw, sys_ in (
            ("item", I, b.rows, item_kw, (A, y, total)),
            ("segment_pair", I, sb_rows, sb_kw, None),
            ("context_longest", C, cl.rows, cl_kw, None)):
        if sys_ is None:
            sys_ = CK.cfr_normal_equations(X, rows, **kw)
            sys_ = (sys_[0], sys_[1], sys_[3])
        k18_cases[name] = k18_check(CK, K, torch, X, rows, kw, sys_, cg,
                                    *((Ib, Cb) if X is I else (Cb, Ib)))
        if name != "item":
            k18_cases[name] = k18_cases[name][0]
    exp = item_kw["explicit"]
    k18_fields, runs, I_new = k18_cases.pop("item")
    # times, bounds and the library product on the item entry
    n_u = int(b.lens.sum())
    n_c = int(lens_c.sum())
    B = b.rows.shape[0]
    dist_u = distinct(torch, b.cols, b.lens)
    dist_c = distinct(torch, cols_c, lens_c)
    nbytes = (8 * (n_u + n_c) + 16 * B + 4 * d * (dist_u + dist_c + B)
              + 4 * dist_c + 4 * d * d + 4 * B * (d * d + d + 2))
    bms, by = bound_ms(nbytes, (n_u + n_c) * (d * (d + 1) + 4 * d))
    # the library's A: one bmm over both sides, the implicit rows weighted
    # by alpha v and the SPPMI rows by 1, each side's padding by 0
    def weights(lens, L, w):
        return (torch.arange(L, device=U.device)[None, :]
                < lens[:, None]).float() * w
    Fg = torch.cat([U[b.cols.long()], C[cols_c.long()]], dim=1)
    Fw = (Fg * torch.cat([weights(b.lens, b.cols.shape[1], alpha * b.vals),
                          weights(lens_c, cols_c.shape[1], 1.0)],
                         dim=1)[:, :, None]).transpose(1, 2)
    k17 = dict(route="cuda",
               source="buffalo_tpu_torch/csrc/cfr_normal_equations.cu",
               replaces="buffalo_tpu/ops/cfr_kernels.py:29",
               max_abs_err=float((got[0] - ref[0]).abs().max()),
               ms=time_ms(lambda: CK.cfr_normal_equations(I, b.rows,
                                                          **item_kw)),
               plain_ms=time_ms(lambda: CK.cfr_normal_equations_plain(
                   I, b.rows, **item_kw), reps=5, warmup=1),
               bound_ms=bms, bound_by=by,
               library_ms=time_ms(lambda: torch.bmm(Fw, Fg)),
               batch=[B, int(b.cols.shape[1]), int(cols_c.shape[1])],
               implicit_entries=n_u, explicit_entries=n_c, checks=k17_errs,
               no_explicit_rel_err=wrong_err,
               k3_item_solve=dict(solve_fields,
                                  one_step_fewer_passes=short_ok))
    for name in ("user", "context", "segment_pair"):
        X, rows, kw = cases[name]
        k17[f"{name}_ms"] = time_ms(
            lambda: CK.cfr_normal_equations(X, rows, **kw))
        (k17[f"{name}_bound_ms"], k17[f"{name}_bound_by"],
         k17[f"{name}_entries"]) = k17_bound(torch, kw, rows, d)
    k18 = dict(route="cuda", source="buffalo_tpu_torch/csrc/cfr_bias.cu",
               replaces="buffalo_tpu/ops/cfr_kernels.py:146",
               max_abs_err=float((runs[0] - runs[2]).abs().max()),
               plain_ms=time_ms(lambda: CK.cfr_bias_plain(
                   I_new, b.rows, total, explicit=exp, bias=runs[3],
                   cbias=Cb), reps=5, warmup=1),
               library_ms=None, **k18_fields,
               epoch_bound_ms=k18_epoch_bound(CK, torch, staged, d)[0],
               **k18_epoch, checks=k18_cases)
    phase("cfr_kernels", d=d, k17=k17, k18=k18, tol_k17=TOL_K17,
          tol_k18=TOL_K18)
    del U, I, C, Ib, Cb, out, got, ref, A, y, I_new, Fg, Fw, runs
    torch.cuda.empty_cache()
    return {"cfr_normal_equations": k17, "cfr_bias": k18}


def w2v_build(bt):
    """The brunch corpus of ``stream_build`` built again as ``stream``
    (order-preserving token lists, no SPPMI): W2V trains on token order,
    which the ``matrix`` build's per-line dedupe loses.  Returns (data,
    host seconds)."""
    sopt = bt.StreamOptions().get_default_option()
    sopt.input.main = os.path.join(WORK, "brunch.txt")
    sopt.data.path = os.path.join(WORK, "brunch_w2v.bfo")
    sopt.data.tmp_dir = os.path.join(WORK, "tmp")
    sopt.data.internal_data_type = "stream"
    sopt.data.validation = {}
    st = time.perf_counter()
    data = bt.data.load(sopt)
    data.create()
    return data, time.perf_counter() - st


def w2v_opt(bt, **kw):
    """W2V at the JAX package's stream benchmark settings
    (``benchmark/test_stream_scale.py:129-134``: d = W2V_D, min_count 2,
    the defaults otherwise) on the card."""
    opt = bt.W2VOption().get_default_option()
    opt.update(d=W2V_D, min_count=2, num_iters=W2V_EPOCHS, device="cuda")
    opt.update(kw)
    return opt


def w2v_model(bt, data, opt):
    np.random.seed(0)
    model = bt.W2V(opt, data=data)
    model.initialize()
    return model


def w2v_path(bt, W, S, R, torch, data, build_s):
    """W2V's main path on the brunch stream: ``pair_gen`` auto (the device
    epoch), W2V_EPOCHS epochs through the user's entry points: exactly one
    K8, one K21 and two K20 launches per token chunk and none of K19, the
    loss falling every epoch, a profiled epoch; ParW2V top-10 for
    W2V_QUERIES keys held to numpy on the normalized L0.  Returns (model,
    the path's launches, one epoch's host arrays)."""
    model = w2v_model(bt, data, w2v_opt(bt))
    kernels = W.KERNELS + (S.sample_negatives,)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    st = time.perf_counter()
    model.train()
    train_s = time.perf_counter() - st
    launches = read_counts(kernels)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    losses, stats = model.iteration_losses, model.epoch_stats
    check(len(losses) == W2V_EPOCHS and all(np.isfinite(losses))
          and all(b < a for a, b in zip(losses, losses[1:]))
          and np.isfinite(model.L0).all() and np.isfinite(model.L1).all(),
          f"W2V loss not finite and falling: {losses}")
    chunks = sum(s["chunks"] for s in stats)
    want = dict(pair_step=0, row_apply=2 * chunks,
                stream_chunk_deltas=chunks, sample_negatives=chunks)
    check(launches == want, f"W2V epochs launched {launches}, expected "
          f"{want}")
    # one more epoch's device work, profiled: the staged chunks of one
    # host phase through the groups, on copies of the trained tables
    block, T, _ = model._stream_plan()
    G = int(model.opt.max_chunks_per_dispatch)
    wc, bc, hc, nchunks, _ = model._stream_host_phase(
        np.random.default_rng(1), T, G)
    dev = model.device
    g_len = min(G, nchunks)
    staged = [tuple(torch.from_numpy(a[g * g_len:(g + 1) * g_len]).to(dev)
                    for a in (wc, bc, hc)) for g in range(nchunks // g_len)]
    L0 = torch.from_numpy(model.L0).to(dev, copy=True)
    L1 = torch.from_numpy(model.L1).to(dev, copy=True)
    prob, al = S.build_alias_table(np.diff(np.asarray(
        model._vocab.dist, dtype=np.int64), prepend=0))
    alias = (torch.from_numpy(prob).to(dev), torch.from_numpy(al).to(dev))
    o = model.opt
    V = int(model._vocab.size)
    com = dict(seed=0, epoch=W2V_EPOCHS, groups=len(staged),
               window=int(o.window), block=block,
               num_negatives=int(o.num_negative_samples), vocab_size=V,
               compute_loss=True, lr=float(o.lr), min_lr=float(o.min_lr),
               total_words=float(model._vocab.total_word_count),
               words_per_chunk=1.0, max_step_norm=float(o.max_step_norm))

    one = bt.parallelism.Mesh([dev])

    def epoch():
        out = [W.w2v_epoch_stream(one, {dev: (L0, L1)}, *([a] for a in arr),
                                  {dev: alias}, np.float32(0), group=g, **com)
               for g, arr in enumerate(staged)]
        return float(sum(float(x[0]) for x in out))

    prof = profile_call(torch, epoch, top=10)
    del L0, L1, staged
    # serving: ParW2V top-10 for W2V_QUERIES in-vocabulary keys, first call
    # and warm, held to numpy's float64 ranking on the normalized L0
    model.build_itemid_map()
    keys = [model._idmanager.itemids[i]
            for i in model._vocab.inv_index[:W2V_QUERIES]]
    par = bt.ParW2V(model)
    reset_counts(R.KERNELS)
    ms_first, (ids, scores) = wall_ms(lambda: par.most_similar(keys,
                                                               topk=TOPK))
    ms_warm, _ = wall_ms(lambda: par.most_similar(keys, topk=TOPK))
    k5 = R.score_topk.launches
    ids, scores = np.asarray(ids), np.asarray(scores)
    check(ids.shape == (W2V_QUERIES, TOPK) and k5 == 2,
          f"ParW2V top-10 malformed or not one K5 launch per call ({k5})")
    topk = w2v_topk_check(
        model.L0, np.asarray(model.get_index(keys[:W2V_CHECK_QUERIES])),
        ids[:W2V_CHECK_QUERIES], scores[:W2V_CHECK_QUERIES])
    med = float(np.median(model.iteration_times[1:]))
    phase("w2v_path", d=W2V_D, epochs=W2V_EPOCHS, window=int(o.window),
          negatives=int(o.num_negative_samples), sample=o.sample,
          neg_block=block, pair_gen=model._pair_gen(),
          stream_build_host_seconds=build_s, vocab=V,
          total_words=int(model._vocab.total_word_count),
          tokens_kept=[s["tokens"] for s in stats],
          pairs=[s["pairs"] for s in stats], chunk_tokens=T,
          chunks=[s["chunks"] for s in stats],
          groups=[s["groups"] for s in stats], train_loss=losses,
          epoch_seconds=model.iteration_times,
          median_epoch_seconds_2_4=med, train_seconds=train_s,
          host_phase_seconds=[s["host_seconds"] for s in stats],
          h2d_bytes_per_epoch=[s["h2d_bytes"] for s in stats],
          launches=launches, launches_per_epoch=per_epoch(launches,
                                                          W2V_EPOCHS),
          max_memory_allocated_mb=peak_mb, epoch_profile=prof,
          topk_queries=W2V_QUERIES, topk_k5_launches=k5,
          topk_host_ms_first=ms_first, topk_host_ms_warm=ms_warm,
          topk_checked_queries=W2V_CHECK_QUERIES, **topk)
    return model, launches, (wc, bc, hc, alias, block)


def w2v_topk_check(table, idx, ids, scores, chunk=256):
    """ParW2V's top-k of queries ``table[idx]`` against numpy's float64
    scores, in chunks of queries.  A query is near-tied when numpy's k-th and
    (k+1)-th scores are within TOL_SCORE of each other (np.isclose's rule):
    the float32 scores may then rank either id k-th.  Held: numpy's exact
    top-k set on at least MIN_SAME_TOPK of the other queries; on every query
    the returned ids' float64 scores, rank by rank, within TOL_SCORE of
    numpy's top-k; the returned scores within TOL_SCORE.  Returns the
    readings: the shares of queries with numpy's set, near-tied, with
    numpy's set among those not near-tied, with exactly equal k-th and
    (k+1)-th scores; the differing queries that are not near-tied; the
    largest k-th gap among differing queries, the gap's quartiles; the
    share of queries whose ids are a top-k off ties; the largest score
    error."""
    k = ids.shape[1]
    same, gaps, tol, off = [], [], [], []
    err = 0.0
    table64 = table.astype(np.float64)
    for s in range(0, len(idx), chunk):
        full = table64[idx[s:s + chunk]] @ table64.T
        # numpy's top k + 1, highest first (a partition: sorting every row of
        # a 502k-word vocabulary would take most of the phase)
        top = np.argpartition(-full, k, axis=1)[:, :k + 1]
        ref = np.take_along_axis(full, top, axis=1)
        order = np.argsort(-ref, axis=1, kind="stable")
        top = np.take_along_axis(top, order, axis=1)
        ref = np.take_along_axis(ref, order, axis=1)
        gaps += list(ref[:, k - 1] - ref[:, k])
        tol += list(TOL_SCORE * np.abs(ref[:, k - 1]) + TOL_SCORE_ABS)
        ref = ref[:, :k]
        mine = np.take_along_axis(full, ids[s:s + chunk].astype(np.int64),
                                  axis=1)
        same += [set(a) == set(b) for a, b in zip(ids[s:s + chunk],
                                                 top[:, :k])]
        off += list(np.isclose(mine, ref, rtol=TOL_SCORE,
                               atol=TOL_SCORE_ABS).all(axis=1))
        err = max(err, float(np.abs(scores[s:s + chunk] - ref).max()))
    same, gaps, off = np.asarray(same), np.asarray(gaps), np.asarray(off)
    near = gaps <= np.asarray(tol)
    clear = float(same[~near].mean()) if (~near).any() else 1.0
    out = dict(
        topk_same_as_numpy=float(same.mean()),
        topk_near_tied=float(near.mean()),
        topk_same_not_near_tied=clear,
        topk_exact_ties=float((gaps == 0).mean()),
        topk_differing_not_near_tied=int((~same & ~near).sum()),
        topk_max_gap_differing=float(gaps[~same].max()) if (~same).any()
        else None,
        topk_gap_quartiles=[float(q) for q in np.quantile(gaps, [.25, .5,
                                                                 .75])],
        topk_same_off_ties=float(off.mean()), topk_max_score_err=err)
    check(clear >= MIN_SAME_TOPK and out["topk_same_off_ties"] >= MIN_SAME_TOPK
          and err <= TOL_SCORE,   # cosines: |s| <= 1
          f"ParW2V.most_similar: numpy's top-{k} set for {clear:.4f} of the "
          f"queries not near-tied, a top-{k} off ties for "
          f"{out['topk_same_off_ties']:.4f}, scores off numpy's by {err:.3g}")
    return out


def distinct_rows(torch, *keys, R):
    """Distinct ids below R among the int32 tensors ``keys``."""
    k = torch.cat([x.reshape(-1) for x in keys])
    return int(torch.unique(k[k < R]).numel())


def k19_work(torch, inputs, targets, negs, V, d, K):
    """(bytes, operations) of one K19 call: the pairs' ids, each distinct
    input's L0 row and each distinct target's and negative's L1 row read
    once, the negatives' ids and the keys written, the 2 + K delta rows of
    each pair written; 5 d (K + 1) operations a pair."""
    B = inputs.shape[0]
    ui = distinct_rows(torch, inputs, R=V)
    ut = distinct_rows(torch, targets, negs, R=V)
    return (8 * B + 4 * d * (ui + ut) + 4 * (B * K + B * (1 + K))
            + 4 * d * B * (2 + K), B * (K + 1) * 5 * d)


def w2v_kernels(W, S, torch, model, arrays):
    """K19, K20 and K21 against their plain versions at d = W2V_D on the
    brunch data: K21 (with K8's block-shared draws, bit for bit) and K20 on
    the first token chunk of an epoch of the trained model, K19 on the
    first pair chunk of a host-pair epoch; each repeatable, each check
    shown to have power (K20 with the cap off, K21 at window - 1), times,
    bounds and library calls.  Returns the kernels line's entries."""
    wc_h, bc_h, hc_h, alias, block = arrays
    dev = model.device
    o = model.opt
    V, d, K = int(model._vocab.size), W2V_D, int(o.num_negative_samples)
    window, cap, lr = int(o.window), float(o.max_step_norm), float(o.lr)
    L0 = torch.from_numpy(model.L0).to(dev, copy=True)
    L1 = torch.from_numpy(model.L1).to(dev, copy=True)
    # ---- K8 + K21 on the first token chunk
    wc = torch.from_numpy(wc_h[0]).to(dev)
    hc = torch.from_numpy(hc_h[0]).to(dev)
    sc = torch.cumsum(torch.from_numpy(bc_h[0]).to(dev), 0,
                      dtype=torch.int32)
    T = wc.shape[0]
    NB = T // block
    draw = dict(num_negatives=K, seed=0, epoch=0, chunk=0, alias=alias)
    negs = W.stream_negatives(NB, V, device=dev, **draw)
    negs_p, _ = S.sample_negatives_plain(
        torch.zeros(NB, dtype=torch.int32, device=dev), V, **draw)
    check(torch.equal(negs.reshape(-1), negs_p), "K8's block-shared draws "
          "differ from its plain version")
    kw = dict(window=window, block=block, vocab_size=V)
    got = W.stream_chunk_deltas(L0, L1, wc, sc, hc, negs, **kw)
    again = W.stream_chunk_deltas(L0, L1, wc, sc, hc, negs, **kw)
    ref = W.stream_chunk_deltas_plain(L0, L1, wc, sc, hc, negs, **kw)
    short = W.stream_chunk_deltas_plain(L0, L1, wc, sc, hc, negs,
                                        **dict(kw, window=window - 1))
    torch.cuda.synchronize()
    k21_err = max(rel_err(a, b)[1] for a, b in zip(got[:3], ref[:3]))
    short_err = min(rel_err(a, b)[1] for a, b in zip(short[:3], got[:3]))
    k21_loss = abs(float(got[3]) - float(ref[3])) / abs(float(ref[3]))
    k21_rep = all(torch.equal(a, b) for a, b in zip(got, again))
    check(k21_err <= TOL_W2V and k21_loss <= TOL_W2V and k21_rep
          and float(got[4]) == float(ref[4]) > 0,
          f"K21: {k21_err:.3g} from the plain version, loss {k21_loss:.3g}, "
          f"count {float(got[4])} vs {float(ref[4])}, repeatable {k21_rep}")
    check(short_err > TOL_W2V, f"the K21 check passes a run at window - 1 "
          f"({short_err:.3g})")
    # ---- K20 on that chunk's L1 update (positions + negatives)
    dL1p, dLn = got[1], got[2]
    parts = [(wc, dL1p), (negs.reshape(-1), dLn.reshape(-1, d))]
    outs = [L1.clone() for _ in range(4)]
    W.row_apply(outs[0], parts, scale=lr, cap=cap)
    W.row_apply(outs[1], parts, scale=lr, cap=cap)
    W.row_apply_plain(outs[2], parts, scale=lr, cap=cap)
    W.row_apply_plain(outs[3], parts, scale=lr, cap=0.0)
    torch.cuda.synchronize()
    # the scale: the largest entry of the summed row deltas before the cap
    dT = outs[3] - L1
    scale = float(dT.abs().max())
    spacing = 2 * float(torch.finfo(torch.float32).eps) * float(
        L1.abs().max())
    k20_err = float((outs[0] - outs[2]).abs().max())
    off_err = float((outs[3] - outs[2]).abs().max())
    k20_rep = torch.equal(outs[0], outs[1])
    binding = int(((dT * dT).sum(1).sqrt() > cap).sum())
    check(k20_err <= TOL_W2V * scale + spacing and k20_rep and binding > 0,
          f"K20: {k20_err:.3g} from the plain version (row deltas up to "
          f"{scale:.3g}, repeatable {k20_rep}, rows past the cap {binding})")
    check(off_err > TOL_W2V * scale + spacing, f"the K20 check passes a run "
          f"with the cap off ({off_err:.3g})")
    # ---- K19 on the first pair chunk of a host-pair epoch
    chunk = model._pair_chunk()
    inp_h, tgt_h, _ = model._generate_pairs(np.random.default_rng(0))
    inputs = torch.from_numpy(inp_h[:chunk].copy()).to(dev)
    targets = torch.from_numpy(tgt_h[:chunk].copy()).to(dev)
    B = inputs.shape[0]
    pkw = dict(vocab_size=V, num_negatives=K, seed=0, epoch=0, chunk=0,
               alias=alias)
    p_got = W.pair_step(L0, L1, inputs, targets, lr, **pkw)
    p_again = W.pair_step(L0, L1, inputs, targets, lr, **pkw)
    p_negs = W.w2v_negatives(targets, V, num_negatives=K, seed=0, epoch=0,
                             chunk=0, alias=alias)
    p_ref = W.pair_step_plain(L0, L1, inputs, targets, p_negs, lr,
                              vocab_size=V)
    torch.cuda.synchronize()
    k19_err = max(rel_err(a, b)[1] for a, b in zip(p_got[2:4], p_ref[1:3]))
    k19_loss = abs(float(p_got[4]) - float(p_ref[3])) / abs(float(p_ref[3]))
    k19_rep = all(torch.equal(a, b) for a, b in zip(p_got, p_again))
    check(torch.equal(p_got[0], p_negs) and torch.equal(p_got[1], p_ref[0])
          and not bool((p_negs == targets[:, None]).any()),
          "K19's draws or keys differ from its plain version, or a target "
          "was drawn")
    check(k19_err <= TOL_W2V and k19_loss <= TOL_W2V and k19_rep
          and float(p_got[5]) == float(p_ref[4]) == B,
          f"K19: rows {k19_err:.3g} from the plain version, loss "
          f"{k19_loss:.3g}, count {float(p_got[5])}, repeatable {k19_rep}")
    # ---- times, bounds, library calls
    valid = int((wc < V).sum())
    u0 = distinct_rows(torch, wc, R=V)
    u1 = distinct_rows(torch, wc, negs, R=V)
    pairs = float(got[4])
    bms, by = bound_ms(9 * T + 4 * NB * K + 4 * d * (u0 + u1)
                       + 4 * d * (2 * T + NB * K),
                       pairs * 2 * d * (3 + 3 * K))

    def fn21():
        return W.stream_chunk_deltas(L0, L1, wc, sc, hc, negs, **kw)

    k21 = dict(route="cuda", source="buffalo_tpu_torch/csrc/w2v_stream_chunk.cu",
               replaces="buffalo_tpu/ops/w2v_kernels.py:236",
               max_abs_err=max(float((a - b).abs().max())
                               for a, b in zip(got[:3], ref[:3])),
               staged_tile=W.stream_staged_tile(d, K, window, block),
               ms=time_ms(fn21), device_ms=trace_ms(fn21, "chunk_deltas"),
               plain_ms=time_ms(lambda: W.stream_chunk_deltas_plain(
                   L0, L1, wc, sc, hc, negs, **kw), reps=5, warmup=1),
               bound_ms=bms, bound_by=by, library_ms=None,
               library="none: no call expands skip-gram windows with "
               "block-shared negatives",
               rel_err=k21_err, loss_rel_err=k21_loss,
               window_minus_1_rel_err=short_err, positions=T,
               real_tokens=valid, pair_terms=pairs, k8_bitwise=True)
    n20 = T + NB * K
    t20 = distinct_rows(torch, wc, negs, R=V)
    bms, by = bound_ms(4 * n20 + 4 * d * n20 + 8 * d * t20, 2 * d * n20)
    keys_all = torch.cat([wc, negs.reshape(-1)])
    rows_all = torch.cat([dL1p, dLn.reshape(-1, d)])
    keep = keys_all < V
    keys_l, rows_l = keys_all[keep].long(), rows_all[keep]

    def library():
        D = torch.zeros_like(L1).index_add_(0, keys_l, rows_l, alpha=lr)
        n = (D * D).sum(1, keepdim=True).sqrt()
        return outs[3].add_(D * torch.clamp(cap / n.clamp(min=1e-20),
                                            max=1.0))

    def fn20():
        W.row_apply(outs[1], parts, scale=lr, cap=cap)

    dev20, ops20 = trace_stats(fn20, "apply_pieces")
    k20 = dict(route="cuda", source="buffalo_tpu_torch/csrc/w2v_row_apply.cu",
               replaces="buffalo_tpu/ops/w2v_kernels.py:34",
               max_abs_err=k20_err, ms=time_ms(fn20), device_ms=dev20,
               stream_ops_per_call=ops20,
               plain_ms=time_ms(lambda: W.row_apply_plain(
                   outs[2], parts, scale=lr, cap=cap), reps=5, warmup=1),
               bound_ms=bms, bound_by=by, library_ms=time_ms(library),
               library="index_add_ of the rows + the norm clip",
               rel_err=k20_err / scale, cap_off_err=off_err,
               entries=n20, touched_rows=t20, rows_past_cap=binding)
    bms, by = bound_ms(*k19_work(torch, inputs, targets, p_negs, V, d, K))

    def fn19():
        return W.pair_step(L0, L1, inputs, targets, lr, **pkw)

    k19 = dict(route="cuda", source="buffalo_tpu_torch/csrc/w2v_pair_step.cu",
               replaces="buffalo_tpu/ops/w2v_kernels.py:477",
               max_abs_err=max(float((a - b).abs().max())
                               for a, b in zip(p_got[2:4], p_ref[1:3])),
               ms=time_ms(fn19), device_ms=trace_ms(fn19, "pair_step"),
               plain_ms=time_ms(lambda: W.pair_step_plain(
                   L0, L1, inputs, targets, W.w2v_negatives(
                       targets, V, num_negatives=K, seed=0, epoch=0, chunk=0,
                       alias=alias), lr, vocab_size=V), reps=5, warmup=1),
               bound_ms=bms, bound_by=by, library_ms=None,
               library="none: no call draws the redrawn negatives and forms "
               "the SGNS rows",
               rel_err=k19_err, loss_rel_err=k19_loss, pairs=B,
               k8_draws_bitwise=True)
    phase("w2v_kernels", d=d, chunk_index=0, k19=k19, k20=k20, k21=k21,
          tol=TOL_W2V)
    del L0, L1, outs, got, again, ref, short, p_got, p_again, p_ref, dT
    torch.cuda.empty_cache()
    return {"pair_step": k19, "row_apply": k20, "stream_chunk_deltas": k21}


def w2v_variants(bt, W, S, torch, data, device_first_loss=None):
    """One epoch each (num_iters 1, the same start) of the device path and
    the host-pair path, resident (262,144-pair chunks) and streamed
    (``resident_mb`` 0): seconds, host pair-generation seconds, bytes to
    the card, the device loss below W2V_DEVICE_BAND x each host loss (the
    JAX package's band), the two host runs (the same pairs and draws, the
    rate in float32 per group or float64 per chunk) within
    TOL_W2V_STREAMED.  The resident host run is profiled and its K19
    calls kept: K19's device launches, busy ms (CUPTI) and the sum of its
    calls' bounds over that epoch.  Returns the host path's launches (K19
    per pair chunk, two K20) and those K19 figures."""
    runs, launches, k19_epoch = {}, None, None
    kernels = W.KERNELS + (S.sample_negatives,)
    for name, kw in (("device", {}), ("host", dict(pair_gen="host")),
                     ("host_streamed", dict(pair_gen="host",
                                            resident_mb=0))):
        model = w2v_model(bt, data, w2v_opt(bt, num_iters=1, **kw))
        torch.cuda.synchronize()
        reset_counts(kernels)
        if name == "host":
            W.pair_step.device_launches = 0
            # each call's pairs and negatives (not its delta rows)
            with EveryCall(torch, (W.pair_step,),
                           lambda a, k, out: (a[2], a[3], out[0])) as k19:
                prof = profile_call(torch, model.train, top=64)
        else:
            model.train()
        got = read_counts(kernels)
        s = model.epoch_stats[0]
        if name == "host":
            launches = got
            want = dict(pair_step=s["chunks"], row_apply=2 * s["chunks"],
                        stream_chunk_deltas=0, sample_negatives=0)
            check(got == want, f"host-pair epoch launched {got}, expected "
                  f"{want}")
            V, K = int(model._vocab.size), int(model.opt.num_negative_samples)
            nbytes = flops = 0
            for inputs, targets, negs in k19.calls["pair_step"]:
                nb, fl = k19_work(torch, inputs, targets, negs, V, W2V_D, K)
                nbytes += nb
                flops += fl
            k19_epoch = dict(
                device_launches_per_epoch=W.pair_step.device_launches,
                epoch_device_ms=sum(
                    v for k, v in prof["device_ms_by_name"].items()
                    if k.startswith("pair_step") or k.startswith("sum_parts")),
                epoch_bound_ms=bound_ms(nbytes, flops)[0])
            del k19
        runs[name] = dict(loss=model.iteration_losses[0],
                          epoch_seconds=model.iteration_times[0],
                          host_seconds=s["host_seconds"],
                          h2d_bytes=s["h2d_bytes"], pairs=s["pairs"],
                          chunks=s["chunks"], chunk=s["chunk"],
                          launches=got)
        del model
        torch.cuda.empty_cache()
    dl = runs["device"]["loss"]
    for name in ("host", "host_streamed"):
        check(dl < W2V_DEVICE_BAND * runs[name]["loss"],
              f"device loss {dl:.5f} not below {W2V_DEVICE_BAND} x the "
              f"{name} loss {runs[name]['loss']:.5f}")
    gap = abs(runs["host"]["loss"] - runs["host_streamed"]["loss"]) \
        / runs["host"]["loss"]
    check(gap <= TOL_W2V_STREAMED, f"streamed host epoch {gap:.3g} from the "
          f"resident one")
    phase("w2v_variants", d=W2V_D, band=W2V_DEVICE_BAND,
          streamed_rel_gap=gap, host_k19=k19_epoch, **runs)
    return launches, k19_epoch


def w2v_quality(bt, W, torch):
    """The JAX package's quality gate on the card
    (``tests/models/test_w2v_cfr.py:485-516``): the clustered corpus, d =
    16, 20 epochs, window 4, lr 0.05, min_count 2, the port's own draws;
    cluster purity of the top-5 neighbours > 0.5 on the host and the device
    path (neg_block 16) and the device loss below W2V_DEVICE_BAND x the
    host loss."""
    rng = np.random.default_rng(3)
    cl = rng.integers(0, 5, 60)
    lines = [" ".join(f"w{int(x)}" for x in rng.choice(
        np.nonzero(cl == rng.integers(0, 5))[0], size=10))
        for _ in range(300)]
    path = os.path.join(WORK, "clustered.txt")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    sopt = bt.StreamOptions().get_default_option()
    sopt.input.main = path
    sopt.data.path = os.path.join(WORK, "clustered.bfo")
    sopt.data.tmp_dir = os.path.join(WORK, "tmp")
    sopt.data.validation = {}
    data = bt.data.load(sopt)
    data.create()
    out = {}
    for pg in ("host", "device"):
        opt = bt.W2VOption().get_default_option()
        opt.update(d=16, num_iters=20, min_count=2, window=4, lr=0.05,
                   pair_gen=pg, neg_block=16, device="cuda")
        np.random.seed(5)
        m = bt.W2V(opt, data=data)
        m.initialize()
        loss = m.train()["train_loss"]
        hits = total = 0
        for w in ("w0", "w1", "w2"):
            for key, _ in m.most_similar(w, topk=5):
                total += 1
                hits += int(cl[int(key[1:])] == cl[int(w[1:])])
        out[pg] = dict(loss=loss, purity=hits / max(total, 1))
        check(total > 0 and hits / total > 0.5,
              f"W2V {pg} purity {hits}/{total} on the clustered corpus")
    check(out["device"]["loss"] < W2V_DEVICE_BAND * out["host"]["loss"],
          f"clustered corpus: device loss not below {W2V_DEVICE_BAND} x "
          f"host: {out}")
    phase("w2v_quality", **out)


def mesh_opt(n, **kw):
    """The options of a mesh of ``n`` shards on the one card."""
    return dict(num_devices=n, devices=["cuda:0"] * n, **kw)


def frob_rel(a, b):
    return float(np.linalg.norm(a.astype(np.float64) - b)
                 / np.linalg.norm(b.astype(np.float64)))


def layouts_rule(run, base, what, epoch=-1):
    """Epoch ``epoch`` of ``run`` held to ``base``'s by the layouts rule:
    factors within TOL_LAYOUT_X (relative Frobenius norm), the loss within
    TOL_LAYOUT_LOSS relative.  Returns the readings."""
    (P, Q), (bP, bQ) = run["tables"][epoch], base["tables"][epoch]
    loss, bloss = run["losses"][epoch], base["losses"][epoch]
    fields = dict(P_rel=frob_rel(P, bP), Q_rel=frob_rel(Q, bQ), loss=loss,
                  base_loss=bloss, loss_rel=abs(loss / bloss - 1))
    check(fields["P_rel"] <= TOL_LAYOUT_X and fields["Q_rel"] <= TOL_LAYOUT_X
          and fields["loss_rel"] <= TOL_LAYOUT_LOSS,
          f"{what} differs from the single-device range epoch: {fields}")
    return fields


def witness_rule(run, family, witness, what):
    """Every epoch of ``run`` (float32) held to the float64 witness, the
    single-device run from the same start through the plain versions on
    the CPU: each table within NOISE_FACTOR times the noise scale, the
    largest distance from the witness (relative Frobenius norm) among
    ``family``, the single-device float32 runs that differ from one
    another only in the order of their sums (ROADMAP's float64-witness
    rule; three CG steps amplify any such order on a few ill-conditioned
    rows from epoch to epoch, and a more accurate sum is not nearer the
    witness: PERF.md, PR 10).  Returns the readings per epoch, with the
    share of the distance on the 8 furthest rows of the run and of the
    single device."""
    def top_share(x, w, n=8):
        """The share of ``x``'s distance from ``w`` on its n furthest rows."""
        rows = np.sort(np.linalg.norm(x.astype(np.float64) - w, axis=1))
        return float(np.linalg.norm(rows[-n:]) / np.linalg.norm(rows))

    out = []
    for e, wtables in enumerate(witness["tables"]):
        r = {}
        for i, (t, w) in enumerate(zip("PQ", wtables)):
            dist = {name: frob_rel(f["tables"][e][i], w)
                    for name, f in family.items()}
            r[t] = dict(run=frob_rel(run["tables"][e][i], w),
                        scale=max(dist.values()), **dist,
                        run_top8_share=top_share(run["tables"][e][i], w),
                        single_top8_share=top_share(
                            family["single"]["tables"][e][i], w))
        check(all(v["run"] <= NOISE_FACTOR * v["scale"] for v in r.values()),
              f"{what}, epoch {e + 1}: further from the float64 witness "
              f"than {NOISE_FACTOR} x the single-device noise scale: {r}")
        out.append(r)
    return out


def mesh_train(bt, K, torch, data, opt, start):
    """A model of ``opt`` from the factors ``start`` trained with the
    kernels' and the collectives' counts set to 0 just before, validation
    on (a loss per epoch), each epoch's host tables kept: (run dict,
    launches, collective calls)."""
    par = bt.parallelism
    opt.update(validation={"topk": TOPK})
    als = bt.ALS(opt, data=data)
    np.random.seed(0)
    als.initialize()
    als.P, als.Q = start[0].copy(), start[1].copy()
    losses, tables = [], []

    def keep(i, m):
        losses.append(m["train_loss"])
        tables.append((als.P.copy(), als.Q.copy()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(K.KERNELS)
    par.reset_counts()
    als.train(training_callback=keep)
    check(als._mesh_range is None, "the mesh layout outlived train()")
    check(len(losses) == int(opt.num_iters) and np.isfinite(losses).all(),
          f"losses {losses}")
    run = dict(losses=losses, tables=tables,
               epoch_seconds=als.iteration_times,
               max_memory_allocated_mb=torch.cuda.max_memory_allocated()
               / 2 ** 20)
    calls = dict(all_gather_rows=par.all_gather_rows.calls,
                 all_reduce_sum=par.all_reduce_sum.calls,
                 dist_all_gather=par.all_gather_rows.dist_calls,
                 dist_all_reduce=par.all_reduce_sum.dist_calls)
    launches = read_counts(K.KERNELS)
    del als
    return run, launches, calls


def mesh_als(bt, K, torch, data, start):
    """ALS d = D over MESH_SHARDS shards on the one card, from the trained
    factors ``start``.  MESH_EPOCHS epochs of "dp+tp" (the per-shard range
    layout) against the single-device range layout: the first epoch by the
    layouts rule, every epoch's loss within TOL_LAYOUT_LOSS, and every
    epoch's factors by ``witness_rule`` against the float64 single-device
    run on the CPU (the plain versions) from the same start, the noise
    scale taken from three single-device float32 runs (the range layout,
    the same with float64-summed gramians, the scatter layout); ``llt``
    (exact solves, nothing for CG to amplify) by the layouts rule after
    every epoch.  The single-device scatter layout's distance from the
    range layout is printed beside the mesh's.  Then one epoch each of
    "dp", "tp" with ``range_layout=False`` and the streamed mesh path
    (resident_mb STREAM_RESIDENT_MB) against one single-device epoch.
    Returns the "dp+tp" run and the witness rule's runs (for
    mesh_nccl)."""
    narrow = (K.als_cg_matrix_free, K.als_normal_equations,
              K.batched_cg_dense)
    mesh_kw = mesh_opt(MESH_SHARDS, sharding="dp+tp")
    base, _, _ = mesh_train(bt, K, torch, data, als_opt(
        bt, d=D, num_iters=MESH_EPOCHS), start)
    st = time.perf_counter()
    witness, _, _ = mesh_train(bt, K, torch, data, als_opt(
        bt, d=D, num_iters=MESH_EPOCHS, device="cpu"),
        tuple(t.astype(np.float64) for t in start))
    witness_s = time.perf_counter() - st
    check(witness["tables"][0][0].dtype == np.float64,
          f"the witness ran in {witness['tables'][0][0].dtype}")
    scatter, _, _ = mesh_train(bt, K, torch, data, als_opt(
        bt, d=D, num_iters=MESH_EPOCHS, range_layout=False), start)
    # the single device with its gramians summed in float64 (cuBLAS's
    # DGEMM, rounded once): the same epochs, a more accurate sum
    gramian = K.gramian
    K.gramian = lambda X: torch.matmul(X.double().T, X.double()).float()
    try:
        gram64, _, _ = mesh_train(bt, K, torch, data, als_opt(
            bt, d=D, num_iters=MESH_EPOCHS), start)
    finally:
        K.gramian = gramian
    family = dict(single=base, single_gramian_f64=gram64, scatter=scatter)
    run, launches, calls = mesh_train(bt, K, torch, data, als_opt(
        bt, d=D, num_iters=MESH_EPOCHS, **mesh_kw), start)
    first = layouts_rule(run, base, "the dp+tp mesh's first epoch", 0)
    loss_rel = [abs(a / b - 1) for a, b in zip(run["losses"],
                                                base["losses"])]
    check(max(loss_rel) <= TOL_LAYOUT_LOSS,
          f"the dp+tp mesh's losses differ: {loss_rel}")
    vs_witness = witness_rule(run, family, witness, "the dp+tp mesh")
    readings = [dict(mesh=[frob_rel(x, y) for x, y in zip(m, b)],
                     scatter=[frob_rel(x, y) for x, y in zip(s, b)])
                for m, s, b in zip(run["tables"], scatter["tables"],
                                   base["tables"])]
    check(all(launches[k.__name__] > 0 for k in narrow),
          f"a kernel of the mesh path never launched: {launches}")
    # per half: the gramian's all-reduce and the fixed side's all-gather
    # (and the segments' table); per epoch the loss's all-reduce
    check(calls["all_reduce_sum"] == 3 * MESH_EPOCHS
          and calls["all_gather_rows"] >= 2 * MESH_EPOCHS,
          f"collective calls {calls}")
    llt = {}
    for name, extra in (("single", {}), ("mesh", mesh_kw)):
        llt[name], _, _ = mesh_train(bt, K, torch, data, als_opt(
            bt, d=D, num_iters=MESH_EPOCHS, optimizer="llt", **extra), start)
    llt_fields = [layouts_rule(llt["mesh"], llt["single"],
                               f"the llt dp+tp mesh's epoch {i + 1}", i)
                  for i in range(MESH_EPOCHS)]
    phase("mesh_als", d=D, shards=MESH_SHARDS, devices="cuda:0 (shared)",
          sharding="dp+tp", epochs=MESH_EPOCHS, first_epoch=first,
          loss_rel=loss_rel, factors_rel_per_epoch_PQ=readings,
          vs_float64_witness=vs_witness, witness_cpu_seconds=witness_s,
          witness_losses=witness["losses"],
          llt=llt_fields, losses=run["losses"],
          single_losses=base["losses"], epoch_seconds=run["epoch_seconds"],
          single_epoch_seconds=base["epoch_seconds"],
          llt_epoch_seconds=llt["mesh"]["epoch_seconds"],
          llt_single_epoch_seconds=llt["single"]["epoch_seconds"],
          launches=launches,
          launches_per_shard_epoch={
              k: v / (MESH_SHARDS * MESH_EPOCHS) for k, v in launches.items()},
          collectives=calls,
          max_memory_allocated_mb=run["max_memory_allocated_mb"],
          tol_factors=TOL_LAYOUT_X, tol_loss=TOL_LAYOUT_LOSS,
          noise_factor=NOISE_FACTOR)
    one, _, _ = mesh_train(bt, K, torch, data,
                           als_opt(bt, d=D, num_iters=1), start)
    data_opt = data.opt.data
    had, saved = "batch_mb" in data_opt, data_opt.get("batch_mb")
    out = {}
    try:
        for name, extra in (("dp", dict(sharding="dp")),
                            ("tp_scatter", dict(sharding="dp+tp",
                                                range_layout=False)),
                            ("streamed", dict(
                                sharding="dp+tp",
                                resident_mb=STREAM_RESIDENT_MB))):
            if name == "streamed":
                data_opt["batch_mb"] = STREAM_BATCH_MB
            r, ln, cl = mesh_train(bt, K, torch, data, als_opt(
                bt, d=D, num_iters=1, **mesh_opt(MESH_SHARDS, **extra)),
                start)
            check(all(ln[k.__name__] > 0 for k in narrow),
                  f"a kernel of the {name} mesh path never launched: {ln}")
            out[name] = dict(layouts_rule(r, one, f"the {name} mesh epoch"),
                             epoch_seconds=r["epoch_seconds"][0],
                             launches=ln, collectives=cl)
    finally:
        if had:
            data_opt["batch_mb"] = saved
        else:
            data_opt.pop("batch_mb", None)
    phase("mesh_als_modes", d=D, shards=MESH_SHARDS, epochs=1,
          single_epoch_seconds=one["epoch_seconds"][0], **out,
          tol_factors=TOL_LAYOUT_X, tol_loss=TOL_LAYOUT_LOSS)
    return run, dict(family=family, witness=witness)


def mesh_nccl(bt, K, torch, data, start, mesh_run, refs):
    """The "dp+tp" epochs of mesh_als inside a 1-rank NCCL process group
    (a TCP store on a free local port) with NCCL_SHARDS local shards: the
    collectives go through torch.distributed on NCCL, and the result is
    held as mesh_als's: the first epoch by the layouts rule to mesh_als's
    run, every loss within TOL_LAYOUT_LOSS of it, and every epoch's
    factors by ``witness_rule`` against ``refs`` (mesh_als's witness and
    single-device float32 runs).  The group is destroyed after."""
    import socket

    par = bt.parallelism
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    world = par.initialize_distributed(f"127.0.0.1:{port}", 1, 0,
                                       backend="nccl")
    try:
        mesh = par.get_mesh(NCCL_SHARDS, devices=["cuda:0"] * NCCL_SHARDS)
        check(world == 1 and mesh.backend == "nccl" and mesh.group
              is not None, f"process group: world {world}, {mesh}")
        run, launches, calls = mesh_train(
            bt, K, torch, data, als_opt(bt, d=D, num_iters=MESH_EPOCHS,
                                        **mesh_opt(NCCL_SHARDS,
                                                   sharding="dp+tp")), start)
        backend = mesh.backend
    finally:
        par.shutdown_distributed()
    check(calls["dist_all_reduce"] == calls["all_reduce_sum"] > 0
          and calls["dist_all_gather"] == calls["all_gather_rows"] > 0,
          f"collectives did not all go through torch.distributed: {calls}")
    # the mesh_als rule: the first epoch's factors, every epoch's loss
    fields = layouts_rule(run, mesh_run, "the NCCL mesh's first epoch", 0)
    loss_rel = [abs(a / b - 1) for a, b in zip(run["losses"],
                                                mesh_run["losses"])]
    check(max(loss_rel) <= TOL_LAYOUT_LOSS,
          f"the NCCL mesh's losses differ: {loss_rel}")
    vs_witness = witness_rule(run, refs["family"], refs["witness"],
                              "the NCCL mesh")
    (P, Q), (mP, mQ) = run["tables"][-1], mesh_run["tables"][-1]
    last = dict(P_rel=frob_rel(P, mP), Q_rel=frob_rel(Q, mQ))
    phase("mesh_nccl", d=D, world_size=world, backend=backend,
          local_shards=NCCL_SHARDS, epochs=MESH_EPOCHS, first_epoch=fields,
          loss_rel=loss_rel, last_epoch_vs_mesh_als=last,
          vs_float64_witness=vs_witness, noise_factor=NOISE_FACTOR,
          losses=run["losses"], epoch_seconds=run["epoch_seconds"],
          launches=launches, collectives=calls,
          tol_factors=TOL_LAYOUT_X, tol_loss=TOL_LAYOUT_LOSS)


def mesh_eals(bt, E, torch, data):
    """eALS d = D over MESH_SHARDS shards, MESH_EPOCHS epochs from seed 0,
    against the single-device range epochs; the noise scale is the
    single-device range-vs-rows (``range_layout=False``) distance."""
    par = bt.parallelism
    runs = {}
    for name, extra in (("single", {}), ("rows", dict(range_layout=False)),
                        ("mesh", mesh_opt(MESH_SHARDS))):
        model = bt.EALS(eals_opt(bt, num_iters=MESH_EPOCHS, validation={},
                                 **extra), data=data)
        np.random.seed(0)
        model.initialize()
        reset_counts(E.KERNELS)
        par.reset_counts()
        kept = {}
        if name == "mesh":  # the state train() builds, for K14 after it
            build = model._train_state
            model._train_state = lambda: kept.setdefault("st", build())
        model.train()
        if name == "mesh":
            k14 = k14_gathered(bt, E, torch, model, kept["st"])
        runs[name] = dict(P=model.P, Q=model.Q,
                          losses=model.iteration_losses,
                          epoch_seconds=model.iteration_times,
                          launches=read_counts(E.KERNELS),
                          collectives=dict(
                              all_gather_rows=par.all_gather_rows.calls,
                              all_reduce_sum=par.all_reduce_sum.calls))
        del model
    mesh, single, rows = runs["mesh"], runs["single"], runs["rows"]
    diff = {t: float(np.abs(mesh[t] - single[t]).max()) for t in "PQ"}
    noise = {t: float(np.abs(rows[t] - single[t]).max()) for t in "PQ"}
    loss_rel = abs(mesh["losses"][-1] / single["losses"][-1] - 1)
    q_close = bool(np.allclose(mesh["Q"], single["Q"], rtol=TOL_PLSI_X,
                               atol=TOL_PLSI_ABS))
    check(all(diff[t] <= NOISE_FACTOR * noise[t] for t in "PQ")
          and loss_rel <= TOL_EALS_SUM,
          f"the eALS mesh differs from one device: {diff} (noise {noise}), "
          f"RMSE {loss_rel:.3g}")
    check(all(v > 0 for v in mesh["launches"].values()),
          f"an eALS kernel never launched on the mesh: {mesh['launches']}")
    phase("mesh_eals", d=D, shards=MESH_SHARDS, epochs=MESH_EPOCHS,
          max_abs_diff=diff, range_vs_rows=noise, rmse_rel=loss_rel,
          Q_within_1e4_1e6=q_close, losses=mesh["losses"],
          single_losses=single["losses"],
          epoch_seconds=mesh["epoch_seconds"],
          single_epoch_seconds=single["epoch_seconds"],
          launches=mesh["launches"], collectives=mesh["collectives"],
          noise_factor=NOISE_FACTOR, tol_rmse=TOL_EALS_SUM,
          k14_gathered=k14)


def k14_gathered(bt, E, torch, model, st):
    """K14 as the eALS mesh's loss runs it (``st``: the mesh's training
    state), on the tables gathered to the first shard's device
    (``k14_entry``)."""
    from buffalo_tpu_torch.data.batching import permute_table

    par = bt.parallelism
    dev0 = st["mesh"].devices[0]
    P, Q = (torch.from_numpy(permute_table(t, st[f"{a}_pos"],
                                           st[f"{a}_pad"])).to(dev0)
            for t, a in ((model.P, "u"), (model.Q, "i")))
    C = par.all_gather_rows(st["mesh"], st["C"], first_only=True)
    out = k14_entry(E, torch, P, Q, *st["u"], C, float(model.opt.alpha),
                    "the mesh's gathered tables", timed=False)
    del P, Q, C
    return out


def k16_halves_check(PK, torch, sums_in, apply_in):
    """K16's two halves on the first shard's inputs as the mesh epoch gave
    them (recorded before each launch), against their plain versions on
    copies of the same inputs: P, the column sums and Q within TOL_K16
    relative.  Returns the relative errors."""
    def rel(a, b):
        return float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())

    (Pn, Qn), kw = sums_in
    got, ref = [Pn.clone(), Qn.clone()], [Pn.clone(), Qn.clone()]
    s_got = PK.plsi_mstep_sums(*got, **kw)
    s_ref = PK.mstep_sums_plain(*ref, **kw)
    (Qa, colsum), kw_a = apply_in
    q_got, q_ref = Qa.clone(), Qa.clone()
    PK.plsi_mstep_apply(q_got, colsum, **kw_a)
    PK.mstep_apply_plain(q_ref, colsum, **kw_a)
    torch.cuda.synchronize()
    errs = dict(P=rel(got[0], ref[0]), colsum=rel(s_got, s_ref),
                Q=rel(q_got, q_ref))
    check(max(errs.values()) <= TOL_K16 and torch.equal(got[1], Qn),
          f"K16's halves on a mesh shard differ from the plain versions: "
          f"{errs}")
    return dict(errs, P_shard=list(Pn.shape), Q_shard=list(Qn.shape))


def mesh_plsi(bt, PK, torch, data):
    """pLSI d = 20 over MESH_SHARDS shards, MESH_EPOCHS epochs from seed 0,
    against the single-device range epochs (tables TOL_PLSI_X /
    TOL_PLSI_ABS, losses TOL_PLSI_LOSS).  The first shard's inputs to
    K16's two halves in the first epoch are kept, and each half is then
    held to its plain version on them (``k16_halves_check``)."""
    runs = {}
    kept = {}
    real = {name: getattr(PK, name)
            for name in ("plsi_mstep_sums", "plsi_mstep_apply")}

    def keeping(name):
        def call(*args, **kw):
            if name not in kept:
                kept[name] = ([a.clone() for a in args], dict(kw))
            return real[name](*args, **kw)
        return call
    for name, extra in (("single", {}), ("mesh", mesh_opt(MESH_SHARDS))):
        model = plsi_model(bt, data, plsi_opt(bt, num_iters=MESH_EPOCHS,
                                              validation={}, **extra))
        reset_counts(PK.KERNELS)
        for fn in real:
            setattr(PK, fn, keeping(fn))
        try:
            model.train()
        finally:
            for fn, f in real.items():
                setattr(PK, fn, f)
        runs[name] = dict(P=model.P, Q=model.Q,
                          losses=model.iteration_losses,
                          epoch_seconds=model.iteration_times,
                          launches=read_counts(PK.KERNELS))
        del model
    mesh, single = runs["mesh"], runs["single"]
    ok = all(np.allclose(mesh[t], single[t], rtol=TOL_PLSI_X,
                         atol=TOL_PLSI_ABS) for t in "PQ")
    loss_rel = max(abs(a / b - 1) for a, b in zip(mesh["losses"],
                                                  single["losses"]))
    diff = {t: float(np.abs(mesh[t] - single[t]).max()) for t in "PQ"}
    check(ok and loss_rel <= TOL_PLSI_LOSS,
          f"the pLSI mesh differs from one device: {diff}, loss {loss_rel}")
    # K16 runs as two launches per shard (the sharded halves)
    check(mesh["launches"]["plsi_mstep"] == 2 * MESH_SHARDS * MESH_EPOCHS
          and mesh["launches"]["plsi_estep"] > 0,
          f"pLSI mesh launches {mesh['launches']}")
    check(set(kept) == set(real), f"K16's halves never ran: {list(kept)}")
    halves = k16_halves_check(PK, torch, kept["plsi_mstep_sums"],
                              kept["plsi_mstep_apply"])
    phase("mesh_plsi", d=int(plsi_opt(bt).d), shards=MESH_SHARDS,
          epochs=MESH_EPOCHS, max_abs_diff=diff, loss_rel=loss_rel,
          losses=mesh["losses"], single_losses=single["losses"],
          epoch_seconds=mesh["epoch_seconds"],
          single_epoch_seconds=single["epoch_seconds"],
          launches=mesh["launches"], k16_halves_rel_err=halves,
          tol=[TOL_PLSI_X, TOL_PLSI_ABS], tol_loss=TOL_PLSI_LOSS,
          tol_k16=TOL_K16)


def same_topk(got, ref, what):
    """(ids, scores) of a sharded call against the unsharded call's: scores
    within TOL_SCORE, ids equal off ties.  Returns (max score error, ids
    differing at ties)."""
    (gi, gs), (ri, rs) = got, ref
    close = np.isclose(gs, rs, rtol=TOL_SCORE, atol=TOL_SCORE_ABS)
    check(bool(close.all()), f"{what}: scores differ by up to "
          f"{float(np.abs(gs - rs).max()):.3g}")
    check(bool(((gi == ri) | close).all()), f"{what}: ids differ off ties")
    return float(np.abs(gs - rs).max()), int((gi != ri).sum())


def k22_bytes(torch, out_idx, D, kl, S):
    """The bytes K22 must move for this run's data, and the candidates it
    must read.  A query's merge reads, of each shard's list, the entries
    it took (c_j, counted from the output ids: shard j holds ids [j S,
    (j + 1) S)) and the head that stopped it, min(c_j + 1, kl), but not
    the head after the last output's: at most k + D - 1 per query.  Each
    list's reads are charged in whole 32-byte sectors of the score and of
    the index arrays ((B, D, kl), contiguous); the (B, k) scores and ids
    are written once."""
    B, k = out_idx.shape
    shard = out_idx.long() // S
    c = torch.zeros((B, D), dtype=torch.int64, device=out_idx.device)
    c.scatter_add_(1, shard, torch.ones_like(shard))
    n = torch.minimum(c + 1, torch.full_like(c, kl))
    n.scatter_(1, shard[:, -1:], c.gather(1, shard[:, -1:]))
    start = 4 * kl * torch.arange(B * D, device=out_idx.device).view(B, D)
    sectors = torch.where(n > 0, (start + 4 * n - 1) // 32 - start // 32 + 1,
                          torch.zeros_like(n))
    return 2 * 32 * int(sectors.sum()) + 8 * B * k, int(n.sum())


def merge_lists(R, torch, B, D, kl, seed=0):
    """(vals, idx) (B, D, kl) on the card as K22 takes them: random scores,
    each list sorted by the plain version's keys (score descending, ties
    to the smaller index), shard j's indices in [j S, (j + 1) S), S = 2
    kl."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    S = 2 * kl
    vals = torch.randn(B, D, kl, generator=g, device="cuda")
    idx = (torch.argsort(torch.rand(B, D, S, generator=g, device="cuda"),
                         dim=-1)[..., :kl]
           + S * torch.arange(D, device="cuda")[None, :, None]).int()
    keys = torch.sort(R._keys(vals, idx), dim=-1, descending=True).values
    v, i = R._decode(keys)
    return v.contiguous(), i.contiguous()


def k22_same(R, torch, vals, idx, k, what):
    """K22 in the form its rule takes and in each form, bit for bit its
    plain version's; returns the rule's form."""
    ref = R.sharded_topk_merge_plain(vals, idx, k)
    for form in (None,) + R.MERGE_FORMS:
        got = R.sharded_topk_merge(vals, idx, k, form=form)
        check(torch.equal(got[1], ref[1]) and torch.equal(
            got[0].view(torch.int32), ref[0].view(torch.int32)),
            f"K22 ({form or 'its rule'}) differs from its plain version "
            f"({what})")
    return R.sharded_topk_merge_form(vals.shape[1], vals.shape[2], k)


def sharded_topk(bt, R, torch, trained):
    """batch_topn_sharded over MESH_SHARDS shards on the one card, with
    K22's count set to 0 just before: SHARDED_USERS ML-20M users against
    the trained Q at k = TOPK, the brunch catalog's queries (seed 21, as
    catalog_path) at k = TOPK, and SHARDED_PAST_USERS users at k =
    TOPK_PAST (each shard past K5's limit); each equal to batch_topn.
    Then K22 on the recorded candidates of the brunch call and the k =
    TOPK_PAST call, in both forms and by its rule bit for bit against its
    plain version, with its event and CUPTI times per form, stream
    operations per call, bound, plain and library times; and bit for bit
    on synthetic lists at k = D kl with D odd and at the first k on each
    side of the crossover between the forms.  Returns (K22's kernels-line
    entry, its launches)."""
    import buffalo_tpu_torch.ops.topk as T

    par = bt.parallelism
    mesh = par.get_mesh(MESH_SHARDS, devices=["cuda:0"] * MESH_SHARDS)
    P, Q = trained
    brunch, queries = brunch_tables(np.random.default_rng(21), BRUNCH_ITEMS,
                                    BRUNCH_D, BRUNCH_QUERIES)
    seen = []
    real = T.sharded_topk_merge

    def recording(vals, idx, k):
        seen.append((vals, idx, k))
        return real(vals, idx, k)
    out = {}
    R.sharded_topk_merge.launches = 0
    T.sharded_topk_merge = recording
    try:
        for name, p, table, k in (
                ("ml20m_users", P[:SHARDED_USERS], Q, TOPK),
                ("brunch", queries, brunch, TOPK),
                ("ml20m_past_1024", P[:SHARDED_PAST_USERS], Q, TOPK_PAST)):
            T.batch_topn_sharded(p, table, k, mesh)  # stages the table
            sh_ms, got = wall_ms(
                lambda: T.batch_topn_sharded(p, table, k, mesh))
            T.batch_topn(p, table, k, device="cuda")
            one_ms, ref = wall_ms(
                lambda: T.batch_topn(p, table, k, device="cuda"))
            err, ties = same_topk(got, ref, f"sharded top-k ({name})")
            out[name] = dict(queries=p.shape[0], items=table.shape[0],
                             d=table.shape[1], k=k, host_ms_sharded=sh_ms,
                             host_ms_unsharded=one_ms, max_abs_score_err=err,
                             ids_differing_at_ties=ties)
    finally:
        T.sharded_topk_merge = real
    launches = R.sharded_topk_merge.launches
    check(launches == 6, f"K22 launched {launches} times, expected 6")
    # K22 on the recorded candidates of the brunch call and of the
    # k = TOPK_PAST call (the first of each pair of calls)
    k22 = {}
    for name, (vals, idx, k) in (("brunch", seen[2]),
                                 ("ml20m_past_1024", seen[4])):
        form = k22_same(R, torch, vals, idx, k, name)
        got = R.sharded_topk_merge(vals, idx, k)
        B, Dn, kl = vals.shape
        flat = vals.reshape(B, -1)
        S = -(-out[name]["items"] // Dn)
        nbytes, entries = k22_bytes(torch, got[1], Dn, kl, S)
        bms, by = bound_ms(nbytes, 0)
        per_form = {}
        for f in R.MERGE_FORMS:
            fn = (lambda: R.sharded_topk_merge(vals, idx, k, form=f))
            dev_ms, ops = trace_stats(fn, "merge")
            per_form[f] = dict(ms=time_ms(fn), device_ms=dev_ms,
                               stream_ops_per_call=ops)
        k22[name] = dict(
            B=B, shards=Dn, k_loc=kl, k=k, entries_read=entries,
            bytes=nbytes, form=form, forms=per_form,
            device_ms=per_form[form]["device_ms"],
            stream_ops_per_call=per_form[form]["stream_ops_per_call"],
            ms=time_ms(lambda: R.sharded_topk_merge(vals, idx, k)),
            plain_ms=time_ms(
                lambda: R.sharded_topk_merge_plain(vals, idx, k), reps=5,
                warmup=1),
            library_ms=time_ms(lambda: torch.topk(flat, k, dim=1), reps=5,
                               warmup=1),
            bound_ms=bms, bound_by=by)
    # synthetic lists: every candidate taken (k = D kl) with D odd, and the
    # first k of each form at D = MESH_SHARDS (kl = k) around the crossover
    cross = next(k for k in range(1, 1 << 14)
                 if R.sharded_topk_merge_form(MESH_SHARDS, k, k) == "tree")
    synthetic = {"k_D_kl_odd_D": k22_same(
        R, torch, *merge_lists(R, torch, 257, 3, 700, seed=3), 2100,
        "D = 3, kl = 700, k = 2,100")}
    for k in (cross - 1, cross):
        if k >= 1:
            synthetic[f"k_{k}"] = k22_same(
                R, torch, *merge_lists(R, torch, SHARDED_PAST_USERS,
                                       MESH_SHARDS, k, seed=k), k,
                f"D = {MESH_SHARDS}, kl = k = {k}")
    phase("sharded_topk", shards=MESH_SHARDS, devices="cuda:0 (shared)",
          **out, k22=k22, k22_launches=launches, k22_crossover_k=cross,
          k22_synthetic_forms=synthetic)
    main = k22["brunch"]
    entry = dict(route="cuda",
                 source="buffalo_tpu_torch/csrc/sharded_topk_merge.cu",
                 replaces="buffalo_tpu/ops/topk.py:330", max_abs_err=0.0,
                 **{key: main[key] for key in (
                     "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                     "form", "device_ms", "stream_ops_per_call")})
    return entry, launches


# ------------------------------------------------ the dp mesh: BPR and WARP
def epoch_snapshots(module, name, tables_of, seconds=None):
    """Wrap ``module.name`` (an epoch function) so that each call appends
    the host copies of the tables ``tables_of(args)`` returns after it; the
    list, and a function that puts the original back.  With a ``seconds``
    list, each copy's seconds (after the epoch's work is synchronized) are
    appended to it: the model's epoch time includes them."""
    import torch

    original = getattr(module, name)
    snaps = []

    def wrapped(*args, **kwargs):
        out = original(*args, **kwargs)
        if seconds is not None:
            torch.cuda.synchronize()
            st = time.perf_counter()
        snaps.append([t.cpu().numpy().copy() for t in tables_of(args)])
        if seconds is not None:
            seconds.append(time.perf_counter() - st)
        return out

    setattr(module, name, wrapped)
    return snaps, lambda: setattr(module, name, original)


def mesh_epochs_rule(mesh_tables, one_tables, mesh_losses, one_losses, names,
                     what, loss_atol=0.0):
    """Every epoch of a dp mesh run held to the single device at the same
    batch size (the same draws; only the shards' sums are ordered
    otherwise): each table within TOL_MESH_X (relative Frobenius norm), the
    loss within TOL_MESH_LOSS relative plus ``loss_atol``.  Returns the
    readings per epoch."""
    out = []
    check(len(mesh_tables) == len(one_tables) == len(mesh_losses),
          f"{what}: {len(mesh_tables)} mesh epochs, {len(one_tables)} "
          "single-device epochs")
    for e, (mt, ot) in enumerate(zip(mesh_tables, one_tables)):
        r = {f"{n}_rel": frob_rel(a, b) for n, a, b in zip(names, mt, ot)}
        r.update(loss=mesh_losses[e], base_loss=one_losses[e],
                 loss_diff=abs(mesh_losses[e] - one_losses[e]))
        check(all(r[f"{n}_rel"] <= TOL_MESH_X for n in names)
              and r["loss_diff"] <= TOL_MESH_LOSS * abs(one_losses[e])
              + loss_atol,
              f"{what}, epoch {e + 1}: the mesh parts from one device: {r}")
        out.append(r)
    return out


def mesh_bpr(bt, S, torch, data):
    """BPR-MF's dp mesh (``bpr_epoch`` on a mesh) over MESH_SHARDS shards on this
    card, MESH_EPOCHS epochs each of sgd (the defaults: the item bias, the
    0.1 step cap) and adagrad, every epoch held to one device at the same
    batch size (``mesh_epochs_rule``), launches and epoch times beside one
    device's.  Then, on the first chunk's second shard (a non-zero slot
    offset) of the trained sgd model: K8 bit for bit to its plain version
    and to the single device's slice, K9's delta path (both launches)
    within TOL_BPR_STEP, bitwise repeatable, the users presorted (as the
    epoch calls it) and grouped agreeing within TOL_BPR_STEP, the hot chunk
    (``k9_hot_check``), at most K9_MAX_STREAM_OPS stream operations per
    call; K10's capped add within TOL_K10.  Returns (the kernels line's
    entries of the new entry points, their launches in the sgd mesh
    run)."""
    runs, mesh_launches = {}, None
    batch = None
    for name, extra in (("sgd", {}), ("adagrad", dict(optimizer="adagrad"))):
        res = {}
        for where, more in (("mesh", mesh_opt(MESH_SHARDS)), ("one", {})):
            snaps, restore = epoch_snapshots(
                S, "bpr_epoch", lambda a: a[1][next(iter(a[1]))])
            try:
                opt = bpr_opt(bt, num_iters=MESH_EPOCHS, **extra, **more)
                if batch is not None:
                    opt.batch_size = batch
                model, launches, peak_mb = bpr_train(bt, S, torch, data, opt)
            finally:
                restore()
            if where == "mesh" and batch is None:
                batch = -(-model._batch_size() // MESH_SHARDS) * MESH_SHARDS
            if where == "mesh":
                if name == "sgd":
                    mesh_launches, sgd_model = launches, model
            res[where] = dict(tables=snaps, losses=model.iteration_losses,
                              epoch_seconds=model.iteration_times,
                              launches=launches, max_memory_allocated_mb=peak_mb)
        nchunks = -(-model.num_nnz // batch)
        per = MESH_SHARDS * nchunks * MESH_EPOCHS
        ln = res["mesh"]["launches"]
        if name == "sgd":
            want = dict(sample_negatives=per, chunk_delta=per,
                        chunk_bias_neg_delta=per,
                        capped_add=4 * nchunks * MESH_EPOCHS,
                        triplet_loss=MESH_EPOCHS, chunk_update=0,
                        chunk_accumulate=0, deferred_update=0)
        else:
            want = dict(sample_negatives=per, chunk_accumulate=per,
                        deferred_update=3 * MESH_EPOCHS,
                        triplet_loss=MESH_EPOCHS, chunk_update=0,
                        chunk_delta=0, chunk_bias_neg_delta=0, capped_add=0)
        check(ln == want, f"the {name} BPR mesh launched {ln}, expected {want}")
        runs[name] = dict(
            epochs=mesh_epochs_rule(res["mesh"]["tables"],
                                    res["one"]["tables"],
                                    res["mesh"]["losses"],
                                    res["one"]["losses"], ("P", "Q", "Qb"),
                                    f"BPR {name} mesh"),
            epoch_seconds=res["mesh"]["epoch_seconds"],
            one_device_epoch_seconds=res["one"]["epoch_seconds"],
            launches=ln, launches_per_epoch=per_epoch(ln, MESH_EPOCHS),
            one_device_launches_per_epoch=per_epoch(res["one"]["launches"],
                                                    MESH_EPOCHS),
            max_memory_allocated_mb=res["mesh"]["max_memory_allocated_mb"],
            one_device_max_memory_allocated_mb=res["one"][
                "max_memory_allocated_mb"])

    # ---- the new entry points on one real shard's inputs
    model = sgd_model
    mesh = bt.parallelism.get_mesh(MESH_SHARDS,
                                   devices=["cuda:0"] * MESH_SHARDS)
    dev = mesh.devices[0]
    users_c, items_c, nnz = epoch_chunks(torch, model, batch)
    n_loc = batch // MESH_SHARDS
    g = 1
    users = users_c[0, g * n_loc:(g + 1) * n_loc].contiguous()
    pos = items_c[0, g * n_loc:(g + 1) * n_loc].contiguous()
    group = model.data.get_group("rowwise")
    words, log2 = S.build_bloom(np.asarray(group["indptr"]),
                                np.asarray(group["key"]))
    bloom = torch.from_numpy(words.view(np.int32)).to(dev)
    I = model.Q.shape[0]
    seed = int(model.opt.random_seed)
    kw8 = dict(num_negatives=1, seed=seed, epoch=0, chunk=0, bloom=bloom,
               bloom_log2=log2, slot_offset=g * n_loc)
    neg, _ = S.sample_negatives(users, I, **kw8)
    ref_neg, _ = S.sample_negatives_plain(users, I, **kw8)
    whole, _ = S.sample_negatives(users_c[0].contiguous(), I,
                                  **dict(kw8, slot_offset=0))
    check(torch.equal(neg, ref_neg)
          and torch.equal(neg, whole[g * n_loc:(g + 1) * n_loc]),
          "K8 at a slot offset differs from its plain version or from the "
          "single device's slice")
    nbytes, ops, attempts = k8_work(S, torch, users, bloom, log2, I, seed, 0)
    t_b, t_o = nbytes / PEAK_BYTES_S, ops / PEAK_INT32_S
    k8 = dict(ms=time_ms(lambda: S.sample_negatives(users, I, **kw8)),
              plain_ms=time_ms(lambda: S.sample_negatives_plain(users, I,
                                                                **kw8),
                               reps=5, warmup=1),
              bound_ms=1e3 * max(t_b, t_o),
              bound_by="bytes" if t_b >= t_o else "operations",
              slots=n_loc, slot_offset=g * n_loc, attempts=attempts)

    P0 = torch.from_numpy(model.P).to(dev)
    Q0 = torch.from_numpy(model.Q).to(dev)
    Qb0 = torch.from_numpy(model.Qb).to(dev)
    o = model.opt
    cap = float(o.max_step_norm)
    lr = S.sgd_lr(o.lr, o.min_lr, 0, nnz, 0, batch, float(nnz) * o.num_iters)
    kw9 = dict(lr=lr, reg_u=o.reg_u, reg_i=o.reg_i, reg_j=o.reg_j,
               reg_b=o.reg_b, num_negatives=1, use_bias=True, update_i=True,
               update_j=True, users_sorted=True)
    # the first chunk of an epoch from the trained tables, as the mesh
    # epoch runs it: every shard's K8 at its offset and K9's delta into its
    # own dense deltas, the positive side's bias delta all-reduced and added
    # by K10 with the cap, then the negative side's (K9's second launch)
    # from that Qb, then P's and Q's reduced deltas capped and added
    shards = []
    for k in range(MESH_SHARDS):
        off, nv = S.shard_slots(mesh, k, n_loc, nnz, 0, batch)
        us = users_c[0, off:off + n_loc].contiguous()
        ps = items_c[0, off:off + n_loc].contiguous()
        ng, _ = S.sample_negatives(us, I, **dict(kw8, slot_offset=off))
        dl = [torch.zeros_like(t) for t in (P0, Q0, Qb0)]
        h = S.chunk_delta(P0, Q0, Qb0, *dl, us, ps, ng,
                          **dict(kw9, n_valid=nv))
        shards.append((us, ps, ng, nv, dl, h))
    check(torch.equal(shards[g][2], neg), "the epoch's shard drew other "
          "negatives than K8's checked call")
    n_valid = shards[g][3]
    kw9["n_valid"] = n_valid

    def reduced(i):
        return bt.parallelism.all_reduce_sum(
            mesh, [sh[4][i] for sh in shards], first_only=True)

    dQb_pos = reduced(2)
    Qb1 = Qb0.clone()
    S.capped_add(Qb1, dQb_pos, cap=cap)  # Qb after the positive side
    Qb1_plain = Qb0.clone()
    S.capped_add_plain(Qb1_plain, dQb_pos, cap)
    torch.cuda.synchronize()
    err_qb = float((Qb1 - Qb1_plain).abs().max())
    check(torch.allclose(Qb1, Qb1_plain, rtol=TOL_K10, atol=1e-7),
          f"K10's capped add of the bias is {err_qb:.3g} from its plain "
          "version")
    capped_bias = int((dQb_pos.abs() > cap).sum())

    def delta(fn, fn_neg, **over):
        dl = [torch.zeros_like(t) for t in (P0, Q0, Qb0)]
        h = fn(P0, Q0, Qb0, *dl, users, pos, neg, **dict(kw9, **over))
        dneg = torch.zeros_like(Qb0)
        fn_neg(h, Qb1, dneg, lr=lr, reg_b=o.reg_b)
        return dl + [dneg]

    got = delta(S.chunk_delta, S.chunk_bias_neg_delta)
    again = delta(S.chunk_delta, S.chunk_bias_neg_delta)
    ref = delta(S.chunk_delta_plain, S.chunk_bias_neg_delta_plain)
    grouped = delta(S.chunk_delta, S.chunk_bias_neg_delta,
                    users_sorted=False)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got[:3], shards[g][4]))
          and all(torch.equal(a, b) for a, b in zip(got, again)),
          "K9's delta path is not bitwise repeatable")
    fields, errs = {}, []
    for name, a, r, gr in zip(("dP", "dQ", "dQb", "dQb_neg"), got, ref,
                              grouped):
        ok, err, limit = step_check(a, r, torch.zeros_like(r))
        check(ok, f"K9's delta {name} is {err:.3g} from the plain version's "
              f"(limit {limit:.3g})")
        ok_g, err_g, _ = step_check(gr, a, torch.zeros_like(r))
        check(ok_g, f"K9's delta {name} with the users grouped is "
              f"{err_g:.3g} from the presorted call's")
        errs.append(err)
        fields[f"{name}_err"], fields[f"{name}_limit"] = err, limit
        fields[f"{name}_grouped_vs_presorted"] = err_g
    fields["hot_chunk_err"] = k9_hot_check(
        S, torch, S.chunk_delta, (P0, Q0, Qb0), users, pos, neg,
        {k: v for k, v in kw9.items() if k != "users_sorted"}, "K9's delta")
    # bounds: what the delta must move: the ids, each touched P / Q / Qb
    # row read once and its delta row read and written (it adds); per
    # sample the K9 operations.  The negative side's bias: each valid
    # negative's logit and id, and its row of Qb read and of dQb added.
    n_u = int(torch.unique(users[:n_valid]).numel())
    ok_neg = neg[:n_valid][neg[:n_valid] < I]
    n_i = int(torch.unique(torch.cat([pos[:n_valid], ok_neg])).numel())
    n_n = int(torch.unique(ok_neg).numel())
    B, N = neg.shape[0], users.shape[0]
    d = P0.shape[1]
    nbytes = 8 * N + 4 * B + (4 + 8) * d * (n_u + n_i) + (4 + 8) * n_i
    bms, by = bound_ms(nbytes, 8 * d * B + 2 * d * N + 6 * d * (n_u + n_i))
    dl_t = [torch.zeros_like(t) for t in (P0, Q0, Qb0)]
    u_s, p_s, n_ok = users.long(), pos.long(), neg.long() < I
    _, _, _, _, safe, mask, p_r, qi, qj, logit = S._forward(
        P0, Q0, Qb0, users, pos, neg, 1, n_valid, True)
    rows_p = lr * mask[:, None] * (logit[:, None] * (qi - qj) - o.reg_u * p_r)
    rows_q = torch.cat([lr * mask[:, None] * (logit[:, None] * p_r
                                              - o.reg_i * qi),
                        (lr * mask[:, None] * (-logit[:, None] * p_r
                                               - o.reg_j * qj))[n_ok]])
    idx_q = torch.cat([p_s, neg.long()[n_ok]])

    def library():  # the two scatters of per-sample rows (index_add_)
        dl_t[0].index_add_(0, u_s, rows_p)
        dl_t[1].index_add_(0, idx_q, rows_q)

    def fn9d(presorted=True):
        return S.chunk_delta(P0, Q0, Qb0, *dl_t, users, pos, neg,
                             **dict(kw9, users_sorted=presorted))

    dev_ms, ops = trace_stats(fn9d, K9_MAIN)
    ops_grouped = trace_stats(lambda: fn9d(False), K9_MAIN)[1]
    check(ops is not None and ops_grouped is not None
          and max(ops, ops_grouped) <= K9_MAX_STREAM_OPS,
          f"K9's delta makes {ops} (presorted) / {ops_grouped} (grouped) "
          f"stream operations per call (at most {K9_MAX_STREAM_OPS})")
    k9d = dict(route="cuda", source="buffalo_tpu_torch/csrc/bpr_update.cu",
               replaces="buffalo_tpu/ops/sgd_kernels.py:804",
               max_abs_err=max(errs[:3]), ms=time_ms(fn9d), device_ms=dev_ms,
               stream_ops_per_call=ops, form="presorted",
               grouped_ms=time_ms(lambda: fn9d(False)),
               stream_ops_per_call_grouped=ops_grouped,
               plain_ms=time_ms(lambda: S.chunk_delta_plain(
                   P0, Q0, Qb0, *dl_t, users, pos, neg, **kw9), reps=5,
                   warmup=1),
               bound_ms=bms, bound_by=by,
               library_ms=time_ms(library, reps=10, warmup=2),
               slots=N, slot_offset=g * n_loc, lr=lr, **fields)
    h = fn9d()
    h_plain = S.chunk_delta_plain(P0, Q0, Qb0, *dl_t, users, pos, neg, **kw9)
    neg_rows = (lr * mask * (-logit - o.reg_b * Qb1[safe]))[n_ok]
    neg_idx = neg.long()[n_ok]
    bms, by = bound_ms(8 * int(n_ok.sum()) + 12 * n_n, 4 * int(n_ok.sum()))

    def fn9n():
        S.chunk_bias_neg_delta(h, Qb1, dl_t[2], lr=lr, reg_b=o.reg_b)

    dev_ms, ops = trace_stats(fn9n, "bias_neg")
    k9n = dict(route="cuda", source="buffalo_tpu_torch/csrc/bpr_update.cu",
               replaces="buffalo_tpu/ops/sgd_kernels.py:832",
               max_abs_err=errs[3], ms=time_ms(fn9n), device_ms=dev_ms,
               stream_ops_per_call=ops,
               plain_ms=time_ms(lambda: S.chunk_bias_neg_delta_plain(
                   h_plain, Qb1, dl_t[2], lr=lr, reg_b=o.reg_b)),
               bound_ms=bms, bound_by=by,
               library_ms=time_ms(lambda: dl_t[2].index_add_(0, neg_idx,
                                                             neg_rows)),
               negatives=int(n_ok.sum()), rows=n_n)

    # K10's capped add of P's reduced delta (the four shards' deltas of this
    # chunk summed): the cap must bind on some rows for the check to see it
    dP = reduced(0)
    a, b = P0.clone(), P0.clone()
    S.capped_add(a, dP, cap=cap)
    S.capped_add_plain(b, dP, cap)
    torch.cuda.synchronize()
    err10 = float((a - b).abs().max())
    check(torch.allclose(a, b, rtol=TOL_K10, atol=1e-7),
          f"K10's capped add is {err10:.3g} from its plain version")
    capped_rows = int((dP.norm(dim=1) > cap).sum())
    check(capped_rows > 0, f"no row of the chunk's reduced delta of P passes "
          f"the cap {cap}: the capped add's check cannot see the cap")
    bms, by = bound_ms(12 * P0.numel(), 5 * P0.numel())
    k10c = dict(route="cuda", source="buffalo_tpu_torch/csrc/bpr_optimizer.cu",
                replaces="buffalo_tpu/ops/sgd_kernels.py:280",
                max_abs_err=max(err10, err_qb),
                ms=time_ms(lambda: S.capped_add(a, dP, cap=cap)),
                plain_ms=time_ms(lambda: S.capped_add_plain(b, dP, cap)),
                bound_ms=bms, bound_by=by, library_ms=None,
                rows=int(P0.shape[0]), capped_rows=capped_rows,
                bias_entries=int(Qb0.shape[0]), capped_bias=capped_bias)
    phase("mesh_bpr", d=D, shards=MESH_SHARDS, devices="cuda:0 (shared)",
          epochs=MESH_EPOCHS, chunk=batch, tol_x=TOL_MESH_X,
          tol_loss=TOL_MESH_LOSS, **runs, k8_offset=k8, k9_delta=k9d,
          k9_bias_neg=k9n, k10_capped_add=k10c, tol_step=TOL_BPR_STEP,
          tol_k10=TOL_K10)
    del users_c, items_c, bloom, P0, Q0, Qb0, shards, dP, dl_t, grouped
    torch.cuda.empty_cache()
    entries = {"chunk_delta": k9d, "chunk_bias_neg_delta": k9n,
               "capped_add": k10c}
    return entries, {n: mesh_launches[n] for n in entries}


def mesh_warp(bt, W, S, torch, data):
    """WARP's dp mesh (``warp_epoch`` on a mesh) over MESH_SHARDS shards on this
    card, MESH_EPOCHS epochs of the defaults (adagrad, d = 64) at the
    single device's batch size rounded to the mesh: every epoch held to one
    device at that batch size (``mesh_epochs_rule``; the violation rate
    within one triplet's 1 / n more, since a margin within one float64
    rounding may flip), the K schedule and found_frac equal; launches and
    epoch times beside one device's.  Then K11 at the second shard's slot
    offset against its plain version on a real chunk (ids, any_v, trials
    and counts equal, weights within TOL_WARP_W)."""
    res = {}
    batch = None
    for where, more in (("mesh", mesh_opt(MESH_SHARDS)), ("one", {})):
        snaps, restore = epoch_snapshots(
            W, "warp_epoch", lambda a: a[1][next(iter(a[1]))])
        try:
            opt = warp_opt(bt, num_iters=MESH_EPOCHS, **more)
            if batch is not None:
                opt.batch_size = batch
            model, launches, peak_mb, _ = warp_train(bt, W, S, torch, data,
                                                     opt)
        finally:
            restore()
        if where == "mesh":
            batch = model._batch_size()
            batch = -(-batch // MESH_SHARDS) * MESH_SHARDS
            mesh_model = model
        res[where] = dict(tables=snaps, losses=model.iteration_losses,
                          K=model.iteration_candidates,
                          found=model.iteration_found,
                          epoch_seconds=model.iteration_times,
                          launches=launches, max_memory_allocated_mb=peak_mb)
    nchunks = -(-mesh_model.num_nnz // batch)
    ln = res["mesh"]["launches"]
    per = MESH_SHARDS * nchunks * MESH_EPOCHS
    want = dict(warp_search=per, warp_accumulate=per, warp_probe=0,
                warp_violations=MESH_EPOCHS, deferred_update=2 * MESH_EPOCHS)
    check(ln == want, f"the WARP mesh launched {ln}, expected {want}")
    check(res["mesh"]["K"] == res["one"]["K"],
          f"K schedules differ: {res['mesh']['K']} vs {res['one']['K']}")
    check(np.allclose(res["mesh"]["found"], res["one"]["found"], rtol=1e-6,
                      atol=0),
          f"found_frac differs: {res['mesh']['found']} vs "
          f"{res['one']['found']}")
    n = len(mesh_model._sub_samples[0])
    epochs = mesh_epochs_rule(res["mesh"]["tables"], res["one"]["tables"],
                              res["mesh"]["losses"], res["one"]["losses"],
                              ("P", "Q"), "WARP mesh", loss_atol=1.0 / n)

    # K11 at a slot offset on the second shard of the middle chunk
    dev = bt.parallelism.get_mesh(MESH_SHARDS,
                                  devices=["cuda:0"] * MESH_SHARDS).devices[0]
    _, _, _, indptr, bloom, log2, P0, Q0 = warp_inputs(S, torch, mesh_model)
    from buffalo_tpu_torch.data.batching import csr_pair_chunks

    u_np, i_np, _ = csr_pair_chunks(mesh_model.data, batch)
    users_c, items_c = (torch.from_numpy(a).to(dev) for a in (u_np, i_np))
    c = users_c.shape[0] // 2
    n_loc, g = batch // MESH_SHARDS, 1
    users = users_c[c, g * n_loc:(g + 1) * n_loc].contiguous()
    pos = items_c[c, g * n_loc:(g + 1) * n_loc].contiguous()
    o = mesh_model.opt
    K = mesh_model.iteration_candidates[-1]
    kw = dict(num_items=Q0.shape[0], num_candidates=K, seed=int(o.random_seed),
              epoch=0, chunk=c, n_valid=n_loc, score_func=o.score_func,
              threshold=float(o.threshold), probe=o.probe_mode, indptr=indptr,
              bloom=bloom, bloom_log2=log2, slot_offset=g * n_loc)
    cnt = [torch.zeros(1, dtype=torch.int32, device=dev) for _ in range(2)]
    got = W.warp_search(users, pos, P0, Q0, counts=cnt[0], **kw)
    ref = W.warp_search_plain(users, pos, P0, Q0, counts=cnt[1], **kw)
    torch.cuda.synchronize()
    check(all(torch.equal(got[i], ref[i]) for i in (0, 2, 3))
          and torch.equal(cnt[0], cnt[1])
          and torch.allclose(got[1], ref[1], rtol=TOL_WARP_W, atol=0),
          "K11 at a slot offset differs from its plain version")
    cand = W.warp_candidates(n_loc, K, Q0.shape[0], seed=int(o.random_seed),
                             epoch=0, chunk=c, device=dev,
                             slot_offset=g * n_loc)
    whole = W.warp_candidates(batch, K, Q0.shape[0], seed=int(o.random_seed),
                              epoch=0, chunk=c, device=dev)
    check(torch.equal(cand, whole[g * n_loc:(g + 1) * n_loc]),
          "a shard's candidates are not the single device's rows")
    neg, w, any_v, _ = got
    first = torch.argmax((cand == neg[:, None]).int(), 1) + 1
    upto = torch.where(any_v, first, torch.full_like(first, K))
    need = int(upto.sum())
    walked = torch.arange(K, device=dev)[None, :] < upto[:, None]
    d = P0.shape[1]
    n_u = int(torch.unique(users).numel())
    n_i = int(torch.unique(torch.cat([pos, cand[walked]])).numel())
    nbytes = n_loc * (8 + 16 + 13 + 4) + 4 * d * (n_u + n_i)
    t_b, t_o = nbytes / PEAK_BYTES_S, 2 * d * (need + n_loc) / PEAK_FP64_S
    t_i = 100 * need / PEAK_INT32_S
    k11 = dict(ms=time_ms(lambda: W.warp_search(users, pos, P0, Q0, **kw)),
               plain_ms=time_ms(lambda: W.warp_search_plain(
                   users, pos, P0, Q0, **kw), reps=3, warmup=1),
               bound_ms=1e3 * max(t_b, t_o, t_i),
               bound_by="bytes" if t_b >= max(t_o, t_i) else "operations",
               slots=n_loc, slot_offset=g * n_loc, num_candidates=K,
               found=int(cnt[0][0]),
               weight_max_abs_err=float((got[1] - ref[1]).abs().max()))
    phase("mesh_warp", d=int(o.d), shards=MESH_SHARDS,
          devices="cuda:0 (shared)", epochs=MESH_EPOCHS, chunk=batch,
          optimizer=o.optimizer, tol_x=TOL_MESH_X, tol_loss=TOL_MESH_LOSS,
          loss_atol=1.0 / n, epochs_rule=epochs, K=res["mesh"]["K"],
          found_frac=res["mesh"]["found"],
          epoch_seconds=res["mesh"]["epoch_seconds"],
          one_device_epoch_seconds=res["one"]["epoch_seconds"],
          launches=ln, launches_per_epoch=per_epoch(ln, MESH_EPOCHS),
          one_device_launches_per_epoch=per_epoch(res["one"]["launches"],
                                                  MESH_EPOCHS),
          max_memory_allocated_mb=res["mesh"]["max_memory_allocated_mb"],
          k11_offset=k11)
    del users_c, items_c, bloom, P0, Q0, mesh_model
    torch.cuda.empty_cache()


def cfr_entry_counts(host, sizes):
    """(entries, solved rows) of CFR's host batches: every live entry of
    both sides of every phase, and the rows with entries (``sizes`` the
    tables' heights per phase)."""
    entries = rows = 0
    for ph, batch_list in host.items():
        for e in batch_list:
            if hasattr(e, "lens"):          # a user or context batch
                lens, ids = e.lens, e.rows
            elif hasattr(e[1], "lens"):     # a segment pair over one row list
                lens, ids = e[0].lens + e[1].lens, e[0].rows
            else:                           # a padded batch + its SPPMI block
                lens, ids = e[0].lens + e[1], e[0].rows
            lens = np.asarray(lens, np.int64)
            entries += int(lens.sum())
            rows += int(((lens > 0) & (np.asarray(ids) < sizes[ph])).sum())
    return entries, rows


def cfr_epoch_bound(host, sizes, d, cg_iters):
    """The least time of one CFR epoch's kernel work on its batches: K17's
    operations, d (d + 1) + 4 d per entry, and K3's, 2 d^2 per CG step and
    solved row, over the FP32 peak; or the bytes: 8 per entry read, each
    solved row's system (d^2 + d floats) written by K17 and read by K3.
    The larger, and which."""
    entries, rows = cfr_entry_counts(host, sizes)
    return bound_ms(8 * entries + 8 * rows * (d * d + d),
                    entries * (d * (d + 1) + 4 * d)
                    + rows * cg_iters * 2 * d * d)


def mesh_cfr(bt, CK, K, torch, data):
    """CoFactor's dp mesh (``cfr_epoch`` on a mesh) over MESH_SHARDS shards
    on this card: CFR d = CFR_D with the defaults, MESH_EPOCHS epochs on
    the brunch data against one device on the same batches, every epoch's
    five tables held by ``mesh_epochs_rule`` (the mesh gathers the rows
    its shards solve, so they are expected bit for bit), launches per epoch
    (K17, K3 and K18 once per shard and padded entry, once per segment
    entry on the one replica), epoch times (less the tables' host copies
    the rule reads) beside one device's and the epoch's bound
    (``cfr_epoch_bound``).  Then K17, K3 and K18 on a shard's
    slice (shard 1's when it has one) of a padded item entry holding
    sentinel rows between real rows, against their plain versions at
    TOL_K17, the CG rule and TOL_K18: the sentinel rows add no loss and no
    entries, and no row or bias outside the slice's real rows moves."""
    from buffalo_tpu_torch.models.cfr import _is_segment, _stage_mesh_entry
    from buffalo_tpu_torch.ops.als_kernels import gramian
    from buffalo_tpu_torch.ops.cfr_kernels import (LOSS_EXPLICIT,
                                                   LOSS_IMPLICIT, LOSS_REG,
                                                   Side)

    par = bt.parallelism
    kernels = CK.KERNELS + (K.batched_cg_dense,)
    res = {}
    for where, more in (("mesh", mesh_opt(MESH_SHARDS)), ("one", {})):
        opt = bt.CFROption().get_default_option()
        opt.update(d=CFR_D, num_iters=MESH_EPOCHS, device="cuda",
                   validation={}, **more)
        model = bt.CFR(opt, data=data)
        np.random.seed(0)
        model.initialize()
        copy_s = []
        snaps, restore = epoch_snapshots(CK, "cfr_epoch",
                                         lambda a: a[1][next(iter(a[1]))],
                                         copy_s)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(kernels)
            par.reset_counts()
            model.train()
            launches = read_counts(kernels)
        finally:
            restore()
        res[where] = dict(
            tables=snaps, losses=model.iteration_losses,
            # the epochs' own seconds: the model's less the snapshot copies
            epoch_seconds=[t - c for t, c in zip(model.iteration_times,
                                                 copy_s)],
            snapshot_seconds=copy_s, launches=launches,
            collective_calls=dict(all_gather_rows=par.all_gather_rows.calls,
                                  all_reduce_sum=par.all_reduce_sum.calls),
            max_memory_allocated_mb=torch.cuda.max_memory_allocated()
            / 2 ** 20)
        if where == "mesh":
            mesh_model = model
    o = mesh_model.opt
    host = mesh_model._build_batches()
    n_pad = sum(not _is_segment(e) for v in host.values() for e in v)
    n_seg = sum(_is_segment(e) for v in host.values() for e in v)
    per = (MESH_SHARDS * n_pad + n_seg) * MESH_EPOCHS
    want = {k.__name__: per for k in kernels}
    ln = res["mesh"]["launches"]
    check(ln == want, f"the CFR mesh launched {ln}, expected {want}")
    names = ("U", "I", "C", "Ib", "Cb")
    epochs = mesh_epochs_rule(res["mesh"]["tables"], res["one"]["tables"],
                              res["mesh"]["losses"], res["one"]["losses"],
                              names, "CFR mesh")
    bitwise = all(np.array_equal(a, b) for mt, ot in zip(
        res["mesh"]["tables"], res["one"]["tables"]) for a, b in zip(mt, ot))
    sizes = {"user": mesh_model.U.shape[0], "item": mesh_model.I.shape[0],
             "context": mesh_model.C.shape[0]}
    ebound, eby = cfr_epoch_bound(host, sizes, CFR_D, int(o.num_cg_max_iters))

    # ---- K17, K3, K18 on a shard's slice holding sentinel rows
    mesh = par.get_mesh(MESH_SHARDS, devices=["cuda:0"] * MESH_SHARDS)
    n = sizes["item"]
    pick = None
    for e in host["item"]:
        if _is_segment(e):
            continue
        rows = np.asarray(e[0].rows)
        m = -(-len(rows) // MESH_SHARDS)
        rows = np.concatenate([rows, np.full(m * MESH_SHARDS - len(rows), n)])
        for g in (1, 2, 3, 0)[:MESH_SHARDS]:
            sl = rows[g * m:(g + 1) * m]
            if (sl >= n).any() and (sl < n).any():
                pick = (_stage_mesh_entry(e, mesh, n)[g], g)
                break
        if pick is not None:
            break
    check(pick is not None, "no padded item entry has a shard slice with "
          "sentinel rows between real ones")
    (b, lens_c, cols_c, vals_c), g = pick
    U, I, C, Ib, Cb = cfr_tables(torch, mesh_model)
    exp = Side(C, lens_c, cols_c, vals_c)
    kw = dict(implicit=Side.of(U, b), explicit=exp, FF=gramian(U), rbias=Ib,
              cbias=Cb, alpha=float(o.alpha), l=float(o.l),
              reg=float(o.reg_i), loss=LOSS_IMPLICIT | LOSS_EXPLICIT
              | LOSS_REG)
    e17, le17, tot, rep, got, ref = k17_check(CK, torch, I, b.rows, kw)
    check(e17 <= TOL_K17 and le17 <= TOL_K17 and tot and rep,
          f"K17 on a shard's slice with sentinel rows: A/y {e17:.3g}, loss "
          f"{le17:.3g} (totals equal {tot}, repeatable {rep})")
    A, y, loss, total = got
    sentinel = b.rows >= n
    check(float(loss[sentinel].abs().sum()) == 0
          and not bool(total[sentinel].any()),
          "a sentinel row added loss or entries in K17")
    live = (total > 0) & ~sentinel
    idx = b.rows.long()[live]
    cg = dict(cg_iters=int(o.num_cg_max_iters), cg_tol=float(o.cg_tolerance))
    ok, solve_fields, short_ok = floor_check(
        lambda t: K.batched_cg_dense(A, y, t, total, rows=b.rows, **cg),
        lambda t, it: K.batched_cg_dense_plain(
            A.to(t.dtype), y.to(t.dtype), t, total, rows=b.rows,
            cg_iters=it, cg_tol=cg["cg_tol"]), I, idx)
    check(ok, f"K3 on a shard's slice with sentinel rows: {solve_fields}")
    I_new = I.clone()
    K.batched_cg_dense(A, y, I_new, total, rows=b.rows, **cg)
    bias = [Ib.clone(), Ib.clone()]
    CK.cfr_bias(I_new, b.rows, total, explicit=exp, bias=bias[0], cbias=Cb)
    CK.cfr_bias_plain(I_new, b.rows, total, explicit=exp, bias=bias[1],
                      cbias=Cb)
    torch.cuda.synchronize()
    k18_err = rel_err(bias[0][idx], bias[1][idx])[1]
    check(k18_err <= TOL_K18, f"K18 on a shard's slice with sentinel rows: "
          f"{k18_err:.3g} from the plain version")
    outside = torch.ones(n, dtype=torch.bool, device=I.device)
    outside[b.rows.long()[~sentinel]] = False
    untouched = (torch.equal(I_new[outside], I[outside])
                 and torch.equal(bias[0][outside], Ib[outside]))
    check(untouched, "K3 or K18 wrote a row outside the slice's real rows")
    phase("mesh_cfr", d=CFR_D, shards=MESH_SHARDS, devices="cuda:0 (shared)",
          epochs=MESH_EPOCHS, padded_entries=n_pad, segment_entries=n_seg,
          tol_x=TOL_MESH_X, tol_loss=TOL_MESH_LOSS, epochs_rule=epochs,
          tables_bitwise_equal=bitwise,
          epoch_seconds=res["mesh"]["epoch_seconds"],
          one_device_epoch_seconds=res["one"]["epoch_seconds"],
          snapshot_seconds=res["mesh"]["snapshot_seconds"],
          one_device_snapshot_seconds=res["one"]["snapshot_seconds"],
          epoch_bound_ms=ebound, epoch_bound_by=eby,
          launches=ln, launches_per_epoch=per_epoch(ln, MESH_EPOCHS),
          one_device_launches_per_epoch=per_epoch(res["one"]["launches"],
                                                  MESH_EPOCHS),
          collective_calls=res["mesh"]["collective_calls"],
          max_memory_allocated_mb=res["mesh"]["max_memory_allocated_mb"],
          one_device_max_memory_allocated_mb=res["one"][
              "max_memory_allocated_mb"],
          sentinel_slice=dict(shard=g, rows=int(b.rows.shape[0]),
                              sentinel_rows=int(sentinel.sum()),
                              k17_rel_err=e17, k17_loss_rel_err=le17,
                              k3=dict(solve_fields,
                                      one_step_fewer_passes=short_ok),
                              k18_rel_err=k18_err),
          tol_k17=TOL_K17, tol_k18=TOL_K18)
    del U, I, C, Ib, Cb, A, y, I_new, got, ref, mesh_model
    torch.cuda.empty_cache()


def w2v_epoch_bound(path, stats, d, K, block):
    """The least time of one W2V epoch's kernel work, from its stats.  The
    stream epoch: K21's operations, 2 d (3 + 3 K) per pair term, over the
    FP32 peak; or its bytes: the 6-byte wire format per position, the
    negatives' ids, and the delta rows (2 per position, K per block) written
    by K21 and read by K20.  The host pairs: K19's operations, 5 d (K + 1)
    per pair; or the ids and the 2 + K delta rows per pair written by K19
    and read by K20.  The larger, and which."""
    pairs = float(stats["pairs"])
    if path == "stream":
        T, chunks = stats["chunk"], stats["chunks"]
        NB = T // block
        return bound_ms(chunks * (6 * T + 4 * NB * K
                                  + 2 * 4 * d * (2 * T + NB * K)),
                        pairs * 2 * d * (3 + 3 * K))
    return bound_ms(pairs * (8 + 2 * 4 * d * (2 + K)),
                    pairs * (K + 1) * 5 * d)


def mesh_w2v(bt, W, S, torch, data):
    """W2V's dp mesh (``w2v_epoch_stream`` and ``w2v_epoch`` on a mesh)
    over MESH_SHARDS shards on this card, on the brunch stream at
    ``w2v_path``'s settings.  The stream epoch (``pair_gen="device"``),
    MESH_EPOCHS epochs against one device at the same T (the same token
    chunks): each epoch's loss within W2V_MESH_STREAM_LOSS (the JAX
    package's rule) and its pair count short of one device's by no more
    than the pairs across the shards' edges (window (window + 1) pair
    terms per edge and chunk),
    the tables' distance printed.  Then one host-pair epoch against one
    device at the same chunk: L0 and L1 within W2V_MESH_HOST_X (relative
    Frobenius), the loss within TOL_MESH_LOSS.  Launches per epoch (per
    chunk K8 and K21, or K19, once per shard; K20 twice on the union),
    epoch times beside one device's and each epoch's bound
    (``w2v_epoch_bound``).  Then, on shard 1 of the first chunk of the
    trained mesh model: K19 at its slot offset (its draws bit for bit its
    plain version's and the single device's rows, the rows at TOL_W2V), K8
    at its offset (bit for bit both ways), and K20 on the union of the
    four shards' L1 rows of a token chunk against its plain version, with
    rows past the cap.  Returns (the kernels line's entries of the two new
    entry points, their launches in the mesh runs)."""
    par = bt.parallelism
    kernels = W.KERNELS + (S.sample_negatives,)
    runs, mesh_models, mesh_launches = {}, {}, {}
    for path, kw in (("stream", dict(pair_gen="device",
                                     num_iters=MESH_EPOCHS)),
                     ("host", dict(pair_gen="host", num_iters=1))):
        res, chunk = {}, None
        for where, more in (("mesh", mesh_opt(MESH_SHARDS)), ("one", {})):
            opt = w2v_opt(bt, **kw, **more)
            if chunk is not None:
                opt.batch_size = chunk
            model = w2v_model(bt, data, opt)
            if chunk is None:
                chunk = (model._stream_plan()[1] if path == "stream"
                         else model._pair_chunk())
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(kernels)
            par.reset_counts()
            model.train()
            launches = read_counts(kernels)
            res[where] = dict(
                losses=model.iteration_losses, stats=model.epoch_stats,
                epoch_seconds=model.iteration_times, launches=launches,
                collective_calls=dict(
                    all_gather_rows=par.all_gather_rows.calls,
                    all_reduce_sum=par.all_reduce_sum.calls),
                max_memory_allocated_mb=torch.cuda.max_memory_allocated()
                / 2 ** 20, tables=(model.L0, model.L1))
            if where == "mesh":
                mesh_models[path] = model
            else:
                del model
        o = mesh_models[path].opt
        d, K = int(o.d), int(o.num_negative_samples)
        block = int(o.neg_block)
        m, one = res["mesh"], res["one"]
        chunks = sum(s["chunks"] for s in m["stats"])
        ln = m["launches"]
        mesh_launches[path] = ln
        if path == "stream":
            want = dict(pair_step=0, row_apply=2 * chunks,
                        stream_chunk_deltas=MESH_SHARDS * chunks,
                        sample_negatives=MESH_SHARDS * chunks)
        else:
            want = dict(pair_step=MESH_SHARDS * chunks, row_apply=2 * chunks,
                        stream_chunk_deltas=0, sample_negatives=0)
        check(ln == want, f"the W2V {path} mesh launched {ln}, expected "
              f"{want}")
        rel = {t: frob_rel(a, b) for t, a, b in zip(("L0", "L1"), m["tables"],
                                                      one["tables"])}
        loss_rel = [abs(a / b - 1) for a, b in zip(m["losses"],
                                                     one["losses"])]
        fields = {}
        if path == "stream":
            window = int(o.window)
            for e, (sm, so) in enumerate(zip(m["stats"], one["stats"])):
                # a shard's edge cuts the window(window + 1) / 2 position
                # pairs that span it, each a pair term both ways
                cut = window * (window + 1) * (MESH_SHARDS - 1) * sm["chunks"]
                # the counts are float32 sums over each group's chunks
                slack = 2 * sm["chunks"]
                check(so["pairs"] - cut - slack <= sm["pairs"]
                      <= so["pairs"] + slack,
                      f"W2V stream mesh epoch {e + 1}: {sm['pairs']} pairs "
                      f"against one device's {so['pairs']}, at most {cut} "
                      "cut at the shards' edges")
            check(max(loss_rel) <= W2V_MESH_STREAM_LOSS,
                  f"W2V stream mesh losses {m['losses']} against one "
                  f"device's {one['losses']}")
            fields["pairs_dropped"] = [so["pairs"] - sm["pairs"] for sm, so in
                                       zip(m["stats"], one["stats"])]
        else:
            fields["tables_bitwise_equal"] = all(
                np.array_equal(a, b) for a, b in zip(m["tables"],
                                                     one["tables"]))
            check(max(rel.values()) <= W2V_MESH_HOST_X
                  and max(loss_rel) <= TOL_MESH_LOSS,
                  f"W2V host-pair mesh epoch parts from one device: tables "
                  f"{rel}, losses {m['losses']} vs {one['losses']}")
        bounds = [w2v_epoch_bound(path, s, d, K, block) for s in m["stats"]]
        runs[path] = dict(
            chunk=chunk, chunks=[s["chunks"] for s in m["stats"]],
            pairs=[s["pairs"] for s in m["stats"]],
            one_device_pairs=[s["pairs"] for s in one["stats"]],
            losses=m["losses"], one_device_losses=one["losses"],
            loss_rel=loss_rel, tables_rel=rel, **fields,
            epoch_seconds=m["epoch_seconds"],
            one_device_epoch_seconds=one["epoch_seconds"],
            epoch_bound_ms=[b for b, _ in bounds],
            epoch_bound_by=[by for _, by in bounds],
            launches=ln, launches_per_epoch=per_epoch(ln, len(m["losses"])),
            one_device_launches_per_epoch=per_epoch(one["launches"],
                                                    len(one["losses"])),
            collective_calls=m["collective_calls"],
            max_memory_allocated_mb=m["max_memory_allocated_mb"],
            one_device_max_memory_allocated_mb=one[
                "max_memory_allocated_mb"])

    # ---- the new entry points on shard 1 of the first chunk
    model = mesh_models["stream"]
    mesh = par.get_mesh(MESH_SHARDS, devices=["cuda:0"] * MESH_SHARDS)
    dev = mesh.devices[0]
    o = model.opt
    V, d, K = int(model._vocab.size), int(o.d), int(o.num_negative_samples)
    cap, lr, g = float(o.max_step_norm), float(o.lr), 1
    L0 = torch.from_numpy(model.L0).to(dev, copy=True)
    L1 = torch.from_numpy(model.L1).to(dev, copy=True)
    prob, al = S.build_alias_table(np.diff(np.asarray(
        model._vocab.dist, dtype=np.int64), prepend=0))
    alias = (torch.from_numpy(prob).to(dev), torch.from_numpy(al).to(dev))
    # K19 at its slot offset on the first pair chunk of a host-pair epoch
    chunk = runs["host"]["chunk"]
    inp_h, tgt_h, _ = model._generate_pairs(np.random.default_rng(0))
    n_loc = chunk // MESH_SHARDS
    inputs = torch.from_numpy(inp_h[:chunk].copy()).to(dev)
    targets = torch.from_numpy(tgt_h[:chunk].copy()).to(dev)
    sl = slice(g * n_loc, (g + 1) * n_loc)
    inp_s, tgt_s = inputs[sl].contiguous(), targets[sl].contiguous()
    pkw = dict(vocab_size=V, num_negatives=K, seed=0, epoch=0, chunk=0,
               alias=alias, slot_offset=g * n_loc)
    p_got = W.pair_step(L0, L1, inp_s, tgt_s, lr, **pkw)
    p_again = W.pair_step(L0, L1, inp_s, tgt_s, lr, **pkw)
    whole = W.pair_step(L0, L1, inputs, targets, lr,
                        **dict(pkw, slot_offset=0))[0]
    p_negs = W.w2v_negatives(tgt_s, V, num_negatives=K, seed=0, epoch=0,
                             chunk=0, alias=alias, slot_offset=g * n_loc)
    p_ref = W.pair_step_plain(L0, L1, inp_s, tgt_s, p_negs, lr, vocab_size=V)
    torch.cuda.synchronize()
    k19_err = max(rel_err(a, b)[1] for a, b in zip(p_got[2:4], p_ref[1:3]))
    k19_rep = all(torch.equal(a, b) for a, b in zip(p_got, p_again))
    check(torch.equal(p_got[0], p_negs) and torch.equal(p_got[0], whole[sl])
          and torch.equal(p_got[1], p_ref[0]) and k19_err <= TOL_W2V
          and k19_rep, f"K19 at slot offset {g * n_loc}: draws equal to the "
          f"plain version's {torch.equal(p_got[0], p_negs)} and the single "
          f"device's {torch.equal(p_got[0], whole[sl])}, rows {k19_err:.3g} "
          f"from the plain version, repeatable {k19_rep}")
    bms, by = bound_ms(*k19_work(torch, inp_s, tgt_s, p_negs, V, d, K))

    def fn19():
        return W.pair_step(L0, L1, inp_s, tgt_s, lr, **pkw)

    k19 = dict(route="cuda", source="buffalo_tpu_torch/csrc/w2v_pair_step.cu",
               replaces="buffalo_tpu/ops/w2v_kernels.py:503",
               max_abs_err=max(float((a - b).abs().max())
                               for a, b in zip(p_got[2:4], p_ref[1:3])),
               ms=time_ms(fn19), device_ms=trace_ms(fn19, "pair_step"),
               plain_ms=time_ms(lambda: W.pair_step_plain(
                   L0, L1, inp_s, tgt_s, W.w2v_negatives(
                       tgt_s, V, num_negatives=K, seed=0, epoch=0, chunk=0,
                       alias=alias, slot_offset=g * n_loc), lr,
                   vocab_size=V), reps=5, warmup=1),
               bound_ms=bms, bound_by=by, library_ms=None,
               library="none: no call draws the redrawn negatives and forms "
               "the SGNS rows", rel_err=k19_err, pairs=n_loc,
               slot_offset=g * n_loc, draws_bitwise=True)
    # K8 at its offset and K20 on the union, the first token chunk
    block, T, _ = model._stream_plan()
    G = int(o.max_chunks_per_dispatch)
    wc_h, bc_h, hc_h, _, _ = model._stream_host_phase(
        np.random.default_rng(1), T, G)
    T_loc, NB = T // MESH_SHARDS, T // (MESH_SHARDS * block)
    draw = dict(num_negatives=K, seed=0, epoch=0, chunk=0, alias=alias)
    whole_negs = W.stream_negatives(T // block, V, device=dev, **draw)
    parts1 = []
    for k in range(MESH_SHARDS):
        wc = torch.from_numpy(wc_h[0, k * T_loc:(k + 1) * T_loc].copy()).to(
            dev)
        hc = torch.from_numpy(hc_h[0, k * T_loc:(k + 1) * T_loc].copy()).to(
            dev)
        sc = torch.cumsum(torch.from_numpy(
            bc_h[0, k * T_loc:(k + 1) * T_loc].copy()).to(dev), 0,
            dtype=torch.int32)
        negs = W.stream_negatives(NB, V, device=dev, slot_offset=k * NB,
                                  **draw)
        if k == g:
            negs_p, _ = S.sample_negatives_plain(
                torch.zeros(NB, dtype=torch.int32, device=dev), V,
                slot_offset=k * NB, **draw)
            check(torch.equal(negs.reshape(-1), negs_p)
                  and torch.equal(negs, whole_negs[k * NB:(k + 1) * NB]),
                  "K8 at a shard's first block differs from its plain "
                  "version or from the single device's rows")
            k8_kw = dict(draw, slot_offset=k * NB)
        _, dL1p, dLn, _, _ = W.stream_chunk_deltas(
            L0, L1, wc, sc, hc, negs, window=int(o.window), block=block,
            vocab_size=V)
        parts1.append([(wc, dL1p), (negs.reshape(-1), dLn.reshape(-1, d))])
    union = [tuple(par.all_gather_rows(mesh, [p[j][x] for p in parts1],
                                       first_only=True) for x in (0, 1))
             for j in range(2)]
    outs = [L1.clone() for _ in range(4)]
    W.apply_union(mesh, {dev: (L0.clone(), outs[0])}, 1, parts1, scale=lr,
                  cap=cap)
    W.row_apply(outs[1], union, scale=lr, cap=cap)
    W.row_apply_plain(outs[2], union, scale=lr, cap=cap)
    W.row_apply_plain(outs[3], union, scale=lr, cap=0.0)
    torch.cuda.synchronize()
    dT = outs[3] - L1
    scale = float(dT.abs().max())
    spacing = 2 * float(torch.finfo(torch.float32).eps) * float(
        L1.abs().max())
    k20_err = float((outs[0] - outs[2]).abs().max())
    k20_rep = torch.equal(outs[0], outs[1])
    capped = int(((dT * dT).sum(1).sqrt() > cap).sum())
    check(k20_err <= TOL_W2V * scale + spacing and k20_rep and capped > 0,
          f"K20 on the union: {k20_err:.3g} from the plain version (row "
          f"deltas up to {scale:.3g}, repeatable {k20_rep}, rows past the cap "
          f"{capped})")
    n20 = int(union[0][0].shape[0] + union[1][0].shape[0])
    t20 = distinct_rows(torch, union[0][0], union[1][0], R=V)
    bms, by = bound_ms(4 * n20 + 4 * d * n20 + 8 * d * t20, 2 * d * n20)
    keys_all = torch.cat([union[0][0], union[1][0]])
    rows_all = torch.cat([union[0][1], union[1][1]])
    keep = keys_all < V
    keys_l, rows_l = keys_all[keep].long(), rows_all[keep]

    def library():
        Dl = torch.zeros_like(L1).index_add_(0, keys_l, rows_l, alpha=lr)
        nrm = (Dl * Dl).sum(1, keepdim=True).sqrt()
        return outs[3].add_(Dl * torch.clamp(cap / nrm.clamp(min=1e-20),
                                             max=1.0))

    k20 = dict(route="cuda", source="buffalo_tpu_torch/csrc/w2v_row_apply.cu",
               replaces="buffalo_tpu/ops/w2v_kernels.py:427",
               max_abs_err=k20_err,
               ms=time_ms(lambda: W.row_apply(outs[1], union, scale=lr,
                                              cap=cap)),
               plain_ms=time_ms(lambda: W.row_apply_plain(
                   outs[2], union, scale=lr, cap=cap), reps=5, warmup=1),
               bound_ms=bms, bound_by=by, library_ms=time_ms(library),
               library="index_add_ of the union's rows + the norm clip",
               rel_err=k20_err / scale, entries=n20, touched_rows=t20,
               rows_past_cap=capped, shards=MESH_SHARDS)
    # K8's work: the block ids read, per draw one Philox4x32-10 (~100
    # int32 operations) and an alias pick (~4, its prob and alias entries
    # read), the negative written
    nb, ops_ = 4 * NB + 12 * NB * K, 104 * NB * K
    k8 = dict(ms=time_ms(lambda: W.stream_negatives(NB, V, device=dev,
                                                    **k8_kw)),
              plain_ms=time_ms(lambda: S.sample_negatives_plain(
                  torch.zeros(NB, dtype=torch.int32, device=dev), V,
                  **k8_kw), reps=5, warmup=1),
              bound_ms=1e3 * max(nb / PEAK_BYTES_S, ops_ / PEAK_INT32_S),
              bound_by="bytes" if nb / PEAK_BYTES_S >= ops_ / PEAK_INT32_S
              else "operations", blocks=NB, slot_offset=g * NB,
              bitwise=True)
    phase("mesh_w2v", d=d, shards=MESH_SHARDS, devices="cuda:0 (shared)",
          stream_epochs=MESH_EPOCHS, host_epochs=1,
          tol_stream_loss=W2V_MESH_STREAM_LOSS, tol_host_x=W2V_MESH_HOST_X,
          tol_loss=TOL_MESH_LOSS, **runs, k19_offset=k19, k8_offset=k8,
          k20_union=k20, tol=TOL_W2V)
    del L0, L1, outs, union, parts1, p_got, p_again, p_ref, whole, dT
    del mesh_models, model
    torch.cuda.empty_cache()
    entries = {"pair_step_offset": k19, "row_apply_union": k20}
    return entries, {"pair_step_offset": mesh_launches["host"]["pair_step"],
                     "row_apply_union": mesh_launches["stream"]["row_apply"]
                     + mesh_launches["host"]["row_apply"]}


# ------------------------------------------------------------- wide rows
WIDE_D = 300  # past 256 floats (the widths the kernels took before) and
              # no multiple of 32
# K7 past the 58,112 cells it once took: an IVF index of WIDE_CELLS cells
# over WIDE_IVF_ROWS random rows of WIDE_D floats (WIDE_IVF_ITERS Lloyd
# iterations), searched by WIDE_IVF_QUERIES queries; K22 past the 32 shards
# it once took: sharded top-k over WIDE_SHARDS shards
WIDE_IVF_ROWS, WIDE_CELLS, WIDE_IVF_ITERS = 120_000, 60_000, 2
WIDE_IVF_QUERIES, WIDE_SHARDS = 1_000, 33
# how each kernel's first call on the d = WIDE_D paths is held to its plain
# version, run on host copies of the call's inputs through the wrapper's
# own CPU route: "table", each input the call changed and each output
# within the tolerance of its largest entry; "step", each changed input's
# step within the tolerance of the largest step, plus two float32 spacings
# of the input (each side rounds start + step once); "solve", the solved
# rows by the CG rule (noise_floor_check: TOL_X, or the noise floor against
# a float64 run), the outputs as "table"; "topk", kernel_topk_check.  A
# tuple gives the outputs' tolerances in order; integer tensors equal.  The
# tolerances are those the kernels are held to elsewhere in this script; a
# float tensor past its tolerance passes only by that noise floor (the
# plain version's float64 run as the witness), and the phase line lists
# each such tensor with both distances from the witness.
WIDE_RULES = {
    "als_normal_equations": ("table", TOL_X),
    "batched_cg_dense": ("solve", TOL_X),
    "ialspp_solve_batch": ("solve", TOL_LOSS),
    "score_topk": ("topk", TOL_SCORE),
    "ivf_tile_topk": ("topk", TOL_SCORE),
    "kmeans_update": ("table", TOL_CENT),
    "sharded_topk_merge": ("table", 0.0),
    "chunk_update": ("step", TOL_BPR_STEP),
    "chunk_accumulate": ("step", TOL_BPR_STEP),
    "chunk_delta": ("step", TOL_BPR_STEP),
    "triplet_loss": ("table", TOL_K10),
    "deferred_update": ("table", TOL_K10),
    "capped_add": ("table", TOL_K10),
    "warp_search": ("table", TOL_WARP_W),
    "warp_violations": ("table", 0.0),
    "warp_accumulate": ("step", TOL_WARP_STEP),
    "dim_sweep": ("table", TOL_EALS),
    "eals_residual": ("table", (TOL_VHAT, TOL_EALS_SUM)),
    "plsi_estep": ("table", TOL_K15),
    "plsi_mstep": ("table", TOL_K16),
    "cfr_normal_equations": ("table", TOL_K17),
    "cfr_bias": ("table", TOL_K18),
    "pair_step": ("table", TOL_W2V),
    "row_apply": ("step", TOL_W2V),
    "stream_chunk_deltas": ("table", TOL_W2V),
}
# K9's delta entry point returns a handle for its second launch (on the
# card the workspace, in the plain version the chunk's terms): its deltas
# are compared, not its result
WIDE_OPAQUE_RESULT = ("chunk_delta",)


def tree_map(torch, x, fn, memo=None):
    """``x`` (tuples, named tuples, lists and dicts of tensors) with every
    tensor replaced by ``fn(tensor)``; a tensor met twice maps to one
    result, so aliases stay aliases."""
    memo = {} if memo is None else memo
    if isinstance(x, torch.Tensor):
        if id(x) not in memo:
            memo[id(x)] = fn(x)
        return memo[id(x)]
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(tree_map(torch, v, fn, memo) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(tree_map(torch, v, fn, memo) for v in x)
    if isinstance(x, dict):
        return {k: tree_map(torch, v, fn, memo) for k, v in x.items()}
    return x


def leaves(torch, x):
    """The tensors of ``x`` in ``tree_map``'s order."""
    out = []
    tree_map(torch, x, lambda t: out.append(t) or t, memo={})
    return out


class Swapped:
    """While open, each of ``kernels`` (kernel wrappers) is replaced by
    ``self._wrap(fn)`` in every module of the port that holds it, its
    launch counts carried over both ways: read them after it closes."""

    def __init__(self, torch, kernels):
        self.torch, self.kernels, self.calls = torch, kernels, {}

    def __enter__(self):
        self.patched = []
        for fn in self.kernels:
            w = self._wrap(fn)
            w.__dict__.update(fn.__dict__)  # launches, device_launches
            for mod in list(sys.modules.values()):
                if getattr(mod, "__name__", "").startswith(
                        "buffalo_tpu_torch") and \
                        getattr(mod, fn.__name__, None) is fn:
                    setattr(mod, fn.__name__, w)
                    self.patched.append((mod, fn, w))
        return self

    def __exit__(self, *exc):
        for mod, fn, w in self.patched:
            setattr(mod, fn.__name__, fn)
            # the wrapper's own count statements name it in its module
            fn.__dict__.update(w.__dict__)
        return False


class FirstCalls(Swapped):
    """While open, each of ``kernels`` records its first call that changes
    something (W2V's first K20 call adds a zero delta: L1 starts at 0):
    copies of its inputs on the card just before it, and of its inputs and
    result just after."""

    def _wrap(self, fn):
        torch, calls, name = self.torch, self.calls, fn.__name__

        def wrapped(*args, **kwargs):
            if name in calls:
                return fn(*args, **kwargs)
            pre = tree_map(torch, (args, kwargs), lambda t: t.clone())
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            changed = leaves(torch, out) or not all(
                torch.equal(a, b) for a, b in zip(
                    leaves(torch, pre), leaves(torch, (args, kwargs))))
            if changed:
                calls[name] = (pre, tree_map(torch, (args, kwargs, out),
                                             lambda t: t.clone()))
            return out

        return wrapped


class EveryCall(Swapped):
    """While open, each of ``kernels`` records ``keep(args, kwargs,
    result)`` of every call, in call order (no copies, no syncs)."""

    def __init__(self, torch, kernels, keep):
        super().__init__(torch, kernels)
        self.keep = keep

    def _wrap(self, fn):
        log, keep = self.calls.setdefault(fn.__name__, []), self.keep

        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            log.append(keep(args, kwargs, out))
            return out

        return wrapped


def n_distinct(torch, *ids):
    """The number of distinct ids among the given int tensors."""
    return int(torch.unique(torch.cat([t.reshape(-1).long()
                                       for t in ids])).numel())


def live_cols(torch, side):
    """The real entries' ids of a batch or side: per row (``lens``) or
    per chunk (``chunk_lens``)."""
    cols = side.cols
    lens = getattr(side, "chunk_lens", None)
    if lens is None or getattr(side, "chunk_ptr", None) is None:
        lens = side.lens
    L = cols.shape[1]
    return cols[torch.arange(L, device=cols.device)[None, :]
                < lens[:, None]]


def wide_work(torch, name, a, r, d):
    """(bytes, operations, peak operations per second) of kernel ``name``'s
    function on its recorded call: ``a`` the call's arguments by name, ``r``
    its result.  Each id and value read once, each distinct gathered row
    read once, each output written once; the operations of the function
    (K11's scores are float64, the rest float32)."""
    fp32, fp64 = PEAK_FP32_S, PEAK_FP64_S
    if name == "als_normal_equations":
        lens = a["lens"]
        side = types.SimpleNamespace(cols=a["cols"], lens=lens,
                                     chunk_lens=a["chunk_lens"],
                                     chunk_ptr=a["chunk_ptr"])
        R_ = lens.shape[0]
        return k2_work(live_cols(torch, side), int((lens > 0).sum()), R_, d,
                       a["item_axis"], 4 * R_) + (fp32,)
    if name == "batched_cg_dense":
        lens = a["lens"]
        R_, real = lens.shape[0], int((lens > 0).sum())
        return (4 * R_ * d * d + 4 * R_ * d + 8 * real * d + 4 * R_,
                real * (1 + a["cg_iters"]) * 2 * d * d, fp32)
    if name == "ialspp_solve_batch":
        b = types.SimpleNamespace(cols=a["cols"], lens=a["lens"])
        return ialspp_work(b, a["vals"], d, a["block_size"],
                           a["item_axis"])[2:] + (fp32,)
    if name == "score_topk":
        return k5_work(a["p"].shape[0], a["Q"].shape[0], d, a["k"],
                       a["Qb"] is not None) + (fp32,)
    if name == "ivf_tile_topk":
        qmask, ln = a["qmask"], a["ln"]
        pairs = int((qmask.sum(1).long() * ln.long()).sum())
        n = a["qidx"].numel()
        return (4 * d * (int(ln.sum()) + n_distinct(torch, a["qidx"][qmask]))
                + 8 * n + 8 * n * a["kk"], 2 * d * pairs, fp32)
    if name == "kmeans_update":
        (N, D_), C = a["unit"].shape, a["cent"].shape[0]
        return (*k7_work(N, D_, C), fp32)
    if name == "sharded_topk_merge":
        B, D_, kl = a["vals"].shape
        return (k22_bytes(torch, r[1], D_, kl, a["items_per_shard"])[0], 0,
                fp32)
    if name in ("chunk_update", "chunk_accumulate", "chunk_delta",
                "triplet_loss"):
        users, pos, neg = a["users"], a["positives"], a["negatives"]
        I = a["Q"].shape[0]
        ok = neg[neg < I]
        n_u, n_i = n_distinct(torch, users), n_distinct(torch, pos, ok)
        B, N = neg.shape[0], users.shape[0]
        if name == "chunk_update":
            return k9_work(users, pos, neg, d, I) + (fp32,)
        if name == "triplet_loss":
            return (12 * N + 4 * d * (n_u + n_i) + 4 * n_i, 3 * d * N + N,
                    fp32)
        # the touched rows read, their accumulator or delta rows read and
        # written (the counts too when accumulating)
        extra = 8 * (n_u + n_i) if name == "chunk_accumulate" else 0
        return (8 * N + 4 * B + (4 + 8) * d * (n_u + n_i) + (4 + 8) * n_i
                + extra, 8 * d * B + 2 * d * N + 2 * d * (n_u + n_i), fp32)
    if name == "deferred_update":
        # param, grad (zeroed), v (and adam's m), each read and written
        n = a["param"].numel()
        words = 3 if a["optimizer"] == "adagrad" else 4
        return (8 * words * n + 4 * a["param"].shape[0],
                14 * n + (3 * n if a["project"] else 0), fp32)
    if name == "capped_add":
        n = a["param"].numel()
        return 12 * n, 5 * n, fp32
    if name in ("warp_search", "warp_violations"):
        users, pos = a["users"], a["positives"]
        neg = r[0] if name == "warp_search" else a["negatives"]
        N, n_u = users.shape[0], n_distinct(torch, users)
        n_i = n_distinct(torch, pos, neg)
        if name == "warp_violations":
            return 12 * N + 4 * d * (n_u + n_i), 6 * d * N, fp64
        K_ = a["num_candidates"]
        return (N * (8 + 16 + 13 + 4) + 4 * d * (n_u + n_i),
                2 * d * N * (K_ + 1), fp64)
    if name == "warp_accumulate":
        users, any_v = a["users"], a["any_v"]
        n = int(any_v[:a["n_valid"]].sum())
        n_u = n_distinct(torch, users)
        n_i = n_distinct(torch, a["positives"], a["negatives"])
        return 13 * users.shape[0] + 12 * d * (n_u + n_i), 10 * d * n, fp32
    if name == "dim_sweep":
        b = a["batch"]
        check(type(b).__name__ == "RangeBatch", f"K13's first call at d = "
              f"{d} took a {type(b).__name__}, not a range batch")
        return k13_work(b, d, a["item_axis"]) + (fp32,)
    if name == "eals_residual":
        return k14_work(torch, a["row_ids"], a["keys"], d,
                        a.get("sums", True),
                        a.get("vhat") is not None) + (fp32,)
    if name == "plsi_estep":
        b = a["batch"]
        cols = live_cols(torch, b)
        n, R_ = int(cols.numel()), b.lens.shape[0]
        return (8 * n + 4 * d * n_distinct(torch, cols) + 12 * R_ * d,
                4 * d * n, fp32)
    if name == "plsi_mstep":
        Pn, Qn = a["Pn"], a["Qn"]
        return (4 * (2 * (Pn.numel() + Qn.numel()) + Pn.shape[0]
                     + Qn.shape[0]), 3 * (Pn.numel() + Qn.numel()), fp32)
    if name == "cfr_normal_equations":
        n, fixed = 0, []
        for side in (a["implicit"], a["explicit"]):
            if side is not None:
                c = live_cols(torch, side)
                n += int(c.numel())
                fixed.append(c)
        R_ = a["rows"].shape[0]
        return (8 * n + 4 * d * n_distinct(torch, *fixed)
                + 4 * R_ * d * (d + 2) + 4 * d * d,
                n * (d * (d + 1) + 4 * d), fp32)
    if name == "cfr_bias":
        rows, side = a["rows"], a["explicit"]
        if side is None:  # the loss term alone: each row's |x|^2
            return (4 * d * rows.shape[0] + 8 * rows.shape[0],
                    2 * d * rows.shape[0], fp32)
        c = live_cols(torch, side)
        n = int(c.numel())
        return (8 * n + 4 * d * (rows.shape[0] + n_distinct(torch, c)),
                2 * d * n, fp32)
    if name == "pair_step":
        B, K_ = a["inputs"].shape[0], a["num_negatives"]
        n_rows = (n_distinct(torch, a["inputs"])
                  + n_distinct(torch, a["targets"], r[0]))
        return (8 * B + 4 * d * n_rows + 4 * d * B * (K_ + 2),
                B * (K_ + 1) * 6 * d, fp32)
    if name == "row_apply":
        parts = a["parts"]
        n = sum(int(p[0].numel()) for p in parts)
        rows = n_distinct(torch, *[p[0] for p in parts])
        return 4 * n + 4 * d * n + 8 * d * rows, 2 * d * n, fp32
    if name == "stream_chunk_deltas":
        wc, negs = a["wc"], a["negs"]
        T_ = wc.shape[0]
        rows = n_distinct(torch, wc, negs)
        return (9 * T_ + 8 * d * rows + 4 * d * (2 * T_ + negs.numel()),
                2 * d * T_ * a["window"] * 2 * (negs.shape[1] + 1), fp32)
    raise KeyError(name)


def hold_first_call(torch, fn, call, d, **extra):
    """Kernel wrapper ``fn``'s recorded first call (``FirstCalls``) held to
    its plain version by ``WIDE_RULES``: the plain version runs on host
    copies of the call's inputs (the wrapper's CPU route), and for a solve
    also in float64.  A float tensor past its tolerance passes only by the
    noise floor (the plain version's float64 run: the kernel no further
    from it than NOISE_FACTOR times the plain float32 run, plus the
    tolerance), recorded in ``noise_floor``.  Then the wrapper timed on
    copies of those inputs on the card, and the bound from them
    (``wide_work``; ``extra`` adds arguments the bound needs).  Returns the
    readings."""
    import inspect

    name = fn.__name__
    rule, tol = WIDE_RULES[name]
    tols = tol if isinstance(tol, tuple) else (tol,)
    pre, post = call

    def host(dtype=None):
        def to(t):
            t = t.detach().to("cpu", copy=True)
            return t.to(dtype) if dtype is not None and \
                t.is_floating_point() else t
        return tree_map(torch, pre, to)

    def plain(dtype=None, **over):
        args, kwargs = host(dtype)
        kwargs = dict(kwargs, **over)
        return args, kwargs, fn(*args, **kwargs)

    st = time.perf_counter()
    ref = plain()
    plain_host_ms = 1e3 * (time.perf_counter() - st)
    ref64 = plain(torch.float64) if rule == "solve" else None

    def witness():
        nonlocal ref64
        if ref64 is None:
            ref64 = plain(torch.float64)
        return ref64

    # K20's steps are held to the largest step before the cap
    uncapped = plain(cap=0.0) if name == "row_apply" else None

    a0 = [t.cpu() for t in leaves(torch, pre)]
    ak = [t.cpu() for t in leaves(torch, post[:2])]
    ap = leaves(torch, ref[:2])
    check(len(a0) == len(ak) == len(ap), f"{name}: the plain run's inputs "
          "differ in structure from the kernel's")
    err = 0.0
    compared, floors = [], {}

    def held(got, want, limit, what, where):
        nonlocal err
        if not got.is_floating_point() or limit == 0.0:
            ok = torch.equal(got, want)
            e = 0.0 if ok else float("inf")
            fields = {}
        else:
            e = float((got.double() - want.double()).abs().max()) \
                if got.numel() else 0.0
            ok, fields = e <= limit, {}
            if not ok:  # the noise floor: the float64 run as the witness
                w = where(witness())
                e64 = float((got.double() - w).abs().max())
                floor = float((want.double() - w).abs().max())
                ok = e64 <= NOISE_FACTOR * floor + limit
                fields = dict(max_abs_err=e, limit=limit, err_vs_f64=e64,
                              plain_err_vs_f64=floor)
                floors[what] = fields
        check(ok, f"{name} at d = {d}: {what} is {e:.3g} from the plain "
              f"version's (limit {limit:.3g}) {fields}")
        err = max(err, e)
        compared.append(what)

    def amax(t):
        return float(t.double().abs().max()) if t.numel() else 0.0

    for i, (b, k, p) in enumerate(zip(a0, ak, ap)):
        if torch.equal(k, b) and torch.equal(p, b):
            continue  # an input the call did not change
        what = f"input {i} {tuple(k.shape)}"
        def where(r, i=i):
            return leaves(torch, r[:2])[i].double()

        if not k.is_floating_point():
            held(k, p, 0.0, what, where)
        elif rule == "solve":
            p64 = leaves(torch, ref64[:2])[i]
            if k.dim() == 2:  # the rows the solve wrote
                rows = (k != b).any(1) | (p != b).any(1)
                k, p, p64 = k[rows], p[rows], p64[rows]
            ok, fields = noise_floor_check(k, p, p64)
            check(ok, f"{name} at d = {d}: {what} off the CG rule: {fields}")
            err = max(err, fields["max_abs_err"])
            compared.append(what)
        elif rule == "step":
            top = p if uncapped is None else leaves(torch, uncapped[:2])[i]
            held(k, p, tols[0] * amax(top - b)
                 + 2 * float(np.finfo(np.float32).eps) * amax(b), what,
                 where)
        else:
            held(k, p, tols[0] * amax(p), what, where)
    ok_, op = leaves(torch, post[2]), leaves(torch, ref[2])
    if name in WIDE_OPAQUE_RESULT:
        ok_, op = [], []
    check(len(ok_) == len(op), f"{name}: the plain run's result differs in "
          "structure from the kernel's")
    if rule == "topk":
        e, ties = kernel_topk_check(tuple(t.cpu() for t in ok_[:2]),
                                    tuple(op[:2]), f"{name} at d = {d}")
        err = max(err, e)
        compared.append("scores and ids")
    else:
        for j, (k, p) in enumerate(zip(ok_, op)):
            held(k.cpu(), p, tols[min(j, len(tols) - 1)] * amax(p)
                 if p.is_floating_point() else 0.0,
                 f"output {j} {tuple(k.shape)}",
                 lambda r, j=j: leaves(torch, r[2])[j].double())
    check(bool(compared), f"{name} at d = {d}: the call changed nothing")

    args, kwargs = tree_map(torch, pre, lambda t: t.clone())
    bound = inspect.signature(fn).bind(*args, **kwargs)
    bound.apply_defaults()
    nbytes, ops, peak = wide_work(torch, name, dict(bound.arguments,
                                                    **extra), post[2], d)
    t_b, t_o = nbytes / PEAK_BYTES_S, ops / peak
    out = dict(ms=time_ms(lambda: fn(*args, **kwargs), reps=10, warmup=2),
               plain_host_ms=plain_host_ms, bound_ms=1e3 * max(t_b, t_o),
               bound_by="bytes" if t_b >= t_o else "operations",
               max_abs_err=err, compared=compared, noise_floor=floors,
               bytes=nbytes, operations=ops)
    del args, kwargs, bound, ref, ref64, uncapped
    torch.cuda.synchronize()
    return out


def small_corpus(path, lines, vocab, tokens):
    """A stream file shaped as ``brunch_corpus`` at a smaller scale."""
    rng = np.random.default_rng(11)
    pop = 1.0 / np.arange(1, vocab + 1) ** 0.8
    pop /= pop.sum()
    lens = np.maximum(1, rng.poisson(tokens / lines, lines))
    items = rng.choice(vocab, size=int(lens.sum()), p=pop)
    with open(path, "w") as fh:
        pos = 0
        for n in lens:
            fh.write(" ".join(map(str, items[pos:pos + n])) + "\n")
            pos += n


def wide_rows(bt, torch, dev):
    """Rows of WIDE_D floats through the user's entry points, each model
    WIDE_EPOCHS epochs (ALS, BPR-MF sgd and adagrad and on a 2-shard mesh,
    WARP, eALS and pLSI on the SMALL_* synthetic; CoFactor and W2V, device
    and host pairs, on a WIDE_LINES-line stream corpus): finite losses that
    fall, and every kernel of the model's path launched.  The first call
    of each widened kernel on these paths is recorded and held to its plain
    version (``hold_first_call``), timed, and bounded from its inputs.  Then
    an IVF index of WIDE_CELLS cells (K7 past its old cell cap; K6 on its
    search), and on the trained ALS tables top-k (K5) and sharded top-k
    over WIDE_SHARDS shards (K22 past its old shard cap)."""
    from buffalo_tpu_torch.data.mm import MatrixMarket, MatrixMarketOptions
    from buffalo_tpu_torch.ops import als_kernels as K
    from buffalo_tpu_torch.ops import cfr_kernels as CK
    from buffalo_tpu_torch.ops import eals_kernels as E
    from buffalo_tpu_torch.ops import plsi_kernels as PK
    from buffalo_tpu_torch.ops import retrieval_kernels as R
    from buffalo_tpu_torch.ops import sgd_kernels as S
    from buffalo_tpu_torch.ops import topk as T
    from buffalo_tpu_torch.ops import w2v_kernels as W2
    from buffalo_tpu_torch.ops import warp_kernels as W
    from buffalo_tpu_torch.parallel.ann import IVFIndex

    d = WIDE_D
    groups, _ = synth_ml20m(SMALL_USERS, SMALL_ITEMS, SMALL_NNZ, seed=5)
    path = os.path.join(WORK, "wide.bfo")
    write_compiled(groups, SMALL_USERS, SMALL_ITEMS, path, num_vali=500,
                   seed=2)
    del groups
    dopt = MatrixMarketOptions().get_default_option()
    dopt.data.tmp_dir = os.path.join(WORK, "tmp")
    dopt.data.path = path
    data = MatrixMarket(dopt)
    data.open(path)
    corpus = os.path.join(WORK, "wide.txt")
    small_corpus(corpus, WIDE_LINES, WIDE_VOCAB, WIDE_TOKENS)
    streams = {}
    for kind in ("matrix", "stream"):
        sopt = bt.StreamOptions().get_default_option()
        sopt.input.main = corpus
        sopt.data.path = os.path.join(WORK, f"wide_{kind}.bfo")
        sopt.data.tmp_dir = os.path.join(WORK, "tmp")
        sopt.data.internal_data_type = kind
        sopt.data.validation = {}
        if kind == "matrix":
            sopt.data.sppmi = {"windows": 5, "k": 10}
        streams[kind] = bt.data.load(sopt)
        streams[kind].create()

    kernels, runs, als = {}, {}, None
    mesh2 = dict(num_devices=2, devices=[str(dev)] * 2, use_bias=True)
    # (run, class, options, data, options set, the kernels of its path that
    # must launch, the widened kernels whose first call is held)
    models = (
        ("ALS", bt.ALS, bt.ALSOption, data, {}, K.KERNELS,
         ("ialspp_solve_batch", "als_normal_equations", "batched_cg_dense"),
         (K.ialspp_solve_batch, K.als_normal_equations,
          K.batched_cg_dense)),
        ("BPRMF", bt.BPRMF, bt.BPRMFOption, data, {}, S.KERNELS,
         ("sample_negatives", "chunk_update", "triplet_loss"),
         (S.chunk_update, S.triplet_loss)),
        ("BPRMF adagrad", bt.BPRMF, bt.BPRMFOption, data,
         dict(optimizer="adagrad"), S.KERNELS,
         ("sample_negatives", "chunk_accumulate", "deferred_update"),
         (S.chunk_accumulate, S.deferred_update)),
        ("BPRMF sgd mesh", bt.BPRMF, bt.BPRMFOption, data, mesh2, S.KERNELS,
         ("sample_negatives", "chunk_delta", "chunk_bias_neg_delta",
          "capped_add"), (S.chunk_delta, S.capped_add)),
        ("WARP", bt.WARP, bt.WARPOption, data, {},
         W.KERNELS + (S.deferred_update,),
         ("warp_search", "warp_accumulate", "deferred_update"),
         (W.warp_search, W.warp_accumulate, W.warp_violations,
          S.deferred_update)),
        ("EALS", bt.EALS, bt.EALSOption, data, {}, E.KERNELS,
         ("dim_sweep", "eals_residual"), (E.dim_sweep, E.eals_residual)),
        ("PLSI", bt.PLSI, bt.PLSIOption, data, {}, PK.KERNELS,
         ("plsi_estep", "plsi_mstep"), (PK.plsi_estep, PK.plsi_mstep)),
        ("CFR", bt.CFR, bt.CFROption, streams["matrix"], {},
         CK.KERNELS + (K.batched_cg_dense,),
         ("cfr_normal_equations", "cfr_bias", "batched_cg_dense"),
         (CK.cfr_normal_equations, CK.cfr_bias, K.batched_cg_dense)),
        ("W2V", bt.W2V, bt.W2VOption, streams["stream"],
         dict(min_count=2, pair_gen="device"),
         W2.KERNELS + (S.sample_negatives,),
         ("stream_chunk_deltas", "row_apply", "sample_negatives"),
         (W2.stream_chunk_deltas, W2.row_apply)),
        ("W2V host pairs", bt.W2V, bt.W2VOption, streams["stream"],
         dict(min_count=2, pair_gen="host"), W2.KERNELS,
         ("pair_step", "row_apply"), (W2.pair_step,)),
    )
    for run, cls, options, mdata, extra, kset, need, held in models:
        opt = options().get_default_option()
        opt.update(d=d, num_iters=WIDE_EPOCHS, device="cuda", validation={},
                   **extra)
        if cls is bt.ALS:  # ALS reports its loss to the callback
            opt.update(validation={"topk": TOPK}, evaluation_period=1)
        model = cls(opt, data=mdata)
        np.random.seed(0)
        model.initialize()
        torch.cuda.synchronize()
        reset_counts(kset)
        seen = []
        with FirstCalls(torch, held) as rec:
            model.train(training_callback=lambda i, m: seen.append(
                m["train_loss"]))
        launches = read_counts(kset)
        losses = [float(x) for x in getattr(model, "iteration_losses",
                                            seen)]
        check(len(losses) == WIDE_EPOCHS and np.isfinite(losses).all()
              and losses[-1] < losses[0],
              f"{run} at d = {d}: losses {losses}")
        check(all(launches[k] > 0 for k in need),
              f"{run} at d = {d} launched {launches}")
        held_here = {}
        for fn in held:
            if fn.__name__ in rec.calls:
                held_here[fn.__name__] = hold_first_call(
                    torch, fn, rec.calls[fn.__name__], d)
        check(all(n in held_here for n in need if n in
                  {f.__name__ for f in held}),
              f"{run} at d = {d}: no first call of {need} recorded")
        for kname, reading in held_here.items():
            # a kernel held on two paths (K10's adagrad and projection
            # modes, K3 in ALS and CoFactor) keeps both readings
            kernels[kname if kname not in kernels
                    else f"{kname} ({run})"] = dict(reading, run=run)
        runs[run] = dict(train_loss=losses,
                         epoch_seconds=model.iteration_times,
                         launches=launches, held=sorted(held_here))
        del rec
        if cls is bt.ALS:
            als = model
        else:
            del model
        torch.cuda.empty_cache()

    # retrieval at d = WIDE_D: an IVF index past K7's old cell cap, its
    # search (K6), and sharded top-k past K22's old shard cap
    rng = np.random.default_rng(31)
    table = rng.standard_normal((WIDE_IVF_ROWS, d), dtype=np.float32)
    queries = rng.standard_normal((WIDE_IVF_QUERIES, d), dtype=np.float32)
    with FirstCalls(torch, (R.kmeans_update, R.ivf_tile_topk)) as rec:
        index = IVFIndex.build(table, n_clusters=WIDE_CELLS,
                               n_iters=WIDE_IVF_ITERS, spill=1,
                               device="cuda")
        ids, _ = index.search(queries, TOPK)
    cells = rec.calls["kmeans_update"][0][0][2].shape[0]
    check(cells == WIDE_CELLS > 58_112, f"K7 ran on {cells} cells")
    check(ids.shape == (WIDE_IVF_QUERIES, TOPK) and (ids >= 0).all(),
          "the wide IVF search returned no full top-k")
    for fn in (R.kmeans_update, R.ivf_tile_topk):
        kernels[fn.__name__] = dict(hold_first_call(
            torch, fn, rec.calls[fn.__name__], d), run="IVF")
    # K7's global-counter form on the card: its first call again, against
    # its plain version there, repeatable, its launches
    kernels["kmeans_update"]["k7_entry"] = k7_entry(
        R, torch, *rec.calls["kmeans_update"][0][0])
    del index, rec, table
    mesh = bt.parallelism.get_mesh(WIDE_SHARDS,
                                   devices=[str(dev)] * WIDE_SHARDS)
    P, Q = als.P[:WIDE_IVF_QUERIES], als.Q
    with FirstCalls(torch, (R.sharded_topk_merge,)) as rec:
        got = T.batch_topn_sharded(P, Q, TOPK, mesh)
    with FirstCalls(torch, (R.score_topk,)) as rec5:
        want = T.batch_topn(P, Q, TOPK, device="cuda")
    same_topk(got, want, f"sharded top-k over {WIDE_SHARDS} shards at d = "
              f"{d}")
    kernels["score_topk"] = dict(hold_first_call(
        torch, R.score_topk, rec5.calls["score_topk"], d), run="top-k")
    kernels["sharded_topk_merge"] = dict(hold_first_call(
        torch, R.sharded_topk_merge, rec.calls["sharded_topk_merge"], d,
        items_per_shard=-(-Q.shape[0] // WIDE_SHARDS)), run="sharded top-k",
        shards=WIDE_SHARDS)
    del als, rec, rec5, mesh
    torch.cuda.empty_cache()
    phase("wide_rows", d=d, kernels=kernels, models=runs,
          epochs=WIDE_EPOCHS, ivf=dict(rows=WIDE_IVF_ROWS, cells=WIDE_CELLS,
                                       lloyd_iterations=WIDE_IVF_ITERS,
                                       queries=WIDE_IVF_QUERIES),
          sharded_topk_shards=WIDE_SHARDS,
          data=dict(users=SMALL_USERS, items=SMALL_ITEMS, nnz=SMALL_NNZ,
                    corpus_lines=WIDE_LINES, corpus_vocab=WIDE_VOCAB))
    return kernels


def main() -> int:
    global _START
    _START = time.perf_counter()
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
    from buffalo_tpu_torch.ops import retrieval_kernels as R
    from buffalo_tpu_torch.ops import cfr_kernels as CK
    from buffalo_tpu_torch.ops import eals_kernels as E
    from buffalo_tpu_torch.ops import plsi_kernels as PK
    from buffalo_tpu_torch.ops import sgd_kernels as S
    from buffalo_tpu_torch.ops import w2v_kernels as W2
    from buffalo_tpu_torch.ops import warp_kernels as W

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

    narrow = (K.als_cg_matrix_free, K.als_normal_equations,
              K.batched_cg_dense)
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
        entries, bf16_ms = kernel_phase(torch, K, P, Q, row_b, col_b, row_s,
                                        col_s, ML20M_USERS, ML20M_ITEMS)
        # the gramian's bound, both halves: 2 n d^2 operations and the
        # table's n d floats read (its d x d output is negligible)
        gram_bound = sum(bound_ms(4 * len(t) * D, 2 * len(t) * D * D)[0]
                         for t in (P, Q))
        phase("epoch_profile", **profile_epoch(torch, K, P, Q, row_s, col_s,
                                               kw),
              gramian_bound_ms=gram_bound)
        del P, Q, row_s, col_s, row_b, col_b
        torch.cuda.empty_cache()

        # ---- path: the user's entry points at ML-20M width, d = D
        als, epochs, launches, peak_mb, train_s = train_path(
            bt, K, torch, data, als_opt(bt, d=D, num_iters=4,
                                        validation={"topk": 10}))
        path_launches = launches
        losses = check_training(als, epochs, launches, narrow, 4, D)
        trained = (als.P, als.Q)
        topk_ms, same, topk_k5 = topk_check(als, R)
        phase("path", epochs=len(losses), train_loss=losses,
              val_ndcg=[m.get("val_ndcg") for m in epochs],
              epoch_seconds=als.iteration_times,
              median_epoch_seconds_2_4=float(np.median(
                  als.iteration_times[1:])),
              train_seconds=train_s, launches=launches,
              launches_per_epoch=per_epoch(launches, len(losses)),
              max_memory_allocated_mb=peak_mb, topk_users=1000, topk_k=10,
              topk_ms=topk_ms, topk_same_as_numpy=same,
              topk_k5_launches=topk_k5,
              # scores for every user and item, and the item table read
              topk_bound_ms=bound_ms(4 * ML20M_ITEMS * D,
                                     2 * 1000 * ML20M_ITEMS * D)[0])

        # ---- retrieval path: the trained model through ParALS + IVF
        retrieval_path(bt, R, torch, als)
        del als

        # ---- bf16 path: the same run on bfloat16 values
        als, epochs, launches, peak_mb, train_s = train_path(
            bt, K, torch, data, als_opt(bt, d=D, num_iters=4,
                                        validation={"topk": 10},
                                        vals_dtype="bfloat16"))
        losses16 = check_training(als, epochs, launches, narrow, 4, D)
        diff = abs(losses16[-1] - losses[-1])
        check(diff <= TOL_BF16_LOSS, f"bfloat16 values end {diff:.3g} from "
              f"the float32 run's loss: {losses16} vs {losses}")
        phase("bf16_path", epochs=4, train_loss=losses16,
              float32_train_loss=losses, final_loss_diff=diff,
              tol=TOL_BF16_LOSS, epoch_seconds=als.iteration_times,
              median_epoch_seconds_2_4=float(np.median(
                  als.iteration_times[1:])),
              launches_per_epoch=per_epoch(launches, 4),
              max_memory_allocated_mb=peak_mb, device_ms=bf16_ms)
        del als

        # ---- scatter and streaming paths against the range layout
        layout_paths(bt, K, torch, data, dev, trained)

        # ---- the device mesh: MESH_SHARDS shards on this card (ALS's
        # mesh modes, a 1-rank NCCL group, eALS, pLSI), then sharded
        # serving through K22
        mesh_run, refs = mesh_als(bt, K, torch, data, trained)
        mesh_nccl(bt, K, torch, data, trained, mesh_run, refs)
        del mesh_run, refs
        mesh_eals(bt, E, torch, data)
        mesh_plsi(bt, PK, torch, data)
        torch.cuda.empty_cache()
        k22_entry, k22_launches = sharded_topk(bt, R, torch, trained)
        del trained
        torch.cuda.empty_cache()

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
        torch.cuda.empty_cache()

        # ---- iALS++: K4 (and K2, K3) at d = D_WIDE on the ML-20M layout,
        # then the user's entry points at that width
        entries["ialspp_solve_batch"] = wide_kernel_phase(torch, K, data,
                                                          dev)
        torch.cuda.empty_cache()
        als, epochs, launches, peak_mb, train_s = train_path(
            bt, K, torch, data, als_opt(bt, d=D_WIDE, num_iters=4,
                                        validation={"topk": 10}))
        check(als._optimizer == "ialspp" and int(als.opt.block_size) == D_WIDE,
              f"d = {D_WIDE} trained {als._optimizer} with block "
              f"{als.opt.block_size}")
        losses_w = check_training(
            als, epochs, launches,
            (K.ialspp_solve_batch, K.als_normal_equations, K.batched_cg_dense),
            4, D_WIDE)
        path_launches["ialspp_solve_batch"] = launches["ialspp_solve_batch"]
        topk_ms, same, topk_k5 = topk_check(als, R)
        phase("ialspp_path", d=D_WIDE, optimizer=als._optimizer,
              block_size=int(als.opt.block_size), epochs=len(losses_w),
              train_loss=losses_w,
              val_ndcg=[m.get("val_ndcg") for m in epochs],
              epoch_seconds=als.iteration_times,
              median_epoch_seconds_2_4=float(np.median(
                  als.iteration_times[1:])),
              train_seconds=train_s, launches=launches,
              launches_per_epoch=per_epoch(launches, len(losses_w)),
              max_memory_allocated_mb=peak_mb, topk_ms=topk_ms,
              topk_same_as_numpy=same, topk_k5_launches=topk_k5)
        del als
        torch.cuda.empty_cache()

        # ---- BPR: the user's entry points on the ML-20M data (sgd, then
        # adagrad, adam and a streamed epoch), then K8-K10 on its chunks
        bpr, bpr_launches = bpr_path(bt, S, R, torch, data)
        entries.update(bpr_kernels(S, torch, bpr))
        path_launches.update(bpr_launches)
        del bpr
        torch.cuda.empty_cache()

        # ---- WARP: the user's entry points on the ML-20M data (the
        # defaults, then its variants), then K11, K12 and K10's projection
        warp, warp_launches = warp_path(bt, W, S, R, torch, data)
        entries.update(warp_kernels(W, S, torch, warp))
        path_launches["deferred_update"] += warp_launches.pop(
            "deferred_update")
        path_launches.update(warp_launches)
        del warp
        torch.cuda.empty_cache()

        # ---- the dp mesh of BPR-MF and WARP: MESH_SHARDS shards on this
        # card against one device, and the new entry points of K8-K11 on
        # a shard's inputs
        mesh_entries, mesh_launches = mesh_bpr(bt, S, torch, data)
        entries.update(mesh_entries)
        path_launches.update(mesh_launches)
        mesh_warp(bt, W, S, torch, data)

        # ---- eALS: the user's entry points at d = D, then K13 and K14 on
        # its layout; then top-k past K5's k limit on its tables
        eals, eals_state, eals_launches = eals_path(bt, E, R, torch, data)
        path_launches.update(eals_launches)
        entries.update(eals_kernels(E, torch, eals, eals_state))
        topk_past_1024(R, torch, eals)
        del eals, eals_state
        torch.cuda.empty_cache()

        # ---- pLSI: the user's entry points on the ML-20M data (the range
        # layout, then the other epoch routes), then K15 and K16 on its
        # layout
        plsi, plsi_state, plsi_launches, k15_epoch = plsi_path(
            bt, PK, R, torch, data)
        path_launches.update(plsi_launches)
        plsi_variants(bt, PK, torch, data, plsi)
        entries.update(plsi_kernels(PK, torch, plsi, plsi_state, k15_epoch))
        del plsi, plsi_state, data
        torch.cuda.empty_cache()

        # ---- Stream + CoFactor: the brunch-shaped corpus built with its
        # SPPMI group, CFR's entry points on it, then K17 and K18 on its
        # batches
        brunch = stream_build(bt, torch)
        cfr, cfr_launches, cfr_staged, k18_epoch = cfr_path(bt, CK, K, R,
                                                            torch, brunch)
        path_launches.update(cfr_launches)
        entries.update(cfr_kernels(CK, K, torch, cfr, cfr_staged, k18_epoch))
        del cfr, cfr_staged
        torch.cuda.empty_cache()
        # ---- CoFactor's dp mesh on the same data: MESH_SHARDS shards on
        # this card against one device, K17 / K3 / K18 on a shard's slice
        # with sentinel rows
        mesh_cfr(bt, CK, K, torch, brunch)
        del brunch
        torch.cuda.empty_cache()

        # ---- W2V: the brunch corpus as a token stream, W2V's main path
        # (the device epoch: K8, K21, K20) and ParW2V, K19-K21 against their
        # plain versions, the host-pair epochs (K19, K20), the quality gate
        w2v_data, w2v_build_s = w2v_build(bt)
        w2v, w2v_launches, w2v_arrays = w2v_path(bt, W2, S, R, torch,
                                                 w2v_data, w2v_build_s)
        entries.update(w2v_kernels(W2, S, torch, w2v, w2v_arrays))
        del w2v, w2v_arrays
        torch.cuda.empty_cache()
        host_launches, k19_epoch = w2v_variants(bt, W2, S, torch, w2v_data)
        entries["pair_step"].update(k19_epoch)
        path_launches["sample_negatives"] += w2v_launches["sample_negatives"]
        path_launches.update(
            row_apply=w2v_launches["row_apply"],
            stream_chunk_deltas=w2v_launches["stream_chunk_deltas"],
            pair_step=host_launches["pair_step"])
        w2v_quality(bt, W2, torch)
        # ---- W2V's dp mesh on the same corpus (the stream epoch, then the
        # host pairs) against one device, and the new entry points (K19 at
        # a slot offset, K20 on the union of the shards' rows)
        w2v_mesh_entries, w2v_mesh_launches = mesh_w2v(bt, W2, S, torch,
                                                       w2v_data)
        entries.update(w2v_mesh_entries)
        path_launches.update(w2v_mesh_launches)
        del w2v_data
        torch.cuda.empty_cache()

        # ---- rows of WIDE_D floats: every widened kernel against its plain
        # version, then each model's entry points at that width
        wide_rows(bt, torch, dev)

        # ---- catalog path: the README's serving configuration (K5-K7 at
        # its shapes), then K5 and K6 at every width
        ret_entries, ret_launches = catalog_path(bt, R, torch, dev)
        entries.update(ret_entries)
        path_launches.update(ret_launches)
        phase("retrieval_widths", **retrieval_widths(R, torch, dev),
              tol=TOL_SCORE)
        phase("k6_forms", **k6_forms(R, torch, dev), tol=TOL_SCORE)

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

    entries["sharded_topk_merge"] = k22_entry
    path_launches["sharded_topk_merge"] = k22_launches
    kernels = []
    for name, entry in entries.items():
        kernels.append({"name": name, "route": entry["route"],
                        "source": entry["source"],
                        "replaces": entry["replaces"],
                        "launches": path_launches[name],
                        "max_abs_err": entry["max_abs_err"],
                        "ms": entry["ms"], "plain_ms": entry["plain_ms"],
                        "bound_ms": entry["bound_ms"],
                        "bound_by": entry["bound_by"],
                        "library_ms": entry["library_ms"],
                        **{key: entry[key] for key in KERNEL_EXTRAS
                           if key in entry}})
    print(json.dumps({"kernels": kernels}))
    print(smi[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
