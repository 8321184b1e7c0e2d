"""The caps the port's kernels keep, each driven at its largest value
through the entry point that reaches it, on the CPU.

Every kernel takes rows of any width (``tests/test_torch_cuda.py`` holds
the wide forms at d = 300 on the card).  Three caps stay, because no
entry point passes them:

* K13's range mode takes rows of at most 8,192 entries: the planner's
  ``DEFAULT_MAX_L`` sends longer rows to segment batches;
* K12 takes at most 2^30 slots per chunk: WARP's default chunk is at most
  2^18 positives;
* K21 takes half-windows below 256 (one byte each): W2V's stream path
  refuses a window of 256, as the JAX package's does, and trains at 255.
"""
import numpy as np
import pytest
import torch

import buffalo_tpu as ref
import buffalo_tpu_torch as port
from buffalo_tpu.data import StreamOptions as RefStreamOptions
from buffalo_tpu.data import load as ref_load
from buffalo_tpu_torch.data import StreamOptions as PortStreamOptions
from buffalo_tpu_torch.data import load as port_load
from buffalo_tpu_torch.data.batching import DEFAULT_MAX_L, BatchPlanner
from buffalo_tpu_torch.models.warp import default_batch_size
from buffalo_tpu_torch.ops.eals_kernels import MAX_RANGE_L


def test_k13_range_rows_stop_at_the_planner_cap():
    """A row of 8,192 entries is a range batch row at L = 8,192 (K13's
    largest); one of 8,193 is a segment batch."""
    assert DEFAULT_MAX_L == MAX_RANGE_L == 8192
    degrees = np.array([8192, 8193, 5, 0, 300])
    indptr = np.concatenate([[0], np.cumsum(degrees)])
    plan = BatchPlanner(indptr)
    assert max(b.L for b in plan.buckets) == 8192
    assert 0 in np.concatenate([b.row_ids for b in plan.buckets])
    assert [r for p in plan.segment_plans for r in p] == [1]


@pytest.mark.parametrize("d", [8, 300, 4096])
def test_k12_chunks_stay_below_its_slot_cap(d):
    """WARP's default chunk at any nnz and width stays at most 2^18
    positives, far below K12's 2^30 slots."""
    for nnz in (1, 10 ** 6, 2 ** 40):
        assert 1024 <= default_batch_size(nnz, d, 64) <= 1 << 18


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("caps_w2v")
    rng = np.random.default_rng(4)
    lines = [rng.integers(0, 40, size=int(n)) for n in
             rng.integers(2, 30, 200)]
    path = root / "main.txt"
    path.write_text("\n".join(" ".join(f"w{x}" for x in s) for s in lines)
                    + "\n")
    data = []
    for options, load, name in ((RefStreamOptions, ref_load, "ref"),
                                (PortStreamOptions, port_load, "port")):
        opt = options().get_default_option()
        opt.input.main = str(path)
        opt.data.path = str(root / f"{name}.bfo")
        opt.data.tmp_dir = str(root / f"tmp_{name}")
        opt.data.validation = {}
        d = load(opt)
        d.create()
        data.append(d)
    return data


def _w2v(pkg, data, window):
    opt = pkg.W2VOption().get_default_option()
    opt.update(dict(d=8, num_iters=1, min_count=1, window=window))
    if pkg is port:
        opt.update(device="cpu", pair_gen="device")
    else:
        opt.update(num_devices=1, pair_gen="device")
    model = pkg.W2V(opt, data=data)
    np.random.seed(1)
    model.initialize()
    return model


def test_k21_window_cap_is_the_jax_packages(corpus):
    """W2V's stream path at window 255 (K21's largest half-window) trains;
    at 256 both packages refuse it."""
    m = _w2v(port, corpus[1], 255)
    m.train()
    assert np.isfinite(m.iteration_losses).all()
    assert torch.isfinite(torch.from_numpy(m.L0)).all()
    for pkg, data in ((ref, corpus[0]), (port, corpus[1])):
        with pytest.raises(AssertionError, match="uint8"):
            _w2v(pkg, data, 256).train()
