"""The port's batch planning is the reference's, array for array.

Both packages must solve the same batches, so the planner, the
bucket-order range layout, the segment batches and the stacking of the
port are compared with ``buffalo_tpu.data.batching`` by
``np.array_equal`` on CSRs with a long row; the torch staging is
checked against the host batches it came from.
"""
import numpy as np
import pytest
import torch

from buffalo_tpu.data import batching as ref
from buffalo_tpu_torch.data import batching as port


def _csr(num_rows, num_cols, seed, max_deg=40, long_deg=0):
    rng = np.random.default_rng(seed)
    degs = rng.integers(0, max_deg, size=num_rows)
    if long_deg:
        degs[num_rows // 2] = long_deg
    indptr = np.zeros(num_rows + 1, dtype=np.int64)
    np.cumsum(degs, out=indptr[1:])
    key = rng.integers(0, num_cols, int(indptr[-1])).astype(np.int32)
    val = (1.0 + rng.random(int(indptr[-1]))).astype(np.float32)
    return indptr, key, val


def _colwise(indptr, key, val, num_cols):
    rows = np.repeat(np.arange(len(indptr) - 1, dtype=np.int32),
                     np.diff(indptr))
    order = np.argsort(key, kind="stable")
    cindptr = np.zeros(num_cols + 1, dtype=np.int64)
    np.cumsum(np.bincount(key, minlength=num_cols), out=cindptr[1:])
    return cindptr, rows[order], val[order]


def _assert_same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert type(x).__name__ == type(y).__name__
        assert x._fields == y._fields
        for f in x._fields:
            u, v = np.asarray(getattr(x, f)), np.asarray(getattr(y, f))
            assert u.dtype == v.dtype and np.array_equal(u, v), f


@pytest.mark.parametrize("max_len,entries", [(16, 256), (64, 512),
                                             (32, 4096)])
def test_planner_and_range_layout_identical(max_len, entries):
    U, I = 70, 45
    indptr, key, val = _csr(U, I, seed=max_len, long_deg=3 * max_len + 5)
    cindptr, ckey, cval = _colwise(indptr, key, val, I)
    kw = dict(entries_per_batch=entries, max_len=max_len, max_rows=64)
    rp, cp = ref.BatchPlanner(indptr, **kw), ref.BatchPlanner(cindptr, **kw)
    tp, tc = port.BatchPlanner(indptr, **kw), port.BatchPlanner(cindptr, **kw)
    for a, b in ((rp, tp), (cp, tc)):
        assert a.shapes() == b.shapes()
        assert a.segment_plans == b.segment_plans
        assert a.padded_entries() == b.padded_entries()
        assert a.num_batches == b.num_batches
        for x, y in zip(a.buckets, b.buckets):
            assert np.array_equal(x.row_ids, y.row_ids)
    assert rp.segment_plans, "fixture must exercise the segment path"

    r_out = ref.build_range_layout(rp, cp, key, val, ckey, cval)
    t_out = port.build_range_layout(tp, tc, key, val, ckey, cval)
    _assert_same_batches(r_out[0], t_out[0])
    _assert_same_batches(r_out[1], t_out[1])
    for a, b in zip(r_out[2:], t_out[2:]):
        assert np.array_equal(a, b)
    _assert_same_batches(ref.stack_batches(r_out[0]),
                         port.stack_batches(t_out[0]))
    P = np.random.default_rng(0).random((U, 4)).astype(np.float32)
    assert np.array_equal(ref.permute_table(P, r_out[2], r_out[4]),
                          port.permute_table(P, t_out[2], t_out[4]))


def test_segment_batch_identical():
    indptr, key, val = _csr(12, 30, seed=3, long_deg=70)
    plan = [6, 1, 11]
    a = ref.build_segment_batch(indptr, key, val, plan, 16, 12)
    b = port.build_segment_batch(indptr, key, val, plan, 16, 12)
    _assert_same_batches([a], [b])


def test_device_batcher_plans_like_reference():
    indptr, key, val = _csr(300, 60, seed=5, max_deg=120)

    class _Data:
        def get_group(self, g):
            return {"indptr": indptr, "key": key, "val": val}

    for matrix_free in (True, False):
        kw = dict(batch_mb=1, d=8, matrix_free=matrix_free)
        a = ref.DeviceBatcher(_Data(), "rowwise", **kw)
        b = port.DeviceBatcher(_Data(), "rowwise", **kw)
        assert a.planner.shapes() == b.planner.shapes()
        assert a.padded_entries == b.padded_entries
        assert a.resident == b.resident


def test_stage_batch_keeps_fields_and_chunk_ranges():
    indptr, key, val = _csr(40, 25, seed=7, long_deg=60)
    cindptr, ckey, cval = _colwise(indptr, key, val, 25)
    rp = port.BatchPlanner(indptr, entries_per_batch=256, max_len=16)
    cp = port.BatchPlanner(cindptr, entries_per_batch=256, max_len=16)
    row_b = port.build_range_layout(rp, cp, key, val, ckey, cval)[0]
    seen_segment = False
    for b in row_b:
        s = port.stage_batch(b, "cpu")
        if isinstance(b, port.RangeBatch):
            assert s.row_start == int(b.row_start)
            for f in ("lens", "cols", "vals"):
                assert torch.equal(getattr(s, f),
                                   torch.from_numpy(getattr(b, f)))
            continue
        seen_segment = True
        assert isinstance(s, port.StagedSegmentBatch)
        ptr = s.chunk_ptr.numpy()
        # row r owns exactly the chunks whose seg_id is r, in order
        for r in range(len(b.rows)):
            assert np.all(b.seg_ids[ptr[r]:ptr[r + 1]] == r)
        assert np.all(b.seg_ids[ptr[-1]:] == len(b.rows))
        assert torch.equal(s.cols, torch.from_numpy(b.cols))
    assert seen_segment
    with pytest.raises(ValueError):
        port.segment_chunk_ptr(np.array([0, 1, 0], np.int32), 2)


@pytest.mark.parametrize("resident_mb", [4096, 0])
def test_device_batcher_yields_the_planned_batches(resident_mb):
    """Resident or streamed (the padded epoch past ``resident_mb``), the
    batcher yields the planner's batches staged, in order, every epoch."""
    indptr, key, val = _csr(200, 50, seed=9, max_deg=90, long_deg=400)

    class _Data:
        def get_group(self, g):
            return {"indptr": indptr, "key": key, "val": val}

    b = port.DeviceBatcher(_Data(), "rowwise", batch_mb=1, d=8, max_len=128,
                           resident_mb=resident_mb, device="cpu")
    assert b.resident == (resident_mb > 0)
    host = list(ref.DeviceBatcher(_Data(), "rowwise", batch_mb=1, d=8,
                                  max_len=128).planner.iter_batches(key, val))
    assert len(host) == b.num_batches > 2
    for _ in range(2):
        got = list(b)
        assert len(got) == len(host)
        for s, h in zip(got, host):
            assert type(s).__name__ == ("StagedSegmentBatch"
                                        if type(h).__name__ == "SegmentBatch"
                                        else "PaddedBatch")
            for f in h._fields:
                assert np.array_equal(getattr(s, f).numpy(), getattr(h, f))
    assert b.h2d_bytes == 0


@pytest.mark.parametrize("dispatch,entries", [
    ("auto", 10), ("auto", (100 << 20) + 1), ("fused", 1 << 30),
    ("group", 10), ("bogus", 10)])
def test_group_dispatch_choice_matches_reference(dispatch, entries):
    opt = {"epoch_dispatch": dispatch}

    class _Opt(dict):
        get = dict.get

    if dispatch == "bogus":
        for mod in (ref, port):
            with pytest.raises(ValueError):
                mod.choose_group_dispatch(_Opt(opt), entries)
        return
    assert port.choose_group_dispatch(_Opt(opt), entries) == \
        ref.choose_group_dispatch(_Opt(opt), entries)
    batches = [ref.PaddedBatch(*[np.zeros((3, 5))] * 4)] * 2
    assert port.padded_entry_count(batches) == \
        ref.padded_entry_count(batches) == 30


@pytest.mark.parametrize("D", [1, 2, 3, 8])
def test_sharded_range_layout_identical(D):
    """``build_sharded_range_layout`` byte for byte against the JAX
    package's, segment rows included, for 1, 2, 3 and 8 shards; each
    shard's slice (``shard_group``) is the stacked group's."""
    U, I = 70, 45
    indptr, key, val = _csr(U, I, seed=D, long_deg=53)
    cindptr, ckey, cval = _colwise(indptr, key, val, I)
    kw = dict(entries_per_batch=512, max_len=16, max_rows=64)
    rp, cp = ref.BatchPlanner(indptr, **kw), ref.BatchPlanner(cindptr, **kw)
    tp, tc = port.BatchPlanner(indptr, **kw), port.BatchPlanner(cindptr, **kw)
    assert rp.segment_plans, "fixture must exercise the segment path"
    r_out = ref.build_sharded_range_layout(rp, cp, key, val, ckey, cval, D)
    t_out = port.build_sharded_range_layout(tp, tc, key, val, ckey, cval, D)
    for i in range(4):
        _assert_same_batches(r_out[i], t_out[i])
    for a, b in zip(r_out[4:], t_out[4:]):
        assert np.array_equal(a, b)
    assert t_out[6] * D >= U and t_out[7] * D >= I
    for g in t_out[0]:
        assert g.lens.shape[0] == D
        for k in range(D):
            x = port.shard_group(g, k)
            assert np.array_equal(x.cols, g.cols[k])
            assert (x.row_start == g.row_start[k]).all()
            # local ranges stay inside the shard
            assert (x.row_start + x.lens.shape[-1] <= t_out[6]).all()


def test_split_rows_slices_a_batch_over_shards():
    """A padded batch planned with ``row_multiple`` = the mesh size splits
    into equal, contiguous row slices, one per shard (the JAX package's
    batch sharding)."""
    indptr, key, val = _csr(40, 20, seed=5)
    planner = port.BatchPlanner(indptr, entries_per_batch=256, row_multiple=3)
    for b in planner.iter_batches(key, val):
        if not isinstance(b, port.PaddedBatch):
            continue
        staged = port.stage_batch(b, "cpu")
        parts = [port.split_rows(staged, 3, j) for j in range(3)]
        for f in range(4):
            assert torch.equal(torch.cat([p[f] for p in parts]), staged[f])
    with pytest.raises(ValueError):
        port.split_rows(staged, 7, 0)
