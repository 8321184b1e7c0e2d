"""Port solvers against the reference's, case for case.

Mirrors ``tests/ops/test_solve.py`` with ``buffalo_tpu.ops.solve`` as
the oracle on the same numpy inputs.  Tolerance rtol 1e-5 (float32, the
two frameworks sum in different orders); the Cholesky case compares
solutions of well-conditioned systems.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buffalo_tpu.ops import solve as ref
from buffalo_tpu_torch.ops import solve as port


def _spd_batch(B, d, seed=0, shift=0.5):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, d, d)).astype(np.float32)
    A = M @ np.swapaxes(M, 1, 2) + shift * np.eye(d, dtype=np.float32)
    y = rng.normal(size=(B, d)).astype(np.float32)
    return A, y


def _both(fn_ref, fn_port, *arrays, **kw):
    got_ref = np.asarray(fn_ref(*[jnp.asarray(a) for a in arrays], **kw))
    got_port = fn_port(*[torch.from_numpy(a) for a in arrays], **kw).numpy()
    return got_ref, got_port


def test_cholesky_matches_reference():
    A, y = _spd_batch(16, 12, shift=12.0)
    a, b = _both(ref.solve_cholesky, port.solve_cholesky, A, y)
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["converge", "warm_exact", "bad_warm",
                                  "zero_start"])
def test_cg_matches_reference(case):
    A, y = _spd_batch(8, 6, seed=1)
    if case == "converge":
        x0, iters = np.zeros((8, 6), np.float32), 30
    elif case == "warm_exact":
        x0 = np.stack([np.linalg.solve(A[b], y[b]) for b in range(8)])
        x0, iters = x0.astype(np.float32), 3
    elif case == "bad_warm":
        x0, iters = 1e4 * np.ones((8, 6), np.float32), 3
    else:
        x0, iters = np.zeros((8, 6), np.float32), 3
    a, b = _both(ref.solve_cg, port.solve_cg, A, y, x0, num_iters=iters)
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)


def test_cg_freeze_rule_matches_reference():
    """A tolerance that some rows reach mid-loop exercises the freeze:
    frozen rows keep x while the others keep stepping."""
    A, y = _spd_batch(32, 8, seed=4)
    x0 = np.zeros((32, 8), np.float32)
    a, b = _both(ref.solve_cg, port.solve_cg, A, y, x0, num_iters=6,
                 tolerance=1e-1)
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("optimizer", ["llt", "ldlt", "manual_cg",
                                       "eigen_cg"])
def test_solve_dispatch(optimizer):
    A, y = _spd_batch(8, 6, seed=5, shift=6.0)
    x0 = np.zeros((8, 6), np.float32)
    a, b = _both(ref.solve, port.solve, A, y, x0, optimizer=optimizer)
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        port.solve(*map(torch.from_numpy, (A, y, x0)), "bogus")


# the widths the card tests give K3: d = 13 and 65 are no multiple of 4,
# 65 and 128 keep A in shared memory on the card; systems are written to a
# row range, rows with len 0 keep their value
@pytest.mark.parametrize("d", [13, 65, 128])
def test_dense_cg_plain_matches_solve_cg(d):
    from buffalo_tpu_torch.ops import als_kernels

    rng = np.random.default_rng(d)
    B, n, rs = 16, 40, 11
    M = rng.normal(size=(B, d, d)) / np.sqrt(d)
    A = (M @ np.swapaxes(M, 1, 2) + np.eye(d)).astype(np.float32)
    y = rng.normal(size=(B, d)).astype(np.float32)
    table = (rng.normal(size=(n, d)) * 0.3).astype(np.float32)
    lens = rng.integers(1, 50, size=B).astype(np.int32)
    lens[[3, 8]] = 0
    x = np.asarray(ref.solve_cg(jnp.asarray(A), jnp.asarray(y),
                                jnp.asarray(table[rs:rs + B]), num_iters=3,
                                tolerance=1e-10))
    expected = table.copy()
    expected[rs:rs + B][lens > 0] = x[lens > 0]
    T = torch.from_numpy(table.copy())
    als_kernels.batched_cg_dense_plain(
        torch.from_numpy(A), torch.from_numpy(y), T, torch.from_numpy(lens),
        row_start=rs, cg_iters=3, cg_tol=1e-10)
    np.testing.assert_allclose(T.numpy(), expected, rtol=1e-5, atol=1e-5)
