"""Batched dense linear solvers for per-row normal equations.

PyTorch counterpart of ``buffalo_tpu.ops.solve``: batched Cholesky
(library ops, as in the reference) and warm-started batched conjugate
gradient with the reference's freeze and clamp rules.  These are the
plain versions: the CG here is what the card's ``batched_cg_dense``
kernel (``ops/als_kernels.py``) is checked against.

Solver mapping (reference optimizer names, ``options.py:90-91``):
  llt / ldlt                              -> batched Cholesky
  manual_cg / eigen_cg / eigen_bicg /
  eigen_gmres / eigen_dgmres / eigen_minres -> batched warm-start CG
"""
from __future__ import annotations

import torch

CHOLESKY_SOLVERS = ("llt", "ldlt")
CG_SOLVERS = ("manual_cg", "eigen_cg", "eigen_bicg", "eigen_gmres",
              "eigen_dgmres", "eigen_minres")


def solve_cholesky(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = y`` for a batch: A (B, d, d) SPD, y (B, d)."""
    L = torch.linalg.cholesky(A)
    return torch.cholesky_solve(y.unsqueeze(-1), L).squeeze(-1)


def cg_warm_start(matvec, y: torch.Tensor, x0: torch.Tensor):
    """The reference's warm-start rule (``algo.cc:62-67``): start from
    the current row ``x0`` unless the zero start has a smaller
    residual.  Returns (x, r = y - A x)."""
    r_warm = y - matvec(x0)
    use_zero = ((y * y).sum(-1) < (r_warm * r_warm).sum(-1))[:, None]
    x = torch.where(use_zero, torch.zeros_like(x0), x0)
    r = torch.where(use_zero, y, r_warm)
    return x, r


def cg_loop(matvec, x: torch.Tensor, r: torch.Tensor, num_iters: int,
            tolerance: float) -> torch.Tensor:
    """Batched un-preconditioned CG steps (``algo.cc:58-81``).

    Starts from ``(x, r = y - A x)``, runs at most ``num_iters``
    lockstep steps, freezing rows whose squared residual drops below
    ``tolerance``: ``alpha = rsold / max(pAp, 1e-30)`` while active,
    ``beta`` only where ``rsold > 0``.
    """
    rsold = (r * r).sum(-1)
    active = rsold >= tolerance
    p = r
    for _ in range(num_iters):
        Ap = matvec(p)
        pAp = (p * Ap).sum(-1)
        alpha = torch.where(active, rsold / pAp.clamp_min(1e-30),
                            torch.zeros_like(rsold))
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        rsnew = (r * r).sum(-1)
        active = active & (rsnew >= tolerance)
        beta = torch.where(rsold > 0, rsnew / rsold.clamp_min(1e-30),
                           torch.zeros_like(rsold))
        p = r + beta[:, None] * p
        rsold = rsnew
    return x


def solve_cg(A: torch.Tensor, y: torch.Tensor, x0: torch.Tensor,
             num_iters: int = 3, tolerance: float = 1e-10) -> torch.Tensor:
    """Batched CG over dense (B, d, d) systems with the reference's
    warm-start rule (``Algorithm::_leastsquare`` ``manual_cg`` branch,
    ``algo.cc:58-81``)."""
    def matvec(v):
        return torch.einsum("bij,bj->bi", A, v)

    x, r = cg_warm_start(matvec, y, x0)
    return cg_loop(matvec, x, r, num_iters, tolerance)


def solve(A: torch.Tensor, y: torch.Tensor, x0: torch.Tensor,
          optimizer: str, num_iters: int = 3,
          tolerance: float = 1e-10) -> torch.Tensor:
    if optimizer in CHOLESKY_SOLVERS:
        return solve_cholesky(A, y)
    if optimizer in CG_SOLVERS:
        return solve_cg(A, y, x0, num_iters=num_iters, tolerance=tolerance)
    raise ValueError(f"Unknown optimizer: {optimizer}")
