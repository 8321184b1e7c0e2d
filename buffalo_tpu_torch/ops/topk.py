"""Scoring + top-k retrieval ops.

PyTorch counterpart of ``buffalo_tpu.ops.topk``'s single-device
functions: scores are one ``torch.matmul`` and selection is
``torch.topk`` (library calls, as the reference left them to XLA).
The batched, tiled and sharded retrieval paths come with a later slice.
"""
from __future__ import annotations

import numpy as np
import torch

from buffalo_tpu_torch.utils import resolve_device


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(
        device)


def matmul_topk(p, Q, k: int, pb=None, Qb=None, device="cuda"):
    """scores = p @ Q^T (+ biases) then top-k.  p: (B, d), Q: (N, d).

    ``k`` is clamped to the candidate count (``topk.py:47-50``): a
    validation request of ``topk + max_seen`` can exceed a small
    catalog.  Returns (scores (B, k), indices (B, k)) on ``device``.
    """
    device = resolve_device(device)
    p = _as_tensor(p, device)
    Q = _as_tensor(Q, device)
    scores = torch.matmul(p, Q.T)
    if pb is not None:
        scores = scores + _as_tensor(pb, device)[:, None]
    if Qb is not None:
        scores = scores + _as_tensor(Qb, device)[None, :]
    return torch.topk(scores, min(k, Q.shape[0]), dim=1)


def topk(scores, k: int, sorted: bool = True, num_threads: int = 0,
         device="cuda") -> np.ndarray:
    """Row-wise top-k indices of a host score matrix (quickselect analog).

    Keeps the reference's ``Evaluable.get_topk`` contract
    (``evaluate/base.py:31-42``); ``num_threads`` is accepted for API
    parity and ignored.  Selection runs on ``device``.
    """
    scores = _as_tensor(scores, resolve_device(device))
    squeeze = scores.dim() == 1
    if squeeze:
        scores = scores[None, :]
    k = min(k, scores.shape[1])
    assert k > 0, f"k({k}) should be greater than 0"
    idx = torch.topk(scores, k, dim=1, sorted=sorted).indices
    idx = idx.cpu().numpy().astype(np.int32)
    return idx[0] if squeeze else idx
