"""Carry weights from the JAX package to this port.

``from_jax_factors`` turns the reference's host factor tables (numpy
arrays, e.g. a trained ``buffalo_tpu`` ALS's ``.P`` / ``.Q``) into this
port's float32 tensors on a device; ``load_reference_model`` opens a
model file that ``buffalo_tpu`` saved, without importing it.
"""
from __future__ import annotations

import numpy as np
import torch

from buffalo_tpu_torch.utils import resolve_device


def from_jax_factors(P, Q, *, device="cuda"):
    """(P, Q) as contiguous float32 tensors on ``device``; values are
    copied unchanged."""
    device = resolve_device(device)

    def conv(x):
        return torch.from_numpy(
            np.ascontiguousarray(np.asarray(x), dtype=np.float32)).to(device)

    return conv(P), conv(Q)


def load_reference_model(path, device="cuda"):
    """A port ``ALS`` holding a model file saved by ``buffalo_tpu``'s ALS
    (its options, id maps and factors), ready to serve on ``device``."""
    from buffalo_tpu_torch.models.als import ALS

    return ALS.new(path, device=device)
