"""Carry weights from the JAX package to this port.

``from_jax_factors`` turns the reference's host factor tables (numpy
arrays, e.g. a trained ``buffalo_tpu`` ALS's ``.P`` / ``.Q``, or a BPRMF's
``.P`` / ``.Q`` / ``.Qb``, a WARP's or eALS's ``.P`` / ``.Q``) into this
port's float32 tensors on a device;
``load_reference_model`` opens a model file that ``buffalo_tpu`` saved,
without importing it.
"""
from __future__ import annotations

import numpy as np
import torch

from buffalo_tpu_torch.utils import resolve_device


def from_jax_factors(*tables, device="cuda"):
    """The tables (e.g. P, Q or P, Q, Qb) as contiguous float32 tensors on
    ``device``, in the order given; values are copied unchanged."""
    device = resolve_device(device)

    def conv(x):
        return torch.from_numpy(
            np.ascontiguousarray(np.asarray(x), dtype=np.float32)).to(device)

    return tuple(conv(t) for t in tables)


def load_reference_model(path, device="cuda"):
    """The port's model of a file saved by either package's ALS, BPRMF,
    WARP or EALS: a BPRMF file holds a ``Qb`` record; otherwise the saved
    options tell WARP (``score_func``) and EALS (``c0``) from ALS.  Its
    options, id maps and factors, ready to serve on ``device``."""
    from buffalo_tpu_torch.models.als import ALS
    from buffalo_tpu_torch.models.base import Serializable
    from buffalo_tpu_torch.models.bpr import BPRMF
    from buffalo_tpu_torch.models.eals import EALS
    from buffalo_tpu_torch.models.warp import WARP

    if "Qb" in Serializable.record_names(path):
        return BPRMF.new(path, device=device)
    opt = Serializable.read_record(path, "opt")
    cls = (WARP if "score_func" in opt else EALS if "c0" in opt else ALS)
    return cls.new(path, device=device)
