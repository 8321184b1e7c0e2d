"""Carry weights from the JAX package to this port.

``from_jax_factors`` turns the reference's host factor tables (numpy
arrays, e.g. a trained ``buffalo_tpu`` ALS's ``.P`` / ``.Q``, or a BPRMF's
``.P`` / ``.Q`` / ``.Qb``, a WARP's, eALS's or pLSI's ``.P`` / ``.Q``, a
CoFactor's ``.U`` / ``.I`` / ``.C`` / ``.Ib`` / ``.Cb``, a W2V's ``.L0`` /
``.L1``) into this port's float32 tensors on a device;
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
        # a copy: the JAX package's host arrays are read-only views
        return torch.from_numpy(
            np.array(x, dtype=np.float32, order="C", copy=True)).to(device)

    return tuple(conv(t) for t in tables)


def load_reference_model(path, device="cuda"):
    """The port's model of a file saved by either package's ALS, BPRMF,
    WARP, EALS, PLSI, CFR or W2V: a BPRMF file holds a ``Qb`` record, a CFR
    file a ``Cb`` record and a W2V file a ``_vocab`` record; otherwise the
    saved options tell WARP
    (``score_func``), EALS (``c0``) and PLSI (``alpha1``) from ALS.  Its
    options, id maps and factors, ready to serve on ``device``."""
    from buffalo_tpu_torch.models.als import ALS
    from buffalo_tpu_torch.models.base import Serializable
    from buffalo_tpu_torch.models.bpr import BPRMF
    from buffalo_tpu_torch.models.cfr import CFR
    from buffalo_tpu_torch.models.eals import EALS
    from buffalo_tpu_torch.models.plsi import PLSI
    from buffalo_tpu_torch.models.w2v import W2V
    from buffalo_tpu_torch.models.warp import WARP

    records = Serializable.record_names(path)
    if "Qb" in records:
        return BPRMF.new(path, device=device)
    if "Cb" in records:
        return CFR.new(path, device=device)
    if "_vocab" in records:
        return W2V.new(path, device=device)
    opt = Serializable.read_record(path, "opt")
    cls = (WARP if "score_func" in opt else EALS if "c0" in opt
           else PLSI if "alpha1" in opt else ALS)
    return cls.new(path, device=device)
