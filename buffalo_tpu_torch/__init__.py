"""buffalo_tpu_torch — the PyTorch/CUDA port of buffalo_tpu.

The same public surface as ``buffalo_tpu`` for the algorithms ported so
far (implicit ALS, BPR-MF, WARP / CML, eALS, pLSI and CoFactor with
top-k recommendation, MatrixMarket and Stream data with its SPPMI group,
batched retrieval with ``ParALS`` / ``ParBPRMF`` / ``ParEALS`` /
``ParCFR`` and the ``IVFIndex`` ANN index), the same option names and the
same save/load byte formats, running on one CUDA device.  The hot per-row
solves, BPR's and WARP's sampling and chunk updates, eALS's dimension
sweeps, pLSI's EM steps, CoFactor's normal equations and biases and the
retrieval scans are hand-written CUDA kernels (``csrc/``, built with ``nvcc`` at first use); on the CPU
(``device="cpu"``) the same entry points run their plain PyTorch
versions.  Nothing here imports JAX or the ``buffalo_tpu`` package.
"""
from __future__ import annotations

__version__ = "0.1.0"

from buffalo_tpu_torch.data import (MatrixMarket,  # noqa: F401
                                    MatrixMarketOptions, Stream,
                                    StreamOptions)
from buffalo_tpu_torch.models import (ALS, BPRMF, CFR, EALS, PLSI,  # noqa: F401
                                      WARP, ALSOption, AlgoOption,
                                      BPRMFOption, CFROption, EALSOption,
                                      PLSIOption, WARPOption)
from buffalo_tpu_torch.models.base import Algo  # noqa: F401
from buffalo_tpu_torch.parallel import (IVFIndex, ParALS,  # noqa: F401
                                        ParBPRMF, ParCFR, ParEALS)
from buffalo_tpu_torch.utils import Option  # noqa: F401
from buffalo_tpu_torch.utils import log  # noqa: F401
from buffalo_tpu_torch.utils.log import get_log_level, set_log_level  # noqa: F401

__all__ = [
    "ALS", "ALSOption", "AlgoOption", "Algo", "BPRMF", "BPRMFOption",
    "CFR", "CFROption", "EALS", "EALSOption", "PLSI", "PLSIOption",
    "WARP", "WARPOption", "MatrixMarket", "MatrixMarketOptions", "Stream",
    "StreamOptions", "ParALS", "ParBPRMF", "ParCFR", "ParEALS", "IVFIndex",
    "Option", "log", "set_log_level", "get_log_level",
]
