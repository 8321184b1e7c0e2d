"""buffalo_tpu_torch — the PyTorch/CUDA port of buffalo_tpu.

The same public surface as ``buffalo_tpu`` for the algorithms ported so
far (implicit ALS, BPR-MF, WARP / CML and eALS with top-k
recommendation, MatrixMarket data, batched retrieval with ``ParALS`` /
``ParBPRMF`` / ``ParEALS`` and the ``IVFIndex`` ANN index), the same
option names and the same save/load byte formats, running on one CUDA
device.  The hot per-row solves, BPR's and WARP's sampling and chunk
updates, eALS's dimension sweeps and the retrieval scans are hand-written
CUDA kernels (``csrc/``, built with ``nvcc`` at first use); on the CPU
(``device="cpu"``) the same entry points run their plain PyTorch
versions.  Nothing here imports JAX or the ``buffalo_tpu`` package.
"""
from __future__ import annotations

__version__ = "0.1.0"

from buffalo_tpu_torch.data import MatrixMarket, MatrixMarketOptions  # noqa: F401
from buffalo_tpu_torch.models import (ALS, BPRMF, EALS, WARP,  # noqa: F401
                                      ALSOption, AlgoOption, BPRMFOption,
                                      EALSOption, WARPOption)
from buffalo_tpu_torch.models.base import Algo  # noqa: F401
from buffalo_tpu_torch.parallel import (IVFIndex, ParALS,  # noqa: F401
                                        ParBPRMF, ParEALS)
from buffalo_tpu_torch.utils import Option  # noqa: F401
from buffalo_tpu_torch.utils import log  # noqa: F401
from buffalo_tpu_torch.utils.log import get_log_level, set_log_level  # noqa: F401

__all__ = [
    "ALS", "ALSOption", "AlgoOption", "Algo", "BPRMF", "BPRMFOption",
    "EALS", "EALSOption", "WARP", "WARPOption",
    "MatrixMarket", "MatrixMarketOptions",
    "ParALS", "ParBPRMF", "ParEALS", "IVFIndex",
    "Option", "log", "set_log_level", "get_log_level",
]
