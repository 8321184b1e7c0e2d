"""buffalo_tpu_torch — the PyTorch/CUDA port of buffalo_tpu.

The same public surface as ``buffalo_tpu`` (implicit ALS, BPR-MF, WARP /
CML, eALS, pLSI, CoFactor and skip-gram W2V with top-k recommendation or
most-similar retrieval, MatrixMarket and Stream data with its SPPMI group,
batched retrieval with ``ParALS`` / ``ParBPRMF`` / ``ParEALS`` /
``ParCFR`` / ``ParW2V`` and the ``IVFIndex`` ANN index), the same option
names and the same save/load byte formats, running on one CUDA device or,
for every model's training and for sharded serving, over a device mesh
(``parallelism``: shards on one or more cards, across processes through
``torch.distributed``).
The hot per-row solves, BPR's and WARP's sampling and chunk updates,
eALS's dimension sweeps, pLSI's EM steps, CoFactor's normal equations and
biases, W2V's pair steps, stream chunks and capped row updates and the
retrieval scans are hand-written CUDA kernels (``csrc/``, built with
``nvcc`` at first use); on the CPU (``device="cpu"``) the same entry
points run their plain PyTorch versions.  Nothing here imports JAX or the
``buffalo_tpu`` package.

``inited_CUALS`` / ``inited_CUBPR`` are the reference's flags for its
optional CUDA extension modules (``buffalo/__init__.py``); as in the JAX
package they are False: neither extension module exists here either (the
port's kernels are its own, loaded on first use), so callers that branch
on the flags take their portable path.  ``aux`` is the reference's alias
of the utilities module.
"""
from __future__ import annotations

__version__ = "0.1.0"

from buffalo_tpu_torch.data import (MatrixMarket,  # noqa: F401
                                    MatrixMarketOptions, Stream,
                                    StreamOptions)
from buffalo_tpu_torch.models import (ALS, BPRMF, CFR, EALS, PLSI,  # noqa: F401
                                      W2V, WARP, ALSOption, AlgoOption,
                                      BPRMFOption, CFROption, EALSOption,
                                      PLSIOption, W2VOption, WARPOption)
from buffalo_tpu_torch.models.base import Algo  # noqa: F401
from buffalo_tpu_torch.parallel import (IVFIndex, ParALS,  # noqa: F401
                                        ParBPRMF, ParCFR, ParEALS, ParW2V)
from buffalo_tpu_torch import parallelism  # noqa: F401
from buffalo_tpu_torch import utils as aux  # noqa: F401  (reference alias)
from buffalo_tpu_torch.utils import Option  # noqa: F401
from buffalo_tpu_torch.utils import log  # noqa: F401
from buffalo_tpu_torch.utils.log import get_log_level, set_log_level  # noqa: F401

inited_CUALS = False
inited_CUBPR = False

__all__ = [
    "ALS", "BPRMF", "CFR", "EALS", "PLSI", "W2V", "WARP",
    "ALSOption", "BPRMFOption", "CFROption", "EALSOption", "PLSIOption",
    "W2VOption", "WARPOption",
    "MatrixMarket", "MatrixMarketOptions", "Stream", "StreamOptions",
    "ParALS", "ParBPRMF", "ParCFR", "ParEALS", "ParW2V", "IVFIndex",
    "Algo", "AlgoOption",
    "Option", "set_log_level", "get_log_level", "aux", "log",
    "inited_CUALS", "inited_CUBPR",
]
