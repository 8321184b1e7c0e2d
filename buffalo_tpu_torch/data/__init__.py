"""Data layer: builders, compiled dataset access, device batching.

The port has the MatrixMarket and the Stream builders (the latter with
the SPPMI group that CoFactor trains on).
"""
from __future__ import annotations

from buffalo_tpu_torch.data.base import Data  # noqa: F401
from buffalo_tpu_torch.data.batching import (BatchPlanner,  # noqa: F401
                                             DeviceBatcher, PaddedBatch)
from buffalo_tpu_torch.data.mm import (MatrixMarket,  # noqa: F401
                                       MatrixMarketOptions)
from buffalo_tpu_torch.data.stream import Stream, StreamOptions  # noqa: F401
from buffalo_tpu_torch.utils import Option


def load(opt):
    """Instantiate the right Data class from an option dict/JSON.

    Counterpart of the reference ``buffalo/data/__init__.py:7-18``.
    """
    if isinstance(opt, str):
        opt = Option(opt)
    assert isinstance(opt, dict), \
        f"opt must be either str or dict/Option but {type(opt)}"
    if opt["type"] == "matrix_market":
        return MatrixMarket(opt)
    if opt["type"] == "stream":
        return Stream(opt)
    raise RuntimeError(f"Unexpected data.type: {opt['type']}")
