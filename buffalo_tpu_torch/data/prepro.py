"""Value preprocessors applied to interaction values at database build.

Counterpart of the reference ``buffalo/data/prepro.py`` (classes at
``prepro.py:18,33,61,75``): same registry — ``OneBased`` binarization,
``MinMaxScalar`` global rescale, ``ImplicitALS`` log(1 + v/eps)
confidence transform, ``SPPMI`` passthrough.  Because our builder holds
the value array as a single numpy buffer (no h5py chunk streaming),
``post`` receives the value ndarray directly.
"""
from __future__ import annotations

import numpy as np


class PreProcess:
    def __init__(self, opt):
        self.opt = opt

    def pre(self, header) -> None:
        pass

    def update_stats(self, v: np.ndarray) -> None:
        """First-pass statistics hook for out-of-core builds
        (MinMaxScalar needs the global range before rescaling)."""
        pass

    def __call__(self, v: np.ndarray) -> np.ndarray:
        return v

    def post(self, val: np.ndarray) -> np.ndarray:
        return val


class OneBased(PreProcess):
    """Binarize every value to 1.0."""

    def __call__(self, v: np.ndarray) -> np.ndarray:
        v = np.asarray(v, dtype=np.float32).copy()
        v[:] = 1.0
        return v


class MinMaxScalar(PreProcess):
    """Track global min/max across chunks, rescale to [opt.min, opt.max]."""

    def __init__(self, opt):
        super().__init__(opt)
        self.value_min = float("inf")
        # -inf, not 0: all-negative values must still span [min, max]
        # (the reference's 0.0 init quietly caps value_max at 0)
        self.value_max = float("-inf")

    def update_stats(self, v: np.ndarray) -> None:
        if v.size:
            self.value_min = min(self.value_min, float(np.min(v)))
            self.value_max = max(self.value_max, float(np.max(v)))

    def __call__(self, v: np.ndarray) -> np.ndarray:
        self.update_stats(v)
        return v

    def post(self, val: np.ndarray) -> np.ndarray:
        lo, hi = self.opt.min, self.opt.max
        if self.value_max - self.value_min < 1e-8:
            val[:] = hi
            return val
        scaled = (val - self.value_min) / (self.value_max - self.value_min)
        val[:] = scaled * (hi - lo) + lo
        return val


class ImplicitALS(PreProcess):
    """Confidence transform log(1 + v / eps)."""

    def __call__(self, v: np.ndarray) -> np.ndarray:
        return np.log(1.0 + np.asarray(v, dtype=np.float32) / self.opt.epsilon)


class SPPMI(PreProcess):
    """Passthrough (SPPMI values are already shifted PMI weights)."""
