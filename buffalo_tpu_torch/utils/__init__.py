"""Shared utilities: configuration, logging, temp files, device choice."""
from __future__ import annotations

import os
import tempfile

from buffalo_tpu_torch.utils.option import InputOptions, Option  # noqa: F401


def get_temporary_file(root: str = "/tmp/", suffix: str = "") -> str:
    """Create (and leak, by design) a named temp file path under ``root``."""
    os.makedirs(root, exist_ok=True)
    fd, path = tempfile.mkstemp(dir=root, suffix=suffix)
    os.close(fd)
    return path


def mkdirs(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


def resolve_device(device="cuda"):
    """The ``torch.device`` an entry point runs on.

    The port runs on the card unless the caller asks for the CPU: a
    CUDA device without a card raises, it never falls back.  On the
    card, float32 products stay full float32 (TF32 off for matmul and
    cuDNN), as the reference computes ``FF @ x`` at
    ``Precision.HIGHEST``.
    """
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device: {device}")
    return device
