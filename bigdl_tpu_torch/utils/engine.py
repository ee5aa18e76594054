"""Runtime engine: device resolution and seeds (counterpart of
``bigdl_tpu/utils/engine.py``).

Every entry point of the port runs on a CUDA device unless its caller asks
for the CPU with ``device="cpu"`` (the tests do). Without a card and
without that request it raises: the port never moves to the CPU on its own.
"""
from __future__ import annotations

import random

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` or ``"cuda"`` -> the current CUDA device (raises when there
    is none); ``"cpu"`` -> the CPU; a ``torch.device`` passes through the
    same check."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def set_seed(seed: int):
    """Seed Python's, numpy's and torch's global generators (the port's
    own entry points take explicit ``seed``s / ``torch.Generator``s)."""
    random.seed(seed)
    np.random.seed(seed % 2**32)
    torch.manual_seed(seed)
