"""Host-to-device placement (the part of ``bigdl_tpu/optim/staging.py``
the serving engine needs)."""
from __future__ import annotations

import numpy as np
import torch

from ..utils.engine import resolve_device

__all__ = ["place_host_value"]


def place_host_value(x, device=None):
    """A host value (numpy array, or a tensor) as a tensor on ``device``
    (the CUDA device by default; ``'cpu'`` for the CPU). To a card the
    bytes go through a pinned copy and a non-blocking transfer on the
    current stream."""
    if x is None:
        return None
    dev = resolve_device(device)
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    if dev.type == "cuda":
        if t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(dev, non_blocking=True)
    return t.to(dev)
