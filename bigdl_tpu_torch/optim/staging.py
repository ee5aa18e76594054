"""Host-to-device placement (the part of ``bigdl_tpu/optim/staging.py``
that the serving engine, the training loop and the evaluator share)."""
from __future__ import annotations

import numpy as np
import torch

from ..utils.engine import resolve_device
from ..utils.table import Table

__all__ = ["place_host_value"]


def place_host_value(x, device=None):
    """A host value (numpy array, or a tensor, or a ``Table`` of them,
    placed member by member) as a tensor on ``device`` (the CUDA device by
    default; ``'cpu'`` for the CPU). A float64 array becomes float32, as
    ``jnp.asarray`` makes it in JAX's default 32-bit mode. To a card the
    bytes go through a pinned copy and a non-blocking transfer on the
    current stream."""
    if x is None:
        return None
    if isinstance(x, Table):
        return Table(*(place_host_value(i, device) for i in x))
    dev = resolve_device(device)
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        x = torch.from_numpy(np.ascontiguousarray(
            a.astype(np.float32) if a.dtype == np.float64 else a))
    if dev.type == "cuda":
        if x.device.type == "cpu":
            x = x.pin_memory()
        return x.to(dev, non_blocking=True)
    return x.to(dev)
