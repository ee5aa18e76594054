"""Placing a freshly built model: shared by the model factories."""
from __future__ import annotations

import torch

from ..utils.engine import resolve_device


def placed(model, device=None, seed: int = 0):
    """``model`` moved to ``device`` (the CUDA device by default, which
    raises without one; ``'cpu'`` for the CPU) with its parameters drawn
    anew from a generator there seeded with ``seed``."""
    dev = resolve_device(device)
    model.to(dev)
    return model.reset(torch.Generator(device=dev).manual_seed(seed))
