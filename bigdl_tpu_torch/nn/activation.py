"""Activations (counterpart of ``bigdl_tpu/nn/activation.py``; the ResNet
slice ports ``ReLU``)."""
from __future__ import annotations

import torch

from .module import Module


class ReLU(Module):
    """max(x, 0) (``ip`` is accepted and ignored, as in the JAX package)."""

    def __init__(self, ip: bool = False, name=None):
        super().__init__(name=name)

    def call(self, params, x):
        return torch.relu(x)
