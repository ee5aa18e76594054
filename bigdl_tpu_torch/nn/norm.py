"""Normalization (counterpart of ``bigdl_tpu/nn/norm.py``)."""
from __future__ import annotations

import torch

from .module import Module


class LayerNormalization(Module):
    """LayerNorm over the last dim. ``eps`` defaults to 1e-6, the JAX
    package's value (not torch's 1e-5)."""

    def __init__(self, hidden_size: int, eps: float = 1e-6):
        super().__init__()
        self.hidden_size, self.eps = hidden_size, eps
        self.weight = torch.nn.Parameter(torch.ones(hidden_size))
        self.bias = torch.nn.Parameter(torch.zeros(hidden_size))

    def call(self, params, x):
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * params["weight"] + params["bias"]
