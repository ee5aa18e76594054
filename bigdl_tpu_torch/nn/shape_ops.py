"""Shape ops (counterpart of ``bigdl_tpu/nn/shape_ops.py``; the ResNet
slice ports ``View``)."""
from __future__ import annotations

import math

from .module import Module


class View(Module):
    """Reshape to ``sizes``, keeping the batch dimension when the rest of
    the input holds exactly ``prod(sizes)`` elements (nn/View.scala)."""

    def __init__(self, *sizes, name=None):
        super().__init__(name=name)
        if len(sizes) == 1 and isinstance(sizes[0], (list, tuple)):
            sizes = tuple(sizes[0])
        self.sizes = tuple(sizes)

    def call(self, params, x):
        if -1 in self.sizes:
            return x.reshape(self.sizes)
        n = math.prod(self.sizes)
        rest = math.prod(x.shape[1:]) if x.dim() > 1 else -1
        if rest == n:
            return x.reshape((x.shape[0],) + self.sizes)
        if x.numel() == n:
            return x.reshape(self.sizes)
        return x.reshape((-1,) + self.sizes)
