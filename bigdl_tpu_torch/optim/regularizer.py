"""Regularizers (counterpart of ``bigdl_tpu/optim/regularizer.py``, parity
with the reference's ``optim/Regularizer.scala``).

The penalty is added to the differentiated loss in the training step, as
in the JAX package: autograd carries its gradient into the update.
"""
from __future__ import annotations

import torch

__all__ = ["Regularizer", "L1L2Regularizer", "L1Regularizer",
           "L2Regularizer", "regularizer_tree", "regularization_loss"]


def _abs(w):
    """|w| with the JAX package's gradient: ``jnp.abs`` passes +1 at 0
    (``torch.abs`` passes 0), which moves a zero-initialised bias under
    an L1 penalty."""
    return torch.where(w >= 0, w, -w)


class Regularizer:
    def loss(self, w):
        return 0.0


class L1L2Regularizer(Regularizer):
    def __init__(self, l1: float = 0.0, l2: float = 0.0):
        self.l1, self.l2 = l1, l2

    def loss(self, w):
        out = 0.0
        if self.l1:
            out = out + self.l1 * _abs(w).sum()
        if self.l2:
            out = out + 0.5 * self.l2 * w.square().sum()
        return out


class L1Regularizer(L1L2Regularizer):
    def __init__(self, l1: float):
        super().__init__(l1=l1, l2=0.0)


class L2Regularizer(L1L2Regularizer):
    def __init__(self, l2: float):
        super().__init__(l1=0.0, l2=l2)


def regularizer_tree(module):
    """A nested dict mirroring ``module``'s params that holds the
    Regularizer of each regularized leaf (and no key elsewhere)."""
    from ..nn.module import Container
    if isinstance(module, Container):
        tree = {}
        for i, child in enumerate(module._modules.values()):
            sub = regularizer_tree(child)
            if sub:
                tree[str(i)] = sub
        return tree
    if hasattr(module, "_regularizers"):
        return {k: v for k, v in module._regularizers().items()
                if v is not None}
    return {}


def regularization_loss(reg_tree, params):
    """The summed penalty over the params the regularizer tree names."""
    total = 0.0
    for k, v in reg_tree.items():
        if k not in params:
            continue
        if isinstance(v, dict):
            total = total + regularization_loss(v, params[k])
        else:
            total = total + v.loss(params[k])
    return total
