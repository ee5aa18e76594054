"""Containers (counterpart of ``bigdl_tpu/nn/containers.py``; the ResNet
slice ports ``Sequential``)."""
from __future__ import annotations

from .module import Container


class Sequential(Container):
    """Chain the children in order; their params and state sit under the
    keys ``"0"``, ``"1"``, ... as in the JAX package."""

    def apply(self, params, state, x, training: bool = False,
              generator=None):
        new_state = dict(state)
        for i in range(len(self._modules)):
            x, new_state[str(i)] = self.child_apply(i, params, state, x,
                                                    training, generator)
        return x, new_state
