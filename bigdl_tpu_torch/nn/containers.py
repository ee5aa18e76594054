"""Containers (counterpart of ``bigdl_tpu/nn/containers.py``): composition
over the children's ``apply``, each child's params and state under its
index ``"0"``, ``"1"``, ... as in the JAX package. The generator given to
a container's ``apply`` is passed to every child."""
from __future__ import annotations

import torch

from ..utils.table import Table
from .module import Container, Module

__all__ = ["Sequential", "Concat", "JoinTableModuleMixin", "ConcatTable",
           "ParallelTable", "MapTable", "Bottle"]


class Sequential(Container):
    """Chain the children in order."""

    def apply(self, params, state, x, training: bool = False,
              generator=None):
        new_state = dict(state)
        for i in range(len(self._modules)):
            x, new_state[str(i)] = self.child_apply(i, params, state, x,
                                                    training, generator)
        return x, new_state


class _Branches(Container):
    """Every child on the same input: ``(outputs, new_state)``."""

    def _branches(self, params, state, x, training, generator):
        outs, new_state = [], dict(state)
        for i in range(len(self._modules)):
            o, new_state[str(i)] = self.child_apply(i, params, state, x,
                                                    training, generator)
            outs.append(o)
        return outs, new_state


class Concat(_Branches):
    """Run the children on the same input and concatenate their outputs
    along 1-based ``dimension`` (``Concat(2)`` on NCHW: the channels)."""

    def __init__(self, dimension: int, *modules, name=None):
        super().__init__(*modules, name=name)
        self.dimension = dimension

    def apply(self, params, state, x, training: bool = False,
              generator=None):
        outs, new_state = self._branches(params, state, x, training,
                                         generator)
        return torch.cat(outs, self.dimension - 1), new_state


class JoinTableModuleMixin:
    pass


class ConcatTable(_Branches):
    """Run the children on the same input; a Table of their outputs."""

    def apply(self, params, state, x, training: bool = False,
              generator=None):
        outs, new_state = self._branches(params, state, x, training,
                                         generator)
        return Table(*outs), new_state


class ParallelTable(Container):
    """Child i consumes entry i + 1 of the input Table."""

    def apply(self, params, state, x, training: bool = False,
              generator=None):
        outs, new_state = [], dict(state)
        for i in range(len(self._modules)):
            o, new_state[str(i)] = self.child_apply(i, params, state,
                                                    x[i + 1], training,
                                                    generator)
            outs.append(o)
        return Table(*outs), new_state


class MapTable(Container):
    """The one child on every entry of the input Table, with shared
    parameters (its params and state under ``"0"``; the new state is the
    last entry's)."""

    def __init__(self, module: Module, name=None):
        super().__init__(module, name=name)

    def apply(self, params, state, x, training: bool = False,
              generator=None):
        outs, new_state = [], dict(state)
        for item in x:
            o, new_state["0"] = self.child_apply(0, params, state, item,
                                                 training, generator)
            outs.append(o)
        return Table(*outs), new_state


class Bottle(Container):
    """Fold the leading dims into one, apply the child, unfold: with
    ``n_input_dim`` 2 an input (d1, ..., dk, feat) reaches the child as
    (d1 * ... * dk, feat)."""

    def __init__(self, module: Module, n_input_dim: int = 2,
                 n_output_dim: int = 2, name=None):
        super().__init__(module, name=name)
        self.n_input_dim = n_input_dim
        self.n_output_dim = n_output_dim

    def apply(self, params, state, x, training: bool = False,
              generator=None):
        keep = self.n_input_dim - 1
        lead = tuple(x.shape[: x.dim() - keep])
        tail = tuple(x.shape[x.dim() - keep:])
        o, new_sub = self.child_apply(0, params, state, x.reshape((-1,) + tail),
                                      training, generator)
        return o.reshape(lead + tuple(o.shape[1:])), {**state, "0": new_sub}
