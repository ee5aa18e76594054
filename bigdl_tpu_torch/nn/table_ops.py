"""Table layers (counterpart of ``bigdl_tpu/nn/table_ops.py``): they take
or give a 1-based :class:`~bigdl_tpu_torch.utils.table.Table` of tensors
(a list or tuple is taken as one). Dimensions are 1-based and go through
``shape_ops._dim0``. ``CMaxTable`` / ``CMinTable`` split a tie's gradient
in half, as ``jnp.maximum`` / ``jnp.minimum`` do (``torch.maximum``
too)."""
from __future__ import annotations

import torch

from ..utils.table import Table
from .elementwise import jabs
from .module import Module
from .shape_ops import _dim0, _items

__all__ = ["CAddTable", "CSubTable", "CMulTable", "CDivTable", "CMaxTable",
           "CMinTable", "CAveTable", "JoinTable", "SplitTable",
           "BifurcateSplitTable", "SelectTable", "NarrowTable",
           "FlattenTable", "MixtureTable", "DotProduct", "CrossProduct", "MM",
           "MV", "PairwiseDistance", "CosineDistance", "TableOperation"]


class _CwiseTable(Module):
    def _combine(self, a, b):
        raise NotImplementedError(type(self).__name__)

    def call(self, params, x):
        items = _items(x)
        out = items[0]
        for it in items[1:]:
            out = self._combine(out, it)
        return out


class CAddTable(_CwiseTable):
    def __init__(self, inplace: bool = False, name=None):
        super().__init__(name=name)

    def _combine(self, a, b):
        return a + b


class CSubTable(_CwiseTable):
    def _combine(self, a, b):
        return a - b


class CMulTable(_CwiseTable):
    def _combine(self, a, b):
        return a * b


class CDivTable(_CwiseTable):
    def _combine(self, a, b):
        return a / b


class CMaxTable(_CwiseTable):
    def _combine(self, a, b):
        return torch.maximum(a, b)


class CMinTable(_CwiseTable):
    def _combine(self, a, b):
        return torch.minimum(a, b)


class CAveTable(Module):
    def __init__(self, inplace: bool = False, name=None):
        super().__init__(name=name)

    def call(self, params, x):
        items = _items(x)
        return sum(items) / len(items)


class JoinTable(Module):
    """Concatenate the entries along 1-based ``dimension``."""

    def __init__(self, dimension: int, n_input_dims: int = -1, name=None):
        super().__init__(name=name)
        self.dimension, self.n_input_dims = dimension, n_input_dims

    def call(self, params, x):
        items = _items(x)
        return torch.cat(items, _dim0(self.dimension, items[0],
                                      self.n_input_dims))


class SplitTable(Module):
    """Split along 1-based ``dimension`` into a Table of its slices."""

    def __init__(self, dimension: int, n_input_dims: int = -1, name=None):
        super().__init__(name=name)
        self.dimension, self.n_input_dims = dimension, n_input_dims

    def call(self, params, x):
        return Table(*x.unbind(_dim0(self.dimension, x, self.n_input_dims)))


class BifurcateSplitTable(Module):
    """Split in two halves along 1-based ``dimension`` (the second half
    takes the odd element)."""

    def __init__(self, dimension: int, name=None):
        super().__init__(name=name)
        self.dimension = dimension

    def call(self, params, x):
        d = self.dimension - 1
        half = x.shape[d] // 2
        return Table(x.narrow(d, 0, half), x.narrow(d, half,
                                                    x.shape[d] - half))


class SelectTable(Module):
    """The 1-based ``index``-th entry (negative from the end)."""

    def __init__(self, index: int, name=None):
        super().__init__(name=name)
        self.index = index

    def call(self, params, x):
        i = self.index if self.index > 0 else len(x) + self.index + 1
        return x[i]


class NarrowTable(Module):
    """The sub-Table of ``length`` entries from 1-based ``offset`` (a
    negative length ends that many entries before the end, -1 at it)."""

    def __init__(self, offset: int, length: int = 1, name=None):
        super().__init__(name=name)
        self.offset, self.length = offset, length

    def call(self, params, x):
        length = self.length
        if length < 0:
            length = len(x) - self.offset + 2 + length
        return Table(*[x[self.offset + i] for i in range(length)])


class FlattenTable(Module):
    """Nested Tables -> one flat Table, depth first."""

    def call(self, params, x):
        out = []

        def rec(t):
            if isinstance(t, Table):
                for item in t:
                    rec(item)
            else:
                out.append(t)
        rec(x)
        return Table(*out)


class MixtureTable(Module):
    """Mixture of experts: ``Table(gate (B, K), experts)`` -> the
    gate-weighted sum of the experts, a Table of K tensors or one tensor
    (B, K, ...)."""

    def __init__(self, dim: int = None, name=None):
        super().__init__(name=name)
        self.dim = dim

    def call(self, params, x):
        gate, experts = x[1], x[2]
        stacked = (torch.stack(experts.to_list(), 1)
                   if isinstance(experts, Table) else experts)
        g = gate.reshape(gate.shape + (1,) * (stacked.dim() - gate.dim()))
        return (stacked * g).sum(1)


class DotProduct(Module):
    """Row-wise dot product of ``Table(a, b)``."""

    def call(self, params, x):
        a, b = x[1], x[2]
        if a.dim() == 1:
            return (a * b).sum()[None]
        return (a * b).sum(-1)


class CrossProduct(Module):
    """The dot product of every pair of entries (i < j), concatenated."""

    def __init__(self, num_tensor: int = 0, embedding_size: int = 0,
                 name=None):
        super().__init__(name=name)

    def call(self, params, x):
        items = x.to_list()
        outs = [(items[i] * items[j]).sum(-1, keepdim=True)
                for i in range(len(items))
                for j in range(i + 1, len(items))]
        return torch.cat(outs, -1)


class MM(Module):
    """Matrix product of ``Table(a, b)``, either transposed first."""

    def __init__(self, trans_a: bool = False, trans_b: bool = False,
                 name=None):
        super().__init__(name=name)
        self.trans_a, self.trans_b = trans_a, trans_b

    def call(self, params, x):
        a, b = x[1], x[2]
        if self.trans_a:
            a = a.transpose(-1, -2)
        if self.trans_b:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)


class MV(Module):
    """Matrix-vector product of ``Table(mat, vec)``."""

    def __init__(self, trans: bool = False, name=None):
        super().__init__(name=name)
        self.trans = trans

    def call(self, params, x):
        m, v = x[1], x[2]
        if self.trans:
            m = m.transpose(-1, -2)
        return torch.einsum("...ij,...j->...i", m, v)


class PairwiseDistance(Module):
    """The Lp distance of the rows of ``Table(a, b)``."""

    def __init__(self, norm: int = 2, name=None):
        super().__init__(name=name)
        self.norm = norm

    def call(self, params, x):
        d = jabs(x[1] - x[2])
        return torch.pow(torch.pow(d, self.norm).sum(-1), 1.0 / self.norm)


class CosineDistance(Module):
    """The cosine similarity of the rows of ``Table(a, b)``."""

    def call(self, params, x):
        a, b = x[1], x[2]
        den = torch.linalg.vector_norm(a, dim=-1) * \
            torch.linalg.vector_norm(b, dim=-1)
        return (a * b).sum(-1) / torch.maximum(den, den.new_tensor(1e-12))


class TableOperation(Module):
    """``operation(a, b)`` of ``Table(a, b)`` (a function of two tensors,
    broadcasting the smaller)."""

    def __init__(self, operation, name=None):
        super().__init__(name=name)
        self.operation = operation

    def call(self, params, x):
        return self.operation(x[1], x[2])
