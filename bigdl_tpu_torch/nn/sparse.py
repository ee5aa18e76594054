"""Sparse compute on COO tensors (counterpart of ``bigdl_tpu/nn/sparse.py``:
the reference's ``tensor/SparseTensor.scala``, ``nn/SparseLinear.scala``,
``nn/LookupTableSparse.scala``, ``nn/SparseJoinTable.scala`` and
``nn/DenseToSparse.scala``).

A :class:`SparseTensor` is a fixed-size COO triple: indices (nnz, ndim)
int32, values (nnz,) and the dense shape. Pad entries carry value 0 at
index 0, which adds nothing to the linear ops here. The products are a
row gather and a segment sum (``index_add``), as the JAX package computes
them. The multi-device ``(indices, values)`` gradient exchange that JAX
re-exports here (``sparse_embedding_grad_allreduce``) is multi-GPU work
and not ported yet.
"""
from __future__ import annotations

import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from ..utils.table import Table
from .linear import Linear, LookupTable
from .module import Module

__all__ = ["embedding_grad_rows", "SparseTensor", "sparse_dense_matmul",
           "SparseLinear", "LookupTableSparse", "SparseJoinTable",
           "DenseToSparse"]


def _segment_sum(data, segment_ids, num_segments):
    """``jax.ops.segment_sum`` over dim 0 (differentiable in ``data``)."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add(0, segment_ids.long(), data)


def embedding_grad_rows(dense_grad, ids):
    """The (B, H) per-id gradient rows of a LOCAL dense (vocab, H)
    embedding gradient, for an ``(indices, values)`` exchange: row
    ``ids[i]`` already sums every local contribution for that id, so an
    id after its first occurrence gets a zero row (first occurrences
    found by a scatter-min of positions, O(B + vocab))."""
    ids = ids.long()
    b = ids.shape[0]
    iota = torch.arange(b, device=ids.device)
    first = torch.full((dense_grad.shape[0],), b, dtype=torch.long,
                       device=ids.device).scatter_reduce(
        0, ids, iota, "amin")
    keep = first[ids] == iota
    rows = dense_grad.index_select(0, ids)
    return rows * keep[:, None].to(rows.dtype)


def _as_tensor(a, dtype=None, device=None):
    if torch.is_tensor(a):
        return a.to(dtype=dtype or a.dtype, device=device or a.device)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


class SparseTensor:
    """Static-shape COO sparse tensor: ``indices`` (nnz, ndim) int32,
    ``values`` (nnz,), ``shape``."""

    def __init__(self, indices, values, shape: Sequence[int]):
        self.indices = indices
        self.values = values
        self.shape = tuple(int(s) for s in shape)

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def _leaves(self):
        """(indices, values): the module protocol's tensor leaves."""
        return self.indices, self.values

    def _with_leaves(self, leaves):
        return SparseTensor(next(leaves), next(leaves), self.shape)

    @staticmethod
    def from_dense(arr, nnz: Optional[int] = None) -> "SparseTensor":
        """Sparsify on the host, padding the buffer to ``nnz``; raises if
        the nonzero count exceeds the budget. A tensor's result lands on
        its device."""
        dev = arr.device if torch.is_tensor(arr) else torch.device("cpu")
        a = arr.detach().cpu().numpy() if torch.is_tensor(arr) \
            else np.asarray(arr)
        idx = np.argwhere(a != 0)
        vals = a[tuple(idx.T)]
        if nnz is None:
            nnz = len(vals)
        if len(vals) > nnz:
            raise ValueError(f"{len(vals)} nonzeros exceed nnz budget {nnz}")
        pad = nnz - len(vals)
        idx = np.concatenate([idx, np.zeros((pad, a.ndim), idx.dtype)], 0)
        vals = np.concatenate([vals, np.zeros((pad,), vals.dtype)], 0)
        return SparseTensor(torch.as_tensor(idx.astype(np.int32), device=dev),
                            torch.as_tensor(vals, device=dev), a.shape)

    @staticmethod
    def coo(indices, values, shape) -> "SparseTensor":
        vals = _as_tensor(values)
        return SparseTensor(_as_tensor(indices, torch.int32, vals.device),
                            vals, shape)

    def to_dense(self):
        strides = np.cumprod([1] + list(self.shape[::-1]))[:-1][::-1]
        flat_idx = (self.indices.long() * torch.as_tensor(
            strides.copy(), device=self.indices.device)).sum(-1)
        out = self.values.new_zeros((int(np.prod(self.shape)),))
        # padded entries all hit flat index 0 with value 0
        return out.index_add(0, flat_idx, self.values).reshape(self.shape)

    def __repr__(self):
        return (f"SparseTensor(shape={self.shape}, nnz={self.nnz}, "
                f"dtype={self.values.dtype})")


def sparse_dense_matmul(sp: SparseTensor, dense):
    """(B, I) sparse @ (I, O) dense -> (B, O): a row gather and a segment
    sum."""
    if sp.ndim != 2:
        raise ValueError("sparse_dense_matmul expects a 2-D SparseTensor")
    rows = sp.indices[:, 0]
    cols = sp.indices[:, 1].long()
    contrib = sp.values[:, None].to(dense.dtype) * dense.index_select(0, cols)
    return _segment_sum(contrib, rows, sp.shape[0])


class SparseLinear(Linear):
    """nn/SparseLinear.scala: y = sparse_x @ W^T + b for a SparseTensor
    input; a dense input takes Linear's product."""

    def call(self, params, x):
        if isinstance(x, SparseTensor):
            y = sparse_dense_matmul(x, params["weight"].T)
            if "bias" in params:
                y = y + params["bias"]
            return y
        return super().call(params, x)


class LookupTableSparse(LookupTable):
    """nn/LookupTableSparse.scala (embedding_lookup_sparse): a 2-D
    SparseTensor of positive 1-based ids, or ``Table(ids, weights)`` of two
    aligned ones, or a dense (B, L) id matrix (0 is padding). Each row's
    embeddings are combined by ``combiner``: sum, mean or sqrtn (the
    weighted forms divide by sum(w) / sqrt(sum(w^2))); ``max_norm`` > 0
    L2-clips each embedding first. Id 0 adds nothing."""

    def __init__(self, n_index: int, n_output: int, combiner: str = "sum",
                 max_norm: float = -1.0, w_regularizer=None, name=None):
        if combiner not in ("sum", "mean", "sqrtn"):
            raise ValueError(f"combiner must be sum/mean/sqrtn, "
                             f"got {combiner}")
        super().__init__(n_index, n_output, w_regularizer=w_regularizer,
                         name=name)
        self.combiner = combiner
        self.max_norm = max_norm

    def call(self, params, x):
        if isinstance(x, Table):
            ids_sp, w_sp = x[1], x[2]
        elif isinstance(x, SparseTensor):
            ids_sp, w_sp = x, None
        else:
            ids_sp, w_sp = SparseTensor.from_dense(x), None
        if ids_sp.ndim != 2:
            raise ValueError("LookupTableSparse expects 2-D id tensors")
        w = params["weight"]
        ids = ids_sp.values.to(torch.int32)
        valid = (ids > 0).to(w.dtype)
        idx = (ids.long() - 1).clamp(0, self.n_index - 1)
        rows = ids_sp.indices[:, 0]
        emb = w.index_select(0, idx)
        if self.max_norm > 0:
            norms = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
            emb = emb * torch.clamp(self.max_norm / (norms + 1e-12), max=1.0)
        weights = (w_sp.values.to(emb.dtype) if w_sp is not None
                   else valid) * valid
        B = ids_sp.shape[0]
        summed = _segment_sum(emb * weights[:, None], rows, B)
        if self.combiner == "sum":
            return summed
        if self.combiner == "mean":
            denom = _segment_sum(weights, rows, B)
        else:
            denom = torch.sqrt(_segment_sum(weights ** 2, rows, B))
        return summed / torch.clamp(denom, min=1e-12)[:, None]


class SparseJoinTable(Module):
    """nn/SparseJoinTable.scala: concatenate 2-D SparseTensors along
    ``dimension`` 2 (features), the one the reference supports."""

    def __init__(self, dimension: int = 2, name=None):
        super().__init__(name=name)
        if dimension != 2:
            raise NotImplementedError("SparseJoinTable joins dimension 2 "
                                      "(features), matching the reference")
        self.dimension = dimension

    def call(self, params, x):
        tensors = [x[i + 1] for i in range(len(x))] \
            if isinstance(x, Table) else list(x)
        rows = [t.shape[0] for t in tensors]
        if len(set(rows)) != 1:
            raise ValueError("SparseJoinTable inputs need equal row counts")
        offset = 0
        idx_parts, val_parts = [], []
        for t in tensors:
            if not isinstance(t, SparseTensor):
                raise TypeError("SparseJoinTable expects SparseTensors")
            shifted = t.indices.clone()
            shifted[:, 1] += offset      # pad entries keep value 0
            idx_parts.append(shifted)
            val_parts.append(t.values)
            offset += t.shape[1]
        return SparseTensor(torch.cat(idx_parts, 0), torch.cat(val_parts, 0),
                            (rows[0], offset))


class DenseToSparse(Module):
    """nn/DenseToSparse.scala: sparsify on the host with a fixed ``nnz``
    budget (without one, the buffer is sized per batch)."""

    def __init__(self, nnz: Optional[int] = None, name=None):
        super().__init__(name=name)
        if nnz is None:
            warnings.warn(
                "DenseToSparse without an nnz budget sizes the COO buffer "
                "per batch; pass nnz=<worst case> for stable shapes",
                stacklevel=2)
        self.nnz = nnz

    def call(self, params, x):
        return SparseTensor.from_dense(x, nnz=self.nnz)
