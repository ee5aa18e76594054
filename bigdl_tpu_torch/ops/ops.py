"""TF-style operation modules (counterpart of ``bigdl_tpu/ops/ops.py``).

Parity: reference ``nn/ops/`` (Equal.scala, Gather.scala, Select.scala,
Tile.scala, TopK.scala, OneHot.scala, SegmentSum.scala, BucketizedCol.scala,
...) and ``nn/tf/`` (Shape.scala, StridedSlice.scala, SplitAndSelect.scala,
Log1p.scala, ...). Each op is one or a few eager PyTorch expressions on its
inputs' device.

Conventions:
  * multi-input ops take a ``Table`` or list (like ``nn.CAddTable``);
  * axis arguments are 0-based (TF convention);
  * ops whose reference semantics are host-side string processing
    (CategoricalColVocaList, CrossCol, MkString, Substr, ...) take numpy
    object arrays and return numpy object arrays or CPU tensors, as
    data-pipeline stages.

Where a plain torch call reads differently from the JAX package's, the op
follows JAX: ``Gather`` fills an out-of-range index (NaN for floats, the
dtype's minimum for signed integers) and wraps a negative one from the end;
``ResizeBilinear`` antialiases when it shrinks (``jax.image.resize``);
``TopK`` / ``InTopK`` / ``ArgMax`` give the lowest index among ties, as
int32; reductions of integers keep int32 and ``Mean`` of integers is
float32; ``SegmentSum`` drops out-of-range ids and sums each segment in
index order (deterministic on the card); ``Digamma`` is NaN at the poles;
``Assert`` always checks (the port is eager). ``RandomUniform`` and
``TruncatedNormal`` draw from the ``torch.Generator`` given to ``apply``,
or from one seeded with ``seed or 0`` on the output's device; JAX's key
stream is not ported.
"""
from __future__ import annotations

import functools
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.module import Module, _tensor_leaves
from ..utils.table import Table


def _items(x):
    return x.to_list() if isinstance(x, Table) else \
        (list(x) if isinstance(x, (list, tuple)) else [x])


def _t(a):
    """A tensor of ``a`` (tensors pass through; numpy and numbers go to the
    CPU, as constants)."""
    return a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))


def _device(xs):
    for x in xs:
        if torch.is_tensor(x):
            return x.device
    return torch.device("cpu")


class Operation(Module):
    """Base class: inference-style op (nn/ops/Operation.scala — ops there
    have no backward; here most are autograd-differentiable anyway)."""

    def _op(self, *xs):
        raise NotImplementedError

    def call(self, params, x):
        return self._op(*_items(x))

    def _draw_generator(self, x):
        # host-side ops take numpy object arrays: no tensor, no generator
        return super()._draw_generator(x) if _tensor_leaves(x) else None


def _unary(fn, doc_ref):
    class _Op(Operation):
        def _op(self, a):
            return fn(_t(a))
    _Op.__doc__ = doc_ref
    return _Op


def _binary(fn, doc_ref):
    class _Op(Operation):
        def _op(self, a, b):
            return fn(_t(a), _t(b))
    _Op.__doc__ = doc_ref
    return _Op


# -- comparison (nn/ops/Equal.scala, Greater.scala, ...) --------------------

Equal = _binary(torch.eq, "nn/ops/Equal.scala")
NotEqual = _binary(torch.ne, "nn/ops/NotEqual.scala")
Greater = _binary(torch.gt, "nn/ops/Greater.scala")
GreaterEqual = _binary(torch.ge, "nn/ops/GreaterEqual.scala")
Less = _binary(torch.lt, "nn/ops/Less.scala")
LessEqual = _binary(torch.le, "nn/ops/LessEqual.scala")


class ApproximateEqual(Operation):
    """nn/ops/ApproximateEqual.scala — |a - b| < tolerance."""

    def __init__(self, tolerance: float = 1e-5, name=None):
        super().__init__(name=name)
        self.tolerance = tolerance

    def _op(self, a, b):
        return torch.abs(_t(a) - _t(b)) < self.tolerance


# -- logical (nn/ops/LogicalAnd.scala, ...) ---------------------------------

LogicalAnd = _binary(torch.logical_and, "nn/ops/LogicalAnd.scala")
LogicalOr = _binary(torch.logical_or, "nn/ops/LogicalOr.scala")
LogicalNot = _unary(torch.logical_not, "nn/ops/LogicalNot.scala")


def _float(a):
    return a if a.is_floating_point() else a.to(torch.float32)


def _int32_acc(a):
    """JAX (64-bit types off) sums booleans and signed integers in int32."""
    if a.dtype == torch.bool or (not a.is_floating_point()
                                 and not a.is_complex()
                                 and a.dtype != torch.uint8):
        return torch.int32
    return None


def _all(a, dim, keepdim):
    return torch.all(a, dim=dim, keepdim=keepdim)


def _any(a, dim, keepdim):
    return torch.any(a, dim=dim, keepdim=keepdim)


def _sum(a, dim, keepdim):
    return torch.sum(a, dim=dim, keepdim=keepdim, dtype=_int32_acc(a))


def _prod(a, dim, keepdim):
    dt = _int32_acc(a)
    if a.dtype == torch.bool:
        a = a.to(torch.int32)
    return torch.prod(a, dim=dim, keepdim=keepdim, dtype=dt)


def _max(a, dim, keepdim):
    return torch.amax(a, dim=dim, keepdim=keepdim)


def _min(a, dim, keepdim):
    return torch.amin(a, dim=dim, keepdim=keepdim)


def _axes(axis, ndim):
    """TF reduction indices (an int, a sequence, a tensor or None for
    every axis) -> sorted non-negative dims."""
    if axis is None:
        return tuple(range(ndim))
    if torch.is_tensor(axis):
        axis = axis.cpu().numpy()
    return tuple(sorted({int(i) % ndim for i in np.asarray(axis).reshape(-1)}))


class _Reduction(Operation):
    """Base for All/Any/Sum/Prod/Max: second input (or ctor arg) gives the
    reduction indices, TF-style."""

    _fn = None

    def __init__(self, axis=None, keep_dims: bool = False, name=None):
        super().__init__(name=name)
        self.axis, self.keep_dims = axis, keep_dims

    def _op(self, a, axis=None):
        a = _t(a)
        ax = _axes(self.axis if axis is None else axis, a.dim())
        fn = type(self)._fn
        if not ax:                           # no axis: JAX's dtype, no sum
            return fn(a.unsqueeze(0), 0, False)
        # one axis at a time (prod / all / any take one dim), last first
        out = a
        for d in sorted(ax, reverse=True):
            out = fn(out, d, self.keep_dims)
        return out


class All(_Reduction):
    """nn/ops/All.scala"""
    _fn = staticmethod(_all)


class Any(_Reduction):
    """nn/ops/Any.scala"""
    _fn = staticmethod(_any)


class Sum(_Reduction):
    """nn/ops/Sum.scala"""
    _fn = staticmethod(_sum)


class Prod(_Reduction):
    """nn/ops/Prod.scala"""
    _fn = staticmethod(_prod)


class Max(_Reduction):
    """nn/ops/Max.scala"""
    _fn = staticmethod(_max)


class Min(_Reduction):
    """tf Min (reference folds into Max.scala pattern)"""
    _fn = staticmethod(_min)


class Mean(_Reduction):
    """tf Mean (nn/ops reduction family): one mean over every axis given
    (integers as float32)."""

    def _op(self, a, axis=None):
        a = _float(_t(a))
        ax = _axes(self.axis if axis is None else axis, a.dim())
        if not ax:
            return a.clone()
        return torch.mean(a, dim=ax, keepdim=self.keep_dims)


# -- elementwise math (nn/ops/Exp.scala, Floor.scala, ...) ------------------

def _digamma(a):
    a = _float(a)
    pole = (a <= 0) & (a == torch.floor(a))
    return torch.where(pole, torch.full_like(a, float("nan")),
                       torch.special.digamma(a))


def _floor_divide(a, b):
    if a.is_floating_point() or b.is_floating_point():
        return torch.div(a, b, rounding_mode="floor")
    return torch.floor_divide(a, b)


def _truncate_div(a, b):
    return torch.trunc(a / b).to(a.dtype)


Exp = _unary(lambda a: torch.exp(_float(a)), "nn/ops/Exp.scala")
Expm1 = _unary(lambda a: torch.expm1(_float(a)), "nn/ops/Expm1.scala")
Log1p = _unary(lambda a: torch.log1p(_float(a)), "nn/tf/Log1p.scala")
Floor = _unary(torch.floor, "nn/ops/Floor.scala")
Ceil = _unary(torch.ceil, "nn/ops/Ceil.scala")
Round = _unary(torch.round, "nn/ops/Round.scala")
Rint = _unary(torch.round, "nn/ops/Rint.scala")
Sign = _unary(torch.sign, "nn/ops/Sign.scala")
Inv = _unary(lambda a: 1.0 / a, "nn/ops/Inv.scala (reciprocal)")
Erf = _unary(lambda a: torch.special.erf(_float(a)), "nn/ops/Erf.scala")
Erfc = _unary(lambda a: torch.special.erfc(_float(a)), "nn/ops/Erfc.scala")
Lgamma = _unary(lambda a: torch.lgamma(_float(a)), "nn/ops/Lgamma.scala")
Digamma = _unary(_digamma, "nn/ops/Digamma.scala")
IsFinite = _unary(torch.isfinite, "nn/ops/IsFinite.scala")
IsInf = _unary(torch.isinf, "nn/ops/IsInf.scala")
IsNan = _unary(torch.isnan, "nn/ops/IsNan.scala")

Pow = _binary(torch.pow, "nn/ops/Pow.scala")
Maximum = _binary(torch.maximum, "nn/ops/Maximum.scala")
Minimum = _binary(torch.minimum, "nn/ops/Minimum.scala")
FloorDiv = _binary(_floor_divide, "nn/ops/FloorDiv.scala")
FloorMod = _binary(torch.remainder, "nn/ops/FloorMod.scala")
Mod = _binary(torch.remainder, "nn/ops/Mod.scala")
TruncateDiv = _binary(_truncate_div, "nn/ops/TruncateDiv.scala")
SquaredDifference = _binary(
    lambda a, b: torch.square(a - b), "nn/ops/SquaredDifference.scala")


# -- shape/metadata (nn/tf/Shape.scala, nn/ops/Rank.scala) ------------------

Shape = _unary(lambda a: torch.tensor(list(a.shape), dtype=torch.int32,
                                      device=a.device), "nn/tf/Shape.scala")
Rank = _unary(lambda a: torch.tensor(a.dim(), dtype=torch.int32,
                                     device=a.device), "nn/ops/Rank.scala")


_NP_TO_TORCH = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
    "complex64": torch.complex64,
}


def to_torch_dtype(dtype) -> torch.dtype:
    """A numpy dtype, its name or a torch dtype -> the torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    return _NP_TO_TORCH[name]


class Cast(Operation):
    """nn/ops/Cast.scala"""

    def __init__(self, dtype, name=None):
        super().__init__(name=name)
        self.dtype = to_torch_dtype(dtype)

    def _op(self, a):
        return _t(a).to(self.dtype)


# -- array ops --------------------------------------------------------------

def _fill_value(dtype):
    """What JAX's gather returns for an index out of range."""
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    if dtype == torch.bool:
        return True
    if dtype == torch.uint8:
        return 255
    return torch.iinfo(dtype).min


def take(a, idx, axis):
    """``jnp.take(a, idx, axis)``: a negative index counts from the end, an
    index out of range gives the fill value."""
    n = a.shape[axis]
    idx = idx.to(device=a.device, dtype=torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    out = torch.index_select(a, axis, torch.where(ok, idx, 0).reshape(-1))
    out = out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])
    shape = [1] * axis + list(ok.shape) + [1] * (a.dim() - axis - 1)
    return torch.where(ok.reshape(shape), out,
                       torch.full((), _fill_value(a.dtype), dtype=a.dtype,
                                  device=a.device))


class Gather(Operation):
    """nn/ops/Gather.scala — gather rows of ``params`` along ``axis`` by
    integer ``indices`` (JAX's ``jnp.take``)."""

    def __init__(self, axis: int = 0, name=None):
        super().__init__(name=name)
        self.axis = axis

    def _op(self, params_t, indices):
        a = _t(params_t)
        return take(a, _t(indices).to(torch.int32), self.axis % a.dim())


class Select(Operation):
    """nn/ops/Select.scala — elementwise cond ? x : y."""

    def _op(self, cond, x, y):
        return torch.where(_t(cond).bool(), _t(x), _t(y))


def slice_dim(a, dim, start, stop, step):
    """``a[..., start:stop:step, ...]`` along ``dim``, negative steps
    included (torch's slicing takes positive ones only)."""
    start, stop, step = slice(start, stop, step).indices(a.shape[dim])
    if step > 0:
        idx = [slice(None)] * dim + [slice(start, stop, step)]
        return a[tuple(idx)]
    sel = torch.arange(start, stop, step, device=a.device)
    return torch.index_select(a, dim, sel)


class Slice(Operation):
    """nn/ops/Slice.scala — static begin/size slice."""

    def __init__(self, begin, size, name=None):
        super().__init__(name=name)
        self.begin = [int(b) for b in begin]
        self.size = [int(s) for s in size]

    def _op(self, a):
        idx = tuple(
            slice(b, a.shape[i] if s == -1 else b + s)
            for i, (b, s) in enumerate(zip(self.begin, self.size)))
        return _t(a)[idx]


class StridedSlice(Operation):
    """nn/tf/StridedSlice.scala — static begin/end/strides with shrink mask."""

    def __init__(self, begin, end, strides=None, shrink_axis_mask: int = 0,
                 begin_mask: int = 0, end_mask: int = 0, name=None):
        super().__init__(name=name)
        self.begin = [int(b) for b in begin]
        self.end = [int(e) for e in end]
        self.strides = [int(s) for s in (strides or [1] * len(self.begin))]
        self.shrink = shrink_axis_mask
        self.begin_mask, self.end_mask = begin_mask, end_mask

    def _op(self, a):
        out = _t(a)
        shrink = []
        for d in range(len(self.begin)):
            if (self.shrink >> d) & 1:
                shrink.append(d)
                b = self.begin[d]
                out = slice_dim(out, d, b, b + 1 if b != -1 else None, 1)
                continue
            b = None if (self.begin_mask >> d) & 1 else self.begin[d]
            e = None if (self.end_mask >> d) & 1 else self.end[d]
            out = slice_dim(out, d, b, e, self.strides[d])
        for d in reversed(shrink):
            out = out.squeeze(d)
        return out


class Tile(Operation):
    """nn/ops/Tile.scala — second input (or ctor) gives multiples."""

    def __init__(self, multiples=None, name=None):
        super().__init__(name=name)
        self.multiples = multiples

    def _op(self, a, multiples=None):
        m = self.multiples if multiples is None else \
            [int(x) for x in np.asarray(
                multiples.cpu() if torch.is_tensor(multiples)
                else multiples).reshape(-1)]
        return torch.tile(_t(a), tuple(int(x) for x in m))


def one_hot(indices, depth, axis=-1, dtype=torch.float32):
    """``jax.nn.one_hot``: an index out of [0, depth) gives a row of
    zeros; the new axis sits at ``axis`` of the output."""
    idx = indices.to(torch.int64)
    oh = (idx.unsqueeze(-1) == torch.arange(depth, device=idx.device)
          ).to(dtype)
    return torch.movedim(oh, -1, axis)


class OneHot(Operation):
    """nn/ops/OneHot.scala — indices → one-hot on a new last (or given) axis."""

    def __init__(self, depth: int, on_value: float = 1.0,
                 off_value: float = 0.0, axis: int = -1, name=None):
        super().__init__(name=name)
        self.depth, self.axis = depth, axis
        self.on_value, self.off_value = on_value, off_value

    def _op(self, indices):
        oh = one_hot(_t(indices).to(torch.int32), self.depth, self.axis)
        return oh * (self.on_value - self.off_value) + self.off_value


def top_k(a, k):
    """``lax.top_k``: the k largest along the last axis, the lowest index
    first among ties (a stable descending sort), indices int32."""
    v, i = torch.sort(a, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k].to(torch.int32)


class TopK(Operation):
    """nn/ops/TopK.scala — returns Table(values, indices)."""

    def __init__(self, k: int, sorted: bool = True, name=None):
        super().__init__(name=name)
        self.k = k

    def _op(self, a):
        v, i = top_k(_t(a), self.k)
        return Table(v, i)


class InTopK(Operation):
    """nn/ops/InTopK.scala — targets ∈ top-k(predictions) per row."""

    def __init__(self, k: int, name=None):
        super().__init__(name=name)
        self.k = k

    def _op(self, predictions, targets):
        _, idx = top_k(_t(predictions), self.k)
        t = _t(targets).to(device=idx.device, dtype=torch.int32)
        return torch.any(idx == t[:, None], dim=-1)


class ArgMax(Operation):
    """nn/ops/ArgMax.scala — axis from ctor or second input."""

    def __init__(self, axis: int = 0, name=None):
        super().__init__(name=name)
        self.axis = axis

    def _op(self, a, axis=None):
        ax = self.axis if axis is None else int(np.asarray(
            axis.cpu() if torch.is_tensor(axis) else axis).reshape(()))
        a = _t(a)
        if a.dtype == torch.bool:
            a = a.to(torch.int32)
        return torch.argmax(a, dim=ax).to(torch.int32)


class BatchMatMul(Operation):
    """nn/ops/BatchMatMul.scala — batched matmul with optional adjoints."""

    def __init__(self, adj_x: bool = False, adj_y: bool = False, name=None):
        super().__init__(name=name)
        self.adj_x, self.adj_y = adj_x, adj_y

    def _op(self, x, y):
        x, y = _t(x), _t(y)
        if self.adj_x:
            x = torch.swapaxes(x, -1, -2)
        if self.adj_y:
            y = torch.swapaxes(y, -1, -2)
        return torch.matmul(x, y)


def segment_sum(data, segment_ids, num_segments):
    """``jax.ops.segment_sum``: ids outside [0, num_segments) are dropped;
    each segment sums its rows in index order (a stable sort by id, then
    ``torch.segment_reduce``), so the card's sums are deterministic.
    Integer data sums in int32, as JAX's does."""
    ids = segment_ids.to(device=data.device, dtype=torch.int64)
    rows = data.reshape((ids.numel(),) + data.shape[ids.dim():])
    ids = ids.reshape(-1)
    ok = (ids >= 0) & (ids < num_segments)
    ids, rows = ids[ok], rows[ok]
    if not rows.is_floating_point():     # exact in any order
        out = torch.zeros((num_segments,) + rows.shape[1:],
                          dtype=torch.int64, device=rows.device)
        out.index_add_(0, ids, rows.to(torch.int64))
        return out.to(_int32_acc(rows) or rows.dtype)
    order = torch.sort(ids, stable=True).indices
    counts = torch.bincount(ids, minlength=num_segments)
    return torch.segment_reduce(rows[order], "sum", lengths=counts, axis=0,
                                unsafe=True)


class SegmentSum(Operation):
    """nn/ops/SegmentSum.scala — ``jax.ops.segment_sum`` (see
    :func:`segment_sum`)."""

    def __init__(self, num_segments=None, name=None):
        super().__init__(name=name)
        self.num_segments = num_segments

    def _op(self, data, segment_ids):
        ids = _t(segment_ids)
        n = self.num_segments
        if n is None:
            n = int(ids.max()) + 1  # host-side like ref
        return segment_sum(_t(data), ids.to(torch.int32), n)


class Pad(Operation):
    """nn/ops/Pad.scala — constant padding, paddings as (ndim, 2)."""

    def __init__(self, paddings, constant_value: float = 0.0, name=None):
        super().__init__(name=name)
        self.paddings = [tuple(int(x) for x in p) for p in np.asarray(paddings)]
        self.constant_value = constant_value

    def _op(self, a):
        flat = [v for p in reversed(self.paddings) for v in p]
        return F.pad(_t(a), flat, value=self.constant_value)


class ExpandDims(Operation):
    """tf ExpandDims (reference folds into array ops)"""

    def __init__(self, axis: int, name=None):
        super().__init__(name=name)
        self.axis = axis

    def _op(self, a):
        a = _t(a)
        return a.unsqueeze(self.axis if self.axis >= 0
                           else a.dim() + 1 + self.axis)


def split(a, n, axis):
    """``jnp.split(a, n, axis)`` into equal pieces (ValueError otherwise)."""
    size = a.shape[axis]
    if size % n:
        raise ValueError("array split does not result in an equal division: "
                         f"{size} into {n}")
    return list(torch.split(a, size // n, dim=axis))


class SplitAndSelect(Operation):
    """nn/tf/SplitAndSelect.scala — split along a dim, return one piece."""

    def __init__(self, dim: int, index: int, num_split: int, name=None):
        super().__init__(name=name)
        self.dim, self.index, self.num_split = dim, index, num_split

    def _op(self, a):
        return split(_t(a), self.num_split, self.dim)[self.index]


class InvertPermutation(Operation):
    """nn/tf/ArrayOps.scala InvertPermutation"""

    def _op(self, p):
        return torch.argsort(_t(p).to(torch.int32), stable=True).to(
            torch.int32)


class Pack(Operation):
    """tf Pack/Stack (nn/tf/ArrayOps family) — stack inputs on ``axis``."""

    def __init__(self, axis: int = 0, name=None):
        super().__init__(name=name)
        self.axis = axis

    def _op(self, *xs):
        return torch.stack([_t(x) for x in xs], dim=self.axis)


class Split(Operation):
    """tf Split — equal split along ``axis``; returns a Table of pieces."""

    def __init__(self, num_split: int, axis: int = 0, name=None):
        super().__init__(name=name)
        self.num_split, self.axis = num_split, axis

    def _op(self, a):
        return Table(*split(_t(a), self.num_split, self.axis))


class Unpack(Operation):
    """tf Unpack/Unstack — split along ``axis`` and squeeze it; Table out."""

    def __init__(self, num: int, axis: int = 0, name=None):
        super().__init__(name=name)
        self.num, self.axis = num, axis

    def _op(self, a):
        pieces = split(_t(a), self.num, self.axis)
        return Table(*[p.squeeze(self.axis) for p in pieces])


def _linspace(start, stop, num, device):
    """``jnp.linspace`` in float32: start + step * i, the last exactly."""
    if num == 1:
        return torch.tensor([float(start)], dtype=torch.float32,
                            device=device)
    step = (stop - start) / (num - 1)
    out = torch.arange(num, dtype=torch.float32, device=device) * \
        torch.tensor(step, dtype=torch.float32) + start
    out[-1] = float(stop)
    return out


class ResizeBilinear(Operation):
    """nn/ops/ResizeBilinear.scala — bilinear resize, NHWC by default.
    Without ``align_corners`` it is ``jax.image.resize(..., "bilinear")``:
    half-pixel centres, and a triangle kernel widened by the scale when it
    shrinks (antialiased, ``F.interpolate(antialias=True)``)."""

    def __init__(self, output_height: int, output_width: int,
                 align_corners: bool = False, data_format: str = "NHWC",
                 name=None):
        super().__init__(name=name)
        self.oh, self.ow = output_height, output_width
        self.align_corners = align_corners
        self.data_format = data_format

    def _op(self, a):
        a = _t(a)
        nhwc = self.data_format == "NHWC"
        if nhwc:
            a = a.permute(0, 3, 1, 2)
        b, c, h, w = a.shape
        if self.align_corners and h > 1 and w > 1:
            # align_corners: endpoints map to endpoints
            ys = _linspace(0, h - 1, self.oh, a.device)
            xs = _linspace(0, w - 1, self.ow, a.device)
            y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, h - 2)
            x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, w - 2)
            wy = (ys - y0)[None, None, :, None]
            wx = (xs - x0)[None, None, None, :]
            g00 = a[:, :, y0][:, :, :, x0]
            g01 = a[:, :, y0][:, :, :, x0 + 1]
            g10 = a[:, :, y0 + 1][:, :, :, x0]
            g11 = a[:, :, y0 + 1][:, :, :, x0 + 1]
            out = (g00 * (1 - wy) * (1 - wx) + g01 * (1 - wy) * wx +
                   g10 * wy * (1 - wx) + g11 * wy * wx)
        else:
            out = F.interpolate(_float(a), size=(self.oh, self.ow),
                                mode="bilinear", align_corners=False,
                                antialias=True)
        if nhwc:
            out = out.permute(0, 2, 3, 1)
        return out.contiguous()


class Dilation2D(Operation):
    """nn/ops/Dilation2D.scala — grayscale morphological dilation: NHWC input,
    (kh, kw, C) filter; out = max over window of (input + filter), SAME
    padding with -inf."""

    def __init__(self, strides, rates, padding: str = "SAME", name=None):
        super().__init__(name=name)
        self.strides = [int(s) for s in strides]
        self.rates = [int(r) for r in rates]
        self.padding = padding

    def _op(self, a, filt):
        a, filt = _t(a), _t(filt)
        kh, kw, c = filt.shape
        sh, sw = self.strides[1], self.strides[2]
        rh, rw = self.rates[1], self.rates[2]
        eff_kh, eff_kw = (kh - 1) * rh + 1, (kw - 1) * rw + 1
        b, h, w, _ = a.shape
        if self.padding == "SAME":
            oh = -(-h // sh)
            ow = -(-w // sw)
            ph = max(0, (oh - 1) * sh + eff_kh - h)
            pw = max(0, (ow - 1) * sw + eff_kw - w)
            a = F.pad(a, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2),
                      value=float("-inf"))
        else:
            oh = (h - eff_kh) // sh + 1
            ow = (w - eff_kw) // sw + 1
        outs = []
        for i in range(kh):
            for j in range(kw):
                patch = a[:, i * rh:i * rh + (oh - 1) * sh + 1:sh,
                          j * rw:j * rw + (ow - 1) * sw + 1:sw, :]
                outs.append(patch + filt[i, j])
        return functools.reduce(torch.maximum, outs)


# -- losses / misc ----------------------------------------------------------

class L2Loss(Operation):
    """nn/ops/L2Loss.scala — sum(x^2) / 2."""

    def _op(self, a):
        return torch.sum(torch.square(_t(a))) / 2.0


class CrossEntropy(Operation):
    """nn/ops/CrossEntropy.scala — per-row softmax cross entropy from
    (logits, one-hot labels)."""

    def _op(self, logits, labels):
        logp = torch.log_softmax(_t(logits), dim=-1)
        return -torch.sum(_t(labels) * logp, dim=-1)


def _shape_of(x):
    v = _items(x)[0]
    v = v.cpu() if torch.is_tensor(v) else v
    return tuple(int(s) for s in np.asarray(v).reshape(-1)), \
        _device(_items(x))


def _seeded(generator, seed, device):
    if generator is not None:
        return generator
    return torch.Generator(device=device).manual_seed(seed or 0)


class RandomUniform(Operation):
    """nn/ops/RandomUniform.scala — shape input → uniform sample, drawn
    from the generator given to ``apply`` (else one seeded with
    ``seed or 0`` on the shape input's device)."""

    def __init__(self, minval: float = 0.0, maxval: float = 1.0, seed=None,
                 name=None):
        super().__init__(name=name)
        self.minval, self.maxval, self.seed = minval, maxval, seed

    def apply(self, params, state, x, training=False, generator=None):
        shape, dev = _shape_of(x)
        g = _seeded(generator, self.seed, dev)
        u = torch.rand(shape, generator=g, device=g.device)
        return self.minval + (self.maxval - self.minval) * u, state


class TruncatedNormal(Operation):
    """nn/ops/TruncatedNormal.scala — shape input → normal truncated to
    (-2, 2) standard deviations (by inverting the normal CDF of a uniform
    draw), drawn as :class:`RandomUniform` draws."""

    def __init__(self, mean: float = 0.0, stddev: float = 1.0, seed=None,
                 name=None):
        super().__init__(name=name)
        self.mean, self.stddev, self.seed = mean, stddev, seed

    def apply(self, params, state, x, training=False, generator=None):
        shape, dev = _shape_of(x)
        g = _seeded(generator, self.seed, dev)
        lo = torch.special.erf(torch.tensor(-2.0 / np.sqrt(2.0)))
        hi = torch.special.erf(torch.tensor(2.0 / np.sqrt(2.0)))
        u = torch.rand(shape, generator=g, device=g.device)
        z = np.sqrt(2.0) * torch.special.erfinv(lo.to(u.device) +
                                                (hi - lo).to(u.device) * u)
        z = torch.clamp(z, -2.0, 2.0)
        return self.mean + self.stddev * z, state


class ModuleToOperation(Operation):
    """nn/ops/ModuleToOperation.scala — wrap any nn module as an op (its
    parameter and state trees are the module's own, as in JAX)."""

    def __init__(self, module: Module, name=None):
        super().__init__(name=name)
        self.module = module

    @property
    def params(self):
        return self.module.params

    @property
    def state(self):
        return self.module.state

    def apply(self, params, state, x, training=False, generator=None):
        return self.module.apply(params, state, x, training, generator)


class TensorOp(Operation):
    """nn/ops/TensorOp.scala — chainable pointwise transform built from a
    function; ``TensorOp.exp().add(1.0)`` style composition."""

    def __init__(self, fn=None, name=None):
        super().__init__(name=name)
        self.fn = fn or (lambda t: t)

    def _op(self, a):
        return self.fn(_t(a))

    def _chain(self, g):
        f = self.fn
        return TensorOp(lambda t: g(f(t)), name=self.name)

    def add(self, v):
        return self._chain(lambda t: t + v)

    def sub(self, v):
        return self._chain(lambda t: t - v)

    def mul(self, v):
        return self._chain(lambda t: t * v)

    def div(self, v):
        return self._chain(lambda t: t / v)

    def exp(self):
        return self._chain(torch.exp)

    def log(self):
        return self._chain(torch.log)

    def abs(self):
        return self._chain(torch.abs)

    def sqrt(self):
        return self._chain(torch.sqrt)

    def square(self):
        return self._chain(torch.square)

    def pow(self, p):
        return self._chain(lambda t: torch.pow(t, p))


# -- feature-column ops (recommender pipelines) -----------------------------

class BucketizedCol(Operation):
    """nn/ops/BucketizedCol.scala — numeric → bucket index by boundaries."""

    def __init__(self, boundaries, name=None):
        super().__init__(name=name)
        self.boundaries = torch.as_tensor(np.asarray(boundaries, np.float32))

    def _op(self, a):
        a = _t(a).to(torch.float32)
        return torch.searchsorted(self.boundaries.to(a.device),
                                  a.contiguous(), right=True,
                                  out_int32=True)


def _host(a):
    return np.asarray(a.cpu() if torch.is_tensor(a) else a)


def _int32_tensor(flat, shape):
    return torch.from_numpy(np.array(flat, np.int32).reshape(shape))


class CategoricalColHashBucket(Operation):
    """nn/ops/CategoricalColHashBucket.scala — string/int column → stable
    hash bucket. Host-side (numpy object arrays), like the reference's
    driver-side feature columns."""

    def __init__(self, hash_bucket_size: int, name=None):
        super().__init__(name=name)
        self.hash_bucket_size = hash_bucket_size

    def _op(self, a):
        arr = _host(a)
        flat = [zlib.crc32(str(x).encode()) % self.hash_bucket_size
                for x in arr.reshape(-1)]
        return _int32_tensor(flat, arr.shape)


class CategoricalColVocaList(Operation):
    """nn/ops/CategoricalColVocaList.scala — vocabulary lookup with optional
    OOV buckets. Host-side."""

    def __init__(self, vocab, default_value: int = -1, num_oov_buckets: int = 0,
                 name=None):
        super().__init__(name=name)
        self.vocab = {v: i for i, v in enumerate(vocab)}
        self.default_value = default_value
        self.num_oov_buckets = num_oov_buckets

    def _op(self, a):
        arr = _host(a)
        n = len(self.vocab)

        def lookup(x):
            key = x if isinstance(x, str) else str(x)
            if key in self.vocab:
                return self.vocab[key]
            if self.num_oov_buckets > 0:
                return n + zlib.crc32(key.encode()) % self.num_oov_buckets
            return self.default_value
        return _int32_tensor([lookup(x) for x in arr.reshape(-1)],
                             arr.shape)


class CrossCol(Operation):
    """nn/ops/CrossCol.scala — hash-cross of several sparse columns.
    Host-side; inputs are equal-length columns."""

    def __init__(self, hash_bucket_size: int, name=None):
        super().__init__(name=name)
        self.hash_bucket_size = hash_bucket_size

    def _op(self, *cols):
        arrs = [_host(c) for c in cols]
        out = []
        for row in zip(*[a.reshape(-1) for a in arrs]):
            key = "_X_".join(str(x) for x in row)
            out.append(zlib.crc32(key.encode()) % self.hash_bucket_size)
        return _int32_tensor(out, arrs[0].shape)


class IndicatorCol(Operation):
    """nn/ops/IndicatorCol.scala — category indices → multi-hot row."""

    def __init__(self, feat_len: int, name=None):
        super().__init__(name=name)
        self.feat_len = feat_len

    def _op(self, a):
        oh = one_hot(_t(a).to(torch.int32), self.feat_len)
        if oh.dim() > 2:
            oh = torch.amax(oh, dim=-2)
        return oh


class Kv2Tensor(Operation):
    """nn/ops/Kv2Tensor.scala — 'k:v,k:v' strings → dense row. Host-side."""

    def __init__(self, kv_delimiter: str = ",", item_delimiter: str = ":",
                 feat_len: int = 0, name=None):
        super().__init__(name=name)
        self.kv_delimiter, self.item_delimiter = kv_delimiter, item_delimiter
        self.feat_len = feat_len

    def _op(self, a):
        arr = _host(a).reshape(-1)
        out = np.zeros((len(arr), self.feat_len), np.float32)
        for r, s in enumerate(arr):
            for item in str(s).split(self.kv_delimiter):
                if not item:
                    continue
                k, _, v = item.partition(self.item_delimiter)
                idx = int(k)
                if 0 <= idx < self.feat_len:
                    out[r, idx] = float(v or 0.0)
        return torch.from_numpy(out)


class MkString(Operation):
    """nn/ops/MkString.scala — join a row's values into one string.
    Host-side; returns a numpy object array."""

    def __init__(self, str_delimiter: str = ",", name=None):
        super().__init__(name=name)
        self.str_delimiter = str_delimiter

    def _op(self, a):
        arr = _host(a)
        return np.array([self.str_delimiter.join(str(x) for x in row)
                         for row in arr.reshape(arr.shape[0], -1)],
                        dtype=object)


class Substr(Operation):
    """nn/ops/Substr.scala — substring of a string column. Host-side."""

    def __init__(self, pos: int, length: int, name=None):
        super().__init__(name=name)
        self.pos, self.length = pos, length

    def _op(self, a):
        arr = _host(a)
        return np.array([str(x)[self.pos:self.pos + self.length]
                         for x in arr.reshape(-1)],
                        dtype=object).reshape(arr.shape)


class RangeOps(Operation):
    """nn/ops/RangeOps.scala — Table(start, limit, delta) → int32 arange on
    the bounds' device. The bounds are read on the host (the output length
    depends on them)."""

    def _op(self, start, limit, delta):
        dev = _device([start, limit, delta])
        return torch.arange(int(_host(start)), int(_host(limit)),
                            int(_host(delta)), dtype=torch.int32,
                            device=dev)


class DepthwiseConv2D(Operation):
    """nn/ops/DepthwiseConv2D.scala — Table(input, filter) depthwise conv.

    ``filter`` uses the TF layout (kh, kw, in_channels, channel_multiplier);
    output channels = in_channels * channel_multiplier, grouped
    in-channel-major (``groups = in_channels``)."""

    def __init__(self, stride_w=1, stride_h=1, pad_w=0, pad_h=0,
                 data_format="NHWC", name=None):
        super().__init__(name=name)
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        assert data_format in ("NHWC", "NCHW"), data_format
        self.data_format = data_format

    def _op(self, x, w):
        x, w = _t(x), _t(w)
        kh, kw, cin, mult = w.shape
        rhs = w.permute(2, 3, 0, 1).reshape(cin * mult, 1, kh, kw)
        if self.data_format == "NHWC":
            x = x.permute(0, 3, 1, 2)
        y = F.conv2d(x, rhs.to(x.dtype), None,
                     (self.stride_h, self.stride_w),
                     (self.pad_h, self.pad_w), 1, cin)
        if self.data_format == "NHWC":
            y = y.permute(0, 2, 3, 1).contiguous()
        return y


__all__ = [
    "Operation", "RangeOps", "DepthwiseConv2D",
    "Compare", "Assert", "NoOp", "ControlDependency", "BiasAdd",
    "TensorModuleWrapper",
    "Equal", "NotEqual", "ApproximateEqual", "Greater",
    "GreaterEqual", "Less", "LessEqual", "LogicalAnd", "LogicalOr",
    "LogicalNot", "All", "Any", "Sum", "Prod", "Max", "Min", "Mean",
    "Exp", "Expm1", "Log1p", "Floor", "Ceil", "Round", "Rint", "Sign",
    "Inv", "Erf", "Erfc", "Lgamma", "Digamma", "IsFinite", "IsInf",
    "IsNan", "Pow", "Maximum", "Minimum", "FloorDiv", "FloorMod", "Mod",
    "TruncateDiv", "SquaredDifference", "Shape", "Rank", "Cast", "Gather",
    "Select", "Slice", "StridedSlice", "Tile", "OneHot", "TopK", "InTopK",
    "ArgMax", "BatchMatMul", "SegmentSum", "Pad", "ExpandDims",
    "SplitAndSelect", "InvertPermutation", "Pack", "Split", "Unpack",
    "ResizeBilinear", "Dilation2D",
    "L2Loss", "CrossEntropy", "RandomUniform", "TruncatedNormal",
    "ModuleToOperation", "TensorOp", "BucketizedCol",
    "CategoricalColHashBucket", "CategoricalColVocaList", "CrossCol",
    "IndicatorCol", "Kv2Tensor", "MkString", "Substr",
]


class Compare(Operation):
    """Abstract base of the comparison ops (nn/ops/Compare.scala) — kept
    for API parity; concrete subclasses implement ``_cmp``."""

    def _cmp(self, a, b):
        raise NotImplementedError

    def _op(self, a, b):
        return self._cmp(_t(a), _t(b))


class Assert(Operation):
    """nn/tf/Assert — checks a predicate and passes data through. The port
    runs eagerly, so the check always runs (JAX skips it under trace)."""

    def _op(self, pred, *data):
        if not bool(torch.all(_t(pred))):
            # a plain `assert` would be stripped under python -O
            raise ValueError("Assert op failed")
        return data[0] if len(data) == 1 else Table(*data)


class NoOp(Operation):
    """nn/tf/NoOp — control-dependency placeholder; identity."""

    def _op(self, *xs):
        return xs[0] if xs else torch.zeros(())


class ControlDependency(NoOp):
    """nn/tf/ControlDependency — data dependencies are the schedule; this
    passes its first input through unchanged."""


class BiasAdd(Operation):
    """nn/tf/BiasAdd — add a 1-D bias over the trailing (channel) dim."""

    def _op(self, x, bias):
        x, bias = _t(x), _t(bias)
        return x + bias.to(x.device).reshape((1,) * (x.dim() - 1) + (-1,))


class TensorModuleWrapper(ModuleToOperation):
    """nn/tf/TensorModuleWrapper — alias of ModuleToOperation here (both
    lift a TensorModule into the op world)."""
