"""Shape, slicing and resampling layers (counterpart of
``bigdl_tpu/nn/shape_ops.py``).

Dimension arguments are 1-based (the reference's torch convention); the
layers that take ``n_input_dims`` shift the dim by the batch dims present
(:func:`_dim0`). ``Max`` / ``Min`` split the gradient of a tied extreme
evenly, as ``jnp.max`` does (``torch.amax``). ``ResizeBilinear`` is
``jax.image.resize``'s bilinear: a triangle filter whose weights are
computed per axis and contracted, antialiased (the filter widened by the
shrink factor) when the output is smaller; ``F.interpolate`` samples
without that filter.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.table import Table
from .module import Module

__all__ = ["Reshape", "View", "InferReshape", "Squeeze", "Unsqueeze",
           "Transpose", "Replicate", "Padding", "SpatialZeroPadding",
           "Narrow", "Select", "Index", "MaskedSelect", "Max", "Min", "Mean",
           "Sum", "Tile", "ExpandSize", "Cropping2D", "Cropping3D",
           "Reverse", "Pack", "UpSampling1D", "UpSampling2D", "UpSampling3D",
           "ResizeBilinear"]


def _dim0(dim: int, x, n_input_dims: int = -1) -> int:
    """1-based (maybe negative) dim -> 0-based absolute axis."""
    nd = x.dim()
    if dim < 0:
        return nd + dim
    d = dim - 1
    if 0 < n_input_dims < nd:
        d += nd - n_input_dims       # batch dims present
    return d


def _items(x):
    return x.to_list() if isinstance(x, Table) else list(x)


class Reshape(Module):
    """Reshape the non-batch dims (nn/Reshape.scala). ``batch_mode=None``
    infers: when the elements after the first dim number prod(size), the
    first dim is the batch."""

    def __init__(self, size: Sequence[int], batch_mode: Optional[bool] = None,
                 name=None):
        super().__init__(name=name)
        self.size = tuple(size)
        self.batch_mode = batch_mode

    def call(self, params, x):
        n = math.prod(self.size)
        if self.batch_mode is False:
            return x.reshape(self.size)
        rest = math.prod(x.shape[1:]) if x.dim() > 1 else -1
        if self.batch_mode is True or rest == n:
            return x.reshape((x.shape[0],) + self.size)
        return x.reshape(self.size)


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


class InferReshape(Module):
    """Reshape with entries -1 (inferred) and 0 (the input's dim kept)
    (nn/InferReshape.scala)."""

    def __init__(self, size: Sequence[int], batch_mode: bool = False,
                 name=None):
        super().__init__(name=name)
        self.size = tuple(size)
        self.batch_mode = batch_mode

    def call(self, params, x):
        in_shape = x.shape[1:] if self.batch_mode else x.shape
        out = tuple(in_shape[i] if s == 0 else s
                    for i, s in enumerate(self.size))
        if self.batch_mode:
            return x.reshape((x.shape[0],) + out)
        return x.reshape(out)


class Squeeze(Module):
    def __init__(self, dim: Optional[int] = None, num_input_dims: int = -1,
                 name=None):
        super().__init__(name=name)
        self.dim, self.num_input_dims = dim, num_input_dims

    def call(self, params, x):
        if self.dim is None:
            return x.squeeze()
        d = _dim0(self.dim, x, self.num_input_dims)
        if x.shape[d] != 1:
            raise ValueError(f"Squeeze: dim {self.dim} has size "
                             f"{x.shape[d]}, not 1")
        return x.squeeze(d)


class Unsqueeze(Module):
    """Insert a singleton dim at 1-based ``pos``."""

    def __init__(self, pos: int, num_input_dims: int = -1, name=None):
        super().__init__(name=name)
        self.pos, self.num_input_dims = pos, num_input_dims

    def call(self, params, x):
        d = self.pos - 1
        if 0 < self.num_input_dims < x.dim():
            d += x.dim() - self.num_input_dims
        return x.unsqueeze(d)


class Transpose(Module):
    """A sequence of 1-based (dim1, dim2) swaps."""

    def __init__(self, permutations, name=None):
        super().__init__(name=name)
        self.permutations = [tuple(p) for p in permutations]

    def call(self, params, x):
        for d1, d2 in self.permutations:
            x = x.transpose(d1 - 1, d2 - 1)
        return x


class Replicate(Module):
    """Insert a new dim of size ``n_features`` at 1-based ``dim``."""

    def __init__(self, n_features: int, dim: int = 1, n_dim: int = -1,
                 name=None):
        super().__init__(name=name)
        self.n_features, self.dim, self.n_dim = n_features, dim, n_dim

    def call(self, params, x):
        d = self.dim - 1
        if 0 < self.n_dim < x.dim():
            d += x.dim() - self.n_dim
        y = x.unsqueeze(d)
        reps = [1] * y.dim()
        reps[d] = self.n_features
        return y.repeat(reps)


class Padding(Module):
    """Pad |pad| entries of ``value`` on 1-based ``dim``: before it when pad
    is negative, after it otherwise (nn/Padding.scala)."""

    def __init__(self, dim: int, pad: int, n_input_dim: int,
                 value: float = 0.0, n_index: int = 1, name=None):
        super().__init__(name=name)
        self.dim, self.pad, self.n_input_dim = dim, pad, n_input_dim
        self.value = value

    def call(self, params, x):
        d = _dim0(self.dim, x, self.n_input_dim)
        cfg = [0] * (2 * x.dim())
        k = 2 * (x.dim() - 1 - d)       # F.pad lists the last dim first
        if self.pad < 0:
            cfg[k] = -self.pad
        else:
            cfg[k + 1] = self.pad
        return F.pad(x, cfg, value=self.value)


class SpatialZeroPadding(Module):
    """Zero padding of the last two dims (NCHW); a negative pad crops
    (nn/SpatialZeroPadding.scala)."""

    def __init__(self, pad_left: int, pad_right: int = None,
                 pad_top: int = None, pad_bottom: int = None, name=None):
        super().__init__(name=name)
        if pad_right is None:
            pad_right = pad_top = pad_bottom = pad_left
        self.l, self.r, self.t, self.b = pad_left, pad_right, pad_top, \
            pad_bottom

    def call(self, params, x):
        # F.pad crops at a negative width, as the JAX package's slices do
        return F.pad(x, (self.l, self.r, self.t, self.b))


class Narrow(Module):
    """The slice [offset, offset + length) of 1-based ``dimension``
    (1-based offset, negative from the end; a negative length ends that
    many elements before the end, -1 at the end)."""

    def __init__(self, dimension: int, offset: int, length: int = 1,
                 name=None):
        super().__init__(name=name)
        self.dimension, self.offset, self.length = dimension, offset, length

    def call(self, params, x):
        d = _dim0(self.dimension, x)
        start = self.offset - 1 if self.offset > 0 else \
            x.shape[d] + self.offset
        length = self.length
        if length < 0:
            length = x.shape[d] - start + length + 1
        return x.narrow(d, start, length)


class Select(Module):
    """Pick 1-based ``index`` (negative from the end) of ``dim`` and drop
    the dim."""

    def __init__(self, dim: int, index: int, name=None):
        super().__init__(name=name)
        self.dim, self.index = dim, index

    def call(self, params, x):
        d = _dim0(self.dim, x)
        i = self.index - 1 if self.index > 0 else x.shape[d] + self.index
        return x.select(d, i)


class Index(Module):
    """``Table(src, indices)``: the entries of 1-based ``indices`` along
    1-based ``dimension`` of src."""

    def __init__(self, dimension: int, name=None):
        super().__init__(name=name)
        self.dimension = dimension

    def call(self, params, x):
        src, idx = x[1], x[2]
        idx = torch.as_tensor(idx, device=src.device).long() - 1
        d = self.dimension - 1
        out = src.index_select(d, idx.reshape(-1))
        return out.reshape(src.shape[:d] + idx.shape + src.shape[d + 1:])


class MaskedSelect(Module):
    """``Table(src, mask)``: the 1-D tensor of src's entries where mask is
    nonzero."""

    def call(self, params, x):
        src, mask = x[1], x[2]
        return src[torch.as_tensor(mask, device=src.device).bool()]


class _Reduce(Module):
    def __init__(self, dimension: int = 1, n_input_dims: int = -1,
                 squeeze: bool = True, name=None):
        super().__init__(name=name)
        self.dimension, self.n_input_dims = dimension, n_input_dims
        self.squeeze = squeeze

    def _reduce(self, x, axis):
        raise NotImplementedError(type(self).__name__)

    def call(self, params, x):
        d = _dim0(self.dimension, x, self.n_input_dims)
        y = self._reduce(x, d)
        return y if self.squeeze else y.unsqueeze(d)


class Max(_Reduce):
    """The max along a 1-based dim (values only)."""

    def __init__(self, dim: int = 1, num_input_dims: int = -1, name=None):
        super().__init__(dim, num_input_dims, True, name=name)

    def _reduce(self, x, axis):
        return torch.amax(x, axis)


class Min(_Reduce):
    def __init__(self, dim: int = 1, num_input_dims: int = -1, name=None):
        super().__init__(dim, num_input_dims, True, name=name)

    def _reduce(self, x, axis):
        return torch.amin(x, axis)


class Mean(_Reduce):
    def __init__(self, dimension: int = 1, n_input_dims: int = -1,
                 squeeze: bool = True, name=None):
        super().__init__(dimension, n_input_dims, squeeze, name=name)

    def _reduce(self, x, axis):
        return x.mean(axis)


class Sum(_Reduce):
    def __init__(self, dimension: int = 1, n_input_dims: int = -1,
                 size_average: bool = False, squeeze: bool = True,
                 name=None):
        super().__init__(dimension, n_input_dims, squeeze, name=name)
        self.size_average = size_average

    def _reduce(self, x, axis):
        return x.mean(axis) if self.size_average else x.sum(axis)


class Tile(Module):
    """Repeat ``copies`` times along 1-based ``dim``."""

    def __init__(self, dim: int = 1, copies: int = 2, name=None):
        super().__init__(name=name)
        self.dim, self.copies = dim, copies

    def call(self, params, x):
        reps = [1] * x.dim()
        reps[_dim0(self.dim, x)] = self.copies
        return x.repeat(reps)


class ExpandSize(Module):
    """Broadcast singleton dims to ``sizes`` (-1 keeps the dim)."""

    def __init__(self, sizes: Sequence[int], name=None):
        super().__init__(name=name)
        self.sizes = tuple(sizes)

    def call(self, params, x):
        target = tuple(x.shape[i] if s == -1 else s
                       for i, s in enumerate(self.sizes))
        return x.expand(target)


class Cropping2D(Module):
    """Crop (top, bottom) rows and (left, right) columns (NCHW or NHWC)."""

    def __init__(self, height_crop=(0, 0), width_crop=(0, 0),
                 data_format="NCHW", name=None):
        super().__init__(name=name)
        self.hc, self.wc = tuple(height_crop), tuple(width_crop)
        self.data_format = data_format

    def call(self, params, x):
        nchw = self.data_format == "NCHW"
        h_ax = x.dim() - 2 if nchw else x.dim() - 3
        w_ax = x.dim() - 1 if nchw else x.dim() - 2
        x = x.narrow(h_ax, self.hc[0], x.shape[h_ax] - sum(self.hc))
        return x.narrow(w_ax, self.wc[0], x.shape[w_ax] - sum(self.wc))


class Cropping3D(Module):
    """Crop the last three dims (NCDHW)."""

    def __init__(self, dim1_crop=(0, 0), dim2_crop=(0, 0), dim3_crop=(0, 0),
                 name=None):
        super().__init__(name=name)
        self.crops = [tuple(dim1_crop), tuple(dim2_crop), tuple(dim3_crop)]

    def call(self, params, x):
        for i, (lo, hi) in enumerate(self.crops):
            ax = x.dim() - 3 + i
            x = x.narrow(ax, lo, x.shape[ax] - lo - hi)
        return x


class Reverse(Module):
    """Flip along 1-based ``dimension``."""

    def __init__(self, dimension: int = 1, is_inplace: bool = False,
                 name=None):
        super().__init__(name=name)
        self.dimension = dimension

    def call(self, params, x):
        return torch.flip(x, (self.dimension - 1,))


class Pack(Module):
    """Stack a Table of tensors along a new 1-based dim."""

    def __init__(self, dimension: int, name=None):
        super().__init__(name=name)
        self.dimension = dimension

    def call(self, params, x):
        items = x.to_list() if isinstance(x, Table) else [x]
        return torch.stack(items, self.dimension - 1)


class UpSampling1D(Module):
    """Repeat each timestep ``length`` times: (B, T, C) -> (B, T*len, C)."""

    def __init__(self, length: int, name=None):
        super().__init__(name=name)
        self.length = length

    def call(self, params, x):
        return x.repeat_interleave(self.length, -2)


class UpSampling2D(Module):
    """Nearest-neighbour upsampling of the last two dims."""

    def __init__(self, size=(2, 2), data_format="NCHW", name=None):
        super().__init__(name=name)
        self.size = tuple(size)

    def call(self, params, x):
        x = x.repeat_interleave(self.size[0], -2)
        return x.repeat_interleave(self.size[1], -1)


class UpSampling3D(Module):
    """Nearest-neighbour upsampling of the last three dims (NCDHW)."""

    def __init__(self, size=(2, 2, 2), name=None):
        super().__init__(name=name)
        self.size = tuple(size)

    def call(self, params, x):
        x = x.repeat_interleave(self.size[0], -3)
        x = x.repeat_interleave(self.size[1], -2)
        return x.repeat_interleave(self.size[2], -1)


def _linear_weights(n_in: int, n_out: int) -> np.ndarray:
    """``jax.image``'s (n_in, n_out) bilinear weights for one axis at scale
    n_out / n_in: a triangle filter widened by the shrink factor (the
    antialias), each column normalised, columns sampled outside the input
    zeroed; computed in float32 as JAX computes them."""
    f32 = np.float32
    inv = f32(1.0) / f32(f32(n_out) / f32(n_in))
    width = max(inv, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    d = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / width
    w = np.maximum(f32(0.0), f32(1.0) - d).astype(f32)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


class ResizeBilinear(Module):
    """Bilinear resize of the last two dims (NCHW) to (output_height,
    output_width): ``jax.image.resize`` (antialiased when shrinking), or
    with ``align_corners`` the corner-aligned gather of the JAX package's
    emulation."""

    def __init__(self, output_height: int, output_width: int,
                 align_corners: bool = False, data_format="NCHW", name=None):
        super().__init__(name=name)
        self.oh, self.ow = output_height, output_width
        self.align_corners = align_corners

    def call(self, params, x):
        h, w = x.shape[-2], x.shape[-1]
        if self.align_corners:
            scale = ((h - 1) / max(self.oh - 1, 1),
                     (w - 1) / max(self.ow - 1, 1))
            ys = torch.arange(self.oh, device=x.device) * scale[0]
            xs = torch.arange(self.ow, device=x.device) * scale[1]
            y0 = ys.floor().long().clamp(0, h - 1)
            y1 = (y0 + 1).clamp(0, h - 1)
            x0 = xs.floor().long().clamp(0, w - 1)
            x1 = (x0 + 1).clamp(0, w - 1)
            wy = (ys - y0).to(x.dtype)[:, None]
            wx = (xs - x0).to(x.dtype)[None, :]

            def g(yy, xx):
                return x[..., yy, :][..., :, xx]
            top = g(y0, x0) * (1 - wx) + g(y0, x1) * wx
            bot = g(y1, x0) * (1 - wx) + g(y1, x1) * wx
            return top * (1 - wy) + bot * wy
        # jax.image.resize filters only the axes whose size changes
        if h != self.oh:
            wh = torch.from_numpy(_linear_weights(h, self.oh)).to(x)
            x = torch.einsum("...hw,ho->...ow", x, wh)
        if w != self.ow:
            ww = torch.from_numpy(_linear_weights(w, self.ow)).to(x)
            x = torch.einsum("...hw,wo->...ho", x, ww)
        return x
