"""Pooling (counterpart of ``bigdl_tpu/nn/pool.py``).

The windows are the JAX package's: :func:`_pool_pads` gives each spatial
dim its (lo, hi) padding - SAME for pad -1, and in ceil mode the extra
right padding that makes the last partial window, dropped only when it
would start in the left padding's mirror past the input (``pad > 0``;
torch's ``ceil_mode`` drops it at pad 0 too). The pads are applied
explicitly (-inf for max, 0 for average) and the window runs VALID, so an
average with ``count_include_pad`` divides every window by kh * kw, the
ceil-mode padding included (torch's ceil mode divides a window that runs
past the padded input by its clipped count). Where torch's own symmetric
padding gives the same windows (floor mode, pad <= k / 2), it pads.
``SpatialMaxPooling(grad_mode='exact')`` sends each window's gradient to
its first maximum, as XLA's select_and_scatter does; ``'fast'`` is the
JAX package's max-tree of strided slices, whose ``jnp.maximum`` ties split
the gradient in half at each level (``torch.maximum`` splits them the same
way). ``RoiPooling`` is not ported.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .module import Module

__all__ = ["SpatialMaxPooling", "SpatialAveragePooling",
           "TemporalMaxPooling", "VolumetricMaxPooling",
           "VolumetricAveragePooling"]


def _pool_pads(size, k, stride, pad, ceil_mode):
    """(lo, hi) padding and output size of one spatial dim; ``pad == -1``
    is SAME."""
    if pad == -1:
        out = math.ceil(size / stride)
        total = max(0, (out - 1) * stride + k - size)
        return (total // 2, total - total // 2), out
    if ceil_mode:
        out = math.ceil((size + 2 * pad - k) / stride) + 1
        # the last window must start inside the padded input
        if pad > 0 and (out - 1) * stride >= size + pad:
            out -= 1
    else:
        out = (size + 2 * pad - k) // stride + 1
    needed = max(0, (out - 1) * stride + k - size - pad)
    return (pad, needed), out


def _torch_pads(sizes, ks, strides, pads, outs):
    """The symmetric paddings for torch's own pooling when its windows are
    these (floor mode, lo <= k / 2, hi <= lo), else None."""
    out = []
    for n, k, s, (lo, hi), o in zip(sizes, ks, strides, pads, outs):
        if lo > k // 2 or hi > lo or (n + 2 * lo - k) // s + 1 != o:
            return None
        out.append(lo)
    return tuple(out)


def _pad_spec(pads):
    """[(lo, hi) per dim, outermost first] -> F.pad's list (last dim
    first)."""
    return [p for lo_hi in reversed(pads) for p in lo_hi]


def _channels_first(fn, x, nhwc, spatial):
    """``fn`` on the channels-first view of x (a channels-last input goes
    through ``permute`` and back, no copy); an input without the batch dim
    is one sample."""
    squeeze = x.dim() == spatial + 1
    if squeeze:
        x = x[None]
    if nhwc:
        perm = (0, spatial + 1) + tuple(range(1, spatial + 1))
        y = fn(x.permute(perm))
        y = y.permute((0,) + tuple(range(2, spatial + 2)) + (1,))
    else:
        y = fn(x)
    return y[0] if squeeze else y


def _window_sum(x, kernel, stride, pads):
    """The VALID window sums of x zero-padded by ``pads`` (2-D or 3-D)."""
    pool = F.avg_pool2d if len(kernel) == 2 else F.avg_pool3d
    if any(lo or hi for lo, hi in pads):
        x = F.pad(x, _pad_spec(pads))
    return pool(x, kernel, stride, divisor_override=1)


def _average(x, kernel, stride, pads, count_include_pad, divide=True):
    """Window sums divided by the window size, by the count of input
    elements in the window, or not at all."""
    s = _window_sum(x, kernel, stride, pads)
    if not divide:
        return s
    if count_include_pad:
        return s / math.prod(kernel)
    ones = x.new_ones((1, 1) + tuple(x.shape[2:]))
    return s / _window_sum(ones, kernel, stride, pads)


class _Pool2D(Module):
    def __init__(self, kw, kh, dw=None, dh=None, pad_w=0, pad_h=0,
                 format="NCHW", name=None):
        super().__init__(name=name)
        if format not in ("NCHW", "NHWC"):
            raise ValueError(f"format must be NCHW or NHWC, got {format!r}")
        self.format = format
        self.kw, self.kh = kw, kh
        self.dw = dw if dw is not None else kw
        self.dh = dh if dh is not None else kh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.ceil_mode = False

    def ceil(self):
        self.ceil_mode = True
        return self

    def floor(self):
        self.ceil_mode = False
        return self

    def _pads(self, h, w):
        """((lo, hi) of H, (lo, hi) of W) and (out_h, out_w)."""
        ph, oh = _pool_pads(h, self.kh, self.dh, self.pad_h, self.ceil_mode)
        pw, ow = _pool_pads(w, self.kw, self.dw, self.pad_w, self.ceil_mode)
        return (ph, pw), (oh, ow)

    def _run(self, fn, x):
        return _channels_first(fn, x, self.format == "NHWC", 2)


class SpatialMaxPooling(_Pool2D):
    """Max pooling (nn/SpatialMaxPooling.scala), NCHW or NHWC."""

    def __init__(self, kw, kh, dw=None, dh=None, pad_w=0, pad_h=0,
                 format="NCHW", grad_mode: str = "exact", name=None):
        super().__init__(kw, kh, dw, dh, pad_w, pad_h, format, name)
        if grad_mode not in ("exact", "fast"):
            raise ValueError(f"grad_mode must be 'exact' or 'fast', got "
                             f"{grad_mode!r}")
        self.grad_mode = grad_mode

    def _exact(self, t):
        k, s = (self.kh, self.kw), (self.dh, self.dw)
        pads, outs = self._pads(*t.shape[2:])
        same = _torch_pads(t.shape[2:], k, s, pads, outs)
        if same is not None:
            return F.max_pool2d(t, k, s, same)
        return F.max_pool2d(F.pad(t, _pad_spec(pads), value=-math.inf), k, s)

    def _fast(self, t):
        """The max over the kh * kw shifted strided slices, in JAX's
        order."""
        pads, _ = self._pads(*t.shape[2:])
        tp = F.pad(t, _pad_spec(pads), value=-math.inf)
        oh = (tp.shape[2] - self.kh) // self.dh + 1
        ow = (tp.shape[3] - self.kw) // self.dw + 1
        y = None
        for i in range(self.kh):
            for j in range(self.kw):
                piece = tp[:, :, i:i + (oh - 1) * self.dh + 1:self.dh,
                           j:j + (ow - 1) * self.dw + 1:self.dw]
                y = piece if y is None else torch.maximum(y, piece)
        return y

    def call(self, params, x):
        return self._run(self._fast if self.grad_mode == "fast"
                         else self._exact, x)


class SpatialAveragePooling(_Pool2D):
    """Average pooling (nn/SpatialAveragePooling.scala): ``global_pooling``
    pools each whole plane (the kernel size is then ignored), ``ceil_mode``
    (or ``ceil()``), ``count_include_pad`` (the reference's default True
    divides by kh * kw) and ``divide=False`` (window sums)."""

    def __init__(self, kw, kh, dw=None, dh=None, pad_w=0, pad_h=0,
                 global_pooling=False, ceil_mode=False,
                 count_include_pad=True, divide=True, format="NCHW",
                 name=None):
        super().__init__(kw, kh, dw, dh, pad_w, pad_h, format, name)
        self.ceil_mode = ceil_mode
        self.count_include_pad = count_include_pad
        self.divide = divide
        self.global_pooling = global_pooling

    def _pool(self, t):
        if self.global_pooling:
            s = t.sum((2, 3), keepdim=True)
            return s / (t.shape[2] * t.shape[3]) if self.divide else s
        k, s = (self.kh, self.kw), (self.dh, self.dw)
        pads, outs = self._pads(*t.shape[2:])
        same = _torch_pads(t.shape[2:], k, s, pads, outs)
        if same is not None and self.divide:
            return F.avg_pool2d(t, k, s, same,
                                count_include_pad=self.count_include_pad)
        return _average(t, k, s, pads, self.count_include_pad, self.divide)

    def call(self, params, x):
        return self._run(self._pool, x)


class TemporalMaxPooling(Module):
    """1-D max pooling over the T of (B, T, C), VALID
    (nn/TemporalMaxPooling.scala)."""

    def __init__(self, k_w: int, d_w: int = None, name=None):
        super().__init__(name=name)
        self.k_w = k_w
        self.d_w = d_w if d_w is not None else k_w

    def call(self, params, x):
        squeeze = x.dim() == 2
        if squeeze:
            x = x[None]
        y = F.max_pool1d(x.transpose(1, 2), self.k_w, self.d_w).transpose(1,
                                                                            2)
        return y[0] if squeeze else y


class VolumetricMaxPooling(Module):
    """3-D max pooling over NCDHW (nn/VolumetricMaxPooling.scala)."""

    def __init__(self, kt, kw, kh, dt=None, dw=None, dh=None,
                 pad_t=0, pad_w=0, pad_h=0, name=None):
        super().__init__(name=name)
        self.kt, self.kw, self.kh = kt, kw, kh
        self.dt = dt if dt is not None else kt
        self.dw = dw if dw is not None else kw
        self.dh = dh if dh is not None else kh
        self.pad_t, self.pad_w, self.pad_h = pad_t, pad_w, pad_h
        self.ceil_mode = False

    def ceil(self):
        self.ceil_mode = True
        return self

    def _window(self, x):
        """(kernel, stride, pads) of an NCDHW input."""
        t, h, w = x.shape[-3:]
        pads = tuple(_pool_pads(n, k, s, p, self.ceil_mode)[0] for n, k, s, p
                     in ((t, self.kt, self.dt, self.pad_t),
                         (h, self.kh, self.dh, self.pad_h),
                         (w, self.kw, self.dw, self.pad_w)))
        return (self.kt, self.kh, self.kw), (self.dt, self.dh, self.dw), pads

    def _pool(self, x):
        k, s, pads = self._window(x)
        return F.max_pool3d(F.pad(x, _pad_spec(pads), value=-math.inf), k, s)

    def call(self, params, x):
        return _channels_first(self._pool, x, False, 3)


class VolumetricAveragePooling(VolumetricMaxPooling):
    """3-D average pooling over NCDHW (nn/VolumetricAveragePooling.scala)."""

    def __init__(self, kt, kw, kh, dt=None, dw=None, dh=None,
                 pad_t=0, pad_w=0, pad_h=0, count_include_pad=True,
                 name=None):
        super().__init__(kt, kw, kh, dt, dw, dh, pad_t, pad_w, pad_h,
                         name=name)
        self.count_include_pad = count_include_pad

    def _pool(self, x):
        k, s, pads = self._window(x)
        return _average(x, k, s, pads, self.count_include_pad)
