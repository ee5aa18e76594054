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
way). ``RoiPooling`` takes each bin's maximum over its columns, then its
rows, in masked reductions over a chunk of rois at a time.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .module import Module

__all__ = ["SpatialMaxPooling", "SpatialAveragePooling",
           "TemporalMaxPooling", "VolumetricMaxPooling",
           "VolumetricAveragePooling", "RoiPooling"]


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


_ROI_CHUNK = 32     # rois a masked reduction (bounds its temporaries)


class RoiPooling(Module):
    """ROI max pooling (nn/RoiPooling.scala): input Table(features NCHW,
    rois (R, 5) [batchIdx, x1, y1, x2, y2] in input pixels) -> (R, C,
    pooled_h, pooled_w). A roi's corners are rounded after scaling by
    ``spatial_scale``; bin (ph, pw) covers rows floor(y1 + ph rh / PH) to
    ceil(y1 + (ph + 1) rh / PH) and the like for columns (at least one
    each), and an empty bin (outside the map) gives 0. The maximum over a
    bin's rectangle is taken over its columns, then its rows (one masked
    reduction each), 32 rois at a time."""

    def __init__(self, pooled_w: int, pooled_h: int,
                 spatial_scale: float = 1.0, name=None):
        super().__init__(name=name)
        self.pooled_w, self.pooled_h = pooled_w, pooled_h
        self.spatial_scale = spatial_scale

    def _bins(self, lo, size, n, extent, device):
        """(R, n, extent) bool: which of ``extent`` positions each of the
        ``n`` bins over [lo, lo + size) covers."""
        p = torch.arange(n, device=device, dtype=torch.float32)
        # divided by a tensor: CUDA divides by a Python number through its
        # reciprocal, which can move a bin edge across an integer
        nt = torch.full((len(lo), n), float(n), device=device)
        start = torch.floor(lo[:, None] + p * size[:, None] / nt)
        end = torch.ceil(lo[:, None] + (p + 1) * size[:, None] / nt)
        end = torch.maximum(end, start + 1)
        pos = torch.arange(extent, device=device, dtype=torch.float32)
        return (pos >= start[..., None]) & (pos < end[..., None])

    def call(self, params, x):
        feats, rois = x[1], x[2]
        rois = rois.to(device=feats.device, dtype=torch.float32)
        C, H, W = feats.shape[1:]
        s = self.spatial_scale
        x1, y1, x2, y2 = (torch.round(rois[:, i] * s) for i in (1, 2, 3, 4))
        rw = torch.clamp(x2 - x1 + 1, min=1.0)
        rh = torch.clamp(y2 - y1 + 1, min=1.0)
        rows = self._bins(y1, rh, self.pooled_h, H, feats.device)
        cols = self._bins(x1, rw, self.pooled_w, W, feats.device)
        bi = rois[:, 0].to(torch.int64)
        neg = torch.tensor(-math.inf, dtype=feats.dtype, device=feats.device)
        outs = []
        for a in range(0, rois.shape[0], _ROI_CHUNK):
            b = slice(a, a + _ROI_CHUNK)
            fm = feats[bi[b]]                               # (r, C, H, W)
            cm = cols[b]                                    # (r, PW, W)
            # max over each bin's columns: (r, C, H, PW)
            colmax = torch.where(cm[:, None, None], fm[:, :, :, None, :],
                                 neg).amax(-1)
            rm = rows[b]                                    # (r, PH, H)
            # then over its rows: (r, C, PH, PW)
            m = torch.where(rm[:, None, :, :, None], colmax[:, :, None],
                            neg).amax(3)
            outs.append(torch.where(torch.isfinite(m), m, 0.0))
        if not outs:
            return feats.new_zeros((0, C, self.pooled_h, self.pooled_w))
        return torch.cat(outs)
