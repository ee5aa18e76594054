"""Pooling (counterpart of ``bigdl_tpu/nn/pool.py``; the ResNet slice ports
``SpatialMaxPooling`` in floor mode with ``grad_mode='exact'`` and
``SpatialAveragePooling`` with ``global_pooling``)."""
from __future__ import annotations

import torch.nn.functional as F

from ..utils.engine import refuse_unported
from .module import Module


class _Pool2D(Module):
    def __init__(self, kw, kh, dw=None, dh=None, pad_w=0, pad_h=0,
                 format="NCHW", name=None):
        super().__init__(name=name)
        if format not in ("NCHW", "NHWC"):
            raise ValueError(f"format must be NCHW or NHWC, got {format!r}")
        if pad_w < 0 or pad_h < 0:
            raise NotImplementedError("SAME padding (pad -1) is not ported")
        self.format = format
        self.kernel = (kh, kw)
        self.stride = (dh if dh is not None else kh, dw if dw is not None
                       else kw)
        self.padding = (pad_h, pad_w)

    def _pool(self, fn, x):
        """``fn`` on the NCHW view of x (NHWC goes through the
        channels-last view and back, no copy); a 3-D input is one
        sample."""
        squeeze = x.dim() == 3
        if squeeze:
            x = x[None]
        nhwc = self.format == "NHWC"
        y = fn(x.permute(0, 3, 1, 2) if nhwc else x)
        if nhwc:
            y = y.permute(0, 2, 3, 1)
        return y[0] if squeeze else y


class SpatialMaxPooling(_Pool2D):
    """Max pooling (nn/SpatialMaxPooling.scala). ``grad_mode='exact'``
    sends each window's gradient to its FIRST maximum (row-major within
    the window), as the JAX package's select_and_scatter does; ties are
    common after a ReLU. The JAX package's ``'fast'`` mode (split ties) is
    not ported. Floor mode pads symmetrically; the JAX package's extra
    right padding is never read in floor mode, so the windows agree."""

    def __init__(self, kw, kh, dw=None, dh=None, pad_w=0, pad_h=0,
                 format="NCHW", grad_mode: str = "exact", name=None):
        super().__init__(kw, kh, dw, dh, pad_w, pad_h, format, name)
        if grad_mode != "exact":
            raise NotImplementedError(f"grad_mode={grad_mode!r} is not "
                                      f"ported (only 'exact')")
        self.grad_mode = grad_mode

    def call(self, params, x):
        return self._pool(lambda t: F.max_pool2d(
            t, self.kernel, self.stride, self.padding), x)


class SpatialAveragePooling(_Pool2D):
    """Average pooling (nn/SpatialAveragePooling.scala) with
    ``global_pooling``: each whole plane, summed over H and W and divided
    by H W (the kernel size is then ignored, as in the reference). Window
    pooling, ``ceil_mode``, ``count_include_pad=False`` and
    ``divide=False`` are not ported."""

    def __init__(self, kw, kh, dw=None, dh=None, pad_w=0, pad_h=0,
                 global_pooling=False, ceil_mode=False,
                 count_include_pad=True, divide=True, format="NCHW",
                 name=None):
        super().__init__(kw, kh, dw, dh, pad_w, pad_h, format, name)
        refuse_unported("SpatialAveragePooling", ceil_mode=(ceil_mode, False),
                        count_include_pad=(count_include_pad, True),
                        divide=(divide, True))
        if not global_pooling:
            raise NotImplementedError("only global_pooling=True is ported")

    def call(self, params, x):
        return self._pool(lambda t: t.sum((2, 3), keepdim=True)
                          / (t.shape[2] * t.shape[3]), x)
