"""Convolution (counterpart of ``bigdl_tpu/nn/conv.py``; the ResNet slice
ports ``SpatialConvolution``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.engine import refuse_unported
from .init import Xavier, Zeros
from .module import Module


class SpatialConvolution(Module):
    """2-D convolution (nn/SpatialConvolution.scala). ``format`` NCHW or
    NHWC; the weight stays OIHW (the reference layout) either way. An NHWC
    input goes to ``F.conv2d`` as its channels-last NCHW view
    (``permute(0, 3, 1, 2)``, no copy) and the output comes back the same
    way. Weights default to ``Xavier``, biases to ``Zeros``. Explicit
    padding only (pad -1, SAME, is not ported); ``n_group``,
    ``propagate_back=False``, the regularizers, ``init_weight`` /
    ``init_bias`` and dilation are not ported and raise at a value other
    than their default."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int, stride_w: int = 1,
                 stride_h: int = 1, pad_w: int = 0, pad_h: int = 0,
                 n_group: int = 1, propagate_back: bool = True,
                 w_regularizer=None, b_regularizer=None, init_weight=None,
                 init_bias=None, with_bias: bool = True, init_method=None,
                 bias_init_method=None, dilation_w: int = 1,
                 dilation_h: int = 1, format: str = "NCHW", name=None):
        super().__init__(name=name)
        refuse_unported("SpatialConvolution", n_group=(n_group, 1),
                        propagate_back=(propagate_back, True),
                        w_regularizer=(w_regularizer, None),
                        b_regularizer=(b_regularizer, None),
                        init_weight=(init_weight, None),
                        init_bias=(init_bias, None),
                        dilation_w=(dilation_w, 1),
                        dilation_h=(dilation_h, 1))
        if format not in ("NCHW", "NHWC"):
            raise ValueError(f"format must be NCHW or NHWC, got {format!r}")
        if pad_w < 0 or pad_h < 0:
            raise NotImplementedError("SAME padding (pad -1) is not ported")
        self.format = format
        self.n_input_plane, self.n_output_plane = n_input_plane, n_output_plane
        self.kernel = (kernel_h, kernel_w)
        self.stride = (stride_h, stride_w)
        self.padding = (pad_h, pad_w)
        self.init_method = init_method or Xavier()
        self.bias_init_method = bias_init_method or Zeros()
        self.weight = torch.nn.Parameter(
            torch.empty(n_output_plane, n_input_plane, kernel_h, kernel_w))
        self.bias = (torch.nn.Parameter(torch.empty(n_output_plane))
                     if with_bias else None)
        self.reset()

    def _reset(self, generator):
        kh, kw = self.kernel
        fans = dict(fan_in=self.n_input_plane * kh * kw,
                    fan_out=self.n_output_plane * kh * kw,
                    generator=generator, device=self.weight.device)
        self.weight.copy_(self.init_method(self.weight.shape, **fans))
        if self.bias is not None:
            self.bias.copy_(self.bias_init_method(self.bias.shape, **fans))

    def call(self, params, x):
        squeeze = x.dim() == 3
        if squeeze:
            x = x[None]
        nhwc = self.format == "NHWC"
        y = F.conv2d(x.permute(0, 3, 1, 2) if nhwc else x, params["weight"],
                     params.get("bias"), self.stride, self.padding)
        if nhwc:
            y = y.permute(0, 2, 3, 1)
        return y[0] if squeeze else y
