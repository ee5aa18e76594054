"""Convolution (counterpart of ``bigdl_tpu/nn/conv.py``): the 2-D family
(``SpatialConvolution`` with groups, dilation and SAME padding,
``SpatialShareConvolution``, ``SpatialDilatedConvolution``, the transposed
``SpatialFullConvolution``, ``SpatialSeparableConvolution`` and the
connection-table ``SpatialConvolutionMap``), ``TemporalConvolution``,
``VolumetricConvolution``, the transposed ``VolumetricFullConvolution``
and the unshared-weight ``LocallyConnected1D`` / ``LocallyConnected2D``.

pad -1 is SAME, for both dims when either asks for it (the JAX package's
``_resolve_padding``): out = ceil(in / stride) and the total padding
``(out - 1) * stride + (k - 1) * dilation + 1 - in`` is split
``(total // 2, total - total // 2)``, the larger half after the input.
``F.conv2d(padding='same')`` refuses strides above 1, so an uneven split
is padded first and the convolution runs VALID. The convolutions are
PyTorch's (``F.conv1d`` / ``conv2d`` / ``conv3d``, ``F.conv_transpose2d``
/ ``conv_transpose3d``; cuDNN on the card), as the JAX package's are
XLA's ``lax.conv_general_dilated``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .init import Xavier, Zeros, _uniform
from .module import Module

__all__ = ["SpatialConvolution", "SpatialShareConvolution",
           "SpatialDilatedConvolution", "SpatialFullConvolution",
           "SpatialSeparableConvolution", "SpatialConvolutionMap",
           "TemporalConvolution", "VolumetricConvolution",
           "VolumetricFullConvolution", "LocallyConnected1D",
           "LocallyConnected2D"]


def _same_pad(size, k, stride, dilation=1):
    out = -(-size // stride)
    total = max(0, (out - 1) * stride + (k - 1) * dilation + 1 - size)
    return total // 2, total - total // 2


def _conv2d(x, w, bias, stride, pads, dilation=(1, 1), groups=1):
    """``F.conv2d`` over NCHW x with per-dim (lo, hi) ``pads``; an uneven
    pair is padded explicitly first."""
    (hl, hh), (wl, wh) = pads
    if hl == hh and wl == wh:
        return F.conv2d(x, w, bias, stride, (hl, wl), dilation, groups)
    return F.conv2d(F.pad(x, (wl, wh, hl, hh)), w, bias, stride, 0, dilation,
                    groups)


def _conv3d(x, w, bias, stride, pads):
    """``F.conv3d`` over NCDHW x with per-dim (lo, hi) ``pads``, as
    :func:`_conv2d`."""
    if all(lo == hi for lo, hi in pads):
        return F.conv3d(x, w, bias, stride, tuple(lo for lo, _ in pads))
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    return F.conv3d(F.pad(x, flat), w, bias, stride)


def _resolve_pads(x_hw, kernel, stride, pad, dilation=(1, 1)):
    """The (lo, hi) pads of H and W: SAME for both when either pad is -1."""
    if -1 in pad:
        return tuple(_same_pad(n, k, s, d) for n, k, s, d in
                     zip(x_hw, kernel, stride, dilation))
    return tuple((p, p) for p in pad)


def _host_array(a, shape=None):
    a = np.array(a, np.float32, copy=True)
    return a.reshape(shape) if shape is not None else a


class SpatialConvolution(Module):
    """2-D convolution (nn/SpatialConvolution.scala). ``format`` NCHW or
    NHWC; the weight stays OIHW, (n_output_plane, n_input_plane / n_group,
    kh, kw), the reference layout, either way. An NHWC input goes to
    ``F.conv2d`` as its channels-last NCHW view (``permute(0, 3, 1, 2)``,
    no copy) and the output comes back the same way. Weights default to
    ``Xavier`` (fan-in (n_input_plane / n_group) kh kw), biases to
    ``Zeros``; ``init_weight`` / ``init_bias`` give their values.
    ``propagate_back=False`` is accepted and, as in the JAX package, the
    input's gradient is still computed. ``w_regularizer`` /
    ``b_regularizer`` (``optim.regularizer``) add their penalty to the
    training loss."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int, stride_w: int = 1,
                 stride_h: int = 1, pad_w: int = 0, pad_h: int = 0,
                 n_group: int = 1, propagate_back: bool = True,
                 w_regularizer=None, b_regularizer=None, init_weight=None,
                 init_bias=None, with_bias: bool = True, init_method=None,
                 bias_init_method=None, dilation_w: int = 1,
                 dilation_h: int = 1, format: str = "NCHW", name=None):
        super().__init__(name=name)
        if format not in ("NCHW", "NHWC"):
            raise ValueError(f"format must be NCHW or NHWC, got {format!r}")
        if n_input_plane % n_group or n_output_plane % n_group:
            raise ValueError(f"n_group {n_group} must divide the planes "
                             f"{n_input_plane} -> {n_output_plane}")
        self.format = format
        self.w_regularizer, self.b_regularizer = w_regularizer, b_regularizer
        self.n_input_plane, self.n_output_plane = n_input_plane, n_output_plane
        self.n_group = n_group
        self.kernel = (kernel_h, kernel_w)
        self.stride = (stride_h, stride_w)
        self.padding = (pad_h, pad_w)
        self.dilation = (dilation_h, dilation_w)
        self.init_weight = (None if init_weight is None else _host_array(
            init_weight, (n_output_plane, n_input_plane // n_group,
                          kernel_h, kernel_w)))
        self.init_bias = None if init_bias is None else _host_array(init_bias)
        self.init_method = init_method or Xavier()
        self.bias_init_method = bias_init_method or Zeros()
        self.weight = torch.nn.Parameter(torch.empty(
            n_output_plane, n_input_plane // n_group, kernel_h, kernel_w))
        self.bias = (torch.nn.Parameter(torch.empty(n_output_plane))
                     if with_bias else None)
        self.reset()

    def _reset(self, generator):
        kh, kw = self.kernel
        fans = dict(fan_in=self.n_input_plane // self.n_group * kh * kw,
                    fan_out=self.n_output_plane * kh * kw,
                    generator=generator, device=self.weight.device)
        self.weight.copy_(
            torch.from_numpy(self.init_weight) if self.init_weight is not None
            else self.init_method(self.weight.shape, **fans))
        if self.bias is not None:
            self.bias.copy_(
                torch.from_numpy(self.init_bias) if self.init_bias is not None
                else self.bias_init_method(self.bias.shape, **fans))

    def _regularizers(self):
        """{param name: Regularizer} for the training step's penalty."""
        r = {}
        if self.w_regularizer is not None:
            r["weight"] = self.w_regularizer
        if self.b_regularizer is not None and self.bias is not None:
            r["bias"] = self.b_regularizer
        return r

    def call(self, params, x):
        squeeze = x.dim() == 3
        if squeeze:
            x = x[None]
        nhwc = self.format == "NHWC"
        if nhwc:
            x = x.permute(0, 3, 1, 2)
        pads = _resolve_pads(x.shape[2:], self.kernel, self.stride,
                             self.padding, self.dilation)
        y = _conv2d(x, params["weight"], params.get("bias"), self.stride,
                    pads, self.dilation, self.n_group)
        if nhwc:
            y = y.permute(0, 2, 3, 1)
        return y[0] if squeeze else y


class SpatialShareConvolution(SpatialConvolution):
    """nn/SpatialShareConvolution.scala: the reference's buffer-sharing
    ``SpatialConvolution``, the same layer here."""


class SpatialDilatedConvolution(SpatialConvolution):
    """nn/SpatialDilatedConvolution.scala."""

    def __init__(self, n_input_plane, n_output_plane, kw, kh, dw=1, dh=1,
                 pad_w=0, pad_h=0, dilation_w=1, dilation_h=1,
                 w_regularizer=None, b_regularizer=None, name=None):
        super().__init__(n_input_plane, n_output_plane, kw, kh, dw, dh,
                         pad_w, pad_h, w_regularizer=w_regularizer,
                         b_regularizer=b_regularizer,
                         dilation_w=dilation_w, dilation_h=dilation_h,
                         name=name)


class SpatialFullConvolution(Module):
    """Transposed 2-D convolution (nn/SpatialFullConvolution.scala) over
    NCHW, weight (n_input_plane, n_output_plane / n_group, kh, kw) - torch's
    ``conv_transpose2d`` layout -, Xavier with fan-in n_input_plane kh kw,
    bias zero. The output is the full transposed convolution, (H - 1) dh
    + kh rows, less pad_h rows at the top and pad_h - adj_h at the bottom
    (zero rows added where that is negative): (H - 1) dh - 2 pad_h + kh
    + adj_h rows, as the JAX package's input-dilated convolution gives for
    any adj (``F.conv_transpose2d``'s ``output_padding`` must stay below
    the stride).
    The regularizers are stored and, as in the JAX package, not applied."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kw: int, kh: int, dw: int = 1, dh: int = 1,
                 pad_w: int = 0, pad_h: int = 0, adj_w: int = 0,
                 adj_h: int = 0, n_group: int = 1, no_bias: bool = False,
                 w_regularizer=None, b_regularizer=None, name=None):
        super().__init__(name=name)
        self.n_input_plane, self.n_output_plane = n_input_plane, n_output_plane
        self.kw, self.kh, self.dw, self.dh = kw, kh, dw, dh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.adj_w, self.adj_h = adj_w, adj_h
        self.n_group, self.no_bias = n_group, no_bias
        self.w_regularizer, self.b_regularizer = w_regularizer, b_regularizer
        self.weight = torch.nn.Parameter(torch.empty(
            n_input_plane, n_output_plane // n_group, kh, kw))
        self.bias = (None if no_bias else
                     torch.nn.Parameter(torch.empty(n_output_plane)))
        self.reset()

    def _reset(self, generator):
        self.weight.copy_(Xavier()(
            self.weight.shape, fan_in=self.n_input_plane * self.kh * self.kw,
            fan_out=self.n_output_plane * self.kh * self.kw,
            generator=generator, device=self.weight.device))
        if self.bias is not None:
            self.bias.zero_()

    def call(self, params, x):
        squeeze = x.dim() == 3
        if squeeze:
            x = x[None]
        full = F.conv_transpose2d(x, params["weight"], None,
                                  (self.dh, self.dw), groups=self.n_group)
        # a negative width crops
        y = F.pad(full, (-self.pad_w, self.adj_w - self.pad_w,
                         -self.pad_h, self.adj_h - self.pad_h))
        if not self.no_bias:
            y = y + params["bias"][None, :, None, None]
        return y[0] if squeeze else y


class SpatialSeparableConvolution(Module):
    """A depthwise convolution (``depth_multiplier`` maps per input
    channel, ``depth_weight`` (cin * multiplier, 1, kh, kw)) then a
    pointwise one (``point_weight`` (n_output_channel, cin * multiplier, 1,
    1)) over NCHW (nn/SpatialSeparableConvolution.scala); Xavier weights,
    bias zero."""

    def __init__(self, n_input_channel: int, n_output_channel: int,
                 depth_multiplier: int, kw: int, kh: int, sw: int = 1,
                 sh: int = 1, pw: int = 0, ph: int = 0, has_bias: bool = True,
                 w_regularizer=None, b_regularizer=None, p_regularizer=None,
                 name=None):
        super().__init__(name=name)
        self.n_input_channel = n_input_channel
        self.n_output_channel = n_output_channel
        self.depth_multiplier = depth_multiplier
        self.kw, self.kh, self.sw, self.sh = kw, kh, sw, sh
        self.pw, self.ph = pw, ph
        self.has_bias = has_bias
        cmid = n_input_channel * depth_multiplier
        self.depth_weight = torch.nn.Parameter(torch.empty(cmid, 1, kh, kw))
        self.point_weight = torch.nn.Parameter(
            torch.empty(n_output_channel, cmid, 1, 1))
        self.bias = (torch.nn.Parameter(torch.empty(n_output_channel))
                     if has_bias else None)
        self.reset()

    def _reset(self, generator):
        cmid = self.n_input_channel * self.depth_multiplier
        dev = self.depth_weight.device
        k = self.kh * self.kw
        self.depth_weight.copy_(Xavier()(self.depth_weight.shape, fan_in=k,
                                         fan_out=k, generator=generator,
                                         device=dev))
        self.point_weight.copy_(Xavier()(
            self.point_weight.shape, fan_in=cmid,
            fan_out=self.n_output_channel, generator=generator, device=dev))
        if self.bias is not None:
            self.bias.zero_()

    def call(self, params, x):
        stride = (self.sh, self.sw)
        pads = _resolve_pads(x.shape[2:], (self.kh, self.kw), stride,
                             (self.ph, self.pw))
        y = _conv2d(x, params["depth_weight"], None, stride, pads,
                    groups=self.n_input_channel)
        y = F.conv2d(y, params["point_weight"])
        if self.has_bias:
            y = y + params["bias"][None, :, None, None]
        return y


class SpatialConvolutionMap(Module):
    """A convolution with an input -> output connection table
    (nn/SpatialConvolutionMap.scala): a dense (n_output_plane,
    n_input_plane, kh, kw) weight multiplied by the table's 0 / 1 mask at
    every call, so the unconnected taps stay zero and take no gradient.
    ``conn_table`` holds (n_pairs, 2) 1-based (in, out) pairs; ``full``,
    ``one_to_one`` and ``random`` (numpy's ``RandomState(1)``, as in the
    JAX package) build them. Weight and bias U(+-1/sqrt(kh kw pairs per
    output)); pad -1 is SAME."""

    def __init__(self, conn_table, kw: int, kh: int, dw: int = 1, dh: int = 1,
                 pad_w: int = 0, pad_h: int = 0, name=None):
        super().__init__(name=name)
        self.conn_table = np.asarray(conn_table, dtype=np.int64)
        self.kw, self.kh, self.dw, self.dh = kw, kh, dw, dh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.n_input_plane = int(self.conn_table[:, 0].max())
        self.n_output_plane = int(self.conn_table[:, 1].max())
        self.weight = torch.nn.Parameter(torch.empty(
            self.n_output_plane, self.n_input_plane, kh, kw))
        self.bias = torch.nn.Parameter(torch.empty(self.n_output_plane))
        self.register_buffer("mask", torch.from_numpy(
            self._mask()[:, :, None, None]), persistent=False)
        self.reset()

    @staticmethod
    def full(nin, nout):
        return np.array([(i + 1, o + 1) for o in range(nout)
                         for i in range(nin)])

    @staticmethod
    def one_to_one(nfeat):
        return np.array([(i + 1, i + 1) for i in range(nfeat)])

    @staticmethod
    def random(nin, nout, nto):
        rngs = np.random.RandomState(1)
        pairs = []
        for o in range(nout):
            for i in rngs.choice(nin, size=min(nto, nin), replace=False):
                pairs.append((i + 1, o + 1))
        return np.array(pairs)

    def _mask(self):
        m = np.zeros((self.n_output_plane, self.n_input_plane), np.float32)
        for i, o in self.conn_table:
            m[o - 1, i - 1] = 1.0
        return m

    def _reset(self, generator):
        fan_in = self.kh * self.kw * max(
            1, len(self.conn_table) // self.n_output_plane)
        stdv = 1.0 / np.sqrt(fan_in)
        dev = self.weight.device
        self.weight.copy_(_uniform(self.weight.shape, stdv, generator, dev)
                          * self.mask)
        self.bias.copy_(_uniform(self.bias.shape, stdv, generator, dev))

    def call(self, params, x):
        squeeze = x.dim() == 3
        if squeeze:
            x = x[None]
        pads = _resolve_pads(x.shape[2:], (self.kh, self.kw),
                             (self.dh, self.dw), (self.pad_h, self.pad_w))
        y = _conv2d(x, params["weight"] * self.mask, params["bias"],
                    (self.dh, self.dw), pads)
        return y[0] if squeeze else y


class TemporalConvolution(Module):
    """1-D convolution over (batch, nFrames, frameSize), VALID
    (nn/TemporalConvolution.scala): ``weight`` (out, in, kW) and ``bias``
    U(+-1/sqrt(in kW)). ``propagate_back`` and the regularizers are
    accepted and ignored, as in the JAX package."""

    def __init__(self, input_frame_size: int, output_frame_size: int,
                 kernel_w: int, stride_w: int = 1, propagate_back=True,
                 w_regularizer=None, b_regularizer=None, name=None):
        super().__init__(name=name)
        self.input_frame_size = input_frame_size
        self.output_frame_size = output_frame_size
        self.kernel_w, self.stride_w = kernel_w, stride_w
        self.weight = torch.nn.Parameter(torch.empty(
            output_frame_size, input_frame_size, kernel_w))
        self.bias = torch.nn.Parameter(torch.empty(output_frame_size))
        self.reset()

    def _reset(self, generator):
        stdv = 1.0 / np.sqrt(self.input_frame_size * self.kernel_w)
        dev = self.weight.device
        self.weight.copy_(_uniform(self.weight.shape, stdv, generator, dev))
        self.bias.copy_(_uniform(self.bias.shape, stdv, generator, dev))

    def call(self, params, x):
        squeeze = x.dim() == 2
        if squeeze:
            x = x[None]
        y = F.conv1d(x.transpose(1, 2), params["weight"], params["bias"],
                     self.stride_w).transpose(1, 2)
        return y[0] if squeeze else y


class VolumetricConvolution(Module):
    """3-D convolution over NCDHW (nn/VolumetricConvolution.scala):
    ``weight`` (out, in, kT, kH, kW) Xavier, ``bias`` zero; pad -1 is SAME
    for every dim when any asks for it. The regularizers are accepted and
    ignored, as in the JAX package."""

    def __init__(self, n_input_plane: int, n_output_plane: int, k_t: int,
                 k_w: int, k_h: int, d_t: int = 1, d_w: int = 1, d_h: int = 1,
                 pad_t: int = 0, pad_w: int = 0, pad_h: int = 0,
                 with_bias: bool = True, w_regularizer=None,
                 b_regularizer=None, name=None):
        super().__init__(name=name)
        self.n_input_plane, self.n_output_plane = n_input_plane, n_output_plane
        self.k_t, self.k_w, self.k_h = k_t, k_w, k_h
        self.d_t, self.d_w, self.d_h = d_t, d_w, d_h
        self.pad_t, self.pad_w, self.pad_h = pad_t, pad_w, pad_h
        self.with_bias = with_bias
        self.weight = torch.nn.Parameter(torch.empty(
            n_output_plane, n_input_plane, k_t, k_h, k_w))
        self.bias = (torch.nn.Parameter(torch.empty(n_output_plane))
                     if with_bias else None)
        self.reset()

    def _reset(self, generator):
        k = self.k_t * self.k_h * self.k_w
        self.weight.copy_(Xavier()(
            self.weight.shape, fan_in=self.n_input_plane * k,
            fan_out=self.n_output_plane * k, generator=generator,
            device=self.weight.device))
        if self.bias is not None:
            self.bias.zero_()

    def call(self, params, x):
        squeeze = x.dim() == 4
        if squeeze:
            x = x[None]
        pads = _resolve_pads(x.shape[2:], (self.k_t, self.k_h, self.k_w),
                             (self.d_t, self.d_h, self.d_w),
                             (self.pad_t, self.pad_h, self.pad_w),
                             (1, 1, 1))
        y = _conv3d(x, params["weight"], params.get("bias"),
                    (self.d_t, self.d_h, self.d_w), pads)
        return y[0] if squeeze else y


class VolumetricFullConvolution(Module):
    """Transposed 3-D convolution over NCDHW
    (nn/VolumetricFullConvolution.scala), ``weight`` (n_input_plane,
    n_output_plane, kT, kH, kW) Xavier (fan-in and fan-out both
    n_input_plane kT kH kW, as in the JAX package), bias zero. As
    ``SpatialFullConvolution``: the full transposed convolution less
    ``pad`` planes before and ``pad - adj`` after (zero planes added where
    that is negative), so any ``adj`` works (``F.conv_transpose3d``'s
    ``output_padding`` must stay below the stride). ``n_group`` is
    accepted and ignored, as in the JAX package (one group)."""

    def __init__(self, n_input_plane: int, n_output_plane: int, kt: int,
                 kw: int, kh: int, dt: int = 1, dw: int = 1, dh: int = 1,
                 pad_t: int = 0, pad_w: int = 0, pad_h: int = 0,
                 adj_t: int = 0, adj_w: int = 0, adj_h: int = 0,
                 n_group: int = 1, no_bias: bool = False, name=None):
        super().__init__(name=name)
        self.n_input_plane, self.n_output_plane = n_input_plane, n_output_plane
        self.kt, self.kw, self.kh = kt, kw, kh
        self.dt, self.dw, self.dh = dt, dw, dh
        self.pad_t, self.pad_w, self.pad_h = pad_t, pad_w, pad_h
        self.adj_t, self.adj_w, self.adj_h = adj_t, adj_w, adj_h
        self.no_bias = no_bias
        self.weight = torch.nn.Parameter(torch.empty(
            n_input_plane, n_output_plane, kt, kh, kw))
        self.bias = (None if no_bias else
                     torch.nn.Parameter(torch.empty(n_output_plane)))
        self.reset()

    def _reset(self, generator):
        fan_in = self.n_input_plane * self.kt * self.kh * self.kw
        self.weight.copy_(Xavier()(self.weight.shape, fan_in=fan_in,
                                   fan_out=fan_in, generator=generator,
                                   device=self.weight.device))
        if self.bias is not None:
            self.bias.zero_()

    def call(self, params, x):
        squeeze = x.dim() == 4
        if squeeze:
            x = x[None]
        full = F.conv_transpose3d(x, params["weight"], None,
                                  (self.dt, self.dh, self.dw))
        y = F.pad(full, (-self.pad_w, self.adj_w - self.pad_w,
                         -self.pad_h, self.adj_h - self.pad_h,
                         -self.pad_t, self.adj_t - self.pad_t))
        if not self.no_bias:
            y = y + params["bias"][None, :, None, None, None]
        return y[0] if squeeze else y


class LocallyConnected2D(Module):
    """A 2-D convolution with a weight of its own at every output position
    (nn/LocallyConnected2D.scala) over NCHW: ``weight`` (out_h, out_w,
    n_output_plane, C kh kw) with the patch flattened (C, kh, kw) - the
    order of ``F.unfold``, and of the JAX package's
    ``conv_general_dilated_patches`` -, ``bias`` (n_output_plane, out_h,
    out_w), both U(+-1/sqrt(C kh kw)); the patches (``F.unfold``) meet the
    weights in one batched product."""

    def __init__(self, n_input_plane: int, input_width: int,
                 input_height: int, n_output_plane: int, kernel_w: int,
                 kernel_h: int, stride_w: int = 1, stride_h: int = 1,
                 pad_w: int = 0, pad_h: int = 0, with_bias: bool = True,
                 name=None):
        super().__init__(name=name)
        self.n_input_plane, self.n_output_plane = n_input_plane, n_output_plane
        self.input_width, self.input_height = input_width, input_height
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        self.with_bias = with_bias
        self.out_h = (input_height + 2 * pad_h - kernel_h) // stride_h + 1
        self.out_w = (input_width + 2 * pad_w - kernel_w) // stride_w + 1
        fan_in = n_input_plane * kernel_h * kernel_w
        self.weight = torch.nn.Parameter(torch.empty(
            self.out_h, self.out_w, n_output_plane, fan_in))
        self.bias = (torch.nn.Parameter(torch.empty(
            n_output_plane, self.out_h, self.out_w)) if with_bias else None)
        self.reset()

    def _reset(self, generator):
        stdv = 1.0 / np.sqrt(self.weight.shape[-1])
        dev = self.weight.device
        self.weight.copy_(_uniform(self.weight.shape, stdv, generator, dev))
        if self.bias is not None:
            self.bias.copy_(_uniform(self.bias.shape, stdv, generator, dev))

    def call(self, params, x):
        squeeze = x.dim() == 3
        if squeeze:
            x = x[None]
        patches = F.unfold(x, (self.kernel_h, self.kernel_w),
                           padding=(self.pad_h, self.pad_w),
                           stride=(self.stride_h, self.stride_w))
        patches = patches.reshape(x.shape[0], -1, self.out_h, self.out_w)
        y = torch.einsum("bphw,hwop->bohw", patches, params["weight"])
        if self.with_bias:
            y = y + params["bias"][None]
        return y[0] if squeeze else y


class LocallyConnected1D(Module):
    """A 1-D convolution over (B, nFrames, frameSize) with a weight of its
    own at every output frame (nn/LocallyConnected1D.scala): ``weight``
    (out_frames, out, kW in) with the window flattened (kW, in), ``bias``
    (out_frames, out), U(+-1/sqrt(kW in)). ``propagate_back`` is accepted
    and ignored, as in the JAX package."""

    def __init__(self, n_input_frame: int, input_frame_size: int,
                 output_frame_size: int, kernel_w: int, stride_w: int = 1,
                 propagate_back=True, name=None):
        super().__init__(name=name)
        self.n_input_frame = n_input_frame
        self.input_frame_size = input_frame_size
        self.output_frame_size = output_frame_size
        self.kernel_w, self.stride_w = kernel_w, stride_w
        self.out_frames = (n_input_frame - kernel_w) // stride_w + 1
        self.weight = torch.nn.Parameter(torch.empty(
            self.out_frames, output_frame_size, input_frame_size * kernel_w))
        self.bias = torch.nn.Parameter(torch.empty(self.out_frames,
                                                   output_frame_size))
        self.reset()

    def _reset(self, generator):
        stdv = 1.0 / np.sqrt(self.input_frame_size * self.kernel_w)
        dev = self.weight.device
        self.weight.copy_(_uniform(self.weight.shape, stdv, generator, dev))
        self.bias.copy_(_uniform(self.bias.shape, stdv, generator, dev))

    def call(self, params, x):
        squeeze = x.dim() == 2
        if squeeze:
            x = x[None]
        # (B, out_frames, C, kW) windows -> (B, out_frames, kW C)
        pat = x.unfold(1, self.kernel_w, self.stride_w)[:, :self.out_frames]
        pat = pat.transpose(2, 3).reshape(x.shape[0], self.out_frames, -1)
        y = torch.einsum("btp,top->bto", pat, params["weight"]) \
            + params["bias"]
        return y[0] if squeeze else y
