"""Int8 post-training quantization (counterpart of
``bigdl_tpu/quantization/quantize.py``; parity: the reference's
``nn/quantized/`` and ``Module.quantize()``).

Weights are quantized per output channel to int8 (symmetric, scale =
max|w| / 127); activations per tensor, dynamically (one max-reduce a call)
or from a static calibrated scale (``calibration.calibrate``). The
int8 x int8 -> int32 contractions go through ``kernels.int8_matmul``
(``int8_matmul`` / ``int8_conv2d``): on the card the hand-written
tensor-core GEMM, on the CPU their exact int32 plain versions. The
rescales are the JAX package's float32 operations in its order:
``maximum(absmax, 1e-8) / 127``, then ``round(x / scale)`` (half to even,
as ``jnp.round``), clipped to +-127.

The quantized modules hold their int8 weights and float32 scales as
parameters that take no gradient (``qweight`` / ``scale``, the
separable convolution's ``qdepth`` / ``dscale`` / ``qpoint`` /
``pscale``, and a static ``act_scale`` when calibrated), under JAX's
names.
"""
from __future__ import annotations

import copy
import logging
import types

import numpy as np
import torch

from ..kernels.int8_matmul import int8_conv2d, int8_matmul
from ..nn.conv import SpatialConvolution, SpatialSeparableConvolution, \
    _resolve_pads
from ..nn.graph_container import Graph
from ..nn.linear import Linear
from ..nn.module import Container, Module

__all__ = ["quantize_weight", "child_path", "QuantizedLinear",
           "QuantizedSpatialConvolution",
           "QuantizedSpatialSeparableConvolution", "quantize"]


def _tensor(w):
    return w.detach() if isinstance(w, torch.Tensor) else \
        torch.as_tensor(np.asarray(w))


def quantize_weight(w, axis=0):
    """Symmetric per-channel int8 quantization along ``axis`` (out-channels).
    Returns (int8 weights, f32 scales)."""
    w = _tensor(w)
    red = tuple(i for i in range(w.dim()) if i != axis)
    absmax = w.abs().amax(dim=red, keepdim=True) if red else w.abs()
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dynamic_quantize(x):
    absmax = x.detach().abs().amax()
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    return _static_quantize(x, scale), scale


def _static_quantize(x, scale):
    # JAX promotes a bf16 activation against a float32 calibrated scale
    dt = torch.promote_types(x.dtype, scale.dtype)
    return torch.clamp(torch.round(x.detach().to(dt) / scale.to(dt)),
                       -127, 127).to(torch.int8)


def child_path(path: str, i: int) -> str:
    """Layer-path keying shared by quantize and calibration ('0/2/...')."""
    return f"{path}/{i}" if path else str(i)


def _frozen(t):
    return torch.nn.Parameter(t, requires_grad=False)


def _activation(params, x):
    """(int8 x, its scale): the calibrated static scale when the params
    hold one (no max-reduce), else the dynamic per-tensor one."""
    if "act_scale" in params:
        xs = params["act_scale"]
        return _static_quantize(x, xs), xs
    return _dynamic_quantize(x)


class _Quantized(Module):
    """Shared by the quantized layers: the float params captured at
    ``from_float`` become the module's int8 parameters in ``_init_params``
    (on the float weights' device)."""

    def _set_params(self, p):
        for k, v in p.items():
            setattr(self, k, _frozen(v))
        self._src_params = None     # the float weights are not kept
        return self.params

    def _act(self, p, device):
        if getattr(self, "_act_scale", None) is not None:
            p["act_scale"] = torch.tensor(float(self._act_scale),
                                          dtype=torch.float32, device=device)
        return p


class QuantizedLinear(_Quantized):
    """nn/quantized/Linear.scala — int8 weights, int32 accumulate."""

    def __init__(self, input_size, output_size, with_bias=True, name=None):
        super().__init__(name=name)
        self.input_size, self.output_size = input_size, output_size
        self.with_bias = with_bias
        self._src_params = None  # float params captured at quantize() time

    @staticmethod
    def from_float(layer: Linear, params, act_scale=None):
        q = QuantizedLinear(layer.input_size, layer.output_size,
                            "bias" in params, name=layer.name + "_int8")
        q._src_params = params
        q._act_scale = act_scale
        return q

    def _init_params(self, rng):
        w = self._src_params["weight"]
        qw, scale = quantize_weight(w, axis=0)
        p = self._act({"qweight": qw, "scale": scale.reshape(-1)}, w.device)
        if self.with_bias:
            p["bias"] = self._src_params["bias"].detach().clone()
        return self._set_params(p)

    def call(self, params, x):
        xq, xs = _activation(params, x)
        k = x.shape[-1]
        acc = int8_matmul(xq.reshape(-1, k).contiguous(), params["qweight"])
        acc = acc.reshape(x.shape[:-1] + (self.output_size,))
        y = acc.to(torch.float32) * (xs * params["scale"])
        if self.with_bias:
            y = y + params["bias"]
        return y


def _conv_cfg(conv: SpatialConvolution):
    """What the quantized convolution reads of a float one (the JAX
    module keeps the float module as ``cfg``; the port keeps its settings,
    not its weights)."""
    return types.SimpleNamespace(
        kernel=conv.kernel, stride=conv.stride, padding=conv.padding,
        dilation=conv.dilation, n_group=conv.n_group,
        with_bias=conv.bias is not None, name=conv.name)


def _sep_cfg(sep: SpatialSeparableConvolution):
    return types.SimpleNamespace(
        n_input_channel=sep.n_input_channel, kh=sep.kh, kw=sep.kw,
        sh=sep.sh, sw=sep.sw, ph=sep.ph, pw=sep.pw, has_bias=sep.has_bias,
        name=sep.name)


def _rescale(acc, xs, scale):
    return acc.to(torch.float32) * (xs * scale)[None, :, None, None]


class QuantizedSpatialConvolution(_Quantized):
    """nn/quantized/SpatialConvolution.scala — int8 conv, NCHW."""

    def __init__(self, conv: SpatialConvolution, name=None):
        super().__init__(name=name or conv.name + "_int8")
        self.cfg = _conv_cfg(conv)
        self._src_params = None

    @staticmethod
    def from_float(conv: SpatialConvolution, params, act_scale=None):
        q = QuantizedSpatialConvolution(conv)
        q._src_params = params
        q._act_scale = act_scale
        return q

    def _init_params(self, rng):
        w = self._src_params["weight"]  # (out, in/g, kh, kw)
        qw, scale = quantize_weight(w, axis=0)
        p = self._act({"qweight": qw, "scale": scale.reshape(-1)}, w.device)
        if self.cfg.with_bias:
            p["bias"] = self._src_params["bias"].detach().clone()
        return self._set_params(p)

    def call(self, params, x):
        c = self.cfg
        squeeze = x.dim() == 3
        if squeeze:
            x = x[None]
        xq, xs = _activation(params, x)
        pads = _resolve_pads(x.shape[2:], c.kernel, c.stride, c.padding,
                             c.dilation)
        acc = int8_conv2d(xq, params["qweight"], c.stride, pads, c.dilation,
                          c.n_group)
        y = _rescale(acc, xs, params["scale"])
        if c.with_bias:
            y = y + params["bias"][None, :, None, None]
        return y[0] if squeeze else y


class QuantizedSpatialSeparableConvolution(_Quantized):
    """Int8 depthwise + pointwise conv (parity: reference
    ``nn/quantized/SpatialDilatedConvolution.scala`` breadth — the separable
    factorization quantizes both stages; the intermediate is requantized
    dynamically between them)."""

    def __init__(self, sep, name=None):
        super().__init__(name=name or sep.name + "_int8")
        self.cfg = _sep_cfg(sep)
        self._src_params = None

    @staticmethod
    def from_float(sep, params, act_scale=None):
        q = QuantizedSpatialSeparableConvolution(sep)
        q._src_params = params
        q._act_scale = act_scale
        return q

    def _init_params(self, rng):
        dw = self._src_params["depth_weight"]
        qd, dscale = quantize_weight(dw, axis=0)
        qp, pscale = quantize_weight(self._src_params["point_weight"], axis=0)
        p = self._act({"qdepth": qd, "dscale": dscale.reshape(-1),
                       "qpoint": qp, "pscale": pscale.reshape(-1)},
                      dw.device)
        if self.cfg.has_bias:
            p["bias"] = self._src_params["bias"].detach().clone()
        return self._set_params(p)

    def call(self, params, x):
        c = self.cfg
        squeeze = x.dim() == 3
        if squeeze:
            x = x[None]
        xq, xs = _activation(params, x)
        stride = (c.sh, c.sw)
        pads = _resolve_pads(x.shape[2:], (c.kh, c.kw), stride, (c.ph, c.pw))
        acc = int8_conv2d(xq, params["qdepth"], stride, pads, 1,
                          c.n_input_channel)
        mid = _rescale(acc, xs, params["dscale"])
        mq, ms = _dynamic_quantize(mid)
        acc2 = int8_conv2d(mq, params["qpoint"])
        y = _rescale(acc2, ms, params["pscale"])
        if c.has_bias:
            y = y + params["bias"][None, :, None, None]
        return y[0] if squeeze else y


def _children(module):
    return [module[i] for i in range(len(module._modules))]


def _quantize_rec(module: Module, params, calibration, path="", used=None):
    """Return (new_module, new_params) with eligible layers replaced.
    ``calibration`` maps layer paths (child_path keying, shared with
    calibration.quantizable_paths) to static activation scales; None →
    dynamic quantization. ``used`` collects matched calibration keys.
    Containers are rewritten in place; their params tree is the new
    children's."""
    act = (calibration or {}).get(path)
    if act is not None and used is not None:
        used.add(path)
    from ..nn.sparse import SparseLinear
    if isinstance(module, Linear) and not isinstance(
            module, (QuantizedLinear, SparseLinear)):
        # SparseLinear stays float: its value is the COO input path, which
        # the dense int8 contraction cannot take
        q = QuantizedLinear.from_float(module, params, act)
        return q, q._init_params(None)
    if isinstance(module, SpatialConvolution):
        q = QuantizedSpatialConvolution.from_float(module, params, act)
        return q, q._init_params(None)
    if isinstance(module, SpatialSeparableConvolution):
        q = QuantizedSpatialSeparableConvolution.from_float(module, params,
                                                            act)
        return q, q._init_params(None)
    if isinstance(module, Container):
        for i, child in enumerate(_children(module)):
            nm, _ = _quantize_rec(child, params[str(i)], calibration,
                                  child_path(path, i), used)
            if nm is not child:
                module.add_module(str(i), nm)
                if isinstance(module, Graph):
                    for node in module.topo:
                        if node.module is child:
                            node.module = nm
        return module, module.params
    return module, params


def quantize(model: Module, calibration=None) -> Module:
    """Module.quantize() parity: returns an int8-inference copy of the model
    (weights quantized per-channel; activations quantized dynamically, or
    statically when a ``calibration`` dict from
    ``quantization.calibrate(model, batches)`` is given)."""
    model.ensure_initialized()
    m = copy.deepcopy(model)
    used = set()
    with torch.no_grad():
        new_m, _ = _quantize_rec(m, m.params, calibration, used=used)
    if calibration and set(calibration) - used:
        logging.getLogger(__name__).warning(
            "calibration keys not matched to any quantizable layer "
            "(falling back to dynamic quantization elsewhere): %s",
            sorted(set(calibration) - used))
    new_m.grad_params = None
    new_m.evaluate()
    return new_m
