"""Normalization (counterpart of ``bigdl_tpu/nn/norm.py``: LayerNorm, and
the BatchNorms with their running statistics as module state)."""
from __future__ import annotations

import torch

from ..utils.engine import refuse_unported
from .module import Module


class LayerNormalization(Module):
    """LayerNorm over the last dim. ``eps`` defaults to 1e-6, the JAX
    package's value (not torch's 1e-5)."""

    def __init__(self, hidden_size: int, eps: float = 1e-6, name=None):
        super().__init__(name=name)
        self.hidden_size, self.eps = hidden_size, eps
        self.weight = torch.nn.Parameter(torch.ones(hidden_size))
        self.bias = torch.nn.Parameter(torch.zeros(hidden_size))

    def call(self, params, x):
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * params["weight"] + params["bias"]


class BatchNormalization(Module):
    """BatchNorm over (B, C) input, reducing over the batch
    (nn/BatchNormalization.scala). Running statistics are the module's
    state (``running_mean``, ``running_var``, float32 buffers); ``apply``
    returns the new ones, with the reference's momentum semantics
    ``(1 - m) * running + m * batch`` and the unbiased batch variance.
    Training uses the JAX package's shifted one-pass statistics: with
    s = running_mean (no gradient), mean = E[x - s] + s and var =
    E[(x - s)^2] - E[x - s]^2, all in float32. The output keeps x's
    dtype. ``init_weight`` / ``init_bias`` are not ported and raise at a
    value other than None."""

    _channel_axis = 1

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 init_weight=None, init_bias=None, name=None):
        super().__init__(name=name)
        refuse_unported(type(self).__name__, init_weight=(init_weight, None),
                        init_bias=(init_bias, None))
        self.n_output, self.eps, self.momentum = n_output, eps, momentum
        if affine:
            self.weight = torch.nn.Parameter(torch.ones(n_output))
            self.bias = torch.nn.Parameter(torch.zeros(n_output))
        self.register_buffer("running_mean", torch.zeros(n_output))
        self.register_buffer("running_var", torch.ones(n_output))

    def _reset(self, generator):
        if "weight" in self._parameters:
            self.weight.fill_(1.0)
            self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def apply(self, params, state, x, training: bool = False,
              generator=None):
        ch = self._channel_axis % x.dim()
        ax = tuple(i for i in range(x.dim()) if i != ch)
        shape = [1] * x.dim()
        shape[ch] = self.n_output
        if training:
            shift = state["running_mean"].detach().float().reshape(shape)
            xs = x.float() - shift
            m1 = xs.mean(ax)
            var = torch.clamp(xs.square().mean(ax) - m1.square(), min=0.0)
            mean = m1 + shift.reshape(-1)
            n = x.numel() // self.n_output
            unbiased = var * n / max(n - 1, 1)
            m = self.momentum
            new_state = {
                "running_mean": ((1 - m) * state["running_mean"]
                                 + m * mean).detach(),
                "running_var": ((1 - m) * state["running_var"]
                                + m * unbiased).detach()}
        else:
            mean, var = state["running_mean"], state["running_var"]
            new_state = state
        y = (x - mean.reshape(shape)) * torch.rsqrt(var + self.eps).reshape(
            shape)
        if "weight" in params:
            y = y * params["weight"].reshape(shape) + \
                params["bias"].reshape(shape)
        return y.to(x.dtype), new_state


class SpatialBatchNormalization(BatchNormalization):
    """Per-channel BatchNorm over NCHW or NHWC
    (nn/SpatialBatchNormalization.scala; ``data_format`` as in the
    reference)."""

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 init_weight=None, init_bias=None,
                 data_format: str = "NCHW", name=None):
        super().__init__(n_output, eps, momentum, affine, init_weight,
                         init_bias, name)
        if data_format not in ("NCHW", "NHWC"):
            raise ValueError(f"data_format must be NCHW or NHWC, got "
                             f"{data_format!r}")
        if data_format == "NHWC":
            self._channel_axis = -1
