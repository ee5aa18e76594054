"""Normalization (counterpart of ``bigdl_tpu/nn/norm.py``): LayerNorm, the
BatchNorms with their running statistics as module state, the local
response normalisations, ``Normalize`` / ``NormalizeScale``, the
subtractive / divisive / contrastive normalisations and ``Masking``.

The LRN window sums are average pools over the zero-padded squares (the
JAX package's ``reduce_window`` sums, divided as its formulas divide)."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .conv import _conv2d
from .elementwise import jabs
from .module import Module

__all__ = ["BatchNormalization", "SpatialBatchNormalization",
           "VolumetricBatchNormalization", "LayerNormalization",
           "SpatialCrossMapLRN", "SpatialWithinChannelLRN", "Normalize",
           "NormalizeScale", "SpatialSubtractiveNormalization",
           "SpatialDivisiveNormalization", "SpatialContrastiveNormalization",
           "Masking"]


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
    dtype. ``init_weight`` / ``init_bias`` give the affine parameters'
    initial values (ones and zeros without them)."""

    _channel_axis = 1

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 init_weight=None, init_bias=None, name=None):
        super().__init__(name=name)
        self.n_output, self.eps, self.momentum = n_output, eps, momentum
        self.init_weight = (None if init_weight is None else
                            np.array(init_weight, np.float32, copy=True))
        self.init_bias = (None if init_bias is None else
                          np.array(init_bias, np.float32, copy=True))
        if affine:
            self.weight = torch.nn.Parameter(torch.ones(n_output))
            self.bias = torch.nn.Parameter(torch.zeros(n_output))
        self.register_buffer("running_mean", torch.zeros(n_output))
        self.register_buffer("running_var", torch.ones(n_output))
        self.reset()

    def _reset(self, generator):
        if "weight" in self._parameters:
            if self.init_weight is None:
                self.weight.fill_(1.0)
            else:
                self.weight.copy_(torch.from_numpy(self.init_weight))
            if self.init_bias is None:
                self.bias.zero_()
            else:
                self.bias.copy_(torch.from_numpy(self.init_bias))
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def apply(self, params, state, x, training: bool = False,
              generator=None):
        ch = self._channel_axis % x.dim()
        ax = tuple(i for i in range(x.dim()) if i != ch)
        shape = [1] * x.dim()
        shape[ch] = self.n_output
        if training:
            from ..parallel.collective import batch_group, global_sums
            shift = state["running_mean"].detach().float().reshape(shape)
            xs = x.float() - shift
            n = x.numel() // self.n_output
            m1 = xs.mean(ax)
            sq = xs.square().mean(ax)
            bg = batch_group()
            if bg is not None:
                # a replicated data-parallel step: the global batch's
                # statistics, the mean of the ranks' equal-sized shares
                m1, sq = global_sums(m1, sq)
                m1, sq = m1 / bg[1], sq / bg[1]
                n = n * bg[1]
            var = torch.clamp(sq - m1.square(), min=0.0)
            mean = m1 + shift.reshape(-1)
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


class VolumetricBatchNormalization(BatchNormalization):
    """Per-channel BatchNorm over NCDHW."""


class SpatialCrossMapLRN(Module):
    """AlexNet's LRN across channels of NCHW (nn/SpatialCrossMapLRN.scala):
    y = x / (k + alpha / size * sum of x^2 over the ``size`` nearest
    channels)^beta, the window padded with (size - 1) // 2 channels before
    and the rest after."""

    def __init__(self, size: int = 5, alpha: float = 1.0, beta: float = 0.75,
                 k: float = 1.0, name=None):
        super().__init__(name=name)
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def call(self, params, x):
        half = (self.size - 1) // 2
        sq = F.pad(torch.square(x), (0, 0, 0, 0, half, self.size - 1 - half))
        mean = F.avg_pool3d(sq[:, None], (self.size, 1, 1), 1)[:, 0]
        return x / torch.pow(self.k + self.alpha * mean, self.beta)


class SpatialWithinChannelLRN(Module):
    """LRN within each channel over a size x size window
    (nn/SpatialWithinChannelLRN.scala)."""

    def __init__(self, size: int = 5, alpha: float = 1.0, beta: float = 0.75,
                 name=None):
        super().__init__(name=name)
        self.size, self.alpha, self.beta = size, alpha, beta

    def call(self, params, x):
        half = (self.size - 1) // 2
        extra = self.size - 1 - half
        sq = F.pad(torch.square(x), (half, extra, half, extra))
        mean = F.avg_pool2d(sq, self.size, 1)
        return x / torch.pow(1.0 + self.alpha * mean, self.beta)


def _lp_norm(x, p):
    """The Lp norm over dim 1, kept."""
    if math.isinf(p):
        return torch.amax(jabs(x), 1, keepdim=True)
    if p == 2.0:
        return torch.sqrt(torch.square(x).sum(1, keepdim=True))
    return torch.pow(torch.pow(jabs(x), p).sum(1, keepdim=True), 1.0 / p)


class Normalize(Module):
    """Lp-normalise over the feature dim (dim 1) (nn/Normalize.scala)."""

    def __init__(self, p: float = 2.0, eps: float = 1e-10, name=None):
        super().__init__(name=name)
        self.p, self.eps = p, eps

    def call(self, params, x):
        return x / (_lp_norm(x, self.p) + self.eps)


class NormalizeScale(Module):
    """Lp-normalise the channels (dim 1), then scale by the learnable
    ``weight`` of shape ``size``, initialised to ``scale``
    (nn/NormalizeScale.scala, SSD's conv4_3 norm)."""

    def __init__(self, p: float = 2.0, eps: float = 1e-10,
                 scale: float = 1.0, size=None, w_regularizer=None,
                 name=None):
        super().__init__(name=name)
        if size is None:
            raise ValueError("NormalizeScale needs the weight's size")
        self.p, self.eps, self.scale = p, eps, scale
        self.size = tuple(size)
        self.weight = torch.nn.Parameter(torch.full(self.size, float(scale)))

    def _reset(self, generator):
        self.weight.fill_(float(self.scale))

    def call(self, params, x):
        n = torch.pow(torch.pow(jabs(x), self.p).sum(1, keepdim=True),
                      1.0 / self.p)
        w = params["weight"]
        if w.dim() < x.dim():
            w = w.reshape((1,) * (x.dim() - w.dim()) + tuple(w.shape))
        return x / (n + self.eps) * w


def _gaussian_2d(size):
    k = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(k ** 2) / (2.0 * (size / 4.0) ** 2))
    g2 = np.outer(g, g)
    return (g2 / g2.sum()).astype(np.float32)


def _local_kernel(kernel):
    """The normalised 2-D averaging kernel (a 9x9 Gaussian by default; a
    1-D kernel is used as its outer product)."""
    k = (np.asarray(kernel, np.float32) if kernel is not None
         else _gaussian_2d(9))
    if k.ndim == 1:
        k = np.outer(k, k)
    return (k / k.sum()).astype(np.float32)


def _local_mean(x, kernel, n_planes):
    """Each plane's ``kernel``-weighted local mean, divided by the kernel's
    mass inside the image (the edge correction)."""
    kh, kw = kernel.shape
    k = torch.from_numpy(kernel).to(x)[None, None]
    pads = ((kh // 2, (kh - 1) // 2), (kw // 2, (kw - 1) // 2))
    mean = _conv2d(x, k.repeat(n_planes, 1, 1, 1), None, (1, 1), pads,
                   groups=n_planes)
    mass = _conv2d(torch.ones_like(x[:, :1]), k, None, (1, 1), pads)
    return mean / mass


class SpatialSubtractiveNormalization(Module):
    """Subtract the weighted local mean
    (nn/SpatialSubtractiveNormalization.scala)."""

    def __init__(self, n_input_plane: int = 1, kernel=None, name=None):
        super().__init__(name=name)
        self.n_input_plane = n_input_plane
        self.kernel = _local_kernel(kernel)

    def call(self, params, x):
        return x - _local_mean(x, self.kernel, self.n_input_plane)


def _divisive(x, kernel, n_planes, threshold, thresval):
    local_var = _local_mean(torch.square(x), kernel, n_planes)
    local_std = torch.sqrt(torch.maximum(local_var, local_var.new_zeros(())))
    mean_std = local_std.mean((2, 3), keepdim=True)
    denom = torch.maximum(local_std, mean_std)
    denom = torch.where(denom < threshold, thresval, denom)
    return x / denom


class SpatialDivisiveNormalization(Module):
    """Divide by the local standard deviation, floored by its plane mean
    and by ``threshold`` (nn/SpatialDivisiveNormalization.scala)."""

    def __init__(self, n_input_plane: int = 1, kernel=None,
                 threshold: float = 1e-4, thresval: float = 1e-4, name=None):
        super().__init__(name=name)
        self.n_input_plane = n_input_plane
        self.kernel = _local_kernel(kernel)
        self.threshold, self.thresval = threshold, thresval

    def call(self, params, x):
        return _divisive(x, self.kernel, self.n_input_plane, self.threshold,
                         self.thresval)


class SpatialContrastiveNormalization(Module):
    """Subtractive, then divisive normalisation
    (nn/SpatialContrastiveNormalization.scala)."""

    def __init__(self, n_input_plane: int = 1, kernel=None,
                 threshold: float = 1e-4, thresval: float = 1e-4, name=None):
        super().__init__(name=name)
        self.n_input_plane = n_input_plane
        self.kernel = _local_kernel(kernel)
        self.threshold, self.thresval = threshold, thresval

    def call(self, params, x):
        y = x - _local_mean(x, self.kernel, self.n_input_plane)
        return _divisive(y, self.kernel, self.n_input_plane, self.threshold,
                         self.thresval)


class Masking(Module):
    """Zero the timesteps (last-dim vectors) equal to ``mask_value``
    everywhere (nn/Masking.scala)."""

    def __init__(self, mask_value: float = 0.0, name=None):
        super().__init__(name=name)
        self.mask_value = mask_value

    def call(self, params, x):
        keep = (x != self.mask_value).any(-1, keepdim=True)
        return x * keep.to(x.dtype)
