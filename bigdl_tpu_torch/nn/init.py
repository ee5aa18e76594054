"""Weight initialisation methods (counterpart of ``bigdl_tpu/nn/init.py``:
``Zeros``, ``Ones``, ``ConstInit``, ``RandomUniform`` - ``Linear``'s
default -, ``RandomNormal``, ``Xavier`` - ``SpatialConvolution``'s -,
``MsraFiller`` and ``BilinearFiller``).

The fan conventions are the JAX package's (the reference's): a 2-D weight
(out, in) has fan-in ``in`` and fan-out ``out``; a conv weight (out, in,
*kernel) counts the receptive field in both. ``init(shape, fan_in,
fan_out, generator, device, dtype)`` returns a new tensor drawn with
``generator`` (a ``torch.Generator`` on ``device``; torch's global one when
None). The draws differ from JAX's for the same seed; tests load JAX's
weights instead.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["InitializationMethod", "Zeros", "Ones", "ConstInit",
           "ConstInitMethod", "RandomUniform", "RandomNormal", "Xavier",
           "MsraFiller", "BilinearFiller"]


def _fans(shape, fan_in=None, fan_out=None):
    if fan_in is not None and fan_out is not None:
        return fan_in, fan_out
    shape = tuple(shape)
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:      # (out, in), the reference Linear layout
        return shape[1], shape[0]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def _uniform(shape, stdv, generator=None, device=None):
    """U(-stdv, stdv), the layers' ``jax.random.uniform(minval=-stdv,
    maxval=stdv)``."""
    return RandomUniform(-stdv, stdv)(shape, generator=generator,
                                      device=device)


class InitializationMethod:
    def __call__(self, shape, fan_in=None, fan_out=None, generator=None,
                 device=None, dtype=torch.float32):
        raise NotImplementedError(type(self).__name__)


class Zeros(InitializationMethod):
    def __call__(self, shape, fan_in=None, fan_out=None, generator=None,
                 device=None, dtype=torch.float32):
        return torch.zeros(shape, device=device, dtype=dtype)


class Ones(InitializationMethod):
    def __call__(self, shape, fan_in=None, fan_out=None, generator=None,
                 device=None, dtype=torch.float32):
        return torch.ones(shape, device=device, dtype=dtype)


class ConstInit(InitializationMethod):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, fan_in=None, fan_out=None, generator=None,
                 device=None, dtype=torch.float32):
        return torch.full(tuple(shape), self.value, device=device,
                          dtype=dtype)


class RandomUniform(InitializationMethod):
    """U(lower, upper); without bounds U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""

    def __init__(self, lower=None, upper=None):
        self.lower, self.upper = lower, upper

    def __call__(self, shape, fan_in=None, fan_out=None, generator=None,
                 device=None, dtype=torch.float32):
        if self.lower is None:
            fi, _ = _fans(shape, fan_in, fan_out)
            hi = 1.0 / math.sqrt(max(fi, 1))
            lo = -hi
        else:
            lo, hi = self.lower, self.upper
        return torch.empty(shape, device=device, dtype=dtype).uniform_(
            lo, hi, generator=generator)


class RandomNormal(InitializationMethod):
    """N(mean, stdv^2)."""

    def __init__(self, mean=0.0, stdv=1.0):
        self.mean, self.stdv = mean, stdv

    def __call__(self, shape, fan_in=None, fan_out=None, generator=None,
                 device=None, dtype=torch.float32):
        return torch.empty(shape, device=device, dtype=dtype).normal_(
            self.mean, self.stdv, generator=generator)


class Xavier(InitializationMethod):
    """Glorot uniform: U(+-sqrt(6 / (fan_in + fan_out)))."""

    def __call__(self, shape, fan_in=None, fan_out=None, generator=None,
                 device=None, dtype=torch.float32):
        fi, fo = _fans(shape, fan_in, fan_out)
        hi = math.sqrt(6.0 / (fi + fo))
        return torch.empty(shape, device=device, dtype=dtype).uniform_(
            -hi, hi, generator=generator)


class MsraFiller(InitializationMethod):
    """He init: N(0, 2 / n) with n = fan_in, or the mean of fan_in and
    fan_out when ``variance_norm_average``."""

    def __init__(self, variance_norm_average: bool = True):
        self.variance_norm_average = variance_norm_average

    def __call__(self, shape, fan_in=None, fan_out=None, generator=None,
                 device=None, dtype=torch.float32):
        fi, fo = _fans(shape, fan_in, fan_out)
        n = (fi + fo) / 2.0 if self.variance_norm_average else fi
        std = math.sqrt(2.0 / max(n, 1.0))
        return torch.empty(shape, device=device, dtype=dtype).normal_(
            0.0, std, generator=generator)


class BilinearFiller(InitializationMethod):
    """The bilinear upsampling kernel of a transposed convolution, the same
    (kh, kw) plane in every (out, in) slot of the weight."""

    def __call__(self, shape, fan_in=None, fan_out=None, generator=None,
                 device=None, dtype=torch.float32):
        kh, kw = shape[-2], shape[-1]
        f = int(np.ceil(kw / 2.0))
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        xs = np.arange(kh * kw)
        vals = (1 - np.abs(xs % kw / f - c)) * (1 - np.abs(xs // kw / f - c))
        w = np.broadcast_to(vals.reshape(kh, kw).astype(np.float32),
                            tuple(shape))
        return torch.tensor(w, device=device, dtype=dtype)


# the pyspark nn/initialization_method.py spelling
ConstInitMethod = ConstInit
