"""Weight initialisation methods (counterpart of ``bigdl_tpu/nn/init.py``;
the ones the ResNet slice needs: ``Zeros``, ``Ones``, ``RandomUniform`` -
``Linear``'s default -, ``Xavier`` - ``SpatialConvolution``'s - and
``MsraFiller``).

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

import torch


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
