"""Dropout and noise layers (counterpart of ``bigdl_tpu/nn/dropout.py``).

Randomness comes from the ``torch.Generator`` threaded through ``apply``
(``generator``, on the input's device), as the JAX package threads its
PRNG key; in training mode a layer that draws needs one. The draws differ
from JAX's for the same seed: evaluation mode and p = 0 are the identity
in both, and in training mode the keep rate, the 1 / (1 - p) scale and
the reproducibility of a generator's mask are what hold.
"""
from __future__ import annotations

import torch

from .module import Module

__all__ = ["Dropout", "GaussianDropout", "GaussianNoise", "GaussianSampler",
           "SpatialDropout1D", "SpatialDropout2D", "SpatialDropout3D"]


def _require_generator(generator, name):
    if generator is None:
        raise ValueError(f"{name} needs a torch.Generator in training mode; "
                         f"pass generator= to apply() (the training loop "
                         f"and the stateful forward pass their own)")
    return generator


def _keep(shape, p, generator, x):
    """A boolean mask of ``shape``, True with probability 1 - p."""
    return torch.rand(shape, generator=generator, device=x.device) < 1.0 - p


def _normal(x, generator):
    return torch.randn(x.shape, generator=generator, device=x.device,
                       dtype=x.dtype)


class Dropout(Module):
    """Inverted dropout (nn/Dropout.scala): kept values scaled by
    1 / (1 - p) at training time when ``scale``."""

    def __init__(self, init_p: float = 0.5, inplace: bool = False,
                 scale: bool = True, name=None):
        super().__init__(name=name)
        self.p = init_p
        self.scale = scale

    def set_p(self, p):
        self.p = p
        return self

    def apply(self, params, state, x, training: bool = False,
              generator=None):
        if not training or self.p <= 0.0:
            return x, state
        keep = _keep(x.shape, self.p, _require_generator(generator,
                                                         "Dropout"), x)
        y = torch.where(keep, x, 0.0)
        return (y / (1.0 - self.p) if self.scale else y), state


class GaussianDropout(Module):
    """Multiplicative N(1, rate / (1 - rate)) noise at training time
    (nn/GaussianDropout.scala)."""

    def __init__(self, rate: float, name=None):
        super().__init__(name=name)
        self.rate = rate

    def apply(self, params, state, x, training: bool = False,
              generator=None):
        if not training:
            return x, state
        g = _require_generator(generator, "GaussianDropout")
        std = (self.rate / (1.0 - self.rate)) ** 0.5
        return x * (1.0 + std * _normal(x, g)), state


class GaussianNoise(Module):
    """Additive N(0, stddev) noise at training time
    (nn/GaussianNoise.scala)."""

    def __init__(self, stddev: float, name=None):
        super().__init__(name=name)
        self.stddev = stddev

    def apply(self, params, state, x, training: bool = False,
              generator=None):
        if not training:
            return x, state
        g = _require_generator(generator, "GaussianNoise")
        return x + self.stddev * _normal(x, g), state


class GaussianSampler(Module):
    """The VAE reparameterisation: a sample of N(mean, exp(logvar)) from
    ``Table(mean, logvar)`` in training mode, the mean otherwise
    (nn/GaussianSampler.scala)."""

    def apply(self, params, state, x, training: bool = False,
              generator=None):
        mean, logvar = x[1], x[2]
        if not training:
            return mean, state
        eps = _normal(mean, _require_generator(generator, "GaussianSampler"))
        return mean + torch.exp(0.5 * logvar) * eps, state


class _SpatialDropout(Module):
    """Drop whole feature maps (channels) together, scaled by
    1 / (1 - p)."""

    def __init__(self, init_p: float = 0.5, name=None):
        super().__init__(name=name)
        self.p = init_p

    def _mask_shape(self, x):
        raise NotImplementedError(type(self).__name__)

    def apply(self, params, state, x, training: bool = False,
              generator=None):
        if not training or self.p <= 0.0:
            return x, state
        g = _require_generator(generator, type(self).__name__)
        keep = _keep(self._mask_shape(x), self.p, g, x)
        return torch.where(keep, x, 0.0) / (1.0 - self.p), state


class SpatialDropout1D(_SpatialDropout):
    """(B, T, C): drop channels (nn/SpatialDropout1D.scala)."""

    def _mask_shape(self, x):
        return tuple(x.shape[:-2]) + (1, x.shape[-1])


class SpatialDropout2D(_SpatialDropout):
    """(B, C, H, W): drop channels (nn/SpatialDropout2D.scala)."""

    def _mask_shape(self, x):
        return tuple(x.shape[:-2]) + (1, 1)


class SpatialDropout3D(_SpatialDropout):
    """(B, C, D, H, W): drop channels (nn/SpatialDropout3D.scala)."""

    def _mask_shape(self, x):
        return tuple(x.shape[:-3]) + (1, 1, 1)
