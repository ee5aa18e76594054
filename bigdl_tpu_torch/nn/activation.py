"""Activations (counterpart of ``bigdl_tpu/nn/activation.py``).

The clips (``ReLU6``, ``HardTanh``, ``Clamp``, ``HardSigmoid``) are
``jnp.clip``'s ``minimum(hi, maximum(lo, x))``, so at a bound they pass
half the gradient, as ``jnp.maximum`` / ``jnp.minimum`` split a tie
(``torch.clamp`` and ``F.hardtanh`` pass all of it); ``ELU`` keeps the
same tie at 0. ``GELU`` is ``jax.nn.gelu``'s default tanh approximation.
``RReLU`` draws its slopes from the ``generator`` given to ``apply`` in
training mode (the mean slope without one, as JAX without an rng).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .init import RandomUniform
from .module import Module

__all__ = ["ReLU", "ReLU6", "LeakyReLU", "PReLU", "RReLU", "SReLU", "ELU",
           "GELU", "SoftPlus", "SoftSign", "Sigmoid", "LogSigmoid", "Tanh",
           "TanhShrink", "HardTanh", "Clamp", "HardSigmoid", "HardShrink",
           "SoftShrink", "SoftMax", "SoftMin", "LogSoftMax", "Threshold",
           "BinaryThreshold", "Maxout"]


class _Elementwise(Module):
    def _fn(self, x):
        raise NotImplementedError(type(self).__name__)

    def call(self, params, x):
        return self._fn(x)


def _default_softmax_axis(x):
    return 0 if x.dim() == 1 else 1


def _clip(x, lo, hi):
    """``jnp.clip(x, lo, hi)``, gradient included (half at a bound)."""
    return torch.minimum(x.new_tensor(hi), torch.maximum(x.new_tensor(lo), x))


class ReLU(_Elementwise):
    """max(x, 0), gradient 0 at 0 (``ip`` is accepted and ignored, as in
    the JAX package)."""

    def __init__(self, ip: bool = False, name=None):
        super().__init__(name=name)

    def _fn(self, x):
        return torch.relu(x)


class ReLU6(_Elementwise):
    def __init__(self, ip: bool = False, name=None):
        super().__init__(name=name)

    def _fn(self, x):
        return _clip(x, 0.0, 6.0)


class LeakyReLU(_Elementwise):
    def __init__(self, negval: float = 0.01, ip: bool = False, name=None):
        super().__init__(name=name)
        self.negval = negval

    def _fn(self, x):
        return torch.where(x >= 0, x, self.negval * x)


class PReLU(Module):
    """Learnable slope (nn/PReLU.scala): one per channel (dim 1) or, with
    ``n_output_plane=0``, one shared; initialised to 0.25."""

    def __init__(self, n_output_plane: int = 0, name=None):
        super().__init__(name=name)
        self.n_output_plane = n_output_plane
        self.weight = torch.nn.Parameter(
            torch.full((max(n_output_plane, 1),), 0.25))

    def _reset(self, generator):
        self.weight.fill_(0.25)

    def call(self, params, x):
        w = params["weight"]
        if self.n_output_plane > 0 and x.dim() >= 2:
            shape = [1] * x.dim()
            shape[1] = self.n_output_plane
            w = w.reshape(shape)
        return torch.where(x >= 0, x, w * x)


class RReLU(Module):
    """Randomised leaky ReLU (nn/RReLU.scala): slopes ~ U[lower, upper]
    in training mode with a generator, their mean otherwise."""

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3,
                 ip: bool = False, name=None):
        super().__init__(name=name)
        self.lower, self.upper = lower, upper

    def apply(self, params, state, x, training: bool = False,
              generator=None):
        if training and generator is not None:
            a = torch.rand(x.shape, generator=generator, device=x.device,
                           dtype=x.dtype) * (self.upper - self.lower) \
                + self.lower
        else:
            a = (self.lower + self.upper) / 2.0
        return torch.where(x >= 0, x, a * x), state


class SReLU(Module):
    """S-shaped ReLU with four learnable tensors of ``shape``, size 1 along
    the 1-based ``shared_axes`` (nn/SReLU.scala)."""

    def __init__(self, shape, shared_axes=None, name=None):
        super().__init__(name=name)
        self.shape = tuple(shape)
        self.shared_axes = shared_axes
        s = list(self.shape)
        for ax in shared_axes or ():
            s[ax - 1] = 1
        for n in ("t_left", "a_left", "t_right", "a_right"):
            setattr(self, n, torch.nn.Parameter(torch.empty(s)))
        self.reset()

    def _reset(self, generator):
        self.t_left.zero_()
        self.a_left.zero_()
        self.t_right.fill_(1.0)
        self.a_right.fill_(1.0)

    def call(self, params, x):
        tl, al = params["t_left"], params["a_left"]
        tr, ar = params["t_right"], params["a_right"]
        y_left = tl + al * (x - tl)
        y_right = tr + ar * (x - tr)
        return torch.where(x < tl, y_left, torch.where(x > tr, y_right, x))


class ELU(_Elementwise):
    def __init__(self, alpha: float = 1.0, ip: bool = False, name=None):
        super().__init__(name=name)
        self.alpha = alpha

    def _fn(self, x):
        neg = self.alpha * (torch.exp(torch.minimum(x, x.new_zeros(()))) - 1)
        return torch.where(x > 0, x, neg)


class GELU(_Elementwise):
    def _fn(self, x):
        return F.gelu(x, approximate="tanh")


class SoftPlus(_Elementwise):
    def __init__(self, beta: float = 1.0, name=None):
        super().__init__(name=name)
        self.beta = beta

    def _fn(self, x):
        bx = self.beta * x
        return torch.logaddexp(bx, torch.zeros_like(bx)) / self.beta


class SoftSign(_Elementwise):
    def _fn(self, x):
        return x / (1.0 + torch.abs(x))


class Sigmoid(_Elementwise):
    def _fn(self, x):
        return torch.sigmoid(x)


class LogSigmoid(_Elementwise):
    def _fn(self, x):
        return F.logsigmoid(x)


class Tanh(_Elementwise):
    def _fn(self, x):
        return torch.tanh(x)


class TanhShrink(_Elementwise):
    def _fn(self, x):
        return x - torch.tanh(x)


class HardTanh(_Elementwise):
    def __init__(self, min_value: float = -1.0, max_value: float = 1.0,
                 ip: bool = False, name=None):
        super().__init__(name=name)
        self.min_value, self.max_value = min_value, max_value

    def _fn(self, x):
        return _clip(x, self.min_value, self.max_value)


class Clamp(HardTanh):
    def __init__(self, min_value, max_value, name=None):
        super().__init__(min_value, max_value, name=name)


class HardSigmoid(_Elementwise):
    def _fn(self, x):
        return _clip(0.2 * x + 0.5, 0.0, 1.0)


class HardShrink(_Elementwise):
    def __init__(self, lambda_: float = 0.5, name=None):
        super().__init__(name=name)
        self.lambda_ = lambda_

    def _fn(self, x):
        return torch.where(torch.abs(x) > self.lambda_, x, 0.0)


class SoftShrink(_Elementwise):
    def __init__(self, lambda_: float = 0.5, name=None):
        super().__init__(name=name)
        self.lambda_ = lambda_

    def _fn(self, x):
        lam = self.lambda_
        return torch.where(x > lam, x - lam,
                           torch.where(x < -lam, x + lam, 0.0))


class SoftMax(_Elementwise):
    """Softmax over ``axis``; by default the class dim (0 for a vector, 1
    for a batch)."""

    def __init__(self, axis=None, name=None):
        super().__init__(name=name)
        self.axis = axis

    def _fn(self, x):
        ax = self.axis if self.axis is not None else _default_softmax_axis(x)
        return torch.softmax(x, ax)


class SoftMin(_Elementwise):
    def __init__(self, axis=None, name=None):
        super().__init__(name=name)
        self.axis = axis

    def _fn(self, x):
        ax = self.axis if self.axis is not None else _default_softmax_axis(x)
        return torch.softmax(-x, ax)


class LogSoftMax(_Elementwise):
    def __init__(self, axis=None, name=None):
        super().__init__(name=name)
        self.axis = axis

    def _fn(self, x):
        ax = self.axis if self.axis is not None else _default_softmax_axis(x)
        return torch.log_softmax(x, ax)


class Threshold(_Elementwise):
    """x > th ? x : v (nn/Threshold.scala)."""

    def __init__(self, th: float = 1e-6, v: float = 0.0, ip: bool = False,
                 name=None):
        super().__init__(name=name)
        self.th, self.v = th, v

    def _fn(self, x):
        return torch.where(x > self.th, x, self.v)


class BinaryThreshold(_Elementwise):
    def __init__(self, th: float = 1e-6, ip: bool = False, name=None):
        super().__init__(name=name)
        self.th = th

    def _fn(self, x):
        return (x > self.th).to(x.dtype)


class Maxout(Module):
    """A linear map to ``maxout_number * output_size`` features, then the
    max over each group of ``maxout_number`` (nn/Maxout.scala); ``weight``
    is (input_size, maxout_number * output_size), both drawn from
    U(+-1/sqrt(input_size)). Ties split the gradient evenly (``jnp.max``)."""

    def __init__(self, input_size: int, output_size: int, maxout_number: int,
                 with_bias: bool = True, name=None):
        super().__init__(name=name)
        self.input_size, self.output_size = input_size, output_size
        self.maxout_number = maxout_number
        self.with_bias = with_bias
        n = maxout_number * output_size
        self.weight = torch.nn.Parameter(torch.empty(input_size, n))
        self.bias = torch.nn.Parameter(torch.empty(n)) if with_bias else None
        self.reset()

    def _reset(self, generator):
        s = 1.0 / math.sqrt(self.input_size)
        init = RandomUniform(-s, s)
        self.weight.copy_(init(self.weight.shape, generator=generator,
                               device=self.weight.device))
        if self.bias is not None:
            self.bias.copy_(init(self.bias.shape, generator=generator,
                                 device=self.bias.device))

    def call(self, params, x):
        y = x @ params["weight"]
        if self.with_bias:
            y = y + params["bias"]
        y = y.reshape(y.shape[:-1] + (self.maxout_number, self.output_size))
        return torch.amax(y, -2)
