"""Elementwise math and utility layers (counterpart of
``bigdl_tpu/nn/elementwise.py``).

Gradients follow the JAX package's where the two frameworks differ:
``Abs`` passes +1 at 0 (``jnp.abs``; ``torch.abs`` passes 0), and
``GradientReversal`` / ``L1Penalty`` are ``torch.autograd.Function``\\ s
with the backward of JAX's ``custom_vjp``.
"""
from __future__ import annotations

import torch

from .module import Module

__all__ = ["Identity", "Echo", "Contiguous", "Abs", "Exp", "Log", "Sqrt",
           "Square", "Negative", "Power", "AddConstant", "MulConstant",
           "GradientReversal", "L1Penalty", "ErrorInfo"]


def jabs(x):
    """|x| with ``jnp.abs``'s gradient: +1 at 0 (``torch.abs`` passes 0)."""
    return torch.where(x >= 0, x, -x)


class _Elementwise(Module):
    def _fn(self, x):
        raise NotImplementedError(type(self).__name__)

    def call(self, params, x):
        return self._fn(x)


class Identity(_Elementwise):
    def _fn(self, x):
        return x


class Echo(_Elementwise):
    """Prints the input's shape and dtype (a debug aid, nn/Echo.scala)."""

    def _fn(self, x):
        print(f"[Echo {self.name}] shape={tuple(getattr(x, 'shape', ()))} "
              f"dtype={getattr(x, 'dtype', None)}")
        return x


class Contiguous(_Elementwise):
    """The input in contiguous memory (nn/Contiguous.scala)."""

    def _fn(self, x):
        return x.contiguous()


class Abs(_Elementwise):
    """|x| with ``jnp.abs``'s gradient: +1 at 0."""

    def _fn(self, x):
        return jabs(x)


class Exp(_Elementwise):
    def _fn(self, x):
        return torch.exp(x)


class Log(_Elementwise):
    def _fn(self, x):
        return torch.log(x)


class Sqrt(_Elementwise):
    def _fn(self, x):
        return torch.sqrt(x)


class Square(_Elementwise):
    def _fn(self, x):
        return torch.square(x)


class Negative(_Elementwise):
    def __init__(self, inplace=False, name=None):
        super().__init__(name=name)

    def _fn(self, x):
        return -x


class Power(_Elementwise):
    """(shift + scale * x) ** power (nn/Power.scala)."""

    def __init__(self, power, scale: float = 1.0, shift: float = 0.0,
                 name=None):
        super().__init__(name=name)
        self.power, self.scale, self.shift = power, scale, shift

    def _fn(self, x):
        return torch.pow(self.shift + self.scale * x, self.power)


class AddConstant(_Elementwise):
    def __init__(self, constant_scalar, ip: bool = False, name=None):
        super().__init__(name=name)
        self.constant_scalar = constant_scalar

    def _fn(self, x):
        return x + self.constant_scalar


class MulConstant(_Elementwise):
    def __init__(self, scalar, ip: bool = False, name=None):
        super().__init__(name=name)
        self.scalar = scalar

    def _fn(self, x):
        return x * self.scalar


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lmbda):
        ctx.lmbda = lmbda
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.lmbda * g, None


class GradientReversal(Module):
    """Identity forward, -lambda * grad backward
    (nn/GradientReversal.scala)."""

    def __init__(self, the_lambda: float = 1.0, name=None):
        super().__init__(name=name)
        self.the_lambda = the_lambda

    def set_lambda(self, l):
        self.the_lambda = l
        return self

    def call(self, params, x):
        return _GradReverse.apply(x, self.the_lambda)


class _L1Penalty(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, m, provide_output):
        ctx.save_for_backward(x)
        ctx.m, ctx.provide_output = m, provide_output
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        gi = ctx.m * torch.sign(x)          # sign(0) == 0, as jnp.sign
        return (gi + g if ctx.provide_output else gi), None, None


class L1Penalty(Module):
    """Identity forward; the backward adds the gradient of an L1 activation
    penalty, ``m * sign(input)`` (plus the incoming gradient when
    ``provide_output``), m = l1weight, divided by the input's size when
    ``size_average`` (nn/L1Penalty.scala)."""

    def __init__(self, l1weight: float, size_average: bool = False,
                 provide_output: bool = True, name=None):
        super().__init__(name=name)
        self.l1weight = float(l1weight)
        self.size_average = size_average
        self.provide_output = provide_output

    def call(self, params, x):
        m = self.l1weight / (x.numel() if self.size_average else 1.0)
        return _L1Penalty.apply(x, m, self.provide_output)


class ErrorInfo:
    """Messages of nn/ErrorInfo.scala."""
    constrainEachInputAsVectorOrBatch = \
        "Each input should be a 1D vector or a batch of them"
