"""Static int8 calibration (counterpart of
``bigdl_tpu/quantization/calibration.py``).

A calibration pass runs representative batches through the *float* model
with observers on every quantizable layer's input, records activation
ranges, and ``quantize(model, calibration=...)`` then uses the static
scales instead of the dynamic per-batch max (no runtime max-reduce).

Observers:
- ``MinMaxObserver`` — running max of |x| (the reference's default).
- ``MovingAverageObserver`` — EMA of per-batch max |x|.
- ``PercentileObserver`` — max of a per-batch percentile of |x|.

The observers hook each layer's ``apply`` (the method the port's
containers call on a child; JAX hooks ``_apply``) as an instance attribute
that shadows the class method, removed again in ``finally``.

Conv+BN fusion: ``fold_batchnorm`` folds inference-mode
BatchNormalization into a preceding Linear / SpatialConvolution inside
Sequential containers, in place, with JAX's numpy float32 arithmetic.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Tuple

import numpy as np
import torch

from ..nn.containers import Sequential
from ..nn.conv import SpatialConvolution
from ..nn.linear import Linear
from ..nn.module import Container, Module
from ..nn.norm import BatchNormalization
from .quantize import (QuantizedLinear, _children, child_path)

__all__ = ["Observer", "MinMaxObserver", "MovingAverageObserver",
           "PercentileObserver", "quantizable_paths", "calibrate",
           "fold_batchnorm"]


def _absmax(x) -> float:
    return float(x.detach().abs().amax())


class Observer:
    """Tracks the absolute activation range of one layer's input."""

    def update(self, x) -> None:
        raise NotImplementedError

    @property
    def absmax(self) -> float:
        raise NotImplementedError

    @property
    def scale(self) -> float:
        return max(float(self.absmax), 1e-8) / 127.0


class MinMaxObserver(Observer):
    def __init__(self):
        self._max = 0.0

    def update(self, x):
        self._max = max(self._max, _absmax(x))

    @property
    def absmax(self):
        return self._max


class MovingAverageObserver(Observer):
    def __init__(self, momentum: float = 0.9):
        self.momentum = momentum
        self._avg = None

    def update(self, x):
        batch_max = _absmax(x)
        self._avg = batch_max if self._avg is None else \
            self.momentum * self._avg + (1 - self.momentum) * batch_max

    @property
    def absmax(self):
        return self._avg or 0.0


class PercentileObserver(Observer):
    def __init__(self, percentile: float = 99.99):
        self.percentile = percentile
        self._max = 0.0

    def update(self, x):
        a = x.detach().float().cpu().numpy()
        p = float(np.percentile(np.abs(a), self.percentile))
        self._max = max(self._max, p)

    @property
    def absmax(self):
        return self._max


def _walk(module: Module, path: str = ""):
    """Yield (path, module) with the same keying used by
    quantize._quantize_rec (shared child_path) so scales line up."""
    yield path, module
    if isinstance(module, Container):
        for i, child in enumerate(_children(module)):
            yield from _walk(child, child_path(path, i))


def quantizable_paths(model: Module) -> List[Tuple[str, Module]]:
    """Layers quantize() will convert — same isinstance tests as
    quantize._quantize_rec."""
    from ..nn.conv import SpatialSeparableConvolution
    from ..nn.sparse import SparseLinear
    return [(p, m) for p, m in _walk(model)
            if (isinstance(m, Linear) and not isinstance(
                m, (QuantizedLinear, SparseLinear)))
            or isinstance(m, (SpatialConvolution,
                              SpatialSeparableConvolution))]


def _device(model):
    for t in model.parameters():
        return t.device
    return torch.device("cpu")


def calibrate(model: Module, batches: Iterable,
              observer_factory: Callable[[], Observer] = MinMaxObserver,
              ) -> Dict[str, float]:
    """Run ``batches`` (tensors or arrays) through the float model in eval
    mode, observing the input range of every quantizable layer.
    → {layer_path: activation_scale}."""
    model.ensure_initialized()
    was_training = bool(model.training)
    model.evaluate()
    observers: Dict[str, Observer] = {}
    hooked: List[Module] = []
    dev = _device(model)
    try:
        for path, mod in quantizable_paths(model):
            obs = observers[path] = observer_factory()

            def wrapped(params, state, x, training=False, generator=None,
                        _orig=mod.apply, _obs=obs):
                _obs.update(x)
                return _orig(params, state, x, training, generator)

            mod.apply = wrapped  # instance attr shadows the class method
            hooked.append(mod)
        with torch.no_grad():
            for x in batches:
                if not isinstance(x, torch.Tensor):
                    x = torch.as_tensor(np.asarray(x), device=dev)
                model.forward(x)
    finally:
        for mod in hooked:
            # the same instance may sit at several paths (shared layers)
            mod.__dict__.pop("apply", None)
        if was_training:
            model.training()
    return {p: o.scale for p, o in observers.items()}


def fold_batchnorm(model: Module) -> Module:
    """Fold eval-mode BN into the preceding Linear/SpatialConvolution inside
    Sequential containers (in place); the folded BN is replaced by an
    ``Identity``."""
    from ..nn.elementwise import Identity

    def host(t):
        return t.detach().cpu().numpy()

    def fold_pair(layer: Module, bn: BatchNormalization) -> None:
        bp = bn._parameters
        gamma = host(bp["weight"]) if bp.get("weight") is not None \
            else np.ones(bn.n_output)
        beta = host(bp["bias"]) if bp.get("bias") is not None \
            else np.zeros(bn.n_output)
        mean = host(bn.running_mean)
        var = host(bn.running_var)
        factor = gamma / np.sqrt(var + bn.eps)
        w = host(layer.weight)
        shape = (-1,) + (1,) * (w.ndim - 1)
        bias = host(layer.bias) if layer.bias is not None else \
            np.zeros_like(mean)
        new_w = w * factor.reshape(shape)
        new_b = (bias - mean) * factor + beta
        with torch.no_grad():
            layer.weight.copy_(torch.from_numpy(np.ascontiguousarray(new_w)))
            if layer.bias is None:
                layer.bias = torch.nn.Parameter(torch.zeros(
                    w.shape[0], device=layer.weight.device))
                if hasattr(layer, "with_bias"):
                    layer.with_bias = True
            layer.bias.copy_(torch.from_numpy(np.asarray(new_b)))

    def rec(module: Module):
        if isinstance(module, Sequential):
            mods = _children(module)
            for i in range(len(mods) - 1):
                layer, bn = mods[i], mods[i + 1]
                if isinstance(layer, (Linear, SpatialConvolution)) and \
                        isinstance(bn, BatchNormalization) and \
                        "weight" in bn._parameters:
                    fold_pair(layer, bn)
                    module.add_module(str(i + 1), Identity())
                    mods[i + 1] = module[i + 1]
        if isinstance(module, Container):
            for child in _children(module):
                rec(child)

    model.ensure_initialized()
    rec(model)
    model.grad_params = None
    return model
