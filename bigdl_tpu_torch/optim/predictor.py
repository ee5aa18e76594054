"""Shape buckets and the shared inference forward (the part of
``bigdl_tpu/optim/predictor.py`` the serving tier needs).

:func:`shared_forward` is the one :class:`CompiledForward` a model has,
weakly cached per model as in the JAX package: an eager
``model.apply(params, state, x, training=False)`` under
``torch.inference_mode()``. Taking ``params`` and ``state`` as arguments
is what lets a serving registry swap versions under one forward.
"""
from __future__ import annotations

import threading
import weakref

import numpy as np
import torch

__all__ = ["bucket_for", "shape_buckets", "pad_leading", "CompiledForward",
           "shared_forward"]


def bucket_for(n: int, max_batch: int) -> int:
    """Smallest power of two >= ``n``, capped at ``max_batch``: the padded
    batch size a ragged batch of ``n`` rows dispatches as."""
    if n <= 0:
        raise ValueError(f"batch rows must be positive, got {n}")
    if n >= max_batch:
        return max_batch
    b = 1
    while b < n:
        b <<= 1
    return min(b, max_batch)


def shape_buckets(max_batch: int):
    """Every bucket of ``max_batch``: ascending powers of two and
    ``max_batch`` itself (what serving warmup drives)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b <<= 1
    out.append(max_batch)
    return tuple(out)


def pad_leading(x, bucket: int):
    """Zero-pad a batch (numpy array or tensor) along axis 0 up to
    ``bucket`` rows; host arrays stay on the host, so the transfer and the
    forward both see the bucket shape. Rows past the true count are
    zeros."""
    n = x.shape[0]
    if n == bucket:
        return x
    if n > bucket:
        raise ValueError(f"batch of {n} rows exceeds bucket {bucket}")
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x.new_zeros((bucket - n,) + tuple(x.shape[1:]))])
    x = np.asarray(x)
    return np.pad(x, [(0, bucket - n)] + [(0, 0)] * (x.ndim - 1))


class CompiledForward:
    """The ``(params, state, x) -> output`` inference forward of one model
    instance, shared by every consumer (the JAX package compiles it once
    per shape; here it runs eagerly). The model is held weakly, as the
    cache's key; :meth:`compiled_shape_count` counts the distinct input
    shapes run so far."""

    def __init__(self, model):
        self._model_ref = weakref.ref(model)
        self._shapes = set()
        self._lock = threading.Lock()

    @property
    def model(self):
        return self._model_ref()

    def fn(self):
        return self.__call__

    def __call__(self, params, state, x):
        model = self._model_ref()
        if model is None:
            raise RuntimeError("model was garbage-collected")
        with self._lock:
            self._shapes.add(tuple(x.shape))
        with torch.inference_mode():
            out, _ = model.apply(params, state, x, training=False)
        return out

    def compiled_shape_count(self) -> int:
        with self._lock:
            return len(self._shapes)


_shared_forwards = weakref.WeakKeyDictionary()
_shared_lock = threading.Lock()


def shared_forward(model) -> CompiledForward:
    """The process-wide :class:`CompiledForward` for ``model`` (weakly
    keyed: dropping the model drops it)."""
    fwd = _shared_forwards.get(model)
    if fwd is None:
        with _shared_lock:
            fwd = _shared_forwards.get(model)
            if fwd is None:
                fwd = CompiledForward(model)
                _shared_forwards[model] = fwd
    return fwd
