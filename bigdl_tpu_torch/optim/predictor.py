"""Batch prediction, shape buckets and the shared inference forward
(counterpart of ``bigdl_tpu/optim/predictor.py``).

:func:`shared_forward` is the one :class:`CompiledForward` a model has,
weakly cached per model as in the JAX package: an eager
``model.apply(params, state, x, training=False)`` under
``torch.inference_mode()``. Taking ``params`` and ``state`` as arguments
is what lets a serving registry swap versions under one forward.
:class:`Predictor` runs it over a data set: a ragged last batch is
zero-padded on the host to its bucket (:func:`bucket_for`) and sliced
back, the outputs stay on the model's device, and ``predict`` reads them
back once, at the end. The forward runs through
``observability.perf.instrument_jit`` (``predict/forward/<model>``, and a
superstep group ``predict/forward_scan/<model>``; keyed on the input), as
JAX's compiled forwards do.
"""
from __future__ import annotations

import threading
import weakref

import numpy as np
import torch

from .. import observability as obs
from ..utils.table import Table

__all__ = ["bucket_for", "shape_buckets", "leading_dim", "pad_leading",
           "CompiledForward", "shared_forward", "Predictor",
           "PredictionService"]


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


def leading_dim(x) -> int:
    """Rows in a batch (an array, a tensor, or a Table of them)."""
    if isinstance(x, Table):
        return leading_dim(x[1]) if len(x) else 0
    return int(np.shape(x)[0])


def pad_leading(x, bucket: int):
    """Zero-pad a batch (numpy array or tensor, or a Table of them) along
    axis 0 up to ``bucket`` rows; host arrays stay on the host, so the
    transfer and the forward both see the bucket shape. Rows past the true
    count are zeros."""
    if isinstance(x, Table):
        return Table(*(pad_leading(m, bucket) for m in x))
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
        self._jit = obs.perf.instrument_jit(
            self.run, name=f"predict/forward/{type(model).__name__}",
            kind="forward", key_argnums=(2,))

    @property
    def model(self):
        return self._model_ref()

    def fn(self):
        return self.__call__

    def run(self, params, state, x):
        """The forward itself, outside the cost notes."""
        model = self._model_ref()
        if model is None:
            raise RuntimeError("model was garbage-collected")
        with torch.inference_mode():
            out, _ = model.apply(params, state, x, training=False)
        return out

    def __call__(self, params, state, x):
        with self._lock:
            self._shapes.add(tuple(x.shape))
        return self._jit(params, state, x)

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


class Predictor:
    """Batch prediction with ``model``'s shared forward, where its
    parameters live. ``batch_per_partition`` is the default batch of
    ``predict(ds)`` without a ``batch_size`` (the port runs on one device,
    so it is the whole batch); ``prefetch_depth`` is the stager's
    lookahead (``optim.staging``)."""

    def __init__(self, model, batch_per_partition: int = 4,
                 prefetch_depth: int = 2):
        self.model = model
        self.batch_per_partition = batch_per_partition
        self.prefetch_depth = prefetch_depth
        self._superstep = 1
        self._scan_jit = None

    def set_superstep(self, k: int):
        """K batches a group: the stager stacks K same-shape batches into
        one ``[K, B, ...]`` placement and K forwards run on its slices
        (the port has no ``lax.scan``); ``predict/dispatches`` counts
        groups, as JAX counts its scanned programs."""
        if k < 1:
            raise ValueError(f"superstep must be >= 1, got {k}")
        self._superstep = int(k)
        return self

    def _default_batch(self):
        return self.batch_per_partition

    def _forward_fn(self):
        return shared_forward(self.model)

    def _scan_fn(self):
        """A superstep group's forwards, one program of the cost notes
        (JAX scans them in one compiled program)."""
        if self._scan_jit is None:
            from .staging import _index
            fwd = self._forward_fn()

            def fwd_scan(params, state, xs, n):
                return [fwd.run(params, state, _index(xs, i))
                        for i in range(n)]
            self._scan_jit = obs.perf.instrument_jit(
                fwd_scan,
                name=f"predict/forward_scan/{type(self.model).__name__}",
                kind="forward", key_argnums=(2,))
        return self._scan_jit

    def _iter_outputs(self, dataset, batch_size):
        """Yields ``(output, rows)`` per batch, the output on the model's
        device and ``rows`` the true count to slice back to (a ragged
        final batch is zero-padded on the host to ``bucket_for`` rows)."""
        from ..dataset.dataset import DataSet, ShardedDataSet
        from .evaluator import _model_device, _shape_key
        from .staging import _index, _stack, place_host_value, staged
        if isinstance(dataset, np.ndarray):
            dataset = DataSet.from_arrays(dataset)
        self.model.ensure_initialized()
        dev = _model_device(self.model)
        fwd = self._forward_fn()
        k = self._superstep

        def host(mb):
            x = mb.get_input()
            n = leading_dim(x)
            if 0 < n < batch_size:
                x = pad_leading(x, bucket_for(n, batch_size))
            return x, n

        def stage(mb):
            x, n = host(mb)
            return place_host_value(x, dev), n

        def group(items):
            return (place_host_value(_stack([x for x, _ in items]), dev),
                    tuple(n for _, n in items))

        batched = ShardedDataSet(dataset, batch_size, drop_last=False)
        batches = staged(batched.data(train=False),
                         host if k > 1 else stage,
                         depth=self.prefetch_depth, name="predict_stager",
                         group=k, group_fn=group if k > 1 else None,
                         group_key=(lambda it: _shape_key(it[0]))
                         if k > 1 else None, device=dev)
        try:
            for item in batches:
                sp = obs.span("predict/batch")
                if k > 1:
                    xs, ns = item
                    with sp:
                        outs = self._scan_fn()(self.model.params,
                                               self.model.state, xs, len(ns))
                else:
                    x, n = item
                    with sp:
                        outs = [fwd(self.model.params, self.model.state, x)]
                    ns = (n,)
                if obs.enabled():
                    obs.counter("predict/dispatches").inc()
                    obs.histogram("predict/batch_s", unit="s").observe(
                        sp.duration_s)
                yield from zip(outs, ns)
        finally:
            batches.close()     # an abandoned generator joins the stager

    def predict(self, dataset, batch_size=None):
        """The outputs of every sample in insertion order, as one host
        array: the per-batch outputs stay on the device and are read back
        once, at the end."""
        outs = [o[:n] for o, n in self._iter_outputs(
            dataset, batch_size or self._default_batch())]
        if not outs:
            return np.empty((0,), np.float32)
        out = torch.cat(outs).cpu()     # the one readback
        if obs.enabled():
            obs.counter("predict/readbacks").inc()
        return out.numpy()

    def predict_class(self, dataset, batch_size=None):
        """1-based argmax class of each sample, as the reference's
        predictClass."""
        return np.argmax(self.predict(dataset, batch_size), axis=-1) + 1


class PredictionService(Predictor):
    """Thread-safe serving facade (the reference's PredictionService):
    the shared forward is safe to call from several threads. The online
    engine (micro-batching, buckets, back-pressure, hot swap) is
    ``serving``."""
