"""Evaluator (counterpart of ``bigdl_tpu/optim/evaluator.py``, parity with
the reference's ``optim/Evaluator.scala`` / ``optim/LocalValidator.scala``).

``evaluate(dataset, methods, batch_size)`` runs the model's
``apply(params, state, x, training=False)`` over the data set in
insertion order, in batches of ``batch_size`` (the last one shorter;
variable-length samples padded with 0, ``MiniBatch.from_samples``). When
every method has a device form (``ValidationMethod.device_stats``, all
built-in ones but ``TreeNNAccuracy``), the per-batch statistics are summed
on the model's device and read back ONCE per evaluation, as in the JAX
package; otherwise each batch's output comes to the host for the numpy
methods. Batches are staged by ``optim.staging`` (on a lookahead thread
with ``prefetch_depth`` >= 2, the default, inline with 0 or 1); with
``set_superstep(K)`` the device path stacks K batches into one placement
and runs their K forwards back to back, summing the statistics as it
goes."""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..dataset.dataset import AbstractDataSet, ShardedDataSet
from ..utils.engine import resolve_device
from ..utils.table import Table
from .staging import _first_leaf, _index, _stack, place_host_value, staged

__all__ = ["Evaluator", "LocalValidator"]


def _model_device(model):
    for t in model.parameters():
        return t.device
    for t in model.buffers():
        return t.device
    return resolve_device(None)


def _leaves(x):
    if isinstance(x, (tuple, list, Table)):
        return [l for i in x for l in _leaves(i)]
    return [] if x is None else [x]


def _shape_key(item):
    """Group key: the leaves' shapes and dtypes, so a ragged last batch
    forms its own, smaller group."""
    return tuple((np.shape(l), str(np.asarray(l).dtype))
                 for l in _leaves(item))


class Evaluator:
    """Evaluates ``model`` where its parameters live. ``prefetch_depth``
    is the batch stager's lookahead (``optim.staging``)."""

    def __init__(self, model, prefetch_depth: int = 2):
        self.model = model
        self.prefetch_depth = prefetch_depth
        self._superstep = 1

    def set_superstep(self, k: int):
        """K evaluation batches a group on the device path (every built-in
        method but ``TreeNNAccuracy``): one stacked placement, K forwards,
        the statistics summed on the device; the host path evaluates batch
        by batch regardless."""
        if k < 1:
            raise ValueError(f"superstep must be >= 1, got {k}")
        self._superstep = int(k)
        return self

    def evaluate(self, dataset: AbstractDataSet, methods: List,
                 batch_size: int = 32):
        """A list of one ``ValidationResult`` per method (None each for an
        empty data set)."""
        self.model.ensure_initialized()
        batched = ShardedDataSet(dataset, batch_size, drop_last=False)
        with torch.no_grad():
            if all(m.supports_device_stats() for m in methods):
                return self._evaluate_device(batched, methods)
            return self._evaluate_host(batched, methods)

    def _forward(self, x):
        out, _ = self.model.apply(self.model.params, self.model.state, x,
                                  training=False)
        return out

    def _evaluate_device(self, batched, methods):
        """Per-batch statistics summed on the device; one readback."""
        dev = _model_device(self.model)
        k = self._superstep

        def place(xy):
            return (place_host_value(xy[0], dev),
                    place_host_value(xy[1], dev))

        def stack(items):
            return place((_stack([x for x, _ in items]),
                          _stack([y for _, y in items])))

        host = lambda mb: (mb.get_input(), mb.get_target())
        batches = staged(batched.data(train=False),
                         host if k > 1 else lambda mb: place(host(mb)),
                         depth=self.prefetch_depth, name="eval_stager",
                         group=k, group_fn=stack if k > 1 else None,
                         group_key=_shape_key if k > 1 else None,
                         device=dev)
        acc = None
        try:
            for x, y in batches:
                n = len(_first_leaf(x)) if k > 1 else 1
                for i in range(n):
                    xi, yi = (x, y) if k == 1 else (_index(x, i),
                                                    _index(y, i))
                    out = self._forward(xi)
                    stats = [m.device_stats(out, yi) for m in methods]
                    acc = stats if acc is None else \
                        [a + s for a, s in zip(acc, stats)]
        finally:
            batches.close()
        if acc is None:
            return [None] * len(methods)
        # the one readback of the summed statistics
        host = torch.cat(acc).cpu().split([a.numel() for a in acc])
        return [m.result_from_stats(s) for m, s in zip(methods, host)]

    def _evaluate_host(self, batched, methods):
        """Per-batch numpy methods (a method without a device form)."""
        dev = _model_device(self.model)
        results = [None] * len(methods)
        batches = staged(batched.data(train=False),
                         lambda mb: (place_host_value(mb.get_input(), dev),
                                     mb),
                         depth=self.prefetch_depth, name="eval_stager",
                         device=dev)
        try:
            for x, mb in batches:
                out = self._forward(x)
                for i, m in enumerate(methods):
                    r = m(out, mb.get_target())
                    results[i] = r if results[i] is None else results[i] + r
        finally:
            batches.close()
        return results


class LocalValidator(Evaluator):
    """Name parity: optim/LocalValidator.scala (the same engine)."""
