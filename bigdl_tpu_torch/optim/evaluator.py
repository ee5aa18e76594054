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
methods. Batches are placed inline (the JAX package's stager thread is
A.4's, with ``set_superstep``)."""
from __future__ import annotations

from typing import List

import torch

from ..dataset.dataset import AbstractDataSet, ShardedDataSet
from ..utils.engine import refuse_unported, resolve_device
from .staging import place_host_value

__all__ = ["Evaluator", "LocalValidator"]


def _model_device(model):
    for t in model.parameters():
        return t.device
    for t in model.buffers():
        return t.device
    return resolve_device(None)


class Evaluator:
    """Evaluates ``model`` where its parameters live. ``prefetch_depth``
    (the JAX package's stager lookahead) is not ported and must stay 2."""

    def __init__(self, model, prefetch_depth: int = 2):
        refuse_unported("Evaluator", prefetch_depth=(prefetch_depth, 2))
        self.model = model
        self.prefetch_depth = prefetch_depth

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
        acc = None
        for mb in batched.data(train=False):
            out = self._forward(place_host_value(mb.get_input(), dev))
            y = place_host_value(mb.get_target(), dev)
            stats = [m.device_stats(out, y) for m in methods]
            acc = stats if acc is None else [a + s
                                             for a, s in zip(acc, stats)]
        if acc is None:
            return [None] * len(methods)
        # the one readback of the summed statistics
        host = torch.cat(acc).cpu().split([a.numel() for a in acc])
        return [m.result_from_stats(s) for m, s in zip(methods, host)]

    def _evaluate_host(self, batched, methods):
        """Per-batch numpy methods (a method without a device form)."""
        dev = _model_device(self.model)
        results = [None] * len(methods)
        for mb in batched.data(train=False):
            out = self._forward(place_host_value(mb.get_input(), dev))
            for i, m in enumerate(methods):
                r = m(out, mb.get_target())
                results[i] = r if results[i] is None else results[i] + r
        return results


class LocalValidator(Evaluator):
    """Name parity: optim/LocalValidator.scala (the same engine)."""
