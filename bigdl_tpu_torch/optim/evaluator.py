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
goes. The forwards run through ``observability.perf.instrument_jit``
(``eval/forward``, ``eval/forward_stats``; keyed on the batch), as JAX's
compile sites do."""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import observability as obs
from ..dataset.dataset import AbstractDataSet, ShardedDataSet
from ..utils.engine import resolve_device
from ..utils.table import Table
from .staging import _first_leaf, _index, _stack, place_host_value, staged

__all__ = ["Evaluator", "LocalValidator", "DistriValidator"]


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
        self._fwd = None
        self._fwd_stats = None

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
        if self._fwd is None:
            model = self.model

            def fwd(params, state, x):
                out, _ = model.apply(params, state, x, training=False)
                return out
            self._fwd = obs.perf.instrument_jit(
                fwd, name="eval/forward", kind="forward", key_argnums=(2,))
        return self._fwd(self.model.params, self.model.state, x)

    def _forward_stats(self, methods, x, y):
        """The forward and every method's device statistics, one call."""
        key = tuple(id(m) for m in methods)
        if self._fwd_stats is None or self._fwd_stats[0] != key:
            model = self.model

            def fwd_stats(params, state, x, y):
                out, _ = model.apply(params, state, x, training=False)
                return [m.device_stats(out, y) for m in methods]
            self._fwd_stats = (key, obs.perf.instrument_jit(
                fwd_stats, name="eval/forward_stats", kind="forward",
                key_argnums=(2, 3)))
        return self._fwd_stats[1](self.model.params, self.model.state, x, y)

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

        host = lambda mb: (self._rows(mb.get_input()),
                           self._rows(mb.get_target()))
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
                    if len(_first_leaf(xi)) == 0:
                        continue        # no rows of this batch here
                    stats = self._forward_stats(methods, xi, yi)
                    acc = stats if acc is None else \
                        [a + s for a, s in zip(acc, stats)]
        finally:
            batches.close()
        if acc is not None:
            # the one readback of the summed statistics
            acc = list(torch.cat(acc).cpu().split([a.numel() for a in acc]))
        acc = self._combine(acc)
        if acc is None:
            return [None] * len(methods)
        return [m.result_from_stats(s) for m, s in zip(methods, acc)]

    def _evaluate_host(self, batched, methods):
        """Per-batch numpy methods (a method without a device form)."""
        dev = _model_device(self.model)
        results = [None] * len(methods)
        batches = staged(batched.data(train=False),
                         lambda mb: (place_host_value(
                             self._rows(mb.get_input()), dev),
                             self._rows(mb.get_target())),
                         depth=self.prefetch_depth, name="eval_stager",
                         device=dev)
        try:
            for x, y in batches:
                if len(_first_leaf(x)) == 0:
                    continue
                out = self._forward(x)
                for i, m in enumerate(methods):
                    r = m(out, y)
                    results[i] = r if results[i] is None else results[i] + r
        finally:
            batches.close()
        if all(r is None for r in results):
            results = None
        results = self._combine(results)
        return [None] * len(methods) if results is None else results

    def _rows(self, v):
        """The rows of a batch this evaluator computes (all of them)."""
        return v

    def _combine(self, parts):
        """This process's per-method results -> the evaluation's (as
        they are)."""
        return parts


class LocalValidator(Evaluator):
    """Name parity: optim/LocalValidator.scala (the same engine)."""


class DistriValidator(Evaluator):
    """Validation sharded over the ``data`` axis of ``mesh`` (the default
    mesh when None; ``DistriOptimizer`` sets its own), as training
    batches are: every rank reads the same batches and computes its block
    of rows (contiguous, ``[r * b // n, (r + 1) * b // n)``, so a short
    last batch splits unevenly); each method's statistics (or host
    results) are then summed over the ranks in rank order, with ONE
    exchange an evaluation, and every rank returns the same results.
    Every rank of the mesh evaluates at the same point."""

    mesh = None

    def _mesh(self):
        from ..parallel.mesh import get_default_mesh
        return self.mesh if self.mesh is not None else get_default_mesh()

    def _rows(self, v):
        from ..parallel.mesh import axis_size
        mesh = self._mesh()
        n = axis_size(mesh, "data")
        if n == 1 or v is None:
            return v
        r = mesh.get_local_rank("data")
        if isinstance(v, Table):
            return Table(*(self._rows(i) for i in v))
        b = len(v)
        return v[r * b // n:(r + 1) * b // n]

    def _combine(self, parts):
        import torch.distributed as dist
        mesh = self._mesh()
        if mesh.size() == 1:
            return parts
        got = [None] * dist.get_world_size(mesh.get_group("data"))
        dist.all_gather_object(got, parts, group=mesh.get_group("data"))
        got = [g for g in got if g is not None]
        if not got:
            return None
        out = list(got[0])
        for g in got[1:]:
            out = [a if b is None else b if a is None else a + b
                   for a, b in zip(out, g)]
        return out
