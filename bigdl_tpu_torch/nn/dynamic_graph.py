"""Data-dependent control flow in a graph (counterpart of
``bigdl_tpu/nn/dynamic_graph.py``: the reference's ``nn/DynamicGraph.scala``
and the ``Switch`` / ``Merge`` of ``nn/ops/ControlOps.scala``).

``StaticGraph`` and ``Model`` are ``Graph``. ``DynamicGraph`` runs eagerly
and skips every node whose direct input is the untaken side of a
``Switch`` (``NOT_TAKEN``); ``Merge`` fires on its one taken input. The
predicate is read on the host, as in the JAX package (one device-to-host
copy a ``Switch``). Cyclic control flow (TF while-loop frames) is not
reproduced, as in JAX.
"""
from __future__ import annotations

from ..utils.table import Table
from .graph_container import Graph
from .module import Module

__all__ = ["StaticGraph", "Model", "DynamicGraph", "Switch", "Merge",
           "NOT_TAKEN"]

StaticGraph = Graph     # nn/StaticGraph.scala: Graph is the static graph
Model = Graph           # the pyspark ``Model(inputs, outputs)`` graph API


class _NotTaken:
    """Sentinel flowing out of the untaken side of a Switch."""

    __slots__ = ()

    def __repr__(self):
        return "<not-taken>"

    def __reduce__(self):           # copies keep the one sentinel
        return "NOT_TAKEN"


NOT_TAKEN = _NotTaken()


def _contains_sentinel(v):
    if v is NOT_TAKEN:
        return True
    if isinstance(v, Table):
        return any(_contains_sentinel(e) for e in v.to_list())
    if isinstance(v, (list, tuple)):
        return any(_contains_sentinel(e) for e in v)
    return False


class Switch(Module):
    """SwitchOps: input ``Table(data, pred)`` -> ``Table(out_on_false,
    out_on_true)``, the untaken slot ``NOT_TAKEN``. The predicate is read
    on the host (``bool`` of a one-element tensor or array)."""

    def call(self, params, x):
        data, pred = x[1], x[2]
        taken = bool(pred.item() if hasattr(pred, "item") else pred)
        return Table(NOT_TAKEN if taken else data,
                     data if taken else NOT_TAKEN)


class Merge(Module):
    """MergeOps: forwards its one available (not ``NOT_TAKEN``) input;
    raises if none or more than one is available."""

    def call(self, params, x):
        items = x.to_list() if isinstance(x, Table) else [x]
        avail = [v for v in items if not _contains_sentinel(v)]
        if len(avail) != 1:
            raise ValueError(f"Merge expects exactly one taken branch, got "
                             f"{len(avail)}")
        return avail[0]


class DynamicGraph(Graph):
    """Eager Graph: the construction API of Graph / StaticGraph, but a
    node whose direct inputs include ``NOT_TAKEN`` is skipped and passes
    the sentinel on (a Merge fires on its one taken input). A Table that
    merely holds a sentinel slot (a Switch's output) is a live value:
    ``SelectTable`` picks a slot out of it."""

    jittable = False

    def _shortcut(self, mod, ins):
        if not isinstance(mod, Merge) and any(v is NOT_TAKEN for v in ins):
            return NOT_TAKEN
        return Graph._EXECUTE

    def _check_output(self, out):
        if _contains_sentinel(out):
            raise ValueError("graph output is on an untaken branch")
        return out
