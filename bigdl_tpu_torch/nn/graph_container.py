"""DAG graph container (counterpart of ``bigdl_tpu/nn/graph_container.py``,
the reference's ``nn/Graph.scala``, ``nn/StaticGraph.scala`` and
``nn/Input.scala``).

Nodes are made by calling modules on other nodes; ``Graph(inputs,
outputs)`` freezes the DAG, sorts it once at construction and runs it as
straight-line code. Its modules are the container's children in that
order, so each one's params and state sit under ``str(mod_idx)`` as in the
JAX package. The generator given to the graph's ``apply`` is passed to
every node (JAX folds the node index into its key, which has no bitwise
counterpart in torch).
"""
from __future__ import annotations

from typing import List, Sequence, Union

from ..utils.table import Table
from .module import Container, Node

__all__ = ["Input", "Graph"]


def Input(name=None) -> Node:
    """A graph input placeholder node (nn/Input.scala)."""
    return Node(None, [], name=name or "input")


class Graph(Container):
    """A module over a DAG of nodes: ``Graph(input_node(s),
    output_node(s))``; several inputs take a Table (or list) of values in
    order, several outputs give a Table."""

    def __init__(self, inputs: Union[Node, Sequence[Node]],
                 outputs: Union[Node, Sequence[Node]], name=None):
        super().__init__(name=name)
        self.input_nodes: List[Node] = ([inputs] if isinstance(inputs, Node)
                                        else list(inputs))
        self.output_nodes: List[Node] = ([outputs]
                                         if isinstance(outputs, Node)
                                         else list(outputs))
        self.topo: List[Node] = self._topo_sort()
        # the module index is stored on the node (copies keep it)
        for n in self.topo:
            if n.module is not None:
                n.mod_idx = len(self._modules)
                self.add(n.module)

    def _topo_sort(self) -> List[Node]:
        order, seen, visiting = [], set(), set()

        def visit(n: Node):
            if id(n) in seen:
                return
            if id(n) in visiting:
                raise ValueError("Graph has a cycle")
            visiting.add(id(n))
            for p in n.prevs:
                visit(p)
            visiting.discard(id(n))
            seen.add(id(n))
            order.append(n)

        for out in self.output_nodes:
            visit(out)
        for inp in self.input_nodes:
            if id(inp) not in seen:
                raise ValueError(f"input node {inp} not connected to "
                                 f"outputs")
        return order

    # sentinel: "no shortcut, execute the node normally" (see _shortcut)
    _EXECUTE = object()

    def _shortcut(self, mod, ins):
        """Hook for subclasses (DynamicGraph): a value to use INSTEAD of
        running ``mod`` on ``ins``, or ``Graph._EXECUTE`` to run it."""
        return Graph._EXECUTE

    def _check_output(self, out):
        """Hook: validate a graph output value before returning it."""
        return out

    def apply(self, params, state, x, training: bool = False,
              generator=None):
        values = {}
        if len(self.input_nodes) == 1:
            values[id(self.input_nodes[0])] = x
        else:
            items = x.to_list() if isinstance(x, Table) else list(x)
            if len(items) != len(self.input_nodes):
                raise ValueError(f"graph expects {len(self.input_nodes)} "
                                 f"inputs, got {len(items)}")
            for node, item in zip(self.input_nodes, items):
                values[id(node)] = item
        new_state = dict(state)
        for n in self.topo:
            if n.module is None:
                if id(n) not in values:
                    raise ValueError(f"unbound input node {n}")
                continue
            ins = [values[id(p)] for p in n.prevs]
            arg = ins[0] if len(ins) == 1 else Table(*ins)
            mi = n.mod_idx
            short = self._shortcut(self[mi], ins)
            if short is not Graph._EXECUTE:
                values[id(n)] = short
                continue
            values[id(n)], new_state[str(mi)] = self.child_apply(
                mi, params, state, arg, training, generator)
        outs = [self._check_output(values[id(o)]) for o in self.output_nodes]
        return (outs[0] if len(outs) == 1 else Table(*outs)), new_state

    def node(self, name):
        for n in self.topo:
            if n.name == name:
                return n
        return None
