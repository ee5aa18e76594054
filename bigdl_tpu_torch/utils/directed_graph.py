"""Directed graph utility (counterpart of
``bigdl_tpu/utils/directed_graph.py``, the reference's
``utils/DirectedGraph.scala`` with ``Node`` and ``Edge``): a generic DAG
with topological sort, BFS, DFS and the reversed walk. Host Python, the
port's own copy; the nn ``Graph`` container keeps its own lean node type
(``nn.module.Node``).
"""
from __future__ import annotations

from collections import deque
from typing import Any, List, Optional

__all__ = ["Edge", "Node", "DirectedGraph"]


class Edge:
    def __init__(self, from_index: Optional[int] = None):
        self.from_index = from_index

    def __repr__(self):
        return f"Edge({self.from_index})"


class Node:
    def __init__(self, element: Any):
        self.element = element
        self.nexts: List[tuple] = []  # (node, edge)
        self.prevs: List[tuple] = []

    def add(self, node: "Node", edge: Optional[Edge] = None):
        e = edge or Edge()
        self.nexts.append((node, e))
        node.prevs.append((self, e))
        return node

    def delete(self, node: "Node"):
        self.nexts = [(n, e) for n, e in self.nexts if n is not node]
        node.prevs = [(n, e) for n, e in node.prevs if n is not self]
        return self

    def remove_prev_edges(self):
        for p, e in list(self.prevs):
            p.nexts = [(n, ee) for n, ee in p.nexts if n is not self]
        self.prevs = []
        return self

    def __repr__(self):
        return f"Node({self.element})"


class DirectedGraph:
    def __init__(self, source: Node, reverse: bool = False):
        self.source = source
        self.reverse = reverse

    def _neighbors(self, node: Node):
        pairs = node.prevs if self.reverse else node.nexts
        return [n for n, _ in pairs]

    def bfs(self):
        seen = {id(self.source)}
        q = deque([self.source])
        while q:
            n = q.popleft()
            yield n
            for nb in self._neighbors(n):
                if id(nb) not in seen:
                    seen.add(id(nb))
                    q.append(nb)

    def dfs(self):
        seen = set()
        stack = [self.source]
        while stack:
            n = stack.pop()
            if id(n) in seen:
                continue
            seen.add(id(n))
            yield n
            for nb in reversed(self._neighbors(n)):
                if id(nb) not in seen:
                    stack.append(nb)

    def topology_sort(self) -> List[Node]:
        # iterative post-order DFS: no recursion limit on deep chains
        order, temp, perm = [], set(), set()
        stack = [(self.source, False)]
        while stack:
            n, children_done = stack.pop()
            if id(n) in perm:
                continue
            if children_done:
                temp.discard(id(n))
                perm.add(id(n))
                order.append(n)
                continue
            if id(n) in temp:
                raise ValueError("graph contains a cycle")
            temp.add(id(n))
            stack.append((n, True))
            for nb in reversed(self._neighbors(n)):
                if id(nb) in temp and id(nb) not in perm:
                    raise ValueError("graph contains a cycle")
                if id(nb) not in perm:
                    stack.append((nb, False))
        return list(reversed(order))

    def size(self):
        return sum(1 for _ in self.bfs())

    def edges(self):
        return sum(len(self._neighbors(n)) for n in self.bfs())
