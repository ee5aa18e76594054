from .directed_graph import DirectedGraph, Edge
from .table import T, Table
from .directed_graph import Node as GraphNode

__all__ = ["DirectedGraph", "GraphNode", "Edge", "Table", "T"]
