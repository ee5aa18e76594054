from .directed_graph import DirectedGraph, Edge
from .directed_graph import Node as GraphNode

__all__ = ["DirectedGraph", "GraphNode", "Edge"]
