from .directed_graph import DirectedGraph, Edge
from .table import T, Table
from .directed_graph import Node as GraphNode
from .shape import Shape, SingleShape, MultiShape
from .misc import (File, ThreadPool, crc32, string_hash,
                   redirect_spark_info_logs, profile_trace,
                   device_memory_stats)

__all__ = ["DirectedGraph", "GraphNode", "Edge", "Table", "T", "Shape",
           "SingleShape", "MultiShape", "File", "ThreadPool", "crc32",
           "string_hash", "redirect_spark_info_logs", "profile_trace",
           "device_memory_stats"]
