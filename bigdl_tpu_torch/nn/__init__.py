from . import (activation, containers, conv, criterion, detection, dropout,
               dynamic_graph, elementwise, graph_container, init, linear, moe,
               norm, pool, recurrent, shape_ops, sparse, table_ops, tree_lstm)
from .activation import *  # noqa: F401,F403
from .attention import (Attention, FeedForwardNetwork, Transformer,
                        TransformerBlock, causal_mask, dot_product_attention,
                        embed_ids, padding_mask, position_encoding,
                        rotary_embedding)
from .containers import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .criterion import *  # noqa: F401,F403
from .detection import *  # noqa: F401,F403
from .dropout import *  # noqa: F401,F403
from .dynamic_graph import *  # noqa: F401,F403
from .elementwise import *  # noqa: F401,F403
from .graph_container import *  # noqa: F401,F403
from .init import *  # noqa: F401,F403
from .linear import *  # noqa: F401,F403
from .module import Container, Criterion, Module, Node
from .module import Module as Layer
from ..parallel.flash import flash_attention
from .moe import MixtureOfExperts
from .norm import *  # noqa: F401,F403
from .pool import *  # noqa: F401,F403
from .recurrent import *  # noqa: F401,F403
from .shape_ops import *  # noqa: F401,F403
from .sparse import *  # noqa: F401,F403
from .speculative import SpecStats, speculative_generate
from .table_ops import *  # noqa: F401,F403
from .tree_lstm import *  # noqa: F401,F403

__all__ = (["Attention", "FeedForwardNetwork", "Transformer",
            "TransformerBlock", "causal_mask", "dot_product_attention",
            "embed_ids", "padding_mask", "position_encoding",
            "rotary_embedding", "Container", "Criterion", "Module", "Node",
            "MixtureOfExperts", "SpecStats", "speculative_generate", "Layer",
            "flash_attention"]
           + activation.__all__ + containers.__all__ + conv.__all__
           + criterion.__all__ + detection.__all__ + dropout.__all__
           + dynamic_graph.__all__ + elementwise.__all__
           + graph_container.__all__ + init.__all__ + linear.__all__
           + norm.__all__ + pool.__all__ + recurrent.__all__
           + shape_ops.__all__ + sparse.__all__ + table_ops.__all__
           + tree_lstm.__all__)
