from .attention import (Attention, FeedForwardNetwork, Transformer,
                        TransformerBlock, causal_mask, dot_product_attention,
                        embed_ids, position_encoding, rotary_embedding)
from .module import Module
from .norm import LayerNormalization

__all__ = ["Attention", "FeedForwardNetwork", "Transformer",
           "TransformerBlock", "causal_mask", "dot_product_attention",
           "embed_ids", "position_encoding", "rotary_embedding", "Module",
           "LayerNormalization"]
