from .attention import (Attention, FeedForwardNetwork, Transformer,
                        TransformerBlock, causal_mask, dot_product_attention,
                        embed_ids, position_encoding, rotary_embedding)
from .criterion import (ClassNLLCriterion, CrossEntropyCriterion, LMCriterion,
                        TimeDistributedMaskCriterion)
from .module import Criterion, Module
from .norm import LayerNormalization

__all__ = ["Attention", "FeedForwardNetwork", "Transformer",
           "TransformerBlock", "causal_mask", "dot_product_attention",
           "embed_ids", "position_encoding", "rotary_embedding",
           "ClassNLLCriterion", "CrossEntropyCriterion", "LMCriterion",
           "TimeDistributedMaskCriterion", "Criterion", "Module",
           "LayerNormalization"]
