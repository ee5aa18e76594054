from .activation import ReLU
from .attention import (Attention, FeedForwardNetwork, Transformer,
                        TransformerBlock, causal_mask, dot_product_attention,
                        embed_ids, position_encoding, rotary_embedding)
from .containers import Sequential
from .conv import SpatialConvolution
from .criterion import (ClassNLLCriterion, CrossEntropyCriterion, LMCriterion,
                        TimeDistributedMaskCriterion)
from .linear import Linear
from .module import Container, Criterion, Module
from .norm import (BatchNormalization, LayerNormalization,
                   SpatialBatchNormalization)
from .pool import SpatialAveragePooling, SpatialMaxPooling
from .shape_ops import View

__all__ = ["ReLU", "Attention", "FeedForwardNetwork", "Transformer",
           "TransformerBlock", "causal_mask", "dot_product_attention",
           "embed_ids", "position_encoding", "rotary_embedding", "Sequential",
           "SpatialConvolution", "ClassNLLCriterion", "CrossEntropyCriterion",
           "LMCriterion", "TimeDistributedMaskCriterion", "Linear",
           "Container", "Criterion", "Module", "BatchNormalization",
           "LayerNormalization", "SpatialBatchNormalization",
           "SpatialAveragePooling", "SpatialMaxPooling", "View"]
