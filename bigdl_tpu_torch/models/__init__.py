from .resnet import FusedBottleneck, FusedBottleneckChain, ResNet, ResNet50
from .transformer_lm import TransformerLM, lm_loss_chunked

__all__ = ["FusedBottleneck", "FusedBottleneckChain", "ResNet", "ResNet50",
           "TransformerLM", "lm_loss_chunked"]
