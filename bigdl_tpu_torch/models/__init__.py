from .autoencoder import Autoencoder
from .inception import (Inception_v1, Inception_v1_NoAuxClassifier,
                        Inception_v2, Inception_v2_NoAuxClassifier,
                        inception_block, inception_layer_v2)
from .lenet import LeNet5
from .moe_lm import MoETransformerLM
from .recommender import NeuralCF, WideAndDeep
from .resnet import (FusedBottleneck, FusedBottleneckChain, ResNet,
                     ResNet50, ResNetCifar)
from .rnn import PTBModel, SimpleRNN
from .textclassifier import TextClassifier, tokenize_to_glove_sequences
from .transformer_lm import TransformerLM, lm_loss_chunked
from .vgg import Vgg_16, Vgg_19, VggForCifar10

__all__ = ["Autoencoder", "Inception_v1", "Inception_v1_NoAuxClassifier",
           "Inception_v2", "Inception_v2_NoAuxClassifier", "inception_block",
           "inception_layer_v2", "LeNet5", "MoETransformerLM", "NeuralCF",
           "WideAndDeep", "FusedBottleneck",
           "FusedBottleneckChain", "ResNet", "ResNet50", "ResNetCifar",
           "PTBModel", "SimpleRNN", "TextClassifier",
           "tokenize_to_glove_sequences", "TransformerLM", "lm_loss_chunked",
           "Vgg_16", "Vgg_19", "VggForCifar10"]
