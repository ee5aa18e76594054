from . import news20, sentence, text
from .dataset import (AbstractDataSet, DataSet, LocalDataSet, ShardedDataSet,
                      TransformedDataSet)
from .minibatch import MiniBatch, PaddingParam
from .sample import Sample
from .transformer import (ChainedTransformer, FuncTransformer, Identity,
                          SampleToMiniBatch, Transformer)

__all__ = ["AbstractDataSet", "DataSet", "LocalDataSet", "ShardedDataSet",
           "MiniBatch", "PaddingParam", "Sample", "SampleToMiniBatch",
           "Transformer", "TransformedDataSet", "ChainedTransformer",
           "FuncTransformer", "Identity"]
