from . import news20, sentence, text
from .dataset import AbstractDataSet, DataSet, LocalDataSet, ShardedDataSet
from .minibatch import MiniBatch, PaddingParam
from .sample import Sample
from .transformer import SampleToMiniBatch, Transformer

__all__ = ["AbstractDataSet", "DataSet", "LocalDataSet", "ShardedDataSet",
           "MiniBatch", "PaddingParam", "Sample", "SampleToMiniBatch",
           "Transformer"]
