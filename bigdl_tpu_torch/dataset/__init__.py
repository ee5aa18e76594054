from .dataset import AbstractDataSet, DataSet, LocalDataSet, ShardedDataSet
from .minibatch import MiniBatch
from .sample import Sample
from .transformer import SampleToMiniBatch, Transformer

__all__ = ["AbstractDataSet", "DataSet", "LocalDataSet", "ShardedDataSet",
           "MiniBatch", "Sample", "SampleToMiniBatch", "Transformer"]
