from . import (base, cifar, datamining, imagenet, mnist, movielens, news20,
               segmentation, sentence, text, tfrecord)
from .datamining import (ColsToNumeric, ColToTensor, RowTransformer,
                         RowTransformSchema)
from .dataset import (AbstractDataSet, DataSet, LocalDataSet, ShardedDataSet,
                      TransformedDataSet)
from .minibatch import MiniBatch, PaddingParam
from .sample import Sample
from .segmentation import PolyMasks, RLEMasks
from .tfrecord import (load_tfrecord_dataset, make_example, parse_example,
                       read_tfrecords, write_tfrecords)
from .transformer import Identity as IdentityTransformer
from .transformer import (ChainedTransformer, FuncTransformer, Identity,
                          SampleToMiniBatch, Transformer)

__all__ = ["AbstractDataSet", "DataSet", "LocalDataSet", "ShardedDataSet",
           "MiniBatch", "PaddingParam", "Sample", "SampleToMiniBatch",
           "Transformer", "TransformedDataSet", "ChainedTransformer",
           "FuncTransformer", "Identity", "IdentityTransformer", "read_tfrecords",
           "write_tfrecords", "parse_example", "make_example",
           "load_tfrecord_dataset", "RowTransformer", "RowTransformSchema",
           "ColToTensor", "ColsToNumeric", "RLEMasks", "PolyMasks"]
