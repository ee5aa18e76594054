"""Data sets (counterpart of ``bigdl_tpu/dataset/dataset.py``): the local
sample store with the JAX package's per-epoch shuffle, and the batch-level
view the optimizer reads (global batches that divide over the data shards)."""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np

from .sample import Sample
from .transformer import SampleToMiniBatch, Transformer

__all__ = ["DataSet", "AbstractDataSet", "LocalDataSet", "TransformedDataSet",
           "ShardedDataSet"]


class DataSet:
    """Factory namespace."""

    @staticmethod
    def array(data: Sequence, transformer: Optional[Transformer] = None):
        """A local data set over ``data``, seen through ``transformer``
        when one is given."""
        ds = LocalDataSet(list(data))
        return ds.transform(transformer) if transformer else ds

    @staticmethod
    def from_arrays(features: np.ndarray, labels: Optional[np.ndarray] = None):
        if labels is None:
            samples = [Sample(features[i]) for i in range(len(features))]
        else:
            samples = [Sample(features[i], labels[i])
                       for i in range(len(features))]
        return LocalDataSet(samples)


class AbstractDataSet:
    def size(self) -> int:
        raise NotImplementedError

    def shuffle(self):
        return self

    def data(self, train: bool) -> Iterable:
        raise NotImplementedError

    def transform(self, transformer: Transformer) -> "AbstractDataSet":
        """This data set seen through ``transformer``, lazily."""
        return TransformedDataSet(self, transformer)

    def arrow(self, transformer):
        """The reference's ``->``: :meth:`transform`."""
        return self.transform(transformer)


class LocalDataSet(AbstractDataSet):
    """In-memory samples whose training order is a pure function of
    ``(seed, epoch)``: ``shuffle()`` advances the epoch, and every
    ``data(train=True)`` in between yields the same permutation, drawn from
    ``np.random.RandomState([seed, epoch])`` exactly as the JAX package
    draws it, so both visit the samples in the same order.
    ``data(train=False)`` yields insertion order."""

    def __init__(self, data: List, seed: int = 1):
        self._data = list(data)
        self._seed = int(seed)
        self._epoch = 0
        self._order = None

    def size(self):
        return len(self._data)

    def shuffle(self):
        self._epoch += 1
        self._order = None
        return self

    def _train_order(self):
        if self._order is None or len(self._order) != len(self._data):
            rng = np.random.RandomState(
                [self._seed & 0x7FFFFFFF, self._epoch])
            self._order = rng.permutation(len(self._data))
        return self._order

    def data(self, train: bool = True):
        if train:
            return (self._data[i] for i in self._train_order())
        return iter(self._data)


class TransformedDataSet(AbstractDataSet):
    """``base`` with ``transformer`` applied to each pass over it: the
    base's size and shuffle, the transformer's elements."""

    def __init__(self, base: AbstractDataSet, transformer: Transformer):
        self.base, self.transformer = base, transformer

    def size(self):
        return self.base.size()

    def shuffle(self):
        self.base.shuffle()
        return self

    def data(self, train: bool = True):
        return self.transformer.apply(iter(self.base.data(train)))


class ShardedDataSet(AbstractDataSet):
    """Batch-level view for the optimizer: global MiniBatches of
    ``batch_size``, padded by the ``PaddingParam``s given, whose rows
    divide over ``num_shards`` data shards (``DistriOptimizer`` gives each
    rank its block of rows). The last short batch is dropped unless
    ``drop_last`` is False."""

    def __init__(self, dataset: AbstractDataSet, batch_size: int,
                 num_shards: int = 1, drop_last: bool = True,
                 feature_padding=None, label_padding=None):
        if batch_size % num_shards != 0:
            raise ValueError(
                f"global batch size {batch_size} must divide over "
                f"{num_shards} data shards")
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_shards = num_shards
        self.to_batch = SampleToMiniBatch(batch_size, feature_padding,
                                          label_padding, drop_last=drop_last)

    def size(self):
        return self.dataset.size()

    def batches_per_epoch(self):
        return self.dataset.size() // self.batch_size

    def shuffle(self):
        self.dataset.shuffle()
        return self

    def data(self, train: bool = True):
        return self.to_batch.apply(iter(self.dataset.data(train)))
