"""Data sets (counterpart of ``bigdl_tpu/dataset/dataset.py``): the local
sample store with the JAX package's per-epoch shuffle, and the batch-level
view the optimizer reads (one shard: multi-GPU comes later)."""
from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np

from ..utils.engine import refuse_unported
from .sample import Sample
from .transformer import SampleToMiniBatch


class DataSet:
    """Factory namespace."""

    @staticmethod
    def array(data: Sequence):
        return LocalDataSet(list(data))

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


class ShardedDataSet(AbstractDataSet):
    """Batch-level view for the optimizer: MiniBatches of ``batch_size``
    from one shard (a single GPU: ``num_shards`` > 1 comes with multi-GPU
    training; padded batches are not ported). The last short batch is
    dropped unless ``drop_last`` is False."""

    def __init__(self, dataset: AbstractDataSet, batch_size: int,
                 num_shards: int = 1, drop_last: bool = True,
                 feature_padding=None, label_padding=None):
        refuse_unported("ShardedDataSet", num_shards=(num_shards, 1),
                        feature_padding=(feature_padding, None),
                        label_padding=(label_padding, None))
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_shards = num_shards
        self.to_batch = SampleToMiniBatch(batch_size, drop_last=drop_last)

    def size(self):
        return self.dataset.size()

    def batches_per_epoch(self):
        return self.dataset.size() // self.batch_size

    def shuffle(self):
        self.dataset.shuffle()
        return self

    def data(self, train: bool = True):
        return self.to_batch.apply(iter(self.dataset.data(train)))
