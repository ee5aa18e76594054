"""Iterator stages (counterpart of ``bigdl_tpu/dataset/transformer.py``):
the base ``Transformer`` and the batching stage the optimizer reads."""
from __future__ import annotations

from typing import Iterable, Iterator


class Transformer:
    def apply(self, it: Iterator) -> Iterator:
        raise NotImplementedError

    def __call__(self, it: Iterable) -> Iterator:
        return self.apply(iter(it))


class SampleToMiniBatch(Transformer):
    """Group Samples into MiniBatches of ``batch_size``; the last, shorter
    one too unless ``drop_last``. Features and labels are padded by the
    ``PaddingParam``s given (``MiniBatch.from_samples``).
    ``partition_num`` is accepted and ignored, as in the JAX package."""

    def __init__(self, batch_size: int, feature_padding_param=None,
                 label_padding_param=None, partition_num=None,
                 drop_last: bool = False):
        self.batch_size = batch_size
        self.feature_padding = feature_padding_param
        self.label_padding = label_padding_param
        self.drop_last = drop_last

    def apply(self, it):
        from .minibatch import MiniBatch
        buf = []
        for s in it:
            buf.append(s)
            if len(buf) == self.batch_size:
                yield MiniBatch.from_samples(buf, self.feature_padding,
                                             self.label_padding)
                buf = []
        if buf and not self.drop_last:
            yield MiniBatch.from_samples(buf, self.feature_padding,
                                         self.label_padding)
