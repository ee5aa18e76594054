"""Iterator stages (counterpart of ``bigdl_tpu/dataset/transformer.py``):
the base ``Transformer`` and the batching stage the optimizer reads."""
from __future__ import annotations

from typing import Iterable, Iterator

from ..utils.engine import refuse_unported


class Transformer:
    def apply(self, it: Iterator) -> Iterator:
        raise NotImplementedError

    def __call__(self, it: Iterable) -> Iterator:
        return self.apply(iter(it))


class SampleToMiniBatch(Transformer):
    """Group Samples into MiniBatches of ``batch_size``; the last, shorter
    one too unless ``drop_last``. ``partition_num`` is accepted and
    ignored, as in the JAX package; padded batches (the padding
    parameters) are not ported."""

    def __init__(self, batch_size: int, feature_padding_param=None,
                 label_padding_param=None, partition_num=None,
                 drop_last: bool = False):
        refuse_unported("SampleToMiniBatch",
                        feature_padding_param=(feature_padding_param, None),
                        label_padding_param=(label_padding_param, None))
        self.batch_size = batch_size
        self.drop_last = drop_last

    def apply(self, it):
        from .minibatch import MiniBatch
        buf = []
        for s in it:
            buf.append(s)
            if len(buf) == self.batch_size:
                yield MiniBatch.from_samples(buf)
                buf = []
        if buf and not self.drop_last:
            yield MiniBatch.from_samples(buf)
