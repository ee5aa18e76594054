"""Iterator stages (counterpart of ``bigdl_tpu/dataset/transformer.py``):
composable transformers (``a | b``, or the reference's ``a.arrow(b)``),
the identity, a per-element function, and the batching stage the
optimizer reads."""
from __future__ import annotations

from typing import Iterable, Iterator


class Transformer:
    def apply(self, it: Iterator) -> Iterator:
        raise NotImplementedError

    def __call__(self, it: Iterable) -> Iterator:
        return self.apply(iter(it))

    def __or__(self, other: "Transformer") -> "ChainedTransformer":
        return ChainedTransformer(self, other)

    def arrow(self, other):
        """The reference's ``->`` composition: ``self | other``."""
        return self.__or__(other)


class ChainedTransformer(Transformer):
    def __init__(self, first: Transformer, second: Transformer):
        self.first, self.second = first, second

    def apply(self, it):
        return self.second.apply(self.first.apply(it))


class Identity(Transformer):
    def apply(self, it):
        return it


class FuncTransformer(Transformer):
    """A per-element function as a stage."""

    def __init__(self, fn):
        self.fn = fn

    def apply(self, it):
        return (self.fn(x) for x in it)


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


__all__ = ["Transformer", "ChainedTransformer", "Identity", "FuncTransformer",
           "SampleToMiniBatch"]
