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
    one is dropped, as the training loop needs whole batches."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size

    def apply(self, it):
        from .minibatch import MiniBatch
        buf = []
        for s in it:
            buf.append(s)
            if len(buf) == self.batch_size:
                yield MiniBatch.from_samples(buf)
                buf = []
