"""MiniBatch: a batch of one input and one target, stacked numpy arrays on
the host (counterpart of ``bigdl_tpu/dataset/minibatch.py``; samples with
several features or labels, which the JAX package batches into a
``Table``, are not ported yet)."""
from __future__ import annotations

import numpy as np

from ..utils.engine import refuse_unported


class MiniBatch:
    def __init__(self, input, target=None):
        self.input = input
        self.target = target

    @staticmethod
    def from_samples(samples, feature_padding=None, label_padding=None):
        """Stack samples of one shape (padding variable-length samples is
        not ported yet)."""
        refuse_unported("MiniBatch.from_samples",
                        feature_padding=(feature_padding, None),
                        label_padding=(label_padding, None))
        if len(samples[0].features) != 1 or len(samples[0].labels) > 1:
            raise NotImplementedError(
                "MiniBatch: only samples of one feature and at most one "
                "label are ported (Table batches are not)")
        inp = np.stack([s.features[0] for s in samples])
        tgt = None
        if samples[0].labels:
            tgt = np.stack([s.labels[0] for s in samples])
        return MiniBatch(inp, tgt)

    def get_input(self):
        return self.input

    def get_target(self):
        return self.target

    def size(self):
        return self.input.shape[0]

    def slice(self, offset: int, length: int):
        """Rows offset .. offset + length - 1, 1-based as in the
        reference."""
        s = slice(offset - 1, offset - 1 + length)
        return MiniBatch(self.input[s],
                         None if self.target is None else self.target[s])

    def __repr__(self):
        tgt = None if self.target is None else self.target.shape
        return f"MiniBatch(input={self.input.shape}, target={tgt})"
