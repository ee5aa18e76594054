"""MiniBatch: a batch of inputs and targets, stacked numpy arrays on the
host (counterpart of ``bigdl_tpu/dataset/minibatch.py``, parity with the
reference's ``dataset/MiniBatch.scala`` and ``PaddingParam``). Samples
with several features (or labels) batch into a ``Table`` of arrays, one a
feature; variable-length samples are padded to the batch's longest (or a
fixed length)."""
from __future__ import annotations

import numpy as np

from ..utils.table import Table


class PaddingParam:
    """Padding spec for variable-length samples (dataset/MiniBatch.scala:260).
    ``padding_value`` fills; ``fixed_length`` pads to at least that length
    (one value, or a list with one a dimension; -1 or None = pad to the
    batch's longest)."""

    def __init__(self, padding_value=0.0, fixed_length=None):
        self.padding_value = padding_value
        self.fixed_length = fixed_length


def _pad_stack(arrays, padding: PaddingParam):
    """Stack equal shapes as they are; otherwise (or with ``padding``)
    into a batch of each dimension's longest (or ``fixed_length``),
    filled with ``padding_value`` (0 without ``padding``), in the first
    array's dtype."""
    shapes = [a.shape for a in arrays]
    if all(s == shapes[0] for s in shapes) and padding is None:
        return np.stack(arrays)
    ndim = arrays[0].ndim
    target = []
    for d in range(ndim):
        mx = max(s[d] for s in shapes)
        if padding is not None and padding.fixed_length is not None:
            fl = padding.fixed_length
            fl = fl[d] if isinstance(fl, (list, tuple)) else fl
            if fl and fl > 0:
                mx = max(mx, fl)
        target.append(mx)
    val = padding.padding_value if padding is not None else 0.0
    out = np.full((len(arrays),) + tuple(target), val, dtype=arrays[0].dtype)
    for i, a in enumerate(arrays):
        sl = (i,) + tuple(slice(0, s) for s in a.shape)
        out[sl] = a
    return out


class MiniBatch:
    def __init__(self, input, target=None):
        self.input = input
        self.target = target

    @staticmethod
    def from_samples(samples, feature_padding=None, label_padding=None):
        """Stack each feature (and label) across ``samples``: one array,
        or a ``Table`` of arrays for several; padded by
        :func:`_pad_stack`."""
        nfeat = len(samples[0].features)
        feats = [_pad_stack([s.features[i] for s in samples], feature_padding)
                 for i in range(nfeat)]
        inp = feats[0] if nfeat == 1 else Table(*feats)
        tgt = None
        if samples[0].labels:
            nlab = len(samples[0].labels)
            labs = [_pad_stack([s.labels[i] for s in samples], label_padding)
                    for i in range(nlab)]
            tgt = labs[0] if nlab == 1 else Table(*labs)
        return MiniBatch(inp, tgt)

    def get_input(self):
        return self.input

    def get_target(self):
        return self.target

    def size(self):
        first = self.input[1] if isinstance(self.input, Table) else self.input
        return first.shape[0]

    def slice(self, offset: int, length: int):
        """Rows offset .. offset + length - 1 of every array, 1-based as in
        the reference."""
        s = slice(offset - 1, offset - 1 + length)

        def cut(x):
            if isinstance(x, Table):
                return Table(*[cut(i) for i in x])
            return None if x is None else x[s]
        return MiniBatch(cut(self.input), cut(self.target))

    def __repr__(self):
        shp = lambda x: [i.shape for i in x] if isinstance(x, Table) else \
            (None if x is None else x.shape)
        return f"MiniBatch(input={shp(self.input)}, target={shp(self.target)})"
