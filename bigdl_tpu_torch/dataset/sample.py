"""Sample: one training example (counterpart of
``bigdl_tpu/dataset/sample.py``): feature array(s) and label array(s), kept
on the host as numpy; batches move to the device whole, never sample by
sample."""
from __future__ import annotations

import numpy as np


class Sample:
    def __init__(self, features, labels=None):
        self.features = features if isinstance(features, (list, tuple)) \
            else [np.asarray(features)]
        self.features = [np.asarray(f) for f in self.features]
        if labels is None:
            self.labels = []
        else:
            labels = labels if isinstance(labels, (list, tuple)) else [labels]
            self.labels = [np.asarray(l) for l in labels]

    def feature(self, i=0):
        return self.features[i]

    def label(self, i=0):
        return self.labels[i] if self.labels else None

    @staticmethod
    def from_ndarray(features, labels=None):
        return Sample(features, labels)

    def __repr__(self):
        fs = [f.shape for f in self.features]
        ls = [l.shape for l in self.labels]
        return f"Sample(features={fs}, labels={ls})"
