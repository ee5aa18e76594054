"""CIFAR-10 loader (binary format) + synthetic fallback (counterpart of
``bigdl_tpu/dataset/cifar.py``).

Parity: reference ``models/vgg/Utils.scala`` (cifar-10 binary reader) /
``dataset/DataSet.scala`` image loaders.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["synthetic", "load", "normalize", "to_samples"]

TRAIN_MEAN = (125.3, 123.0, 113.9)
TRAIN_STD = (63.0, 62.1, 66.7)


def _read_bin(path):
    raw = np.fromfile(path, dtype=np.uint8)
    rec = raw.reshape(-1, 3073)
    labels = rec[:, 0].astype(np.int64)
    images = rec[:, 1:].reshape(-1, 3, 32, 32)
    return images, labels


def synthetic(n=512, seed=0):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n).astype(np.int64)
    images = rng.randint(0, 255, size=(n, 3, 32, 32)).astype(np.uint8)
    for i, l in enumerate(labels):
        images[i, l % 3, (l * 3) % 28:(l * 3) % 28 + 4, :] = 250
    return images, labels + 1


def load(folder=None, train=True, n_synthetic=512):
    """Return (images uint8 NCHW, labels int64 1-based)."""
    if folder and os.path.isdir(folder):
        if train:
            files = [os.path.join(folder, f"data_batch_{i}.bin")
                     for i in range(1, 6)]
        else:
            files = [os.path.join(folder, "test_batch.bin")]
        files = [f for f in files if os.path.exists(f)]
        if files:
            parts = [_read_bin(f) for f in files]
            images = np.concatenate([p[0] for p in parts])
            labels = np.concatenate([p[1] for p in parts])
            return images, labels + 1
    return synthetic(n_synthetic, seed=0 if train else 1)


def normalize(images):
    x = images.astype(np.float32)
    mean = np.asarray(TRAIN_MEAN, np.float32)[:, None, None]
    std = np.asarray(TRAIN_STD, np.float32)[:, None, None]
    return (x - mean) / std


def to_samples(images, labels):
    from .sample import Sample
    x = normalize(images)
    return [Sample(x[i], np.int64(labels[i])) for i in range(len(labels))]
