"""MNIST loader (counterpart of ``bigdl_tpu/dataset/mnist.py``).

Parity: reference ``dataset/image/...`` + ``pyspark/bigdl/dataset/mnist.py``
(idx-format parser). If the idx files are not on disk, ``load`` generates
a deterministic synthetic stand-in with the same shapes/dtypes (the JAX
package's, bit for bit) so pipelines and tests run anywhere.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

__all__ = ["synthetic", "load", "normalize", "to_samples"]

TRAIN_MEAN = 0.13066047740239506 * 255
TRAIN_STD = 0.3081078 * 255
TEST_MEAN = 0.13251460696903547 * 255
TEST_STD = 0.31048024 * 255


def _read_idx(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
        data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.reshape(dims)


def _find(folder, names):
    for n in names:
        for suffix in ("", ".gz"):
            p = os.path.join(folder, n + suffix)
            if os.path.exists(p):
                return p
    return None


def synthetic(n=1024, seed=0):
    """Deterministic synthetic MNIST-shaped data (28x28 uint8, labels 0-9).
    Digits are separable blobs so small models actually learn."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n).astype(np.int64)
    images = np.zeros((n, 28, 28), dtype=np.uint8)
    for i, l in enumerate(labels):
        # place a class-dependent bright square; add noise
        r, c = 2 + (l // 5) * 12, 2 + (l % 5) * 5
        img = rng.randint(0, 40, size=(28, 28))
        img[r:r + 9, c:c + 4] = 220 + (l * 3) % 35
        images[i] = img.astype(np.uint8)
    return images, labels + 1  # 1-based labels (reference convention)


def load(folder=None, train=True, n_synthetic=1024):
    """Return (images uint8 (N,28,28), labels int64 1-based)."""
    if folder:
        img_name = ("train-images-idx3-ubyte" if train
                    else "t10k-images-idx3-ubyte")
        lab_name = ("train-labels-idx1-ubyte" if train
                    else "t10k-labels-idx1-ubyte")
        ip, lp = _find(folder, [img_name]), _find(folder, [lab_name])
        if ip and lp:
            return _read_idx(ip), _read_idx(lp).astype(np.int64) + 1
    return synthetic(n_synthetic, seed=0 if train else 1)


def normalize(images, train=True):
    mean = TRAIN_MEAN if train else TEST_MEAN
    std = TRAIN_STD if train else TEST_STD
    return ((images.astype(np.float32) - mean) / std)


def to_samples(images, labels, train=True):
    from .sample import Sample
    x = normalize(images, train)[:, None, :, :]  # NCHW
    return [Sample(x[i], np.int64(labels[i])) for i in range(len(labels))]
