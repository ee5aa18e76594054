"""ImageNet folder-of-images loader (counterpart of
``bigdl_tpu/dataset/imagenet.py``).

Parity: reference ``dataset/image/LocalImageFiles`` + the inception example's
sequence-file pipeline. Decodes JPEGs with the native libjpeg codec
(``native``), and with Pillow where it is installed (other formats too);
with no decoder, or no folder, it serves deterministic synthetic 224x224
data (the JAX package's) so the full training pipeline runs anywhere.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["scan_folder", "synthetic", "ImageNetDataSet"]

IMAGENET_MEAN = (0.485 * 255, 0.456 * 255, 0.406 * 255)
IMAGENET_STD = (0.229 * 255, 0.224 * 255, 0.225 * 255)


def _python_decoder():
    try:
        from PIL import Image  # noqa
    except ImportError:
        return None

    def dec(path):
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), np.uint8)
    return dec


def _decoder():
    """A path -> (H, W, 3) uint8 decoder: the native libjpeg codec first
    (PIL for what it cannot read), else PIL, else None."""
    from .. import native
    fallback = _python_decoder()  # PIL, for non-JPEG files
    if not native.jpeg_available():
        return fallback

    def dec(path):
        try:
            img = native.decode_jpeg(path)
        except ValueError:  # stray PNG/BMP etc.
            if fallback is None:
                raise
            return fallback(path)
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        return img
    return dec


def scan_folder(folder: str) -> Tuple[List[str], List[int], List[str]]:
    """folder/<class_name>/<image> layout → (paths, 1-based labels, classes)."""
    classes = sorted(d for d in os.listdir(folder)
                     if os.path.isdir(os.path.join(folder, d)))
    paths, labels = [], []
    for i, c in enumerate(classes):
        cdir = os.path.join(folder, c)
        for f in sorted(os.listdir(cdir)):
            if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")):
                paths.append(os.path.join(cdir, f))
                labels.append(i + 1)
    return paths, labels, classes


def synthetic(n: int = 64, size: int = 224, classes: int = 1000, seed: int = 0):
    rng = np.random.RandomState(seed)
    labels = rng.randint(1, classes + 1, size=n).astype(np.int64)
    imgs = rng.randint(0, 255, size=(n, size, size, 3)).astype(np.uint8)
    return imgs, labels


class ImageNetDataSet:
    """Streaming dataset over an ImageNet-style folder; decodes + augments
    lazily per epoch (host-side, overlapped with device compute by the
    batching loop)."""

    def __init__(self, folder: Optional[str], batch_size: int,
                 train: bool = True, crop_size: int = 224,
                 n_synthetic: int = 256, seed: int = 1):
        from ..transform import vision
        self.batch_size = batch_size
        self.crop = crop_size
        self.decode = _decoder()
        self._rng = np.random.RandomState(seed)
        if folder and os.path.isdir(folder) and self.decode:
            self.paths, self.labels, self.classes = scan_folder(folder)
            self.synthetic_imgs = None
        else:
            self.paths = None
            self.synthetic_imgs, self.labels = synthetic(n_synthetic,
                                                         crop_size)
            self.classes = sorted({int(l) for l in self.labels})
        if train:
            self.pipeline = (vision.RandomResizedCrop(crop_size) |
                             vision.RandomFlip(0.5) |
                             vision.ChannelNormalize(*IMAGENET_MEAN,
                                                     *IMAGENET_STD) |
                             vision.MatToTensor())
        else:
            self.pipeline = (vision.AspectScale(256) |
                             vision.CenterCrop(crop_size, crop_size) |
                             vision.ChannelNormalize(*IMAGENET_MEAN,
                                                     *IMAGENET_STD) |
                             vision.MatToTensor())

    def size(self):
        return len(self.labels)

    def shuffle(self):
        return self

    def batches_per_epoch(self):
        return self.size() // self.batch_size

    def _images(self, order):
        for i in order:
            if self.paths is not None:
                yield self.decode(self.paths[i]).astype(np.float32)
            else:
                yield self.synthetic_imgs[i].astype(np.float32)

    def data(self, train: bool = True):
        from .minibatch import MiniBatch
        order = self._rng.permutation(self.size()) if train \
            else np.arange(self.size())
        feats = self.pipeline(self._images(order))
        buf_x, buf_y = [], []
        for i, x in zip(order, feats):
            buf_x.append(x)
            buf_y.append(float(self.labels[i]))
            if len(buf_x) == self.batch_size:
                yield MiniBatch(np.stack(buf_x), np.asarray(buf_y,
                                                            np.float32))
                buf_x, buf_y = [], []
