"""ImageFrame: the vision-frame carrier the reference's detection examples
pipeline through (counterpart of ``bigdl_tpu/transform/image_frame.py``).

Parity: ``transform/vision/image/ImageFrame.scala`` (LocalImageFrame — an
array of ImageFeatures with ``transform``/``read`` — the DistributedImageFrame
RDD variant is Spark-only and designed out) and
``MTImageFeatureToBatch.scala`` (ImageFeature iterator -> fixed-size
MiniBatch; the reference's "MT" multi-thread pooling is the native
prefetcher's here — see ``native/`` — so the class keeps the name for API
parity but is a plain batcher of host arrays into the port's
``MiniBatch``).

ImageFeature keys follow ``ImageFeature.scala``: ``uri``, ``bytes``,
``image`` (decoded HWC float, the ``floats``/``mat`` analog), ``label``,
``boundingBox``, ``predict``, ``originalSize``.
"""
from __future__ import annotations

import os
from typing import Iterable, List, Optional, Sequence

import numpy as np

from ._vision_impl import FeatureTransformer, ImageFeature, MatToTensor
from ..dataset.minibatch import MiniBatch

__all__ = ["ImageFrame", "LocalImageFrame", "MTImageFeatureToBatch"]


class ImageFrame:
    """Factory namespace (ImageFrame.scala object): ``ImageFrame.read`` /
    ``ImageFrame.array`` produce a :class:`LocalImageFrame`."""

    @staticmethod
    def array(images: Sequence, labels: Optional[Sequence] = None
              ) -> "LocalImageFrame":
        """Build from decoded arrays (HWC) or ready ImageFeatures."""
        feats = []
        for i, im in enumerate(images):
            if isinstance(im, ImageFeature):
                f = im
            else:
                f = ImageFeature(image=np.asarray(im, np.float32))
            if labels is not None:
                f["label"] = labels[i]
            f.setdefault("originalSize",
                         tuple(np.asarray(f["image"]).shape)
                         if "image" in f else None)
            feats.append(f)
        return LocalImageFrame(feats)

    @staticmethod
    def read(path: str, with_label: bool = False) -> "LocalImageFrame":
        """Read a file / folder of JPEGs (ImageFrame.read local mode).
        ``with_label=True`` treats immediate subfolders as class labels
        (1-based, sorted — the ImageNet folder convention). Decoding uses
        the native libjpeg path, and PIL where it is installed
        (dataset/imagenet.py's decoder)."""
        from ..dataset.imagenet import _decoder, scan_folder
        decode = _decoder()
        feats = []
        if os.path.isfile(path):
            entries = [(path, None)]
        elif with_label:
            # folder/<class>/<image> layout: one listing implementation
            # (dataset/imagenet.py) owns the extension set and ordering
            paths, labels, _ = scan_folder(path)
            entries = list(zip(paths, labels))
        else:
            entries = [(os.path.join(path, f), None)
                       for f in sorted(os.listdir(path))
                       if f.lower().endswith((".jpg", ".jpeg", ".png",
                                              ".bmp"))]
        for p, label in entries:
            img = decode(p)
            f = ImageFeature(image=np.asarray(img, np.float32), uri=p,
                             originalSize=tuple(np.asarray(img).shape))
            if label is not None:
                f["label"] = label
            feats.append(f)
        return LocalImageFrame(feats)


class LocalImageFrame:
    """An in-memory sequence of ImageFeatures (LocalImageFrame in
    ImageFrame.scala), transformable by FeatureTransformers."""

    def __init__(self, features: List[ImageFeature]):
        self.features = list(features)

    def __len__(self):
        return len(self.features)

    def __iter__(self):
        return iter(self.features)

    def transform(self, transformer) -> "LocalImageFrame":
        """Apply a (composed) FeatureTransformer; returns a NEW frame (the
        reference mutates its array in place — a functional copy is safer
        and the arrays are shared when a transformer passes them through)."""
        out = list(transformer(iter(self.features)))
        feats = [f if isinstance(f, ImageFeature)
                 else ImageFeature(f) if isinstance(f, dict)
                 else ImageFeature(image=f)
                 for f in out]
        return LocalImageFrame(feats)

    # `frame -> transformer` composes in the reference; `|` would collide
    # with dict union on ImageFeature, so transform() is the one spelling.

    def to_distributed(self):
        raise NotImplementedError(
            "DistributedImageFrame is Spark-only in the reference; "
            "distribution happens at the data-set level, not the frame "
            "level")


class MTImageFeatureToBatch:
    """ImageFeature iterator → MiniBatch stream
    (MTImageFeatureToBatch.scala). Center-crops/pads every image to
    (height, width), stacks CHW floats, attaches labels when present;
    ``with_bbox=True`` also carries per-image bounding boxes (the SSD/
    Faster-RCNN path) as a list aligned with the batch."""

    def __init__(self, width: int, height: int, batch_size: int,
                 transformer: Optional[FeatureTransformer] = None,
                 to_rgb: bool = False, with_bbox: bool = False):
        self.width, self.height = width, height
        self.batch_size = batch_size
        self.transformer = transformer
        self.to_rgb = to_rgb
        self.with_bbox = with_bbox

    def _fit(self, img: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        if img.ndim == 2:
            img = img[:, :, None]
        # center-crop then zero-pad to the exact target (the reference
        # assumes the transformer already resized; this is the safety net)
        y0 = max((h - self.height) // 2, 0)
        x0 = max((w - self.width) // 2, 0)
        img = img[y0:y0 + self.height, x0:x0 + self.width]
        ph, pw = self.height - img.shape[0], self.width - img.shape[1]
        if ph or pw:
            img = np.pad(img, ((0, ph), (0, pw), (0, 0)))
        return img

    def __call__(self, features: Iterable[ImageFeature]):
        mat = MatToTensor()
        batch_imgs, batch_labels, batch_boxes = [], [], []
        it = iter(features)
        if self.transformer is not None:
            it = self.transformer(it)
        for f in it:
            if not isinstance(f, (dict, ImageFeature)):
                f = ImageFeature(image=f)
            img = self._fit(np.asarray(f["image"], np.float32))
            if self.to_rgb:
                img = img[:, :, ::-1]
            batch_imgs.append(mat.transform_image(img, None))
            if "label" in f:
                batch_labels.append(np.asarray(f["label"], np.float32))
            if batch_labels and len(batch_labels) != len(batch_imgs):
                raise ValueError(
                    "MTImageFeatureToBatch: mixed labeled/unlabeled "
                    "ImageFeatures in one stream — labels would misalign "
                    "with images (give every feature a 'label' or none)")
            if self.with_bbox:
                batch_boxes.append(np.asarray(f.get("boundingBox",
                                                    np.zeros((0, 4)))))
            if len(batch_imgs) == self.batch_size:
                yield self._emit(batch_imgs, batch_labels, batch_boxes)
                batch_imgs, batch_labels, batch_boxes = [], [], []
        if batch_imgs:
            yield self._emit(batch_imgs, batch_labels, batch_boxes)

    def _emit(self, imgs, labels, boxes):
        inp = np.stack(imgs)
        tgt = np.stack(labels) if labels else None
        mb = MiniBatch(inp, tgt)
        if self.with_bbox:
            mb.bboxes = boxes
        return mb
