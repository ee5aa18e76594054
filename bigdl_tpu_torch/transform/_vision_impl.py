"""Vision feature transformers (counterpart of
``bigdl_tpu/transform/_vision_impl.py``, the port's own copy).

Parity: reference ``transform/vision/image/augmentation/*.scala`` (Resize,
Crop variants, Flip, channel ops, ColorJitter, Expand, Filler, Lighting,
PixelNormalizer) + ``MatToTensor``. The reference runs these per-sample on
OpenCV Mats inside Spark tasks; here, as in the JAX package, they are
host-side numpy ops feeding the device pipeline. Images are HWC float32
unless noted; ``MatToTensor`` produces the CHW array the models consume.
Each transformer draws from its own ``np.random.RandomState(seed)``
(default 17), so the same seed gives the JAX package's crops, flips and
jitters bit for bit.

Each transformer is a ``dataset.Transformer`` over ``Sample``-like dicts or
raw arrays, composable with ``|``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..dataset.transformer import Transformer

__all__ = ["ImageFeature", "FeatureTransformer", "Resize", "AspectScale",
           "CenterCrop", "RandomCrop", "RandomResizedCrop", "HFlip",
           "RandomTransformer", "RandomFlip", "ChannelNormalize",
           "ChannelScaledNormalizer", "PixelNormalizer", "Brightness",
           "Contrast", "Saturation", "Hue", "ColorJitter", "Expand", "Filler",
           "Lighting", "MatToTensor", "ImageFrameToSample", "ChannelOrder",
           "Crop", "RandomCropper", "RandomResize", "RandomAlterAspect"]


class ImageFeature(dict):
    """Loose parity with transform/vision/image/ImageFeature.scala: a dict
    carrying 'image' (HWC float), 'label', and arbitrary metadata."""

    @property
    def image(self):
        return self["image"]

    @image.setter
    def image(self, v):
        self["image"] = v


class FeatureTransformer(Transformer):
    """Base per-image transformer (transform/vision/image/
    FeatureTransformer.scala)."""

    def transform_image(self, img: np.ndarray, rng: np.random.RandomState
                        ) -> np.ndarray:
        return img

    def __init__(self, seed: int = 17):
        self.rng = np.random.RandomState(seed)

    def apply(self, it):
        for item in it:
            if isinstance(item, dict):
                item = dict(item)
                item["image"] = self.transform_image(
                    np.asarray(item["image"], np.float32), self.rng)
                yield item
            else:
                yield self.transform_image(np.asarray(item, np.float32),
                                           self.rng)


def _resize_bilinear(img, oh, ow):
    h, w = img.shape[:2]
    if (h, w) == (oh, ow):
        return img
    ys = np.linspace(0, h - 1, oh)
    xs = np.linspace(0, w - 1, ow)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    img = img if img.ndim == 3 else img[..., None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    return out.astype(np.float32)


class Resize(FeatureTransformer):
    """augmentation/Resize.scala."""

    def __init__(self, resize_h: int, resize_w: int, **kw):
        super().__init__(**kw)
        self.resize_h, self.resize_w = resize_h, resize_w

    def transform_image(self, img, rng):
        return _resize_bilinear(img, self.resize_h, self.resize_w)


class AspectScale(FeatureTransformer):
    """augmentation/AspectScale.scala — short side → scale."""

    def __init__(self, scale: int = 256, max_size: int = 1000, **kw):
        super().__init__(**kw)
        self.scale, self.max_size = scale, max_size

    def transform_image(self, img, rng):
        h, w = img.shape[:2]
        short, long = min(h, w), max(h, w)
        ratio = self.scale / short
        if long * ratio > self.max_size:
            ratio = self.max_size / long
        return _resize_bilinear(img, int(round(h * ratio)),
                                int(round(w * ratio)))


class CenterCrop(FeatureTransformer):
    """augmentation/Crop.scala CenterCrop."""

    def __init__(self, crop_width: int, crop_height: int, **kw):
        super().__init__(**kw)
        self.cw, self.ch = crop_width, crop_height

    def transform_image(self, img, rng):
        h, w = img.shape[:2]
        y = max((h - self.ch) // 2, 0)
        x = max((w - self.cw) // 2, 0)
        return img[y:y + self.ch, x:x + self.cw]


class RandomCrop(FeatureTransformer):
    """augmentation/Crop.scala RandomCrop."""

    def __init__(self, crop_width: int, crop_height: int, **kw):
        super().__init__(**kw)
        self.cw, self.ch = crop_width, crop_height

    def transform_image(self, img, rng):
        h, w = img.shape[:2]
        y = rng.randint(0, max(h - self.ch, 0) + 1)
        x = rng.randint(0, max(w - self.cw, 0) + 1)
        return img[y:y + self.ch, x:x + self.cw]


class RandomResizedCrop(FeatureTransformer):
    """models/inception RandomAlterAspect / torch-style random area+aspect
    crop then resize."""

    def __init__(self, size: int, area_range=(0.08, 1.0),
                 aspect_range=(3 / 4, 4 / 3), **kw):
        super().__init__(**kw)
        self.size = size
        self.area_range, self.aspect_range = area_range, aspect_range

    def transform_image(self, img, rng):
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target = rng.uniform(*self.area_range) * area
            aspect = np.exp(rng.uniform(np.log(self.aspect_range[0]),
                                        np.log(self.aspect_range[1])))
            cw = int(round(np.sqrt(target * aspect)))
            ch = int(round(np.sqrt(target / aspect)))
            if cw <= w and ch <= h:
                y = rng.randint(0, h - ch + 1)
                x = rng.randint(0, w - cw + 1)
                return _resize_bilinear(img[y:y + ch, x:x + cw],
                                        self.size, self.size)
        return _resize_bilinear(img, self.size, self.size)


class HFlip(FeatureTransformer):
    """augmentation/HFlip.scala (unconditional)."""

    def transform_image(self, img, rng):
        return img[:, ::-1].copy()


class RandomTransformer(FeatureTransformer):
    """augmentation/RandomTransformer.scala — apply inner with prob p."""

    def __init__(self, inner: FeatureTransformer, prob: float = 0.5, **kw):
        super().__init__(**kw)
        self.inner, self.prob = inner, prob

    def transform_image(self, img, rng):
        if rng.rand() < self.prob:
            return self.inner.transform_image(img, rng)
        return img


def RandomFlip(prob=0.5):
    return RandomTransformer(HFlip(), prob)


class ChannelNormalize(FeatureTransformer):
    """augmentation/ChannelNormalize.scala — (x - mean) / std per channel."""

    def __init__(self, mean_r, mean_g, mean_b, std_r=1.0, std_g=1.0,
                 std_b=1.0, **kw):
        super().__init__(**kw)
        self.mean = np.array([mean_r, mean_g, mean_b], np.float32)
        self.std = np.array([std_r, std_g, std_b], np.float32)

    def transform_image(self, img, rng):
        return (img - self.mean) / self.std


class ChannelScaledNormalizer(FeatureTransformer):
    """augmentation/ChannelScaledNormalizer.scala."""

    def __init__(self, mean_r, mean_g, mean_b, scale: float, **kw):
        super().__init__(**kw)
        self.mean = np.array([mean_r, mean_g, mean_b], np.float32)
        self.scale = scale

    def transform_image(self, img, rng):
        return (img - self.mean) * self.scale


class PixelNormalizer(FeatureTransformer):
    """augmentation/PixelNormalizer.scala — subtract per-pixel mean image."""

    def __init__(self, means: np.ndarray, **kw):
        super().__init__(**kw)
        self.means = np.asarray(means, np.float32)

    def transform_image(self, img, rng):
        return img - self.means.reshape(img.shape)


class Brightness(FeatureTransformer):
    """augmentation/Brightness.scala — add delta in [lo, hi]."""

    def __init__(self, delta_low: float, delta_high: float, **kw):
        super().__init__(**kw)
        self.lo, self.hi = delta_low, delta_high

    def transform_image(self, img, rng):
        return img + rng.uniform(self.lo, self.hi)


class Contrast(FeatureTransformer):
    """augmentation/Contrast.scala — scale around mean."""

    def __init__(self, delta_low: float, delta_high: float, **kw):
        super().__init__(**kw)
        self.lo, self.hi = delta_low, delta_high

    def transform_image(self, img, rng):
        f = rng.uniform(self.lo, self.hi)
        return img * f


class Saturation(FeatureTransformer):
    """augmentation/Saturation.scala — blend with grayscale."""

    def __init__(self, delta_low: float, delta_high: float, **kw):
        super().__init__(**kw)
        self.lo, self.hi = delta_low, delta_high

    def transform_image(self, img, rng):
        f = rng.uniform(self.lo, self.hi)
        gray = img.mean(axis=-1, keepdims=True)
        return gray + (img - gray) * f


class Hue(FeatureTransformer):
    """augmentation/Hue.scala — rotate hue (approximate RGB-space rotation)."""

    def __init__(self, delta_low: float = -18.0, delta_high: float = 18.0,
                 **kw):
        super().__init__(**kw)
        self.lo, self.hi = delta_low, delta_high

    def transform_image(self, img, rng):
        theta = np.deg2rad(rng.uniform(self.lo, self.hi))
        c, s = np.cos(theta), np.sin(theta)
        # YIQ hue rotation matrix
        t_yiq = np.array([[0.299, 0.587, 0.114],
                          [0.596, -0.274, -0.322],
                          [0.211, -0.523, 0.312]], np.float32)
        rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
        m = np.linalg.inv(t_yiq) @ rot @ t_yiq
        return img @ m.T


class ColorJitter(FeatureTransformer):
    """augmentation/ColorJitter.scala — random order B/C/S."""

    def __init__(self, brightness=32.0, contrast=0.5, saturation=0.5, **kw):
        super().__init__(**kw)
        self.ops = [Brightness(-brightness, brightness),
                    Contrast(1 - contrast, 1 + contrast),
                    Saturation(1 - saturation, 1 + saturation)]

    def transform_image(self, img, rng):
        order = rng.permutation(len(self.ops))
        for i in order:
            img = self.ops[i].transform_image(img, rng)
        return img


class Expand(FeatureTransformer):
    """augmentation/Expand.scala — place image on a larger mean canvas."""

    def __init__(self, means=(123, 117, 104), max_expand_ratio: float = 4.0,
                 **kw):
        super().__init__(**kw)
        self.means = np.array(means, np.float32)
        self.max_ratio = max_expand_ratio

    def transform_image(self, img, rng):
        ratio = rng.uniform(1.0, self.max_ratio)
        h, w = img.shape[:2]
        nh, nw = int(h * ratio), int(w * ratio)
        canvas = np.tile(self.means, (nh, nw, 1)).astype(np.float32)
        y = rng.randint(0, nh - h + 1)
        x = rng.randint(0, nw - w + 1)
        canvas[y:y + h, x:x + w] = img
        return canvas


class Filler(FeatureTransformer):
    """augmentation/Filler.scala — fill a normalized sub-rect with a value."""

    def __init__(self, start_x: float, start_y: float, end_x: float,
                 end_y: float, value: float = 255.0, **kw):
        super().__init__(**kw)
        self.box = (start_x, start_y, end_x, end_y)
        self.value = value

    def transform_image(self, img, rng):
        h, w = img.shape[:2]
        x1, y1, x2, y2 = self.box
        img = img.copy()
        img[int(y1 * h):int(y2 * h), int(x1 * w):int(x2 * w)] = self.value
        return img


class Lighting(FeatureTransformer):
    """augmentation/Lighting.scala — AlexNet PCA noise (ImageNet eigen
    values/vectors)."""

    _eigval = np.array([0.2175, 0.0188, 0.0045], np.float32)
    _eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]], np.float32)

    def __init__(self, alphastd: float = 0.1, **kw):
        super().__init__(**kw)
        self.alphastd = alphastd

    def transform_image(self, img, rng):
        alpha = rng.normal(0, self.alphastd, 3).astype(np.float32)
        noise = (self._eigvec * alpha * self._eigval).sum(axis=1)
        return img + noise


class MatToTensor(FeatureTransformer):
    """transform/vision/image/MatToTensor.scala — HWC → CHW float tensor."""

    def transform_image(self, img, rng):
        if img.ndim == 2:
            img = img[..., None]
        return np.ascontiguousarray(img.transpose(2, 0, 1))


class ImageFrameToSample(Transformer):
    """transform/vision/image/ImageFrameToSample.scala."""

    def apply(self, it):
        from ..dataset.sample import Sample
        for item in it:
            if isinstance(item, dict):
                yield Sample(item["image"], item.get("label"))
            else:
                yield Sample(item)


class ChannelOrder(FeatureTransformer):
    """augmentation/ChannelOrder.scala — swap RGB<->BGR (the reference
    flips the OpenCV BGR order to the RGB order nets trained on).
    No-op on grayscale (HW) images — the last axis there is width."""

    def transform_image(self, img, rng):
        return img[..., ::-1] if img.ndim == 3 else img


class Crop(FeatureTransformer):
    """augmentation/Crop.scala base — crop by an explicit roi
    (x1, y1, x2, y2), normalized coords by default, clipped to bounds."""

    def __init__(self, roi, normalized: bool = True, is_clip: bool = True,
                 **kw):
        super().__init__(**kw)
        self.roi, self.normalized, self.is_clip = tuple(roi), normalized, \
            is_clip

    def generate_roi(self, img, rng):
        return self.roi

    def transform_image(self, img, rng):
        h, w = img.shape[:2]
        x1, y1, x2, y2 = self.generate_roi(img, rng)
        if self.normalized:
            x1, y1, x2, y2 = x1 * w, y1 * h, x2 * w, y2 * h
        if self.is_clip:
            x1, x2 = max(0, x1), min(w, x2)
            y1, y2 = max(0, y1), min(h, y2)
        elif not (0 <= x1 < x2 <= w and 0 <= y1 < y2 <= h):
            # without clipping an out-of-bounds roi cannot be represented
            # by a numpy view (negative indices would WRAP); fail loudly
            raise ValueError(
                f"crop roi ({x1},{y1},{x2},{y2}) outside {w}x{h} image "
                "(set is_clip=True to clamp)")
        return img[int(y1):int(y2), int(x1):int(x2)]


class RandomCropper(FeatureTransformer):
    """augmentation/RandomCropper.scala — crop to (cropWidth, cropHeight)
    at a random (or center) position, with optional random mirror."""

    def __init__(self, crop_width: int, crop_height: int,
                 mirror: bool = True, cropper_method: str = "random", **kw):
        super().__init__(**kw)
        if cropper_method not in ("random", "center"):
            raise ValueError(f"cropper_method must be 'random' or 'center', "
                             f"got {cropper_method!r}")
        # one source of truth for the offset math: delegate to the
        # existing crop transformers
        self._crop = (RandomCrop if cropper_method == "random"
                      else CenterCrop)(crop_width, crop_height)
        self.mirror = mirror
        self.cropper_method = cropper_method

    def transform_image(self, img, rng):
        out = self._crop.transform_image(img, rng)
        if self.mirror and rng.rand() < 0.5:
            out = out[:, ::-1]
        return out


class RandomResize(FeatureTransformer):
    """augmentation/RandomResize.scala — resize so the SHORTER side is a
    uniform random size in [min_size, max_size], keeping aspect."""

    def __init__(self, min_size: int, max_size: int, **kw):
        super().__init__(**kw)
        self.min_size, self.max_size = min_size, max_size

    def transform_image(self, img, rng):
        h, w = img.shape[:2]
        short = rng.randint(self.min_size, self.max_size + 1)
        if h < w:
            oh, ow = short, int(round(w / h * short))
        else:
            oh, ow = int(round(h / w * short)), short
        return _resize_bilinear(img, oh, ow)


# reference name for the inception-style scale/aspect crop
RandomAlterAspect = RandomResizedCrop
