"""The port's vision transforms and image frame
(``bigdl_tpu_torch.transform``) against the JAX package's
(``bigdl_tpu.transform``), bit for bit.

Host pixel work is numpy in both packages and every transformer draws
from its own ``np.random.RandomState(seed)``, so each transform, built
with the same arguments and seed and fed the same images (numpy, from a
seed), must give identical arrays, draw after draw: a stream of three
images (one of them an ``ImageFeature``-style dict with a label) goes
through each, twice. ``ImageFrame.read`` is held over a JPEG folder the
test writes (flat, and class subfolders with labels), and
``MTImageFeatureToBatch`` over the frame after a transform.
"""
import os

import numpy as np
import pytest
import torch

from bigdl_tpu import native as jnative
from bigdl_tpu.transform import image_frame as jframe
from bigdl_tpu.transform import vision as jv
from bigdl_tpu_torch.dataset import MiniBatch, Sample
from bigdl_tpu_torch.transform import (ImageFrame, LocalImageFrame,
                                       MTImageFeatureToBatch, vision as tv)
from bigdl_tpu_torch.transform.vision import image as tv_image

torch.set_num_threads(1)

# name -> (constructor over a module of transforms, kwargs)
CASES = {
    "Resize": (lambda m: m.Resize(20, 14), {}),
    "AspectScale": (lambda m: m.AspectScale(24, 30), {}),
    "CenterCrop": (lambda m: m.CenterCrop(9, 7), {}),
    "RandomCrop": (lambda m: m.RandomCrop(9, 7, seed=3), {}),
    "RandomResizedCrop": (lambda m: m.RandomResizedCrop(12, seed=4), {}),
    "RandomAlterAspect": (lambda m: m.RandomAlterAspect(10, (0.3, 0.9)),
                          {}),
    "HFlip": (lambda m: m.HFlip(), {}),
    "RandomTransformer": (lambda m: m.RandomTransformer(m.Brightness(-9, 9),
                                                        0.6, seed=5), {}),
    "RandomFlip": (lambda m: m.RandomFlip(0.5), {}),
    "ChannelNormalize": (lambda m: m.ChannelNormalize(120, 110, 100, 60, 58,
                                                      57), {}),
    "ChannelScaledNormalizer": (
        lambda m: m.ChannelScaledNormalizer(104, 117, 123, 0.017), {}),
    "PixelNormalizer": (lambda m: m.PixelNormalizer(
        np.random.RandomState(9).rand(18 * 15 * 3) * 100), {}),
    "Brightness": (lambda m: m.Brightness(-32, 32, seed=6), {}),
    "Contrast": (lambda m: m.Contrast(0.5, 1.5), {}),
    "Saturation": (lambda m: m.Saturation(0.5, 1.5), {}),
    "Hue": (lambda m: m.Hue(seed=7), {}),
    "ColorJitter": (lambda m: m.ColorJitter(seed=8), {}),
    "Expand": (lambda m: m.Expand(max_expand_ratio=2.5), {}),
    "Filler": (lambda m: m.Filler(0.1, 0.2, 0.6, 0.7, 33.0), {}),
    "Lighting": (lambda m: m.Lighting(0.2, seed=2), {}),
    "MatToTensor": (lambda m: m.MatToTensor(), {}),
    "ChannelOrder": (lambda m: m.ChannelOrder(), {}),
    "Crop": (lambda m: m.Crop((0.1, 0.2, 0.8, 0.9)), {}),
    "Crop_pixels": (lambda m: m.Crop((2, 3, 11, 14), normalized=False), {}),
    "RandomCropper": (lambda m: m.RandomCropper(8, 6, seed=11), {}),
    "RandomCropper_center": (lambda m: m.RandomCropper(
        8, 6, mirror=True, cropper_method="center", seed=12), {}),
    "RandomResize": (lambda m: m.RandomResize(10, 30, seed=13), {}),
    "FeatureTransformer": (lambda m: m.FeatureTransformer(), {}),
    "chain": (lambda m: m.RandomResizedCrop(10, seed=1) | m.RandomFlip(0.5)
              | m.ChannelNormalize(1, 2, 3, 4, 5, 6) | m.MatToTensor(), {}),
}


def _images(seed=0):
    rng = np.random.RandomState(seed)
    a = (rng.rand(18, 15, 3) * 255).astype(np.float32)
    b = (rng.rand(18, 15, 3) * 255).astype(np.float32)
    c = (rng.rand(18, 15, 3) * 255).astype(np.float32)
    return [a, {"image": b, "label": 3.0, "uri": "b"}, c]


def _arrays(items):
    return [np.asarray(i["image"] if isinstance(i, dict) else i)
            for i in items]


def test_every_jax_transform_has_a_case():
    names = {n.split("_")[0] for n in CASES} - {"chain"}
    want = {n for n in jv.__all__ if n not in ("ImageFeature",
                                               "ImageFrameToSample",
                                               "Transformer")}
    assert names == want
    assert tv.__all__ == jv.__all__ == sorted(jv.__all__)
    assert tv_image.Resize is tv.Resize


@pytest.mark.parametrize("name", sorted(CASES))
def test_transform_matches_jax_bit_for_bit(name):
    make, _ = CASES[name]
    jt, tt = make(jv), make(tv)
    for draw in range(2):
        want = list(jt(iter(_images(draw))))
        got = list(tt(iter(_images(draw))))
        assert len(got) == len(want) == 3
        for g, w in zip(_arrays(got), _arrays(want)):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert np.array_equal(g, w), name
        assert isinstance(got[1], dict) and got[1]["label"] == 3.0


def test_image_frame_to_sample_and_feature():
    f = tv.ImageFeature(image=np.ones((2, 2, 3), np.float32), label=2)
    assert f.image.shape == (2, 2, 3)
    f.image = np.zeros((1, 1, 3), np.float32)
    assert f["image"].shape == (1, 1, 3)
    s = list(tv.ImageFrameToSample()(iter([f, np.ones(3, np.float32)])))
    assert all(isinstance(x, Sample) for x in s)
    np.testing.assert_array_equal(s[0].features[0], f["image"])


def _write_folder(root, classes=("cat", "dog"), n=3):
    rng = np.random.RandomState(0)
    for ci, c in enumerate(classes):
        d = os.path.join(root, c)
        os.makedirs(d)
        for i in range(n):
            img = (rng.rand(20 + 2 * i, 24 - i, 3) * 255).astype(np.uint8)
            with open(os.path.join(d, f"{i}.jpg"), "wb") as f:
                f.write(jnative.encode_jpeg(img, 85))
    return root


def _same_frames(got, want):
    assert isinstance(got, LocalImageFrame) and len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert np.array_equal(g[k], w[k]), k
            else:
                assert g[k] == w[k], k


def test_image_frame_read_matches_jax(tmp_path):
    root = _write_folder(str(tmp_path / "data"))
    _same_frames(ImageFrame.read(root, with_label=True),
                 jframe.ImageFrame.read(root, with_label=True))
    flat = os.path.join(root, "cat")
    _same_frames(ImageFrame.read(flat), jframe.ImageFrame.read(flat))
    one = os.path.join(flat, "1.jpg")
    frame = ImageFrame.read(one)
    _same_frames(frame, jframe.ImageFrame.read(one))
    assert frame.features[0]["uri"] == one


def test_transformed_frame_batches_match_jax(tmp_path):
    root = _write_folder(str(tmp_path / "data"), n=4)
    pipes = [m.RandomResizedCrop(16, seed=2) | m.RandomFlip(0.5)
             for m in (tv, jv)]
    got = ImageFrame.read(root, with_label=True).transform(pipes[0])
    want = jframe.ImageFrame.read(root, with_label=True).transform(pipes[1])
    _same_frames(got, want)
    kw = dict(width=14, height=12, batch_size=3, to_rgb=True)
    got_b = list(MTImageFeatureToBatch(**kw)(got))
    want_b = list(jframe.MTImageFeatureToBatch(**kw)(want))
    assert [b.size() for b in got_b] == [3, 3, 2]
    for g, w in zip(got_b, want_b):
        assert isinstance(g, MiniBatch)
        assert np.array_equal(g.get_input(), w.get_input())
        assert np.array_equal(g.get_target(), w.get_target())
    # an array frame with bounding boxes, through the batcher's transformer
    imgs = _arrays(_images(1))
    boxes = MTImageFeatureToBatch(20, 20, 2, transformer=tv.HFlip(),
                                  with_bbox=True)
    out = list(boxes(ImageFrame.array(imgs, [1, 2, 3])))
    want = list(jframe.MTImageFeatureToBatch(
        20, 20, 2, transformer=jv.HFlip(), with_bbox=True)(
        jframe.ImageFrame.array(imgs, [1, 2, 3])))
    for g, w in zip(out, want):
        assert np.array_equal(g.input, w.input)
        assert [b.shape for b in g.bboxes] == [b.shape for b in w.bboxes]
    with pytest.raises(ValueError, match="mixed"):
        list(MTImageFeatureToBatch(4, 4, 4)(
            [tv.ImageFeature(image=imgs[0], label=1),
             tv.ImageFeature(image=imgs[1])]))
    with pytest.raises(NotImplementedError):
        got.to_distributed()
