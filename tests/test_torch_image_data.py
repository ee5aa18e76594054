"""The port's image data sets and readers (``bigdl_tpu_torch.dataset``:
``base``, ``imagenet``, ``mnist``, ``cifar``, ``tfrecord``) against the JAX
package's, bit for bit, over small files the tests write: an ImageNet-style
JPEG folder (with a stray PNG), MNIST idx files (plain and gzipped),
CIFAR-10 binary batches, TFRecord files of tf.Examples. The synthetic
stand-ins are the JAX package's arrays. ``maybe_download`` resolves a file
that is present and refuses, naming the URL, one that is not: the port
downloads nothing, whatever the environment says.
"""
import gzip
import os
import struct

import numpy as np
import pytest
import torch

from bigdl_tpu import native as jnative
from bigdl_tpu.dataset import (base as jbase, cifar as jcifar,
                               imagenet as jimagenet, mnist as jmnist,
                               tfrecord as jtfrecord)
from bigdl_tpu_torch.dataset import (MiniBatch, Sample, base, cifar, imagenet,
                                     mnist, tfrecord)

torch.set_num_threads(1)


def _same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert isinstance(g, MiniBatch)
        assert np.array_equal(g.get_input(), w.get_input())
        assert np.array_equal(g.get_target(), w.get_target())


def _same_samples(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, Sample)
        for a, b in zip(g.features + g.labels, w.features + w.labels):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            assert np.array_equal(a, b)


# -- ImageNet ---------------------------------------------------------------------

def _imagenet_folder(root):
    from PIL import Image
    rng = np.random.RandomState(0)
    for ci, c in enumerate(("n01", "n02", "n03")):
        d = os.path.join(root, c)
        os.makedirs(d)
        for i in range(3):
            img = (rng.rand(30 + 4 * i, 36 - 3 * i, 3) * 255).astype(np.uint8)
            with open(os.path.join(d, f"{i}.jpg"), "wb") as f:
                f.write(jnative.encode_jpeg(img, 90))
        with open(os.path.join(d, "notes.txt"), "w") as f:
            f.write("not an image")
    Image.fromarray((rng.rand(25, 28, 3) * 255).astype(np.uint8)).save(
        os.path.join(root, "n02", "9.png"))
    return root


def test_imagenet_folder_matches_jax(tmp_path):
    root = _imagenet_folder(str(tmp_path / "imagenet"))
    assert imagenet.scan_folder(root) == jimagenet.scan_folder(root)
    paths, labels, classes = imagenet.scan_folder(root)
    assert len(paths) == 10 and classes == ["n01", "n02", "n03"]
    dec, jdec = imagenet._decoder(), jimagenet._decoder()
    for p in paths:                           # libjpeg, and PIL for the PNG
        assert np.array_equal(dec(p), jdec(p))
    for train in (True, False):
        ds = imagenet.ImageNetDataSet(root, 3, train=train, crop_size=20,
                                      seed=4)
        jds = jimagenet.ImageNetDataSet(root, 3, train=train, crop_size=20,
                                        seed=4)
        assert ds.size() == 10 and ds.batches_per_epoch() == 3
        assert ds.shuffle() is ds
        for _ in range(2):                   # two epochs: the rng streams
            got = list(ds.data(train=train))
            _same_batches(got, list(jds.data(train=train)))
        assert got[0].get_input().shape == (3, 3, 20, 20)


def test_imagenet_synthetic_matches_jax():
    for a, b in zip(imagenet.synthetic(6, 12, 10, seed=2),
                    jimagenet.synthetic(6, 12, 10, seed=2)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    ds = imagenet.ImageNetDataSet(None, 4, crop_size=16, n_synthetic=9)
    jds = jimagenet.ImageNetDataSet(None, 4, crop_size=16, n_synthetic=9)
    assert ds.classes == jds.classes
    _same_batches(list(ds.data()), list(jds.data()))
    _same_batches(list(ds.data(train=False)), list(jds.data(train=False)))


def test_imagenet_decoder_without_libjpeg_or_pil(monkeypatch):
    """No libjpeg build and no PIL: no decoder, so a folder is served as
    the synthetic stand-in (as in JAX)."""
    from bigdl_tpu_torch import native
    monkeypatch.setattr(native, "jpeg_available", lambda: False)
    monkeypatch.setattr(imagenet, "_python_decoder", lambda: None)
    assert imagenet._decoder() is None


# -- MNIST ----------------------------------------------------------------------

def _idx(path, arr, gz):
    op = gzip.open if gz else open
    with op(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | arr.ndim))
        for d in arr.shape:
            f.write(struct.pack(">I", d))
        f.write(arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
def test_mnist_idx_files_match_jax(tmp_path, gz):
    rng = np.random.RandomState(1)
    sfx = ".gz" if gz else ""
    for prefix, n in (("train", 7), ("t10k", 5)):
        _idx(str(tmp_path / f"{prefix}-images-idx3-ubyte{sfx}"),
             rng.randint(0, 256, size=(n, 28, 28)), gz)
        _idx(str(tmp_path / f"{prefix}-labels-idx1-ubyte{sfx}"),
             rng.randint(0, 10, size=(n,)), gz)
    for train in (True, False):
        imgs, labels = mnist.load(str(tmp_path), train)
        jimgs, jlabels = jmnist.load(str(tmp_path), train)
        assert imgs.shape == (7 if train else 5, 28, 28)
        assert np.array_equal(imgs, jimgs) and np.array_equal(labels,
                                                              jlabels)
        assert labels.dtype == np.int64 and labels.min() >= 1
        assert np.array_equal(mnist.normalize(imgs, train),
                              jmnist.normalize(imgs, train))
        _same_samples(mnist.to_samples(imgs, labels, train),
                      jmnist.to_samples(imgs, labels, train))


def test_mnist_synthetic_matches_jax():
    for train in (True, False):
        for a, b in zip(mnist.load(None, train, 40),
                        jmnist.load(None, train, 40)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    x = mnist.to_samples(*mnist.synthetic(3))[0].features[0]
    assert x.shape == (1, 28, 28) and x.dtype == np.float32


# -- CIFAR-10 -----------------------------------------------------------------------

def test_cifar_binary_files_match_jax(tmp_path):
    rng = np.random.RandomState(2)
    for name, n in (("data_batch_1.bin", 6), ("data_batch_3.bin", 4),
                    ("test_batch.bin", 5)):
        rec = np.concatenate([rng.randint(0, 10, size=(n, 1)),
                              rng.randint(0, 256, size=(n, 3072))], 1)
        rec.astype(np.uint8).tofile(str(tmp_path / name))
    for train in (True, False):
        imgs, labels = cifar.load(str(tmp_path), train)
        jimgs, jlabels = jcifar.load(str(tmp_path), train)
        assert imgs.shape == ((10 if train else 5), 3, 32, 32)
        assert np.array_equal(imgs, jimgs) and np.array_equal(labels,
                                                              jlabels)
        assert np.array_equal(cifar.normalize(imgs), jcifar.normalize(imgs))
        _same_samples(cifar.to_samples(imgs, labels),
                      jcifar.to_samples(imgs, labels))
    for a, b in zip(cifar.load(str(tmp_path / "none"), n_synthetic=12),
                    jcifar.load(str(tmp_path / "none"), n_synthetic=12)):
        assert a.shape[0] == 12 and np.array_equal(a, b)


# -- TFRecord -------------------------------------------------------------------------

FEATURES = [
    {"features": np.linspace(-1, 1, 12, dtype=np.float32),
     "label": np.array([3]), "ids": np.array([-5, 0, 2 ** 40]),
     "name": b"first", "tags": [b"a", b"bc"]},
    {"features": np.arange(12, dtype=np.float64) / 7, "label": np.array([1]),
     "ids": np.array([7]), "name": b"", "tags": [b"x"]},
]


def test_tf_examples_match_jax_byte_for_byte():
    for f in FEATURES:
        rec = tfrecord.make_example(f)
        assert rec == jtfrecord.make_example(f)
        got, want = tfrecord.parse_example(rec), jtfrecord.parse_example(rec)
        assert sorted(got) == sorted(want)
        for k in want:
            if isinstance(want[k], np.ndarray):
                assert got[k].dtype == want[k].dtype
                assert np.array_equal(got[k], want[k])
            else:
                assert got[k] == want[k]
    assert tfrecord.parse_example(tfrecord.make_example(FEATURES[0]))[
        "ids"].tolist() == [-5, 0, 2 ** 40]


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "python"])
def test_tfrecord_files_match_jax(tmp_path, use_native):
    recs = [tfrecord.make_example(f) for f in FEATURES] + [b"raw bytes"]
    p, jp = str(tmp_path / "port.tfrecord"), str(tmp_path / "jax.tfrecord")
    tfrecord.write_tfrecords(p, recs)
    jtfrecord.write_tfrecords(jp, recs)
    assert open(p, "rb").read() == open(jp, "rb").read()
    assert list(tfrecord.read_tfrecords(jp, use_native=use_native)) == recs
    assert list(jtfrecord.read_tfrecords(p, use_native=use_native)) == recs
    ds = str(tmp_path / "ds.tfrecord")
    tfrecord.write_tfrecords(ds, recs[:2])
    _same_samples(tfrecord.load_tfrecord_dataset([ds], feature_shape=(3, 4)),
                  jtfrecord.load_tfrecord_dataset([ds],
                                                  feature_shape=(3, 4)))
    # a flipped byte in the second record's payload
    raw = bytearray(open(p, "rb").read())
    raw[len(raw) // 2] ^= 0x40
    bad = str(tmp_path / "bad.tfrecord")
    open(bad, "wb").write(bytes(raw))
    for mod in (tfrecord, jtfrecord):
        with pytest.raises(IOError, match="corrupt"):
            list(mod.read_tfrecords(bad, use_native=use_native))


def test_legacy_framing_is_named_as_in_jax(tmp_path):
    from bigdl_tpu_torch.visualization.event_writer import crc32c
    data = b"payload"
    head = struct.pack("<Q", len(data))
    legacy = lambda b: ((crc32c(b) >> 15) | (crc32c(b) << 17)) & 0xFFFFFFFF
    p = str(tmp_path / "old.tfrecord")
    with open(p, "wb") as f:
        f.write(head + struct.pack("<I", legacy(head)) + data
                + struct.pack("<I", legacy(data)))
    for use_native in (True, False):
        for mod in (tfrecord, jtfrecord):
            with pytest.raises(IOError, match="legacy unmasked scheme"):
                list(mod.read_tfrecords(p, use_native=use_native))
        assert list(tfrecord.read_tfrecords(p, False, use_native)) == [data]


# -- base -----------------------------------------------------------------------------

def test_maybe_download_resolves_present_files_and_fetches_nothing(
        tmp_path, monkeypatch):
    url = "https://example.invalid/train-images-idx3-ubyte.gz"
    d = str(tmp_path / "mnist")
    with pytest.raises(FileNotFoundError, match="example.invalid"):
        base.maybe_download("train.gz", d, url)
    # JAX's download switch does not make the port download
    monkeypatch.setenv("BIGDL_TPU_ALLOW_DOWNLOAD", "1")
    with pytest.raises(FileNotFoundError, match="nothing is downloaded"):
        base.maybe_download("train.gz", d, url)
    open(os.path.join(d, "train.gz"), "wb").close()
    monkeypatch.delenv("BIGDL_TPU_ALLOW_DOWNLOAD")
    assert base.maybe_download("train.gz", d, url) == \
        jbase.maybe_download("train.gz", d, url) == os.path.join(d,
                                                                 "train.gz")


def test_progbar_and_table_print_what_jax_prints(capsys):
    for mod in (base, jbase):
        bar = mod.Progbar(10, width=8, interval=0.0)
        bar.update(3)
        bar.add(4)
        bar.update(10)
        mod.display_table([["name", "value"], ["loss", 0.25]], [8, 20])
    out = capsys.readouterr().out
    half = len(out) // 2
    assert out[:half] == out[half:] and out.count("[========] 10/10") == 2
