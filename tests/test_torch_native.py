"""The port's native runtime (``bigdl_tpu_torch.native``) against the JAX
package's (``bigdl_tpu.native``): the same C++ prefetcher, decoders and
TFRecord reader, built from the port's own copy of the source into
``build/native/``.

Held bit for bit (numpy inputs from seeds, JPEG folders the tests write):

* ``NativePrefetcher`` / ``JpegFolderPrefetcher`` batches for
  ``train=False`` with JAX at ``n_workers=1`` (the only count at which
  JAX's completion-order delivery is deterministic) and the port at 1 and
  4; augmented bf16 NHWC and float32 CHW batches at the same seed
  (``train=True``: the same permutation, the same crops and flips);
* ``encode_jpeg`` bytes, ``decode_jpeg`` pixels,
  ``decode_jpeg_resize_norm`` floats;
* ``read_tfrecords_native`` records, and its errors on a corrupt file.

Port-only: batches leave in claim order with 4 workers when the first
batch is the slowest to decode; the staging ring on the CPU; the
library's build under concurrent first use; looped epochs; a LeNet-5
``LocalOptimizer`` run fed by the prefetcher.
"""
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from bigdl_tpu import native as jnative
from bigdl_tpu.dataset.tfrecord import write_tfrecords as jax_write_tfrecords
from bigdl_tpu_torch import native

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN, STD = [10.0, 20.0, 30.0], [2.0, 3.0, 4.0]


def _raw(n=50, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 255, size=(n, 3, 8, 8)).astype(np.uint8),
            rng.randint(1, 11, size=(n,)).astype(np.int64))


def _smooth(h, w, seed):
    """A JPEG-friendly RGB image: gradients plus a little noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 / w, yy * 255 / h, (xx + yy) * 127 / (w + h)],
                   -1) + rng.randn(h, w, 3) * 8
    return np.clip(img, 0, 255).astype(np.uint8)


def _folder(tmp_path, sizes, seed=0):
    """JPEG files written with JAX's encoder; (paths, 1-based labels)."""
    paths, labels = [], []
    for i, (h, w) in enumerate(sizes):
        p = str(tmp_path / f"im{i:03d}.jpg")
        with open(p, "wb") as f:
            f.write(jnative.encode_jpeg(_smooth(h, w, seed + i), 90))
        paths.append(p)
        labels.append(i % 4 + 1)
    return paths, labels


def _port_batches(pf, train):
    return [(b.input.float().numpy(), b.target.numpy())
            for b in pf.data(train=train)]


def _jax_batches(pf, train):
    return [(np.asarray(b.input, np.float32), np.asarray(b.target))
            for b in pf.data(train=train)]


def _equal(got, want):
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.shape == wx.shape and np.array_equal(gx, wx)
        assert np.array_equal(gy, wy)


def test_both_libraries_build_with_libjpeg():
    assert native.available() and jnative.available()
    assert native.jpeg_available() and jnative.jpeg_available()
    assert native.lib_path().parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")


@pytest.mark.parametrize("workers", [1, 4])
def test_raw_batches_equal_jax_in_order(workers):
    imgs, labels = _raw()
    want = _jax_batches(jnative.NativePrefetcher(
        imgs, labels, MEAN, STD, batch_size=16, n_workers=1), False)
    pf = native.NativePrefetcher(imgs, labels, MEAN, STD, batch_size=16,
                                 n_workers=workers)
    got = _port_batches(pf, False)
    _equal(got, want)
    assert [len(y) for _, y in got] == [16, 16, 16, 2]
    ref = (imgs.astype(np.float32) - np.float32(MEAN)[:, None, None]) \
        / np.float32(STD)[:, None, None]
    np.testing.assert_array_equal(np.concatenate([x for x, _ in got]), ref)
    # training order: the permutation of the same seed, in both
    want = _jax_batches(jnative.NativePrefetcher(
        imgs, labels, MEAN, STD, batch_size=16, n_workers=1, seed=5), True)
    _equal(_port_batches(native.NativePrefetcher(
        imgs, labels, MEAN, STD, batch_size=16, n_workers=workers, seed=5),
        True), want)


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("out", ["f32_chw", "bf16_nhwc"])
def test_jpeg_batches_equal_jax(tmp_path, workers, out):
    paths, labels = _folder(tmp_path, [(40 + 3 * i, 30 + 5 * i)
                                       for i in range(11)])
    kw = dict(batch_size=4, seed=3, out=out)
    for augment, train in ((False, False), (True, True)):
        want = _jax_batches(jnative.JpegFolderPrefetcher(
            paths, labels, 24, 20, (120.0, 110.0, 100.0),
            (60.0, 58.0, 57.0), n_workers=1, augment=augment, **kw), train)
        pf = native.JpegFolderPrefetcher(
            paths, labels, 24, 20, (120.0, 110.0, 100.0), (60.0, 58.0, 57.0),
            n_workers=workers, augment=augment, **kw)
        got = _port_batches(pf, train)
        _equal(got, want)
        shape = (4, 3, 24, 20) if out == "f32_chw" else (4, 24, 20, 3)
        assert got[0][0].shape == shape
        assert pf.decode_failures == 0
    x = next(iter(pf.data(train=False))).input
    assert x.dtype == (torch.float32 if out == "f32_chw" else torch.bfloat16)


def test_jpeg_codec_equals_jax(tmp_path):
    img = _smooth(37, 53, 1)
    gray = img[:, :, 0]
    for a in (img, gray):
        for q in (50, 90):
            b = native.encode_jpeg(a, q)
            assert b == jnative.encode_jpeg(a, q)
            np.testing.assert_array_equal(native.decode_jpeg(b),
                                          jnative.decode_jpeg(b))
    p = str(tmp_path / "a.jpg")
    with open(p, "wb") as f:
        f.write(native.encode_jpeg(img))
    np.testing.assert_array_equal(native.decode_jpeg(p),
                                  jnative.decode_jpeg(p))
    np.testing.assert_array_equal(
        native.decode_jpeg_resize_norm(p, 16, 20, MEAN, STD),
        jnative.decode_jpeg_resize_norm(p, 16, 20, MEAN, STD))
    for bad in (lambda: native.decode_jpeg(b"not a jpeg"),
                lambda: native.encode_jpeg(img.astype(np.float32))):
        with pytest.raises(ValueError):
            bad()


def test_undecodable_file_is_a_zero_image_in_both(tmp_path):
    paths, labels = _folder(tmp_path, [(20, 20)] * 3)
    with open(paths[1], "wb") as f:
        f.write(b"\xff\xd8 truncated")
    want = _jax_batches(jnative.JpegFolderPrefetcher(
        paths, labels, 8, 8, 0.0, 1.0, batch_size=3, n_workers=1), False)
    pf = native.JpegFolderPrefetcher(paths, labels, 8, 8, 0.0, 1.0,
                                     batch_size=3, n_workers=2)
    got = _port_batches(pf, False)
    _equal(got, want)
    assert not got[0][0][1].any() and got[0][0][0].any()
    assert pf.decode_failures == 1


def test_tfrecords_equal_jax(tmp_path):
    rng = np.random.RandomState(0)
    recs = [rng.bytes(n) for n in (0, 1, 17, 300)]
    p = str(tmp_path / "a.tfrecord")
    jax_write_tfrecords(p, recs)
    assert native.read_tfrecords_native(p) == recs
    assert jnative.read_tfrecords_native(p) == recs
    raw = bytearray(open(p, "rb").read())
    raw[-3] ^= 0xFF                     # the last record's data crc
    bad = str(tmp_path / "bad.tfrecord")
    open(bad, "wb").write(bytes(raw))
    for mod in (native, jnative):
        with pytest.raises(IOError, match="corrupt data crc"):
            mod.read_tfrecords_native(bad)
        assert mod.read_tfrecords_native(bad, verify_crc=False)[:3] \
            == recs[:3]
    with pytest.raises(FileNotFoundError):
        native.read_tfrecords_native(str(tmp_path / "missing"))


def _held_first_batch(tmp_path, name):
    """A JPEG folder of 8 batches of 4 whose first file is a FIFO: the
    worker that claims batch 0 blocks opening it until :func:`_release`
    opens the other end (then reads nothing: a zero image, one decode
    failure)."""
    paths, _ = _folder(tmp_path, [(16, 16)] * 32)
    fifo = str(tmp_path / name)
    os.mkfifo(fifo)
    return [fifo] + paths[1:], list(range(1, 33))


def _release(fifo, delay):
    def go():
        time.sleep(delay)
        with open(fifo, "wb"):
            pass
    t = threading.Thread(target=go, daemon=True)
    t.start()
    return t


def test_batches_leave_in_claim_order_when_the_first_is_slowest(tmp_path):
    """Four workers; batch 0 is held back a second while the other
    workers finish theirs. The port still hands out batch 0 first and every
    batch in the order of the data set; JAX's copy hands out whichever
    batch finished first (the reference's completion-order delivery,
    ``bigdl_tpu/native/prefetcher.cpp`` ``worker_loop``)."""
    firsts = {}
    for mod in (native, jnative):
        paths, labels = _held_first_batch(tmp_path, f"fifo_{mod.__name__}")
        pf = mod.JpegFolderPrefetcher(paths, labels, 16, 16, 0.0, 1.0,
                                      batch_size=4, n_workers=4,
                                      queue_capacity=4)
        t = _release(paths[0], 1.0)
        ys = [np.asarray(b.target).astype(int).tolist()
              for b in pf.data(train=False)]
        t.join(timeout=60)
        assert not t.is_alive() and pf.decode_failures == 1
        assert sorted(sum(ys, [])) == labels
        firsts[mod] = ys[0]
        if mod is native:
            assert ys == [labels[i:i + 4] for i in range(0, 32, 4)]
    assert firsts[native] == [1, 2, 3, 4]
    assert firsts[jnative] != [1, 2, 3, 4]


def test_staging_ring_on_the_cpu_clones():
    imgs, labels = _raw(40)
    plain = _port_batches(native.NativePrefetcher(
        imgs, labels, MEAN, STD, batch_size=8), False)
    pf = native.NativePrefetcher(imgs, labels, MEAN, STD, batch_size=8,
                                 queue_capacity=1, stage_to_device=True,
                                 device="cpu")
    held = list(pf.data(train=False))        # 5 batches through 3 slots
    _equal([(b.input.numpy(), b.target.numpy()) for b in held], plain)
    ring = native.HostStagingRing((2, 3), torch.float32, (2,),
                                  torch.float32, slots=2, device="cpu")
    x, y = ring.acquire()
    x.fill_(1.0)
    xd, _ = ring.to_device(x, y)
    x.fill_(2.0)
    assert float(xd.sum()) == 6.0
    assert ring.acquire()[0] is not x and ring.acquire()[0] is x


def test_labels_must_match_the_samples(tmp_path):
    imgs, labels = _raw(8)
    with pytest.raises(ValueError, match="7 labels for 8 samples"):
        native.NativePrefetcher(imgs, labels[:7], MEAN, STD)
    paths, _ = _folder(tmp_path, [(8, 8)] * 2)
    with pytest.raises(ValueError, match="3 labels for 2 samples"):
        native.JpegFolderPrefetcher(paths, [1, 2, 3], 4, 4, 0.0, 1.0)


def test_staging_to_the_card_needs_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    imgs, labels = _raw(8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        native.NativePrefetcher(imgs, labels, MEAN, STD,
                                stage_to_device=True)
    # without staging the prefetcher is host-only and needs no device
    assert native.NativePrefetcher(imgs, labels, MEAN, STD).size() == 8


def test_looped_epochs_cover_every_sample_without_a_restart():
    imgs = np.arange(40, dtype=np.uint8).reshape(40, 1, 1, 1)
    labels = np.arange(1, 41, dtype=np.int64)
    pf = native.NativePrefetcher(imgs, labels, [0.0], [1.0], batch_size=16,
                                 n_workers=3)
    batches = list(pf.data(train=True, loop_epochs=3))
    assert [b.size() for b in batches] == [16] * 6    # partial ones dropped
    for b in batches:
        y = b.target.numpy()
        assert len(set(y.tolist())) == 16
        np.testing.assert_array_equal(b.input.numpy().reshape(-1) + 1, y)
    # each epoch a fresh permutation of the seed, as in JAX
    rng = np.random.RandomState(1)
    want = np.concatenate([rng.permutation(40)[:32] for _ in range(3)]) + 1
    np.testing.assert_array_equal(
        np.concatenate([b.target.numpy() for b in batches]), want)


def test_concurrent_first_use_builds_the_library_once(tmp_path):
    """Four processes load the library at once into an empty build
    directory: one compiles under the lock, the others wait and load its
    result; no temporary file is left behind."""
    code = textwrap.dedent(f"""
        import pathlib, sys
        from bigdl_tpu_torch import native
        native.BUILD_DIR = pathlib.Path({str(tmp_path)!r})
        assert native.available() and native.jpeg_available()
        print(native.lib_path().name)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    names = {o.strip() for o, _ in outs}
    assert len(names) == 1
    assert sorted(os.listdir(tmp_path)) == sorted(names | {"build.lock"})


def test_prefetcher_trains_lenet():
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import mnist
    from bigdl_tpu_torch.models import LeNet5
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, MaxIteration
    imgs, labels = mnist.load(n_synthetic=256)
    pf = native.NativePrefetcher(imgs[:, None], labels, [mnist.TRAIN_MEAN],
                                 [mnist.TRAIN_STD], batch_size=64)
    opt = LocalOptimizer(LeNet5(10, device="cpu"), pf,
                         nn.ClassNLLCriterion(), SGD(learningrate=0.05),
                         MaxIteration(8), 64, device="cpu")
    opt.optimize()
    assert opt.optim_method.state["loss"] < 2.5
