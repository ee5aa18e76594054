"""Native (C++) data-loading runtime, ctypes-bound (counterpart of
``bigdl_tpu/native``).

Parity: the reference's native runtime split — Spark-executor threaded decode
(utils/ThreadPool.scala + dataset image readers) around the compute core.
Here: ``prefetcher.cpp`` (the port's own copy, which delivers batches in the
order they were claimed) around the GPU. The library is built with ``g++`` on
first use, never at import, into ``build/native/`` at the root of the
checkout (gitignored); its file name carries a digest of the source, and
concurrent first uses (test workers) build it once, under a file lock,
through a temporary file and ``os.replace``. A build with libjpeg
(``-DBIGDL_TPU_JPEG -ljpeg``) is tried first, then one without:
:func:`jpeg_available` says which was made. Without ``g++``,
:func:`load_library` returns None, as the JAX package's does.

Batches are torch tensors: float32 CHW, or bfloat16 NHWC for
``JpegFolderPrefetcher(out="bf16_nhwc")`` (the workers write bf16 bits into
a ``torch.bfloat16`` buffer). ``stage_to_device=True`` decodes into a ring of
pinned host buffers copied to the card with ``non_blocking=True``; each slot
records a CUDA event after its copy and waits on it before it is refilled.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..utils.engine import resolve_device

__all__ = ["load_library", "available", "HostStagingRing",
           "NativePrefetcher", "jpeg_available", "decode_jpeg",
           "encode_jpeg", "decode_jpeg_resize_norm", "JpegFolderPrefetcher",
           "read_tfrecords_native"]

_SRC = Path(__file__).resolve().parent / "prefetcher.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_CXX = ("g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_lib = None
_lock = threading.Lock()


def lib_path() -> Path:
    """The library's path: ``build/native/`` with a digest of the source
    and the flags in its name, so an edited source is rebuilt."""
    h = hashlib.sha256(" ".join(_CXX).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libbigdl_tpu_torch_native-{h.hexdigest()[:12]}.so"


def _build(out: Path):
    """Compile ``prefetcher.cpp`` to ``out`` (with libjpeg when it links)
    unless another process did while this one waited for the lock."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        base = [*_CXX, str(_SRC), "-o", str(tmp)]
        r = subprocess.run([*_CXX, "-DBIGDL_TPU_JPEG", str(_SRC), "-o",
                            str(tmp), "-ljpeg"], capture_output=True)
        if r.returncode != 0:
            subprocess.run(base, check=True, capture_output=True)
        os.replace(tmp, out)


def load_library():
    """Build (if needed) and load the native library; None if it cannot
    be built (no ``g++``)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = lib_path()
        try:
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, subprocess.CalledProcessError):
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.pf_create_raw.restype = ctypes.c_void_p
        lib.pf_create_raw.argtypes = [
            u8p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, f32p, f32p]
        lib.pf_next.restype = ctypes.c_int
        lib.pf_start_epoch.argtypes = [
            ctypes.c_void_p, i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.pf_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p]
        lib.pf_set_format.restype = ctypes.c_int
        lib.pf_set_format.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.pf_set_augment.restype = ctypes.c_int
        lib.pf_set_augment.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_longlong]
        lib.pf_end_epoch.argtypes = [ctypes.c_void_p]
        lib.pf_destroy.argtypes = [ctypes.c_void_p]
        lib.pf_decode_failures.restype = ctypes.c_int64
        lib.pf_decode_failures.argtypes = [ctypes.c_void_p]
        lib.tfr_open.restype = ctypes.c_void_p
        lib.tfr_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.tfr_count.restype = ctypes.c_int64
        lib.tfr_count.argtypes = [ctypes.c_void_p]
        lib.tfr_error.restype = ctypes.c_char_p
        lib.tfr_error.argtypes = [ctypes.c_void_p]
        lib.tfr_record_len.restype = ctypes.c_int64
        lib.tfr_record_len.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.tfr_record_data.restype = u8p
        lib.tfr_record_data.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.tfr_close.argtypes = [ctypes.c_void_p]
        lib.jd_available.restype = ctypes.c_int
        if lib.jd_available():
            lib.jd_info.restype = ctypes.c_int
            lib.jd_info.argtypes = [u8p, ctypes.c_long, i32p, i32p, i32p]
            lib.jd_decode.restype = ctypes.c_int
            lib.jd_decode.argtypes = [u8p, ctypes.c_long, u8p]
            lib.jd_decode_resize_chw.restype = ctypes.c_int
            lib.jd_decode_resize_chw.argtypes = [
                u8p, ctypes.c_long, ctypes.c_int, ctypes.c_int, f32p, f32p,
                f32p]
            lib.pf_create_jpeg.restype = ctypes.c_void_p
            lib.pf_create_jpeg.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, f32p, f32p]
            lib.je_encode.restype = ctypes.c_int
            lib.je_encode.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int, u8p,
                                      ctypes.c_long]
        _lib = lib
        return _lib


def available() -> bool:
    return load_library() is not None


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _channels(v, c: int) -> np.ndarray:
    return np.ascontiguousarray(np.broadcast_to(np.asarray(v, np.float32),
                                                (c,)))


def _labels(labels, n: int) -> np.ndarray:
    """1-based labels as int64, one per sample (the C side reads n)."""
    labels = np.ascontiguousarray(labels, np.int64).reshape(-1)
    if len(labels) != n:
        raise ValueError(f"{len(labels)} labels for {n} samples")
    return labels


class HostStagingRing:
    """Reusable host staging buffers for the decode -> device handoff.

    ``pf_next`` copies each finished batch into a slot (pinned host
    tensors when the target is a card) and that memory goes straight to
    the device with one ``non_blocking`` copy on the current stream. Each slot records a CUDA
    event after its copy and :meth:`acquire` waits on that event before
    the slot is refilled: without the wait the workers would overwrite
    pinned memory the copy is still reading. With ``slots >
    queue_capacity`` the copy has almost always landed by then. On the CPU
    (``device="cpu"``) :meth:`to_device` clones the slot."""

    def __init__(self, x_shape, x_dtype, y_shape, y_dtype, slots: int = 3,
                 device=None):
        self._dev = resolve_device(device)
        pin = self._dev.type == "cuda"
        self._slots = max(2, int(slots))
        self._bufs = [(torch.empty(x_shape, dtype=x_dtype, pin_memory=pin),
                       torch.empty(y_shape, dtype=y_dtype, pin_memory=pin))
                      for _ in range(self._slots)]
        self._copied = [None] * self._slots      # CUDA event per slot
        self._i = 0

    def acquire(self):
        """Next (x, y) host buffers to decode into."""
        self._i = (self._i + 1) % self._slots
        ev = self._copied[self._i]
        if ev is not None:
            # sync-ok: reuse fence - the copy issued slots - 1 batches ago
            # has already landed in the steady state
            ev.synchronize()
            self._copied[self._i] = None
        return self._bufs[self._i]

    def to_device(self, x_view, y_view):
        """The filled views on the device: non-blocking copies from the
        pinned slot, fenced by the slot's event (a clone on the CPU)."""
        if self._dev.type != "cuda":
            return x_view.clone(), y_view.clone()
        xd = x_view.to(self._dev, non_blocking=True)
        yd = y_view.to(self._dev, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self._copied[self._i] = ev
        return xd, yd


class NativePrefetcher:
    """Threaded native decode+normalize pipeline producing float CHW batches.

    Usable as a dataset for the optimizers: ``data(train)`` yields MiniBatch
    with inputs shaped (B, C, H, W) (torch tensors) and 1-based float
    labels, in the order of the epoch's permutation (``train=False``: the
    data set's order) whatever ``n_workers`` is.

    ``stage_to_device=True`` stages each decoded batch through a
    :class:`HostStagingRing` onto ``device`` (the CUDA device by default,
    which raises without one): the yielded MiniBatches hold device
    tensors and the optimizer's placement is a no-op."""

    _out_format = 0  # 0 = f32 CHW; 1 = bf16 NHWC (JpegFolderPrefetcher)

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 mean, std, batch_size: int = 32, n_workers: int = 4,
                 queue_capacity: int = 4, seed: int = 1,
                 stage_to_device: bool = False, device=None):
        """images: uint8 (N, C, H, W); labels: 1-based int."""
        self.lib = load_library()
        if self.lib is None:
            raise RuntimeError("native library unavailable (no g++?)")
        images = np.ascontiguousarray(images, np.uint8)
        if images.ndim == 3:
            images = images[:, None]
        n, c, h, w = images.shape
        labels = _labels(labels, n)
        mean, std = _channels(mean, c), _channels(std, c)
        self.handle = self.lib.pf_create_raw(
            _u8(images), labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, c, h, w, _f32(mean), _f32(std))
        if not self.handle:
            raise RuntimeError("pf_create_raw failed")
        self._setup(n, c, h, w, batch_size, n_workers, queue_capacity, seed,
                    stage_to_device, device)

    def _setup(self, n, c, h, w, batch_size, n_workers, queue_capacity, seed,
               stage_to_device, device):
        self.n, self.c, self.h, self.w = n, c, h, w
        self.batch_size = batch_size
        self.n_workers = n_workers
        self.queue_capacity = queue_capacity
        self._rng = np.random.RandomState(seed)
        self._epoch_open = False
        self._stage_to_device = stage_to_device
        self._device = resolve_device(device) if stage_to_device else None

    # dataset protocol ---------------------------------------------------
    def size(self):
        return self.n

    def shuffle(self):
        return self

    def batches_per_epoch(self):
        return self.n // self.batch_size

    def data(self, train: bool = True, loop_epochs: int = 1):
        """Yield MiniBatches for ``loop_epochs`` epochs (freshly permuted
        each) as ONE worker run: with loop_epochs > 1 the decode threads
        never join/respawn between epochs, so there is no queue-refill
        stall at epoch boundaries."""
        from ..dataset.minibatch import MiniBatch
        if self._epoch_open:
            self.lib.pf_end_epoch(self.handle)
        loop_epochs = max(1, loop_epochs)
        if self.n * loop_epochs > 1 << 26:
            # the looped order is materialised host-side (int32 per sample
            # per epoch); cap it rather than silently eating GBs or
            # overflowing pf_start_epoch's int length at 2^31
            raise ValueError(
                f"loop_epochs={loop_epochs} over {self.n} samples needs a "
                f"{self.n * loop_epochs * 4 / 1e6:.0f} MB index array; "
                "keep n*loop_epochs <= 64M and restart data() instead")
        # looped mode drops each epoch's partial batch (drop-remainder):
        # the C++ workers chunk the whole order by batch_size, so without
        # the trim a batch could span the epoch boundary and contain the
        # same sample twice from two independent permutations
        per = (self.n if loop_epochs == 1
               else self.n - self.n % self.batch_size)
        if train:
            order = np.concatenate([self._rng.permutation(self.n)[:per]
                                    for _ in range(loop_epochs)])
        else:
            order = np.tile(np.arange(self.n)[:per], loop_epochs)
        order = np.ascontiguousarray(order.astype(np.int32))
        self.lib.pf_start_epoch(
            self.handle, order.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            len(order), self.batch_size, self.n_workers,
            self.queue_capacity)
        self._epoch_open = True
        if self._out_format == 1:
            x_shape, x_dtype = ((self.batch_size, self.h, self.w, 3),
                                torch.bfloat16)
        else:
            x_shape, x_dtype = ((self.batch_size, self.c, self.h, self.w),
                                torch.float32)
        from .. import observability as obs
        if obs.enabled():
            obs.gauge("dataset/queue_capacity").set(self.queue_capacity)
        ring = None
        if self._stage_to_device:
            # slots > queue_capacity: by the time a slot cycles back, its
            # copy left the bounded native window long ago
            ring = HostStagingRing(x_shape, x_dtype, (self.batch_size,),
                                   torch.float32,
                                   slots=self.queue_capacity + 2,
                                   device=self._device)
        while True:
            if ring is not None:
                x, y = ring.acquire()
            else:
                x = torch.empty(x_shape, dtype=x_dtype)
                y = torch.empty((self.batch_size,), dtype=torch.float32)
            # stamped unconditionally: one clock read per batch is noise
            # next to a jpeg decode, and a mid-block obs.enable() must
            # never pair a real end time with a zero start
            t_wait = time.perf_counter()
            got = self.lib.pf_next(self.handle, x.data_ptr(), y.data_ptr())
            if obs.enabled():
                # time blocked in pf_next ~ queue starvation: near-zero
                # means the decode window stayed full (compute-bound);
                # large means it ran dry (input-bound)
                obs.histogram("dataset/native_next_wait_s", unit="s") \
                    .observe(time.perf_counter() - t_wait)
            if got == 0:
                self._epoch_open = False
                failed = self.decode_failures
                if failed:
                    import logging
                    logging.getLogger(__name__).warning(
                        "%d samples failed to decode so far (substituted "
                        "with zero images)", failed)
                return
            if ring is not None:
                yield MiniBatch(*ring.to_device(x[:got], y[:got]))
            else:
                yield MiniBatch(x[:got], y[:got])

    @property
    def decode_failures(self) -> int:
        """Total undecodable samples substituted with zero images."""
        return int(self.lib.pf_decode_failures(self.handle))

    def transform(self, transformer):
        raise NotImplementedError(
            "NativePrefetcher bakes normalization in; compose python-side "
            "transforms before constructing it")

    def __del__(self):
        if getattr(self, "handle", None) and getattr(self, "lib", None):
            self.lib.pf_destroy(self.handle)


def jpeg_available() -> bool:
    lib = load_library()
    return bool(lib and lib.jd_available())


def _jpeg_lib():
    lib = load_library()
    if lib is None or not lib.jd_available():
        raise RuntimeError("native JPEG codec unavailable (the library was "
                           "built without libjpeg)")
    return lib


def _read(data) -> np.ndarray:
    if isinstance(data, str):
        with open(data, "rb") as f:
            data = f.read()
    return np.frombuffer(data, np.uint8)


def decode_jpeg(data) -> np.ndarray:
    """Native JPEG decode -> (H, W, C) uint8 (C is 3 or 1). Accepts bytes or
    a file path."""
    lib = _jpeg_lib()
    buf = _read(data)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.jd_info(_u8(buf), len(buf), ctypes.byref(w), ctypes.byref(h),
                   ctypes.byref(c)) != 0:
        raise ValueError("not a decodable JPEG")
    out = np.empty((h.value, w.value, c.value), np.uint8)
    if lib.jd_decode(_u8(buf), len(buf), _u8(out)) < 0:
        raise ValueError("JPEG decode failed")
    return out


def encode_jpeg(img: np.ndarray, quality: int = 90) -> bytes:
    """Native JPEG encode: (H, W, 3) RGB or (H, W)/(H, W, 1) gray uint8 ->
    JPEG bytes, so data sets and checks can write real JPEG files with no
    Python imaging dependency."""
    lib = _jpeg_lib()
    img = np.ascontiguousarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (1, 3):
        raise ValueError(
            f"want uint8 HWC with 1 or 3 channels, got {img.dtype} "
            f"{img.shape}")
    h, w, c = img.shape
    cap = h * w * c + (1 << 16)
    out = np.empty((cap,), np.uint8)
    n = lib.je_encode(_u8(img), w, h, c, int(quality), _u8(out), cap)
    if n < 0:
        raise ValueError("JPEG encode failed")
    return out[:n].tobytes()


def decode_jpeg_resize_norm(data, height: int, width: int, mean,
                            std) -> np.ndarray:
    """Native decode + bilinear resize + normalize -> (3, height, width)
    float32."""
    lib = _jpeg_lib()
    buf = _read(data)
    mean, std = _channels(mean, 3), _channels(std, 3)
    out = np.empty((3, height, width), np.float32)
    if lib.jd_decode_resize_chw(_u8(buf), len(buf), height, width,
                                _f32(mean), _f32(std), _f32(out)) < 0:
        raise ValueError("JPEG decode failed")
    return out


class JpegFolderPrefetcher(NativePrefetcher):
    """Threaded native JPEG pipeline: paths -> decode -> bilinear resize ->
    normalized batches (the reference's ImageNet executor-side decode
    path)."""

    def __init__(self, paths, labels, height: int, width: int, mean, std,
                 batch_size: int = 32, n_workers: int = 4,
                 queue_capacity: int = 4, seed: int = 1,
                 out: str = "f32_chw", augment: bool = False,
                 stage_to_device: bool = False, device=None):
        """``out="bf16_nhwc"`` makes the decode workers emit device-ready
        batches: normalized bfloat16 in NHWC, so the host path is decode ->
        copy with no float32 -> bf16 cast, no transpose, and half the
        host -> device bytes.

        ``augment=True`` runs Inception-style RandomResizedCrop (area
        U(0.08, 1), aspect exp(U(+-log 4/3)), center-square fallback) +
        p=0.5 horizontal flip ON the decode workers, deterministic per
        (seed, epoch position). Build a separate augment=False instance
        for evaluation."""
        self.lib = _jpeg_lib()
        if out not in ("f32_chw", "bf16_nhwc"):
            raise ValueError(f"out={out!r}: expected f32_chw | bf16_nhwc")
        n = len(paths)
        labels = _labels(labels, n)
        mean, std = _channels(mean, 3), _channels(std, 3)
        arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
        self.handle = self.lib.pf_create_jpeg(
            arr, labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
            height, width, _f32(mean), _f32(std))
        if not self.handle:
            raise RuntimeError("pf_create_jpeg failed")
        self._setup(n, 3, height, width, batch_size, n_workers,
                    queue_capacity, seed, stage_to_device, device)
        self._out_format = 1 if out == "bf16_nhwc" else 0
        if self.lib.pf_set_format(self.handle, self._out_format) != 0:
            raise RuntimeError(f"pf_set_format({out}) rejected")
        if self.lib.pf_set_augment(self.handle, 1 if augment else 0,
                                   seed) != 0:
            raise RuntimeError("pf_set_augment rejected")


def read_tfrecords_native(path: str, verify_crc: bool = True):
    """Read a whole TFRecord file via the C++ reader. Returns a list of
    ``bytes``; raises IOError on corrupt/truncated files. None if the
    native library is unavailable (the caller falls back to the pure-python
    reader in dataset/tfrecord.py)."""
    lib = load_library()
    if lib is None:
        return None
    # surface the same typed errors (FileNotFoundError/PermissionError with
    # errno) the pure-python open() path raises
    open(path, "rb").close()
    h = lib.tfr_open(os.fsencode(path), 1 if verify_crc else 0)
    if not h:
        raise IOError(f"cannot open {path}")
    try:
        err = lib.tfr_error(h).decode()
        if err:
            raise IOError(f"{path}: {err}")
        return [ctypes.string_at(lib.tfr_record_data(h, i),
                                 lib.tfr_record_len(h, i))
                for i in range(lib.tfr_count(h))]
    finally:
        lib.tfr_close(h)
