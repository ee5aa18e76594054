"""TensorBoard event-file writer without TensorFlow (counterpart of
``bigdl_tpu/visualization/event_writer.py``): the protobuf wire encoding
of Event / Summary records with scalar and histogram values, framed as
TFRecords with masked crc32c checksums. The bytes are the JAX package's
for the same tag, value, step and wall time, and so is the file name
pattern (``events.out.tfevents.<t>.bigdl_tpu<suffix>``), which both
packages' readers scan."""
from __future__ import annotations

import os
import struct
import time

import numpy as np
import torch

__all__ = ["crc32c", "encode_scalar_summary", "encode_histogram_summary",
           "encode_event", "encode_file_version", "EventWriter"]

# -- crc32c (software, table-driven) ------------------------------------------
_CRC_TABLE = []


def _make_table():
    poly = 0x82F63B78
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_make_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    """TFRecord masking: rotate right by 15, then add 0xa282ead8 (without
    the delta TensorBoard rejects the file)."""
    crc = crc32c(data)
    rot = ((crc >> 15) | (crc << 17)) & 0xFFFFFFFF
    return (rot + 0xA282EAD8) & 0xFFFFFFFF


# -- minimal protobuf encoding ------------------------------------------------
def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            out += bytes([b])
            return out


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _f_double(num: int, v: float) -> bytes:
    return _field(num, 1) + struct.pack("<d", v)


def _f_float(num: int, v: float) -> bytes:
    return _field(num, 5) + struct.pack("<f", v)


def _f_int64(num: int, v: int) -> bytes:
    return _field(num, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _f_bytes(num: int, v: bytes) -> bytes:
    return _field(num, 2) + _varint(len(v)) + v


def _f_string(num: int, v: str) -> bytes:
    return _f_bytes(num, v.encode("utf-8"))


def _f_packed_double(num: int, vals) -> bytes:
    return _f_bytes(num, b"".join(struct.pack("<d", float(v)) for v in vals))


def encode_scalar_summary(tag: str, value: float) -> bytes:
    val = _f_string(1, tag) + _f_float(2, float(value))
    return _f_bytes(1, val)     # Summary.value


def _host(values) -> np.ndarray:
    """A tensor (on any device) or an array as host float64: a CUDA
    tensor is copied to the host here, one readback the caller chose by
    asking for the histogram."""
    if isinstance(values, torch.Tensor):
        values = values.detach().to("cpu", torch.float64).numpy()
    return np.asarray(values, np.float64).reshape(-1)


def encode_histogram_summary(tag: str, values) -> bytes:
    v = _host(values)
    if v.size == 0:
        v = np.zeros(1)
    counts, edges = np.histogram(v, bins=30)
    histo = (_f_double(1, float(v.min())) + _f_double(2, float(v.max())) +
             _f_double(3, float(v.size)) + _f_double(4, float(v.sum())) +
             _f_double(5, float(np.sum(v * v))) +
             _f_packed_double(6, edges[1:]) +
             _f_packed_double(7, counts))
    val = _f_string(1, tag) + _f_bytes(5, histo)    # Value.histo = 5
    return _f_bytes(1, val)


def encode_event(step: int, summary_value: bytes,
                 wall_time: float = None) -> bytes:
    wt = time.time() if wall_time is None else wall_time
    return (_f_double(1, wt) + _f_int64(2, step) +
            _f_bytes(5, summary_value))     # Event.summary = 5


def encode_file_version() -> bytes:
    return _f_double(1, time.time()) + _f_string(3, "brain.Event:2")


class EventWriter:
    """An append-only TFRecord event file that TensorBoard reads. Every
    record is flushed when written."""

    def __init__(self, logdir: str, suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.bigdl_tpu{suffix}"
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._write_record(encode_file_version())

    def _write_record(self, data: bytes):
        length = struct.pack("<Q", len(data))
        self._f.write(length)
        self._f.write(struct.pack("<I", _masked_crc(length)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        self._write_record(encode_event(step, encode_scalar_summary(tag,
                                                                    value)))

    def add_histogram(self, tag: str, values, step: int):
        """``values``: an array or a tensor; a CUDA tensor is copied to the
        host (a readback the caller pays)."""
        self._write_record(
            encode_event(step, encode_histogram_summary(tag, values)))

    def close(self):
        self._f.close()
