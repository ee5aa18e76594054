"""TFRecord reader/writer + tf.Example parser (wire-level, no TF dep;
counterpart of ``bigdl_tpu/dataset/tfrecord.py``).

Parity: reference ``nn/tf/ParsingOps.scala`` (ParseExample /
ParseSingleExample) and the TFRecord ingestion the reference's TF Session
feeds through Spark. Framing: each record is
``uint64 length | masked_crc32c(length) | data | masked_crc32c(data)`` —
the same masked-crc scheme the visualization event writer emits.

Example proto (tensorflow/core/example/example.proto):
  Example{1: Features}; Features{1: map<string, Feature>} (repeated map
  entries key=1 value=2); Feature = oneof bytes_list(1) / float_list(2) /
  int64_list(3), each with repeated field 1 (packed or unpacked).
"""
from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..loaders.wire import (field_bytes, field_packed_float,
                            field_packed_varint, field_string, iter_fields,
                            read_float, to_signed, unpack_packed)
from ..visualization.event_writer import _masked_crc

__all__ = ["read_tfrecords", "write_tfrecords", "parse_example",
           "make_example", "load_tfrecord_dataset"]


# ---------------------------------------------------------------------------
# record framing
# ---------------------------------------------------------------------------


def read_tfrecords(path: str, verify_crc: bool = True,
                   use_native: bool = True) -> Iterator[bytes]:
    """Yield raw record payloads from a TFRecord file.

    ``use_native`` routes through the C++ reader (native/prefetcher.cpp
    tfr_* — one file read, table-driven crc32c) when the native library is
    available (``read_tfrecords_native`` returns None without one); the
    pure-python loop below is the behavioral reference.
    Truncated files raise IOError regardless of ``verify_crc`` — a short
    payload must never be yielded as a valid record.

    Error-surfacing contract for corrupt files: the native reader validates
    the WHOLE file before yielding anything (IOError raised eagerly, zero
    records seen), while the streaming python path yields the valid leading
    records and raises at the corruption point. Incremental consumers that
    need the eager behavior should not pass ``use_native=False``; consumers
    that need the lazy prefix should. Files written by pre-round-2 builds
    of this repo used an unmasked rotate-only CRC (missing TFRecord's
    kMaskDelta) — those are detected and reported as such rather than as
    generic corruption."""
    # the native reader materialises the whole file; for big shards keep
    # the O(one record) streaming python path
    _NATIVE_MAX_BYTES = 256 << 20
    if use_native:
        try:
            import os as _os
            small = _os.path.getsize(path) <= _NATIVE_MAX_BYTES
        except OSError:
            small = True  # let the reader raise the typed error itself
        recs = None
        if small:
            from ..native import read_tfrecords_native
            try:
                recs = read_tfrecords_native(path, verify_crc)
            except OSError as e:
                # upgrade the native reader's generic corruption error when
                # the file is actually legacy-framed (pre-round-2 builds)
                legacy = _first_record_is_legacy(path)
                if legacy:
                    raise IOError(legacy) from e
                raise
        if recs is not None:
            yield from recs
            return
    with open(path, "rb") as f:
        while True:
            head = f.read(12)
            if not head:
                return
            if len(head) < 12:
                raise IOError(f"{path}: truncated record header")
            (length,), (len_crc,) = struct.unpack("<Q", head[:8]), \
                struct.unpack("<I", head[8:])
            if verify_crc and _masked_crc(head[:8]) != len_crc:
                raise IOError(_crc_error(path, "length", head[:8], len_crc))
            data = f.read(length)
            crc_bytes = f.read(4)
            if len(data) < length or len(crc_bytes) < 4:
                raise IOError(f"{path}: truncated record payload")
            (data_crc,) = struct.unpack("<I", crc_bytes)
            if verify_crc and _masked_crc(data) != data_crc:
                raise IOError(_crc_error(path, "record", data, data_crc))
            yield data


def _first_record_is_legacy(path: str):
    """If the file's first length-crc matches the legacy rotate-only scheme,
    return the actionable message (else None). Used to upgrade the native
    reader's generic corruption IOError."""
    try:
        with open(path, "rb") as f:
            head = f.read(12)
    except OSError:
        return None
    if len(head) < 12:
        return None
    (found,) = struct.unpack("<I", head[8:])
    msg = _crc_error(path, "length", head[:8], found)
    return msg if "legacy" in msg else None


def _crc_error(path: str, what: str, payload: bytes, found_crc: int) -> str:
    """Distinguish real corruption from the legacy pre-round-2 framing
    (rotate-only CRC, missing TFRecord's kMaskDelta) so old files get an
    actionable message instead of a generic corruption error."""
    from ..visualization.event_writer import crc32c
    crc = crc32c(payload)
    legacy = ((crc >> 15) | (crc << 17)) & 0xFFFFFFFF  # rot15, no delta
    if legacy == found_crc:
        return (f"{path}: {what} crc uses the legacy unmasked scheme of "
                f"pre-round-2 bigdl_tpu builds — rewrite the file with the "
                f"current version (write_tfrecords), or read with "
                f"verify_crc=False")
    return f"{path}: corrupt {what} crc"


def write_tfrecords(path: str, records) -> None:
    """Write raw payloads with TFRecord framing (masked crc32c)."""
    with open(path, "wb") as f:
        for data in records:
            head = struct.pack("<Q", len(data))
            f.write(head)
            f.write(struct.pack("<I", _masked_crc(head)))
            f.write(data)
            f.write(struct.pack("<I", _masked_crc(data)))


# ---------------------------------------------------------------------------
# tf.Example decode
# ---------------------------------------------------------------------------


def _parse_list(buf: bytes, kind: int):
    vals: List = []
    for fnum, wire, val in iter_fields(buf):
        if fnum != 1:
            continue
        if kind == 1:  # bytes_list
            vals.append(val)
        elif wire == 2:  # packed floats/ints (shared wire helpers)
            if kind == 2:
                vals.extend(unpack_packed(val, "float"))
            else:
                vals.extend(to_signed(v)
                            for v in unpack_packed(val, "varint"))
        elif kind == 2:  # unpacked float (wire 5, bytes)
            vals.append(read_float(val))
        else:  # unpacked int64 varint
            vals.append(to_signed(val))
    return vals


def _parse_feature(buf: bytes):
    for fnum, wire, val in iter_fields(buf):
        if fnum in (1, 2, 3):
            inner = val
            # each list is a message with repeated field 1
            vals = _parse_list(inner, fnum)
            if fnum == 1:
                return vals
            dtype = np.float32 if fnum == 2 else np.int64
            return np.asarray(vals, dtype)
    return None


def parse_example(record: bytes) -> Dict[str, object]:
    """Decode one serialized tf.Example → {name: np.ndarray | [bytes]}."""
    out: Dict[str, object] = {}
    for fnum, wire, val in iter_fields(record):
        if fnum != 1:  # Example.features
            continue
        for f2, w2, feats in iter_fields(val):
            if f2 != 1:  # Features.feature map entries
                continue
            key, feature = None, None
            for f3, w3, v3 in iter_fields(feats):
                if f3 == 1:
                    key = v3.decode("utf-8", "replace")
                elif f3 == 2:
                    feature = _parse_feature(v3)
            if key is not None:
                out[key] = feature
    return out


def make_example(features: Dict[str, object]) -> bytes:
    """Encode {name: array | bytes | [bytes]} → serialized tf.Example."""
    entries = b""
    for key, value in features.items():
        if isinstance(value, bytes):
            value = [value]
        if isinstance(value, (list, tuple)) and value and \
                isinstance(value[0], bytes):
            lst = b"".join(field_bytes(1, b) for b in value)
            feat = field_bytes(1, lst)
        else:
            arr = np.asarray(value)
            if np.issubdtype(arr.dtype, np.integer):
                feat = field_bytes(3, field_packed_varint(
                    1, [int(v) for v in arr.reshape(-1)]))
            else:
                feat = field_bytes(2, field_packed_float(
                    1, arr.reshape(-1).astype(np.float32)))
        entry = field_string(1, key) + field_bytes(2, feat)
        entries += field_bytes(1, entry)
    return field_bytes(1, entries)


# ---------------------------------------------------------------------------
# DataSet integration
# ---------------------------------------------------------------------------


def load_tfrecord_dataset(paths, feature_key: str = "features",
                          label_key: str = "label",
                          feature_shape: Optional[tuple] = None):
    """Read tf.Example TFRecords into Samples (ParseExample parity).

    ``feature_shape`` reshapes the flat float list (TFRecord Examples carry
    no shape). Returns a list of :class:`Sample`.
    """
    from .sample import Sample
    if isinstance(paths, str):
        paths = [paths]
    samples = []
    for p in paths:
        for rec in read_tfrecords(p):
            ex = parse_example(rec)
            x = np.asarray(ex[feature_key], np.float32)
            if feature_shape is not None:
                x = x.reshape(feature_shape)
            y = ex.get(label_key)
            if y is not None:
                y = np.asarray(y, np.float32).reshape(-1)
                y = y[0] if y.size == 1 else y
            samples.append(Sample(x, y))
    return samples
