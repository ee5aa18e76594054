"""Protobuf wire-format primitives (no protoc/protobuf dependency).

Shared by the caffe (.caffemodel), TensorFlow (GraphDef) and bigdl.proto
loaders/serializers. Implements just the wire layer: varints, tagged fields,
length-delimited submessages, packed repeated scalars.

Wire types: 0 varint, 1 64-bit, 2 length-delimited, 5 32-bit.
"""
from __future__ import annotations

import struct
from typing import Iterator, List, Tuple, Union


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift, val = 0, 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def zigzag_decode(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def to_signed(v: int, bits: int = 64) -> int:
    """Interpret an unsigned varint as two's-complement int64/int32."""
    if v >= 1 << (bits - 1):
        v -= 1 << bits
    return v


def iter_fields(buf: bytes) -> Iterator[Tuple[int, int, Union[int, bytes]]]:
    """Yield (field_number, wire_type, value). Length-delimited and fixed
    values come back as bytes; varints as int."""
    i, n = 0, len(buf)
    while i < n:
        key, i = read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, i = read_varint(buf, i)
        elif wire == 1:
            val = buf[i:i + 8]
            i += 8
        elif wire == 2:
            ln, i = read_varint(buf, i)
            val = buf[i:i + ln]
            i += ln
        elif wire == 5:
            val = buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def unpack_packed(buf: bytes, kind: str) -> List:
    """Decode a packed repeated scalar field. kind: 'varint'|'float'|'double'."""
    out: List = []
    if kind == "float":
        return list(struct.unpack(f"<{len(buf) // 4}f", buf))
    if kind == "double":
        return list(struct.unpack(f"<{len(buf) // 8}d", buf))
    i = 0
    while i < len(buf):
        v, i = read_varint(buf, i)
        out.append(v)
    return out


def read_float(val: Union[int, bytes]) -> float:
    return struct.unpack("<f", val)[0]


def read_double(val: Union[int, bytes]) -> float:
    return struct.unpack("<d", val)[0]


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


def write_varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64  # two's-complement int64 like protobuf
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def tag(field: int, wire: int) -> bytes:
    return write_varint((field << 3) | wire)


def field_varint(field: int, v: int) -> bytes:
    return tag(field, 0) + write_varint(v)


def field_bytes(field: int, data: bytes) -> bytes:
    return tag(field, 2) + write_varint(len(data)) + data


def field_string(field: int, s: str) -> bytes:
    return field_bytes(field, s.encode("utf-8"))


def field_float(field: int, f: float) -> bytes:
    return tag(field, 5) + struct.pack("<f", f)


def field_double(field: int, d: float) -> bytes:
    return tag(field, 1) + struct.pack("<d", d)


def field_packed_varint(field: int, vals) -> bytes:
    body = b"".join(write_varint(int(v)) for v in vals)
    return field_bytes(field, body)


def field_packed_float(field: int, vals) -> bytes:
    return field_bytes(field, struct.pack(f"<{len(vals)}f", *vals))


def field_packed_double(field: int, vals) -> bytes:
    return field_bytes(field, struct.pack(f"<{len(vals)}d", *vals))


__all__ = ["read_varint", "zigzag_decode", "to_signed", "iter_fields",
           "unpack_packed", "read_float", "read_double", "write_varint",
           "tag", "field_varint", "field_bytes", "field_string",
           "field_float", "field_double", "field_packed_varint",
           "field_packed_float", "field_packed_double"]
