"""TensorBoard event-file reader without TensorFlow (counterpart of
``bigdl_tpu/visualization/event_reader.py``): scans the TFRecord frames
(CRC-checked) of every event file in a log directory and picks the scalar
summaries of a tag, so a restarted process, or one pointed at another
run's directory, reads the training history back. A corrupt or truncated
tail (a writer killed mid-record) ends the scan of that file at the last
valid record."""
from __future__ import annotations

import os
import struct
from typing import Iterator, List, Tuple

from ..loaders.wire import iter_fields
from .event_writer import _masked_crc

__all__ = ["iter_records", "ScalarCache", "read_scalar"]


def _scan_records(f) -> Iterator[Tuple[bytes, int]]:
    """Yield (payload, end offset) for each valid frame from the file's
    position: u64 length, masked crc32c of it, payload, masked crc32c of
    the payload. A CRC mismatch or a short read stops the scan."""
    while True:
        hdr = f.read(8)
        lcrc = f.read(4)
        if len(hdr) < 8 or len(lcrc) < 4:
            return
        if _masked_crc(hdr) != struct.unpack("<I", lcrc)[0]:
            return
        n = struct.unpack("<Q", hdr)[0]
        data = f.read(n)
        dcrc = f.read(4)
        if len(data) < n or len(dcrc) < 4:
            return
        if _masked_crc(data) != struct.unpack("<I", dcrc)[0]:
            return
        yield data, f.tell()


def iter_records(path: str) -> Iterator[bytes]:
    """The payload of each valid frame in ``path``."""
    with open(path, "rb") as f:
        for data, _ in _scan_records(f):
            yield data


def _event_scalars(record: bytes) -> Tuple[int, float, List]:
    """One Event -> (step, wall time, [(tag, value), ...])."""
    step, wall, vals = 0, 0.0, []
    for f, w, v in iter_fields(record):
        if f == 2 and w == 0:            # Event.step
            step = v
        elif f == 1 and w == 1:          # Event.wall_time
            wall = struct.unpack("<d", v)[0]
        elif f == 5 and w == 2:          # Event.summary
            for f2, w2, v2 in iter_fields(v):
                if f2 == 1 and w2 == 2:              # Summary.value
                    tag, sv = None, None
                    for f3, w3, v3 in iter_fields(v2):
                        if f3 == 1 and w3 == 2:      # Value.tag
                            tag = v3.decode("utf-8")
                        elif f3 == 2 and w3 == 5:    # Value.simple_value
                            sv = struct.unpack("<f", v3)[0]
                    if tag is not None and sv is not None:
                        vals.append((tag, sv))
    return step, wall, vals


class ScalarCache:
    """Incremental scalar reader of one log directory: it keeps each
    file's resume offset and parsed rows and rescans only appended bytes;
    a file that shrank (replaced) is read again from the start."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._files = {}    # path -> [offset, [(wall, step, tag, value)]]

    def _refresh(self):
        try:
            names = sorted(os.listdir(self.log_dir))
        except (FileNotFoundError, NotADirectoryError):
            return
        for name in names:
            if "tfevents" not in name:
                continue
            path = os.path.join(self.log_dir, name)
            offset, rows = self._files.setdefault(path, [0, []])
            try:
                if os.path.getsize(path) < offset:
                    offset, rows = 0, []
                    self._files[path] = [offset, rows]
                if os.path.getsize(path) == offset:
                    continue
                with open(path, "rb") as f:
                    f.seek(offset)
                    for rec, end in _scan_records(f):
                        step, wall, vals = _event_scalars(rec)
                        rows.extend((wall, step, t, v) for t, v in vals)
                        self._files[path][0] = end
            except OSError:
                continue

    def read(self, tag: str) -> List[Tuple[int, float]]:
        self._refresh()
        rows = [(wall, step, v)
                for _, (_, rs) in sorted(self._files.items())
                for wall, step, t, v in rs if t == tag]
        rows.sort(key=lambda r: (r[0], r[1]))
        return [(step, v) for _, step, v in rows]


def read_scalar(log_dir: str, tag: str) -> List[Tuple[int, float]]:
    """Every (step, value) of ``tag`` in the event files of ``log_dir``,
    ordered by (wall time, step). Pollers should hold a
    :class:`ScalarCache`."""
    return ScalarCache(log_dir).read(tag)
