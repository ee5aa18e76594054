"""COCO-style segmentation masks, polygon and RLE (counterpart of
``bigdl_tpu/dataset/segmentation.py``): the COCO mask API's column-major
RLE, its compressed character encoding, polygon rasterization, and area /
bbox / merge / IoU. Host numpy, the port's own copy (masks are data
pipeline objects; they reach the device as dense tensors).

RLE convention (pycocotools-compatible):
- counts alternate runs of 0s and 1s, starting with 0s, over the mask
  flattened in **column-major** (Fortran) order;
- the compressed string encodes each count in 5-bit groups (LSB first) with
  a continuation bit, offset by 48 into printable ASCII; counts from the
  third onward are delta-coded against the count two positions back.
"""
from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np

__all__ = ["RLEMasks", "PolyMasks", "rle_encode", "rle_decode", "rle_area",
           "rle_to_bbox", "rle_merge", "rle_iou", "rle_to_string",
           "rle_from_string", "rasterize_polygon"]


class RLEMasks:
    """A batch of RLE-encoded masks of a common (height, width)."""

    def __init__(self, counts: Sequence[Sequence[int]], height: int,
                 width: int):
        self.counts = [list(map(int, c)) for c in counts]
        self.height, self.width = int(height), int(width)

    def __len__(self):
        return len(self.counts)

    def decode(self) -> np.ndarray:
        """→ (N, H, W) uint8 dense masks."""
        return np.stack([rle_decode(c, self.height, self.width)
                         for c in self.counts]) if self.counts else \
            np.zeros((0, self.height, self.width), np.uint8)

    def area(self) -> np.ndarray:
        return np.array([sum(c[1::2]) for c in self.counts], np.int64)

    def bbox(self) -> np.ndarray:
        return np.stack([rle_to_bbox(c, self.height, self.width)
                         for c in self.counts]) if self.counts else \
            np.zeros((0, 4), np.float32)

    def to_strings(self) -> List[str]:
        return [rle_to_string(c) for c in self.counts]

    @classmethod
    def from_strings(cls, strings: Sequence[str], height: int, width: int):
        return cls([rle_from_string(s) for s in strings], height, width)


class PolyMasks:
    """A batch of polygon masks; each mask is a list of rings, each ring a
    flat [x0, y0, x1, y1, ...] sequence (COCO polygon format)."""

    def __init__(self, polys: Sequence[Sequence[Sequence[float]]],
                 height: int, width: int):
        self.polys = [[np.asarray(r, np.float64) for r in p] for p in polys]
        self.height, self.width = int(height), int(width)

    def __len__(self):
        return len(self.polys)

    def _dense(self) -> List[np.ndarray]:
        out = []
        for rings in self.polys:
            mask = np.zeros((self.height, self.width), np.uint8)
            for ring in rings:
                mask |= rasterize_polygon(ring, self.height, self.width)
            out.append(mask)
        return out

    def to_rle(self) -> RLEMasks:
        return RLEMasks([rle_encode(m) for m in self._dense()],
                        self.height, self.width)

    def decode(self) -> np.ndarray:
        dense = self._dense()
        return np.stack(dense) if dense else \
            np.zeros((0, self.height, self.width), np.uint8)


# ---------------------------------------------------------------------------
# RLE primitives
# ---------------------------------------------------------------------------


def rle_encode(mask: np.ndarray) -> List[int]:
    """Dense (H, W) {0,1} mask → counts (column-major runs, 0s first)."""
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    if flat.size == 0:
        return []
    change = np.nonzero(np.diff(flat))[0] + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    runs = np.diff(bounds).tolist()
    if flat[0] == 1:  # counts start with a (possibly zero) run of 0s
        runs = [0] + runs
    return [int(r) for r in runs]


def rle_decode(counts: Sequence[int], height: int, width: int) -> np.ndarray:
    """counts → dense (H, W) uint8 mask."""
    flat = np.zeros(height * width, np.uint8)
    pos, val = 0, 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape(width, height).T  # column-major


def rle_area(counts: Sequence[int]) -> int:
    return int(sum(counts[1::2]))


def rle_to_bbox(counts: Sequence[int], height: int, width: int) -> np.ndarray:
    """→ [x, y, w, h] (COCO xywh). Zero mask → zeros."""
    xs, ys = [], []
    pos, val = 0, 0
    for c in counts:
        if val and c > 0:
            start, end = pos, pos + c - 1
            x0, x1 = start // height, end // height
            xs += [x0, x1]
            if x0 == x1:
                ys += [start % height, end % height]
            else:
                ys += [0, height - 1]
        pos += c
        val ^= 1
    if not xs:
        return np.zeros(4, np.float32)
    x0, x1, y0, y1 = min(xs), max(xs), min(ys), max(ys)
    return np.array([x0, y0, x1 - x0 + 1, y1 - y0 + 1], np.float32)


def rle_merge(rles: Sequence[Sequence[int]], height: int, width: int,
              intersect: bool = False) -> List[int]:
    masks = [rle_decode(c, height, width).astype(bool) for c in rles]
    out = masks[0]
    for m in masks[1:]:
        out = (out & m) if intersect else (out | m)
    return rle_encode(out.astype(np.uint8))


def rle_iou(a: Sequence[int], b: Sequence[int], height: int,
            width: int) -> float:
    ma = rle_decode(a, height, width).astype(bool)
    mb = rle_decode(b, height, width).astype(bool)
    union = np.count_nonzero(ma | mb)
    return float(np.count_nonzero(ma & mb)) / union if union else 0.0


# ---------------------------------------------------------------------------
# Compressed string form (pycocotools charcode)
# ---------------------------------------------------------------------------


def rle_to_string(counts: Sequence[int]) -> str:
    """counts → compressed ASCII string (delta-coded from the 3rd count)."""
    out = []
    for i, c in enumerate(counts):
        x = int(c)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5
            # sign-aware termination: stop when remaining bits are pure sign
            more = (x != -1) if (ch & 0x10) else (x != 0)
            if more:
                ch |= 0x20
            out.append(chr(ch + 48))
    return "".join(out)


def rle_from_string(s: str) -> List[int]:
    counts: List[int] = []
    i = 0
    while i < len(s):
        x, k = 0, 0
        while True:
            ch = ord(s[i]) - 48
            x |= (ch & 0x1F) << (5 * k)
            i += 1
            if not (ch & 0x20):
                if ch & 0x10:  # sign-extend
                    x |= -1 << (5 * (k + 1))
                break
            k += 1
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


# ---------------------------------------------------------------------------
# Polygon rasterization
# ---------------------------------------------------------------------------


def rasterize_polygon(ring: np.ndarray, height: int,
                      width: int) -> np.ndarray:
    """Flat [x0, y0, x1, y1, ...] ring → (H, W) uint8 mask.

    Even-odd crossing test at pixel centers (x+0.5, y+0.5), vectorized over
    the whole grid. Matches COCO's rasterization to within boundary-pixel
    rounding (COCO upsamples 5x and fills the outline; interiors agree).
    """
    pts = np.asarray(ring, np.float64).reshape(-1, 2)
    if len(pts) < 3:
        return np.zeros((height, width), np.uint8)
    px, py = pts[:, 0], pts[:, 1]
    qx, qy = np.roll(px, -1), np.roll(py, -1)
    cy = np.arange(height, dtype=np.float64) + 0.5
    # (H, E) — which edges straddle each pixel-center row, and where
    straddle = (py[None, :] <= cy[:, None]) != (qy[None, :] <= cy[:, None])
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (cy[:, None] - py[None, :]) / (qy - py)[None, :]
        xint = px[None, :] + t * (qx - px)[None, :]
    mask = np.zeros((height, width), np.uint8)
    for y in range(height):
        xs = np.sort(xint[y, straddle[y]])
        if xs.size == 0:
            continue
        # even-odd fill: pixel center x+0.5 inside ⇔ odd #crossings left of it
        lo = np.ceil(xs[0::2] - 0.5).astype(np.int64)
        hi = np.ceil(xs[1::2] - 0.5).astype(np.int64)
        for a, b in zip(lo, hi):
            mask[y, max(a, 0):min(b, width)] = 1
    return mask
