"""Object-detection heads (counterpart of ``bigdl_tpu/nn/detection.py``: the
reference's ``nn/Anchor.scala``, ``nn/Nms.scala``, ``nn/PriorBox.scala``,
``nn/Proposal.scala``, ``nn/DetectionOutputSSD.scala``,
``nn/DetectionOutputFrcnn.scala`` and ``BboxUtil.scala``), with
``RoiAlign``.

The box math (areas, IoU, regression, decoding, clipping) is vectorised
torch on ``(N, 4)`` float32 tensors, on the device of its input. Greedy
NMS orders its candidates on the device by a stable sort (tied scores keep
their input order, as in JAX), builds the pairwise IoU there, reads it
back once per call and scans the candidates on the host: one transfer and
no launch per candidate, where JAX runs the scan as a device loop. With a
fixed threshold (``eta`` = 1) the transfer is the IoU > threshold mask;
with ``eta`` < 1 the threshold shrinks as boxes are kept, so the scan
needs the IoU values themselves. The post-processors give the reference's
packed ``(batch, 1 + maxDet * 6)`` layout; SSD's class softmax runs on the
host in numpy, as the JAX package computes it.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from .module import Module

__all__ = ["bbox_areas", "bbox_iou_matrix", "bbox_transform_inv",
           "clip_boxes", "decode_boxes", "scale_bboxes",
           "generate_basic_anchors", "Anchor", "nms_mask", "Nms", "PriorBox",
           "Proposal", "DetectionOutputSSD", "bbox_vote",
           "DetectionOutputFrcnn", "RoiAlign"]


def _f32(x, device=None):
    """x as a float32 tensor (on ``device`` when given)."""
    if torch.is_tensor(x):
        return x.to(dtype=torch.float32, device=device or x.device)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# -- vectorised box utilities (BboxUtil.scala) --------------------------------

def bbox_areas(boxes, normalized: bool = False):
    """Areas of (N, 4) [x1, y1, x2, y2] boxes: the pixel convention
    ``(x2 - x1 + 1)`` of ``Nms.scala getAreas``, or with ``normalized``
    the [0, 1] convention."""
    off = 0.0 if normalized else 1.0
    return (boxes[:, 2] - boxes[:, 0] + off) * (boxes[:, 3] - boxes[:, 1]
                                                + off)


def bbox_iou_matrix(boxes_a, boxes_b, normalized: bool = False):
    """Pairwise IoU of (N, 4) and (M, 4) box sets -> (N, M); leading
    batch dims broadcast."""
    a, b = _f32(boxes_a), _f32(boxes_b)
    off = 0.0 if normalized else 1.0
    ax1, ay1, ax2, ay2 = (a[..., i][..., :, None] for i in range(4))
    bx1, by1, bx2, by2 = (b[..., i][..., None, :] for i in range(4))
    iw = torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1) + off
    ih = torch.minimum(ay2, by2) - torch.maximum(ay1, by1) + off
    inter = torch.clamp(iw, min=0.0) * torch.clamp(ih, min=0.0)
    area_a = ((a[..., 2] - a[..., 0] + off)
              * (a[..., 3] - a[..., 1] + off))[..., :, None]
    area_b = ((b[..., 2] - b[..., 0] + off)
              * (b[..., 3] - b[..., 1] + off))[..., None, :]
    return inter / (area_a + area_b - inter)


def bbox_transform_inv(boxes, deltas):
    """(dx, dy, dw, dh) regression deltas applied to (N, 4) boxes
    (``BboxUtil.bboxTransformInv``: ``+1`` widths, centres at ``x1 +
    w / 2``); deltas (N, 4 A), the result the same shape."""
    deltas = _f32(deltas)
    boxes = _f32(boxes, deltas.device)
    repeat = deltas.shape[1] // 4
    d = deltas.reshape(deltas.shape[0], repeat, 4)
    x1, y1 = boxes[:, 0:1], boxes[:, 1:2]
    w = boxes[:, 2:3] - x1 + 1.0
    h = boxes[:, 3:4] - y1 + 1.0
    ctr_x = d[:, :, 0] * w + x1 + w / 2.0
    ctr_y = d[:, :, 1] * h + y1 + h / 2.0
    half_w = torch.exp(d[:, :, 2]) * w / 2.0
    half_h = torch.exp(d[:, :, 3]) * h / 2.0
    out = torch.stack([ctr_x - half_w, ctr_y - half_h,
                       ctr_x + half_w, ctr_y + half_h], -1)
    return out.reshape(deltas.shape)


def clip_boxes(boxes, height, width, min_h: float = 0.0, min_w: float = 0.0,
               scores=None):
    """Clip (N, 4 A) boxes to [0, width - 1] x [0, height - 1]
    (``BboxUtil.clipBoxes``). With ``scores``: boxes whose clipped width or
    height falls below ``min_w`` / ``min_h`` get score 0, and the result is
    ``(clipped, scores, kept_count)``."""
    boxes = _f32(boxes)
    a = boxes.reshape(boxes.shape[0], -1, 4)
    x = torch.clamp(a[..., 0::2], 0.0, float(width - 1.0))
    y = torch.clamp(a[..., 1::2], 0.0, float(height - 1.0))
    clipped = torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], -1)
    flat = clipped.reshape(boxes.shape)
    if scores is None:
        return flat
    scores = _f32(scores, boxes.device)
    w = clipped[..., 2] - clipped[..., 0] + 1.0
    h = clipped[..., 3] - clipped[..., 1] + 1.0
    ok = ((w >= float(min_w)) & (h >= float(min_h))).reshape(scores.shape)
    return flat, torch.where(ok, scores, 0.0), int(ok.sum())


def decode_boxes(prior_boxes, prior_variances, deltas,
                 variance_encoded_in_target: bool = False,
                 clip: bool = False):
    """SSD box decoding (``BboxUtil.decodeBoxes``), every argument (N, 4)
    (or with leading batch dims); prior widths without the ``+1``."""
    d = _f32(deltas)
    p = _f32(prior_boxes, d.device)
    v = _f32(prior_variances, d.device)
    pw = p[..., 2] - p[..., 0]
    ph = p[..., 3] - p[..., 1]
    pcx = (p[..., 0] + p[..., 2]) / 2.0
    pcy = (p[..., 1] + p[..., 3]) / 2.0
    if variance_encoded_in_target:
        cx = d[..., 0] * pw + pcx
        cy = d[..., 1] * ph + pcy
        w = torch.exp(d[..., 2]) * pw
        h = torch.exp(d[..., 3]) * ph
    else:
        cx = v[..., 0] * d[..., 0] * pw + pcx
        cy = v[..., 1] * d[..., 1] * ph + pcy
        w = torch.exp(v[..., 2] * d[..., 2]) * pw
        h = torch.exp(v[..., 3] * d[..., 3]) * ph
    out = torch.stack([cx - w / 2.0, cy - h / 2.0,
                       cx + w / 2.0, cy + h / 2.0], -1)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out


def scale_bboxes(boxes, height, width):
    """Box coordinates times (width, height, width, height)
    (``BboxUtil.scaleBBox``)."""
    boxes = _f32(boxes)
    s = torch.tensor([float(width), float(height), float(width),
                      float(height)], dtype=torch.float32,
                     device=boxes.device)
    return boxes * s[None, :]


# -- anchors (Anchor.scala) ---------------------------------------------------

def generate_basic_anchors(ratios: Sequence[float], scales: Sequence[float],
                           base_size: float = 16.0) -> np.ndarray:
    """Ratio x scale anchors around a (0, 0, base - 1, base - 1) window
    (``Anchor.generateBasicAnchors``: ratio widths rounded to integers
    before centring, as py-faster-rcnn does); (len(ratios) * len(scales),
    4) numpy."""
    base = np.array([0.0, 0.0, base_size - 1.0, base_size - 1.0], np.float32)

    def info(a):
        w = a[2] - a[0] + 1
        h = a[3] - a[1] + 1
        return w, h, a[0] + 0.5 * (w - 1), a[1] + 0.5 * (h - 1)

    def mk(ws, hs, xc, yc):
        ws, hs = np.asarray(ws, np.float32), np.asarray(hs, np.float32)
        return np.stack([xc - (ws / 2 - 0.5), yc - (hs / 2 - 0.5),
                         xc + (ws / 2 - 0.5), yc + (hs / 2 - 0.5)], axis=1)

    w, h, xc, yc = info(base)
    area = w * h
    ws = np.array([round(math.sqrt(area / r)) for r in ratios], np.float32)
    hs = np.array([round(wi * r) for wi, r in zip(ws, ratios)], np.float32)
    ratio_anchors = mk(ws, hs, xc, yc)
    out = []
    for i in range(ratio_anchors.shape[0]):
        w, h, xc, yc = info(ratio_anchors[i])
        sw = np.array([s * w for s in scales], np.float32)
        sh = np.array([s * h for s in scales], np.float32)
        out.append(mk(sw, sh, xc, yc))
    return np.concatenate(out, axis=0)


class Anchor:
    """A regular grid of multi-scale, multi-aspect anchors
    (``nn/Anchor.scala``)."""

    def __init__(self, ratios: Sequence[float], scales: Sequence[float]):
        self.ratios = list(ratios)
        self.scales = list(scales)
        self.basic_anchors = generate_basic_anchors(ratios, scales)
        self.anchor_num = len(ratios) * len(scales)

    def generate_anchors(self, width: int, height: int,
                         feat_stride: float = 16.0) -> np.ndarray:
        """Every anchor over a height x width map, ordered (y, x, anchor)
        slowest to fastest: (H W A, 4) numpy."""
        sx = np.arange(width, dtype=np.float32) * feat_stride
        sy = np.arange(height, dtype=np.float32) * feat_stride
        shifts = np.stack([np.tile(sx, height), np.repeat(sy, width),
                           np.tile(sx, height), np.repeat(sy, width)],
                          axis=1)
        all_a = self.basic_anchors[None, :, :] + shifts[:, None, :]
        return all_a.reshape(-1, 4).astype(np.float32)


# -- NMS: device IoU, host scan (Nms.scala) -----------------------------------

def _nms_candidates(boxes, scores, valid, score_thresh, topk, normalized,
                    sorted_input):
    """The batched candidate stage on the device: boxes (..., N, 4),
    scores and valid (..., N) -> (order (..., m) int64, live (..., m),
    iou (..., m, m)), the candidates by descending score (stable; invalid
    entries sorted to the back) cut to ``topk``."""
    n = scores.shape[-1]
    v = valid
    if score_thresh > 0:
        v = v & (scores >= score_thresh)
    if sorted_input:
        order = torch.arange(n, device=scores.device).expand(scores.shape)
    else:
        masked = torch.where(v, scores, -math.inf)
        order = torch.argsort(-masked, dim=-1, stable=True)
    if topk and 0 < topk < n:
        order = order[..., :topk]
    bs = torch.gather(boxes, -2, order[..., None].expand(
        order.shape + (4,)))
    return order, torch.gather(v, -1, order), \
        bbox_iou_matrix(bs, bs, normalized)


def _greedy_keep(live, over=None, iou=None, iou_thresh=0.0, eta=1.0):
    """The greedy scan on the host over m candidates in order: candidate i
    is kept when live and no earlier kept one overlaps it by more than the
    threshold; with ``eta`` < 1 the threshold shrinks by ``eta`` after each
    keep while it is above 0.5 (``Nms.nmsFast``), and ``iou`` (m, m)
    float32 is read; otherwise ``over`` (m, m), the IoU > threshold
    mask."""
    m = live.shape[0]
    keep = np.zeros(m, bool)
    if over is not None:
        suppressed = np.zeros(m, bool)
        for i in range(m):
            if live[i] and not suppressed[i]:
                keep[i] = True
                suppressed |= over[i]
        return keep
    thresh, eta = np.float32(iou_thresh), np.float32(eta)
    kept = []
    for i in range(m):
        if live[i] and not (iou[i, kept] > thresh).any():
            keep[i] = True
            kept.append(i)
            if thresh > 0.5:
                thresh = np.float32(thresh * eta)
    return keep


def _nms_host(boxes, scores, valid, iou_thresh, score_thresh=0.0, topk=-1,
              eta=1.0, normalized=False, sorted_input=False):
    """Batched NMS with one device-to-host read: (order (..., m) host
    int32, keep (..., m) host bool)."""
    order, live, iou = _nms_candidates(boxes, scores, valid, score_thresh,
                                       topk, normalized, sorted_input)
    exact = eta < 1.0
    mat = iou if exact else iou > np.float32(iou_thresh)
    order, live, mat = (t.cpu().numpy() for t in (order.to(torch.int32),
                                                  live, mat))
    keep = np.zeros(live.shape, bool)
    for idx in np.ndindex(live.shape[:-1]):
        if exact:
            keep[idx] = _greedy_keep(live[idx], iou=mat[idx],
                                     iou_thresh=iou_thresh, eta=eta)
        else:
            keep[idx] = _greedy_keep(live[idx], over=mat[idx])
    return order, keep


def nms_mask(boxes, scores, iou_thresh: float, score_thresh: float = 0.0,
             topk: int = -1, eta: float = 1.0, normalized: bool = False,
             sorted_input: bool = False, valid=None):
    """Greedy NMS: ``(order, keep)``, ``order`` the score-descending
    candidate indices (the first ``topk`` when ``topk`` > 0, cut before the
    IoU is built) and ``keep[i]`` whether ``boxes[order[i]]`` survives,
    both on the boxes' device (int32, bool). ``valid`` masks live entries.
    Semantics of ``Nms.nms`` (``eta`` 1, no score threshold) and
    ``Nms.nmsFast`` (adaptive ``eta``, score threshold, ``topk``)."""
    scores = _f32(scores)
    boxes = _f32(boxes, scores.device)
    n = scores.shape[0]
    dev = scores.device
    if n == 0:
        return (torch.zeros((0,), dtype=torch.int32, device=dev),
                torch.zeros((0,), dtype=torch.bool, device=dev))
    v = torch.ones((n,), dtype=torch.bool, device=dev) if valid is None \
        else torch.as_tensor(valid, device=dev).bool()
    order, keep = _nms_host(boxes, scores, v, iou_thresh, score_thresh,
                            topk, eta, normalized, sorted_input)
    return (torch.from_numpy(order).to(dev),
            torch.from_numpy(keep).to(dev))


class Nms:
    """Host-facing NMS with the reference's index-list API
    (``nn/Nms.scala``): ``nms`` / ``nms_fast`` return 0-based numpy index
    arrays into the input, kept boxes in descending score order."""

    def nms(self, scores, boxes, thresh: float, sorted_input: bool = False
            ) -> np.ndarray:
        if np.size(_host(scores)) == 0:
            return np.zeros((0,), np.int64)
        order, keep = nms_mask(boxes, scores, float(thresh),
                               sorted_input=sorted_input)
        return _host(order)[_host(keep)]

    def nms_fast(self, scores, boxes, nms_thresh: float, score_thresh: float,
                 topk: int = -1, eta: float = 1.0, normalized: bool = True
                 ) -> np.ndarray:
        if np.size(_host(scores)) == 0:
            return np.zeros((0,), np.int64)
        order, keep = nms_mask(boxes, scores, float(nms_thresh),
                               score_thresh=float(score_thresh),
                               topk=int(topk), eta=float(eta),
                               normalized=normalized)
        return _host(order)[_host(keep)]


# -- PriorBox (PriorBox.scala) ------------------------------------------------

class PriorBox(Module):
    """SSD prior boxes over a feature map (``nn/PriorBox.scala``): output
    (1, 2, layerH * layerW * numPriors * 4), channel 0 the coordinates,
    channel 1 the variances, on the feature's device (cached per map
    size and device)."""

    def __init__(self, min_sizes: Sequence[float],
                 max_sizes: Optional[Sequence[float]] = None,
                 aspect_ratios: Optional[Sequence[float]] = None,
                 is_flip: bool = True, is_clip: bool = False,
                 variances: Optional[Sequence[float]] = None,
                 offset: float = 0.5, img_h: int = 0, img_w: int = 0,
                 img_size: int = 0, step_h: float = 0.0, step_w: float = 0.0,
                 step: float = 0.0, name=None):
        super().__init__(name=name)
        assert min_sizes, "must provide min_sizes"
        self.min_sizes = list(min_sizes)
        self.max_sizes = list(max_sizes) if max_sizes else []
        ars = [1.0]
        for ar in (aspect_ratios or []):
            if not any(abs(ar - a) < 1e-6 for a in ars):
                ars.append(float(ar))
                if is_flip:
                    ars.append(1.0 / ar)
        self.aspect_ratios = ars
        self.num_priors = len(ars) * len(self.min_sizes) + len(self.max_sizes)
        if self.max_sizes:
            assert len(self.max_sizes) == len(self.min_sizes)
        self.is_clip = is_clip
        self.variances = list(variances) if variances is not None else [0.1]
        if len(self.variances) > 1:
            assert len(self.variances) == 4, "must provide exactly 4 variances"
        self.offset = offset
        self.img_h = img_h or img_size
        self.img_w = img_w or img_size
        self.step_h = step_h or step
        self.step_w = step_w or step
        self._cache = {}

    def _priors_for(self, layer_h: int, layer_w: int) -> np.ndarray:
        img_w, img_h = float(self.img_w), float(self.img_h)
        step_w = self.step_w or img_w / layer_w
        step_h = self.step_h or img_h / layer_h
        # per-cell half sizes (P, 2) in pixels: min, [sqrt(min * max)],
        # ratios != 1, per min_size
        halves = []
        for s, mn in enumerate(self.min_sizes):
            m = float(int(mn))
            halves.append((m / 2.0, m / 2.0))
            if self.max_sizes:
                hw = math.sqrt(int(mn) * int(self.max_sizes[s])) / 2.0
                halves.append((hw, hw))
            for ar in self.aspect_ratios:
                if abs(ar - 1.0) < 1e-6:
                    continue
                v = math.sqrt(ar)
                halves.append((m * v / 2.0, m / v / 2.0))
        halves = np.asarray(halves, np.float32)
        cx = (np.arange(layer_w, dtype=np.float32) + self.offset) * step_w
        cy = (np.arange(layer_h, dtype=np.float32) + self.offset) * step_h
        cx = np.tile(cx, layer_h)
        cy = np.repeat(cy, layer_w)
        c = np.stack([cx, cy], axis=1)[:, None, :]
        hwh = halves[None, :, :]
        boxes = np.concatenate([c - hwh, c + hwh], axis=2)
        boxes /= np.array([img_w, img_h, img_w, img_h], np.float32)
        flat = boxes.reshape(-1)
        if self.is_clip:
            flat = np.clip(flat, 0.0, 1.0)
        if len(self.variances) == 1:
            var = np.full_like(flat, self.variances[0])
        else:
            var = np.tile(np.asarray(self.variances, np.float32),
                          flat.shape[0] // 4)
        return np.stack([flat, var], axis=0)[None]

    def call(self, params, x):
        feature = x[1] if not hasattr(x, "shape") else x
        assert self.img_w > 0 and self.img_h > 0, \
            "img_w and img_h must be > 0"
        layer_h, layer_w = int(feature.shape[2]), int(feature.shape[3])
        dev = feature.device if torch.is_tensor(feature) \
            else torch.device("cpu")
        key = (layer_h, layer_w, str(dev))
        if key not in self._cache:
            self._cache[key] = torch.from_numpy(
                self._priors_for(layer_h, layer_w)).to(dev)
        return self._cache[key]


# -- Proposal (Proposal.scala) ------------------------------------------------

class Proposal(Module):
    """RPN proposals (``nn/Proposal.scala``): input Table(cls scores (1,
    2A, H, W), bbox deltas (1, 4A, H, W), im_info (1, 4) [height, width,
    scale_h, scale_w]); output (numKeep, 5) rows [0, x1, y1, x2, y2]."""

    MIN_SIZE = 16.0

    def __init__(self, pre_nms_topn: int, post_nms_topn: int,
                 ratios: Sequence[float], scales: Sequence[float],
                 rpn_pre_nms_topn_train: int = 12000,
                 rpn_post_nms_topn_train: int = 2000, name=None):
        super().__init__(name=name)
        self.pre_nms_topn = pre_nms_topn
        self.post_nms_topn = post_nms_topn
        self.rpn_pre_nms_topn_train = rpn_pre_nms_topn_train
        self.rpn_post_nms_topn_train = rpn_post_nms_topn_train
        self.anchor = Anchor(ratios, scales)

    def apply(self, params, state, x, training: bool = False,
              generator=None):
        cls_score, bbox_pred = _f32(x[1]), _f32(x[2])
        im_info = _host(x[3])
        assert cls_score.shape[0] == 1 and im_info.shape[0] == 1, \
            "only single batch supported (reference Proposal.scala:82)"
        dev = cls_score.device
        a_num = self.anchor.anchor_num
        h, w = int(cls_score.shape[2]), int(cls_score.shape[3])
        # (1, 4A, H, W) -> (H W A, 4) ordered (h, w, a); foreground scores
        # are the second half of the 2A channels
        deltas = bbox_pred.reshape(a_num, 4, h, w).permute(2, 3, 0, 1) \
            .reshape(-1, 4)
        scores = cls_score[0, a_num:].permute(1, 2, 0).reshape(-1)
        anchors = torch.from_numpy(self.anchor.generate_anchors(w, h)).to(dev)
        proposals = bbox_transform_inv(anchors, deltas)
        info = im_info[0]
        proposals, scores, _ = clip_boxes(
            proposals, float(info[0]), float(info[1]),
            float(self.MIN_SIZE * info[2]), float(self.MIN_SIZE * info[3]),
            scores)
        pre_n = self.rpn_pre_nms_topn_train if training else self.pre_nms_topn
        post_n = (self.rpn_post_nms_topn_train if training
                  else self.post_nms_topn)
        order, keep = _nms_host(proposals, scores, scores > 0, 0.7,
                                topk=int(pre_n))
        kept_idx = order[keep]
        if post_n > 0:
            kept_idx = kept_idx[:post_n]
        kept = proposals[torch.from_numpy(kept_idx.astype(np.int64)).to(dev)]
        out = torch.cat([kept.new_zeros((kept.shape[0], 1)), kept], 1)
        return out, state


# -- DetectionOutputSSD (DetectionOutputSSD.scala) -----------------------------

def _softmax_np(x, axis=-1):
    m = np.max(x, axis=axis, keepdims=True)
    e = np.exp(x - m)
    return e / np.sum(e, axis=axis, keepdims=True)


def _packed(results, batch, dev):
    """Per-image lists of (label, score, box) -> the (batch, 1 + maxDet *
    6) packed layout on ``dev``."""
    max_det = max((len(d) for d in results), default=0)
    out = np.zeros((batch, 1 + max_det * 6), np.float32)
    for i, dets in enumerate(results):
        out[i, 0] = len(dets)
        off = 1
        for (c, s, box) in dets:
            out[i, off:off + 6] = [c, s, box[0], box[1], box[2], box[3]]
            off += 6
    return torch.from_numpy(out).to(dev)


class DetectionOutputSSD(Module):
    """SSD post-processing (``nn/DetectionOutputSSD.scala``): input
    Table(loc (B, nPriors * 4), conf (B, nPriors * nClasses), prior (1, 2,
    nPriors * 4)); output (B, 1 + maxDet * 6), per image the detection
    count, then rows [label, score, x1, y1, x2, y2]. The boxes are decoded
    and every class's IoU built on the device in one batch; training mode
    passes the input through."""

    def __init__(self, n_classes: int = 21, share_location: bool = True,
                 bg_label: int = 0, nms_thresh: float = 0.45,
                 nms_topk: int = 400, keep_topk: int = 200,
                 conf_thresh: float = 0.01,
                 variance_encoded_in_target: bool = False,
                 conf_post_process: bool = True, name=None):
        super().__init__(name=name)
        assert share_location, "share_location=False not supported"
        self.n_classes = n_classes
        self.bg_label = bg_label
        self.nms_thresh = nms_thresh
        self.nms_topk = nms_topk
        self.keep_topk = keep_topk
        self.conf_thresh = conf_thresh
        self.variance_encoded_in_target = variance_encoded_in_target
        self.conf_post_process = conf_post_process

    def apply(self, params, state, x, training: bool = False,
              generator=None):
        if training:
            return x, state
        loc = _f32(x[1])
        dev = loc.device
        conf = _host(x[2]).astype(np.float32)
        prior = _f32(x[3], dev)
        batch = loc.shape[0]
        n_priors = prior.shape[2] // 4
        conf = conf.reshape(batch, n_priors, self.n_classes)
        if self.conf_post_process:
            conf = _softmax_np(conf, axis=-1)
        decoded = decode_boxes(prior[0, 0].reshape(n_priors, 4),
                               prior[0, 1].reshape(n_priors, 4),
                               loc.reshape(batch, n_priors, 4),
                               self.variance_encoded_in_target)
        classes = [c for c in range(self.n_classes) if c != self.bg_label]
        scores = torch.from_numpy(np.ascontiguousarray(
            conf[:, :, classes].transpose(0, 2, 1))).to(dev)  # (B, C', N)
        boxes = decoded[:, None].expand(batch, len(classes), n_priors, 4)
        order, keep = _nms_host(
            boxes, scores, torch.ones_like(scores, dtype=torch.bool),
            self.nms_thresh, self.conf_thresh, self.nms_topk,
            normalized=True)
        decoded = _host(decoded)
        results = []
        for i in range(batch):
            dets = []
            for j, c in enumerate(classes):
                for idx in order[i, j][keep[i, j]]:
                    dets.append((c, conf[i, idx, c], decoded[i, idx]))
            if self.keep_topk > -1 and len(dets) > self.keep_topk:
                dets.sort(key=lambda d: -d[1])
                dets = dets[:self.keep_topk]
                dets.sort(key=lambda d: d[0])   # regroup by class
            results.append(dets)
        return _packed(results, batch, dev), state


# -- DetectionOutputFrcnn (DetectionOutputFrcnn.scala) --------------------------

def bbox_vote(scores_nms, bbox_nms, scores_all, bbox_all):
    """Weighted box voting (``BboxUtil.bboxVote``): each kept box becomes
    the score-weighted mean of the candidates overlapping it by IoU >= 0.5
    (numpy in, numpy out; the IoU on the device of ``bbox_all`` when it is
    a tensor)."""
    scores_nms = np.asarray(_host(scores_nms), np.float32)
    bbox_nms_h = np.asarray(_host(bbox_nms), np.float32).copy()
    scores_all = np.asarray(_host(scores_all), np.float32)
    bbox_all_h = np.asarray(_host(bbox_all), np.float32)
    dev = bbox_all.device if torch.is_tensor(bbox_all) else None
    iou = _host(bbox_iou_matrix(_f32(bbox_nms_h, dev), _f32(bbox_all_h, dev)))
    for i in range(bbox_nms_h.shape[0]):
        m = iou[i] >= 0.5
        wsum = scores_all[m].sum()
        if wsum > 0:
            bbox_nms_h[i] = (scores_all[m, None] * bbox_all_h[m]).sum(0) / wsum
    return scores_nms, bbox_nms_h


class DetectionOutputFrcnn(Module):
    """Faster R-CNN post-processing (``nn/DetectionOutputFrcnn.scala``):
    input Table(im_info (1, 4), rois (N, 5), box deltas (N, 4 nClasses),
    scores (N, nClasses)); output (1, 1 + maxDet * 6) rows [label, score,
    x1, y1, x2, y2]. Every class's NMS runs in one batch."""

    def __init__(self, nms_thresh: float = 0.3, n_classes: int = 21,
                 bbox_vote: bool = False, max_per_image: int = 100,
                 thresh: float = 0.05, name=None):
        super().__init__(name=name)
        self.nms_thresh = nms_thresh
        self.n_classes = n_classes
        self.use_bbox_vote = bbox_vote
        self.max_per_image = max_per_image
        self.thresh = thresh

    def apply(self, params, state, x, training: bool = False,
              generator=None):
        if training:
            return x, state
        im_info = _host(x[1]).astype(np.float32)
        rois = _f32(x[2])
        dev = rois.device
        box_deltas = _f32(x[3], dev)
        scores_t = _f32(x[4], dev)
        scores = _host(scores_t)
        # rois back to raw image space
        boxes = scale_bboxes(rois[:, 1:5], 1.0 / im_info[0, 2],
                             1.0 / im_info[0, 3])
        pred = clip_boxes(bbox_transform_inv(boxes, box_deltas),
                          im_info[0, 0] / im_info[0, 2],
                          im_info[0, 1] / im_info[0, 3])
        pred = pred.reshape(pred.shape[0], self.n_classes, 4)
        classes = list(range(1, self.n_classes))
        valid = scores_t[:, 1:] > self.thresh                   # (N, C')
        order, keep = _nms_host(
            pred[:, 1:].transpose(0, 1), scores_t[:, 1:].T, valid.T,
            float(self.nms_thresh))
        pred_h, valid_h = _host(pred), _host(valid)
        per_class = {}
        for j, c in enumerate(classes):
            if not valid_h[:, j].any():
                continue
            kept = order[j][keep[j]]
            s, b = scores[kept, c], pred_h[kept, c]
            if self.use_bbox_vote:
                s, b = bbox_vote(s, b, scores[valid_h[:, j], c],
                                 pred_h[valid_h[:, j], c])
            per_class[c] = (s, b)
        if self.max_per_image > 0:
            all_scores = np.concatenate(
                [s for s, _ in per_class.values()]) if per_class \
                else np.empty(0)
            if all_scores.size > self.max_per_image:
                thresh = np.sort(all_scores)[-self.max_per_image]
                per_class = {c: (s[s >= thresh], b[s >= thresh])
                             for c, (s, b) in per_class.items()}
        dets = [(c, s[j], b[j]) for c in sorted(per_class)
                for s, b in [per_class[c]] for j in range(s.shape[0])]
        return _packed([dets], 1, dev), state


# -- RoiAlign -------------------------------------------------------------------

class RoiAlign(Module):
    """Bilinear ROI align: input Table(features NCHW, rois (R, 5)
    [batchIdx, x1, y1, x2, y2]) -> (R, C, pooled_h, pooled_w), sampling
    ``sampling_ratio``^2 points a bin and averaging (``'avg'``) or taking
    the largest (``'max'``). Differentiable; every roi in one batch of
    gathers."""

    def __init__(self, pooled_w: int, pooled_h: int,
                 spatial_scale: float = 1.0, sampling_ratio: int = 2,
                 mode: str = "avg", name=None):
        super().__init__(name=name)
        self.pooled_w, self.pooled_h = pooled_w, pooled_h
        self.spatial_scale = spatial_scale
        self.sampling_ratio = max(1, sampling_ratio)
        assert mode in ("avg", "max")
        self.mode = mode

    def call(self, params, x):
        feats = x[1]
        rois = _f32(x[2], feats.device)
        B, C, H, W = feats.shape
        R, sr = rois.shape[0], self.sampling_ratio
        ph, pw = self.pooled_h, self.pooled_w
        bi = rois[:, 0].to(torch.int64)
        x1, y1, x2, y2 = (rois[:, i] * self.spatial_scale for i in (1, 2, 3,
                                                                    4))
        rw = torch.clamp(x2 - x1, min=1.0)
        rh = torch.clamp(y2 - y1, min=1.0)
        bin_w, bin_h = rw / pw, rh / ph
        # sample grid: pooled * sr points a dim, centred in the sub-bins
        ar_y = torch.arange(ph * sr, device=feats.device, dtype=torch.float32)
        ar_x = torch.arange(pw * sr, device=feats.device, dtype=torch.float32)
        gy = y1[:, None] + (ar_y + 0.5) * bin_h[:, None] / sr
        gx = x1[:, None] + (ar_x + 0.5) * bin_w[:, None] / sr
        y0 = torch.clamp(torch.floor(gy), 0, H - 1)
        x0 = torch.clamp(torch.floor(gx), 0, W - 1)
        yb = torch.clamp(y0 + 1, 0, H - 1)
        xb = torch.clamp(x0 + 1, 0, W - 1)
        wy = (torch.clamp(gy, 0, H - 1) - y0)[:, None, :, None]
        wx = (torch.clamp(gx, 0, W - 1) - x0)[:, None, None, :]

        def at(ys, xs):          # (R, C, Py, Px)
            v = feats[bi[:, None, None], :, ys.long()[:, :, None],
                      xs.long()[:, None, :]]
            return v.permute(0, 3, 1, 2)

        vals = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, xb) * (1 - wy) * wx
                + at(yb, x0) * wy * (1 - wx) + at(yb, xb) * wy * wx)
        v = vals.reshape(R, C, ph, sr, pw, sr)
        if self.mode == "avg":
            return v.mean(dim=(3, 5))
        return v.amax(dim=(3, 5))
