"""The detection heads of the port against the JAX package on the CPU: the
box utilities at 1e-5 (``generate_basic_anchors`` / ``Anchor`` exactly),
greedy NMS (``nms_mask``, ``Nms``) index for index - tied scores keep
JAX's stable order, ``eta`` < 1 shrinks the threshold as JAX's loop does,
``topk``, score thresholds, ``valid`` and ``sorted_input`` - ``PriorBox``,
``Proposal``, ``DetectionOutputSSD``, ``DetectionOutputFrcnn`` (with and
without box voting) and ``bbox_vote`` (the same detections, values at
1e-5), and ``RoiAlign`` / ``RoiPooling`` (output and gradients at
1e-5)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bigdl_tpu.nn as jnn
from bigdl_tpu.nn import detection as jd
from bigdl_tpu.utils.table import Table as JTable
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.nn import detection as td
from bigdl_tpu_torch.utils.table import Table

from torch_parity_helpers import check_pair

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), **tol)


def _boxes(n, seed, scale=50.0, normalized=False):
    rng = np.random.RandomState(seed)
    xy = rng.rand(n, 2) * scale
    wh = rng.rand(n, 2) * scale / 2 + (0.01 if normalized else 1.0)
    b = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    return b / np.float32(scale * 1.5) if normalized else b


# -- box utilities -------------------------------------------------------------

@pytest.mark.parametrize("normalized", [False, True])
def test_box_utilities_match_jax(normalized):
    a, b = _boxes(12, 0, normalized=normalized), _boxes(9, 1,
                                                      normalized=normalized)
    _close(td.bbox_areas(torch.from_numpy(a), normalized),
           jd.bbox_areas(jnp.asarray(a), normalized))
    _close(td.bbox_iou_matrix(a, b, normalized),
           jd.bbox_iou_matrix(jnp.asarray(a), jnp.asarray(b), normalized))
    rng = np.random.RandomState(2)
    deltas = (0.3 * rng.randn(12, 8)).astype(np.float32)
    _close(td.bbox_transform_inv(a, deltas), jd.bbox_transform_inv(a, deltas))
    scores = rng.rand(12, 2).astype(np.float32)
    for args in ((40.0, 30.0), (np.float32(40.0), np.float32(30.0), 9.0,
                                12.0)):
        want = jd.clip_boxes(jd.bbox_transform_inv(a, deltas), *args,
                             scores=scores if len(args) > 2 else None)
        got = td.clip_boxes(td.bbox_transform_inv(a, deltas), *args,
                            scores=scores if len(args) > 2 else None)
        if len(args) > 2:
            _close(got[0], want[0])
            _close(got[1], want[1])
            assert got[2] == int(want[2])
        else:
            _close(got, want)
    var = np.tile(np.float32([0.1, 0.1, 0.2, 0.2]), (12, 1))
    for enc in (False, True):
        for clip in (False, True):
            _close(td.decode_boxes(a, var, deltas[:, :4], enc, clip),
                   jd.decode_boxes(a, var, deltas[:, :4], enc, clip))
    _close(td.scale_bboxes(a, 0.5, 2.0), jd.scale_bboxes(a, 0.5, 2.0))


def test_anchors_equal_jax():
    np.testing.assert_array_equal(
        td.generate_basic_anchors((0.5, 1, 2), (8, 16, 32)),
        jd.generate_basic_anchors((0.5, 1, 2), (8, 16, 32)))
    ta, ja = td.Anchor((0.5, 1, 2), (8, 16, 32)), jd.Anchor((0.5, 1, 2),
                                                            (8, 16, 32))
    assert ta.anchor_num == ja.anchor_num == 9
    np.testing.assert_array_equal(ta.generate_anchors(5, 3, 16.0),
                                  ja.generate_anchors(5, 3, 16.0))


# -- NMS ------------------------------------------------------------------------

def _nms_inputs(n=60, seed=3, ties=True, normalized=False):
    rng = np.random.RandomState(seed)
    boxes = _boxes(n, seed, scale=30.0, normalized=normalized)
    scores = rng.rand(n).astype(np.float32)
    if ties:       # blocks of equal scores among overlapping boxes
        scores[::3] = scores[0]
        scores[1::7] = 0.5
    return boxes, scores


@pytest.mark.parametrize("kw", [
    dict(iou_thresh=0.3),
    dict(iou_thresh=0.5, topk=25),
    dict(iou_thresh=0.7, eta=0.9),
    dict(iou_thresh=0.45, score_thresh=0.3, eta=0.8, normalized=True),
    dict(iou_thresh=0.4, sorted_input=True),
    dict(iou_thresh=0.5, valid="half"),
], ids=["plain", "topk", "eta", "fast_normalized", "sorted", "valid"])
def test_nms_mask_matches_jax_index_for_index(kw):
    kw = dict(kw)
    boxes, scores = _nms_inputs(normalized=kw.get("normalized", False))
    if kw.get("valid") == "half":
        kw["valid"] = np.arange(60) % 2 == 0
    jo, jk = jd.nms_mask(boxes, scores, **kw)
    to, tk = td.nms_mask(boxes, scores, **kw)
    assert to.dtype == torch.int32 and tk.dtype == torch.bool
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert 0 < tk.sum() < len(tk)


def test_nms_ties_keep_the_input_order_and_eta_shrinks_the_threshold():
    # four identical boxes with one score: the first index wins
    b = np.tile(np.float32([[0, 0, 10, 10]]), (4, 1))
    assert td.Nms().nms(np.full(4, 0.5, np.float32), b, 0.5).tolist() == [0]
    # a box whose overlap with the first kept box is over the shrunken
    # threshold only: JAX's eta reading (the threshold at the time of the
    # candidate, for every earlier keep)
    b = np.float32([[0, 0, 10, 10], [20, 0, 30, 10], [0, 0, 10, 6]])
    s = np.float32([0.9, 0.8, 0.7])
    for eta in (1.0, 0.8):
        want = jd.Nms().nms_fast(s, b, 0.75, 0.0, eta=eta, normalized=False)
        got = td.Nms().nms_fast(s, b, 0.75, 0.0, eta=eta, normalized=False)
        np.testing.assert_array_equal(got, want)
    assert len(td.Nms().nms_fast(s, b, 0.75, 0.0, eta=1.0,
                                 normalized=False)) == 3
    assert len(td.Nms().nms_fast(s, b, 0.75, 0.0, eta=0.8,
                                 normalized=False)) == 2
    assert td.Nms().nms(np.zeros(0, np.float32),
                        np.zeros((0, 4), np.float32), 0.5).size == 0


@pytest.mark.parametrize("fast", [False, True])
def test_nms_index_lists_match_jax(fast):
    boxes, scores = _nms_inputs(200, seed=4, normalized=fast)
    if fast:
        want = jd.Nms().nms_fast(scores, boxes, 0.45, 0.2, topk=120, eta=0.9)
        got = td.Nms().nms_fast(scores, boxes, 0.45, 0.2, topk=120, eta=0.9)
    else:
        want = jd.Nms().nms(scores, boxes, 0.3)
        got = td.Nms().nms(scores, boxes, 0.3)
    np.testing.assert_array_equal(got, want)


# -- PriorBox, Proposal ------------------------------------------------------------

def _prior_box(nn, **kw):
    return nn.PriorBox([30.0], [60.0], [2.0, 3.0], is_flip=True,
                       variances=[0.1, 0.1, 0.2, 0.2], img_h=96, img_w=96,
                       **kw)


@pytest.mark.parametrize("kw", [{}, {"is_clip": True, "step": 16.0}])
def test_prior_box_matches_jax(kw):
    feat = np.zeros((1, 8, 6, 5), np.float32)
    want = _prior_box(jnn, **kw).apply({}, {}, jnp.asarray(feat))[0]
    tm = _prior_box(tnn, **kw)
    got = tm.call({}, torch.from_numpy(feat))
    assert tm.num_priors == 6 and got.shape == (1, 2, 6 * 5 * 6 * 4)
    _close(got, want)


@pytest.mark.parametrize("training", [False, True])
def test_proposal_matches_jax(training):
    rng = np.random.RandomState(5)
    A, H, W = 9, 6, 8
    cls = rng.randn(1, 2 * A, H, W).astype(np.float32)
    cls[0, A + 2:A + 5] = cls[0, A]          # tied foreground scores
    deltas = (0.2 * rng.randn(1, 4 * A, H, W)).astype(np.float32)
    info = np.float32([[96, 128, 1.0, 1.0]])
    args = (60, 20, (0.5, 1, 2), (4, 8, 16), 80, 30)
    want, _ = jd.Proposal(*args).apply({}, {}, JTable(cls, deltas, info),
                                       training)
    got, _ = td.Proposal(*args).apply({}, {}, Table(
        torch.from_numpy(cls), torch.from_numpy(deltas),
        torch.from_numpy(info)), training)
    assert got.shape == tuple(np.shape(want)) and got.shape[0] > 5
    _close(got, want)


# -- the post-processors --------------------------------------------------------------

def _ssd_inputs(B=2, classes=5, seed=6):
    rng = np.random.RandomState(seed)
    prior = np.asarray(_prior_box(jnn).apply(
        {}, {}, jnp.zeros((1, 8, 5, 5)))[0])
    n = prior.shape[2] // 4
    loc = (0.5 * rng.randn(B, n * 4)).astype(np.float32)
    conf = (2.0 * rng.randn(B, n * classes)).astype(np.float32)
    return loc, conf, prior


@pytest.mark.parametrize("kw", [
    dict(n_classes=5, nms_topk=40, keep_topk=30, conf_thresh=0.05),
    dict(n_classes=5, bg_label=2, nms_thresh=0.3, keep_topk=-1,
         conf_post_process=False, variance_encoded_in_target=True),
], ids=["topk", "bg2_raw_scores"])
def test_detection_output_ssd_matches_jax(kw):
    loc, conf, prior = _ssd_inputs()
    want, _ = jd.DetectionOutputSSD(**kw).apply({}, {},
                                                JTable(loc, conf, prior))
    tm = td.DetectionOutputSSD(**kw)
    got, _ = tm.apply({}, {}, Table(*map(torch.from_numpy,
                                         (loc, conf, prior))))
    want = np.asarray(want)
    assert got.shape == want.shape and want[0, 0] > 3
    np.testing.assert_array_equal(_np(got)[:, 0], want[:, 0])
    _close(got, want)
    # training mode passes the input through
    x = Table(torch.zeros(1))
    assert tm.apply({}, {}, x, training=True)[0] is x


def _frcnn_inputs(n=40, classes=4, seed=7):
    rng = np.random.RandomState(seed)
    b = _boxes(n, seed, scale=80.0)
    rois = np.concatenate([np.zeros((n, 1), np.float32), b * 1.5], 1)
    deltas = (0.1 * rng.randn(n, 4 * classes)).astype(np.float32)
    scores = rng.rand(n, classes).astype(np.float32)
    scores[:, 2] *= 0.05              # a class under the threshold
    info = np.float32([[100, 120, 1.5, 1.5]])
    return info, rois, deltas, scores


@pytest.mark.parametrize("vote,max_per", [(False, 100), (True, 100),
                                          (False, 6)],
                         ids=["plain", "bbox_vote", "max_per_image"])
def test_detection_output_frcnn_matches_jax(vote, max_per):
    x = _frcnn_inputs()
    kw = dict(nms_thresh=0.3, n_classes=4, bbox_vote=vote,
              max_per_image=max_per, thresh=0.05)
    want, _ = jd.DetectionOutputFrcnn(**kw).apply({}, {}, JTable(*x))
    got, _ = td.DetectionOutputFrcnn(**kw).apply(
        {}, {}, Table(*map(torch.from_numpy, x)))
    want = np.asarray(want)
    assert got.shape == want.shape and want[0, 0] > 2
    _close(got, want)


def test_bbox_vote_matches_jax():
    b = _boxes(30, 8)
    s = np.random.RandomState(9).rand(30).astype(np.float32)
    js, jb = jd.bbox_vote(s[:5], b[:5], s, b)
    ts, tb = td.bbox_vote(s[:5], b[:5], s, b)
    np.testing.assert_array_equal(ts, js)
    _close(tb, jb)


# -- RoiAlign, RoiPooling -----------------------------------------------------------------

def _rois(R=7, seed=10):
    rng = np.random.RandomState(seed)
    xy = rng.rand(R, 2) * 60
    wh = rng.rand(R, 2) * 40 + 2
    r = np.concatenate([rng.randint(0, 2, (R, 1)), xy, xy + wh],
                       1).astype(np.float32)
    r[0, 1:] = [70, 70, 90, 95]        # partly outside the map
    return r


@pytest.mark.parametrize("mode,sr", [("avg", 2), ("max", 1), ("avg", 3)])
def test_roi_align_matches_jax(mode, sr):
    feats = np.random.RandomState(11).randn(2, 3, 9, 11).astype(np.float32)
    check_pair(jnn.RoiAlign(3, 2, 1 / 8.0, sr, mode),
               tnn.RoiAlign(3, 2, 1 / 8.0, sr, mode), [feats, _rois()],
               False, jit=True)


@pytest.mark.parametrize("pooled,scale", [((2, 2), 1 / 8.0), ((3, 4), 0.25)])
def test_roi_pooling_matches_jax(pooled, scale):
    feats = np.random.RandomState(12).randn(2, 3, 9, 11).astype(np.float32)
    rois = _rois(40)                  # more rois than one 32-roi chunk
    out = check_pair(jnn.RoiPooling(*pooled, scale),
                     tnn.RoiPooling(*pooled, scale), [feats, rois], False,
                     jit=True)
    assert out.shape == (40, 3, pooled[1], pooled[0])
    assert not out[0].any() or scale == 0.25     # the bins off the map
