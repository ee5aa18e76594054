"""The port's host-side data modules of the recommender and detection slice
against the JAX package: ``dataset.datamining`` (every schema and factory,
dict / pandas / sequence rows, frames, errors), ``dataset.movielens`` (the
synthetic stand-in and the leave-one-out split equal to JAX's, the
``ratings.dat`` reader) and ``dataset.segmentation`` (RLE encode / decode,
the compressed strings, area / bbox / merge / IoU, polygon rasterization),
all equal value for value."""
import numpy as np
import pandas as pd
import pytest

from bigdl_tpu.dataset import datamining as jdm
from bigdl_tpu.dataset import movielens as jml
from bigdl_tpu.dataset import segmentation as jseg
from bigdl_tpu_torch.dataset import datamining as tdm
from bigdl_tpu_torch.dataset import movielens as tml
from bigdl_tpu_torch.dataset import segmentation as tseg
from bigdl_tpu_torch.utils.table import Table


def _same(got, want):
    """Tables / dicts / arrays equal, key for key."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
        return
    if hasattr(want, "keys") and not isinstance(want, np.ndarray):
        assert isinstance(got, Table)
        assert list(got.keys()) == list(want.keys())
        for k in want.keys():
            _same(got[k], want[k])
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# -- datamining ------------------------------------------------------------------

ROW = {"age": 31, "name": "ann", "member": True, "height": 1.7,
       "vec": [1.0, 2.0]}


@pytest.mark.parametrize("make", [
    lambda m: m.RowTransformer([m.ColToTensor("a", "age"),
                                m.ColToTensor("n", "name"),
                                m.ColToTensor("b", 2),
                                m.ColsToNumeric("num", ["age", "height",
                                                        "vec"])]),
    lambda m: m.RowTransformer.atomic(["age", "member"]),
    lambda m: m.RowTransformer.numeric({"x": ["age", "height"],
                                        "y": ["vec"]}),
    lambda m: m.RowTransformer.atomic_with_numeric(["name"],
                                                   {"z": ["height"]}),
], ids=["schemas", "atomic", "numeric_map", "atomic_with_numeric"])
def test_row_transformer_matches_jax(make):
    rows = [ROW, dict(ROW, age=40, name="bob", member=False, vec=[3, 4])]
    jt, tt = make(jdm), make(tdm)
    for r in rows:
        _same(tt.transform_row(r), jt.transform_row(r))
    for jr, tr in zip(jt(iter(rows)), tt(iter(rows))):
        _same(tr, jr)
    frame = {k: [r[k] for r in rows] for k in ROW}
    _same(tt.transform_frame(frame), jt.transform_frame(frame))


def test_row_transformer_over_pandas_and_sequences():
    df = pd.DataFrame({"a": [1.0, 2.0, 3.0], "b": [4.0, 5.0, 6.0],
                       "c": ["x", "y", "z"]})
    make = lambda m: m.RowTransformer.numeric()
    _same(make(tdm).transform_frame(df[["a", "b"]]),
          make(jdm).transform_frame(df[["a", "b"]]))
    make = lambda m: m.RowTransformer([m.ColsToNumeric("ab", ["a", "b"]),
                                       m.ColToTensor("c", "c")])
    _same(make(tdm).transform_frame(df), make(jdm).transform_frame(df))
    seq = [(1.0, 2.0, 3.0), (4.0, 5.0, 6.0)]
    make = lambda m: m.RowTransformer([m.ColsToNumeric("s", indices=[0, 2]),
                                       m.ColToTensor("m", 1)], row_size=3)
    _same(make(tdm).transform_frame(seq), make(jdm).transform_frame(seq))


def test_row_transformer_errors_match_jax():
    for m in (jdm, tdm):
        with pytest.raises(ValueError, match="replicated"):
            m.RowTransformer([m.ColToTensor("a", 0), m.ColToTensor("a", 1)])
        with pytest.raises(ValueError, match="out of bound"):
            m.RowTransformer([m.ColsToNumeric("s", indices=[5])], row_size=3)
        with pytest.raises(ValueError, match="field name"):
            m.RowTransformer([m.ColToTensor("a", "age")]).transform_row(
                (1, 2))
        with pytest.raises(NotImplementedError):
            m.RowTransformSchema("k").transform([1], ["k"])
    assert tdm.RowTransformer.numeric().transform_frame([])["all"].shape \
        == (0,)


# -- movielens ---------------------------------------------------------------------

def test_movielens_synthetic_and_split_equal_jax():
    for kw in ({}, dict(n_users=50, n_items=30, n_ratings=600, seed=3)):
        np.testing.assert_array_equal(tml.synthetic(**kw),
                                      jml.synthetic(**kw))
    data = tml.synthetic(n_users=40, n_items=25, n_ratings=500, seed=1)
    # a user who has seen almost every item takes the fallback draws
    extra = np.array([[41, i, 4, 10 ** 8 + i] for i in range(1, 25)])
    data = np.concatenate([data, extra])
    for kw in ({}, dict(n_negatives=2, n_eval_negatives=5, seed=7)):
        got = tml.train_test_split_leave_one_out(data, **kw)
        want = jml.train_test_split_leave_one_out(data, **kw)
        for g, w in zip(got, want):
            _same(g, w)
    train, labels, ev_u, ev_items = got
    assert ev_items.shape == (len(ev_u), 6) and set(labels) == {0, 1}


def test_movielens_reads_ratings_dat(tmp_path):
    d = tmp_path / "ml-1m"
    d.mkdir()
    (d / "ratings.dat").write_text("1::10::5::978300760\n"
                                   "2::20::3::978302109\n\n")
    for fn in ("read_data_sets", "get_id_pairs", "get_id_ratings"):
        _same(getattr(tml, fn)(str(tmp_path)),
              getattr(jml, fn)(str(tmp_path)))
    assert tml.get_id_pairs(str(tmp_path)).tolist() == [[1, 10], [2, 20]]
    # no data on disk: the synthetic matrix, nothing downloaded
    _same(tml.read_data_sets(str(tmp_path / "none"), n_synthetic=300),
          jml.read_data_sets(str(tmp_path / "none"), n_synthetic=300))


# -- segmentation --------------------------------------------------------------------

def _masks(n=4, h=13, w=9, seed=0):
    rng = np.random.RandomState(seed)
    m = (rng.rand(n, h, w) < 0.35).astype(np.uint8)
    m[1] = 0
    m[2] = 1
    return m


def test_rle_matches_jax():
    masks = _masks()
    h, w = masks.shape[1:]
    counts = [tseg.rle_encode(m) for m in masks]
    assert counts == [jseg.rle_encode(m) for m in masks]
    for c, m in zip(counts, masks):
        _same(tseg.rle_decode(c, h, w), jseg.rle_decode(c, h, w))
        np.testing.assert_array_equal(tseg.rle_decode(c, h, w), m)
        assert tseg.rle_area(c) == jseg.rle_area(c) == int(m.sum())
        _same(tseg.rle_to_bbox(c, h, w), jseg.rle_to_bbox(c, h, w))
        s = tseg.rle_to_string(c)
        assert s == jseg.rle_to_string(c)
        assert tseg.rle_from_string(s) == jseg.rle_from_string(s) == c
    for inter in (False, True):
        assert tseg.rle_merge(counts, h, w, inter) == \
            jseg.rle_merge(counts, h, w, inter)
    assert tseg.rle_iou(counts[0], counts[3], h, w) == \
        jseg.rle_iou(counts[0], counts[3], h, w)
    assert tseg.rle_iou(counts[1], counts[1], h, w) == 0.0
    rle, jrle = tseg.RLEMasks(counts, h, w), jseg.RLEMasks(counts, h, w)
    assert len(rle) == 4
    for fn in ("decode", "area", "bbox"):
        _same(getattr(rle, fn)(), getattr(jrle, fn)())
    assert rle.to_strings() == jrle.to_strings()
    back = tseg.RLEMasks.from_strings(rle.to_strings(), h, w)
    assert back.counts == counts
    _same(tseg.RLEMasks([], h, w).decode(), jseg.RLEMasks([], h, w).decode())


def test_polygon_masks_match_jax():
    polys = [[[1.0, 1.0, 7.5, 2.0, 6.0, 10.0, 2.0, 8.0]],
             [[0.0, 0.0, 8.0, 0.0, 8.0, 12.0], [3.0, 3.0, 5.0, 3.0, 4.0, 6.0]],
             [[1.0, 1.0, 2.0, 2.0]]]
    pm, jpm = tseg.PolyMasks(polys, 13, 9), jseg.PolyMasks(polys, 13, 9)
    assert len(pm) == 3
    _same(pm.decode(), jpm.decode())
    assert pm.to_rle().counts == jpm.to_rle().counts
    _same(tseg.rasterize_polygon(polys[0][0], 13, 9),
          jseg.rasterize_polygon(polys[0][0], 13, 9))
    assert pm.decode()[0].sum() > 10 and not pm.decode()[2].any()
