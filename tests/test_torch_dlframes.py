"""The port's ML-pipeline stages (``bigdl_tpu_torch.dlframes``) against
the JAX package's.

``DLEstimator`` / ``DLClassifier`` fit the same model (the port's loaded
with JAX's initial weights) on the same columns, given as a dict of arrays
and as a pandas DataFrame; the trained weights follow JAX's
``LocalOptimizer`` trajectory within 1e-4 and ``transform`` appends JAX's
predictions. A stage refuses a model that lives on another device.
``DLImageReader.read_images`` reads the PNGs the test writes (and skips
the rest) into JAX's rows, and ``DLImageTransformer`` maps both a
DataFrame and a dict image column to JAX's outputs.
"""
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import dlframes as jdf
from bigdl_tpu.transform import vision as jvision
from bigdl_tpu_torch import convert, dlframes, nn
from bigdl_tpu_torch.transform import vision
from torch_parity_helpers import close

torch.set_num_threads(1)
STEP_TOL = dict(atol=1e-4, rtol=1e-4)


def _toy(n=48, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 0).astype(np.float32) + 1   # classes 1 / 2
    return x, y


def _twins(make):
    jm, tm = make(jnn), make(nn)
    jm.ensure_initialized()
    tm.load_state_dict(convert.jax_to_state_dict(jm.params, jm.state or {}))
    return jm, tm


def _classifier(m):
    return m.Sequential(m.Linear(4, 8), m.ReLU(), m.Linear(8, 2),
                        m.LogSoftMax())


@pytest.mark.parametrize("frame", ["dict", "pandas"])
def test_classifier_fit_transform_follows_jax(frame):
    x, y = _toy()
    if frame == "pandas":
        pd = pytest.importorskip("pandas")
        df = pd.DataFrame({"features": list(x), "label": y})
    else:
        df = {"features": x, "label": y}
    jm, tm = _twins(_classifier)
    outs = []
    for pkg, m, kw in ((jdf, jm, {}), (dlframes, tm, {"device": "cpu"})):
        est = pkg.DLClassifier(m, (jnn if pkg is jdf else nn)
                               .ClassNLLCriterion(), [4], **kw)
        est.set_batch_size(16).set_max_epoch(3).set_learning_rate(1e-2)
        fitted = est.fit(df)
        assert type(fitted).__name__ == "DLClassifierModel"
        outs.append(fitted.set_batch_size(16).transform(df))
    close(tm.params, jm.params, STEP_TOL, "params")
    want, got = outs
    if frame == "pandas":
        assert list(got.columns) == list(want.columns)
        assert len(got) == len(x)
    np.testing.assert_array_equal(np.asarray(got["prediction"]),
                                  np.asarray(want["prediction"]))
    assert set(np.unique(np.asarray(got["prediction"]))) <= {1.0, 2.0}


def test_estimator_regression_follows_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(40, 3).astype(np.float32)
    y = (x @ np.array([1.0, -2.0, 0.5], np.float32))[:, None]
    jm, tm = _twins(lambda m: m.Linear(3, 1))
    outs = []
    for pkg, m, crit, kw in ((jdf, jm, jnn.MSECriterion(), {}),
                             (dlframes, tm, nn.MSECriterion(),
                              {"device": "cpu"})):
        est = pkg.DLEstimator(m, crit, [3], [1], **kw)
        est.set_max_epoch(4).set_learning_rate(5e-2).set_batch_size(8)
        outs.append(est.fit({"features": x, "label": y}).transform(
            {"features": x, "label": y}))
    close(tm.params, jm.params, STEP_TOL, "params")
    np.testing.assert_allclose(outs[1]["prediction"],
                               np.asarray(outs[0]["prediction"]), **STEP_TOL)
    assert set(outs[1]) == {"features", "label", "prediction"}


def test_optim_method_and_columns_are_honoured():
    from bigdl_tpu.optim import SGD as JSGD
    from bigdl_tpu_torch.optim import SGD
    x, y = _toy(32, seed=3)
    jm, tm = _twins(_classifier)
    for pkg, m, opt, kw in ((jdf, jm, JSGD(0.1), {}),
                            (dlframes, tm, SGD(0.1), {"device": "cpu"})):
        est = pkg.DLClassifier(m, (jnn if pkg is jdf else nn)
                               .ClassNLLCriterion(), [4], "feat", "lab",
                               "out", **kw)
        est.set_optim_method(opt).set_max_epoch(2)
        out = est.fit({"feat": x, "lab": y}).transform({"feat": x})
        assert set(out) == {"feat", "out"}
    close(tm.params, jm.params, STEP_TOL, "params")


def test_a_model_elsewhere_is_refused():
    x, y = _toy(8)
    m = _classifier(nn).to("meta")
    est = dlframes.DLClassifier(m, nn.ClassNLLCriterion(), [4], device="cpu")
    with pytest.raises(ValueError, match="device='cpu'"):
        est.fit({"features": x, "label": y})
    with pytest.raises(ValueError, match="device='cpu'"):
        dlframes.DLClassifierModel(m, [4], device="cpu").transform(
            {"features": x})


def _images(tmp_path):
    from PIL import Image
    rng = np.random.RandomState(0)
    d = tmp_path / "imgs"
    (d / "sub").mkdir(parents=True)
    for i in range(3):
        arr = rng.randint(0, 255, (12 + i, 10, 3), dtype=np.uint8)
        Image.fromarray(arr).save(str(d / f"im{i}.png"))
    Image.fromarray(rng.randint(0, 255, (9, 7), dtype=np.uint8)).save(
        str(d / "sub" / "gray.png"))
    (d / "notes.txt").write_text("not an image")
    return d


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "data"} == \
            {k: v for k, v in w.items() if k != "data"}
        np.testing.assert_allclose(np.asarray(g["data"]),
                                   np.asarray(w["data"]), atol=1e-5)


def test_image_reader_and_transformer_match_jax(tmp_path):
    pytest.importorskip("pandas")
    d = _images(tmp_path)
    for kw in ({}, {"recursive": False}, {"pattern": "im1*"}):
        want = jdf.DLImageReader.read_images(str(d), **kw)
        got = dlframes.DLImageReader.read_images(str(d), **kw)
        assert list(got.columns) == ["image"]
        _same_rows(list(got["image"]), list(want["image"]))
    one = dlframes.DLImageReader.read_images(str(d / "im0.png"),
                                             image_col="img")
    assert list(one.columns) == ["img"] and len(one) == 1

    df = dlframes.DLImageReader.read_images(str(d), recursive=False)
    jt = jdf.DLImageTransformer(jvision.Resize(8, 8) | jvision.ChannelNormalize(
        0.0, 0.0, 0.0, 255.0, 255.0, 255.0))
    tt = dlframes.DLImageTransformer(vision.Resize(8, 8) | vision.ChannelNormalize(
        0.0, 0.0, 0.0, 255.0, 255.0, 255.0))
    tt.set_input_col("image").set_output_col("output")
    want, got = jt.transform(df), tt.transform(df)
    _same_rows(list(got["output"]), list(want["output"]))
    assert got["output"][0]["height"] == 8
    # a dict of columns, as JAX's takes it
    col = {"image": list(df["image"])}
    dwant, dgot = jt.transform(col), tt.transform(col)
    assert isinstance(dgot, dict) and set(dgot) == {"image", "output"}
    _same_rows(dgot["output"], dwant["output"])


def test_the_shim_paths_are_the_stages():
    from bigdl_tpu_torch.dlframes.dl_classifier import (DLClassifier,
                                                        DLClassifierModel,
                                                        DLEstimator, DLModel)
    from bigdl_tpu_torch.dlframes.dl_image_transformer import (
        DLImageTransformer)
    assert DLClassifier is dlframes.DLClassifier
    assert DLEstimator is dlframes.DLEstimator and DLModel is \
        dlframes.DLModel and DLClassifierModel is dlframes.DLClassifierModel
    assert DLImageTransformer is dlframes.DLImageTransformer
