"""The port's Caffe, Torch7 and TensorFlow loaders and savers
(``bigdl_tpu_torch.loaders``) against the JAX package's: a file the JAX
package writes loads in the port and gives JAX's outputs (1e-5), the port's
saver writes the same bytes as JAX's for the same model and params (the
module names set alike: each package numbers its auto-generated names from
its own counter; the same bytes load in JAX as JAX's own file), a graph real tensorflow writes loads and gives
tensorflow's own output, the error paths raise JAX's exception types,
``TFSession`` trains and predicts, and every loader needs a card unless
``device="cpu"`` is passed."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import loaders as JL
from bigdl_tpu import nn as jnn
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import loaders as PL
from bigdl_tpu_torch import nn as pnn

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _convnet(N):
    """Conv / BN / LRN / pools / an inception-style Concat / a residual
    ConcatTable + CAddTable / dropout / flatten / linear."""
    branch = N.Concat(2)
    branch.add(N.SpatialConvolution(8, 4, 1, 1))
    branch.add(N.Sequential(N.SpatialConvolution(8, 4, 3, 3, 1, 1, 1, 1),
                            N.ReLU()))
    res = N.ConcatTable()
    res.add(N.Sequential(N.SpatialConvolution(8, 8, 3, 3, 1, 1, 1, 1),
                         N.SpatialBatchNormalization(8)))
    res.add(N.Identity())
    return N.Sequential(
        N.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1),
        N.SpatialBatchNormalization(8), N.ReLU(),
        N.SpatialCrossMapLRN(5, 0.0001, 0.75, 1.0),
        N.SpatialMaxPooling(2, 2, 2, 2),
        res, N.CAddTable(), N.Tanh(),
        branch,
        N.SpatialAveragePooling(2, 2, 2, 2),
        N.Dropout(0.3),
        N.View(8 * 2 * 2),
        N.Linear(32, 5), N.LogSoftMax())


def _walk_names(jm, pm, prefix):
    jm.set_name(prefix)
    pm.set_name(prefix)
    jk = getattr(jm, "modules", None)
    if isinstance(jk, list):
        for i, (a, b) in enumerate(zip(jk, pm._modules.values())):
            _walk_names(a, b, f"{prefix}_{i}")


def _twins(make, seed=0):
    """The same model in both packages: JAX's weights and statistics
    redrawn from ``seed``, copied into the port's; evaluation mode."""
    jm, pm = make(jnn), make(pnn)
    _walk_names(jm, pm, "n")
    # JAX's parameter shapes without running its initialisers
    shapes = jax.eval_shape(jm._init_params, jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    jp = jax.tree_util.tree_map(
        lambda a: (0.3 * rng.randn(*a.shape)).astype(np.float32), shapes)
    js = jax.tree_util.tree_map(
        lambda a: (0.5 + rng.rand(*np.shape(a))).astype(np.float32),
        jm._init_state())
    jm.params = jax.tree_util.tree_map(jnp.asarray, jp)
    jm.state = jax.tree_util.tree_map(jnp.asarray, js)
    pm.load_state_dict(convert.jax_to_state_dict(jp, js))
    return jm.evaluate(), pm.evaluate()


X = np.random.RandomState(7).randn(2, 3, 8, 8).astype(np.float32)


def _j(m, x=X):
    """JAX's evaluation-mode forward, compiled once (faster than its
    op-by-op dispatch for a whole net)."""
    m.ensure_initialized()
    f = jax.jit(lambda p, s, v: m.apply(p, s, v, training=False)[0])
    return np.asarray(f(m.params, m.state, jnp.asarray(x)))


def _p(m, x=X):
    with torch.no_grad():
        return m.forward(torch.from_numpy(np.array(x))).numpy()


# -- Caffe ----------------------------------------------------------------

def test_caffe_same_bytes_and_jax_files_load(tmp_path):
    jm, pm = _twins(_convnet)
    jm.save_caffe(str(tmp_path / "j.prototxt"), str(tmp_path / "j.caffemodel"),
                  input_shape=(3, 8, 8))
    pm.save_caffe(str(tmp_path / "p.prototxt"), str(tmp_path / "p.caffemodel"),
                  input_shape=(3, 8, 8))
    for ext in ("prototxt", "caffemodel"):
        assert (tmp_path / f"j.{ext}").read_bytes() == \
            (tmp_path / f"p.{ext}").read_bytes(), ext
    want = _j(jm)
    g = PL.load_caffe(str(tmp_path / "j.prototxt"),
                      str(tmp_path / "j.caffemodel"), device="cpu").evaluate()
    np.testing.assert_allclose(_p(g), want, **TOL)


def test_caffe_prototxt_and_blobs_parse_alike(tmp_path):
    jm, pm = _twins(_convnet)
    pm.save_caffe(str(tmp_path / "p.prototxt"), str(tmp_path / "p.caffemodel"),
                  input_shape=(3, 8, 8))
    text = (tmp_path / "p.prototxt").read_text()
    assert PL.parse_prototxt(text) == JL.parse_prototxt(text)
    pb = PL.read_caffemodel_blobs(str(tmp_path / "p.caffemodel"))
    jb = JL.read_caffemodel_blobs(str(tmp_path / "p.caffemodel"))
    assert list(pb) == list(jb)
    for k in jb:
        for a, b in zip(pb[k], jb[k]):
            np.testing.assert_array_equal(a, b)


def test_caffe_long_tail_layers_load_like_jax(tmp_path):
    proto = """
name: "tail"
input: "data"
input_dim: 1
input_dim: 4
input_dim: 6
input_dim: 6
layer { name: "c1" type: "Convolution" bottom: "data" top: "c1"
  convolution_param { num_output: 6 kernel_size: 3 pad: 1 group: 2 } }
layer { name: "pw" type: "Power" bottom: "c1" top: "pw"
  power_param { power: 2.0 scale: 0.5 shift: 1.0 } }
layer { name: "pr" type: "PReLU" bottom: "pw" top: "pr" }
layer { name: "ex" type: "Exp" bottom: "pr" top: "ex"
  exp_param { base: 2.0 scale: 0.1 } }
layer { name: "ab" type: "AbsVal" bottom: "ex" top: "ab" }
layer { name: "lg" type: "Log" bottom: "ab" top: "lg"
  log_param { base: 10.0 shift: 1.0 } }
layer { name: "el" type: "ELU" bottom: "lg" top: "el" elu_param { alpha: 0.5 } }
layer { name: "sl" type: "Slice" bottom: "el" top: "s1" top: "s2"
  slice_param { axis: 1 slice_point: 2 } }
layer { name: "dc" type: "Deconvolution" bottom: "s2" top: "dc"
  convolution_param { num_output: 2 kernel_size: 2 stride: 2 } }
layer { name: "th" type: "Threshold" bottom: "dc" top: "th"
  threshold_param { threshold: 0.1 } }
"""
    (tmp_path / "t.prototxt").write_text(proto)
    jg = JL.load_caffe(str(tmp_path / "t.prototxt"))
    jg.ensure_initialized()
    pg = PL.load_caffe(str(tmp_path / "t.prototxt"), device="cpu")
    rng = np.random.RandomState(3)
    jp = jax.tree_util.tree_map(
        lambda a: (0.3 * rng.randn(*a.shape)).astype(np.float32), jg.params)
    jg.params = jax.tree_util.tree_map(jnp.asarray, jp)
    pg.load_state_dict(convert.jax_to_state_dict(jp, jax.tree_util.tree_map(
        np.asarray, jg.state)))
    x = rng.rand(1, 4, 6, 6).astype(np.float32)
    np.testing.assert_allclose(_p(pg, x), _j(jg, x), **TOL)


def test_caffe_error_paths_raise_jax_types(tmp_path):
    bad = 'input: "data"\nlayer { name: "q" type: "Nope" bottom: "data" top: "q" }\n'
    (tmp_path / "b.prototxt").write_text(bad)
    for load, kw in ((JL.load_caffe, {}), (PL.load_caffe, {"device": "cpu"})):
        with pytest.raises(ValueError, match="unsupported caffe layer"):
            load(str(tmp_path / "b.prototxt"), **kw)
    for N, save in ((jnn, JL.save_caffe), (pnn, PL.save_caffe)):
        m = N.Sequential(N.SpatialConvolution(3, 4, 3, 3), N.SoftPlus())
        if N is jnn:
            m.ensure_initialized()
        with pytest.raises(NotImplementedError, match="SoftPlus"):
            save(m, str(tmp_path / "x.prototxt"),
                 str(tmp_path / "x.caffemodel"))


# -- Torch7 ---------------------------------------------------------------

def _t7net(N):
    return N.Sequential(
        N.SpatialConvolution(3, 6, 3, 3, 1, 1, 1, 1),
        N.SpatialBatchNormalization(6), N.ReLU(),
        N.SpatialCrossMapLRN(3, 0.001, 0.75, 2.0),
        N.SpatialMaxPooling(2, 2, 2, 2).ceil(),
        N.SpatialZeroPadding(1, 0, 0, 1), N.LeakyReLU(0.1),
        N.SpatialAveragePooling(2, 2, 2, 2),
        N.Dropout(0.2), N.View(6 * 2 * 2), N.Linear(24, 4),
        N.Threshold(0.05, -1.0), N.SoftMax())


def test_t7_same_bytes_and_jax_files_load(tmp_path):
    jm, pm = _twins(_t7net)
    jm.save_torch(str(tmp_path / "j.t7"))
    pm.save_torch(str(tmp_path / "p.t7"))
    assert (tmp_path / "j.t7").read_bytes() == (tmp_path / "p.t7").read_bytes()
    want = _j(jm)
    back = PL.load_torch(str(tmp_path / "j.t7"), device="cpu").evaluate()
    np.testing.assert_allclose(_p(back), want, **TOL)


def test_t7_lstm_and_raw_objects(tmp_path):
    jl, pl = _twins(lambda N: N.Recurrent(N.LSTM(3, 5)))
    JL.save_torch(jl, str(tmp_path / "j.t7"))
    PL.save_torch(pl, str(tmp_path / "p.t7"))
    assert (tmp_path / "j.t7").read_bytes() == (tmp_path / "p.t7").read_bytes()
    x = np.random.RandomState(1).randn(2, 4, 3).astype(np.float32)
    back = PL.load_torch(str(tmp_path / "j.t7"), device="cpu").evaluate()
    np.testing.assert_allclose(_p(back, x), _j(jl, x), **TOL)
    obj = {"x": np.arange(12.0).reshape(3, 4), "n": 7, "s": "hello",
           "flag": True, "i": np.arange(5, dtype=np.int32)}
    JL.save_t7(obj, str(tmp_path / "jo.t7"))
    PL.save_t7({**obj, "x": torch.from_numpy(obj["x"])},
               str(tmp_path / "po.t7"))
    assert (tmp_path / "jo.t7").read_bytes() == \
        (tmp_path / "po.t7").read_bytes()
    got = PL.load_t7(str(tmp_path / "jo.t7"), device="cpu")
    assert got["n"] == 7 and got["s"] == "hello" and got["flag"] is True
    assert torch.is_tensor(got["x"]) and got["x"].dtype == torch.float64
    np.testing.assert_array_equal(got["x"].numpy(), obj["x"])
    np.testing.assert_array_equal(got["i"].numpy(), obj["i"])


def test_t7_error_paths_raise_jax_types(tmp_path):
    for N, save in ((jnn, JL.save_torch), (pnn, PL.save_torch)):
        m = N.Sequential(N.SpatialConvolution(3, 4, 3, 3),
                         N.SpatialAveragePooling(2, 2, global_pooling=True))
        if N is jnn:
            m.ensure_initialized()
        with pytest.raises(NotImplementedError, match="global average"):
            save(m, str(tmp_path / "g.t7"))
    obj = JL.torchfile.TorchObject("nn.Nope", {})
    JL.save_t7(obj, str(tmp_path / "u.t7"))
    for load, kw in ((JL.load_torch, {}), (PL.load_torch, {"device": "cpu"})):
        with pytest.raises(ValueError, match="unsupported torch module"):
            load(str(tmp_path / "u.t7"), **kw)


# -- TensorFlow -----------------------------------------------------------

def _tfnet(N):
    branch = N.Concat(2)
    branch.add(N.SpatialConvolution(8, 4, 1, 1))
    branch.add(N.SpatialConvolution(8, 4, 3, 3, 1, 1, -1, -1))
    res = N.ConcatTable()
    res.add(N.Sequential(N.SpatialConvolution(8, 8, 3, 3, 1, 1, 1, 1),
                         N.SpatialBatchNormalization(8)))
    res.add(N.Identity())
    return N.Sequential(
        N.SpatialConvolution(3, 8, 3, 3, 2, 2, 1, 1),
        N.SpatialBatchNormalization(8), N.ReLU6(),
        res, N.CAddTable(), N.ReLU(),
        N.SpatialConvolution(8, 8, 3, 3, 1, 1, 1, 1, n_group=8),
        branch, N.SpatialMaxPooling(2, 2, 2, 2),
        N.SpatialAveragePooling(1, 1, global_pooling=True),
        N.View(8), N.Linear(8, 5), N.Sigmoid())


def _same_nodes(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert {k: g[k] for k in ("name", "op", "inputs")} == \
            {k: w[k] for k in ("name", "op", "inputs")}
        assert list(g["attrs"]) == list(w["attrs"])
        for k, v in w["attrs"].items():
            np.testing.assert_array_equal(np.asarray(g["attrs"][k]),
                                          np.asarray(v))


def test_tf_same_bytes_and_jax_files_load(tmp_path):
    jm, pm = _twins(_tfnet)
    jb = jm.save_tf((3, 8, 8))
    pb = pm.save_tf((3, 8, 8), str(tmp_path / "p.pb"))
    assert jb == pb == (tmp_path / "p.pb").read_bytes()
    _same_nodes(PL.parse_graphdef(jb), JL.parse_graphdef(jb))
    want = _j(jm)
    g = PL.load_tf_graph(jb, device="cpu")
    np.testing.assert_allclose(_p(g), want, **TOL)


def _tf_node(name, op, inputs=(), **attrs):
    from bigdl_tpu_torch.loaders import wire as W
    b = W.field_string(1, name) + W.field_string(2, op)
    for i in inputs:
        b += W.field_string(3, i)
    for k, vb in attrs.items():
        b += W.field_bytes(5, W.field_string(1, k) + W.field_bytes(2, vb))
    return W.field_bytes(1, b)


def _const(arr):
    from bigdl_tpu_torch.loaders import wire as W
    from bigdl_tpu_torch.loaders.tf_saver import _tensor_proto
    return W.field_bytes(8, _tensor_proto(np.asarray(arr)))


def test_tf_extended_ops_and_folding_like_jax():
    from bigdl_tpu_torch.loaders import wire as W
    x = np.random.RandomState(0).rand(2, 6).astype(np.float32) + 0.5
    graphs = [
        [_tf_node("x", "Placeholder"), _tf_node("sq", "Square", ["x"]),
         _tf_node("half", "Const", value=_const(np.float32(0.5))),
         _tf_node("scaled", "Mul", ["sq", "half"]),
         _tf_node("r", "Rsqrt", ["scaled"]), _tf_node("out", "Neg", ["r"])],
        [_tf_node("x", "Placeholder"),
         _tf_node("c0", "Const", value=_const(np.int32(0))),
         _tf_node("c2", "Const", value=_const(np.int32(2))),
         _tf_node("c1", "Const", value=_const(np.int32(1))),
         _tf_node("axes", "Range", ["c0", "c2", "c1"]),
         _tf_node("s", "Sum", ["x", "axes"])],
        [_tf_node("x", "Placeholder"),
         _tf_node("axis", "Const", value=_const(np.int32(1))),
         _tf_node("split", "Split", ["axis", "x"],
                  num_split=W.field_varint(3, 2)),
         _tf_node("out", "Sub", ["split", "split:1"])],
        [_tf_node("x", "Placeholder"),
         _tf_node("idx", "Const", value=_const(np.array([5, 0, -1, 9],
                                                          np.int32))),
         _tf_node("ax", "Const", value=_const(np.int32(1))),
         _tf_node("g", "GatherV2", ["x", "idx", "ax"]),
         _tf_node("k", "Const", value=_const(np.int32(2))),
         _tf_node("tk", "TopKV2", ["x", "k"]),
         _tf_node("c", "Const", value=_const(np.float32(1.0))),
         _tf_node("m", "Maximum", ["tk", "c"]),
         _tf_node("am", "ArgMax", ["x", "ax"]),
         _tf_node("fm", "FloorMod", ["x", "c"])],
    ]
    for nodes in graphs:
        gd = b"".join(nodes)
        outs = None
        if len(nodes) == 10:
            outs = ["g", "m", "am", "fm"]
        jg = JL.load_tf_graph(gd, outputs=outs)
        pg = PL.load_tf_graph(gd, outputs=outs, device="cpu")
        jo, po = jg.forward(jnp.asarray(x)), pg.forward(torch.from_numpy(x))
        jo = jo.to_list() if hasattr(jo, "to_list") else [jo]
        po = po.to_list() if hasattr(po, "to_list") else [po]
        for a, b in zip(po, jo):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       equal_nan=True, **TOL)
            assert a.numpy().dtype == np.asarray(b).dtype


def test_tf_unsupported_op_raises_like_jax():
    gd = _tf_node("x", "Placeholder") + _tf_node("y", "NoSuchOp", ["x"])
    with pytest.raises(NotImplementedError, match="NoSuchOp"):
        JL.load_tf_graph(gd)
    with pytest.raises(NotImplementedError, match="NoSuchOp"):
        PL.load_tf_graph(gd, device="cpu")
    with pytest.raises(ValueError, match="no Placeholder"):
        PL.load_tf_graph(_tf_node("c", "Const", value=_const(
            np.float32(1))), device="cpu")


def test_load_graph_written_by_real_tensorflow():
    tf = pytest.importorskip("tensorflow")
    tf1 = tf.compat.v1
    g = tf.Graph()
    with g.as_default():
        rng = np.random.RandomState(0)
        x = tf1.placeholder(tf.float32, [None, 8, 8, 3], name="input")
        w = tf.constant(rng.randn(3, 3, 3, 4).astype(np.float32))
        y = tf.nn.conv2d(x, w, strides=[1, 1, 1, 1], padding="SAME")
        y = tf.nn.bias_add(y, tf.constant(rng.randn(4).astype(np.float32)))
        y = tf.nn.relu(y)
        y = tf1.reshape(y, [-1, 8 * 8 * 4])
        wd = tf.constant(rng.randn(8 * 8 * 4, 5).astype(np.float32))
        y = tf.nn.softmax(tf1.matmul(y, wd), name="probs")
    xin = np.random.RandomState(1).randn(2, 8, 8, 3).astype(np.float32)
    with tf1.Session(graph=g) as sess:
        ref = sess.run("probs:0", {"input:0": xin})
    m = PL.load_tf_graph(g.as_graph_def().SerializeToString(), device="cpu")
    ours = _p(m, xin.transpose(0, 3, 1, 2))
    np.testing.assert_allclose(ours.reshape(ref.shape), ref, atol=1e-5)


@pytest.mark.parametrize("padding,stride,ih,oh", [
    ("SAME", 2, 5, 10), ("VALID", 2, 5, 11), ("SAME", 1, 5, 5),
    ("SAME", 2, 3, 5), ("VALID", 2, 2, 6)])
def test_load_deconv_graph_written_by_real_tensorflow(padding, stride, ih,
                                                      oh):
    tf = pytest.importorskip("tensorflow")
    tf1 = tf.compat.v1
    g = tf.Graph()
    with g.as_default():
        rng = np.random.RandomState(0)
        x = tf1.placeholder(tf.float32, [2, ih, ih, 4], name="input")
        w = tf.constant(rng.randn(3, 3, 6, 4).astype(np.float32))
        y = tf.nn.conv2d_transpose(
            x, w, output_shape=[2, oh, oh, 6],
            strides=[1, stride, stride, 1], padding=padding)
        y = tf.nn.relu(y, name="out")
    xin = np.random.RandomState(1).randn(2, ih, ih, 4).astype(np.float32)
    with tf1.Session(graph=g) as sess:
        ref = sess.run("out:0", {"input:0": xin})
    m = PL.load_tf_graph(g.as_graph_def().SerializeToString(), device="cpu")
    ours = _p(m, xin.transpose(0, 3, 1, 2))
    np.testing.assert_allclose(ours.transpose(0, 2, 3, 1), ref, atol=1e-4)


def test_tf_session_trains_and_predicts():
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.dataset.sample import Sample
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.optim.trigger import max_epoch

    torch.manual_seed(0)
    src = pnn.Sequential(
        pnn.SpatialConvolution(1, 4, 3, 3, 1, 1, 1, 1), pnn.ReLU(),
        pnn.SpatialAveragePooling(1, 1, global_pooling=True),
        pnn.View(4), pnn.Linear(4, 3), pnn.LogSoftMax()).evaluate()
    gd = PL.save_tf_graph(src, input_shape=(1, 8, 8))
    rng = np.random.RandomState(0)
    xs = rng.randn(96, 1, 8, 8).astype(np.float32)
    ys = np.repeat(np.arange(3), 32)
    xs += ys[:, None, None, None] * 3.0
    samples = [Sample(x, np.float32(y + 1)) for x, y in zip(xs, ys)]
    sess = PL.TFSession(gd, device="cpu")
    before = np.asarray(sess.predict([], xs[:9]))
    sess.train([], DataSet.array(samples), SGD(learningrate=0.1),
               pnn.ClassNLLCriterion(), max_epoch(15), batch_size=32)
    after = np.asarray(sess.predict([], xs))
    assert (after.argmax(-1) == ys).mean() > 0.8
    assert not np.allclose(before, after[:9])
    with pytest.raises(ValueError, match="already built"):
        sess.predict(["other"], xs[:2])


# -- the device rule ------------------------------------------------------

def test_every_loader_needs_a_card_unless_cpu_is_asked(monkeypatch,
                                                       tmp_path):
    m = _twins(_t7net)[1]
    m.save_torch(str(tmp_path / "m.t7"))
    _twins(_convnet)[1].save_caffe(str(tmp_path / "m.prototxt"),
                                   str(tmp_path / "m.caffemodel"),
                                   input_shape=(3, 8, 8))
    gd = _twins(_tfnet)[1].save_tf((3, 8, 8))
    from bigdl_tpu_torch.loaders.bigdl_proto import load_bigdl, save_bigdl
    save_bigdl(m, str(tmp_path / "m.bigdl"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda **kw: load_bigdl(str(tmp_path / "m.bigdl"), **kw),
        lambda **kw: PL.load_caffe(str(tmp_path / "m.prototxt"),
                                   str(tmp_path / "m.caffemodel"), **kw),
        lambda **kw: PL.load_torch(str(tmp_path / "m.t7"), **kw),
        lambda **kw: PL.load_t7(str(tmp_path / "m.t7"), **kw),
        lambda **kw: PL.load_tf_graph(gd, **kw),
        lambda **kw: PL.TFSession(gd, **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        assert call(device="cpu") is not None


def test_strided_padded_max_pool_exports_exactly():
    """A 3x3 / 2 / 1 max pool (ResNet's stem) goes out as PadV2(-inf) and
    a VALID pool (a ceil-mode pool's last window padded on): the round
    trip equals the model, and real tensorflow runs the graph to the same
    numbers. JAX's saver writes SAME there, which pads at the end only,
    and drops ceil mode (its round trip differs)."""
    tf = pytest.importorskip("tensorflow")
    make = lambda N: N.Sequential(  # noqa: E731
        N.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1),
        N.SpatialMaxPooling(3, 3, 2, 2, 1, 1),
        N.SpatialMaxPooling(3, 3, 2, 2, 1, 1).ceil())
    jm, pm = _twins(make)
    x = np.random.RandomState(0).randn(2, 3, 8, 8).astype(np.float32)
    want = _p(pm, x)
    np.testing.assert_allclose(want, _j(jm, x), **TOL)
    gd = pm.save_tf((3, 8, 8))
    np.testing.assert_array_equal(_p(PL.load_tf_graph(gd, device="cpu"), x),
                                  want)
    jgot = _j(JL.load_tf_graph(jm.save_tf((3, 8, 8))), x)
    assert jgot.shape != want.shape or np.abs(jgot - want).max() > 1e-3
    tf1 = tf.compat.v1
    g = tf.Graph()
    with g.as_default():
        gdef = tf1.GraphDef()
        gdef.ParseFromString(gd)
        tf1.import_graph_def(gdef, name="")
    out = [n["name"] for n in PL.parse_graphdef(gd)][-1]
    with tf1.Session(graph=g) as sess:
        ref = sess.run(out + ":0", {"input:0": x.transpose(0, 2, 3, 1)})
    np.testing.assert_allclose(ref.transpose(0, 3, 1, 2), want, atol=1e-5)
