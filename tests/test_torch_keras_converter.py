"""The port's Keras-1.2 converter (``bigdl_tpu_torch.keras.converter``,
``backend.py``) against the JAX package's, and the port's
``util.tf_utils`` against JAX's (every test that imports tensorflow is in
this file).

Each Keras JSON definition of ``test_keras_converter.py`` (Sequential and
functional ``Model`` configs, keras 2/3 ``to_json()`` spellings, "th" and
"tf" dim ordering) is converted by both packages; the port's model, built
on the CPU, must have JAX's module tree, and after ``load_weights`` of the
same Keras-layout arrays (in definition order, by name, non-strict) or
``load_weights_hdf5`` / ``load_keras`` of the same HDF5 file (written here
with h5py) its evaluation-mode output equals JAX's at 1e-5. The refusals
(unknown classes, BatchNorm axes, unsupported weights, a per-feature layer
between a tf-ordered Flatten and Dense) raise the same error types. A
reduced Keras-1.2 ResNet-50 (``chip_smoke.keras_resnet_json``: two stages
at 32x32) goes through both converters from the same JSON and weights.
A live tf.keras model goes through ``with_bigdl_backend`` in both
packages: weights, predictions, a fit's trajectory and ``evaluate``.
"""
import json
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from bigdl_tpu.keras import converter as JC
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.keras import converter as PC
from torch_parity_helpers import close

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
STEP_TOL = dict(atol=1e-4, rtol=1e-4)


def _layer(cls, name, **cfg):
    cfg.setdefault("name", name)
    return {"class_name": cls, "config": cfg}


def _seq(layers):
    return json.dumps({"class_name": "Sequential",
                       "config": [dict(l) for l in layers]})


def _r(seed):
    return np.random.RandomState(seed)


def _f32(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _both(json_def, weights=None, x=None, tol=TOL, **kw):
    """Both packages' models of ``json_def`` with ``weights`` loaded
    (``kw`` to ``load_weights``); their evaluation-mode outputs on ``x``
    held equal. Returns (JAX model, port model)."""
    jm = JC.model_from_json(json_def)
    tm = PC.model_from_json(json_def, device="cpu")
    assert tm.output_shape == jm.output_shape
    assert [r.name for r in tm.converted_records] == \
        [r.name for r in jm.converted_records]
    jmod = _init_jax(jm)
    tshapes = {k: tuple(v.shape)
               for k, v in convert.flatten(tm._module().params).items()}
    jshapes = {k: tuple(np.shape(v))
               for k, v in convert.flatten(jmod.params).items()}
    assert tshapes == jshapes
    if weights is not None:
        JC.load_weights(jm, weights, **kw)
        PC.load_weights(tm, weights, **kw)
    if x is not None:
        _same_out(jm, tm, x, tol)
    return jm, tm


def _init_jax(jm):
    """JAX's module tree with zero parameters of its shapes (from
    ``jax.eval_shape``: JAX's initialisers run op by op, seconds a model)
    and its initial state; ``load_weights`` then writes every loaded
    leaf."""
    jmod = jm._module()
    if jmod.params is None:
        shapes = jax.eval_shape(jmod._init_params, jax.random.PRNGKey(0))
        jmod.params = jax.tree_util.tree_map(
            lambda a: jnp.zeros(a.shape, a.dtype), shapes)
        jmod.state = jmod._init_state()
    return jmod


def _jax_out(jm, x):
    """JAX's evaluation-mode output, compiled as one function."""
    jmod = jm._module()
    return np.asarray(jax.jit(lambda p, s, v: jmod.apply(
        p, s, v, training=False)[0])(jmod.params, jmod.state, x))


def _same_out(jm, tm, x, tol=TOL):
    want = _jax_out(jm, x)
    got = tm._module().evaluate().forward(torch.from_numpy(x))
    torch.testing.assert_close(got.detach(), torch.from_numpy(want), **tol)
    return got


def _lenet():
    spec = [
        _layer("Convolution2D", "conv1", nb_filter=6, nb_row=5, nb_col=5,
               activation="tanh", border_mode="valid", dim_ordering="th",
               batch_input_shape=[None, 1, 28, 28]),
        _layer("MaxPooling2D", "pool1", pool_size=[2, 2], dim_ordering="th"),
        _layer("Convolution2D", "conv2", nb_filter=12, nb_row=5, nb_col=5,
               activation="tanh", dim_ordering="th"),
        _layer("MaxPooling2D", "pool2", pool_size=[2, 2], dim_ordering="th"),
        _layer("Flatten", "flat"),
        _layer("Dense", "fc1", output_dim=100, activation="tanh"),
        _layer("Dense", "fc2", output_dim=10, activation="softmax")]
    rng = _r(0)
    w = {"conv1": [_f32(rng, 6, 1, 5, 5), _f32(rng, 6)],
         "conv2": [0.2 * _f32(rng, 12, 6, 5, 5), _f32(rng, 12)],
         "fc1": [0.1 * _f32(rng, 192, 100), _f32(rng, 100)],
         "fc2": [0.1 * _f32(rng, 100, 10), _f32(rng, 10)]}
    return _seq(spec), w, _f32(rng, 2, 1, 28, 28)


def _mlp():
    spec = [_layer("Dense", "d1", output_dim=4, activation="relu",
                   batch_input_shape=[None, 3]),
            _layer("Dropout", "drop", p=0.5),
            _layer("Dense", "d2", output_dim=2)]
    rng = _r(1)
    w = {"d1": [_f32(rng, 3, 4), _f32(rng, 4)], "drop": [],
         "d2": [_f32(rng, 4, 2), _f32(rng, 2)]}
    return _seq(spec), w, _f32(rng, 5, 3)


def _cnn_bn():
    spec = [_layer("Convolution2D", "c1", nb_filter=4, nb_row=3, nb_col=3,
                   dim_ordering="th", batch_input_shape=[None, 2, 6, 6]),
            _layer("BatchNormalization", "bn", epsilon=1e-3, momentum=0.99,
                   mode=0, axis=1),
            _layer("Activation", "act", activation="relu"),
            _layer("Flatten", "flat"),
            _layer("Dense", "fc", output_dim=3)]
    rng = _r(2)
    w = {"c1": [_f32(rng, 4, 2, 3, 3), _f32(rng, 4)],
         "bn": [rng.rand(4).astype(np.float32) + 0.5, _f32(rng, 4),
                _f32(rng, 4), rng.rand(4).astype(np.float32) + 0.5],
         "fc": [_f32(rng, 64, 3), _f32(rng, 3)]}
    return _seq(spec), w, _f32(rng, 2, 2, 6, 6)


def _functional():
    spec = {"class_name": "Model", "config": {
        "layers": [
            {"class_name": "InputLayer", "name": "in1",
             "config": {"batch_input_shape": [None, 4], "name": "in1"},
             "inbound_nodes": []},
            {"class_name": "Dense", "name": "a",
             "config": {"output_dim": 3, "name": "a"},
             "inbound_nodes": [[["in1", 0, 0]]]},
            {"class_name": "Dense", "name": "b",
             "config": {"output_dim": 3, "name": "b"},
             "inbound_nodes": [[["in1", 0, 0]]]},
            {"class_name": "Merge", "name": "m",
             "config": {"mode": "concat", "concat_axis": -1, "name": "m"},
             "inbound_nodes": [[["a", 0, 0], ["b", 0, 0]]]},
            {"class_name": "Dense", "name": "out",
             "config": {"output_dim": 2, "name": "out"},
             "inbound_nodes": [[["m", 0, 0]]]}],
        "input_layers": [["in1", 0, 0]],
        "output_layers": [["out", 0, 0]]}}
    rng = _r(3)
    w = {"a": [_f32(rng, 4, 3), _f32(rng, 3)],
         "b": [_f32(rng, 4, 3), _f32(rng, 3)],
         "out": [_f32(rng, 6, 2), _f32(rng, 2)]}
    return json.dumps(spec), w, _f32(rng, 3, 4)


def _text_lstm():
    T, V, E, H = 5, 10, 4, 3
    spec = [_layer("Embedding", "emb", input_dim=V, output_dim=E,
                   batch_input_shape=[None, T]),
            _layer("LSTM", "lstm", output_dim=H, return_sequences=False),
            _layer("Dense", "fc", output_dim=2, activation="softmax")]
    rng = _r(4)
    lstm = [a for _ in "icfo" for a in (_f32(rng, E, H), _f32(rng, H, H),
                                        _f32(rng, H))]
    w = {"emb": [_f32(rng, V, E)], "lstm": lstm,
         "fc": [_f32(rng, H, 2), _f32(rng, 2)]}
    return _seq(spec), w, rng.randint(0, V, (2, T)).astype(np.float32)


def _lstm_gpu_layout():
    T, E, H = 4, 3, 5
    spec = [_layer("LSTM", "lstm", output_dim=H, return_sequences=True,
                   consume_less="gpu", batch_input_shape=[None, T, E])]
    rng = _r(14)
    w = {"lstm": [_f32(rng, E, 4 * H), _f32(rng, H, 4 * H),
                  _f32(rng, 4 * H)]}
    return _seq(spec), w, _f32(rng, 2, T, E)


def _gru_rnn():
    T, E, H = 4, 3, 5
    spec = [_layer("GRU", "gru", output_dim=H, return_sequences=True,
                   batch_input_shape=[None, T, E]),
            _layer("SimpleRNN", "rnn", output_dim=2)]
    rng = _r(5)
    gru = [a for _ in "zrh" for a in (_f32(rng, E, H), _f32(rng, H, H),
                                      _f32(rng, H))]
    w = {"gru": gru, "rnn": [_f32(rng, H, 2), _f32(rng, 2, 2),
                             _f32(rng, 2)]}
    return _seq(spec), w, _f32(rng, 2, T, E)


def _gru_concat():
    T, E, H = 4, 3, 5
    spec = [_layer("GRU", "gru", output_dim=H, batch_input_shape=[None, T, E])]
    rng = _r(15)
    w = {"gru": [_f32(rng, E, 3 * H), _f32(rng, H, 3 * H), _f32(rng, 3 * H)]}
    return _seq(spec), w, _f32(rng, 2, T, E)


def _bn_temporal():
    spec = [_layer("BatchNormalization", "bn", axis=-1, epsilon=1e-3,
                   batch_input_shape=[None, 5, 4])]
    rng = _r(10)
    w = {"bn": [rng.rand(4).astype(np.float32) + 0.5, _f32(rng, 4),
                _f32(rng, 4), rng.rand(4).astype(np.float32) + 0.5]}
    return _seq(spec), w, _f32(rng, 2, 5, 4)


def _atrous1d():
    T, C, OUT, K, RATE = 12, 3, 5, 3, 2
    spec = [_layer("AtrousConvolution1D", "ac", nb_filter=OUT,
                   filter_length=K, atrous_rate=RATE,
                   batch_input_shape=[None, T, C])]
    rng = _r(12)
    w = {"ac": [_f32(rng, K, 1, C, OUT), _f32(rng, OUT)]}
    return _seq(spec), w, _f32(rng, 2, T, C)


def _conv_family():
    """Conv1D (keras-1.2 4-D kernel), Atrous2D, Highway, PReLU,
    Convolution3D in "th" ordering."""
    spec = [_layer("Convolution1D", "c1", nb_filter=4, filter_length=3,
                   activation="relu", batch_input_shape=[None, 8, 3]),
            _layer("Flatten", "f"),
            _layer("Highway", "hw", activation="tanh"),
            _layer("PReLU", "pr")]
    rng = _r(16)
    w = {"c1": [_f32(rng, 3, 1, 3, 4), _f32(rng, 4)],
         "hw": [_f32(rng, 24, 24) * 0.2, _f32(rng, 24, 24) * 0.2,
                _f32(rng, 24), _f32(rng, 24)],
         "pr": [np.full((24,), 0.2, np.float32)]}
    return _seq(spec), w, _f32(rng, 2, 8, 3)


def _conv3d_atrous2d():
    spec = [_layer("Convolution3D", "c3", nb_filter=3, kernel_dim1=2,
                   kernel_dim2=3, kernel_dim3=3, dim_ordering="th",
                   batch_input_shape=[None, 2, 4, 6, 6]),
            _layer("Reshape", "r", target_shape=[9, 16]),
            _layer("Permute", "p", dims=[2, 1])]
    rng = _r(17)
    w = {"c3": [_f32(rng, 3, 2, 2, 3, 3), _f32(rng, 3)]}
    return _seq(spec), w, _f32(rng, 2, 2, 4, 6, 6)


def _atrous2d():
    spec = [_layer("AtrousConvolution2D", "a2", nb_filter=3, nb_row=3,
                   nb_col=3, atrous_rate=[2, 2], dim_ordering="th",
                   batch_input_shape=[None, 2, 9, 9])]
    rng = _r(18)
    w = {"a2": [_f32(rng, 3, 2, 3, 3), _f32(rng, 3)]}
    return _seq(spec), w, _f32(rng, 2, 2, 9, 9)


def _tf_conv_stack():
    """A keras-1.2 "tf"-ordered stack: kernels (kh, kw, in, out), a
    Flatten -> Dense whose rows come in (h, w, c) order."""
    spec = [_layer("Convolution2D", "c1", nb_filter=5, nb_row=3, nb_col=3,
                   activation="relu", border_mode="same", dim_ordering="tf",
                   batch_input_shape=[None, 8, 8, 3]),
            _layer("MaxPooling2D", "p", pool_size=[2, 2], dim_ordering="tf"),
            _layer("Convolution2D", "c2", nb_filter=4, nb_row=3, nb_col=3,
                   dim_ordering="tf"),
            _layer("BatchNormalization", "bn", axis=3, mode=0),
            _layer("Flatten", "f"),
            _layer("Dense", "d1", output_dim=6, activation="tanh"),
            _layer("Dense", "d2", output_dim=3)]
    rng = _r(19)
    w = {"c1": [_f32(rng, 3, 3, 3, 5), _f32(rng, 5)],
         "c2": [_f32(rng, 3, 3, 5, 4), _f32(rng, 4)],
         "bn": [rng.rand(4).astype(np.float32) + 0.5, _f32(rng, 4),
                _f32(rng, 4), rng.rand(4).astype(np.float32) + 0.5],
         "d1": [0.2 * _f32(rng, 16, 6), _f32(rng, 6)],
         "d2": [_f32(rng, 6, 3), _f32(rng, 3)]}
    return _seq(spec), w, _f32(rng, 2, 3, 8, 8)


DEFS = {"lenet": _lenet, "mlp": _mlp, "cnn_bn": _cnn_bn,
        "functional_merge": _functional, "text_lstm": _text_lstm,
        "lstm_gpu_layout": _lstm_gpu_layout, "gru_simplernn": _gru_rnn,
        "gru_concatenated": _gru_concat, "bn_temporal": _bn_temporal,
        "atrous1d": _atrous1d, "conv1d_highway_prelu": _conv_family,
        "conv3d_reshape_permute": _conv3d_atrous2d, "atrous2d": _atrous2d,
        "tf_ordered_stack": _tf_conv_stack}


@pytest.mark.parametrize("name", sorted(DEFS))
@pytest.mark.parametrize("by_name", [False, True], ids=["by_order",
                                                         "by_name"])
def test_definition_and_weights_match_jax(name, by_name):
    json_def, w, x = DEFS[name]()
    _both(json_def, w, x, by_name=by_name)


def test_tf_ordering_equals_the_th_model_with_transposed_weights():
    json_tf, w, x = _tf_conv_stack()
    spec = json.loads(json_tf)
    for ly in spec["config"]:
        c = ly["config"]
        if "dim_ordering" in c:
            c["dim_ordering"] = "th"
        if "batch_input_shape" in c:
            c["batch_input_shape"] = [None, 3, 8, 8]
        if ly["class_name"] == "BatchNormalization":
            c["axis"] = 1
    wth = dict(w, c1=[w["c1"][0].transpose(3, 2, 0, 1), w["c1"][1]],
               c2=[w["c2"][0].transpose(3, 2, 0, 1), w["c2"][1]])
    # keras flattens (h, w, c); the th model (c, h, w)
    perm = np.arange(16).reshape(2, 2, 4).transpose(2, 0, 1).ravel()
    wth["d1"] = [w["d1"][0][perm], w["d1"][1]]
    tf_m = PC.model_from_json(json_tf, device="cpu")
    th_m = PC.model_from_json(json.dumps(spec), device="cpu")
    assert tf_m._tf_ordered and not th_m._tf_ordered
    PC.load_weights(tf_m, w)
    PC.load_weights(th_m, wth)
    torch.testing.assert_close(torch.from_numpy(tf_m.predict(x)),
                               torch.from_numpy(th_m.predict(x)), **TOL)


def test_reduced_keras_resnet_from_json_matches_jax():
    for ordering in ("th", "tf"):
        j = chip_smoke.keras_resnet_json(blocks=(2, 1), widths=(4, 8),
                                         size=32, classes=10,
                                         ordering=ordering)
        w = chip_smoke.keras_resnet_weights(j, seed=3, ordering=ordering)
        x = _f32(_r(20), 2, 3, 32, 32)
        jm, tm = _both(j, w, x, tol=dict(atol=1e-5, rtol=1e-4))
        assert tm.output_shape == (10,)
        names = [r.name for r in tm.converted_records]
        assert names[:3] == ["zeropadding2d_1", "conv1", "bn_conv1"]
        assert "res3a_branch1" in names and names[-1] == "fc1000"


def _modern_dense(name, units, activation, shape=None):
    cfg = {"name": name, "trainable": True, "units": units,
           "activation": activation, "use_bias": True,
           "kernel_initializer": {"class_name": "GlorotUniform",
                                  "config": {"seed": None}}}
    return {"module": "keras.layers", "class_name": "Dense", "config": cfg,
            "registered_name": None,
            "build_config": {"input_shape": [None, shape]}}


def test_modern_to_json_spellings_match_jax():
    """keras 3's ``to_json()`` (units / use_bias / rate / batch_shape,
    ``Functional`` with keras_history inbound nodes, Conv2D with
    channels_last, dilation, 1-D pool sizes, negative_slope), as keras
    3.13 writes it."""
    seq = {"module": "keras", "class_name": "Sequential", "config": {
        "name": "sequential", "layers": [
            {"module": "keras.layers", "class_name": "InputLayer",
             "config": {"batch_shape": [None, 4], "dtype": "float32",
                        "sparse": False, "name": "input_layer"}},
            _modern_dense("dense", 8, "relu", 4),
            {"module": "keras.layers", "class_name": "Dropout",
             "config": {"name": "dropout", "rate": 0.2, "seed": None}},
            _modern_dense("dense_1", 2, "softmax", 8)]}}
    rng = _r(21)
    _both(json.dumps(seq), {"dense": [_f32(rng, 4, 8), _f32(rng, 8)],
                            "dense_1": [_f32(rng, 8, 2), _f32(rng, 2)]},
          _f32(rng, 3, 4))

    def node(parent, shape):
        return [{"args": [{"class_name": "__keras_tensor__", "config": {
            "shape": [None, shape], "dtype": "float32",
            "keras_history": [parent, 0, 0]}}], "kwargs": {}}]
    d2, d3 = _modern_dense("dense_2", 5, "tanh", 6), \
        _modern_dense("dense_3", 3, "linear", 5)
    d2.update(name="dense_2", inbound_nodes=node("input_layer_1", 6))
    d3.update(name="dense_3", inbound_nodes=node("dense_2", 5))
    fn = {"module": "keras.src.models.functional", "class_name":
          "Functional", "config": {"name": "functional_1", "layers": [
              {"module": "keras.layers", "class_name": "InputLayer",
               "config": {"batch_shape": [None, 6], "dtype": "float32",
                          "name": "input_layer_1"},
               "name": "input_layer_1", "inbound_nodes": []}, d2, d3],
              "input_layers": ["input_layer_1", 0, 0],
              "output_layers": ["dense_3", 0, 0]}}
    _both(json.dumps(fn), {"dense_2": [_f32(rng, 6, 5), _f32(rng, 5)],
                           "dense_3": [_f32(rng, 5, 3), _f32(rng, 3)]},
          _f32(rng, 2, 6))

    def conv(name, filters, k, **kw):
        cfg = dict({"name": name, "filters": filters, "kernel_size": [k, k],
                    "strides": [1, 1], "padding": "valid",
                    "data_format": "channels_last", "dilation_rate": [1, 1],
                    "activation": "linear", "use_bias": True}, **kw)
        return {"class_name": "Conv2D", "config": cfg}
    layers = [{"class_name": "InputLayer",
               "config": {"batch_shape": [None, 9, 9, 3],
                          "name": "input"}},
              conv("cv", 4, 3, padding="same", activation="relu"),
              conv("dil", 3, 3, dilation_rate=[2, 2]),
              {"class_name": "MaxPooling2D", "config": {
                  "name": "mp", "pool_size": [2, 2], "strides": [2, 2],
                  "padding": "valid", "data_format": "channels_last"}},
              {"class_name": "Reshape", "config": {"name": "rs",
                                                   "target_shape": [3, 4]}},
              {"class_name": "MaxPooling1D", "config": {
                  "name": "m1", "pool_size": [2], "strides": [1],
                  "padding": "valid"}},
              {"class_name": "LeakyReLU", "config": {"name": "lr",
                                                     "negative_slope": 0.1}}]
    spec = {"class_name": "Sequential", "config": {"layers": layers}}
    w = {"cv": [_f32(rng, 3, 3, 3, 4), _f32(rng, 4)],
         "dil": [_f32(rng, 3, 3, 4, 3), _f32(rng, 3)]}
    jm, tm = _both(json.dumps(spec), w, _f32(rng, 2, 3, 9, 9))
    assert tm._tf_ordered


def _h5_weights(path, weights, h5py, group=None):
    with h5py.File(path, "w") as f:
        g = f.create_group(group) if group else f
        g.attrs["layer_names"] = [n.encode() for n in weights]
        for n, ws in weights.items():
            sub = g.create_group(n)
            names = [f"{n}_p{i}".encode() for i in range(len(ws))]
            sub.attrs["weight_names"] = names
            for wn, a in zip(names, ws):
                sub.create_dataset(wn.decode(), data=a)
        return f


def test_hdf5_weights_and_full_model_match_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    json_def, w, x = _cnn_bn()
    path = str(tmp_path / "w.h5")
    _h5_weights(path, w, h5py)
    jm, tm = _both(json_def)
    JC.load_weights_hdf5(jm, path)
    PC.load_weights_hdf5(tm, path)
    _same_out(jm, tm, x)
    full = str(tmp_path / "full.h5")
    _h5_weights(full, w, h5py, group="model_weights")
    with h5py.File(full, "a") as f:
        f.attrs["model_config"] = json_def.encode()
        f.attrs["training_config"] = json.dumps({
            "optimizer": {"class_name": "RMSprop",
                          "config": {"lr": 0.003, "rho": 0.8}},
            "loss": "mse", "metrics": ["accuracy", "mae"]}).encode()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jfull = JC.load_keras(hdf5_path=full)
        tfull = PC.load_keras(hdf5_path=full, device="cpu")
    _same_out(jfull, tfull, x)
    assert type(tfull.optim_method).__name__ == "RMSprop"
    assert tfull.optim_method.learningrate == jfull.optim_method.learningrate
    assert tfull.metrics == jfull.metrics == ["accuracy"]
    jpath = str(tmp_path / "m.json")
    with open(jpath, "w") as f:
        f.write(json_def)
    jm2 = JC.load_keras(json_path=jpath, hdf5_path=full)
    tm2 = PC.load_keras(json_path=jpath, hdf5_path=full, device="cpu")
    _same_out(jm2, tm2, x)
    for kw in ({}, {"hdf5_path": path}):
        with pytest.raises(ValueError) as je:
            JC.load_keras(**kw)
        with pytest.raises(ValueError) as te:
            PC.load_keras(device="cpu", **kw)
        assert str(te.value) == str(je.value)


def test_non_strict_load_skips_unsupported_as_jax():
    spec = _seq([_layer("Dense", "d", output_dim=4,
                        batch_input_shape=[None, 3]),
                 _layer("MaxoutDense", "mx", output_dim=4, nb_feature=2)])
    rng = _r(13)
    w = {"d": [_f32(rng, 3, 4), _f32(rng, 4)]}
    jm, tm = _both(spec)
    msgs = []
    for conv, m in ((JC, jm), (PC, tm)):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            conv.load_weights(m, w, by_name=True, strict=False)
        msgs.append([str(r.message) for r in rec])
    assert msgs[0] == msgs[1] and any("mx" in m for m in msgs[1])
    close(tm._module().params["0"], jm._module().params["0"], TOL, "dense")


def test_mismatched_counts_fall_back_to_names_as_jax():
    json_def, w, x = _mlp()
    w = {"d2": w["d2"], "d1": w["d1"], "extra": [np.zeros(2, np.float32)]}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _both(json_def, w, x)


def _refusals():
    conv_th = _layer("Convolution2D", "c", nb_filter=2, nb_row=3, nb_col=3,
                     dim_ordering="th", batch_input_shape=[None, 3, 8, 8])
    tf_flat_bn = _seq([
        _layer("Convolution2D", "c", nb_filter=3, nb_row=3, nb_col=3,
               border_mode="same", dim_ordering="tf",
               batch_input_shape=[None, 6, 6, 2]),
        _layer("Flatten", "f"), _layer("BatchNormalization", "bn"),
        _layer("Dense", "d", output_dim=2)])
    rng = _r(30)
    tf_w = {"c": [_f32(rng, 3, 3, 2, 3), _f32(rng, 3)],
            "bn": [np.ones(108, np.float32), np.zeros(108, np.float32),
                   np.zeros(108, np.float32), np.ones(108, np.float32)],
            "d": [_f32(rng, 108, 2), _f32(rng, 2)]}
    return {
        "unknown_class": (_seq([_layer("FancyNewLayer", "x",
                                       batch_input_shape=[None, 3])]),
                          None, NotImplementedError),
        "bn_bad_axis": (_seq([conv_th, _layer("BatchNormalization", "bn",
                                              axis=-1)]),
                        None, NotImplementedError),
        "bn_mode_1": (_seq([_layer("BatchNormalization", "bn", mode=1,
                                   batch_input_shape=[None, 4])]),
                      None, NotImplementedError),
        "no_input_shape": (_seq([_layer("Dense", "d", output_dim=2)]),
                           None, ValueError),
        "unknown_model": (json.dumps({"class_name": "Graphs",
                                      "config": []}), None, ValueError),
        "maxout_weights": (_seq([_layer("MaxoutDense", "mx", output_dim=4,
                                        nb_feature=2,
                                        batch_input_shape=[None, 3])]),
                           {"mx": [np.zeros((2, 3, 4), np.float32)]},
                           NotImplementedError),
        "bidirectional_weights": (_seq([{
            "class_name": "Bidirectional", "config": {
                "name": "bi", "batch_input_shape": [None, 4, 3],
                "layer": {"class_name": "LSTM",
                          "config": {"output_dim": 2}}}}]),
            {"bi": [np.zeros((3, 8), np.float32)]}, NotImplementedError),
        "per_element_prelu": (_seq([_layer("PReLU", "p",
                                           batch_input_shape=[None, 3])]),
                              {"p": [np.array([0.1, 0.2, 0.3],
                                              np.float32)]},
                              NotImplementedError),
        "tf_flatten_bn_dense": (tf_flat_bn, tf_w, NotImplementedError),
        "shape_mismatch": (_seq([_layer("Dense", "d", output_dim=2,
                                        batch_input_shape=[None, 3])]),
                           {"d": [np.zeros((4, 2), np.float32),
                                  np.zeros(2, np.float32)]}, ValueError),
    }


REFUSALS = _refusals()


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_raise_as_jax(name):
    json_def, w, err = REFUSALS[name]
    outcomes = []
    for conv, kw in ((JC, {}), (PC, {"device": "cpu"})):
        with pytest.raises(err) as e:
            m = conv.model_from_json(json_def, **kw)
            conv.load_weights(m, w)
        outcomes.append(str(e.value))
    assert outcomes[0].split(":")[0] == outcomes[1].split(":")[0]


def test_training_config_compiles_as_jax():
    from bigdl_tpu_torch.keras.converter import _compile_from_training_config
    from bigdl_tpu.keras.converter import (
        _compile_from_training_config as jcompile)
    json_def, _, _ = _mlp()
    for cls, oc in (("SGD", {"lr": 0.05, "momentum": 0.9, "nesterov": True}),
                    ("Adam", {"lr": 0.002, "beta_1": 0.8}),
                    ("Adagrad", {"lr": 0.1}), ("Adadelta", {"rho": 0.9}),
                    ("Adamax", {"lr": 0.004}), ("Nadam", {})):
        tc = {"optimizer": {"class_name": cls, "config": oc},
              "loss": "categorical_crossentropy", "metrics": ["acc"]}
        jm = JC.model_from_json(json_def)
        tm = PC.model_from_json(json_def, device="cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jcompile(jm, tc)
            _compile_from_training_config(tm, tc)
        jo, to = getattr(jm, "optim_method", None), \
            getattr(tm, "optim_method", None)
        assert type(to).__name__ == type(jo).__name__
        if jo is not None:
            assert {k: v for k, v in vars(to).items()
                    if isinstance(v, (int, float))} == \
                {k: v for k, v in vars(jo).items()
                 if isinstance(v, (int, float))}
            assert tm.metrics == jm.metrics


# -- tensorflow: a live tf.keras model and a tf1 graph ------------------------

def test_with_bigdl_backend_follows_jax_on_a_live_tf_keras_model():
    tf = pytest.importorskip("tensorflow")
    keras = tf.keras
    from bigdl_tpu.keras import with_bigdl_backend as jwrap
    from bigdl_tpu_torch.keras import with_bigdl_backend
    rng = _r(0)
    km = keras.Sequential([
        keras.layers.Input(shape=(6,)),
        keras.layers.Dense(10, activation="relu", name="h"),
        keras.layers.Dense(3, activation="softmax", name="out")])
    km.compile(optimizer=keras.optimizers.SGD(learning_rate=0.05),
               loss="categorical_crossentropy", metrics=["accuracy"])
    jb, tb = jwrap(km), with_bigdl_backend(km, device="cpu")
    assert tb.model.metrics == jb.model.metrics == ["accuracy"]
    x = _f32(rng, 32, 6)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 32)]
    torch.testing.assert_close(torch.from_numpy(tb.predict(x)),
                               torch.from_numpy(km.predict(x, verbose=0)),
                               **TOL)
    jb.fit(x, y, batch_size=8, nb_epoch=2)
    tb.fit(x, y, batch_size=8, nb_epoch=2)
    close(tb.model._module().params, jb.model._module().params, STEP_TOL,
          "params")
    np.testing.assert_allclose(tb.evaluate(x, y, batch_size=8),
                               jb.evaluate(x, y, batch_size=8), atol=1e-4)
    assert np.array_equal(tb.predict_classes(x),
                          np.asarray(jb.predict_classes(x)))

    # a channels_last conv stack through to_json and the weights of the
    # live layers: the tf-ordered pipeline against keras itself (JAX's
    # converter is held on the same pipeline above, without tensorflow)
    kc = keras.Sequential([
        keras.layers.Input((8, 8, 3)),
        keras.layers.Conv2D(5, 3, activation="relu", padding="same"),
        keras.layers.MaxPooling2D(),
        keras.layers.Conv2D(4, 3),
        keras.layers.Flatten(),
        keras.layers.Dense(3)])
    kc.compile(optimizer="adam", loss="mse")
    xi = _f32(rng, 2, 8, 8, 3)
    ref = kc.predict(xi, verbose=0)
    tc = with_bigdl_backend(kc, device="cpu")
    got = tc.predict(xi.transpose(0, 3, 1, 2))
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_tf_utils_convert_matches_jax():
    tf = pytest.importorskip("tensorflow")
    from bigdl_tpu.util import tf_utils as jtu
    from bigdl_tpu_torch.util.tf_utils import convert as tconvert, dump_model
    tf1 = tf.compat.v1
    g = tf1.Graph()
    with g.as_default():
        x = tf1.placeholder(tf.float32, (None, 4), name="x")
        w = tf1.constant(_r(0).randn(4, 3), tf.float32)
        y = tf1.nn.relu(tf1.matmul(x, w), name="y")
    xin = _f32(_r(1), 2, 4)
    m = tconvert(["x:0"], ["y:0"], graph_def=g.as_graph_def(), device="cpu")
    jm = jtu.convert(["x:0"], ["y:0"], graph_def=g.as_graph_def())
    with tf1.Session(graph=g) as sess:
        ref = sess.run(y, {x: xin})
    out = m.evaluate().forward(torch.from_numpy(xin)).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    np.testing.assert_allclose(out, np.asarray(jm.evaluate().forward(xin)),
                               **TOL)
    with pytest.raises(NotImplementedError, match="MIGRATION"):
        dump_model("unused")

    # variables and a session: their live values are frozen in
    g2 = tf1.Graph()
    with g2.as_default():
        x2 = tf1.placeholder(tf.float32, (None, 4), name="x2")
        wv = tf1.get_variable("wv", initializer=_f32(_r(2), 4, 3))
        y2 = tf1.identity(tf1.matmul(x2, wv), name="y2")
        with tf1.Session(graph=g2) as sess:
            sess.run(tf1.global_variables_initializer())
            ref2 = sess.run(y2, {x2: xin})
            m2 = tconvert([x2.op], [y2.op], graph_def=g2.as_graph_def(),
                          sess=sess, device="cpu")
            with sess.as_default():
                m3 = tconvert(["x2"], ["y2"], device="cpu")
    for mm in (m2, m3):
        out2 = mm.evaluate().forward(torch.from_numpy(xin)).detach().numpy()
        np.testing.assert_allclose(out2, ref2, atol=1e-5)
