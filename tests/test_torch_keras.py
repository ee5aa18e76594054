"""The port's Keras-1.2 API (``bigdl_tpu_torch.keras``: ``topology.py``,
``layers.py``) against the JAX package's.

Every layer class is built by the same call in both packages inside a
``Sequential`` on the CPU; the built module trees must have the same
parameter names and shapes, the inferred output shape must be the shape
the forward gives, and output, new state, parameter and input gradients
of sum(sin(out / 2)) agree at 1e-5 on JAX's parameters redrawn from a
numpy seed (random layers in evaluation mode, BatchNorm in both modes).
The long-tail modes JAX refuses are refused alike. ``Sequential`` and
``Model`` training (``compile`` / ``fit`` / ``evaluate`` / ``predict``)
follows JAX's ``LocalOptimizer`` trajectory within 1e-4 after the steps,
with JAX's label handling (one-hot and 0-based labels to 1-based).
"""
import numpy as np
import pytest
import torch

from bigdl_tpu import keras as JK
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import keras as PK
from torch_parity_helpers import check_pair, close

torch.set_num_threads(1)
STEP_TOL = dict(atol=1e-4, rtol=1e-4)     # after training steps


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _ids(n, *shape, seed=0):
    return np.random.RandomState(seed).randint(0, n, shape).astype(
        np.float32)


def _masked(*shape, seed=0):
    x = _x(*shape, seed=seed)
    x[:, 1] = 0.0          # a masked time step
    return x


def _bn_state(js):
    rng = np.random.RandomState(9)
    return {k: (rng.rand(*np.shape(v)) + 0.5).astype(np.float32)
            if "var" in k else rng.randn(*np.shape(v)).astype(np.float32)
            for k, v in js.items()} if js and all(
        not isinstance(v, dict) for v in js.values()) else js


def _state(js):
    """Non-trivial running statistics wherever the tree holds them."""
    if isinstance(js, dict):
        if "running_mean" in js:
            return _bn_state(js)
        return {k: _state(v) for k, v in js.items()}
    return js


# (name, factory over the keras package, input, training modes)
CASES = [
    ("Dense", lambda K: K.Dense(5, activation="relu", input_shape=(4,)),
     _x(3, 4), (False,)),
    ("Dense_3d", lambda K: K.Dense(5, input_shape=(3, 4)), _x(2, 3, 4),
     (False,)),
    ("Dense_nobias", lambda K: K.Dense(5, activation="tanh",
                                       with_bias=False, input_dim=4),
     _x(3, 4), (False,)),
    ("Activation", lambda K: K.Activation("softplus", input_shape=(6,)),
     _x(3, 6), (False,)),
    ("Dropout", lambda K: K.Dropout(0.3, input_shape=(6,)), _x(3, 6),
     (False,)),
    ("Flatten", lambda K: K.Flatten(input_shape=(2, 3, 4)), _x(2, 2, 3, 4),
     (False,)),
    ("Reshape", lambda K: K.Reshape((4, -1), input_shape=(2, 3, 4)),
     _x(2, 2, 3, 4), (False,)),
    ("Permute", lambda K: K.Permute((3, 1, 2), input_shape=(2, 3, 4)),
     _x(2, 2, 3, 4), (False,)),
    ("RepeatVector", lambda K: K.RepeatVector(3, input_shape=(4,)),
     _x(2, 4), (False,)),
    ("Convolution2D", lambda K: K.Convolution2D(
        4, 3, 3, activation="relu", border_mode="same", subsample=(2, 2),
        input_shape=(2, 7, 7)), _x(2, 2, 7, 7), (False,)),
    ("Convolution2D_valid", lambda K: K.Convolution2D(
        3, 2, 3, bias=False, input_shape=(2, 6, 7)), _x(2, 2, 6, 7),
     (False,)),
    ("Convolution1D", lambda K: K.Convolution1D(
        4, 3, activation="relu", subsample_length=2, input_shape=(9, 3)),
     _x(2, 9, 3), (False,)),
    ("MaxPooling2D", lambda K: K.MaxPooling2D(
        (3, 3), strides=(2, 2), border_mode="same", input_shape=(2, 9, 9)),
     _x(2, 2, 9, 9), (False,)),
    ("AveragePooling2D", lambda K: K.AveragePooling2D(
        (2, 2), border_mode="same", input_shape=(2, 7, 7)),
     _x(2, 2, 7, 7), (False,)),
    ("GlobalAveragePooling2D", lambda K: K.GlobalAveragePooling2D(
        input_shape=(3, 4, 5)), _x(2, 3, 4, 5), (False,)),
    ("GlobalMaxPooling2D", lambda K: K.GlobalMaxPooling2D(
        input_shape=(3, 4, 5)), _x(2, 3, 4, 5), (False,)),
    ("MaxPooling1D", lambda K: K.MaxPooling1D(2, input_shape=(8, 3)),
     _x(2, 8, 3), (False,)),
    ("GlobalAveragePooling1D", lambda K: K.GlobalAveragePooling1D(
        input_shape=(5, 3)), _x(2, 5, 3), (False,)),
    ("ZeroPadding2D", lambda K: K.ZeroPadding2D((1, 2),
                                                input_shape=(2, 3, 3)),
     _x(2, 2, 3, 3), (False,)),
    ("UpSampling2D", lambda K: K.UpSampling2D((2, 3), input_shape=(2, 3, 3)),
     _x(2, 2, 3, 3), (False,)),
    ("Cropping2D", lambda K: K.Cropping2D(((1, 0), (0, 2)),
                                          input_shape=(2, 5, 6)),
     _x(2, 2, 5, 6), (False,)),
    ("BatchNormalization", lambda K: K.BatchNormalization(
        input_shape=(4, 5, 5)), _x(3, 4, 5, 5), (False, True)),
    ("BatchNormalization_1d", lambda K: K.BatchNormalization(
        epsilon=1e-5, momentum=0.9, input_shape=(6,)), _x(8, 6),
     (False, True)),
    ("Embedding", lambda K: K.Embedding(10, 4, input_length=5),
     _ids(10, 3, 5), (False,)),
    ("LSTM", lambda K: K.LSTM(5, return_sequences=True, input_shape=(4, 3)),
     _x(2, 4, 3), (False,)),
    ("GRU", lambda K: K.GRU(5, go_backwards=True, input_shape=(4, 3)),
     _x(2, 4, 3), (False,)),
    ("SimpleRNN", lambda K: K.SimpleRNN(5, input_shape=(4, 3)),
     _x(2, 4, 3), (False,)),
    ("Bidirectional", lambda K: K.Bidirectional(
        K.LSTM(4, return_sequences=True), input_shape=(5, 3)),
     _x(2, 5, 3), (False,)),
    ("Bidirectional_sum", lambda K: K.Bidirectional(
        K.GRU(4), merge_mode="sum", input_shape=(5, 3)), _x(2, 5, 3),
     (False,)),
    ("TimeDistributed", lambda K: K.TimeDistributed(
        K.Dense(4, activation="tanh"), input_shape=(5, 3)), _x(2, 5, 3),
     (False,)),
    ("Highway", lambda K: K.Highway(input_shape=(5,)), _x(3, 5), (False,)),
    ("LeakyReLU", lambda K: K.LeakyReLU(0.2, input_shape=(6,)), _x(3, 6),
     (False,)),
    ("ELU", lambda K: K.ELU(0.7, input_shape=(6,)), _x(3, 6), (False,)),
    ("ThresholdedReLU", lambda K: K.ThresholdedReLU(0.5, input_shape=(6,)),
     _x(3, 6), (False,)),
    ("GaussianNoise", lambda K: K.GaussianNoise(0.1, input_shape=(6,)),
     _x(3, 6), (False,)),
    ("GaussianDropout", lambda K: K.GaussianDropout(0.2, input_shape=(6,)),
     _x(3, 6), (False,)),
    ("SpatialDropout2D", lambda K: K.SpatialDropout2D(
        0.3, input_shape=(2, 4, 4)), _x(2, 2, 4, 4), (False,)),
    ("Masking", lambda K: K.Masking(0.0, input_shape=(4, 3)),
     _masked(2, 4, 3), (False,)),
    ("SoftMax", lambda K: K.SoftMax(input_shape=(7,)), _x(3, 7), (False,)),
    ("AtrousConvolution2D", lambda K: K.AtrousConvolution2D(
        4, 3, 3, atrous_rate=(2, 2), input_shape=(2, 9, 9)),
     _x(2, 2, 9, 9), (False,)),
    ("AtrousConvolution1D", lambda K: K.AtrousConvolution1D(
        4, 3, atrous_rate=2, activation="tanh", input_shape=(10, 5)),
     _x(2, 10, 5), (False,)),
    ("SeparableConvolution2D", lambda K: K.SeparableConvolution2D(
        6, 3, 3, border_mode="same", depth_multiplier=2,
        input_shape=(2, 6, 6)), _x(2, 2, 6, 6), (False,)),
    ("Deconvolution2D", lambda K: K.Deconvolution2D(
        3, 3, 3, subsample=(2, 2), activation="relu",
        input_shape=(2, 4, 4)), _x(2, 2, 4, 4), (False,)),
    ("Convolution3D", lambda K: K.Convolution3D(
        4, 2, 3, 3, input_shape=(2, 4, 5, 5)), _x(2, 2, 4, 5, 5),
     (False,)),
    ("LocallyConnected1D", lambda K: K.LocallyConnected1D(
        4, 3, input_shape=(7, 3)), _x(2, 7, 3), (False,)),
    ("LocallyConnected2D", lambda K: K.LocallyConnected2D(
        4, 3, 3, input_shape=(2, 6, 6)), _x(2, 2, 6, 6), (False,)),
    ("LocallyConnected2D_same", lambda K: K.LocallyConnected2D(
        3, 4, 4, border_mode="same", input_shape=(2, 5, 5)),
     _x(2, 2, 5, 5), (False,)),
    ("Cropping1D", lambda K: K.Cropping1D((1, 2), input_shape=(8, 3)),
     _x(2, 8, 3), (False,)),
    ("Cropping3D", lambda K: K.Cropping3D(((1, 1), (0, 1), (1, 0)),
                                          input_shape=(2, 5, 6, 6)),
     _x(2, 2, 5, 6, 6), (False,)),
    ("ZeroPadding1D", lambda K: K.ZeroPadding1D((1, 2), input_shape=(5, 3)),
     _x(2, 5, 3), (False,)),
    ("ZeroPadding3D", lambda K: K.ZeroPadding3D((1, 2, 1),
                                                input_shape=(2, 3, 4, 4)),
     _x(2, 2, 3, 4, 4), (False,)),
    ("UpSampling1D", lambda K: K.UpSampling1D(3, input_shape=(4, 2)),
     _x(2, 4, 2), (False,)),
    ("UpSampling3D", lambda K: K.UpSampling3D((2, 1, 2),
                                              input_shape=(2, 2, 3, 3)),
     _x(2, 2, 2, 3, 3), (False,)),
    ("AveragePooling1D", lambda K: K.AveragePooling1D(
        3, 2, border_mode="same", input_shape=(9, 3)), _x(2, 9, 3),
     (False,)),
    ("MaxPooling3D", lambda K: K.MaxPooling3D((2, 2, 2),
                                              input_shape=(2, 4, 6, 6)),
     _x(2, 2, 4, 6, 6), (False,)),
    ("AveragePooling3D", lambda K: K.AveragePooling3D(
        (2, 2, 2), strides=(1, 2, 2), input_shape=(2, 4, 6, 6)),
     _x(2, 2, 4, 6, 6), (False,)),
    ("GlobalMaxPooling1D", lambda K: K.GlobalMaxPooling1D(
        input_shape=(7, 4)), _x(2, 7, 4), (False,)),
    ("GlobalMaxPooling3D", lambda K: K.GlobalMaxPooling3D(
        input_shape=(3, 4, 5, 5)), _x(2, 3, 4, 5, 5), (False,)),
    ("GlobalAveragePooling3D", lambda K: K.GlobalAveragePooling3D(
        input_shape=(3, 4, 5, 5)), _x(2, 3, 4, 5, 5), (False,)),
    ("ConvLSTM2D_seq", lambda K: K.ConvLSTM2D(
        3, 3, return_sequences=True, input_shape=(3, 2, 5, 5)),
     _x(2, 3, 2, 5, 5), (False,)),
    ("ConvLSTM2D", lambda K: K.ConvLSTM2D(
        3, 3, go_backwards=True, input_shape=(3, 2, 5, 5)),
     _x(2, 3, 2, 5, 5), (False,)),
    ("MaxoutDense", lambda K: K.MaxoutDense(6, 3, input_shape=(5,)),
     _x(3, 5), (False,)),
    ("PReLU", lambda K: K.PReLU(input_shape=(4, 5)), _x(2, 4, 5), (False,)),
    ("SReLU", lambda K: K.SReLU(input_shape=(4, 5)), _x(2, 4, 5), (False,)),
    ("SpatialDropout1D", lambda K: K.SpatialDropout1D(
        0.3, input_shape=(6, 4)), _x(2, 6, 4), (False,)),
    ("SpatialDropout3D", lambda K: K.SpatialDropout3D(
        0.3, input_shape=(2, 3, 4, 4)), _x(2, 2, 3, 4, 4), (False,)),
]


def test_the_cases_cover_every_layer_class():
    import inspect
    from bigdl_tpu_torch.keras import layers
    classes = {n for n, v in vars(layers).items()
               if inspect.isclass(v) and issubclass(v, PK.KerasLayer)
               and not n.startswith("_") and v.__module__ == layers.__name__}
    covered = {type(f(PK)).__name__ for _, f, _, _ in CASES} | {"Merge"}
    assert classes == covered, classes ^ covered
    assert len(classes) == 60


@pytest.mark.parametrize("name,make,x,modes", CASES,
                         ids=[c[0] for c in CASES])
def test_layer_matches_jax(name, make, x, modes):
    jm = JK.Sequential().add(make(JK))
    tm = PK.Sequential(device="cpu").add(make(PK))
    assert tm.output_shape == jm.output_shape
    for training in modes:
        out = check_pair(jm._module(), tm._module(), x, training,
                         state=_state, jit=True)
        assert tuple(out.shape) == (x.shape[0],) + tuple(tm.output_shape)


@pytest.mark.parametrize("mode", ["sum", "mul", "max", "ave", "concat",
                                  "dot"])
def test_functional_merge_matches_jax(mode):
    def build(K, **kw):
        inp = K.Input(shape=(6,))
        a = K.Dense(4, activation="relu")(inp)
        b = K.Dense(4, activation="tanh")(inp)
        m = K.Merge(mode=mode)([a, b])
        # 'dot' gives one value a row (its inferred shape is JAX's)
        out = m if mode == "dot" else K.Dense(3)(m)
        return K.Model(inp, out, **kw), m
    jm, jmerged = build(JK)
    tm, tmerged = build(PK, device="cpu")
    assert tmerged.shape == jmerged.shape and tm.output_shape == \
        jm.output_shape
    check_pair(jm._module(), tm._module(), _x(5, 6), False, jit=True)


@pytest.mark.parametrize("make", [
    lambda K: K.AtrousConvolution2D(4, 3, 3, border_mode="same"),
    lambda K: K.AtrousConvolution1D(4, 3, border_mode="same"),
    lambda K: K.Deconvolution2D(4, 3, 3, border_mode="same"),
    lambda K: K.ConvLSTM2D(4, 3, activation="relu"),
    lambda K: K.ConvLSTM2D(4, 3, border_mode="valid")],
    ids=["atrous2d_same", "atrous1d_same", "deconv_same", "convlstm_relu",
         "convlstm_valid"])
def test_unsupported_modes_raise_as_jax(make):
    with pytest.raises(ValueError) as je:
        make(JK)
    with pytest.raises(ValueError) as te:
        make(PK)
    assert str(te.value) == str(je.value)


def test_sequential_needs_an_input_shape_and_a_card_unless_cpu(monkeypatch):
    with pytest.raises(ValueError, match="input_shape"):
        PK.Sequential(device="cpu").add(PK.Dense(3))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: PK.Sequential(),
                 lambda: PK.Model(PK.Input((3,)), PK.Input((3,)))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def _twins(build, x, y, seed=0):
    """The JAX model and the port's with JAX's initial weights."""
    jm, tm = build(JK, {}), build(PK, {"device": "cpu"})
    jmod = jm._module()
    jmod.ensure_initialized()
    tm._module().load_state_dict(convert.jax_to_state_dict(
        jmod.params, jmod.state or {}))
    return jm, tm


def _seq_mlp(K, kw):
    m = K.Sequential(**kw)
    # BatchNorm first: after a biased layer it would leave that bias a
    # gradient of rounding noise, which Adam scales up to steps of lr
    m.add(K.BatchNormalization(input_shape=(6,)))
    m.add(K.Dense(16, activation="relu"))
    m.add(K.Dense(4))
    return m


def _func_merge(K, kw):
    inp = K.Input(shape=(6,))
    a = K.Dense(8, activation="tanh")(inp)
    b = K.Dense(8, activation="relu")(inp)
    out = K.Dense(3, activation="softmax")(K.Merge(mode="concat")([a, b]))
    return K.Model(inp, out, **kw)


@pytest.mark.parametrize("build,opt,loss,labels", [
    (_seq_mlp, "sgd", "sparse_categorical_crossentropy", "zero_based"),
    (_seq_mlp, "adam", "sparse_categorical_crossentropy", "one_hot"),
    (_func_merge, "rmsprop", "categorical_crossentropy", "one_hot"),
    (_func_merge, "sgd", "mse", "one_hot")],
    ids=["seq_sgd_0based", "seq_adam_onehot", "model_rmsprop_cce",
         "model_sgd_mse"])
def test_fit_evaluate_predict_follow_jax(build, opt, loss, labels):
    rng = np.random.RandomState(3)
    x = rng.randn(24, 6).astype(np.float32)
    n_cls = 4 if build is _seq_mlp else 3
    cls = rng.randint(0, n_cls, 24)
    y = np.eye(n_cls, dtype=np.float32)[cls] if labels == "one_hot" \
        else cls
    jm, tm = _twins(build, x, y)
    for m in (jm, tm):
        m.compile(opt, loss, ["accuracy"])
        m.fit(x, y, batch_size=8, nb_epoch=2)
    jmod = jm._module()
    close(tm._module().params, jmod.params, STEP_TOL, "params")
    close(convert.to_numpy_tree(tm._module().state), jmod.state or {},
          STEP_TOL, "state")
    torch.testing.assert_close(
        torch.from_numpy(tm.predict(x[:10], batch_size=4)),
        torch.from_numpy(np.asarray(jm.predict(x[:10], batch_size=4))),
        **STEP_TOL)
    assert np.array_equal(tm.predict_classes(x, zero_based_label=False),
                          np.asarray(jm.predict_classes(
                              x, zero_based_label=False)))
    jv, tv = jm.evaluate(x, y, batch_size=8), tm.evaluate(x, y, batch_size=8)
    np.testing.assert_allclose(tv, jv, atol=1e-4, rtol=1e-4)
    kinds = [[ln.rsplit(" (", 1)[-1] for ln in m.summary().splitlines()]
             for m in (jm, tm)]
    assert kinds[0] == kinds[1]


def test_fit_with_validation_data_follows_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(32, 6).astype(np.float32)
    y = rng.randint(0, 4, 32)
    jm, tm = _twins(_seq_mlp, x, y)
    for m in (jm, tm):
        m.compile("sgd", "sparse_categorical_crossentropy", ["accuracy"])
        m.fit(x, y, batch_size=8, nb_epoch=1, validation_data=(x[:8], y[:8]))
    close(tm._module().params, jm._module().params, STEP_TOL, "params")
    assert tm.history.validation_trigger is not None


def test_labels_are_made_one_based_as_jax():
    m = PK.Sequential(device="cpu").add(PK.Dense(3, input_shape=(2,)))
    x = np.zeros((3, 2), np.float32)
    m.compile("sgd", "sparse_categorical_crossentropy")
    ys = [s.labels[0] for s in m._to_samples(x, np.array([0, 2, 1]))]
    assert [float(v) for v in ys] == [1.0, 3.0, 2.0]
    ys = [s.labels[0] for s in m._to_samples(x, np.eye(3)[[2, 0, 1]])]
    assert [float(v) for v in ys] == [3.0, 1.0, 2.0]
    m.compile("sgd", "mse")
    ys = [s.labels[0] for s in m._to_samples(x, np.array([0., 2., 1.]))]
    assert [float(v) for v in ys] == [0.0, 2.0, 1.0]
