"""The port's ``util`` package (``util/common.py``, ``util/_parity.py``)
against the JAX package's, and the pyspark module paths of
``test_parity_paths.py`` the port now has (``nn.keras``, ``dlframes``,
``util``). ``util.tf_utils`` needs tensorflow and is held against JAX's in
``test_torch_keras_converter.py`` (one file imports tensorflow)."""
import logging
import random

import numpy as np
import pytest
import torch

from bigdl_tpu.util import common as jcommon
from bigdl_tpu_torch.util import common
from bigdl_tpu_torch.utils import engine

torch.set_num_threads(1)


def test_jtensor_round_trips_as_jax():
    data = np.random.RandomState(123).uniform(0, 1, (2, 3)).astype("float32")
    for mod in (jcommon, common):
        t = mod.JTensor.from_ndarray(data)
        assert list(t.shape) == [2, 3] and (t.to_ndarray() == data).all()
        t2 = mod.JTensor(t.storage.tobytes(),
                         np.array([2, 3], np.int32).tobytes())
        assert (t2.to_ndarray() == data).all()
        assert repr(t) == "JTensor[Dense](2, 3)"
        d = mod.JTensor.from_ndarray(data.astype(np.float64), "double")
        assert d.storage.dtype == np.float64
    vals = np.array([1.0, 2.0], np.float32)
    idx = np.array([[0, 0], [1, 2]], np.int32)
    ts = [mod.JTensor.sparse(vals, idx, np.array([3, 4]))
          for mod in (jcommon, common)]
    for a in ("storage", "shape", "indices"):
        np.testing.assert_array_equal(getattr(ts[1], a), getattr(ts[0], a))
    assert repr(ts[1]) == repr(ts[0]) == "JTensor[Sparse](3, 4)"
    with pytest.raises(AssertionError):
        ts[1].to_ndarray()


@pytest.fixture
def saved_engine():
    """The process's engine, generators and process group as they were."""
    saved = (dict(engine._state), torch.get_rng_state(),
             np.random.get_state(), random.getstate())
    yield
    engine.destroy_process_group()
    engine._state.clear()
    engine._state.update(saved[0])
    torch.set_rng_state(saved[1])
    np.random.set_state(saved[2])
    random.setstate(saved[3])


def test_rng_draws_equal_jax_and_seed_the_engine(saved_engine):
    a, b = common.RNG(), jcommon.RNG()
    a.set_seed(7)
    b.set_seed(7)
    np.testing.assert_array_equal(a.uniform(0, 1, (3, 4)),
                                  b.uniform(0, 1, (3, 4)))
    assert engine.get_seed() == 7
    first = torch.rand(3)
    common.RNG().set_seed(7)
    torch.testing.assert_close(torch.rand(3), first, rtol=0, atol=0)
    d = common.RNG("double")
    d.set_seed(1)
    assert d.uniform(0, 1, 2).dtype == np.float64
    assert common.get_dtype("double") is jcommon.get_dtype("double")
    assert common.get_dtype() is jcommon.get_dtype()


def test_engine_helpers_and_samples(saved_engine):
    common.init_engine(device="cpu")
    assert engine.is_initialized()
    assert engine.process_group()["backend"] == "gloo"
    assert common.get_node_and_core_number(device="cpu") == (1, 1)
    common.init_engine(device="cpu")          # once
    assert common.to_list(3) == jcommon.to_list(3) == [3]
    assert common.to_list([3]) == [3]
    x, y = np.arange(8.0).reshape(4, 2), np.arange(4.0)
    got, want = common.to_sample_rdd(x, y), jcommon.to_sample_rdd(x, y)
    assert len(got) == len(want) == 4
    assert isinstance(got[0], common.Sample)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.feature(), w.feature())
        np.testing.assert_array_equal(g.label(), w.label())


def test_to_sample_rdd_feeds_the_optimizer():
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, max_iteration
    rng = np.random.RandomState(0)
    x = rng.randn(16, 3).astype(np.float32)
    y = (rng.randint(0, 2, 16) + 1).astype(np.float32)
    m = nn.Sequential(nn.Linear(3, 2), nn.LogSoftMax())
    before = m.get_weights()
    LocalOptimizer(m, common.to_sample_rdd(x, y), nn.ClassNLLCriterion(),
                   SGD(0.5), max_iteration(2), 8, device="cpu").optimize()
    assert not np.allclose(m.get_weights()["0"]["weight"],
                           before["0"]["weight"])


def test_spark_helpers_raise_with_the_port_s_path():
    for fn in (common.create_spark_conf, common.get_spark_context,
               common.get_spark_sql_context):
        with pytest.raises(NotImplementedError) as e:
            fn()
        assert "torch.distributed" in str(e.value)
        assert "jax" not in str(e.value)


def test_log_redirect_dedups_handlers(tmp_path):
    p = str(tmp_path / "bigdl.log")
    common.redire_spark_logs(log_path=p)
    common.redire_spark_logs(log_path=p)
    common.show_bigdl_info_logs()
    log = logging.getLogger("bigdl_tpu_torch")
    assert log.level == logging.INFO
    try:
        log.warning("once-only line")
        with open(p) as f:
            assert f.read().count("once-only line") == 1
    finally:
        h = common._log_handlers.pop(str(tmp_path.joinpath("bigdl.log")))
        log.removeHandler(h)
        h.close()
        log.setLevel(logging.NOTSET)


def test_public_names_keep_to_the_port():
    from bigdl_tpu.util._parity import public_names as jnames
    from bigdl_tpu_torch.keras import layers, topology
    from bigdl_tpu_torch.util._parity import public_names
    from bigdl_tpu.keras import layers as jlayers
    assert public_names(layers) == jnames(jlayers)
    assert "np" not in public_names(layers)
    assert "Sequential" in public_names(topology)
    assert public_names(jlayers) == []   # JAX's classes are not the port's
    assert jnames(layers) == []


# -- the pyspark module paths (test_parity_paths.py) -------------------------

def test_util_common_path():
    from bigdl_tpu_torch.util.common import init_engine, JTensor, Sample  # noqa
    from bigdl_tpu_torch.dataset.sample import Sample as S2
    assert Sample is S2


def test_dlframes_paths():
    from bigdl_tpu_torch.dlframes.dl_classifier import (  # noqa
        DLEstimator, DLModel, DLClassifier, DLClassifierModel)
    from bigdl_tpu_torch.dlframes.dl_image_transformer import (  # noqa
        DLImageTransformer)
    from bigdl_tpu_torch.dlframes import DLClassifier as C2
    assert DLClassifier is C2


def test_nn_keras_paths():
    from bigdl_tpu_torch.keras import layers, topology
    from bigdl_tpu_torch.nn.keras import layer, topology as ntopology
    from bigdl_tpu_torch.nn.keras.layer import Dense, Input, InputLayer
    from bigdl_tpu_torch.nn.keras.topology import Sequential
    assert Dense is layers.Dense and Sequential is topology.Sequential
    assert Input is topology.Input and InputLayer is topology.InputLayer
    import bigdl_tpu.nn.keras.layer as jlayer
    import bigdl_tpu.nn.keras.topology as jtopology
    assert sorted(layer.__all__) == sorted(jlayer.__all__)
    assert sorted(ntopology.__all__) == sorted(jtopology.__all__)
    m = Sequential(device="cpu")
    m.add(Dense(4, input_shape=(3,)))
    out = m.predict(np.ones((2, 3), "float32"))
    assert np.asarray(out).shape == (2, 4)
