"""``Module.save`` / ``load`` / ``clone`` / ``init`` /
``get_extra_parameter`` / ``set_extra_parameter`` / ``predict`` /
``predict_class`` and ``Predictor`` on the port, against the JAX
package's:

* ``save`` writes JAX's payload keys, and its ``params`` / ``state`` equal
  those of JAX's file for the same weights (a BatchNorm model); ``load``
  rebuilds the model bit for bit, and refuses a JAX pickle without
  importing ``bigdl_tpu`` (checked in a fresh process);
* ``clone`` shares no storage; ``init`` draws new trees and leaves the
  module as it was;
* ``get_extra_parameter`` returns the state leaves in JAX's
  ``tree_leaves`` order (ResNetCifar-20's BatchNorm statistics), and
  ``set_extra_parameter`` round-trips them;
* ``predict`` / ``predict_class`` / ``Predictor`` over 20 samples at batch
  8 (a ragged last batch, padded to its bucket and sliced back), per batch
  and under ``set_superstep(2)``, within 1e-5 of JAX's."""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.observability as jobs  # noqa: F401 - JAX's registry
import bigdl_tpu_torch.observability as tobs
from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import DataSet as JaxDataSet, Sample as JaxSample
from bigdl_tpu.models import resnet as jresnet
from bigdl_tpu.optim.predictor import Predictor as JaxPredictor
from bigdl_tpu_torch import convert, models, nn
from bigdl_tpu_torch.dataset import (DataSet, FuncTransformer, Sample,
                                     TransformedDataSet)
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.optim.predictor import (PredictionService, Predictor,
                                             leading_dim)
from bigdl_tpu_torch.utils.table import Table
from tests.torch_loop_helpers import bn_net, mlp, twins

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bn_twins():
    """bn_net in both packages with the same weights and nonzero running
    statistics."""
    jm, tm, w = twins(bn_net)
    rng = np.random.RandomState(3)
    st = {k: (rng.rand(*v.shape) + 0.5).astype(np.float32)
          for k, v in convert.flatten(convert.host_copy_tree(tm.state))
          .items()}
    from bigdl_tpu_torch.nn.module import copy_tree_into
    copy_tree_into(tm.state, convert.unflatten(st))
    jm.state = jax.tree_util.tree_map(jnp.array, convert.unflatten(st))
    return jm, tm


def _equal(a, b):
    fa, fb = convert.flatten(a), convert.flatten(b)
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]),
                                      err_msg=k)


def test_save_payload_equals_jax_file(tmp_path):
    jm, tm = _bn_twins()
    tm.save(str(tmp_path / "port.bigdl"))
    jm.save(str(tmp_path / "jax.bigdl"))
    with open(tmp_path / "jax.bigdl", "rb") as f:
        want = pickle.load(f)
    with open(tmp_path / "port.bigdl", "rb") as f:
        got = pickle.load(f)
    assert set(got) == set(want) == {"module", "params", "state"}
    _equal(got["params"], jax.tree_util.tree_map(np.asarray,
                                                 want["params"]))
    _equal(got["state"], jax.tree_util.tree_map(np.asarray, want["state"]))
    # the pickled module holds no storage
    assert all(p.device.type == "meta" for p in got["module"].parameters())
    assert got["module"].grad_params is None


def test_load_rebuilds_the_model_bit_for_bit(tmp_path):
    _, tm = _bn_twins()
    tm.evaluate()
    path = str(tmp_path / "m.bigdl")
    tm.save(path)
    with pytest.raises(IOError):
        tm.save(path, overwrite=False)
    m = Module.load(path, device="cpu")
    assert type(m) is type(tm) and m is not tm
    _equal(convert.host_copy_tree(m.params),
           convert.host_copy_tree(tm.params))
    _equal(convert.host_copy_tree(m.state), convert.host_copy_tree(tm.state))
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 6, 6, 3)
                         .astype(np.float32))
    m.evaluate()
    torch.testing.assert_close(m.forward(x), tm.forward(x), rtol=0, atol=0)


def test_load_refuses_a_jax_pickle_without_importing_it(tmp_path):
    jm, _ = _bn_twins()
    path = str(tmp_path / "jax.bigdl")
    jm.save(path)
    code = (
        "import pickle, sys\n"
        "from bigdl_tpu_torch.nn.module import Module\n"
        "try:\n"
        f"    Module.load({path!r}, device='cpu')\n"
        "except pickle.UnpicklingError as e:\n"
        "    print('REFUSED', 'load_weights' in str(e),"
        " 'convert' in str(e))\n"
        "print('IMPORTED', any(m == 'bigdl_tpu' or"
        " m.startswith('bigdl_tpu.') for m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={**os.environ, "PYTHONPATH": REPO},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "REFUSED True True" in out.stdout
    assert "IMPORTED False" in out.stdout


def test_clone_shares_no_storage_and_a_step_leaves_the_original():
    _, tm = _bn_twins()
    c = tm.clone()
    before = convert.host_copy_tree(tm.params)
    ptrs = {p.data_ptr() for p in tm.parameters()}
    assert not ptrs & {p.data_ptr() for p in c.parameters()}
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, max_iteration
    rng = np.random.RandomState(1)
    data = [Sample(rng.randn(6, 6, 3).astype(np.float32),
                   np.float32(rng.randint(1, 4))) for _ in range(8)]
    LocalOptimizer(c, data, nn.CrossEntropyCriterion(), SGD(0.5),
                   max_iteration(1), 8, device="cpu").optimize()
    _equal(convert.host_copy_tree(tm.params), before)
    moved = convert.flatten(convert.host_copy_tree(c.params))
    assert any(not np.array_equal(moved[k], v)
               for k, v in convert.flatten(before).items())


def test_init_draws_new_trees_and_keeps_the_module():
    _, tm = _bn_twins()
    before = convert.host_copy_tree(tm.params)
    p1, s1 = tm.init(torch.Generator().manual_seed(5))
    p2, _ = tm.init(torch.Generator().manual_seed(5))
    _equal(convert.host_copy_tree(tm.params), before)
    _equal(convert.host_copy_tree(p1), convert.host_copy_tree(p2))
    assert set(convert.flatten(p1)) == set(convert.flatten(before))
    assert not all(np.array_equal(a, b) for a, b in zip(
        convert.flatten(convert.host_copy_tree(p1)).values(),
        convert.flatten(before).values()))
    # the state is reset to its initial values (unit variance, zero mean)
    for k, v in convert.flatten(s1).items():
        assert float(v.abs().sum()) == (0.0 if "mean" in k else v.numel())
    fresh = tm.clone().reset(torch.Generator().manual_seed(5))
    _equal(convert.host_copy_tree(fresh.params), convert.host_copy_tree(p1))


def test_extra_parameters_in_jax_order():
    """ResNetCifar-20 (BatchNorm after every convolution): distinct values
    per JAX state leaf, carried into the port, come back from
    ``get_extra_parameter`` in JAX's ``tree_leaves`` order."""
    jm = jresnet.ResNetCifar(10, 20)
    tm = models.ResNetCifar(10, 20, device="cpu")
    jp, js = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    leaves, treedef = jax.tree_util.tree_flatten(js)
    vals = [(rng.rand(*l.shape) + i).astype(np.float32)
            for i, l in enumerate(leaves)]
    jm.params = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype), jp)
    jm.state = jax.tree_util.tree_unflatten(treedef,
                                            [jnp.array(v) for v in vals])
    from bigdl_tpu_torch.nn.module import copy_tree_into
    copy_tree_into(tm.state, jax.tree_util.tree_map(np.asarray, jm.state))
    got = tm.get_extra_parameter()
    want = jm.get_extra_parameter()
    assert len(got) == len(want) == len(leaves) > 20
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # a round trip, bit for bit, and the copies are not the live tensors
    new = [g * 0.5 + 1 for g in got]
    tm.set_extra_parameter(new)
    for a, b in zip(tm.get_extra_parameter(), new):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    got[0].zero_()
    assert float(tm.get_extra_parameter()[0].abs().sum()) > 0
    with pytest.raises(ValueError, match="expected"):
        tm.set_extra_parameter(new[:-1])
    with pytest.raises(ValueError, match="shape"):
        tm.set_extra_parameter([torch.zeros(3)] + new[1:])


def _pred_twins():
    jm, tm, _ = twins(mlp)
    rng = np.random.RandomState(4)
    xs = rng.randn(20, 6).astype(np.float32)
    return jm, tm, xs


@pytest.mark.parametrize("k", [1, 2], ids=["per_batch", "superstep2"])
@pytest.mark.parametrize("prefetch", [0, 2])
def test_predictor_matches_jax_with_a_ragged_last_batch(k, prefetch):
    jm, tm, xs = _pred_twins()
    tm.evaluate()
    jm.evaluate()
    tp = Predictor(tm, prefetch_depth=prefetch).set_superstep(k)
    jpred = JaxPredictor(jm, prefetch_depth=prefetch).set_superstep(k)
    tds = DataSet.array([Sample(x) for x in xs])
    jds = JaxDataSet.array([JaxSample(x) for x in xs])
    got = tp.predict(tds, 8)
    want = jpred.predict(jds, 8)
    assert got.shape == (20, 3)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_array_equal(tp.predict_class(tds, 8),
                                  jpred.predict_class(jds, 8))
    # and a numpy array, at the default batch (4 a device)
    np.testing.assert_allclose(tp.predict(xs), np.asarray(jpred.predict(xs)),
                               **TOL)


def test_module_predict_over_a_transformed_data_set():
    jm, tm, xs = _pred_twins()
    tm.evaluate()
    ds = DataSet.array([Sample(x) for x in xs],
                       FuncTransformer(lambda s: Sample(s.features[0] * 2)))
    assert isinstance(ds, TransformedDataSet)
    got = tm.predict(ds, 8)
    with torch.no_grad():
        want = torch.cat([tm.forward(torch.from_numpy(xs[i:i + 8] * 2))
                          for i in range(0, 20, 8)]).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(tm.predict_class(ds, 8),
                                  want.argmax(-1) + 1)
    jm.evaluate()
    jds = JaxDataSet.array([JaxSample(x * 2) for x in xs])
    np.testing.assert_allclose(got, np.asarray(jm.predict(jds, 8)), **TOL)


def test_predictor_counts_dispatches_and_pads_to_buckets():
    _, tm, xs = _pred_twins()
    tobs.reset()
    tobs.enable()
    try:
        p = Predictor(tm, prefetch_depth=0)
        p.predict(xs[:13], 8)
        assert tobs.registry().counter("predict/dispatches").value == 2
        assert tobs.registry().counter("predict/readbacks").value == 1
        # 8 rows, then 5 padded to the bucket of 8
        from bigdl_tpu_torch.optim.predictor import shared_forward
        assert shared_forward(tm).compiled_shape_count() == 1
        p.set_superstep(2).predict(xs[:16], 4)
        assert tobs.registry().counter("predict/dispatches").value == 4
    finally:
        tobs.disable()
        tobs.reset()
    assert isinstance(PredictionService(tm), Predictor)
    assert Predictor(tm).predict(DataSet.array([]), 4).shape == (0,)
    assert leading_dim(Table(np.zeros((3, 2)), np.zeros((3,)))) == 3
    with pytest.raises(ValueError):
        Predictor(tm).set_superstep(0)
