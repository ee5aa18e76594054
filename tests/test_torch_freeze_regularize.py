"""Regularizers, frozen modules and the module walk of the port against
the JAX package: ``optim/regularizer.py``, ``Linear`` / ``SpatialConvolution``
with ``w_regularizer`` / ``b_regularizer``, ``Module.freeze`` /
``unfreeze`` / ``is_frozen``, ``modules_iter`` / ``find_module`` /
``get_name`` / ``set_name``, and the training step's handling of both
(the penalty in the loss, a frozen leaf's gradient zeroed and its value
kept through the update).

Tolerances: penalties within 1e-6 relative; training runs within 1e-5
(float32, the same formulas); a frozen parameter bit for bit unchanged.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.optim as jo
import bigdl_tpu_torch.optim as to
from bigdl_tpu import nn as jnn
from bigdl_tpu.optim.optimizer import _frozen_mask
from bigdl_tpu.optim.regularizer import (regularization_loss as jreg_loss,
                                         regularizer_tree as jreg_tree)
from bigdl_tpu_torch import convert, nn as tnn
from bigdl_tpu_torch.optim.optimizer import _frozen_names
from bigdl_tpu_torch.optim.regularizer import (regularization_loss,
                                               regularizer_tree)
from tests.torch_loop_helpers import (assert_close, assert_equal, conv_net,
                                      data_pair, image_batches, mlp,
                                      optimizers, twins, vector_batches)

torch.set_num_threads(1)

REGS = {"l1": lambda o: o.L1Regularizer(0.01),
        "l2": lambda o: o.L2Regularizer(0.1),
        "l1l2": lambda o: o.L1L2Regularizer(0.01, 0.1),
        "none": lambda o: o.L1L2Regularizer()}


@pytest.mark.parametrize("name", sorted(REGS))
def test_penalty_matches_jax(name):
    w = np.random.RandomState(0).randn(4, 5).astype(np.float32)
    got = REGS[name](to).loss(torch.from_numpy(w))
    want = REGS[name](jo).loss(jnp.asarray(w))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("name", ["l1", "l1l2"])
def test_penalty_gradient_at_zero_is_jax_s(name):
    """``jnp.abs`` passes a gradient of +1 at 0 and ``torch.abs`` 0: the
    L1 penalty's gradient on a zero-initialised bias follows JAX."""
    w = np.array([0.0, -0.0, 1.5, -2.0, 0.0], np.float32)
    t = torch.from_numpy(w).requires_grad_(True)
    got, = torch.autograd.grad(REGS[name](to).loss(t), t)
    want = jax.grad(lambda a: REGS[name](jo).loss(a))(jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def _reg_net(pkg):
    o = jo if pkg is jnn else to
    return conv_net(pkg, REGS["l2"](o), REGS["l1"](o), REGS["l1l2"](o))


def test_regularizer_tree_and_loss_match_jax():
    jm, tm, w = twins(_reg_net)
    jt, tt = jreg_tree(jm), regularizer_tree(tm)
    assert jax.tree_util.tree_map(lambda r: type(r).__name__, jt,
                                  is_leaf=lambda r: not isinstance(r, dict)) \
        == {k: {n: type(r).__name__ for n, r in v.items()}
            for k, v in tt.items()}
    assert set(tt) == {"0", "3"} and set(tt["0"]) == {"weight", "bias"}
    np.testing.assert_allclose(
        float(regularization_loss(tt, tm.params).detach()),
        float(jreg_loss(jt, jm.params)), rtol=1e-6)
    assert regularizer_tree(twins(conv_net)[1]) == {}


@pytest.mark.parametrize("k", [1, 2], ids=["k1", "superstep2"])
def test_regularized_training_matches_jax(k):
    jm, tm, _ = twins(_reg_net)
    jopt, topt = optimizers(jm, tm, data_pair(image_batches(4)),
                            lambda p: p.CrossEntropyCriterion(),
                            lambda o: o.SGD(0.1, momentum=0.9),
                            lambda o: o.max_iteration(4), 8,
                            set_prefetch=(0,), set_superstep=(k,))
    jopt.optimize()
    topt.optimize()
    np.testing.assert_allclose(topt.optim_method.state["loss"],
                               jopt.optim_method.state["loss"], rtol=1e-5)
    assert_close(convert.to_numpy_tree(tm.params), jm.params)


def _freeze_first(m):
    return m.freeze(m[0].name)


def _freeze_all_but_head(m):
    return m.freeze().unfreeze(m[2].name)


@pytest.mark.parametrize("how,frozen", [
    (_freeze_first, {"0.weight", "0.bias"}),
    (_freeze_all_but_head, {"0.weight", "0.bias"})],
    ids=["freeze_first", "freeze_root_unfreeze_head"])
@pytest.mark.parametrize("k", [1, 2], ids=["k1", "superstep2"])
def test_frozen_training_matches_jax(how, frozen, k):
    """SGD with momentum and weight decay: a frozen leaf is bit for bit
    unchanged (weight decay does not move it), the rest within 1e-5 of
    JAX's loop, and K=2 bit for bit K=1."""
    out = {}
    for kk in sorted({1, k}):
        jm, tm, w = twins(mlp)
        how(jm)
        how(tm)
        assert _frozen_names(tm) == frozen
        jopt, topt = optimizers(jm, tm, data_pair(vector_batches(4)),
                                lambda p: p.CrossEntropyCriterion(),
                                lambda o: o.SGD(0.1, momentum=0.9,
                                                weightdecay=0.1),
                                lambda o: o.max_iteration(4), 8,
                                set_prefetch=(2,), set_superstep=(kk,))
        jopt.optimize()
        topt.optimize()
        got = convert.to_numpy_tree(tm.params)
        assert_close(got, jm.params)
        flat, w0 = convert.flatten(got), convert.flatten(w)
        for name in flat:
            moved = not np.array_equal(flat[name], w0[name])
            assert moved == (name not in frozen), name
        out[kk] = got
    assert_equal(out[1], out[k])


def test_freeze_flags_follow_jax():
    """``freeze()`` flags the whole walk, ``unfreeze(name)`` a subtree,
    an unknown name raises, as in JAX."""
    inner = lambda p: p.Sequential(p.Linear(2, 3), p.ReLU())
    for pkg in (jnn, tnn):
        m = pkg.Sequential(inner(pkg), pkg.Linear(3, 2))
        m.freeze()
        assert all(x.is_frozen() for x in m.modules_iter())
        m.unfreeze(m[0].name)
        assert [x.is_frozen() for x in m.modules_iter()] == \
            [True, False, False, False, True]
        with pytest.raises(ValueError, match="no module named"):
            m.freeze("missing")


def test_module_walk_and_names_follow_jax():
    build = lambda p: p.Sequential(p.Sequential(p.Linear(2, 3), p.ReLU()),
                                   p.Linear(3, 2))
    jm, tm = build(jnn), build(tnn)
    assert [type(m).__name__ for m in jm.modules_iter()] == \
        [type(m).__name__ for m in tm.modules_iter()] == \
        ["Sequential", "Sequential", "Linear", "ReLU", "Linear"]
    for m in (jm, tm):
        assert m[0][0].set_name("enc") is m[0][0]
        assert m.find_module("enc") is m[0][0]
        assert m.find_module("enc").get_name() == "enc"
        assert m.find_module("nothing") is None


def test_frozen_names_on_resnet50_match_jax_mask():
    """The stem (conv, BatchNorm) and the first stage frozen: the port's
    frozen parameter names are the leaves JAX's mask zeroes. A fused
    stage is one module in both walks."""
    from bigdl_tpu.models import ResNet50 as JaxResNet50
    from bigdl_tpu_torch.models import ResNet50
    jm = JaxResNet50(format="NHWC", fused="pallas")
    jm.ensure_initialized()
    tm = ResNet50(format="NHWC", fused="pallas", device="cpu")
    assert [type(m).__name__ for m in jm.modules_iter()] == \
        [type(m).__name__ for m in tm.modules_iter()]
    for m in (jm, tm):
        m.freeze(m[0].name, m[1].name, m[4].name)
    mask = convert.flatten(_frozen_mask(jm))
    want = {k for k, v in mask.items() if v == 0.0}
    assert _frozen_names(tm) == want
    assert len(want) == 1 + 2 + 12 + 9 + 9 and all(
        k.split(".")[0] in ("0", "1", "4") for k in want)
