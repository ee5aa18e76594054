"""The Torch backward protocol of the port's ``Module`` against the JAX
package's (``nn/module.py``): ``forward`` / ``backward`` (gradInput and
parameter gradients accumulated into ``grad_params``, scaled by
``set_scale_w``), ``update_grad_input``, ``acc_grad_parameters``,
``zero_grad_parameters``, ``get_parameters`` (flat weights and gradients
in JAX's flattening order, and the unravel), ``is_training``; then the
manual LeNet-5 step of the reference example. Same weights in both
packages (the port's, carried into JAX), tolerance 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as jnn
from bigdl_tpu.models import lenet as jlenet
from bigdl_tpu.utils.table import Table as JTable
from bigdl_tpu_torch import convert, models, nn
from bigdl_tpu_torch.utils.table import Table
from torch_parity_helpers import close

torch.set_num_threads(1)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _net(m):
    return m.Sequential(m.SpatialConvolution(2, 3, 3, 3, 1, 1, 1, 1),
                        m.SpatialBatchNormalization(3), m.Tanh(),
                        m.SpatialMaxPooling(2, 2), m.View(12),
                        m.Linear(12, 4), m.LogSoftMax())


def _table_net(m):
    return m.Sequential(m.ParallelTable(m.Linear(3, 4), m.Linear(5, 4)),
                        m.CAddTable(), m.Tanh())


def _twins(make):
    """The port module and the JAX one holding its weights and state."""
    tm = make(nn)
    jm = make(jnn)
    jm.params = jax.tree_util.tree_map(jnp.array, convert.to_numpy_tree(
        tm.params))
    jm.state = jax.tree_util.tree_map(jnp.array, convert.to_numpy_tree(
        tm.state))
    jm.grad_params = jax.tree_util.tree_map(jnp.zeros_like, jm.params)
    return jm, tm


def _seq_net(m):
    return m.Sequential(m.Recurrent(m.LSTM(3, 4)), m.Select(2, -1),
                        m.Linear(4, 2))


CASES = {
    "conv_bn_net": (_net, lambda: _x(3, 2, 4, 4), lambda: _x(3, 4, seed=1)),
    "recurrent_net": (_seq_net, lambda: _x(2, 5, 3),
                      lambda: _x(2, 2, seed=1)),
    "table_net": (_table_net, lambda: [_x(2, 3), _x(2, 5, seed=2)],
                  lambda: _x(2, 4, seed=1)),
}


def _j(v):
    return JTable(*[jnp.asarray(a) for a in v]) if isinstance(v, list) \
        else jnp.asarray(v)


def _t(v):
    return Table(*[torch.from_numpy(a) for a in v]) if isinstance(v, list) \
        else torch.from_numpy(v)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_accumulates_like_jax(name, training):
    make, xs, gos = CASES[name]
    jm, tm = _twins(make)
    if not training:
        jm.evaluate()
        tm.evaluate()
    assert tm.is_training() is training
    jm.set_scale_w(0.5)
    tm.set_scale_w(0.5)
    x, go = xs(), gos()
    close(tm.forward(_t(x)), jm.forward(_j(x)), what="forward")
    close(tm.state, jm.state, what="state")
    for _ in range(2):          # two accumulated backward calls
        gi = tm.backward(_t(x), _t(go))
        jgi = jm.backward(_j(x), _j(go))
        close(gi, jgi, what="grad_input")
    close(tm.grad_params, jm.grad_params, what="grad_params")
    w, g, unravel = tm.get_parameters()
    jw, jg, junravel = jm.get_parameters()
    close(w, jw, what="flat weights")
    close(g, jg, what="flat grads")
    close(unravel(g), junravel(jg), what="unravelled")
    close(tm.update_grad_input(_t(x), _t(go)),
          jm.update_grad_input(_j(x), _j(go)), what="update_grad_input")
    tm.acc_grad_parameters(_t(x), _t(go))
    jm.acc_grad_parameters(_j(x), _j(go))
    close(tm.grad_params, jm.grad_params, what="acc_grad_parameters")
    tm.zero_grad_parameters()
    jm.zero_grad_parameters()
    assert float(tm.get_parameters()[1].abs().sum()) == 0.0
    close(tm.grad_params, jm.grad_params, what="zeroed")


def test_backward_replays_the_forward_dropout_mask():
    m = nn.Sequential(nn.Linear(6, 6), nn.Dropout(0.5))
    x = torch.ones(4, 6)
    y = m.forward(x)
    dropped = y == 0
    gi = m.backward(x, torch.ones(4, 6))
    # the gradient reaching the Linear's bias is the kept mask, scaled
    torch.testing.assert_close(m.grad_params["0"]["bias"],
                               (~dropped).float().sum(0) * 2.0)
    assert gi.shape == x.shape


def test_lenet_manual_step_matches_jax():
    """The reference example's loop body: forward, criterion forward and
    backward, model backward, then the flat weights and gradients."""
    tm = models.LeNet5(10, device="cpu", seed=2)
    jm, _ = _twins(lambda m: jlenet.LeNet5(10) if m is jnn else tm)
    x = _x(8, 28, 28)
    y = np.random.RandomState(3).randint(1, 11, size=8)
    tc, jc = nn.ClassNLLCriterion(), jnn.ClassNLLCriterion()
    out, jout = tm.forward(torch.from_numpy(x)), jm.forward(jnp.asarray(x))
    loss, jloss = tc.forward(out, y), jc.forward(jout, jnp.asarray(y))
    close(loss, np.asarray(jloss), what="loss")
    g = tc.backward(out, y)
    jg = jc.backward(jout, jnp.asarray(y))
    tm.zero_grad_parameters()
    jm.zero_grad_parameters()
    close(tm.backward(torch.from_numpy(x), g),
          jm.backward(jnp.asarray(x), jg), what="grad_input")
    w, gw, _ = tm.get_parameters()
    jw, jgw, _ = jm.get_parameters()
    assert w.numel() == jw.size == 22278
    close(w, jw, what="weights")
    close(gw, jgw, what="grads")
    # a plain SGD step on the flat vectors moves the loss down
    with torch.no_grad():
        new = tm.get_parameters()[2](w - 0.5 * gw)
        for k, v in convert.flatten(new).items():
            convert.flatten(tm.params)[k].copy_(v)
    assert float(tc.forward(tm.forward(torch.from_numpy(x)), y)) < \
        float(loss)
