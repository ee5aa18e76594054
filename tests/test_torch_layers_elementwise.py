"""The port's elementwise layers, activations and dropout against the JAX
package (``nn/elementwise.py``, ``nn/activation.py``, ``nn/dropout.py``).

Every case builds the JAX module and its port from the same constructor
call, carries JAX's parameters (redrawn from a numpy seed) across with
``convert`` and holds the output, the parameter gradients and the input
gradient of sum(sin(out / 2)) to JAX's at 1e-5, in training and in
evaluation mode. The gradients at ties are JAX's: ``Abs`` passes +1 at 0,
the clips half the gradient at their bounds, ``ELU`` half at 0, ``Maxout``
an even split between tied maxima. Dropout masks cannot match JAX's bit
for bit: the layers are held to JAX in evaluation mode and at p = 0, and
in training mode by the keep rate, the 1 / (1 - p) scale, and the same
mask from the same generator.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as jnn
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.utils.table import Table
from torch_parity_helpers import check_pair, close

torch.set_num_threads(1)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _ties(values, shape=(3, 8), seed=0):
    """Random values with the given ones planted at every third entry."""
    x = _x(*shape, seed=seed).reshape(-1)
    x[::3] = np.resize(np.asarray(values, np.float32), x[::3].shape)
    return x.reshape(shape)


CASES = {
    # elementwise
    "Identity": (lambda m: m.Identity(), _x(3, 4)),
    "Contiguous": (lambda m: m.Contiguous(), _x(3, 4)),
    "Abs_at_zero": (lambda m: m.Abs(), _ties([0.0])),
    "Exp": (lambda m: m.Exp(), _x(3, 4)),
    "Log": (lambda m: m.Log(), np.abs(_x(3, 4)) + 0.1),
    "Sqrt": (lambda m: m.Sqrt(), np.abs(_x(3, 4)) + 0.1),
    "Square": (lambda m: m.Square(), _x(3, 4)),
    "Negative": (lambda m: m.Negative(), _x(3, 4)),
    "Power": (lambda m: m.Power(3, 0.5, 1.5), _x(3, 4)),
    "Power_sqrt": (lambda m: m.Power(0.5, 2.0, 3.0), np.abs(_x(3, 4))),
    "AddConstant": (lambda m: m.AddConstant(1.5), _x(3, 4)),
    "MulConstant": (lambda m: m.MulConstant(-2.5), _x(3, 4)),
    "GradientReversal": (lambda m: m.GradientReversal(0.7), _x(3, 4)),
    "L1Penalty": (lambda m: m.L1Penalty(0.3), _ties([0.0])),
    "L1Penalty_avg_no_output": (lambda m: m.L1Penalty(0.3, True, False),
                                _ties([0.0])),
    # activations
    "ReLU_at_zero": (lambda m: m.ReLU(), _ties([0.0])),
    "ReLU6_at_bounds": (lambda m: m.ReLU6(), _ties([0.0, 6.0]) * 4),
    "LeakyReLU": (lambda m: m.LeakyReLU(0.2), _ties([0.0])),
    "PReLU_shared": (lambda m: m.PReLU(), _x(2, 3, 4, 4)),
    "PReLU_channels": (lambda m: m.PReLU(3), _x(2, 3, 4, 4)),
    "RReLU_eval_slope": (lambda m: m.RReLU(), _x(3, 8)),
    "SReLU": (lambda m: m.SReLU((3, 4)), _x(2, 3, 4)),
    "SReLU_shared": (lambda m: m.SReLU((3, 4), (2,)), _x(2, 3, 4)),
    "ELU_at_zero": (lambda m: m.ELU(0.8), _ties([0.0])),
    "GELU": (lambda m: m.GELU(), _x(3, 8)),
    "SoftPlus": (lambda m: m.SoftPlus(2.0), _x(3, 8) * 4),
    "SoftSign": (lambda m: m.SoftSign(), _x(3, 8)),
    "Sigmoid": (lambda m: m.Sigmoid(), _x(3, 8)),
    "LogSigmoid": (lambda m: m.LogSigmoid(), _x(3, 8) * 4),
    "Tanh": (lambda m: m.Tanh(), _x(3, 8)),
    "TanhShrink": (lambda m: m.TanhShrink(), _x(3, 8)),
    "HardTanh_at_bounds": (lambda m: m.HardTanh(), _ties([-1.0, 1.0]) * 2),
    "HardTanh_range": (lambda m: m.HardTanh(-0.5, 2.0),
                       _ties([-0.5, 2.0]) * 2),
    "Clamp_at_bounds": (lambda m: m.Clamp(-0.25, 0.5),
                        _ties([-0.25, 0.5])),
    "HardSigmoid_at_bounds": (lambda m: m.HardSigmoid(),
                              _ties([-2.5, 2.5]) * 3),
    "HardShrink": (lambda m: m.HardShrink(0.3), _x(3, 8)),
    "SoftShrink": (lambda m: m.SoftShrink(0.3), _x(3, 8)),
    "SoftMax_batch": (lambda m: m.SoftMax(), _x(3, 5, 2)),
    "SoftMax_vector": (lambda m: m.SoftMax(), _x(5)),
    "SoftMax_axis": (lambda m: m.SoftMax(-1), _x(3, 5, 2)),
    "SoftMin": (lambda m: m.SoftMin(), _x(3, 5)),
    "LogSoftMax": (lambda m: m.LogSoftMax(), _x(3, 5)),
    "Threshold": (lambda m: m.Threshold(0.1, -2.0), _x(3, 8)),
    "BinaryThreshold": (lambda m: m.BinaryThreshold(0.1), _x(3, 8)),
    "Maxout": (lambda m: m.Maxout(6, 4, 3), _x(5, 6)),
    "Maxout_no_bias": (lambda m: m.Maxout(6, 4, 3, False), _x(5, 6)),
    # dropout: the identity in evaluation mode and at p = 0
    "Dropout_p0": (lambda m: m.Dropout(0.0), _x(3, 8)),
    "SpatialDropout2D_p0": (lambda m: m.SpatialDropout2D(0.0),
                            _x(2, 3, 4, 4)),
}
EVAL_ONLY = {
    "Dropout": (lambda m: m.Dropout(0.4), _x(3, 8)),
    "Dropout_unscaled": (lambda m: m.Dropout(0.4, False, False), _x(3, 8)),
    "GaussianDropout": (lambda m: m.GaussianDropout(0.3), _x(3, 8)),
    "GaussianNoise": (lambda m: m.GaussianNoise(0.3), _x(3, 8)),
    "GaussianSampler": (lambda m: m.GaussianSampler(), [_x(3, 4),
                                                        _x(3, 4, seed=1)]),
    "SpatialDropout1D": (lambda m: m.SpatialDropout1D(0.3), _x(2, 5, 4)),
    "SpatialDropout2D": (lambda m: m.SpatialDropout2D(0.3), _x(2, 3, 4, 4)),
    "SpatialDropout3D": (lambda m: m.SpatialDropout3D(0.3),
                         _x(2, 3, 2, 4, 4)),
}


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_jax(name, training):
    make, x = CASES[name]
    if name == "RReLU_eval_slope" and training:
        training = False     # JAX draws its slopes only with an rng
    check_pair(make(jnn), make(nn), x, training)


@pytest.mark.parametrize("name", sorted(EVAL_ONLY))
def test_random_layer_matches_jax_in_evaluation(name):
    make, x = EVAL_ONLY[name]
    check_pair(make(jnn), make(nn), x, False)


def _grad(module, x):
    t = torch.tensor(x, requires_grad=True)
    module.apply({}, {}, t)[0].sum().backward()
    return t.grad


@pytest.mark.parametrize("name,x,want", [
    ("Abs", [0.0, -1.0, 2.0], [1.0, -1.0, 1.0]),
    ("ReLU6", [0.0, 6.0, 3.0, 7.0], [0.5, 0.5, 1.0, 0.0]),
    ("HardTanh", [-1.0, 1.0, 0.0], [0.5, 0.5, 1.0]),
    ("HardSigmoid", [-2.5, 2.5, 0.0], [0.1, 0.1, 0.2]),
    ("ELU", [0.0, 1.0], [0.5, 1.0]),
])
def test_gradient_at_ties_is_jax_not_torch(name, x, want):
    """The ties' gradients, written out: a port through ``torch.abs`` /
    ``torch.clamp`` / ``F.hardtanh`` / ``F.elu`` fails these."""
    got = _grad(getattr(nn, name)(), x)
    jm = getattr(jnn, name)()
    jg = jax.grad(lambda v: jm.apply({}, {}, v)[0].sum())(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(jg), want, atol=1e-6)
    torch.testing.assert_close(got, torch.tensor(want), atol=1e-6, rtol=0)


def test_maxout_splits_tied_maxima_like_jnp_max():
    jm, tm = jnn.Maxout(2, 1, 3), nn.Maxout(2, 1, 3)
    w = np.array([[1.0, 1.0, -1.0], [0.0, 0.0, 2.0]], np.float32)
    b = np.zeros(3, np.float32)
    tm.load_state_dict({"weight": torch.from_numpy(w),
                        "bias": torch.from_numpy(b)})
    x = np.array([[1.0, 0.0]], np.float32)       # columns 0 and 1 tie
    jg = jax.grad(lambda p: jm.apply(p, {}, jnp.asarray(x))[0].sum())(
        {"weight": jnp.asarray(w), "bias": jnp.asarray(b)})
    out = tm.call(tm.params, torch.from_numpy(x))
    gw, = torch.autograd.grad(out.sum(), tm.weight)
    close(gw, jg["weight"])
    assert float(gw[0, 0]) == float(gw[0, 1]) == 0.5


# -- dropout in training mode ----------------------------------------------

@pytest.mark.parametrize("cls,shape,per", [
    ("Dropout", (200, 100), ()),
    ("SpatialDropout1D", (50, 3, 400), (1,)),
    ("SpatialDropout2D", (50, 400, 2, 3), (2, 3)),
    ("SpatialDropout3D", (50, 400, 2, 2, 2), (2, 3, 4)),
])
def test_dropout_keep_rate_scale_and_replay(cls, shape, per):
    p = 0.3
    m = getattr(nn, cls)(p)
    x = torch.ones(shape)
    y, _ = m.apply({}, {}, x, training=True,
                   generator=torch.Generator().manual_seed(3))
    vals = torch.unique(y)
    torch.testing.assert_close(vals, torch.tensor([0.0, 1.0 / (1 - p)]))
    kept = (y != 0).float()
    assert abs(float(kept.mean()) - (1 - p)) < 0.01
    if per:      # one draw per feature map: constant over the broadcast dims
        assert torch.equal(kept, kept.amax(per, keepdim=True)
                           .expand_as(kept))
    again, _ = m.apply({}, {}, x, training=True,
                       generator=torch.Generator().manual_seed(3))
    assert torch.equal(y, again)
    other, _ = m.apply({}, {}, x, training=True,
                       generator=torch.Generator().manual_seed(4))
    assert not torch.equal(y, other)


def test_dropout_unscaled_and_needs_a_generator_in_training():
    m = nn.Dropout(0.5, False, False)
    y, _ = m.apply({}, {}, torch.ones(10, 10), training=True,
                   generator=torch.Generator().manual_seed(0))
    assert set(torch.unique(y).tolist()) == {0.0, 1.0}
    for layer in (nn.Dropout(0.5), nn.GaussianDropout(0.2),
                  nn.GaussianNoise(0.1), nn.SpatialDropout2D(0.2)):
        with pytest.raises(ValueError, match="Generator"):
            layer.apply({}, {}, torch.ones(2, 3, 4, 4), training=True)
    with pytest.raises(ValueError, match="Generator"):
        nn.GaussianSampler().apply({}, {}, Table(torch.ones(2),
                                                 torch.ones(2)),
                                   training=True)


def test_gaussian_noise_layers_draw_their_moments():
    g = torch.Generator().manual_seed(1)
    x = torch.full((400, 500), 2.0)
    y, _ = nn.GaussianDropout(0.2).apply({}, {}, x, True, g)
    std = (0.2 / 0.8) ** 0.5
    assert abs(float((y / 2).mean()) - 1.0) < 0.01
    assert abs(float((y / 2).std()) - std) < 0.01
    y, _ = nn.GaussianNoise(0.3).apply({}, {}, x, True, g)
    assert abs(float((y - 2).std()) - 0.3) < 0.01
    mean, logvar = torch.zeros(400, 500), torch.full((400, 500), np.log(4.0))
    y, _ = nn.GaussianSampler().apply({}, {}, Table(mean, logvar), True, g)
    assert abs(float(y.std()) - 2.0) < 0.02


def test_rrelu_draws_slopes_from_the_generator_in_training():
    m = nn.RReLU(0.1, 0.3)
    x = -torch.ones(1000)
    y, _ = m.apply({}, {}, x, True, torch.Generator().manual_seed(2))
    slopes = -y
    assert float(slopes.min()) >= 0.1 and float(slopes.max()) <= 0.3
    assert float(slopes.std()) > 0.05
    y2, _ = m.apply({}, {}, x, True, torch.Generator().manual_seed(2))
    assert torch.equal(y, y2)
    # no generator: the mean slope, as JAX without an rng
    torch.testing.assert_close(m.apply({}, {}, x, True)[0],
                               torch.full((1000,), -0.2))


def test_stateful_forward_threads_a_generator_in_training_only():
    m = nn.Sequential(nn.Linear(8, 8), nn.Dropout(0.5))
    x = torch.ones(4, 8)
    y = m.forward(x)
    assert (y == 0).any()
    m.evaluate()
    torch.testing.assert_close(m.forward(x), m[0].call(m[0].params, x))


def test_echo_prints_and_passes_through(capsys):
    x = torch.ones(2, 3)
    assert torch.equal(nn.Echo(name="e").call({}, x), x)
    assert "[Echo e] shape=(2, 3)" in capsys.readouterr().out
    assert nn.ErrorInfo.constrainEachInputAsVectorOrBatch.startswith("Each")
