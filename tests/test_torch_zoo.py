"""The classic image zoo of the port against the JAX package's models at
their published widths: ``LeNet5`` and ``Autoencoder`` (28x28),
``ResNetCifar(depth=20)`` and ``VggForCifar10`` (32x32),
``Inception_v1`` and the three-head ``Inception_v2`` at B1/224, the
default ``ResNet50()`` (NCHW, ``fused="none"``) and its NHWC
space-to-depth / fast-pool arm at B2/64, and ``Vgg_16`` / ``Vgg_19`` by
their parameter trees (no 224 forward on the CPU).

Each model is built by both packages; the port's freshly drawn
parameters and state are held to the JAX model's trees (names and shapes,
from ``jax.eval_shape`` of its ``init``) and then carried into JAX, so
both run the same weights. Two checks each:

* float32, in the mode stated (training mode updates the BatchNorm
  statistics): logits and new running statistics within 1e-4 of the
  largest JAX value (1e-3 for ResNet-50 in training mode at B2/64, whose
  stage-3 BatchNorms see 8 pixels a channel, as in
  ``test_torch_resnet``), and for LeNet-5, the autoencoder and
  ResNetCifar-20 every parameter gradient of sum(sin(logits / 2)) within
  1e-4;
* float64 in both packages (JAX's x64 mode for the one test), evaluation
  mode: every parameter gradient within 1e-9. At full width in float32 a
  few of the millions of pre-activations and pooled maxima land within
  rounding of a ReLU's kink or of a tie and take the other side in the
  other package's summation order, which moves the gradients below them
  by up to a few tenths of a percent (Inception v1: 0.6% on one leaf);
  in float64 the two agree to ~1e-14, which holds the semantics exactly.
  Training-mode gradients of the BatchNorm models are left to the layer
  tests: JAX computes batch statistics in float32 even in x64 mode, with
  the shifted one-pass variance, which loses most of its digits on the
  few pixels a channel has at B1/B2 (ResNet-50 stage 3 at 64x64: 8).

Two ``LocalOptimizer`` runs, LeNet-5 and ResNetCifar-20, follow JAX's
loop for 3 SGD steps: losses within 1e-4.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import DataSet as JaxDataSet, Sample as JaxSample
from bigdl_tpu.models import (autoencoder as jauto, inception as jinc,
                              lenet as jlenet, resnet as jresnet, vgg as jvgg)
from bigdl_tpu.optim import SGD as JaxSGD
from bigdl_tpu.optim.optimizer import LocalOptimizer as JaxLocalOptimizer
from bigdl_tpu.optim.trigger import Trigger as JaxTrigger
from bigdl_tpu_torch import convert, models, nn
from bigdl_tpu_torch.dataset import DataSet, Sample
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger

torch.set_num_threads(1)


def _trees(jm, tm):
    """The port model's (params, state) as numpy, after checking they have
    the JAX model's names and shapes."""
    jp, js = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tp, ts = convert.to_numpy_trees(tm)
    for got, want in ((tp, jp), (ts, js)):
        g, w = convert.flatten(got), convert.flatten(
            jax.tree_util.tree_map(lambda s: s.shape, want))
        assert sorted(g) == sorted(w)
        assert all(tuple(g[k].shape) == tuple(w[k]) for k in w)
    return tp, ts


def _rel(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-6)


@pytest.fixture
def x64():
    """JAX's float64 mode for one test, restored after it."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _grads(jm, tm, tp, ts, x, training, dtype):
    """Both packages' (logits, new state, parameter gradients) of
    sum(sin(logits / 2)) in ``dtype``."""
    cast = lambda t: jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, dtype)), t)

    def f(p):
        out, ns = jm.apply(p, cast(ts), jnp.asarray(x.astype(dtype)),
                           training=training)
        return jnp.sum(jnp.sin(0.5 * out)), (out, ns)
    (_, (jout, jns)), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(
        cast(tp))
    params = tm.params
    out, ns = tm.apply(params, tm.state, torch.from_numpy(x.astype(dtype)),
                       training=training)
    leaves = convert.flatten(params)
    g = torch.autograd.grad(torch.sin(0.5 * out).sum(), list(leaves.values()))
    return ((out, ns, convert.unflatten(dict(zip(leaves, g)))),
            (jout, jax.tree_util.tree_map(np.asarray, jns),
             jax.tree_util.tree_map(np.asarray, jg)))


def _leaf_errs(got, want):
    g, w = convert.flatten(convert.to_numpy_tree(got)), convert.flatten(want)
    assert sorted(g) == sorted(w)
    return {k: _rel(g[k], w[k]) for k in w}


def _hold(jm, tm, x, training, grads32=False, tol32=1e-4):
    """The float32 check in ``training`` mode (logits and state within
    ``tol32``); the float64 check of the gradients (call from a test with
    the ``x64`` fixture) in evaluation mode."""
    tp, ts = _trees(jm, tm)
    (out, ns, g), (jout, jns, jg) = _grads(jm, tm, tp, ts, x, training,
                                           np.float32)
    assert _rel(out, jout) <= tol32
    assert max(_leaf_errs(ns, jns).values(), default=0.0) <= tol32
    if grads32:
        errs = _leaf_errs(g, jg)
        assert max(errs.values()) <= 1e-4, sorted(errs.items(),
                                                   key=lambda e: -e[1])[:3]
    if jax.config.jax_enable_x64:
        import copy
        t64 = copy.deepcopy(tm).double()
        (out64, _, g64), (jout64, _, jg64) = _grads(jm, t64, tp, ts, x,
                                                    False, np.float64)
        assert out64.dtype == torch.float64
        assert _rel(out64, jout64) <= 1e-9
        errs = _leaf_errs(g64, jg64)
        assert max(errs.values()) <= 1e-9, sorted(errs.items(),
                                                  key=lambda e: -e[1])[:3]
    return out


def _img(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_lenet5_matches_jax(training):
    out = _hold(jlenet.LeNet5(10), models.LeNet5(10, device="cpu"),
                _img(4, 28, 28), training, grads32=True)
    assert out.shape == (4, 10)


def test_autoencoder_matches_jax(x64):
    out = _hold(jauto.Autoencoder(32), models.Autoencoder(32, device="cpu"),
                _img(4, 28, 28), True, grads32=True)
    assert out.shape == (4, 784)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_resnet_cifar20_matches_jax(training):
    tm = models.ResNetCifar(10, 20, device="cpu")
    assert sum(p.numel() for p in tm.parameters()) == 269722
    _hold(jresnet.ResNetCifar(10, 20), tm, _img(4, 3, 32, 32), training,
          grads32=True)


def test_resnet_cifar20_float64(x64):
    _hold(jresnet.ResNetCifar(10, 20),
          models.ResNetCifar(10, 20, device="cpu", seed=1),
          _img(2, 3, 32, 32), True)


def test_vgg_cifar10_matches_jax(x64):
    _hold(jvgg.VggForCifar10(10, False),
          models.VggForCifar10(10, False, device="cpu"),
          _img(2, 3, 32, 32), True)


def test_inception_v1_matches_jax_at_224(x64):
    tm = models.Inception_v1(1000, device="cpu")
    assert sum(p.numel() for p in tm.parameters()) == 6998552
    out = _hold(jinc.Inception_v1(1000), tm, _img(1, 3, 224, 224), False)
    assert out.shape == (1, 1000)


def test_inception_v2_three_heads_match_jax_at_224(x64):
    out = _hold(jinc.Inception_v2(1000), models.Inception_v2(1000,
                                                             device="cpu"),
                _img(1, 3, 224, 224), True)
    assert out.shape == (1, 3000)
    # three log-softmaxes side by side
    torch.testing.assert_close(out.detach().exp().reshape(3, 1000).sum(1),
                               torch.ones(3))


def test_resnet50_default_arm_matches_jax(x64):
    """``ResNet50()`` is JAX's default: NCHW, ``fused="none"``; without
    the zero-initialised residual gammas, so every gradient is live."""
    tm = models.ResNet50(10, zero_init_residual=False, device="cpu")
    assert tm[0].format == "NCHW" and not any(
        isinstance(m, models.FusedBottleneck) for m in tm.modules())
    _hold(jresnet.ResNet50(10, zero_init_residual=False), tm,
          _img(2, 3, 64, 64), True, tol32=1e-3)
    zero = models.ResNet50(10, device="cpu")
    assert not zero[4][0][0][7].weight.any()         # BN3's gamma


def test_resnet50_nhwc_s2d_fast_pool_arm_matches_jax(x64):
    kw = dict(format="NHWC", stem="s2d", pool_grad="fast",
              with_log_softmax=True, zero_init_residual=False)
    _hold(jresnet.ResNet50(10, **kw), models.ResNet50(10, device="cpu", **kw),
          _img(2, 64, 64, 3), True, tol32=1e-3)


def test_resnet_factory_arms():
    m = models.ResNet(10, 50, data_set="cifar10", device="cpu")
    # depth 50 = 6 * 8 + 2: stage 1 opens at block 3 + 8, projected (B)
    assert isinstance(m[3][0][1], nn.Identity)
    assert isinstance(m[11][0][1], nn.Sequential)
    m = models.ResNetCifar(10, 32, "C", device="cpu")
    assert len([c for c in m.modules() if isinstance(c, nn.ConcatTable)]) \
        == 15
    assert isinstance(models.ResNet50(format="NHWC", fused="xla",
                                      device="cpu")[4],
                      models.FusedBottleneckChain)
    with pytest.raises(ValueError, match="fused='pallas'"):
        models.ResNet50(format="NHWC", fused="xla", fused_conv2=True,
                        device="cpu")
    for kw in (dict(format="NCHW", fused="pallas"),
               dict(format="NCHW", stem="s2d"), dict(fused_conv2=True)):
        with pytest.raises(ValueError):
            models.ResNet50(device="cpu", **kw)
    with pytest.raises(ValueError):
        models.ResNetCifar(depth=21, device="cpu")


@pytest.mark.parametrize("factory", [
    models.LeNet5, models.Autoencoder, models.VggForCifar10,
    models.Inception_v1, models.Inception_v2, models.ResNetCifar,
    models.ResNet50], ids=lambda f: f.__name__)
def test_factories_need_a_card_unless_cpu_is_asked(factory, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        factory()


@pytest.mark.parametrize("name,n_params", [("Vgg_16", 138357544),
                                           ("Vgg_19", 143667240)])
def test_vgg_imagenet_trees_and_init(name, n_params):
    tm = getattr(models, name)(1000, device="cpu", seed=3)
    tp, _ = _trees(getattr(jvgg, name)(1000), tm)
    flat = convert.flatten(tp)
    assert sum(a.size for a in flat.values()) == n_params
    # JAX's initialisers: Xavier for the convolutions (biases 0),
    # U(+-1/sqrt(fan_in)) for the classifier's weights and biases
    for k, a in flat.items():
        i = int(k.split(".")[0])
        layer = tm[i]
        if isinstance(layer, nn.SpatialConvolution):
            if k.endswith("bias"):
                assert not a.any()
                continue
            o, c, kh, kw = a.shape
            std = (6.0 / (c * kh * kw + o * kh * kw)) ** 0.5 / 3 ** 0.5
        else:
            std = 1.0 / layer.input_size ** 0.5 / 3 ** 0.5
        if a.size >= 4096:
            assert abs(a.std() - std) < 0.03 * std, k
            assert abs(a.mean()) < 0.05 * std, k


# -- LocalOptimizer against JAX's loop ----------------------------------------

def _samples(sample, shape, classes, n=12, seed=8):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, *shape).astype(np.float32)
    y = rng.randint(1, classes + 1, size=n)
    return [sample(x[i], y[i]) for i in range(n)]


def _end(trigger_cls, losses, iters=3):
    def fn(state):
        losses.append(state["loss"])
        return state["neval"] >= iters
    return trigger_cls(fn)


@pytest.mark.parametrize("name,jmake,tmake,shape", [
    ("lenet5", lambda: jlenet.LeNet5(10),
     lambda: models.LeNet5(10, device="cpu"), (28, 28)),
    ("resnet_cifar20", lambda: jresnet.ResNetCifar(10, 20),
     lambda: models.ResNetCifar(10, 20, device="cpu"), (3, 32, 32)),
])
def test_local_optimizer_follows_jax_loop(name, jmake, tmake, shape):
    jm, tm = jmake(), tmake()
    tp, ts = _trees(jm, tm)
    jm.params = jax.tree_util.tree_map(jnp.array, tp)
    jm.state = jax.tree_util.tree_map(jnp.array, ts)
    jm.grad_params = jax.tree_util.tree_map(jnp.zeros_like, jm.params)
    jl, tl = [], []
    JaxLocalOptimizer(jm, JaxDataSet.array(_samples(JaxSample, shape, 10)),
                      jnn.ClassNLLCriterion(),
                      JaxSGD(learningrate=0.05, momentum=0.9),
                      _end(JaxTrigger, jl), batch_size=4).optimize()
    LocalOptimizer(tm, DataSet.array(_samples(Sample, shape, 10)),
                   nn.ClassNLLCriterion(),
                   SGD(learningrate=0.05, momentum=0.9), _end(Trigger, tl),
                   batch_size=4, device="cpu").optimize()
    assert len(tl) == len(jl) == 3
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
    assert tl[-1] != tl[0]
