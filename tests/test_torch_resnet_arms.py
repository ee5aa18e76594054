"""ResNet-50's last two arms in the port against the JAX package:
``fused="xla"`` (the fused blocks in plain ops, JAX's control arm of the
kernels) and the chain-off arm (``fused_chain=False``, JAX's
``BIGDL_TPU_FUSED_CHAIN=0``: blocks appended to the ``Sequential``, each
with its own junction, conv1 through K3).

Every input is made with numpy from a seed. Whole models carry the port's
freshly drawn weights into JAX (``convert.to_numpy_trees``); blocks carry
JAX's into the port (``convert.jax_to_state_dict``, strict). JAX runs its
plain path (``BIGDL_TPU_FLASH=off``: the same ops as its ``"xla"`` arm).
Tolerances, as the largest error over the largest JAX magnitude:

* blocks and chains of ``kernel="xla"``, float32: outputs and new state
  1e-5, gradients 1e-4 (the one-pass BatchNorm statistics, as in
  ``test_torch_resnet``);
* whole ResNet-50 at B2/64x64, float32, training mode: logits and new
  state 1e-3, the classifier's gradients 1e-3, the stem's and stage 0's
  1e-1, as ``test_torch_resnet`` holds the chained arm. Deeper float32
  training-mode gradients are not a witness: through the BatchNorms'
  one-pass statistics they move by up to 16% between the port's own
  float32 and float64 runs of the same model at this size (stages 2-3),
  so any two summation orders disagree there;
* the ``"xla"`` arm in float64 in both packages, evaluation mode: logits
  and every parameter gradient 1e-6. Both packages form each BatchNorm's
  affine from the running statistics in float32 (rsqrt included), so the
  float64 results differ by the float32 rounding of one rsqrt at most; a
  summation order or a different reading of the blocks would show far
  above it.

Launch counts of a training forward (24 K3 + 12 K5 chained, 36 + 0
unchained, none for ``"xla"``) are held on the CPU by counting the
module's calls of the kernel wrappers; ``chip_smoke.py`` holds the same
counts with the wrappers' launch counters on the card.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.models import resnet as jresnet
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.models import (FusedBottleneck, FusedBottleneckChain,
                                    ResNet)
import bigdl_tpu_torch.models.resnet as tresnet

torch.set_num_threads(1)
TOL = 1e-5
GRAD_TOL = 1e-4


def _rel(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-6)


def _tree_errs(got, want):
    """Leaf by leaf errors of a port tree of tensors against JAX's."""
    g = convert.flatten(convert.to_numpy_tree(got))
    w = convert.flatten(jax.tree_util.tree_map(np.asarray, want))
    assert sorted(g) == sorted(w)
    return {k: _rel(g[k], w[k]) for k in w}


def _sin(out, xp):
    return xp.sum(xp.sin(0.5 * out))


def _run_both(jm, tm, jp, js, x, training, dtype=np.float32):
    """Both packages' (output, new state, parameter gradients) of
    sum(sin(out / 2)) in ``dtype``."""
    cast = lambda t: jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, dtype)), t)

    def f(p):
        out, ns = jm.apply(p, cast(js), jnp.asarray(x.astype(dtype)),
                           training=training)
        return _sin(out, jnp), (out, ns)
    (_, (jout, jns)), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(
        cast(jp))
    params = tm.params
    out, ns = tm.apply(params, tm.state, torch.from_numpy(x.astype(dtype)),
                       training=training)
    leaves = convert.flatten(params)
    g = torch.autograd.grad(_sin(out, torch), list(leaves.values()))
    return (out, ns, convert.unflatten(dict(zip(leaves, g)))), \
        (jout, jns, jg)


@pytest.fixture
def x64():
    """JAX's float64 mode for one test, restored after it."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


# -- the xla blocks ---------------------------------------------------------------

BLOCKS = [
    # nin, nmid, stride, zero_init_residual
    (16, 8, 1, False),     # projecting block
    (16, 8, 2, True),      # strided projecting block
    (32, 8, 1, True),      # identity block
]


@pytest.mark.parametrize("nin,nmid,stride,zero_init", BLOCKS)
def test_xla_bottleneck_matches_jax(monkeypatch, nin, nmid, stride,
                                    zero_init):
    monkeypatch.setenv("BIGDL_TPU_FLASH", "off")
    jb = jresnet.FusedBottleneck(nin, nmid, stride, 4, zero_init,
                                 kernel="xla")
    jp, js = jb.init(jax.random.PRNGKey(1))
    tb = FusedBottleneck(nin, nmid, stride, 4, zero_init, kernel="xla")
    tb.load_state_dict(convert.jax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jp),
        jax.tree_util.tree_map(np.asarray, js)))
    x = np.random.RandomState(nin + stride).randn(2, 8, 8, nin).astype(
        np.float32)
    for training in (True, False):
        (out, ns, g), (jout, jns, jg) = _run_both(jb, tb, jp, js, x,
                                                  training)
        assert _rel(out, jout) <= TOL
        assert max(_tree_errs(ns, jns).values()) <= TOL
        assert max(_tree_errs(g, jg).values()) <= GRAD_TOL


def test_xla_chain_matches_jax(monkeypatch):
    """The chain of xla blocks writes its junctions out (JAX's
    ``_junction`` off its kernel), zero-initialised residual gammas
    included: the junctions then sit on the ReLU's kink, where both
    packages' max(u, 0) pass half the gradient."""
    monkeypatch.setenv("BIGDL_TPU_FLASH", "off")

    def blocks(mod, zero_init):
        return [mod.FusedBottleneck(16, 8, 2, 4, zero_init, kernel="xla"),
                mod.FusedBottleneck(32, 8, 1, 4, zero_init, kernel="xla"),
                mod.FusedBottleneck(32, 8, 1, 4, zero_init, kernel="xla")]

    x = np.random.RandomState(5).randn(2, 8, 8, 16).astype(np.float32)
    for zero_init in (True, False):
        jc = jresnet.FusedBottleneckChain(blocks(jresnet, zero_init))
        jp, js = jc.init(jax.random.PRNGKey(2))
        tc = FusedBottleneckChain(blocks(tresnet, zero_init))
        tc.load_state_dict(convert.jax_to_state_dict(
            jax.tree_util.tree_map(np.asarray, jp),
            jax.tree_util.tree_map(np.asarray, js)))
        for training in (True, False):
            (out, ns, g), (jout, jns, jg) = _run_both(jc, tc, jp, js, x,
                                                      training)
            assert _rel(out, jout) <= TOL
            assert max(_tree_errs(ns, jns).values()) <= TOL
            assert max(_tree_errs(g, jg).values()) <= GRAD_TOL


# -- whole ResNet-50 ------------------------------------------------------------

def _models(monkeypatch, chain, fused):
    """(JAX model, port model, JAX params, JAX state): the port's weights
    (zero_init_residual off, so no junction sits on a kink), carried into
    JAX; JAX's model built with ``BIGDL_TPU_FUSED_CHAIN`` set as asked."""
    monkeypatch.setenv("BIGDL_TPU_FLASH", "off")
    monkeypatch.setenv("BIGDL_TPU_FUSED_CHAIN", "1" if chain else "0")
    jm = jresnet.ResNet(10, 50, format="NHWC", fused=fused,
                        zero_init_residual=False)
    tm = ResNet(10, 50, format="NHWC", fused=fused, fused_chain=chain,
                zero_init_residual=False, device="cpu", seed=3)
    jp, js = convert.to_numpy_trees(tm)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    for got, want in zip((jp, js), shapes):
        g, w = convert.flatten(got), convert.flatten(want)
        assert sorted(g) == sorted(w)
        assert all(g[k].shape == w[k].shape for k in w)
    return jm, tm, jp, js


def _hold_training_step(jm, tm, jp, js, stage0):
    """One float32 training step of both; ``stage0``: the Sequential
    indices that hold stage 0's blocks."""
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    (out, ns, g), (jout, jns, jg) = _run_both(jm, tm, jp, js, x, True)
    assert _rel(out, jout) <= 1e-3
    assert max(_tree_errs(ns, jns).values()) <= 1e-3
    errs = _tree_errs(g, jg)
    last = max(int(k) for k in tm.params)          # the classifier
    head = [k for k in errs if k.split(".")[0] == str(last)]
    assert len(head) == 2 and max(errs[k] for k in head) <= 1e-3
    low = [k for k in errs if k.split(".")[0] in ("0", "1") + stage0]
    assert len(low) == 3 + 3 * 9 + 3     # stem; 3 blocks, 1 projection
    assert max(errs[k] for k in low) <= 1e-1, sorted(
        ((k, errs[k]) for k in low), key=lambda e: -e[1])[:3]


def test_xla_arm_matches_jax(monkeypatch):
    jm, tm, jp, js = _models(monkeypatch, True, "xla")
    chains = [m for m in tm.modules() if isinstance(m, FusedBottleneckChain)]
    assert [len(c.blocks) for c in chains] == [3, 4, 6, 3]
    assert {b.kernel for c in chains for b in c.blocks} == {"xla"}
    _hold_training_step(jm, tm, jp, js, ("4",))


def test_xla_arm_float64_gradients_match_jax(monkeypatch, x64):
    jm, tm, jp, js = _models(monkeypatch, True, "xla")
    tm = tm.double()
    x = np.random.RandomState(1).randn(2, 64, 64, 3)
    (out, _, g), (jout, _, jg) = _run_both(jm, tm, jp, js, x, False,
                                           np.float64)
    assert out.dtype == torch.float64 and jout.dtype == jnp.float64
    assert _rel(out, jout) <= 1e-6
    errs = _tree_errs(g, jg)
    assert max(errs.values()) <= 1e-6, sorted(errs.items(),
                                              key=lambda e: -e[1])[:3]


def test_chain_off_arm_matches_jax_and_carries_its_layout(monkeypatch):
    """JAX's unchained layout (blocks at Sequential indices 4-19, no chain
    container) loads strictly into the port's chain-off model and comes
    back unchanged; one training step follows JAX's."""
    jm, tm, jp, js = _models(monkeypatch, False, "pallas")
    blocks = [m for m in tm.modules() if isinstance(m, FusedBottleneck)]
    assert len(blocks) == 16 and not any(
        isinstance(m, FusedBottleneckChain) for m in tm.modules())
    flat = convert.flatten(jp)
    assert "4.w1" in flat and "19.bn3.weight" in flat
    assert not any(k.startswith("4.0.") for k in flat)
    again = ResNet(10, 50, format="NHWC", fused="pallas", fused_chain=False,
                   zero_init_residual=False, device="cpu", seed=9)
    again.load_state_dict(convert.jax_to_state_dict(jp, js))
    back_p, back_s = convert.to_numpy_trees(again)
    for got, want in ((back_p, jp), (back_s, js)):
        g, w = convert.flatten(got), convert.flatten(want)
        assert sorted(g) == sorted(w)
        assert all(np.array_equal(g[k], w[k]) for k in w)
    _hold_training_step(jm, tm, jp, js, ("4", "5", "6"))


@pytest.mark.parametrize("fused,chain,k3,k5", [
    ("pallas", True, 24, 12), ("pallas", False, 36, 0),
    ("xla", True, 0, 0), ("xla", False, 0, 0)],
    ids=["pallas_chained", "pallas_unchained", "xla_chained",
         "xla_unchained"])
def test_kernel_calls_a_training_forward(monkeypatch, fused, chain, k3, k5):
    """The K3 / K5 wrapper calls of one training forward of ResNet-50: the
    launch counts phase 16 of ``chip_smoke.py`` asserts on the card. The
    arms' logits agree (on the CPU the wrappers run their plain
    versions)."""
    calls = {"k3": 0, "k5": 0}

    def counted(fn, key):
        def call(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return call
    monkeypatch.setattr(tresnet, "fused_bn_relu_matmul_nhwc",
                        counted(tresnet.fused_bn_relu_matmul_nhwc, "k3"))
    monkeypatch.setattr(tresnet, "fused_residual_matmul_nhwc",
                        counted(tresnet.fused_residual_matmul_nhwc, "k5"))
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 32, 32, 3)
                         .astype(np.float32))
    tm = ResNet(10, 50, format="NHWC", fused=fused, fused_chain=chain,
                device="cpu", seed=4)
    out, _ = tm.apply(tm.params, tm.state, x, training=True)
    assert calls == {"k3": k3, "k5": k5}
    ref = ResNet(10, 50, format="NHWC", fused="pallas", device="cpu", seed=4)
    want, _ = ref.apply(ref.params, ref.state, x, training=True)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)


def test_fused_conv2_needs_the_pallas_arm():
    for build in (lambda: ResNet(10, 50, format="NHWC", fused="xla",
                                 fused_conv2=True, device="cpu"),
                  lambda: FusedBottleneck(16, 8, kernel="xla",
                                          fused_conv2=True),
                  lambda: FusedBottleneck(16, 8, kernel="mosaic")):
        with pytest.raises(ValueError):
            build()
    # fused_conv2 with the chain off: every 3x3 conv still goes through K4
    m = ResNet(10, 50, format="NHWC", fused="pallas", fused_conv2=True,
               fused_chain=False, device="cpu")
    assert sum(isinstance(b, FusedBottleneck) and b.fused_conv2
               for b in m.modules()) == 16
