"""``LBFGS.optimize`` and the closure form ``OptimMethod.optimize`` against
the JAX package's (``optim/optim_method.py``), on convex full-batch
problems: a least-squares fit of a flat vector and a softmax regression
whose parameters are a nested tree (keys out of order, so the flat
vector's order - sorted keys at every level, as JAX's ``ravel_pytree`` -
matters).

Tolerances: every loss of the run and the final parameters within 1e-5
relative to their largest value, float32 on both sides (the same host
loop on the same gradients, apart from the summation order of the dot
products; the iterate moves by ~1e-7 relative a step through it), and
the same number of losses: the same exits taken.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.optim import optim_method as jom
from bigdl_tpu_torch.optim import optim_method as tom

torch.set_num_threads(1)
REL = 1e-5


def _problem(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(24, 5).astype(np.float32)
    y = rng.randint(0, 3, size=24)
    w0 = {"w": 0.1 * rng.randn(5, 3).astype(np.float32),
          "blk": {"z": np.zeros(3, np.float32),
                  "a": 0.1 * rng.randn(3).astype(np.float32)}}
    return x, y, w0


def _softmax_loss(xp, logsm, p, x, y):
    logits = x @ p["w"] + p["blk"]["a"] + 0.5 * p["blk"]["z"]
    ll = logsm(logits)
    reg = 0.01 * (xp.sum(p["w"] ** 2) + xp.sum(p["blk"]["a"] ** 2)
                  + xp.sum(p["blk"]["z"] ** 2))     # strictly convex
    return -xp.mean(ll[xp.arange(len(y)), y]) + reg


def _fevals(x, y):
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    yj, yt = jnp.asarray(y), torch.from_numpy(y)
    jloss = lambda p: _softmax_loss(jnp, lambda v: jax.nn.log_softmax(v, -1),
                                    p, xj, yj)
    jf = jax.jit(jax.value_and_grad(jloss))

    def tf(p):
        leaves = jax.tree_util.tree_leaves(p)   # a nested dict of tensors
        leaves = [t.detach().requires_grad_() for t in leaves]
        tree = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(p),
                                            leaves)
        loss = _softmax_loss(torch, lambda v: torch.log_softmax(v, -1),
                             tree, xt, yt)
        grads = torch.autograd.grad(loss, leaves)
        return loss.item(), jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(p), list(grads))
    return jf, tf


def _flat(tree):
    return np.concatenate([np.asarray(
        t.detach() if torch.is_tensor(t) else t).ravel()
        for t in jax.tree_util.tree_leaves(tree)])


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("kw", [
    dict(max_iter=15),
    dict(max_iter=15, line_search=True, learningrate=1.0),
    dict(max_iter=12, n_correction=2, line_search=True),
    dict(max_iter=40, max_eval=8),
    dict(max_iter=30, tol_fun=1e-3),
], ids=["fixed_step", "line_search", "two_corrections", "max_eval",
        "tol_fun_exit"])
def test_lbfgs_on_a_tree_matches_jax(kw):
    x, y, w0 = _problem()
    jf, tf = _fevals(x, y)
    jw, jlosses = jom.LBFGS(**kw).optimize(
        jf, jax.tree_util.tree_map(jnp.asarray, w0))
    t0 = jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()), w0)
    m = tom.LBFGS(**kw)
    tw, tlosses = m.optimize(tf, t0)
    assert len(tlosses) == len(jlosses) and len(tlosses) > 2
    assert tlosses[-1] < tlosses[0]
    assert _rel(tlosses, jlosses) <= REL
    assert _rel(_flat(tw), _flat(jw)) <= REL
    assert sorted(tw) == ["blk", "w"] and tw["blk"]["a"].shape == (3,)
    assert m.state["neval"] == 1


def test_lbfgs_on_a_vector_matches_jax():
    """Least squares on a bare vector, where the first step is scaled by
    min(1, 1 / sum|g|)."""
    rng = np.random.RandomState(3)
    a = rng.randn(30, 6).astype(np.float32)
    b = rng.randn(30).astype(np.float32)
    jf = jax.jit(jax.value_and_grad(
        lambda w: jnp.sum((jnp.asarray(a) @ w - jnp.asarray(b)) ** 2)))

    def tf(w):
        w = w.detach().requires_grad_()
        loss = ((torch.from_numpy(a) @ w - torch.from_numpy(b)) ** 2).sum()
        return loss.item(), torch.autograd.grad(loss, w)[0]
    jw, jl = jom.LBFGS(max_iter=10).optimize(jf, jnp.zeros(6))
    tw, tl = tom.LBFGS(max_iter=10).optimize(tf, torch.zeros(6))
    assert len(tl) == len(jl) and tw.shape == (6,)
    assert _rel(tl, jl) <= REL and _rel(tw, jw) <= REL


def test_lbfgs_flattens_in_ravel_pytree_order():
    from jax.flatten_util import ravel_pytree
    _, _, w0 = _problem()
    want, _ = ravel_pytree(w0)
    got, unravel = tom._ravel(jax.tree_util.tree_map(torch.from_numpy, w0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = unravel(got)
    np.testing.assert_array_equal(back["blk"]["a"].numpy(), w0["blk"]["a"])


@pytest.mark.parametrize("make", [
    lambda o: o.SGD(0.1, momentum=0.9),
    lambda o: o.Adam(0.05),
    lambda o: o.LBFGS(learningrate=0.2).__class__.__mro__[1](0.3),
], ids=["sgd_momentum", "adam", "base_class"])
def test_closure_optimize_steps_match_jax(make):
    """``OptimMethod.optimize``: one update a call, the method's state kept
    across calls; the port writes x in place and returns it."""
    x, y, w0 = _problem(1)
    jf, tf = _fevals(x, y)
    jm, tm = make(jom), make(tom)
    if type(jm) is jom.OptimMethod:     # the base class has no update
        pytest.raises(NotImplementedError, tm.optimize, tf,
                      jax.tree_util.tree_map(torch.from_numpy, w0))
        return
    jw = jax.tree_util.tree_map(jnp.asarray, w0)
    tw = jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()), w0)
    for _ in range(4):
        jw, jl = jm.optimize(jf, jw)
        out, tl = tm.optimize(tf, tw)
        assert out is tw
        assert abs(tl[0] - float(jl[0])) <= REL * abs(float(jl[0]))
    assert _rel(_flat(tw), _flat(jw)) <= REL
    assert tm.state["neval"] == jm.state["neval"] == 4
