"""Shared pieces of the layer-library parity tests
(``test_torch_layers_*``, ``test_torch_criteria``, ``test_torch_zoo``,
``test_torch_backward_protocol``): one JAX module and its port built from
the same constructor call, the JAX parameters (redrawn from a numpy seed
so no layer sits at its special initial values) carried into the port
with ``convert``, and both run on the same numpy inputs - tensors or
``Table``\\ s of them - through ``apply``, a loss sum(sin(out / 2)) over
every output, and its gradients in the parameters and the float inputs."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.utils.table import Table as JTable
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.utils.table import Table

TOL = dict(atol=1e-5, rtol=1e-5)        # layers and criteria, float32


def to_jax(x):
    if isinstance(x, (list, tuple)):
        return JTable(*[to_jax(v) for v in x])
    return jnp.asarray(x)


def to_torch(x):
    if isinstance(x, (list, tuple)):
        return Table(*[to_torch(v) for v in x])
    return torch.from_numpy(np.array(x, copy=True))


def leaves(x):
    """The arrays / tensors of a value, a Table / list of them, nested."""
    if isinstance(x, (list, tuple, JTable, Table)):
        return [t for v in x for t in leaves(v)]
    return [x]


def float_slots(x):
    """Indices (in ``leaves`` order) of the floating inputs."""
    return [i for i, a in enumerate(leaves(x))
            if np.issubdtype(np.asarray(a).dtype, np.floating)]


def substitute(x, new, make):
    """x's structure (numpy, nested lists) with the leaves at
    ``float_slots`` taken from ``new`` and every other leaf through
    ``make``; lists become ``Table``\\ s of the package."""
    slots = dict(zip(float_slots(x), new))
    counter = iter(range(len(leaves(x))))

    def rec(v):
        if isinstance(v, (list, tuple)):
            items = [rec(i) for i in v]
            return (JTable if make is jnp.asarray else Table)(*items)
        i = next(counter)
        return slots[i] if i in slots else make(np.array(v, copy=True))
    return rec(x)


def sin_loss(out, xp):
    return sum(xp.sum(xp.sin(0.5 * o)) for o in leaves(out)
               if o.dtype in (jnp.float32, torch.float32))


def jax_params(jm, seed=0, redraw=True, state=None, jit=False):
    """JAX parameters (and state) of ``jm`` as numpy, every float leaf
    redrawn as 0.5 N(0, 1) from ``seed`` unless ``redraw`` is False. With
    ``jit`` and ``redraw`` JAX's initialisers are not run: the parameters'
    shapes come from ``jax.eval_shape`` (no compilation) and the state
    from ``_init_state``."""
    if jit and redraw:
        jp = jax.eval_shape(jm._init_params, jax.random.PRNGKey(seed))
        js = jm._init_state()
    else:
        jp, js = jm.init(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed + 100)
    jp = jax.tree_util.tree_map(
        lambda a: (0.5 * rng.randn(*np.shape(a))).astype(np.float32)
        if redraw else np.array(a, np.float32), jp)
    js = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), js)
    if state is not None:
        js = state(js)
    return jp, js


def load(tm, jp, js):
    """The port module ``tm`` with JAX's parameters and state (strict: the
    trees must have the same names and shapes)."""
    tm.load_state_dict(convert.jax_to_state_dict(jp, js))
    return tm


def run_jax(jm, jp, js, x, training, loss=sin_loss, jit=False):
    """(output, new state, parameter gradients, float-input gradients);
    with ``jit`` the loss and its gradients are one compiled function (one
    compilation, where op-by-op dispatch compiles every primitive: faster
    for a module of many small ops, such as a recurrence)."""
    fl = [jnp.asarray(leaves(x)[i]) for i in float_slots(x)]

    def f(p, fl):
        out, ns = jm.apply(p, js, substitute(x, fl, jnp.asarray),
                           training=training)
        return loss(out, jnp), (out, ns)
    vg = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)
    (_, (out, ns)), (gp, gx) = (jax.jit(vg) if jit else vg)(
        jax.tree_util.tree_map(jnp.asarray, jp), fl)
    return out, ns, gp, gx


def run_port(tm, x, training, loss=sin_loss, generator=None):
    fl = [torch.from_numpy(np.array(leaves(x)[i], copy=True))
          .requires_grad_() for i in float_slots(x)]
    params = tm.params
    out, ns = tm.apply(params, tm.state, substitute(x, fl, torch.from_numpy),
                       training=training, generator=generator)
    pl = convert.flatten(params)
    wrt = list(pl.values()) + fl
    value = loss(out, torch)
    grads = torch.autograd.grad(value, wrt, allow_unused=True) \
        if wrt and value.requires_grad else [None] * len(wrt)
    grads = [torch.zeros_like(w) if g is None else g
             for w, g in zip(wrt, grads)]
    gp = convert.unflatten(dict(zip(pl, grads[:len(pl)])))
    return out, ns, gp, grads[len(pl):]


def close(got, want, tol=TOL, what=""):
    """Tensors / arrays / Tables / nested dicts of them equal within
    ``tol``."""
    if isinstance(want, dict):
        g, w = convert.flatten(got), convert.flatten(
            jax.tree_util.tree_map(np.asarray, want))
        assert sorted(g) == sorted(w), (what, sorted(g), sorted(w))
        for k in w:
            close(g[k], w[k], tol, f"{what}.{k}")
        return
    gl, wl = leaves(got), leaves(want)
    assert len(gl) == len(wl), what
    for g, w in zip(gl, wl):
        w = torch.from_numpy(np.array(w))
        g = g.detach() if torch.is_tensor(g) else torch.from_numpy(
            np.array(g))
        assert tuple(g.shape) == tuple(w.shape), (what, g.shape, w.shape)
        torch.testing.assert_close(g.to(w.dtype), w, **tol, msg=what)


def check_pair(jm, tm, x, training, seed=0, redraw=True, state=None,
               loss=sin_loss, tol=TOL, jit=False):
    """Hold the port module against its JAX twin on input ``x``: output,
    new state, parameter and input gradients (JAX's compiled as one
    function with ``jit``)."""
    jp, js = jax_params(jm, seed, redraw, state, jit)
    load(tm, jp, js)
    jout, jns, jgp, jgx = run_jax(jm, jp, js, x, training, loss, jit)
    out, ns, gp, gx = run_port(tm, x, training, loss)
    close(out, jout, tol, "output")
    close(convert.to_numpy_tree(ns), jns, tol, "state")
    close(gp, jgp, tol, "param grads")
    close(gx, jgx, tol, "input grads")
    return out
