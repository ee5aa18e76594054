"""Tensor-parallel and FSDP execution of the port's Transformer LM on a
gloo world of 4 ranks, held against JAX's ``jit`` over the same placement
on 4 virtual CPU devices (``tests/test_distributed.py``'s TP decode and
FSDP training drills) and against one rank.

The port finds the placement in the leaves a rank holds
(``parallel.sharding``): column-split ``wq`` means tensor parallel (the
model sums its partial outputs over ``model`` after ``wo`` and ``w2``),
other smaller leaves are FSDP slices (each block gathers them just before
it runs). ``generate``: tokens equal to JAX's TP / FSDP run and to one
rank, last logits at 1e-4. Training: three SGD steps of the flagship's
recipe, parameters at 2e-5 (JAX's FSDP bound) against JAX's
``jit``-over-specs step, every rank's block of every leaf; a gradient
scaled by n (a ``psum`` backward on a replicated cotangent) would move
the parameters n times too far. TP runs at 4 heads over 4 ranks (one head
a rank) and at 2 heads over 4 ranks (a head split across ranks: the model
gathers the split columns and runs the layer whole, as JAX's compiler
reshards them).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bigdl_tpu.models import TransformerLM as JaxLM
from bigdl_tpu.models.transformer_lm import lm_loss_chunked as jax_loss
from bigdl_tpu.optim import SGD as JaxSGD
from bigdl_tpu.parallel import fsdp_specs, transformer_tp_specs

import torch_dist_helpers as dh

torch.set_num_threads(1)
N = 4
GEN = dict(vocab_size=67, hidden_size=32, num_heads=8, filter_size=64,
           num_layers=2, max_len=32)
TRAIN = dict(vocab_size=64, hidden_size=32, num_heads=2, filter_size=64,
             num_layers=2, max_len=16)
TRAIN4 = dict(TRAIN, num_heads=4)
STEPS = 3
_cache = {}


def _jax_params(cfg, seed):
    jm = JaxLM(**cfg)
    params, _ = jm.init(jax.random.PRNGKey(seed))
    return jm, jax.tree_util.tree_map(np.asarray, params)


def _data():
    x = np.random.RandomState(0).randint(1, 64, (8, 12)).astype(np.int64)
    y = np.random.RandomState(1).randint(1, 64, (8, 12)).astype(np.int64)
    return x, y


CASES = {"generate_tp": ("generate", GEN, "tp"),
         "generate_fsdp": ("generate", GEN, "fsdp"),
         "train_tp": ("train", TRAIN4, "tp"),
         "train_tp_split_heads": ("train", TRAIN, "tp"),
         "train_fsdp": ("train", TRAIN, "fsdp")}
IDS = np.random.RandomState(1).randint(1, 67, (2, 6)).astype(np.int64)


def _world():
    if "world" not in _cache:
        x, y = _data()
        cases = []
        for kind, cfg, placement in CASES.values():
            _, w = _jax_params(cfg, 0)
            if kind == "generate":
                cases.append((kind, dict(cfg=cfg, weights=w, ids=IDS,
                                         max_new=8, placement=placement)))
            else:
                cases.append((kind, dict(cfg=cfg, weights=w, x=x, y=y,
                                         placement=placement, steps=STEPS)))
        out = dh.run_world(dh.mp_cases, N, cases, timeout_s=150)
        _cache["world"] = {k: [o[i] for o in out]
                           for i, k in enumerate(CASES)}
    return _cache["world"]


def _mesh(axis):
    return Mesh(np.array(jax.devices()[:N]), (axis,))


def _block(a, spec, r):
    """Rank r's block of the whole array ``a`` under a spec tuple."""
    for d, ax in enumerate(tuple(spec)):
        if ax is not None:
            k = a.shape[d] // N
            a = np.take(a, range(r * k, (r + 1) * k), axis=d)
    return a


@pytest.mark.parametrize("key", ["generate_tp", "generate_fsdp"])
def test_generate_equals_jax_placement_and_one_rank(key):
    out = _world()[key]
    _, cfg, placement = CASES[key]
    jm, w = _jax_params(cfg, 0)
    params = jax.tree_util.tree_map(jnp.asarray, w)
    want = np.asarray(jm.generate(params, jnp.asarray(IDS, jnp.int32),
                                  max_new_tokens=8))
    axis = "model" if placement == "tp" else "data"
    mesh = _mesh(axis)
    specs = (transformer_tp_specs(params) if placement == "tp"
             else fsdp_specs(params, mesh, min_elems=256))
    placed = jax.tree_util.tree_map(
        lambda v, s: jax.device_put(v, NamedSharding(mesh, s)), params,
        specs)
    got_jax = np.asarray(jax.jit(lambda p, x: jm.generate(
        p, x, max_new_tokens=8))(placed, jnp.asarray(IDS, jnp.int32)))
    np.testing.assert_array_equal(got_jax, want)
    for o in out:
        np.testing.assert_array_equal(o["tokens"], want)
        np.testing.assert_array_equal(o["solo"], want)
        np.testing.assert_allclose(o["logits"], o["solo_logits"], atol=1e-4)
    jlogits, _ = jm.prefill(params, jnp.asarray(want, jnp.int32),
                            want.shape[1] + 1)
    np.testing.assert_allclose(out[0]["logits"], np.asarray(jlogits),
                               atol=1e-4)
    # each rank holds its block: about 1/n of the sliced leaves
    assert out[0]["resident"] < out[0]["whole"]


def _jax_train(cfg, placement):
    jm, w = _jax_params(cfg, 0)
    params = jax.tree_util.tree_map(jnp.asarray, w)
    optim = JaxSGD(learningrate=0.1, momentum=0.9)
    x, y = (jnp.asarray(a, jnp.int32) for a in _data())

    def step(p, s, xb, yb):
        def loss_fn(q):
            h = jm.hidden_states(q, xb, training=False)
            return jax_loss(h, q["embed"], yb, chunk=4)
        loss, grads = jax.value_and_grad(loss_fn)(p)
        p, s = optim.update(grads, p, s, jnp.float32(0.1))
        return loss, p, s

    axis = "model" if placement == "tp" else "data"
    mesh = _mesh(axis)
    specs = (transformer_tp_specs(params) if placement == "tp"
             else fsdp_specs(params, mesh, min_elems=256))
    p = jax.tree_util.tree_map(
        lambda v, s: jax.device_put(v, NamedSharding(mesh, s)), params,
        specs)
    if placement == "fsdp":
        x = jax.device_put(x, NamedSharding(mesh, P("data")))
        y = jax.device_put(y, NamedSharding(mesh, P("data")))
    s = optim.init_state(p)
    step_j = jax.jit(step)
    losses, trail = [], []
    for _ in range(STEPS):
        loss, p, s = step_j(p, s, x, y)
        losses.append(float(loss))
        trail.append(jax.tree_util.tree_map(np.asarray, p))
    return losses, trail, jax.tree_util.tree_map(tuple, specs,
                                                 is_leaf=lambda v:
                                                 isinstance(v, P))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("key", ["train_tp", "train_tp_split_heads",
                                 "train_fsdp"])
def test_training_steps_equal_jax_over_the_same_specs(key):
    out = _world()[key]
    _, cfg, placement = CASES[key]
    losses, trail, specs = _jax_train(cfg, placement)
    fs = _flat(specs)
    for r, o in enumerate(out):
        np.testing.assert_allclose(o["losses"], losses, rtol=1e-5)
        for step, (mine, theirs) in enumerate(zip(o["params"], trail)):
            for name, a in _flat(theirs).items():
                np.testing.assert_allclose(
                    mine[name], _block(a, fs[name], r), rtol=2e-5,
                    atol=2e-5, err_msg=f"rank {r} step {step} {name}")


def test_spec_trees_equal_jax():
    """transformer_tp_specs / fsdp_specs / serving_param_specs over the
    port's parameter tree give JAX's spec trees (the port's tuples)."""
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.parallel import sharding as tsh
    from bigdl_tpu.parallel import sharding as jsh
    cfg = dict(TRAIN, num_kv_heads=1, ffn_activation="swiglu")
    tm = TransformerLM(device="cpu", **cfg)
    jm, w = _jax_params(cfg, 0)

    class _M:        # a stand-in 4-rank data mesh for the spec rules
        mesh_dim_names = ("data",)

        def size(self, i=None):
            return N
    is_p = dict(is_leaf=lambda v: isinstance(v, P))
    jt = jax.tree_util.tree_map(tuple, transformer_tp_specs(w), **is_p)
    assert tsh.transformer_tp_specs(tm.params) == jt
    for me in (256, 16384):
        jf = jax.tree_util.tree_map(
            tuple, fsdp_specs(w, _mesh("data"), min_elems=me), **is_p)
        assert tsh.fsdp_specs(tm.params, _M(), min_elems=me) == jf
    for placement in ("tp", None, "replicated"):
        js = jax.tree_util.tree_map(tuple, jsh.serving_param_specs(
            w, _mesh("model"), placement), **is_p)
        assert tsh.serving_param_specs(tm.params, _M(), placement) == js
    assert tsh.tp_linear_rules() == jax.tree_util.tree_map(
        tuple, jsh.tp_linear_rules(), **is_p)
    assert tsh.SERVING_BATCH_AXES == jsh.SERVING_BATCH_AXES
