"""The rest of mesh serving and model parallelism in the port, on gloo
worlds of 2 and 4 ranks, held against JAX's virtual-device meshes and
against one rank:

* the host KV tier under a tensor-parallel mesh
  (``DecodeScheduler(mesh=, host_blocks=)``): a device pool small enough
  that admission spills the prefix chains and a repeated prefix refills
  them; tokens equal the one-rank scheduler's bit for bit and JAX's mesh
  scheduler's up to the first near-tie, the host-tier counts are equal
  on every rank, and every refill writes each rank's pages bit for bit as
  they were spilled;
* tensor parallelism and FSDP at once: a 2 x 2 ``(data, model)`` training
  step with the tensor-parallel specs over ``model`` (the matrices also
  sliced over ``data`` along their other dimension) and every other leaf
  of >= 32 elements over ``data`` (the blocks' norms and biases too),
  against JAX's ``jit`` over the same specs, parameters at 2e-5 (JAX's
  FSDP bound);
* dropout under tensor parallelism: each rank's dropout draws are its
  heads' / filter columns' block of the one-rank step's draws over the
  whole tree, mask for mask, and the hidden states and gradients agree;
* ``ServingEngine(mesh=, placement=fsdp)`` over the LM: outputs against
  JAX's forward and the direct apply, with no whole-tree gather and at
  most one block's bytes gathered at once.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bigdl_tpu.models.transformer_lm import TransformerLM as JaxLM
from bigdl_tpu.models.transformer_lm import lm_loss_chunked as jax_loss
from bigdl_tpu.optim import SGD as JaxSGD
from bigdl_tpu.parallel import fsdp_specs, transformer_tp_specs
from bigdl_tpu.serving import DecodeScheduler as JaxScheduler

import torch_dist_helpers as dh

torch.set_num_threads(1)
MARGIN = 1e-3
CFG = dict(vocab_size=64, hidden_size=32, num_heads=4, filter_size=64,
           num_layers=2, max_len=128, num_kv_heads=2)
# 11 usable blocks of 4: a finished request's pinned chain must spill for
# the next admission, and a repeated prefix refills it
TIER = dict(max_slots=2, block_size=4, max_seq_len=64, prefill_chunk=8,
            num_blocks=12, host_blocks=32)
_rng = np.random.RandomState(5)
_pre = _rng.randint(1, 64, size=16).astype(np.int32)
TIER_PROMPTS = [np.concatenate([_pre, _rng.randint(1, 64, size=5)
                                .astype(np.int32)]),
                _rng.randint(1, 64, size=24).astype(np.int32),
                np.concatenate([_pre, _rng.randint(1, 64, size=3)
                                .astype(np.int32)])]
TRAIN = dict(vocab_size=64, hidden_size=32, num_heads=4, filter_size=64,
             num_layers=2, max_len=16)
STEPS = 2
MIN_ELEMS = 32     # the blocks' norms and b2 are sliced over ``data`` too
_cache = {}


def _wide(cfg, seed=0):
    """JAX's LM with every leaf redrawn as 0.3 * N(0, 1) (wide margins):
    (the JAX model, the numpy tree both packages load)."""
    key = ("w", tuple(sorted(cfg.items())), seed)
    if key not in _cache:
        jm = JaxLM(**cfg)
        jp, _ = jm.init(jax.random.PRNGKey(seed))
        r = np.random.RandomState(seed)
        w = jax.tree_util.tree_map(
            lambda a: (0.3 * r.randn(*np.shape(a))).astype(np.float32), jp)
        jm.params = jax.tree_util.tree_map(jnp.asarray, w)
        _cache[key] = (jm, w)
    return _cache[key]


def _margins(cfg, weights, prompt, n):
    """Top-2 margins of the port's dense solo greedy decode."""
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.nn.module import copy_tree_into
    tm = TransformerLM(device="cpu", **cfg)
    copy_tree_into(tm.params, weights)
    logits, caches = tm.prefill(tm.params, torch.from_numpy(prompt)[None],
                                cfg["max_len"])
    out, pos = [], prompt.size
    for i in range(n):
        top = logits[0].topk(2).values
        out.append(float(top[0] - top[1]))
        if i < n - 1:
            logits, caches = tm.decode_one(tm.params,
                                           [int(logits[0].argmax())], pos,
                                           caches)
            pos += 1
    return np.array(out)


# -- the host tier under a mesh ------------------------------------------------

def _tier_world():
    if "tier" not in _cache:
        _, w = _wide(CFG)
        _cache["tier"] = dh.run_world(dh.mesh_host_tier, 2, CFG, w, TIER,
                                      TIER_PROMPTS, 8, timeout_s=120)
    return _cache["tier"]


def test_mesh_host_tier_tokens_equal_one_rank_and_jax():
    out = _tier_world()
    jm, w = _wide(CFG)
    mesh = Mesh(np.array(jax.devices()[:2]), ("model",))
    sched = JaxScheduler(jm, mesh=mesh, placement="tp", **TIER)
    with sched:
        want = [np.asarray(sched.submit(p, 8).result(timeout=60))
                for p in TIER_PROMPTS]
    o = out[0]
    for p, got, solo, jw in zip(TIER_PROMPTS, o["tokens"], o["solo"], want):
        np.testing.assert_array_equal(got, solo)
        m = _margins(CFG, w, p, len(jw))
        low = np.nonzero(m < MARGIN)[0]
        k = len(m) if low.size == 0 else int(low[0]) + 1
        np.testing.assert_array_equal(got[:k], jw[:k])
    # the same spills and refills as the one-rank scheduler's (JAX's
    # stager lands its spills on its own clock, so its second-chance hits
    # are timing-dependent and not compared)
    assert o["prefix"] == o["solo_prefix"]
    assert o["prefix"]["spills"] > 0 and o["prefix"]["hits_after_spill"] == 1


def test_mesh_host_tier_counts_equal_on_every_rank():
    out = _tier_world()
    assert out[0]["host"]["host_spills"] > 0
    assert out[0]["host"]["swap_in_bytes"] > 0
    for o in out:
        assert o["host"] == out[0]["host"]
        assert o["refills"] == out[0]["refills"] > 0
        assert o["page_heads"] == CFG["num_kv_heads"] // 2
    assert out[0]["host"]["host_blocks_in_use"] == 0


def test_mesh_host_tier_refills_each_ranks_pages_bit_for_bit():
    for o in _tier_world():
        assert o["refilled_bitwise"] and all(o["refilled_bitwise"])


# -- tensor parallelism with FSDP ------------------------------------------------

def _tp_fsdp_specs(params, mesh):
    tp = transformer_tp_specs(params)
    fs = fsdp_specs(params, mesh, min_elems=MIN_ELEMS)
    return jax.tree_util.tree_map(
        lambda a, b: P(*dh.tp_fsdp_spec(a, b)), tp, fs,
        is_leaf=lambda v: isinstance(v, P))


def _data():
    x = np.random.RandomState(0).randint(1, 64, (8, 12)).astype(np.int64)
    y = np.random.RandomState(1).randint(1, 64, (8, 12)).astype(np.int64)
    return x, y


def test_tp_with_fsdp_2x2_training_matches_jax_jit():
    jm = JaxLM(**TRAIN)
    params, _ = jm.init(jax.random.PRNGKey(0))
    w = jax.tree_util.tree_map(np.asarray, params)
    x, y = _data()
    out = dh.run_world(dh.tp_fsdp_training, 4, TRAIN, w, x, y, STEPS,
                       MIN_ELEMS, timeout_s=120)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    specs = _tp_fsdp_specs(params, mesh)
    optim = JaxSGD(learningrate=0.1, momentum=0.9)

    def step(p, s, xb, yb):
        def loss_fn(q):
            h = jm.hidden_states(q, xb, training=False)
            return jax_loss(h, q["embed"], yb, chunk=4)
        loss, grads = jax.value_and_grad(loss_fn)(p)
        p, s = optim.update(grads, p, s, jnp.float32(0.1))
        return loss, p, s

    p = jax.tree_util.tree_map(
        lambda v, s: jax.device_put(v, NamedSharding(mesh, s)), params,
        specs)
    s = optim.init_state(p)
    step_j = jax.jit(step)
    xb = jax.device_put(jnp.asarray(x, jnp.int32),
                        NamedSharding(mesh, P("data")))
    yb = jax.device_put(jnp.asarray(y, jnp.int32),
                        NamedSharding(mesh, P("data")))
    flat_specs = out[0]["specs"]
    # both axes are used, inside the blocks too, and some leaf over both
    assert flat_specs["block0/ln1/weight"] == ("data",)
    assert any("data" in s and "model" in s for s in flat_specs.values())
    assert any(s == ("data",) and k.startswith("block")
               for k, s in flat_specs.items())
    for i in range(STEPS):
        loss, p, s = step_j(p, s, xb, yb)
        want = _np_tree(p)
        for o in out:
            np.testing.assert_allclose(o["losses"][i], float(loss),
                                       rtol=2e-5, atol=2e-5)
            d, m = o["coords"]
            for k, v in o["params"][i].items():
                whole = want[k]
                block = whole
                for dim, ax in enumerate(flat_specs[k]):
                    if ax is None:
                        continue
                    r = d if ax == "data" else m
                    size = v.shape[dim]
                    block = np.take(block, range(r * size, (r + 1) * size),
                                    axis=dim)
                np.testing.assert_allclose(v, block, rtol=2e-5, atol=2e-5,
                                           err_msg=k)


def _np_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_np_tree(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


# -- dropout under tensor parallelism (C.10) ------------------------------------

def test_tp_dropout_draws_are_the_whole_layers_block_mask_for_mask():
    cfg = dict(TRAIN, dropout=0.3)
    _, w = _wide(TRAIN, seed=3)
    x = np.random.RandomState(2).randint(1, 64, (2, 8)).astype(np.int64)
    out = dh.run_world(dh.tp_dropout, 2, cfg, w, x, 7, timeout_s=90)
    for r, o in enumerate(out):
        solo_draws, solo_h, solo_g = o["solo"]
        tp_draws, tp_h, tp_g = o["tp"]
        assert len(tp_draws) == len(solo_draws) == 2 * TRAIN["num_layers"]
        for s, t in zip(solo_draws, tp_draws):
            dim = 1 if s.ndim == 4 else s.ndim - 1   # heads / filter cols
            k = t.shape[dim]
            assert k * 2 == s.shape[dim]
            np.testing.assert_array_equal(
                t, np.take(s, range(r * k, (r + 1) * k), axis=dim))
        np.testing.assert_allclose(tp_h, solo_h, rtol=1e-5, atol=1e-5)
        # this rank's columns of wq and w1 (column-split)
        for g_tp, g_solo in zip(tp_g, solo_g):
            k = g_tp.shape[1]
            np.testing.assert_allclose(g_tp, g_solo[:, r * k:(r + 1) * k],
                                       rtol=1e-4, atol=1e-4)


# -- the engine over FSDP ---------------------------------------------------------

def test_engine_over_fsdp_gathers_block_by_block_and_matches_jax():
    cfg = dict(TRAIN)
    jm, w = _wide(cfg, seed=4)
    xs = np.random.RandomState(6).randint(1, 64, (3, 10)).astype(np.int64)
    out = dh.run_world(dh.mesh_engine_lm, 2, cfg, w, 4, xs, timeout_s=90)
    jwant = np.asarray(jm.apply(jm.params, {}, jnp.asarray(xs, jnp.int32),
                                training=False)[0])
    o = out[0]
    for i, got in enumerate(o["outs"]):
        np.testing.assert_allclose(got, o["direct"][i], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got, jwant[i], rtol=1e-4, atol=1e-4)
    for o in out:
        assert o["whole_tree"] == 0
        assert o["resident"] < o["whole"]
        # each block gathered its slices, never more than one block's
        assert o["per_block"] and max(o["per_block"]) > 0
        assert max(o["per_block"]) <= o["block_bytes"]
        assert max(o["gathers"]) <= o["block_bytes"]
