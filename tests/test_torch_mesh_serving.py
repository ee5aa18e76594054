"""Mesh serving in the port: ``DecodeScheduler(mesh=, placement=)`` and
``ServingEngine(mesh=, placement=)`` on gloo worlds of 2, 3 and 4 ranks,
held against JAX's mesh serving on the virtual CPU devices
(``tests/test_serving_mesh.py``'s drills) and against one rank.

Tokens: the port's tensor-parallel and FSDP schedulers (rank 0 serves,
the other ranks replay its steps in lockstep) against the port's
one-rank scheduler and against JAX's TP / FSDP scheduler, up to the first
step whose top-2 logit margin on the port's solo decode is under 1e-3
(the weights are 0.3 * N(0, 1), so margins are wide). Pages: every
rank's pool after the drill against the one-rank pool's matching kv
heads at 1e-5. The prefix warm hit and the hot swap mid-traffic run on
the mesh too. The engine's outputs are held against the model's direct
apply at rtol 1e-5 / atol 1e-6 (JAX's own bound).
"""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from bigdl_tpu.models import LeNet5 as JaxLeNet
from bigdl_tpu.models.transformer_lm import TransformerLM as JaxLM
from bigdl_tpu.parallel import sharding as jsh
from bigdl_tpu.serving import DecodeScheduler as JaxScheduler
from bigdl_tpu.serving import ServingEngine as JaxEngine

import torch_dist_helpers as dh

torch.set_num_threads(1)
CFG = dict(vocab_size=64, hidden_size=32, num_heads=4, filter_size=64,
           num_layers=2, max_len=128, num_kv_heads=2)
SCHED = dict(max_slots=4, block_size=4, max_seq_len=64, prefill_chunk=8)
MARGIN, PAGE_TOL = 1e-3, 1e-5
_rng = np.random.RandomState(1)
PROMPTS = [_rng.randint(1, 64, size=k).astype(np.int32) for k in (5, 11, 3)]
_prefix = _rng.randint(1, 64, size=16).astype(np.int32)
PREFIX = [np.concatenate([_prefix, _rng.randint(1, 64, size=k)
                          .astype(np.int32)]) for k in (5, 3)]
SWAP = [_rng.randint(1, 64, size=6).astype(np.int32) for _ in range(3)]
_cache = {}


def _weights():
    """JAX's LM with every leaf redrawn as 0.3 * N(0, 1) (wide margins):
    (the JAX model, the numpy tree both packages load)."""
    if "w" not in _cache:
        jm = JaxLM(**CFG)
        jp, _ = jm.init(jax.random.PRNGKey(0))
        r = np.random.RandomState(0)
        w = jax.tree_util.tree_map(
            lambda a: (0.3 * r.randn(*np.shape(a))).astype(np.float32), jp)
        jm.params, jm.state = jax.tree_util.tree_map(jax.numpy.asarray,
                                                     w), {}
        _cache["w"] = (jm, w)
    return _cache["w"]


def _jax_mesh(shape, axes):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)


def _jax_serve(shape, axes, placement, prompts):
    jm, _ = _weights()
    kw = dict(SCHED)
    if shape is not None:
        kw.update(mesh=_jax_mesh(shape, axes), placement=placement)
    sched = JaxScheduler(jm, **kw)
    with sched:
        futs = [sched.submit(p, 8) for p in prompts]
        return [np.asarray(f.result(timeout=60)) for f in futs]


def _margins(prompt, n=8):
    """Top-2 margins of the port's dense solo greedy decode."""
    from bigdl_tpu_torch.nn.module import copy_tree_into
    from bigdl_tpu_torch.models import TransformerLM
    if "tm" not in _cache:
        tm = TransformerLM(device="cpu", **CFG)
        copy_tree_into(tm.params, _weights()[1])
        _cache["tm"] = tm
    tm = _cache["tm"]
    logits, caches = tm.prefill(tm.params, torch.from_numpy(prompt)[None],
                                CFG["max_len"])
    out, pos = [], prompt.size
    for i in range(n):
        top = logits[0].topk(2).values
        out.append(float(top[0] - top[1]))
        if i < n - 1:
            logits, caches = tm.decode_one(tm.params, [int(logits[0].argmax())],
                                           pos, caches)
            pos += 1
    return np.array(out)


def _agree(got, want, prompt):
    m = _margins(prompt, len(want))
    low = np.nonzero(m < MARGIN)[0]
    k = len(m) if low.size == 0 else int(low[0]) + 1
    np.testing.assert_array_equal(np.asarray(got)[:k], np.asarray(want)[:k])


WORLDS = {"tp2": (2, (2,), ("model",), "tp"),
          "tp4": (4, (4,), ("model",), "tp"),
          "fsdp4": (4, (4,), ("data",), "fsdp256")}


def _world(key):
    if key not in _cache:
        n, shape, axes, placement = WORLDS[key]
        _cache[key] = dh.run_world(dh.mesh_serving, n, CFG, _weights()[1],
                                   shape, axes, placement, SCHED, PROMPTS, 8,
                                   PREFIX, SWAP, timeout_s=120)
    return _cache[key]


@pytest.mark.parametrize("key", list(WORLDS))
def test_mesh_scheduler_tokens_equal_one_rank_and_jax(key):
    out = _world(key)
    n, shape, axes, placement = WORLDS[key]
    jplace = ("fsdp" if placement == "fsdp256" else placement)
    want = _jax_serve(shape, axes, jplace, PROMPTS)
    for p, got, solo, w in zip(PROMPTS, out[0]["tokens"], out[0]["solo"],
                               want):
        np.testing.assert_array_equal(got, solo)
        _agree(got, w, p)


@pytest.mark.parametrize("key", list(WORLDS))
def test_mesh_scheduler_pages_equal_one_rank_heads(key):
    out = _world(key)
    n = WORLDS[key][0]
    for r, o in enumerate(out):
        for (k, v), (sk, sv) in zip(o["pool"], o["solo_pool"]):
            h = k.shape[1]
            lo = r * h if h < sk.shape[1] else 0
            np.testing.assert_allclose(k, sk[:, lo:lo + h], atol=PAGE_TOL)
            np.testing.assert_allclose(v, sv[:, lo:lo + h], atol=PAGE_TOL)
    kvh, heads = CFG["num_kv_heads"], CFG["num_heads"]
    split = WORLDS[key][3] == "tp" and kvh % n == 0 and heads % n == 0
    assert out[0]["page"][1] == (kvh // n if split else kvh)


@pytest.mark.parametrize("key", list(WORLDS))
def test_mesh_scheduler_placement_matches_jax(key):
    """Each rank stores its block: the TP column shard of wq as JAX's
    addressable shard, FSDP slices at 1/n of the sliced leaves."""
    out = _world(key)
    n, shape, axes, placement = WORLDS[key]
    jm, _ = _weights()
    mesh = _jax_mesh(shape, axes)
    specs = (jsh.fsdp_specs(jm.params, mesh, min_elems=256)
             if placement == "fsdp256"
             else jsh.serving_param_specs(jm.params, mesh, placement))
    placed = jsh.place_with_specs(jm.params, mesh, specs)
    want = placed["block0"]["attn"]["wq"].addressable_shards[0].data.shape
    for o in out:
        assert o["wq"] == tuple(want)
    resident = sum(l.addressable_shards[0].data.size
                   for l in jax.tree_util.tree_leaves(placed))
    assert out[0]["resident"] == resident


@pytest.mark.parametrize("key", list(WORLDS))
def test_mesh_prefix_warm_hit_equals_cold(key):
    out = _world(key)[0]
    assert out["prefix_stats"] == {"prefix_hits": 1,
                                   "prefix_reused_tokens": 16}
    if "cold" not in _cache:
        _cache["cold"] = _jax_serve(None, None, None, PREFIX)
    cold = _cache["cold"]
    for p, got, w in zip(PREFIX, out["prefix"], cold):
        _agree(got, w, p)


@pytest.mark.parametrize("key", list(WORLDS))
def test_mesh_hot_swap_mid_traffic_version_pinned(key):
    out = _world(key)
    pre, post, v1 = out[0]["swap_versions"]
    assert pre == ["v0"] * 3 and post == v1 == "v1"
    assert all(o["swap_wq"] == o["wq"] for o in out)
    assert len(out[0]["swap_pre"]) == 3 and out[0]["swap_post"].size == 8


def test_mesh_draft_model_rejected():
    """JAX's refusal, kept: speculative decoding is single-device."""
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.serving import DecodeScheduler
    small = dict(CFG, num_layers=1)
    lm = TransformerLM(device="cpu", **CFG)
    draft = TransformerLM(device="cpu", **small)
    mesh = make_mesh((1,), ("model",), device="cpu")
    with pytest.raises(ValueError, match="single-device"):
        DecodeScheduler(lm, mesh=mesh, draft_model=draft, **SCHED)


# -- the engine --------------------------------------------------------------

ENGINES = {"replica_data4": (4, (2, 2), ("replica", "data"), 16),
           "data3": (3, (3,), ("data",), 12)}


def _lenet():
    if "lenet" not in _cache:
        jm = JaxLeNet()
        jm.ensure_initialized()
        from bigdl_tpu_torch import convert
        from bigdl_tpu_torch.models import LeNet5
        tm = LeNet5(10, device="cpu")
        tm.load_state_dict(convert.jax_to_state_dict(
            jax.tree_util.tree_map(np.asarray, jm.params)))
        _cache["lenet"] = (jm, tm)
    return _cache["lenet"]


def _engine_world(key):
    k = "eng_" + key
    if k not in _cache:
        n, shape, axes, mb = ENGINES[key]
        jm, tm = _lenet()
        xs = np.random.RandomState(4).randn(5, 784).astype(np.float32)
        _cache[k] = (xs, dh.run_world(dh.mesh_engine, n, dh.host(tm.params),
                                      shape, axes, "fsdp", mb, xs,
                                      timeout_s=90))
    return _cache[k]


@pytest.mark.parametrize("key", list(ENGINES))
def test_mesh_engine_buckets_equal_jax(key):
    xs, out = _engine_world(key)
    n, shape, axes, mb = ENGINES[key]
    jm, _ = _lenet()
    eng = JaxEngine(jm, input_shape=(784,), max_batch=mb,
                    mesh=_jax_mesh(shape, axes), placement="fsdp",
                    warmup=False)
    o = out[0]
    assert o["floor"] == eng._bucket_floor
    assert o["buckets"] == eng._buckets()
    assert o["bucket_for"] == [eng._bucket_for(i) for i in range(1, mb + 1)]
    jspec = jsh.serving_batch_spec(_jax_mesh(shape, axes))
    assert o["spec"] == tuple(jspec)
    assert o["count"] == jsh.batch_shard_count(_jax_mesh(shape, axes), jspec)


@pytest.mark.parametrize("key", list(ENGINES))
def test_mesh_engine_rows_equal_direct_apply(key):
    xs, out = _engine_world(key)
    jm, tm = _lenet()
    with torch.no_grad():
        want = tm.apply(tm.params, tm.state, torch.from_numpy(xs),
                        False)[0].numpy()
    from bigdl_tpu.optim.predictor import shared_forward
    jwant = np.asarray(shared_forward(jm)(jm.params, jm.state, xs))
    for i, o in enumerate(out[0]["outs"]):
        np.testing.assert_allclose(o, want[i], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(o, jwant[i], rtol=1e-5, atol=1e-5)
    # FSDP: the largest leaf is stored in data-axis slices on every rank
    n_data = dict(zip(ENGINES[key][2], ENGINES[key][1]))["data"]
    name, shape = out[0]["big"]
    whole = dh._flat(tm.params)[name].shape
    assert int(np.prod(shape)) * n_data == int(np.prod(whole))


@pytest.mark.parametrize("key", list(ENGINES))
def test_mesh_engine_rejects_indivisible_max_batch(key):
    """JAX's refusal: max_batch must be a multiple of the shard count."""
    _, out = _engine_world(key)
    assert "multiple of the batch shard count" in out[0]["indivisible"]


def test_mesh_engine_registry_with_placement_refused():
    """JAX's refusal, kept: placement= with an explicit registry."""
    from bigdl_tpu_torch.models import LeNet5
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.serving import ModelRegistry, ServingEngine
    mesh = make_mesh((1, 1), ("replica", "data"), device="cpu")
    with pytest.raises(ValueError, match="explicit registry"):
        ServingEngine(LeNet5(10, device="cpu"), input_shape=(784,),
                      max_batch=4, mesh=mesh, placement="fsdp",
                      registry=ModelRegistry(mesh=mesh))
