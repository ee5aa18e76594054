"""The port's serving tier: the paged KV ledger and the continuous-batching
DecodeScheduler, held against the JAX package's DecodeScheduler (built
with ``prefix_cache=False`` here; the prefix cache, speculative decoding
and the host tier have their own files), plus the package's import and
device hygiene.

Greedy tokens are compared only up to (and including) the first step
whose top-2 logit margin, measured on the port's own solo decode, is under
1e-3: the two frameworks agree on logits to about 1e-6 in float32 here,
so a step above that margin must pick the same token on both sides.
"""
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax

from bigdl_tpu.models.transformer_lm import TransformerLM as JaxLM
from bigdl_tpu.serving import DecodeScheduler as JaxScheduler
from bigdl_tpu_torch import convert, kernels
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.serving import (DeadlineExceeded, DecodeScheduler,
                                     KVCacheOOM, PagedKVCache, QueueFull,
                                     blocks_for_tokens,
                                     decode_scheduler_threads_alive,
                                     prefill_padded_end, prefill_schedule)

torch.set_num_threads(1)
V, H, MAXLEN, CHUNK = 48, 32, 128, 8
MARGIN = 1e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=V, hidden_size=H, num_heads=4, filter_size=64,
           num_layers=2, max_len=MAXLEN, num_kv_heads=2, pos_encoding="rope")
SCHED = dict(max_slots=4, block_size=4, max_seq_len=96, prefill_chunk=CHUNK)

_shared = {}


def _models():
    """(JAX model with params, port model with the same weights)."""
    if "pair" not in _shared:
        jm = JaxLM(**CFG)
        jp, _ = jm.init(jax.random.PRNGKey(0))
        jm.params, jm.state = jp, {}
        tm = TransformerLM(device="cpu", **CFG)
        tm.load_state_dict(convert.jax_to_state_dict(
            jax.tree_util.tree_map(np.asarray, jp)))
        _shared["pair"] = (jm, tm)
    return _shared["pair"]


def _prompts(n, seed=0, lo=3, hi=21):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, V, rng.randint(lo, hi)).astype(np.int32)
            for _ in range(n)]


def _solo(tm, prompt, n):
    """The port's dense solo greedy decode: (tokens, top-2 margins)."""
    params = tm.params
    logits, caches = tm.prefill(params, prompt[None], MAXLEN)
    toks, margins = [], []
    pos = prompt.size
    for i in range(n):
        top = logits[0].topk(2).values
        margins.append(float(top[0] - top[1]))
        toks.append(int(logits[0].argmax()))
        if i < n - 1:
            logits, caches = tm.decode_one(params, [toks[-1]], pos, caches)
            pos += 1
    return np.array(toks, np.int32), np.array(margins)


def _assert_agree(got, want, margins):
    low = np.nonzero(margins < MARGIN)[0]
    k = len(margins) if low.size == 0 else int(low[0]) + 1
    np.testing.assert_array_equal(np.asarray(got)[:k], np.asarray(want)[:k])
    return k


# -- the KV ledger ------------------------------------------------------------

def test_kv_ledger_alloc_oom_truncate_free_audit():
    _, tm = _models()
    kv = PagedKVCache(tm, num_blocks=9, block_size=4, max_blocks_per_seq=5)
    assert kv.pages()[0][0].shape == (9, 2, 4, H // 4)
    assert blocks_for_tokens(9, 4) == 3
    kv.ensure_capacity("a", 9)                     # 3 blocks
    kv.ensure_capacity("b", 17)                    # 5 blocks
    assert kv.blocks_free() == 0 and kv.owned("a") == 3
    before = (kv.stats(), kv.block_table("a").tolist())
    with pytest.raises(KVCacheOOM):
        kv.ensure_capacity("c", 4)
    with pytest.raises(KVCacheOOM):
        kv.ensure_capacity("a", 13)                # growth needs 1 more
    assert (kv.stats(), kv.block_table("a").tolist()) == before
    assert kv.owned("c") == 0
    with pytest.raises(ValueError):
        kv.ensure_capacity("a", 21)                # past the table width
    table = kv.block_table("b")
    assert table.dtype == np.int32 and (table > 0).all()
    assert kv.truncate("b", 6) == 3 and kv.owned("b") == 2
    assert kv.block_table("b")[2:].tolist() == [0, 0, 0]
    assert kv.null_table().tolist() == [0] * 5
    pin = kv.owner_blocks("a")[0]
    kv.retain([pin])
    assert kv.audit(prefix_pins={pin: 1})["ok"]
    assert not kv.audit(prefix_pins={})["ok"]     # the pin is unaccounted
    assert kv.free("a") == 3 and kv.free("a") == 0
    assert kv.block_refs(pin) == 1                # the pin outlives "a"
    assert kv.release([pin]) == 1
    with pytest.raises(ValueError):
        kv.release([pin])                          # double free refused
    kv.free("b")
    rep = kv.audit(prefix_pins={})
    assert rep["ok"], rep["violations"]
    assert kv.stats()["blocks_in_use"] == 0 and kv.stats()["high_water"] == 8


def test_prefill_schedule_matches_jax():
    from bigdl_tpu.serving import decode_scheduler as jds
    for n in (1, 3, 8, 9, 17, 40):
        assert prefill_schedule(n, 8) == jds.prefill_schedule(n, 8)
        assert prefill_padded_end(n, 8) == jds.prefill_padded_end(n, 8)


# -- the scheduler against JAX's ----------------------------------------------

def test_scheduler_greedy_tokens_match_jax_scheduler():
    jm, tm = _models()
    prompts = _prompts(5, seed=1)
    budgets = [6, 9, 4, 7, 5]
    js = JaxScheduler(jm, prefix_cache=False, **SCHED).start(warmup=False)
    try:
        jfut = [js.submit(p, n) for p, n in zip(prompts, budgets)]
        want = [f.result(120) for f in jfut]
    finally:
        js.shutdown()
    with DecodeScheduler(tm, **SCHED) as ts:
        got = [f.result(60) for f in [ts.submit(p, n) for p, n in
                                      zip(prompts, budgets)]]
    checked = 0
    for p, n, g, w in zip(prompts, budgets, got, want):
        assert g.dtype == np.int32 and g.size == n
        solo, margins = _solo(tm, p, n)
        checked += _assert_agree(g, solo, margins)
        _assert_agree(g, w, margins)
    assert checked >= 15, "fixtures too close to ties to say anything"


def test_scheduler_same_tokens_alone_or_mid_batch():
    _, tm = _models()
    prompts = _prompts(6, seed=2, hi=30)
    with DecodeScheduler(tm, **SCHED) as ts:
        alone = [ts.generate(p, 8, timeout=60) for p in prompts[:3]]
        futs = [ts.submit(p, 8) for p in prompts]
        batched = [f.result(60) for f in futs]
        st = ts.stats()
    # the prefix cache (JAX's default) pins registered blocks until
    # shutdown; every block is back once the scheduler is down
    assert st["completed"] == 9 and ts.stats()["kv"]["blocks_in_use"] == 0
    for p, a, b in zip(prompts, alone, batched):
        _, margins = _solo(tm, p, 8)
        _assert_agree(a, b, margins)
    assert decode_scheduler_threads_alive() == 0


def test_eos_budget_and_static_admission():
    _, tm = _models()
    p = _prompts(1, seed=3)[0]
    solo, _ = _solo(tm, p, 10)
    eos = int(solo[3])
    cut = list(solo).index(eos)
    prompts = _prompts(5, seed=4)
    with DecodeScheduler(tm, admission="static", **SCHED) as ts:
        out = ts.generate(p, 10, eos_id=eos, timeout=60)
        assert out.tolist() == solo[:cut + 1].tolist()
        full = ts.generate(p, 10, timeout=60)
        assert full.size == 10
        res = [f.result(60) for f in [ts.submit(q, 5) for q in prompts]]
        # only the prefix cache's pins outlive the requests
        assert ts.stats()["kv"]["blocks_in_use"] == len(
            ts.prefix.pinned_blocks())
    assert ts.stats()["kv"]["blocks_in_use"] == 0
    with DecodeScheduler(tm, **SCHED) as ts:
        cont = [f.result(60) for f in [ts.submit(q, 5) for q in prompts]]
    for q, a, b in zip(prompts, res, cont):
        _, margins = _solo(tm, q, 5)
        _assert_agree(a, b, margins)


def test_deadline_expiry_returns_partial_prefix():
    _, tm = _models()
    p = _prompts(1, seed=5)[0]
    solo, margins = _solo(tm, p, 60)
    ts = DecodeScheduler(tm, **SCHED).start()
    gate = threading.Event()
    orig = ts._step_group

    def slow_step(rows):           # >= 10 ms per decode step
        time.sleep(0.01)
        gate.set()
        return orig(rows)

    ts._step_group = slow_step
    try:
        fut = ts.submit(p, 60, deadline_ms=250.0)
        with pytest.raises(DeadlineExceeded) as ei:
            fut.result(60)
    finally:
        ts.shutdown()
    partial = ei.value.partial
    assert gate.is_set() and 0 < partial.size < 60
    _assert_agree(partial, solo[:partial.size], margins[:partial.size])
    assert ts.stats()["kv"]["blocks_in_use"] == 0
    assert ts.stats()["timeouts"] == 1


def test_sampling_seeded_and_batch_mix_independent():
    _, tm = _models()
    prompts = _prompts(4, seed=6)
    kw = dict(temperature=0.9, top_p=0.9, seed=1234)
    with DecodeScheduler(tm, **SCHED) as ts:
        alone = ts.generate(prompts[0], 8, timeout=60, **kw)
        futs = [ts.submit(prompts[0], 8, **kw)] + \
            [ts.submit(q, 8) for q in prompts[1:]]
        mixed = futs[0].result(60)
        greedy = ts.generate(prompts[1], 8, timeout=60)
        nucleus = ts.generate(prompts[1], 8, timeout=60, temperature=1.0,
                              top_p=1e-6, seed=9)
        other = ts.generate(prompts[0], 8, timeout=60, temperature=0.9,
                            top_p=0.9, seed=4321)
    np.testing.assert_array_equal(alone, mixed)
    np.testing.assert_array_equal(greedy, nucleus)
    assert not np.array_equal(alone, other)


def test_rejections_swap_and_shutdown_without_drain():
    _, tm = _models()
    ts = DecodeScheduler(tm, max_queue=2, **SCHED)
    with pytest.raises(ValueError):
        ts.submit(np.arange(1, 90), 20)             # over max_seq_len
    with pytest.raises(ValueError):
        ts.submit([1, 2], 0)
    with pytest.raises(RuntimeError):
        ts.generate([1, 2], 3)                      # not started
    ts.submit([1, 2], 3)
    ts.submit([1, 2], 3)
    with pytest.raises(QueueFull):
        ts.submit([1, 2], 3)
    ts.start(warmup=False)
    assert ts.drain(60)
    v1 = ts.swap({k: v for k, v in tm.params.items()})
    fut = ts.submit([3, 4, 5], 4)
    assert fut.result(60).size == 4 and fut.version == v1
    f2 = ts.submit(np.arange(1, 40), 50)
    ts.shutdown(drain=False)
    assert f2.done() and ts.stats()["kv"]["blocks_in_use"] == 0
    assert ts.audit()["ok"]


# -- the serving API keeps JAX's state (ROADMAP C.2) --------------------------

def test_registry_publish_reads_positional_state_and_version_like_jax():
    """JAX's positional ``publish(p, None, "v1")`` names the version "v1"
    in both packages; a state tree travels with its version; ``transform``
    runs once, before placement."""
    from bigdl_tpu.serving.registry import ModelRegistry as JaxRegistry
    from bigdl_tpu_torch.serving import ModelRegistry
    p = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    jr, tr = JaxRegistry(), ModelRegistry(device="cpu")
    assert jr.publish(p, None, "v1") == tr.publish(
        {"w": torch.from_numpy(p["w"])}, None, "v1") == "v1"
    assert tr.current().state is None and jr.current().state is None
    calls = []
    state = {"running_mean": torch.ones(3)}
    v = tr.publish({"w": torch.zeros(2, 3)}, state, "v2", True,
                   lambda t: calls.append(1) or {"w": t["w"] + 1})
    assert v == "v2" and tr.active_version == "v2" and calls == [1]
    cur = tr.current()
    assert torch.equal(cur.params["w"], torch.ones(2, 3))
    assert torch.equal(cur.state["running_mean"], torch.ones(3))


def test_model_version_carries_params_and_state():
    from bigdl_tpu.serving.registry import ModelVersion as JaxVersion
    from bigdl_tpu_torch.serving import ModelVersion
    for cls in (JaxVersion, ModelVersion):
        mv = cls("v3", {"w": 1}, {"s": 2})
        assert (mv.version, mv.params, mv.state) == ("v3", {"w": 1}, {"s": 2})


def test_swap_reads_positional_state_and_version_and_inherits_state():
    _, tm = _models()
    with DecodeScheduler(tm, **SCHED) as ts:
        before = ts.registry.current().state
        assert ts.swap(tm.params, None, "v9") == "v9"
        cur = ts.registry.current()
        assert cur.version == "v9" and cur.state == before
        assert ts.swap(tm.params, {}, "v10") == "v10"
        assert ts.registry.current().state == {}
        fut = ts.submit([3, 4, 5], 3)
        assert fut.result(60).size == 3 and fut.version == "v10"


def test_kv_audit_takes_prefix_pins_like_jax():
    from bigdl_tpu.serving.kv_cache import PagedKVCache as JaxKV
    jm, tm = _models()
    for cls, model in ((JaxKV, jm), (PagedKVCache, tm)):
        kv = cls(model, num_blocks=6, block_size=4, max_blocks_per_seq=3)
        kv.ensure_capacity("a", 5)
        pin = kv.owner_blocks("a")[0]
        kv.retain([pin])
        assert kv.audit(prefix_pins={pin: 1})["ok"]
        assert not kv.audit(prefix_pins={})["ok"]
        assert kv.audit(prefix_pins=None)["ok"]      # pins unknown


# -- hygiene ------------------------------------------------------------------

def test_port_imports_neither_jax_nor_bigdl_tpu():
    # every module of the package, found by walking it, so a new module
    # cannot slip past
    code = ("import pkgutil, importlib, sys, bigdl_tpu_torch\n"
            "names = [m.name for m in pkgutil.walk_packages("
            "bigdl_tpu_torch.__path__, 'bigdl_tpu_torch.')]\n"
            "for n in names:\n"
            "    importlib.import_module(n)\n"
            "assert len(names) > 30, names\n"
            "for want in ('observability', 'observability.health', "
            "'observability.flight', 'observability.cluster', "
            "'parallel.chaos', 'parallel.failure', 'optim.staging', "
            "'serving.engine', 'serving.router', 'utils.table', "
            "'optim.validation', 'optim.evaluator', 'optim.regularizer', "
            "'parallel.elastic', 'native', 'transform', "
            "'transform.vision', 'transform.vision.image', "
            "'transform.image_frame', 'transform._vision_impl', "
            "'dataset.base', 'dataset.imagenet', 'dataset.mnist', "
            "'dataset.cifar', 'dataset.tfrecord', 'parallel.moe', "
            "'nn.moe', 'models.moe_lm', 'utils.directed_graph', "
            "'nn.graph_container', 'nn.dynamic_graph', 'nn.sparse', "
            "'dataset.movielens', 'models.recommender', "
            "'dataset.datamining', 'nn.detection', "
            "'dataset.segmentation', 'parallel.mesh', "
            "'parallel.collective', 'parallel.allreduce', "
            "'parallel.sharding', 'ops', 'ops.ops', 'loaders', "
            "'loaders.wire', 'loaders.bigdl_proto', 'loaders.caffe', "
            "'loaders.caffe_persister', 'loaders.torchfile', "
            "'loaders.tensorflow', 'loaders.tf_saver', "
            "'loaders.tf_session'):\n"
            "    assert 'bigdl_tpu_torch.' + want in names, want\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'bigdl_tpu', 'ml_dtypes', 'tensorflow')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM(vocab_size=V, hidden_size=H, num_heads=4,
                      filter_size=64, num_layers=1)
    kernels.reset_launch_counts()
    _, tm = _models()
    with DecodeScheduler(tm, **SCHED) as ts:
        ts.generate([1, 2, 3], 3, timeout=60)
    counts = kernels.launch_counts()
    assert {"flash_fwd", "flash_bwd", "paged_attention"} <= set(counts)
    assert set(counts.values()) == {0}
