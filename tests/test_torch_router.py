"""The port's Router against the JAX package's: DecodeScheduler replicas
``r0`` / ``r1`` on a small LM (JAX's weights carried over by
``convert``) and ServingEngine replicas on a small MLP.

The drill runs one request at a time, so the routing decisions (round
robin, prefix affinity, the replica a tagged chaos rule kills, the
dispatch retry) do not depend on timing, and compares ``submitted``,
``completed``, ``rejected``, ``failovers``, ``dispatch_retries``,
``affinity_hits``, ``kv_recoveries``, ``drains`` and ``doomed`` between
the packages, and the replicas' ``swaps``. ``dispatches`` is left out: a
dispatch raced by a replica's death is retried on the next one, and
whether that race happens depends on timing. Tokens are held against JAX
up to the first near-tie (top-2 margin under 1e-3 on the port's own full
forward). Health-driven drain and rejoin are driven by the port's own
``health/stall`` events; the watchdog that raises them is tested in
``test_torch_fault_replay.py``.
"""
import numpy as np
import pytest
import torch

import jax

from bigdl_tpu import nn as jnn
from bigdl_tpu.models.transformer_lm import TransformerLM as JaxLM
from bigdl_tpu.observability import health as jhealth
from bigdl_tpu.parallel import chaos as jchaos
from bigdl_tpu.serving import DecodeScheduler as JaxScheduler
from bigdl_tpu.serving import Router as JaxRouter
from bigdl_tpu_torch import convert, nn
from bigdl_tpu_torch import observability as obs
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.observability import health
from bigdl_tpu_torch.parallel import chaos
from bigdl_tpu_torch.serving import (DeadlineExceeded, DecodeScheduler,
                                     EngineStopped,
                                     PriorityClass, Router, ServingEngine,
                                     decode_scheduler_threads_alive,
                                     router_threads_alive,
                                     serving_threads_alive)

torch.set_num_threads(1)
V, MAXLEN = 48, 128
MARGIN = 1e-3
CFG = dict(vocab_size=V, hidden_size=32, num_heads=4, filter_size=64,
           num_layers=2, max_len=MAXLEN, num_kv_heads=2, pos_encoding="rope")
SCHED = dict(max_slots=4, block_size=4, max_seq_len=96, prefill_chunk=8)
KEYS = ("submitted", "completed", "rejected", "failovers",
        "dispatch_retries", "affinity_hits", "kv_recoveries", "drains",
        "doomed")

_shared = {}


def _reset_both():
    chaos.disarm()
    jchaos.disarm()
    health.reset()
    jhealth.reset()
    obs.registry().reset()
    obs.disable()


@pytest.fixture(autouse=True)
def _clean():
    _reset_both()
    yield
    _reset_both()


def _pair():
    if "lm" not in _shared:
        jm = JaxLM(**CFG)
        jp, _ = jm.init(jax.random.PRNGKey(0))
        jm.params, jm.state = jp, {}
        tm = TransformerLM(device="cpu", **CFG)
        tm.load_state_dict(convert.jax_to_state_dict(
            jax.tree_util.tree_map(np.asarray, jp)))
        _shared["lm"] = (jm, tm)
    return _shared["lm"]


def _assert_agree(tm, prompt, got, want):
    ids = np.concatenate([prompt, got])[None]
    with torch.no_grad():
        lg = tm.call(tm.params, torch.as_tensor(ids[:, :-1]))
    top = lg[0, prompt.size - 1:].topk(2, dim=-1).values
    low = np.nonzero((top[:, 0] - top[:, 1]).numpy() < MARGIN)[0]
    k = len(got) if low.size == 0 else int(low[0]) + 1
    np.testing.assert_array_equal(np.asarray(got)[:k], np.asarray(want)[:k])


def _drill(pkg):
    """A (system prompt) -> r1 by round robin; B (the same system prompt)
    -> r1 by prefix affinity; a fleet swap; C with a permanent fault at
    r1's next decode step -> r1 dies, C fails over to r0 with the token
    r1 generated; D with a transient fault at its dispatch -> retried."""
    port = pkg == "port"
    jm, tm = _pair()
    ch, Sched, Rt = ((chaos, DecodeScheduler, Router) if port else
                     (jchaos, JaxScheduler, JaxRouter))
    rng = np.random.RandomState(51)
    system = rng.randint(1, V, 16).astype(np.int32)
    prompts = [np.concatenate([system, rng.randint(1, V, n).astype(np.int32)])
               for n in (2, 3)] + [rng.randint(1, V, n).astype(np.int32)
                                   for n in (9, 6)]
    reps = [Sched(tm if port else jm, name=f"r{i}", **SCHED).start(
        warmup=False) for i in range(2)]
    router = Rt(reps).start()
    out = []
    try:
        for i, p in enumerate(prompts):
            if i == 2:
                router.swap(tm.params if port else jm.params, version="v1")
                ch.arm({"sites": {"serving/scheduler_step": [
                    {"kind": "permanent", "nth": 1, "tag": "r1"}]}})
            if i == 3:
                ch.arm({"sites": {"router/dispatch": [
                    {"kind": "transient", "nth": 1}]}})
            f = router.submit(p, max_new_tokens=7)
            out.append(np.asarray(f.result(120)))
            assert f.version == ("v0" if i < 2 else "v1")
        st = router.stats()
        swaps = [r.stats()["swaps"] for r in reps]
        healthy = router.healthy_replicas()
    finally:
        router.shutdown()
        ch.disarm()
    return prompts, out, {k: st[k] for k in KEYS}, swaps, healthy


def test_router_drill_matches_jax():
    prompts, got, st, swaps, healthy = _drill("port")
    _, want, jst, jswaps, jhealthy = _drill("jax")
    assert st == jst
    assert (st["affinity_hits"], st["failovers"], st["kv_recoveries"],
            st["dispatch_retries"], st["completed"]) == (1, 1, 1, 1, 4)
    assert swaps == jswaps == [1, 1]
    assert healthy == jhealthy
    _, tm = _pair()
    for p, g, w in zip(prompts, got, want):
        assert g.size == 7
        _assert_agree(tm, p, g, w)
    assert decode_scheduler_threads_alive() == 0
    assert router_threads_alive() == 0


def test_stall_event_drains_and_recovery_rejoins():
    obs.enable()
    _, tm = _pair()
    reps = [DecodeScheduler(tm, name=f"r{i}", **SCHED).start(warmup=False)
            for i in range(2)]
    p = np.arange(1, 9, dtype=np.int32)
    with Router(reps) as router:
        health.emit("stall", component=reps[1].beacon_name, silent_s=2.0)
        assert router.healthy_replicas() == ["r0"]
        outs = [router.submit(p, max_new_tokens=4) for _ in range(3)]
        for f in outs:
            assert f.result(120).size == 4
        assert reps[1].stats()["submitted"] == 0
        health.emit("stall_recovered", component=reps[1].beacon_name)
        assert router.healthy_replicas() == ["r0", "r1"]
        st = router.stats()
    assert (st["drains"], st["rejoins"], st["completed"]) == (1, 1, 3)


def _mlp():
    jm = jnn.Sequential().add(jnn.Linear(4, 8)).add(jnn.ReLU()).add(
        jnn.Linear(8, 3))
    jp, js = jm.init(jax.random.PRNGKey(1))
    tm = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 3))
    tm.load_state_dict(convert.jax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jp), js))
    return tm


def test_engine_fleet_classes_swap_and_membership():
    """Two priority classes over ServingEngine replicas: every response
    names v0 or v1 and equals that version's forward; ``add_replica`` /
    ``remove_replica`` change a running fleet; a deadline already spent
    is doomed at admission."""
    tm = _mlp()
    kw = dict(input_shape=(4,), max_batch=4, device="cpu")
    engines = [ServingEngine(tm, name=f"e{i}", **kw) for i in range(2)]
    classes = [PriorityClass("tight", weight=4), PriorityClass("bulk")]
    rng = np.random.RandomState(2)
    xs = [rng.randn(4).astype(np.float32) for _ in range(12)]
    v1 = {k: {n: t.detach() * 0.5 for n, t in sub.items()}
          for k, sub in tm.params.items()}
    with Router(engines, classes=classes) as router:
        futs = [router.submit(x, klass=("tight", "bulk")[i % 2])
                for i, x in enumerate(xs[:6])]
        router.swap(v1, version="v1")
        futs += [router.submit(x, klass="bulk") for x in xs[6:10]]
        for f in futs:
            f.result(60)
        # a replica added after the swap serves its own v0
        name = router.add_replica(ServingEngine(tm, name="e2", **kw))
        assert name == "e2" and "e2" in router.healthy_replicas()
        router.remove_replica("e0").shutdown()       # the caller's to stop
        assert router.healthy_replicas() == ["e1", "e2"]
        futs += [router.submit(x, klass="tight") for x in xs[10:]]
        for ms in (0.0, -1.0):
            with pytest.raises(DeadlineExceeded, match="doomed"):
                router.submit(xs[0], klass="tight", deadline_ms=ms)
        res = [(f.result(60), f.version) for f in futs]
        st = router.stats()
    with torch.no_grad():
        for x, (y, ver) in zip(xs, res):
            params = tm.params if ver == "v0" else v1
            want = tm.apply(params, tm.state, torch.from_numpy(x[None]))[0]
            np.testing.assert_allclose(y, want[0].numpy(), atol=1e-6)
    assert {v for _, v in res[6:10]} == {"v1"}
    assert st["joins"] == 1 and st["retires"] == 1 and st["doomed"] == 2
    assert serving_threads_alive() == 0
    with pytest.raises(EngineStopped):
        router.submit(xs[0], klass="bulk")
