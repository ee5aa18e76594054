"""The port's serving fleet across processes (``serving/fleet.py``, the
counterpart of ``bigdl_tpu/serving/fleet.py``), held against JAX's and
against the port's own in-process scheduler.

Agents run in-process (threads serving real local sockets, as
``tests/test_controller.py`` runs JAX's); one test spawns an agent
subprocess through ``python -m bigdl_tpu_torch.serving.fleet``. Weights
are JAX's initialisation redrawn as 0.3 * N(0, 1) (wide margins), loaded
into both packages. Tokens of a ``RemoteReplica`` behind the port's
``Router`` are bit for bit the port's in-process scheduler's, and equal
JAX's in-process scheduler's up to the first step whose top-2 margin is
under 1e-3. The KV handoff: ``export_blocks`` pages equal JAX's at 1e-5;
a geometry mismatch, corrupt tokens or pages and a version-skewed
handoff are refused typed (``KVHandoffError``) as JAX refuses them, with
nothing adopted; an export is a copy taken under the ledger lock, so a
page write right after the lock is released does not tear it.
"""
import json
import os
import pickle
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.models.transformer_lm import TransformerLM as JaxLM
from bigdl_tpu.serving import DecodeScheduler as JaxScheduler
from bigdl_tpu.serving import (ReplicaAgent as JaxAgent,
                               RemoteReplica as JaxRemote,
                               wait_for_members as jax_wait)
from bigdl_tpu.serving import KVHandoffError as JaxHandoffError
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.nn.module import copy_tree_into
from bigdl_tpu_torch.observability import health as _health
from bigdl_tpu_torch.parallel import chaos
from bigdl_tpu_torch.serving import (DecodeScheduler, DisaggregatedFleet,
                                     EngineStopped, FleetMonitor, KVCacheOOM,
                                     KVHandoffError, RemoteReplica,
                                     ReplicaAgent, Router,
                                     transport_threads_alive,
                                     wait_for_members)
from bigdl_tpu_torch.serving.fleet import (fleet_threads_alive, read_member,
                                           warm_replica)
from bigdl_tpu_torch.serving.kv_cache import SPILL_PENDING

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 48
SCHED = dict(max_slots=4, block_size=4, max_seq_len=96, prefill_chunk=8)
MODEL = dict(vocab_size=V, hidden_size=32, num_heads=4, filter_size=64,
             num_layers=2, max_len=256)
MARGIN, PAGE_TOL = 1e-3, 1e-5
_cache = {}


@pytest.fixture(autouse=True)
def _clean():
    yield
    chaos.disarm()
    _health.reset()


def _weights():
    if "w" not in _cache:
        jm = JaxLM(**MODEL)
        jp, _ = jm.init(jax.random.PRNGKey(0))
        r = np.random.RandomState(0)
        w = jax.tree_util.tree_map(
            lambda a: (0.3 * r.randn(*np.shape(a))).astype(np.float32), jp)
        jm.params = jax.tree_util.tree_map(jnp.asarray, w)
        _cache["w"] = (jm, w)
    return _cache["w"]


def _jax_sched():
    """One JAX in-process scheduler for the module (its compiled steps are
    shared by the tests that read it); shut down at module teardown."""
    if "js" not in _cache:
        _cache["js"] = JaxScheduler(_weights()[0], name="jref",
                                    **SCHED).start(warmup=False)
    return _cache["js"]


@pytest.fixture(scope="module", autouse=True)
def _module_teardown():
    yield
    if "js" in _cache:
        _cache.pop("js").shutdown()


def _model():
    m = TransformerLM(device="cpu", **MODEL)
    copy_tree_into(m.params, _weights()[1])
    return m


def _prompts(rng, sizes):
    return [rng.randint(1, V, size=n).astype(np.int32) for n in sizes]


def _scaled(params, f):
    return {k: _scaled(v, f) if isinstance(v, dict) else v * f
            for k, v in params.items()}


def _perturbed(params):
    """A second version whose tokens differ: the final LayerNorm's gain
    negated."""
    p = {k: dict(v) if isinstance(v, dict) else v for k, v in params.items()}
    p["ln_f"]["weight"] = -p["ln_f"]["weight"]
    return p


def _agents(fd, m, specs, **kw):
    """(agents, handles) for ``specs`` = [(name, role, sched kwargs)]."""
    ags = [ReplicaAgent(DecodeScheduler(m, name=n, **dict(SCHED, **s)),
                        fleet_dir=fd, name=n, role=r, **kw).start()
           for n, r, s in specs]
    docs = wait_for_members(fd, [n for n, _, _ in specs], timeout_s=30)
    return ags, [RemoteReplica(d, fleet_dir=fd) for d in docs]


def _margins(m, prompt, n):
    logits, caches = m.prefill(m.params, torch.from_numpy(prompt)[None],
                               MODEL["max_len"])
    out, pos = [], prompt.size
    for i in range(n):
        top = logits[0].topk(2).values
        out.append(float(top[0] - top[1]))
        if i < n - 1:
            logits, caches = m.decode_one(m.params, [int(logits[0].argmax())],
                                          pos, caches)
            pos += 1
    return np.array(out)


def _agree_jax(m, prompt, got, want):
    mg = _margins(m, prompt, len(want))
    low = np.nonzero(mg < MARGIN)[0]
    k = len(mg) if low.size == 0 else int(low[0]) + 1
    np.testing.assert_array_equal(np.asarray(got)[:k], np.asarray(want)[:k])


# -- the KV handoff -------------------------------------------------------------

def test_export_blocks_equal_jax_and_primitives_refuse_as_jax_does():
    jm, w = _weights()
    m = _model()
    prompt = np.random.RandomState(3).randint(1, V, 35).astype(np.int32)
    js = _jax_sched()
    js.generate(prompt, 2)
    jchain = js.prefix.lookup(prompt[:32], js.registry.current().version)
    jids, jlayers = js.kv.export_blocks(blocks=jchain)
    with DecodeScheduler(m, name="pexp", **SCHED) as ps:
        ps.generate(prompt, 2)
        chain = ps.prefix.lookup(prompt[:32], ps.registry.current().version)
        ids, layers = ps.kv.export_blocks(blocks=chain)
        assert ps.kv.geometry() == js.kv.geometry()
    assert len(ids) == len(jids) == 8 and len(layers) == len(jlayers)
    for (k, v), (jk, jv) in zip(layers, jlayers):
        assert k.dtype == np.float32 and k.shape == jk.shape
        np.testing.assert_allclose(k, jk, atol=PAGE_TOL, rtol=PAGE_TOL)
        np.testing.assert_allclose(v, jv, atol=PAGE_TOL, rtol=PAGE_TOL)
    # adopt, geometry refusal, all-or-nothing OOM, dead blocks
    a = DecodeScheduler(m, name="exp", **SCHED)
    b = DecodeScheduler(m, name="imp", **SCHED)
    a.kv.ensure_capacity("o1", 16)
    ids = a.kv.owner_blocks("o1")
    ids2, layers = a.kv.export_blocks(owner="o1")
    assert ids2 == ids and layers[0][0].shape[0] == len(ids)
    new = b.kv.adopt_serialized("x", layers)
    assert len(new) == len(ids) and b.kv.blocks_in_use() == len(ids)
    b.kv.free("x")
    bad = [(np.zeros((2, layers[0][0].shape[1], SCHED["block_size"], 3),
                     np.float32),) * 2 for _ in range(a.kv.n_layers)]
    with pytest.raises(ValueError, match="geometry"):
        b.kv.adopt_serialized("y", bad)
    big = [(np.zeros((1000,) + layers[0][0].shape[1:], np.float32),) * 2
           for _ in range(a.kv.n_layers)]
    with pytest.raises(KVCacheOOM):
        b.kv.adopt_serialized("z", big)
    assert b.kv.blocks_in_use() == 0
    a.kv.free("o1")
    with pytest.raises(ValueError, match="dead block"):
        a.kv.export_blocks(blocks=ids)


class _ReleaseHook:
    """The ledger lock with a one-shot hook run right after its next
    release: the moment a concurrent defrag or decode step could write
    the pool between an export's lock and its host fetch."""

    def __init__(self, lock):
        self.lock, self.hook = lock, None

    def __enter__(self):
        self.lock.acquire()
        return self

    def __exit__(self, *exc):
        self.lock.release()
        hook, self.hook = self.hook, None
        if hook is not None:
            hook()
        return False


def test_export_is_a_copy_a_write_after_the_lock_cannot_tear_it():
    m = _model()
    kv = DecodeScheduler(m, name="torn", **SCHED).kv
    kv.ensure_capacity("o", 12)
    ids = kv.owner_blocks("o")
    g = torch.Generator().manual_seed(0)
    for k, v in kv.pages():
        k.copy_(torch.randn(k.shape, generator=g))
        v.copy_(torch.randn(v.shape, generator=g))
    want = [(k[ids].clone().numpy(), v[ids].clone().numpy())
            for k, v in kv.pages()]
    kv._lock = hook = _ReleaseHook(kv._lock)

    def overwrite():
        # a defrag moving other pages onto these blocks, or a decode
        # step writing them in place
        for k, v in kv.pages():
            k[ids] = -7.0
            v[ids] = 9.0

    hook.hook = overwrite
    got_ids, layers = kv.export_blocks(blocks=ids)
    assert hook.hook is None, "the hook never ran"
    assert got_ids == ids
    for (k, v), (wk, wv) in zip(layers, want):
        np.testing.assert_array_equal(k, wk)
        np.testing.assert_array_equal(v, wv)
    assert float(kv.pages()[0][0][ids[0]].flatten()[0]) == -7.0


def _matrix(rdc, hand, arrays, Err, swap_params):
    """Refused handoffs on the decode agent behind ``rdc``: a geometry
    mismatch, corrupt tokens, corrupt pages, a version skew. Returns the
    refusals' messages, the blocks in use after them and the clean
    handoff's adopted blocks."""
    bad_geo = dict(hand, geometry=dict(hand["geometry"], head_dim=7))
    bad_tok = [arrays[0].copy()] + list(arrays[1:])
    bad_tok[0][3] ^= 1
    bad_pg = [arrays[0]] + [np.array(a, copy=True) for a in arrays[1:]]
    bad_pg[1].reshape(-1)[0] += 1.0
    msgs = []
    for h, a in ((bad_geo, arrays), (hand, bad_tok), (hand, bad_pg)):
        with pytest.raises(Err) as ei:
            rdc.adopt_prefix(h, a, timeout=60)
        msgs.append(str(ei.value))
    rdc.registry.publish(swap_params, version="v-new")
    rdc.registry.activate("v-new")
    with pytest.raises(Err) as ei:
        rdc.adopt_prefix(hand, arrays, timeout=60)
    msgs.append(str(ei.value))
    in_use = rdc.stats()["kv"]["blocks_in_use"]
    rdc.registry.activate(hand["version"])
    adopted = rdc.adopt_prefix(hand, arrays, timeout=60)[0]
    return msgs, in_use, adopted["adopted_blocks"]


def test_refused_handoffs_are_refused_where_jax_refuses_them():
    """The port's prefill agent exports; the port's decode agent and a
    JAX decode agent (JAX's geometry tag, chain keys and digest are the
    port's) take the same refusal matrix, then the clean handoff."""
    jm, _ = _weights()
    m = _model()
    fd = tempfile.mkdtemp(prefix="fleet_refuse_")
    ags, (rpf, rdc) = _agents(fd, m, [("pf", "prefill", {}),
                                      ("dc", "decode", {})])
    jsched = JaxScheduler(jm, name="jdc", **SCHED).start(warmup=False)
    jag = JaxAgent(jsched, fleet_dir=fd, name="jdc", role="decode").start()
    try:
        rpf.start()
        rdc.start()
        jdc = JaxRemote(jax_wait(fd, ["jdc"], timeout_s=30)[0],
                        fleet_dir=fd).start()
        prompt = np.random.RandomState(3).randint(1, V, 35).astype(np.int32)
        meta, arrays = rpf.prefill_export(prompt, timeout=120)
        assert meta["tokens"] == 32
        hand = {k: meta[k] for k in ("version", "keys", "geometry",
                                     "digest")}
        got = _matrix(rdc, hand, arrays, KVHandoffError,
                      _scaled(m.params, 1.01))
        want = _matrix(jdc, hand, arrays, JaxHandoffError,
                       jax.tree_util.tree_map(lambda a: a * 1.01,
                                              jm.params))
    finally:
        for a in ags:
            a.shutdown()
        jag.shutdown()
    keys = ("geometry mismatch", "chain-hash mismatch", "digest mismatch",
            "version skew")
    for msgs in (got[0], want[0]):
        assert all(k in msg for k, msg in zip(keys, msgs)), msgs
    assert got[1] == want[1] == 0, "a refused handoff adopts nothing"
    assert got[2] == want[2] == 32 // SCHED["block_size"]
    assert fleet_threads_alive() == 0


def test_bf16_pages_cross_the_handoff_bit_for_bit():
    from bigdl_tpu_torch.serving import PagedKVCache
    m = _model()
    a = PagedKVCache(m, num_blocks=8, block_size=4, max_blocks_per_seq=4,
                     dtype=torch.bfloat16)
    b = PagedKVCache(m, num_blocks=8, block_size=4, max_blocks_per_seq=4,
                     dtype=torch.bfloat16)
    assert a.geometry()["dtype"] == "bfloat16"
    a.ensure_capacity("o", 8)
    g = torch.Generator().manual_seed(1)
    for k, v in a.pages():
        k.copy_(torch.randn(k.shape, generator=g))
        v.copy_(torch.randn(v.shape, generator=g))
    ids, layers = a.export_blocks(owner="o")
    assert layers[0][0].dtype == torch.bfloat16
    from bigdl_tpu_torch.serving import transport as pt
    descr, bufs = pt.pack_arrays([x for kv in layers for x in kv])
    back = pt.unpack_arrays(descr, [bytearray(bytes(x)) for x in bufs])
    new = b.adopt_serialized("x", [(back[2 * i], back[2 * i + 1])
                                   for i in range(len(layers))])
    for (k, v), (bk, bv) in zip(a.pages(), b.pages()):
        assert torch.equal(k[ids].view(torch.int16), bk[new].view(
            torch.int16))
        assert torch.equal(v[ids].view(torch.int16), bv[new].view(
            torch.int16))


# -- the fleet --------------------------------------------------------------------

def test_remote_tokens_bitwise_local_and_jax_and_swap_never_mixes():
    jm, _ = _weights()
    m = _model()
    fd = tempfile.mkdtemp(prefix="fleet_remote_")
    local = DecodeScheduler(m, name="oracle", **SCHED).start()
    ags, (rr,) = _agents(fd, m, [("r0", "replica", {})])
    try:
        router = Router([rr]).start()
        prompts = _prompts(np.random.RandomState(0), (5, 17, 26, 33))
        want = [local.generate(p, 12) for p in prompts]
        futs = [router.submit(p, max_new_tokens=12) for p in prompts]
        got = [f.result(timeout=120) for f in futs]
        for w, g in zip(want, got):
            np.testing.assert_array_equal(w, g)
        assert all(f.version == "v0" for f in futs)
        js = _jax_sched()
        jwant = [np.asarray(js.generate(p, 12)) for p in prompts]
        for p, g, jw in zip(prompts, got, jwant):
            _agree_jax(m, p, g, jw)
        # seeded sampling, (seed, position)-keyed: bitwise across processes
        ws = local.generate(prompts[1], 10, temperature=0.7, top_p=0.9,
                            seed=11)
        gs = router.submit(prompts[1], max_new_tokens=10, temperature=0.7,
                           top_p=0.9, seed=11).result(timeout=120)
        np.testing.assert_array_equal(ws, gs)
        # the two-phase fleet swap over the wire, in bfloat16 leaves: every
        # later response is the new version's, bitwise
        from bigdl_tpu_torch.utils.amp import bf16_params
        p2 = bf16_params(_perturbed(m.params))
        v2 = router.swap(p2)
        local.swap(p2, version=v2)
        futs2 = [router.submit(p, max_new_tokens=12) for p in prompts]
        got2 = [f.result(timeout=120) for f in futs2]
        want2 = [local.generate(p, 12) for p in prompts]
        for f, w2, g2 in zip(futs2, want2, got2):
            assert f.version == v2
            np.testing.assert_array_equal(w2, g2)
        assert not np.array_equal(want[0], want2[0])
        remote = ags[0].engine.registry.get(v2).params
        assert remote["block0"]["attn"]["wq"].dtype == torch.bfloat16
        assert torch.equal(remote["block0"]["attn"]["wq"],
                           p2["block0"]["attn"]["wq"])
        meta, _ = rr._request("shutdown", {"drain": True}, timeout=120)
        assert meta["kv_blocks_in_use"] == 0
        router.shutdown()
    finally:
        for a in ags:
            a.shutdown()
        local.shutdown()
    doc = read_member(fd, "r0")
    assert doc and doc.get("final") and not doc.get("dead")
    assert fleet_threads_alive() == 0 and transport_threads_alive() == 0


def test_disaggregated_tokens_bitwise_monolithic_greedy_sampled_and_swap():
    m = _model()
    fd = tempfile.mkdtemp(prefix="fleet_dis_")
    local = DecodeScheduler(m, name="mono", **SCHED).start()
    ags, (rpf, rd0) = _agents(fd, m, [("pf", "prefill", {}),
                                      ("d0", "decode", {})])
    try:
        rpf.start()
        router = Router([rd0]).start()
        dis = DisaggregatedFleet(router, [rpf], [rd0])
        long_prompts = _prompts(np.random.RandomState(2), (33, 40, 52))
        want = [local.generate(p, 10) for p in long_prompts]
        got = [dis.submit(p, max_new_tokens=10).result(timeout=120)
               for p in long_prompts]
        for w, g in zip(want, got):
            np.testing.assert_array_equal(w, g)
        ws = local.generate(long_prompts[0], 8, temperature=0.8, top_p=0.85,
                            seed=23)
        gs = dis.submit(long_prompts[0], max_new_tokens=8, temperature=0.8,
                        top_p=0.85, seed=23).result(timeout=120)
        np.testing.assert_array_equal(ws, gs)
        st = dis.stats()
        assert st["handoffs"] == 4 and st["handoff_failed"] == 0 \
            and st["handoff_refused"] == 0, st
        sd = rd0.stats()
        assert sd["prefix_hits"] >= 3 and sd["prefix_reused_tokens"] >= 96
        # the swap covers the prefill pool: handoffs keep landing
        p2 = _scaled(m.params, 1.01)
        v = dis.swap(p2)
        local.swap(p2, version=v)
        prompt = _prompts(np.random.RandomState(5), (37,))[0]
        np.testing.assert_array_equal(
            local.generate(prompt, 8),
            dis.submit(prompt, max_new_tokens=8).result(timeout=120))
        st = dis.stats()
        assert st["handoffs"] == 5 and st["handoff_refused"] == 0, st
        router.shutdown()
    finally:
        for a in ags:
            a.shutdown()
        local.shutdown()
    assert fleet_threads_alive() == 0


def test_a_cadence_audit_inside_an_export_does_not_quarantine():
    """An export holds ownerless references to its chain's blocks while it
    copies them (``retain`` ... ``release``, on the agent's handoff
    thread), and the scheduler's cadence audit runs on its loop thread at
    any moment. An audit inside that window must not read the export's
    references as a leak and quarantine the prefill pool, which then
    registers no prefix and exports nothing (ROADMAP C.11: a whole smoke
    handed off 9 of 16 prompts, then none). Here the audit lands inside
    every export's window; it completes once the export is done."""
    m = _model()
    fd = tempfile.mkdtemp(prefix="fleet_audit_")
    ags, (rpf, rd0) = _agents(fd, m, [("pf", "prefill", {}),
                                      ("d0", "decode", {})])
    pf = ags[0].engine
    export, audits, threads = pf.kv.export_blocks, [], []

    def export_under_audit(*a, **kw):
        t = threading.Thread(target=lambda: audits.append(
            pf._audit("cadence")))
        threads.append(t)
        t.start()
        t.join(0.3)         # the loop's audit, inside the export's window
        return export(*a, **kw)
    pf.kv.export_blocks = export_under_audit
    try:
        rpf.start()
        router = Router([rd0]).start()
        dis = DisaggregatedFleet(router, [rpf], [rd0])
        for p in _prompts(np.random.RandomState(7), (33, 40, 52)):
            dis.submit(p, max_new_tokens=4).result(timeout=120)
        for t in threads:
            t.join(30)
        st = dis.stats()
        assert st["handoffs"] == 3 and st["direct"] == 0, st
        assert len(audits) == 3 and all(r["ok"] for r in audits), audits
        ps = rpf.stats()
        assert not ps["quarantined"] and ps["kv_corruptions"] == 0, ps
        router.shutdown()
    finally:
        pf.kv.export_blocks = export
        for a in ags:
            a.shutdown()
    assert fleet_threads_alive() == 0


def test_warm_replica_refills_spilled_chains_from_source():
    m = _model()
    fd = tempfile.mkdtemp(prefix="fleet_warm_")
    ags, (rsrc, rtgt) = _agents(fd, m, [("ws", "replica",
                                         {"host_blocks": 32}),
                                        ("wt", "replica", {})])
    solo = DecodeScheduler(m, name="wsolo", **SCHED).start()
    src_sched = ags[0].engine
    try:
        rsrc.start()
        rtgt.start()
        prompts = _prompts(np.random.RandomState(21), (16,) * 4)
        for p in prompts:
            rsrc.submit(p, max_new_tokens=8).result(timeout=120)
        src_sched.prefix.evict(4)
        st = rsrc.stats()
        assert st["prefix"]["spills"] == 4
        deadline = time.time() + 10
        while time.time() < deadline:
            with src_sched.prefix._lock:
                pend = [h for h, _ in src_sched.prefix._spilled.values()
                        if h.state == SPILL_PENDING]
            if not pend:
                break
            time.sleep(0.01)
        assert not pend
        out = warm_replica(rsrc, rtgt, prompts, timeout_s=120)
        assert out["warmed"] == 4 and out["failed"] == 0, out
        assert rsrc.stats()["prefix"]["hits_after_spill"] >= 1
        want = solo.generate(prompts[0], 8)
        got = rtgt.submit(prompts[0], max_new_tokens=8).result(timeout=120)
        np.testing.assert_array_equal(want, got)
        assert rtgt.stats()["prefix_hits"] >= 1
    finally:
        for a in ags:
            a.shutdown()
        solo.shutdown()
    assert src_sched.stats()["host"]["host_blocks_in_use"] == 0
    assert fleet_threads_alive() == 0


def test_monitor_redials_a_torn_connection():
    m = _model()
    fd = tempfile.mkdtemp(prefix="fleet_reconn_")
    ags, (rep,) = _agents(fd, m, [("rc", "replica", {})], beat_s=0.1)
    mon = None
    try:
        rep.start()
        mon = FleetMonitor([rep], fleet_dir=fd, every_s=0.05,
                           stale_s=5.0).start()
        prompt = _prompts(np.random.RandomState(9), (9,))[0]
        first = rep.submit(prompt, max_new_tokens=4).result(timeout=60)
        rep._client.close()
        deadline = time.time() + 10
        while rep._client.closed and time.time() < deadline:
            time.sleep(0.02)
        assert not rep._client.closed
        again = rep.submit(prompt, max_new_tokens=4).result(timeout=60)
        np.testing.assert_array_equal(first, again)
    finally:
        if mon is not None:
            mon.stop()
        for a in ags:
            a.shutdown()
    assert fleet_threads_alive() == 0


def test_agent_death_mid_decode_loses_nothing_and_splices_partials():
    """r0's scheduler takes a permanent fault at its 6th decode dispatch
    (a chaos rule tagged with its name); its in-flight requests fail
    typed with their partial tokens, the agent dies (exit code 86, a dead
    member file), and the Router splices the partials on r1: every
    stream is bit for bit the uninterrupted run."""
    m = _model()
    fd = tempfile.mkdtemp(prefix="fleet_death_")
    local = DecodeScheduler(m, name="oracle2", **SCHED).start()
    ags, reps = _agents(fd, m, [("r0", "replica", {}),
                                ("r1", "replica", {})], beat_s=0.1)
    monitor = None
    try:
        prompts = _prompts(np.random.RandomState(1), (6, 9, 14, 21))
        want = [local.generate(p, 24) for p in prompts]
        chaos.arm({"sites": {"serving/scheduler_step": [
            {"kind": "permanent", "nth": 6, "tag": "r0"}]}})
        router = Router(reps, max_failovers=4).start()
        monitor = FleetMonitor(reps, fleet_dir=fd, every_s=0.05,
                               stale_s=10.0).start()
        futs = [router.submit(p, max_new_tokens=24) for p in prompts]
        got = [f.result(timeout=120) for f in futs]
        for w, g in zip(want, got):
            np.testing.assert_array_equal(w, g)
        st = router.stats()
        assert st["completed"] == len(prompts), st
        assert st["kv_recoveries"] >= 1, st
        assert {f.trace["router"]["replica"] for f in futs} >= {"r1"}
        deadline = time.time() + 10
        while ags[0].exit_code != 86 and time.time() < deadline:
            time.sleep(0.02)
        assert ags[0].exit_code == 86
        assert read_member(fd, "r0")["dead"]
        router.shutdown()
    finally:
        if monitor is not None:
            monitor.stop()
        for a in ags:
            a.shutdown()
        local.shutdown()
    assert fleet_threads_alive() == 0


def test_subprocess_agent_from_config_registers_and_serves(tmp_path):
    """One agent process through ``python -m bigdl_tpu_torch.serving.fleet
    <config.json>`` on the CPU (``"device": "cpu"``): it registers, serves
    one request bit for bit as the in-process scheduler, reports its
    launches through ``stats``, imports neither JAX nor bigdl_tpu, and
    drains to exit 0."""
    fd = str(tmp_path)
    m = _model()
    path = os.path.join(fd, "params.pkl")
    with open(path, "wb") as f:
        pickle.dump(_weights()[1], f)
    cfg = {"fleet_dir": fd, "name": "sp", "role": "replica", "beat_s": 0.1,
           "process_index": 1, "model": MODEL, "params_path": path,
           "scheduler": SCHED, "device": "cpu"}
    cfg_path = os.path.join(fd, "cfg_sp.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    # the agent's own interpreter reports what it imported at exit
    code = ("import atexit, runpy, sys\n"
            "def bad():\n"
            "    b = [m for m in sys.modules if m in ('jax', 'bigdl_tpu') or "
            "m.startswith(('jax.', 'bigdl_tpu.'))]\n"
            "    print('FOREIGN', b, flush=True)\n"
            "atexit.register(bad)\n"
            "sys.argv = ['fleet', sys.argv[1]]\n"
            "runpy.run_module('bigdl_tpu_torch.serving.fleet', "
            "run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    log_path = os.path.join(fd, "agent.log")
    with open(log_path, "w") as log:
        p = subprocess.Popen([sys.executable, "-c", code, cfg_path],
                             stdout=log, stderr=subprocess.STDOUT, cwd=REPO,
                             env=env)
    try:
        doc, = wait_for_members(fd, ["sp"], timeout_s=120)
        rr = RemoteReplica(doc, fleet_dir=fd).start()
        prompt = _prompts(np.random.RandomState(8), (19,))[0]
        with DecodeScheduler(m, name="solo", **SCHED) as solo:
            want = solo.generate(prompt, 8)
        got = rr.submit(prompt, max_new_tokens=8).result(timeout=120)
        np.testing.assert_array_equal(want, got)
        st = rr.stats()
        assert st["completed"] == 1 and "launches_by_route" in st
        assert st["launches"]["paged_attention"] == 0    # CPU: no kernel
        meta, _ = rr._request("shutdown", {"drain": True}, timeout=60)
        assert meta["kv_blocks_in_use"] == 0
        rr.close()
        assert p.wait(timeout=60) == 0
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    with open(log_path) as f:
        log = f.read()
    assert "FOREIGN []" in log, log[-2000:]
    assert read_member(fd, "sp").get("final")
