"""The port's host KV tier: ``HostKVPool`` / ``KVSwapManager`` (spill,
refill, digest, failure and exhaustion), the prefix cache's second chance
and the scheduler's swap-based priority preemption, held against the JAX
package's.

On the CPU the port's stager copies on its own thread and a refill is a
plain copy (the pinned ring and the side stream are the card's path,
driven by ``chip_smoke.py``). Tokens: against JAX's scheduler up to and
including the first step whose top-2 logit margin, on the port's own solo
decode, is under 1e-3; a refilled or recomputed request against the
port's own cold run bitwise.
"""
import time

import numpy as np
import pytest
import torch

import jax

from bigdl_tpu.models.transformer_lm import TransformerLM as JaxLM
from bigdl_tpu.serving import DecodeScheduler as JaxScheduler
from bigdl_tpu.serving.kv_cache import KVSwapManager as JaxSwap
from bigdl_tpu.serving.kv_cache import PagedKVCache as JaxKV
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.serving import (DecodeScheduler, HostKVPool,
                                     HostPoolOOM, KVSwapManager,
                                     PagedKVCache, PrefixCache,
                                     decode_scheduler_threads_alive,
                                     kv_swap_threads_alive)
from bigdl_tpu_torch.serving.kv_cache import (SPILL_FAILED, SPILL_FREED,
                                              SPILL_PENDING, SPILL_READY,
                                              _pages_digest)

torch.set_num_threads(1)
V, H, MAXLEN, CHUNK, BS = 48, 32, 128, 8, 4
MARGIN = 1e-3
CFG = dict(vocab_size=V, hidden_size=H, num_heads=4, filter_size=64,
           num_layers=2, max_len=MAXLEN, num_kv_heads=2, pos_encoding="rope")
SCHED = dict(max_slots=4, block_size=BS, max_seq_len=96, prefill_chunk=CHUNK)

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


def _solo_margins(tm, prompt, toks):
    """Top-2 margins of the port's full forward at each of ``toks``."""
    ids = np.concatenate([prompt, toks])[None, :-1]
    with torch.no_grad():
        lg = tm.call(tm.params, torch.as_tensor(ids))[0, prompt.size - 1:]
    top = lg.topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]).numpy()


def _assert_agree(got, want, margins):
    low = np.nonzero(margins < MARGIN)[0]
    k = len(margins) if low.size == 0 else int(low[0]) + 1
    np.testing.assert_array_equal(np.asarray(got)[:k], np.asarray(want)[:k])
    return k


def _wait(cond, what, deadline_s=30.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < deadline_s, what
        time.sleep(0.002)


def _settle(pc):
    """Spills are asynchronous: wait until no spilled handle is PENDING."""
    def done():
        with pc._lock:
            return all(h.state != SPILL_PENDING
                       for h, _ in pc._spilled.values())
    _wait(done, "spill stage never settled")


def _plus(rng, prefix, n):
    return np.concatenate([prefix, rng.randint(1, V, n).astype(np.int32)])


# -- the host pool and the manager ---------------------------------------------

def test_host_pool_reserve_store_payload_fail_free():
    pool = HostKVPool(4)
    h = pool.alloc(3, tag="t")
    assert h.state == SPILL_PENDING and pool.blocks_in_use() == 3
    with pytest.raises(HostPoolOOM):
        pool.alloc(2)
    layers = [(np.ones((3, 2)), np.zeros((3, 2)))]
    assert pool.payload(h) is None
    assert pool.store(h, layers, b"d") and h.state == SPILL_READY
    assert pool.payload(h)[1] == b"d" and h.nbytes == 96
    pool.fail(h)                           # READY: fail is a no-op
    assert h.state == SPILL_READY
    assert pool.free(h) == 3 and pool.free(h) == 0
    g = pool.alloc(4)
    pool.fail(g)
    assert g.state == SPILL_FAILED and not pool.store(g, layers, b"d")
    assert pool.stats() == {"host_blocks_total": 4, "host_blocks_in_use": 0,
                            "host_blocks_free": 4, "host_spills": 2}


def test_block_freed_and_rewritten_after_spill_refills_its_old_bytes():
    """The port's pages are written in place, so a spill gathers them at
    the boundary: the blocks freed and rewritten right after ``spill``
    still refill with the old bytes, whose digest equals JAX's over the
    same pages."""
    jm, tm = _models()
    kw = dict(num_blocks=8, block_size=BS, max_blocks_per_seq=4)
    kv, jkv = PagedKVCache(tm, **kw), JaxKV(jm, **kw)
    swap, jswap = KVSwapManager(kv, 8), JaxSwap(jkv, 8)
    try:
        kv.ensure_capacity("a", 12)
        jkv.ensure_capacity("a", 12)
        ids = kv.owner_blocks("a")
        assert ids == jkv.owner_blocks("a")
        old = []
        for li, (k, v) in enumerate(kv.pages()):
            k[ids] = torch.randn(k[ids].shape, generator=torch.Generator(
            ).manual_seed(li))
            v[ids] = -k[ids]
            old.append((k[ids].clone(), v[ids].clone()))
        # copies: a CPU jax array may alias the numpy memory it came from
        jkv.set_pages([(jax.numpy.array(k.numpy().copy()),
                        jax.numpy.array(v.numpy().copy()))
                       for k, v in kv.pages()])
        h, jh = swap.spill(ids, tag="t"), jswap.spill(ids, tag="t")
        kv.free("a")
        kv.ensure_capacity("b", 12)            # the same blocks, LIFO
        assert sorted(kv.owner_blocks("b")) == sorted(ids)
        for k, v in kv.pages():
            k[ids] = 9.0
            v[ids] = 9.0
        _wait(lambda: h.state == SPILL_READY and jh.state == SPILL_READY,
              "spill never staged")
        layers, digest = swap.pool.payload(h)
        assert digest == _pages_digest(layers) == jswap.pool.payload(jh)[1]
        kv.free("b")
        new = swap.refill("r", h)
        assert h.state == SPILL_FREED and swap.pool.blocks_in_use() == 0
        for (k, v), (ok, ov) in zip(kv.pages(), old):
            assert torch.equal(k[new], ok) and torch.equal(v[new], ov)
        st = swap.stats()
        assert st["swap_out_bytes"] == st["swap_in_bytes"] == h.nbytes > 0
        assert st["swap_failures"] == 0 and st["swap_out_s"] is None
    finally:
        swap.shutdown()
        jswap.shutdown()
    assert kv_swap_threads_alive() == 0


def test_corrupt_or_failed_handles_degrade_and_refill_many_clamps():
    _, tm = _models()
    kv = PagedKVCache(tm, num_blocks=8, block_size=BS, max_blocks_per_seq=8)
    swap = KVSwapManager(kv, 16)
    try:
        kv.ensure_capacity("seed", 6 * BS)
        hs = swap.spill_many([[b] for b in kv.owner_blocks("seed")] + [[]])
        assert hs[-1] is None
        hs = hs[:-1]
        _wait(lambda: all(h.state == SPILL_READY for h in hs), "staging")
        kv.free("seed")
        kv.ensure_capacity("hog", 5 * BS)      # leaves 2 blocks free
        ids, consumed, dropped = swap.refill_many("re", hs)
        assert (len(ids), consumed, dropped) == (2, 2, 0)
        kv.free("re")
        kv.free("hog")
        hs[3].layers[0][0][0, 0, 0, 0] += 1.0  # a corrupt host page
        ids, consumed, dropped = swap.refill_many("re2", hs[2:])
        assert (consumed, dropped) == (1, 1) and hs[3].state == SPILL_FREED
        assert swap.stats()["swap_failures"] == 1
        kv.free("re2")
        assert swap.spill([], tag="x") is None  # an empty group
        assert swap.refill("x", hs[4]) is not None
        swap.pool.fail(hs[5])                  # READY: no-op
        assert swap.discard(hs[5]) == 1
    finally:
        swap.shutdown()
    assert swap.pool.blocks_in_use() == 0


# -- the prefix cache's second chance -------------------------------------------

def test_hit_after_spill_refills_bitwise_and_matches_jax():
    jm, tm = _models()
    rng = np.random.RandomState(31)
    prefix = rng.randint(1, V, 16).astype(np.int32)
    p1, p2 = _plus(rng, prefix, 5), _plus(rng, prefix, 3)
    with DecodeScheduler(tm, prefix_cache=False, **SCHED) as ts:
        cold = [ts.generate(p, 6, timeout=120) for p in (p1, p2)]

    def run(sched):
        r1 = sched.submit(p1, 6).result(120)
        n = sched.stats()["prefix"]["entries"]
        assert sched.prefix.evict(n) == n      # the chain goes to host
        assert sched.stats()["prefix"]["spilled_entries"] == n
        _settle(sched.prefix)
        r2 = sched.submit(p2, 6).result(120)
        return [r1, r2], sched.stats()

    js = JaxScheduler(jm, host_blocks=32, **SCHED).start(warmup=False)
    try:
        want, jst = run(js)
    finally:
        js.shutdown()
    with DecodeScheduler(tm, host_blocks=32, **SCHED) as ts:
        got, st = run(ts)
    for g, c, w, p in zip(got, cold, want, (p1, p2)):
        np.testing.assert_array_equal(g, c)
        _assert_agree(g, w, _solo_margins(tm, p, c))
    for key in ("hits_after_spill", "refills", "spills", "evictions"):
        assert st["prefix"][key] == jst["prefix"][key], key
    assert st["prefix"]["hits_after_spill"] == 1 and st["prefix_hits"] == 1
    assert st["host"]["swap_out_bytes"] > 0 and st["host"]["swap_in_bytes"] > 0
    assert ts.stats()["host"]["host_blocks_in_use"] == 0
    assert ts.stats()["kv"]["blocks_in_use"] == 0
    assert decode_scheduler_threads_alive() == kv_swap_threads_alive() == 0


def test_host_pool_exhaustion_degrades_spill_to_drop():
    _, tm = _models()
    rng = np.random.RandomState(39)
    prefix = rng.randint(1, V, 16).astype(np.int32)
    with DecodeScheduler(tm, prefix_cache=False, **SCHED) as ts:
        cold = ts.generate(_plus(np.random.RandomState(2), prefix, 3), 6,
                           timeout=120)
    with DecodeScheduler(tm, host_blocks=2, **SCHED) as ts:
        ts.generate(_plus(rng, prefix, 5), 4, timeout=120)
        n = ts.stats()["prefix"]["entries"]
        assert ts.prefix.evict(n) == n         # device blocks all freed
        st = ts.stats()
        assert 0 < st["prefix"]["spilled_entries"] <= 2 < n
        _settle(ts.prefix)
        again = ts.generate(_plus(np.random.RandomState(2), prefix, 3), 6,
                            timeout=120)
    np.testing.assert_array_equal(again, cold)
    assert ts.stats()["host"]["host_blocks_in_use"] == 0


def test_refill_pressure_trades_cold_residents_for_the_warm_chain():
    _, tm = _models()
    rng = np.random.RandomState(40)
    tok_c = rng.randint(1, V, 32).astype(np.int32)      # an 8-block chain
    tok_a = rng.randint(1, V, 12).astype(np.int32)      # a cold bystander
    kv = PagedKVCache(tm, num_blocks=9, block_size=BS, max_blocks_per_seq=16)
    swap = KVSwapManager(kv, host_blocks=32)
    pc = PrefixCache(kv, swap=swap)
    try:
        kv.ensure_capacity("c", 32)
        pc.insert(tok_c, "v", kv.owner_blocks("c"))
        kv.free("c")
        assert pc.evict(4) == 4                # C's tail spills leaf first
        kv.ensure_capacity("a", 12)
        pc.insert(tok_a, "v", kv.owner_blocks("a"))
        kv.free("a")
        _settle(pc)
        assert kv.blocks_free() == 1
        blocks = pc.lookup(tok_c, "v")
        st = pc.stats()
        assert len(blocks) == 8 and st["hits_after_spill"] == 1
        assert st["refills"] == 4 and st["spilled_entries"] == 3
        assert st["spills"] == 7 and st["entries"] == 8
        assert pc.lookup(tok_c, "v") == blocks
        _settle(pc)
        assert pc.peek(tok_a, "v") == 12       # READY on host: routable
    finally:
        pc.clear()
        swap.shutdown()
    assert swap.pool.blocks_in_use() == 0 and kv.blocks_in_use() == 0


# -- swap-based preemption -------------------------------------------------------

def _preempt_run(sched, pa, pb):
    fa = sched.submit(pa, 24, priority=0)
    _wait(lambda: sched.stats()["active"] == 1, "A never started decoding")
    fb = sched.submit(pb, 8, priority=1)
    return [fa.result(120), fb.result(120)], sched.stats()


def _preempt_prompts():
    rng = np.random.RandomState(33)
    return (rng.randint(1, V, 24).astype(np.int32),
            rng.randint(1, V, 24).astype(np.int32))


def test_preempt_then_resume_matches_jax_and_the_solo_run():
    """The pool fits one request's worst case: the priority-1 arrival
    swaps the decoding priority-0 request out; it resumes from its
    refilled pages at the position it left."""
    jm, tm = _models()
    pa, pb = _preempt_prompts()
    kw = dict(SCHED, num_blocks=14, prefix_cache=False, host_blocks=32)
    with DecodeScheduler(tm, prefix_cache=False, **SCHED) as ts:
        solo = [ts.generate(pa, 24, timeout=120),
                ts.generate(pb, 8, timeout=120)]
    js = JaxScheduler(jm, **kw).start(warmup=False)
    try:
        want, jst = _preempt_run(js, pa, pb)
    finally:
        js.shutdown()
    with DecodeScheduler(tm, **kw) as ts:
        got, st = _preempt_run(ts, pa, pb)
    for g, s, w, p in zip(got, solo, want, (pa, pb)):
        np.testing.assert_array_equal(g, s)
        _assert_agree(g, w, _solo_margins(tm, p, s))
    assert st["preemptions"] >= 1 and jst["preemptions"] >= 1
    assert st["resumes"] >= 1 and st["resume_recomputes"] == 0
    assert st["host"]["swap_failures"] == 0
    final = ts.stats()
    assert final["kv"]["blocks_in_use"] == 0
    assert final["host"]["host_blocks_in_use"] == 0
    assert decode_scheduler_threads_alive() == kv_swap_threads_alive() == 0


def test_failed_stage_degrades_the_resume_to_a_recompute():
    """``HostKVPool.fail`` on the preempted request's handle (the stager's
    copy died): the resume re-prefills the request's tokens and its
    output is unchanged."""
    _, tm = _models()
    pa, pb = _preempt_prompts()
    with DecodeScheduler(tm, prefix_cache=False, **SCHED) as ts:
        solo = [ts.generate(pa, 24, timeout=120),
                ts.generate(pb, 8, timeout=120)]
    ts = DecodeScheduler(tm, num_blocks=14, prefix_cache=False,
                         host_blocks=32, **SCHED)
    orig = ts.kv_swap._fetch

    def failing_fetch(plans, pages, ev):
        for h, _s, _n in plans:
            if h.tag == "preempt":
                ts.kv_swap.pool.fail(h)
        return orig(plans, pages, ev)

    ts.kv_swap._fetch = failing_fetch
    with ts:
        got, st = _preempt_run(ts, pa, pb)
    for g, s in zip(got, solo):
        np.testing.assert_array_equal(g, s)
    assert st["preemptions"] >= 1 and st["resume_recomputes"] >= 1
    assert st["resumes"] == 0
    assert ts.stats()["host"]["host_blocks_in_use"] == 0
    assert ts.stats()["kv"]["blocks_in_use"] == 0 and ts.audit()["ok"]


def test_equal_priorities_never_preempt_and_preempt_false_defers():
    _, tm = _models()
    pa, pb = _preempt_prompts()
    for kw in (dict(), dict(preempt=False)):
        with DecodeScheduler(tm, num_blocks=14, prefix_cache=False,
                             host_blocks=32, **kw, **SCHED) as ts:
            fa = ts.submit(pa, 24)
            _wait(lambda: ts.stats()["active"] == 1, "A never decoded")
            fb = ts.submit(pb, 8, priority=1 if kw else 0)
            fa.result(120)
            fb.result(120)
            assert ts.stats()["preemptions"] == 0
