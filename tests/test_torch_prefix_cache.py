"""The port's prefix cache: the shared-block ledger (adopt, retain, release,
copy-on-write forks, defrag), the content-addressed ``PrefixCache`` and the
scheduler's prefix admission, each held against the JAX package's.

Ledger and index: both packages run the same script and must agree block
id for block id (the free lists are LIFO in both) and page for page.

Tokens: the port's scheduler against JAX's scheduler (both with JAX's
default ``prefix_cache=True``) up to and including the first step whose
top-2 logit margin, on the port's own solo decode, is under 1e-3 (the two
frameworks agree on logits to about 1e-6 in float32 here). Warm against
cold in the port alone is held bitwise: a warm request reruns exactly the
cold schedule's remaining chunks over the same pages.
"""
import time

import numpy as np
import pytest
import torch

import jax

from bigdl_tpu.models.transformer_lm import TransformerLM as JaxLM
from bigdl_tpu.serving import DecodeScheduler as JaxScheduler
from bigdl_tpu.serving import PagedKVCache as JaxKV
from bigdl_tpu.serving import PrefixCache as JaxPrefix
from bigdl_tpu.serving import chain_keys as jax_chain_keys
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.serving import (DecodeScheduler, KVCacheOOM,
                                     PagedKVCache, PrefixCache, chain_keys,
                                     decode_scheduler_threads_alive,
                                     prefill_schedule)

torch.set_num_threads(1)
V, H, MAXLEN, CHUNK, BS = 48, 32, 128, 8, 4     # hit_align = 8
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


def _plus(rng, prefix, n):
    return np.concatenate([prefix, rng.randint(1, V, n).astype(np.int32)])


# -- the chain keys and the ledger ---------------------------------------------

@pytest.mark.parametrize("bs,version,n,cap", [
    (4, "v0", 17, None), (4, "v0", 16, 3), (16, "bf16", 70, None),
    (8, "v12", 7, None)])
def test_chain_keys_equal_jax_byte_for_byte(bs, version, n, cap):
    toks = np.random.RandomState(n).randint(0, 32000, n)
    got = chain_keys(toks, bs, version, max_blocks=cap)
    assert got == jax_chain_keys(toks, bs, version, max_blocks=cap)
    assert len(got) == min(n // bs, cap if cap is not None else n)


def _patterned(kv_port, kv_jax):
    """Give both pools the same distinct page contents."""
    pages = []
    for li, (k, v) in enumerate(kv_port.pages()):
        kn = np.random.RandomState(li).randn(*k.shape).astype(np.float32)
        vn = np.random.RandomState(li + 50).randn(*v.shape).astype(np.float32)
        k.copy_(torch.from_numpy(kn))
        v.copy_(torch.from_numpy(vn))
        pages.append((jax.numpy.asarray(kn), jax.numpy.asarray(vn)))
    kv_jax.set_pages(pages)


def _same_pages(kv_port, kv_jax):
    for (k, v), (jk, jv) in zip(kv_port.pages(), kv_jax.pages()):
        np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_ledger_follows_jax_through_one_script():
    jm, tm = _models()
    kw = dict(num_blocks=12, block_size=BS, max_blocks_per_seq=5)
    pk, jk = PagedKVCache(tm, **kw), JaxKV(jm, **kw)
    _patterned(pk, jk)
    remaps = {"port": [], "jax": []}
    pk.add_remap_listener(remaps["port"].append)
    jk.add_remap_listener(remaps["jax"].append)

    def state(kv):
        return (kv.blocks_free(), kv.blocks_in_use(), kv.shared_blocks(),
                kv.frag_blocks(), kv.can_allocate(4),
                {o: kv.owner_blocks(o) for o in ("a", "b", "c", "d")},
                {b: kv.block_refs(b) for b in range(12)})

    script = [
        lambda kv: kv.ensure_capacity("a", 13),            # 4 blocks
        lambda kv: kv.ensure_capacity("b", 6),
        lambda kv: kv.retain(kv.owner_blocks("a")[:2]),    # cache pins
        lambda kv: kv.free("a"),
        lambda kv: kv.adopt("c", [1, 2]),                  # shared prefix
        lambda kv: kv.ensure_capacity("c", 17),
        lambda kv: kv.fork_blocks("c", [0, 1, 4]),         # 0, 1 shared
        lambda kv: kv.release([1]),
        lambda kv: kv.ensure_capacity("d", 9),
        lambda kv: kv.free("b"),
        lambda kv: kv.defrag(),
        lambda kv: kv.truncate("c", 5),
    ]
    for step in script:
        got, want = step(pk), step(jk)
        assert got == want
        assert state(pk) == state(jk)
        _same_pages(pk, jk)
        assert pk.audit(None) == jk.audit(None)
    assert remaps["port"] == remaps["jax"] and remaps["port"][0]
    dead = next(b for b in range(1, 12) if pk.block_refs(b) == 0)
    for kv in (pk, jk):
        with pytest.raises(ValueError):
            kv.release([dead])                             # double free
        with pytest.raises(ValueError):
            kv.adopt("c", [1])                             # c holds blocks
    assert pk.audit(prefix_pins={}) == jk.audit(prefix_pins={})
    assert not pk.audit(prefix_pins={dead: 1})["ok"]       # a dead pin
    assert pk.geometry()["n_layers"] == jk.geometry()["n_layers"]


def test_fork_gives_a_private_copy_and_leaves_the_original():
    _, tm = _models()
    kv = PagedKVCache(tm, num_blocks=8, block_size=BS, max_blocks_per_seq=4)
    kv.ensure_capacity("a", 8)
    shared = kv.owner_blocks("a")
    kv.retain(shared)
    k0 = kv.pages()[0][0]
    k0[shared[1]] = 7.0
    kv.free("a")
    kv.adopt("b", shared)
    assert kv.fork_blocks("b", [1]) == [1]
    mine = kv.owner_blocks("b")[1]
    assert mine != shared[1] and kv.block_refs(shared[1]) == 1
    assert torch.equal(k0[mine], k0[shared[1]])
    k0[mine] = -1.0                     # the owner's write ...
    assert (k0[shared[1]] == 7.0).all()  # ... leaves the shared page
    assert kv.fork_blocks("b", [1]) == []   # already private
    kv.ensure_capacity("c", 16)                # the last free blocks
    with pytest.raises(KVCacheOOM):
        kv.fork_blocks("b", [0])
    assert kv.audit(prefix_pins={b: 1 for b in shared})["ok"]


def test_snapshot_is_a_copy_that_outlives_a_rewrite():
    _, tm = _models()
    kv = PagedKVCache(tm, num_blocks=6, block_size=BS, max_blocks_per_seq=4)
    kv.ensure_capacity("a", 8)
    ids = kv.owner_blocks("a")
    kv.pages()[1][1][ids] = 3.0
    got_ids, snap = kv.snapshot_blocks(ids)
    kv.free("a")
    kv.ensure_capacity("b", 8)
    assert kv.owner_blocks("b") == ids[::-1] or set(kv.owner_blocks(
        "b")) == set(ids)
    kv.pages()[1][1][ids] = -5.0
    assert got_ids == ids and (snap[1][1] == 3.0).all()
    with pytest.raises(ValueError):
        kv.snapshot_blocks([5])                            # dead block


# -- the prefix index against JAX's --------------------------------------------

def test_prefix_cache_side_by_side_with_jax():
    """The same insert / lookup / evict sequence through both packages'
    PrefixCache over their own ledgers: same chains, same evictions, same
    pins, leaf first and LRU."""
    jm, tm = _models()
    kw = dict(num_blocks=40, block_size=BS, max_blocks_per_seq=10)
    pk, jk = PagedKVCache(tm, **kw), JaxKV(jm, **kw)
    pp, jp = PrefixCache(pk), JaxPrefix(jk)
    rng = np.random.RandomState(3)
    root = rng.randint(1, V, 8).astype(np.int32)
    prompts = [_plus(rng, root, 8), _plus(rng, root, 12),
               rng.randint(1, V, 16).astype(np.int32), _plus(rng, root, 4)]

    def both(fn):
        a, b = fn(pk, pp, "p"), fn(jk, jp, "j")
        assert a == b
        assert pp.pinned_blocks() == jp.pinned_blocks()
        assert pk.audit(prefix_pins=pp.pinned_blocks()) \
            == jk.audit(prefix_pins=jp.pinned_blocks())
        for key in ("entries", "max_chain_blocks", "evictions",
                    "shared_blocks"):
            assert pp.stats()[key] == jp.stats()[key], key
        return a

    for i, p in enumerate(prompts):
        def reg(kv, pc, tag, p=p, i=i):
            kv.ensure_capacity((tag, i), p.size)
            return pc.insert(p, "v0", kv.owner_blocks((tag, i))[
                :p.size // BS])
        both(reg)
        both(lambda kv, pc, tag, i=i: kv.free((tag, i)))
    chains = [both(lambda kv, pc, tag, p=p: pc.lookup(p, "v0"))
              for p in prompts]
    assert [len(c) for c in chains] == [4, 5, 4, 3]
    assert both(lambda kv, pc, tag: pc.lookup(prompts[0], "v1")) == []
    assert both(lambda kv, pc, tag: pc.peek(prompts[1], "v0")) == 20
    # an adopter pins its chain: eviction skips it
    both(lambda kv, pc, tag: kv.adopt((tag, "r"), pc.lookup(prompts[1],
                                                            "v0")))
    assert both(lambda kv, pc, tag: pc.evict(3)) == 3
    assert both(lambda kv, pc, tag: pc.evict(100)) > 0
    assert both(lambda kv, pc, tag: pc.lookup(prompts[1], "v0"))
    both(lambda kv, pc, tag: kv.free((tag, "r")))
    pk.defrag()
    jk.defrag()
    assert pp.pinned_blocks() == jp.pinned_blocks()
    assert both(lambda kv, pc, tag: pc.clear()) > 0
    assert pk.blocks_in_use() == jk.blocks_in_use() == 0


# -- the scheduler -------------------------------------------------------------

def _workload(seed):
    rng = np.random.RandomState(seed)
    prefix = rng.randint(1, V, 16).astype(np.int32)       # 2 aligned chunks
    first = _plus(rng, prefix, 5)
    rest = [_plus(rng, prefix, n) for n in (3, 7, 9)]
    return prefix, first, rest


def _serve(sched, first, rest, n=8):
    """The registrant alone, then the others together."""
    out = [sched.submit(first, n).result(120)]
    return out + [f.result(120) for f in [sched.submit(p, n) for p in rest]]


def test_scheduler_prefix_hits_match_jax_scheduler():
    jm, tm = _models()
    _, first, rest = _workload(11)
    js = JaxScheduler(jm, **SCHED).start(warmup=False)
    try:
        want = _serve(js, first, rest)
        jst = js.stats()
    finally:
        js.shutdown()
    with DecodeScheduler(tm, **SCHED) as ts:
        got = _serve(ts, first, rest)
        st = ts.stats()
    checked = 0
    for p, g, w in zip([first] + rest, got, want):
        solo, margins = _solo(tm, p, 8)
        checked += _assert_agree(g, solo, margins)
        _assert_agree(g, w, margins)
    assert checked >= 16
    for key in ("prefix_hits", "prefix_misses", "prefix_reused_tokens",
                "prefix_cow_forks", "prefill_chunks"):
        assert st[key] == jst[key], key
    assert st["prefix_hits"] == 3 and st["prefix_reused_tokens"] == 48
    assert st["kv"]["blocks_in_use"] > 0          # the cache's pins
    assert ts.stats()["kv"]["blocks_in_use"] == 0
    assert ts.audit()["ok"] and decode_scheduler_threads_alive() == 0


def test_warm_solo_equals_cold_solo_bitwise():
    _, tm = _models()
    _, first, rest = _workload(12)
    with DecodeScheduler(tm, prefix_cache=False, **SCHED) as ts:
        cold = [ts.generate(p, 10, timeout=120) for p in [first] + rest]
        n_cold = ts.stats()["prefill_chunks"]
    with DecodeScheduler(tm, **SCHED) as ts:
        warm = [ts.generate(p, 10, timeout=120) for p in [first] + rest]
        st = ts.stats()
    for c, w in zip(cold, warm):
        np.testing.assert_array_equal(c, w)
    plans = [prefill_schedule(p.size, CHUNK) for p in [first] + rest]
    assert n_cold == sum(len(c) for c in plans)
    # the warm requests run only the chunks past the 16 cached tokens
    assert st["prefix_hits"] == 3 and st["prefill_chunks"] == len(
        plans[0]) + sum(len([c for c in q if c[0] >= 16]) for q in plans[1:])


def test_full_aligned_hit_reruns_last_chunk_with_cow():
    """A prompt that is exactly a cached aligned chain reruns its last
    chunk over copy-on-write forks: its tokens are the cold ones, and the
    shared pages it would have overwritten still serve the registrant
    and a third request unchanged."""
    jm, tm = _models()
    prefix, first, rest = _workload(13)
    with DecodeScheduler(tm, prefix_cache=False, **SCHED) as ts:
        cold = [ts.generate(p, 8, timeout=120)
                for p in (first, prefix, rest[0])]
    js = JaxScheduler(jm, **SCHED).start(warmup=False)
    try:
        jwant = [js.submit(p, 8).result(120)
                 for p in (first, prefix, rest[0], first)]
        jst = js.stats()
    finally:
        js.shutdown()
    with DecodeScheduler(tm, **SCHED) as ts:
        got = [ts.generate(p, 8, timeout=120)
               for p in (first, prefix, rest[0], first)]
        st = ts.stats()
    assert st["prefix_cow_forks"] >= 1
    assert st["prefix_cow_forks"] == jst["prefix_cow_forks"]
    for g, c in zip(got, cold + [cold[0]]):
        np.testing.assert_array_equal(g, c)
    for g, w, p in zip(got, jwant, (first, prefix, rest[0], first)):
        _assert_agree(g, w, _solo(tm, p, 8)[1])
    assert ts.audit()["ok"] and st["prefix_hits"] == 3


def test_defrag_then_warm_hit_bitwise():
    _, tm = _models()
    prefix, first, rest = _workload(14)
    rng = np.random.RandomState(15)
    churn = [rng.randint(1, V, n).astype(np.int32) for n in (11, 19, 6)]
    with DecodeScheduler(tm, prefix_cache=False, **SCHED) as ts:
        cold = ts.generate(rest[1], 8, timeout=120)
    # the entry cap evicts the oldest chains' leaves: holes below the
    # live blocks
    with DecodeScheduler(tm, prefix_cache_entries=10, **SCHED) as ts:
        for p in churn + [first]:
            ts.generate(p, 6, timeout=120)
        frag = ts.kv.frag_blocks()
        assert ts.defrag() == -1                   # deferred to a boundary
        t0 = time.monotonic()
        while ts.stats()["defrags"] == 0:
            assert time.monotonic() - t0 < 30
            time.sleep(0.005)
        assert frag > 0 and ts.kv.frag_blocks() == 0
        assert ts.cached_prefix_tokens(rest[1]) == 16
        warm = ts.generate(rest[1], 8, timeout=120)
        assert ts.stats()["prefix_hits"] == 1 and ts.audit()["ok"]
    np.testing.assert_array_equal(warm, cold)
    assert ts.stats()["kv"]["blocks_in_use"] == 0


def test_eviction_under_pressure_and_entry_cap():
    _, tm = _models()
    rng = np.random.RandomState(16)
    prompts = [rng.randint(1, V, 24).astype(np.int32) for _ in range(6)]
    # the pool holds two requests' worst case: every admission evicts
    with DecodeScheduler(tm, num_blocks=17, **SCHED) as ts:
        outs = [ts.generate(p, 8, timeout=120) for p in prompts]
        st = ts.stats()
        assert st["prefix"]["evictions"] > 0 and ts.audit()["ok"]
    with DecodeScheduler(tm, prefix_cache_entries=5, **SCHED) as ts:
        capped = [ts.generate(p, 8, timeout=120) for p in prompts]
        # the cap, past the chain of the request that was still holding
        # its blocks when it registered
        assert ts.stats()["prefix"]["entries"] <= 5 + 24 // BS
        assert ts.stats()["prefix"]["evictions"] > 0
    for a, b in zip(outs, capped):
        np.testing.assert_array_equal(a, b)
    assert ts.stats()["kv"]["blocks_in_use"] == 0
