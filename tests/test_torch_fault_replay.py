"""The port's DecodeScheduler control plane against the JAX package's:
step replay under chaos, replay after a fault injected past the page
write, the audit's quarantine, the stall watchdog and loop death.

Drills submit every request before ``start()``, so both schedulers see
the same arrivals at the same boundary and their ``stats()`` agree key
for key. Tokens are held against JAX up to the first step whose top-2
margin (the port's own full forward) is under 1e-3 (the frameworks agree
on logits to ~1e-6 in float32), and bit for bit against the port's own
fault-free run, with the K / V pages of every chain the prefix cache
holds.

The port's pages are written in place where JAX's are immutable handles:
a replayed unit restores only the rows' counters. The post-write fault
(raised from ``_forward`` after it returned, so the pages already hold
the step's K / V) shows the replay rewrites the same values at the same
places, copy-on-write forks of a fully cached prompt and a warm hit's
draft catch-up included.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

import jax

from bigdl_tpu import observability as jobs
from bigdl_tpu.models.transformer_lm import TransformerLM as JaxLM
from bigdl_tpu.observability import health as jhealth
from bigdl_tpu.parallel import chaos as jchaos
from bigdl_tpu.parallel.failure import FaultPolicy as JaxFaultPolicy
from bigdl_tpu.serving import DecodeScheduler as JaxScheduler
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import observability as obs
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.observability import flight, health
from bigdl_tpu_torch.parallel import chaos
from bigdl_tpu_torch.parallel.failure import (FaultPolicy,
                                              TransientDeviceError)
from bigdl_tpu_torch.serving import (DecodeScheduler, EngineStopped,
                                     decode_scheduler_threads_alive)
from bigdl_tpu_torch.serving.decode_scheduler import _STAT_KEYS

torch.set_num_threads(1)
V, H, MAXLEN, CHUNK = 48, 32, 128, 8
MARGIN = 1e-3
CFG = dict(vocab_size=V, hidden_size=H, num_heads=4, filter_size=64,
           max_len=MAXLEN, num_kv_heads=2, pos_encoding="rope")
SCHED = dict(max_slots=4, block_size=4, max_seq_len=96, prefill_chunk=CHUNK)
PLAN = {"sites": {
    "serving/scheduler_step": [{"kind": "transient", "every": 3,
                                "max_fires": 3}],
    "serving/prefill": [{"kind": "transient", "nth": 2}]}}

_shared = {}


def _reset_both():
    for ch, h, o in ((chaos, health, obs), (jchaos, jhealth, jobs)):
        ch.disarm()
        h.reset()
        o.registry().reset()
        o.reset()
        o.disable()
    flight.reset()


@pytest.fixture(autouse=True)
def _clean():
    # both packages' process globals, before (other test files of this
    # worker leave theirs) and after each test
    _reset_both()
    yield
    _reset_both()


def _pair(layers, seed):
    """(JAX model with params, port model with the same weights)."""
    if (layers, seed) not in _shared:
        cfg = dict(CFG, num_layers=layers)
        jm = JaxLM(**cfg)
        jp, _ = jm.init(jax.random.PRNGKey(seed))
        jm.params, jm.state = jp, {}
        tm = TransformerLM(device="cpu", **cfg)
        tm.load_state_dict(convert.jax_to_state_dict(
            jax.tree_util.tree_map(np.asarray, jp)))
        _shared[(layers, seed)] = (jm, tm)
    return _shared[(layers, seed)]


def _prompts(n, seed, lo=3, hi=21):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, V, rng.randint(lo, hi)).astype(np.int32)
            for _ in range(n)]


def _margins(tm, prompt, toks):
    ids = np.concatenate([prompt, toks])[None]
    with torch.no_grad():
        lg = tm.call(tm.params, torch.as_tensor(ids[:, :-1]))
    top = lg[0, prompt.size - 1:].topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]).numpy()


def _assert_agree(got, want, margins):
    low = np.nonzero(margins < MARGIN)[0]
    k = len(margins) if low.size == 0 else int(low[0]) + 1
    np.testing.assert_array_equal(np.asarray(got)[:k], np.asarray(want)[:k])
    return k


def _chains(sched, prompts):
    """The K / V pages (numpy, per layer) of every chain the prefix cache
    holds for ``prompts``, in chain order."""
    out = []
    for p in prompts:
        blocks = sched.prefix._walk(p, "v0", touch=False)[0]
        idx = torch.as_tensor(blocks, dtype=torch.long)
        out.append([(k[idx].numpy().copy(), v[idx].numpy().copy())
                    for k, v in sched.kv.pages()])
    return out


def _fault_after_write(sched, calls):
    """Raise a transient fault from ``_forward`` AFTER it returned (the
    step's K / V are in the pages) on the given call numbers."""
    orig = sched._forward
    n = [0]

    def forward(*a):
        out = orig(*a)
        n[0] += 1
        if n[0] in calls:
            raise TransientDeviceError(f"injected after the write, call "
                                       f"{n[0]}")
        return out
    sched._forward = forward
    return n


def _drill(pkg, prompts, budgets, plan=None, waves=1, faults=(), **kw):
    """Serve ``prompts`` (all submitted before ``start``) ``waves`` times
    in a row through one package's scheduler; ``faults`` are the
    ``_forward`` call numbers of the LAST wave that raise after the
    write. Returns (tokens, stats, chains (port only), chaos stats)."""
    port = pkg == "port"
    ch = chaos if port else jchaos
    jm, tm = _pair(2, 0)
    if kw.get("draft_model") == "draft":
        kw["draft_model"] = _pair(1, 1)[1 if port else 0]
    if "fault_policy" not in kw:
        kw["fault_policy"] = (FaultPolicy if port else JaxFaultPolicy)(
            max_restarts=2, backoff_base_s=0.0)
    if plan is not None:
        ch.arm(plan)
    s = (DecodeScheduler if port else JaxScheduler)(tm if port else jm,
                                                    **SCHED, **kw)
    calls = _fault_after_write(s, faults) if faults else [0]
    out = []
    try:
        for w in range(waves):
            # count the last wave's calls from 1; earlier waves run clean
            calls[0] = 0 if w == waves - 1 else -10 ** 9
            futs = [s.submit(p, n) for p, n in zip(prompts, budgets)]
            if w == 0:
                s.start(warmup=False)
            out += [np.asarray(f.result(120)) for f in futs]
        st = s.stats()
        chains = _chains(s, prompts) if port else None
        fired = ch.stats()
    finally:
        s.shutdown()
        ch.disarm()
    assert s.stats()["kv"]["blocks_in_use"] == 0
    return out, st, chains, fired


def _same_chains(a, b):
    assert len(a) == len(b)
    blocks = 0
    for ca, cb in zip(a, b):
        assert len(ca) == len(cb)
        for (ka, va), (kb, vb) in zip(ca, cb):
            blocks += ka.shape[0]
            np.testing.assert_array_equal(ka, kb)
            np.testing.assert_array_equal(va, vb)
    assert blocks > 0, "no chain to compare"


def test_chaos_replay_matches_jax_and_the_fault_free_run():
    """Transient faults at ``serving/prefill`` and ``serving/scheduler_step``
    replay in both packages: every stats key equal, ``step_replays`` equal
    to the chaos fire count, tokens as JAX's and bit for bit the
    fault-free run's, chains bit for bit, and the exported metrics text
    names the same ``serve/`` series."""
    prompts = _prompts(4, seed=41)
    budgets = [8, 6, 7, 9]
    _, tm = _pair(2, 0)
    clean, _, clean_chains, _ = _drill("port", prompts, budgets)
    obs.enable()
    jobs.enable()
    got, st, chains, fired = _drill("port", prompts, budgets, plan=PLAN)
    want, jst, _, jfired = _drill("jax", prompts, budgets, plan=PLAN)
    assert fired["fires"] == jfired["fires"] == 4
    assert st["step_replays"] == fired["fires"]
    assert {k: st[k] for k in _STAT_KEYS} == {k: jst[k] for k in _STAT_KEYS}
    assert set(st) == set(jst)
    checked = 0
    for p, g, w, c in zip(prompts, got, want, clean):
        np.testing.assert_array_equal(g, c)
        checked += _assert_agree(g, w, _margins(tm, p, g))
    assert checked >= 20
    _same_chains(chains, clean_chains)

    def series(text):
        return {ln.split()[2] for ln in text.splitlines()
                if ln.startswith("# TYPE bigdl_serve_")}
    ours = series(obs.prometheus_text())
    assert "bigdl_serve_step_replays" in ours
    assert "bigdl_serve_ttft_ms" in ours and "bigdl_serve_kv_allocs" in ours
    assert ours == series(jobs.prometheus_text())


@pytest.mark.parametrize("faults", [(1,), (2, 5, 9), (3, 4, 12, 13)],
                         ids=["first_prefill", "mixed", "back_to_back"])
def test_fault_after_the_page_write_replays_bitwise(faults):
    prompts = _prompts(3, seed=42)
    budgets = [7, 9, 6]
    clean, _, clean_chains, _ = _drill("port", prompts, budgets)
    got, st, chains, _ = _drill("port", prompts, budgets, faults=faults)
    assert st["step_replays"] == len(faults)
    for g, c in zip(got, clean):
        np.testing.assert_array_equal(g, c)
    _same_chains(chains, clean_chains)


def test_cow_fork_and_draft_catchup_replay_bitwise():
    """A fully cached aligned prompt reruns its last chunk into blocks
    forked at admission (before the unit's snapshot); with a draft, the
    warm hit's draft catches up inside the speculative round (the
    snapshot restores ``draft_pos``). Faults after the writes of the
    second wave's rerun chunk, catch-up and verify replay bit for bit;
    both runs fork and hit alike."""
    prompts = [_prompts(1, seed=43, lo=16, hi=17)[0]]     # hit_align 8
    kw = dict(draft_model="draft", spec_k=2, waves=2)
    clean, cst, clean_chains, _ = _drill("port", prompts, [9], **kw)
    # the second wave's forwards: 1 the rerun chunk; then the first round:
    # 2, 3 the draft catch-up, 4-6 the draft steps, 7 the verify. Call 1
    # and 3 fail; the round's replay starts at 4, so 9 is its verify
    faults = (1, 3, 9)
    got, st, chains, _ = _drill("port", prompts, [9], faults=faults, **kw)
    assert st["prefix_hits"] == cst["prefix_hits"] == 1
    assert st["prefix_cow_forks"] == cst["prefix_cow_forks"] >= 1
    assert st["step_replays"] == len(faults)
    for g, c in zip(got, clean):
        np.testing.assert_array_equal(g, c)
    _same_chains(chains, clean_chains)


def test_spec_round_replay_matches_jax():
    prompts = _prompts(3, seed=44)
    budgets = [9, 7, 8]
    plan = {"sites": {"serving/spec_round": [
        {"kind": "transient", "every": 2, "max_fires": 2}]}}
    _, tm = _pair(2, 0)
    kw = dict(draft_model="draft", spec_k=2)
    clean, _, clean_chains, _ = _drill("port", prompts, budgets, **kw)
    got, st, chains, fired = _drill("port", prompts, budgets, plan=plan,
                                    **kw)
    want, jst, _, _ = _drill("jax", prompts, budgets, plan=plan, **kw)
    assert st["step_replays"] == fired["fires"] == 2
    assert {k: st[k] for k in _STAT_KEYS} == {k: jst[k] for k in _STAT_KEYS}
    for p, g, w, c in zip(prompts, got, want, clean):
        np.testing.assert_array_equal(g, c)
        _assert_agree(g, w, _margins(tm, p, g))
    _same_chains(chains, clean_chains)


def test_admission_transient_defers_like_jax():
    """A transient fault in the admission transaction (the copy-on-write
    fork of a fully cached prompt) unwinds it; the next boundary admits."""
    p = _prompts(1, seed=45, lo=16, hi=17)
    plan = {"sites": {"kv/cow_fork": [{"kind": "transient", "nth": 1}]}}
    got, st, _, fired = _drill("port", p, [6], plan=plan, waves=2)
    want, jst, _, _ = _drill("jax", p, [6], plan=plan, waves=2)
    assert fired["by_site"] == {"kv/cow_fork": 1}
    assert st["prefix_hits"] == 1 and st["prefix_cow_forks"] >= 1
    assert {k: st[k] for k in _STAT_KEYS} == {k: jst[k] for k in _STAT_KEYS}
    np.testing.assert_array_equal(got[0], got[1])


def _corrupt(sched):
    """A phantom reference on a free block (the one popped last)."""
    with sched.kv._lock:
        b = sched.kv._free[0]
        sched.kv._refs[b] = 1
    return b


def test_audit_quarantines_like_jax(tmp_path, monkeypatch):
    """A refcount corrupted before the first boundary: the cadence audit
    (``audit_every=1``) quarantines in both packages with one
    ``kv_corruption`` event and one crash bundle; requests still finish,
    and a repeat of a cached prompt adopts no prefix."""
    monkeypatch.setenv("BIGDL_TPU_FLIGHT_DIR", str(tmp_path))
    prompts = _prompts(2, seed=46, lo=16, hi=24)
    res = {}
    for pkg, (Sched, model, o, h) in {
            "port": (DecodeScheduler, _pair(2, 0)[1], obs, health),
            "jax": (JaxScheduler, _pair(2, 0)[0], jobs, jhealth)}.items():
        o.enable()
        events = []
        s = Sched(model, audit_every=1, **SCHED)
        phantom = _corrupt(s)
        with h.listen(events.append):
            futs = [s.submit(p, 6) for p in prompts]
            s.start(warmup=False)
            first = [np.asarray(f.result(120)) for f in futs]
            again = s.submit(prompts[0], 6)
            np.testing.assert_array_equal(again.result(120), first[0])
            assert again.trace["prefix_hit_tokens"] == 0
            assert s.cached_prefix_tokens(prompts[0]) == 0
            st = s.stats()
        with s.kv._lock:
            s.kv._refs.pop(phantom)
        s.shutdown()
        kinds = [e["kind"] for e in events]
        assert kinds.count("health/kv_corruption") == 1, kinds
        res[pkg] = {k: st[k] for k in _STAT_KEYS + ("quarantined",)}
        o.disable()
    assert res["port"] == res["jax"]
    assert res["port"]["quarantined"] and res["port"]["kv_corruptions"] == 1
    assert res["port"]["prefix_hits"] == 0
    bundles = [n for n in os.listdir(tmp_path) if n.startswith("flight_")]
    assert len(bundles) == 2                   # one a package
    assert decode_scheduler_threads_alive() == 0


def test_stall_watchdog_fires_and_recovers():
    """A 3 s wedge at a decode step silences the loop's beacon
    (``stall_deadline_s=0.5``): ``health/stall`` names the replica's
    beacon, ``health/stall_recovered`` follows, and the request still
    finishes with the fault-free tokens."""
    obs.enable()
    _, tm = _pair(2, 0)
    p = _prompts(1, seed=47)[0]
    with DecodeScheduler(tm, **SCHED) as s:
        want = s.generate(p, 6, timeout=120)
    events = []
    chaos.arm({"sites": {"serving/scheduler_step": [
        {"kind": "wedge", "nth": 2, "wedge_s": 3.0, "tag": "r1"}]}})
    s = DecodeScheduler(tm, name="r1", stall_deadline_s=0.5, **SCHED)
    assert s.beacon_name == "serving/decode_scheduler[r1]"
    with health.listen(events.append):
        s.start(warmup=False)
        got = s.generate(p, 6, timeout=120)

        def seen(kind):
            return any(e["kind"] == kind and e["component"] == s.beacon_name
                       for e in events)
        t_end = time.monotonic() + 30
        while time.monotonic() < t_end and not seen(
                "health/stall_recovered"):
            time.sleep(0.05)
        s.shutdown()
    assert seen("health/stall") and seen("health/stall_recovered")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("error", [
    "chaos", "RuntimeError('paged_attention kernel launch failed "
    "(f32_split): CUDA error 700')"], ids=["permanent_chaos", "cuda_error"])
def test_permanent_fault_dies_with_triage_and_never_replays(
        error, tmp_path, monkeypatch):
    """A PERMANENT fault (chaos's, or a CUDA runtime error from the step)
    is not replayed: the loop dies with a crash bundle carrying per-request
    triage, and the request fails typed with its tokens so far."""
    monkeypatch.setenv("BIGDL_TPU_FLIGHT_DIR", str(tmp_path))
    obs.enable()
    _, tm = _pair(2, 0)
    p = _prompts(1, seed=48)[0]
    with DecodeScheduler(tm, **SCHED) as s:
        want = s.generate(p, 12, timeout=120)
    s = DecodeScheduler(tm, **SCHED)
    if error == "chaos":
        chaos.arm({"sites": {"serving/scheduler_step": [
            {"kind": "permanent", "nth": 3}]}})
    else:
        orig, n = s._dispatch, [0]

        def dispatch(*a):
            n[0] += 1
            if n[0] == 3:
                raise eval(error)
            return orig(*a)
        s._dispatch = dispatch
    s.start(warmup=False)
    exc = s.submit(p, 12).exception(timeout=120)
    assert isinstance(exc, EngineStopped)
    np.testing.assert_array_equal(exc.partial, want[:exc.partial.size])
    assert exc.partial.size == 3
    s.shutdown()
    assert s.stats()["step_replays"] == 0
    assert s.stats()["kv"]["blocks_in_use"] == 0
    bundle = [n for n in os.listdir(tmp_path) if n.startswith("flight_")]
    with open(tmp_path / bundle[0]) as f:
        b = json.load(f)
    assert b["context"]["failure_class"] == "permanent"
    assert [(r["stage"], r["tokens"]) for r in b["context"]["requests"]] \
        == [("decode", 3)]
    assert decode_scheduler_threads_alive() == 0
