"""The port's speculative decoding: ``nn.speculative`` (``batched_acceptance``,
``speculative_generate`` greedy and by rejection sampling) and the
scheduler's batched speculative rounds, held against the JAX package's.

Greedy tokens against JAX's are compared up to and including the first
step whose top-2 logit margin, on the port's own dense decode, is under
1e-3 (the two frameworks agree on logits to about 1e-6 in float32 here).
The port's speculative output against its own ``generate`` is held
bitwise. The sampling mode's marginal is held to the enumerated target
marginal within 4 binomial sigma + 1e-3, as ``tests/test_speculative.py``
holds JAX's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.models.transformer_lm import TransformerLM as JaxLM
from bigdl_tpu.nn.speculative import batched_acceptance as jax_acceptance
from bigdl_tpu.nn.speculative import speculative_generate as jax_spec
from bigdl_tpu.serving import DecodeScheduler as JaxScheduler
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.nn import SpecStats, speculative_generate
from bigdl_tpu_torch.nn.speculative import batched_acceptance
from bigdl_tpu_torch.serving import (DecodeScheduler,
                                     decode_scheduler_threads_alive)

torch.set_num_threads(1)
V, H, MAXLEN, CHUNK = 48, 32, 128, 8
MARGIN = 1e-3
CFG = dict(vocab_size=V, hidden_size=H, num_heads=4, filter_size=64,
           num_layers=2, max_len=MAXLEN, num_kv_heads=2, pos_encoding="rope")
SCHED = dict(max_slots=4, block_size=4, max_seq_len=96, prefill_chunk=CHUNK)

_shared = {}


def _pair(layers, seed):
    """(JAX model with params, port model with the same weights)."""
    key = (layers, seed)
    if key not in _shared:
        cfg = dict(CFG, num_layers=layers)
        jm = JaxLM(**cfg)
        jp, _ = jm.init(jax.random.PRNGKey(seed))
        jm.params, jm.state = jp, {}
        tm = TransformerLM(device="cpu", **cfg)
        tm.load_state_dict(convert.jax_to_state_dict(
            jax.tree_util.tree_map(np.asarray, jp)))
        _shared[key] = (jm, tm)
    return _shared[key]


def _target():
    return _pair(2, 0)


def _draft():
    return _pair(1, 1)


def _margins(tm, ids, tp):
    """Top-2 margins of the port's full forward at every generated
    position of ``ids`` (B, tp + n): (B, n)."""
    with torch.no_grad():
        lg = tm.call(tm.params, torch.as_tensor(ids[:, :-1]))[:, tp - 1:]
    top = lg.topk(2, dim=-1).values
    return (top[..., 0] - top[..., 1]).numpy()


def _assert_agree(got, want, margins):
    low = np.nonzero(margins < MARGIN)[0]
    k = len(margins) if low.size == 0 else int(low[0]) + 1
    np.testing.assert_array_equal(np.asarray(got)[:k], np.asarray(want)[:k])
    return k


# -- batched_acceptance ---------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_batched_acceptance_equals_jax(seed):
    rng = np.random.RandomState(seed)
    B, k = 8, 4
    choices = rng.randint(0, 5, (B, k + 1)).astype(np.int32)
    drafts = choices[:, :k].copy()
    for b in range(B):              # diverge at a per-row position (or not)
        cut = rng.randint(0, k + 1)
        if cut < k:
            drafts[b, cut] = (drafts[b, cut] + 1 + rng.randint(3)) % 5
    elig = rng.rand(B) > 0.25
    j, emit = batched_acceptance(torch.from_numpy(drafts),
                                 torch.from_numpy(choices),
                                 torch.from_numpy(elig))
    jj, je = jax_acceptance(jnp.asarray(drafts), jnp.asarray(choices),
                            jnp.asarray(elig))
    np.testing.assert_array_equal(j.numpy(), np.asarray(jj))
    np.testing.assert_array_equal(emit.numpy(), np.asarray(je))
    assert j.dtype == emit.dtype == torch.int32


# -- speculative_generate -------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3])
def test_greedy_equals_generate_bitwise_and_jax_up_to_a_near_tie(k):
    jm, tm = _target()
    jd, td = _draft()
    ids = np.random.RandomState(k).randint(1, V, (2, 7)).astype(np.int32)
    want = tm.generate(tm.params, ids, 12).numpy()
    got, st = speculative_generate(tm, tm.params, td, td.params, ids, 12, k,
                                   return_stats=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert isinstance(st, SpecStats) and int(st.rounds) >= 1
    assert int(st.drafted) == k * int(st.rounds)
    jgot = np.asarray(jax_spec(jm, jm.params, jd, jd.params, ids, 12, k=k))
    margins = _margins(tm, want, 7)
    checked = sum(_assert_agree(g[7:], w[7:], m)
                  for g, w, m in zip(got.numpy(), jgot, margins))
    assert checked >= 12


def test_self_draft_accepts_everything_and_rejects_bad_arguments():
    _, tm = _target()
    ids = np.random.RandomState(5).randint(1, V, (2, 5)).astype(np.int32)
    got, st = speculative_generate(tm, tm.params, tm, tm.params, ids, 10, 3,
                                   return_stats=True)
    np.testing.assert_array_equal(got.numpy(),
                                  tm.generate(tm.params, ids, 10).numpy())
    assert int(st.accepted) == int(st.drafted)
    g = torch.Generator().manual_seed(1)
    got, st = speculative_generate(tm, tm.params, tm, tm.params, ids, 10, 3,
                                   temperature=0.8, generator=g,
                                   return_stats=True)
    assert got.shape == (2, 15) and ((got >= 0) & (got < V)).all()
    assert int(st.accepted) >= 0.9 * int(st.drafted)
    other = TransformerLM(device="cpu", **dict(CFG, vocab_size=V + 1))
    with pytest.raises(ValueError):
        speculative_generate(tm, tm.params, other, other.params, ids, 4)
    with pytest.raises(ValueError):
        speculative_generate(tm, tm.params, tm, tm.params, ids, MAXLEN, 3)


def test_sampling_preserves_the_target_marginal():
    """The second generated token's empirical distribution over 512 rows
    x 4 generators, with a draft that disagrees with the target, against
    its enumerated marginal sum_t1 p(t1) p(t2 | t1) at V = 9."""
    Vs = 9
    cfg = dict(vocab_size=Vs, hidden_size=16, num_heads=2, filter_size=32,
               max_len=32, device="cpu")
    tm = TransformerLM(num_layers=2, seed=21, **cfg)
    td = TransformerLM(num_layers=1, seed=22, **cfg)
    prompt = np.random.RandomState(23).randint(0, Vs, (1, 4))
    ids = np.tile(prompt, (512, 1))
    samples = np.concatenate([
        speculative_generate(tm, tm.params, td, td.params, ids, 2, 2,
                             temperature=1.0,
                             generator=torch.Generator().manual_seed(s)
                             ).numpy()[:, 5] for s in range(4)])
    emp = np.bincount(samples, minlength=Vs) / samples.size
    with torch.no_grad():
        p1 = torch.softmax(tm.call(tm.params, prompt)[0, -1], -1).numpy()
        ext = np.concatenate([np.tile(prompt, (Vs, 1)),
                              np.arange(Vs)[:, None]], 1)
        p2 = torch.softmax(tm.call(tm.params, ext)[:, -1], -1).numpy()
    marg = (p1[:, None] * p2).sum(0)
    tol = 4 * np.sqrt(marg * (1 - marg) / samples.size) + 1e-3
    assert (np.abs(emp - marg) < tol).all(), np.stack([emp, marg, tol])


# -- the scheduler's batched rounds ---------------------------------------------

def _prompts(seed, n=5):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, V, rng.randint(3, 20)).astype(np.int32)
            for _ in range(n)]


def test_scheduler_with_draft_matches_jax_and_the_plain_port():
    jm, tm = _target()
    jd, td = _draft()
    prompts = _prompts(31)
    budgets = [9, 6, 11, 7, 8]
    kw = dict(SCHED, spec_k=3)
    js = JaxScheduler(jm, draft_model=jd, **kw).start(warmup=False)
    try:
        want = [f.result(120) for f in [js.submit(p, n) for p, n in
                                        zip(prompts, budgets)]]
    finally:
        js.shutdown()
    with DecodeScheduler(tm, **SCHED) as ts:
        plain = [f.result(120) for f in [ts.submit(p, n) for p, n in
                                         zip(prompts, budgets)]]
    with DecodeScheduler(tm, draft_model=td, **kw) as ts:
        got = [f.result(120) for f in [ts.submit(p, n) for p, n in
                                       zip(prompts, budgets)]]
        st = ts.stats()
        assert ts.audit()["ok"]
    checked = 0
    for p, g, w, q in zip(prompts, got, want, plain):
        ids = np.concatenate([p, g])[None]
        m = _margins(tm, ids, p.size)[0]
        checked += _assert_agree(g, w, m)
        _assert_agree(g, q, m)
    assert checked >= 25
    assert st["spec_rounds"] > 0 and st["spec_row_rounds"] >= st[
        "spec_rounds"]
    assert ts.stats()["kv"]["blocks_in_use"] == 0
    assert ts.draft_kv.stats()["blocks_in_use"] == 0
    assert decode_scheduler_threads_alive() == 0


def test_contrived_draft_is_accepted_and_sampled_rows_ride_the_verify():
    """A target whose deeper block adds exactly zero to the residual (the
    draft's weights for the rest) accepts nearly every proposal; a
    sampled request rides the same rounds with its plain sampled tokens;
    a sampled-majority group takes the plain step."""
    _, td = _draft()
    tm = TransformerLM(device="cpu", **CFG)
    p = {k: v.clone() for k, v in tm.state_dict().items()}
    for k, v in td.state_dict().items():
        p[k] = v.clone()
    for k in ("block1.attn.wo", "block1.ffn.w2", "block1.ffn.b2"):
        p[k].zero_()
    tm.load_state_dict(p)
    prompts = _prompts(32, 4)
    kw = dict(SCHED, spec_k=3)
    samp = dict(temperature=0.9, top_p=0.9, seed=77)
    with DecodeScheduler(tm, **SCHED) as ts:
        plain = [ts.submit(q, 10) for q in prompts]
        plain_s = ts.submit(prompts[0], 10, **samp)
        plain = [f.result(120) for f in plain] + [plain_s.result(120)]
    with DecodeScheduler(tm, draft_model=td, **kw) as ts:
        futs = [ts.submit(q, 10) for q in prompts[:3]]
        futs.append(ts.submit(prompts[0], 10, **samp))
        got = [f.result(120) for f in futs]
        st = ts.stats()
        fall = [ts.submit(q, 6, temperature=1.0, seed=i)
                for i, q in enumerate(prompts[:3])] + [
            ts.submit(prompts[3], 6)]
        [f.result(120) for f in fall]
        assert ts.stats()["spec_fallbacks"] > st["spec_fallbacks"]
    for g, q in zip(got[:3], plain[:3]):
        np.testing.assert_array_equal(g, q)
    np.testing.assert_array_equal(got[3], plain[4])
    assert st["spec_accepted"] >= 0.9 * 3 * st["spec_row_rounds"]


def test_warm_hit_speculates_after_the_draft_catches_up():
    _, tm = _target()
    _, td = _draft()
    rng = np.random.RandomState(33)
    prefix = rng.randint(1, V, 16).astype(np.int32)
    a = np.concatenate([prefix, rng.randint(1, V, 5).astype(np.int32)])
    b = np.concatenate([prefix, rng.randint(1, V, 3).astype(np.int32)])
    with DecodeScheduler(tm, prefix_cache=False, **SCHED) as ts:
        cold = ts.generate(b, 12, timeout=120)
    with DecodeScheduler(tm, draft_model=td, spec_k=3, **SCHED) as ts:
        ts.generate(a, 6, timeout=120)
        before = ts.stats()["spec_row_rounds"]
        fut = ts.submit(b, 12)
        warm = fut.result(120)
        st = ts.stats()
    assert st["prefix_hits"] == 1 and fut.trace["prefix_hit_tokens"] == 16
    assert fut.trace["spec_rounds"] > 0 and st["spec_row_rounds"] > before
    ids = np.concatenate([b, cold])[None]
    _assert_agree(warm, cold, _margins(tm, ids, b.size)[0])
