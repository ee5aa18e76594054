"""The port's modules and TransformerLM against the JAX package.

Every input is made with numpy from a seed and fed to both sides; the JAX
parameters are carried into the port with ``bigdl_tpu_torch.convert``.
Tolerances, float32 on both sides:

* modules: atol = rtol = 1e-5 (same arithmetic, other summation order);
* whole-model logits: atol = rtol = 1e-4 (the per-layer differences add up
  over blocks, the tied projection and the softmax paths);
* greedy tokens are compared only up to the first step whose top-2 logit
  margin is under 1e-3, ten times the logits tolerance - past a near-tie
  either side may pick the other token legitimately.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.models.transformer_lm import TransformerLM as JaxLM
from bigdl_tpu.nn.attention import (Attention as JaxAttention,
                                    FeedForwardNetwork as JaxFFN,
                                    TransformerBlock as JaxBlock)
from bigdl_tpu.nn.norm import LayerNormalization as JaxLN
from bigdl_tpu_torch import convert, kernels
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.nn import (Attention, FeedForwardNetwork,
                                LayerNormalization, TransformerBlock)
from bigdl_tpu_torch.utils.amp import bf16_params

torch.set_num_threads(1)
MOD_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
MARGIN = 1e-3
V, H, MAXLEN = 48, 32, 64


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _port_tree(jax_params):
    return convert.unflatten(convert.jax_to_state_dict(_np(jax_params)))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _pair(seed=0, **kw):
    cfg = dict(vocab_size=V, hidden_size=H, num_heads=4, filter_size=64,
               num_layers=2, max_len=MAXLEN)
    cfg.update(kw)
    jm = JaxLM(**cfg)
    jp, _ = jm.init(jax.random.PRNGKey(seed))
    tm = TransformerLM(device="cpu", **cfg)
    tm.load_state_dict(convert.jax_to_state_dict(_np(jp)))
    return jm, jp, tm


def _ids(seed, B, T):
    return np.random.RandomState(seed).randint(1, V, (B, T)).astype(np.int32)


ARCHS = {
    "mha_sinusoidal": {},
    "gqa_rope": dict(num_kv_heads=2, pos_encoding="rope"),
    "gqa_swiglu": dict(num_kv_heads=1, ffn_activation="swiglu"),
}


# -- modules ----------------------------------------------------------------

def test_layer_norm_matches_and_uses_eps_1e6():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, H).astype(np.float32) * 1e-3  # eps matters here
    p = {"weight": rng.randn(H).astype(np.float32),
         "bias": rng.randn(H).astype(np.float32)}
    want, _ = JaxLN(H).apply(jax.tree_util.tree_map(jnp.asarray, p), {},
                             jnp.asarray(x))
    ln = LayerNormalization(H)
    assert ln.eps == 1e-6
    got = ln.call({k: _t(v) for k, v in p.items()}, _t(x))
    torch.testing.assert_close(got, _t(want), **MOD_TOL)


@pytest.mark.parametrize("kvh,rope,flash", [(None, False, True),
                                            (2, True, True),
                                            (2, False, False)])
def test_attention_matches(kvh, rope, flash):
    ja = JaxAttention(H, 4, causal=True, num_kv_heads=kvh, rope=rope,
                      use_flash=flash)
    jp, _ = ja.init(jax.random.PRNGKey(1))
    x = np.random.RandomState(1).randn(2, 9, H).astype(np.float32)
    want, _ = ja.apply(jp, {}, jnp.asarray(x))
    ta = Attention(H, 4, causal=True, num_kv_heads=kvh, rope=rope,
                   use_flash=flash)
    got = ta.call(_port_tree(jp), _t(x))
    torch.testing.assert_close(got, _t(want), **MOD_TOL)


@pytest.mark.parametrize("act", ["relu", "gelu", "swiglu"])
def test_ffn_matches(act):
    jf = JaxFFN(H, 64, activation=act)
    jp, _ = jf.init(jax.random.PRNGKey(2))
    jp = dict(jp, b1=jnp.full((64,), 0.1), b2=jnp.full((H,), -0.1))
    x = np.random.RandomState(2).randn(2, 5, H).astype(np.float32)
    want, _ = jf.apply(jp, {}, jnp.asarray(x))
    got = FeedForwardNetwork(H, 64, activation=act).call(_port_tree(jp),
                                                         _t(x))
    torch.testing.assert_close(got, _t(want), **MOD_TOL)


def test_block_matches_and_prefill_returns_compact_kv():
    jb = JaxBlock(H, 4, 64, causal=True, num_kv_heads=2, rope=True)
    jp, _ = jb.init(jax.random.PRNGKey(3))
    x = np.random.RandomState(3).randn(2, 7, H).astype(np.float32)
    want, _ = jb.apply(jp, {}, jnp.asarray(x))
    tb = TransformerBlock(H, 4, 64, causal=True, num_kv_heads=2, rope=True)
    tp = _port_tree(jp)
    torch.testing.assert_close(tb.call(tp, _t(x)), _t(want), **MOD_TOL)
    jh, (jk, jv) = jb.prefill(jp, jnp.asarray(x))
    h, (k, v) = tb.prefill(tp, _t(x))
    assert k.shape == (2, 2, 7, H // 4)
    torch.testing.assert_close(h, _t(jh), **MOD_TOL)
    torch.testing.assert_close(k, _t(jk), **MOD_TOL)
    torch.testing.assert_close(v, _t(jv), **MOD_TOL)


# -- the model --------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_logits_match(arch):
    jm, jp, tm = _pair(**ARCHS[arch])
    ids = _ids(4, 2, 13)
    want, _ = jm.apply(jp, {}, jnp.asarray(ids))
    torch.testing.assert_close(tm(ids), _t(want), **LOGIT_TOL)


def test_forward_logits_match_pallas_flash_interpret(monkeypatch):
    """The JAX side through its flash kernel (interpret mode) rather than
    its einsum fallback."""
    monkeypatch.setenv("BIGDL_TPU_FLASH", "interpret")
    jm, jp, tm = _pair(seed=1)
    ids = _ids(5, 1, 10)
    want, _ = jm.apply(jp, {}, jnp.asarray(ids))
    torch.testing.assert_close(tm(ids), _t(want), **LOGIT_TOL)


@pytest.mark.parametrize("arch", ["mha_sinusoidal", "gqa_rope"])
def test_prefill_chunked_decode_match(arch):
    jm, jp, tm = _pair(**ARCHS[arch])
    tp = tm.params
    ids = _ids(6, 2, 19)
    jl, jc = jm.prefill(jp, jnp.asarray(ids), MAXLEN)
    tl, tc = tm.prefill(tp, ids, MAXLEN)
    torch.testing.assert_close(tl, _t(jl), **LOGIT_TOL)
    for (jk, jv), (k, v) in zip(jc, tc):
        torch.testing.assert_close(k[:, :, :19], _t(jk[:, :, :19]),
                                   **MOD_TOL)
    # chunked: 8-wide pieces take the rectangular-causal flash path, the
    # 3-token tail the einsum path
    jl2, jc2 = jm.prefill_chunked(jp, jnp.asarray(ids), MAXLEN, chunk=8)
    tl2, tc2 = tm.prefill_chunked(tp, ids, MAXLEN, chunk=8)
    torch.testing.assert_close(tl2, _t(jl2), **LOGIT_TOL)
    torch.testing.assert_close(tl2, tl, **LOGIT_TOL)
    nxt = _ids(7, 2, 3)
    jd, jc2 = jm.decode_chunk(jp, jnp.asarray(nxt), 19, jc2)
    td, tc2 = tm.decode_chunk(tp, nxt, 19, tc2)
    torch.testing.assert_close(td, _t(jd), **LOGIT_TOL)
    j1, _ = jm.decode_one(jp, jnp.asarray(nxt[:, 0]), 22, jc2)
    t1, _ = tm.decode_one(tp, nxt[:, 0], 22, tc2)
    torch.testing.assert_close(t1, _t(j1), **LOGIT_TOL)


@pytest.mark.parametrize("arch", ["mha_sinusoidal", "gqa_rope"])
def test_decode_paged_matches_pallas_interpret(arch, monkeypatch):
    """Two rows at different depths over one scattered pool, plus a padded
    slot on the null table: a chunked prefill step (S=4) then a decode
    step (S=1), the JAX side through its Pallas paged kernel."""
    monkeypatch.setenv("BIGDL_TPU_PAGED_ATTN", "interpret")
    jm, jp, tm = _pair(**ARCHS[arch])
    tp = tm.params
    kvh = ARCHS[arch].get("num_kv_heads", 4)
    NB, bs, nblk = 12, 4, 5
    jpages = [(jnp.zeros((NB, kvh, bs, H // 4)),) * 2 for _ in range(2)]
    tpages = [(torch.zeros(NB, kvh, bs, H // 4),
               torch.zeros(NB, kvh, bs, H // 4)) for _ in range(2)]
    tables = np.array([[3, 7, 1, 0, 0], [9, 2, 5, 11, 0], [0] * nblk],
                      np.int32)
    pos = np.array([0, 6, 0], np.int32)
    for S, seed in ((4, 8), (1, 9)):
        toks = _ids(seed, 3, S)
        jl, jpages = jm.decode_paged(jp, jnp.asarray(toks), jnp.asarray(pos),
                                     jpages, jnp.asarray(tables))
        tl, tpages = tm.decode_paged(tp, toks, torch.from_numpy(pos),
                                     tpages, torch.from_numpy(tables))
        torch.testing.assert_close(tl[:2], _t(jl[:2]), **LOGIT_TOL)
        assert torch.isfinite(tl).all()
        pos = pos + S


def _greedy_steps_with_margin(tm, params, prompt, n):
    """Port-side solo greedy decode that also returns each step's top-2
    logit margin."""
    logits, caches = tm.prefill(params, prompt, MAXLEN)
    toks, margins = [], []
    pos = prompt.shape[1]
    for i in range(n):
        top = logits[0].topk(2).values
        margins.append(float(top[0] - top[1]))
        toks.append(int(logits[0].argmax()))
        if i < n - 1:
            logits, caches = tm.decode_one(params, [toks[-1]], pos, caches)
            pos += 1
    return np.array(toks), np.array(margins)


def _trusted(margins):
    """Steps up to (and including) the first near-tie."""
    low = np.nonzero(margins < MARGIN)[0]
    return len(margins) if low.size == 0 else int(low[0]) + 1


@pytest.mark.parametrize("arch", ["mha_sinusoidal", "gqa_rope"])
def test_greedy_generate_matches_jax(arch):
    jm, jp, tm = _pair(seed=2, **ARCHS[arch])
    tp = tm.params
    n = 10
    for row in range(2):
        prompt = _ids(10 + row, 1, 7 + 4 * row)
        want = np.asarray(jm.generate(jp, jnp.asarray(prompt), n))[0, -n:]
        got = tm.generate(tp, prompt, n)[0, -n:].numpy()
        solo, margins = _greedy_steps_with_margin(tm, tp, prompt, n)
        np.testing.assert_array_equal(got, solo)
        k = _trusted(margins)
        assert k >= 3, "fixture too close to a tie to say anything"
        np.testing.assert_array_equal(got[:k], want[:k])


def test_generate_eos_and_sampling():
    _, _, tm = _pair(seed=3)
    tp = tm.params
    prompt = _ids(12, 2, 5)
    greedy = tm.generate(tp, prompt, 8)
    eos = int(greedy[0, 5 + 2])          # row 0's third generated token
    out = tm.generate(tp, prompt, 8, eos_id=eos)
    row = out[0, 5:].tolist()
    cut = row.index(eos)
    assert cut <= 2 and all(t == 0 for t in row[cut + 1:])
    g = lambda: torch.Generator().manual_seed(5)
    a = tm.generate(tp, prompt, 8, temperature=0.8, top_k=10, top_p=0.9,
                    generator=g())
    b = tm.generate(tp, prompt, 8, temperature=0.8, top_k=10, top_p=0.9,
                    generator=g())
    assert torch.equal(a, b)
    # a nucleus that keeps only the top token is greedy
    c = tm.generate(tp, prompt, 8, temperature=1.0, top_p=1e-6,
                    generator=g())
    assert torch.equal(c, greedy)


def test_bf16_params_cast_and_run():
    _, _, tm = _pair(seed=4)
    p16 = bf16_params(tm.params)
    assert p16["block0"]["attn"]["wq"].dtype == torch.bfloat16
    assert tm.params["block0"]["attn"]["wq"].dtype == torch.float32
    out = tm.generate(p16, _ids(13, 2, 9), 4)
    assert out.shape == (2, 13)


def test_convert_state_dict_round_trip_and_facade():
    jm, jp, tm = _pair(seed=5, ffn_activation="swiglu")
    sd = convert.jax_to_state_dict(_np(jp))
    assert set(sd) == set(tm.state_dict())
    assert "block1.ffn.w3" in sd and "ln_f.weight" in sd
    flat = convert.flatten(tm.params)
    for name, t in sd.items():
        assert torch.equal(flat[name].detach(), t)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           convert.to_numpy_tree(tm.params), _np(jp))
    assert tm.evaluate() is tm and not tm.training
    assert tm.training() is tm and tm.training
    kernels.reset_launch_counts()
    tm(_ids(14, 1, 8))
    assert set(kernels.launch_counts().values()) == {0}
