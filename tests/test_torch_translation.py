"""The port's encoder-decoder Transformer (``mode='translation'``) and the
masked path's dtypes against the JAX package.

Every input is made with numpy from a seed and fed to both sides; the JAX
parameters are carried into the port with ``bigdl_tpu_torch.convert``.
Tolerances, float32 on both sides unless stated:

* modules (attention, blocks, cross K/V, one decode step): atol = rtol =
  1e-5 (the same arithmetic in another summation order);
* whole-model logits and the gradient of every parameter: atol = rtol =
  1e-4 (the per-layer differences add up over the encoder, the decoder,
  the tied projection and the softmax);
* greedy ``translate`` tokens are compared up to the first step whose
  top-2 logit margin is under 1e-3, ten times the logits tolerance;
* bf16 parameters (C.5): output dtypes exactly; values within 3e-2 of the
  largest logit. bf16 keeps 8 significant bits (2^-8 = 0.4%) and the JAX
  package rounds the first attention's logits and every bf16 product to
  bf16 where the port accumulates in float32, over two blocks.

The weights are redrawn as 0.3 * N(0, 1) (every leaf, the LayerNorms
too): a freshly initialised model's 0.02-scale embedding gives near-equal
logits, whose greedy tokens say nothing.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.models.transformer_lm import TransformerLM as JaxLM
from bigdl_tpu.nn.attention import (Attention as JaxAttention,
                                    Transformer as JaxTransformer,
                                    TransformerBlock as JaxBlock,
                                    causal_mask as jax_causal_mask,
                                    dot_product_attention as jax_dpa,
                                    padding_mask as jax_padding_mask)
from bigdl_tpu.utils.table import Table as JaxTable
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.nn import (Attention, Transformer, TransformerBlock,
                                causal_mask, dot_product_attention,
                                padding_mask)
from bigdl_tpu_torch.utils.amp import bf16_params
from bigdl_tpu_torch.utils.table import T, Table

torch.set_num_threads(1)
MOD_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
MARGIN = 1e-3
BF16_REL = 3e-2
V, H, HEADS, FILTER, MAXLEN = 29, 16, 2, 32, 32


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _redraw(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (0.3 * rng.randn(*a.shape)).astype(np.float32), tree)


def _port_tree(jax_params):
    return convert.unflatten(convert.jax_to_state_dict(_np(jax_params)))


def _pair(seed=0, layers=2):
    jm = JaxTransformer(V, H, HEADS, FILTER, layers, mode="translation",
                        max_len=MAXLEN)
    jp, _ = jm.init(jax.random.PRNGKey(seed))
    jp = _redraw(jp, 100 + seed)
    tm = Transformer(V, H, HEADS, FILTER, layers, mode="translation",
                     max_len=MAXLEN, device="cpu")
    tm.load_state_dict(convert.jax_to_state_dict(jp))
    return jm, jp, tm


def _src(seed, B=3, Ts=7):
    """Source ids in 1..V-1 with trailing padding (0) on every row but the
    first."""
    rng = np.random.RandomState(seed)
    src = rng.randint(1, V, (B, Ts)).astype(np.int32)
    for b in range(1, B):
        src[b, Ts - 2 * b:] = 0
    return src


def _ids(seed, B, T):
    return np.random.RandomState(seed).randint(1, V, (B, T)).astype(np.int32)


# -- Table ---------------------------------------------------------------------

def test_table_indexes_iterates_and_names_as_jax_does():
    a, b = np.zeros(2), np.ones(3)
    for cls in (Table, JaxTable):
        t = cls(a, b)
        assert t[1] is a and t[2] is b and len(t) == 2 == t.length()
        assert list(t) == [a, b] and 2 in t and 3 not in t
        with pytest.raises(IndexError):
            t[0]
        t["name"] = 5
        t[4] = "x"
        assert t["name"] == 5 and len(t) == 4 and t[3] is None
        assert "name" in t and list(t.keys()) == ["name"]
        t.insert(7).update("k", 1)
        assert t.to_list()[-1] == 7 and t["k"] == 1
    assert len(T(a, b)) == len(Table([a, b])) == 2
    assert repr(Table(1, 2)) == repr(JaxTable(1, 2)) == "Table{1, 2}"


# -- modules ---------------------------------------------------------------------

def test_padding_mask_matches():
    keep = _src(1) != 0
    want = jax_padding_mask(jnp.asarray(keep), keep.shape[1])
    got = padding_mask(torch.from_numpy(keep), keep.shape[1])
    assert got.shape == (3, 1, 1, 7) and got.dtype == torch.float32
    torch.testing.assert_close(got, _t(want), atol=0, rtol=0)


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "padding"])
def test_cross_attention_on_a_table_matches(masked):
    ja = JaxAttention(H, HEADS)
    jp = _redraw(ja.init(jax.random.PRNGKey(1))[0], 1)
    rng = np.random.RandomState(2)
    q = rng.randn(3, 5, H).astype(np.float32)
    kv = rng.randn(3, 7, H).astype(np.float32)
    keep = _src(3) != 0
    jm = jax_padding_mask(jnp.asarray(keep), 7) if masked else None
    want, _ = ja.apply(jp, {}, JaxTable(jnp.asarray(q), jnp.asarray(kv), jm))
    tm = padding_mask(torch.from_numpy(keep), 7) if masked else None
    got = Attention(H, HEADS).call(_port_tree(jp), Table(_t(q), _t(kv), tm))
    torch.testing.assert_close(got, _t(want), **MOD_TOL)
    # qkv(kx=): queries of one sequence, keys / values of the other
    jq, jk, jv = ja.qkv(jp, jnp.asarray(q), jnp.asarray(kv))
    tq, tk, tv = Attention(H, HEADS).qkv(_port_tree(jp), _t(q), _t(kv))
    for got, want in ((tq, jq), (tk, jk), (tv, jv)):
        torch.testing.assert_close(got, _t(want), **MOD_TOL)


def test_rope_refuses_cross_attention_as_jax_does():
    a = Attention(H, HEADS, rope=True)
    x = torch.zeros(1, 3, H)
    with pytest.raises(ValueError, match="RoPE"):
        a.call(a.params, Table(x, torch.zeros(1, 4, H), None))
    with pytest.raises(ValueError, match="RoPE"):
        Transformer(V, H, HEADS, FILTER, 1, mode="translation",
                    pos_encoding="rope", device="cpu")


def test_cross_block_and_its_decode_pieces_match():
    jb = JaxBlock(H, HEADS, FILTER, with_cross=True)
    jp = _redraw(jb.init(jax.random.PRNGKey(4))[0], 4)
    tb = TransformerBlock(H, HEADS, FILTER, with_cross=True)
    tp = _port_tree(jp)
    rng = np.random.RandomState(5)
    h = rng.randn(3, 6, H).astype(np.float32)
    enc = rng.randn(3, 7, H).astype(np.float32)
    keep = _src(6) != 0
    jmask = jax_padding_mask(jnp.asarray(keep), 7)
    tmask = padding_mask(torch.from_numpy(keep), 7)
    want, _ = jb.apply(jp, {}, JaxTable(jnp.asarray(h), jax_causal_mask(6),
                                        jnp.asarray(enc), jmask))
    got = tb.call(tp, Table(_t(h), causal_mask(6), _t(enc), tmask))
    torch.testing.assert_close(got, _t(want), **MOD_TOL)
    # cross K/V of the encoder output, then one cached decode step
    jkv = jb.cross_kv(jp, jnp.asarray(enc))
    tkv = tb.cross_kv(tp, _t(enc))
    for got, want in zip(tkv, jkv):
        assert got.shape == (3, HEADS, 7, H // HEADS)
        torch.testing.assert_close(got, _t(want), **MOD_TOL)
    cache = rng.randn(3, HEADS, 8, H // HEADS).astype(np.float32)
    jh, (jk, jv) = jb.decode_step(jp, jnp.asarray(h[:, :1]),
                                  (jnp.asarray(cache), jnp.asarray(cache)),
                                  3, jkv, jmask)
    tk, tv = _t(cache), _t(cache)
    th, (k2, v2) = tb.decode_step(tp, _t(h[:, :1]), (tk, tv), 3, tkv, tmask)
    assert k2 is tk and v2 is tv           # written in place
    torch.testing.assert_close(th, _t(jh), **MOD_TOL)
    torch.testing.assert_close(tk, _t(jk), **MOD_TOL)
    torch.testing.assert_close(tv, _t(jv), **MOD_TOL)


def test_attention_decode_matches():
    ja = JaxAttention(H, HEADS, causal=True)
    jp = _redraw(ja.init(jax.random.PRNGKey(7))[0], 7)
    rng = np.random.RandomState(7)
    x = rng.randn(2, 1, H).astype(np.float32)
    cache = rng.randn(2, HEADS, 6, H // HEADS).astype(np.float32)
    want, jk, jv = ja.decode(jp, jnp.asarray(x), jnp.asarray(cache),
                             jnp.asarray(cache), 4)
    tk, tv = _t(cache), _t(cache)
    got, _, _ = Attention(H, HEADS, causal=True).decode(_port_tree(jp),
                                                        _t(x), tk, tv, 4)
    torch.testing.assert_close(got, _t(want), **MOD_TOL)
    torch.testing.assert_close(tk, _t(jk), **MOD_TOL)
    torch.testing.assert_close(tv, _t(jv), **MOD_TOL)


# -- the model -------------------------------------------------------------------

def test_translation_params_carry_jax_names():
    jm, jp, tm = _pair()
    assert set(convert.flatten(tm.params)) == set(convert.flatten(_np(jp)))
    keys = set(tm.state_dict())
    assert {"enc_block0.attn.wq", "block0.cross.wq", "block0.ln3.weight",
            "enc_block1.ffn.w2"} <= keys
    assert not any(k.startswith("enc_block0.cross") for k in keys)
    assert tm.blocks[0].attn.causal is False and tm.blocks[0].with_cross
    assert len(tm.enc_blocks) == 2 and not tm.enc_blocks[0].with_cross


def test_translation_forward_matches_with_padded_sources():
    jm, jp, tm = _pair(seed=1)
    src, tgt = _src(11), _ids(12, 3, 6)
    want, _ = jm.apply(jp, {}, JaxTable(jnp.asarray(src), jnp.asarray(tgt)),
                       training=False)
    got = tm.call(tm.params, Table(src, tgt))
    torch.testing.assert_close(got, _t(want), **LOGIT_TOL)
    out, state = tm.apply(tm.params, {}, Table(src, tgt))
    torch.testing.assert_close(out, got, atol=0, rtol=0)
    torch.testing.assert_close(tm.evaluate()(Table(src, tgt)).detach(),
                               got.detach(), atol=0, rtol=0)
    # a padded source position changes nothing
    src2 = src.copy()
    src2[1, -1] = 5
    assert not torch.allclose(tm.call(tm.params, Table(src2, tgt))[1], got[1])
    src3 = src.copy()
    src3[2, -1] = 0
    torch.testing.assert_close(tm.call(tm.params, Table(src3, tgt)), got,
                               atol=0, rtol=0)


def _loss_w(shape, seed=13):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_translation_gradients_match_every_parameter(remat):
    jm, jp, tm = _pair(seed=2)
    tm.remat = remat
    src, tgt = _src(21), _ids(22, 3, 6)
    w = _loss_w((3, 6, V))

    def jloss(p):
        out, _ = jm.apply(p, {}, JaxTable(jnp.asarray(src),
                                          jnp.asarray(tgt)), training=True)
        return jnp.sum(out * w)

    jgrads = _np(jax.grad(jloss)(jax.tree_util.tree_map(jnp.asarray, jp)))
    params = tm.params
    leaves = convert.flatten(params)
    loss = (tm.call(params, Table(src, tgt), training=True) * _t(w)).sum()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    want = convert.flatten(jgrads)
    assert set(want) == set(leaves)
    for (name, _), g in zip(leaves.items(), grads):
        torch.testing.assert_close(g, _t(want[name]), **LOGIT_TOL,
                                   msg=name)


def test_decode_one_with_cross_matches():
    jm, jp, tm = _pair(seed=3)
    src = _src(31)
    jenc, jmask = jm._encode_src(jp, jnp.asarray(src))
    tenc, tmask = tm._encode_src(tm.params, torch.from_numpy(src).long())
    torch.testing.assert_close(tenc, _t(jenc), **MOD_TOL)
    torch.testing.assert_close(tmask, _t(jmask), atol=0, rtol=0)
    jcross = [b.cross_kv(jp[f"block{i}"], jenc)
              for i, b in enumerate(jm.blocks)]
    tcross = [b.cross_kv(tm.params[f"block{i}"], tenc)
              for i, b in enumerate(tm.blocks)]
    jc = jm.init_cache(3, 8)
    tc = tm.init_cache(3, 8)
    toks = _ids(32, 3, 3)
    for pos in range(3):
        jl, jc = jm.decode_one(jp, jnp.asarray(toks[:, pos]), pos, jc,
                               jcross, jmask)
        tl, tc = tm.decode_one(tm.params, toks[:, pos], pos, tc, tcross,
                               tmask)
        torch.testing.assert_close(tl, _t(jl), **MOD_TOL)
    for (jk, jv), (k, v) in zip(jc, tc):
        torch.testing.assert_close(k, _t(jk), **MOD_TOL)
        torch.testing.assert_close(v, _t(jv), **MOD_TOL)


def _greedy_with_margins(tm, src, n, bos=1):
    """Port-side greedy decode through decode_one, with each step's top-2
    logit margin (the smallest over the batch)."""
    p = tm.params
    enc, mask = tm._encode_src(p, torch.from_numpy(src).long())
    cross = [b.cross_kv(p[f"block{i}"], enc) for i, b in enumerate(tm.blocks)]
    caches = tm.init_cache(src.shape[0], n + 1)
    tok = torch.full((src.shape[0],), bos)
    toks, margins = [], []
    for pos in range(n):
        logits, caches = tm.decode_one(p, tok, pos, caches, cross, mask)
        top = logits.topk(2, -1).values
        margins.append(float((top[:, 0] - top[:, 1]).min()))
        tok = logits.argmax(-1)
        toks.append(tok)
    return torch.stack(toks, 1), np.array(margins)


def _trusted(margins):
    """Steps up to (and including) the first near-tie."""
    low = np.nonzero(margins < MARGIN)[0]
    return len(margins) if low.size == 0 else int(low[0]) + 1


@pytest.mark.parametrize("seed", [1, 12])
def test_translate_matches_jax_greedy(seed):
    jm, jp, tm = _pair(seed=seed)
    src = _src(40 + seed)
    n = 8
    want = np.asarray(jm.translate(jp, jnp.asarray(src), n, bos_id=1))
    got = tm.translate(tm.params, src, n, bos_id=1)
    solo, margins = _greedy_with_margins(tm, src, n)
    torch.testing.assert_close(got, solo, atol=0, rtol=0)
    k = _trusted(margins)
    assert k >= 3, "fixture too close to a tie to say anything"
    np.testing.assert_array_equal(got.numpy()[:, :k], want[:, :k])
    assert len(set(got.numpy().ravel().tolist())) > 2   # not one token


def test_translate_matches_the_naive_reforward():
    """translate == feeding the growing target back through the full
    forward, as the JAX package's own test holds it."""
    _, _, tm = _pair(seed=5)
    src = _src(50)
    out = tm.translate(tm.params, src, 6)
    tgt = torch.ones((3, 1), dtype=torch.long)
    for _ in range(6):
        logits = tm.call(tm.params, Table(src, tgt))
        tgt = torch.cat([tgt, logits[:, -1].argmax(-1)[:, None]], 1)
    torch.testing.assert_close(out, tgt[:, 1:], atol=0, rtol=0)


def test_translate_eos_masking_matches_jax():
    jm, jp, tm = _pair(seed=6, layers=1)
    src = _src(60, B=2)
    free = tm.translate(tm.params, src, 8)
    eos = int(free[0, 1])                  # row 0's second token
    got = tm.translate(tm.params, src, 8, eos_id=eos)
    want = np.asarray(jm.translate(jp, jnp.asarray(src), 8, eos_id=eos))
    row = got[0].tolist()
    cut = row.index(eos)
    assert cut <= 1 and all(t == 0 for t in row[cut + 1:])
    np.testing.assert_array_equal(got.numpy(), want)
    # the argmax is still fed back: the tokens before the cut are the free
    # run's, and the rows that never emit eos are unchanged
    assert row[:cut + 1] == free[0, :cut + 1].tolist()


def test_translation_mode_refuses_lm_entry_points():
    _, _, tm = _pair()
    with pytest.raises(ValueError, match="mode"):
        tm.generate(tm.params, _ids(1, 1, 3), 2)
    with pytest.raises(ValueError, match="mode"):
        tm.hidden_states(tm.params, _ids(1, 1, 3))
    lm = TransformerLM(vocab_size=V, hidden_size=H, num_heads=HEADS,
                       filter_size=FILTER, num_layers=1, max_len=MAXLEN,
                       device="cpu")
    with pytest.raises(ValueError, match="mode"):
        lm.translate(lm.params, _src(1), 2)
    with pytest.raises(ValueError, match="max_len"):
        tm.translate(tm.params, _src(1), MAXLEN)


# -- C.5: the masked path's dtypes with bf16 parameters ------------------------

@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_dot_product_attention_dtype_follows_jax(masked):
    rng = np.random.RandomState(8)
    q, k, v = (rng.randn(2, 2, 5, 8).astype(np.float32) for _ in range(3))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (_t(a).to(torch.bfloat16) for a in (q, k, v))
    jm = jax_causal_mask(5) if masked else None
    tmask = causal_mask(5) if masked else None
    want = jax_dpa(jq, jk, jv, jm)
    got = dot_product_attention(tq, tk, tv, tmask)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    assert got.dtype == (torch.float32 if masked else torch.bfloat16)
    torch.testing.assert_close(got.float(), _t(want.astype(jnp.float32)),
                               atol=3e-2, rtol=3e-2)


def _bf16_close(got, want):
    want = np.asarray(want.astype(jnp.float32))
    scale = float(np.abs(want).max())
    err = float((got.float() - _t(want)).abs().max())
    assert err <= BF16_REL * scale, (err, scale)


def test_lm_non_flash_bf16_outputs_follow_jax():
    """With bf16 parameters and ``use_flash=False`` the causal mask makes
    the first attention float32 and the residual stream float32 after it:
    JAX returns float32 logits; so does the port."""
    cfg = dict(vocab_size=V, hidden_size=H, num_heads=HEADS,
               filter_size=FILTER, num_layers=2, max_len=MAXLEN,
               use_flash=False)
    jm = JaxLM(**cfg)
    jp = _redraw(jm.init(jax.random.PRNGKey(9))[0], 9)
    tm = TransformerLM(device="cpu", **cfg)
    tm.load_state_dict(convert.jax_to_state_dict(jp))
    jp16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), jp)
    with torch.no_grad():
        tp16 = bf16_params(tm.params)
    ids = _ids(90, 2, 9)
    want, _ = jm.apply(jp16, {}, jnp.asarray(ids))
    got = tm.call(tp16, ids)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    _bf16_close(got, want)
    jl, jc = jm.prefill(jp16, jnp.asarray(ids), 16)
    tl, tc = tm.prefill(tp16, ids, 16)
    assert str(jl.dtype) == "float32" and tl.dtype == torch.float32
    assert tc[0][0].dtype == torch.bfloat16
    assert str(jc[0][0].dtype) == "bfloat16"
    _bf16_close(tl, jl)
    # the flash path has no mask and stays bf16, in both packages
    flash = TransformerLM(device="cpu", **dict(cfg, use_flash=True))
    flash.load_state_dict(tm.state_dict())
    assert flash.call(tp16, ids).dtype == torch.bfloat16


def test_translation_bf16_outputs_follow_jax():
    jm, jp, tm = _pair(seed=7)
    jp16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), jp)
    with torch.no_grad():
        tp16 = bf16_params(tm.params)
    src, tgt = _src(70), _ids(71, 3, 5)
    want, _ = jm.apply(jp16, {}, JaxTable(jnp.asarray(src),
                                          jnp.asarray(tgt)))
    got = tm.call(tp16, Table(src, tgt))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    _bf16_close(got, want)
    # translate builds its caches in the encoder output's dtype: float32
    jenc, _ = jm._encode_src(jp16, jnp.asarray(src))
    tenc, _ = tm._encode_src(tp16, torch.from_numpy(src).long())
    assert jenc.dtype == jnp.float32 and tenc.dtype == torch.float32
    assert tm.translate(tp16, src, 4).shape == (3, 4)
