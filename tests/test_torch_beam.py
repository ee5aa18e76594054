"""The port's beam search (``Transformer.generate_beam``,
``translate_beam`` and the shared ``_beam_scan`` / ``_beam_backtrack`` /
``_beam_select``) against the JAX package.

Every input is made with numpy from a seed and fed to both sides; the JAX
parameters are carried into the port with ``bigdl_tpu_torch.convert`` and
redrawn as 0.3 * N(0, 1), so that the log-probabilities are far from
uniform. Tolerances, float32 on both sides:

* each expansion's tokens and parent slots are compared up to the first
  step where two of the top (beam + 1) candidate scores of a row lie
  closer than 1e-3 (ten times the logits tolerance): past such a near-tie
  either side may rank them the other way. Candidates at -1e30 (dead or
  frozen beams) tie exactly on both sides and are picked lower index
  first, so they are no near-tie;
* when no step has a near-tie, the final beam scores within atol = rtol =
  1e-5 (sums of a few float32 log-probabilities) and the output tokens
  exactly;
* the helpers on integer inputs, and picks among exact ties: exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.models.transformer_lm import TransformerLM as JaxLM
from bigdl_tpu.nn import attention as jattn
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.nn import Transformer
from bigdl_tpu_torch.nn import attention as tattn
from bigdl_tpu_torch.utils.table import Table

torch.set_num_threads(1)
SCORE_TOL = dict(atol=1e-5, rtol=1e-5)
MARGIN = 1e-3
V, H, HEADS, FILTER, MAXLEN = 29, 16, 2, 32, 32


def _redraw(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (0.3 * rng.randn(*a.shape)).astype(np.float32), tree)


def _translation_pair(seed, layers=2):
    jm = jattn.Transformer(V, H, HEADS, FILTER, layers, mode="translation",
                           max_len=MAXLEN)
    jp = _redraw(jm.init(jax.random.PRNGKey(seed))[0], 100 + seed)
    tm = Transformer(V, H, HEADS, FILTER, layers, mode="translation",
                     max_len=MAXLEN, device="cpu")
    tm.load_state_dict(convert.jax_to_state_dict(jp))
    return jm, jp, tm


def _lm_pair(seed):
    cfg = dict(vocab_size=V, hidden_size=H, num_heads=HEADS,
               filter_size=FILTER, num_layers=2, max_len=MAXLEN)
    jm = JaxLM(**cfg)
    jp = _redraw(jm.init(jax.random.PRNGKey(seed))[0], 200 + seed)
    tm = TransformerLM(device="cpu", **cfg)
    tm.load_state_dict(convert.jax_to_state_dict(jp))
    return jm, jp, tm


def _src(seed, B=2, Ts=7):
    rng = np.random.RandomState(seed)
    src = rng.randint(1, V, (B, Ts)).astype(np.int32)
    src[-1, Ts - 2:] = 0                    # a padded row
    return src


def _recording_top_k(monkeypatch):
    """Patch the port's top-k to record, for each call, the smallest gap
    between adjacent scores among a row's top (k + 1) above -1e29 (the
    smallest over the rows)."""
    gaps = []
    real = tattn._top_k

    def top_k(x, k):
        vals = torch.sort(x.float(), -1, descending=True).values[..., :k + 1]
        d = vals[..., :-1] - vals[..., 1:]
        live = (vals[..., 1:] > -1e29)
        gaps.append(float(torch.where(live, d, float("inf")).min()))
        return real(x, k)
    monkeypatch.setattr(tattn, "_top_k", top_k)
    return gaps


def _trusted(gaps):
    """Number of leading calls before the first near-tie."""
    low = [i for i, g in enumerate(gaps) if g < MARGIN]
    return len(gaps) if not low else low[0]


def _jax_translate_scan(jm, jp, src, n, K, eos_id=None):
    """JAX's translate_beam up to its _beam_scan: (scores, toks,
    parents)."""
    src = jnp.asarray(src)
    B = src.shape[0]
    enc, mask = jm._encode_src(jp, src)
    rep = lambda x: jnp.repeat(x, K, axis=0)
    cross = [tuple(rep(t) for t in b.cross_kv(jp[f"block{i}"], enc))
             for i, b in enumerate(jm.blocks)]
    caches = jm.init_cache(B * K, n + 1, enc.dtype)
    scores0 = jnp.tile(jnp.concatenate(
        [jnp.zeros((1,)), jnp.full((K - 1,), jnp.float32(-1e30))]), (B,))
    out = jm._beam_scan(
        lambda t, p, c: jm.decode_one(jp, t, p, c, cross, rep(mask)),
        caches, jnp.full((B * K,), 1, jnp.int32), scores0,
        jnp.zeros((B * K,), bool), jnp.int32(0), n, B, K, eos_id)
    return [np.asarray(a) for a in out]


def _port_translate_scan(tm, src, n, K, eos_id=None):
    p = tm.params
    src = torch.from_numpy(src).long()
    B = src.shape[0]
    enc, mask = tm._encode_src(p, src)
    cross = [tuple(t.repeat_interleave(K, 0)
                   for t in b.cross_kv(p[f"block{i}"], enc))
             for i, b in enumerate(tm.blocks)]
    caches = tm.init_cache(B * K, n + 1, enc.dtype)
    scores0 = torch.full((B, K), -1e30)
    scores0[:, 0] = 0.0
    with torch.no_grad():
        return tm._beam_scan(
            lambda t, q, c: tm.decode_one(p, t, q, c, cross,
                                          mask.repeat_interleave(K, 0)),
            caches, torch.ones(B * K, dtype=torch.long), scores0.reshape(-1),
            torch.zeros(B * K, dtype=torch.bool), 0, n, B, K, eos_id)


def _compare_scans(got, want, trusted):
    scores, toks, parents = got
    np.testing.assert_array_equal(toks.numpy()[:trusted], want[1][:trusted])
    np.testing.assert_array_equal(parents.numpy()[:trusted],
                                  want[2][:trusted])
    if trusted == toks.shape[0]:
        torch.testing.assert_close(scores, torch.from_numpy(want[0].copy()),
                                   **SCORE_TOL)


# -- the helpers -------------------------------------------------------------

def test_beam_helpers_match_jax_exactly():
    rng = np.random.RandomState(0)
    steps, B, K = 6, 3, 4
    toks = rng.randint(0, 5, (steps, B, K)).astype(np.int32)   # 0 is pad
    parents = rng.randint(0, K, (steps, B, K)).astype(np.int32)
    scores = rng.randn(B * K).astype(np.float32) * 5
    jpaths, jroots = jattn._beam_backtrack(jnp.asarray(toks),
                                           jnp.asarray(parents), B, K)
    paths, roots = tattn._beam_backtrack(torch.from_numpy(toks).long(),
                                         torch.from_numpy(parents).long(),
                                         B, K)
    np.testing.assert_array_equal(paths.numpy(), np.asarray(jpaths))
    np.testing.assert_array_equal(roots.numpy(), np.asarray(jroots))
    for lp in (0.0, 0.6, 1.0):
        want = jattn._beam_select(jnp.asarray(scores), jnp.asarray(toks), B,
                                  K, lp)
        got = tattn._beam_select(torch.from_numpy(scores),
                                 torch.from_numpy(toks).long(), B, K, lp)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # no steps: the roots are the slots themselves
    empty = torch.zeros((0, B, K), dtype=torch.long)
    p0, r0 = tattn._beam_backtrack(empty, empty, B, K)
    assert p0.shape == (0, B, K)
    np.testing.assert_array_equal(r0.numpy(), np.tile(np.arange(K), (B, 1)))


def test_top_k_picks_ties_as_lax_top_k_does():
    x = np.array([[1.0, 3.0, 3.0, -1e30, 3.0, -1e30, 2.0],
                  [-1e30] * 7,
                  [0.5, -1e30, 0.5, 0.5, -2e30, 0.5, 0.5]], np.float32)
    for k in (1, 3, 5):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = tattn._top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("eos_id", [None, 0, 3])
def test_beam_scan_on_constructed_ties_matches_jax(eos_id):
    """Every vocab column ties (equal logits), and beams 1.. start at
    -1e30 as in translate_beam: each pick is decided by the tie order
    alone. An eos at column 3 (or 0) freezes the beams that pick it."""
    B, K, steps = 2, 3, 4

    class Stub:
        vocab_size = V

    logits = np.zeros((B * K, V), np.float32)
    scores0 = np.tile(np.array([0.0] + [-1e30] * (K - 1), np.float32), B)
    want = jattn.Transformer._beam_scan(
        Stub(), lambda t, p, c: (jnp.asarray(logits), c),
        [(jnp.zeros((B * K, 2)),) * 2], jnp.ones((B * K,), jnp.int32),
        jnp.asarray(scores0), jnp.zeros((B * K,), bool), jnp.int32(0),
        steps, B, K, eos_id)
    got = tattn.Transformer._beam_scan(
        Stub(), lambda t, p, c: (torch.from_numpy(logits), c),
        [(torch.zeros(B * K, 2),) * 2], torch.ones(B * K, dtype=torch.long),
        torch.from_numpy(scores0), torch.zeros(B * K, dtype=torch.bool), 0,
        steps, B, K, eos_id)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- translate_beam -------------------------------------------------------------

@pytest.mark.parametrize("seed,K", [(1, 4), (5, 3)])
def test_translate_beam_matches_jax(seed, K, monkeypatch):
    jm, jp, tm = _translation_pair(seed)
    src = _src(40 + seed)
    n = 6
    want = _jax_translate_scan(jm, jp, src, n, K)
    gaps = _recording_top_k(monkeypatch)
    got = _port_translate_scan(tm, src, n, K)
    trusted = _trusted(gaps)
    assert trusted >= 3, f"fixture too close to a tie: gaps {gaps}"
    _compare_scans(got, want, trusted)
    if trusted == n:
        out = tm.translate_beam(tm.params, src, n, beam_size=K)
        jout = jm.translate_beam(jp, jnp.asarray(src), n, beam_size=K)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def test_translate_beam_with_eos_and_length_penalty_matches_jax(monkeypatch):
    jm, jp, tm = _translation_pair(12)
    src = _src(52)
    free = tm.translate_beam(tm.params, src, 6, beam_size=3)
    eos = int(free[0, 1])
    want = _jax_translate_scan(jm, jp, src, 6, 3, eos)
    gaps = _recording_top_k(monkeypatch)
    got = _port_translate_scan(tm, src, 6, 3, eos)
    trusted = _trusted(gaps)
    assert trusted >= 3, f"fixture too close to a tie: gaps {gaps}"
    _compare_scans(got, want, trusted)
    for lp in (0.0, 1.0):
        out = tm.translate_beam(tm.params, src, 6, beam_size=3, eos_id=eos,
                                length_penalty=lp).numpy()
        for row in out:                      # pad after the first eos
            hit = np.nonzero(row == eos)[0]
            if hit.size:
                assert (row[hit[0] + 1:] == 0).all(), row
        if trusted == 6:
            jout = jm.translate_beam(jp, jnp.asarray(src), 6, beam_size=3,
                                     eos_id=eos, length_penalty=lp)
            np.testing.assert_array_equal(out, np.asarray(jout))


def _seq_logprob(tm, src, tgt):
    full = torch.cat([torch.ones((tgt.shape[0], 1), dtype=torch.long), tgt],
                     1)
    with torch.no_grad():
        logits = tm.call(tm.params, Table(src, full[:, :-1]))
    logp = torch.log_softmax(logits.float(), -1)
    return logp.gather(-1, tgt[..., None])[..., 0].sum(1)


def test_wider_beams_score_no_worse_than_greedy():
    """The best beam's model score never falls below greedy's (the JAX
    package's own property test), which a cache reorder that overwrote
    rows it still had to read would break."""
    _, _, tm = _translation_pair(1)
    src = _src(41)
    greedy = _seq_logprob(tm, src, tm.translate(tm.params, src, 6))
    for K in (2, 4, 8):
        beam = tm.translate_beam(tm.params, src, 6, beam_size=K)
        assert ((b := _seq_logprob(tm, src, beam)) >= greedy - 1e-4).all(), \
            (K, b, greedy)


# -- generate_beam ---------------------------------------------------------------

@pytest.mark.parametrize("seed,K", [(1, 4), (3, 2)])
def test_generate_beam_matches_jax(seed, K, monkeypatch):
    jm, jp, tm = _lm_pair(seed)
    ids = np.random.RandomState(30 + seed).randint(1, V, (2, 7)) \
        .astype(np.int32)
    n = 6
    gaps = _recording_top_k(monkeypatch)
    got = tm.generate_beam(tm.params, ids, n, beam_size=K)
    trusted = _trusted(gaps)             # gaps[0]: the prefill's top-k
    assert trusted >= 3, f"fixture too close to a tie: gaps {gaps}"
    want = np.asarray(jm.generate_beam(jp, jnp.asarray(ids), n,
                                       beam_size=K))
    np.testing.assert_array_equal(got.numpy()[:, :7], ids)
    if trusted == len(gaps):
        np.testing.assert_array_equal(got.numpy(), want)
    else:          # the tokens of a single best path are not comparable
        assert got.shape == want.shape


def test_generate_beam_prefills_once_and_bounds_max_len():
    _, _, tm = _lm_pair(0)
    ids = np.random.RandomState(3).randint(1, V, (2, 5)).astype(np.int32)
    calls = []
    real = tm.prefill
    tm.prefill = lambda *a, **k: calls.append(a[1].shape) or real(*a, **k)
    out = tm.generate_beam(tm.params, ids, 4, beam_size=3)
    assert calls == [(2, 5)] and out.shape == (2, 9)     # un-repeated batch
    assert torch.equal(tm.generate_beam(tm.params, ids, 0), out[:, :5])
    with pytest.raises(ValueError, match="max_len"):
        tm.generate_beam(tm.params, ids, MAXLEN)


# -- width 1 is greedy, bit for bit ----------------------------------------------

@pytest.mark.parametrize("eos", [False, True], ids=["free", "eos"])
def test_width_one_is_greedy_bit_for_bit(eos):
    _, _, tm = _translation_pair(1)
    src = _src(41)
    eos_id = int(tm.translate(tm.params, src, 6)[0, 2]) if eos else None
    torch.testing.assert_close(
        tm.translate_beam(tm.params, src, 6, beam_size=1, eos_id=eos_id),
        tm.translate(tm.params, src, 6, eos_id=eos_id), atol=0, rtol=0)
    _, _, lm = _lm_pair(0)
    ids = np.random.RandomState(5).randint(1, V, (3, 6)).astype(np.int32)
    eos_id = int(lm.generate(lm.params, ids, 7)[1, 8]) if eos else None
    torch.testing.assert_close(
        lm.generate_beam(lm.params, ids, 7, beam_size=1, eos_id=eos_id),
        lm.generate(lm.params, ids, 7, eos_id=eos_id), atol=0, rtol=0)
