"""The MoE slice of the port against the JAX package on the CPU.

* ``parallel.moe``: ``expert_capacity``; ``top1_routing`` bit for bit in
  float32 (dispatch; gate and aux at 1e-6: the softmax's ``exp`` differs by
  an ulp between XLA and torch) and in bf16 at 8192 tokens over 8 experts
  (1024 a queue, past bf16's exact integers at 256), where both packages
  must put the same tokens in the same shared slots (the reference caveat:
  1458 slots hold more than one token, one holds 10); the queue positions'
  cumulative sum against ``jnp.cumsum`` in bf16 bit for bit.
* ``nn.MixtureOfExperts``: output, ``aux_loss`` state and gradients at
  1e-5 (float32), token dropping included; in bf16 the routing of every
  row whose top-2 probability margin exceeds 2^-7 (bf16's resolution near
  1 is 2^-8; the bf16 router products of the two packages may round one
  ulp apart) and the output at 2e-2 (a few bf16 roundings of values near
  1).
* ``models.MoETransformerLM`` at 2 layers: logits at 1e-4, ``aux`` and
  every parameter's gradient of sum(sin(logits / 2)) + aux at 1e-4 / 1e-5,
  remat bit for bit the plain backward, ``hidden_states``, ``generate``
  token for token up to the first top-2 margin under 1e-3, and
  ``prefill_chunked`` logits against JAX's full forward at 1e-4 (its
  caches against ``prefill``'s, ``decode_one`` against the port's full
  forward), and the port's weights carried back into JAX.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.models.moe_lm import MoETransformerLM as JaxMoELM
from bigdl_tpu.nn.moe import MixtureOfExperts as JaxMoE
from bigdl_tpu.parallel import moe as jmoe
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.models import MoETransformerLM, lm_loss_chunked
from bigdl_tpu_torch.nn import MixtureOfExperts
from bigdl_tpu_torch.parallel import moe as tmoe

from torch_parity_helpers import check_pair

torch.set_num_threads(1)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)     # model logits, float32
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)      # whole-model gradients
MARGIN = 1e-3                              # greedy tokens past a near-tie
CFG = dict(vocab_size=48, hidden_size=32, num_heads=2, filter_size=64,
           num_layers=2, n_experts=4, max_len=64)


def _bits(a):
    """An array of JAX's or a tensor as float32 numpy (bf16 is exact)."""
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# -- parallel.moe ---------------------------------------------------------------

@pytest.mark.parametrize("t,e,f", [(8192, 8, 1.25), (16, 4, 1.25),
                                   (3, 8, 1.0), (100, 3, 2.0)])
def test_expert_capacity(t, e, f):
    assert tmoe.expert_capacity(t, e, f) == jmoe.expert_capacity(t, e, f)


def test_top1_routing_float32_bit_for_bit():
    t, E = 3000, 4
    cap = jmoe.expert_capacity(t, E, 1.25)
    lg = np.random.RandomState(1).randn(t, E).astype(np.float32)
    lg[:, 0] += 0.5             # expert 0 overflows its queue
    jd, jc, ja = jmoe.top1_routing(jnp.asarray(lg), cap)
    td, tc, ta = tmoe.top1_routing(torch.from_numpy(lg), cap)
    np.testing.assert_array_equal(_bits(td), _bits(jd))
    np.testing.assert_allclose(_bits(tc), _bits(jc), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    assert _bits(td).sum(0).max() == 1.0     # no slot shared in float32
    assert 0 < (_bits(td).sum((1, 2)) == 0).sum()   # some tokens dropped


def _shared(dispatch):
    occ = _bits(dispatch).sum(0)
    return int((occ > 1).sum()), float(occ.max())


@pytest.mark.parametrize("t,E,seed,shared", [(8192, 8, 0, (1458, 10.0)),
                                             (3000, 4, 1, None)],
                         ids=["t8192_e8", "t3000_e4"])
def test_top1_routing_bf16_shares_the_same_slots_as_jax(t, E, seed, shared):
    """The reference caveat: positions count in bf16, which holds integers
    exactly only up to 256, so past 256 tokens an expert's queue positions
    round and several tokens share one slot. Both packages round the same
    way, so dispatch, combine and aux are bit for bit JAX's."""
    cap = jmoe.expert_capacity(t, E, 1.25)
    lg = np.random.RandomState(seed).randn(t, E).astype(np.float32)
    jd, jc, ja = jmoe.top1_routing(jnp.asarray(lg).astype(jnp.bfloat16), cap)
    td, tc, ta = tmoe.top1_routing(torch.from_numpy(lg).bfloat16(), cap)
    assert td.dtype == tc.dtype == ta.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(td), _bits(jd))
    np.testing.assert_array_equal(_bits(tc), _bits(jc))
    assert float(ta) == float(ja)
    got = _shared(td)
    assert got == _shared(jd) and got[0] > 0
    if shared is not None:
        assert got == shared
    # float32 positions share nothing
    fd, _, _ = tmoe.top1_routing(torch.from_numpy(lg), cap)
    assert _shared(fd)[1] == 1.0


def test_cumsum_rounds_as_xla_does_in_bf16():
    rng = np.random.RandomState(3)
    cols = (rng.rand(5000, 6) < np.array([0.5, 0.125, 0.3, 1, 0.9, 0.05])
            ).astype(np.float32)
    want = _bits(jnp.cumsum(jnp.asarray(cols).astype(jnp.bfloat16), axis=0))
    got = _bits(tmoe._cumsum(torch.from_numpy(cols).bfloat16()))
    np.testing.assert_array_equal(got, want)
    # the 257th entry of a running count of ones reads 256
    assert got[256, 3] == 256.0
    # a float32 running count is exact
    f = tmoe._cumsum(torch.from_numpy(cols)).numpy()
    np.testing.assert_array_equal(f, np.cumsum(cols, 0))


# -- nn.MixtureOfExperts ---------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 8, 16), (24, 16)], ids=["btd", "nd"])
def test_mixture_of_experts_matches_jax(shape):
    """Output, the aux_loss state and the gradients of the parameters and
    the input, with tokens dropped at capacity 1.25 * t / E."""
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    check_pair(JaxMoE(16, 4, 32), MixtureOfExperts(16, 4, 32), x, True,
               jit=True)


def test_mixture_of_experts_bf16_routes_as_jax_where_the_margin_is_clear():
    rng = np.random.RandomState(7)
    jm = JaxMoE(32, 4, 64)
    jp, js = jm.init(jax.random.PRNGKey(0))
    jp = jax.tree_util.tree_map(
        lambda a: (0.5 * rng.randn(*a.shape)).astype(np.float32), jp)
    x = rng.randn(4, 96, 32).astype(np.float32)
    jpb = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), jp)
    jy, jst = jm.apply(jpb, js, jnp.asarray(x, jnp.bfloat16))
    tm = MixtureOfExperts(32, 4, 64)
    tm.load_state_dict(convert.jax_to_state_dict(jp, js))
    tp = {k: v.detach().bfloat16() for k, v in tm.params.items()}
    ty, tst = tm.apply(tp, tm.state, torch.from_numpy(x).bfloat16())
    assert ty.dtype == torch.bfloat16
    # routing: the same expert wherever JAX's top-2 margin is clear
    h = jnp.asarray(x, jnp.bfloat16).reshape(-1, 32)
    jprobs = _bits(jax.nn.softmax(h @ jpb["router"], axis=-1))
    tprobs = _bits(tmoe._softmax(torch.from_numpy(x).bfloat16()
                                 .reshape(-1, 32) @ tp["router"]))
    top2 = np.sort(jprobs, -1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2.0 ** -7
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(tprobs.argmax(-1)[clear],
                                  jprobs.argmax(-1)[clear])
    if (tprobs.argmax(-1) == jprobs.argmax(-1)).all():
        np.testing.assert_allclose(_bits(ty), _bits(jy), atol=2e-2,
                                   rtol=2e-2)
        np.testing.assert_allclose(float(tst["aux_loss"]),
                                   float(jst["aux_loss"]), rtol=2e-2)


# -- models.MoETransformerLM -------------------------------------------------------

_shared_models = {}


def _models(**kw):
    """JAX's 2-layer MoE LM with 0.3 N(0, 1) weights (numpy seed 0) and
    the port's carrying them."""
    key = tuple(sorted(kw.items()))
    if key not in _shared_models:
        cfg = dict(CFG, **kw)
        jm = JaxMoELM(**cfg)
        jp, js = jm.init(jax.random.PRNGKey(0))
        rng = np.random.RandomState(0)
        jp = jax.tree_util.tree_map(
            lambda a: (0.3 * rng.randn(*a.shape)).astype(np.float32), jp)
        tm = MoETransformerLM(device="cpu", **cfg)
        tm.load_state_dict(convert.jax_to_state_dict(jp, js))
        _shared_models[key] = (jm, jp, js, tm)
    return _shared_models[key]


def _ids(seed, B, T, V=CFG["vocab_size"]):
    return np.random.RandomState(seed).randint(0, V, (B, T)).astype(np.int32)


def test_state_tree_and_params_are_jax_s():
    jm, jp, js, tm = _models()
    assert set(convert.flatten(tm.state)) == {"aux_loss"}
    want = {k: v.shape for k, v in convert.flatten(
        jax.tree_util.tree_map(np.asarray, jp)).items()}
    got = {k: tuple(v.shape) for k, v in convert.flatten(tm.params).items()}
    assert got == want
    assert {"block1.ffn.router", "block1.ffn.w1", "block0.ffn.b1"} <= set(got)
    assert tm.moe_idx == jm.moe_idx == {1}


@pytest.mark.parametrize("arch", [{}, {"pos_encoding": "rope",
                                       "num_kv_heads": 1}],
                         ids=["sinusoidal", "rope_gqa"])
def test_logits_aux_and_gradients_match_jax(arch):
    jm, jp, js, tm = _models(**arch)
    ids = _ids(1, 2, 24)

    def jloss(p):
        logits, st = jm.apply(p, js, jnp.asarray(ids), training=True)
        return jnp.sum(jnp.sin(0.5 * logits)) + st["aux_loss"], \
            (logits, st["aux_loss"])
    (_, (jlog, jaux)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, jp))
    params = tm.params
    logits, st = tm.apply(params, tm.state, torch.from_numpy(ids), True)
    torch.testing.assert_close(logits, torch.from_numpy(np.asarray(jlog)),
                               **LOGIT_TOL)
    torch.testing.assert_close(st["aux_loss"].float(),
                               torch.tensor(float(jaux)), **LOGIT_TOL)
    flat = convert.flatten(params)
    grads = torch.autograd.grad(
        torch.sin(0.5 * logits).sum() + st["aux_loss"], list(flat.values()))
    jflat = convert.flatten(jax.tree_util.tree_map(np.asarray, jg))
    for k, g in zip(flat, grads):
        torch.testing.assert_close(g, torch.from_numpy(jflat[k]), **GRAD_TOL,
                                   msg=k)


def test_hidden_states_remat_and_the_forward_facade():
    jm, jp, js, tm = _models()
    ids = _ids(2, 2, 16)
    jh, jaux = jax.jit(jm.hidden_states)(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(ids))
    params = tm.params
    flat = convert.flatten(params)
    outs = []
    for remat in (False, True):
        tm.remat = remat
        h, aux = tm.hidden_states(params, ids, training=True)
        loss = lm_loss_chunked(h, params["embed"], ids, chunk=8) + 0.01 * aux
        outs.append((h, aux, torch.autograd.grad(loss, list(flat.values()))))
    tm.remat = False
    torch.testing.assert_close(outs[0][0], torch.from_numpy(np.asarray(jh)),
                               **LOGIT_TOL)
    assert abs(float(outs[0][1]) - float(jaux)) <= 1e-5
    for a, b in zip(outs[0][2], outs[1][2]):
        assert torch.equal(a, b)
    # the stateful facade writes the router loss into the state
    tm.evaluate()
    tm.forward(torch.from_numpy(ids))
    assert abs(float(tm.aux_loss) - float(jaux)) <= 1e-5


def _greedy_margins(tm, params, prompt, n):
    """The port's full-forward greedy tokens and each step's top-2 logit
    margin."""
    seq = torch.from_numpy(prompt).long()
    toks, margins = [], []
    with torch.no_grad():
        for _ in range(n):
            logits = tm.call(params, seq)[:, -1]
            top = logits.topk(2, -1).values
            margins.append(float((top[:, 0] - top[:, 1]).min()))
            nxt = logits.argmax(-1)
            toks.append(nxt.numpy())
            seq = torch.cat([seq, nxt[:, None]], 1)
    return np.stack(toks, 1), np.array(margins)


def test_generate_matches_jax_up_to_the_first_near_tie():
    jm, jp, js, tm = _models(capacity_factor=4.0)
    prompt = _ids(3, 2, 6)
    n = 8
    want = np.asarray(jm.generate(jax.tree_util.tree_map(jnp.asarray, jp),
                                  jnp.asarray(prompt), n))
    got = tm.generate(tm.params, prompt, n).numpy()
    np.testing.assert_array_equal(got[:, :6], prompt)
    _, margins = _greedy_margins(tm, tm.params, prompt, n)
    low = np.nonzero(margins < MARGIN)[0]
    k = n if low.size == 0 else int(low[0]) + 1
    assert k >= 4
    np.testing.assert_array_equal(got[:, 6:6 + k], want[:, 6:6 + k])


def test_prefill_chunked_and_decode_match_jax():
    """``prefill_chunked``'s last logits against JAX's full forward (with
    capacity for every token, neither drops one), its caches against the
    one-piece ``prefill``'s, and one cached step against the port's full
    forward of the longer sequence."""
    jm, jp, js, tm = _models(capacity_factor=4.0)
    jpp = jax.tree_util.tree_map(jnp.asarray, jp)
    ids = _ids(4, 2, 12)
    jl = jax.jit(lambda p, x: jm.apply(p, js, x)[0])(jpp, jnp.asarray(ids))
    tl, tc = tm.prefill_chunked(tm.params, ids, 32, chunk=8)
    torch.testing.assert_close(tl, torch.from_numpy(np.asarray(jl)[:, -1]),
                               **LOGIT_TOL)
    pl, pc = tm.prefill(tm.params, ids, 32)
    for (pk, pv), (tk, tv) in zip(pc, tc):
        torch.testing.assert_close(tk, pk, **LOGIT_TOL)
        torch.testing.assert_close(tv, pv, **LOGIT_TOL)
    # one cached step against the full forward of the longer sequence
    tok = np.array([5, 7], np.int32)
    tl2, _ = tm.decode_one(tm.params, tok, 12, tc)
    full = tm.call(tm.params, np.concatenate([ids, tok[:, None]], 1))
    torch.testing.assert_close(tl2, full[:, -1], **LOGIT_TOL)
    torch.testing.assert_close(pl, tl, **LOGIT_TOL)


def test_convert_carries_the_port_s_weights_back_to_jax():
    """The way back: the port's own seeded weights through
    ``convert.to_numpy_trees`` into JAX's apply give the port's logits."""
    jm, _, _, _ = _models()
    tm = MoETransformerLM(device="cpu", seed=3, **CFG)
    params, state = convert.to_numpy_trees(tm)
    ids = _ids(6, 2, 10)
    want = jax.jit(lambda p, x: jm.apply(p, {}, x)[0])(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(ids))
    got, st = tm.apply(tm.params, tm.state, ids)
    torch.testing.assert_close(got.detach(),
                               torch.from_numpy(np.asarray(want)),
                               **LOGIT_TOL)
    assert set(convert.flatten(state)) == {"aux_loss"}
