"""The port's training path against the JAX package: differentiable model,
losses, criteria and the LocalOptimizer loop.

Every input is made with numpy from a seed and fed to both sides; the JAX
parameters are carried into the port with ``bigdl_tpu_torch.convert``.
Tolerances, float32 on both sides unless stated:

* model gradients and losses, per parameter: atol = rtol = 1e-4 (the same
  arithmetic in another summation order, added up over two blocks, the
  tied projection and the softmax);
* criteria and their gradInput: atol = rtol = 1e-5 (one softmax or
  gather; a few ulps);
* the 3-step LocalOptimizer run: losses and final parameters within 1e-4
  (three updates at lr 0.1 with momentum carry the gradient differences);
* the bf16 cast: gradients equal within 1e-6 relative (both frameworks
  round the same float32 cotangent to bf16 and back, round to nearest
  even).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.dataset import DataSet as JaxDataSet, Sample as JaxSample
from bigdl_tpu.models.transformer_lm import (TransformerLM as JaxLM,
                                             lm_loss_chunked as jax_lm_loss)
from bigdl_tpu.nn import criterion as jcrit
from bigdl_tpu.optim import SGD as JaxSGD
from bigdl_tpu.optim.optimizer import LocalOptimizer as JaxLocalOptimizer
from bigdl_tpu.optim.trigger import Trigger as JaxTrigger
from bigdl_tpu.utils.amp import bf16_params as jax_bf16_params
from bigdl_tpu_torch import convert, kernels
from bigdl_tpu_torch.dataset import DataSet, Sample
from bigdl_tpu_torch.models import TransformerLM, lm_loss_chunked
from bigdl_tpu_torch.nn import (ClassNLLCriterion, CrossEntropyCriterion,
                                LMCriterion, TimeDistributedMaskCriterion)
from bigdl_tpu_torch.nn import attention as tattn
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Optimizer, Trigger
from bigdl_tpu_torch.utils.amp import bf16_params

torch.set_num_threads(1)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
CRIT_TOL = dict(atol=1e-5, rtol=1e-5)
V, H, MAXLEN = 48, 32, 64
CFG = dict(vocab_size=V, hidden_size=H, num_heads=4, filter_size=64,
           num_layers=2, max_len=MAXLEN)
ARCHS = {
    "mha_sinusoidal_relu": {},
    "gqa_rope_swiglu": dict(num_kv_heads=2, pos_encoding="rope",
                            ffn_activation="swiglu"),
}


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _pair(seed=0, **kw):
    cfg = dict(CFG, **kw)
    jm = JaxLM(**cfg)
    jp, _ = jm.init(jax.random.PRNGKey(seed))
    tm = TransformerLM(device="cpu", **cfg)
    tm.load_state_dict(convert.jax_to_state_dict(_np(jp)))
    return jm, jp, tm


def _batch(seed, B=2, T=13):
    rng = np.random.RandomState(seed)
    x = rng.randint(1, V, (B, T)).astype(np.int32)
    y = rng.randint(0, V, (B, T)).astype(np.int32)   # 0 = padding
    return x, y


def _port_grads(loss, params):
    leaves = convert.flatten(params)
    return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def _assert_tree_close(got: dict, want_tree, **tol):
    want = convert.flatten(_np(want_tree))
    assert set(got) == set(want)
    for name, g in got.items():
        torch.testing.assert_close(g.detach(), _t(want[name]), **tol,
                                   msg=lambda m: f"{name}: {m}")


def _jax_loss_and_grads(jm, jp, x, y):
    def loss_fn(p):
        out, _ = jm.apply(p, {}, jnp.asarray(x), training=True,
                          rng=jax.random.PRNGKey(0))
        return jcrit.LMCriterion()._forward(out, jnp.asarray(y))
    return jax.jit(jax.value_and_grad(loss_fn))(jp)  # jit: 7x faster


# -- the two faults of the serving slice ---------------------------------------

def test_bf16_params_carries_gradients_to_float32_masters():
    rng = np.random.RandomState(0)
    tree = {"w": rng.randn(3, 4).astype(np.float32),
            "sub": {"b": rng.randn(4).astype(np.float32)}}
    c = rng.randn(3, 4).astype(np.float32)

    def jf(p):
        p16 = jax_bf16_params(p)
        return jnp.sum(p16["w"].astype(jnp.float32) ** 2 * c) + jnp.sum(
            p16["sub"]["b"].astype(jnp.float32) * 3.0)
    want = jax.grad(jf)(jax.tree_util.tree_map(jnp.asarray, tree))
    tp = {"w": _t(tree["w"]).requires_grad_(),
          "sub": {"b": _t(tree["sub"]["b"]).requires_grad_()}}
    p16 = bf16_params(tp)
    assert p16["w"].dtype == torch.bfloat16
    loss = (p16["w"].float() ** 2 * _t(c)).sum() + (p16["sub"]["b"].float()
                                                    * 3.0).sum()
    got = _port_grads(loss, tp)
    assert all(g.dtype == torch.float32 for g in got.values())
    _assert_tree_close(got, want, atol=0, rtol=1e-6)


def test_hidden_states_in_training_is_differentiable():
    _, _, tm = _pair()
    x, _ = _batch(1)
    h = tm.hidden_states(tm.params, x, training=True)
    assert h.requires_grad
    g = torch.autograd.grad(h.square().sum(), tm.params["block0"]["attn"]
                            ["wq"])[0]
    assert torch.isfinite(g).all() and g.abs().sum() > 0


# -- model gradients against jax.value_and_grad ---------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_gradients_match_jax(arch):
    jm, jp, tm = _pair(**ARCHS[arch])
    x, y = _batch(2)
    jl, jg = _jax_loss_and_grads(jm, jp, x, y)
    kernels.reset_launch_counts()
    loss = LMCriterion()._forward(tm.call(tm.params, x, training=True), y)
    torch.testing.assert_close(loss.detach(), _t(jl), **GRAD_TOL)
    _assert_tree_close(_port_grads(loss, tm.params), jg, **GRAD_TOL)
    assert set(kernels.launch_counts().values()) == {0}


def test_model_gradients_match_jax_pallas_flash_interpret(monkeypatch):
    """The JAX side through its flash custom_vjp (Pallas forward and
    backward kernels in interpret mode) rather than its einsum path."""
    monkeypatch.setenv("BIGDL_TPU_FLASH", "interpret")
    jm, jp, tm = _pair(seed=1, num_layers=1)
    x, y = _batch(3, B=1, T=10)
    jl, jg = _jax_loss_and_grads(jm, jp, x, y)
    loss = LMCriterion()._forward(tm.call(tm.params, x, training=True), y)
    torch.testing.assert_close(loss.detach(), _t(jl), **GRAD_TOL)
    _assert_tree_close(_port_grads(loss, tm.params), jg, **GRAD_TOL)


def _loss_and_grads(tm, x, y, generator=None):
    loss = LMCriterion()._forward(
        tm.call(tm.params, x, training=True, generator=generator), y)
    return loss, _port_grads(loss, tm.params)


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_remat_gives_the_same_gradients(dropout):
    """remat recomputes each block in the backward; with dropout the
    recomputation must replay the same masks from the run's generator."""
    _, jp, tm = _pair(seed=2)
    tr = TransformerLM(device="cpu", remat=True, dropout=dropout, **CFG)
    tr.load_state_dict(tm.state_dict())
    tp = TransformerLM(device="cpu", dropout=dropout, **CFG)
    tp.load_state_dict(tm.state_dict())
    x, y = _batch(4)
    gen = lambda: torch.Generator().manual_seed(7)
    l0, g0 = _loss_and_grads(tp, x, y, gen())
    l1, g1 = _loss_and_grads(tr, x, y, gen())
    torch.testing.assert_close(l1, l0, atol=0, rtol=0)
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], atol=1e-6, rtol=1e-6)


def test_dropout_invariants(monkeypatch):
    """Dropout cannot match JAX's bits; its invariants: flash is bypassed
    exactly when dropout is live, each element is kept with probability
    1 - p and scaled by 1 / (1 - p), and evaluation is unchanged."""
    _, _, base = _pair(seed=3)
    tm = TransformerLM(device="cpu", dropout=0.25, **CFG)
    tm.load_state_dict(base.state_dict())
    x, _ = _batch(5)
    flash_calls = []
    real = tattn.flash_attention
    monkeypatch.setattr(tattn, "flash_attention", lambda *a, **k: (
        flash_calls.append(1), real(*a, **k))[1])
    p = tm.params
    with torch.no_grad():
        ref = base.call(base.params, x)
        flash_calls.clear()
        evals = [tm.call(p, x), tm.call(p, x, training=False,
                                        generator=torch.Generator()),
                 tm.call(p, x, training=True)]
        assert len(flash_calls) == 3 * 2            # 2 blocks each
        drop = tm.call(p, x, training=True,
                       generator=torch.Generator().manual_seed(1))
        assert len(flash_calls) == 6                # bypassed
    for e in evals:
        torch.testing.assert_close(e, ref, atol=0, rtol=0)
    assert not torch.allclose(drop, ref, atol=1e-3)
    ones = torch.ones(200_000)
    out = tattn.dropout(ones, 0.25, torch.Generator().manual_seed(0))
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.005   # ~5 sigma
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 4 / 3))


# -- losses and criteria --------------------------------------------------------

@pytest.mark.parametrize("T,chunk", [(12, 4), (12, 5), (10, 128)])
def test_lm_loss_chunked_matches_jax(T, chunk):
    """T=12 chunk=5 takes the largest divisor (4); targets hold padding
    (id 0)."""
    rng = np.random.RandomState(T + chunk)
    h = rng.randn(2, T, H).astype(np.float32)
    emb = (0.1 * rng.randn(V, H)).astype(np.float32)
    y = rng.randint(0, V, (2, T)).astype(np.int32)
    y[0, :3] = 0
    jl, (jdh, jde) = jax.value_and_grad(
        lambda a, b: jax_lm_loss(a, b, jnp.asarray(y), chunk=chunk),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(emb))
    th, te = _t(h).requires_grad_(), _t(emb).requires_grad_()
    loss = lm_loss_chunked(th, te, y, chunk=chunk)
    dh, de = torch.autograd.grad(loss, (th, te))
    torch.testing.assert_close(loss.detach(), _t(jl), **CRIT_TOL)
    torch.testing.assert_close(dh, _t(jdh), **CRIT_TOL)
    torch.testing.assert_close(de, _t(jde), **CRIT_TOL)
    full = LMCriterion()._forward(th @ te.T, y)
    torch.testing.assert_close(loss, full, **CRIT_TOL)


def _criteria_cases():
    rng = np.random.RandomState(11)
    C = 6
    logits = rng.randn(8, C).astype(np.float32)
    logp = np.log(np.exp(logits) / np.exp(logits).sum(-1, keepdims=True))
    t1 = rng.randint(1, C + 1, 8).astype(np.int32)
    t1[2] = -1                                      # ClassNLL padding
    w = rng.rand(C).astype(np.float32) + 0.5
    seq = rng.randn(2, 5, C).astype(np.float32)
    tseq = rng.randint(1, C + 1, (2, 5)).astype(np.int32)
    tseq[1, 3:] = 0                                 # time padding
    lm_t = rng.randint(0, C, (2, 5)).astype(np.int32)
    return {
        "nll": (lambda m: m.ClassNLLCriterion(), logp, t1),
        "nll_weights_sum": (lambda m: m.ClassNLLCriterion(
            weights=w, size_average=False), logp, t1),
        "nll_probs": (lambda m: m.ClassNLLCriterion(
            log_prob_as_input=False), np.exp(logp), t1),
        "cross_entropy": (lambda m: m.CrossEntropyCriterion(weights=w),
                          logits, t1),
        "lm": (lambda m: m.LMCriterion(), seq, lm_t),
        "time_masked_nll": (lambda m: m.TimeDistributedMaskCriterion(
            m.ClassNLLCriterion()), seq, tseq),
        "time_masked_ce": (lambda m: m.TimeDistributedMaskCriterion(
            m.CrossEntropyCriterion()), seq, tseq),
    }


class _PortCriteria:
    ClassNLLCriterion = ClassNLLCriterion
    CrossEntropyCriterion = CrossEntropyCriterion
    LMCriterion = LMCriterion
    TimeDistributedMaskCriterion = TimeDistributedMaskCriterion


@pytest.mark.parametrize("case", sorted(_criteria_cases()))
def test_criteria_match_jax(case):
    make, inp, tgt = _criteria_cases()[case]
    jc, tc = make(jcrit), make(_PortCriteria)
    want = jc.forward(jnp.asarray(inp), jnp.asarray(tgt))
    want_gi = jc.backward(jnp.asarray(inp), jnp.asarray(tgt))
    got = tc.forward(_t(inp), tgt)
    got_gi = tc.backward(_t(inp), torch.from_numpy(tgt))
    torch.testing.assert_close(got, _t(want), **CRIT_TOL)
    torch.testing.assert_close(got_gi, _t(want_gi), **CRIT_TOL)
    assert tc(_t(inp), tgt) is tc.output


# -- the LocalOptimizer loop ------------------------------------------------------

def _lm_samples(mod_sample, n=16, T=12, seed=21):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, V, (n, T + 1)).astype(np.int32)
    return [mod_sample(ids[i, :-1], ids[i, 1:]) for i in range(n)]


def _recording_end(trigger_cls, iters, losses):
    def fn(state):
        losses.append(state["loss"])
        return state["neval"] >= iters
    return trigger_cls(fn)


def test_local_optimizer_matches_jax():
    jm, jp, tm = _pair(seed=4)
    jm.params, jm.state = jp, {}
    jl, tl = [], []
    JaxLocalOptimizer(jm, JaxDataSet.array(_lm_samples(JaxSample)),
                      jcrit.LMCriterion(),
                      JaxSGD(learningrate=0.1, momentum=0.9),
                      _recording_end(JaxTrigger, 3, jl),
                      batch_size=4).optimize()
    opt = LocalOptimizer(tm, DataSet.array(_lm_samples(Sample)),
                         LMCriterion(), SGD(learningrate=0.1, momentum=0.9),
                         _recording_end(Trigger, 3, tl), batch_size=4,
                         device="cpu")
    assert opt.optimize() is tm
    assert len(tl) == len(jl) == 3 and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
    got = convert.to_numpy_tree(tm.params)
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4),
        got, _np(jm.params))
    state = opt.optim_method.state
    assert state["neval"] == 3 and state["epoch"] == 1
    assert len(opt.metrics.values["step_time"]) == 3


class _NaNCriterion(LMCriterion):
    def _forward(self, input, target):
        return super()._forward(input, target) * float("nan")


def test_nan_policy_skip_keeps_params_and_error_raises():
    _, _, tm = _pair(seed=5)
    before = {k: v.detach().clone()
              for k, v in convert.flatten(tm.params).items()}
    data = DataSet.array(_lm_samples(Sample, n=8))
    end = Trigger(lambda s: s["neval"] >= 3)
    opt = Optimizer(model=tm, training_set=data, criterion=_NaNCriterion(),
                    optim_method=SGD(learningrate=0.1, momentum=0.9),
                    end_trigger=end, batch_size=4, device="cpu")
    assert isinstance(opt, LocalOptimizer)
    opt.set_nan_policy("skip").optimize()
    # as in the JAX loop, a skipped step counts but the end trigger is
    # next asked at the epoch's end: two epochs of two batches
    assert opt.optim_method.state["neval"] == 4
    assert len(opt.metrics.values["nan_skips"]) == 4
    for k, v in convert.flatten(tm.params).items():
        assert torch.equal(v.detach(), before[k]), k
    opt.set_model(tm).set_nan_policy("error")
    with pytest.raises(FloatingPointError, match="non-finite"):
        opt.optimize()


def test_optimizer_needs_a_card_unless_cpu_is_asked(monkeypatch):
    _, _, tm = _pair(seed=6)
    data = DataSet.array(_lm_samples(Sample, n=4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LocalOptimizer(tm, data, LMCriterion(), batch_size=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Optimizer.create(tm, data, LMCriterion(), batch_size=4)
