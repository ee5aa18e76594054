"""The optim methods this slice ports (``Adagrad``, ``Adadelta``,
``Adamax``, ``RMSprop``, ``Ftrl``, ``LarsSGD``, ``ParallelAdam``), the
``Plateau`` schedule, ``current_lr_vector`` and the device-side NaN guard
against the JAX package's.

Tolerances: an update sequence on a parameter tree within 1e-6 (float32
on both sides, the same elementwise formulas; a few ulps at magnitudes of
order 1), a training run within 1e-5, learning rates within 1e-12
relative (host float64 on both sides), state tree names exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.optim as jo
import bigdl_tpu_torch.optim as to
from bigdl_tpu.optim import optim_method as jom
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.optim.optim_method import write_guarded
from tests.torch_loop_helpers import (assert_close, data_pair, mlp,
                                      optimizers, twins, vector_batches)

torch.set_num_threads(1)
STEP_TOL = dict(atol=1e-6, rtol=1e-6)

METHODS = {
    "adagrad": lambda o: o.Adagrad(0.1, learningrate_decay=0.01,
                                   weightdecay=0.01),
    "adadelta": lambda o: o.Adadelta(0.9, 1e-6),
    "adamax": lambda o: o.Adamax(0.01),
    "rmsprop": lambda o: o.RMSprop(0.01, 0.01, 0.9),
    "ftrl": lambda o: o.Ftrl(0.1, -0.5, 0.1, 0.01, 0.02, 0.01),
    "lars_sgd": lambda o: o.LarsSGD(0.1, 0.5, 0.9, 0.01),
    "parallel_adam": lambda o: o.ParallelAdam(0.01),
    "adam": lambda o: o.Adam(0.01),
}


def _tree(rng):
    return {"w": rng.randn(3, 4).astype(np.float32),
            "blk": {"b": rng.randn(4).astype(np.float32),
                    "m": rng.randn(2, 2, 3).astype(np.float32)}}


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("name", sorted(METHODS))
def test_update_sequence_matches_jax(name):
    """Five updates of the same gradients; a sixth gradient with a NaN
    goes through the guard (the loss is not finite), which keeps every
    tensor, the step counter ``t`` too; then one more update. Parameters
    and every state leaf, under JAX's state names, within 1e-6."""
    jm, tm = METHODS[name](jom), METHODS[name](to)
    rng = np.random.RandomState(len(name))
    p0 = _tree(rng)
    grads = [_tree(rng) for _ in range(6)]
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = jm.init_state(jp)
    tp = _torch(p0)
    ts = tm.init_state(tp)
    assert sorted(ts) == sorted(js)
    for i, g in enumerate(grads):
        lr = 0.1 / (1 + i)
        if i == 5:      # the guarded step JAX never sees applied
            bad = jax.tree_util.tree_map(lambda a: a * np.nan, g)
            write_guarded(tm._updates(_torch(bad), tp, ts, lr),
                          torch.isfinite(torch.tensor(np.nan)))
            continue
        jp, js = jm.update(jax.tree_util.tree_map(jnp.asarray, g), jp, js,
                           jnp.float32(lr))
        out, ts = tm.update(_torch(g), tp, ts, lr)
        assert out is tp
    got = convert.to_numpy_tree(tp)
    assert_close(got, jp, STEP_TOL, "params")
    for key in js:
        if key == "t":
            assert ts["t"].dtype == torch.int32
            assert int(ts["t"]) == int(js["t"]) == 5
        else:
            assert_close(convert.to_numpy_tree(ts[key]), js[key], STEP_TOL,
                         key)


@pytest.mark.parametrize("name", sorted(METHODS))
def test_method_trains_like_jax(name):
    """Six iterations of the MLP through each package's loop with the
    method: losses read, parameters and optimizer state within 1e-5."""
    jm, tm, _ = twins(mlp)
    jopt, topt = optimizers(jm, tm, data_pair(vector_batches(6)),
                            lambda p: p.CrossEntropyCriterion(),
                            METHODS[name], lambda o: o.max_iteration(6), 8,
                            set_prefetch=(0,))
    jopt.optimize()
    topt.optimize()
    np.testing.assert_allclose(topt.optim_method.state["loss"],
                               jopt.optim_method.state["loss"], rtol=1e-5)
    assert_close(convert.to_numpy_tree(tm.params), jm.params)


def test_plateau_on_the_validation_score_trains_like_jax():
    """SGD under ``Plateau('score', mode='max')`` fed by a validation
    every 2 iterations: the rates the schedule gives and the parameters
    equal JAX's loop's."""
    from bigdl_tpu.dataset import Sample as JS
    from bigdl_tpu_torch.dataset import Sample as TS
    held = vector_batches(2, seed=9)
    jm, tm, _ = twins(mlp)
    method = lambda o: o.SGD(0.2, learningrate_schedule=o.Plateau(
        "score", factor=0.5, patience=1, mode="max", epsilon=0.5))
    jopt, topt = optimizers(jm, tm, data_pair(vector_batches(8)),
                            lambda p: p.CrossEntropyCriterion(), method,
                            lambda o: o.max_iteration(8), 8,
                            set_prefetch=(0,))
    jopt.set_validation(jo.several_iteration(2),
                        [JS(x, y) for xb, yb in held for x, y in zip(xb, yb)],
                        [jo.Top1Accuracy()])
    topt.set_validation(to.several_iteration(2),
                        [TS(x, y) for xb, yb in held for x, y in zip(xb, yb)],
                        [to.Top1Accuracy()])
    rates = {}
    for key, opt in (("jax", jopt), ("port", topt)):
        m, rates[key] = opt.optim_method, []
        orig = m.current_lr
        m.current_lr = lambda orig=orig, r=rates[key]: r.append(orig()) \
            or r[-1]
        opt.optimize()
    np.testing.assert_allclose(rates["port"], rates["jax"], rtol=1e-12)
    assert rates["port"][-1] < rates["port"][0]
    assert topt.optim_method.state["score"] == \
        jopt.optim_method.state["score"]
    assert_close(convert.to_numpy_tree(tm.params), jm.params)


def test_plateau_schedule_and_force_reduction_match_jax():
    jp = jom.Plateau("loss", factor=0.5, patience=2, cooldown=1, min_lr=0.01)
    tp = to.Plateau("loss", factor=0.5, patience=2, cooldown=1, min_lr=0.01)
    rng = np.random.RandomState(3)
    for i in range(30):
        s = {"neval": i, "epoch": 1, "loss": float(rng.choice([1.0, 0.5,
                                                                 2.0]))}
        assert tp.update_lr(0.1, s) == jp.update_lr(0.1, s)
        if i in (7, 19):
            assert tp.force_reduction() == jp.force_reduction()
    assert (tp.best, tp.wait, tp.cooldown_counter, tp.multiplier) == \
        (jp.best, jp.wait, jp.cooldown_counter, jp.multiplier)
    assert tp.update_lr(0.1, {"neval": 0, "epoch": 1}) == \
        jp.update_lr(0.1, {"neval": 0, "epoch": 1})


@pytest.mark.parametrize("k", [1, 3, 5])
def test_current_lr_vector_matches_jax(k):
    for build in (lambda o: o.SGD(0.1, learningrate_decay=0.1),
                  lambda o: o.SGD(0.1, learningrate_schedule=o.Poly(0.5, 6)),
                  lambda o: o.Adam(0.01, learningrate_decay=0.2),
                  lambda o: o.RMSprop(0.01, 0.3)):
        jm, tm = build(jo), build(to)
        for m in (jm, tm):
            m.state["neval"] = 2
        np.testing.assert_allclose(tm.current_lr_vector(k),
                                   jm.current_lr_vector(k), rtol=1e-12)
        assert tm.state["neval"] == 2


def test_write_guarded_keeps_every_tensor_on_a_non_finite_loss():
    """The guard gathers per dtype (float32 and bfloat16 parameters, an
    int32 counter): with ok false every tensor keeps its bits, with ok
    true each takes its new value cast to its own dtype."""
    a = torch.randn(3, 4)
    b = torch.randn(5).to(torch.bfloat16)
    t = torch.zeros((), dtype=torch.int32)
    old = [a.clone(), b.clone(), t.clone()]
    pairs = [(a, a * np.nan), (b, b.float() + 1), (t, t + 1)]
    write_guarded(pairs, torch.tensor(False))
    for x, y in zip((a, b, t), old):
        assert torch.equal(x, y)
    new_a = a * 2
    write_guarded([(a, new_a), (b, b.float() + 1), (t, t + 1)],
                  torch.tensor(True))
    assert torch.equal(a, new_a) and int(t) == 1
    assert b.dtype == torch.bfloat16
    assert torch.equal(b, (old[1].float() + 1).to(torch.bfloat16))
