"""The port's optim methods, schedules, triggers, gradient clipping and data
sets against the JAX package.

Tolerances: parameters and optimizer state within 1e-6 after 5 steps of
the same gradient sequence (float32 on both sides, the same elementwise
formulas; a few ulps at magnitudes of order 1); learning rates within
1e-12 relative (host float64 on both sides); triggers and batch orders
exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.dataset import DataSet as JaxDataSet, Sample as JaxSample
from bigdl_tpu.dataset.dataset import (LocalDataSet as JaxLocalDataSet,
                                       ShardedDataSet as JaxShardedDataSet)
from bigdl_tpu.optim import optim_method as jom
from bigdl_tpu.optim import trigger as jtrig
from bigdl_tpu.optim.optimizer import _clip_grads as jax_clip_grads
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.dataset import DataSet, LocalDataSet, Sample
from bigdl_tpu_torch.dataset import ShardedDataSet
from bigdl_tpu_torch.optim import optim_method as tom
from bigdl_tpu_torch.optim import trigger as ttrig
from bigdl_tpu_torch.optim.optimizer import _clip_grads

torch.set_num_threads(1)
STATE_TOL = dict(atol=1e-6, rtol=1e-6)


def _tree(rng):
    return {"w": rng.randn(3, 4).astype(np.float32),
            "blk": {"b": rng.randn(4).astype(np.float32),
                    "m": rng.randn(2, 2, 3).astype(np.float32)}}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, np.float32))
            for k, v in tree.items()}


def _close(got, want):
    want = convert.flatten(jax.tree_util.tree_map(np.asarray, want))
    got = convert.flatten(got)
    assert set(got) == set(want)
    for k in got:
        torch.testing.assert_close(got[k], torch.from_numpy(
            np.array(want[k], np.float32)), **STATE_TOL, msg=k)


METHODS = {
    "sgd": dict(cls="SGD", kw=dict(learningrate=0.1)),
    "sgd_momentum": dict(cls="SGD", kw=dict(learningrate=0.1, momentum=0.9)),
    "sgd_dampening_wd": dict(cls="SGD", kw=dict(
        learningrate=0.1, momentum=0.9, dampening=0.5, weightdecay=0.01)),
    "sgd_nesterov": dict(cls="SGD", kw=dict(learningrate=0.1, momentum=0.9,
                                            nesterov=True)),
    "adam": dict(cls="Adam", kw=dict(learningrate=0.01)),
    "adamw": dict(cls="AdamW", kw=dict(learningrate=0.01,
                                       weight_decay=0.1)),
}


@pytest.mark.parametrize("name", sorted(METHODS))
def test_optim_methods_match_jax_over_five_steps(name):
    spec = METHODS[name]
    jm = getattr(jom, spec["cls"])(**spec["kw"])
    tm = getattr(tom, spec["cls"])(**spec["kw"])
    rng = np.random.RandomState(len(name))
    p0 = _tree(rng)
    grads = [_tree(rng) for _ in range(5)]
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = jm.init_state(jp)
    tp = _to_torch(p0)
    ts = tm.init_state(tp)
    for i, g in enumerate(grads):
        lr = 0.1 / (1 + i)
        jp, js = jm.update(jax.tree_util.tree_map(jnp.asarray, g), jp, js,
                           jnp.float32(lr))
        out, ts = tm.update(_to_torch(g), tp, ts, lr)
        assert out is tp       # updated in place
    _close(tp, jp)
    for key in ("v", "m"):
        if key in js:
            _close(ts[key], js[key])
    if "t" in js:
        assert ts["t"] == int(js["t"]) == 5


def _schedules(m):
    decay = lambda e: e // 2
    seq = m.SequentialSchedule(iteration_per_epoch=3)
    seq.add(m.Warmup(0.01), 4).add(m.CosineAnnealing(8, min_lr=0.001), 8)
    return {
        "default": None,
        "poly": m.Poly(0.5, 10),
        "step": m.Step(3, 0.5),
        "multistep": m.MultiStep([2, 5, 9], 0.3),
        "epoch_step": m.EpochStep(2, 0.5),
        "epoch_decay": m.EpochDecay(decay),
        "natural_exp": m.NaturalExp(3, 0.2),
        "exponential": m.Exponential(4, 0.5),
        "exponential_stair": m.Exponential(4, 0.5, stair_case=True),
        "cosine_restarts": m.CosineAnnealing(4, 0.01, restarts=True,
                                             t_mult=2.0),
        "sequential": seq,
        "epoch_schedule": m.EpochSchedule([
            m.Regime(1, 2, {"learningRate": 0.05}),
            m.Regime(3, 4, {"learning_rate": 0.02})]),
        "warmup_then_decay": m.EpochDecayWithWarmUp(3, 0.02, decay),
    }


@pytest.mark.parametrize("name", sorted(_schedules(tom)))
def test_lr_schedules_match_jax(name):
    js, ts = _schedules(jom)[name], _schedules(tom)[name]
    jsgd = jom.SGD(0.1, learningrate_decay=0.05, learningrate_schedule=js)
    tsgd = tom.SGD(0.1, learningrate_decay=0.05, learningrate_schedule=ts)
    jl, tl = [], []
    for n in range(14):
        for opt, out in ((jsgd, jl), (tsgd, tl)):
            opt.state["neval"], opt.state["epoch"] = n, n // 3 + 1
            out.append(opt.current_lr())
    np.testing.assert_allclose(tl, jl, rtol=1e-12)
    ja, ta = jom.Adam(0.01, learningrate_decay=0.1), tom.Adam(
        0.01, learningrate_decay=0.1)
    ja.state["neval"] = ta.state["neval"] = 7
    assert ta.get_learning_rate() == ja.get_learning_rate()


def _triggers(m):
    return {
        "every_epoch": m.every_epoch(),
        "several_iteration": m.several_iteration(3),
        "max_epoch": m.max_epoch(2),
        "max_iteration": m.max_iteration(5),
        "max_score": m.max_score(0.5),
        "min_loss": m.min_loss(0.2),
        "and": m.and_(m.max_iteration(3), m.min_loss(0.6)),
        "or": m.TriggerOr(m.MaxEpoch(2), m.MaxScore(0.7)),
    }


@pytest.mark.parametrize("name", sorted(_triggers(ttrig)))
def test_triggers_fire_where_jax_fires(name):
    jt, tt = _triggers(jtrig)[name], _triggers(ttrig)[name]
    states = []
    for n in range(10):
        s = {"neval": n, "epoch": n // 4 + 1, "epoch_finished": n % 4 == 0,
             "loss": 1.0 - 0.1 * n}
        if n % 2:
            s["score"] = 0.1 * n
        states.append(s)
    assert [tt.probe(s) for s in states] == [jt.probe(s) for s in states]
    assert [tt(s) for s in states] == [jt(s) for s in states]


def test_local_dataset_order_and_batches_match_jax():
    rng = np.random.RandomState(5)
    feats = rng.randn(11, 3).astype(np.float32)
    labels = rng.randint(0, 4, 11).astype(np.int32)
    jds = JaxLocalDataSet(list(range(11)), seed=3)
    tds = LocalDataSet(list(range(11)), seed=3)
    for _ in range(3):
        jds.shuffle(), tds.shuffle()
        assert list(tds.data(True)) == list(jds.data(True))
        assert list(tds.data(True)) == list(jds.data(True))   # stable
    assert list(tds.data(False)) == list(range(11))
    jb = JaxShardedDataSet(JaxDataSet.from_arrays(feats, labels), 4)
    tb = ShardedDataSet(DataSet.from_arrays(feats, labels), 4)
    jb.shuffle(), tb.shuffle()
    jbs, tbs = list(jb.data(True)), list(tb.data(True))
    assert len(tbs) == len(jbs) == tb.batches_per_epoch() == 2
    for j, t in zip(jbs, tbs):
        np.testing.assert_array_equal(t.get_input(), j.get_input())
        np.testing.assert_array_equal(t.get_target(), j.get_target())
    arr = DataSet.array([Sample(f, l) for f, l in zip(feats, labels)])
    jarr = JaxDataSet.array([JaxSample(f, l) for f, l in zip(feats, labels)])
    arr.shuffle(), jarr.shuffle()
    assert [s.label() for s in arr.data(True)] == \
        [s.label() for s in jarr.data(True)]
    assert tbs[0].slice(2, 2).size() == 2


@pytest.mark.parametrize("const,norm", [((-0.5, 0.5), None), (None, 1.0),
                                        ((-1.0, 1.0), 0.5), (None, 1e3)])
def test_clip_grads_matches_jax(const, norm):
    g = _tree(np.random.RandomState(9))
    want = jax_clip_grads(jax.tree_util.tree_map(jnp.asarray, g), const,
                          norm)
    _close(_clip_grads(_to_torch(g), const, norm), want)
