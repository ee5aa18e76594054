"""The port's padded ``Table`` batches, validation methods, ``Evaluator``
and the ``LocalOptimizer`` loop with ``set_validation`` against the JAX
package.

Every input is made with numpy from a seed and fed to both sides; the JAX
parameters are carried into the port with ``bigdl_tpu_torch.convert``.
Tolerances:

* batches: the arrays equal, values and dtypes;
* validation methods on the same (output, target) pairs: counts exactly,
  losses within atol = rtol = 1e-6 (one float32 reduction, or NDCG's
  float32 logs against the host's float64), the device statistics against
  the host path the same way;
* ``Evaluator`` on the tiny translation model: counts exactly, the loss
  within 1e-5 relative (a float32 forward of two blocks each side);
* the 4-step ``LocalOptimizer`` run: losses and validation losses within
  atol = rtol = 1e-4 (updates at lr 0.1 carry the gradient differences),
  validation accuracies exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.dataset import (DataSet as JaxDataSet, MiniBatch as JaxMB,
                               PaddingParam as JaxPad, Sample as JaxSample,
                               ShardedDataSet as JaxSharded)
from bigdl_tpu.dataset.transformer import SampleToMiniBatch as JaxS2MB
from bigdl_tpu.nn import criterion as jcrit
from bigdl_tpu.nn.attention import Transformer as JaxTransformer
from bigdl_tpu.optim import SGD as JaxSGD
from bigdl_tpu.optim import validation as jval
from bigdl_tpu.optim.optimizer import LocalOptimizer as JaxLocalOptimizer
from bigdl_tpu.optim import trigger as jtrig
from bigdl_tpu.utils.table import Table as JaxTable
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.dataset import (DataSet, MiniBatch, PaddingParam,
                                     Sample, SampleToMiniBatch,
                                     ShardedDataSet)
from bigdl_tpu_torch.nn import Transformer
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, trigger
from bigdl_tpu_torch.optim import validation as tval
from bigdl_tpu_torch.optim.evaluator import Evaluator, LocalValidator
from bigdl_tpu_torch.utils.table import Table

torch.set_num_threads(1)
METHOD_TOL = dict(atol=1e-6, rtol=1e-6)
LOOP_TOL = dict(atol=1e-4, rtol=1e-4)
V, H, HEADS, FILTER, MAXLEN = 29, 16, 2, 32, 32


def _leaves(x):
    return list(x) if isinstance(x, (Table, JaxTable)) else [x]


def _same_batch(got, want):
    for g, w in ((got.input, want.input), (got.target, want.target)):
        assert isinstance(g, Table) == isinstance(w, JaxTable)
        for a, b in zip(_leaves(g), _leaves(w), strict=True):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _pairs_samples(seed, n, mod_sample, labels=1):
    """(src, tgt_in) features and ``labels`` label arrays of varying
    lengths; ids in 1..V-1 (0 is padding)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ls, lt = rng.randint(3, 8), rng.randint(2, 7)
        src = rng.randint(1, V, ls).astype(np.int32)
        tgt = rng.randint(1, V, lt + 1).astype(np.int32)
        labs = [tgt[1:]] + [rng.randn(2).astype(np.float32)
                            for _ in range(labels - 1)]
        out.append(mod_sample([src, tgt[:-1]],
                              labs if labels > 1 else labs[0]))
    return out


# -- batches -----------------------------------------------------------------

@pytest.mark.parametrize("pad", [None, (0, None), (-1, 9), (7, [3, 8])],
                         ids=["no_param", "value", "fixed", "fixed_list"])
def test_table_minibatches_and_padding_equal_jax(pad):
    ts = _pairs_samples(1, 5, Sample, labels=2)
    js = _pairs_samples(1, 5, JaxSample, labels=2)
    tp = None if pad is None else PaddingParam(*pad)
    jp = None if pad is None else JaxPad(*pad)
    got = MiniBatch.from_samples(ts, tp, tp)
    want = JaxMB.from_samples(js, jp, jp)
    _same_batch(got, want)
    assert got.size() == want.size() == 5
    _same_batch(got.slice(2, 3), want.slice(2, 3))
    assert repr(got) == repr(want)


def test_sample_to_minibatch_and_sharded_padding_equal_jax():
    ts = _pairs_samples(2, 7, Sample)
    js = _pairs_samples(2, 7, JaxSample)
    pad_t, pad_j = PaddingParam(0), JaxPad(0)
    got = list(SampleToMiniBatch(3, pad_t, pad_t).apply(iter(ts)))
    want = list(JaxS2MB(3, pad_j, pad_j).apply(iter(js)))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same_batch(g, w)
    tb = ShardedDataSet(DataSet.array(ts), 3, feature_padding=pad_t,
                        label_padding=pad_t)
    jb = JaxSharded(JaxDataSet.array(js), 3, feature_padding=pad_j,
                    label_padding=pad_j)
    tb.shuffle()
    jb.shuffle()
    for g, w in zip(tb.data(train=True), jb.data(train=True), strict=True):
        _same_batch(g, w)
    # equal shapes stack as they are; one feature and one label stay arrays
    one = MiniBatch.from_samples([Sample(np.ones(3), 1), Sample(np.zeros(3),
                                                                 2)])
    assert one.input.shape == (2, 3) and one.target.tolist() == [1, 2]


# -- the seven validation methods ---------------------------------------------

def _method_cases():
    rng = np.random.RandomState(3)
    logits = rng.randn(6, 8).astype(np.float32)
    logits[0, 2] = logits[0, 5] = logits[0].max() + 1       # a tie
    seq = rng.randn(2, 5, 8).astype(np.float32)
    idx = rng.randint(1, 9, 6).astype(np.int32)
    seq_t = rng.randint(0, 9, (2, 5)).astype(np.int32)
    onehot = np.eye(8, dtype=np.float32)[idx - 1]
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    scores = rng.randn(2 * 11).astype(np.float32)
    scores[5] = scores[7]                                    # rank tie
    mark = np.zeros(22, np.float32)
    mark[[3, 15]] = 1.0
    reg = rng.randn(6, 3).astype(np.float32)
    tree = rng.randn(4, 3, 5).astype(np.float32)
    tree_t = rng.randint(1, 6, (4, 3)).astype(np.int32)
    binary = rng.rand(4, 1).astype(np.float32)
    return {
        "top1_index": ("Top1Accuracy", (), logits, idx),
        "top1_onehot": ("Top1Accuracy", (), logits, onehot),
        "top1_sequence": ("Top1Accuracy", (), seq, seq_t),
        "top5_index": ("Top5Accuracy", (), logits, idx),
        "top5_sequence": ("Top5Accuracy", (), seq, seq_t),
        "loss_nll": ("Loss", (), logp, idx),
        "loss_cross_entropy": ("Loss", ("CrossEntropyCriterion",), logits,
                               idx),
        "mae": ("MAE", (), reg, reg[::-1].copy()),
        "hit_ratio": ("HitRatio", (5, 10), scores, mark),
        "ndcg": ("NDCG", (5, 10), scores, mark),
        "tree_nn": ("TreeNNAccuracy", (), tree, tree_t),
        "tree_nn_binary": ("TreeNNAccuracy", (), binary,
                           (binary[:, 0] > 0.3).astype(np.int64)),
    }


CASES = _method_cases()


def _build(mod, crit_mod, name, args):
    if name == "Loss" and args:
        return getattr(mod, name)(getattr(crit_mod, args[0])())
    return getattr(mod, name)(*args)


def _assert_result(got, want):
    assert type(got).__name__ == type(want).__name__
    assert got.count == want.count
    if hasattr(want, "correct"):
        assert got.correct == want.correct
    else:
        np.testing.assert_allclose(got.loss, want.loss, **METHOD_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_validation_methods_match_jax_host_and_device(case):
    from bigdl_tpu_torch import nn as tnn
    name, args, out, tgt = CASES[case]
    jm = _build(jval, jcrit, name, args)
    tm = _build(tval, tnn, name, args)
    assert repr(tm) == repr(jm)
    want = jm(out, tgt)
    got = tm(torch.from_numpy(out), tgt)
    _assert_result(got, want)
    assert tm.supports_device_stats() == jm.supports_device_stats()
    if not jm.supports_device_stats():
        return
    jdev = jm.result_from_stats(np.asarray(
        jm.device_stats(jnp.asarray(out), jnp.asarray(tgt))))
    stats = tm.device_stats(torch.from_numpy(out), torch.from_numpy(tgt))
    assert stats.dtype == torch.float32 and stats.dim() == 1
    tdev = tm.result_from_stats(stats)
    _assert_result(tdev, jdev)
    _assert_result(tdev, got)          # the device path equals the host's
    # results merge across batches
    both = got + tdev
    assert both.count == 2 * got.count


def test_results_print_and_merge_as_jax():
    a, b = tval.AccuracyResult(3, 4), jval.AccuracyResult(3, 4)
    assert repr(a) == repr(b) and (a + a).result() == (b + b).result()
    assert a == tval.AccuracyResult(3, 4)
    l, m = tval.LossResult(2.5, 5), jval.LossResult(2.5, 5)
    assert repr(l) == repr(m) and (l + l).result() == (m + m).result()
    assert isinstance(tval.ContiguousResult(1.0, 1), tval.LossResult)


# -- Evaluator ----------------------------------------------------------------

def _translation_pair(seed=0):
    jm = JaxTransformer(V, H, HEADS, FILTER, 2, mode="translation",
                        max_len=MAXLEN)
    jp, _ = jm.init(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(100 + seed)
    jp = jax.tree_util.tree_map(
        lambda a: (0.3 * rng.randn(*a.shape)).astype(np.float32), jp)
    tm = Transformer(V, H, HEADS, FILTER, 2, mode="translation",
                     max_len=MAXLEN, device="cpu")
    tm.load_state_dict(convert.jax_to_state_dict(jp))
    jm.params, jm.state = jp, {}
    return jm, tm


def _seq_methods(mod, crit):
    return [mod.Loss(crit.TimeDistributedMaskCriterion(
        crit.CrossEntropyCriterion(), padding_value=0)),
        mod.Top1Accuracy(), mod.Top5Accuracy()]


@pytest.mark.parametrize("device_path", [True, False],
                         ids=["device_stats", "host"])
def test_evaluator_matches_jax_on_the_translation_model(device_path):
    from bigdl_tpu_torch import nn as tnn
    jm, tm = _translation_pair()
    jmeth, tmeth = _seq_methods(jval, jcrit), _seq_methods(tval, tnn)
    if not device_path:             # TreeNNAccuracy sends all to the host
        jmeth.append(jval.TreeNNAccuracy())
        tmeth.append(tval.TreeNNAccuracy())
    js = JaxDataSet.array(_pairs_samples(5, 10, JaxSample))
    ts = DataSet.array(_pairs_samples(5, 10, Sample))
    want = jm.evaluate_dataset(js, jmeth, batch_size=4)
    got = tm.evaluate_dataset(ts, tmeth, batch_size=4)
    for g, w in zip(got, want, strict=True):
        assert g.count == w.count
        if hasattr(w, "correct"):
            assert g.correct == w.correct
        else:
            np.testing.assert_allclose(g.loss, w.loss, rtol=1e-5)
    again = LocalValidator(tm).evaluate(ts, tmeth, batch_size=4)
    assert [r.result() for r in again] == [r.result() for r in got]
    assert Evaluator(tm).evaluate(DataSet.array([]), tmeth) == \
        [None] * len(tmeth)
    # the inline stager evaluates what the lookahead thread does
    serial = Evaluator(tm, prefetch_depth=0).evaluate(ts, tmeth, batch_size=4)
    assert [r.result() for r in serial] == [r.result() for r in got]


# -- LocalOptimizer with set_validation ----------------------------------------

def _run(mod, optim_mod, dataset_mod, crit_mod, model, trig_mod, val_mod,
         iters, losses, scores, sharded):
    samples = _pairs_samples(7, 12, dataset_mod.Sample)
    held = _pairs_samples(8, 6, dataset_mod.Sample)
    pad = dataset_mod.PaddingParam(0)
    train = sharded(dataset_mod.DataSet.array(samples), 4,
                    feature_padding=pad, label_padding=pad)

    def end(state):      # asked after each step and at the epoch's end
        losses[state["neval"]] = state["loss"]
        return state["neval"] >= iters
    opt = optim_mod(model, train, crit_mod.TimeDistributedMaskCriterion(
        crit_mod.CrossEntropyCriterion(), padding_value=0),
        mod(learningrate=0.1), trig_mod.Trigger(end), batch_size=4,
        **({} if mod is JaxSGD else {"device": "cpu"}))
    opt.set_validation(trig_mod.several_iteration(2), held,
                       _seq_methods(val_mod, crit_mod)[:2], batch_size=4)
    real = opt._validate

    def validate(state):
        out = real(state)
        scores.append((dict(out), state["score"]))
        return out
    opt._validate = validate
    opt.optimize()
    return opt


def test_local_optimizer_with_validation_matches_jax():
    from bigdl_tpu import dataset as jds
    from bigdl_tpu_torch import dataset as tds
    from bigdl_tpu_torch import nn as tnn
    jm, tm = _translation_pair(1)
    jl, tl, jsc, tsc = {}, {}, [], []
    _run(JaxSGD, JaxLocalOptimizer, jds, jcrit, jm, jtrig, jval, 4, jl, jsc,
         JaxSharded)
    opt = _run(SGD, LocalOptimizer, tds, tnn, tm, trigger, tval, 4, tl, tsc,
               ShardedDataSet)
    assert list(tl) == list(jl) == [1, 2, 3, 4] and tl[4] < tl[1]
    np.testing.assert_allclose(list(tl.values()), list(jl.values()),
                               **LOOP_TOL)
    assert len(tsc) == len(jsc) == 2            # at iterations 2 and 4
    for (got, gscore), (want, wscore) in zip(tsc, jsc):
        assert list(got) == list(want) == ["Loss", "Top1Accuracy"]
        np.testing.assert_allclose(got["Loss"], want["Loss"], **LOOP_TOL)
        assert got["Top1Accuracy"] == want["Top1Accuracy"]
        np.testing.assert_allclose(gscore, wscore, **LOOP_TOL)
    assert opt.optim_method.state["score"] == tsc[-1][1]
    assert bool(tm.training)                    # back in training mode
    got = convert.to_numpy_tree(tm.params)
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, w, **LOOP_TOL),
        got, jax.tree_util.tree_map(np.asarray, jm.params))


@pytest.mark.parametrize("validate", [True, False],
                         ids=["with_validation", "without"])
def test_max_score_stops_a_run_once_validation_writes_the_score(validate):
    """``max_score`` reads ``state["score"]``, which only validation
    writes: with it the run stops after the first validation, as JAX's
    does; without it the run goes on to ``max_iteration``."""
    from bigdl_tpu_torch import nn as tnn
    outcomes = []
    for pkg in ("jax", "port"):
        jm, tm = _translation_pair(2)
        if pkg == "jax":
            opt = JaxLocalOptimizer(
                jm, JaxSharded(JaxDataSet.array(_pairs_samples(
                    9, 8, JaxSample)), 4, feature_padding=JaxPad(0),
                    label_padding=JaxPad(0)),
                jcrit.TimeDistributedMaskCriterion(
                    jcrit.CrossEntropyCriterion(), 0), JaxSGD(0.1),
                jtrig.or_(jtrig.max_iteration(3), jtrig.max_score(-1.0)),
                batch_size=4)
            methods = [jval.Top1Accuracy()]
            every = jtrig.several_iteration(1)
        else:
            opt = LocalOptimizer(
                tm, ShardedDataSet(DataSet.array(_pairs_samples(
                    9, 8, Sample)), 4, feature_padding=PaddingParam(0),
                    label_padding=PaddingParam(0)),
                tnn.TimeDistributedMaskCriterion(
                    tnn.CrossEntropyCriterion(), 0), SGD(0.1),
                trigger.or_(trigger.max_iteration(3),
                            trigger.max_score(-1.0)),
                batch_size=4, device="cpu")
            methods = [tval.Top1Accuracy()]
            every = trigger.several_iteration(1)
        if validate:
            opt.set_validation(every, _pairs_samples(
                10, 4, JaxSample if pkg == "jax" else Sample), methods)
        opt.optimize()
        st = opt.optim_method.state
        outcomes.append((st["neval"], "score" in st))
    assert outcomes[0] == outcomes[1] == ((1, True) if validate
                                          else (3, False))
