"""Transformer chains on the port's data sets against the JAX package's:
``|``, ``arrow``, ``Identity``, ``FuncTransformer`` and
``SampleToMiniBatch`` over a ``TransformedDataSet``, shuffled with the
same seed, give the same elements in the same order, epoch after epoch;
and a chained data set trains through ``LocalOptimizer`` as the plain one
does."""
import numpy as np
import pytest
import torch

from bigdl_tpu.dataset import dataset as jds
from bigdl_tpu.dataset import transformer as jtr
from bigdl_tpu.dataset.sample import Sample as JaxSample
from bigdl_tpu_torch.dataset import (ChainedTransformer, DataSet,
                                     FuncTransformer, Identity, Sample,
                                     SampleToMiniBatch, TransformedDataSet,
                                     Transformer)

torch.set_num_threads(1)
N = 11


def _samples(sample_cls):
    rng = np.random.RandomState(0)
    return [sample_cls(rng.randn(3).astype(np.float32) + i,
                       np.float32(i % 3 + 1)) for i in range(N)]


def _scale(s, cls):
    return cls(s.features[0] * 2.0, s.labels[0])


def _chain(pkg, sample_cls, kind):
    scale = pkg.FuncTransformer(lambda s: _scale(s, sample_cls))
    shift = pkg.FuncTransformer(lambda s: sample_cls(s.features[0] - 1.0,
                                                     s.labels[0]))
    batch = pkg.SampleToMiniBatch(4)
    return {"pipe": scale | shift | batch,
            "arrow": scale.arrow(shift).arrow(batch),
            "identity": pkg.Identity() | batch,
            "nested": (pkg.Identity() | scale) | (shift | batch)}[kind]


def _epochs(ds, n=3, train=True):
    out = []
    for _ in range(n):
        ds.shuffle()
        out.append([(np.asarray(mb.get_input()).copy(),
                     np.asarray(mb.get_target()).copy())
                    for mb in ds.data(train=train)])
    return out


@pytest.mark.parametrize("kind", ["pipe", "arrow", "identity", "nested"])
@pytest.mark.parametrize("how", ["array", "transform", "arrow"])
def test_chained_batches_equal_jax(kind, how):
    chains = {"port": _chain(__import__("bigdl_tpu_torch.dataset",
                                        fromlist=["x"]), Sample, kind),
              "jax": _chain(jtr, JaxSample, kind)}
    sets = {}
    for pkg, DS, cls in (("port", DataSet, Sample),
                         ("jax", jds.DataSet, JaxSample)):
        t = chains[pkg]
        base = DS.array(_samples(cls))
        sets[pkg] = {"array": lambda: DS.array(_samples(cls), t),
                     "transform": lambda: base.transform(t),
                     "arrow": lambda: base.arrow(t)}[how]()
    assert isinstance(sets["port"], TransformedDataSet)
    assert sets["port"].size() == sets["jax"].size() == N
    for train in (True, False):
        got = _epochs(sets["port"], train=train)
        want = _epochs(sets["jax"], train=train)
        assert [len(e) for e in got] == [3, 3, 3]
        for ge, we in zip(got, want):
            for (gx, gy), (wx, wy) in zip(ge, we):
                np.testing.assert_array_equal(gx, wx)
                np.testing.assert_array_equal(gy, wy)


def test_func_transformer_and_call_over_any_iterable():
    t = FuncTransformer(lambda x: x * 10) | FuncTransformer(lambda x: x + 1)
    assert isinstance(t, ChainedTransformer)
    assert list(t([1, 2, 3])) == list(
        (jtr.FuncTransformer(lambda x: x * 10)
         | jtr.FuncTransformer(lambda x: x + 1))([1, 2, 3])) == [11, 21, 31]
    assert list(Identity()(range(3))) == [0, 1, 2]
    with pytest.raises(NotImplementedError):
        Transformer()([1])


def test_sample_to_minibatch_drop_last_like_jax():
    for drop in (False, True):
        got = [mb.size() for mb in
               SampleToMiniBatch(4, drop_last=drop)(_samples(Sample))]
        want = [mb.size() for mb in
                jtr.SampleToMiniBatch(4, drop_last=drop)(
                    _samples(JaxSample))]
        assert got == want


def test_a_chained_data_set_trains_like_the_plain_one():
    """``LocalOptimizer`` over ``DataSet.array(samples, FuncTransformer)``
    lands where it lands over the transformed samples themselves."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, max_iteration
    from bigdl_tpu_torch.nn import ClassNLLCriterion

    def run(ds):
        torch.manual_seed(0)
        m = nn.Sequential(nn.Linear(3, 4), nn.LogSoftMax())
        m.reset(torch.Generator().manual_seed(0))
        LocalOptimizer(m, ds, ClassNLLCriterion(), SGD(0.1),
                       max_iteration(4), batch_size=4,
                       device="cpu").prepare_input().optimize()
        return [p.detach().clone() for p in m.parameters()]

    t = FuncTransformer(lambda s: _scale(s, Sample))
    chained = run(DataSet.array(_samples(Sample), t))
    plain = run(DataSet.array([_scale(s, Sample)
                               for s in _samples(Sample)]))
    for a, b in zip(chained, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
