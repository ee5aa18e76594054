"""The port's criteria against the JAX package's (``nn/criterion.py``): the
loss (``forward``) and its input gradient (``backward``, a Table of
gradients for a Table input) at 1e-5 on the same numpy inputs and targets,
with JAX's conventions: 1-based class targets, ``size_average``, class
weights, padding values, +-1 targets, Table inputs and targets, nested
criteria. The inputs include JAX's kinks - a probability at exactly 1
under ``jnp.clip``, an input equal to its target under ``jnp.abs``, a
hinge at exactly its margin under ``jnp.maximum(0, .)`` - where the port
passes JAX's gradient.
"""
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu_torch import nn
from torch_parity_helpers import close, to_jax, to_torch

torch.set_num_threads(1)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _probs(*shape, seed=0):
    e = np.exp(_x(*shape, seed=seed))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _logp(*shape, seed=0):
    return np.log(_probs(*shape, seed=seed)).astype(np.float32)


def _cls(n, classes, seed=1):
    return np.random.RandomState(seed).randint(1, classes + 1, size=n)


def _sign(*shape, seed=2):
    return np.where(np.random.RandomState(seed).rand(*shape) > 0.5, 1.0,
                    -1.0).astype(np.float32)


def _onehot(t, n):
    return np.eye(n, dtype=np.float32)[t - 1]


W5 = np.array([0.5, 1.0, 2.0, 1.5, 0.25], np.float32)
P_TIE = np.concatenate([np.array([[1.0, 0.0, 0.0, 0.0, 0.0]], np.float32),
                        _probs(3, 5)])
X_EQ = _x(4, 5)
T_EQ = X_EQ.copy()
T_EQ[:, ::2] = _x(4, 5, seed=3)[:, ::2]          # half the entries equal
MARGIN_X = np.array([1.0, -1.0, 0.5, 2.0], np.float32)   # 1 - x y = 0 at
MARGIN_T = np.array([1.0, -1.0, 1.0, -1.0], np.float32)  # the first two
MLM_T = np.array([[3, 1, 0, 0, 0], [5, 0, 2, 0, 0], [1, 2, 3, 4, 5],
                  [0, 0, 0, 0, 0]])

CASES = {
    "ClassNLL": (lambda m: m.ClassNLLCriterion(), _logp(4, 5), _cls(4, 5)),
    "ClassNLL_weights_sum": (lambda m: m.ClassNLLCriterion(W5, False),
                             _logp(4, 5), _cls(4, 5)),
    "ClassNLL_padding": (lambda m: m.ClassNLLCriterion(W5, True, True, 2),
                         _logp(6, 5), np.array([1, 2, 5, 2, 3, 4])),
    "ClassNLL_probabilities": (lambda m: m.ClassNLLCriterion(None, True,
                                                             False),
                               _probs(4, 5), _cls(4, 5)),
    "ClassNLL_vector": (lambda m: m.ClassNLLCriterion(), _logp(5),
                        np.array([3])),
    "CrossEntropy": (lambda m: m.CrossEntropyCriterion(), _x(4, 5),
                     _cls(4, 5)),
    "CrossEntropy_weights": (lambda m: m.CrossEntropyCriterion(W5, False),
                             _x(4, 5), _cls(4, 5)),
    "CategoricalCrossEntropy_tie": (lambda m: m.CategoricalCrossEntropy(),
                                    P_TIE, _onehot(_cls(4, 5), 5)),
    "BCE": (lambda m: m.BCECriterion(), _probs(4, 5),
            (_x(4, 5, seed=4) > 0).astype(np.float32)),
    "BCE_weights_sum": (lambda m: m.BCECriterion(W5, False), _probs(4, 5),
                        (_x(4, 5, seed=4) > 0).astype(np.float32)),
    "MSE": (lambda m: m.MSECriterion(), _x(4, 5), _x(4, 5, seed=1)),
    "MSE_sum": (lambda m: m.MSECriterion(False), _x(4, 5), _x(4, 5, seed=1)),
    "Abs_ties": (lambda m: m.AbsCriterion(), X_EQ, T_EQ),
    "SmoothL1": (lambda m: m.SmoothL1Criterion(), 2 * _x(4, 5), X_EQ),
    "SmoothL1WithWeights": (lambda m: m.SmoothL1CriterionWithWeights(2.0, 3),
                            _x(4, 5), _x(4, 5, seed=1)),
    "SmoothL1WithWeights_table": (
        lambda m: m.SmoothL1CriterionWithWeights(),
        2 * _x(4, 5), [_x(4, 5, seed=1), np.abs(_x(4, 5, seed=2)),
                       np.abs(_x(4, 5, seed=3))]),
    "Margin_at_margin": (lambda m: m.MarginCriterion(), MARGIN_X, MARGIN_T),
    "Margin_squared_sum": (lambda m: m.MarginCriterion(0.5, False, True),
                           _x(4, 5), _sign(4, 5)),
    "MultiLabelSoftMargin": (lambda m: m.MultiLabelSoftMarginCriterion(),
                             _x(4, 5),
                             (_x(4, 5, seed=4) > 0).astype(np.float32)),
    "MultiLabelSoftMargin_weights": (
        lambda m: m.MultiLabelSoftMarginCriterion(W5, False), _x(4, 5),
        (_x(4, 5, seed=4) > 0).astype(np.float32)),
    "MultiMargin": (lambda m: m.MultiMarginCriterion(), _x(4, 5),
                    _cls(4, 5)),
    "MultiMargin_p2_weights": (lambda m: m.MultiMarginCriterion(
        2, W5, 0.5, False), _x(4, 5), _cls(4, 5)),
    "MultiLabelMargin": (lambda m: m.MultiLabelMarginCriterion(), _x(4, 5),
                         MLM_T),
    "SoftMargin": (lambda m: m.SoftMarginCriterion(), _x(4, 5),
                   _sign(4, 5)),
    "DistKLDiv": (lambda m: m.DistKLDivCriterion(), _logp(4, 5),
                  _probs(4, 5, seed=1) * (_x(4, 5, seed=2) > -1)),
    "DistKLDiv_sum": (lambda m: m.DistKLDivCriterion(False), _logp(4, 5),
                      _probs(4, 5, seed=1)),
    "KullbackLeibler": (lambda m: m.KullbackLeiblerDivergenceCriterion(),
                        _probs(4, 5), _probs(4, 5, seed=1)),
    "KLD": (lambda m: m.KLDCriterion(), [_x(4, 3), _x(4, 3, seed=1)], None),
    "KLD_sum": (lambda m: m.KLDCriterion(False), [_x(4, 3),
                                                 _x(4, 3, seed=1)], None),
    "Gaussian": (lambda m: m.GaussianCriterion(),
                 [_x(4, 3), _x(4, 3, seed=1)], _x(4, 3, seed=2)),
    "CosineEmbedding": (lambda m: m.CosineEmbeddingCriterion(0.2),
                        [_x(4, 5), _x(4, 5, seed=1)], _sign(4)),
    "HingeEmbedding": (lambda m: m.HingeEmbeddingCriterion(0.5),
                       np.abs(_x(4, 5)), _sign(4, 5)),
    "L1HingeEmbedding": (lambda m: m.L1HingeEmbeddingCriterion(5.0),
                         [_x(4, 5), _x(4, 5, seed=1)], _sign(4)),
    "MarginRanking": (lambda m: m.MarginRankingCriterion(0.5),
                      [_x(4), _x(4, seed=1)], _sign(4)),
    "MarginRanking_table_target": (lambda m: m.MarginRankingCriterion(
        1.0, False), [_x(4), _x(4, seed=1)], [_sign(4)]),
    "SoftmaxWith": (lambda m: m.SoftmaxWithCriterion(), _x(2, 4, 3, 3),
                    _cls(18, 4).reshape(2, 3, 3)),
    "SoftmaxWith_ignore": (lambda m: m.SoftmaxWithCriterion(2),
                           _x(2, 4, 3, 3), _cls(18, 4).reshape(2, 3, 3)),
    "SoftmaxWith_batch": (lambda m: m.SoftmaxWithCriterion(
        None, "BATCH_SIZE"), _x(2, 4, 3), _cls(6, 4).reshape(2, 3)),
    "SoftmaxWith_full": (lambda m: m.SoftmaxWithCriterion(3, "FULL"),
                         _x(2, 4, 3), _cls(6, 4).reshape(2, 3)),
    "SoftmaxWith_none": (lambda m: m.SoftmaxWithCriterion(None, "NONE"),
                         _x(2, 4, 3), _cls(6, 4).reshape(2, 3)),
    "TimeDistributed": (lambda m: m.TimeDistributedCriterion(
        m.ClassNLLCriterion()), _logp(2, 3, 5), _cls(6, 5).reshape(2, 3)),
    "TimeDistributed_mean_dim3": (lambda m: m.TimeDistributedCriterion(
        m.MSECriterion(), True, 3), _x(2, 3, 4), _x(2, 3, 4, seed=1)),
    "LM": (lambda m: m.LMCriterion(), _x(2, 3, 6),
           np.array([[0, 2, 5], [1, 0, 3]])),
    "TimeDistributedMask": (lambda m: m.TimeDistributedMaskCriterion(
        m.ClassNLLCriterion(), 0), _logp(2, 3, 5),
        np.array([[1, 0, 5], [2, 3, 0]])),
    "Parallel": (lambda m: m.ParallelCriterion().add(
        m.ClassNLLCriterion(), 0.5).add(m.MSECriterion(), 2.0),
        [_logp(4, 5), _x(4, 3)], [_cls(4, 5), _x(4, 3, seed=1)]),
    "Parallel_repeat": (lambda m: m.ParallelCriterion(True).add(
        m.MSECriterion()).add(m.AbsCriterion(), 3.0),
        [_x(4, 3), _x(4, 3, seed=1)], _x(4, 3, seed=2)),
    "Multi": (lambda m: m.MultiCriterion().add(m.MSECriterion(), 0.5).add(
        m.AbsCriterion(), 2.0), _x(4, 5), _x(4, 5, seed=1)),
    "L1Cost": (lambda m: m.L1Cost(), X_EQ - T_EQ, None),
    "DiceCoefficient": (lambda m: m.DiceCoefficientCriterion(),
                        _probs(3, 2, 4), (_x(3, 2, 4) > 0).astype(
                            np.float32)),
    "DiceCoefficient_sum": (lambda m: m.DiceCoefficientCriterion(False, 0.5),
                            _probs(3, 8), _probs(3, 8, seed=1)),
    "MeanAbsolutePercentage": (lambda m: m.MeanAbsolutePercentageCriterion(),
                               X_EQ, T_EQ),
    "MeanSquaredLogarithmic": (lambda m: m.MeanSquaredLogarithmicCriterion(),
                               _x(4, 5), np.abs(_x(4, 5, seed=1))),
    "Poisson": (lambda m: m.PoissonCriterion(), np.abs(_x(4, 5)) + 0.1,
                np.abs(_x(4, 5, seed=1))),
    "CosineProximity": (lambda m: m.CosineProximityCriterion(), _x(4, 5),
                        _x(4, 5, seed=1)),
    "DotProduct": (lambda m: m.DotProductCriterion(), _x(4, 5),
                   _x(4, 5, seed=1)),
    "PG": (lambda m: m.PGCriterion(), _probs(4, 5), _x(4, 5, seed=1)),
    "PG_mean": (lambda m: m.PGCriterion(True), _probs(4, 5),
                _x(4, 5, seed=1)),
    "ClassSimplex": (lambda m: m.ClassSimplexCriterion(5), _x(4, 5),
                     _cls(4, 5)),
    "CosineDistance": (lambda m: m.CosineDistanceCriterion(), _x(4, 5),
                       _x(4, 5, seed=1)),
    "ActivityRegularization": (lambda m: m.ActivityRegularization(0.3, 0.2),
                               X_EQ - T_EQ, None),
    "NegativeEntropyPenalty": (lambda m: m.NegativeEntropyPenalty(0.1),
                               _probs(4, 5), None),
    "Transformer": (lambda m: m.TransformerCriterion(
        m.MSECriterion(), m.Sigmoid(), m.Tanh()), _x(4, 5),
        _x(4, 5, seed=1)),
}


def _jax(v):
    return None if v is None else to_jax(v)


def _port(v):
    return None if v is None else to_torch(v)


@pytest.mark.parametrize("name", sorted(CASES))
def test_criterion_matches_jax(name):
    make, x, t = CASES[name]
    jc, tc = make(jnn), make(nn)
    want = jc.forward(_jax(x), _jax(t))
    got = tc.forward(_port(x), _port(t))
    close(got, np.asarray(want), what="loss")
    close(tc.backward(_port(x), _port(t)), jc.backward(_jax(x), _jax(t)),
          what="grad_input")
    assert tc.grad_input is not None and tc.output is got


def test_criteria_keep_jax_kinks():
    """The kinks' gradients, written out: clip at 1 passes half, |0|
    passes +1, max(0, 0) passes half."""
    cce = nn.CategoricalCrossEntropy()
    g = cce.backward(torch.tensor([[1.0, 0.0]]), torch.tensor([[1.0, 0.0]]))
    torch.testing.assert_close(g, torch.tensor([[-0.5, 0.0]]))
    g = nn.AbsCriterion(False).backward(torch.zeros(3), torch.zeros(3))
    torch.testing.assert_close(g, torch.ones(3))
    g = nn.MarginCriterion(1.0, False).backward(torch.tensor([1.0]),
                                                torch.tensor([1.0]))
    torch.testing.assert_close(g, torch.tensor([-0.5]))
