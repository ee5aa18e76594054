"""Loss functions (counterpart of ``bigdl_tpu/nn/criterion.py``).

Targets keep the JAX package's conventions: the torch-parity
classification criteria take **1-based** class indices, ``LMCriterion``
takes RAW 0-based token ids (the tied embedding's own indexing, as
``models.lm_loss_chunked`` does). Targets may be numpy arrays or tensors.
``size_average=True`` means the mean (``_reduce``). Where JAX
differentiates ``jnp.abs``, ``jnp.clip`` or ``jnp.maximum(0, .)`` the port
passes JAX's gradient at the kink (``jabs``; ``torch.maximum`` /
``torch.minimum`` split a tie in half as JAX's do). ``backward`` takes a
``Table`` input (``KLDCriterion``, ``MarginRankingCriterion``,
``ParallelCriterion``, ...) and returns a Table of gradients.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.table import Table
from .elementwise import jabs
from .module import Criterion

__all__ = ["ClassNLLCriterion", "CrossEntropyCriterion",
           "CategoricalCrossEntropy", "BCECriterion", "MSECriterion",
           "AbsCriterion", "SmoothL1Criterion",
           "SmoothL1CriterionWithWeights", "MarginCriterion",
           "MultiLabelSoftMarginCriterion", "MultiMarginCriterion",
           "MultiLabelMarginCriterion", "SoftMarginCriterion",
           "DistKLDivCriterion", "KullbackLeiblerDivergenceCriterion",
           "KLDCriterion", "GaussianCriterion", "CosineEmbeddingCriterion",
           "HingeEmbeddingCriterion", "L1HingeEmbeddingCriterion",
           "MarginRankingCriterion", "SoftmaxWithCriterion",
           "TimeDistributedCriterion", "LMCriterion",
           "TimeDistributedMaskCriterion", "ParallelCriterion",
           "MultiCriterion", "L1Cost", "DiceCoefficientCriterion",
           "MeanAbsolutePercentageCriterion",
           "MeanSquaredLogarithmicCriterion", "PoissonCriterion",
           "CosineProximityCriterion", "DotProductCriterion", "PGCriterion",
           "ClassSimplexCriterion", "CosineDistanceCriterion",
           "ActivityRegularization", "NegativeEntropyPenalty",
           "TransformerCriterion"]


def _index(target, like):
    """``target`` as an int64 tensor on ``like``'s device."""
    if torch.is_tensor(target):
        return target.to(like.device).long()
    return torch.as_tensor(np.asarray(target), device=like.device).long()


def _value(target, like):
    """``target`` as a tensor of ``like``'s dtype on its device."""
    if torch.is_tensor(target):
        return target.to(like.device, like.dtype)
    return torch.as_tensor(np.asarray(target), dtype=like.dtype,
                           device=like.device)


def _reduce(x, size_average):
    return x.mean() if size_average else x.sum()


def _max0(x):
    """``jnp.maximum(0, x)``: half the gradient at 0."""
    return torch.maximum(x, x.new_zeros(()))


def _clip(x, lo=None, hi=None):
    """``jnp.clip``: ``minimum(hi, maximum(lo, x))``, ties split."""
    if lo is not None:
        x = torch.maximum(x.new_tensor(lo), x)
    if hi is not None:
        x = torch.minimum(x.new_tensor(hi), x)
    return x


def _norm(x, keepdim=False):
    return torch.linalg.vector_norm(x, dim=-1, keepdim=keepdim)


class ClassNLLCriterion(Criterion):
    """NLL over log-probabilities (N, C) or (C,), 1-based integer targets.
    ``log_prob_as_input=False`` takes probabilities. Optional per-class
    ``weights``; targets equal to ``padding_value`` are ignored. With
    ``size_average`` the sum is divided by the summed weights of the
    counted targets."""

    def __init__(self, weights=None, size_average: bool = True,
                 log_prob_as_input: bool = True, padding_value: int = -1):
        super().__init__(size_average)
        self.weights = (None if weights is None else
                        torch.as_tensor(np.asarray(weights, np.float32)))
        self.log_prob_as_input = log_prob_as_input
        self.padding_value = padding_value

    def _forward(self, input, target):
        logp = input if self.log_prob_as_input else torch.log(input + 1e-8)
        if logp.dim() == 1:
            logp = logp[None]
        t = _index(target, logp).reshape(-1)
        valid = t != self.padding_value
        idx = (t - 1).clamp(0, logp.shape[-1] - 1)
        picked = logp.gather(-1, idx[:, None])[:, 0]
        w = (self.weights.to(logp.device)[idx] if self.weights is not None
             else torch.ones_like(picked))
        w = w * valid
        loss = -(w * picked).sum()
        if self.size_average:
            loss = loss / w.sum().clamp(min=1e-8)
        return loss


class CrossEntropyCriterion(Criterion):
    """LogSoftMax + ClassNLL (1-based targets)."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__(size_average)
        self.nll = ClassNLLCriterion(weights, size_average)

    def _forward(self, input, target):
        return self.nll._forward(torch.log_softmax(input, -1), target)


class LMCriterion(Criterion):
    """Masked softmax cross-entropy over RAW (0-based) token ids: logits
    (B, T, V) with targets (B, T), or the flattened 2-D forms. Targets equal
    to ``padding_value`` (default 0) are excluded; mean over the valid
    positions, in float32. Same math as ``models.lm_loss_chunked``."""

    def __init__(self, padding_value: int = 0):
        super().__init__(True)
        self.padding_value = padding_value

    def _forward(self, input, target):
        logits = input.reshape(-1, input.shape[-1]).float()
        t = _index(target, logits).reshape(-1)
        lse = torch.logsumexp(logits, -1)
        idx = t.clamp(0, logits.shape[-1] - 1)
        gold = logits.gather(-1, idx[:, None])[:, 0]
        valid = (t != self.padding_value).float()
        return ((lse - gold) * valid).sum() / valid.sum().clamp(min=1.0)


class TimeDistributedMaskCriterion(Criterion):
    """A per-timestep criterion over (B, T, C) input and (B, T) targets with
    time folded into the batch; targets equal to ``padding_value`` are
    excluded and the result is the mean over the rest. A
    ``ClassNLLCriterion`` inside takes the padding value itself; any other
    criterion is applied row by row (``torch.func.vmap``) and masked."""

    def __init__(self, critrn: Criterion, padding_value: int = 0):
        super().__init__(True)
        self.critrn = critrn
        self.padding_value = padding_value

    def _forward(self, input, target):
        x = input.reshape(-1, input.shape[-1])
        t = _index(target, x).reshape(-1)
        if isinstance(self.critrn, ClassNLLCriterion):
            inner = ClassNLLCriterion(
                self.critrn.weights, True, self.critrn.log_prob_as_input,
                padding_value=self.padding_value)
            return inner._forward(x, t)
        mask = (t != self.padding_value).to(x.dtype)
        per = torch.func.vmap(self.critrn._forward)(x, t)
        return (per * mask).sum() / mask.sum().clamp(min=1.0)


class CategoricalCrossEntropy(Criterion):
    """Keras' categorical cross entropy: probabilities against one-hot
    targets, the batch mean."""

    def _forward(self, input, target):
        p = _clip(input, 1e-8, 1.0)
        return (-(_value(target, input) * torch.log(p)).sum(-1)).mean()


class BCECriterion(Criterion):
    """Binary cross entropy on probabilities, optionally weighted."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__(size_average)
        self.weights = (None if weights is None else
                        torch.as_tensor(np.asarray(weights, np.float32)))

    def _forward(self, input, target):
        t = _value(target, input)
        p = _clip(input, 1e-12, 1 - 1e-12)
        loss = -(t * torch.log(p) + (1 - t) * torch.log(1 - p))
        if self.weights is not None:
            loss = loss * self.weights.to(input)
        return _reduce(loss, self.size_average)


class MSECriterion(Criterion):
    def _forward(self, input, target):
        return _reduce(torch.square(input - _value(target, input)),
                       self.size_average)


class AbsCriterion(Criterion):
    def _forward(self, input, target):
        return _reduce(jabs(input - _value(target, input)),
                       self.size_average)


class SmoothL1Criterion(Criterion):
    def _forward(self, input, target):
        d = jabs(input - _value(target, input))
        return _reduce(torch.where(d < 1.0, 0.5 * d * d, d - 0.5),
                       self.size_average)


class SmoothL1CriterionWithWeights(Criterion):
    """Fast R-CNN's box loss with inside / outside weights: target
    ``Table(t, inside, outside)`` or a tensor; the sum, divided by ``num``
    when it is positive."""

    def __init__(self, sigma: float = 1.0, num: int = 0):
        super().__init__(False)
        self.sigma2 = sigma * sigma
        self.num = num

    def _forward(self, input, target):
        if isinstance(target, Table):
            t, in_w, out_w = (_value(target[i], input) for i in (1, 2, 3))
        else:
            t, in_w, out_w = _value(target, input), 1.0, 1.0
        d = in_w * (input - t)
        ad = jabs(d)
        loss = out_w * torch.where(ad < 1.0 / self.sigma2,
                                   0.5 * self.sigma2 * d * d,
                                   ad - 0.5 / self.sigma2)
        s = loss.sum()
        return s / self.num if self.num > 0 else s


class MarginCriterion(Criterion):
    """Hinge (or squared hinge) against +-1 targets."""

    def __init__(self, margin: float = 1.0, size_average: bool = True,
                 squared: bool = False):
        super().__init__(size_average)
        self.margin, self.squared = margin, squared

    def _forward(self, input, target):
        h = _max0(self.margin - input * _value(target, input))
        if self.squared:
            h = h * h
        return _reduce(h, self.size_average)


class MultiLabelSoftMarginCriterion(Criterion):
    """Sigmoid cross entropy on logits against multi-hot targets, the mean
    over the labels."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__(size_average)
        self.weights = (None if weights is None else
                        torch.as_tensor(np.asarray(weights, np.float32)))

    def _forward(self, input, target):
        t = _value(target, input)
        zero = torch.zeros_like(input)
        loss = torch.logaddexp(zero, -input) * t + \
            torch.logaddexp(zero, input) * (1 - t)
        if self.weights is not None:
            loss = loss * self.weights.to(input)
        return _reduce(loss.mean(-1) if loss.dim() > 1 else loss,
                       self.size_average)


class MultiMarginCriterion(Criterion):
    """The multi-class hinge against 1-based targets, each row's sum over
    the other classes divided by the class count."""

    def __init__(self, p: int = 1, weights=None, margin: float = 1.0,
                 size_average: bool = True):
        super().__init__(size_average)
        self.p, self.margin = p, margin
        self.weights = (None if weights is None else
                        torch.as_tensor(np.asarray(weights, np.float32)))

    def _forward(self, input, target):
        x = input if input.dim() == 2 else input[None]
        t = _index(target, x).reshape(-1) - 1
        xt = x.gather(-1, t[:, None])
        h = _max0(self.margin - xt + x)
        if self.p == 2:
            h = h * h
        if self.weights is not None:
            h = h * self.weights.to(x)[t][:, None]
        mask = 1.0 - torch.nn.functional.one_hot(t, x.shape[-1]).to(x)
        return _reduce((h * mask).sum(-1) / x.shape[-1], self.size_average)


class MultiLabelMarginCriterion(Criterion):
    """The multi-label hinge: every target label (1-based ids, rows ended
    by 0) against every non-target class."""

    def __init__(self, size_average: bool = True):
        super().__init__(size_average)

    def _forward(self, input, target):
        x = input if input.dim() == 2 else input[None]
        t = _index(target, x)
        t = t if t.dim() == 2 else t[None]
        n = x.shape[-1]
        valid = t > 0
        idx = (t - 1).clamp(0, n - 1)
        is_target = torch.zeros_like(x).scatter_reduce(
            1, idx, valid.to(x.dtype), reduce="amax")
        xt = x.gather(-1, idx)                               # (B, L)
        margins = 1.0 - xt[:, :, None] + x[:, None, :]       # (B, L, N)
        m = _max0(margins) * valid[:, :, None] * \
            (1.0 - is_target)[:, None, :]
        return _reduce(m.sum((1, 2)) / n, self.size_average)


class SoftMarginCriterion(Criterion):
    """log(1 + exp(-y x))."""

    def _forward(self, input, target):
        z = -input * _value(target, input)
        return _reduce(torch.logaddexp(torch.zeros_like(z), z),
                       self.size_average)


class DistKLDivCriterion(Criterion):
    """KL(target || input) over log-probability input; with
    ``size_average`` the sum is divided by the batch size."""

    def _forward(self, input, target):
        t = _value(target, input)
        loss = torch.where(t > 0, t * (torch.log(t + 1e-12) - input), 0.0)
        if self.size_average and input.dim() > 1:
            return loss.sum() / input.shape[0]
        return loss.sum()


class KullbackLeiblerDivergenceCriterion(Criterion):
    """Keras' KL divergence on probabilities, the batch mean."""

    def _forward(self, input, target):
        p = _clip(_value(target, input), 1e-7, 1.0)
        q = _clip(input, 1e-7, 1.0)
        return (p * torch.log(p / q)).sum(-1).mean()


class KLDCriterion(Criterion):
    """The VAE's KL divergence to N(0, I) of ``Table(mean, logvar)``."""

    def _forward(self, input, target=None):
        mean, logvar = input[1], input[2]
        kl = 0.5 * (torch.square(mean) + torch.exp(logvar) - 1.0
                    - logvar).sum(-1)
        return kl.mean() if self.size_average else kl.sum()

    def backward(self, input, target=None):
        return super().backward(input, target)


class GaussianCriterion(Criterion):
    """-log N(target; mean, exp(logvar)) of ``Table(mean, logvar)``,
    summed."""

    def _forward(self, input, target):
        mean, logvar = input[1], input[2]
        t = _value(target, mean)
        return (0.5 * (np.log(2 * np.pi) + logvar
                       + torch.square(t - mean) / torch.exp(logvar))).sum()


class CosineEmbeddingCriterion(Criterion):
    """``Table(a, b)`` against +-1 targets: 1 - cos for +1, max(0, cos -
    margin) for -1."""

    def __init__(self, margin: float = 0.0, size_average: bool = True):
        super().__init__(size_average)
        self.margin = margin

    def _forward(self, input, target):
        a, b = input[1], input[2]
        den = _norm(a) * _norm(b)
        cos = (a * b).sum(-1) / torch.maximum(den, den.new_tensor(1e-12))
        t = _value(target, cos).reshape(cos.shape)
        loss = torch.where(t > 0, 1.0 - cos, _max0(cos - self.margin))
        return _reduce(loss, self.size_average)


class HingeEmbeddingCriterion(Criterion):
    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__(size_average)
        self.margin = margin

    def _forward(self, input, target):
        t = _value(target, input)
        return _reduce(torch.where(t > 0, input, _max0(self.margin - input)),
                       self.size_average)


class L1HingeEmbeddingCriterion(Criterion):
    """The L1 distance of ``Table(a, b)`` against +-1 targets."""

    def __init__(self, margin: float = 1.0):
        super().__init__(True)
        self.margin = margin

    def _forward(self, input, target):
        d = jabs(input[1] - input[2]).sum(-1)
        t = _value(target, d).reshape(d.shape)
        return _reduce(torch.where(t > 0, d, _max0(self.margin - d)), True)


class MarginRankingCriterion(Criterion):
    """max(0, -y (x1 - x2) + margin) of ``Table(x1, x2)``; the target is
    +-1 (a tensor or ``Table(y)``)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__(size_average)
        self.margin = margin

    def _forward(self, input, target):
        x1, x2 = input[1], input[2]
        t = _value(target[1] if isinstance(target, Table) else target, x1)
        return _reduce(_max0(-t * (x1 - x2) + self.margin),
                       self.size_average)


class SoftmaxWithCriterion(Criterion):
    """Caffe's SoftmaxWithLoss over (B, C, ...) logits and (B, ...) 1-based
    targets; ``normalize_mode`` VALID (the count of targets not equal to
    ``ignore_label``), BATCH_SIZE, FULL or NONE."""

    def __init__(self, ignore_label: Optional[int] = None,
                 normalize_mode: str = "VALID"):
        super().__init__(True)
        self.ignore_label = ignore_label
        self.normalize_mode = normalize_mode

    def _forward(self, input, target):
        logp = torch.log_softmax(input, 1)
        t = _index(target, input)
        idx = (t - 1).clamp(0, input.shape[1] - 1)
        picked = logp.gather(1, idx[:, None])[:, 0]
        valid = (torch.ones_like(picked) if self.ignore_label is None
                 else (t != self.ignore_label).to(picked.dtype))
        loss = -(picked * valid).sum()
        if self.normalize_mode == "VALID":
            return loss / valid.sum().clamp(min=1.0)
        if self.normalize_mode == "BATCH_SIZE":
            return loss / input.shape[0]
        if self.normalize_mode == "FULL":
            return loss / picked.numel()
        return loss


class TimeDistributedCriterion(Criterion):
    """``critrn`` at each step along 1-based ``dimension`` of input and
    target, summed (or averaged over the steps)."""

    def __init__(self, critrn: Criterion, size_average: bool = False,
                 dimension: int = 2):
        super().__init__(size_average)
        self.critrn = critrn
        self.dimension = dimension

    def _forward(self, input, target):
        d = self.dimension - 1
        steps = input.shape[d]
        target = target if torch.is_tensor(target) else \
            torch.as_tensor(np.asarray(target), device=input.device)
        total = 0.0
        for i in range(steps):
            total = total + self.critrn._forward(input.select(d, i),
                                                 target.select(d, i))
        return total / steps if self.size_average else total


class ParallelCriterion(Criterion):
    """The weighted sum of criteria over zipped Tables of inputs and
    targets (one target for all with ``repeat_target``)."""

    def __init__(self, repeat_target: bool = False):
        super().__init__(True)
        self.repeat_target = repeat_target
        self.criterions = []
        self.cweights = []

    def add(self, criterion, weight: float = 1.0):
        self.criterions.append(criterion)
        self.cweights.append(weight)
        return self

    def _forward(self, input, target):
        total = 0.0
        for i, (c, w) in enumerate(zip(self.criterions, self.cweights)):
            t = target if self.repeat_target else target[i + 1]
            total = total + w * c._forward(input[i + 1], t)
        return total


class MultiCriterion(Criterion):
    """The weighted sum of criteria on the same input and target."""

    def __init__(self):
        super().__init__(True)
        self.criterions = []
        self.cweights = []

    def add(self, criterion, weight: float = 1.0):
        self.criterions.append(criterion)
        self.cweights.append(weight)
        return self

    def _forward(self, input, target):
        return sum(w * c._forward(input, target)
                   for c, w in zip(self.criterions, self.cweights))


class L1Cost(Criterion):
    """The sum of |x|; the target is ignored."""

    def _forward(self, input, target=None):
        return jabs(input).sum()

    def backward(self, input, target=None):
        return super().backward(input, target)


class DiceCoefficientCriterion(Criterion):
    """1 - the Dice overlap of each sample, smoothed by ``epsilon``."""

    def __init__(self, size_average: bool = True, epsilon: float = 1.0):
        super().__init__(size_average)
        self.epsilon = epsilon

    def _forward(self, input, target):
        x = input.reshape(input.shape[0], -1)
        t = _value(target, input).reshape(x.shape[0], -1)
        inter = (x * t).sum(-1)
        denom = x.sum(-1) + t.sum(-1)
        dice = (2.0 * inter + self.epsilon) / (denom + self.epsilon)
        return _reduce(1.0 - dice, self.size_average)


class MeanAbsolutePercentageCriterion(Criterion):
    def _forward(self, input, target):
        t = _value(target, input)
        return (jabs(t - input) / _clip(jabs(t), 1e-7)).mean() * 100.0


class MeanSquaredLogarithmicCriterion(Criterion):
    def _forward(self, input, target):
        a = torch.log(_clip(input, 1e-7) + 1.0)
        b = torch.log(_clip(_value(target, input), 1e-7) + 1.0)
        return torch.square(a - b).mean()


class PoissonCriterion(Criterion):
    def _forward(self, input, target):
        return (input - _value(target, input)
                * torch.log(input + 1e-7)).mean()


class CosineProximityCriterion(Criterion):
    """Minus the mean cosine of the rows of input and target."""

    def _forward(self, input, target):
        t = _value(target, input)
        xn = input / torch.maximum(_norm(input, True), input.new_tensor(1e-12))
        tn = t / torch.maximum(_norm(t, True), t.new_tensor(1e-12))
        return -(xn * tn).sum(-1).mean()


class DotProductCriterion(Criterion):
    """The sum of input * target."""

    def _forward(self, input, target):
        return (input * _value(target, input)).sum()


class PGCriterion(Criterion):
    """The policy-gradient loss -target * log(input)."""

    def __init__(self, size_average: bool = False):
        super().__init__(size_average)

    def _forward(self, input, target):
        return _reduce(-_value(target, input) * torch.log(input + 1e-8),
                       self.size_average)


class ClassSimplexCriterion(Criterion):
    """MSE against the vertex of a regular simplex that embeds each 1-based
    class."""

    def __init__(self, n_classes: int):
        super().__init__(True)
        self.n_classes = n_classes
        self.simplex = self._build_simplex(n_classes)

    @staticmethod
    def _build_simplex(n):
        a = np.zeros((n, n), dtype=np.float32)
        for k in range(n - 1):
            a[k, k] = 1.0
        a[n - 1] = (1.0 - np.sqrt(n + 1.0)) / n
        a = a - np.mean(a, axis=0)
        return torch.from_numpy(a / np.linalg.norm(a[0]))

    def _forward(self, input, target):
        t = _index(target, input).reshape(-1) - 1
        emb = self.simplex.to(input)[t]
        return torch.square(input - emb).mean()


class CosineDistanceCriterion(Criterion):
    """1 - the cosine of the rows of input and target."""

    def _forward(self, input, target):
        t = _value(target, input)
        den = _norm(input) * _norm(t)
        num = (input * t).sum(-1)
        return _reduce(1.0 - num / torch.maximum(den, den.new_tensor(1e-12)),
                       self.size_average)


class ActivityRegularization(Criterion):
    """The L1 + L2 activity penalty l1 * sum |x| + l2 * sum x^2."""

    def __init__(self, l1: float = 0.0, l2: float = 0.0):
        super().__init__(False)
        self.l1, self.l2 = l1, l2

    def _forward(self, input, target=None):
        return self.l1 * jabs(input).sum() + \
            self.l2 * torch.square(input).sum()


class NegativeEntropyPenalty(Criterion):
    """beta * sum(p log p)."""

    def __init__(self, beta: float = 0.01):
        super().__init__(False)
        self.beta = beta

    def _forward(self, input, target=None):
        return self.beta * (input * torch.log(input + 1e-8)).sum()


class TransformerCriterion(Criterion):
    """``criterion`` of the input and the target, each first passed through
    its module (in evaluation mode) when one is given."""

    def __init__(self, criterion, input_transformer=None,
                 target_transformer=None):
        super().__init__(True)
        self.criterion = criterion
        self.input_transformer = input_transformer
        self.target_transformer = target_transformer

    @staticmethod
    def _transform(m, x):
        if m is None:
            return x
        return m.apply(m.params, m.state, x, training=False)[0]

    def _forward(self, input, target):
        return self.criterion._forward(
            self._transform(self.input_transformer, input),
            self._transform(self.target_transformer, target))
