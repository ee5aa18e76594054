"""Loss functions (counterpart of ``bigdl_tpu/nn/criterion.py``; the
criteria the training slice needs).

Targets keep the JAX package's conventions: the torch-parity
classification criteria take **1-based** class indices, ``LMCriterion``
takes RAW 0-based token ids (the tied embedding's own indexing, as
``models.lm_loss_chunked`` does). Targets may be numpy arrays or tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from .module import Criterion


def _index(target, like):
    """``target`` as an int64 tensor on ``like``'s device."""
    if torch.is_tensor(target):
        return target.to(like.device).long()
    return torch.as_tensor(np.asarray(target), device=like.device).long()


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
