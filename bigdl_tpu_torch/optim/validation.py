"""Validation methods and results (counterpart of
``bigdl_tpu/optim/validation.py``, parity with the reference's
``optim/ValidationMethod.scala``: Top1Accuracy, Top5Accuracy, Loss, MAE,
HitRatio, NDCG, TreeNNAccuracy). Results merge with ``+`` across batches.

Two paths compute each method, as in the JAX package: ``__call__`` on the
host (numpy) per batch, and ``device_stats``, a small float32 vector of
summable statistics computed on the output's device, which
``optim.evaluator.Evaluator`` sums on the device over the whole loop and
reads back once; ``result_from_stats`` turns the summed vector into the
result. ``TreeNNAccuracy`` has no device form and keeps the host path.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["ValidationResult", "AccuracyResult", "LossResult",
           "ContiguousResult", "ValidationMethod", "Top1Accuracy",
           "Top5Accuracy", "Loss", "MAE", "HitRatio", "NDCG",
           "TreeNNAccuracy"]


_LOG2 = float(np.log(np.float32(2.0)))    # jnp.log(2.0) in float32


def _host(x):
    """A tensor (any device; bf16 as float32) or array as a numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _tensor(x, like=None):
    """A tensor on ``like``'s device (numpy arrays are moved there)."""
    if isinstance(x, torch.Tensor):
        return x if like is None else x.to(like.device)
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t if like is None else t.to(like.device)


def _stats(*vals, like):
    return torch.stack([v.float() if isinstance(v, torch.Tensor)
                        else torch.tensor(float(v), device=like.device)
                        for v in vals])


class ValidationResult:
    def result(self):
        raise NotImplementedError

    def __add__(self, other):
        raise NotImplementedError


class AccuracyResult(ValidationResult):
    def __init__(self, correct: int, count: int):
        self.correct, self.count = int(correct), int(count)

    def result(self):
        return (self.correct / max(self.count, 1), self.count)

    def __add__(self, other):
        return AccuracyResult(self.correct + other.correct,
                              self.count + other.count)

    def __repr__(self):
        acc, cnt = self.result()
        return f"Accuracy(correct: {self.correct}, count: {cnt}, " \
               f"accuracy: {acc})"

    def __eq__(self, other):
        return (self.correct, self.count) == (other.correct, other.count)


class LossResult(ValidationResult):
    def __init__(self, loss: float, count: int):
        self.loss, self.count = float(loss), int(count)

    def result(self):
        return (self.loss / max(self.count, 1), self.count)

    def __add__(self, other):
        return LossResult(self.loss + other.loss, self.count + other.count)

    def __repr__(self):
        return f"Loss(loss: {self.loss}, count: {self.count}, " \
               f"average: {self.result()[0]})"


class ContiguousResult(LossResult):
    pass


class ValidationMethod:
    """Apply to (output, target) of one batch -> ValidationResult.

    ``device_stats(output, target)`` returns a 1-D float32 tensor on the
    output's device whose sum over batches, fed to ``result_from_stats``,
    gives the result of ``__call__`` summed over the same batches. A
    method without it keeps the host path (the Evaluator decides)."""

    def __call__(self, output, target):
        raise NotImplementedError

    def device_stats(self, output, target):
        raise NotImplementedError

    def result_from_stats(self, stats) -> "ValidationResult":
        raise NotImplementedError

    def supports_device_stats(self) -> bool:
        return type(self).device_stats is not ValidationMethod.device_stats

    def __repr__(self):
        return type(self).__name__


def _target_classes(target, n_classes):
    """1-based class indices from index targets or one-hot rows (the
    reference's 2-D discrimination, ValidationMethod.scala:183-190). Only
    rows that really are indicator vectors (0/1 entries, row sums 1) with
    a trailing dim equal to ``n_classes`` take the argmax path: integer
    sequence labels (B, T) with T == C stay indices."""
    t = np.asarray(target)
    if t.ndim >= 2 and t.shape[-1] == n_classes and n_classes > 1:
        flat = t.reshape(-1, n_classes)
        is_01 = np.logical_or(flat == 0, flat == 1).all()
        if is_01 and np.all(flat.sum(-1) == 1):
            return np.argmax(flat, axis=-1) + 1
    return t.reshape(-1)


def _device_logits_targets(output, target):
    """The device form of the host reshape and :func:`_target_classes`:
    (logits (N, C), classes (N,)). One-hot against index is decided on the
    shapes alone, as the JAX package's traced form does (the host's 0/1
    data check can only decide cases where the index form's shapes would
    not fit)."""
    out = output if output.dim() > 1 else output[None]
    out = out.reshape(-1, out.shape[-1])
    n_classes, n_rows = out.shape[-1], out.shape[0]
    t = _tensor(target, out)
    if t.dim() >= 2 and t.shape[-1] == n_classes and n_classes > 1 and \
            t.numel() // n_classes == n_rows:
        t = t.reshape(-1, n_classes).argmax(-1) + 1
    else:
        t = t.reshape(-1)
    return out, t


class Top1Accuracy(ValidationMethod):
    """optim/ValidationMethod.scala:170."""

    def __call__(self, output, target):
        out = _host(output)
        if out.ndim == 1:
            out = out[None]
        out = out.reshape(-1, out.shape[-1])  # (B*T..., C)
        t = _target_classes(_host(target), out.shape[-1])
        pred = np.argmax(out, axis=-1) + 1
        correct = int(np.sum(pred == t.astype(np.int64)))
        return AccuracyResult(correct, t.size)

    def device_stats(self, output, target):
        out, t = _device_logits_targets(output, target)
        pred = out.argmax(-1) + 1
        correct = (pred == t.long()).sum()
        return _stats(correct, t.numel(), like=out)

    def result_from_stats(self, stats):
        return AccuracyResult(int(stats[0]), int(stats[1]))

    def __repr__(self):
        return "Top1Accuracy"


class Top5Accuracy(ValidationMethod):
    """optim/ValidationMethod.scala:224. Equal logits rank by class index
    on both paths (stable sorts)."""

    def __call__(self, output, target):
        out = _host(output)
        if out.ndim == 1:
            out = out[None]
        out = out.reshape(-1, out.shape[-1])  # (B*T..., C)
        t = _target_classes(_host(target), out.shape[-1]).astype(np.int64)
        top5 = np.argsort(-out, axis=-1, kind="stable")[:, :5] + 1
        correct = int(np.sum(np.any(top5 == t[:, None], axis=-1)))
        return AccuracyResult(correct, t.size)

    def device_stats(self, output, target):
        out, t = _device_logits_targets(output, target)
        top5 = torch.sort(-out, dim=-1, stable=True).indices[:, :5] + 1
        correct = (top5 == t.long()[:, None]).any(-1).sum()
        return _stats(correct, t.numel(), like=out)

    def result_from_stats(self, stats):
        return AccuracyResult(int(stats[0]), int(stats[1]))

    def __repr__(self):
        return "Top5Accuracy"


class Loss(ValidationMethod):
    """optim/ValidationMethod.scala:475: the criterion's loss, averaged
    over the rows (``ClassNLLCriterion`` when none is given)."""

    def __init__(self, criterion=None):
        if criterion is None:
            from ..nn.criterion import ClassNLLCriterion
            criterion = ClassNLLCriterion()
        self.criterion = criterion

    def __call__(self, output, target):
        out = _tensor(output)
        l = float(self.criterion._forward(out, _tensor(target, out)))
        n = out.shape[0]
        return LossResult(l * n, n)

    def device_stats(self, output, target):
        l = self.criterion._forward(output, _tensor(target, output))
        n = output.shape[0]
        return _stats(l.float() * n, n, like=output)

    def result_from_stats(self, stats):
        return LossResult(float(stats[0]), int(stats[1]))

    def __repr__(self):
        return "Loss"


class MAE(ValidationMethod):
    """optim/ValidationMethod.scala:500: mean absolute error."""

    def __call__(self, output, target):
        out = _host(output)
        t = _host(target)
        l = float(np.mean(np.abs(out - t)))
        n = out.shape[0]
        return LossResult(l * n, n)

    def device_stats(self, output, target):
        l = (output - _tensor(target, output)).abs().mean()
        n = output.shape[0]
        return _stats(l.float() * n, n, like=output)

    def result_from_stats(self, stats):
        return LossResult(float(stats[0]), int(stats[1]))

    def __repr__(self):
        return "MAE"


def _device_pos_ranks(output, target):
    """Sorted-scores ranks for the device HitRatio / NDCG: sort once and
    read each score's strictly-greater count off ``searchsorted``.
    Returns (positive mask (N,), 1-based rank (N,)), the host's arithmetic
    exactly (strict >, ties share a rank)."""
    out = output.reshape(-1).float()
    t = _tensor(target, out).reshape(-1)
    pos = t > 0.5
    asc = torch.sort(out).values
    n_greater = out.numel() - torch.searchsorted(asc, out, right=True)
    return pos, n_greater + 1


class HitRatio(ValidationMethod):
    """optim/ValidationMethod.scala:279: HR@k for recommendation; each row
    of output scores 1 positive and ``neg_num`` negatives, the target
    marks the positive."""

    def __init__(self, k: int = 10, neg_num: int = 100):
        self.k, self.neg_num = k, neg_num

    def __call__(self, output, target):
        out = _host(output).reshape(-1)
        t = _host(target).reshape(-1)
        pos = out[t > 0.5]
        hits = 0.0
        count = 0
        for p in np.atleast_1d(pos):
            rank = int(np.sum(out > p)) + 1
            hits += 1.0 if rank <= self.k else 0.0
            count += 1
        return AccuracyResult(int(hits), max(count, 1))

    def device_stats(self, output, target):
        pos, rank = _device_pos_ranks(output, target)
        hits = (pos & (rank <= self.k)).float().sum()
        return torch.stack([hits, pos.float().sum()])

    def result_from_stats(self, stats):
        # the count clamps at the aggregate (the host path per batch; they
        # differ only for batches without a positive)
        return AccuracyResult(int(stats[0]), max(int(stats[1]), 1))

    def __repr__(self):
        return f"HitRate@{self.k}"


class NDCG(ValidationMethod):
    """optim/ValidationMethod.scala:346: NDCG@k, same setup as HitRatio."""

    def __init__(self, k: int = 10, neg_num: int = 100):
        self.k, self.neg_num = k, neg_num

    def __call__(self, output, target):
        out = _host(output).reshape(-1)
        t = _host(target).reshape(-1)
        pos = out[t > 0.5]
        total = 0.0
        count = 0
        for p in np.atleast_1d(pos):
            rank = int(np.sum(out > p)) + 1
            total += float(np.log(2) / np.log(rank + 1)) if rank <= self.k \
                else 0.0
            count += 1
        return LossResult(total, max(count, 1))

    def device_stats(self, output, target):
        pos, rank = _device_pos_ranks(output, target)
        # float32 logs against the host's float64: the summed gain agrees
        # to ~1e-6 relative
        gain = torch.where(rank <= self.k,
                           _LOG2 / torch.log(rank.float() + 1.0), 0.0)
        total = torch.where(pos, gain, 0.0).sum()
        return torch.stack([total, pos.float().sum()])

    def result_from_stats(self, stats):
        return LossResult(float(stats[0]), max(int(stats[1]), 1))

    def __repr__(self):
        return f"NDCG@{self.k}"


class TreeNNAccuracy(ValidationMethod):
    """optim/ValidationMethod.scala:118: accuracy on the root (first
    position) prediction of a tree or sequence output; a 1-wide head is
    thresholded at 0.5."""

    def __call__(self, output, target):
        out = _host(output)
        if out.ndim == 3:
            out = out[:, 0, :]
        t = _host(target)
        if t.ndim >= 2:
            t = t[:, 0]
        if out.shape[-1] == 1:  # binary head: threshold at 0.5 (reference)
            pred = (out[..., 0] >= 0.5).astype(np.int64)
        else:
            pred = np.argmax(out, axis=-1) + 1
        correct = int(np.sum(pred == t.reshape(-1).astype(np.int64)))
        return AccuracyResult(correct, t.size)

    def __repr__(self):
        return "TreeNNAccuracy"
