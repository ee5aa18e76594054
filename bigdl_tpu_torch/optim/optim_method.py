"""Optimization methods and learning-rate schedules (counterpart of
``bigdl_tpu/optim/optim_method.py``; this slice ports ``SGD``, ``Adam``,
``AdamW`` and every schedule but ``Plateau``, which needs validation).

The contract is the JAX package's, over parameter trees (nested dicts of
tensors): ``init_state(params) -> state`` and ``update(grads, params,
state, lr) -> (params, state)``. Unlike JAX's pure update, the port writes
the new values INTO the given parameter and state tensors (no second copy
of a model's masters) and returns the same trees. Writing back with
``copy_`` casts to each tensor's own dtype (JAX's ``_keep_dtype``), so bf16
params stay bf16. Schedules run on the host each step and feed ``lr`` in
as a float.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..convert import flatten


def _zeros_like(params):
    """A tree of zeros shaped like ``params``, leaf for leaf."""
    if isinstance(params, dict):
        return {k: _zeros_like(v) for k, v in params.items()}
    return torch.zeros_like(params, requires_grad=False)


def _leaves(*trees):
    """Leaves of trees of one structure, matched by path:
    {path: (leaf of tree 0, leaf of tree 1, ...)}."""
    flats = [flatten(t) for t in trees]
    return {name: tuple(f[name] for f in flats) for name in flats[0]}


# ---------------------------------------------------------------------------
# Learning-rate schedules
# ---------------------------------------------------------------------------
class LearningRateSchedule:
    """Host-side schedule. ``update_lr(lr, state) -> lr`` where ``state``
    carries 'neval' (iterations so far, 0-based), 'epoch' (1-based),
    optionally 'score' / 'loss'."""

    def update_lr(self, lr, state):
        raise NotImplementedError


class Default(LearningRateSchedule):
    """lr / (1 + neval * learningrate_decay)."""

    def __init__(self):
        self.decay = 0.0  # set by SGD from learningrate_decay

    def update_lr(self, lr, state):
        return lr / (1.0 + state["neval"] * self.decay)


class Poly(LearningRateSchedule):
    """lr * (1 - neval / max_iteration) ^ power; 0 past max_iteration."""

    def __init__(self, power: float, max_iteration: int):
        self.power, self.max_iteration = power, max_iteration

    def update_lr(self, lr, state):
        if state["neval"] >= self.max_iteration:
            return 0.0
        return lr * (1.0 - state["neval"] / self.max_iteration) ** self.power


class Step(LearningRateSchedule):
    """lr * gamma ^ floor(neval / step_size)."""

    def __init__(self, step_size: int, gamma: float):
        self.step_size, self.gamma = step_size, gamma

    def update_lr(self, lr, state):
        return lr * self.gamma ** (state["neval"] // self.step_size)


class MultiStep(LearningRateSchedule):
    """lr * gamma ^ (number of step sizes <= neval)."""

    def __init__(self, step_sizes, gamma: float):
        self.step_sizes, self.gamma = list(step_sizes), gamma

    def update_lr(self, lr, state):
        n = sum(1 for s in self.step_sizes if state["neval"] >= s)
        return lr * self.gamma ** n


class EpochStep(LearningRateSchedule):
    """lr * gamma ^ floor((epoch - 1) / step_size)."""

    def __init__(self, step_size: int, gamma: float):
        self.step_size, self.gamma = step_size, gamma

    def update_lr(self, lr, state):
        return lr * self.gamma ** ((state["epoch"] - 1) // self.step_size)


class EpochDecay(LearningRateSchedule):
    """lr * 0.1 ^ decay_type(epoch)."""

    def __init__(self, decay_type):
        self.decay_type = decay_type

    def update_lr(self, lr, state):
        return lr * 0.1 ** self.decay_type(state["epoch"])


class NaturalExp(LearningRateSchedule):
    """lr * exp(-gamma * floor(neval / decay_step))."""

    def __init__(self, decay_step: int, gamma: float):
        self.decay_step, self.gamma = decay_step, gamma

    def update_lr(self, lr, state):
        return lr * math.exp(-self.gamma * (state["neval"] // self.decay_step))


class Exponential(LearningRateSchedule):
    """lr * decay_rate ^ (neval / decay_step), floored with stair_case."""

    def __init__(self, decay_step: int, decay_rate: float,
                 stair_case: bool = False):
        self.decay_step, self.decay_rate = decay_step, decay_rate
        self.stair_case = stair_case

    def update_lr(self, lr, state):
        p = state["neval"] / self.decay_step
        if self.stair_case:
            p = math.floor(p)
        return lr * self.decay_rate ** p


class Warmup(LearningRateSchedule):
    """lr + delta * neval (used inside SequentialSchedule)."""

    def __init__(self, delta: float):
        self.delta = delta

    def update_lr(self, lr, state):
        return lr + self.delta * state["neval"]


class CosineAnnealing(LearningRateSchedule):
    """Cosine decay lr -> min_lr over ``max_iteration`` steps, optionally
    restarting with periods growing by ``t_mult`` (SGDR)."""

    def __init__(self, max_iteration: int, min_lr: float = 0.0,
                 restarts: bool = False, t_mult: float = 1.0):
        self.max_iteration = max_iteration
        self.min_lr = min_lr
        self.restarts = restarts
        self.t_mult = t_mult

    def update_lr(self, lr, state):
        t = state["neval"]
        period = self.max_iteration
        if self.restarts:
            while t >= period:
                t -= period
                period = max(1, int(period * self.t_mult))
        else:
            t = min(t, period)
        cos = 0.5 * (1.0 + math.cos(math.pi * t / period))
        return self.min_lr + (lr - self.min_lr) * cos


class SequentialSchedule(LearningRateSchedule):
    """Chain schedules, each active for its ``max_iteration`` steps (the
    last one for ever)."""

    def __init__(self, iteration_per_epoch: int = 1):
        self.iteration_per_epoch = iteration_per_epoch
        self.schedules = []  # (schedule, max_iter)

    def add(self, schedule, max_iteration: int):
        self.schedules.append((schedule, max_iteration))
        return self

    def update_lr(self, lr, state):
        n = state["neval"]
        offset = 0
        for sched, mx in self.schedules:
            if n < offset + mx or (sched, mx) == self.schedules[-1]:
                sub = dict(state)
                sub["neval"] = n - offset
                sub["epoch"] = max(1, (n - offset) // self.iteration_per_epoch
                                   + 1)
                return sched.update_lr(lr, sub)
            offset += mx
        return lr


class Regime:
    """An epoch range [start_epoch, end_epoch] with its config."""

    def __init__(self, start_epoch: int, end_epoch: int, config: dict):
        self.start_epoch, self.end_epoch, self.config = \
            start_epoch, end_epoch, config


class EpochSchedule(LearningRateSchedule):
    """Per-epoch-range regimes: the learning rate of the regime holding the
    current epoch."""

    def __init__(self, regimes):
        self.regimes = list(regimes)

    def update_lr(self, lr, state):
        e = state["epoch"]
        for r in self.regimes:
            if r.start_epoch <= e <= r.end_epoch:
                return r.config.get("learningRate",
                                    r.config.get("learning_rate", lr))
        return lr


class EpochDecayWithWarmUp(LearningRateSchedule):
    """Linear warmup for ``warmup_iteration`` steps, then epoch decay."""

    def __init__(self, warmup_iteration: int, warmup_delta: float,
                 decay_type):
        self.warmup_iteration = warmup_iteration
        self.warmup_delta = warmup_delta
        self.decay_type = decay_type

    def update_lr(self, lr, state):
        if state["neval"] < self.warmup_iteration:
            return lr + self.warmup_delta * state["neval"]
        return (lr + self.warmup_delta * self.warmup_iteration) * \
            0.1 ** self.decay_type(state["epoch"])


# ---------------------------------------------------------------------------
# Optim methods
# ---------------------------------------------------------------------------
class OptimMethod:
    """Base: hyperparameters plus the host step state
    ``{'neval': 0, 'epoch': 1}`` the optimizer loop advances."""

    def __init__(self, learningrate: float = 1e-3):
        self.learningrate = learningrate
        self.state = {"neval": 0, "epoch": 1}

    def init_state(self, params):
        return {}

    def update(self, grads, params, opt_state, lr):
        raise NotImplementedError

    def get_learning_rate(self):
        return self.current_lr()

    def current_lr(self):
        return self.learningrate


class SGD(OptimMethod):
    """SGD with momentum, dampening, Nesterov, L2 weight decay and the
    schedule family (``learningrate_schedule``, default ``Default`` with
    ``learningrate_decay``)."""

    def __init__(self, learningrate: float = 1e-3,
                 learningrate_decay: float = 0.0, weightdecay: float = 0.0,
                 momentum: float = 0.0, dampening: Optional[float] = None,
                 nesterov: bool = False, learningrate_schedule=None,
                 **_ignored):
        super().__init__(learningrate)
        self.learningrate_decay = learningrate_decay
        self.weightdecay = weightdecay
        self.momentum = momentum
        self.dampening = momentum if dampening is None else dampening
        self.nesterov = nesterov
        if learningrate_schedule is None:
            learningrate_schedule = Default()
        if isinstance(learningrate_schedule, Default):
            learningrate_schedule.decay = learningrate_decay
        self.learningrate_schedule = learningrate_schedule
        if nesterov and (momentum <= 0 or self.dampening != 0):
            # as the reference requires: Nesterov needs zero dampening
            self.dampening = 0.0

    def current_lr(self):
        return self.learningrate_schedule.update_lr(self.learningrate,
                                                    self.state)

    def init_state(self, params):
        if self.momentum <= 0:
            return {}
        return {"v": _zeros_like(params)}

    def update(self, grads, params, opt_state, lr):
        wd, mom, damp = self.weightdecay, self.momentum, self.dampening
        vs = flatten(opt_state["v"]) if mom > 0 else None
        with torch.no_grad():
            for name, (w, g) in _leaves(params, grads).items():
                if wd > 0:
                    g = g + wd * w
                if mom > 0:
                    v = vs[name]
                    v.copy_(mom * v + (1 - damp) * g)
                    g = g + mom * v if self.nesterov else v
                w.copy_(w - lr * g)
        return params, opt_state


class Adam(OptimMethod):
    """Adam with bias correction; lr / (1 + neval * learningrate_decay)."""

    def __init__(self, learningrate: float = 1e-3,
                 learningrate_decay: float = 0.0, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8, **_ignored):
        super().__init__(learningrate)
        self.learningrate_decay = learningrate_decay
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def current_lr(self):
        return self.learningrate / (1 + self.state["neval"] *
                                    self.learningrate_decay)

    def init_state(self, params):
        return {"m": _zeros_like(params), "v": _zeros_like(params), "t": 0}

    def _step(self, w, g, m, v, lr, bc1, bc2):
        """New value of one leaf; updates its moments m, v in place."""
        b1, b2 = self.beta1, self.beta2
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        return w - lr * (m / bc1) / (torch.sqrt(v / bc2) + self.epsilon)

    def update(self, grads, params, opt_state, lr):
        t = opt_state["t"] + 1
        # the bias corrections rounded to float32, as the JAX package
        # computes them
        f32 = lambda x: float(torch.tensor(x, dtype=torch.float32))
        bc1 = f32(1 - f32(f32(self.beta1) ** t))
        bc2 = f32(1 - f32(f32(self.beta2) ** t))
        with torch.no_grad():
            for w, g, m, v in _leaves(params, grads, opt_state["m"],
                                      opt_state["v"]).values():
                w.copy_(self._step(w, g, m, v, lr, bc1, bc2))
        opt_state["t"] = t
        return params, opt_state


class AdamW(Adam):
    """Adam with DECOUPLED weight decay: after the Adam step each selected
    leaf also moves by -lr * weight_decay * (its value before the step).
    ``decay_filter(leaf) -> bool`` selects the leaves; the default (ndim >=
    2) leaves biases and norm scales alone."""

    def __init__(self, learningrate: float = 1e-3,
                 learningrate_decay: float = 0.0, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: float = 0.01, decay_filter=None, **_ignored):
        super().__init__(learningrate, learningrate_decay, beta1, beta2,
                         epsilon)
        self.weight_decay = weight_decay
        self.decay_filter = decay_filter

    def _step(self, w, g, m, v, lr, bc1, bc2):
        new = super()._step(w, g, m, v, lr, bc1, bc2)
        keep = self.decay_filter or (lambda x: x.dim() >= 2)
        if self.weight_decay and keep(w):
            new = new - lr * self.weight_decay * w
        return new
