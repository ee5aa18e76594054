"""Optimization methods and learning-rate schedules (counterpart of
``bigdl_tpu/optim/optim_method.py``: every schedule, ``SGD``, ``Adam``,
``AdamW``, ``ParallelAdam``, ``Adagrad``, ``Adadelta``, ``Adamax``,
``RMSprop``, ``Ftrl``, ``LarsSGD`` and ``LBFGS``, and the reference's
closure form ``optimize(feval, x)``).

The contract is the JAX package's, over parameter trees (nested dicts of
tensors): ``init_state(params) -> state`` and ``update(grads, params,
state, lr) -> (params, state)``, with JAX's state tree names (``v``,
``m``, ``t``, ``accum``, ...), so checkpoints carry across. Unlike JAX's
pure update, the port writes the new values INTO the given parameter and
state tensors (no second copy of a model's masters) and returns the same
trees. Each method computes its new values first (``_updates``: a list of
(tensor, new value) pairs) and :func:`write_guarded` writes them: one
``copy_`` each, cast to each tensor's own dtype (JAX's ``_keep_dtype``, so
bf16 params stay bf16), or, in the training step, through the device-side
NaN guard, which keeps every old value where the loss is not finite with
a few launches for the whole tree. A step counter ``t`` (Adam, Adamax) is
a device int32 scalar, as in JAX, so a guarded step does not advance it.
Schedules run on the host each step and feed ``lr`` in as a float.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..convert import flatten


def _zeros_like(params):
    """A tree of zeros shaped like ``params``, leaf for leaf."""
    return _full_like(params, 0.0)


def _full_like(params, value):
    if isinstance(params, dict):
        return {k: _full_like(v, value) for k, v in params.items()}
    return torch.full_like(params, value, requires_grad=False)


def _step_counter(params):
    """A device int32 0 beside the parameters (Adam's and Adamax's
    ``t``)."""
    dev = next(iter(flatten(params).values())).device if flatten(params) \
        else torch.device("cpu")
    return torch.zeros((), dtype=torch.int32, device=dev)


def write_guarded(pairs, ok=None):
    """Write each ``(tensor, new value)`` pair in place, cast to the
    tensor's dtype. With ``ok`` (a 0-d bool tensor on the tensors' device)
    a tensor keeps its old value where ``ok`` is false: per dtype, the new
    and the old values are gathered into one flat buffer each, selected by
    one ``torch.where`` and scattered back by one ``_foreach_copy_``, a
    few launches however many tensors there are."""
    with torch.no_grad():
        if ok is None:
            for dst, new in pairs:
                dst.copy_(new)
            return
        groups = {}
        for dst, new in pairs:
            groups.setdefault((dst.dtype, dst.device), []).append((dst, new))
        for (dt, _), grp in groups.items():
            dsts = [d for d, _ in grp]
            new = torch.cat([n.to(dt).reshape(-1) for _, n in grp])
            old = torch.cat([d.reshape(-1) for d in dsts])
            sel = torch.where(ok, new, old).split([d.numel() for d in dsts])
            torch._foreach_copy_(dsts, [s.view(d.shape)
                                        for s, d in zip(sel, dsts)])


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


class Plateau(LearningRateSchedule):
    """Reduce the rate by ``factor`` when the monitored value
    (``state[monitor]``: ``"score"``, written by validation, or ``"loss"``)
    has not improved by ``epsilon`` for ``patience`` calls, then wait
    ``cooldown`` calls; never below ``min_lr``."""

    def __init__(self, monitor: str = "score", factor: float = 0.1,
                 patience: int = 10, mode: str = "min", epsilon: float = 1e-4,
                 cooldown: int = 0, min_lr: float = 0.0):
        self.monitor, self.factor, self.patience = monitor, factor, patience
        self.mode, self.epsilon, self.cooldown = mode, epsilon, cooldown
        self.min_lr = min_lr
        self.best = None
        self.wait = 0
        self.cooldown_counter = 0
        self.multiplier = 1.0

    def _better(self, cur, best):
        if self.mode == "min":
            return cur < best - self.epsilon
        return cur > best + self.epsilon

    def update_lr(self, lr, state):
        cur = state.get(self.monitor)
        if cur is not None:
            if self.best is None or self._better(cur, self.best):
                self.best = cur
                self.wait = 0
            elif self.cooldown_counter > 0:
                self.cooldown_counter -= 1
                self.wait = 0
            else:
                self.wait += 1
                if self.wait >= self.patience:
                    self.multiplier *= self.factor
                    self.wait = 0
                    self.cooldown_counter = self.cooldown
        return max(lr * self.multiplier, self.min_lr)

    def force_reduction(self) -> float:
        """One reduction now, whatever the patience counter says; resets
        the patience window and enters the cooldown as a reduction by
        patience does. Returns the new multiplier."""
        self.multiplier *= self.factor
        self.wait = 0
        self.cooldown_counter = self.cooldown
        return self.multiplier


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
    ``{'neval': 0, 'epoch': 1}`` the optimizer loop advances. A method
    defines ``init_state`` and ``_updates(grads, params, opt_state, lr)``,
    the (tensor, new value) pairs of one update."""

    def __init__(self, learningrate: float = 1e-3):
        self.learningrate = learningrate
        self.state = {"neval": 0, "epoch": 1}

    def init_state(self, params):
        return {}

    def _updates(self, grads, params, opt_state, lr):
        raise NotImplementedError(type(self).__name__)

    def update(self, grads, params, opt_state, lr):
        """One update, written in place; returns ``(params, opt_state)``,
        the trees given."""
        write_guarded(self._updates(grads, params, opt_state, lr))
        return params, opt_state

    def save(self, path, overwrite=True):
        """Pickle this method (hyperparameters, schedule and step state)
        with the checkpoints' atomic write. The pickle holds the port's
        classes: the JAX package's ``load`` does not read it."""
        import os
        if not overwrite and os.path.exists(path):
            raise IOError(f"{path} exists and overwrite=False")
        from .optimizer import _atomic_pickle
        _atomic_pickle(path, self)
        return self

    @staticmethod
    def load(path):
        """An optim method written by :meth:`save`."""
        import pickle
        with open(path, "rb") as f:
            m = pickle.load(f)
        if not isinstance(m, OptimMethod):
            raise TypeError(f"{path} does not contain an OptimMethod "
                            f"(got {type(m).__name__})")
        return m

    def get_learning_rate(self):
        return self.current_lr()

    def current_lr(self):
        return self.learningrate

    def current_lr_vector(self, k: int):
        """The rates of the next ``k`` steps, ``[lr(neval), ...,
        lr(neval + k - 1)]``, for a superstep: ``state['neval']`` is
        advanced through the window (a stateful schedule sees one
        ``update_lr`` call a step, as with K=1) and restored; a loss- or
        score-driven schedule sees the values as of the superstep's
        start."""
        if k == 1:
            return [self.current_lr()]
        n0 = self.state["neval"]
        try:
            lrs = []
            for i in range(k):
                self.state["neval"] = n0 + i
                lrs.append(self.current_lr())
        finally:
            self.state["neval"] = n0
        return lrs

    def clone(self):
        import copy
        return copy.deepcopy(self)

    def optimize(self, feval, x):
        """The reference's closure form, one step: ``feval(x) -> (loss,
        gradient)`` on ``x`` (a tensor or a tree of them), then one
        ``update`` of ``x`` IN PLACE (the method's state is kept between
        calls); returns ``(x, [loss])``."""
        tree = x if isinstance(x, dict) else {"x": x}
        if not hasattr(self, "_flat_state"):
            self._flat_state = self.init_state(tree)
        loss, g = feval(x)
        lr = self.current_lr()
        self.update(g if isinstance(g, dict) else {"x": g}, tree,
                    self._flat_state, lr)
        self.state["neval"] += 1
        return x, [loss]


def _sorted_leaves(tree):
    """The leaves of a tree, dict keys sorted at every level (the order
    JAX's ``ravel_pytree`` flattens in)."""
    if not isinstance(tree, dict):
        return [tree]
    return [t for k in sorted(tree) for t in _sorted_leaves(tree[k])]


def _ravel(tree):
    """(the leaves of ``tree`` as one flat vector, in ``_sorted_leaves``
    order; the function taking such a vector back to a tree of views)."""
    if not isinstance(tree, dict):
        shape = tree.shape
        return tree.reshape(-1), lambda v: v.reshape(shape)
    leaves = _sorted_leaves(tree)
    flat = torch.cat([t.reshape(-1) for t in leaves]) if leaves \
        else torch.zeros(0)

    def unravel(v):
        it = iter(v.split([t.numel() for t in leaves]))

        def rebuild(node):
            if not isinstance(node, dict):
                return next(it).reshape(node.shape)
            return {k: rebuild(node[k]) for k in sorted(node)}
        return rebuild(tree)
    return flat, unravel


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

    def _updates(self, grads, params, opt_state, lr):
        wd, mom, damp = self.weightdecay, self.momentum, self.dampening
        vs = flatten(opt_state["v"]) if mom > 0 else None
        out = []
        for name, (w, g) in _leaves(params, grads).items():
            if wd > 0:
                g = g + wd * w
            if mom > 0:
                v = mom * vs[name] + (1 - damp) * g
                out.append((vs[name], v))
                g = g + mom * v if self.nesterov else v
            out.append((w, w - lr * g))
        return out


class Adam(OptimMethod):
    """Adam with bias correction; lr / (1 + neval * learningrate_decay).
    The step counter ``t`` is a device int32 scalar and the bias
    corrections are computed from it in float32, as in JAX."""

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
        return {"m": _zeros_like(params), "v": _zeros_like(params),
                "t": _step_counter(params)}

    def _leaf(self, w, g, m, v, lr, bc1, bc2):
        """New (m, v, w) of one leaf."""
        b1, b2 = self.beta1, self.beta2
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        return m, v, w - lr * (m / bc1) / (torch.sqrt(v / bc2) + self.epsilon)

    def _updates(self, grads, params, opt_state, lr):
        t = opt_state["t"] + 1
        tf = t.float()
        bc1 = 1 - self.beta1 ** tf
        bc2 = 1 - self.beta2 ** tf
        out = [(opt_state["t"], t)]
        for w, g, m, v in _leaves(params, grads, opt_state["m"],
                                  opt_state["v"]).values():
            nm, nv, nw = self._leaf(w, g, m, v, lr, bc1, bc2)
            out += [(m, nm), (v, nv), (w, nw)]
        return out


class ParallelAdam(Adam):
    """Adam's update (the reference's parallel form is a sharding of it,
    which the one-device port does not need)."""


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

    def _leaf(self, w, g, m, v, lr, bc1, bc2):
        m, v, new = super()._leaf(w, g, m, v, lr, bc1, bc2)
        keep = self.decay_filter or (lambda x: x.dim() >= 2)
        if self.weight_decay and keep(w):
            new = new - lr * self.weight_decay * w
        return m, v, new


class Adagrad(OptimMethod):
    """Adagrad (optim/Adagrad.scala): accum += g^2, w -= lr g / (sqrt(accum)
    + 1e-10); lr / (1 + neval * learningrate_decay)."""

    def __init__(self, learningrate: float = 1e-3,
                 learningrate_decay: float = 0.0, weightdecay: float = 0.0,
                 **_ignored):
        super().__init__(learningrate)
        self.learningrate_decay = learningrate_decay
        self.weightdecay = weightdecay

    def current_lr(self):
        return self.learningrate / (1 + self.state["neval"] *
                                    self.learningrate_decay)

    def init_state(self, params):
        return {"accum": _zeros_like(params)}

    def _updates(self, grads, params, opt_state, lr):
        out = []
        for w, g, a in _leaves(params, grads, opt_state["accum"]).values():
            if self.weightdecay > 0:
                g = g + self.weightdecay * w
            na = a + g * g
            out += [(a, na), (w, w - lr * g / (torch.sqrt(na) + 1e-10))]
        return out


class Adadelta(OptimMethod):
    """Adadelta (optim/Adadelta.scala) with decay rate rho."""

    def __init__(self, decayrate: float = 0.9, epsilon: float = 1e-10,
                 **_ignored):
        super().__init__(1.0)
        self.rho, self.epsilon = decayrate, epsilon

    def init_state(self, params):
        return {"accum": _zeros_like(params),
                "delta_accum": _zeros_like(params)}

    def _updates(self, grads, params, opt_state, lr):
        rho, eps = self.rho, self.epsilon
        out = []
        for w, g, a, d in _leaves(params, grads, opt_state["accum"],
                                  opt_state["delta_accum"]).values():
            na = rho * a + (1 - rho) * g * g
            delta = g * torch.sqrt(d + eps) / torch.sqrt(na + eps)
            nd = rho * d + (1 - rho) * delta * delta
            out += [(a, na), (d, nd), (w, w - lr * delta)]
        return out


class Adamax(OptimMethod):
    """Adamax (optim/Adamax.scala); ``t`` a device int32 scalar."""

    def __init__(self, learningrate: float = 0.002, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-38, **_ignored):
        super().__init__(learningrate)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_state(self, params):
        return {"m": _zeros_like(params), "u": _zeros_like(params),
                "t": _step_counter(params)}

    def _updates(self, grads, params, opt_state, lr):
        b1, b2 = self.beta1, self.beta2
        t = opt_state["t"] + 1
        bc = 1 - b1 ** t.float()
        out = [(opt_state["t"], t)]
        for w, g, m, u in _leaves(params, grads, opt_state["m"],
                                  opt_state["u"]).values():
            nm = b1 * m + (1 - b1) * g
            nu = torch.maximum(b2 * u, g.abs() + self.epsilon)
            out += [(m, nm), (u, nu), (w, w - (lr / bc) * nm / nu)]
        return out


class RMSprop(OptimMethod):
    """RMSprop (optim/RMSprop.scala)."""

    def __init__(self, learningrate: float = 1e-2,
                 learningrate_decay: float = 0.0, decayrate: float = 0.99,
                 epsilon: float = 1e-8, **_ignored):
        super().__init__(learningrate)
        self.learningrate_decay = learningrate_decay
        self.decayrate, self.epsilon = decayrate, epsilon

    def current_lr(self):
        return self.learningrate / (1 + self.state["neval"] *
                                    self.learningrate_decay)

    def init_state(self, params):
        return {"accum": _zeros_like(params)}

    def _updates(self, grads, params, opt_state, lr):
        rho = self.decayrate
        out = []
        for w, g, a in _leaves(params, grads, opt_state["accum"]).values():
            na = rho * a + (1 - rho) * g * g
            out += [(a, na),
                    (w, w - lr * g / (torch.sqrt(na) + self.epsilon))]
        return out


class Ftrl(OptimMethod):
    """FTRL-proximal (optim/Ftrl.scala)."""

    def __init__(self, learningrate: float = 1e-3,
                 learningrate_power: float = -0.5,
                 initial_accumulator_value: float = 0.1,
                 l1_regularization_strength: float = 0.0,
                 l2_regularization_strength: float = 0.0,
                 l2_shrinkage_regularization_strength: float = 0.0,
                 **_ignored):
        super().__init__(learningrate)
        self.lr_power = learningrate_power
        self.init_accum = initial_accumulator_value
        self.l1 = l1_regularization_strength
        self.l2 = l2_regularization_strength
        self.l2_shrinkage = l2_shrinkage_regularization_strength

    def init_state(self, params):
        return {"accum": _full_like(params, self.init_accum),
                "linear": _zeros_like(params)}

    def _updates(self, grads, params, opt_state, lr):
        lp = self.lr_power
        out = []
        for w, g, a, lin in _leaves(params, grads, opt_state["accum"],
                                    opt_state["linear"]).values():
            g_shrunk = g + 2 * self.l2_shrinkage * w
            na = a + g * g
            if lp == -0.5:
                # sqrt(na) - sqrt(a) as (na - a) / (sqrt(na) + sqrt(a)):
                # the same value, without the cancellation that turns an
                # ulp of either root into ~1e-4 of sigma when g is small
                root = torch.sqrt(na)
                sigma = (na - a) / (root + torch.sqrt(a)) / lr
            else:
                root = torch.pow(na, -lp)
                sigma = (root - torch.pow(a, -lp)) / lr
            nl = lin + g_shrunk - sigma * w
            quad = root / lr + 2 * self.l2
            l_reg = torch.clamp(nl, -self.l1, self.l1)
            out += [(a, na), (lin, nl), (w, (l_reg - nl) / quad)]
        return out


class LarsSGD(OptimMethod):
    """Layer-wise adaptive rate scaling (optim/LarsSGD.scala), the trust
    ratio computed per parameter leaf."""

    def __init__(self, learningrate: float = 1e-2, trust: float = 1.0,
                 momentum: float = 0.9, weightdecay: float = 0.0,
                 learningrate_schedule=None, **_ignored):
        super().__init__(learningrate)
        self.trust, self.momentum, self.weightdecay = \
            trust, momentum, weightdecay
        self.learningrate_schedule = learningrate_schedule or Default()

    def current_lr(self):
        return self.learningrate_schedule.update_lr(self.learningrate,
                                                    self.state)

    def init_state(self, params):
        return {"v": _zeros_like(params)}

    def _updates(self, grads, params, opt_state, lr):
        out = []
        for w, g, v in _leaves(params, grads, opt_state["v"]).values():
            wn = torch.linalg.vector_norm(w.reshape(-1))
            gn = torch.linalg.vector_norm(g.reshape(-1))
            local_lr = torch.where(
                (wn > 0) & (gn > 0),
                self.trust * wn / (gn + self.weightdecay * wn + 1e-9),
                torch.ones_like(wn))
            nv = self.momentum * v + lr * local_lr * \
                (g + self.weightdecay * w)
            out += [(v, nv), (w, w - nv)]
        return out


class LBFGS(OptimMethod):
    """Limited-memory BFGS (optim/LBFGS.scala), driven from the host over
    flat vectors as in the JAX package: ``optimize(feval, x)`` flattens
    ``x`` (a tensor or a tree of them, leaves in the order JAX's
    ``ravel_pytree`` takes them), runs up to ``max_iter`` iterations of the
    two-loop recursion over the last ``n_correction`` (s, y) pairs (a
    pair kept only when s.y > 1e-10), the first step scaled by min(1, 1 /
    sum|g|), with Armijo backtracking (halving, at most 25 tries) when
    ``line_search``, and stops when max|g| <= ``tol_fun``, the directional
    derivative > -``tol_x``, the loss moves less than ``tol_fun`` or
    ``max_eval`` evaluations are spent. Returns ``(x, losses)``, x a new
    tree. The vectors stay on x's device; the loop reads back the scalars
    it decides on. ``update`` is a plain gradient step, for the training
    loop."""

    def __init__(self, max_iter: int = 20, max_eval: Optional[float] = None,
                 tol_fun: float = 1e-5, tol_x: float = 1e-9,
                 n_correction: int = 100, learningrate: float = 1.0,
                 line_search: bool = False, **_ignored):
        super().__init__(learningrate)
        self.max_iter, self.tol_fun, self.tol_x = max_iter, tol_fun, tol_x
        self.n_correction = n_correction
        self.line_search = line_search
        self.max_eval = max_eval or max_iter * 1.25

    def optimize(self, feval, x):
        x_flat, unravel = _ravel(x)
        x_flat = x_flat.detach().clone()

        def f(v):
            loss, g = feval(unravel(v))
            return float(loss), _ravel(g)[0].detach()

        losses, s_list, y_list, rho_list = [], [], [], []
        loss, g = f(x_flat)
        losses.append(loss)
        n_eval = 1
        for it in range(self.max_iter):
            if float(g.abs().max()) <= self.tol_fun:
                break
            # two-loop recursion
            q = g
            alphas = []
            for s, y, rho in zip(reversed(s_list), reversed(y_list),
                                 reversed(rho_list)):
                a = rho * torch.dot(s, q)
                alphas.append(a)
                q = q - a * y
            if y_list:
                q = torch.dot(s_list[-1], y_list[-1]) \
                    / torch.dot(y_list[-1], y_list[-1]) * q
            for (s, y, rho), a in zip(zip(s_list, y_list, rho_list),
                                      reversed(alphas)):
                b = rho * torch.dot(y, q)
                q = q + (a - b) * s
            d = -q
            t = self.learningrate if it > 0 or s_list else \
                min(1.0, 1.0 / float(g.abs().sum())) * self.learningrate
            gtd = float(torch.dot(g, d))
            if gtd > -self.tol_x:
                break
            if self.line_search:
                for _ in range(25):
                    new_loss, _ = f(x_flat + t * d)
                    n_eval += 1
                    if new_loss <= loss + 1e-4 * t * gtd:
                        break
                    t *= 0.5
            x_new = x_flat + t * d
            loss_new, g_new = f(x_new)
            n_eval += 1
            s, y = x_new - x_flat, g_new - g
            sy = float(torch.dot(s, y))
            if sy > 1e-10:
                if len(s_list) >= self.n_correction:
                    s_list.pop(0)
                    y_list.pop(0)
                    rho_list.pop(0)
                s_list.append(s)
                y_list.append(y)
                rho_list.append(1.0 / sy)
            converged = abs(loss_new - loss) < self.tol_fun
            x_flat, loss, g = x_new, loss_new, g_new
            losses.append(loss)
            if converged or n_eval >= self.max_eval:
                break
        self.state["neval"] += 1
        return unravel(x_flat), losses

    def init_state(self, params):
        return {}

    def _updates(self, grads, params, opt_state, lr):
        return [(w, w - lr * g) for w, g in _leaves(params, grads).values()]
