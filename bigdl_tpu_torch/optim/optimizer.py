"""The training loop (counterpart of ``bigdl_tpu/optim/optimizer.py``: the
``BaseOptimizer`` core, ``LocalOptimizer`` and the ``Optimizer`` factory).

One step: the functional forward ``model.apply(params, state, x,
training=True, generator)`` (dropout drawn from one ``torch.Generator``
per run, the stand-in for JAX's ``next_rng_key``), the criterion,
gradients of the loss with ``torch.autograd.grad``, gradient clipping
(constant and global L2 norm), then the optim method's update, which
writes the model's parameters IN PLACE, and the new model state
(BatchNorm running statistics) copied into the model's buffers. A
non-finite loss leaves the parameters, the optimizer state and the model
state as they were (the JAX loop's ``pick(new, old)``);
``set_nan_policy('error')`` then raises and ``'skip'`` counts the step and
goes on. The loop
schedules lr per step, advances ``neval`` / ``epoch`` / ``loss`` /
``epoch_finished`` in ``optim_method.state``, reshuffles per epoch (the
same order as the JAX package for the same data set seed) and stops at
the end trigger. ``metrics`` records ``data_time``, ``step_time`` and
``epoch_time`` per step or epoch.

The model must be one whose ``apply(params, state, x, training,
generator)`` is the training forward (``Transformer`` and the ResNets
are). Not ported yet: supersteps, the
staging thread, async / windowed loss reads, checkpoints and the 'resume'
policy, validation, summaries, regularizers, frozen modules, remediation,
fault policies, observability, and ``DistriOptimizer``.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..convert import flatten, unflatten
from ..dataset import AbstractDataSet, DataSet, ShardedDataSet
from ..nn.module import assign_state
from ..utils import engine
from .optim_method import SGD, OptimMethod
from .trigger import Trigger, max_epoch


class Metrics:
    """Per-phase timings in seconds: ``values[name]`` lists every
    reading."""

    def __init__(self, namespace: str = "optim"):
        engine.refuse_unported("Metrics", namespace=(namespace, "optim"))
        self.values = {}

    def add(self, name, value):
        self.values.setdefault(name, []).append(value)

    def mean(self, name):
        if name not in self.values:
            raise KeyError(f"no metric named {name!r} has been recorded "
                           f"(seen: {sorted(self.values)})")
        v = self.values[name]
        return sum(v) / len(v)

    def summary(self):
        return {k: self.mean(k) for k in self.values}


def _clip_grads(grads, clip_const=None, clip_norm=None):
    """Clip a gradient tree to [lo, hi] elementwise (``clip_const``), then
    scale it so its global L2 norm is at most ``clip_norm``. Returns a new
    tree."""
    flat = flatten(grads)
    if clip_const is not None:
        lo, hi = clip_const
        flat = {k: g.clamp(lo, hi) for k, g in flat.items()}
    if clip_norm is not None:
        total = torch.sqrt(sum(g.square().sum() for g in flat.values()))
        scale = torch.clamp(clip_norm / (total + 1e-12), max=1.0)
        flat = {k: g * scale for k, g in flat.items()}
    return unflatten(flat)


def _place(a, device):
    """A host batch array as a tensor on ``device`` (float64 becomes
    float32, as JAX's default 32-bit mode makes it)."""
    if a is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.dtype == torch.float64:
        t = t.float()
    return t.to(device)


class BaseOptimizer:
    """``device``: where training runs - the CUDA device by default, which
    raises when there is none; ``'cpu'`` for the CPU. The model must already
    live there."""

    def __init__(self, model, training_set, criterion,
                 optim_method: Optional[OptimMethod] = None,
                 end_trigger: Optional[Trigger] = None, batch_size: int = 32,
                 device=None):
        self.device = engine.resolve_device(device)
        self.model = model
        self.criterion = criterion
        self.optim_method = optim_method or SGD(learningrate=0.01)
        self.end_trigger = end_trigger or max_epoch(1)
        self.batch_size = batch_size
        self.training_set = self._as_dataset(training_set)
        self.clip_const = None
        self.clip_norm = None
        self.nan_policy = "error"
        self.max_nan_retries = 10  # consecutive non-finite steps before abort
        self.metrics = Metrics()

    # -- reference API surface ------------------------------------------
    def set_model(self, model):
        """Swap the model; training progress (neval, epoch) resets."""
        self.model = model
        self.optim_method.state = {"neval": 0, "epoch": 1}
        return self

    def set_criterion(self, criterion):
        self.criterion = criterion
        return self

    def set_traindata(self, training_set, batch_size=None):
        self.training_set = self._as_dataset(training_set)
        if batch_size:
            self.batch_size = batch_size
        return self

    def set_end_when(self, trigger):
        self.end_trigger = trigger
        return self

    def set_gradclip_const(self, clip_min: float, clip_max: float):
        self.clip_const = (clip_min, clip_max)
        return self

    def set_gradclip_l2norm(self, clip_norm: float):
        self.clip_norm = clip_norm
        return self

    def disable_gradclip(self):
        self.clip_const = None
        self.clip_norm = None
        return self

    def set_nan_policy(self, policy: str):
        """'error' raises on a non-finite loss; 'skip' drops the step (the
        parameters stay as they were) and counts it, up to
        ``max_nan_retries`` in a row."""
        if policy not in ("error", "skip"):
            raise ValueError(f"nan policy must be 'error' or 'skip' (the "
                             f"port has no checkpoints to resume from), got "
                             f"{policy!r}")
        self.nan_policy = policy
        return self

    # -- internals -------------------------------------------------------
    def _as_dataset(self, ds):
        if ds is None or isinstance(ds, AbstractDataSet):
            return ds
        if isinstance(ds, tuple) and len(ds) == 2:
            return DataSet.from_arrays(ds[0], ds[1])
        if isinstance(ds, list):
            return DataSet.array(ds)
        if hasattr(ds, "data") and hasattr(ds, "size"):
            return ds  # a batch-level data set
        raise TypeError(f"unsupported dataset {type(ds)}")

    def _batched(self):
        if hasattr(self.training_set, "batches_per_epoch"):
            return self.training_set  # already yields MiniBatches
        return ShardedDataSet(self.training_set, self.batch_size)

    def _step(self, params, mstate, opt_state, x, y, lr, generator) -> float:
        """One training step; returns the loss as a host float (the one
        device sync of the step). The parameter update and the new model
        state are skipped on a non-finite loss."""
        leaves = flatten(params)
        out, new_mstate = self.model.apply(params, mstate, x, training=True,
                                           generator=generator)
        loss = self.criterion._forward(out, y)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        loss_val = float(loss.detach())
        if np.isfinite(loss_val):
            g = _clip_grads(unflatten(dict(zip(leaves, grads))),
                            self.clip_const, self.clip_norm)
            self.optim_method.update(g, params, opt_state, lr)
            assign_state(mstate, new_mstate)
        return loss_val

    def optimize(self):
        """Train to the end trigger; returns the model, whose parameters
        now hold the trained values."""
        model = self.model
        where = {p.device for p in model.parameters()}
        if where != {self.device}:
            raise ValueError(f"the model lives on {sorted(map(str, where))}, "
                             f"the optimizer on {self.device}: build the "
                             f"model with device='{self.device}'")
        model.training()
        params = model.params
        mstate = model.state
        opt_state = self.optim_method.init_state(params)
        generator = engine.new_generator(self.device)
        state = self.optim_method.state
        batched = self._batched()
        done = False
        nan_streak = 0
        while not done:
            batched.shuffle()
            epoch_start = time.time()
            done, nan_streak = self._run_epoch(
                iter(batched.data(train=True)), state, params, mstate,
                opt_state, generator, nan_streak)
            if not done:
                state["epoch"] += 1
                state["epoch_finished"] = True
                self.metrics.add("epoch_time", time.time() - epoch_start)
                done = self.end_trigger(state)
        return model

    def _run_epoch(self, batches, state, params, mstate, opt_state,
                   generator, nan_streak):
        """Steps until the epoch's batches run out (returns (False, ...))
        or the end trigger fires (returns (True, ...))."""
        optim = self.optim_method
        while True:
            t0 = time.time()
            mb = next(batches, None)
            if mb is None:
                return False, nan_streak
            x = _place(mb.input, self.device)
            y = _place(mb.target, self.device)
            t1 = time.time()
            loss_val = self._step(params, mstate, opt_state, x, y,
                                  optim.current_lr(), generator)
            t2 = time.time()
            if not np.isfinite(loss_val):
                nan_streak += 1
                if self.nan_policy == "error":
                    raise FloatingPointError(
                        f"non-finite loss {loss_val} at iteration "
                        f"{state['neval']} - enable set_nan_policy('skip') "
                        f"to drop such steps")
                if nan_streak > self.max_nan_retries:
                    raise FloatingPointError(
                        f"{nan_streak} consecutive non-finite steps "
                        f"(nan_policy='{self.nan_policy}') - data or "
                        f"hyperparameters are unrecoverably bad")
                self.metrics.add("nan_skips", 1.0)
                state["neval"] += 1
                continue
            nan_streak = 0
            state["loss"] = loss_val
            state["neval"] += 1
            state["epoch_finished"] = False
            self.metrics.add("data_time", t1 - t0)
            self.metrics.add("step_time", t2 - t1)
            if self.end_trigger(state):
                return True, nan_streak


class LocalOptimizer(BaseOptimizer):
    """Training on one device."""


class Optimizer(BaseOptimizer):
    """Factory with the reference's signature. The port runs on one GPU
    so far, so it always builds a :class:`LocalOptimizer`."""

    def __new__(cls, model=None, training_set=None, training_rdd=None,
                criterion=None, optim_method=None, end_trigger=None,
                batch_size: int = 32, device=None):
        training = training_set if training_set is not None else training_rdd
        return LocalOptimizer(model, training, criterion, optim_method,
                              end_trigger, batch_size, device=device)

    @staticmethod
    def create(model, training_set, criterion, end_trigger=None,
               batch_size=32, optim_method=None, cores=None,
               bigdl_type="float", device=None):
        """pyspark ``Optimizer.create`` spelling (``cores`` and
        ``bigdl_type`` are ignored)."""
        return Optimizer(model=model, training_set=training_set,
                         criterion=criterion, optim_method=optim_method,
                         end_trigger=end_trigger, batch_size=batch_size,
                         device=device)
