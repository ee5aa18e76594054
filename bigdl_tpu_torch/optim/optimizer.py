"""The training loop (counterpart of ``bigdl_tpu/optim/optimizer.py``: the
``BaseOptimizer`` core, ``LocalOptimizer`` and the ``Optimizer`` factory).

One step: the functional forward ``model.apply(params, state, x,
training=True, generator)`` (dropout drawn from one ``torch.Generator``
per run, the stand-in for JAX's ``next_rng_key``), the criterion plus the
regularizers' penalty (``optim.regularizer``), gradients of the loss with
``torch.autograd.grad``, gradient clipping (constant and global L2 norm),
frozen modules' gradients zeroed, then the optim method's update, which
writes the model's parameters IN PLACE, and the new model state
(BatchNorm running statistics) copied into the model's buffers. The NaN
guard is decided on the device, as in the JAX loop's compiled step: every
write keeps its old value where the loss is not finite
(``optim_method.write_guarded``), a frozen leaf keeps its value through
the update, and the step returns the loss as a device tensor without
reading it.

The loop reads the losses by the sync policy (``set_sync_policy``:
'sync' reads each step's loss, 'async' the previous step's, 'window:K'
keeps K in flight and reads the oldest), applies the NaN policy to what
it reads ('error' raises, 'skip' counts the step, 'resume' restores the
latest checkpoint), schedules lr per step, advances ``neval`` / ``epoch``
/ ``loss`` / ``epoch_finished`` in ``optim_method.state``, reshuffles per
epoch (the JAX package's order for the same data set seed) and stops at
the end trigger. Batches come from a stager (``optim.staging``): inline
with ``set_prefetch(0)`` / ``(1)``, on a lookahead thread that places on a
side stream with ``set_prefetch(2)`` and more (the default). With
``set_superstep(K)`` the stager stacks K batches into one ``[K, batch,
...]`` placement, the loop runs K eager steps on its slices (the port has
no ``lax.scan``: the same ops in the same order as K=1) and reads the K
losses at once; groups are cut where an end, validation or checkpoint
trigger would fire inside one. Validation and checkpoints
(``set_checkpoint``: JAX's payload keys and tree names with numpy leaves
in JAX's layout, written atomically, optionally on a writer thread) fire
after every step and at every epoch's end. ``metrics`` records
``data_time``, ``step_time`` and ``epoch_time``; with observability on,
``optim/loss_syncs``, ``engine/dispatches`` (a step, or a superstep) and
``optim/steps`` are counted as in JAX.

The model must be one whose ``apply(params, state, x, training,
generator)`` is the training forward (``Transformer`` and the ResNets
are). Not ported yet: summaries, remediation, stall deadlines, fault
policies, anomaly detection, the loop's spans and flight records,
``prepare_input`` and ``DistriOptimizer``.
"""
from __future__ import annotations

import os
import pickle
import queue
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from .. import observability as obs
from ..convert import flatten, host_copy_tree, unflatten
from ..dataset import AbstractDataSet, DataSet, ShardedDataSet
from ..nn.module import Container, copy_tree_into
from ..parallel import chaos as _chaos
from ..utils import engine
from .optim_method import SGD, OptimMethod, write_guarded
from .regularizer import regularization_loss, regularizer_tree
from .staging import _first_leaf, _index, _stack, place_host_value, staged
from .trigger import Trigger, max_epoch


def _read_umask():
    """The process umask, read from /proc where Linux has it (the
    ``os.umask`` flip is process-wide and racy against other threads)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("Umask:"):
                    return int(line.split()[1], 8)
    except (OSError, ValueError, IndexError):
        pass
    um = os.umask(0)
    os.umask(um)
    return um


# _atomic_pickle gives its mkstemp files (born 0600) the umask's modes
_UMASK = _read_umask()


def _atomic_pickle(path, payload):
    """Crash-consistent write: a unique temporary file, fsync, an atomic
    rename and a directory fsync, so a kill at any point leaves the
    previous file or the complete new one, never a truncated one. A
    failed write removes its temporary file."""
    _chaos.maybe_fire("checkpoint/write")
    import tempfile
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(
        prefix=os.path.basename(path) + ".", suffix=".tmp", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            os.fchmod(f.fileno(), 0o666 & ~_UMASK)
            pickle.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    try:
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass    # no directory fsync here: the file itself is durable


class _AsyncCheckpointWriter:
    """One daemon writer thread writing submissions IN ORDER, each through
    the atomic write. Payloads are host numpy only (the device-to-host
    copy is done before ``submit``). The queue is bounded, so a slow disk
    holds the loop back instead of piling up host copies of the model.
    ``flush`` drains it and raises the first write error."""

    def __init__(self, max_pending: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._err = None
        self._thread = None

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                path, payload = item
                try:
                    _atomic_pickle(path, payload)
                except Exception as e:  # noqa: BLE001 - raised in flush
                    if self._err is None:
                        self._err = e
            finally:
                self._q.task_done()

    def submit(self, path, payload):
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
        self._q.put((path, payload))

    def flush(self, timeout=None):
        if self._thread is not None:
            if timeout is None:
                self._q.join()
            else:
                deadline = time.monotonic() + timeout
                while self._q.unfinished_tasks and \
                        time.monotonic() < deadline:
                    time.sleep(0.05)
                if self._q.unfinished_tasks:
                    raise TimeoutError(
                        f"{self._q.unfinished_tasks} async checkpoint "
                        f"write(s) still pending after {timeout}s")
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError(
                f"async checkpoint write failed: {err}") from err

    def close(self, timeout=None):
        """Flush, then stop the writer thread; a writer wedged past
        ``timeout`` is abandoned to its daemon fate."""
        try:
            self.flush(timeout)
        finally:
            if self._thread is not None:
                try:
                    self._q.put_nowait(None)
                except queue.Full:
                    pass
                self._thread.join(timeout=30 if timeout is None
                                  else timeout)
                self._thread = None


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


def _frozen_names(model):
    """The dotted names of the parameters under frozen modules
    (``Module.freeze``), or None when nothing is frozen. Flags are per
    module, with no propagation from ancestors: ``freeze()`` marks whole
    subtrees, so ``unfreeze("head")`` under a frozen root works."""
    if not any(getattr(m, "_frozen", False) for m in model.modules_iter()):
        return None

    def rec(m, p, prefix):
        if isinstance(m, Container) and isinstance(p, dict):
            out = set()
            for k, v in p.items():
                if k.isdigit() and int(k) < len(m._modules):
                    out |= rec(m[int(k)], v, f"{prefix}{k}.")
                elif getattr(m, "_frozen", False):
                    out |= set(flatten({k: v}, prefix))
            return out
        if getattr(m, "_frozen", False):
            return set(flatten(p, prefix)) if isinstance(p, dict) \
                else {prefix[:-1]}
        return set()

    return rec(model, model.params, "")


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
        self.validation_trigger = None
        self.validation_set = None
        self.validation_methods = None
        self.validation_batch = None
        self.checkpoint_trigger = None
        self.checkpoint_path = None
        self.checkpoint_overwrite = True
        self.checkpoint_async = False
        self._ckpt_writer = _AsyncCheckpointWriter()
        self.clip_const = None
        self.clip_norm = None
        self.nan_policy = "error"   # or "skip" / "resume"
        self.max_nan_retries = 10   # consecutive non-finite steps before abort
        self.sync_policy = "sync"   # or "async" / "window:K"
        self.prefetch_depth = 2     # >= 2: the lookahead stager thread
        self.superstep = 1          # K steps a group, one loss readback
        self._pending_loss = None
        self._loss_window = deque()
        self._resolved_step = None  # the step of the last resolved loss
        self._resume_opt_state = None
        self.metrics = Metrics()

    # -- reference API surface ------------------------------------------
    def set_model(self, model):
        """Swap the model; training progress (neval, epoch) and any
        optimizer state loaded from a checkpoint reset with it."""
        self.model = model
        self.optim_method.state = {"neval": 0, "epoch": 1}
        self._resume_opt_state = None
        return self

    def set_criterion(self, criterion):
        self.criterion = criterion
        return self

    def set_traindata(self, training_set, batch_size=None):
        self.training_set = self._as_dataset(training_set)
        if batch_size:
            self.batch_size = batch_size
        return self

    def set_validation(self, trigger, dataset, methods, batch_size=None):
        """Evaluate ``methods`` on ``dataset`` (a data set, or a list of
        Samples) whenever ``trigger`` fires; batches of ``batch_size``
        (the training batch size when None)."""
        self.validation_trigger = trigger
        self.validation_set = self._as_dataset(dataset)
        self.validation_methods = list(methods)
        self.validation_batch = batch_size or self.batch_size
        return self

    def set_checkpoint(self, trigger, path, overwrite=True,
                       async_write=False):
        """Write a checkpoint into the directory ``path`` whenever
        ``trigger`` fires: ``checkpoint.bigdl``, or with ``overwrite=False``
        ``checkpoint_e{epoch}_i{neval}.bigdl``. ``async_write=True`` moves
        pickling and file IO to a writer thread (in order, atomic): the
        loop pays only the device-to-host copy. ``wait_for_checkpoints``
        (also called at the end of ``optimize``) flushes and raises a
        write's error."""
        self.checkpoint_trigger = trigger
        self.checkpoint_path = path
        self.checkpoint_overwrite = overwrite
        self.checkpoint_async = async_write
        os.makedirs(path, exist_ok=True)
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

    def set_sync_policy(self, policy: str):
        """'sync' (default) reads each step's loss at once: the host waits
        for the device every iteration. 'async' reads the PREVIOUS step's
        loss, so the next step is queued while the device computes. With
        'window:K' up to K losses stay in flight and the host reads the
        oldest once the window is full: loss logging, NaN handling and
        loss-driven triggers lag K-1 steps ('window:1' is 'sync'). The
        in-step guard keeps the parameters safe meanwhile."""
        if isinstance(policy, str) and policy.startswith("window:"):
            k = int(policy.split(":", 1)[1])
            if k < 1:
                raise ValueError(f"window size must be >= 1, got {k}")
        else:
            assert policy in ("sync", "async")
        self.sync_policy = policy
        return self

    def set_prefetch(self, depth: int):
        """Lookahead of the batch stager: with ``depth >= 2`` a host thread
        produces and places batches N+1..N+depth while step N runs; ``0`` /
        ``1`` place inline. The stager keeps the order, so training is the
        same either way."""
        depth = int(depth)
        if depth < 0:
            raise ValueError(f"prefetch depth must be >= 0, got {depth}")
        self.prefetch_depth = depth
        return self

    def set_superstep(self, k: int):
        """K steps a group: one stacked ``[K, batch, ...]`` placement, K
        steps on its slices and one ``[K]`` loss readback, with lr
        precomputed for the K steps (``current_lr_vector``). A group is
        cut where an end, validation or checkpoint trigger would fire
        inside it, and at an epoch's end. With K > 1 the group's readback
        replaces the sync policy's reads (the same K-step lag as
        'window:K'). ``1`` is the per-step loop."""
        k = int(k)
        if k < 1:
            raise ValueError(f"superstep must be >= 1, got {k}")
        self.superstep = k
        return self

    def _window_k(self) -> Optional[int]:
        if isinstance(self.sync_policy, str) and \
                self.sync_policy.startswith("window:"):
            return int(self.sync_policy.split(":", 1)[1])
        return None

    def set_nan_policy(self, policy: str):
        """'error' raises on a non-finite loss; 'skip' drops the step (the
        parameters stay as they were) and counts it, up to
        ``max_nan_retries`` in a row; 'resume' restores the latest
        checkpoint (``set_checkpoint`` first)."""
        assert policy in ("error", "skip", "resume")
        self.nan_policy = policy
        return self

    def _latest_checkpoint(self):
        from ..parallel.elastic import find_latest_checkpoint
        return find_latest_checkpoint(self.checkpoint_path)

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

    def _step(self, params, mstate, opt_state, x, y, lr, generator):
        """One training step; returns the loss as a device tensor, unread.
        Every write of the update and of the new model state keeps its old
        value where the loss is not finite."""
        leaves = flatten(params)
        out, new_mstate = self.model.apply(params, mstate, x, training=True,
                                           generator=generator)
        loss = self.criterion._forward(out, y)
        if self._reg_tree:
            loss = loss + regularization_loss(self._reg_tree, params)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        loss = loss.detach()
        g = _clip_grads(unflatten(dict(zip(leaves, grads))),
                        self.clip_const, self.clip_norm)
        if self._frozen:
            g = unflatten({k: v * 0.0 if k in self._frozen else v
                           for k, v in flatten(g).items()})
        writes = self.optim_method._updates(g, params, opt_state, lr)
        if self._frozen:
            # weight decay must not move a frozen leaf either
            keep = {id(leaves[k]) for k in self._frozen}
            writes = [(d, n) for d, n in writes if id(d) not in keep]
        new = flatten(new_mstate)
        writes += [(t, new[k]) for k, t in flatten(mstate).items()
                   if new[k] is not t]
        write_guarded(writes, torch.isfinite(loss))
        return loss

    def _stage_minibatch(self, mb):
        """A host MiniBatch -> (x, y) on the device (on the stager thread
        with prefetch, inline otherwise)."""
        return (place_host_value(mb.get_input(), self.device),
                place_host_value(mb.get_target(), self.device))

    def _stage_minibatch_host(self, mb):
        """Superstep stage 1: the host (x, y); ``_stage_group`` places the
        whole group at once."""
        return mb.get_input(), mb.get_target()

    def _stage_group(self, items):
        """K host microbatches -> ``(k, xs, ys)`` with ``[k, batch, ...]``
        stacks on the device, one placement each."""
        xs = _stack([x for x, _ in items])
        ys = _stack([y for _, y in items])
        return (len(items), place_host_value(xs, self.device),
                place_host_value(ys, self.device))

    @staticmethod
    def _stage_group_key(staged):
        """Stacking key: the per-step batch size, so a ragged final batch
        starts its own, smaller group."""
        x, _ = staged
        return np.shape(_first_leaf(x))[0]

    def _observe_loss(self, loss, step=None):
        """Apply the sync policy to this step's device loss: the host float
        to examine this iteration, or None while a window is filling.
        Every read is one device sync, counted in ``optim/loss_syncs``.
        ``step`` is the iteration of this step; under 'async' /
        'window:K' the float is an older step's, named by
        ``self._resolved_step``."""
        k = self._window_k()
        self._resolved_step = step
        if k is not None:
            self._loss_window.append((step, loss))
            if len(self._loss_window) < k:
                return None
            if obs.enabled():
                obs.counter("optim/loss_syncs").inc()
            self._resolved_step, oldest = self._loss_window.popleft()
            return float(oldest)
        if obs.enabled():
            obs.counter("optim/loss_syncs").inc()
        if self.sync_policy == "async":
            prev, self._pending_loss = self._pending_loss, (step, loss)
            if prev is not None:
                self._resolved_step, loss = prev
            return float(loss)
        return float(loss)

    def _drain_pending_losses(self, state):
        """Read the losses still in flight when the loop ends ('async''s
        one, 'window:K''s up to K-1): a NaN on the final steps must not be
        swallowed."""
        pending = list(self._loss_window)
        self._loss_window.clear()
        if self._pending_loss is not None:
            pending.append(self._pending_loss)
            self._pending_loss = None
        for _step, dev in pending:
            final = float(dev)
            if np.isfinite(final):
                state["loss"] = final
            elif self.nan_policy == "error":
                raise FloatingPointError(
                    f"non-finite loss {final} on a final step "
                    f"({self.sync_policy} lagged read)")
            else:
                self.metrics.add("nan_skips", 1.0)

    def _host_step_state(self, params, opt_state, mstate):
        """Host numpy copies of the step's trees, the checkpoint's form
        (JAX's names and layouts). The copies are complete when this
        returns, so the next step may write the tensors."""
        return {"params": host_copy_tree(params),
                "opt_state": host_copy_tree(opt_state),
                "model_state": host_copy_tree(mstate)}

    def _checkpoint_payload(self, params, opt_state, mstate, state):
        """The checkpoint: JAX's keys, ``optim_host_state`` from the
        caller's ``state``."""
        return {**self._host_step_state(params, opt_state, mstate),
                "optim_host_state": dict(state),
                "epoch": state["epoch"], "neval": state["neval"]}

    def _checkpoint(self, params, opt_state, mstate, state, tag=None,
                    force_sync=False):
        """Write one checkpoint; returns its path. ``force_sync`` bypasses
        the writer thread."""
        if tag is None:
            tag = "" if self.checkpoint_overwrite else \
                f"_e{state['epoch']}_i{state['neval']}"
        path = os.path.join(self.checkpoint_path, f"checkpoint{tag}.bigdl")
        payload = self._checkpoint_payload(params, opt_state, mstate, state)
        if self.checkpoint_async and not force_sync:
            self._ckpt_writer.submit(path, payload)
        else:
            _atomic_pickle(path, payload)
        return path

    def wait_for_checkpoints(self):
        """Block until every async checkpoint write has landed (raising a
        write's error). Nothing to wait for with synchronous writes."""
        self._ckpt_writer.flush()

    def _close_checkpoints(self, timeout=None):
        self._ckpt_writer.close(timeout=timeout)

    def load_checkpoint(self, path):
        """Resume from a checkpoint (the port's or the JAX package's): the
        parameters and model state are copied into the model's tensors,
        the host state (neval, epoch, ...) into ``optim_method.state``,
        and the optimizer state is restored when ``optimize`` starts."""
        with open(path, "rb") as f:
            payload = pickle.load(f)
        copy_tree_into(self.model.params, payload["params"])
        copy_tree_into(self.model.state, payload["model_state"])
        self.optim_method.state.update(payload["optim_host_state"])
        self._resume_opt_state = payload["opt_state"]
        return self

    def _restore_step_state(self, payload, params, opt_state, mstate):
        """Copy a checkpoint's trees into the live tensors (queued after
        the steps already in flight)."""
        copy_tree_into(params, payload["params"])
        copy_tree_into(opt_state, payload["opt_state"])
        copy_tree_into(mstate, payload["model_state"])

    def _validate(self, state):
        """Run the validation methods in evaluate mode; ``{repr(method):
        value}``, the first value written to ``state["score"]`` (None
        without a validation set)."""
        if self.validation_set is None:
            return None
        from .evaluator import Evaluator
        was_training = bool(self.model.training)
        self.model.evaluate()
        results = Evaluator(self.model).evaluate(
            self.validation_set, self.validation_methods,
            self.validation_batch)
        if was_training:
            self.model.training()
        scores = {repr(m): r.result()[0]
                  for m, r in zip(self.validation_methods, results)}
        if scores:
            state["score"] = next(iter(scores.values()))
        return scores

    def _fire_mid_epoch(self, state, params, opt_state, mstate):
        fired = False
        if self.validation_trigger is not None and \
                self.validation_trigger(state):
            self._validate(state)
            fired = True
        if self.checkpoint_trigger is not None and \
                self.checkpoint_trigger(state):
            self._checkpoint(params, opt_state, mstate, state)
            fired = True
        return fired

    def _fire_epoch(self, state, params, opt_state, mstate):
        self._fire_mid_epoch(state, params, opt_state, mstate)

    def _resume(self, state, params, opt_state, mstate):
        """'resume': restore the latest checkpoint into the live tensors
        and its host state into ``state``."""
        self.wait_for_checkpoints()     # writes in flight land first
        snap = self._latest_checkpoint()
        if snap is None:
            raise FloatingPointError(
                "non-finite loss with nan_policy='resume' but no checkpoint "
                "saved yet - call set_checkpoint(...) first")
        with open(snap, "rb") as f:
            payload = pickle.load(f)
        state.update(payload["optim_host_state"])
        self._restore_step_state(payload, params, opt_state, mstate)
        self.metrics.add("nan_resumes", 1.0)

    def _nan_check(self, loss_val, state, nan_streak):
        """The NaN policy's raises for a non-finite loss read."""
        if self.nan_policy == "error":
            raise FloatingPointError(
                f"non-finite loss {loss_val} at iteration {state['neval']} "
                f"- enable set_nan_policy('skip') to drop such steps")
        if nan_streak > self.max_nan_retries:
            raise FloatingPointError(
                f"{nan_streak} consecutive non-finite steps "
                f"(nan_policy='{self.nan_policy}') - data or "
                f"hyperparameters are unrecoverably bad")

    # -- main loop -------------------------------------------------------
    def optimize(self):
        """Train to the end trigger; returns the model, whose parameters
        now hold the trained values."""
        try:
            return self._optimize_impl()
        finally:
            # idempotent after the clean path's unbounded close: a crash
            # must not leak the writer thread
            self._close_checkpoints(timeout=30.0)

    def _optimize_impl(self):
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
        if self._resume_opt_state is not None:
            copy_tree_into(opt_state, self._resume_opt_state)
        self._reg_tree = regularizer_tree(model)
        self._frozen = _frozen_names(model)
        # never read a dead run's in-flight losses
        self._pending_loss = None
        self._loss_window.clear()
        generator = engine.new_generator(self.device)
        state = self.optim_method.state
        batched = self._batched()
        done = False
        nan_streak = 0
        k = self.superstep
        while not done:
            batched.shuffle()
            epoch_start = time.time()
            if k > 1:
                batches = staged(batched.data(train=True),
                                 self._stage_minibatch_host,
                                 depth=self.prefetch_depth, name="stager",
                                 group=k, group_fn=self._stage_group,
                                 group_key=self._stage_group_key,
                                 device=self.device)
                run = self._run_epoch_supersteps
            else:
                batches = staged(batched.data(train=True),
                                 self._stage_minibatch,
                                 depth=self.prefetch_depth, name="stager",
                                 device=self.device)
                run = self._run_epoch_steps
            try:
                done, nan_streak = run(batches, state, params, mstate,
                                       opt_state, generator, nan_streak)
            finally:
                batches.close()     # join the stager thread, always
            if not done:
                state["epoch"] += 1
                state["epoch_finished"] = True
                self.metrics.add("epoch_time", time.time() - epoch_start)
                self._fire_epoch(state, params, opt_state, mstate)
                done = self.end_trigger(state)
        self._drain_pending_losses(state)
        self._close_checkpoints()   # land async writes, stop the writer
        return model

    def _run_epoch_steps(self, batches, state, params, mstate, opt_state,
                         generator, nan_streak):
        """One epoch of the per-step loop: returns (False, streak) when the
        batches run out, (True, streak) when the end trigger fires."""
        optim = self.optim_method
        while True:
            t0 = time.time()
            try:
                x, y = next(batches)
            except StopIteration:
                return False, nan_streak
            t1 = time.time()
            loss = self._step(params, mstate, opt_state, x, y,
                              optim.current_lr(), generator)
            if obs.enabled():
                obs.counter("engine/dispatches").inc()
            # the step just queued is iteration neval+1; 'async' and
            # 'window:K' read an older one (_resolved_step)
            loss_val = self._observe_loss(loss, state["neval"] + 1)
            t2 = time.time()
            if loss_val is not None and not np.isfinite(loss_val):
                nan_streak += 1
                self._nan_check(loss_val, state, nan_streak)
                if self.nan_policy == "resume":
                    self._resume(state, params, opt_state, mstate)
                    # the in-flight losses are of steps the restore undid
                    self._pending_loss = None
                    self._loss_window.clear()
                    continue
                # 'skip': the guard kept the state; the iteration counts
                self.metrics.add("nan_skips", 1.0)
                state["neval"] += 1
                continue
            if loss_val is not None:
                nan_streak = 0
                state["loss"] = loss_val
            state["neval"] += 1
            state["epoch_finished"] = False
            self.metrics.add("data_time", t1 - t0)
            self.metrics.add("step_time", t2 - t1)
            if obs.enabled():
                obs.counter("optim/steps").inc()
            self._fire_mid_epoch(state, params, opt_state, mstate)
            if self.end_trigger(state):
                return True, nan_streak

    def _clamp_superstep(self, state, k):
        """The largest j <= k such that no end, validation or checkpoint
        trigger fires at an iteration inside a j-step group: the triggers
        are probed (without side effects) at neval+1 .. neval+k-1, so a
        firing point lands on a group boundary, where it lands with K=1.
        Loss- and score-driven triggers see the values read so far."""
        if k <= 1:
            return k
        triggers = [t for t in (self.end_trigger, self.validation_trigger,
                                self.checkpoint_trigger) if t is not None]
        if not triggers:
            return k
        sim = dict(state)
        sim["epoch_finished"] = False
        for i in range(1, k):
            sim["neval"] = state["neval"] + i
            for t in triggers:
                fired = t.probe(sim) if hasattr(t, "probe") \
                    else bool(t(dict(sim)))
                if fired:
                    return i
        return k

    def _run_epoch_supersteps(self, batches, state, params, mstate,
                              opt_state, generator, nan_streak):
        """The superstep epoch loop: ``batches`` yields ``(k, xs, ys)``
        stacks; k steps run on their slices and the k losses are read at
        once, then the per-step bookkeeping (NaN policy, loss, counters)
        replays on the host over them. A NaN in a step is skipped by the
        guard and the later steps go on from the kept state, as in JAX.
        Returns as ``_run_epoch_steps`` does."""
        optim = self.optim_method
        pending = None  # the clamped rest of a group (device slices)
        while True:
            t0 = time.time()
            if pending is not None:
                (k, xs, ys), pending = pending, None
            else:
                try:
                    k, xs, ys = next(batches)
                except StopIteration:
                    return False, nan_streak
            j = self._clamp_superstep(state, k)
            if j < k:
                # a trigger fires inside the group: run the first j now
                pending = (k - j, _index(xs, slice(j, None)),
                           _index(ys, slice(j, None)))
                xs, ys = _index(xs, slice(0, j)), _index(ys, slice(0, j))
                k = j
            lrs = optim.current_lr_vector(k)
            t1 = time.time()
            losses = torch.stack([
                self._step(params, mstate, opt_state, _index(xs, i),
                           _index(ys, i), lrs[i], generator)
                for i in range(k)])
            if obs.enabled():
                obs.counter("engine/dispatches").inc()
            losses = losses.cpu().tolist()     # the one [k] readback
            if obs.enabled():
                obs.counter("optim/loss_syncs").inc()
            t2 = time.time()
            self.metrics.add("data_time", t1 - t0)
            self.metrics.add("step_time", t2 - t1)
            if obs.enabled():
                obs.counter("optim/steps").inc(k)
            restored = False
            for loss_val in losses:
                if not np.isfinite(loss_val):
                    nan_streak += 1
                    self._nan_check(loss_val, state, nan_streak)
                    if self.nan_policy == "resume":
                        # the group's later losses are of undone updates
                        self._resume(state, params, opt_state, mstate)
                        restored = True
                        break
                    self.metrics.add("nan_skips", 1.0)
                    state["neval"] += 1
                    continue
                nan_streak = 0
                state["loss"] = loss_val
                state["neval"] += 1
                state["epoch_finished"] = False
            if restored:
                continue
            # the triggers are asked once, at the group's boundary, where
            # the parameters and the counters agree
            self._fire_mid_epoch(state, params, opt_state, mstate)
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
