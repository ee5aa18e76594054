"""The training loop (counterpart of ``bigdl_tpu/optim/optimizer.py``: the
``BaseOptimizer`` core, ``LocalOptimizer``, ``DistriOptimizer`` /
``ParallelOptimizer`` and the ``Optimizer`` factory).

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

Summaries (``set_train_summary`` / ``set_val_summary``): ``Loss``,
``LearningRate`` and ``Throughput`` after every step, the validation
scores after every validation, each gated by its ``set_summary_trigger``.
With observability on, the loop records JAX's spans (``step``,
``step/data_fetch``, ``step/dispatch``, ``step/loss_sync``,
``step/superstep``, ``step/validate``, ``step/checkpoint_submit``), its
flight records (``train/start``, ``step``, ``nan``, ``epoch``,
``checkpoint``; a lagged loss carries the step that produced it), a crash
bundle on any failure but ``TrainingHalted``, the ``optim/throughput``
gauge, memory telemetry, metric snapshots and ``BIGDL_TPU_PROFILE``
windows, and pulses a stall beacon (``set_stall_deadline``) that opens at
the startup grace (the first step builds the kernels) and tightens after
the first dispatch. The loss anomaly detector (``set_anomaly_detection``)
reads the losses the sync policy resolved. ``set_fault_policy`` snapshots
the step's trees (on the device) and the dropout generator before every
dispatch and replays a transient failure from that snapshot, bit for bit
the fault-free run; ``set_remediation`` halts a stalled run with a
checkpoint taken on a side thread, and drives the lr and early stopping
from plateaus and spikes, halts on a lost or stale heartbeat peer, feeds
a straggler monitor, and probes a distributed run's mesh on a stall.
``DistriOptimizer`` trains one process a rank (its docstring). The step
runs through ``observability.perf.instrument_jit`` (``optim/step``, keyed
on the batch's shapes; a superstep group is one program of k steps), and
with observability on each step after the counted one publishes the
live MFU and step-phase gauges (``perf.note_step``), as in JAX.

The model must be one whose ``apply(params, state, x, training,
generator)`` is the training forward (``Transformer`` and the ResNets
are).
"""
from __future__ import annotations

import logging
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
from ..observability import cluster as _cluster
from ..observability import flight as _flight
from ..observability import health as _health
from ..parallel import chaos as _chaos
from ..parallel.failure import (PERMANENT, TRANSIENT, FaultPolicy,
                                HeartbeatLost, TrainingHalted,
                                _run_with_timeout, classify_failure,
                                probe_mesh)
from ..utils import engine
from .optim_method import SGD, OptimMethod, Plateau, write_guarded
from .regularizer import regularization_loss, regularizer_tree
from .staging import _first_leaf, _index, _stack, place_host_value, staged
from .trigger import Trigger, max_epoch

__all__ = ["Metrics", "RemediationPolicy", "BaseOptimizer", "LocalOptimizer",
           "DistriOptimizer", "ParallelOptimizer", "Optimizer"]

_LOG = logging.getLogger(__name__)

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
        """Record one reading; with observability on it is also observed
        in the ``optim/<name>`` histogram, as in JAX."""
        self.values.setdefault(name, []).append(value)
        if obs.enabled():
            obs.histogram(f"optim/{name}").observe(value)

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


class RemediationPolicy:
    """What the loop does when the health layer sees trouble (JAX's
    Tier 1), with JAX's parameters:

    * stalls: when the step beacon stalls (observability on),
      ``halt_on_stall`` checkpoints the last completed step's
      state from a side thread (the loop is wedged), dumps a flight bundle
      and queues a :class:`~bigdl_tpu_torch.parallel.failure.TrainingHalted`
      that the loop raises when it moves again, before its next step;
      ``exit_process`` then ``os._exit(86)``. The wait for the loop to
      reach its data fetch, and the checkpoint's device-to-host copy, are
      each bounded by ``halt_artifact_timeout_s``. A distributed run first
      probes its mesh (``parallel.failure.probe_mesh``, bounded by
      ``probe_timeout_s``): a probe that fails makes the stall PERMANENT
      and halts; otherwise, without ``halt_on_stall``, the stall is
      transient and the beacon re-arms;
    * heartbeat membership: with a ``heartbeat``
      (``parallel.failure.Heartbeat``) the loop beats every
      ``heartbeat_every`` steps with ``heartbeat_timeout_s``; a lost or
      stale exchange checkpoints and halts with the stale ranks as
      ``lost_processes`` (what ``ElasticRunner`` shrinks the mesh by);
    * stragglers: with a ``straggler_monitor`` each step's time is
      recorded and a report runs every ``straggler_every`` steps
      (persistent stragglers fire ``health/straggler``);
    * anomalies: a ``health/plateau`` from the loss monitor reduces the lr
      (``plateau_lr``: ``Plateau.force_reduction`` for a ``Plateau``
      schedule, else a ``plateau_factor`` multiplier down to
      ``min_lr_scale``), ``early_stop_plateaus`` ends the run cleanly after
      that many plateaus, and ``max_spikes`` loss spikes checkpoint and
      halt.
    """

    def __init__(self, halt_on_stall: bool = False,
                 probe_timeout_s: float = 30.0,
                 exit_process: bool = False,
                 halt_artifact_timeout_s: float = 120.0,
                 heartbeat=None, heartbeat_every: int = 0,
                 heartbeat_timeout_s: float = 60.0,
                 plateau_lr: bool = False, plateau_factor: float = 0.1,
                 min_lr_scale: float = 1e-4,
                 early_stop_plateaus: Optional[int] = None,
                 max_spikes: Optional[int] = None,
                 straggler_monitor=None, straggler_every: int = 0):
        if heartbeat is not None and heartbeat_every < 1:
            raise ValueError("heartbeat needs heartbeat_every >= 1 "
                             f"(got {heartbeat_every})")
        if straggler_monitor is not None and straggler_every < 1:
            raise ValueError("straggler_monitor needs straggler_every >= 1 "
                             f"(got {straggler_every})")
        self.halt_on_stall = halt_on_stall
        self.probe_timeout_s = float(probe_timeout_s)
        self.exit_process = exit_process
        self.halt_artifact_timeout_s = float(halt_artifact_timeout_s)
        self.heartbeat = heartbeat
        self.heartbeat_every = int(heartbeat_every)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.plateau_lr = plateau_lr
        self.plateau_factor = float(plateau_factor)
        self.min_lr_scale = float(min_lr_scale)
        self.early_stop_plateaus = early_stop_plateaus
        self.max_spikes = max_spikes
        self.straggler_monitor = straggler_monitor
        self.straggler_every = int(straggler_every)
        # per-run bookkeeping (reset by optimize())
        self.plateaus = 0
        self.spikes = 0
        self._last_beat_neval = 0
        self._last_straggler_neval = 0

    def reset_run_state(self):
        self.plateaus = 0
        self.spikes = 0
        self._last_beat_neval = 0
        self._last_straggler_neval = 0


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
        # the step and a superstep group through the cost notes (JAX's
        # InstrumentedJit sites): the batch arguments are the key
        self._step_fn = obs.perf.instrument_jit(
            lambda *a: self._step(*a), name="optim/step", kind="train_step",
            key_argnums=(3, 4))
        self._group_fn = obs.perf.instrument_jit(
            self._run_group, name="optim/step", kind="train_step",
            key_argnums=(3, 4), steps_per_program=lambda args: len(args[5]))
        self._pending_loss = None
        self._loss_window = deque()
        self._resolved_step = None  # the step of the last resolved loss
        self._resume_opt_state = None
        self.metrics = Metrics()
        self.train_summary = None
        self.val_summary = None
        # the health layer (active while observability is on): the stall
        # deadline and its callback, the loss monitor's configuration
        # (None disables it; a dict overrides SeriesMonitor's defaults)
        self.stall_deadline_s = None        # None: BIGDL_TPU_STALL_S
        self.stall_startup_grace_s = None   # None: max(deadline, default)
        self._stall_grace_pending = False
        self.on_stall = None
        self.anomaly_config: Optional[dict] = {}
        self._step_beacon = _health.NULL_BEACON
        self._loss_monitor = None
        self._profiler = None
        self._snap_writer = _cluster.MetricSnapshotWriter(every_s=0)
        # the remediation tiers and the halt channel the side thread
        # writes into
        self.remediation: Optional[RemediationPolicy] = None
        self.fault_policy: Optional[FaultPolicy] = None
        self._halt_requested: Optional[TrainingHalted] = None
        self._live_state = None     # (params, opt_state, mstate, event)
        # held by the loop except while it waits for data: the stall
        # remediation copies the live tensors under it, between two steps
        self._live_lock = threading.Lock()
        self._running = False
        self._fault_snap = None     # (live leaves, device copies)
        self._remediation_lr_scale = 1.0
        self._remediating = False

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

    def set_summary_trigger(self, name, trigger):
        """Record the summary tag ``name`` only when ``trigger`` fires.
        Train tags: "Loss", "LearningRate", "Throughput". "Validation"
        gates every validation scalar, a method's repr gates its own."""
        val_tags = {repr(m) for m in (self.validation_methods or ())}
        if name.startswith("Validation") or name in val_tags:
            if self.val_summary is None:
                raise ValueError(
                    "set_summary_trigger(%r): validation tag but no "
                    "validation summary is set - call set_val_summary "
                    "first (the train loop only consults Loss/"
                    "LearningRate/Throughput)" % (name,))
            target = self.val_summary
        elif self.train_summary is not None:
            target = self.train_summary
        else:
            raise ValueError("set a train/val summary before "
                             "set_summary_trigger")
        target.set_summary_trigger(name, trigger)
        return self

    def prepare_input(self):
        """Touch one element of the training data before ``optimize`` so an
        IO error shows early (data sets with an open epoch are
        skipped)."""
        if getattr(self.training_set, "_epoch_open", None) is not None:
            return self
        it = iter(self.training_set.data(train=False))
        try:
            next(it, None)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
        return self

    def set_train_summary(self, summary):
        self.train_summary = summary
        return self

    def set_val_summary(self, summary):
        self.val_summary = summary
        return self

    def set_stall_deadline(self, seconds: float, on_stall=None,
                           startup_grace_s=None):
        """Arm the stall watchdog (observability on): the step loop and
        its stager pulse beacons, and ``seconds`` of silence fires a
        ``health/stall`` event (and ``on_stall(beacon, age_s)``). Until
        the first dispatch completes the deadline is ``startup_grace_s``
        (default ``max(seconds, BIGDL_TPU_STALL_S)``): the first step
        builds the kernels, a legitimate silence."""
        seconds = float(seconds)
        if seconds <= 0:
            raise ValueError(f"stall deadline must be > 0, got {seconds}")
        if startup_grace_s is not None and float(startup_grace_s) < seconds:
            raise ValueError(
                f"startup_grace_s ({startup_grace_s}) must be >= the "
                f"steady-state deadline ({seconds})")
        self.stall_deadline_s = seconds
        self.stall_startup_grace_s = None if startup_grace_s is None \
            else float(startup_grace_s)
        self.on_stall = on_stall
        return self

    def set_remediation(self, policy: Optional[RemediationPolicy]):
        """Arm :class:`RemediationPolicy`; ``None`` disarms."""
        if policy is not None and not isinstance(policy, RemediationPolicy):
            raise TypeError(f"expected RemediationPolicy, got {policy!r}")
        self.remediation = policy
        return self

    def set_fault_policy(self, policy: Optional[FaultPolicy]):
        """Arm dispatch replay: before every dispatch the step's trees are
        copied into device buffers kept for the run, and the dropout
        generator's state is saved (the step writes the tensors in place,
        so a fault can leave them half updated); a TRANSIENT failure backs off, copies the snapshot back
        into the live tensors and replays the step, or the whole superstep
        group, with the same batches and lr: bit for bit the fault-free
        run. The armed dispatch synchronises the device, so an
        asynchronous CUDA fault surfaces inside the guard. Permanent
        failures raise. The snapshot costs one device copy of the
        parameters, the optimizer state and the model state per dispatch,
        and as much device memory again. ``None`` disarms.
        One process only: a replay under ``torch.distributed`` with more
        than one rank would desynchronise the collectives (a warning)."""
        if policy is not None and not isinstance(policy, FaultPolicy):
            raise TypeError(f"expected FaultPolicy, got {policy!r}")
        dist = torch.distributed
        if policy is not None and dist.is_available() and \
                dist.is_initialized() and dist.get_world_size() > 1:
            _LOG.warning(
                "FaultPolicy replay is single-controller: in this "
                "%d-process run a one-sided transient replay would "
                "desynchronize the mesh's collectives - rely on "
                "Tier 1 heartbeat remediation + elastic restart for "
                "cross-process faults", dist.get_world_size())
        self.fault_policy = policy
        return self

    def set_anomaly_detection(self, enabled: bool = True, **config):
        """The loss anomaly detector (``observability.health.
        SeriesMonitor``: spikes, plateaus, NaN streaks; ``config``
        overrides its defaults). It reads the losses the sync policy
        resolved, no extra readback. ``enabled=False`` turns it off."""
        self.anomaly_config = dict(config) if enabled else None
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
        return self._apply_update(params, mstate, opt_state, leaves, grads,
                                  loss.detach(), new_mstate, lr)

    def _run_group(self, params, mstate, opt_state, xs, ys, lrs, generator):
        """A superstep group: ``len(lrs)`` steps over the slices of the
        ``xs`` / ``ys`` stacks; returns the stacked losses."""
        return torch.stack([
            self._step(params, mstate, opt_state, _index(xs, i),
                       _index(ys, i), lr, generator)
            for i, lr in enumerate(lrs)])

    def _note_mfu(self, fn, t0, t1, t2, dsp):
        """The live MFU gauges of a step or group that was not the counted
        call (its wall includes the counter, as JAX skips a compile)."""
        if not fn.last_call_compiled:
            obs.perf.note_step(fn.last_artifact, wall_s=t2 - t0,
                               host_s=t1 - t0, dispatch_s=dsp.duration_s)

    def _apply_update(self, params, mstate, opt_state, leaves, grads, loss,
                      new_mstate, lr):
        """The step after the gradients: clipping, frozen leaves zeroed,
        the update and the new model state, all written through the NaN
        guard of ``loss``; returns ``loss``."""
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
                "opt_state": self._opt_state_for_checkpoint(opt_state),
                "model_state": host_copy_tree(mstate)}

    def _opt_state_for_checkpoint(self, opt_state):
        """Host optimizer state in CANONICAL form (the state of a local
        run; the ZeRO-1 override gathers and unflattens its slices)."""
        return host_copy_tree(opt_state)

    def _writes_files(self) -> bool:
        """Whether this process writes the run's files: checkpoints
        (every rank builds the payload, one writes it) and summaries."""
        return True

    def _prepare_opt_state(self, params):
        """The optimizer state at the start of ``optimize``: a fresh
        init, or the state a loaded checkpoint holds."""
        opt_state = self.optim_method.init_state(params)
        if self._resume_opt_state is not None:
            copy_tree_into(opt_state, self._resume_opt_state)
        return opt_state

    def _new_generator(self):
        return engine.new_generator(self.device)

    def _evaluator(self):
        from .evaluator import Evaluator
        return Evaluator(self.model)

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
        async_write = self.checkpoint_async and not force_sync
        with obs.span("step/checkpoint_submit", async_write=async_write):
            if not self._writes_files():
                pass
            elif async_write:
                self._ckpt_writer.submit(path, payload)
            else:
                _atomic_pickle(path, payload)
        if obs.enabled():
            _flight.record("checkpoint", path=path, neval=state["neval"],
                           epoch=state["epoch"], async_write=async_write)
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
        was_training = bool(self.model.training)
        self.model.evaluate()
        with obs.span("step/validate", neval=state["neval"]):
            results = self._evaluator().evaluate(
                self.validation_set, self.validation_methods,
                self.validation_batch)
        if was_training:
            self.model.training()
        scores = {}
        for method, res in zip(self.validation_methods, results):
            val = res.result()[0]
            scores[repr(method)] = val
            if self.val_summary is not None and self._writes_files():
                # "Validation" gates every scalar, the method's tag its own
                rec = self.val_summary.should_record
                if rec("Validation", state) and rec(repr(method), state):
                    self.val_summary.add_scalar(repr(method), val,
                                                state["neval"])
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
        now hold the trained values. With observability on the run is
        health-instrumented (beacons, the loss monitor, flight records,
        memory gauges) and a failure other than ``TrainingHalted`` dumps a
        flight-recorder crash bundle before it propagates."""
        self._halt_requested = None
        self._live_state = None
        self._fault_snap = None
        self._remediation_lr_scale = 1.0
        self._remediating = False
        if self.remediation is not None:
            self.remediation.reset_run_state()
        # with a remediation policy the stall callback is its handler
        # (which calls the user's on_stall first)
        on_stall = self._stall_handler if self.remediation is not None \
            else self.on_stall
        deadline = self.stall_deadline_s \
            if self.stall_deadline_s is not None \
            else _health.default_stall_deadline()
        grace = self.stall_startup_grace_s \
            if self.stall_startup_grace_s is not None \
            else max(deadline, _health.default_stall_deadline())
        self._step_beacon = _health.beacon(
            "optim/step", deadline_s=max(grace, deadline),
            on_stall=on_stall)
        self._stall_grace_pending = (
            grace > deadline
            and self._step_beacon is not _health.NULL_BEACON)
        self._profiler = _health.profiler_window_from_env()
        self._loss_monitor = None
        if self.anomaly_config is not None and \
                (obs.enabled() or self.remediation is not None):
            # remediation acts on the monitor's events even with
            # observability off
            self._loss_monitor = _health.SeriesMonitor(
                "loss", **self.anomaly_config)
        if obs.enabled():
            _health.ensure_memory_telemetry()
            self._snap_writer = _cluster.default_writer()
            st = self.optim_method.state
            _flight.record("train/start", epoch=st.get("epoch"),
                           neval=st.get("neval"), seed=engine.get_seed(),
                           batch_size=self.batch_size,
                           superstep=self.superstep,
                           sync_policy=self.sync_policy)
        self._live_lock.acquire()   # released while waiting for data
        self._running = True
        try:
            return self._optimize_impl()
        except TrainingHalted:
            raise   # the halt already landed its checkpoint and bundle
        except BaseException as e:
            if obs.enabled():
                st = self.optim_method.state
                _flight.dump_crash_bundle(error=e, context={
                    "component": "optimizer",
                    "epoch": st.get("epoch"), "neval": st.get("neval"),
                    "seed": engine.get_seed(),
                    "batch_size": self.batch_size,
                    "superstep": self.superstep,
                    "sync_policy": self.sync_policy,
                    "nan_policy": self.nan_policy})
            raise
        finally:
            self._running = False
            self._live_lock.release()
            if self._snap_writer.enabled and obs.enabled():
                # the final snapshot: a finished process is not a straggler
                self._snap_writer.write(
                    step=self.optim_method.state.get("neval"), final=True)
            self._step_beacon.close()
            self._step_beacon = _health.NULL_BEACON
            self._live_state = None
            self._fault_snap = None
            if self._profiler is not None:
                self._profiler.close()
                self._profiler = None
            try:
                # idempotent after the clean path's unbounded close: a
                # crash must not leak the writer thread or wait forever
                self._close_checkpoints(timeout=30.0)
            except Exception:
                _LOG.exception("async checkpoint writer close failed")

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
        self._reg_tree = regularizer_tree(model)
        self._frozen = _frozen_names(model)
        opt_state = self._prepare_opt_state(params)
        # never read a dead run's in-flight losses
        self._pending_loss = None
        self._loss_window.clear()
        generator = self._new_generator()
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
                                 stall_deadline_s=self.stall_deadline_s,
                                 device=self.device)
                run = self._run_epoch_supersteps
            else:
                batches = staged(batched.data(train=True),
                                 self._stage_minibatch,
                                 depth=self.prefetch_depth, name="stager",
                                 stall_deadline_s=self.stall_deadline_s,
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
                if obs.enabled():
                    _flight.record("epoch", epoch=state["epoch"] - 1,
                                   neval=state["neval"],
                                   epoch_time_s=time.time() - epoch_start)
                self._fire_epoch(state, params, opt_state, mstate)
                done = self.end_trigger(state)
        self._drain_pending_losses(state)
        self._close_checkpoints()   # land async writes, stop the writer
        return model

    # -- the self-healing tiers -------------------------------------------
    def _dispatch_guarded(self, run, params, opt_state, mstate, generator):
        """``run()`` (one step, or a superstep group's steps), wrapped by
        the fault policy when one is armed: the step's trees are copied
        into device buffers and the generator's state is saved first; on a
        retryable failure the loop backs off, copies the buffers back into
        the live tensors (the failed attempt may have written some of
        them), rewinds the generator and runs the same steps again. Other
        failures propagate."""
        fp = self.fault_policy
        if fp is None:
            return run()
        live, snap = self._snapshot_step_state(params, opt_state, mstate)
        gen_state = generator.get_state()
        if obs.enabled():
            obs.counter("optim/fault_snapshots").inc()
        while True:
            try:
                out = run()
                # CUDA reports a fault at a later sync; make it surface
                # here, where the retry can catch it
                if out.device.type == "cuda":
                    torch.cuda.synchronize(out.device)
                fp.record_success()
                return out
            except FloatingPointError:
                raise   # numeric failures belong to the NaN policy
            except Exception as e:
                cls = classify_failure(e)
                if not fp.should_retry(cls):
                    if obs.enabled():
                        _health.emit("fault_exhausted", failure_class=cls,
                                     error=f"{type(e).__name__}: {e}",
                                     consecutive=fp.consecutive)
                    raise
                fp.record_failure()
                delay = fp.backoff_s()
                self.metrics.add("fault_retries", 1.0)
                if obs.enabled():
                    _health.emit("fault_retry", failure_class=cls,
                                 error=f"{type(e).__name__}: {e}",
                                 attempt=fp.consecutive,
                                 backoff_s=round(delay, 3))
                if delay > 0:
                    fp.sleep(delay)
                with torch.no_grad():
                    torch._foreach_copy_(live, snap)
                generator.set_state(gen_state)

    def _snapshot_step_state(self, params, opt_state, mstate):
        """The fault policy's snapshot: ``(live leaves, copies)``, the
        step's tensors copied into device buffers allocated once for the
        run (anew only if a leaf was rebound). The copy is queued on the
        stream the step runs on, so it reads the state before the step."""
        live = [t for tree in (params, opt_state, mstate)
                for t in flatten(tree).values()]
        snap = self._fault_snap
        if snap is None or len(snap[0]) != len(live) or \
                any(a is not b for a, b in zip(snap[0], live)):
            snap = self._fault_snap = (
                live, [torch.empty_like(t) for t in live])
        with torch.no_grad():
            torch._foreach_copy_(snap[1], live)
        return snap

    def _mark_live(self, params, opt_state, mstate):
        """Name the trees of the last completed dispatch for the stall
        remediation's side thread, with a CUDA event after that dispatch
        (the side thread waits on it before it copies)."""
        if self.remediation is None:
            return
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        self._live_state = (params, opt_state, mstate, event)

    def _tighten_stall_deadline(self):
        """Drop the beacon's startup grace to the steady-state deadline
        once the first dispatch completed (one bool check after that)."""
        if not self._stall_grace_pending:
            return
        self._stall_grace_pending = False
        # pulse first: the age still spans the kernel build
        self._step_beacon.pulse()
        self._step_beacon.deadline_s = self.stall_deadline_s
        _health.watchdog().poke()

    def _check_halt(self):
        """Raise a halt the side thread queued while the loop was
        blocked."""
        if self._halt_requested is not None:
            ex, self._halt_requested = self._halt_requested, None
            raise ex

    def _next_batch(self, batches):
        """``next(batches)`` with the live lock let go while the loop
        waits: a stall remediation copies the live tensors then. Taking
        the lock back waits for a copy in progress, and the halt it queued
        is raised before the next step writes the tensors, so the
        checkpoint holds one step's state."""
        self._live_lock.release()
        try:
            return next(batches)
        finally:
            self._live_lock.acquire()
            self._check_halt()

    def _try_halt_checkpoint(self, state, live):
        """Drain queued async writes, then write the remediation
        checkpoint of ``live`` ``(params, opt_state, mstate, event)``
        synchronously. A failure is logged and gives None: it must not
        mask the halt."""
        try:
            self.wait_for_checkpoints()
        except Exception:
            _LOG.exception("async checkpoint drain failed during remediation")
        if live is None:
            return None
        try:
            p, o, m, event = live
            if event is not None:
                event.synchronize()     # the last completed dispatch
            return self._checkpoint(
                p, o, m, state, force_sync=True,
                tag=f"_remediation_e{state.get('epoch', 0)}"
                    f"_i{state.get('neval', 0)}")
        except Exception:
            _LOG.exception("remediation checkpoint failed (halting anyway)")
            return None

    def _land_halt_checkpoint(self, state, live, timeout_s=None):
        """The halt's checkpoint, bounded by ``timeout_s`` on a daemon
        thread when given (a wedged device copy must not wedge the
        remediation); on expiry the halt goes on without one."""
        if not self.checkpoint_path:
            return None
        if timeout_s is None:
            return self._try_halt_checkpoint(state, live)
        res = _run_with_timeout(
            lambda: self._try_halt_checkpoint(state, live), timeout_s)
        if res.get("timeout"):
            _LOG.error("remediation checkpoint did not land within %.1fs; "
                       "halting without one", timeout_s)
            return None
        return res.get("value")

    def _land_halt_artifacts(self, cause, state, live, error=None,
                             failure_class=PERMANENT, lost_processes=(),
                             ckpt_timeout_s=None, **extra):
        """The one landing of a halt, for the loop and the side thread:
        the checkpoint (async writes drained first, so a queued older
        write cannot land after it), the flight bundle, a
        ``health/remediation`` event; returns the ``TrainingHalted`` for
        the caller to raise or queue."""
        ckpt = self._land_halt_checkpoint(state, live,
                                          timeout_s=ckpt_timeout_s)
        bundle = _flight.dump_crash_bundle(error=error, context={
            "component": "optimizer/remediation", "cause": cause,
            "failure_class": failure_class,
            "epoch": state.get("epoch"), "neval": state.get("neval"),
            "checkpoint": ckpt,
            "lost_processes": list(lost_processes), **extra})
        _health.emit("remediation", cause=cause,
                     failure_class=failure_class, checkpoint=ckpt,
                     bundle=bundle, neval=state.get("neval"),
                     lost_processes=list(lost_processes), **extra)
        return TrainingHalted(
            cause=cause, failure_class=failure_class, checkpoint_path=ckpt,
            bundle_path=bundle, epoch=state.get("epoch"),
            neval=state.get("neval"), lost_processes=lost_processes)

    def _halt(self, cause, state, params, opt_state, mstate, error=None,
              failure_class=PERMANENT, lost_processes=()):
        """Checkpoint and halt from the loop itself (bounded as the side
        thread's is)."""
        pol = self.remediation
        raise self._land_halt_artifacts(
            cause, state, (params, opt_state, mstate, None), error=error,
            failure_class=failure_class, lost_processes=lost_processes,
            ckpt_timeout_s=pol.halt_artifact_timeout_s
            if pol is not None else None) from error

    def _stall_handler(self, beacon, age_s):
        """The watchdog's stall callback under a remediation policy: the
        user's ``on_stall`` inline, then the remediation on a side thread
        (the one watchdog thread keeps watching the other beacons). One
        episode, one remediation."""
        if self.on_stall is not None:
            try:
                self.on_stall(beacon, age_s)
            except Exception:
                _LOG.exception("on_stall failed")
        pol = self.remediation
        if pol is None or self._halt_requested is not None \
                or self._remediating:
            return
        self._remediating = True
        threading.Thread(target=self._remediate_stall,
                         args=(beacon, age_s),
                         name="bigdl-stall-remediation",
                         daemon=True).start()

    def _remediate_stall(self, beacon, age_s):
        """Side thread: with ``halt_on_stall`` land the halt artifacts
        from the last completed dispatch's trees and queue the halt for
        the loop (``exit_process`` exits); otherwise the stall is
        transient and the beacon re-arms. The artifacts land under the
        live lock, which the loop lets go only while it waits for data, so
        no step writes the tensors while they are copied; a loop that does
        not let go within ``halt_artifact_timeout_s`` (wedged elsewhere)
        halts without a checkpoint. A distributed run probes its mesh
        first: a failed probe makes the stall PERMANENT and halts."""
        locked = False
        try:
            pol = self.remediation
            cls, err = TRANSIENT, None
            mesh = getattr(self, "mesh", None)
            if mesh is not None and pol.probe_timeout_s > 0:
                res = probe_mesh(mesh, timeout_s=pol.probe_timeout_s)
                if not res.ok:
                    cls = PERMANENT
                    err = RuntimeError(
                        f"mesh probe failed after {age_s:.1f}s stall of "
                        f"{beacon.name}: {res.error}")
            if cls != PERMANENT and not pol.halt_on_stall:
                beacon.rearm()
                return
            locked = self._live_lock.acquire(
                timeout=pol.halt_artifact_timeout_s)
            if not self._running:
                return      # the run ended meanwhile
            # one snapshot of the counters: tag, payload and exception
            # agree
            state = dict(self.optim_method.state)
            self._halt_requested = self._land_halt_artifacts(
                "stall", state, self._live_state if locked else None,
                error=err, failure_class=cls,
                stalled_component=beacon.name, age_s=round(age_s, 3),
                ckpt_timeout_s=pol.halt_artifact_timeout_s)
            if pol.exit_process:
                os._exit(86)
        except Exception:
            _LOG.exception("stall remediation failed")
        finally:
            if locked:
                self._live_lock.release()
            self._remediating = False

    def _apply_anomaly_events(self, pol, state, events):
        """Act on the loss monitor's events of this iteration; True when
        the run should end cleanly (a plateau early stop)."""
        for ev in events:
            kind = ev.get("kind", "")
            if kind == "health/plateau":
                pol.plateaus += 1
                if pol.plateau_lr:
                    self._reduce_lr_for_plateau(pol, state)
                if pol.early_stop_plateaus is not None and \
                        pol.plateaus >= pol.early_stop_plateaus:
                    _health.emit("early_stop", reason="plateau",
                                 neval=state["neval"],
                                 plateaus=pol.plateaus)
                    return True
            elif kind.endswith("_spike"):
                pol.spikes += 1
                if pol.max_spikes is not None and \
                        pol.spikes >= pol.max_spikes:
                    raise FloatingPointError(
                        f"{pol.spikes} loss spikes "
                        f"(RemediationPolicy.max_spikes="
                        f"{pol.max_spikes}) - the run is diverging")
        return False

    def _reduce_lr_for_plateau(self, pol, state):
        sched = getattr(self.optim_method, "learningrate_schedule", None)
        if isinstance(sched, Plateau):
            mult = sched.force_reduction()
        else:
            self._remediation_lr_scale = max(
                self._remediation_lr_scale * pol.plateau_factor,
                pol.min_lr_scale)
            mult = self._remediation_lr_scale
        _health.emit("lr_reduced", reason="plateau", neval=state["neval"],
                     multiplier=mult,
                     schedule=type(sched).__name__ if sched else None)
        if obs.enabled():
            obs.counter("optim/lr_reductions").inc()
            obs.instant("optim/lr_reduced", neval=state["neval"],
                        multiplier=mult)

    def _remediation_tick(self, state, params, opt_state, mstate, events,
                          step_time_s=None):
        """One pass of the policy after a step (a group under supersteps):
        True ends the run cleanly; spike overload and heartbeat loss
        halt; the straggler monitor records ``step_time_s`` and reports
        on its cadence."""
        pol = self.remediation
        if pol is None:
            return False
        try:
            if events and self._apply_anomaly_events(pol, state, events):
                return True
        except FloatingPointError as e:
            self._halt("loss_spikes", state, params, opt_state, mstate,
                       error=e, failure_class=PERMANENT)
        hb = pol.heartbeat
        if hb is not None and \
                state["neval"] - pol._last_beat_neval >= pol.heartbeat_every:
            pol._last_beat_neval = state["neval"]
            try:
                stale = hb.beat(timeout_s=pol.heartbeat_timeout_s)
            except HeartbeatLost as e:
                self._halt("heartbeat_lost", state, params, opt_state,
                           mstate, error=e, failure_class=PERMANENT)
            if stale:
                self._halt("heartbeat_stale", state, params, opt_state,
                           mstate, failure_class=PERMANENT,
                           error=HeartbeatLost(
                               f"peers {stale} stopped advancing their "
                               f"heartbeat counters"),
                           lost_processes=stale)
        sm = pol.straggler_monitor
        if sm is not None:
            if step_time_s is not None:
                sm.record(step_time_s)
            # distance, not ``%``: a superstep advances neval by K
            if state["neval"] - pol._last_straggler_neval >= \
                    pol.straggler_every:
                pol._last_straggler_neval = state["neval"]
                sm.report()
        return False

    def _record_summaries(self, state, loss_val, lr, throughput):
        rec = self.train_summary.should_record
        if loss_val is not None and rec("Loss", state):
            self.train_summary.add_scalar("Loss", loss_val, state["neval"])
        if rec("LearningRate", state):
            self.train_summary.add_scalar("LearningRate", lr,
                                          state["neval"])
        if rec("Throughput", state):
            self.train_summary.add_scalar("Throughput", throughput,
                                          state["neval"])

    def _run_epoch_steps(self, batches, state, params, mstate, opt_state,
                         generator, nan_streak):
        """One epoch of the per-step loop: returns (False, streak) when the
        batches run out, (True, streak) when the end trigger fires (or the
        remediation stops the run)."""
        optim = self.optim_method
        while True:
            self._step_beacon.pulse()
            self._check_halt()
            with obs.span("step", neval=state["neval"]):
                t0 = time.time()
                with obs.span("step/data_fetch"):
                    try:
                        x, y = self._next_batch(batches)
                    except StopIteration:
                        return False, nan_streak
                t1 = time.time()
                # * 1.0 is exact: the scale moves only after a plateau
                lr = optim.current_lr() * self._remediation_lr_scale
                dsp = obs.span("step/dispatch")
                with dsp:
                    loss = self._dispatch_guarded(
                        lambda: self._step_fn(params, mstate, opt_state, x,
                                              y, lr, generator),
                        params, opt_state, mstate, generator)
                self._mark_live(params, opt_state, mstate)
                self._tighten_stall_deadline()
                if obs.enabled():
                    obs.counter("engine/dispatches").inc()
                with obs.span("step/loss_sync"):
                    # the step just queued is iteration neval+1; 'async'
                    # and 'window:K' read an older one (_resolved_step)
                    loss_val = self._observe_loss(loss, state["neval"] + 1)
                t2 = time.time()
                if loss_val is not None and not np.isfinite(loss_val):
                    nan_streak += 1
                    if obs.enabled():
                        _flight.record("nan", neval=self._resolved_step,
                                       epoch=state["epoch"], loss=loss_val,
                                       policy=self.nan_policy)
                    if self._loss_monitor is not None:
                        self._loss_monitor.observe(loss_val,
                                                   self._resolved_step)
                    self._nan_check(loss_val, state, nan_streak)
                    if self.nan_policy == "resume":
                        self._resume(state, params, opt_state, mstate)
                        # the in-flight losses are of steps the restore undid
                        self._pending_loss = None
                        self._loss_window.clear()
                        obs.instant("step/nan_resume", neval=state["neval"])
                        continue
                    # 'skip': the guard kept the state; the iteration counts
                    self.metrics.add("nan_skips", 1.0)
                    obs.instant("step/nan_skip", neval=state["neval"])
                    state["neval"] += 1
                    continue
                if loss_val is not None:
                    nan_streak = 0
                    state["loss"] = loss_val
                state["neval"] += 1
                state["epoch_finished"] = False
                events = []
                if loss_val is not None:
                    if obs.enabled():
                        _flight.record("step", neval=self._resolved_step,
                                       epoch=state["epoch"], loss=loss_val)
                    if self._loss_monitor is not None:
                        events = self._loss_monitor.observe(
                            loss_val, self._resolved_step)
                if self._profiler is not None:
                    self._profiler.maybe_tick(state["neval"])
                self.metrics.add("data_time", t1 - t0)
                self.metrics.add("step_time", t2 - t1)
                throughput = self.batch_size / max(t2 - t0, 1e-9)
                if obs.enabled():
                    obs.counter("optim/steps").inc()
                    obs.gauge("optim/throughput",
                              unit="samples/s").set(throughput)
                    self._note_mfu(self._step_fn, t0, t1, t2, dsp)
                    self._snap_writer.maybe_write(step=state["neval"])
                if self.train_summary is not None and self._writes_files():
                    self._record_summaries(state, loss_val, lr, throughput)
                if self._remediation_tick(state, params, opt_state, mstate,
                                          events, step_time_s=t2 - t1):
                    return True, nan_streak
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
        once, then the per-step bookkeeping (NaN policy, loss, flight
        records, the loss monitor, summaries) replays on the host over
        them. A NaN in a step is skipped by the guard and the later steps
        go on from the kept state, as in JAX. A fault replays the whole
        group. Returns as ``_run_epoch_steps`` does."""
        optim = self.optim_method
        pending = None  # the clamped rest of a group (device slices)
        while True:
            self._step_beacon.pulse()
            self._check_halt()
            t0 = time.time()
            if pending is not None:
                (k, xs, ys), pending = pending, None
            else:
                with obs.span("step/data_fetch"):
                    try:
                        k, xs, ys = self._next_batch(batches)
                    except StopIteration:
                        return False, nan_streak
            j = self._clamp_superstep(state, k)
            if j < k:
                # a trigger fires inside the group: run the first j now
                pending = (k - j, _index(xs, slice(j, None)),
                           _index(ys, slice(j, None)))
                xs, ys = _index(xs, slice(0, j)), _index(ys, slice(0, j))
                k = j
            scale = self._remediation_lr_scale   # * 1.0 is exact
            lrs = [lr * scale for lr in optim.current_lr_vector(k)]
            t1 = time.time()

            def run(xs=xs, ys=ys, lrs=lrs):
                return self._group_fn(params, mstate, opt_state, xs, ys, lrs,
                                      generator)

            with obs.span("step/superstep", neval=state["neval"], k=k):
                dsp = obs.span("step/dispatch")
                with dsp:
                    losses = self._dispatch_guarded(
                        run, params, opt_state, mstate, generator)
                self._mark_live(params, opt_state, mstate)
                self._tighten_stall_deadline()
                if obs.enabled():
                    obs.counter("engine/dispatches").inc()
                with obs.span("step/loss_sync"):
                    losses = losses.cpu().tolist()     # the one [k] readback
                if obs.enabled():
                    obs.counter("optim/loss_syncs").inc()
            t2 = time.time()
            self.metrics.add("data_time", t1 - t0)
            self.metrics.add("step_time", t2 - t1)
            throughput = k * self.batch_size / max(t2 - t0, 1e-9)
            if obs.enabled():
                obs.counter("optim/steps").inc(k)
                obs.gauge("optim/throughput",
                          unit="samples/s").set(throughput)
                self._note_mfu(self._group_fn, t0, t1, t2, dsp)
                self._snap_writer.maybe_write(step=state["neval"])
            restored = False
            events = []
            for i, loss_val in enumerate(losses):
                if not np.isfinite(loss_val):
                    nan_streak += 1
                    if obs.enabled():
                        _flight.record("nan", neval=state["neval"],
                                       epoch=state["epoch"], loss=loss_val,
                                       policy=self.nan_policy,
                                       superstep_k=k, microstep=i)
                    if self._loss_monitor is not None:
                        self._loss_monitor.observe(loss_val, state["neval"])
                    self._nan_check(loss_val, state, nan_streak)
                    if self.nan_policy == "resume":
                        # the group's later losses are of undone updates
                        self._resume(state, params, opt_state, mstate)
                        obs.instant("step/nan_resume", neval=state["neval"])
                        restored = True
                        break
                    self.metrics.add("nan_skips", 1.0)
                    obs.instant("step/nan_skip", neval=state["neval"])
                    state["neval"] += 1
                    continue
                nan_streak = 0
                state["loss"] = loss_val
                state["neval"] += 1
                state["epoch_finished"] = False
                if obs.enabled():
                    _flight.record("step", neval=state["neval"],
                                   epoch=state["epoch"], loss=loss_val,
                                   superstep_k=k, microstep=i)
                if self._loss_monitor is not None:
                    events.extend(self._loss_monitor.observe(
                        loss_val, state["neval"]))
                if self.train_summary is not None and self._writes_files():
                    self._record_summaries(state, loss_val, lrs[i],
                                           throughput)
            if restored:
                # the group's events before the NaN are of real losses
                if self._remediation_tick(state, params, opt_state, mstate,
                                          events, step_time_s=t2 - t1):
                    return True, nan_streak
                continue
            if self._profiler is not None:
                self._profiler.maybe_tick(state["neval"])
            if self._remediation_tick(state, params, opt_state, mstate,
                                      events, step_time_s=t2 - t1):
                return True, nan_streak
            # the triggers are asked once, at the group's boundary, where
            # the parameters and the counters agree
            self._fire_mid_epoch(state, params, opt_state, mstate)
            if self.end_trigger(state):
                return True, nan_streak


class LocalOptimizer(BaseOptimizer):
    """Training on one device."""


def _local_seed_generator(device, rank):
    """The dropout generator of a rank in a LOCAL-semantics step (ZeRO-1,
    the sparse wire): the run's seed folded with the rank, as JAX folds
    ``axis_index`` into its key."""
    seed = engine.get_seed()
    seed = engine._DEFAULT_SEED if seed is None else seed
    return torch.Generator(device=device).manual_seed(
        (seed * 1000003 + rank) % (2 ** 63))


class DistriOptimizer(BaseOptimizer):
    """Data-parallel training over a mesh's ``data`` axis (parity:
    optim/DistriOptimizer.scala), one process per rank.

    Every rank reads the same global batches (the data set's seeded
    shuffle) and trains on its rows (``parallel.sharding.shard_batch``).
    The two parameter modes compute what JAX's compute:

    * ``parameter_mode="replicated"`` (JAX: the whole step under ``jit``
      over a sharded batch) is GLOBAL: the forward runs in
      ``parallel.collective.global_batch``, so BatchNorm takes the global
      batch's statistics (one all-reduce of its sums) and a criterion
      that divides by a count of the data divides by the global count;
      the loss and the gradients are then averaged over the ranks (one
      all-reduce), and every rank applies the same update to its copy.
      Every rank holds the run's one dropout generator and draws the
      global batch's mask, keeping its own rows of it
      (``parallel.collective.batch_rows``). The result equals a local
      run over the global batch, dropout included, up to the summation
      order.
    * ``parameter_mode="zero1"`` (JAX: a ``shard_map`` body) is LOCAL:
      forward, BatchNorm statistics and loss per rank; the gradient is the
      mean over the ranks through ``parallel.allreduce.AllReduceParameter``
      (reduce-scatter, this rank's slice of the update, all-gather), with
      ``compress`` / ``wire_dtype`` picking the wire; the model state is
      averaged over the ranks; dropout draws from the rank's own stream.
      The optimizer state lives only sharded, and checkpoints hold it in
      the canonical params-shaped form, so a snapshot restores under any
      number of ranks (and from or into JAX).

    ``sparse_embedding`` picks the Parallax wire for a leading
    ``LookupTable``'s gradient in replicated mode (``"auto"`` when it
    applies safely, ``True`` as a contract, ``False`` off); that step is
    local, as JAX's explicit ``shard_map`` is. The NaN guard reads the
    loss after the mean, so every rank takes the same branch; no rank
    skips a collective. Setup all-gathers the ranks' batch counts and
    refuses splits that disagree (they would deadlock). Checkpoints are
    written by the mesh's first rank. ``device``: the mesh's device by
    default."""

    def __init__(self, model, training_set, criterion, optim_method=None,
                 end_trigger=None, batch_size: int = 32, mesh=None,
                 parameter_mode: str = "replicated",
                 compress: str = "none", wire_dtype: str = "none",
                 sparse_embedding="auto", device=None):
        from ..parallel.mesh import get_default_mesh, mesh_device
        if mesh is None and device is not None:
            engine.init_process_group(device=device)    # the group's device
        mesh = mesh or get_default_mesh()
        super().__init__(model, training_set, criterion, optim_method,
                         end_trigger, batch_size,
                         device=device if device is not None
                         else mesh_device(mesh))
        self.mesh = mesh
        if "data" not in tuple(self.mesh.mesh_dim_names):
            raise ValueError("DistriOptimizer mesh needs a 'data' axis")
        if parameter_mode not in ("replicated", "zero1"):
            raise ValueError(f"parameter_mode must be 'replicated' or "
                             f"'zero1', got {parameter_mode!r}")
        if sparse_embedding is True and parameter_mode != "replicated":
            raise ValueError(
                "sparse_embedding selects per-LAYER gradient wires - "
                "ZeRO-1 ships one flat vector and has no per-layer "
                "seam; use parameter_mode='replicated'")
        self.parameter_mode = parameter_mode
        self.compress = compress
        self.wire_dtype = wire_dtype
        self.sparse_embedding = sparse_embedding
        self._arp = None
        self._flat = None
        self._group = self.mesh.get_group("data")
        self._rank = self.mesh.get_local_rank("data") \
            if self._num_shards() > 1 else 0

    def _num_shards(self):
        from ..parallel.mesh import axis_size
        return axis_size(self.mesh, "data")

    def _batched(self):
        if hasattr(self.training_set, "batches_per_epoch"):
            return self.training_set
        return ShardedDataSet(self.training_set, self.batch_size,
                              num_shards=self._num_shards())

    def _writes_files(self) -> bool:
        import torch.distributed as dist
        from ..parallel.mesh import mesh_ranks
        return dist.get_rank() == int(mesh_ranks(self.mesh).flat[0])

    def _evaluator(self):
        from .evaluator import DistriValidator
        v = DistriValidator(self.model)
        v.mesh = self.mesh
        return v

    def _new_generator(self):
        if self.parameter_mode == "zero1" or self._sparse_embedding_enabled():
            return _local_seed_generator(self.device, self._rank)
        return super()._new_generator()

    # -- batches: this rank's rows of the global batch --------------------
    def _stage_minibatch(self, mb):
        from ..parallel.sharding import shard_batch
        return (shard_batch(mb.get_input(), self.mesh),
                shard_batch(mb.get_target(), self.mesh))

    def _stage_group(self, items):
        from ..parallel.sharding import shard_stacked_batch
        xs = _stack([x for x, _ in items])
        ys = _stack([y for _, y in items])
        return (len(items), shard_stacked_batch(xs, self.mesh),
                shard_stacked_batch(ys, self.mesh))

    # -- setup and checkpoints ---------------------------------------------
    def _check_split_agreement(self):
        """Every rank must take the same number of steps an epoch (a rank
        with more would wait forever in the next collective): the ranks'
        batch counts are all-gathered at setup and a disagreement
        raises on every rank."""
        import torch.distributed as dist
        n = self._num_shards()
        if n == 1:
            return
        src = self._batched()
        k = getattr(src, "batches_per_epoch", 0)
        k = int(k() if callable(k) else (k or 0))
        t = torch.tensor([k], dtype=torch.int64, device=self.device)
        out = t.new_empty((n,))
        dist.all_gather_into_tensor(out, t, group=self._group)
        counts = out.cpu().tolist()
        if len(set(counts)) > 1:
            raise ValueError(
                "per-process dataset splits disagree on batches/epoch "
                f"{counts}; pad or trim the local splits so every "
                "process takes the same number of steps (uneven splits "
                "deadlock in the cross-process gradient psum)")

    def _prepare_opt_state(self, params):
        self._check_split_agreement()
        if self.parameter_mode != "zero1":
            return super()._prepare_opt_state(params)
        from ..parallel.allreduce import AllReduceParameter
        self._arp = AllReduceParameter(
            self.optim_method, self.mesh, compress=self.compress,
            wire_dtype=self.wire_dtype)
        _, opt_state = self._arp.prepare(
            params, resume_state=self._resume_opt_state)
        self._flat = self._arp.flat
        self._flat_mask = None
        if self._frozen:
            full = {k: torch.full_like(v, 0.0 if k in self._frozen else 1.0)
                    for k, v in flatten(params).items()}
            self._flat_mask = self._flat.flatten(unflatten(full))
        return opt_state

    def _opt_state_for_checkpoint(self, opt_state):
        if self.parameter_mode == "zero1" and self._arp is not None:
            from ..parallel.sharding import gather_to_host
            return self._arp.state_to_canonical(
                gather_to_host(opt_state, self.mesh))
        return super()._opt_state_for_checkpoint(opt_state)

    def _restore_step_state(self, payload, params, opt_state, mstate):
        copy_tree_into(params, payload["params"])
        copy_tree_into(mstate, payload["model_state"])
        if self.parameter_mode == "zero1" and self._arp is not None:
            copy_tree_into(opt_state, self._arp.place_canonical_state(
                payload["opt_state"]))
        else:
            copy_tree_into(opt_state, payload["opt_state"])

    def _resume(self, state, params, opt_state, mstate):
        import torch.distributed as dist
        self.wait_for_checkpoints()
        dist.barrier(group=self._group)     # the first rank's writes landed
        super()._resume(state, params, opt_state, mstate)

    # -- the steps ----------------------------------------------------------
    def _mean_over_ranks(self, tensors):
        """The mean over the ranks of each tensor: one all-reduce of their
        float32 concatenation."""
        import torch.distributed as dist
        from ..parallel.collective import _record
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        _record("pmean", flat)
        dist.all_reduce(flat, group=self._group)
        flat = flat / self._num_shards()
        return [p.view(t.shape).to(t.dtype) for p, t in
                zip(flat.split([t.numel() for t in tensors]), tensors)]

    def _local_loss(self, params, mstate, x, y, generator):
        out, new_mstate = self.model.apply(params, mstate, x, training=True,
                                           generator=generator)
        loss = self.criterion._forward(out, y)
        if self._reg_tree:
            loss = loss + regularization_loss(self._reg_tree, params)
        return loss, new_mstate

    def _step(self, params, mstate, opt_state, x, y, lr, generator):
        from ..parallel import collective
        with collective.over(self.mesh):
            if self.parameter_mode == "zero1":
                return self._zero1_step(params, mstate, opt_state, x, y, lr,
                                        generator)
            if self._sparse_embedding_enabled():
                return self._sparse_step(params, mstate, opt_state, x, y,
                                         lr, generator)
            return self._replicated_step(params, mstate, opt_state, x, y,
                                         lr, generator)

    def _replicated_step(self, params, mstate, opt_state, x, y, lr,
                         generator):
        from ..parallel.collective import global_batch
        leaves = flatten(params)
        with global_batch(self._group, self._num_shards()):
            loss, new_mstate = self._local_loss(params, mstate, x, y,
                                                generator)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        *grads, loss = self._mean_over_ranks(list(grads) + [loss])
        # BatchNorm's new running statistics came from global statistics:
        # the same on every rank
        return self._apply_update(params, mstate, opt_state, leaves, grads,
                                  loss, new_mstate, lr)

    def _pmean_state(self, mstate, new_mstate):
        """The new model state averaged over the ranks (JAX's ``pmean`` in
        the local-semantics steps)."""
        new = flatten(new_mstate)
        names = [k for k, t in flatten(mstate).items() if new[k] is not t]
        if not names:
            return new_mstate
        avg = self._mean_over_ranks([new[k] for k in names])
        return unflatten({**new, **dict(zip(names, avg))})

    def _zero1_step(self, params, mstate, opt_state, x, y, lr, generator):
        leaves = flatten(params)
        loss, new_mstate = self._local_loss(params, mstate, x, y, generator)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        flat = self._flat
        gflat = flat.flatten(unflatten(dict(zip(leaves, grads))))
        gflat = _clip_grads({"g": gflat}, self.clip_const,
                            self.clip_norm)["g"]
        if self._flat_mask is not None:
            gflat = gflat * self._flat_mask
        flat_w = flat.flatten(params)
        new_full, new_opt = self._arp.update(gflat, flat_w, opt_state, lr)
        if self._flat_mask is not None:
            new_full = torch.where(self._flat_mask > 0, new_full, flat_w)
        loss = self._mean_over_ranks([loss.detach()])[0]
        new_mstate = self._pmean_state(mstate, new_mstate)
        new_params = flatten(flat.unflatten(new_full))
        writes = [(t, new_params[k]) for k, t in leaves.items()]
        new_o = flatten(new_opt)
        writes += [(t, new_o[k]) for k, t in flatten(opt_state).items()
                   if new_o[k] is not t]
        new_m = flatten(new_mstate)
        writes += [(t, new_m[k]) for k, t in flatten(mstate).items()
                   if new_m[k] is not t]
        # after the mean: every rank takes the same branch
        write_guarded(writes, torch.isfinite(loss))
        return loss

    # -- the Parallax sparse-embedding wire -------------------------------
    def _sparse_embedding_path(self):
        """``(param path, vocab size)`` of the embedding whose ids are the
        model input: the model itself, or a leading Sequential's first
        child, a ``LookupTable`` without a ``w_regularizer``."""
        from ..nn.linear import LookupTable
        m = self.model
        emb, path = None, None
        if isinstance(m, LookupTable):
            emb, path = m, ("weight",)
        elif isinstance(m, Container) and len(m._modules) and \
                isinstance(m[0], LookupTable):
            emb, path = m[0], ("0", "weight")
        if emb is None:
            raise ValueError(
                "sparse_embedding=True needs the model input to BE the "
                "embedding ids: a LookupTable model, or a Sequential "
                "whose first child is a LookupTable - got "
                f"{type(m).__name__}")
        if emb.w_regularizer is not None:
            raise ValueError(
                "sparse_embedding=True cannot ride a w_regularizer'd "
                "embedding: the regularizer gradient is dense over the "
                "whole vocab, which the sparse (indices, values) "
                "exchange cannot carry - drop the regularizer or the "
                "sparse wire")
        return path, emb.n_index

    def _sparse_embedding_enabled(self) -> bool:
        """``True`` / ``False`` as given; ``"auto"``: the wire exactly
        when ``_sparse_embedding_path`` accepts the model in replicated
        mode."""
        se = self.sparse_embedding
        if se == "auto":
            if self.parameter_mode != "replicated":
                return False
            try:
                self._sparse_embedding_path()
            except ValueError:
                return False
            return True
        return bool(se)

    def _sparse_step(self, params, mstate, opt_state, x, y, lr, generator):
        """The per-layer wire (local semantics, as JAX's ``shard_map``):
        the embedding's gradient ships its touched ``(ids, rows)`` when
        ``B_local * (H + 1) < vocab * H`` elements, every other leaf the
        dense mean."""
        from ..nn.sparse import embedding_grad_rows
        from ..parallel.allreduce import sparse_embedding_grad_allreduce
        path, vocab = self._sparse_embedding_path()
        emb_name = ".".join(path)
        leaves = flatten(params)
        loss, new_mstate = self._local_loss(params, mstate, x, y, generator)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        ids = torch.clamp(x.reshape(-1).to(torch.int32) - 1, 0, vocab - 1)
        g = grads[emb_name]
        sparse = ids.shape[0] * (g.shape[-1] + 1) < g.numel()
        dense = [k for k in grads if not (sparse and k == emb_name)]
        if obs.enabled():
            obs.counter("collective/grad_dense_traced_bytes", unit="B").inc(
                float(sum(grads[k].numel() * grads[k].element_size()
                          for k in dense)))
            obs.gauge("collective/sparse_layers_selected").set(int(sparse))
        avg = self._mean_over_ranks([grads[k] for k in dense] + [loss])
        loss = avg.pop()
        grads.update(zip(dense, avg))
        if sparse:
            grads[emb_name] = sparse_embedding_grad_allreduce(
                ids, embedding_grad_rows(g, ids), vocab_size=vocab,
                axis="data")
        new_mstate = self._pmean_state(mstate, new_mstate)
        return self._apply_update(params, mstate, opt_state, leaves,
                                  [grads[k] for k in leaves], loss,
                                  new_mstate, lr)


class ParallelOptimizer(DistriOptimizer):
    """Name parity: optim/ParallelOptimizer.scala (the same engine)."""


class Optimizer(BaseOptimizer):
    """Factory with the reference's signature: a :class:`DistriOptimizer`
    when the mesh (``mesh``, else the default mesh when this process is
    in a group of more than one rank) has more than one device, else a
    :class:`LocalOptimizer` on ``device``."""

    def __new__(cls, model=None, training_set=None, training_rdd=None,
                criterion=None, optim_method=None, end_trigger=None,
                batch_size: int = 32, mesh=None, device=None, **kw):
        training = training_set if training_set is not None else training_rdd
        m = mesh
        if m is None:
            import torch.distributed as dist
            if dist.is_available() and dist.is_initialized() and \
                    dist.get_world_size() > 1:
                from ..parallel.mesh import get_default_mesh
                m = get_default_mesh()
        if m is not None and m.size() > 1:
            return DistriOptimizer(model, training, criterion, optim_method,
                                   end_trigger, batch_size, mesh=m,
                                   device=device, **kw)
        return LocalOptimizer(model, training, criterion, optim_method,
                              end_trigger, batch_size, device=device)

    @staticmethod
    def create(model, training_set, criterion, end_trigger=None,
               batch_size=32, optim_method=None, cores=None,
               bigdl_type="float", device=None):
        """pyspark ``Optimizer.create`` spelling (``cores`` and
        ``bigdl_type`` are ignored; local or distributed is picked as the
        constructor picks it)."""
        return Optimizer(model=model, training_set=training_set,
                         criterion=criterion, optim_method=optim_method,
                         end_trigger=end_trigger, batch_size=batch_size,
                         device=device)
