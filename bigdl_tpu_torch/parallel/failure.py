"""Failure classes, the retry budget and the failure detectors
(counterpart of ``bigdl_tpu/parallel/failure.py``).

``classify_failure`` maps an exception onto TRANSIENT / PERMANENT;
:class:`FaultPolicy` is the retry and backoff budget the serving tier's
replays share (the decode scheduler's step replay, the engine's batch
retry). The detectors: :func:`probe_mesh` runs a sum of ones over every
axis of a mesh with a timeout (a hung or lost rank becomes a probe failure
instead of a stall inside a training collective); :class:`Heartbeat`
all-gathers a counter a rank across the process group and names the ranks
whose counter stopped; :class:`FileHeartbeat` is the same signal through
a file, for processes that share no group; :class:`StragglerMonitor`
gathers each rank's mean step time and flags ranks slower than
``threshold`` x the median. A rank is the port's process, where JAX
speaks of a host's process.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import observability as obs
from ..observability import health as _health

__all__ = ["TRANSIENT", "PERMANENT", "TransientDeviceError", "HeartbeatLost",
           "classify_failure", "FaultPolicy", "TrainingHalted",
           "MeshProbeResult", "probe_mesh", "Heartbeat", "FileHeartbeat",
           "StragglerMonitor"]

_LOG = logging.getLogger("bigdl_tpu_torch.parallel.failure")

# ------------------------------------------------------ failure classes
#: the failure taxonomy the remediation tiers branch on: TRANSIENT
#: failures are worth replaying in place (:class:`FaultPolicy`); PERMANENT
#: ones (a dead device, a poisoned CUDA context) are surfaced.
TRANSIENT = "transient"
PERMANENT = "permanent"


class TransientDeviceError(RuntimeError):
    """A device/collective failure worth retrying in place: the chip is
    believed alive, the dispatch just failed (dropped tunnel packet,
    preempted RPC, flaky barrier). Raised by fault-injection harnesses
    and recognized by :class:`FaultPolicy` (the trainer replays the
    in-flight step group) and by the serving engine's one-shot batch
    retry — one typed classification shared by both consumers."""


#: substrings that mark a runtime error as transient: the JAX package's
#: list (the gRPC/absl status words of connection-level failures), kept so
#: a message classifies the same in both packages. Errors of the CUDA
#: runtime are matched first, below, and never reach it.
_TRANSIENT_MARKERS = (
    "transient", "unavailable", "deadline_exceeded", "deadline exceeded",
    "aborted", "cancelled", "connection reset", "connection refused",
    "socket closed", "broken pipe", "temporarily", "preempt",
    "too many pings", "keepalive", "network is unreachable",
)


#: what the CUDA runtime's errors say, as torch and the kernel wrappers
#: raise them ("CUDA error: ...", "... kernel launch failed (route): CUDA
#: error n", cuBLAS / cuDNN status words, a device-side assert)
_CUDA_MARKERS = ("cuda error", "kernel launch failed", "cublas_status",
                 "cudnn_status", "cuda driver error", "device-side assert")


def _cuda_runtime_error(exc: BaseException) -> bool:
    """True for an error raised by the CUDA runtime: after one, the
    context is poisoned (CUDA errors are sticky), so a replay would fail
    the same way until the budget is spent."""
    errs = [torch.cuda.CudaError, torch.cuda.OutOfMemoryError]
    if hasattr(torch, "AcceleratorError"):
        errs.append(torch.AcceleratorError)
    if isinstance(exc, tuple(errs)):
        return True
    msg = str(exc).lower()
    return any(m in msg for m in _CUDA_MARKERS)


def classify_failure(exc: BaseException) -> str:
    """Map an exception from the dispatch path onto the failure
    taxonomy. Typed signals win: :class:`TransientDeviceError` is
    transient by construction (chaos injects it), :class:`HeartbeatLost`
    means a peer is gone, and an error of the CUDA runtime is PERMANENT
    before any marker is matched (its messages can carry a transient
    word, "busy or unavailable", yet the context is poisoned). Everything
    else matches the status vocabulary in the message; unknown errors
    classify PERMANENT (replaying a deterministic bug fails identically)."""
    if isinstance(exc, TransientDeviceError):
        return TRANSIENT
    if isinstance(exc, HeartbeatLost) or _cuda_runtime_error(exc):
        return PERMANENT
    msg = f"{type(exc).__name__}: {exc}".lower()
    if any(m in msg for m in _TRANSIENT_MARKERS):
        return TRANSIENT
    return PERMANENT


class FaultPolicy:
    """Retry and backoff budget of a dispatch path. Each unit of work (a
    decode group, an engine batch) snapshots its host state first; a
    failure classified into ``retry_classes`` (default: transient only)
    replays it after ``backoff_base_s * 2^k`` seconds, capped at
    ``backoff_max_s``. ``max_restarts`` bounds CONSECUTIVE failed
    attempts and any success resets it; failures outside
    ``retry_classes`` raise at once. ``sleep`` is injectable so drills run
    at full speed.
    """

    def __init__(self, max_restarts: int = 3, backoff_base_s: float = 0.5,
                 backoff_max_s: float = 30.0,
                 retry_classes=(TRANSIENT,), sleep=time.sleep):
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
        self.max_restarts = int(max_restarts)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.retry_classes = tuple(retry_classes)
        self.sleep = sleep
        self.consecutive = 0   # failed attempts since the last success
        self.total_retries = 0

    def classify(self, exc: BaseException) -> str:
        return classify_failure(exc)

    def should_retry(self, failure_class: str) -> bool:
        return (failure_class in self.retry_classes
                and self.consecutive < self.max_restarts)

    def backoff_s(self) -> float:
        """Backoff before the NEXT attempt, from the consecutive-failure
        count (first retry waits ``backoff_base_s``)."""
        return min(self.backoff_base_s * (2.0 ** max(self.consecutive - 1, 0)),
                   self.backoff_max_s)

    def record_failure(self) -> None:
        self.consecutive += 1
        self.total_retries += 1

    def record_success(self) -> None:
        self.consecutive = 0

    def reset(self) -> None:
        """Start a fresh unit of work. The consecutive budget is meant
        to bound retries of ONE dispatch unit; a consumer that SURVIVES
        an exhausted budget (the serving batcher fails the batch and
        moves on — unlike the trainer, whose run ends) must reset, or
        the tripped fuse would deny every later unit its retry."""
        self.consecutive = 0


class TrainingHalted(RuntimeError):
    """Training stopped itself (checkpoint written where a path is set,
    flight bundle dumped) instead of hanging or dying without artifacts;
    carries the cause, the failure class, the checkpoint and bundle paths,
    the iteration and the lost peer processes for a supervisor."""

    def __init__(self, cause: str, failure_class: str = PERMANENT,
                 checkpoint_path: Optional[str] = None,
                 bundle_path: Optional[str] = None,
                 epoch: Optional[int] = None, neval: Optional[int] = None,
                 lost_processes=()):
        self.cause = cause
        self.failure_class = failure_class
        self.checkpoint_path = checkpoint_path
        self.bundle_path = bundle_path
        self.epoch = epoch
        self.neval = neval
        self.lost_processes = list(lost_processes)
        super().__init__(
            f"training halted by remediation: cause={cause} "
            f"class={failure_class} epoch={epoch} neval={neval} "
            f"checkpoint={checkpoint_path} bundle={bundle_path}"
            + (f" lost_processes={self.lost_processes}"
               if self.lost_processes else ""))


class HeartbeatLost(RuntimeError):
    """A heartbeat exchange did not complete: a peer process is dead or
    unresponsive (the all-gather hung past the timeout, or the coordination
    service surfaced the peer's failure as an error). The training loop
    should halt cleanly — checkpoint and exit — rather than stall inside
    the next collective."""


def _run_with_timeout(fn, timeout_s: float) -> Dict:
    """Run ``fn`` on a daemon thread: ``{'value': ...}`` when it returns,
    ``{'error': str}`` when it raised, ``{'timeout': True}`` when it did
    not finish in ``timeout_s`` (the thread, which cannot be cancelled, is
    abandoned and the caller escalates)."""
    result: Dict = {}

    def run():
        try:
            result["value"] = fn()
        except Exception as e:  # noqa: BLE001 - reported, not raised
            result["error"] = f"{type(e).__name__}: {e}"

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout_s)
    if th.is_alive():
        return {"timeout": True}
    return result


def _group_device():
    """The device a collective of the default group runs on."""
    from ..utils import engine
    grp = engine.process_group()
    return grp["device"] if grp is not None else torch.device("cpu")


def _world():
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def _allgather_scalar(value, dtype):
    """Every rank's ``value`` in rank order (an all-gather over the
    default group; ``[value]`` in a world of one)."""
    import torch.distributed as dist
    if _world() == 1:
        return [value]
    t = torch.tensor([value], dtype=dtype, device=_group_device())
    out = t.new_empty((dist.get_world_size(),))
    dist.all_gather_into_tensor(out, t)
    return out.cpu().tolist()


class MeshProbeResult:
    def __init__(self, ok: bool, n_devices: int, latency_s: float,
                 error: Optional[str] = None):
        self.ok, self.n_devices = ok, n_devices
        self.latency_s, self.error = latency_s, error

    def __repr__(self):
        return (f"MeshProbeResult(ok={self.ok}, n={self.n_devices}, "
                f"latency={self.latency_s:.4f}s, error={self.error})")


def probe_mesh(mesh, timeout_s: float = 30.0) -> MeshProbeResult:
    """A sum of ones over every axis of ``mesh`` (one all-reduce an axis,
    on a watchdog thread): it must come back as the mesh's size within
    ``timeout_s``. A dead or hung rank never completes the collective;
    the timeout turns that into a failed probe instead of a stall. Every
    rank of the mesh probes at the same point."""
    import torch.distributed as dist
    from .mesh import mesh_device
    axes = tuple(mesh.mesh_dim_names)
    n = int(mesh.size())
    dev = mesh_device(mesh)

    def ones_sum():
        t0 = time.time()
        s = torch.ones((), device=dev)
        for a in axes:
            if mesh.size(axes.index(a)) > 1:
                s = s.reshape(1).contiguous()
                dist.all_reduce(s, group=mesh.get_group(a))
                s = s.reshape(())
        val = int(round(float(s)))
        return val, time.time() - t0

    t0 = time.time()
    result = _run_with_timeout(ones_sum, timeout_s)
    if result.get("timeout"):
        res = MeshProbeResult(False, n, time.time() - t0,
                              f"collective did not complete in {timeout_s}s")
    elif "error" in result:
        res = MeshProbeResult(False, n, time.time() - t0, result["error"])
    else:
        val, latency = result["value"]
        ok = val == n
        res = MeshProbeResult(ok, n, latency,
                              None if ok else
                              f"psum returned {val}, expected {n}")
    if obs.enabled():
        obs.histogram("failure/probe_latency_s", unit="s").observe(
            res.latency_s)
        obs.gauge("failure/probe_ok").set(1.0 if res.ok else 0.0)
        if not res.ok:
            _health.emit("probe_failed", n_devices=res.n_devices,
                         latency_s=round(res.latency_s, 3),
                         error=res.error)
    return res


class Heartbeat:
    """Liveness of the ranks of the process group: each :meth:`beat`
    all-gathers an incrementing counter a rank; a rank whose counter has
    not advanced for ``stale_after`` beats is reported. A world of one is
    always healthy. A DEAD rank hangs the all-gather itself, so
    ``beat(timeout_s=...)`` runs the exchange on a watchdog thread and
    raises :class:`HeartbeatLost` on a hang past the timeout or an error
    of the group (the thread cannot be cancelled; detection is followed
    by a halt). ``expected_interval_s`` logs a late beat."""

    def __init__(self, stale_after: int = 3,
                 expected_interval_s: Optional[float] = None):
        self.stale_after = stale_after
        self.expected_interval_s = expected_interval_s
        self.beat_no = 0
        self.last_seen: Dict[int, int] = {}
        self.counters: Dict[int, int] = {}
        self._last_beat_t: Optional[float] = None
        self._beacon = None

    @property
    def last_beat_age_s(self) -> float:
        """Seconds since the last completed beat; ``inf`` before the
        first (the ``failure/last_beat_age_s`` gauge)."""
        if self._last_beat_t is None:
            return float("inf")
        return time.monotonic() - self._last_beat_t

    def _register_gauge(self):
        ref = weakref.ref(self)

        def age() -> float:
            hb = ref()
            return hb.last_beat_age_s if hb is not None else float("nan")

        obs.gauge("failure/last_beat_age_s", unit="s").set_fn(age)

    def _ensure_beacon(self):
        if self._beacon is not None or not obs.enabled():
            return
        deadline = (self.expected_interval_s * self.stale_after
                    if self.expected_interval_s is not None else None)
        self._beacon = _health.beacon("failure/heartbeat",
                                      deadline_s=deadline)
        if self._beacon is not _health.NULL_BEACON:
            weakref.finalize(self, self._beacon.close)

    @property
    def n_processes(self) -> int:
        return _world()

    def _gather(self, value: int) -> List[int]:
        return [int(v) for v in _allgather_scalar(value, torch.int64)]

    def _gather_with_timeout(self, value: int, timeout_s: float) -> List[int]:
        result = _run_with_timeout(lambda: self._gather(value), timeout_s)
        if result.get("timeout"):
            raise HeartbeatLost(
                f"heartbeat exchange did not complete in {timeout_s}s - "
                f"a peer process is dead or unresponsive")
        if "error" in result:
            raise HeartbeatLost(
                f"heartbeat exchange failed ({result['error']}) - "
                f"a peer process died")
        return result["value"]

    def beat(self, timeout_s: Optional[float] = None) -> List[int]:
        """Advance the local counter, exchange, and return the stale
        ranks. An injected fault at the chaos site ``heartbeat/beat``
        surfaces as :class:`HeartbeatLost`, as a real failure does."""
        try:
            _chaos.maybe_fire("heartbeat/beat")
        except Exception as e:  # noqa: BLE001 - typed re-surface
            raise HeartbeatLost(
                f"injected heartbeat fault: {type(e).__name__}: {e}") \
                from e
        self.beat_no += 1
        now = time.monotonic()
        if (self.expected_interval_s is not None
                and self._last_beat_t is not None
                and now - self._last_beat_t > self.expected_interval_s):
            _LOG.warning(
                "late heartbeat: beat_no=%d age_s=%.3f "
                "expected_interval_s=%.3f", self.beat_no,
                now - self._last_beat_t, self.expected_interval_s)
            if obs.enabled():
                obs.counter("failure/late_beats").inc()
                _health.emit("heartbeat_late", beat_no=self.beat_no,
                             age_s=round(now - self._last_beat_t, 3),
                             expected_interval_s=self.expected_interval_s)
        if timeout_s is not None:
            counters = self._gather_with_timeout(self.beat_no, timeout_s)
        else:
            counters = self._gather(self.beat_no)
        self._last_beat_t = time.monotonic()
        if obs.enabled():
            self._register_gauge()
            self._ensure_beacon()
            if self._beacon is not None:
                self._beacon.pulse()
            obs.counter("failure/beats").inc()
        stale = []
        for pid, c in enumerate(counters):
            if c > self.counters.get(pid, -1):
                self.counters[pid] = c
                self.last_seen[pid] = self.beat_no
            elif self.beat_no - self.last_seen.get(pid, 0) >= \
                    self.stale_after:
                stale.append(pid)
        if stale:
            _LOG.warning(
                "stale heartbeat peers: processes=%s beat_no=%d "
                "stale_after=%d", stale, self.beat_no, self.stale_after)
            if obs.enabled():
                _health.emit("heartbeat_stale", peers=stale,
                             beat_no=self.beat_no,
                             stale_after=self.stale_after)
        return stale


class FileHeartbeat:
    """File-based liveness for processes that share no process group
    (the serving fleet's members): each :meth:`beat` atomically rewrites
    ONE file (temporary file + rename) with an incrementing counter, a
    wall-clock stamp and the caller's payload; anyone can :meth:`read` it
    and judge :meth:`age_s`. A member that finishes cleanly writes
    ``final: true``. The file's JSON is JAX's, key for key."""

    def __init__(self, path: str):
        self.path = path
        self.beat_no = 0

    def beat(self, payload: Optional[Dict] = None, *,
             final: bool = False) -> Dict:
        """Atomic rewrite of the member file; returns the written doc.
        Never raises: a failed write leaves the previous beat, which
        reads as a late beat."""
        self.beat_no += 1
        doc = dict(payload or {})
        doc.update(beat=self.beat_no, written_at=time.time(),
                   pid=os.getpid())
        if final:
            doc["final"] = True
        try:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            tmp = f"{self.path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, default=str)
            os.replace(tmp, self.path)
            if obs.enabled():
                obs.counter("failure/file_beats").inc()
        except OSError:
            _LOG.exception("file heartbeat write failed: %s", self.path)
        return doc

    @staticmethod
    def read(path: str) -> Optional[Dict]:
        """The member's latest doc, or None for a missing or torn file."""
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    @staticmethod
    def age_s(doc: Optional[Dict], now: Optional[float] = None) -> float:
        """Seconds since the doc's beat; ``inf`` for no doc."""
        if not doc or not isinstance(doc.get("written_at"), (int, float)):
            return float("inf")
        return max(0.0, (time.time() if now is None else now)
                   - doc["written_at"])


class StragglerMonitor:
    """Per-rank step times and straggler flagging: :meth:`report`
    all-gathers each rank's mean over the last ``window`` steps and flags
    ranks above ``threshold`` x the median. A rank flagged in
    ``persist_after`` consecutive reports fires ``health/straggler``;
    one clean report re-arms it."""

    def __init__(self, threshold: float = 1.5, window: int = 50,
                 persist_after: int = 3):
        self.threshold = threshold
        self.window = window
        self.persist_after = max(1, int(persist_after))
        self.times: List[float] = []
        self._consecutive: Dict[int, int] = {}

    def record(self, step_time_s: float) -> None:
        self.times.append(float(step_time_s))
        if len(self.times) > self.window:
            self.times.pop(0)

    def _local_mean(self) -> float:
        return float(np.mean(self.times)) if self.times else 0.0

    def _gather_means(self) -> np.ndarray:
        return np.asarray(_allgather_scalar(self._local_mean(),
                                            torch.float64), np.float64)

    @staticmethod
    def analyze(per_host_means: np.ndarray, threshold: float = 1.5) -> Dict:
        means = np.asarray(per_host_means, np.float64)
        med = float(np.median(means)) if means.size else 0.0
        stragglers = [int(i) for i, m in enumerate(means)
                      if med > 0 and m > threshold * med]
        return {"per_host_mean_s": [float(m) for m in means],
                "median_s": med,
                "max_s": float(means.max()) if means.size else 0.0,
                "imbalance": float(means.max() / med) if med > 0 else 1.0,
                "stragglers": stragglers}

    def report(self) -> Dict:
        rep = self.analyze(self._gather_means(), self.threshold)
        flagged = set(rep["stragglers"])
        for pid in flagged:
            self._consecutive[pid] = self._consecutive.get(pid, 0) + 1
            if self._consecutive[pid] == self.persist_after:
                _health.emit(
                    "straggler", host=pid,
                    consecutive_reports=self._consecutive[pid],
                    mean_s=round(rep["per_host_mean_s"][pid], 6),
                    median_s=round(rep["median_s"], 6),
                    imbalance=round(rep["imbalance"], 3),
                    threshold=self.threshold)
        for pid in list(self._consecutive):
            if pid not in flagged:
                del self._consecutive[pid]
        return rep


# imported last: chaos imports this module's taxonomy
from . import chaos as _chaos  # noqa: E402
