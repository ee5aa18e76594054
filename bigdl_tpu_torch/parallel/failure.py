"""Failure classes and the retry budget (counterpart of the host part of
``bigdl_tpu/parallel/failure.py``).

``classify_failure`` maps an exception onto TRANSIENT / PERMANENT;
:class:`FaultPolicy` is the retry and backoff budget the serving tier's
replays share (the decode scheduler's step replay, the engine's batch
retry). The mesh probe, the heartbeats and the straggler monitor
(``probe_mesh``, ``Heartbeat``, ``FileHeartbeat``, ``StragglerMonitor``)
are multi-device and not ported yet (ROADMAP A.6); ``HeartbeatLost`` is
here as the type ``classify_failure`` knows.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

__all__ = ["TRANSIENT", "PERMANENT", "TransientDeviceError", "HeartbeatLost",
           "classify_failure", "FaultPolicy", "TrainingHalted"]

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
