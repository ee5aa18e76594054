"""Request-side serving types and micro-batch assembly (counterpart of
``bigdl_tpu/serving/batching.py``; the shape-bucket math is in
``optim/predictor.py``). :func:`assemble` isolates errors per request: a
malformed input fails its own future and the rest of the batch still
serves.
"""
from __future__ import annotations

import time
from concurrent.futures import Future
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["QueueFull", "DeadlineExceeded", "EngineStopped", "ServeFuture",
           "Request", "assemble"]


class QueueFull(RuntimeError):
    """Admission control: the bounded request queue is at capacity."""


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed; ``.partial`` holds the tokens
    generated before it did."""


class EngineStopped(RuntimeError):
    """submit() after shutdown began, or work abandoned by a hard stop."""


class ServeFuture(Future):
    """``concurrent.futures.Future`` plus serving provenance: the model
    ``version`` that answered, the request id ``rid`` and a ``trace`` dict
    of per-request timings."""

    def __init__(self):
        super().__init__()
        self.version: Optional[str] = None
        self.rid: Optional[int] = None
        self.trace: Optional[dict] = None


class Request:
    """One queued inference request: the raw input, the future the client
    holds, its enqueue stamps (``t_enqueue`` monotonic seconds,
    ``t_enqueue_ns`` the ``perf_counter_ns`` the queue-wait span starts
    from), its absolute deadline (or None) and the engine's request id."""

    __slots__ = ("x", "future", "t_enqueue", "t_enqueue_ns", "deadline",
                 "rid")

    def __init__(self, x, deadline_s: Optional[float] = None,
                 rid: Optional[int] = None):
        self.x = x
        self.future = ServeFuture()
        self.rid = rid
        self.future.rid = rid
        self.t_enqueue = time.monotonic()
        self.t_enqueue_ns = time.perf_counter_ns()
        self.deadline = (self.t_enqueue + deadline_s
                         if deadline_s is not None else None)

    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline is not None
                and (now or time.monotonic()) > self.deadline)


def assemble(requests: Sequence[Request],
             template_shape: Optional[Tuple[int, ...]] = None,
             dtype=np.float32) -> Tuple[Optional[np.ndarray], List[Request]]:
    """Stack per-request samples into one ``[n, ...]`` host batch. Each
    input is converted and shape-checked on its own: a failure sets that
    request's future and drops it, the survivors still dispatch. Returns
    ``(batch, live_requests)``, ``batch`` None when nothing survived.
    ``template_shape`` is the authority when given; otherwise the first
    convertible request sets it."""
    xs: List[np.ndarray] = []
    live: List[Request] = []
    shape = template_shape
    for r in requests:
        try:
            a = np.asarray(r.x, dtype=dtype)
            if shape is None:
                shape = a.shape
            if a.shape != shape:
                raise ValueError(
                    f"request sample shape {a.shape} != expected {shape} "
                    "(submit ONE unbatched sample per request)")
        except BaseException as e:  # noqa: BLE001 - routed to the future
            if not r.future.cancelled():
                r.future.set_exception(e)
            continue
        xs.append(a)
        live.append(r)
    if not live:
        return None, []
    return np.stack(xs, axis=0), live
