"""Request-side serving types (counterpart of
``bigdl_tpu/serving/batching.py``)."""
from __future__ import annotations

from concurrent.futures import Future
from typing import Optional


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
