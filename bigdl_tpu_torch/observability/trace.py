"""Span-based tracer: nested, thread-safe, monotonic, exception-safe
(counterpart of ``bigdl_tpu/observability/trace.py``, the port's own copy
with its own process tracer).

* Disabled cost is one flag read: ``with span("serve/prefill"):`` returns
  a shared no-op context manager when tracing is off.
* Spans stamp ``time.perf_counter_ns()``, so wall-clock steps never give
  negative durations.
* Each thread owns its span stack (``threading.local``); finished spans
  land in one shared list that the exporters snapshot under a lock.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

__all__ = ["Span", "Tracer", "get_tracer", "enable", "disable", "enabled",
           "reset", "span", "instant", "complete"]


class Span:
    """One finished (or open) span. Times are perf_counter nanoseconds."""

    __slots__ = ("name", "start_ns", "end_ns", "tid", "depth", "args")

    def __init__(self, name: str, start_ns: int, tid: int, depth: int,
                 args: Optional[Dict] = None):
        self.name = name
        self.start_ns = start_ns
        self.end_ns: Optional[int] = None
        self.tid = tid
        self.depth = depth
        self.args = args

    @property
    def duration_ns(self) -> int:
        return (self.end_ns or self.start_ns) - self.start_ns

    def __repr__(self):
        return (f"Span({self.name!r}, dur={self.duration_ns / 1e6:.3f}ms, "
                f"depth={self.depth})")


class _SpanHandle:
    """Context manager that closes its span exactly once, exception or
    not; an exception tags the span (``error: ExcType``) instead of
    leaking an open span on the stack."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", sp: Span):
        self._tracer = tracer
        self._span = sp

    def annotate(self, **kw):
        """Attach key/values to the live span (shows up in the Chrome
        trace ``args`` pane)."""
        if self._span.args is None:
            self._span.args = {}
        self._span.args.update(kw)
        return self

    @property
    def duration_s(self) -> float:
        """Elapsed seconds (final after ``__exit__``) — lets call-sites
        feed a histogram from the SAME clock reads the span made instead
        of timing the interval twice."""
        return self._span.duration_ns / 1e9

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.annotate(error=exc_type.__name__)
        self._tracer._finish(self._span)
        return False


class _NullSpan:
    """Shared no-op handle for the disabled path (and a safe annotate)."""

    __slots__ = ()

    duration_s = 0.0

    def annotate(self, **kw):
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    def __init__(self, max_events: int = 1_000_000):
        # max_events bounds memory on multi-hour runs: once full the
        # tracer drops new spans (and counts the drops) rather than OOM
        self.max_events = max_events
        self.dropped = 0
        self._events: List[Span] = []
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._epoch_ns = time.perf_counter_ns()

    # -- recording -------------------------------------------------------
    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def span(self, name: str, **args) -> _SpanHandle:
        st = self._stack()
        sp = Span(name, time.perf_counter_ns(), threading.get_ident(),
                  len(st), args or None)
        st.append(sp)
        return _SpanHandle(self, sp)

    def _append(self, sp: Span):
        # lock: reset() clears the list + re-stamps the epoch; an append
        # racing it would land a pre-epoch span (negative export ts).
        # The ONE capacity gate for every recording path (finish/
        # instant/complete) — the drop policy must not fork per path.
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(sp)

    def _finish(self, sp: Span):
        sp.end_ns = time.perf_counter_ns()
        st = self._stack()
        # exception-safe even if an inner handle leaked: pop through to
        # this span rather than corrupting the depth bookkeeping
        while st and st[-1] is not sp:
            st.pop()
        if st:
            st.pop()
        self._append(sp)

    def complete(self, name: str, start_ns: int, end_ns: int,
                 tid: Optional[int] = None, **args):
        """Record an already-finished span from caller-supplied
        ``perf_counter_ns`` stamps (depth 0) — for intervals whose
        start predates the recording call, e.g. a serving request's
        queue wait measured from its enqueue stamp when its batch is
        finally cut. Bypasses the nesting stack. ``tid`` defaults to
        the current thread; pass a synthetic (e.g. negative) id when
        several retro spans OVERLAP — complete events on one tid are
        nested-by-containment in the trace format, so overlapping siblings must each
        ride their own virtual lane to keep self-times honest."""
        sp = Span(name, int(start_ns),
                  threading.get_ident() if tid is None else tid, 0,
                  args or None)
        sp.end_ns = int(end_ns)
        self._append(sp)

    def instant(self, name: str, **args):
        """Zero-duration marker event (nan skips, trigger fires)."""
        sp = Span(name, time.perf_counter_ns(), threading.get_ident(),
                  len(self._stack()), args or None)
        sp.end_ns = sp.start_ns
        self._append(sp)

    # -- reading ---------------------------------------------------------
    def events(self) -> List[Span]:
        with self._lock:
            return list(self._events)

    def reset(self):
        with self._lock:
            self._events.clear()
            self.dropped = 0
            self._epoch_ns = time.perf_counter_ns()

    @property
    def epoch_ns(self) -> int:
        """perf_counter origin for relative timestamps in exports."""
        return self._epoch_ns


# -- process-global state ------------------------------------------------
_enabled = False
_tracer = Tracer()


def get_tracer() -> Tracer:
    return _tracer


def enable():
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def reset():
    """Clear collected spans (and the shared registry's owner does its
    own reset; this touches only the tracer)."""
    _tracer.reset()


def span(name: str, **args):
    """Module-level hot-path entry: a real span when enabled, the shared
    no-op handle when not."""
    if not _enabled:
        return _NULL_SPAN
    return _tracer.span(name, **args)


def instant(name: str, **args):
    if _enabled:
        _tracer.instant(name, **args)


def complete(name: str, start_ns: int, end_ns: int,
             tid: Optional[int] = None, **args):
    """Record a retrospective span from explicit ``perf_counter_ns``
    stamps (no-op when disabled). See :meth:`Tracer.complete` for the
    ``tid`` contract on overlapping spans."""
    if _enabled:
        _tracer.complete(name, start_ns, end_ns, tid=tid, **args)
