"""Batch staging: overlap host batch preparation with the device's compute
(counterpart of ``bigdl_tpu/optim/staging.py``).

The serial loop pays ``produce batch -> place -> step`` every iteration.
``BatchStager`` moves produce and place onto one bounded lookahead thread:
while step N runs, the thread pulls batches N+1..N+depth from the data
set's iterator and stages them, so the loop's fetch is a queue pop of a
batch already on the device.

On a CUDA device the thread places on a side stream of its own: pinned
host buffers copied with ``non_blocking=True``, then an event recorded on
the side stream. The consumer's stream waits on that event before the
batch is handed out, and every CUDA tensor of the batch is marked with
``record_stream`` for the consumer's stream, so the caching allocator
cannot give its memory to a later batch while a step still reads it.

Invariants, as in the JAX package:

* **Order-preserving.** One worker thread, one FIFO queue: the consumer
  sees batches in the serial order, so training is bit for bit the serial
  loop's.
* **Error-transparent.** An exception in the iterator or the stage
  function is raised in the consumer at the matching ``next()``.
* **No thread leaks.** ``close()`` (idempotent, also reached at
  exhaustion) unblocks and joins the worker; the threads are named
  ``bigdl_tpu-stager`` (the JAX package's name) so tests can count them.
"""
from __future__ import annotations

import contextlib
import logging
import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from ..observability import health as _health
from ..utils.engine import resolve_device
from ..utils.table import Table

__all__ = ["BatchStager", "staged", "stager_threads_alive",
           "place_host_value"]

THREAD_NAME = "bigdl_tpu-stager"

_SENTINEL = object()


def _cuda_tensors(x):
    """The CUDA tensors of a staged item (tuples, lists, Tables, dicts)."""
    if isinstance(x, torch.Tensor):
        return [x] if x.is_cuda else []
    if isinstance(x, (tuple, list, Table)):
        return [t for i in x for t in _cuda_tensors(i)]
    if isinstance(x, dict):
        return [t for i in x.values() for t in _cuda_tensors(i)]
    return []


class BatchStager:
    """Bounded lookahead stager: a daemon thread pulls items from
    ``source``, maps them through ``stage_fn`` (host work and placement)
    and parks up to ``depth`` staged results in a FIFO queue.

    Iterate it like the source; :meth:`close` (or the context manager)
    shuts the worker down early, e.g. when an end trigger fires
    mid-epoch. With ``group=K`` and a ``group_fn`` the worker collects up
    to K staged items and emits one ``group_fn([item, ...])`` a group (the
    optimizer's superstep stacks); an item whose ``group_key`` differs
    from the pending group's starts a new group, and the epoch's last
    group may be smaller. ``device``: where ``stage_fn`` places (the CUDA
    device by default; ``'cpu'`` for the CPU, where no stream is used)."""

    def __init__(self, source: Iterable, stage_fn: Callable, depth: int = 2,
                 name: str = "stager", group: int = 1,
                 group_fn: Optional[Callable] = None,
                 group_key: Optional[Callable] = None,
                 stall_deadline_s: Optional[float] = None, device=None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if group < 1:
            raise ValueError(f"group must be >= 1, got {group}")
        if group > 1 and group_fn is None:
            raise ValueError("group > 1 requires a group_fn")
        dev = resolve_device(device)
        self._cuda = dev if dev.type == "cuda" else None
        self._source = source
        self._stage_fn = stage_fn
        self._group = group
        self._group_fn = group_fn
        self._group_key = group_key or (lambda item: None)
        self._name = name
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._err = None
        self._done = False
        # pulsed per source item and while blocked on a full queue (the
        # consumer's wait): silence means a wedged iterator or stage_fn
        self._beacon = _health.beacon(f"stager/{name}",
                                      deadline_s=stall_deadline_s)
        self._thread = threading.Thread(
            target=self._run, name=THREAD_NAME, daemon=True)
        self._thread.start()

    # -- worker ----------------------------------------------------------
    def _stream_context(self):
        if self._cuda is None:
            return contextlib.nullcontext(None)
        torch.cuda.set_device(self._cuda)
        return torch.cuda.stream(torch.cuda.Stream(self._cuda))

    def _emit(self, staged):
        """(item, the event its placement recorded on the side stream)."""
        ev = None
        if self._cuda is not None:
            ev = torch.cuda.Event()
            ev.record()
        while not self._stop.is_set():
            try:
                self._q.put((staged, ev), timeout=0.1)
                return
            except queue.Full:
                self._beacon.pulse()

    def _run(self):
        it = iter(self._source)
        pending = []
        try:
            with self._stream_context():
                exhausted = False
                while not self._stop.is_set() and not exhausted:
                    try:
                        item = next(it)
                    except StopIteration:
                        exhausted = True
                    self._beacon.pulse()
                    if exhausted:
                        emit = []
                        if pending:     # the epoch's tail: a smaller group
                            emit, pending = [self._group_fn(pending)], []
                    elif self._group > 1:
                        staged = self._stage_fn(item)
                        emit = []
                        if pending and self._group_key(staged) != \
                                self._group_key(pending[0]):
                            emit, pending = [self._group_fn(pending)], []
                        pending.append(staged)
                        if len(pending) == self._group:
                            emit.append(self._group_fn(pending))
                            pending = []
                    else:
                        emit = [self._stage_fn(item)]
                    for staged in emit:
                        self._emit(staged)
        except BaseException as e:  # noqa: BLE001 - raised in the consumer
            self._err = e
        finally:
            self._beacon.close()
            close = getattr(it, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass
            while not self._stop.is_set():
                try:
                    self._q.put(_SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    continue

    # -- consumer --------------------------------------------------------
    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        while True:
            try:
                got = self._q.get(timeout=0.5)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    self._done = True
                    self._reraise()
                    raise StopIteration
        if got is _SENTINEL:
            self._done = True
            self._thread.join(timeout=30)
            self._reraise()
            raise StopIteration
        item, ev = got
        if ev is not None:
            stream = torch.cuda.current_stream(self._cuda)
            stream.wait_event(ev)
            for t in _cuda_tensors(item):
                t.record_stream(stream)
        return item

    def _reraise(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def close(self):
        """Stop the worker and join it (idempotent, never raises); staged
        batches not yet consumed are dropped."""
        self._stop.set()
        try:    # drain, so a worker blocked on a full queue wakes
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=30)
        if self._thread.is_alive():
            logging.getLogger(__name__).warning(
                "stager %r worker did not join within 30s (blocked in "
                "stage_fn?) - daemon thread leaked", self._name)
        self._beacon.close()
        self._done = True

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False


class _SerialStager:
    """Depth 0 / 1: the same iterator and ``close()``, staging each item
    inline at ``next()`` - the serial loop, so ``set_prefetch(0)`` is an
    exact A/B switch. ``group`` / ``group_fn`` / ``group_key`` stack
    inline with the threaded stager's semantics."""

    def __init__(self, source: Iterable, stage_fn: Callable,
                 group: int = 1, group_fn: Optional[Callable] = None,
                 group_key: Optional[Callable] = None):
        if group > 1 and group_fn is None:
            raise ValueError("group > 1 requires a group_fn")
        self._it = iter(source)
        self._stage_fn = stage_fn
        self._group = group
        self._group_fn = group_fn
        self._group_key = group_key or (lambda item: None)
        self._carry = []    # the item that broke the previous group

    def __iter__(self):
        return self

    def __next__(self):
        if self._group <= 1:
            return self._stage_fn(next(self._it))
        pending, self._carry = self._carry, []
        while len(pending) < self._group:
            try:
                staged = self._stage_fn(next(self._it))
            except StopIteration:
                if pending:
                    break       # the epoch's tail: a smaller group
                raise
            if pending and self._group_key(staged) != \
                    self._group_key(pending[0]):
                self._carry = [staged]
                break
            pending.append(staged)
        return self._group_fn(pending)

    def close(self):
        close = getattr(self._it, "close", None)
        if close is not None:
            try:
                close()
            except Exception:
                pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False


def staged(source: Iterable, stage_fn: Callable, depth: int = 2,
           name: str = "stager", group: int = 1,
           group_fn: Optional[Callable] = None,
           group_key: Optional[Callable] = None,
           stall_deadline_s: Optional[float] = None, device=None):
    """The threaded stager for ``depth >= 2``, the inline one for 0 / 1;
    ``group`` / ``group_fn`` / ``group_key`` stack on either."""
    if depth >= 2:
        return BatchStager(source, stage_fn, depth=depth, name=name,
                           group=group, group_fn=group_fn,
                           group_key=group_key,
                           stall_deadline_s=stall_deadline_s, device=device)
    return _SerialStager(source, stage_fn, group=group, group_fn=group_fn,
                         group_key=group_key)


def stager_threads_alive() -> int:
    """Live stager worker threads (0 after every stager has closed)."""
    return sum(1 for t in threading.enumerate()
               if t.name == THREAD_NAME and t.is_alive())


def _stack(vals):
    """Host batches (arrays, or Tables of them) -> one ``[k, ...]``
    stack, member by member."""
    if vals[0] is None:
        return None
    if isinstance(vals[0], Table):
        return Table(*(_stack(list(ms)) for ms in zip(*vals)))
    return np.stack([np.asarray(v) for v in vals])


def _index(x, i):
    """``x[i]`` of a stack (a tensor, a Table of them, or None)."""
    if x is None:
        return None
    if isinstance(x, Table):
        return Table(*(_index(m, i) for m in x))
    return x[i]


def _first_leaf(x):
    return _first_leaf(x[1]) if isinstance(x, Table) else x


def place_host_value(x, device=None):
    """A host value (numpy array, or a tensor, or a ``Table`` of them,
    placed member by member) as a tensor on ``device`` (the CUDA device by
    default; ``'cpu'`` for the CPU). A float64 array becomes float32, as
    ``jnp.asarray`` makes it in JAX's default 32-bit mode. To a card the
    bytes go through a pinned copy and a non-blocking transfer on the
    current stream."""
    if x is None:
        return None
    if isinstance(x, Table):
        return Table(*(place_host_value(i, device) for i in x))
    dev = resolve_device(device)
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        x = torch.from_numpy(np.ascontiguousarray(
            a.astype(np.float32) if a.dtype == np.float64 else a))
    if dev.type == "cuda":
        if x.device.type == "cpu":
            x = x.pin_memory()
        return x.to(dev, non_blocking=True)
    return x.to(dev)
