"""FLOP tallies of the hand kernels for the program cost notes
(``observability.perf``).

``torch.utils.flop_counter.FlopCounterMode`` counts the aten operations it
sees. A kernel launched through ``ctypes`` is no aten operation, so on the
card a wrapper that launches one adds to every active counter what its
plain version's aten operations would have counted for the same call
(:func:`tally`); on the CPU the plain version runs and is counted as it
is. The count of a step is then the same on either device.

The counters are registered process-wide (:func:`counting`), not per
thread, because autograd runs a CUDA backward on a thread of its own. A
launch during a CUDA-graph capture is not counted: the capture runs no
work.
"""
from __future__ import annotations

import contextlib
import threading

import torch

_lock = threading.Lock()
_counters: list = []     # the active FlopCounterMode objects


@contextlib.contextmanager
def counting(counter):
    """Add the kernels' tallies to ``counter`` (an entered
    ``FlopCounterMode``) while the block runs."""
    with _lock:
        _counters.append(counter)
    try:
        yield counter
    finally:
        with _lock:
            _counters.remove(counter)


def tally(name: str, flops: int):
    """Add ``flops`` under ``name`` to every active counter."""
    if not _counters or (torch.cuda.is_available()
                         and torch.cuda.is_current_stream_capturing()):
        return
    with _lock:
        for c in _counters:
            c.flop_counts["Global"][name] += int(flops)


def attention(B, H, Tq, Tk, D) -> int:
    """The two (Tq x Tk x D) products of one attention forward."""
    return 4 * B * H * Tq * Tk * D
