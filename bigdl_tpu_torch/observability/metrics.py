"""Process-global metrics registry: counters, gauges, histograms
(counterpart of ``bigdl_tpu/observability/metrics.py``, the port's own
copy with its own registry).

Names are slash-namespaced (``serve/ttft_ms``, ``serve/kv_allocs``); the
Prometheus exporter sanitizes them to its charset. Call sites guard writes
with ``observability.enabled()``; the instruments themselves do not check
the flag.
"""
from __future__ import annotations

import random
import threading
import zlib
from typing import Callable, Dict, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
           "counter", "gauge", "histogram"]


class Counter:
    """Monotonic accumulator (events, bytes)."""

    __slots__ = ("name", "unit", "value")

    def __init__(self, name: str, unit: str = ""):
        self.name = name
        self.unit = unit
        self.value = 0.0

    def inc(self, n: float = 1.0):
        self.value += n
        return self


class Gauge:
    """Last-write-wins point-in-time value (queue depth, throughput) — or,
    via :meth:`set_fn`, a value computed at READ time (heartbeat age: the
    number must keep growing while the loop that would have updated it is
    hung, which a write-time gauge cannot do)."""

    __slots__ = ("name", "unit", "_value", "_fn")

    def __init__(self, name: str, unit: str = ""):
        self.name = name
        self.unit = unit
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, v: float):
        self._fn = None
        self._value = float(v)
        return self

    def set_fn(self, fn: Callable[[], float]):
        """Make the gauge live: exporters call ``fn()`` at read time."""
        self._fn = fn
        return self

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:
                # a raising callback must not break snapshot()/
                # prometheus_text for every OTHER instrument: this gauge
                # reads NaN (distinguishable from any real value), the
                # failure is counted, and the export proceeds. The error
                # counter lives in the DEFAULT registry regardless of
                # which registry owns the gauge — one place to alert on.
                _registry.counter("obs/gauge_fn_errors").inc()
                return float("nan")
        return self._value


class Histogram:
    """Streaming distribution with reservoir-sampled quantiles.

    Exact count/sum/min/max; quantiles come from a fixed-size uniform
    reservoir (Vitter's algorithm R) so a million-step run costs the
    same memory as a hundred-step one. The reservoir RNG is seeded per
    instrument for reproducible tests.
    """

    __slots__ = ("name", "unit", "count", "total", "min", "max",
                 "_reservoir", "_cap", "_rng", "_lock")

    def __init__(self, name: str, unit: str = "", reservoir_size: int = 1024):
        self.name = name
        self.unit = unit
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._cap = reservoir_size
        self._reservoir: List[float] = []
        # crc32, not hash(): PYTHONHASHSEED randomizes str hashes per
        # process, and the seed must be stable across runs
        self._rng = random.Random(zlib.crc32(name.encode()))
        self._lock = threading.Lock()

    def observe(self, v: float):
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            if len(self._reservoir) < self._cap:
                self._reservoir.append(v)
            else:
                j = self._rng.randrange(self.count)
                if j < self._cap:
                    self._reservoir[j] = v
        return self

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile over the reservoir (0 when empty)."""
        with self._lock:
            if not self._reservoir:
                return 0.0
            s = sorted(self._reservoir)
        idx = min(len(s) - 1, max(0, int(q * len(s))))
        return s[idx]

    def quantiles(self, qs=(0.5, 0.9, 0.99)) -> Dict[float, float]:
        with self._lock:
            s = sorted(self._reservoir)
        if not s:
            return {q: 0.0 for q in qs}
        return {q: s[min(len(s) - 1, max(0, int(q * len(s))))] for q in qs}


class MetricsRegistry:
    """Name → instrument, typed getters, one lock around creation."""

    def __init__(self):
        self._instruments: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, **kw):
        inst = self._instruments.get(name)
        if inst is None:
            with self._lock:
                inst = self._instruments.get(name)
                if inst is None:
                    inst = cls(name, **kw)
                    self._instruments[name] = inst
        if not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(inst).__name__}, requested {cls.__name__}")
        return inst

    def counter(self, name: str, unit: str = "") -> Counter:
        return self._get(name, Counter, unit=unit)

    def gauge(self, name: str, unit: str = "") -> Gauge:
        return self._get(name, Gauge, unit=unit)

    def histogram(self, name: str, unit: str = "",
                  reservoir_size: int = 1024) -> Histogram:
        return self._get(name, Histogram, unit=unit,
                         reservoir_size=reservoir_size)

    def get(self, name: str):
        return self._instruments.get(name)

    def names(self) -> List[str]:
        return sorted(self._instruments)

    def instruments(self) -> List[object]:
        with self._lock:
            return [self._instruments[n] for n in sorted(self._instruments)]

    def reset(self):
        with self._lock:
            self._instruments.clear()

    def snapshot(self) -> Dict[str, Dict]:
        """Plain-dict view, one entry per instrument (for logs / JSON)."""
        out = {}
        for inst in self.instruments():
            if isinstance(inst, Histogram):
                out[inst.name] = {
                    "type": "histogram", "unit": inst.unit,
                    "count": inst.count, "sum": inst.total,
                    "mean": inst.mean,
                    "min": inst.min if inst.count else 0.0,
                    "max": inst.max if inst.count else 0.0,
                    "quantiles": {str(q): v
                                  for q, v in inst.quantiles().items()},
                }
            elif isinstance(inst, Counter):
                out[inst.name] = {"type": "counter", "unit": inst.unit,
                                  "value": inst.value}
            else:
                out[inst.name] = {"type": "gauge", "unit": inst.unit,
                                  "value": inst.value}
        return out


_registry = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _registry


def counter(name: str, unit: str = "") -> Counter:
    return _registry.counter(name, unit)


def gauge(name: str, unit: str = "") -> Gauge:
    return _registry.gauge(name, unit)


def histogram(name: str, unit: str = "") -> Histogram:
    return _registry.histogram(name, unit)
