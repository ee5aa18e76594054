"""Unified tracing, metrics and health (counterpart of
``bigdl_tpu/observability``; the port's own copy, with its own process
globals: its tracer, metrics registry, health listeners, watchdog thread
and flight recorder are not the JAX package's).

* ``trace``: span-based tracer (``with observability.span("serve/prefill")``).
* ``metrics``: the process-global registry of counters, gauges and
  histograms under slash-namespaced names (``serve/ttft_ms``).
* ``exporters``: Chrome trace-event JSON, Prometheus text, the metric-line
  dump.
* ``health``: the stall watchdog over progress beacons (``health/stall``),
  anomaly detectors, device-memory telemetry from
  ``torch.cuda.memory_stats`` and ``torch.profiler`` windows
  (``BIGDL_TPU_PROFILE=start:stop``).
* ``flight``: a bounded ring of recent events, dumped as a JSON crash
  bundle on failure.
* ``cluster``: per-process metric snapshots merged by rank 0.
* ``perf``: what the programs cost: per-call FLOP and memory artifacts
  from the training step, the evaluator / predictor forwards and the
  decode step (``compile/*``), and the live MFU / step-phase gauges
  (``perf/mfu``, ``perf/phase_*_frac``) derived from them.

Disabled cost is one flag read a site; enable with :func:`enable` or ``BIGDL_TPU_TRACE=1``.
The environment variables keep the JAX package's names.
"""
from __future__ import annotations

import os as _os

from .trace import (Tracer, enable, disable, enabled, span, instant,
                    complete, get_tracer, reset)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      registry, counter, gauge, histogram)
from .exporters import (chrome_trace, write_chrome_trace, prometheus_text,
                        SummaryBridge, metrics_dump, write_metrics_dump,
                        record_bench_line)
from . import flight
from . import health
from . import perf
from . import cluster

__all__ = ["Tracer", "enable", "disable", "enabled", "span", "instant",
           "complete", "get_tracer", "reset", "Counter", "Gauge",
           "Histogram", "MetricsRegistry", "registry", "counter", "gauge",
           "histogram", "chrome_trace", "write_chrome_trace",
           "prometheus_text", "SummaryBridge", "metrics_dump",
           "write_metrics_dump", "record_bench_line", "flight", "health",
           "perf", "cluster"]

if _os.environ.get("BIGDL_TPU_TRACE") == "1":
    enable()
