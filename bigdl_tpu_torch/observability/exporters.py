"""Exporters: Chrome trace-event JSON, Prometheus text, a summary bridge and
the ``{"metric", "value", "unit"}`` metric-line dump (counterpart of
``bigdl_tpu/observability/exporters.py``).

The Chrome trace is the ``traceEvents`` array of complete ("ph": "X")
events, timestamps in microseconds from the tracer's epoch. Prometheus
text exports histograms as ``summary`` (reservoir quantiles).
``SummaryBridge`` mirrors registry values into any object with
``add_scalar(tag, value, step)``.
"""
from __future__ import annotations

import json
import re
from typing import Dict, List, Optional

from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .metrics import registry as _default_registry
from .trace import Tracer, get_tracer

__all__ = ["chrome_trace", "write_chrome_trace", "prometheus_text",
           "SummaryBridge", "record_bench_line", "metrics_dump",
           "write_metrics_dump"]

# ------------------------------------------------------------------ chrome

def chrome_trace(tracer: Optional[Tracer] = None,
                 process_name: str = "bigdl_tpu") -> Dict:
    """Trace-event JSON object (dict); dump with json.dump or
    :func:`write_chrome_trace`."""
    tracer = tracer or get_tracer()
    epoch = tracer.epoch_ns
    events = [{
        "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
        "args": {"name": process_name},
    }]
    tids = {}
    for sp in tracer.events():
        # compact per-thread tids (thread idents are huge opaque ints)
        tid = tids.setdefault(sp.tid, len(tids))
        ev = {
            "name": sp.name,
            "cat": sp.name.split("/", 1)[0],
            "ph": "X",
            # clamp: a span that straddled a reset() started before the
            # re-stamped epoch; never emit negative timestamps
            "ts": max(0.0, (sp.start_ns - epoch) / 1e3),
            "dur": sp.duration_ns / 1e3,
            "pid": 0,
            "tid": tid,
        }
        if sp.args:
            ev["args"] = dict(sp.args)
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"dropped_events": tracer.dropped}}


def write_chrome_trace(path: str, tracer: Optional[Tracer] = None) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(tracer), f)
    return path


# -------------------------------------------------------------- prometheus

def _prom_name(name: str) -> str:
    """Prometheus metric charset: [a-zA-Z_:][a-zA-Z0-9_:]*."""
    out = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _fmt(v: float) -> str:
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return repr(float(v))


def prometheus_text(reg: Optional[MetricsRegistry] = None,
                    prefix: str = "bigdl") -> str:
    """Text exposition format. Counters keep their value as-is (callers
    count events or bytes); histograms export as proper summaries with
    ``quantile="0.5|0.9|0.99"`` labels plus _sum/_count/_min/_max. Every
    family gets a ``# HELP`` line carrying the registry name and unit.
    A live gauge whose callback raises exports NaN (and bumps
    ``obs/gauge_fn_errors``) instead of aborting the scrape."""
    reg = reg or _default_registry()
    lines: List[str] = []
    for inst in reg.instruments():
        base = _prom_name(f"{prefix}_{inst.name}" if prefix else inst.name)
        unit = f" ({inst.unit})" if inst.unit else ""
        lines.append(f"# HELP {base} {inst.name}{unit}")
        if isinstance(inst, Counter):
            lines.append(f"# TYPE {base} counter")
            lines.append(f"{base} {_fmt(inst.value)}")
        elif isinstance(inst, Gauge):
            lines.append(f"# TYPE {base} gauge")
            lines.append(f"{base} {_fmt(inst.value)}")
        elif isinstance(inst, Histogram):
            lines.append(f"# TYPE {base} summary")
            for q, v in sorted(inst.quantiles((0.5, 0.9, 0.99)).items()):
                lines.append(f'{base}{{quantile="{q}"}} {_fmt(v)}')
            lines.append(f"{base}_sum {_fmt(inst.total)}")
            lines.append(f"{base}_count {inst.count}")
            if inst.count:
                lines.append(f"{base}_min {_fmt(inst.min)}")
                lines.append(f"{base}_max {_fmt(inst.max)}")
    return "\n".join(lines) + "\n"


# ------------------------------------------------------------- tensorboard

class SummaryBridge:
    """Mirror selected registry metrics into a ``visualization.Summary``.

    ``flush(step)`` writes one scalar per counter/gauge and
    mean/p50/p99 scalars per histogram, under ``obs/<name>`` tags —
    the existing event-file reader (``Summary.read_scalar``) sees them
    like any other scalar, so TensorBoard keeps working without a new
    backend. ``metrics=None`` bridges everything; pass an iterable of
    registry names to select."""

    def __init__(self, summary, reg: Optional[MetricsRegistry] = None,
                 metrics: Optional[List[str]] = None,
                 tag_prefix: str = "obs/"):
        self.summary = summary
        self.reg = reg or _default_registry()
        self.metrics = set(metrics) if metrics is not None else None
        self.tag_prefix = tag_prefix

    def flush(self, step: int):
        n = 0
        for inst in self.reg.instruments():
            if self.metrics is not None and inst.name not in self.metrics:
                continue
            tag = self.tag_prefix + inst.name
            if isinstance(inst, Histogram):
                if not inst.count:
                    continue
                qs = inst.quantiles((0.5, 0.99))
                self.summary.add_scalar(tag + "/mean", inst.mean, step)
                self.summary.add_scalar(tag + "/p50", qs[0.5], step)
                self.summary.add_scalar(tag + "/p99", qs[0.99], step)
                n += 3
            else:
                self.summary.add_scalar(tag, inst.value, step)
                n += 1
        return n


# ------------------------------------------------------- bench-line schema

def record_bench_line(line: Dict, reg: Optional[MetricsRegistry] = None):
    """Feed one bench.py result line ({"metric", "value", "unit", ...})
    into the registry as a gauge named ``bench/<metric>``; vs_baseline
    and mfu side-values get their own gauges."""
    reg = reg or _default_registry()
    name = line.get("metric")
    if not name or not isinstance(line.get("value"), (int, float)):
        return
    reg.gauge(f"bench/{name}", unit=line.get("unit", "")).set(line["value"])
    # stale_cache rides along as a 1.0 gauge (bool is an int): a metrics
    # dump built from a cached re-serve must carry the mark, so nothing
    # downstream (perf gate, round files) can mistake it for fresh
    for extra in ("vs_baseline", "mfu", "input_wait_frac", "superstep_k",
                  "dispatches", "compile_cache_hits",
                  "compile_cache_misses", "queue_wait_p99_ms",
                  "assemble_p99_ms", "dispatch_p99_ms", "stale_cache"):
        if isinstance(line.get(extra), (int, float)):
            reg.gauge(f"bench/{name}/{extra}").set(float(line[extra]))


def metrics_dump(reg: Optional[MetricsRegistry] = None) -> List[Dict]:
    """The registry rendered as BENCH_*.json-compatible metric lines:
    one ``{"metric", "value", "unit", "kind"}`` dict per instrument
    (histograms add count/mean/p50/p99). ``bench/``-namespaced gauges
    round-trip to exactly the line bench.py printed."""
    reg = reg or _default_registry()
    out = []
    for inst in reg.instruments():
        line = {"metric": inst.name, "unit": inst.unit}
        if isinstance(inst, Histogram):
            qs = inst.quantiles((0.5, 0.99))
            line.update(kind="histogram", value=inst.mean,
                        count=inst.count, p50=qs[0.5], p99=qs[0.99])
        elif isinstance(inst, Counter):
            line.update(kind="counter", value=inst.value)
        else:
            line.update(kind="gauge", value=inst.value)
        out.append(line)
    return out


def write_metrics_dump(path: str,
                       reg: Optional[MetricsRegistry] = None) -> str:
    with open(path, "w") as f:
        json.dump(metrics_dump(reg), f, indent=1)
    return path
