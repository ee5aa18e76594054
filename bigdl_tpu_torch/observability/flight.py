"""Flight recorder: a bounded ring of recent structured events, dumped as a
JSON crash bundle on unhandled failure (counterpart of
``bigdl_tpu/observability/flight.py``).

Bundle schema (``schema`` = ``bigdl_tpu.flight_bundle.v1``, shared with
the JAX package so one report tool reads both)::

    {"schema", "written_at", "written_at_iso", "pid",
     "error": {"type", "message", "traceback"} | null,
     "context": {...}, "events": [...], "metrics": {...},
     "spans": [...], "programs": [...],
     "env": {"torch", "cuda", "device", "devices", "process_index"}}

Disabled observability means a disabled recorder: :func:`record` returns
after one flag read. :func:`dump_crash_bundle` never raises.
"""
from __future__ import annotations

import datetime
import json
import logging
import math
import os
import tempfile
import threading
import time
import traceback as _traceback
from collections import deque
from typing import Dict, List, Optional

from . import metrics as _metrics
from . import trace as _trace

__all__ = ["FlightRecorder", "recorder", "record", "reset", "crash_bundle",
           "bundle_dir", "dump_crash_bundle", "aggregate_bundles"]

_LOG = logging.getLogger("bigdl_tpu_torch.observability.flight")

SCHEMA = "bigdl_tpu.flight_bundle.v1"

#: spans included in a bundle (the TAIL of the trace — most recent)
BUNDLE_SPAN_TAIL = 64


class FlightRecorder:
    """Fixed-capacity ring of structured events (thread-safe)."""

    def __init__(self, capacity: int = 512):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._total = 0

    def record(self, kind: str, **fields):
        """Append one event (hot path: gated on the observability flag
        BEFORE building the dict — disabled cost is one flag read)."""
        if not _trace.enabled():
            return
        ev = {"t": time.time(), "kind": kind}
        ev.update(fields)
        with self._lock:
            self._ring.append(ev)
            self._total += 1

    def events(self) -> List[Dict]:
        with self._lock:
            return list(self._ring)

    @property
    def total_recorded(self) -> int:
        """Events ever recorded (>= len(events()) once the ring wraps)."""
        with self._lock:
            return self._total

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._total = 0


_recorder = FlightRecorder()


def recorder() -> FlightRecorder:
    return _recorder


def record(kind: str, **fields):
    """Module-level hot-path entry: append to the process recorder."""
    _recorder.record(kind, **fields)


def reset():
    _recorder.clear()


def _env_info() -> Dict:
    try:
        import torch
        from .cluster import _process_index
        cuda = torch.cuda.is_available()
        return {"torch": torch.__version__,
                "cuda": torch.version.cuda,
                "device": torch.cuda.get_device_name(0) if cuda else "cpu",
                "devices": torch.cuda.device_count() if cuda else 0,
                "process_index": _process_index()}
    except Exception as e:  # post-mortem must work on a wedged device
        return {"error": f"{type(e).__name__}: {e}"}


def _span_tail(n: int = BUNDLE_SPAN_TAIL) -> List[Dict]:
    tracer = _trace.get_tracer()
    epoch = tracer.epoch_ns
    out = []
    for sp in tracer.events()[-n:]:
        ev = {"name": sp.name,
              "start_us": max(0.0, (sp.start_ns - epoch) / 1e3),
              "dur_us": sp.duration_ns / 1e3,
              "tid": sp.tid}
        if sp.args:
            ev["args"] = dict(sp.args)
        out.append(ev)
    return out


def crash_bundle(error: Optional[BaseException] = None,
                 context: Optional[Dict] = None) -> Dict:
    """Assemble the post-mortem dict (see module docstring for the
    schema). Pure snapshot — no file IO; :func:`dump_crash_bundle`
    writes it."""
    err = None
    if error is not None:
        err = {"type": type(error).__name__,
               "message": str(error),
               "traceback": "".join(_traceback.format_exception(
                   type(error), error, error.__traceback__))}
    now = time.time()
    return {
        "schema": SCHEMA,
        "written_at": now,
        "written_at_iso": datetime.datetime.fromtimestamp(
            now, datetime.timezone.utc).isoformat(),
        "pid": os.getpid(),
        "error": err,
        "context": dict(context or {}),
        "events": _recorder.events(),
        "metrics": _metrics.registry().snapshot(),
        "spans": _span_tail(),
        "programs": _programs(),
        "env": _env_info(),
    }


def _programs():
    """The program cost notes (``perf``'s artifacts) for a bundle."""
    from . import perf as _perf
    return _perf.artifacts_snapshot()


def bundle_dir() -> str:
    """Where bundles land: ``BIGDL_TPU_FLIGHT_DIR`` or a per-user temp
    subdirectory (never the CWD — a crash must not litter a checkout)."""
    return (os.environ.get("BIGDL_TPU_FLIGHT_DIR")
            or os.path.join(tempfile.gettempdir(), "bigdl_tpu_flight"))


def _json_safe(obj):
    """Recursively replace non-finite floats with their string names.
    A NaN post-mortem is the recorder's headline use case, and
    ``json.dump``'s default emits bare ``NaN``/``Infinity`` tokens —
    Python reads those back but jq / JSON.parse / strict parsers reject
    the whole bundle, which is exactly where a REMOTE bundle gets
    inspected."""
    if isinstance(obj, float):
        if math.isfinite(obj):
            return obj
        return "NaN" if obj != obj else \
            ("Infinity" if obj > 0 else "-Infinity")
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    return obj


def dump_crash_bundle(error: Optional[BaseException] = None,
                      context: Optional[Dict] = None,
                      path: Optional[str] = None) -> Optional[str]:
    """Write the crash bundle as strict JSON (atomic tmp+rename) and
    return its path. NEVER raises — the post-mortem writer must not
    mask the crash it is documenting (failures are logged and return
    None)."""
    try:
        bundle = _json_safe(crash_bundle(error, context))
        if path is None:
            d = bundle_dir()
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"flight_{os.getpid()}_{int(time.time() * 1000)}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            # default=str: span args / context may carry numpy scalars,
            # shapes, device reprs — a post-mortem keeps them as text
            # rather than refusing to serialize. allow_nan=False backs
            # the strict-JSON guarantee (_json_safe already replaced
            # every non-finite float this module produces).
            json.dump(bundle, f, indent=1, default=str, allow_nan=False)
        os.replace(tmp, path)
        _LOG.warning("crash bundle written: %s (%d events)", path,
                     len(bundle["events"]))
        return path
    except Exception:
        _LOG.exception("failed to write crash bundle")
        return None


AGGREGATE_SCHEMA = "bigdl_tpu.flight_aggregate.v1"


def aggregate_bundles(directory: Optional[str] = None,
                      out: Optional[str] = None) -> Optional[str]:
    """Merge every per-process crash bundle under ``directory`` (default
    :func:`bundle_dir`) into ONE rank-0 post-mortem artifact and return
    its path. In a multi-host failure each process dumps its own bundle
    into the (shared) flight dir; the elastic restarter calls this on
    process 0 before resuming, so the operator triages a single file —
    bundles sorted by (process_index, written_at), the newest error per
    process surfaced in a ``summary`` header. Never raises; returns
    None when there is nothing to aggregate. Each aggregate covers only
    bundles NEWER than the previous aggregate (and aggregates of
    aggregates are skipped): repeated elastic restarts on a shared
    flight dir each get a post-mortem of THEIR failure, not an
    ever-growing re-embedding of every failure before it."""
    try:
        d = directory or bundle_dir()
        if not os.path.isdir(d):
            return None
        last_agg = 0.0  # watermark: newest existing aggregate
        for name in os.listdir(d):
            if name.startswith("flight_aggregate") and \
                    name.endswith(".json"):
                try:
                    last_agg = max(last_agg, float(
                        name.rsplit("_", 1)[1].split(".")[0]) / 1000.0)
                except (IndexError, ValueError):
                    pass
        bundles = []
        for name in sorted(os.listdir(d)):
            if not (name.startswith("flight_") and name.endswith(".json")) \
                    or name.startswith("flight_aggregate"):
                continue
            try:
                with open(os.path.join(d, name)) as f:
                    b = json.load(f)
            except Exception:
                continue  # half-written by a dying peer — skip, don't die
            if b.get("written_at", 0) <= last_agg:
                continue  # already folded into an earlier post-mortem
            if b.get("schema", "").startswith("bigdl_tpu.flight_bundle"):
                b["bundle_file"] = name
                bundles.append(b)
        if not bundles:
            return None
        bundles.sort(key=lambda b: (b.get("env", {}).get("process_index", 0),
                                    b.get("written_at", 0)))
        summary = []
        for b in bundles:
            err = b.get("error") or {}
            summary.append({
                "process_index": b.get("env", {}).get("process_index"),
                "pid": b.get("pid"),
                "bundle_file": b.get("bundle_file"),
                "error_type": err.get("type"),
                "error_message": err.get("message"),
                "context": b.get("context", {}),
            })
        now = time.time()
        agg = {"schema": AGGREGATE_SCHEMA, "written_at": now,
               "written_at_iso": datetime.datetime.fromtimestamp(
                   now, datetime.timezone.utc).isoformat(),
               "n_bundles": len(bundles), "summary": summary,
               "bundles": bundles}
        if out is None:
            out = os.path.join(d, f"flight_aggregate_{int(now * 1000)}.json")
        tmp = out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(_json_safe(agg), f, indent=1, default=str,
                      allow_nan=False)
        os.replace(tmp, out)
        _LOG.warning("aggregated %d crash bundles into %s",
                     len(bundles), out)
        return out
    except Exception:
        _LOG.exception("failed to aggregate crash bundles")
        return None
