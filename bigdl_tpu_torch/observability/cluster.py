"""Cluster-wide metric aggregation (counterpart of
``bigdl_tpu/observability/cluster.py``).

Each process snapshots its metrics registry into the flight-bundle
directory (one file a process, overwritten by atomic rename) and rank 0
merges the files into one view: per-host step-time skew, straggler
attribution and a merged Prometheus export. Cadence comes from
``BIGDL_TPU_METRIC_SNAP_S`` (seconds; unset or 0 disables) or an explicit
``every_s``. The process index is ``torch.distributed``'s rank when a
process group is up, else 0.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, List, Optional

from . import metrics as _metrics
from . import trace as _trace
from . import flight as _flight

__all__ = ["snapshot_interval_from_env", "snapshot_path",
           "MetricSnapshotWriter", "read_snapshots", "aggregate",
           "write_aggregate", "latest_aggregate",
           "prometheus_cluster_text", "default_writer", "enabled"]

_LOG = logging.getLogger("bigdl_tpu_torch.observability.cluster")

SNAPSHOT_SCHEMA = "bigdl_tpu.metric_snapshot.v1"
CLUSTER_SCHEMA = "bigdl_tpu.cluster_view.v1"

#: a process whose mean step time exceeds the cluster median by this
#: factor is attributed as a straggler in the merged view
STRAGGLER_RATIO = 1.5

#: a straggler whose heartbeat age exceeds this is flagged as dying
#: rather than merely slow (joins the ``parallel/failure`` signal)
STALE_HEARTBEAT_S = 30.0


def snapshot_interval_from_env() -> float:
    """``BIGDL_TPU_METRIC_SNAP_S`` as a float; 0.0 (disabled) on unset
    or unparsable."""
    raw = os.environ.get("BIGDL_TPU_METRIC_SNAP_S", "")
    try:
        v = float(raw) if raw else 0.0
    except ValueError:
        _LOG.warning("ignoring unparsable BIGDL_TPU_METRIC_SNAP_S=%r", raw)
        return 0.0
    return max(0.0, v)


def _process_index() -> int:
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
    except Exception:  # noqa: BLE001 - a broken group reads as rank 0
        pass
    return 0


def snapshot_path(directory: Optional[str] = None,
                  process_index: Optional[int] = None) -> str:
    d = directory or _flight.bundle_dir()
    idx = _process_index() if process_index is None else int(process_index)
    return os.path.join(d, f"metrics_p{idx:05d}.json")


class MetricSnapshotWriter:
    """Periodic per-process metric snapshots (one overwritten file).

    ``maybe_write(step=...)`` is the hot-loop entry: one monotonic
    clock read when the cadence has not elapsed, an atomic JSON write
    when it has. Hot loops call it obs-gated; a zero/negative interval
    makes every call a no-op (the disabled configuration costs one
    comparison)."""

    def __init__(self, every_s: Optional[float] = None,
                 directory: Optional[str] = None,
                 process_index: Optional[int] = None):
        self.every_s = snapshot_interval_from_env() \
            if every_s is None else float(every_s)
        self._dir = directory or _flight.bundle_dir()
        self._idx = _process_index() if process_index is None \
            else int(process_index)
        self._last = 0.0
        self.writes = 0
        self._sections: Dict[str, object] = {}

    def add_section(self, name: str, fn) -> None:
        """Attach a named extra section to every snapshot this writer
        produces: ``fn()`` is called per write and its dict lands in the
        doc under ``name`` (the serving fleet agent publishes its
        queue-depth/inflight/prefix-summary/active-version section this
        way — the router's remote load/health signal rides the SAME
        files the cluster merge already reads). A raising provider is
        skipped for that write — telemetry never takes down the run."""
        if name in ("schema", "written_at", "pid", "process_index",
                    "step", "metrics", "final", "snapshot_file"):
            raise ValueError(f"section name {name!r} collides with a "
                             "core snapshot field")
        self._sections[name] = fn

    @property
    def enabled(self) -> bool:
        return self.every_s > 0

    def maybe_write(self, step: Optional[int] = None,
                    force: bool = False) -> Optional[str]:
        if not force:
            if self.every_s <= 0:
                return None
            now = time.monotonic()
            if now - self._last < self.every_s:
                return None
            self._last = now
        return self.write(step=step)

    def write(self, step: Optional[int] = None,
              final: bool = False) -> Optional[str]:
        """Unconditional snapshot write (atomic tmp+rename). Never
        raises — telemetry must not take down the run. ``final=True``
        is the TERMINAL write a cleanly-exiting process lands: the
        merge then knows this process FINISHED — its snapshot going
        stale afterwards is retirement, not a wedge — and the
        straggler/suspect-dead attribution skips it (a finished process
        used to read exactly like a dead one)."""
        try:
            os.makedirs(self._dir, exist_ok=True)
            path = snapshot_path(self._dir, self._idx)
            doc = {
                "schema": SNAPSHOT_SCHEMA,
                "written_at": time.time(),
                "pid": os.getpid(),
                "process_index": self._idx,
                "step": step,
                "final": bool(final),
                "metrics": _metrics.registry().snapshot(),
            }
            for name, fn in self._sections.items():
                try:
                    doc[name] = fn()
                except Exception:  # noqa: BLE001 — telemetry only
                    _LOG.exception("snapshot section %r failed", name)
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(_flight._json_safe(doc), f, default=str,
                          allow_nan=False)
            os.replace(tmp, path)
            self.writes += 1
            return path
        except Exception:  # noqa: BLE001
            _LOG.exception("metric snapshot write failed")
            return None


def read_snapshots(directory: Optional[str] = None) -> List[Dict]:
    """Every per-process snapshot under ``directory``, sorted by
    process index. Half-written or foreign files are skipped, exactly
    like the crash-bundle aggregator."""
    d = directory or _flight.bundle_dir()
    if not os.path.isdir(d):
        return []
    out = []
    for name in sorted(os.listdir(d)):
        if not (name.startswith("metrics_p") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(d, name)) as f:
                doc = json.load(f)
        except Exception:  # noqa: BLE001 — a dying peer's torn write
            continue
        if doc.get("schema") != SNAPSHOT_SCHEMA:
            continue
        doc["snapshot_file"] = name
        out.append(doc)
    out.sort(key=lambda s: s.get("process_index", 0))
    return out


def _metric_value(snap: Dict, name: str):
    m = snap.get("metrics", {}).get(name)
    if not isinstance(m, dict):
        return None
    if m.get("type") == "histogram":
        return m.get("mean")
    v = m.get("value")
    return v if isinstance(v, (int, float)) else None


#: fleet-tier latency histograms surfaced in the merged view : the
#: fleet tier's KV-handoff wall time in the disaggregated pool and
#: controller spawn-to-register launch latency
FLEET_HISTOGRAMS = ("serve/fleet_handoff_ms", "serve/fleet_spawn_ms")


def _merge_fleet_histograms(snaps: List[Dict]) -> Dict[str, Dict]:
    """Cross-process merge of the fleet latency histograms: counts sum,
    means combine count-weighted, max is the max, and the merged "p99"
    is the worst per-process p99 (conservative — true cross-process
    quantiles would need the raw samples, which snapshots drop)."""
    out: Dict[str, Dict] = {}
    for name in FLEET_HISTOGRAMS:
        count = 0
        total = 0.0
        mx = None
        p99 = None
        for s in snaps:
            m = s.get("metrics", {}).get(name)
            if not isinstance(m, dict) or m.get("type") != "histogram":
                continue
            c = m.get("count") or 0
            if not c:
                continue
            count += c
            total += m.get("sum") or 0.0
            if isinstance(m.get("max"), (int, float)):
                mx = m["max"] if mx is None else max(mx, m["max"])
            q = (m.get("quantiles") or {}).get("0.99")
            if isinstance(q, (int, float)):
                p99 = q if p99 is None else max(p99, q)
        if count:
            out[name] = {"count": count, "mean": total / count,
                         "max": mx, "p99_worst_proc": p99}
    return out


def aggregate(directory: Optional[str] = None,
              now: Optional[float] = None) -> Optional[Dict]:
    """Merge the per-process snapshots into one cluster view:

    * per-process rows — step, mean step time, throughput, heartbeat
      age, snapshot age; a serving-fleet process's row also carries a
      trimmed ``serving`` summary (role, queue depth, inflight, active
      version) from the section its agent publishes;
    * **step-time skew** — slowest/median mean-step-time ratio across
      processes (the number that says the mesh is dragging);
    * **straggler attribution** — processes above
      ``STRAGGLER_RATIO`` × median, each joined with its heartbeat age
      (a straggler whose heartbeat is ALSO stale is dying, not slow);
    * a ``fleet`` section when any process recorded the fleet latency
      histograms (KV handoff, elastic spawn).

    Returns None when there is nothing to merge."""
    snaps = read_snapshots(directory)
    if not snaps:
        return None
    now = time.time() if now is None else now
    rows = []
    for s in snaps:
        step_time = _metric_value(s, "optim/step_time")
        hb_age = _metric_value(s, "failure/last_beat_age_s")
        row = {
            "process_index": s.get("process_index", 0),
            "pid": s.get("pid"),
            "step": s.get("step"),
            "step_time_mean_s": step_time,
            "throughput": _metric_value(s, "optim/throughput"),
            "heartbeat_age_s": hb_age,
            "snapshot_age_s": round(max(0.0, now - s.get("written_at", now)),
                                    3),
            "snapshot_file": s.get("snapshot_file"),
            "final": bool(s.get("final", False)),
        }
        serving = s.get("serving")
        if isinstance(serving, dict):
            row["serving"] = {
                k: serving.get(k) for k in
                ("role", "queue_depth", "inflight", "pending",
                 "active_version")
                if serving.get(k) is not None}
        rows.append(row)
    # finished (final:true) processes are retired, not slow: their
    # frozen means must not distort the LIVE cluster's median/skew
    # either — several fast finishers dragging the median down would
    # falsely push a healthy live process over the straggler ratio
    times = sorted(r["step_time_mean_s"] for r in rows
                   if not r["final"]
                   and isinstance(r["step_time_mean_s"], (int, float))
                   and r["step_time_mean_s"] > 0)
    skew = None
    median = None
    stragglers = []
    if times:
        import statistics
        median = statistics.median(times)
        slowest = times[-1]
        skew = slowest / median if median > 0 else None
        for r in rows:
            if r["final"]:
                # a cleanly-finished process (terminal final:true
                # snapshot) is retired, not slow: its frozen mean and
                # ever-growing heartbeat age would otherwise read as a
                # suspect-dead straggler forever
                continue
            st = r["step_time_mean_s"]
            if isinstance(st, (int, float)) and median > 0 and \
                    st > STRAGGLER_RATIO * median:
                stragglers.append({
                    "process_index": r["process_index"],
                    "step_time_mean_s": st,
                    "vs_median": round(st / median, 3),
                    "heartbeat_age_s": r["heartbeat_age_s"],
                    "suspect_dead": isinstance(
                        r["heartbeat_age_s"], (int, float))
                    and r["heartbeat_age_s"] > STALE_HEARTBEAT_S,
                })
    view = {
        "schema": CLUSTER_SCHEMA,
        "written_at": now,
        "n_processes": len(rows),
        "step_time_median_s": median,
        "step_time_skew": round(skew, 4) if skew is not None else None,
        "stragglers": stragglers,
        "processes": rows,
    }
    fleet = _merge_fleet_histograms(snaps)
    if fleet:
        view["fleet"] = fleet
    return view


def write_aggregate(directory: Optional[str] = None,
                    out: Optional[str] = None,
                    context: Optional[Dict] = None) -> Optional[str]:
    """Rank-0 merge artifact: write the cluster view (atomic), mirror
    the headline numbers into the local registry
    (``cluster/step_time_skew``, ``cluster/stragglers``,
    ``cluster/processes``) and return the path. Never raises; None when
    there is nothing to merge."""
    try:
        view = aggregate(directory)
        if view is None:
            return None
        if context:
            view["context"] = dict(context)
        reg = _metrics.registry()
        if view["step_time_skew"] is not None:
            reg.gauge("cluster/step_time_skew").set(view["step_time_skew"])
        reg.gauge("cluster/stragglers").set(len(view["stragglers"]))
        reg.gauge("cluster/processes").set(view["n_processes"])
        d = directory or _flight.bundle_dir()
        if out is None:
            out = os.path.join(
                d, f"cluster_view_{int(view['written_at'] * 1000)}.json")
        tmp = out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(_flight._json_safe(view), f, indent=1, default=str,
                      allow_nan=False)
        os.replace(tmp, out)
        return out
    except Exception:  # noqa: BLE001
        _LOG.exception("cluster aggregate failed")
        return None


def latest_aggregate(directory: Optional[str] = None) -> Optional[str]:
    d = directory or _flight.bundle_dir()
    if not os.path.isdir(d):
        return None
    views = [os.path.join(d, f) for f in os.listdir(d)
             if f.startswith("cluster_view_") and f.endswith(".json")]
    return max(views, key=os.path.getmtime) if views else None


def prometheus_cluster_text(view: Dict, prefix: str = "bigdl_cluster") \
        -> str:
    """The merged view in Prometheus text exposition format, one series
    per process labelled ``{process="<idx>"}`` — the fleet dashboard's
    scrape target."""
    lines = [f"# HELP {prefix}_step_time_mean_s per-process mean step "
             f"time (s)",
             f"# TYPE {prefix}_step_time_mean_s gauge"]
    for r in view.get("processes", []):
        idx = r.get("process_index", 0)
        for key, metric in (("step_time_mean_s", "step_time_mean_s"),
                            ("throughput", "throughput"),
                            ("heartbeat_age_s", "heartbeat_age_s"),
                            ("snapshot_age_s", "snapshot_age_s")):
            v = r.get(key)
            if isinstance(v, (int, float)):
                lines.append(
                    f'{prefix}_{metric}{{process="{idx}"}} {float(v)!r}')
    skew = view.get("step_time_skew")
    if isinstance(skew, (int, float)):
        lines.append(f"{prefix}_step_time_skew {float(skew)!r}")
    lines.append(f"{prefix}_stragglers "
                 f"{float(len(view.get('stragglers', [])))!r}")
    lines.append(f"{prefix}_processes "
                 f"{float(view.get('n_processes', 0))!r}")
    return "\n".join(lines) + "\n"


def default_writer() -> MetricSnapshotWriter:
    """A writer on the env-configured cadence — what the optimizer and
    serving hot loops tick (no-op unless ``BIGDL_TPU_METRIC_SNAP_S`` is
    set)."""
    return MetricSnapshotWriter()


# re-exported convenience for hot-loop call sites
def enabled() -> bool:
    return _trace.enabled()
