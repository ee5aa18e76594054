"""Health layer: is the system alive (counterpart of
``bigdl_tpu/observability/health.py``).

* **Stall watchdog**: long-running components (the serving batcher, the
  decode scheduler's loop, the router) register progress :class:`Beacon` s
  and ``pulse()`` them; one monitor thread fires ``health/stall`` once
  when a beacon is quiet past its deadline and ``health/stall_recovered``
  when progress resumes.
* **Anomaly detectors**: :class:`SeriesMonitor` flags spikes, plateaus and
  NaN streaks in a host scalar series.
* **Device-memory telemetry**: live gauges ``mem/device_live_bytes`` /
  ``mem/device_peak_bytes`` from ``torch.cuda.memory_stats()`` of every
  visible card; on the CPU there are none and the gauges are never
  registered.
* **Profiler windows**: ``BIGDL_TPU_PROFILE=start:stop`` arms a
  :class:`ProfilerWindow` that brackets a ``torch.profiler`` trace around
  that step range and writes it as a Chrome trace.

:func:`beacon` returns a shared no-op while observability is disabled.
"""
from __future__ import annotations

import logging
import math
import os
import tempfile
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from . import flight
from . import metrics as _metrics
from . import trace as _trace

__all__ = ["default_stall_deadline", "emit", "listen", "Beacon", "Watchdog",
           "watchdog", "beacon", "watchdog_threads_alive",
           "SeriesMonitor", "memory_stats_available",
           "sample_device_memory", "ensure_memory_telemetry",
           "ProfilerWindow", "profiler_window_from_env", "reset"]

_LOG = logging.getLogger("bigdl_tpu_torch.observability.health")

WATCHDOG_THREAD_NAME = "bigdl_tpu_torch-health-watchdog"

#: registered event listeners: each is called with the event dict
listeners: List[Callable[[Dict], None]] = []


def default_stall_deadline() -> float:
    """Seconds of beacon silence before a stall fires when the caller
    does not pass a deadline. ``BIGDL_TPU_STALL_S`` overrides (a slow
    remote compile can legitimately silence a loop for minutes);
    ``BIGDL_TPU_STALL_S=0`` disables the watchdog entirely
    (:func:`beacon` returns the no-op beacon for non-positive
    deadlines)."""
    try:
        return float(os.environ.get("BIGDL_TPU_STALL_S", "600"))
    except ValueError:
        return 600.0


def emit(kind: str, **fields) -> Dict:
    """One structured health event, fanned out to every sink: an
    ``health/<kind>`` instant span (visible on the trace timeline), a
    ``health/<kind>`` counter, a flight-recorder entry, and the
    registered :data:`listeners`. Returns the event dict (also when
    observability is disabled — unit tests inspect it; the sinks are
    only written when enabled)."""
    event = {"kind": f"health/{kind}"}
    event.update(fields)
    if _trace.enabled():
        _trace.instant(f"health/{kind}", **fields)
        _metrics.counter(f"health/{kind}").inc()
        flight.record(f"health/{kind}", **fields)
    for fn in list(listeners):
        try:
            fn(event)
        except Exception:  # a broken listener must not break the loop
            _LOG.exception("health listener failed for %s", event["kind"])
    return event


class listen:
    """Scoped health-event listener: ``with listen(fn):`` registers
    ``fn`` with :data:`listeners` for the block and ALWAYS unregisters
    on exit, so a finished consumer's hook never outlives it. For
    observing events fired by other components (the watchdog thread's
    ``health/stall``, a peer's ``health/straggler``) in tests and
    external supervisors; the in-process remediation policy gets its
    signals directly (the beacon's stall callback, the event lists
    ``SeriesMonitor.observe`` returns), not through listeners."""

    def __init__(self, fn: Callable[[Dict], None]):
        self._fn = fn

    def __enter__(self):
        listeners.append(self._fn)
        return self._fn

    def __exit__(self, exc_type, exc, tb):
        try:
            listeners.remove(self._fn)
        except ValueError:
            pass  # reset() cleared the registry mid-scope
        return False


# ---------------------------------------------------------------- watchdog

class Beacon:
    """One component's progress signal. ``pulse()`` is the hot-path
    call: a monotonic clock read and two attribute writes — no lock, no
    allocation (the watchdog thread reads the timestamp racily, which
    is fine: a torn read is at worst one check interval of slack)."""

    __slots__ = ("name", "deadline_s", "on_stall", "_last_pulse",
                 "_pulses", "_stalled", "_rearmed")

    def __init__(self, name: str, deadline_s: float,
                 on_stall: Optional[Callable[["Beacon", float], None]] = None):
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        self.name = name
        self.deadline_s = float(deadline_s)
        self.on_stall = on_stall
        self._last_pulse = time.monotonic()
        self._pulses = 0
        self._stalled = False
        self._rearmed = False

    def pulse(self):
        """Record progress (hot path — cheap and lock-free)."""
        self._last_pulse = time.monotonic()
        self._pulses += 1
        if self._stalled or self._rearmed:
            # close the episode: every health/stall (including re-armed
            # re-probes) pairs with exactly one stall_recovered
            self._stalled = self._rearmed = False
            emit("stall_recovered", component=self.name,
                 pulses=self._pulses)

    def rearm(self):
        """Reset the stall latch WITHOUT claiming progress: no pulse is
        counted, but the age clock restarts so the NEXT silent deadline
        emits a fresh ``health/stall`` (and re-runs ``on_stall``). For
        stall handlers that classified an episode as transient and must
        be called again if it persists — a wedged component will never
        pulse its own latch clear, and the monitor skips latched
        beacons. The episode stays OPEN: real progress later still
        emits the paired ``stall_recovered``."""
        self._last_pulse = time.monotonic()
        self._stalled = False
        self._rearmed = True

    @property
    def age_s(self) -> float:
        return time.monotonic() - self._last_pulse

    @property
    def pulses(self) -> int:
        return self._pulses

    @property
    def stalled(self) -> bool:
        return self._stalled

    def close(self):
        """Unregister from the watchdog (idempotent). A finished loop's
        beacon must not page on a run that simply ended."""
        _watchdog.unregister(self)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    def __repr__(self):
        return (f"Beacon({self.name!r}, deadline={self.deadline_s}s, "
                f"pulses={self._pulses}, stalled={self._stalled})")


class _NullBeacon:
    """Shared no-op beacon for the disabled path (mirrors trace's
    ``_NULL_SPAN`` pattern: hot loops keep the calls inline)."""

    __slots__ = ()
    name = "<null>"
    deadline_s = float("inf")
    age_s = 0.0
    pulses = 0
    stalled = False

    def pulse(self):
        return None

    def rearm(self):
        return None

    def close(self):
        return None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NULL_BEACON = _NullBeacon()


class Watchdog:
    """One monitor thread over every registered beacon. The check
    interval adapts to the tightest deadline (deadline/4, clamped to
    [20ms, 5s]) so a test's 200ms deadline and a production run's
    10-minute one are both detected within ~1.25x their deadline. The
    thread starts with the first beacon and exits when the last one
    closes — no idle daemon outlives a run."""

    def __init__(self):
        self._beacons: set = set()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._wake = threading.Event()

    def register(self, beacon: Beacon):
        with self._lock:
            self._beacons.add(beacon)
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name=WATCHDOG_THREAD_NAME, daemon=True)
                self._thread.start()
        self._wake.set()

    def unregister(self, beacon: Beacon):
        with self._lock:
            self._beacons.discard(beacon)
            drained = not self._beacons
        if drained:
            self._wake.set()  # exit promptly — don't sleep out the poll

    def beacons(self) -> List[Beacon]:
        with self._lock:
            return list(self._beacons)

    def poke(self):
        """Wake the monitor thread so it recomputes its check interval
        now — callers that TIGHTEN a live beacon's deadline (the step
        loop dropping its startup compile grace) use this so detection
        latency follows the new deadline, not the old poll cadence."""
        self._wake.set()

    def reset(self):
        """Drop every beacon (tests); the monitor thread then exits on
        its next wakeup."""
        with self._lock:
            self._beacons.clear()
        self._wake.set()

    def _run(self):
        while True:
            with self._lock:
                if not self._beacons:
                    self._thread = None
                    return
                beacons = list(self._beacons)
            interval = min(b.deadline_s for b in beacons) / 4.0
            interval = min(max(interval, 0.02), 5.0)
            for b in beacons:
                if b._stalled:
                    continue
                age = b.age_s
                if age > b.deadline_s:
                    b._stalled = True
                    emit("stall", component=b.name, age_s=round(age, 3),
                         deadline_s=b.deadline_s, pulses=b._pulses)
                    if b.on_stall is not None:
                        try:
                            b.on_stall(b, age)
                        except Exception:
                            _LOG.exception(
                                "on_stall callback failed for %s", b.name)
            self._wake.wait(interval)
            self._wake.clear()


_watchdog = Watchdog()


def watchdog() -> Watchdog:
    return _watchdog


def beacon(name: str, deadline_s: Optional[float] = None,
           on_stall: Optional[Callable] = None):
    """Register a progress beacon with the process watchdog. Returns
    the shared no-op beacon when observability is disabled — or when
    the effective deadline is non-positive (``BIGDL_TPU_STALL_S=0``,
    the documented watchdog off-switch) — so hot loops call
    ``beacon.pulse()`` unconditionally at zero cost."""
    if not _trace.enabled():
        return NULL_BEACON
    deadline = (deadline_s if deadline_s is not None
                else default_stall_deadline())
    if deadline <= 0:
        return NULL_BEACON
    b = Beacon(name, deadline, on_stall)
    _watchdog.register(b)
    return b


def watchdog_threads_alive() -> int:
    """Live watchdog monitor threads (tests assert 0 after shutdown)."""
    return sum(1 for t in threading.enumerate()
               if t.name == WATCHDOG_THREAD_NAME and t.is_alive())


# ------------------------------------------------------ anomaly detectors

class SeriesMonitor:
    """Rolling anomaly detector over an already-synced scalar series.

    Fed host floats the loop resolved anyway (loss via the sync policy,
    grad norm if a caller syncs one) — this class never touches a
    device array, so it adds no readbacks. Detection rules:

    * **NaN/Inf streak**: ``nan_streak`` consecutive non-finite values
      fire ``health/nan_streak`` once (re-armed by a finite value). A
      single NaN under ``nan_policy='skip'`` is routine; a streak means
      the run is diverging.
    * **Spike**: a finite value beyond ``mean + spike_sigma * std`` of
      the rolling window (after ``min_points`` observations) fires
      ``health/loss_spike`` — loss explosions and data poisoning both
      look like this.
    * **Plateau**: no relative improvement of at least ``plateau_rel``
      over the best value for ``plateau_window`` steps fires
      ``health/plateau`` — recurring, once per FULL stale window (a
      flat run keeps reporting every ``plateau_window`` steps; a new
      best resets the clock) — the signal an LR schedule or an
      early-stop/plateau-counting policy wants.

    Running mean/variance are maintained incrementally (O(1) per
    observation) over a bounded window, so a million-step run costs the
    same as a hundred-step one.
    """

    def __init__(self, name: str = "loss", window: int = 64,
                 spike_sigma: float = 8.0, min_points: int = 16,
                 plateau_window: int = 200, plateau_rel: float = 1e-3,
                 nan_streak: int = 3):
        if window < 2:
            raise ValueError(f"window must be >= 2, got {window}")
        self.name = name
        self.window = window
        self.spike_sigma = float(spike_sigma)
        self.min_points = max(2, int(min_points))
        self.plateau_window = int(plateau_window)
        self.plateau_rel = float(plateau_rel)
        self.nan_streak = int(nan_streak)
        self._vals: deque = deque(maxlen=window)
        self._sum = 0.0
        self._sumsq = 0.0
        self._streak = 0
        self._best = math.inf
        self._best_step: Optional[int] = None
        self._plateau_step = None  # step of the last plateau event

    def observe(self, value, step: int) -> List[Dict]:
        """Feed one already-resolved host scalar; returns the health
        events it fired (also emitted through :func:`emit`)."""
        events = []
        if not math.isfinite(value):
            self._streak += 1
            if self._streak == self.nan_streak:
                events.append(emit(
                    "nan_streak", monitor=self.name, step=step,
                    streak=self._streak))
            return events
        if self._streak:
            self._streak = 0
        n = len(self._vals)
        if n >= self.min_points:
            mean = self._sum / n
            var = max(self._sumsq / n - mean * mean, 0.0)
            std = math.sqrt(var)
            if std > 0.0 and value > mean + self.spike_sigma * std:
                events.append(emit(
                    f"{self.name}_spike", monitor=self.name, step=step,
                    value=value, mean=round(mean, 6), std=round(std, 6),
                    sigma=round((value - mean) / std, 2)))
        if (self._best_step is None
                or value < self._best - abs(self._best) * self.plateau_rel):
            self._best = value
            self._best_step = step
            self._plateau_step = None
        else:
            # recurring, one event per FULL stale window (never per
            # step): consumers that count plateaus — repeated LR cuts,
            # RemediationPolicy.early_stop_plateaus — need a flat run to
            # keep reporting, and a one-shot detector could never reach
            # a count of 2 without an improvement in between
            anchor = (self._plateau_step if self._plateau_step is not None
                      else self._best_step)
            if step - anchor >= self.plateau_window:
                self._plateau_step = step
                events.append(emit(
                    "plateau", monitor=self.name, step=step,
                    best=self._best, best_step=self._best_step,
                    stale_steps=step - self._best_step))
        if n == self._vals.maxlen:
            old = self._vals[0]
            self._sum -= old
            self._sumsq -= old * old
        self._vals.append(value)
        self._sum += value
        self._sumsq += value * value
        return events


# ------------------------------------------------- device-memory telemetry

_mem_available: Optional[bool] = None  # None = not probed yet


def _device_memory_stats():
    """Per-card ``{"bytes_in_use", "peak_bytes_in_use"}`` dicts from
    ``torch.cuda.memory_stats`` (the caching allocator's allocated bytes,
    current and peak) for every visible card, or None without one (the
    CPU, like jaxlib's CPU backend, reports none)."""
    import torch
    if not torch.cuda.is_available():
        return None
    out = []
    for i in range(torch.cuda.device_count()):
        try:
            st = torch.cuda.memory_stats(i)
        except Exception:
            return None
        out.append({"bytes_in_use": st.get("allocated_bytes.all.current", 0),
                    "peak_bytes_in_use": st.get("allocated_bytes.all.peak",
                                                0)})
    return out or None


def memory_stats_available() -> bool:
    """Probe once whether the backend reports device memory."""
    global _mem_available
    if _mem_available is None:
        try:
            _mem_available = _device_memory_stats() is not None
        except Exception:
            _mem_available = False
    return _mem_available


def sample_device_memory() -> Optional[Dict[str, float]]:
    """One aggregate sample across local devices:
    ``{"live_bytes", "peak_bytes", "devices"}`` — or None when the
    backend has no memory stats."""
    if not memory_stats_available():
        return None
    stats = _device_memory_stats()
    if stats is None:
        return None
    return {
        "live_bytes": float(sum(s.get("bytes_in_use", 0) for s in stats)),
        "peak_bytes": float(sum(
            s.get("peak_bytes_in_use", s.get("bytes_in_use", 0))
            for s in stats)),
        "devices": float(len(stats)),
    }


def ensure_memory_telemetry() -> bool:
    """Register ``mem/device_live_bytes`` / ``mem/device_peak_bytes``
    as LIVE gauges (computed at export-read time — an exporter scraping
    a hung loop still sees current HBM numbers). Returns whether the
    backend supports it; no gauges are registered when it does not, so
    dashboards never show a dead-zero memory row."""
    if not memory_stats_available():
        return False
    reg = _metrics.registry()
    if reg.get("mem/device_live_bytes") is not None:
        return True

    def live() -> float:
        s = sample_device_memory()
        return s["live_bytes"] if s else float("nan")

    def peak() -> float:
        s = sample_device_memory()
        return s["peak_bytes"] if s else float("nan")

    reg.gauge("mem/device_live_bytes", unit="bytes").set_fn(live)
    reg.gauge("mem/device_peak_bytes", unit="bytes").set_fn(peak)
    return True


# ------------------------------------------------------- profiler windows

class ProfilerWindow:
    """Bracket a ``torch.profiler`` trace (host and, on a card, CUDA
    activity) around a step range; the trace lands in ``out_dir`` as
    ``trace_<start>_<stop>.json`` (Chrome trace format).

    The optimizer ticks this once per step (host-side counter compare —
    no sync); the window starts the trace when ``step >= start_step``
    and stops it when ``step >= stop_step``, emitting
    ``health/profile_start`` / ``health/profile_stop`` instants with
    the step number so the device profile correlates to the span
    timeline. Profiler failures (missing plugin, unwritable dir) are
    logged once and disable the window — they never kill training."""

    def __init__(self, start_step: int, stop_step: int, out_dir: str):
        if stop_step <= start_step:
            raise ValueError(
                f"profiler window needs start < stop, got "
                f"{start_step}:{stop_step}")
        self.start_step = int(start_step)
        self.stop_step = int(stop_step)
        self.out_dir = out_dir
        self.active = False
        self.failed = False
        self.done = False
        self._prof = None

    def maybe_tick(self, step: int):
        """Hot-path tick: two int compares when idle. Ticks arrive at
        step-loop granularity — superstep fusion ticks only at
        superstep boundaries — so a window narrower than the tick
        stride can be jumped over entirely; that is reported loudly
        (warning + ``health/profile_skipped``), never silently."""
        if self.failed or self.done:
            return
        if not self.active:
            if step >= self.stop_step:
                self.done = True
                _LOG.warning(
                    "profiler window %d:%d skipped — the step counter "
                    "jumped to %d without entering it (window narrower "
                    "than the superstep/tick stride?)",
                    self.start_step, self.stop_step, step)
                emit("profile_skipped", step=step,
                     start_step=self.start_step, stop_step=self.stop_step)
            elif step >= self.start_step:
                self._start(step)
        elif step >= self.stop_step:
            self._stop(step)

    def _start(self, step: int):
        try:
            import torch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            os.makedirs(self.out_dir, exist_ok=True)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
        except Exception as e:
            self.failed = True
            _LOG.warning("profiler window disabled: start_trace failed: %s",
                         e)
            return
        self.active = True
        emit("profile_start", step=step, dir=self.out_dir,
             stop_step=self.stop_step)

    def _stop(self, step: int):
        try:
            self._prof.stop()
            self._prof.export_chrome_trace(os.path.join(
                self.out_dir,
                f"trace_{self.start_step}_{self.stop_step}.json"))
        except Exception as e:
            self.failed = True
            _LOG.warning("profiler window: stop_trace failed: %s", e)
            return
        finally:
            self.active = False
            self.done = True
            self._prof = None
        emit("profile_stop", step=step, dir=self.out_dir)

    def close(self):
        """Stop a still-open trace (run ended inside the window)."""
        if self.active:
            self._stop(self.stop_step)


def profiler_window_from_env(env=None) -> Optional[ProfilerWindow]:
    """Parse ``BIGDL_TPU_PROFILE=start:stop`` (global step numbers) and
    ``BIGDL_TPU_PROFILE_DIR`` (default ``bigdl_tpu_profile`` under the temp directory) into
    a :class:`ProfilerWindow`; None when unset or malformed (malformed
    specs log a warning rather than killing the run)."""
    env = env if env is not None else os.environ
    spec = env.get("BIGDL_TPU_PROFILE")
    if not spec:
        return None
    try:
        start_s, stop_s = spec.split(":", 1)
        window = ProfilerWindow(
            int(start_s), int(stop_s),
            env.get("BIGDL_TPU_PROFILE_DIR", os.path.join(
                tempfile.gettempdir(), "bigdl_tpu_profile")))
    except (ValueError, TypeError) as e:
        _LOG.warning("ignoring malformed BIGDL_TPU_PROFILE=%r (%s); "
                     "expected start:stop step numbers", spec, e)
        return None
    return window


def reset():
    """Test hook: drop every beacon (stops the watchdog thread), clear
    listeners, and forget the memory-stats probe."""
    global _mem_available
    _watchdog.reset()
    del listeners[:]
    _mem_available = None
