"""SLO-aware router: N serving replicas behind priority-class queues
(counterpart of ``bigdl_tpu/serving/router.py``).

* **Priority classes with weighted-fair queuing**: each
  :class:`PriorityClass` owns a bounded queue and a weight; the dispatch
  loop runs deficit round-robin over the classes (an idle class costs
  nothing).
* **Deadline-aware dispatch**: a request with a deadline goes to the
  least-loaded healthy replica, deadline-less ones round-robin; a request
  whose deadline is already unmeetable at ``submit()`` (expired, or under
  the class's observed service-time EWMA) fails at admission, typed
  :class:`DeadlineExceeded` (``doomed``).
* **Health-driven drain, failover and rejoin**: every replica registers a
  named stall-watchdog beacon; the router listens on
  ``observability.health.listeners`` for that beacon's ``health/stall``,
  drains the replica and re-dispatches its in-flight requests onto the
  survivors; the replica rejoins on ``health/stall_recovered``.
  ``EngineStopped`` from a replica takes the same failover path, and a
  dying decode scheduler's generated tokens (``exc.partial``) are spliced
  into the re-dispatched request.
* **Prefix affinity**: for replicas with a prefix cache
  (``cached_prefix_tokens``), dispatch prefers the replica holding the
  longest cached prefix of the prompt, unless it is deeper than the
  least-loaded one by more than ``affinity_slack``.
* **Fleet hot swap** (:meth:`Router.swap`): two-phase, publish on every
  replica, then activate everywhere; ``add_replica`` / ``remove_replica``
  change the membership of a running router.

The ``router/dispatch`` chaos site fires at each replica submit, tagged
with the replica's name. In the port every replica (a ``ServingEngine``
or a ``DecodeScheduler``) serves on the one card.
"""
from __future__ import annotations

import itertools
import re
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import observability as obs
from ..observability import cluster as _cluster
from ..observability import flight as _flight
from ..observability import health as _health
from ..parallel import chaos as _chaos
from ..parallel.failure import TRANSIENT, classify_failure
from .batching import (DeadlineExceeded, EngineStopped, QueueFull,
                       ServeFuture)

__all__ = ["PriorityClass", "Router", "router_threads_alive"]

THREAD_NAME = "bigdl_tpu_torch-serving-router"

_STAT_KEYS = ("submitted", "completed", "rejected", "doomed", "dispatches",
              "failovers", "drains", "rejoins", "deadline_misses",
              "replica_full", "affinity_hits", "affinity_bypassed",
              "kv_recoveries", "dispatch_retries", "joins", "retires")

#: per-request cap on transient-classified submit failures: a transport
#: that keeps presenting as transient is not transient — past this the
#: request fails typed instead of park-and-retrying forever
_MAX_DISPATCH_RETRIES = 32


def _metric_cls(name: str) -> str:
    """Class name → metric-name fragment (prometheus-safe)."""
    return re.sub(r"\W", "_", name)


class PriorityClass:
    """One latency tier: a bounded queue with a weighted-fair share.

    weight : deficit-round-robin share under contention (an idle class
        consumes nothing — work-conserving).
    default_deadline_ms : applied when ``submit`` passes none; None
        means requests of this class run deadline-less (routed
        round-robin, never doomed).
    max_queue : router-side admission bound for this class (typed
        :class:`QueueFull` past it) — one class flooding cannot starve
        another's admission.
    depth_limit : max outstanding requests of THIS class per replica
        (None = bounded only by the replica's own queue). The
        head-of-line lever for mixed tiers: a deep bulk backlog
        dispatched freely would stuff every replica's FIFO ahead of
        each arriving tight request — capping bulk at a shallow depth
        (2 keeps replicas pipelined) leaves the replica queues nearly
        empty for the tight tier, which is what bounds tight latency
        to ~2 batch cycles under full bulk overload.
    replica_tags : class→replica affinity for heterogeneous fleets: when
        set, requests of this class dispatch ONLY to replicas whose
        ``tags`` (``DecodeScheduler(tags=...)`` /
        ``ServingEngine(tags=...)`` / a fleet member's membership tags)
        intersect this set — e.g. bulk traffic pinned to
        int8-published replicas while tight traffic rides the f32
        fleet. Composes with least-loaded/deadline placement,
        prefix-affinity, and ``depth_limit`` (all operate on the
        tag-filtered candidate set); ``None`` keeps the class
        fleet-wide. The router validates at construction that at least
        one replica carries each demanded tag set.
    """

    def __init__(self, name: str, weight: int = 1,
                 default_deadline_ms: Optional[float] = None,
                 max_queue: int = 1024,
                 depth_limit: Optional[int] = None,
                 replica_tags: Optional[Sequence[str]] = None):
        if weight < 1:
            raise ValueError(f"weight must be >= 1, got {weight}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if depth_limit is not None and depth_limit < 1:
            raise ValueError(f"depth_limit must be >= 1, got {depth_limit}")
        if replica_tags is not None and not replica_tags:
            raise ValueError("replica_tags must name at least one tag "
                             "(None means any replica)")
        self.name = name
        self.weight = int(weight)
        self.default_deadline_ms = default_deadline_ms
        self.max_queue = int(max_queue)
        self.depth_limit = depth_limit
        self.replica_tags = (frozenset(replica_tags)
                             if replica_tags is not None else None)

    def __repr__(self):
        return (f"PriorityClass({self.name!r}, weight={self.weight}, "
                f"deadline={self.default_deadline_ms})")


class _ClassQueue:
    __slots__ = ("cls", "q", "deficit", "ewma_ms")

    def __init__(self, cls: PriorityClass):
        self.cls = cls
        self.q: deque = deque()
        self.deficit = 0.0
        # the ADMISSION estimate the doomed check reads: the best
        # (minimum) per-replica service-time EWMA across currently
        # HEALTHY replicas — kept per replica (``_Replica.ewma_ms``)
        # and re-derived on drain/rejoin, so a recovered replica's
        # pre-stall latencies can never doom tight requests
        self.ewma_ms: Optional[float] = None


class _RouterRequest:
    __slots__ = ("payload", "kw", "klass", "future", "rid", "deadline",
                 "t_enqueue", "t_enqueue_ns", "t_dispatch_ns", "failovers",
                 "epoch", "recovered", "dispatch_retries")

    def __init__(self, payload, kw, klass, rid,
                 deadline_s: Optional[float]):
        self.payload = payload
        self.kw = kw
        # tokens a dying replica already decoded for this request
        # (KV-preserving failover splices them into the payload and the
        # final result — see Router._recover_decode)
        self.recovered: Optional[np.ndarray] = None
        self.klass = klass
        self.future = ServeFuture()
        self.future.rid = rid
        self.rid = rid
        self.t_enqueue = time.monotonic()
        self.t_enqueue_ns = time.perf_counter_ns()
        self.t_dispatch_ns = None
        self.deadline = (self.t_enqueue + deadline_s
                         if deadline_s is not None else None)
        self.failovers = 0
        self.dispatch_retries = 0
        # dispatch epoch: bumped on every failover so a LATE resolution
        # of an abandoned inner future (a drained replica finishing or
        # dying after its work was re-routed) is recognizably stale and
        # cannot fail the request over a second time
        self.epoch = 0

    def remaining_ms(self, now: Optional[float] = None) -> Optional[float]:
        if self.deadline is None:
            return None
        return (self.deadline - (now or time.monotonic())) * 1000.0

    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline is not None
                and (now or time.monotonic()) > self.deadline)


class _Replica:
    __slots__ = ("engine", "name", "healthy", "dead", "inflight",
                 "by_class", "ewma_ms", "tags")

    def __init__(self, engine, name: str):
        self.engine = engine
        self.name = name
        self.tags = frozenset(getattr(engine, "tags", ()) or ())
        self.healthy = True
        self.dead = False            # EngineStopped — no rejoin possible
        self.inflight: set = set()   # _RouterRequest currently submitted
        self.by_class: Dict[str, int] = {}   # outstanding per class
        self.ewma_ms: Dict[str, float] = {}  # per-class service time

    @property
    def beacon_name(self) -> str:
        return getattr(self.engine, "beacon_name", "")


class Router:
    """Deadline- and health-aware dispatch over N engine replicas.

    Parameters
    ----------
    replicas : engine objects (``ServingEngine`` / ``DecodeScheduler`` /
        anything with ``submit(payload, deadline_ms=..., **kw)`` →
        future plus ``start/shutdown/swap``). Give each a distinct
        ``name=`` at construction — that names its watchdog beacon,
        which is what the router's per-replica health integration keys
        on.
    classes : :class:`PriorityClass` list (default: one ``"default"``
        class, weight 1 — plain least-loaded/round-robin routing).
    max_failovers : re-dispatch budget per request (a request bouncing
        across dying replicas must eventually fail, not loop).
    fail_fast_factor : a deadline-carrying request is DOOMED at
        admission when its remaining budget is under ``factor`` × the
        class's observed service-time EWMA (0 disables the estimate —
        only already-expired deadlines fail fast).
    manage_replicas : ``start()``/``shutdown()`` cascade to the
        replicas (the common ownership); False when the caller runs
        their lifecycle.
    prefix_affinity : KV-cache-aware placement (on by default; a no-op
        unless a replica exposes ``cached_prefix_tokens`` — i.e. a
        :class:`~.decode_scheduler.DecodeScheduler` with its prefix
        cache enabled). Dispatch probes each healthy replica's
        prefix-cache summary for the prompt and prefers the replica
        already holding the LONGEST cached prefix: the hit skips that
        prefix's prefill there, where any other placement re-pays it.
        Affinity is bounded by ``affinity_slack``: a cache-holder whose
        in-flight depth exceeds the least-loaded healthy replica's by
        more than the slack is bypassed (counted), so affinity never
        starves the deadline/least-loaded machinery — a hot prefix
        cannot capsize one replica while others idle.
    affinity_slack : max extra in-flight requests a prefix-affine
        replica may carry over the least-loaded one before affinity
        yields to load balance.
    """

    def __init__(self, replicas: Sequence, *,
                 classes: Optional[Sequence[PriorityClass]] = None,
                 max_failovers: int = 2,
                 fail_fast_factor: float = 0.5,
                 manage_replicas: bool = True,
                 name: str = "router",
                 prefix_affinity: bool = True,
                 affinity_slack: int = 4,
                 stall_deadline_s: Optional[float] = None):
        if not replicas:
            raise ValueError("need at least one replica")
        self._replicas: List[_Replica] = []
        seen = set()
        for i, eng in enumerate(replicas):
            rname = getattr(eng, "name", None) or f"replica{i}"
            if rname in seen:
                raise ValueError(f"duplicate replica name {rname!r} — "
                                 "construct each engine with a distinct "
                                 "name= so health events are attributable")
            seen.add(rname)
            self._replicas.append(_Replica(eng, rname))
        classes = list(classes) if classes else [PriorityClass("default")]
        self._classes: Dict[str, _ClassQueue] = {}
        for c in classes:
            if c.name in self._classes:
                raise ValueError(f"duplicate class {c.name!r}")
            if c.replica_tags is not None and not any(
                    r.tags & c.replica_tags for r in self._replicas):
                raise ValueError(
                    f"class {c.name!r} demands replica_tags "
                    f"{sorted(c.replica_tags)} but no replica carries "
                    f"any of them (replica tags: "
                    f"{ {r.name: sorted(r.tags) for r in self._replicas} })")
            self._classes[c.name] = _ClassQueue(c)
        self.max_failovers = int(max_failovers)
        self.fail_fast_factor = float(fail_fast_factor)
        self.manage_replicas = bool(manage_replicas)
        self.prefix_affinity = bool(prefix_affinity)
        self.affinity_slack = int(affinity_slack)
        # capability probe once: affinity costs nothing on fleets whose
        # engines expose no prefix summary (plain ServingEngines)
        self._any_prefix = any(
            callable(getattr(r.engine, "cached_prefix_tokens", None))
            for r in self._replicas)
        self.name = name
        self.beacon_name = f"serving/router[{name}]"
        self.stall_deadline_s = stall_deadline_s
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._stop = threading.Event()
        self._pending = 0
        self._rids = itertools.count()
        self._rr = 0
        self._stats = dict.fromkeys(_STAT_KEYS, 0)
        self._stats_lock = threading.Lock()
        self._beacon = _health.NULL_BEACON
        self._snap_writer = _cluster.default_writer()
        self._by_beacon = {}
        for r in self._replicas:
            if not r.beacon_name:
                continue
            if r.beacon_name in self._by_beacon and len(self._replicas) > 1:
                # two engines sharing a beacon name would make a stall
                # un-attributable — the drain could take out the WRONG
                # replica while traffic keeps flowing to the stalled one
                raise ValueError(
                    f"replicas share the beacon name {r.beacon_name!r} — "
                    "construct each engine with a distinct name= so "
                    "health events are attributable per replica")
            self._by_beacon[r.beacon_name] = r

    # -- lifecycle -------------------------------------------------------

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return self
        if self._closed:
            raise EngineStopped("router was shut down; build a new one")
        if self.manage_replicas:
            for r in self._replicas:
                r.engine.start()
        _health.listeners.append(self._on_health_event)
        self._beacon = _health.beacon(self.beacon_name,
                                      deadline_s=self.stall_deadline_s)
        self._thread = threading.Thread(target=self._run, name=THREAD_NAME,
                                        daemon=True)
        self._thread.start()
        return self

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every admitted request resolved (True) or the
        timeout passed (False)."""
        with self._cond:
            return self._cond.wait_for(lambda: self._pending == 0, timeout)

    def shutdown(self, drain: bool = True, timeout: float = 60.0):
        """Graceful by default: stop admitting, route everything queued,
        wait for in-flight work, then (when ``manage_replicas``) drain
        the replicas. ``drain=False`` abandons queued work typed."""
        with self._lock:
            self._closed = True
        if not drain:
            self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                import logging
                logging.getLogger(__name__).warning(
                    "router loop did not join within %.0fs", timeout)
        try:
            _health.listeners.remove(self._on_health_event)
        except ValueError:
            pass
        self._beacon.close()
        if self.manage_replicas:
            for r in self._replicas:
                try:
                    r.engine.shutdown(drain=drain)
                except Exception:
                    pass
        # anything still queued fails typed rather than hanging a client
        leftovers = []
        with self._lock:
            for cq in self._classes.values():
                leftovers.extend(cq.q)
                cq.q.clear()
        for req in leftovers:
            if not req.future.done():
                try:
                    req.future.set_exception(EngineStopped(
                        "router shut down before dispatch"))
                except Exception:
                    pass

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.shutdown(drain=exc_type is None)
        return False

    # -- client surface --------------------------------------------------

    def submit(self, payload, klass: str = "default",
               deadline_ms: Optional[float] = None, **kw) -> ServeFuture:
        """Enqueue one request under a priority class. ``payload`` and
        ``**kw`` flow through to the replica's ``submit`` (a
        ``DecodeScheduler`` fleet takes ``max_new_tokens=`` etc.).

        Admission control is typed: :class:`QueueFull` past the class
        queue bound, :class:`EngineStopped` after shutdown began, and —
        the deadline-aware part — :class:`DeadlineExceeded` for a
        DOOMED request: its deadline is already unmeetable (expired, or
        under ``fail_fast_factor`` × the class's observed service-time
        EWMA), so failing in microseconds beats failing after burning a
        replica dispatch on it."""
        try:
            cq = self._classes[klass]
        except KeyError:
            raise ValueError(
                f"unknown priority class {klass!r}; configured: "
                f"{list(self._classes)}") from None
        ms = (deadline_ms if deadline_ms is not None
              else cq.cls.default_deadline_ms)
        if ms is not None:
            est = cq.ewma_ms
            if ms <= 0 or (self.fail_fast_factor > 0 and est is not None
                           and ms < self.fail_fast_factor * est):
                self._bump("doomed")
                if obs.enabled():
                    obs.counter("serve/router_doomed").inc()
                raise DeadlineExceeded(
                    f"deadline {ms:.1f}ms is unmeetable (class "
                    f"{klass!r} service estimate "
                    f"{est if est is None else round(est, 1)}ms) — "
                    "doomed requests fail at admission")
        req = _RouterRequest(payload, kw, klass, next(self._rids),
                             ms / 1000.0 if ms is not None else None)
        with self._lock:
            if self._closed:
                raise EngineStopped("router is shutting down")
            if len(cq.q) >= cq.cls.max_queue:
                self._bump("rejected")
                if obs.enabled():
                    obs.counter("serve/router_rejected").inc()
                raise QueueFull(
                    f"class {klass!r} queue at capacity "
                    f"({cq.cls.max_queue}) — shed or retry with backoff")
            cq.q.append(req)
            self._pending += 1
        req.future.add_done_callback(lambda f: self._on_done(f))
        self._bump("submitted")
        if obs.enabled():
            obs.gauge(
                f"serve/router_queue_depth_{_metric_cls(klass)}").set(
                    len(cq.q))
        self._wake.set()
        return req.future

    def predict(self, payload, timeout: Optional[float] = None, **kw):
        """Synchronous convenience: ``submit(...).result(timeout)``."""
        if self._thread is None:
            raise RuntimeError("router not started — call start() or use "
                               "it as a context manager")
        return self.submit(payload, **kw).result(timeout)

    def swap(self, params, state=None, version: Optional[str] = None) -> str:
        """Fleet-wide hot swap, TWO-PHASE so the fleet never splits:
        phase 1 publishes the new version on EVERY replica (each
        registry does its own — possibly sharded — load on THIS
        thread; traffic keeps flowing on the old version); only when
        every publish landed does phase 2 activate everywhere
        (activation after a successful publish is a pointer write that
        cannot fail). A publish failure mid-fleet retires the copies
        already loaded and re-raises — all replicas stay on the OLD
        version rather than serving two answers for one request
        depending on placement. ``state=None`` inherits each replica's
        active state (the params-only swap contract). Each replica
        still flips at its own batch boundary, so every response is
        old-or-new, never mixed."""
        v = version or f"rv{next(self._rids)}"
        published = []
        try:
            for r in self._replicas:
                st = state
                if st is None:
                    cur = r.engine.registry.current()
                    st = cur.state if cur is not None else \
                        r.engine.model.state
                r.engine.registry.publish(params, st, version=v,
                                          activate=False)
                published.append(r)
        except BaseException:
            for r in published:
                try:
                    r.engine.registry.retire(v)
                except Exception:
                    pass
            raise
        for r in self._replicas:
            r.engine.registry.activate(v)
            r.engine._bump("swaps")
            if obs.enabled():
                obs.instant("serve/swap", version=v, replica=r.name)
        if obs.enabled():
            obs.instant("serve/router_swap", version=v)
        return v

    def stats(self) -> dict:
        with self._stats_lock:
            out = dict(self._stats)
        with self._lock:
            out["pending"] = self._pending
            out["queue_depth"] = {k: len(cq.q)
                                  for k, cq in self._classes.items()}
            out["replicas"] = {
                r.name: {"healthy": r.healthy,
                         "inflight": len(r.inflight)}
                for r in self._replicas}
        # per-replica prefix summary (the affinity signal, surfaced
        # next to the load signal): resident entry/shared-block counts
        # from each scheduler's prefix cache
        for r in self._replicas:
            pc = getattr(r.engine, "prefix", None)
            if pc is not None:
                out["replicas"][r.name]["prefix"] = pc.stats()
        return out

    def healthy_replicas(self) -> List[str]:
        with self._lock:
            return [r.name for r in self._replicas if r.healthy]

    # -- dynamic membership ----------------------------------------------

    def add_replica(self, engine, name: Optional[str] = None) -> str:
        """Register one more replica on a RUNNING router (the elastic
        scale-up path). Same invariants as construction — distinct
        name, distinct beacon — enforced under the lock; the membership
        list is REPLACED rather than mutated in place so `swap`'s
        lock-free iteration sees either the old fleet or the new one,
        never a half-grown list. When ``manage_replicas``, a router
        that is already started starts the engine too. Returns the
        registered replica name."""
        rname = name or getattr(engine, "name", None)
        rep = _Replica(engine, rname or "")
        with self._lock:
            if self._closed:
                raise EngineStopped("router is shutting down")
            if not rep.name:
                rep.name = f"replica{len(self._replicas)}"
            if any(r.name == rep.name for r in self._replicas):
                raise ValueError(f"duplicate replica name {rep.name!r}")
            bn = rep.beacon_name
            if bn and bn in self._by_beacon:
                raise ValueError(
                    f"replica {rep.name!r} shares the beacon name {bn!r} "
                    "with an existing replica — health events would be "
                    "un-attributable")
            running = self._thread is not None
        if self.manage_replicas and running:
            engine.start()
        err: Optional[Exception] = None
        with self._lock:
            # re-validate: the lock was dropped around engine.start(),
            # so the router may have closed — or a concurrent add may
            # have taken the name/beacon — in between
            if self._closed:
                err = EngineStopped("router is shutting down")
            elif any(r.name == rep.name for r in self._replicas):
                err = ValueError(f"duplicate replica name {rep.name!r}")
            elif bn and bn in self._by_beacon:
                err = ValueError(
                    f"replica {rep.name!r} shares the beacon name {bn!r} "
                    "with an existing replica — health events would be "
                    "un-attributable")
            else:
                self._replicas = self._replicas + [rep]
                if bn:
                    self._by_beacon[bn] = rep
                self._any_prefix = self._any_prefix or callable(
                    getattr(engine, "cached_prefix_tokens", None))
                for k in self._classes:
                    self._reseed_ewma_locked(k)
        if err is not None:
            # undo the start — the engine never entered rotation
            if self.manage_replicas and running:
                try:
                    engine.shutdown(drain=True)
                except Exception:  # noqa: BLE001 — undo is best-effort
                    pass
            raise err
        self._bump("joins")
        if obs.enabled():
            obs.counter("serve/router_joins").inc()
            obs.instant("serve/router_join", replica=rep.name)
        self._wake.set()
        return rep.name

    def remove_replica(self, name: str):
        """Deregister a replica (the elastic scale-DOWN path): drain it
        through the existing drain machinery — its in-flight requests
        fail over to survivors, no client loses a request — then drop
        it from rotation. The engine is NOT shut down here even under
        ``manage_replicas``: retirement sequencing (drain the agent,
        wait for its queues, then stop it) belongs to the caller, who
        gets the engine back. Refuses to remove the last replica or to
        strand a tag-demanding class with zero matching replicas."""
        with self._lock:
            rep = next((r for r in self._replicas if r.name == name), None)
            if rep is None:
                raise ValueError(f"no replica named {name!r}")
            if len(self._replicas) == 1:
                raise ValueError(
                    "cannot remove the last replica — shut the router "
                    "down instead")
            rest = [r for r in self._replicas if r is not rep]
            for cq in self._classes.values():
                tags = cq.cls.replica_tags
                if tags is not None and not any(r.tags & tags
                                                for r in rest):
                    raise ValueError(
                        f"removing {name!r} would leave class "
                        f"{cq.cls.name!r} (replica_tags {sorted(tags)}) "
                        "with no eligible replica")
        # out of rotation first (re-routes its in-flight requests onto
        # the survivors), THEN deregister — the drain path needs the
        # replica still resolvable while it strands/fails-over
        self._drain_replica(rep, reason="retired")
        with self._lock:
            rep.dead = True   # a retired replica must never rejoin
            self._replicas = [r for r in self._replicas if r is not rep]
            bn = rep.beacon_name
            if bn and self._by_beacon.get(bn) is rep:
                del self._by_beacon[bn]
            self._any_prefix = any(
                callable(getattr(r.engine, "cached_prefix_tokens", None))
                for r in self._replicas)
            for k in self._classes:
                self._reseed_ewma_locked(k)
        self._bump("retires")
        if obs.enabled():
            obs.counter("serve/router_retires").inc()
            obs.instant("serve/router_retire", replica=name)
        self._wake.set()
        return rep.engine

    # -- routing loop ----------------------------------------------------

    def _run(self):
        try:
            self._route_loop()
        except BaseException as e:  # noqa: BLE001 — post-mortem, then die
            if obs.enabled():
                _flight.dump_crash_bundle(error=e, context={
                    "component": "serving/router",
                    "stats": {k: v for k, v in self.stats().items()
                              if k not in ("replicas", "queue_depth")}})
            raise

    def _route_loop(self):
        """The dispatch loop: one deficit-round-robin pass over the
        class queues per wakeup. Everything here is host bookkeeping —
        the device work happens inside the replicas' own batcher
        threads, so a slow dispatch never blocks routing."""
        while not self._stop.is_set():
            self._beacon.pulse()
            if obs.enabled():
                self._snap_writer.maybe_write()
            did = self._drr_round()
            with self._lock:
                idle = all(not cq.q for cq in self._classes.values())
                inflight = sum(len(r.inflight) for r in self._replicas)
                if self._closed and idle and inflight == 0:
                    break
            if not did:
                self._wake.wait(0.02)
                self._wake.clear()

    def _drr_round(self) -> bool:
        """Deficit round-robin: each backlogged class earns its weight
        in credits per pass and dispatches that many requests; an empty
        class forfeits its deficit (work conservation — no class banks
        credit while idle)."""
        did = False
        for cq in self._classes.values():
            with self._lock:
                backlogged = bool(cq.q)
            if not backlogged:
                cq.deficit = 0.0
                continue
            cq.deficit += cq.cls.weight
            while cq.deficit >= 1.0:
                with self._lock:
                    req = cq.q.popleft() if cq.q else None
                if req is None:
                    break
                cq.deficit -= 1.0
                if not self._dispatch_one(cq, req):
                    # THIS class is parked (depth_limit reached / its
                    # eligible replicas full) — move on to the next
                    # class rather than ending the round: a stuck bulk
                    # head must never block the tight queue behind it
                    break
                did = True
            if obs.enabled():
                obs.gauge("serve/router_queue_depth_"
                          f"{_metric_cls(cq.cls.name)}").set(len(cq.q))
        return did

    def _dispatch_one(self, cq: _ClassQueue, req: _RouterRequest) -> bool:
        """Route ONE request: deadline requests to the least-loaded
        healthy replica (they cannot afford a deep queue), deadline-less
        round-robin. Returns False when the request was PARKED (pushed
        back, nothing routable right now)."""
        if req.future.cancelled():
            return True
        now = time.monotonic()
        if req.expired(now):
            self._miss(req, cq, "deadline passed while queued at router")
            return True
        limit = cq.cls.depth_limit
        tags = cq.cls.replica_tags
        with self._lock:
            # class→replica affinity first: a tagged class only ever
            # sees its tag-matching replicas — least-loaded, deadline,
            # depth_limit and prefix-affinity all compose on the
            # filtered set
            eligible = (self._replicas if tags is None else
                        [r for r in self._replicas if r.tags & tags])
            healthy = [r for r in eligible if r.healthy]
            if limit is not None:
                healthy = [r for r in healthy
                           if r.by_class.get(req.klass, 0) < limit]
        if not healthy:
            with self._lock:
                all_dead = all(r.dead for r in eligible)
            if self._stop.is_set() or all_dead:
                # a drained replica may rejoin (park and wait); a DEAD
                # fleet never will — parking would hang every client
                self._fail(req, EngineStopped("no replicas left"))
                return True
            with self._lock:
                cq.q.appendleft(req)
            return False
        if req.deadline is not None:
            order = sorted(healthy, key=lambda r: len(r.inflight))
        else:
            self._rr += 1
            order = healthy[self._rr % len(healthy):] \
                + healthy[:self._rr % len(healthy)]
        aff = self._affinity_pick(req, healthy)
        if aff is not None:
            order = [aff] + [r for r in order if r is not aff]
        rem = req.remaining_ms(now)
        for rep in order:
            try:
                _chaos.maybe_fire("router/dispatch", tag=rep.name)
                inner = rep.engine.submit(req.payload, deadline_ms=rem,
                                          **req.kw)
            except QueueFull:
                self._bump("replica_full")
                if obs.enabled():
                    obs.counter("serve/router_replica_full").inc()
                continue
            except EngineStopped:
                self._mark_unhealthy(rep, "engine_stopped")
                continue
            except BaseException as e:  # noqa: BLE001 — fail THIS request
                if classify_failure(e) == TRANSIENT \
                        and req.dispatch_retries < _MAX_DISPATCH_RETRIES:
                    # a transient dispatch-path failure (flaky replica
                    # transport, injected fault) is worth the NEXT
                    # replica, not this request's life — bounded per
                    # request: a transport that NEVER stops presenting
                    # transient eventually fails the request typed
                    # instead of park-and-retrying forever
                    req.dispatch_retries += 1
                    self._bump("dispatch_retries")
                    if obs.enabled():
                        obs.counter("serve/router_dispatch_retries").inc()
                    continue
                self._fail(req, e)
                return True
            with self._lock:
                if not rep.healthy:
                    # drained between submit and registration: the
                    # drain's stranded snapshot could not have seen this
                    # request, so route it to the next replica ourselves
                    # (the orphaned inner future resolves into the void —
                    # the outer future is set exactly once)
                    continue
                rep.inflight.add(req)
                rep.by_class[req.klass] = \
                    rep.by_class.get(req.klass, 0) + 1
                # capture INSIDE the lock: a drain interleaving after
                # registration bumps the epoch under this same lock, so
                # the callback's epoch is guaranteed to describe THIS
                # dispatch, keeping the staleness guard sound
                req.t_dispatch_ns = time.perf_counter_ns()
                epoch = req.epoch
            self._bump("dispatches")
            if obs.enabled():
                obs.counter("serve/router_dispatches").inc()
                obs.gauge(f"serve/router_inflight_{rep.name}").set(
                    len(rep.inflight))
                obs.histogram(
                    "serve/router_queue_wait_ms_"
                    f"{_metric_cls(cq.cls.name)}", unit="ms").observe(
                        (time.perf_counter_ns() - req.t_enqueue_ns) / 1e6)
            inner.add_done_callback(
                lambda f, r=req, rp=rep, ep=epoch:
                self._on_inner_done(r, rp, f, ep))
            return True
        # every healthy replica's queue is full: park and retry — the
        # router's own bounded class queues are the real backpressure
        with self._lock:
            cq.q.appendleft(req)
        return False

    def _affinity_pick(self, req: _RouterRequest,
                       healthy: List[_Replica]) -> Optional[_Replica]:
        """Prefix-affinity placement: the healthy replica whose prefix
        cache reports the LONGEST resident prefix for this prompt (each
        replica's ``cached_prefix_tokens`` probe — a host-side digest
        walk, no device work), or None when nothing is cached, only one
        candidate exists, or the cache-holder is more than
        ``affinity_slack`` in-flight requests deeper than the
        least-loaded replica (affinity yields to load — the
        starvation guard)."""
        if not self.prefix_affinity or not self._any_prefix \
                or len(healthy) < 2:
            return None
        best, best_tokens = None, 0
        for rep in healthy:
            probe = getattr(rep.engine, "cached_prefix_tokens", None)
            if not callable(probe):
                continue
            try:
                n = int(probe(req.payload))
            except Exception:
                continue   # malformed payload for this engine — no bias
            if n > best_tokens:
                best, best_tokens = rep, n
        if best is None:
            return None
        min_load = min(len(r.inflight) for r in healthy)
        if len(best.inflight) - min_load > self.affinity_slack:
            self._bump("affinity_bypassed")
            if obs.enabled():
                obs.counter("serve/router_affinity_bypassed").inc()
            return None
        self._bump("affinity_hits")
        if obs.enabled():
            obs.counter("serve/router_affinity_hits").inc()
        return best

    def _on_inner_done(self, req: _RouterRequest, rep: _Replica, inner,
                       epoch: int = 0):
        """Resolve the client future from the replica's future — or
        FAIL OVER: a replica that died mid-request (EngineStopped, or
        drained by its stall beacon before answering) sends the request
        back through the queue to complete on a survivor."""
        with self._lock:
            if req in rep.inflight:
                rep.inflight.discard(req)
                rep.by_class[req.klass] = \
                    max(0, rep.by_class.get(req.klass, 1) - 1)
            stale = epoch != req.epoch
        # a replica slot freed: parked depth-limited classes can route
        self._wake.set()
        if obs.enabled():
            obs.gauge(f"serve/router_inflight_{rep.name}").set(
                len(rep.inflight))
        if stale:
            # an ABANDONED inner future resolving late (its request was
            # already failed over by a drain): the live copy owns the
            # outcome — acting here would requeue/dispatch it twice
            return
        if req.future.done():
            return  # failover already resolved it elsewhere
        if inner.cancelled():
            req.future.cancel()
            return
        exc = inner.exception()
        if exc is None:
            lat_ms = (time.perf_counter_ns() - req.t_enqueue_ns) / 1e6
            # the doomed-at-admission estimate is SERVICE time (dispatch
            # -> done), not end-to-end latency: a backlog inflates queue
            # wait transiently, and folding that into the estimate would
            # keep dooming tight requests long after replicas went idle
            svc_ms = ((time.perf_counter_ns() - req.t_dispatch_ns) / 1e6
                      if req.t_dispatch_ns is not None else lat_ms)
            with self._lock:
                prev = rep.ewma_ms.get(req.klass)
                rep.ewma_ms[req.klass] = (svc_ms if prev is None
                                          else 0.8 * prev + 0.2 * svc_ms)
                self._reseed_ewma_locked(req.klass)
            res = inner.result()
            if req.recovered is not None:
                # KV-preserving failover: the survivor only decoded
                # the CONTINUATION — the client gets the dead replica's
                # tokens followed by the survivor's, which is bitwise
                # the uninterrupted stream. A splice that fails (a
                # result that is not a token vector) must FAIL the
                # future, never strand it.
                try:
                    res = np.concatenate([
                        req.recovered,
                        np.asarray(res, np.int32).reshape(-1)])
                except Exception as e:  # noqa: BLE001 — typed, not stuck
                    self._fail(req, e)
                    return
            self._complete(req, res, replica=rep.name,
                           base_trace=getattr(inner, "trace", None),
                           version=getattr(inner, "version", None))
            return
        if isinstance(exc, DeadlineExceeded):
            # _miss splices req.recovered ahead of the survivor's
            # continuation partial (_carry_recovered) — one splice
            # point for every terminal path
            self._miss(req, self._classes[req.klass], str(exc), exc=exc)
            return
        if isinstance(exc, (EngineStopped, QueueFull)) \
                and not self._stop.is_set() \
                and req.failovers < self.max_failovers:
            if self._recover_decode(req, exc):
                return  # the partial already completed the request
            self._failover(req, rep, reason=type(exc).__name__)
            return
        self._fail(req, exc)

    def _recover_decode(self, req: _RouterRequest, exc) -> bool:
        """KV-preserving decode recovery. A dying
        :class:`~.decode_scheduler.DecodeScheduler` fails its in-flight
        requests typed with the tokens it already generated on
        ``exc.partial``; instead of re-running the whole generation
        from scratch on a survivor, splice that progress into the
        request before the failover re-queues it:

        * payload becomes ``prompt + partial`` — the survivor prefills
          the full token history (a PREFIX HIT where its cache already
          holds the prompt: the re-prefill collapses to the partial's
          tail chunks);
        * ``max_new_tokens`` shrinks by the tokens already produced;
        * the final result is ``partial + continuation``.

        Greedy decode — and seeded sampling, whose keys derive from
        (seed, absolute position) in-program — is a pure function of
        the token history, so the recovered stream is BITWISE the
        uninterrupted run. Host-only
        bookkeeping — never a device touch. Returns True when the
        partial already exhausted the budget (the request is resolved
        here, nothing left to re-dispatch); False falls through to the
        plain whole-prompt failover."""
        partial = getattr(exc, "partial", None)
        if partial is None:
            return False
        partial = np.asarray(partial, np.int32).reshape(-1)
        if partial.size == 0:
            return False
        mnt = req.kw.get("max_new_tokens")
        if mnt is None:
            return False  # not a decode-shaped request
        try:
            payload = np.asarray(req.payload, np.int32).reshape(-1)
        except (TypeError, ValueError):
            return False
        self._bump("kv_recoveries")
        if obs.enabled():
            obs.counter("serve/router_kv_recoveries").inc()
        _health.emit("router_kv_recovery", rid=req.rid,
                     tokens=int(partial.size))
        req.recovered = (partial if req.recovered is None
                         else np.concatenate([req.recovered, partial]))
        req.payload = np.concatenate([payload, partial])
        req.kw = dict(req.kw)
        req.kw["max_new_tokens"] = int(mnt) - int(partial.size)
        if req.kw["max_new_tokens"] <= 0:
            # the dead replica had already produced the full budget —
            # its answer is complete; resolve instead of re-dispatching
            # a zero-token request (replica=None in the trace: no
            # survivor served a continuation)
            self._complete(req, req.recovered, replica=None,
                           base_trace={"rid": req.rid},
                           version=getattr(exc, "version", None))
            return True
        return False

    def _complete(self, req: _RouterRequest, res, *,
                  replica: Optional[str], base_trace=None, version=None):
        """The ONE completion path: attach version + the router trace
        (with recovery provenance), record the completion metrics, and
        resolve the future — shared by the normal inner-done success
        and the full-budget recovery resolve so the provenance surface
        cannot drift between them."""
        lat_ms = (time.perf_counter_ns() - req.t_enqueue_ns) / 1e6
        trace = dict(base_trace or {})
        trace["router"] = {"class": req.klass, "replica": replica,
                           "failovers": req.failovers,
                           "latency_ms": round(lat_ms, 3)}
        if req.recovered is not None:
            trace["router"]["recovered_tokens"] = int(req.recovered.size)
        req.future.version = version
        req.future.trace = trace
        self._bump("completed")
        if obs.enabled():
            obs.counter("serve/router_completed").inc()
            obs.histogram(
                f"serve/router_latency_ms_{_metric_cls(req.klass)}",
                unit="ms").observe(lat_ms)
        try:
            req.future.set_result(res)
        except Exception:
            pass

    # -- health / failover -----------------------------------------------

    def _reseed_ewma_locked(self, klass: str):
        """Re-derive one class's admission estimate from the healthy
        replicas' per-replica EWMAs (min — doom a deadline only when
        even the BEST live replica can't meet it). Caller holds
        ``self._lock``."""
        cq = self._classes[klass]
        est = [r.ewma_ms[klass] for r in self._replicas
               if r.healthy and klass in r.ewma_ms]
        cq.ewma_ms = min(est) if est else None

    def _on_health_event(self, event: dict):
        """health-listener hook (runs on the watchdog thread): a
        replica's stall beacon drains it, its recovery rejoins it."""
        comp = event.get("component")
        rep = self._by_beacon.get(comp)
        if rep is None:
            return
        kind = event.get("kind")
        if kind == "health/stall":
            self._drain_replica(rep, reason="stall")
        elif kind == "health/stall_recovered":
            self._rejoin_replica(rep)

    def _drain_replica(self, rep: _Replica, reason: str):
        """Take a replica out of rotation and re-route its in-flight
        requests onto the survivors. The stalled replica's own futures
        are left pending — if it revives and answers first, the outer
        future is already resolved and the late answer is dropped
        (set-once), so no client ever sees two answers or none."""
        with self._lock:
            if not rep.healthy:
                return
            rep.healthy = False
            stranded = list(rep.inflight)
            rep.inflight.clear()
            rep.by_class.clear()
            # the drained replica's service times leave the admission
            # estimate with it — the fleet's doomed check must describe
            # the replicas that can actually serve
            for k in self._classes:
                self._reseed_ewma_locked(k)
        self._bump("drains")
        if obs.enabled():
            obs.counter("serve/router_drains").inc()
            obs.instant("serve/router_drain", replica=rep.name,
                        reason=reason, stranded=len(stranded))
            _flight.record("serve/router_drain", replica=rep.name,
                           reason=reason, stranded=len(stranded))
        for req in stranded:
            if not req.future.done():
                self._failover(req, rep, reason=reason)

    def _rejoin_replica(self, rep: _Replica):
        with self._lock:
            if rep.healthy or rep.dead:
                return
            rep.healthy = True
            # stale-EWMA dooming fix: the pre-stall service
            # times this replica measured are the latencies of a
            # machine that just wedged — re-seed from FRESH completions
            # so a recovered replica cannot doom tight-deadline
            # requests off its old numbers
            rep.ewma_ms.clear()
            for k in self._classes:
                self._reseed_ewma_locked(k)
        self._bump("rejoins")
        if obs.enabled():
            obs.counter("serve/router_rejoins").inc()
            obs.instant("serve/router_rejoin", replica=rep.name)
        self._wake.set()

    def _failover(self, req: _RouterRequest, rep: _Replica, reason: str):
        """Send a request back through the class queue (head — it has
        already waited) to complete on a surviving replica. The
        ``max_failovers`` budget is enforced HERE — the one choke point
        both the inner-error path and the stall-drain path go through —
        so a request ping-ponging between flapping replicas eventually
        fails typed instead of looping forever."""
        if req.failovers >= self.max_failovers:
            self._fail(req, EngineStopped(
                f"request {req.rid} failed over {req.failovers}x "
                f"(budget {self.max_failovers}) — last replica "
                f"{rep.name}: {reason}"))
            return
        req.failovers += 1
        self._bump("failovers")
        if obs.enabled():
            obs.counter("serve/router_failovers").inc()
            _health.emit("router_failover", rid=req.rid, replica=rep.name,
                         reason=reason, attempt=req.failovers)
        with self._lock:
            # bump under the SAME lock the dispatch path captures its
            # epoch under — the abandoned inner's resolution is now
            # recognizably stale, with no interleaving window
            req.epoch += 1
            self._classes[req.klass].q.appendleft(req)
        self._wake.set()

    def _mark_unhealthy(self, rep: _Replica, reason: str):
        with self._lock:
            was = rep.healthy
            rep.healthy = False
            if reason == "engine_stopped":
                rep.dead = True
            for k in self._classes:
                self._reseed_ewma_locked(k)
        if was:
            self._bump("drains")
            if obs.enabled():
                obs.counter("serve/router_drains").inc()
                obs.instant("serve/router_drain", replica=rep.name,
                            reason=reason, stranded=0)

    # -- internals -------------------------------------------------------

    def _miss(self, req: _RouterRequest, cq: _ClassQueue, msg: str,
              exc: Optional[BaseException] = None):
        self._bump("deadline_misses")
        if obs.enabled():
            obs.counter("serve/router_timeouts").inc()
            obs.counter("serve/router_deadline_miss_"
                        f"{_metric_cls(cq.cls.name)}").inc()
        if exc is None:
            exc = DeadlineExceeded(msg)
        try:
            req.future.set_exception(self._carry_recovered(req, exc))
        except Exception:
            pass

    def _carry_recovered(self, req: _RouterRequest,
                         exc: BaseException) -> BaseException:
        """Terminal failures must not silently drop tokens a dead
        replica already produced: whatever path fails the request —
        deadline at the router, exhausted failover budget, a dead
        fleet — the client's ``exc.partial`` carries the WHOLE stream:
        the recovered prefix followed by whatever continuation the
        last replica's own partial holds (an exception without one, or
        with an empty one, still keeps the prefix). The one splice
        point for every terminal path — matching the contract the
        scheduler upholds on its own failure paths."""
        if req.recovered is not None:
            tail = getattr(exc, "partial", None)
            tail = (np.zeros((0,), np.int32) if tail is None
                    else np.asarray(tail, np.int32).reshape(-1))
            exc.partial = np.concatenate([req.recovered, tail])
        return exc

    def _fail(self, req: _RouterRequest, exc: BaseException):
        try:
            req.future.set_exception(self._carry_recovered(req, exc))
        except Exception:
            pass

    def _on_done(self, future):
        with self._cond:
            self._pending -= 1
            self._cond.notify_all()

    def _bump(self, key: str, n: int = 1):
        with self._stats_lock:
            self._stats[key] += n


def router_threads_alive() -> int:
    """Live router loops (tests assert 0 after shutdown)."""
    return sum(1 for t in threading.enumerate()
               if t.name == THREAD_NAME and t.is_alive())
