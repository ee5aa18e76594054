"""Elastic fleet control plane (counterpart of
``bigdl_tpu/serving/controller.py``).

A RECONCILE LOOP over the signals the fleet already emits - member files
carry each agent's ``serving`` section (queue depth, inflight, active
version) through ``FileHeartbeat``, and the Router counts submissions and
deadline misses per class. The controller never invents a data path; it
only changes WHO is in the existing ones:

* **SLO-scored scaling** - each tick scores fleet load (router class
  queues + member-file queue depths, per healthy replica) and the
  deadline-miss rate of the tick window against a :class:`ScalePolicy`.
  Sustained pressure (``up_ticks`` consecutive ticks) spawns a replica
  through the caller's ``spawn`` hook; sustained slack retires one, with
  min / max budgets and a cooldown. Retirement is a DRAIN, never a kill:
  ``Router.remove_replica`` fails the victim's in-flight work over to
  survivors, then the agent drains its own queue and exits 0.
* **Prefill promotion** - when the prefill pool's backlog crosses
  ``prefill_backlog_high`` while the decode pool has a replica to spare,
  one decode replica is PROMOTED (out of router rotation, version-checked
  against the pool, role-flipped through the ``set_role`` op, added to the
  :class:`~.fleet.DisaggregatedFleet` prefill pool); relief demotes it.
* **Prefix warming on join** - a spawned replica adopts prefix chains
  from a live peer through :func:`~.fleet.warm_replica` before it takes
  traffic.
* **Adoption** - ``start()`` (and every tick) reconciles the membership
  DIRECTORY against the router: live members the router does not know are
  adopted, not respawned, so the directory is the controller's only
  durable state.

``tick()`` is public, so a caller (or a test) drives reconciliation
deterministically. Chaos sites ``fleet/controller_tick`` and
``fleet/spawn``; metrics ``serve/fleet_*``.
"""
from __future__ import annotations

import itertools
import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Set

from .. import observability as obs
from ..observability import health as _health
from ..parallel import chaos as _chaos
from ..parallel.failure import TRANSIENT, classify_failure
from .fleet import (DisaggregatedFleet, FleetMonitor, RemoteReplica,
                    discover, read_member, warm_replica)

_LOG = logging.getLogger("bigdl_tpu_torch.serving.controller")

__all__ = ["ScalePolicy", "FleetController", "controller_threads_alive"]

CONTROLLER_THREAD = "bigdl_tpu_torch-fleet-controller"


@dataclass
class ScalePolicy:
    """The controller's SLO thresholds and scaling discipline.

    Load score = (router class-queue depth + member-file queue depths)
    per healthy replica; miss rate = deadline misses / submissions in
    the tick window. Hysteresis (``up_ticks``/``down_ticks``
    consecutive ticks over/under threshold) plus ``cooldown_s`` after
    ANY membership change keep a bursty minute from flapping the
    fleet - scaling is meant to track sustained pressure, the queues
    absorb the rest."""
    min_replicas: int = 1
    max_replicas: int = 4
    #: per-healthy-replica backlog above which the fleet is overloaded
    queue_high: float = 8.0
    #: ...and below which it is over-provisioned
    queue_low: float = 1.0
    #: deadline-miss fraction per tick window that counts as overload
    miss_rate_high: float = 0.05
    up_ticks: int = 2
    down_ticks: int = 4
    cooldown_s: float = 5.0
    #: prefill-pool backlog (queue depth + pending across specialists)
    #: that triggers a decode->prefill promotion / its relief demotes
    prefill_backlog_high: int = 8
    prefill_backlog_low: int = 1
    #: only these router classes feed the load score (None = all)
    watch_classes: Optional[Set[str]] = None
    #: max prompts warmed into a joining replica (0 disables warming)
    warm_limit: int = 8
    #: after a drain-retire, the victim's name is held out of adoption
    #: until its member doc goes terminal or this many seconds pass -
    #: the shutdown ack races the agent's final beat, and a tick in
    #: that window must not re-register the retiring replica
    retire_grace_s: float = 60.0


class FleetController:
    """The reconcile loop: observe -> score -> (maybe) change membership.

    Parameters
    ----------
    router : the :class:`~.router.Router` whose ``add_replica`` /
        ``remove_replica`` / ``stats`` are the scale levers + signal.
    monitor : the :class:`~.fleet.FleetMonitor` watching the same
        replicas (``watch``/``unwatch`` keep it in step).
    fleet_dir : the membership directory - the controller's durable
        state. A respawned controller adopts whatever lives here.
    spawn : ``spawn(name) -> RemoteReplica`` - launch ONE new agent
        (subprocess, thread, whatever the deployment uses) and return
        a connected handle. The controller wraps the call with the
        ``fleet/spawn`` chaos seam and the ``serve/fleet_spawn_ms``
        histogram; a raise is a counted, retried-after-cooldown
        failure, never a half-registered replica.
    disagg : optional :class:`~.fleet.DisaggregatedFleet` - enables
        prefill promotion/demotion and pool-aware adoption.
    warm_prompts : the prompts a joining replica pre-warms (a sequence,
        or a zero-arg callable returning one - e.g. "current hottest
        chains"). Warming degrades per-prompt; it never blocks a join.
    every_s : tick cadence of the background thread. ``tick()`` is
        public so tests drive reconciliation deterministically.
    """

    def __init__(self, router, monitor: FleetMonitor, *, fleet_dir: str,
                 spawn: Callable[[str], RemoteReplica],
                 policy: Optional[ScalePolicy] = None,
                 disagg: Optional[DisaggregatedFleet] = None,
                 warm_prompts=None,
                 every_s: float = 0.5,
                 name: str = "controller",
                 spawn_prefix: str = "auto"):
        self.router = router
        self.monitor = monitor
        self.fleet_dir = fleet_dir
        self.spawn = spawn
        self.policy = policy or ScalePolicy()
        self.disagg = disagg
        self.warm_prompts = warm_prompts
        self.every_s = float(every_s)
        self.name = name
        self.spawn_prefix = spawn_prefix
        self._members: Dict[str, RemoteReplica] = {
            r.name: r for r in monitor.replicas}
        if disagg is not None:
            for p in disagg.prefill:
                self._members.setdefault(p.name, p)
        self._promoted: Set[str] = set()
        # name -> monotonic stamp of a drain-retire still in flight:
        # adopt() skips these until the member doc goes terminal (or
        # the grace period lapses)
        self._retired: Dict[str, float] = {}
        self._spawn_ids = itertools.count()
        self._up_streak = 0
        self._down_streak = 0
        self._last_change = float("-inf")
        self._last_submitted = 0
        self._last_misses = 0
        self._stats = {"ticks": 0, "tick_faults": 0, "scale_ups": 0,
                       "scale_downs": 0, "spawn_failed": 0,
                       "promotions": 0, "demotions": 0, "adopted": 0,
                       "warm_prompts": 0, "version_skew_blocked": 0}
        self._stats_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.dead = False

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "FleetController":
        self.adopt()
        self._thread = threading.Thread(
            target=self._loop, name=f"{CONTROLLER_THREAD}[{self.name}]",
            daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(10.0)

    def stats(self) -> Dict:
        with self._stats_lock:
            out = dict(self._stats)
        out["replicas"] = len(self._members)
        out["promoted"] = sorted(self._promoted)
        out["dead"] = self.dead
        return out

    # -- adoption --------------------------------------------------------

    def adopt(self) -> int:
        """Reconcile the membership DIRECTORY against the router: any
        live member (not dead, not cleanly final) the controller does
        not already track gets a fresh :class:`RemoteReplica` and joins
        the router/monitor (prefill-role members join the disagg
        prefill pool instead). This is what makes a controller restart
        an ADOPTION, not a respawn storm - the directory is the
        controller's only durable state. A name this controller just
        drain-retired is held out until its member doc goes terminal
        (or ``retire_grace_s`` lapses): the agent's shutdown ack races
        its final beat, and a tick landing in that window must not
        re-register the retiring replica. Returns members adopted."""
        n = 0
        now = time.monotonic()
        for doc in discover(self.fleet_dir):
            name = doc["name"]
            if doc.get("dead") or doc.get("final"):
                self._retired.pop(name, None)   # retirement completed
                continue
            if name in self._members:
                continue
            if name in self._retired:
                if now - self._retired[name] < self.policy.retire_grace_s:
                    continue
                self._retired.pop(name, None)
            rep = RemoteReplica(doc, fleet_dir=self.fleet_dir)
            try:
                rep.start()
            except OSError:
                # registered but unreachable (still booting, or its
                # host died without a terminal beat) - next tick
                continue
            try:
                self._register(rep)
            except ValueError:
                rep.close()
                continue
            self._members[name] = rep
            n += 1
            self._bump("adopted")
            _LOG.info("controller %s adopted member %s (%s) at %s:%d",
                      self.name, name, rep.role, rep.host, rep.port)
            if obs.enabled():
                obs.instant("serve/fleet_adopt", agent=name,
                            role=rep.role)
        return n

    def _register(self, rep: RemoteReplica):
        if rep.role == "prefill" and self.disagg is not None:
            self.disagg.add_prefill(rep)
            self.monitor.watch(rep)
            return
        self.router.add_replica(rep)
        self.monitor.watch(rep)
        if self.disagg is not None and rep.role == "decode":
            self.disagg.add_decode(rep)

    # -- the reconcile loop ----------------------------------------------

    def _loop(self):
        while not self._stop.is_set():
            try:
                _chaos.maybe_fire("fleet/controller_tick", tag=self.name)
                self.tick()
            except BaseException as e:  # noqa: BLE001 - classify
                if classify_failure(e) == TRANSIENT:
                    # one lost tick: membership is unchanged, the data
                    # path never noticed
                    self._bump("tick_faults")
                    if obs.enabled():
                        obs.counter("serve/fleet_controller_faults").inc()
                else:
                    # controller DEATH. Deliberately not fatal to the
                    # fleet: the router/monitor own the data path, so
                    # serving continues with membership frozen; a
                    # respawned controller adopts the directory.
                    self.dead = True
                    _health.emit("fleet_controller_death",
                                 controller=self.name, error=repr(e))
                    _LOG.error("fleet controller %s died: %s",
                               self.name, e)
                    return
            self._stop.wait(self.every_s)

    def tick(self):
        """ONE reconciliation: score the fleet, take at most one
        membership action. Public so tests and drills can drive the
        controller deterministically without the thread cadence."""
        self._bump("ticks")
        pol = self.policy
        load, miss_rate, n_healthy = self._score()
        if obs.enabled():
            obs.gauge("serve/fleet_size").set(len(self._members))
            obs.gauge("serve/fleet_load").set(load)
        over = load > pol.queue_high or miss_rate > pol.miss_rate_high
        under = (load < pol.queue_low
                 and miss_rate <= pol.miss_rate_high / 2)
        self._up_streak = self._up_streak + 1 if over else 0
        self._down_streak = self._down_streak + 1 if under else 0
        self.adopt()
        if self.disagg is not None:
            self._reconcile_prefill()
        if time.monotonic() - self._last_change < pol.cooldown_s:
            return
        size = self._router_size()
        if self._up_streak >= pol.up_ticks and size < pol.max_replicas:
            self._scale_up()
        elif self._down_streak >= pol.down_ticks \
                and size > pol.min_replicas and n_healthy > 1:
            self._scale_down()

    # -- signals ---------------------------------------------------------

    def _score(self):
        rs = self.router.stats()
        reps = rs.get("replicas", {})
        n_healthy = sum(1 for v in reps.values() if v.get("healthy"))
        qd = rs.get("queue_depth", {})
        if self.policy.watch_classes is not None:
            qd = {k: v for k, v in qd.items()
                  if k in self.policy.watch_classes}
        backlog = sum(qd.values())
        for name in reps:
            s = self._serving(name)
            backlog += int(s.get("queue_depth") or 0)
        load = backlog / max(1, n_healthy)
        submitted = rs.get("submitted", 0)
        misses = rs.get("deadline_misses", 0)
        ds = submitted - self._last_submitted
        dm = misses - self._last_misses
        self._last_submitted, self._last_misses = submitted, misses
        miss_rate = (dm / ds) if ds > 0 else 0.0
        return load, miss_rate, n_healthy

    def _serving(self, name: str) -> Dict:
        rep = self._members.get(name)
        doc = rep.member() if rep is not None else None
        return (doc or {}).get("serving", {}) or {}

    def _router_size(self) -> int:
        return len(self.router.stats().get("replicas", {}))

    # -- scale -----------------------------------------------------------

    def _next_spawn_name(self) -> str:
        """The next ``<prefix>N`` no member already claims. The id
        counter restarts at 0 with every controller incarnation, so a
        successor that ADOPTED a predecessor's ``auto0`` must not hand
        that name to its own first spawn - the new agent would clobber
        the live replica's member file and the healthy original would
        be falsely retired off the new agent's beats. Skip ids with a
        tracked member, a retirement in flight, or any existing member
        file (live, final, or orphaned: the name is taken either way)."""
        while True:
            name = f"{self.spawn_prefix}{next(self._spawn_ids)}"
            if (name not in self._members
                    and name not in self._retired
                    and read_member(self.fleet_dir, name) is None):
                return name

    def _scale_up(self):
        name = self._next_spawn_name()
        t0 = time.monotonic()
        try:
            _chaos.maybe_fire("fleet/spawn", tag=name)
            rep = self.spawn(name)
        except BaseException as e:  # noqa: BLE001 - spawn must not kill
            # the controller: a failed spawn changed NOTHING (no router
            # entry, no monitor entry) - count it, honor the cooldown,
            # try again. An orphan member file, if the process half-
            # started, is adopted by a later tick.
            self._bump("spawn_failed")
            if obs.enabled():
                obs.counter("serve/fleet_spawn_failed").inc()
            _LOG.warning("fleet spawn %s failed (%s: %s) - retrying "
                         "after cooldown", name, type(e).__name__, e)
            self._last_change = time.monotonic()
            return
        if obs.enabled():
            obs.histogram("serve/fleet_spawn_ms", unit="ms").observe(
                (time.monotonic() - t0) * 1000.0)
        self._warm(rep)
        try:
            self._register(rep)
        except ValueError as e:
            _LOG.warning("spawned replica %s rejected by router (%s) - "
                         "draining it", name, e)
            rep.shutdown(drain=True)
            self._bump("spawn_failed")
            self._last_change = time.monotonic()
            return
        self._members[rep.name] = rep
        self._bump("scale_ups")
        self._up_streak = 0
        self._last_change = time.monotonic()
        _health.emit("fleet_scale_up", agent=rep.name,
                     size=len(self._members))
        if obs.enabled():
            obs.counter("serve/fleet_scale_ups").inc()
            obs.instant("serve/fleet_scale_up", agent=rep.name,
                        spawn_ms=round((time.monotonic() - t0) * 1e3, 1))
        _LOG.info("fleet scaled UP: %s joined (%d members)",
                  rep.name, len(self._members))

    def _scale_down(self):
        victim = self._pick_victim()
        if victim is None:
            return
        try:
            eng = self.router.remove_replica(victim)
        except ValueError:
            return   # raced to the last replica / tag coverage - skip
        self.monitor.unwatch(victim)
        if self.disagg is not None:
            self.disagg.remove_decode(victim)
        self._members.pop(victim, None)
        # hold the name out of adoption until its member doc goes
        # terminal - the agent acks shutdown BEFORE its final beat
        self._retired[victim] = time.monotonic()
        self._bump("scale_downs")
        self._down_streak = 0
        self._last_change = time.monotonic()
        _health.emit("fleet_scale_down", agent=victim,
                     size=len(self._members))
        if obs.enabled():
            obs.counter("serve/fleet_scale_downs").inc()
            obs.instant("serve/fleet_scale_down", agent=victim)
        _LOG.info("fleet scaled DOWN: %s retiring (%d members)",
                  victim, len(self._members))
        # the router already failed the victim's in-flight work over to
        # survivors; now the AGENT drains its own queue and exits 0 -
        # retire is always a drain, never a kill
        try:
            eng.shutdown(drain=True)
        except Exception:  # noqa: BLE001 - it is out of rotation either way
            pass

    def _pick_victim(self) -> Optional[str]:
        """The healthy router replica with the least in-flight work -
        never a promoted specialist (demotion owns those), preferring
        controller-spawned replicas so a static seed fleet survives
        scale-down."""
        rs = self.router.stats().get("replicas", {})
        cand = [(v.get("inflight", 0),
                 0 if n.startswith(self.spawn_prefix) else 1, n)
                for n, v in rs.items()
                if v.get("healthy") and n not in self._promoted]
        if not cand:
            return None
        cand.sort(key=lambda t: (t[1], t[0], t[2]))
        return cand[0][2]

    # -- prefill promotion ----------------------------------------------

    def _reconcile_prefill(self):
        pol = self.policy
        backlog = 0
        for p in self.disagg.prefill:
            s = self._serving(p.name)
            backlog += (int(s.get("queue_depth") or 0)
                        + int(s.get("pending") or 0))
        if obs.enabled():
            obs.gauge("serve/fleet_prefill_backlog").set(backlog)
        if backlog > pol.prefill_backlog_high:
            self._promote()
        elif backlog <= pol.prefill_backlog_low and self._promoted:
            self._demote()

    def _promote(self):
        """Decode -> prefill: dedicate one decode replica to the backed-
        up prefill pool. Router removal first (its in-flight decodes
        fail over - zero lost), then the version check (a skewed
        promotee would refuse every handoff: wait instead, counted),
        then the role flip + pool move."""
        rs = self.router.stats().get("replicas", {})
        cand = [(v.get("inflight", 0), n) for n, v in rs.items()
                if v.get("healthy") and n not in self._promoted]
        if len(cand) < 2:
            return   # never strip the decode pool bare
        name = min(cand)[1]
        rep = self._members.get(name)
        if rep is None:
            return
        def _live_version(r):
            # the FRESH member doc, never the handle cache: an adopted
            # or idle handle's cached version is seeded at construction
            # and only refreshed by its own submit acks, so it can stay
            # None/stale forever and block promotion on phantom skew
            doc = r.member()
            if doc is None:
                return r.active_version()
            return (doc.get("serving") or {}).get("active_version")

        pool_vs = {v for v in (_live_version(p)
                               for p in self.disagg.prefill)
                   if v is not None}
        if pool_vs and _live_version(rep) not in pool_vs:
            self._bump("version_skew_blocked")
            if obs.enabled():
                obs.counter("serve/fleet_promotion_skew_blocked").inc()
            return
        try:
            self.router.remove_replica(name)
        except ValueError:
            return
        try:
            rep.set_role("prefill")
        except Exception as e:  # noqa: BLE001 - undo, stay consistent
            _LOG.warning("promotion of %s failed at role flip (%s) - "
                         "rejoining decode", name, e)
            self.router.add_replica(rep)
            return
        self.disagg.remove_decode(name)
        self.disagg.add_prefill(rep)
        self._promoted.add(name)
        self._bump("promotions")
        self._last_change = time.monotonic()
        _health.emit("fleet_promotion", agent=name, to_role="prefill")
        if obs.enabled():
            obs.counter("serve/fleet_promotions").inc()
            obs.instant("serve/fleet_promotion", agent=name)
        _LOG.info("promoted %s to prefill duty", name)

    def _demote(self):
        name = sorted(self._promoted)[0]
        rep = self.disagg.remove_prefill(name)
        if rep is None:
            self._promoted.discard(name)
            return
        try:
            rep.set_role("decode")
        except Exception as e:  # noqa: BLE001 - keep it prefill then
            self.disagg.add_prefill(rep)
            _LOG.warning("demotion of %s failed at role flip: %s",
                         name, e)
            return
        try:
            self.router.add_replica(rep)
        except ValueError:
            pass   # already present (raced adoption)
        self.disagg.add_decode(rep)
        self._promoted.discard(name)
        self._bump("demotions")
        self._last_change = time.monotonic()
        _health.emit("fleet_demotion", agent=name, to_role="decode")
        if obs.enabled():
            obs.counter("serve/fleet_demotions").inc()
            obs.instant("serve/fleet_demotion", agent=name)
        _LOG.info("demoted %s back to decode duty", name)

    # -- warming ---------------------------------------------------------

    def _warm(self, rep: RemoteReplica):
        """Pre-warm a joining replica's prefix cache from a live peer
        (the ``warm_replica`` hop) so scale-up serves warm.
        Strictly best-effort: a failed warm is a cold join, not a
        failed join."""
        if self.policy.warm_limit <= 0 or self.warm_prompts is None:
            return
        prompts = (self.warm_prompts() if callable(self.warm_prompts)
                   else self.warm_prompts)
        prompts = list(prompts)[:self.policy.warm_limit]
        if not prompts:
            return
        source = next(
            (m for m in self._members.values()
             if m.name != rep.name and not m._client.closed), None)
        if source is None:
            return
        try:
            out = warm_replica(source, rep, prompts,
                               timeout_s=self.every_s * 120)
            self._bump("warm_prompts", out.get("warmed", 0))
        except Exception as e:  # noqa: BLE001 - warming is optional
            _LOG.warning("prefix warming for %s failed: %s",
                         rep.name, e)

    def _bump(self, key: str, n: int = 1):
        with self._stats_lock:
            self._stats[key] += n


def controller_threads_alive() -> int:
    """Live controller loops (tests assert 0 after stop)."""
    return sum(1 for t in threading.enumerate() if t.is_alive()
               and t.name.startswith(CONTROLLER_THREAD))
