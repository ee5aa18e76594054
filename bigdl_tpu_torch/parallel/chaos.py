"""Deterministic fault injection (counterpart of
``bigdl_tpu/parallel/chaos.py``, with its own armed plan: arming one
package's chaos never arms the other's).

Named injection sites sit at the real seams of the serving tier:

============================  ==============================================
site                          where it fires
============================  ==============================================
``serving/scheduler_step``    DecodeScheduler decode-group dispatch
``serving/prefill``           DecodeScheduler prefill-chunk dispatch
``serving/spec_round``        DecodeScheduler speculative round
``serving/engine_dispatch``   ServingEngine micro-batch forward
``kv/page_copy``              PagedKVCache.defrag page move
``kv/cow_fork``               PagedKVCache.fork_blocks copy-on-write
``kv/swap_out``               KVSwapManager spill copy (stager)
``kv/swap_in``                KVSwapManager refill verify + adopt
``prefix/insert``             PrefixCache.insert
``prefix/evict``              PrefixCache.evict
``router/dispatch``           Router replica submit
============================  ==============================================

(the catalog keeps the JAX package's other sites, which the port does not
reach yet). Schedules are seeded and deterministic (nth call, every k-th,
seeded probability, wedge for a duration); a ``transient`` rule raises
:class:`~.failure.TransientDeviceError`, a ``permanent`` rule
:class:`ChaosError` (classified PERMANENT), a ``wedge`` rule sleeps in
place. Disarmed cost is one module-global read per site. Arm with
:func:`arm` (a plan dict, a :class:`ChaosPlan` or a JSON path) or
``BIGDL_TPU_CHAOS=<plan.json>``. Rules may carry a ``tag`` matched against
the tag the call site passes (replica names); each rule counts only the
calls its tag matches. Every injection is counted (:func:`stats`) and
emitted as a ``health/chaos_injected`` event.
"""
from __future__ import annotations

import json
import logging
import os
import random
import threading
import time
from typing import Dict, List, Optional

from .failure import PERMANENT, TRANSIENT, TransientDeviceError

__all__ = ["ChaosError", "Rule", "ChaosPlan", "maybe_fire", "arm", "disarm",
           "armed", "stats", "fires", "sites_fired", "arm_from_env"]

_LOG = logging.getLogger("bigdl_tpu_torch.parallel.chaos")

#: the schedule kind that sleeps in place instead of raising — the
#: injected analog of a wedged collective/device copy (the stall
#: watchdog, not the retry tiers, owns this failure mode)
WEDGE = "wedge"

KINDS = (TRANSIENT, PERMANENT, WEDGE)

#: canonical site catalog (call sites may use others — the registry is
#: open — but the documented campaign surface is this list)
SITES = (
    "serving/scheduler_step",
    "serving/prefill",
    "serving/spec_round",
    "serving/engine_dispatch",
    "kv/page_copy",
    "kv/cow_fork",
    "kv/swap_out",
    "kv/swap_in",
    "prefix/insert",
    "prefix/evict",
    "router/dispatch",
    "checkpoint/write",
    "heartbeat/beat",
    "fleet/agent_beat",
    "fleet/transport",
    "fleet/handoff",
    "fleet/controller_tick",
    "fleet/spawn",
)


class ChaosError(RuntimeError):
    """An injected PERMANENT fault. The message carries none of the
    transient gRPC/absl markers, so ``classify_failure`` maps it to
    PERMANENT by the unknown-error default — exactly the class a dead
    chip or a wedged mesh presents as."""


class Rule:
    """One injection rule at one site.

    Parameters
    ----------
    kind : ``"transient"`` | ``"permanent"`` | ``"wedge"``.
    nth : fire ONCE, at the first matching call >= nth (1-based). The
        at-or-after semantics matter when two rules at one site want
        the same call: only the first takes effect that call, and the
        suppressed nth rule then fires on the NEXT call instead of
        being starved forever.
    every : fire on every ``every``-th matching call.
    prob : fire with this probability per matching call, drawn from the
        plan's seeded stream (deterministic for a fixed seed AND a fixed
        call interleaving — prefer nth/every for bitwise campaigns).
    wedge_s : sleep duration for ``kind="wedge"``.
    max_fires : stop firing after this many injections (None = no cap).
    tag : only calls passing this tag match (None matches every call) —
        how a campaign targets one replica of a fleet.
    """

    __slots__ = ("kind", "nth", "every", "prob", "wedge_s", "max_fires",
                 "tag", "calls", "fired")

    def __init__(self, kind: str = TRANSIENT, nth: Optional[int] = None,
                 every: Optional[int] = None, prob: Optional[float] = None,
                 wedge_s: float = 0.0, max_fires: Optional[int] = None,
                 tag: Optional[str] = None):
        if kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
        if sum(x is not None for x in (nth, every, prob)) != 1:
            raise ValueError(
                "exactly one of nth/every/prob must be set per rule")
        if nth is not None and nth < 1:
            raise ValueError(f"nth must be >= 1, got {nth}")
        if every is not None and every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        if prob is not None and not 0.0 < prob <= 1.0:
            raise ValueError(f"prob must be in (0, 1], got {prob}")
        if kind == WEDGE and wedge_s <= 0:
            raise ValueError("wedge rules need wedge_s > 0")
        self.kind = kind
        self.nth = nth
        self.every = every
        self.prob = prob
        self.wedge_s = float(wedge_s)
        self.max_fires = max_fires
        self.tag = tag
        self.calls = 0
        self.fired = 0

    def matches(self, tag: Optional[str]) -> bool:
        return self.tag is None or self.tag == tag

    def should_fire(self, rng: random.Random) -> bool:
        """Advance this rule's call counter and decide (caller holds the
        engine lock). ``fired`` counts EFFECTIVE injections only — a
        rule that wanted a call another rule took keeps its budget and
        (for nth) its one shot."""
        self.calls += 1
        if self.max_fires is not None and self.fired >= self.max_fires:
            return False
        if self.nth is not None:
            return self.calls >= self.nth and self.fired == 0
        if self.every is not None:
            return self.calls % self.every == 0
        return rng.random() < self.prob

    @classmethod
    def from_dict(cls, d: Dict) -> "Rule":
        allowed = {"kind", "nth", "every", "prob", "wedge_s", "max_fires",
                   "tag"}
        unknown = set(d) - allowed
        if unknown:
            raise ValueError(f"unknown rule keys {sorted(unknown)} "
                             f"(allowed: {sorted(allowed)})")
        return cls(**d)


class ChaosPlan:
    """A seeded campaign: ``{site: [Rule, ...]}`` plus the RNG seed the
    probability schedules draw from."""

    def __init__(self, sites: Dict[str, List[Rule]], seed: int = 0):
        self.seed = int(seed)
        self.sites = {str(s): list(rules) for s, rules in sites.items()}

    @classmethod
    def from_dict(cls, d: Dict) -> "ChaosPlan":
        sites = {}
        for site, rules in (d.get("sites") or {}).items():
            sites[site] = [r if isinstance(r, Rule) else Rule.from_dict(r)
                           for r in rules]
        return cls(sites, seed=d.get("seed", 0))

    @classmethod
    def from_json(cls, path: str) -> "ChaosPlan":
        with open(path) as f:
            return cls.from_dict(json.load(f))


class _Engine:
    """The armed plan: per-site rule lists, one seeded RNG, counters."""

    def __init__(self, plan: ChaosPlan):
        self.plan = plan
        self._rng = random.Random(plan.seed)
        self._lock = threading.Lock()
        self._fires: List[Dict] = []        # bounded injection LOG
        self._calls: Dict[str, int] = {}
        # exact counters, never truncated — the campaign gates read
        # these, the log is a debugging convenience
        self._total = 0
        self._by_site: Dict[str, int] = {}
        self._by_kind: Dict[str, int] = {}

    def fire(self, site: str, tag: Optional[str]):
        rule = None
        with self._lock:
            self._calls[site] = self._calls.get(site, 0) + 1
            call_no = self._calls[site]
            for r in self.plan.sites.get(site, ()):
                if not r.matches(tag):
                    continue
                if r.should_fire(self._rng) and rule is None:
                    r.fired += 1
                    rule = r
            if rule is not None:
                self._total += 1
                self._by_site[site] = self._by_site.get(site, 0) + 1
                self._by_kind[rule.kind] = \
                    self._by_kind.get(rule.kind, 0) + 1
                if len(self._fires) < 4096:
                    self._fires.append({"site": site, "kind": rule.kind,
                                        "tag": tag, "call": call_no})
        if rule is None:
            return
        # structured provenance for the campaign gates: every injection
        # is observable (health listeners work with observability off)
        from ..observability import health as _health
        _health.emit("chaos_injected", site=site, fault=rule.kind,
                     tag=tag, call=call_no)
        if rule.kind == WEDGE:
            _LOG.warning("chaos: wedging %.2fs at %s (tag=%s, call %d)",
                         rule.wedge_s, site, tag, call_no)
            time.sleep(rule.wedge_s)
            return
        msg = (f"chaos: injected {rule.kind} fault at {site} "
               f"(tag={tag}, call {call_no})")
        _LOG.warning("%s", msg)
        if rule.kind == TRANSIENT:
            raise TransientDeviceError(msg)
        raise ChaosError(msg)

    def stats(self) -> Dict:
        with self._lock:
            return {"fires": self._total, "by_site": dict(self._by_site),
                    "by_kind": dict(self._by_kind),
                    "calls": dict(self._calls)}

    def fires(self) -> List[Dict]:
        """The injection log — bounded at 4096 entries (the exact
        counters in :meth:`stats` never truncate)."""
        with self._lock:
            return list(self._fires)


#: the single armed engine; None = disarmed (the hot-path flag)
_engine: Optional[_Engine] = None


def maybe_fire(site: str, tag: Optional[str] = None):
    """The hot-path seam. Disarmed: one module-global read, nothing
    else. Armed: evaluate this site's rules and inject the scheduled
    fault (raise typed / wedge in place)."""
    eng = _engine
    if eng is None:
        return
    eng.fire(site, tag)


def arm(plan) -> _Engine:
    """Install a plan process-wide. Accepts a :class:`ChaosPlan`, a
    plan dict, or a path to a plan JSON file. Re-arming replaces the
    previous plan (counters reset)."""
    global _engine
    if isinstance(plan, str):
        plan = ChaosPlan.from_json(plan)
    elif isinstance(plan, dict):
        plan = ChaosPlan.from_dict(plan)
    elif not isinstance(plan, ChaosPlan):
        raise TypeError(f"cannot arm a {type(plan).__name__}")
    _engine = _Engine(plan)
    _LOG.warning("chaos armed: %d sites, seed=%d",
                 len(plan.sites), plan.seed)
    return _engine


def disarm():
    """Remove the armed plan (maybe_fire returns to the one-flag-read
    no-op)."""
    global _engine
    _engine = None


def armed() -> bool:
    return _engine is not None


def stats() -> Dict:
    """Injection accounting for the armed plan ({} when disarmed)."""
    eng = _engine
    return eng.stats() if eng is not None else {}


def fires() -> List[Dict]:
    """The injection log: [{site, kind, tag, call}, ...]."""
    eng = _engine
    return eng.fires() if eng is not None else []


def sites_fired() -> List[str]:
    """Distinct sites that have injected at least one fault."""
    return sorted(stats().get("by_site", ()))


def arm_from_env(env=None) -> Optional[_Engine]:
    """Arm from ``BIGDL_TPU_CHAOS=<plan.json>`` when set (called once at
    import; exposed for tests). Malformed plans log and stay disarmed —
    a typo'd campaign file must not take production down harder than
    the faults it meant to inject."""
    env = env if env is not None else os.environ
    path = env.get("BIGDL_TPU_CHAOS")
    if not path:
        return None
    try:
        return arm(ChaosPlan.from_json(path))
    except Exception as e:  # noqa: BLE001 — stay disarmed, loudly
        _LOG.error("ignoring malformed BIGDL_TPU_CHAOS=%r: %s", path, e)
        return None


arm_from_env()
