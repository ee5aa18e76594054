"""Fleet serving across processes (counterpart of
``bigdl_tpu/serving/fleet.py``).

Replicas in OTHER processes behind the same ``Router``, coordinated by a
control plane over files and a framed binary data plane for tensors
(``serving/transport.py``). Three layers:

* **Membership + health** - each replica process runs a
  :class:`ReplicaAgent`: it serves its engine over a local-socket
  transport, registers in a FLEET DIRECTORY (one atomically rewritten
  member file per agent, beaten on a cadence through
  ``parallel.failure.FileHeartbeat``), and extends the
  ``MetricSnapshotWriter`` snapshot with a ``serving`` section (queue
  depth, inflight, prefix summary, active model version), so
  ``cluster.write_aggregate()`` merges the fleet into one view. The Router
  gets a :class:`RemoteReplica` whose surface is an engine's
  (``submit`` / ``registry`` / ``cached_prefix_tokens`` / ``tags`` /
  ``shutdown``), so its dispatch, prefix affinity, class tags and
  failover work across processes unchanged. :class:`FleetMonitor` watches
  the member files and emits the ``health/stall`` /
  ``health/stall_recovered`` events a local stall beacon would; a dying
  scheduler's typed ``EngineStopped`` (its ``.partial`` tokens ride the
  error frame) feeds the Router's KV-preserving failover.

* **Fleet swap** - :class:`RemoteReplica`'s registry shim ships a new
  version's parameter tree over the wire (raw leaf bytes in one frame;
  bfloat16 leaves as their 2-byte buffers) and acknowledges after the
  remote placement, so ``Router.swap``'s two-phase publish-then-activate
  spans processes.

* **Disaggregated prefill / decode** - a PREFILL agent runs a prompt's
  chunked prefill and exports the finished prefix's KV blocks
  (``PagedKVCache.export_blocks``: a device copy taken under the ledger
  lock, fetched to the host after it) with the prefix cache's chain keys;
  a DECODE agent adopts them (``adopt_serialized`` +
  ``PrefixCache.insert``) only after re-deriving the chain keys from the
  tokens under ITS active version and checking the blake2b page digest -
  a corrupt or version-skewed handoff is refused typed
  (:class:`KVHandoffError`). The adopted prefix is an ordinary prefix
  entry, so the following ``Router.submit`` steers to the holder through
  prefix affinity and admission takes the warm-hit path: disaggregated
  tokens are bit for bit the monolithic scheduler's. A failed handoff
  degrades to a plain submit (the decode replica prefills itself), and is
  counted (``DisaggregatedFleet.stats()``: ``handoff_failed`` /
  ``handoff_refused``).

An agent's ``stats`` op also reports the kernel launches of its process
(``kernels.launch_counts()`` / ``launches_by_route()`` under
``"launches"`` / ``"launches_by_route"``), so a parent can count what its
agents launched. Chaos sites ``fleet/agent_beat``, ``fleet/transport``
and ``fleet/handoff``; metrics ``serve/fleet_*``. Run a replica process
with ``python -m bigdl_tpu_torch.serving.fleet <config.json>``.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import kernels as _kernels
from .. import observability as obs
from ..observability import cluster as _cluster
from ..utils.carrier import TreeCarrier
from ..observability import flight as _flight
from ..observability import health as _health
from ..parallel import chaos as _chaos
from ..parallel.failure import (FileHeartbeat, TRANSIENT,
                                TransientDeviceError, classify_failure)
from .batching import (DeadlineExceeded, EngineStopped, QueueFull,
                       ServeFuture)
from .kv_cache import KVCacheOOM
from .prefix_cache import chain_keys
from .transport import (RemoteError, TransportClient, TransportClosed,
                        TransportServer, decode_tree, encode_tree,
                        pick_advertise_host)

_LOG = logging.getLogger("bigdl_tpu_torch.serving.fleet")

MEMBER_SCHEMA = "bigdl_tpu.fleet_member.v1"   # JAX's: the files interoperate
AGENT_THREAD = "bigdl_tpu_torch-fleet-agent"
MONITOR_THREAD = "bigdl_tpu_torch-fleet-monitor"

#: agent process exit code after an injected/organic death (the
#: supervisor's signal that this was a crash, not a clean drain)
DEATH_EXIT_CODE = 86

#: replica roles. "replica" serves the full prefill+decode path;
#: "prefill" specializes in chunked prefill + KV export; "decode"
#: specializes in decode over adopted prefixes. Roles are labels for
#: discovery/routing - every scheduler-backed agent can serve every op.
ROLES = ("replica", "prefill", "decode")

__all__ = ["KVHandoffError", "member_path", "read_member", "discover",
           "wait_for_members", "ReplicaAgent", "RemoteReplica",
           "FleetMonitor", "DisaggregatedFleet", "warm_replica",
           "fleet_threads_alive", "agent_from_config", "main"]


class KVHandoffError(RuntimeError):
    """A prefill->decode KV handoff the receiver REFUSED: content chain
    hash mismatch (corrupt or mis-tokenized payload), page-digest
    mismatch (corrupt pages), version skew (the prefix was built under
    a model version the receiver no longer serves), or geometry
    mismatch. Typed so the handoff client degrades to a plain submit
    instead of decoding over garbage KV."""


# -- fleet directory -------------------------------------------------------

def member_path(fleet_dir: str, name: str) -> str:
    return os.path.join(fleet_dir, f"fleet_{name}.json")


def read_member(fleet_dir: str, name: str) -> Optional[Dict]:
    doc = FileHeartbeat.read(member_path(fleet_dir, name))
    if doc is None or doc.get("schema") != MEMBER_SCHEMA:
        return None
    return doc


def discover(fleet_dir: str, role: Optional[str] = None) -> List[Dict]:
    """Every registered member's latest doc (sorted by name), optionally
    filtered by role. Half-written or foreign files are skipped."""
    if not os.path.isdir(fleet_dir):
        return []
    out = []
    for fname in sorted(os.listdir(fleet_dir)):
        if not (fname.startswith("fleet_") and fname.endswith(".json")):
            continue
        doc = FileHeartbeat.read(os.path.join(fleet_dir, fname))
        if doc is None or doc.get("schema") != MEMBER_SCHEMA:
            continue
        if role is not None and doc.get("role") != role:
            continue
        out.append(doc)
    return out


def wait_for_members(fleet_dir: str, names: Sequence[str],
                     timeout_s: float = 120.0) -> List[Dict]:
    """Block until every named agent has registered (spawned processes
    pay an import + warmup before their first beat); raises
    ``TimeoutError`` naming the missing members."""
    deadline = time.monotonic() + timeout_s
    docs: Dict[str, Dict] = {}
    while time.monotonic() < deadline:
        for n in names:
            if n not in docs:
                d = read_member(fleet_dir, n)
                if d is not None:
                    docs[n] = d
        if len(docs) == len(names):
            return [docs[n] for n in names]
        time.sleep(0.1)
    missing = [n for n in names if n not in docs]
    raise TimeoutError(f"fleet members never registered: {missing} "
                       f"(dir {fleet_dir})")


# -- error mapping ---------------------------------------------------------

_TYPED = {
    "QueueFull": QueueFull,
    "DeadlineExceeded": DeadlineExceeded,
    "EngineStopped": EngineStopped,
    "KVCacheOOM": KVCacheOOM,
    "KVHandoffError": KVHandoffError,
    "TransientDeviceError": TransientDeviceError,
    "ValueError": ValueError,
    "TimeoutError": TimeoutError,
}


def _rehydrate(err: RemoteError) -> BaseException:
    """A peer's typed error frame back into the matching LOCAL exception
    type - with the dead scheduler's ``.partial`` token prefix attached
    when it rode the frame - so the Router's isinstance-driven
    failover/recovery logic cannot tell remote from local failures."""
    cls = _TYPED.get(err.type_name, RuntimeError)
    exc = cls(str(err))
    if err.meta.get("has_partial") and err.arrays:
        exc.partial = np.asarray(err.arrays[0], np.int32).reshape(-1)
    return exc


# -- the replica-side agent ------------------------------------------------

class ReplicaAgent:
    """One replica process's membership + serving endpoint.

    Wraps an engine (a :class:`~.decode_scheduler.DecodeScheduler`; a
    plain :class:`~.engine.ServingEngine` serves the non-LM subset of
    ops) with: a :class:`~.transport.TransportServer` answering fleet
    ops, a ``FileHeartbeat``-beaten member file in ``fleet_dir`` (the
    router side's liveness + load signal), and a
    ``MetricSnapshotWriter`` extended with the ``serving`` section -
    the fleet's observability rides the cluster files unchanged.

    Death discipline: a PERMANENT fault in the beat loop (the
    ``fleet/agent_beat`` chaos site), or the engine loop dying under
    us, runs :meth:`_die` - the engine's no-drain shutdown fails every
    in-flight request typed with its generated ``.partial`` (those
    error frames FLUSH over the still-open transport before the server
    closes), the member file gets a terminal ``dead: true`` beat, and
    the process exits ``DEATH_EXIT_CODE``. The router side recovers:
    partials splice through ``Router._recover_decode`` on a survivor,
    bitwise."""

    def __init__(self, engine, *, fleet_dir: str,
                 name: Optional[str] = None, role: str = "replica",
                 tags: Sequence[str] = (), beat_s: float = 0.25,
                 host: str = "127.0.0.1", port: int = 0,
                 advertise_host: Optional[str] = None,
                 snapshot_every_s: Optional[float] = None,
                 process_index: Optional[int] = None):
        if role not in ROLES:
            raise ValueError(f"role must be one of {ROLES}, got {role!r}")
        self.engine = engine
        self.fleet_dir = fleet_dir
        self.name = name or getattr(engine, "name", None) \
            or f"agent{os.getpid()}"
        self.role = role
        self.tags = tuple(tags) or tuple(getattr(engine, "tags", ()))
        self.beat_s = float(beat_s)
        self._host, self._port = host, int(port)
        # the address the MEMBER FILE carries: cross-host peers dial
        # this, not the bind address. A wildcard bind ("0.0.0.0")
        # auto-resolves to this host's outbound interface; an explicit
        # advertise_host wins (NAT/multi-homed boxes). Single-host
        # fleets keep the loopback default untouched.
        self.advertise_host = (advertise_host
                               or pick_advertise_host(host))
        self.server: Optional[TransportServer] = None
        self._hb = FileHeartbeat(member_path(fleet_dir, self.name))
        self._snap = _cluster.MetricSnapshotWriter(
            every_s=(self.beat_s if snapshot_every_s is None
                     else snapshot_every_s),
            directory=fleet_dir,
            process_index=(os.getpid() % 100000 if process_index is None
                           else process_index))
        # the snapshot's serving section reuses the beat tick's already-
        # computed section when one exists - _serving_section takes the
        # engine's stats locks, and paying that twice per tick (member
        # file + snapshot) doubles lock traffic against a hot decode
        # loop for identical data
        self._section: Optional[Dict] = None
        self._snap.add_section(
            "serving", lambda: (self._section if self._section is not None
                                else self._serving_section()))
        self._stop = threading.Event()
        self._beat_thread: Optional[threading.Thread] = None
        self._dead = False
        self._shutting_down = False
        self._finished = False
        self._died_once = threading.Lock()
        # serializes member-file/snapshot writes against the terminal
        # final/dead beat: an in-flight cadence beat landing AFTER the
        # terminal one would strip final:true - the monitor would then
        # read a cleanly-exited agent as a wedged one, the exact
        # misattribution the final flag exists to prevent
        self._beat_write = threading.Lock()
        self._started_at = time.time()
        self._handoff_ids = itertools.count()
        self.exit_code = 0

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "ReplicaAgent":
        os.makedirs(self.fleet_dir, exist_ok=True)
        self.engine.start()
        self.server = TransportServer(self._handle, host=self._host,
                                      port=self._port,
                                      name=self.name).start()
        self._hb.beat(self._member_doc())   # register before first beat
        self._beat_thread = threading.Thread(
            target=self._beat_loop, name=f"{AGENT_THREAD}[{self.name}]",
            daemon=True)
        self._beat_thread.start()
        _LOG.info("fleet agent %s (%s) serving on %s:%d, dir %s",
                  self.name, self.role, self.server.host,
                  self.server.port, self.fleet_dir)
        return self

    def run(self) -> int:
        """Drive a standalone replica process: start, serve until a
        ``shutdown`` op or death, clean up. Returns the exit code."""
        if self.server is None:
            self.start()
        self._stop.wait()
        self._finish()
        return self.exit_code

    def shutdown(self, drain: bool = True):
        """Programmatic local stop (tests / embedded agents)."""
        self._shutting_down = True
        try:
            self.engine.shutdown(drain=drain)
        finally:
            self._finish()
            t = self._beat_thread
            if t is not None and t is not threading.current_thread():
                t.join(5.0)

    def _finish(self):
        """Terminal state, exactly once: final membership beat + final
        snapshot (skipped after :meth:`_die`, which already landed its
        ``dead: true`` terminal state), stop signal, server close. Safe
        from any thread - the server close skips joining its caller."""
        with self._died_once:
            first = not self._finished
            self._finished = True
        if first and not self._dead:
            with self._beat_write:
                self._hb.beat(self._member_doc(), final=True)
                self._snap.write(final=True)
        self._stop.set()
        if self.server is not None:
            self.server.close()

    # -- membership ------------------------------------------------------

    def _serving_section(self) -> Dict:
        """The snapshot/membership ``serving`` section: the router's
        remote load/health/affinity signal (JAX's schema). Pure host
        reads."""
        eng = self.engine
        out = {"name": self.name, "role": self.role,
               "tags": list(self.tags)}
        try:
            st = eng.stats()
            out["queue_depth"] = st.get("queue_depth", 0)
            out["inflight"] = (st.get("active", 0)
                               + st.get("prefilling", 0))
            out["pending"] = st.get("pending", 0)
            out["active_version"] = st.get("active_version")
            kv = st.get("kv") or {}
            out["kv_blocks_in_use"] = kv.get("blocks_in_use")
            pre = st.get("prefix")
            if pre:
                # the prefix SUMMARY (entries/shared blocks/max chain):
                # enough for capacity planning; the per-prompt affinity
                # probe stays an RPC because it needs the prompt
                out["prefix"] = {
                    "entries": pre.get("entries"),
                    "shared_blocks": pre.get("shared_blocks"),
                    "max_chain_blocks": pre.get("max_chain_blocks")}
        except Exception:  # noqa: BLE001 - membership must not die
            pass
        for attr in ("hit_align", "max_seq_len", "prefill_chunk"):
            v = getattr(eng, attr, None)
            if v is not None:
                out[attr] = int(v)
        kvc = getattr(eng, "kv", None)
        if kvc is not None:
            out["block_size"] = int(kvc.block_size)
        return out

    def _member_doc(self, section: Optional[Dict] = None) -> Dict:
        return {"schema": MEMBER_SCHEMA, "name": self.name,
                "role": self.role, "tags": list(self.tags),
                "host": self.advertise_host,
                "port": self.server.port if self.server else self._port,
                "started_at": self._started_at,
                "dead": self._dead,
                "serving": (self._serving_section() if section is None
                            else section)}

    def _beat_loop(self):
        """The agent's heartbeat: one member-file rewrite + one snapshot
        cadence check per tick. The ``fleet/agent_beat`` chaos seam
        fires here - a transient rule skips ONE beat (reads as a late
        beat), a wedge rule goes silent until the monitor's staleness
        threshold drains us (and rejoins on recovery), a permanent rule
        IS the agent-death drill."""
        while not self._stop.is_set():
            try:
                _chaos.maybe_fire("fleet/agent_beat", tag=self.name)
            except BaseException as e:  # noqa: BLE001 - classify
                if classify_failure(e) == TRANSIENT:
                    if obs.enabled():
                        obs.counter("serve/fleet_beat_faults").inc()
                    self._stop.wait(self.beat_s)
                    continue
                self._die(f"injected agent fault: "
                          f"{type(e).__name__}: {e}")
                return
            et = getattr(self.engine, "_thread", None)
            if et is not None and not et.is_alive() \
                    and not self._stop.is_set() \
                    and not self._shutting_down:
                # the engine loop died under us (a permanent dispatch
                # fault): its _die already failed every in-flight
                # request typed-with-partial - finish the job as a
                # whole-process death so the fleet stops routing here.
                # (a CLEANLY drained engine - the shutdown op sets
                # _shutting_down first - is not a death)
                self._die("engine loop died")
                return
            sec = self._serving_section()
            with self._beat_write:
                # re-check under the write lock: _finish/_die may have
                # landed the terminal beat while this tick was building
                # its doc - a cadence beat must never overwrite it
                if self._finished or self._dead:
                    return
                self._section = sec
                self._hb.beat(self._member_doc(sec))
                if obs.enabled():
                    obs.counter("serve/fleet_beats").inc()
                self._snap.maybe_write()
            self._stop.wait(self.beat_s)

    def _die(self, reason: str):
        """Agent death: fail in-flight typed-with-partial (the error
        frames flush over the open transport - the router's
        KV-preserving splice point), mark the member file dead, stop."""
        with self._died_once:
            if self._dead:
                return
            self._dead = True
        _LOG.error("fleet agent %s dying: %s", self.name, reason)
        _health.emit("fleet_agent_died", agent=self.name,
                     reason=reason)
        if obs.enabled():
            obs.counter("serve/fleet_agent_deaths").inc()
        try:
            # no-drain shutdown: every in-flight request fails typed
            # EngineStopped with .partial - the submit handlers' done
            # callbacks send those error frames NOW, before the server
            # closes below
            self.engine.shutdown(drain=False, timeout=10.0)
        except Exception:  # noqa: BLE001 - dying anyway
            pass
        with self._died_once:
            self._finished = True   # the dead beat IS the terminal state
        with self._beat_write:
            self._hb.beat(self._member_doc(), final=True)
            self._snap.write(final=True)
        self.exit_code = DEATH_EXIT_CODE
        self._stop.set()
        if self.server is not None:
            # safe from any thread - close skips joining its caller
            self.server.close()

    # -- op handlers -----------------------------------------------------

    def _handle(self, reply, op, meta, arrays):
        if op == "ping":
            reply({"name": self.name, "role": self.role,
                   "tags": list(self.tags)})
        elif op == "submit":
            self._op_submit(reply, meta, arrays)
        elif op == "stats":
            st = dict(self.engine.stats())
            # this process's kernel launches: a parent counts what its
            # agents launched through here
            st["launches"] = _kernels.launch_counts()
            st["launches_by_route"] = _kernels.launches_by_route()
            reply(_flight._json_safe(st))
        elif op == "prefix_probe":
            probe = getattr(self.engine, "cached_prefix_tokens", None)
            n = int(probe(arrays[0])) if callable(probe) else 0
            reply({"tokens": n})
        elif op == "publish":
            # placement runs for seconds on a real model - off the
            # connection's reader thread, like the handoff ops, so
            # in-flight submits/probes on this connection keep flowing
            # through the whole swap window (errors reply typed; a
            # failed publish is the swapping caller's problem, not a
            # dying agent)
            self._spawn_op(self._op_publish, reply, meta, arrays)
        elif op == "activate":
            self.engine.registry.activate(meta["version"])
            try:
                self.engine._bump("swaps")
            except Exception:  # noqa: BLE001 - stats only
                pass
            if obs.enabled():
                obs.instant("serve/swap", version=meta["version"],
                            replica=self.name)
            reply({"version": meta["version"]})
        elif op == "retire":
            self.engine.registry.retire(meta["version"])
            reply({"version": meta["version"]})
        elif op == "set_role":
            # the controller's promotion seam: roles are discovery/
            # routing labels (every scheduler-backed agent serves every
            # op), so a decode->prefill promotion is a label flip plus
            # an immediate member-file rewrite - peers discover the new
            # duty on their next directory read, no engine restart
            role = meta["role"]
            if role not in ROLES:
                raise ValueError(f"role must be one of {ROLES}, "
                                 f"got {role!r}")
            old = self.role
            self.role = role
            if "tags" in meta:
                self.tags = tuple(meta["tags"])
            with self._beat_write:
                if not (self._finished or self._dead):
                    self._section = self._serving_section()
                    self._hb.beat(self._member_doc(self._section))
            if obs.enabled():
                obs.instant("serve/fleet_role_flip", agent=self.name,
                            from_role=old, to_role=role)
            _health.emit("fleet_role_flip", agent=self.name,
                         from_role=old, to_role=role)
            reply({"role": role, "was": old})
        elif op == "prefill_export":
            self._guard_handoff(self._export_prefix, reply, meta, arrays)
        elif op == "adopt_prefix":
            self._guard_handoff(self._adopt_prefix, reply, meta, arrays)
        elif op == "chaos_arm":
            _chaos.arm(meta["plan"])
            reply({"armed": True})
        elif op == "chaos_stats":
            reply(_chaos.stats())
        elif op == "shutdown":
            et = getattr(self.engine, "_thread", None)
            if (not self._shutting_down and not self._dead
                    and et is not None and not et.is_alive()):
                # the engine loop already died organically - the beat
                # loop's death detection (one beat_s tick of latency)
                # races a router drain RPC here. A dead engine must
                # never launder into a clean exit 0: answer typed so
                # the caller's drain moves on, then take the death
                # path (DEATH_EXIT_CODE, dead member file).
                reply(error={"type": "EngineStopped",
                             "msg": f"agent {self.name}: engine loop "
                                    "died before shutdown"})
                self._die("engine loop died (caught at shutdown)")
                return
            drain = bool(meta.get("drain", True))
            self._shutting_down = True
            self.engine.shutdown(drain=drain)
            st = self.engine.stats()
            reply({"kv_blocks_in_use": (st.get("kv") or {}).get(
                "blocks_in_use"), "stats": _flight._json_safe(
                {k: v for k, v in st.items() if k != "prefix"})})
            self._finish()
        else:
            raise ValueError(f"unknown fleet op {op!r}")

    def _op_submit(self, reply, meta, arrays):
        kw = {}
        for k in ("max_new_tokens", "deadline_ms", "temperature",
                  "top_p", "seed", "eos_id"):
            # presence-based, not None-filtered: an EXPLICIT
            # eos_id=None (disable EOS stopping - distinct from the
            # scheduler's "default" sentinel) must survive the wire,
            # or remote tokens diverge from the in-process replica's
            if k in meta:
                kw[k] = meta[k]
        fut = self.engine.submit(arrays[0], **kw)
        if obs.enabled():
            obs.counter("serve/fleet_agent_submits").inc()

        def done(f):
            exc = f.exception()
            if exc is None:
                reply(meta={"version": f.version,
                            "trace": _flight._json_safe(f.trace)},
                      arrays=[np.asarray(f.result(), np.int32)])
                return
            partial = getattr(exc, "partial", None)
            err = {"type": type(exc).__name__, "msg": str(exc)}
            if partial is not None:
                reply(meta={"has_partial": True},
                      arrays=[np.asarray(partial, np.int32).reshape(-1)],
                      error=err)
            else:
                reply(error=err)

        fut.add_done_callback(done)

    def _op_publish(self, reply, meta, arrays):
        params = _torch_tree(decode_tree(meta["params_spec"], arrays))
        if meta.get("state_is_none", True):
            # the params-only swap contract, applied replica-side: the
            # compiled step's state pytree must not change shape
            cur = self.engine.registry.current()
            state = (cur.state if cur is not None
                     else getattr(self.engine.model, "state", None))
        else:
            state = _torch_tree(decode_tree(meta["state_spec"], arrays))
        v = self.engine.registry.publish(
            params, state, version=meta.get("version"),
            activate=bool(meta.get("activate", False)))
        reply({"version": v})

    # -- disaggregation: prefill export / decode adopt -------------------

    def _spawn_op(self, fn, reply, meta, arrays):
        """Run a slow op on its own worker thread, answering typed on
        failure (no death discipline - for ops whose failure is the
        caller's error, not an agent fault)."""
        def run():
            try:
                fn(reply, meta, arrays)
            except BaseException as e:  # noqa: BLE001 - answer typed
                self._try_reply(reply, {"type": type(e).__name__,
                                        "msg": str(e)})

        threading.Thread(target=run,
                         name=f"{AGENT_THREAD}-op[{self.name}]",
                         daemon=True).start()

    def _guard_handoff(self, fn, reply, meta, arrays):
        """Handoff ops under the death discipline, on their OWN worker
        thread: an export may block minutes on a cold prefill, and the
        transport contract says handlers must not camp on the
        connection's reader thread (a concurrent export/stats/shutdown
        RPC would sit unread in the socket behind it - the prefill pool
        could never pipeline). A typed refusal (:class:`KVHandoffError`)
        and a transient fault answer the client and leave the agent
        alive; a PERMANENT fault (the ``fleet/handoff`` chaos site's
        death drill, or a genuinely dead device under the page fetch)
        kills THIS agent AFTER the typed error frame goes out - process
        death mid-handoff must be a routine, recovered event on the
        client side (it degrades to a plain submit), not a special
        case."""
        def run():
            try:
                fn(reply, meta, arrays)
            except KVHandoffError as e:
                self._try_reply(reply, {"type": "KVHandoffError",
                                        "msg": str(e)})
            except BaseException as e:  # noqa: BLE001 - classify
                self._try_reply(reply, {"type": type(e).__name__,
                                        "msg": str(e)})
                if classify_failure(e) != TRANSIENT:
                    self._die(f"permanent handoff fault: "
                              f"{type(e).__name__}: {e}")

        threading.Thread(target=run,
                         name=f"{AGENT_THREAD}-handoff[{self.name}]",
                         daemon=True).start()

    @staticmethod
    def _try_reply(reply, error: Dict):
        """Error-frame a handoff failure; swallow a double-reply (the
        op already answered before raising) - the client is resolved
        either way."""
        try:
            reply(error=error)
        except Exception:  # noqa: BLE001 - already replied
            pass

    def _export_prefix(self, reply, meta, arrays):
        """Prefill-specialist op: make the prompt's aligned prefix
        resident (running its chunked prefill here if it is not), then
        export the prefix-cache chain's KV pages + content keys for a
        decode specialist to adopt. The ``fleet/handoff`` chaos seam
        fires first: an injected fault presents to the client exactly
        like a specialist dying mid-handoff (degrade to plain submit,
        never block the request)."""
        _chaos.maybe_fire("fleet/handoff", tag=self.name)
        sched = self.engine
        prefix = getattr(sched, "prefix", None)
        if prefix is None:
            raise KVHandoffError(
                "prefill specialist needs a prefix cache (the export "
                "handle IS a prefix entry)")
        prompt = np.asarray(arrays[0], np.int32).reshape(-1)
        align = int(sched.hit_align)
        n = (int(prompt.size) // align) * align
        if n <= 0:
            reply({"tokens": 0})
            return
        sub = prompt[:n]
        v = sched.registry.current().version
        if sched.cached_prefix_tokens(sub) < n:
            # cold: run the aligned prefix's chunked prefill here (one
            # discarded token - the cheapest way to ride the exact
            # admission/registration path the bitwise gates pin); the
            # export keys under the version the prefill actually pinned
            fut = sched.submit(sub, max_new_tokens=1)
            # sync-ok: export waits for the prefill it is exporting
            fut.result(timeout=float(meta.get("timeout_s", 300.0)))
            v = fut.version or v
        chain = prefix.lookup(sub, v)
        bs = sched.kv.block_size
        usable = min(len(chain) * bs, n)
        usable -= usable % align
        if usable <= 0:
            reply({"tokens": 0})
            return
        ids = chain[:usable // bs]
        # pin against a concurrent eviction between lookup and export;
        # LOSING that race (an admission-path evict freed the chain
        # between the two calls) is a routine typed refusal - the
        # client degrades to a plain submit - not a dying specialist.
        # The pins are no prefix entry's: the scheduler's audit waits
        # until they are released (else it reads them as a leak and
        # quarantines the pool)
        with sched._audit_lock:
            try:
                sched.kv.retain(ids)
            except ValueError as e:
                raise KVHandoffError(
                    f"prefix evicted during export: {e}") from e
            try:
                _, layers = sched.kv.export_blocks(blocks=ids)
            finally:
                sched.kv.release(ids)
        keys = [k.hex() for k in chain_keys(prompt[:usable], bs, v)]
        out_arrays = [prompt[:usable]]
        digest = hashlib.blake2b(digest_size=16)
        nbytes = 0
        for k, vv in layers:
            for a in (k, vv):
                b = _leaf_bytes(a)
                digest.update(b)
                nbytes += len(b)
                out_arrays.append(a)
        if obs.enabled():
            obs.counter("serve/fleet_handoff_exports").inc()
            obs.counter("serve/fleet_handoff_bytes").inc(nbytes)
        reply(meta={"tokens": usable, "version": v, "keys": keys,
                    "geometry": sched.kv.geometry(),
                    "digest": digest.hexdigest()},
              arrays=out_arrays)

    def _adopt_prefix(self, reply, meta, arrays):
        """Decode-specialist op: verify and adopt a handed-off prefix.
        The chain hash is re-derived HERE from the tokens under THIS
        replica's active version - the exported keys must match
        exactly, so a corrupt payload or a version-skewed handoff is
        refused typed before any page lands; the page digest guards the
        raw bytes themselves. On success the prefix is an ordinary
        content-addressed cache entry: the next submit of a prompt
        carrying it takes the warm-hit path (bitwise the cold
        decode)."""
        _chaos.maybe_fire("fleet/handoff", tag=self.name)
        sched = self.engine
        prefix = getattr(sched, "prefix", None)
        try:
            if prefix is None or getattr(sched, "_quarantined", False):
                raise KVHandoffError(
                    "replica cannot adopt: prefix cache disabled or "
                    "ledger quarantined")
            tokens = np.asarray(arrays[0], np.int32).reshape(-1)
            mv = sched.registry.current()
            if meta.get("version") != mv.version:
                raise KVHandoffError(
                    f"version skew: handoff built under "
                    f"{meta.get('version')!r}, replica serves "
                    f"{mv.version!r} - refusing stale KV")
            geo = sched.kv.geometry()
            if meta.get("geometry") != geo:
                raise KVHandoffError(
                    f"geometry mismatch: {meta.get('geometry')} vs "
                    f"{geo}")
            bs = sched.kv.block_size
            want_keys = [k.hex() for k in chain_keys(tokens, bs,
                                                     mv.version)]
            if want_keys != list(meta.get("keys", ())):
                raise KVHandoffError(
                    "content chain-hash mismatch - the tokens do not "
                    "derive the exported keys under this version; "
                    "refusing corrupt handoff")
            pages = arrays[1:]
            if len(pages) != 2 * geo["n_layers"]:
                raise KVHandoffError(
                    f"expected {2 * geo['n_layers']} page arrays, got "
                    f"{len(pages)}")
            digest = hashlib.blake2b(digest_size=16)
            for a in pages:
                digest.update(_leaf_bytes(a))
            if digest.hexdigest() != meta.get("digest"):
                raise KVHandoffError(
                    "page digest mismatch - KV bytes corrupted in "
                    "transit; refusing handoff")
        except KVHandoffError as e:
            if obs.enabled():
                obs.counter("serve/fleet_handoff_refused").inc()
            _health.emit("fleet_handoff_refused", agent=self.name,
                         reason=str(e))
            raise
        layers = [(pages[2 * i], pages[2 * i + 1])
                  for i in range(len(pages) // 2)]
        owner = ("handoff", next(self._handoff_ids))
        # the owner table and the prefix entry change apart: the
        # scheduler's audit waits until both are done
        with sched._audit_lock:
            ids = self._adopt_pages(sched, prefix, owner, layers, tokens, mv)
        if obs.enabled():
            obs.counter("serve/fleet_handoff_adopts").inc()
            obs.counter("serve/fleet_handoff_blocks").inc(len(ids))
        reply({"adopted_blocks": len(ids), "tokens": int(tokens.size)})

    def _adopt_pages(self, sched, prefix, owner, layers, tokens, mv):
        """Adopt the pages under ``owner`` and register them as the
        prefix entry of ``tokens``; returns the adopted block ids."""
        try:
            try:
                ids = sched.kv.adopt_serialized(owner, layers)
            except KVCacheOOM:
                # block pressure: reclaim unreferenced prefix entries
                # like admission does, then retry ONCE
                prefix.evict(len(layers[0][0]))
                ids = sched.kv.adopt_serialized(owner, layers)
        except KVCacheOOM as e:
            # a still-full pool is routine block pressure on a busy
            # decode replica, not a dying agent: refuse typed so the
            # client degrades to a plain submit (the replica prefills
            # itself) instead of _guard_handoff reading the OOM as a
            # permanent fault and killing the process
            if obs.enabled():
                obs.counter("serve/fleet_handoff_refused").inc()
            _health.emit("fleet_handoff_refused", agent=self.name,
                         reason=str(e))
            raise KVHandoffError(
                f"adopt refused under block pressure: {e}") from e
        try:
            prefix.insert(tokens, mv.version, ids)
        finally:
            sched.kv.free(owner)
        return ids


# -- the router-side adapter -----------------------------------------------

class _RemoteVersion:
    """What ``RemoteReplica.registry.current()`` hands ``Router.swap``:
    ``state=None`` routes the state-inherit decision to the AGENT side
    (its registry holds the real active state - shipping it back and
    forth would copy the model twice per swap for nothing)."""
    __slots__ = ("version", "params", "state")

    def __init__(self, version):
        self.version = version
        self.params = None
        self.state = None


class _RemoteRegistry:
    """The registry shim ``Router.swap``'s two-phase protocol drives:
    ``publish`` ships the param tree (raw leaf bytes, one frame) and
    returns after the REMOTE placement finished - so the router's
    all-published-before-any-activates guarantee spans processes."""

    def __init__(self, rep: "RemoteReplica",
                 publish_timeout_s: float = 600.0):
        self._rep = rep
        self._timeout = publish_timeout_s

    def current(self):
        return _RemoteVersion(self._rep.active_version())

    def publish(self, params, state=None, version: Optional[str] = None,
                activate: bool = False) -> str:
        bufs: List[np.ndarray] = []
        spec = encode_tree(_np_tree(params), bufs)
        meta = {"version": version, "params_spec": spec,
                "state_is_none": state is None, "activate": activate}
        if state is not None:
            meta["state_spec"] = encode_tree(_np_tree(state), bufs)
        m, _ = self._rep._request("publish", meta, bufs,
                                  timeout=self._timeout)
        return m["version"]

    def activate(self, version: str):
        self._rep._request("activate", {"version": version},
                           timeout=self._timeout)

    def retire(self, version: str):
        self._rep._request("retire", {"version": version},
                           timeout=self._timeout)


def _np_tree(tree):
    """A parameter tree with host leaves (the publish wire format): numpy
    arrays, and CPU bfloat16 tensors (numpy has no bfloat16; the
    transport sends their raw 2-byte buffers). The device-to-host fetch
    is deliberate and rides the SWAPPING caller's thread, exactly where
    the registry contract puts placement cost."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return t if t.dtype == torch.bfloat16 else t.numpy()
    if isinstance(tree, TreeCarrier):       # a quantized weight
        return tree.map(_np_tree)
    return tree


def _torch_tree(tree):
    """A decoded tree's array leaves as tensors (the registry places
    tensors; bfloat16 leaves arrive as tensors already)."""
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_torch_tree(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    if isinstance(tree, TreeCarrier):
        return tree.map(_torch_tree)
    return tree


def _leaf_bytes(a) -> bytes:
    """A page array's raw bytes (the handoff digest's input)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    return np.ascontiguousarray(a).tobytes()


class RemoteReplica:
    """An engine-shaped handle to a fleet agent in another process.

    Presents the exact surface the :class:`~.router.Router` dispatches
    against - ``submit(payload, deadline_ms=..., **kw) -> ServeFuture``,
    ``name``/``beacon_name``/``tags``, ``registry`` (the two-phase swap
    shim), ``cached_prefix_tokens`` (the affinity probe, an RPC with a
    short timeout that degrades to 0), ``start``/``shutdown``/``stats``
    - so a fleet of processes drops into the router's replica list with
    zero routing-logic changes. Failure mapping: a transient transport
    fault raises typed from ``submit`` (the router's try-next-replica
    path); a LOST connection fails in-flight futures ``EngineStopped``
    and makes later submits raise it too (the router marks the replica
    dead); a dying scheduler's error frames carry ``.partial`` (the
    router's KV-preserving splice)."""

    def __init__(self, doc: Optional[Dict] = None, *,
                 fleet_dir: Optional[str] = None,
                 name: Optional[str] = None,
                 probe_timeout_s: float = 2.0,
                 rpc_timeout_s: float = 120.0):
        if doc is None:
            if fleet_dir is None or name is None:
                raise ValueError("pass a member doc, or fleet_dir+name")
            doc = read_member(fleet_dir, name)
            if doc is None:
                raise ValueError(f"no fleet member {name!r} registered "
                                 f"in {fleet_dir}")
        self.doc = doc
        self.fleet_dir = fleet_dir
        self.name = doc["name"]
        self.role = doc.get("role", "replica")
        self.tags = tuple(doc.get("tags", ()))
        self.host, self.port = doc["host"], int(doc["port"])
        self.beacon_name = f"serving/fleet[{self.name}]"
        self.registry = _RemoteRegistry(self)
        self.model = _RemoteVersion(None)   # .state for Router.swap
        self._client = TransportClient(self.host, self.port,
                                       name=self.name)
        self._probe_timeout = float(probe_timeout_s)
        self._rpc_timeout = float(rpc_timeout_s)
        self._active_version: Optional[str] = doc.get(
            "serving", {}).get("active_version")
        self._stats: Dict[str, int] = {}

    # -- engine surface --------------------------------------------------

    def start(self) -> "RemoteReplica":
        self._client.connect()
        return self

    def submit(self, payload, deadline_ms: Optional[float] = None,
               **kw) -> ServeFuture:
        """Dispatch one request to the remote engine. The frame SEND is
        synchronous (a flaky-fabric fault raises typed right here, into
        the router's transient retry); the returned future resolves
        from the transport receiver thread when the remote answers."""
        prompt = np.asarray(payload, np.int32).reshape(-1)
        meta = {"deadline_ms": deadline_ms}
        for k in ("max_new_tokens", "temperature", "top_p", "seed",
                  "eos_id"):
            # forward exactly what the caller passed - an explicit
            # eos_id=None is a real override (disable EOS stopping),
            # not an absence; dropping it would silently re-enable the
            # remote scheduler's default and break process transparency
            if k in kw:
                meta[k] = kw[k]
        unknown = set(kw) - {"max_new_tokens", "temperature", "top_p",
                             "seed", "eos_id"}
        if unknown:
            raise ValueError(f"unsupported remote submit kwargs "
                             f"{sorted(unknown)}")
        outer = ServeFuture()
        if self._client.closed:
            raise EngineStopped(
                f"fleet transport to {self.name} is closed")
        try:
            inner = self._client.request_async("submit", meta, [prompt])
        except TransportClosed as e:
            raise EngineStopped(
                f"fleet replica {self.name} unreachable: {e}") from e
        if obs.enabled():
            obs.counter("serve/fleet_remote_submits").inc()

        def done(f):
            exc = f.exception()
            if exc is None:
                m, arrays = f.result()
                outer.version = m.get("version")
                outer.trace = m.get("trace")
                self._active_version = m.get("version") \
                    or self._active_version
                res = (np.asarray(arrays[0], np.int32).reshape(-1)
                       if arrays else np.zeros((0,), np.int32))
                try:
                    outer.set_result(res)
                except Exception:  # noqa: BLE001 - cancelled outer
                    pass
                return
            if isinstance(exc, RemoteError):
                exc = _rehydrate(exc)
            elif isinstance(exc, TransportClosed):
                exc = EngineStopped(
                    f"fleet replica {self.name} connection lost mid-"
                    f"request: {exc}")
            try:
                outer.set_exception(exc)
            except Exception:  # noqa: BLE001 - cancelled outer
                pass

        inner.add_done_callback(done)
        return outer

    def generate(self, prompt_ids, max_new_tokens: int,
                 timeout: Optional[float] = None, **kw):
        return self.submit(prompt_ids, max_new_tokens=max_new_tokens,
                           **kw).result(timeout)

    def cached_prefix_tokens(self, prompt_ids) -> int:
        """The router's prefix-affinity probe, over the wire. Degrades
        to 0 on any fault/timeout - a probe must never stall dispatch."""
        try:
            m, _ = self._request(
                "prefix_probe", arrays=[np.asarray(prompt_ids, np.int32)],
                timeout=self._probe_timeout)
            return int(m.get("tokens", 0))
        except Exception:  # noqa: BLE001 - degrade, never stall routing
            return 0

    def stats(self) -> Dict:
        m, _ = self._request("stats", timeout=self._rpc_timeout)
        return m

    def active_version(self) -> Optional[str]:
        return self._active_version

    def member(self) -> Optional[Dict]:
        """The latest membership doc (None once the file is gone)."""
        if self.fleet_dir is None:
            return None
        return read_member(self.fleet_dir, self.name)

    def reconnect(self) -> bool:
        """Re-establish a LOST transport from the latest member doc (a
        restarted agent registers a fresh port). The agent may be
        perfectly alive behind a torn connection - one transient frame
        loss must not remove a healthy, still-beating replica from the
        fleet forever. The FleetMonitor calls this when the member file
        is fresh but the client is closed; the subsequent ``not down``
        tick emits ``stall_recovered`` and the router rejoins. Returns
        True when a fresh connection is up."""
        doc = self.member() or self.doc
        if doc.get("dead") or doc.get("final"):
            return False
        try:
            cli = TransportClient(doc["host"], int(doc["port"]),
                                  name=self.name).connect()
        except OSError:
            return False
        old = self._client
        self.doc = doc
        self.host, self.port = doc["host"], int(doc["port"])
        self._client = cli
        old.close()
        return True

    def shutdown(self, drain: bool = True, timeout: float = 120.0):
        """Stop the REMOTE agent (drain by default), then drop the
        connection. Unreachable agents are already down - ignored."""
        try:
            if not self._client.closed:
                self._request("shutdown", {"drain": drain},
                              timeout=timeout)
        except Exception:  # noqa: BLE001 - the agent is gone either way
            pass
        self._client.close()

    def close(self):
        """Drop the connection WITHOUT stopping the remote agent."""
        self._client.close()

    # -- fleet ops -------------------------------------------------------

    def prefill_export(self, prompt, timeout: Optional[float] = None):
        """(meta, arrays) of the remote's exported aligned prefix."""
        return self._request(
            "prefill_export", {"timeout_s": timeout or self._rpc_timeout},
            [np.asarray(prompt, np.int32)],
            timeout=timeout or self._rpc_timeout)

    def adopt_prefix(self, meta: Dict, arrays,
                     timeout: Optional[float] = None):
        return self._request("adopt_prefix", meta, arrays,
                             timeout=timeout or self._rpc_timeout)

    def chaos_arm(self, plan: Dict):
        """Arm a chaos plan INSIDE the agent process (campaign drills)."""
        return self._request("chaos_arm", {"plan": plan},
                             timeout=self._rpc_timeout)

    def set_role(self, role: str, tags: Optional[Sequence[str]] = None):
        """Flip the remote agent's duty label (controller promotion).
        The agent rewrites its member file immediately; this handle's
        ``role``/``tags`` mirror the flip on the ack."""
        meta: Dict = {"role": role}
        if tags is not None:
            meta["tags"] = list(tags)
        m, _ = self._request("set_role", meta, timeout=self._rpc_timeout)
        self.role = m["role"]
        if tags is not None:
            self.tags = tuple(tags)
        return m

    def _request(self, op, meta=None, arrays=(), timeout=None):
        self._client.connect()
        try:
            return self._client.request(op, meta, arrays, timeout=timeout)
        except RemoteError as e:
            raise _rehydrate(e) from None

    def _bump(self, key: str, n: int = 1):
        self._stats[key] = self._stats.get(key, 0) + n


# -- file-heartbeat health monitor -----------------------------------------

class FleetMonitor:
    """Watches the fleet directory and converts membership-file
    staleness into the health events the Router already acts on.

    For each :class:`RemoteReplica`: a member file that is marked
    ``dead``, has gone stale past ``stale_s``, or whose transport
    connection dropped, emits ``health/stall`` with the replica's
    beacon name - the router DRAINS it and fails over its in-flight
    work exactly as if a local stall beacon fired; a member that beats
    again emits ``health/stall_recovered`` and rejoins. A ``final``
    (cleanly drained) member is treated as down without the alarm.
    One monitor thread per router process; pure host file reads.

    Staleness is CROSS-HOST SAFE: it is judged by beat-COUNTER progress
    against THIS OBSERVER's monotonic clock - the member's ``beat``
    counter not advancing for ``stale_s`` observer-seconds is the stall
    signal, exactly how the in-job ``failure.Heartbeat`` judges peers
    by counter progress. The member file's wall-clock ``written_at``
    stamp is never compared against the observer's wall clock, so an
    agent on a host whose clock is skewed hours off (NTP drift, a VM
    resume) cannot be false-killed while it is beating perfectly well -
    and a frozen observer clock cannot hide a genuinely wedged agent."""

    def __init__(self, replicas: Sequence[RemoteReplica], *,
                 fleet_dir: str, every_s: float = 0.25,
                 stale_s: float = 5.0):
        self.replicas = list(replicas)
        self.fleet_dir = fleet_dir
        self.every_s = float(every_s)
        self.stale_s = float(stale_s)
        self._up: Dict[str, bool] = {r.name: True for r in self.replicas}
        # per-member (last beat counter seen, observer-monotonic stamp
        # of when it last ADVANCED) - the cross-host-safe staleness
        # state; a member first seen counts as advancing right then
        self._progress: Dict[str, tuple] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _progress_age_s(self, name: str, doc: Optional[Dict],
                        now: float) -> float:
        """Observer-monotonic seconds since ``name``'s beat counter last
        advanced; ``inf`` for a missing doc (nothing to make progress)."""
        if doc is None:
            # a transient read miss (file mid-rewrite) must NOT reset
            # the staleness clock: keep the (beat, stamp) entry so the
            # next successful read continues a frozen member's age
            # instead of re-seeding it at 0. unwatch() is what forgets
            # a member for good.
            return float("inf")
        beat = doc.get("beat")
        if not isinstance(beat, (int, float)):
            return float("inf")
        last = self._progress.get(name)
        # any counter CHANGE is progress - a restarted agent's counter
        # resets to 1, and "went backwards" must read as a fresh
        # incarnation beating, not as ten minutes of silence
        if last is None or beat != last[0]:
            self._progress[name] = (beat, now)
            return 0.0
        return max(0.0, now - last[1])

    def start(self) -> "FleetMonitor":
        self._thread = threading.Thread(target=self._loop,
                                        name=MONITOR_THREAD, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(5.0)

    def watch(self, rep: RemoteReplica):
        """Start monitoring a replica that joined after start() (the
        controller's scale-up path). Idempotent by name."""
        if all(r.name != rep.name for r in self.replicas):
            self.replicas.append(rep)
        self._up.setdefault(rep.name, True)

    def unwatch(self, name: str):
        """Stop monitoring a retired replica (scale-down): its member
        file going final/stale afterwards is retirement, not a stall."""
        self.replicas = [r for r in self.replicas if r.name != name]
        self._up.pop(name, None)
        self._progress.pop(name, None)

    def _loop(self):
        while not self._stop.is_set():
            alive = 0
            for rep in list(self.replicas):
                doc = read_member(self.fleet_dir, rep.name)
                # beat-counter progress vs OUR monotonic clock - never
                # the member file's wall-clock stamp (cross-host skew
                # must not false-kill a beating agent)
                age = self._progress_age_s(rep.name, doc,
                                           time.monotonic())
                dead = bool(doc and doc.get("dead"))
                finished = bool(doc and doc.get("final") and not dead)
                if (doc is not None and not dead and not finished
                        and age <= self.stale_s and rep._client.closed):
                    # fresh beats behind a torn connection: the agent
                    # is alive - re-dial it (agent restarts land a new
                    # port; reconnect reads the latest doc) so the
                    # rejoin below can actually happen
                    try:
                        rep.reconnect()
                    except Exception:  # noqa: BLE001 - stays down
                        pass
                down = (doc is None or dead or finished
                        or age > self.stale_s
                        or rep._client.closed)
                if not down:
                    alive += 1
                was_up = self._up.get(rep.name, True)
                if down and was_up:
                    self._up[rep.name] = False
                    if not finished:
                        _health.emit(
                            "stall", component=rep.beacon_name,
                            source="fleet_monitor", age_s=round(age, 3)
                            if age != float("inf") else None,
                            dead=dead)
                        if obs.enabled():
                            obs.counter("serve/fleet_agent_drains").inc()
                elif not down and not was_up:
                    self._up[rep.name] = True
                    _health.emit("stall_recovered",
                                 component=rep.beacon_name,
                                 source="fleet_monitor")
            if obs.enabled():
                obs.gauge("serve/fleet_agents_alive").set(alive)
            self._stop.wait(self.every_s)


# -- disaggregated prefill/decode front ------------------------------------

class DisaggregatedFleet:
    """The prefill-pool/decode-pool front: long prompts prefill on a
    specialist, their KV hands off in one framed binary hop, and the
    request itself rides the ordinary Router - whose prefix-affinity
    probe steers it to the adopting replica, where admission takes the
    warm-hit path (tokens bitwise the monolithic scheduler).

    Failure discipline: ANY handoff failure - specialist death
    mid-export (``fleet/handoff`` chaos), a refused adopt
    (:class:`KVHandoffError` - corrupt/version-skewed payloads), block
    pressure on the decode side - is counted and DEGRADED: the request
    submits normally and the decode replica runs its own prefill.
    Slower, never lost, never wrong."""

    def __init__(self, router, prefill: Sequence[RemoteReplica],
                 decode: Sequence[RemoteReplica], *,
                 min_handoff_tokens: Optional[int] = None,
                 handoff_timeout_s: float = 300.0):
        self.router = router
        self.prefill = list(prefill)
        self.decode = list(decode)
        if not self.prefill or not self.decode:
            raise ValueError("need at least one prefill and one decode "
                             "replica")
        # the alignment the specialists share: exported prefixes are
        # hit_align-aligned, so a shorter prompt cannot hand off
        self.align = int(self.prefill[0].doc.get("serving", {})
                         .get("hit_align", 8))
        self.min_handoff_tokens = (self.align if min_handoff_tokens is None
                                   else int(min_handoff_tokens))
        self.handoff_timeout_s = float(handoff_timeout_s)
        self._rr = 0
        self._stats = {"handoffs": 0, "handoff_tokens": 0,
                       "handoff_failed": 0, "handoff_refused": 0,
                       "direct": 0}
        self._lock = threading.Lock()

    def submit(self, prompt_ids, max_new_tokens: int,
               klass: str = "default", **kw) -> ServeFuture:
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        n = (int(prompt.size) // self.align) * self.align
        if n >= self.min_handoff_tokens:
            self._handoff(prompt[:n])
        else:
            self._bump("direct")
        return self.router.submit(prompt, klass=klass,
                                  max_new_tokens=max_new_tokens, **kw)

    def _handoff(self, sub: np.ndarray):
        try:
            pf = next((p for p in self.prefill if not p._client.closed),
                      None)
            if pf is None:
                raise EngineStopped("no live prefill specialist")
            t0 = time.monotonic()
            meta, arrays = pf.prefill_export(
                sub, timeout=self.handoff_timeout_s)
            if meta.get("tokens", 0) <= 0:
                self._bump("direct")
                return
            healthy = set(self.router.healthy_replicas())
            targets = [d for d in self.decode
                       if d.name in healthy and not d._client.closed]
            if not targets:
                raise EngineStopped("no live decode replica to adopt")
            with self._lock:
                self._rr += 1
                target = targets[self._rr % len(targets)]
            target.adopt_prefix(
                {"version": meta["version"], "keys": meta["keys"],
                 "geometry": meta["geometry"],
                 "digest": meta["digest"]},
                arrays, timeout=self.handoff_timeout_s)
            self._bump("handoffs")
            self._bump("handoff_tokens", int(meta["tokens"]))
            if obs.enabled():
                obs.counter("serve/fleet_handoffs").inc()
                obs.counter("serve/fleet_handoff_tokens").inc(
                    int(meta["tokens"]))
                # per-hop export->adopt wall time: the number that says
                # whether the handoff hop is paying for itself against
                # the decode replica just prefilling locally
                obs.histogram("serve/fleet_handoff_ms",
                              unit="ms").observe(
                    (time.monotonic() - t0) * 1000.0)
        except KVHandoffError as e:
            self._bump("handoff_refused")
            _LOG.warning("KV handoff refused (degrading to plain "
                         "submit): %s", e)
        except Exception as e:  # noqa: BLE001 - degrade, never fail
            self._bump("handoff_failed")
            if obs.enabled():
                obs.counter("serve/fleet_handoff_failed").inc()
            _LOG.warning("KV handoff failed (%s: %s) - request degrades "
                         "to a plain submit", type(e).__name__, e)

    # -- pool membership (controller scale/promotion) --------------------

    def add_prefill(self, rep: RemoteReplica):
        """Admit a replica to the prefill pool (promotion lands here
        AFTER the role flip + any version alignment). List replacement,
        not append: ``_handoff`` reads the pool without the lock."""
        with self._lock:
            if all(p.name != rep.name for p in self.prefill):
                self.prefill = self.prefill + [rep]

    def remove_prefill(self, name: str) -> Optional[RemoteReplica]:
        with self._lock:
            gone = next((p for p in self.prefill if p.name == name), None)
            self.prefill = [p for p in self.prefill if p.name != name]
        return gone

    def add_decode(self, rep: RemoteReplica):
        with self._lock:
            if all(d.name != rep.name for d in self.decode):
                self.decode = self.decode + [rep]

    def remove_decode(self, name: str) -> Optional[RemoteReplica]:
        with self._lock:
            gone = next((d for d in self.decode if d.name == name), None)
            self.decode = [d for d in self.decode if d.name != name]
        return gone

    def swap(self, params, state=None,
             version: Optional[str] = None) -> str:
        """Fleet swap covering BOTH pools. ``Router.swap`` two-phases
        only ITS replicas (the decode pool) - prefill specialists are
        not in the router's dispatch list, and one left behind on the
        old version would version-skew-refuse EVERY handoff from then
        on: safe (each degrades to a plain submit, counted in
        ``serve/fleet_handoff_refused``) but the pool silently stops
        paying for itself. Order: publish to the prefill pool first
        (specialists keep exporting the OLD version - decode replicas
        still on it adopt fine), two-phase the decode pool through the
        router, then activate the specialists. The only skew window is
        one export already in flight around the flip, and the refusal
        path makes that a degraded submit, never a wrong token."""
        published = []
        v = version or f"dv{id(self) & 0xffff}.{next(_swap_ids)}"
        try:
            for p in self.prefill:
                # state=None rides the wire as state_is_none: the AGENT
                # side inherits its active version's state (the
                # params-only swap contract, applied replica-side)
                p.registry.publish(params, state, version=v,
                                   activate=False)
                published.append(p)
        except BaseException:
            for p in published:
                try:
                    p.registry.retire(v)
                except Exception:  # noqa: BLE001 - best-effort unwind
                    pass
            raise
        self.router.swap(params, state=state, version=v)
        for p in self.prefill:
            p.registry.activate(v)
        return v

    def stats(self) -> Dict:
        with self._lock:
            return dict(self._stats)

    def _bump(self, key: str, n: int = 1):
        with self._lock:
            self._stats[key] = self._stats.get(key, 0) + n


#: DisaggregatedFleet.swap version-id stream (process-local)
_swap_ids = itertools.count(1)


def warm_replica(source: RemoteReplica, target: RemoteReplica,
                 prompts, *, timeout_s: float = 300.0) -> Dict:
    """Warm a (re)joining replica's prefix cache from a peer: for each
    prompt, export ``source``'s aligned prefix chain and adopt it on
    ``target`` through the ordinary content-key-verified handoff - the
    new replica's first requests for warmed prompts take the
    warm-hit path instead of each paying a cold prefill.

    The host tier is what makes the SOURCE side cheap: a
    chain the source evicted under block pressure lives on in its host
    pool, so the export's lookup REFILLS it (a second-chance hit)
    rather than re-running the prefill - warming a peer from a busy
    replica costs swap-ins, not recompute. Failure discipline is
    per-prompt degrade, the fleet's usual: a refused adopt (version
    skew, block pressure on the target) or a dying export skips THAT
    prompt and moves on - warming is an optimization pass, it must
    never take a joining replica down.

    Returns ``{"warmed", "tokens", "skipped", "failed"}`` counts.
    Administrative path (replica join/rebalance) - not a hot loop."""
    out = {"warmed": 0, "tokens": 0, "skipped": 0, "failed": 0}
    for p in prompts:
        try:
            meta, arrays = source.prefill_export(p, timeout=timeout_s)
            if meta.get("tokens", 0) <= 0:
                out["skipped"] += 1      # shorter than the alignment
                continue
            target.adopt_prefix(
                {"version": meta["version"], "keys": meta["keys"],
                 "geometry": meta["geometry"],
                 "digest": meta["digest"]},
                arrays, timeout=timeout_s)
            out["warmed"] += 1
            out["tokens"] += int(meta["tokens"])
        except Exception as e:  # noqa: BLE001 - per-prompt degrade
            out["failed"] += 1
            _LOG.warning("warm_replica: prompt skipped (%s: %s)",
                         type(e).__name__, e)
    if obs.enabled():
        obs.counter("serve/fleet_warm_prompts").inc(out["warmed"])
        obs.counter("serve/fleet_warm_tokens").inc(out["tokens"])
    return out


def fleet_threads_alive() -> int:
    """Live agent/monitor threads (tests assert 0 after shutdown)."""
    return sum(1 for t in threading.enumerate() if t.is_alive()
               and (t.name.startswith(AGENT_THREAD)
                    or t.name == MONITOR_THREAD))


# -- standalone replica process driver -------------------------------------

def agent_from_config(cfg: Dict) -> ReplicaAgent:
    """Build a scheduler-backed agent from a config dict::

        {"fleet_dir": ..., "name": "r0", "role": "replica",
         "tags": ["f32"], "beat_s": 0.25, "process_index": 1,
         "observability": true,
         "host": "0.0.0.0", "port": 0,            # bind address
         "advertise_host": "10.0.0.7",            # optional override
         "model": {...TransformerLM kwargs...},
         "params_path": "/path/params.pkl",       # optional numpy tree
         "scheduler": {...DecodeScheduler kwargs...},
         "chaos": {...chaos plan...},             # optional
         "device": "cuda",                        # "cpu" off the card
         "dtype": "bfloat16"}                     # optional served dtype

    ``host`` is the BIND address; the member file advertises
    ``advertise_host`` (auto-detected from the outbound interface on a
    wildcard bind). ``params_path`` (a pickled tree of numpy leaves under
    the model's parameter names, written by the parent; ``convert``
    maps it onto the module) pins every process to ONE parameter set -
    the fleet's bitwise checks depend on it. The model is built on
    ``device`` (the CUDA device unless ``"cpu"``); with ``"dtype":
    "bfloat16"`` the agent serves the parameters cast to bfloat16
    (``utils.amp.bf16_params``) as version ``v0``, the pages staying
    float32."""
    from .. import convert
    from ..models.transformer_lm import TransformerLM
    from .decode_scheduler import DecodeScheduler
    from .registry import ModelRegistry

    if cfg.get("observability", False):
        obs.enable()
    model = TransformerLM(**cfg.get("model", {}),
                          device=cfg.get("device", "cuda"))
    model.ensure_initialized()
    if cfg.get("params_path"):
        import pickle
        with open(cfg["params_path"], "rb") as f:
            host = pickle.load(f)
        model.load_state_dict(convert.jax_to_state_dict(host), strict=True)
    sched_kw = dict(cfg.get("scheduler", {}))
    sched_kw.setdefault("name", cfg.get("name"))
    sched_kw.setdefault("tags", cfg.get("tags", ()))
    if cfg.get("dtype", "float32") != "float32":
        if cfg["dtype"] != "bfloat16":
            raise ValueError(f"dtype must be 'float32' or 'bfloat16', got "
                             f"{cfg['dtype']!r}")
        from ..utils.amp import bf16_params
        reg = ModelRegistry(device=model.device)
        reg.publish(bf16_params(model.params), model.state, version="v0",
                    activate=True)
        sched_kw.setdefault("registry", reg)
    sched = DecodeScheduler(model, **sched_kw)
    if cfg.get("chaos"):
        _chaos.arm(cfg["chaos"])
    return ReplicaAgent(
        sched, fleet_dir=cfg["fleet_dir"], name=cfg.get("name"),
        role=cfg.get("role", "replica"), tags=cfg.get("tags", ()),
        beat_s=cfg.get("beat_s", 0.25),
        host=cfg.get("host", "127.0.0.1"),
        port=cfg.get("port", 0),
        advertise_host=cfg.get("advertise_host"),
        process_index=cfg.get("process_index"))


def main(argv=None) -> int:
    import sys
    argv = sys.argv if argv is None else argv
    if len(argv) != 2:
        print("usage: python -m bigdl_tpu_torch.serving.fleet <config.json>",
              file=sys.stderr)
        return 2
    with open(argv[1]) as f:
        cfg = json.load(f)
    agent = agent_from_config(cfg)
    agent.start()
    return agent.run()


if __name__ == "__main__":  # pragma: no cover - subprocess entry
    raise SystemExit(main())
