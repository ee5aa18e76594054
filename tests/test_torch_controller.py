"""The port's elastic fleet control plane (``serving/controller.py``)
through JAX's twelve controller drills (``tests/test_controller.py``),
each driven the way JAX's is, with in-process agents (threads serving
real local sockets) over the port's ``DecodeScheduler`` on the CPU:
advertise hosts and wildcard binds, role flips, staleness judged by beat
progress and not wall clock (also across a transient read miss and a
skewed clock), reconnect churn on new ports, scale up and down with no
request lost and tokens bit for bit the static oracle's, prefill
promotion and demotion, controller death and adoption, spawn names that
never collide with adopted members, a retiring member not re-adopted mid
drain, and a failed spawn changing nothing. Reconciliation is driven by
``tick()``, not the controller thread, except where the thread's death
is the drill.
"""
import itertools
import time

import numpy as np
import pytest

import torch

from bigdl_tpu_torch import observability as obs
from bigdl_tpu_torch.observability import health as _health
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.parallel import chaos
from bigdl_tpu_torch.parallel.failure import FileHeartbeat
from bigdl_tpu_torch.serving import (DecodeScheduler, DisaggregatedFleet,
                               FleetController, FleetMonitor,
                               RemoteReplica, ReplicaAgent, Router,
                               ScalePolicy, controller_threads_alive,
                               wait_for_members)
from bigdl_tpu_torch.serving.fleet import fleet_threads_alive, read_member
from bigdl_tpu_torch.serving.transport import pick_advertise_host

V, H = 48, 32
SCHED = dict(max_slots=4, block_size=4, max_seq_len=96, prefill_chunk=8)
MODEL = dict(vocab_size=V, hidden_size=H, num_heads=4, filter_size=64,
             num_layers=2, max_len=256)


@pytest.fixture(autouse=True)
def _clean():
    yield
    chaos.disarm()
    _health.reset()
    obs.registry().reset()
    obs.disable()


torch.set_num_threads(1)


def _model():
    return TransformerLM(device="cpu", **MODEL)


def _prompts(rng, sizes):
    return [rng.randint(1, V, size=n).astype(np.int32) for n in sizes]


def _crash(ag):
    """Ungraceful agent death: no final beat, no drain - the member
    file is left mid-beat, exactly what a kill -9 leaves behind."""
    ag._stop.set()
    if ag._beat_thread is not None:
        ag._beat_thread.join(10)
    if ag.server is not None:
        ag.server.close()
    ag.engine.shutdown(drain=False)


# -- cross-host discovery ---------------------------------------------------

def test_pick_advertise_host_and_wildcard_bind_member_doc(tmp_path):
    # a concrete bind address is already dialable - passed through
    assert pick_advertise_host("10.1.2.3") == "10.1.2.3"
    assert pick_advertise_host("127.0.0.1") == "127.0.0.1"
    # a wildcard bind must never be advertised as-is: peers on other
    # hosts cannot dial 0.0.0.0
    got = pick_advertise_host("0.0.0.0")
    assert got not in ("", "0.0.0.0", "::")
    # an agent bound to the wildcard advertises the resolved address
    fd = str(tmp_path)
    m = _model()
    ag = ReplicaAgent(DecodeScheduler(m, name="adv", **SCHED),
                      fleet_dir=fd, name="adv", host="0.0.0.0",
                      beat_s=0.1).start()
    try:
        doc, = wait_for_members(fd, ["adv"], timeout_s=60)
        assert doc["host"] == got != "0.0.0.0"
        # ...and an explicit advertise_host (NAT/multi-homed) wins
        assert ReplicaAgent(
            DecodeScheduler(m, name="adv2", **SCHED), fleet_dir=fd,
            name="adv2", host="0.0.0.0",
            advertise_host="203.0.113.9").advertise_host == "203.0.113.9"
        # the advertised address is actually dialable on this box
        # (boxes whose outbound interface refuses hairpin connects just
        # skip the dial - the doc contract above is the real gate)
        try:
            rep = RemoteReplica(doc, fleet_dir=fd).start()
        except OSError:
            rep = None
        if rep is not None:
            assert rep.stats()["queue_depth"] == 0
    finally:
        ag.shutdown()
    assert fleet_threads_alive() == 0


def test_set_role_flips_member_doc_and_rejects_unknown(tmp_path):
    fd = str(tmp_path)
    ag = ReplicaAgent(DecodeScheduler(_model(), name="rf", **SCHED),
                      fleet_dir=fd, name="rf", role="decode",
                      beat_s=0.05).start()
    try:
        doc, = wait_for_members(fd, ["rf"], timeout_s=60)
        rep = RemoteReplica(doc, fleet_dir=fd).start()
        out = rep.set_role("prefill", tags=["pf"])
        assert out == {"role": "prefill", "was": "decode"}
        assert rep.role == "prefill"
        deadline = time.time() + 10
        while time.time() < deadline:
            d = read_member(fd, "rf")
            if d and d.get("role") == "prefill":
                break
            time.sleep(0.02)
        assert d["role"] == "prefill" and d["tags"] == ["pf"], \
            "the role flip must land in the member file immediately"
        with pytest.raises(ValueError, match="role"):
            rep.set_role("bogus")
        assert rep.role == "prefill"
    finally:
        ag.shutdown()
    assert fleet_threads_alive() == 0


# -- cross-host-safe staleness (satellite: skewed-stamp regression) ---------

def test_staleness_is_beat_progress_not_wallclock(tmp_path):
    """The monitor judges staleness by beat-COUNTER progress against
    its own monotonic clock; the member file's wall-clock stamp is
    never compared, so hours of cross-host clock skew cannot
    false-kill a beating agent."""
    fd = str(tmp_path)
    mon = FleetMonitor([], fleet_dir=fd, stale_s=1.0)
    # a doc stamped two hours in the past is FRESH while its counter
    # moves - under wall-clock staleness this would read age 7200s
    skew = time.time() - 7200.0
    assert mon._progress_age_s("x", {"beat": 1, "written_at": skew},
                               now=100.0) == 0.0
    assert FileHeartbeat.age_s({"written_at": skew}) > 7000.0
    # frozen counter: age accrues on the OBSERVER's clock
    assert mon._progress_age_s("x", {"beat": 1, "written_at": skew},
                               now=100.4) == pytest.approx(0.4)
    # counter moved -> fresh again (stamp still hours off)
    assert mon._progress_age_s("x", {"beat": 2, "written_at": skew},
                               now=100.5) == 0.0
    # counter went BACKWARDS -> a restarted incarnation, not silence
    assert mon._progress_age_s("x", {"beat": 1, "written_at": skew},
                               now=100.6) == 0.0
    # missing/typeless docs are infinitely stale
    assert mon._progress_age_s("x", None, 101.0) == float("inf")
    assert mon._progress_age_s("x", {"written_at": skew},
                               101.0) == float("inf")


def test_staleness_clock_survives_transient_read_miss(tmp_path):
    """One unreadable beat (the member file mid-rewrite) must not reset
    a frozen member's staleness clock: the next successful read
    continues the age from when the counter last ADVANCED, so a wedged
    agent cannot have its stall detection deferred by transient read
    misses."""
    mon = FleetMonitor([], fleet_dir=str(tmp_path), stale_s=1.0)
    assert mon._progress_age_s("m", {"beat": 7}, now=50.0) == 0.0
    assert mon._progress_age_s("m", {"beat": 7},
                               now=50.4) == pytest.approx(0.4)
    # transient miss: unknown for the instant, but the entry survives
    assert mon._progress_age_s("m", None, now=50.5) == float("inf")
    assert mon._progress_age_s("m", {"beat": 7},
                               now=51.2) == pytest.approx(1.2)
    # real counter progress still resets the clock
    assert mon._progress_age_s("m", {"beat": 8}, now=51.3) == 0.0
    # unwatch is what forgets the member for good
    mon.unwatch("m")
    assert "m" not in mon._progress


def test_skewed_wallclock_member_not_false_killed(tmp_path):
    """End-to-end: an agent whose member-file stamps are rewritten two
    hours into the past (a skewed cross-host clock) keeps serving under
    a monitor with a sub-second staleness threshold - no stall is ever
    emitted for it while it beats."""
    fd = str(tmp_path)
    m = _model()
    ag = ReplicaAgent(DecodeScheduler(m, name="skew", **SCHED),
                      fleet_dir=fd, name="skew", beat_s=0.1)

    class _SkewedHB(FileHeartbeat):
        def beat(self, payload=None, *, final=False):
            doc = dict(payload or {})
            out = super().beat(doc, final=final)
            # rewrite atomically with the stamp hours off, like a host
            # whose wall clock drifted - the beat counter still moves
            import json, os
            skewed = dict(out, written_at=out["written_at"] - 7200.0)
            tmp = f"{self.path}.skew"
            with open(tmp, "w") as f:
                json.dump(skewed, f, default=str)
            os.replace(tmp, self.path)
            return skewed

    ag._hb = _SkewedHB(ag._hb.path)
    ag.start()
    events = []
    _health.listeners.append(lambda e: events.append(e))
    mon = None
    try:
        doc, = wait_for_members(fd, ["skew"], timeout_s=60)
        assert doc["written_at"] < time.time() - 7000
        rep = RemoteReplica(doc, fleet_dir=fd).start()
        mon = FleetMonitor([rep], fleet_dir=fd, every_s=0.05,
                           stale_s=0.6).start()
        rng = np.random.RandomState(4)
        prompt = rng.randint(1, V, size=9).astype(np.int32)
        first = rep.submit(prompt, max_new_tokens=4).result(timeout=120)
        time.sleep(1.5)   # many monitor ticks past stale_s of wall skew
        again = rep.submit(prompt, max_new_tokens=4).result(timeout=120)
        assert np.array_equal(first, again)
        stalls = [e for e in events if e.get("kind") == "health/stall"]
        assert not stalls, f"skewed stamp false-killed the agent: {stalls}"
    finally:
        if mon is not None:
            mon.stop()
        ag.shutdown()
    assert fleet_threads_alive() == 0


# -- reconnect churn (satellite) --------------------------------------------

def test_reconnect_churn_new_ports_zero_lost_3x(tmp_path):
    """Agent restart churn, three rounds: each incarnation crashes
    (no final beat) and a replacement registers under the SAME member
    name on a NEW port; the monitor re-dials from the fresh doc and
    every post-rejoin submit completes, tokens bitwise round one's."""
    fd = str(tmp_path)
    m = _model()
    ag = ReplicaAgent(DecodeScheduler(m, name="rc0", **SCHED),
                      fleet_dir=fd, name="rc", beat_s=0.1).start()
    mon = None
    crashed = []
    try:
        doc, = wait_for_members(fd, ["rc"], timeout_s=60)
        rep = RemoteReplica(doc, fleet_dir=fd).start()
        mon = FleetMonitor([rep], fleet_dir=fd, every_s=0.05,
                           stale_s=8.0).start()
        rng = np.random.RandomState(11)
        prompt = rng.randint(1, V, size=9).astype(np.int32)
        want = rep.submit(prompt, max_new_tokens=6).result(timeout=120)
        ports = {rep.port}
        for i in range(1, 4):
            old_port = rep.port
            _crash(ag)
            crashed.append(ag)
            ag = ReplicaAgent(
                DecodeScheduler(m, name=f"rc{i}", **SCHED),
                fleet_dir=fd, name="rc", beat_s=0.1).start()
            deadline = time.time() + 60
            while time.time() < deadline:
                if not rep._client.closed and rep.port != old_port:
                    break
                time.sleep(0.05)
            assert rep.port != old_port, \
                f"round {i}: monitor never re-dialed the new port"
            ports.add(rep.port)
            got = rep.submit(prompt, max_new_tokens=6).result(timeout=120)
            assert np.array_equal(want, got), f"round {i}: tokens differ"
        assert len(ports) == 4, f"every round must land a new port: {ports}"
    finally:
        if mon is not None:
            mon.stop()
        ag.shutdown()
        for c in crashed:
            c.engine.shutdown(drain=False)
    assert fleet_threads_alive() == 0


# -- the elastic drill ------------------------------------------------------

def test_elastic_scale_up_and_down_zero_lost_bitwise(tmp_path):
    """The acceptance drill: under an injected load ramp the controller
    scales 1->3 replicas (spawn + prefix-warm + router join) and back
    down to 1 (drain-retire, never kill) with ZERO lost requests and
    every token bitwise the static oracle. The spawn-latency histogram
    records each launch."""
    fd = str(tmp_path)
    m = _model()
    obs.enable()
    local = DecodeScheduler(m, name="ctl_oracle", **SCHED).start()
    agents = {}

    def spawn(name):
        ag = ReplicaAgent(DecodeScheduler(m, name=name, **SCHED),
                          fleet_dir=fd, name=name, beat_s=0.1).start()
        agents[name] = ag
        doc, = wait_for_members(fd, [name], timeout_s=60)
        return RemoteReplica(doc, fleet_dir=fd).start()

    r0 = spawn("r0")
    router = Router([r0], max_failovers=4).start()
    mon = FleetMonitor([r0], fleet_dir=fd, every_s=0.1,
                       stale_s=10.0).start()
    rng = np.random.RandomState(7)
    prompts = _prompts(rng, [9 + (i % 13) for i in range(32)])
    pol = ScalePolicy(min_replicas=1, max_replicas=3, queue_high=2.0,
                      queue_low=0.5, up_ticks=1, down_ticks=2,
                      cooldown_s=0.0, warm_limit=2)
    ctl = FleetController(router, mon, fleet_dir=fd, spawn=spawn,
                          policy=pol, warm_prompts=lambda: prompts[:2])
    try:
        want = [local.generate(p, 24) for p in prompts]
        futs = []  # (prompt_index, future) - every request ever sent
        nxt = itertools.count()

        def top_up(n):
            for _ in range(n):
                i = next(nxt) % len(prompts)
                futs.append((i, router.submit(prompts[i],
                                              max_new_tokens=24)))

        # ramp: tick (deterministically, no thread) until the fleet
        # grows to the max budget - the load must be SUSTAINED, so the
        # queue is topped back up whenever the fleet starts catching
        # up (a one-shot burst drains before the second spawn lands
        # and the controller correctly never scales past 2)
        top_up(24)
        deadline = time.time() + 240
        while len(router.stats()["replicas"]) < 3 \
                and time.time() < deadline:
            if sum(router.stats()["queue_depth"].values()) < 8 \
                    and len(futs) < 400:
                top_up(8)
            ctl.tick()
            time.sleep(0.05)
        assert len(router.stats()["replicas"]) == 3, \
            f"never scaled to 3: {ctl.stats()} / {router.stats()}"
        for i, f in futs:
            assert np.array_equal(want[i], f.result(timeout=300)), \
                "elastic-fleet tokens must be bitwise the static oracle"
        st = router.stats()
        assert st["completed"] == len(futs), f"lost requests: {st}"
        # drain of load -> scale back down to min, retiring the
        # controller-spawned replicas first; the seed replica survives
        deadline = time.time() + 240
        while len(router.stats()["replicas"]) > 1 \
                and time.time() < deadline:
            ctl.tick()
            time.sleep(0.05)
        assert router.healthy_replicas() == ["r0"], router.stats()
        cs = ctl.stats()
        assert cs["scale_ups"] >= 2 and cs["scale_downs"] >= 2, cs
        assert cs["warm_prompts"] >= 1, \
            f"joiners must pre-warm from a peer: {cs}"
        st = router.stats()
        assert st["joins"] == cs["scale_ups"] \
            and st["retires"] == cs["scale_downs"], (st, cs)
        # post-retire traffic still serves, still bitwise
        tail = router.submit(prompts[0],
                             max_new_tokens=24).result(timeout=120)
        assert np.array_equal(want[0], tail)
        assert router.stats()["completed"] == len(futs) + 1
        h = obs.registry().get("serve/fleet_spawn_ms")
        assert h is not None and h.count == cs["scale_ups"], \
            "every spawn must record its launch latency"
        router.shutdown()
    finally:
        for ag in agents.values():
            ag.shutdown()
        mon.stop()
    local.shutdown()
    assert fleet_threads_alive() == 0
    assert controller_threads_alive() == 0


# -- prefill promotion ------------------------------------------------------

def test_prefill_promotion_relieves_backlog_then_demotes(tmp_path):
    """An injected prefill backlog promotes one decode replica to
    prefill duty (role flip lands in its member file, pools move, its
    in-flight decode work fails over - zero lost); the handoff path
    keeps landing through the grown pool; backlog relief demotes it
    back to decode rotation."""
    fd = str(tmp_path)
    m = _model()
    local = DecodeScheduler(m, name="promo_oracle", **SCHED).start()
    ags = [ReplicaAgent(DecodeScheduler(m, name=n, **SCHED),
                        fleet_dir=fd, name=n, role=r,
                        beat_s=0.05).start()
           for n, r in (("pp", "prefill"), ("pd0", "decode"),
                        ("pd1", "decode"))]
    mon = None
    try:
        dpf, dd0, dd1 = wait_for_members(fd, ["pp", "pd0", "pd1"],
                                         timeout_s=120)
        rpf = RemoteReplica(dpf, fleet_dir=fd).start()
        rd0 = RemoteReplica(dd0, fleet_dir=fd)
        rd1 = RemoteReplica(dd1, fleet_dir=fd)
        router = Router([rd0, rd1], max_failovers=4).start()
        mon = FleetMonitor([rpf, rd0, rd1], fleet_dir=fd, every_s=0.1,
                           stale_s=10.0).start()
        dis = DisaggregatedFleet(router, [rpf], [rd0, rd1])
        pol = ScalePolicy(min_replicas=2, max_replicas=2, up_ticks=99,
                          down_ticks=99, cooldown_s=0.0,
                          prefill_backlog_high=3, prefill_backlog_low=0)
        ctl = FleetController(
            router, mon, fleet_dir=fd,
            spawn=lambda n: pytest.fail("promotion must not spawn"),
            policy=pol, disagg=dis)
        # the promotion version gate must read the FRESH member docs,
        # not these handle caches - an adopted or idle handle's cache
        # is seeded at construction and can stay None/stale forever,
        # which would block promotion on phantom skew. Poison the
        # caches to prove the gate no longer consults them.
        rpf._active_version = "vSTALE-pool"
        rd0._active_version = "vSTALE-promotee"
        rng = np.random.RandomState(13)
        # backlog: pile slow work straight onto the prefill specialist
        load = [rpf.submit(p, max_new_tokens=24)
                for p in _prompts(rng, (12,) * 8)]
        deadline = time.time() + 30
        while time.time() < deadline:
            s = (rpf.member() or {}).get("serving", {})
            if (s.get("queue_depth", 0) or 0) \
                    + (s.get("pending", 0) or 0) > 3:
                break
            time.sleep(0.05)
        ctl.tick()
        cs = ctl.stats()
        assert cs["promotions"] == 1 and cs["promoted"] == ["pd0"], cs
        assert [p.name for p in dis.prefill] == ["pp", "pd0"]
        assert router.healthy_replicas() == ["pd1"]
        deadline = time.time() + 10
        while time.time() < deadline:
            d = read_member(fd, "pd0")
            if d and d.get("role") == "prefill":
                break
            time.sleep(0.02)
        assert d["role"] == "prefill"
        # the handoff path keeps landing with the promoted pool, and
        # tokens stay bitwise the monolithic oracle
        long_p = rng.randint(1, V, size=40).astype(np.int32)
        want = local.generate(long_p, 8)
        got = dis.submit(long_p, max_new_tokens=8).result(timeout=240)
        assert np.array_equal(want, got)
        assert dis.stats()["handoffs"] >= 1, dis.stats()
        # relief: drain the injected backlog, demote on the next tick
        for f in load:
            f.result(timeout=300)
        deadline = time.time() + 30
        while time.time() < deadline:
            s = (rpf.member() or {}).get("serving", {})
            if not (s.get("queue_depth", 0) or s.get("pending", 0)):
                break
            time.sleep(0.05)
        ctl.tick()
        cs = ctl.stats()
        assert cs["demotions"] == 1 and cs["promoted"] == [], cs
        assert [p.name for p in dis.prefill] == ["pp"]
        assert sorted(router.healthy_replicas()) == ["pd0", "pd1"]
        # the demoted replica takes decode traffic again
        p = rng.randint(1, V, size=9).astype(np.int32)
        outs = [router.submit(p, max_new_tokens=4).result(timeout=120)
                for _ in range(4)]
        assert all(np.array_equal(outs[0], o) for o in outs)
        router.shutdown()
    finally:
        if mon is not None:
            mon.stop()
        for ag in ags:
            ag.shutdown()
    local.shutdown()
    assert fleet_threads_alive() == 0


# -- controller death + adoption --------------------------------------------

def test_controller_death_keeps_serving_and_respawn_adopts(tmp_path):
    """`fleet/controller_tick` chaos kills the controller thread
    mid-reconcile. The fleet KEEPS SERVING (the router/monitor own the
    data path); a respawned controller finds the members in the fleet
    directory and ADOPTS them - including one that joined while no
    controller was alive - instead of respawning anything."""
    fd = str(tmp_path)
    m = _model()
    local = DecodeScheduler(m, name="adopt_oracle", **SCHED).start()
    ags = {n: ReplicaAgent(DecodeScheduler(m, name=n, **SCHED),
                           fleet_dir=fd, name=n, beat_s=0.1).start()
           for n in ("c0", "c1")}
    mon = None
    ctl = ctl2 = None
    try:
        d0, _ = wait_for_members(fd, ["c0", "c1"], timeout_s=120)
        r0 = RemoteReplica(d0, fleet_dir=fd)
        router = Router([r0], max_failovers=4).start()
        mon = FleetMonitor([r0], fleet_dir=fd, every_s=0.1,
                           stale_s=10.0).start()
        pol = ScalePolicy(up_ticks=99, down_ticks=99)
        boom = lambda n: pytest.fail("adoption must not spawn")  # noqa: E731
        chaos.arm({"sites": {"fleet/controller_tick": [
            {"kind": "permanent", "nth": 3}]}})
        ctl = FleetController(router, mon, fleet_dir=fd, spawn=boom,
                              policy=pol, every_s=0.02)
        ctl.start()
        # start() adopted the member the router didn't know about
        assert ctl.stats()["adopted"] == 1
        assert sorted(router.healthy_replicas()) == ["c0", "c1"]
        deadline = time.time() + 30
        while not ctl.dead and time.time() < deadline:
            time.sleep(0.02)
        assert ctl.dead, "the armed permanent tick fault must kill it"
        assert len(chaos.fires()) >= 1
        # controller death is NOT a fleet death: traffic still serves,
        # bitwise, across both members
        rng = np.random.RandomState(17)
        prompts = _prompts(rng, (7, 12, 15, 20))
        want = [local.generate(p, 8) for p in prompts]
        futs = [router.submit(p, max_new_tokens=8) for p in prompts]
        for w, f in zip(want, futs):
            assert np.array_equal(w, f.result(timeout=240))
        assert router.stats()["completed"] == len(prompts)
        # a member joins while NO controller is alive...
        ags["c2"] = ReplicaAgent(
            DecodeScheduler(m, name="c2", **SCHED), fleet_dir=fd,
            name="c2", beat_s=0.1).start()
        wait_for_members(fd, ["c2"], timeout_s=120)
        # ...and the respawned controller adopts it from the directory
        chaos.disarm()
        ctl2 = FleetController(router, mon, fleet_dir=fd, spawn=boom,
                               policy=pol)
        assert ctl2.adopt() == 1
        assert ctl2.stats()["adopted"] == 1
        assert sorted(router.healthy_replicas()) == ["c0", "c1", "c2"]
        got = router.submit(prompts[0],
                            max_new_tokens=8).result(timeout=240)
        assert np.array_equal(want[0], got)
        router.shutdown()
    finally:
        if ctl is not None:
            ctl.stop()
        if ctl2 is not None:
            ctl2.stop()
        if mon is not None:
            mon.stop()
        for ag in ags.values():
            ag.shutdown()
    local.shutdown()
    assert controller_threads_alive() == 0
    assert fleet_threads_alive() == 0


def test_restart_spawn_names_never_collide_with_adopted(tmp_path):
    """A successor controller's spawn-id counter restarts at 0; its
    first scale-up must NOT reuse the name of a predecessor-spawned
    replica it adopted - the new agent would clobber the live replica's
    member file, be drained as a duplicate, and its final beat would
    falsely retire the healthy original. Names with a member file still
    in the directory (live OR final) are skipped too."""
    fd = str(tmp_path)
    m = _model()
    agents = {}

    def spawn(name):
        ag = ReplicaAgent(DecodeScheduler(m, name=name, **SCHED),
                          fleet_dir=fd, name=name, beat_s=0.1).start()
        agents[name] = ag
        doc, = wait_for_members(fd, [name], timeout_s=60)
        return RemoteReplica(doc, fleet_dir=fd).start()

    # a PREDECESSOR controller spawned auto0 (still live) and auto1
    # (retired cleanly - its FINAL member file remains), then died
    r0 = spawn("auto0")
    ag1 = ReplicaAgent(DecodeScheduler(m, name="auto1", **SCHED),
                       fleet_dir=fd, name="auto1", beat_s=0.1).start()
    wait_for_members(fd, ["auto1"], timeout_s=60)
    ag1.shutdown()
    assert read_member(fd, "auto1").get("final")
    router = Router([r0], max_failovers=4).start()
    mon = FleetMonitor([r0], fleet_dir=fd, every_s=0.1,
                       stale_s=10.0).start()
    pol = ScalePolicy(min_replicas=1, max_replicas=3, up_ticks=99,
                      down_ticks=99, cooldown_s=0.0)
    ctl = FleetController(router, mon, fleet_dir=fd, spawn=spawn,
                          policy=pol)
    try:
        assert ctl.adopt() == 0   # auto0 already routed; auto1 is final
        ctl._scale_up()
        cs = ctl.stats()
        assert cs["scale_ups"] == 1 and cs["spawn_failed"] == 0, cs
        assert "auto2" in agents, \
            f"spawn must skip taken names auto0/auto1: {sorted(agents)}"
        assert sorted(router.healthy_replicas()) == ["auto0", "auto2"]
        # the predecessor replica's member file was never clobbered
        d0 = read_member(fd, "auto0")
        assert d0 and not d0.get("dead") and not d0.get("final")
        assert int(d0["port"]) == r0.port
        # both serve, bitwise alike
        rng = np.random.RandomState(23)
        p = rng.randint(1, V, size=9).astype(np.int32)
        outs = [router.submit(p, max_new_tokens=6).result(timeout=120)
                for _ in range(4)]
        assert all(np.array_equal(outs[0], o) for o in outs)
        router.shutdown()
    finally:
        mon.stop()
        for ag in agents.values():
            ag.shutdown()
    assert fleet_threads_alive() == 0


def test_retired_victim_is_not_readopted_mid_drain(tmp_path):
    """The retiring agent acks its shutdown op BEFORE writing the final
    member beat; an adopt() landing in that window must not re-register
    the victim - its name is held out of adoption until its member doc
    goes terminal."""
    fd = str(tmp_path)
    m = _model()
    agents = {}

    def spawn(name):
        ag = ReplicaAgent(DecodeScheduler(m, name=name, **SCHED),
                          fleet_dir=fd, name=name, beat_s=0.05).start()
        agents[name] = ag
        doc, = wait_for_members(fd, [name], timeout_s=60)
        return RemoteReplica(doc, fleet_dir=fd).start()

    seed = spawn("seed0")
    auto = spawn("auto0")
    router = Router([seed, auto], max_failovers=4).start()
    mon = FleetMonitor([seed, auto], fleet_dir=fd, every_s=0.1,
                       stale_s=10.0).start()
    pol = ScalePolicy(up_ticks=99, down_ticks=99, cooldown_s=0.0)
    ctl = FleetController(router, mon, fleet_dir=fd, spawn=spawn,
                          policy=pol)
    try:
        ctl._scale_down()   # prefers the controller-prefixed auto0
        assert router.healthy_replicas() == ["seed0"]
        assert ctl.stats()["scale_downs"] == 1
        # hammer adoption through the ack->final-beat window
        deadline = time.time() + 60
        while time.time() < deadline:
            assert ctl.adopt() == 0, \
                "retiring member must not be re-adopted"
            d = read_member(fd, "auto0")
            if d and (d.get("final") or d.get("dead")):
                break
            time.sleep(0.002)
        else:
            pytest.fail("auto0 never reached a terminal beat")
        assert ctl.adopt() == 0   # the terminal doc clears the ledger
        assert "auto0" not in ctl._retired
        assert ctl.stats()["adopted"] == 0
        assert router.healthy_replicas() == ["seed0"]
        router.shutdown()
    finally:
        mon.stop()
        for ag in agents.values():
            ag.shutdown()
    assert fleet_threads_alive() == 0


def test_spawn_failure_mid_reconcile_changes_nothing(tmp_path):
    """`fleet/spawn` chaos: a spawn that dies mid-launch is a counted,
    cooldown-gated retry - the router's membership is untouched, no
    request is lost, and the NEXT eligible spawn succeeds."""
    fd = str(tmp_path)
    m = _model()
    agents = {}

    def spawn(name):
        ag = ReplicaAgent(DecodeScheduler(m, name=name, **SCHED),
                          fleet_dir=fd, name=name, beat_s=0.1).start()
        agents[name] = ag
        doc, = wait_for_members(fd, [name], timeout_s=60)
        return RemoteReplica(doc, fleet_dir=fd).start()

    r0 = spawn("s0")
    router = Router([r0], max_failovers=4).start()
    mon = FleetMonitor([r0], fleet_dir=fd, every_s=0.1,
                       stale_s=10.0).start()
    pol = ScalePolicy(min_replicas=1, max_replicas=2, queue_high=1.0,
                      up_ticks=1, down_ticks=99, cooldown_s=0.0)
    ctl = FleetController(router, mon, fleet_dir=fd, spawn=spawn,
                          policy=pol)
    try:
        # the first spawn attempt dies on the chaos seam
        chaos.arm({"sites": {"fleet/spawn": [
            {"kind": "transient", "nth": 1}]}})
        rng = np.random.RandomState(19)
        futs = [router.submit(p, max_new_tokens=12)
                for p in _prompts(rng, (9,) * 12)]
        deadline = time.time() + 120
        while ctl.stats()["spawn_failed"] < 1 \
                and time.time() < deadline:
            ctl.tick()
            time.sleep(0.02)
        cs = ctl.stats()
        assert cs["spawn_failed"] == 1 and cs["scale_ups"] == 0, cs
        assert router.healthy_replicas() == ["s0"], \
            "a failed spawn must change NOTHING"
        assert len(chaos.fires()) == 1
        # the retry (chaos exhausted) lands the replica - the load must
        # stay pressed, or the burst drains and the controller rightly
        # stops wanting a second replica
        deadline = time.time() + 240
        while len(router.stats()["replicas"]) < 2 \
                and time.time() < deadline:
            if sum(router.stats()["queue_depth"].values()) < 4 \
                    and len(futs) < 200:
                futs.extend(router.submit(p, max_new_tokens=12)
                            for p in _prompts(rng, (9,) * 4))
            ctl.tick()
            time.sleep(0.05)
        assert len(router.stats()["replicas"]) == 2
        for f in futs:
            f.result(timeout=300)
        assert router.stats()["completed"] == len(futs), router.stats()
        router.shutdown()
    finally:
        chaos.disarm()
        mon.stop()
        for ag in agents.values():
            ag.shutdown()
    assert fleet_threads_alive() == 0
