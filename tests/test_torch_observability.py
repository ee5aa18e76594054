"""The port's control-plane building blocks against the JAX package's:
metrics, trace and exporters, the flight recorder, health (watchdog,
memory telemetry, profiler windows), cluster snapshots, chaos and the
failure taxonomy.

Each package keeps its own process globals (tracer, registry, health
listeners, watchdog thread, flight ring, armed chaos plan); the fixture
resets both packages' after every test, and one test shows that arming
either package's chaos leaves the other's disarmed. Timing: events are
waited for by polling with limits of seconds, chaos is armed by ``nth`` /
``every``, and no test bounds a wall time from above.
"""
import json
import os
import time

import pytest
import torch

from bigdl_tpu import observability as jobs
from bigdl_tpu.observability import cluster as jcluster
from bigdl_tpu.observability import flight as jflight
from bigdl_tpu.observability import health as jhealth
from bigdl_tpu.parallel import chaos as jchaos
from bigdl_tpu.parallel import failure as jfailure
from bigdl_tpu_torch import observability as obs
from bigdl_tpu_torch.observability import cluster, flight, health
from bigdl_tpu_torch.parallel import chaos, failure

torch.set_num_threads(1)


def _reset_both():
    for ch, h, o in ((chaos, health, obs), (jchaos, jhealth, jobs)):
        ch.disarm()
        h.reset()
        o.registry().reset()
        o.reset()
        o.disable()
    flight.reset()
    jflight.reset()


@pytest.fixture(autouse=True)
def _clean():
    # both packages' process globals, before (other test files of this
    # worker leave theirs) and after each test
    _reset_both()
    yield
    _reset_both()


def _poll(cond, limit_s=20.0):
    t_end = time.monotonic() + limit_s
    while time.monotonic() < t_end:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def _record(o):
    """The same instrument writes through one package's registry."""
    o.enable()
    o.counter("serve/decode_steps").inc(3)
    o.counter("serve/kv_allocs").inc(7)
    o.gauge("serve/kv_blocks_in_use", unit="blocks").set(12)
    h = o.histogram("serve/ttft_ms", unit="ms")
    for v in (1.0, 2.0, 4.0, 8.0, 16.0):
        h.observe(v)
    with o.span("serve/decode_step", rids=[1, 2]):
        with o.span("serve/prefill", rid=3):
            pass
    o.instant("serve/swap", version="v1")


def test_metrics_and_prometheus_text_equal_jax():
    _record(obs)
    _record(jobs)
    assert obs.prometheus_text() == jobs.prometheus_text()
    got, want = obs.metrics_dump(), jobs.metrics_dump()
    assert got == want
    assert obs.registry().snapshot() == jobs.registry().snapshot()


def test_chrome_trace_names_and_nesting_equal_jax():
    _record(obs)
    _record(jobs)
    got, want = obs.chrome_trace(), jobs.chrome_trace()

    def shape(t):
        return sorted((e["name"], e["ph"], json.dumps(e.get("args", {}),
                                                      sort_keys=True))
                      for e in t["traceEvents"] if e["ph"] != "M")
    assert shape(got) == shape(want)
    assert len(obs.get_tracer().events()) == 3


def test_packages_keep_their_own_globals():
    obs.enable()
    assert obs.enabled() and not jobs.enabled()
    obs.counter("serve/x").inc()
    assert jobs.registry().get("serve/x") is None
    jchaos.arm({"sites": {"s": [{"kind": "transient", "nth": 1}]}})
    assert jchaos.armed() and not chaos.armed()
    chaos.maybe_fire("s")                      # the port's: disarmed
    chaos.arm({"sites": {"t": [{"kind": "transient", "nth": 1}]}})
    jchaos.disarm()
    assert chaos.armed() and not jchaos.armed()
    events = []
    with health.listen(events.append):
        jhealth.emit("probe")
        assert events == []
        health.emit("probe")
    assert [e["kind"] for e in events] == ["health/probe"]


@pytest.mark.parametrize("plan,calls", [
    ({"sites": {"a": [{"kind": "transient", "nth": 3}],
                "b": [{"kind": "transient", "every": 2, "max_fires": 2}],
                "c": [{"kind": "permanent", "nth": 1, "tag": "r1"}]}}, 8),
    ({"seed": 11, "sites": {"a": [{"kind": "transient", "prob": 0.5}]}}, 32),
], ids=["nth_every_tag", "seeded_prob"])
def test_chaos_schedule_equals_jax(plan, calls):
    def pattern(ch, fail):
        ch.arm(plan)
        out = []
        for i in range(calls):
            for site, tag in (("a", None), ("b", None), ("c", "r0"),
                              ("c", "r1")):
                try:
                    ch.maybe_fire(site, tag=tag)
                except (fail.TransientDeviceError, ch.ChaosError) as e:
                    out.append((i, site, tag, type(e).__name__))
        return out, ch.stats(), ch.fires(), ch.sites_fired()
    assert pattern(chaos, failure) == pattern(jchaos, jfailure)


def test_chaos_wedge_and_rule_validation():
    chaos.arm({"sites": {"w": [{"kind": "wedge", "nth": 1, "wedge_s": 0.05}]}})
    t0 = time.monotonic()
    chaos.maybe_fire("w")
    assert time.monotonic() - t0 >= 0.04
    for bad in (dict(kind="sideways", nth=1), dict(nth=1, every=2),
                dict(kind="wedge", nth=1), dict(prob=1.5)):
        with pytest.raises(ValueError):
            chaos.Rule(**bad)
    with pytest.raises(TypeError):
        chaos.arm(42)


def test_chaos_arm_from_env(tmp_path):
    plan = tmp_path / "plan.json"
    plan.write_text('{"sites": {"serving/prefill": '
                    '[{"kind": "transient", "nth": 1}]}}')
    assert chaos.arm_from_env({"BIGDL_TPU_CHAOS": str(plan)}) is not None
    with pytest.raises(failure.TransientDeviceError):
        chaos.maybe_fire("serving/prefill")
    chaos.disarm()
    plan.write_text("{not json")
    assert chaos.arm_from_env({"BIGDL_TPU_CHAOS": str(plan)}) is None
    assert not chaos.armed()


MESSAGES = ["UNAVAILABLE: socket closed", "DEADLINE_EXCEEDED: rpc",
            "connection reset by peer", "RESOURCE_EXHAUSTED: out of memory",
            "INVALID_ARGUMENT: shape", "something else", "aborted"]


@pytest.mark.parametrize("msg", MESSAGES)
def test_classify_failure_equals_jax(msg):
    assert failure.classify_failure(RuntimeError(msg)) == \
        jfailure.classify_failure(RuntimeError(msg))
    assert failure.classify_failure(failure.TransientDeviceError(msg)) == \
        failure.TRANSIENT
    assert failure.classify_failure(chaos.ChaosError(msg)) == \
        jfailure.classify_failure(jchaos.ChaosError(msg))


@pytest.mark.parametrize("exc", [
    RuntimeError("CUDA error: all CUDA-capable devices are busy or "
                 "unavailable"),
    RuntimeError("paged_attention kernel launch failed (f32_split): CUDA "
                 "error 700"),
    RuntimeError("CUBLAS_STATUS_EXECUTION_FAILED when calling cublasSgemm"),
    torch.cuda.OutOfMemoryError("CUDA out of memory; temporarily short"),
    RuntimeError("CUDA driver error: unavailable"),
], ids=["busy_or_unavailable", "kernel_launch", "cublas", "oom",
        "driver"])
def test_cuda_runtime_errors_classify_permanent(exc):
    """CUDA errors are sticky: a transient word in their text (JAX's
    marker list matches "unavailable", "temporarily") must not buy a
    replay of a poisoned context."""
    assert failure.classify_failure(exc) == failure.PERMANENT
    if hasattr(torch, "AcceleratorError"):
        assert failure.classify_failure(
            torch.AcceleratorError("unavailable")) == failure.PERMANENT


def test_fault_policy_budget_equals_jax():
    def run(fail):
        sleeps = []
        p = fail.FaultPolicy(max_restarts=3, backoff_base_s=0.01,
                             backoff_max_s=0.03, sleep=sleeps.append)
        out = []
        for _ in range(5):
            ok = p.should_retry(fail.TRANSIENT)
            out.append((ok, p.should_retry(fail.PERMANENT)))
            if ok:
                p.record_failure()
                p.sleep(p.backoff_s())
        p.record_success()
        out.append(p.should_retry(fail.TRANSIENT))
        return out, sleeps, p.total_retries
    assert run(failure) == run(jfailure)
    with pytest.raises(ValueError):
        failure.FaultPolicy(max_restarts=-1)


def test_flight_bundle_and_aggregate(tmp_path, monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_FLIGHT_DIR", str(tmp_path))
    obs.enable()
    flight.record("serve/batch", n=3, loss=float("nan"))
    health.emit("stall", component="serving/batcher[r0]", silent_s=1.5)
    try:
        raise RuntimeError("boom")
    except RuntimeError as e:
        path = flight.dump_crash_bundle(e, context={"component": "x"})
    with open(path) as f:
        b = json.load(f)                        # strict JSON: NaN as text
    assert b["schema"] == jflight.SCHEMA
    assert b["error"]["type"] == "RuntimeError"
    assert [e["kind"] for e in b["events"]] == ["serve/batch",
                                                "health/stall"]
    assert b["events"][0]["loss"] == "NaN"
    assert b["env"]["torch"] == torch.__version__
    assert b["env"]["devices"] == 0 and b["env"]["process_index"] == 0
    assert set(b) == set(jflight.crash_bundle(None, {}))
    agg = flight.aggregate_bundles(str(tmp_path))
    with open(agg) as f:
        a = json.load(f)
    assert a["n_bundles"] == 1 and a["summary"][0]["error_type"] == \
        "RuntimeError"


def test_watchdog_fires_stall_and_recovery_once():
    obs.enable()
    events = []
    with health.listen(events.append):
        b = health.beacon("serving/decode_scheduler[r0]", deadline_s=0.2)
        b.pulse()
        assert _poll(lambda: any(e["kind"] == "health/stall"
                                 for e in events))
        stalls = [e for e in events if e["kind"] == "health/stall"]
        assert stalls[0]["component"] == "serving/decode_scheduler[r0]"
        b.pulse()
        assert _poll(lambda: any(e["kind"] == "health/stall_recovered"
                                 for e in events))
        b.close()
    assert len(stalls) == 1
    assert obs.registry().get("health/stall").value >= 1
    health.reset()
    assert _poll(lambda: health.watchdog_threads_alive() == 0)


def test_disabled_beacon_is_the_null_beacon():
    assert health.beacon("x", deadline_s=0.1) is health.NULL_BEACON
    obs.enable()
    assert health.beacon("x", deadline_s=0.0) is health.NULL_BEACON


def test_memory_telemetry_is_absent_on_the_cpu():
    assert health._device_memory_stats() is None
    assert not health.memory_stats_available()
    assert health.sample_device_memory() is None
    assert not health.ensure_memory_telemetry()


def test_profiler_window_writes_a_trace(tmp_path):
    w = health.profiler_window_from_env(
        {"BIGDL_TPU_PROFILE": "2:4", "BIGDL_TPU_PROFILE_DIR": str(tmp_path)})
    assert (w.start_step, w.stop_step) == (2, 4)
    x = torch.ones(8)
    for step in range(6):
        w.maybe_tick(step)
        x = x * 2
    assert w.done and not w.active and not w.failed
    assert os.path.exists(tmp_path / "trace_2_4.json")
    assert health.profiler_window_from_env({"BIGDL_TPU_PROFILE": "x"}) \
        is None
    assert health.profiler_window_from_env({}) is None


def test_series_monitor_equals_jax():
    vals = [1.0] * 20 + [9.0] + [float("nan")] * 4 + [1.0] * 5

    def run(h):
        m = h.SeriesMonitor("loss", window=8, spike_sigma=4.0,
                            nan_streak=3)
        return [[e["kind"] for e in m.observe(i, v)]
                for i, v in enumerate(vals)]
    assert run(health) == run(jhealth)


def test_cluster_snapshots_and_aggregate(tmp_path):
    obs.enable()
    obs.gauge("optim/step_time_mean", unit="s").set(0.5)
    obs.counter("serve/lm_tokens").inc(10)
    w = cluster.MetricSnapshotWriter(every_s=60.0, directory=str(tmp_path))
    assert w.maybe_write() is not None           # the first write lands
    assert w.maybe_write() is None               # cadence not elapsed
    path = w.write(step=3, final=True)
    assert os.path.basename(path) == "metrics_p00000.json"
    snaps = cluster.read_snapshots(str(tmp_path))
    assert len(snaps) == 1 and snaps[0]["step"] == 3
    assert snaps[0]["schema"] == jcluster.SNAPSHOT_SCHEMA
    view = cluster.aggregate(str(tmp_path))
    assert view["schema"] == jcluster.CLUSTER_SCHEMA
    assert view["n_processes"] == 1
    assert "serve/lm_tokens" in snaps[0]["metrics"]
    assert cluster._process_index() == 0


def test_snapshot_interval_reads_the_jax_variable(monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_METRIC_SNAP_S", "2.5")
    assert cluster.snapshot_interval_from_env() == 2.5
    assert cluster.default_writer().every_s == 2.5
