"""The loop's self-healing tiers on the port, mirroring the JAX package's
``tests/test_resilience.py`` (and its loop's behaviour, run side by side
where the two can be compared):

* fault replay (``set_fault_policy``): a transient fault injected by a
  subclass that overrides ``_step`` - also AFTER the step wrote the
  parameters, the optimizer state and drew dropout - is replayed from the
  snapshot, bit for bit the fault-free run, in the step loop and in
  a superstep group; the budget runs out; a permanent failure passes;
* stall remediation: a data set that blocks (on an event, released when
  the halt is queued, never a fixed sleep) halts the run with
  ``TrainingHalted`` whose checkpoint the side thread wrote, holding the
  last completed step's parameters, also when the data arrives while the
  checkpoint copies (no step runs under the copy); a transient stall
  re-arms;
* anomaly control: a plateau drives a ``Plateau`` schedule and early-stops
  at the same iteration as JAX's loop, the policy's own scale, spike
  overload;
* the refused multi-GPU detectors, the crash bundle of a failed step and
  the flight record kinds against JAX's for the same run."""
import glob
import json
import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch

import bigdl_tpu.observability as jobs
import bigdl_tpu_torch.observability as tobs
from bigdl_tpu_torch import convert, nn
from bigdl_tpu_torch.dataset import MiniBatch
from bigdl_tpu_torch.observability import health
from bigdl_tpu_torch.optim import (SGD, Adam, LocalOptimizer, Plateau,
                                   max_iteration, several_iteration)
from bigdl_tpu_torch.optim.optimizer import RemediationPolicy
from bigdl_tpu_torch.parallel.failure import (PERMANENT, FaultPolicy,
                                              TrainingHalted,
                                              TransientDeviceError)
from tests.torch_loop_helpers import (FixedBatches, data_pair, mlp,
                                      optimizers, twins, vector_batches)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_observability(tmp_path, monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    for o in (tobs, jobs):
        o.disable()
        o.reset()
        o.flight.reset()
    yield
    for o in (tobs, jobs):
        o.disable()
        o.reset()
        o.flight.reset()
    assert health.watchdog_threads_alive() == 0 or _wait_no_watchdog()


def _wait_no_watchdog(cap=10.0):
    end = time.monotonic() + cap
    while time.monotonic() < end:
        if health.watchdog_threads_alive() == 0:
            return True
        time.sleep(0.02)
    return False


def _model(seed=0):
    torch.manual_seed(seed)
    m = nn.Sequential(nn.Linear(6, 16), nn.ReLU(), nn.Dropout(0.3),
                      nn.Linear(16, 3))
    m.reset(torch.Generator().manual_seed(seed))
    return m


def _data(n, seed=7, constant=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 6).astype(np.float32)
    y = rng.randn(n, 3).astype(np.float32)
    if constant:
        x[:] = x[0]
        y[:] = y[0]
    return x, y


class _FlakyLocal(LocalOptimizer):
    """``LocalOptimizer`` whose ``_step`` raises an injected error on the
    chosen calls (every attempt counts, retries too), before the step or,
    with ``after``, once the step has written the tensors and drawn its
    dropout."""

    def __init__(self, *a, fail_on=(), error=None, after=False, **kw):
        super().__init__(*a, **kw)
        self._fail_on = set(fail_on)
        self._error = error or (lambda: TransientDeviceError(
            "injected collective flake"))
        self._after = after
        self.calls = 0

    def _step(self, *args):
        self.calls += 1
        fail = self.calls in self._fail_on or "all" in self._fail_on
        if fail and not self._after:
            raise self._error()
        loss = super()._step(*args)
        if fail:
            raise self._error()
        return loss


def _run(cls=LocalOptimizer, steps=6, superstep=1, opt_kw=None, setup=None,
         method=None, data=None):
    x, y = data or _data(steps * 8)
    opt = cls(_model(), (x, y), nn.MSECriterion(),
              optim_method=method or Adam(learningrate=0.01),
              end_trigger=max_iteration(steps), batch_size=8, device="cpu",
              **(opt_kw or {}))
    if superstep > 1:
        opt.set_superstep(superstep)
    if setup:
        setup(opt)
    opt.optimize()
    return opt


def _bitwise(a, b):
    fa, fb = convert.flatten(convert.host_copy_tree(a)), \
        convert.flatten(convert.host_copy_tree(b))
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _policy(**kw):
    return FaultPolicy(max_restarts=2, backoff_base_s=0,
                       sleep=lambda s: None, **kw)


# --------------------------------------------------- fault replay

@pytest.mark.parametrize("after", [False, True],
                         ids=["before_the_step", "after_the_writes"])
def test_transient_replay_is_bitwise_step_loop(after):
    clean = _run()
    flaky = _run(cls=_FlakyLocal, opt_kw={"fail_on": (3,), "after": after},
                 setup=lambda o: o.set_fault_policy(_policy()))
    _bitwise(clean.model.params, flaky.model.params)
    assert flaky.fault_policy.total_retries == 1
    assert flaky.metrics.values["fault_retries"] == [1.0]
    assert flaky.calls == 7     # 6 steps and the failed attempt


@pytest.mark.parametrize("fail_on,after", [((3,), False), ((4,), False),
                                           ((4,), True)],
                         ids=["first_microstep", "second_microstep",
                              "after_the_group_wrote"])
def test_transient_replay_is_bitwise_superstep_group(fail_on, after):
    """The whole K-step group replays: a fault at its second microstep
    comes after the first wrote the tensors in place."""
    clean = _run(superstep=2)
    flaky = _run(cls=_FlakyLocal, superstep=2,
                 opt_kw={"fail_on": fail_on, "after": after},
                 setup=lambda o: o.set_fault_policy(_policy()))
    _bitwise(clean.model.params, flaky.model.params)
    assert flaky.fault_policy.total_retries == 1
    assert flaky.calls == 6 + (fail_on[0] - 2 * ((fail_on[0] - 1) // 2))


def test_fault_budget_exhaustion_and_permanent_passthrough():
    with pytest.raises(TransientDeviceError):
        _run(cls=_FlakyLocal, opt_kw={"fail_on": ("all",)},
             setup=lambda o: o.set_fault_policy(_policy()))
    fp = FaultPolicy(max_restarts=5, backoff_base_s=0, sleep=lambda s: None)
    with pytest.raises(ValueError, match="deterministic bug"):
        _run(cls=_FlakyLocal,
             opt_kw={"fail_on": (2,),
                     "error": lambda: ValueError("deterministic bug")},
             setup=lambda o: o.set_fault_policy(fp))
    assert fp.total_retries == 0


def test_replay_counts_snapshots_and_emits_retry_events():
    tobs.enable()
    events = []
    with health.listen(lambda ev: events.append(ev["kind"])):
        flaky = _run(cls=_FlakyLocal, opt_kw={"fail_on": (2,)},
                     setup=lambda o: o.set_fault_policy(_policy()))
    assert events.count("health/fault_retry") == 1
    assert tobs.registry().counter("optim/fault_snapshots").value == 6
    assert flaky.optim_method.state["neval"] == 6


# ------------------------------------------------ stall remediation

class _StallingSet:
    """Batch-level data set that blocks before batch ``stall_before``
    until ``release()`` returns True (polled, capped at 30 s)."""

    def __init__(self, x, y, batch, stall_before, release):
        self.x, self.y, self.batch = x, y, batch
        self.stall_before, self.release = stall_before, release
        self.waited = None

    def batches_per_epoch(self):
        return len(self.x) // self.batch

    def size(self):
        return len(self.x)

    def shuffle(self):
        return self

    def data(self, train=True):
        for i in range(self.batches_per_epoch()):
            if i == self.stall_before:
                t0 = time.monotonic()
                while not self.release() and time.monotonic() - t0 < 30:
                    time.sleep(0.01)
                self.waited = time.monotonic() - t0
            lo = i * self.batch
            yield MiniBatch(self.x[lo:lo + self.batch],
                            self.y[lo:lo + self.batch])


def test_stall_remediation_checkpoints_from_the_side_thread(tmp_path):
    tobs.enable()
    x, y = _data(10 * 8)
    box = {}
    threads = []

    def release():
        if opt._halt_requested is None:
            return False
        # the loop is still blocked: these are the last completed
        # step's tensors
        box["live"] = convert.host_copy_tree(opt.model.params)
        return True

    ds = _StallingSet(x, y, 8, 3, release)
    opt = LocalOptimizer(_model(), ds, nn.MSECriterion(),
                         optim_method=SGD(learningrate=0.01, momentum=0.9),
                         end_trigger=max_iteration(10), batch_size=8,
                         device="cpu")
    real = opt._checkpoint

    def checkpoint(*a, **kw):
        threads.append(threading.current_thread() is
                       threading.main_thread())
        return real(*a, **kw)
    opt._checkpoint = checkpoint
    opt.set_checkpoint(several_iteration(1000), str(tmp_path / "ck"))
    opt.set_stall_deadline(0.4)
    opt.set_remediation(RemediationPolicy(halt_on_stall=True))
    t0 = time.monotonic()
    with pytest.raises(TrainingHalted) as ei:
        opt.optimize()
    halt = ei.value
    assert halt.cause == "stall" and halt.neval == 3
    assert threads == [False]   # written off the loop's thread
    assert "remediation" in os.path.basename(halt.checkpoint_path)
    with open(halt.checkpoint_path, "rb") as f:
        payload = pickle.load(f)
    assert payload["neval"] == 3 and payload["optim_host_state"]["neval"] == 3
    for k, v in convert.flatten(box["live"]).items():
        np.testing.assert_array_equal(
            convert.flatten(payload["params"])[k], v, err_msg=k)
    assert halt.bundle_path and os.path.exists(halt.bundle_path)
    bundle = json.load(open(halt.bundle_path))
    assert bundle["context"]["cause"] == "stall"
    assert tobs.registry().get("health/stall") is not None
    assert ds.waited < 30 and time.monotonic() - t0 < 30
    assert not [t for t in threading.enumerate()
                if t.name == "bigdl-stall-remediation"]


def test_stall_checkpoint_holds_one_step_when_data_arrives_mid_copy(
        tmp_path):
    """The data set lets go as soon as the side thread starts the halt
    checkpoint, and the checkpoint then waits (up to 1 s) for a fourth
    step: the loop must hold that step until the copy has landed and
    raise the halt instead, so the checkpoint is step 3's state exactly."""
    tobs.enable()
    x, y = _data(10 * 8)
    copying, stepped = threading.Event(), threading.Event()
    after = []

    class Recording(LocalOptimizer):
        def _step(self, *a):
            loss = super()._step(*a)
            after.append(convert.host_copy_tree(self.model.params))
            if len(after) > 3:
                stepped.set()
            return loss

    ds = _StallingSet(x, y, 8, 3, copying.is_set)
    opt = Recording(_model(), ds, nn.MSECriterion(),
                    optim_method=SGD(learningrate=0.01, momentum=0.9),
                    end_trigger=max_iteration(10), batch_size=8,
                    device="cpu")
    real = opt._checkpoint

    def checkpoint(*a, **kw):
        copying.set()
        stepped.wait(1.0)
        return real(*a, **kw)
    opt._checkpoint = checkpoint
    opt.set_checkpoint(several_iteration(1000), str(tmp_path / "ck"))
    opt.set_stall_deadline(0.4)
    opt.set_remediation(RemediationPolicy(halt_on_stall=True))
    with pytest.raises(TrainingHalted) as ei:
        opt.optimize()
    halt = ei.value
    assert halt.cause == "stall" and halt.neval == 3
    assert len(after) == 3 and not stepped.is_set()
    with open(halt.checkpoint_path, "rb") as f:
        payload = pickle.load(f)
    assert payload["neval"] == 3 and payload["optim_host_state"]["neval"] == 3
    live = convert.flatten(convert.host_copy_tree(opt.model.params))
    for k, v in convert.flatten(after[2]).items():
        np.testing.assert_array_equal(
            convert.flatten(payload["params"])[k], v, err_msg=k)
        np.testing.assert_array_equal(live[k], v, err_msg=k)
    assert ds.waited < 30


def test_transient_stall_rearms_so_the_watchdog_fires_again():
    tobs.enable()
    x, y = _data(10 * 8)
    events = []
    ds = _StallingSet(x, y, 8, 3,
                      lambda: events.count("health/stall") >= 3)
    opt = LocalOptimizer(_model(), ds, nn.MSECriterion(),
                         optim_method=SGD(learningrate=0.01),
                         end_trigger=max_iteration(10), batch_size=8,
                         device="cpu")
    opt.set_stall_deadline(0.3)
    opt.set_remediation(RemediationPolicy(halt_on_stall=False))
    with health.listen(lambda ev: events.append(ev["kind"])):
        opt.optimize()
    assert opt.optim_method.state["neval"] == 10
    assert ds.waited < 30
    assert events.count("health/stall") >= 3


def test_startup_grace_holds_until_the_first_dispatch():
    """The beacon opens at the grace and drops to the deadline after the
    first step (the grace defaults to max(deadline, BIGDL_TPU_STALL_S))."""
    tobs.enable()
    seen = []

    class Probe(LocalOptimizer):
        def _step(self, *a):
            seen.append(self._step_beacon.deadline_s)
            return super()._step(*a)

    _run(cls=Probe, steps=3, setup=lambda o: o.set_stall_deadline(
        5.0, startup_grace_s=50.0))
    assert seen == [50.0, 5.0, 5.0]
    seen.clear()
    _run(cls=Probe, steps=2, setup=lambda o: o.set_stall_deadline(5.0))
    assert seen[0] == max(5.0, health.default_stall_deadline())


# ------------------------------------------- anomaly-driven control

def _plateau_pair(policy_kw, sched):
    jm, tm, _ = twins(mlp)
    rng = np.random.RandomState(0)
    x = np.repeat(rng.randn(1, 6).astype(np.float32), 8, 0)
    y = np.full(8, 2)
    batches = [(x, y)] * 50
    jopt, topt = optimizers(
        jm, tm, data_pair(batches), lambda p: p.CrossEntropyCriterion(),
        lambda o: o.SGD(learningrate=0.0,
                        learningrate_schedule=sched(o)),
        lambda o: o.max_iteration(50), 8)
    from bigdl_tpu.optim.optimizer import RemediationPolicy as JaxPolicy
    for opt, cls in ((jopt, JaxPolicy), (topt, RemediationPolicy)):
        opt.set_anomaly_detection(min_points=2, window=8, plateau_window=3,
                                  plateau_rel=1e-7)
        opt.set_remediation(cls(**policy_kw))
        opt.optimize()
    return jopt, topt


def test_plateau_drives_the_schedule_and_stops_where_jax_stops():
    jopt, topt = _plateau_pair(
        dict(plateau_lr=True, early_stop_plateaus=1),
        lambda o: o.Plateau(factor=0.1, patience=1000))
    assert topt.optim_method.state["neval"] == \
        jopt.optim_method.state["neval"] < 50
    sched = topt.optim_method.learningrate_schedule
    assert sched.multiplier == pytest.approx(0.1)
    assert topt.remediation.plateaus == jopt.remediation.plateaus == 1


def test_plateau_scales_lr_without_a_plateau_schedule():
    jopt, topt = _plateau_pair(
        dict(plateau_lr=True, plateau_factor=0.5, early_stop_plateaus=2),
        lambda o: o.Default())
    assert topt._remediation_lr_scale == pytest.approx(0.25) == \
        jopt._remediation_lr_scale
    assert topt.optim_method.state["neval"] == \
        jopt.optim_method.state["neval"]


def test_spike_overload_halts(tmp_path):
    opt = LocalOptimizer(_model(), _data(32), nn.MSECriterion(),
                         optim_method=SGD(learningrate=0.01),
                         end_trigger=max_iteration(2), batch_size=8,
                         device="cpu")
    opt.set_checkpoint(several_iteration(1000), str(tmp_path / "ck"))
    opt.set_remediation(RemediationPolicy(max_spikes=2))
    state = {"epoch": 1, "neval": 5}
    spike = {"kind": "health/loss_spike"}
    params, mstate = opt.model.params, opt.model.state
    assert not opt._remediation_tick(state, params, {}, mstate, [spike])
    with pytest.raises(TrainingHalted) as ei:
        opt._remediation_tick(state, params, {}, mstate, [spike])
    assert ei.value.cause == "loss_spikes"
    assert ei.value.failure_class == PERMANENT
    with open(ei.value.checkpoint_path, "rb") as f:
        assert pickle.load(f)["neval"] == 5


@pytest.mark.parametrize("kw", [
    {"heartbeat": object(), "heartbeat_every": 1},
    {"straggler_monitor": object(), "straggler_every": 1}],
    ids=["heartbeat", "straggler_monitor"])
def test_multi_gpu_detectors_are_refused(kw):
    """The multi-GPU detectors are ported: a policy takes them with a
    cadence, and refuses them without one (``*_every`` < 1), as JAX's
    does (tests/test_torch_mesh_failure.py drives them)."""
    from bigdl_tpu.optim.optimizer import RemediationPolicy as JaxPolicy
    pol = RemediationPolicy(**kw)
    for k, v in kw.items():
        assert getattr(pol, k) is v if not isinstance(v, int) \
            else getattr(pol, k) == v
    every = {k: 0 for k in kw if k.endswith("_every")}
    for cls in (RemediationPolicy, JaxPolicy):
        with pytest.raises(ValueError, match="_every >= 1"):
            cls(**{**kw, **every})


def test_policy_defaults_match_jax():
    from bigdl_tpu.optim.optimizer import RemediationPolicy as JaxPolicy
    a, b = RemediationPolicy(), JaxPolicy()
    for k, v in vars(b).items():
        assert getattr(a, k) == v, k
    a.plateaus = a.spikes = 3
    a.reset_run_state()
    assert (a.plateaus, a.spikes) == (0, 0)


# --------------------------------------- crash bundles and flight records

def test_a_failed_step_dumps_a_crash_bundle(tmp_path):
    tobs.enable()
    with pytest.raises(ValueError, match="boom"):
        _run(cls=_FlakyLocal, opt_kw={"fail_on": (2,),
                                      "error": lambda: ValueError("boom")})
    [path] = glob.glob(str(tmp_path / "flight" / "*.json"))
    bundle = json.load(open(path))
    assert bundle["context"]["component"] == "optimizer"
    assert bundle["context"]["neval"] == 1
    assert "boom" in json.dumps(bundle["error"])


def test_a_halt_dumps_no_second_bundle(tmp_path):
    tobs.enable()
    opt = LocalOptimizer(_model(), _data(32), nn.MSECriterion(),
                         optim_method=SGD(learningrate=0.01),
                         end_trigger=max_iteration(2), batch_size=8,
                         device="cpu")
    real = opt._optimize_impl

    def halted():
        opt._halt_requested = TrainingHalted(cause="test")
        opt._check_halt()
        return real()
    opt._optimize_impl = halted
    with pytest.raises(TrainingHalted):
        opt.optimize()
    assert not glob.glob(str(tmp_path / "flight" / "*.json"))


@pytest.mark.parametrize("policy", ["sync", "async", "window:3"])
def test_flight_record_kinds_match_jax(tmp_path, policy):
    """A run with NaN steps skipped, a lagged loss read and checkpoints:
    the same records in both rings, each step's loss attributed to the
    step that produced it."""
    for o in (tobs, jobs):
        o.enable()
    jm, tm, _ = twins(mlp)
    batches = vector_batches(8, poison=(2, 5))
    jopt, topt = optimizers(
        jm, tm, data_pair(batches), lambda p: p.CrossEntropyCriterion(),
        lambda o: o.SGD(learningrate=0.1), lambda o: o.max_iteration(8), 8,
        set_nan_policy=("skip",), set_sync_policy=(policy,))
    import bigdl_tpu.optim as jo
    import bigdl_tpu_torch.optim as to
    jopt.set_checkpoint(jo.several_iteration(2), str(tmp_path / "j"))
    topt.set_checkpoint(to.several_iteration(2), str(tmp_path / "t"))
    jopt.optimize()
    topt.optimize()
    rec = {}
    for pkg, o in (("jax", jobs), ("port", tobs)):
        rec[pkg] = [(e["kind"], e.get("neval"), e.get("epoch"))
                    for e in o.flight.recorder().events()
                    if not e["kind"].startswith("health/")]
    assert rec["port"] == rec["jax"]
    kinds = [k for k, _, _ in rec["port"]]
    # a skipped step fires no trigger, in either package
    assert kinds.count("nan") == 2 and kinds.count("checkpoint") >= 2
