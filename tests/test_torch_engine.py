"""The port's ServingEngine against the JAX package's: the same requests,
chaos plan and fault policy through both, a small
``Sequential(Linear, ReLU, Linear)`` and ResNet-50 at 64x64 with JAX's
weights carried over by ``convert``.

Outputs are held at float32 1e-5 (the MLP) and at the whole-model spread
``tests/test_torch_resnet.py`` states for ResNet-50's eval logits (1e-3 of
the largest, against the JAX plain path); the port's engine output is
also bit for bit its own direct ``apply(training=False)`` on the padded
bucket. ``stats()`` keys compared: ``submitted``, ``completed``,
``rejected``, ``timeouts``, ``request_errors``, ``transient_retries``,
``batch_errors`` and ``swaps``, which the drill fixes whatever the
batching; ``batches`` is left out (requests submitted after ``start``
may be cut into batches differently on a loaded machine).
"""
import numpy as np
import pytest
import torch

import jax

from bigdl_tpu import nn as jnn
from bigdl_tpu.models import resnet as jresnet
from bigdl_tpu.parallel import chaos as jchaos
from bigdl_tpu.parallel.failure import FaultPolicy as JaxFaultPolicy
from bigdl_tpu.serving import ServingEngine as JaxEngine
from bigdl_tpu_torch import convert, nn
from bigdl_tpu_torch.models import ResNet
from bigdl_tpu_torch.parallel import chaos
from bigdl_tpu_torch.parallel.failure import (FaultPolicy,
                                              TransientDeviceError)
from bigdl_tpu_torch.serving import (EngineStopped, ModelRegistry, QueueFull,
                                     ServingEngine, serving_threads_alive)

torch.set_num_threads(1)
KEYS = ("submitted", "completed", "rejected", "timeouts", "request_errors",
        "transient_retries", "batch_errors", "swaps")


@pytest.fixture(autouse=True)
def _clean():
    chaos.disarm()
    jchaos.disarm()
    yield
    chaos.disarm()
    jchaos.disarm()


def _mlp_pair():
    jm = jnn.Sequential().add(jnn.Linear(4, 8)).add(jnn.ReLU()).add(
        jnn.Linear(8, 3))
    jp, js = jm.init(jax.random.PRNGKey(0))
    jp = jax.tree_util.tree_map(np.asarray, jp)
    jm.params, jm.state = jp, js
    tm = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 3))
    tm.load_state_dict(convert.jax_to_state_dict(jp, js))
    return jm, tm


def _serve(eng, ch, plan, first, then, swap_params):
    """``first`` submitted before ``start``, a swap, then ``then``:
    (results or exceptions, versions, stats)."""
    ch.arm(plan)
    futs = [eng.submit(x) for x in first]
    eng.start()
    try:
        res = [f.exception(60) or f.result(60) for f in futs]
        eng.swap(swap_params, version="v1")
        late = [eng.submit(x) for x in then]
        res += [f.result(60) for f in late]
        futs += late
        st = eng.stats()
    finally:
        eng.shutdown()
        ch.disarm()
    return res, [f.version for f in futs], st


def test_mlp_drill_matches_jax():
    """A transient fault at ``serving/engine_dispatch`` replays the batch,
    a malformed request fails alone, a hot swap serves the rest on v1."""
    jm, tm = _mlp_pair()
    rng = np.random.RandomState(0)
    first = [rng.randn(4).astype(np.float32) for _ in range(9)]
    first[5] = np.ones(5, np.float32)                  # malformed
    then = [rng.randn(4).astype(np.float32) for _ in range(3)]
    plan = {"sites": {"serving/engine_dispatch": [
        {"kind": "transient", "nth": 2}]}}
    kw = dict(input_shape=(4,), max_batch=4, max_wait_ms=1.0)
    jv1 = jax.tree_util.tree_map(lambda a: a * 1.5, jm.params)
    want, jver, jst = _serve(
        JaxEngine(jm, fault_policy=JaxFaultPolicy(max_restarts=1,
                                                  backoff_base_s=0.0), **kw),
        jchaos, plan, first, then, jv1)
    tv1 = jax.tree_util.tree_map(lambda t: t.detach() * 1.5, tm.params)
    got, ver, st = _serve(
        ServingEngine(tm, device="cpu", fault_policy=FaultPolicy(
            max_restarts=1, backoff_base_s=0.0), **kw),
        chaos, plan, first, then, tv1)
    assert {k: st[k] for k in KEYS} == {k: jst[k] for k in KEYS}
    assert st["transient_retries"] == 1 and st["request_errors"] == 1
    assert ver == jver == ["v0"] * 5 + [None] + ["v0"] * 3 + ["v1"] * 3
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 5:
            assert isinstance(g, ValueError) and isinstance(w, ValueError)
            continue
        assert g.shape == (3,) and g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=1e-5)
    assert serving_threads_alive() == 0


def test_retry_budget_backoff_and_fresh_budget_per_batch():
    _, tm = _mlp_pair()
    sleeps = []
    pol = FaultPolicy(max_restarts=2, backoff_base_s=0.01,
                      sleep=sleeps.append)
    chaos.arm({"sites": {"serving/engine_dispatch": [
        {"kind": "transient", "every": 1, "max_fires": 5}]}})
    x = np.ones(4, np.float32)
    with ServingEngine(tm, input_shape=(4,), max_batch=2, device="cpu",
                       fault_policy=pol, warmup=False) as eng:
        exc = eng.submit(x).exception(60)           # fires 1-3: spent
        assert isinstance(exc, TransientDeviceError)
        assert eng.predict(x, timeout=60).shape == (3,)   # fires 4-5
        st = eng.stats()
    assert sleeps == [0.01, 0.02, 0.01, 0.02]
    assert st["transient_retries"] == 4 and st["batch_errors"] == 1


def test_cuda_runtime_error_fails_the_batch_without_retry():
    _, tm = _mlp_pair()
    eng = ServingEngine(tm, input_shape=(4,), max_batch=2, device="cpu",
                        warmup=False)
    orig, n = eng._fwd, [0]

    def fwd(*a):
        n[0] += 1
        if n[0] == 1:
            raise RuntimeError("fused_matmul_fwd kernel launch failed "
                               "(f32_sm90): CUDA error 700")
        return orig(*a)
    eng._fwd = fwd
    with eng:
        exc = eng.submit(np.ones(4, np.float32)).exception(60)
        assert "CUDA error" in str(exc)
        assert eng.predict(np.ones(4, np.float32), timeout=60) is not None
        st = eng.stats()
    assert st["transient_retries"] == 0 and st["batch_errors"] == 1


def test_admission_deadline_and_shutdown_are_typed():
    _, tm = _mlp_pair()
    eng = ServingEngine(tm, input_shape=(4,), max_batch=2, max_queue=2,
                        device="cpu")
    a = eng.submit(np.ones(4, np.float32), deadline_ms=0.0)
    eng.submit(np.ones(4, np.float32))
    with pytest.raises(QueueFull):
        eng.submit(np.ones(4, np.float32))
    eng.start()
    assert type(a.exception(60)).__name__ == "DeadlineExceeded"
    eng.shutdown()
    with pytest.raises(EngineStopped):
        eng.submit(np.ones(4, np.float32))
    st = eng.stats()
    assert (st["rejected"], st["timeouts"], st["completed"]) == (1, 1, 1)
    assert eng.device.type == "cpu" and eng.registry.device.type == "cpu"
    reg = ModelRegistry(device="cpu")
    assert ServingEngine(tm, registry=reg).device.type == "cpu"


def test_resnet50_engine_matches_jax_and_its_own_apply(monkeypatch):
    """ResNet-50 (NHWC, ``fused="pallas"``, ``fused_conv2``) at 64x64
    served through both engines: one batch of 3 in a bucket of 4 (a zero
    pad row), one transient retry. The port's rows equal its direct
    ``apply(training=False)`` on the padded bucket bit for bit."""
    monkeypatch.setenv("BIGDL_TPU_FLASH", "off")
    tm = ResNet(10, 50, format="NHWC", fused="pallas",
                zero_init_residual=False, fused_conv2=True, device="cpu")
    tm.evaluate()
    p, s = convert.to_numpy_trees(tm)
    jm = jresnet.ResNet(10, 50, format="NHWC", fused="pallas",
                        zero_init_residual=False)
    jm.params, jm.state = p, s
    jm.evaluate()
    rng = np.random.RandomState(0)
    xs = [rng.randn(64, 64, 3).astype(np.float32) for _ in range(3)]
    plan = {"sites": {"serving/engine_dispatch": [
        {"kind": "transient", "nth": 1}]}}
    kw = dict(input_shape=(64, 64, 3), max_batch=4, warmup=False)
    out = {}
    for pkg, eng, ch in (
            ("jax", JaxEngine(jm, **kw), jchaos),
            ("port", ServingEngine(tm, device="cpu", **kw), chaos)):
        ch.arm(plan)
        futs = [eng.submit(x) for x in xs]
        eng.start()
        out[pkg] = np.stack([f.result(120) for f in futs])
        assert eng.stats()["transient_retries"] == 1
        assert [f.trace["bucket"] for f in futs] == [4, 4, 4]
        eng.shutdown()
        ch.disarm()
    want = out["jax"]
    assert np.abs(out["port"] - want).max() <= 1e-3 * np.abs(want).max()
    bucket = np.concatenate([np.stack(xs), np.zeros((1, 64, 64, 3),
                                                    np.float32)])
    with torch.inference_mode():
        direct, _ = tm.apply(tm.params, tm.state, torch.from_numpy(bucket),
                             training=False)
    np.testing.assert_array_equal(out["port"], direct.numpy()[:3])


# -- utils.engine (the runtime engine, not the serving one) ---------------

def test_utils_engine_members():
    """The engine's CUDA members: ``init`` joins the process group, builds
    the mesh, records its numbers and seeds,
    ``device_count`` counts CUDA devices, ``RandomGenerator`` draws from
    the port's seeded generator (reproducible, not JAX's values)."""
    from bigdl_tpu.utils import engine as jengine
    from bigdl_tpu_torch.utils import engine
    import random
    saved = (dict(engine._state), torch.get_rng_state(),
             np.random.get_state(), random.getstate())
    try:
        _engine_members(engine, jengine)
    finally:    # the process's engine and generators as they were
        engine.destroy_process_group()
        engine._state.clear()
        engine._state.update(saved[0])
        torch.set_rng_state(saved[1])
        np.random.set_state(saved[2])
        random.setstate(saved[3])


def _engine_members(engine, jengine):
    # a process without torchrun's variables is a world of one (gloo on
    # the CPU), and the engine's mesh is one 'data' axis over it
    mesh = engine.init(node_number=2, core_number=3, seed=7, device="cpu")
    assert engine.get_mesh() is mesh and mesh.mesh_dim_names == ("data",)
    assert engine.process_group()["backend"] == "gloo" and mesh.size() == 1
    assert engine.is_initialized() and engine.get_seed() == 7
    assert (engine.node_number(), engine.core_number()) == (2, 3)
    assert engine.engine_type() == "cuda"
    assert engine.device_count() == torch.cuda.device_count()
    assert engine.default_dtype() is jengine.default_dtype()
    engine.RandomGenerator.set_seed(5)
    a = engine.RandomGenerator.uniform(-1.0, 2.0, (64,))
    n = engine.RandomGenerator.normal(3.0, 0.5, (2, 3))
    engine.RandomGenerator.set_seed(5)
    torch.testing.assert_close(engine.RandomGenerator.uniform(-1.0, 2.0,
                                                              (64,)), a)
    assert float(a.min()) >= -1.0 and float(a.max()) < 2.0
    assert n.shape == (2, 3)
