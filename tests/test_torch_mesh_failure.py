"""The failure detectors and the elastic restart of the port
(``parallel/failure.py``, ``parallel/elastic.py``) on gloo worlds, with
JAX's pure functions as the oracle: ``probe_mesh`` over a 1-D and a 2-D
mesh and over a mesh whose other ranks have left (it fails within its
timeout), ``Heartbeat`` healthy, with a rank whose counter stops (named
stale after ``stale_after`` beats) and with the peers gone
(``HeartbeatLost`` within the timeout), ``FileHeartbeat``'s documents
against JAX's, ``StragglerMonitor`` across ranks and its analysis against
JAX's, the ``RemediationPolicy`` detectors in a distributed run (a stale
peer halts with a checkpoint and the peer as ``lost_processes``; the
straggler monitor sees every step; the stall remediation probes the
mesh), and ``ElasticRunner`` resuming a halted 2-rank ZeRO-1 run on one
rank from the canonical checkpoint, equal (1e-5) to an uninterrupted
one-rank run. Every world has the helpers' deadline."""
import json
import os

import numpy as np
import pytest
import torch

from bigdl_tpu.parallel import failure as jf
from bigdl_tpu_torch import convert, nn as tnn
from bigdl_tpu_torch.parallel import elastic as te
from bigdl_tpu_torch.parallel import failure as tf
from torch_dist_helpers import (build, elastic_world, failure_world,
                                remediation_world, run_world)

torch.set_num_threads(1)


def _mlp_case(batches):
    rng = np.random.RandomState(4)
    xs = [rng.randn(8, 6).astype(np.float32) for _ in range(batches)]
    ys = [rng.randint(1, 4, 8).astype(np.float32) for _ in range(batches)]
    return dict(model="mlp", data=("fixed", xs, ys), crit="ce",
                method="sgdm", batch=8,
                weights=convert.host_copy_tree(build("mlp", tnn).params))


@pytest.fixture(scope="module")
def failures():
    return run_world(failure_world, 4, timeout_s=90)


def test_probe_mesh(failures):
    for r in failures:
        assert r["probe"] == (True, 4, None)
        assert r["probe2"] == (True, 4)
    # the others left: the collective hangs past the timeout or gloo
    # reports the closed peers, and the probe fails either way
    ok, err = failures[0]["probe_lost"]
    assert not ok and err
    assert repr(tf.MeshProbeResult(True, 4, 0.5)) == \
        repr(jf.MeshProbeResult(True, 4, 0.5))


def test_heartbeat(failures):
    for r in failures:
        assert r["healthy"] == [[], [], []]
        # rank 3's counter stays at 1: stale once 2 beats passed it by
        assert r["stale"] == [[], [], [3], [3]]
    assert "did not complete in 1.0s" in failures[0]["beat_lost"] or \
        "failed" in failures[0]["beat_lost"]
    assert tf.Heartbeat().beat() == [] == jf.Heartbeat().beat()


def test_straggler_monitor(failures):
    for r in failures:
        rep = r["straggler"]
        assert rep["stragglers"] == [2]
        want = jf.StragglerMonitor.analyze(
            np.array(rep["per_host_mean_s"]), 1.5)
        assert rep == want
    arr = np.array([0.10, 0.11, 0.09, 0.35])
    assert tf.StragglerMonitor.analyze(arr, 1.5) == \
        jf.StragglerMonitor.analyze(arr, 1.5)


def test_file_heartbeat_documents_match_jax(tmp_path):
    docs = []
    for mod in (tf, jf):
        path = str(tmp_path / mod.__name__ / "member.json")
        hb = mod.FileHeartbeat(path)
        hb.beat({"serving": {"queue": 3}})
        doc = hb.beat({"serving": {"queue": 1}}, final=True)
        read = mod.FileHeartbeat.read(path)
        assert read == json.loads(json.dumps(doc))
        assert mod.FileHeartbeat.age_s(read, now=read["written_at"] + 2) \
            == 2.0
        assert mod.FileHeartbeat.age_s(None) == float("inf")
        assert mod.FileHeartbeat.read(path + ".missing") is None
        docs.append({k: v for k, v in read.items()
                     if k not in ("written_at", "pid")})
    assert docs[0] == docs[1]


def test_remediation_detectors_in_a_distributed_run(tmp_path):
    with pytest.raises(ValueError, match="heartbeat_every"):
        from bigdl_tpu_torch.optim import RemediationPolicy
        RemediationPolicy(heartbeat=tf.Heartbeat())
    with pytest.raises(ValueError, match="straggler_every"):
        RemediationPolicy(straggler_monitor=tf.StragglerMonitor())
    out = run_world(remediation_world, 1, _mlp_case(8), str(tmp_path),
                    timeout_s=90)[0]
    cause, lost, neval, ckpt = out["halt"]
    # beats at steps 1, 2, 3: rank 1's counter stays at 1, stale at 3
    assert (cause, lost, neval) == ("heartbeat_stale", [1], 3)
    assert ckpt == "checkpoint_remediation_e1_i3.bigdl"
    # the halt at step 3 comes before that step's time is recorded, as
    # in JAX's tick (heartbeat first)
    assert out["straggler_times"] == 2
    assert out["stall_ok"] == (True, None)
    assert out["stall_dead"] == ("stall", "permanent")


def test_elastic_runner_resumes_on_fewer_ranks(tmp_path):
    r0, r1 = run_world(elastic_world, 2, _mlp_case(2), str(tmp_path),
                       timeout_s=90)
    assert r1 == {"model": None, "attempts": [2]}
    assert r0["attempts"] == [2, 1] and r0["restarts"] == 1
    assert r0["halts"] == ["drill"]
    g, w = convert.flatten(r0["elastic"]), convert.flatten(r0["straight"])
    for k in g:
        np.testing.assert_allclose(g[k], w[k], atol=1e-5, rtol=1e-5,
                                   err_msg=k)


def test_shrink_devices_and_the_factory():
    halt = tf.TrainingHalted("x", lost_processes=[1, 3])
    assert te.shrink_devices([0, 1, 2, 3], halt) == [0, 2]
    assert te.shrink_devices([0, 1], tf.TrainingHalted("y")) == [0, 1]
    seen = []
    factory = te.data_parallel_factory(lambda mesh: seen.append(mesh))
    assert callable(factory)
    with pytest.raises(ValueError, match="max_restarts"):
        te.ElasticRunner(factory, "/nonexistent", max_restarts=-1)
