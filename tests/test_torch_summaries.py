"""Summaries and the loop's observability against the JAX package's loop:
the same twin MLP trained by both for 6 steps (per step and in supersteps)
with a train and a validation summary writes the same tags at the same
steps, values within 1e-5 (``Throughput`` by step only: it is a wall-time
rate); triggers gate the tags as in JAX; ``set_summary_trigger`` raises
JAX's errors; ``prepare_input`` and the stall / anomaly setters behave as
JAX's; the loop's spans and flight records carry JAX's names and
fields."""
import numpy as np
import pytest
import torch

import bigdl_tpu.observability as jobs
import bigdl_tpu_torch.observability as tobs
from bigdl_tpu.visualization import (TrainSummary as JaxTrainSummary,
                                     ValidationSummary as JaxValSummary)
from bigdl_tpu_torch.visualization import (TrainSummary, ValidationSummary,
                                           read_scalar)
from tests.torch_loop_helpers import (data_pair, mlp, optimizers, samples,
                                      twins, vector_batches)

torch.set_num_threads(1)
CE = lambda pkg: pkg.CrossEntropyCriterion()
SGDM = lambda o: o.SGD(learningrate=0.1, momentum=0.9)
TAGS = ("Loss", "LearningRate", "Throughput")


def _pair(tmp_path, k=1, triggers=(), val=True, iters=6):
    jm, tm, _ = twins(mlp)
    batches = vector_batches(12)
    jopt, topt = optimizers(jm, tm, data_pair(batches, fixed=True), CE,
                            SGDM, lambda o: o.max_iteration(iters), 8,
                            set_superstep=(k,), set_prefetch=(0,))
    import bigdl_tpu.optim as jo
    import bigdl_tpu_torch.optim as to
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.dataset import Sample as JaxSample
    from bigdl_tpu_torch import nn as tnn
    from bigdl_tpu_torch.dataset import Sample
    held = vector_batches(2, seed=5)
    for pkg, opt, o, nn, cls, ts, vs in (
            ("jax", jopt, jo, jnn, JaxSample, JaxTrainSummary, JaxValSummary),
            ("port", topt, to, tnn, Sample, TrainSummary,
             ValidationSummary)):
        if val:
            opt.set_validation(o.several_iteration(3), samples(held, cls),
                               [o.Loss(nn.CrossEntropyCriterion()),
                                o.Top1Accuracy()], 8)
        opt.set_train_summary(ts(str(tmp_path / pkg), "app"))
        if val:
            opt.set_val_summary(vs(str(tmp_path / pkg), "app"))
        for name, every in triggers:
            opt.set_summary_trigger(name, o.several_iteration(every))
    return jopt, topt


def _read(tmp_path, pkg, sub, tag):
    return read_scalar(str(tmp_path / pkg / "app" / sub), tag)


@pytest.mark.parametrize("k", [1, 3], ids=["steps", "superstep3"])
def test_train_and_validation_summaries_match_jax(tmp_path, k):
    jopt, topt = _pair(tmp_path, k=k)
    jopt.optimize()
    topt.optimize()
    for tag in TAGS:
        got = _read(tmp_path, "port", "train", tag)
        want = _read(tmp_path, "jax", "train", tag)
        assert [s for s, _ in got] == [s for s, _ in want] == \
            list(range(1, 7)), tag
        if tag != "Throughput":
            np.testing.assert_allclose([v for _, v in got],
                                       [v for _, v in want], rtol=1e-5,
                                       atol=1e-5, err_msg=tag)
    for tag in ("Loss", "Top1Accuracy"):
        got = _read(tmp_path, "port", "validation", tag)
        want = _read(tmp_path, "jax", "validation", tag)
        assert [s for s, _ in got] == [s for s, _ in want] == [3, 6]
        np.testing.assert_allclose([v for _, v in got],
                                   [v for _, v in want], rtol=1e-5,
                                   atol=1e-5)


def test_triggers_gate_the_tags_as_in_jax(tmp_path):
    trig = (("LearningRate", 2), ("Loss", 3), ("Top1Accuracy", 6))
    jopt, topt = _pair(tmp_path, triggers=trig)
    jopt.optimize()
    topt.optimize()
    for sub, tag in (("train", "LearningRate"), ("train", "Loss"),
                     ("train", "Throughput"), ("validation", "Loss"),
                     ("validation", "Top1Accuracy")):
        got = [s for s, _ in _read(tmp_path, "port", sub, tag)]
        assert got == [s for s, _ in _read(tmp_path, "jax", sub, tag)], tag
    assert [s for s, _ in _read(tmp_path, "port", "train",
                                "LearningRate")] == [2, 4, 6]
    assert [s for s, _ in _read(tmp_path, "port", "validation",
                                "Top1Accuracy")] == [6]


def test_validation_gate_stops_every_validation_scalar(tmp_path):
    jopt, topt = _pair(tmp_path, triggers=(("Validation", 100),))
    jopt.optimize()
    topt.optimize()
    assert _read(tmp_path, "port", "validation", "Loss") == [] == \
        _read(tmp_path, "jax", "validation", "Loss")


@pytest.mark.parametrize("methods,name", [
    (False, "Loss"), (False, "Validation"), (True, "Top1Accuracy")],
    ids=["no_summary", "validation_without_summary",
         "method_tag_without_summary"])
def test_set_summary_trigger_errors_match_jax(methods, name):
    import bigdl_tpu.optim as jo
    import bigdl_tpu_torch.optim as to
    jm, tm, _ = twins(mlp)
    jopt, topt = optimizers(jm, tm, data_pair(vector_batches(2)), CE, SGDM,
                            lambda o: o.max_iteration(1), 8)
    errors = []
    for opt, o in ((jopt, jo), (topt, to)):
        if methods:
            opt.set_validation(o.every_epoch(), [], [o.Top1Accuracy()])
        with pytest.raises(ValueError) as e:
            opt.set_summary_trigger(name, o.several_iteration(2))
        errors.append(str(e.value).replace("\u2014", "-"))
    assert errors[0] == errors[1]


def test_train_summary_alone_takes_train_tags(tmp_path):
    import bigdl_tpu_torch.optim as to
    _, topt = _pair(tmp_path, val=False)
    topt.set_summary_trigger("Throughput", to.several_iteration(2))
    with pytest.raises(ValueError, match="validation tag"):
        topt.set_summary_trigger("ValidationLoss", to.several_iteration(2))


def test_stall_and_anomaly_setters_raise_like_jax():
    jm, tm, _ = twins(mlp)
    jopt, topt = optimizers(jm, tm, data_pair(vector_batches(2)), CE, SGDM,
                            lambda o: o.max_iteration(1), 8)
    for bad in ((0,), (-1.0,), (2.0, None, 1.0)):
        msgs = []
        for opt in (jopt, topt):
            with pytest.raises(ValueError) as e:
                opt.set_stall_deadline(*bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    for opt in (jopt, topt):
        opt.set_stall_deadline(2.0, startup_grace_s=5.0)
        assert (opt.stall_deadline_s, opt.stall_startup_grace_s) == (2.0, 5.0)
        opt.set_anomaly_detection(spike_sigma=6)
        assert opt.anomaly_config == {"spike_sigma": 6}
        opt.set_anomaly_detection(False)
        assert opt.anomaly_config is None
        for setter in (opt.set_remediation, opt.set_fault_policy):
            with pytest.raises(TypeError):
                setter(object())
            assert setter(None) is opt


def test_prepare_input_touches_one_element_and_closes_it():
    from bigdl_tpu_torch.dataset import DataSet, FuncTransformer, Sample
    seen = []
    ds = DataSet.array([Sample(np.zeros(2, np.float32), np.float32(1))] * 5,
                       FuncTransformer(lambda s: seen.append(1) or s))
    jm, tm, _ = twins(mlp)
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, max_iteration
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    opt = LocalOptimizer(tm, ds, CrossEntropyCriterion(), SGD(0.1),
                         max_iteration(1), 4, device="cpu")
    assert opt.prepare_input() is opt and seen == [1]


@pytest.fixture
def traced():
    for o in (jobs, tobs):
        o.reset()
        o.enable()
        o.flight.reset()
    yield
    for o in (jobs, tobs):
        o.disable()
        o.reset()
        o.flight.reset()


SPANS = ("step", "step/data_fetch", "step/dispatch", "step/loss_sync",
         "step/validate", "step/checkpoint_submit")


@pytest.mark.parametrize("k", [1, 2], ids=["steps", "superstep2"])
def test_spans_and_flight_records_match_jax(tmp_path, traced, k):
    jopt, topt = _pair(tmp_path, k=k)
    import bigdl_tpu.optim as jo
    import bigdl_tpu_torch.optim as to
    jopt.set_checkpoint(jo.several_iteration(2), str(tmp_path / "jc"))
    topt.set_checkpoint(to.several_iteration(2), str(tmp_path / "tc"))
    jopt.optimize()
    topt.optimize()
    names = {}
    for pkg, o in (("jax", jobs), ("port", tobs)):
        names[pkg] = {e.name for e in o.get_tracer().events()}
        ev = o.flight.recorder().events()
        names[pkg + "_flight"] = [(e["kind"], e.get("neval"))
                                  for e in ev if not
                                  e["kind"].startswith("health/")]
    # a superstep group's span is step/superstep, as in JAX
    want = set(SPANS) - {"step"} | {"step/superstep"} if k > 1 \
        else set(SPANS)
    assert want <= names["port"]
    assert want & names["jax"] <= names["port"]
    assert names["port_flight"] == names["jax_flight"]
    kinds = [kd for kd, _ in names["port_flight"]]
    assert kinds[0] == "train/start" and kinds.count("step") == 6
    assert kinds.count("checkpoint") == 3
    g = tobs.registry().gauge("optim/throughput")
    assert g.value > 0
