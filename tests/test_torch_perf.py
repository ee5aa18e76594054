"""The port's program cost notes (``observability.perf``) against the JAX
package's: the peak table and its override, one artifact per input
shape, ``note_step``'s gauges from the same FLOPs and walls, the
artifacts in the flight bundle and in ``dump_artifacts``' JSON, the sites
that record them (the training step, a superstep group, the evaluator,
the predictor, the decode scheduler), and nothing recorded with
observability off.

FLOPs in eager PyTorch come from ``FlopCounterMode``, which sees aten
operations only; a hand kernel launched through ``ctypes`` adds its
plain version's count itself (``kernels._flops.tally``). Here, on the
CPU, every wrapper runs its plain version, so the tallies are held two
ways: each wrapper's formula equals what the counter counts for its
plain version, and a small LM training step counts the same with the
attention's plain versions counted as aten operations as with them
hidden from the counter and tallied.
"""
import json
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.flop_counter import FlopCounterMode

from bigdl_tpu import observability as jobs
from bigdl_tpu.observability import perf as jperf
from bigdl_tpu_torch import kernels, nn, observability as obs
from bigdl_tpu_torch.dataset import DataSet, Sample
from bigdl_tpu_torch.kernels import _flops
from bigdl_tpu_torch.models import TransformerLM, lm_loss_chunked
from bigdl_tpu_torch.observability import flight, perf
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, max_iteration

torch.set_num_threads(1)
fa = kernels.flash_attention
pa = kernels.paged_attention


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    monkeypatch.setenv("BIGDL_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("BIGDL_TPU_PEAK_FLOPS", "1e9")
    for o, p in ((obs, perf), (jobs, jperf)):
        o.disable()
        o.reset()
        o.registry().reset()
        p.reset()
    yield
    for o, p in ((obs, perf), (jobs, jperf)):
        o.disable()
        o.reset()
        o.registry().reset()
        p.reset()


def _mlp():
    torch.manual_seed(0)
    return nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 1))


def _train(steps=4, superstep=1, batch=16):
    rng = np.random.RandomState(0)
    x = rng.randn(steps * batch, 8).astype(np.float32)
    y = rng.randn(steps * batch, 1).astype(np.float32)
    opt = LocalOptimizer(_mlp(), DataSet.array(
        [Sample(a, b) for a, b in zip(x, y)]), nn.MSECriterion(),
        SGD(learningrate=0.01), max_iteration(steps), batch, device="cpu")
    if superstep > 1:
        opt.set_superstep(superstep)
    opt.optimize()
    return opt


# -- the peak table ---------------------------------------------------------------

def test_peak_flops_table_and_env_override(monkeypatch):
    monkeypatch.delenv("BIGDL_TPU_PEAK_FLOPS", raising=False)
    assert perf.PEAK_FLOPS_TABLE == (("H100", 989.0e12),)
    assert perf.peak_flops("NVIDIA H100 80GB HBM3") == 989.0e12
    assert perf.peak_flops("") == perf.DEFAULT_PEAK_FLOPS == 989.0e12
    monkeypatch.setenv("BIGDL_TPU_PEAK_FLOPS", "2.5e12")
    assert perf.peak_flops("NVIDIA H100 80GB HBM3") == 2.5e12
    monkeypatch.setenv("BIGDL_TPU_PEAK_FLOPS", "not a number")
    assert perf.peak_flops("") == perf.DEFAULT_PEAK_FLOPS


def test_step_perf_peak_unsticks_when_env_unset(monkeypatch):
    sp = perf._StepPerf()
    monkeypatch.setenv("BIGDL_TPU_PEAK_FLOPS", "1e9")
    assert sp.peak() == 1e9
    monkeypatch.delenv("BIGDL_TPU_PEAK_FLOPS")
    assert sp.peak() == perf.peak_flops("")
    monkeypatch.setenv("BIGDL_TPU_PEAK_FLOPS", "3e9")
    assert sp.peak() == 3e9


# -- artifacts --------------------------------------------------------------------

def test_one_artifact_per_input_shape():
    obs.enable()
    w = torch.randn(6, 5)
    f = perf.instrument_jit(lambda a, x: x @ a, name="t/fn", kind="forward",
                            key_argnums=(1,))
    for rows in (3, 3, 4, 3):
        f(w, torch.randn(rows, 6))
    arts = perf.registry().artifacts()
    assert [a.name for a in arts] == ["t/fn", "t/fn"]
    assert f.compiled_shape_count() == 2
    assert [a.flops for a in arts] == [2 * 3 * 6 * 5, 2 * 4 * 6 * 5]
    assert not f.last_call_compiled and f.last_artifact is arts[0]
    a = arts[0]
    assert a.input_shapes == ["(6, 5):torch.float32",
                              "(3, 6):torch.float32"]
    assert a.backend == "cpu" and a.degraded is None
    # no device memory on the CPU: only the fields eager mode has
    assert set(a.analysis) == {"flops"} and a.resident_bytes() is None
    assert obs.registry().counter("compile/programs").value == 2
    assert obs.registry().gauge("compile/flops_last").value == 2 * 4 * 6 * 5


def test_disabled_observability_records_nothing():
    _train(steps=3)
    assert perf.registry().artifacts() == []
    assert obs.registry().get("perf/mfu") is None


@pytest.mark.parametrize("host,dispatch", [(None, None), (0.01, 0.002)])
def test_note_step_gauges_equal_jax(host, dispatch):
    obs.enable()
    jobs.enable()
    flops = 3.2e7
    arts = [m.CompiledArtifact("optim/step", "train_step", [],
                               analysis={"flops": flops})
            for m in (perf, jperf)]
    for wall in (0.05, 0.07, 0.04):
        perf.note_step(arts[0], wall, host_s=host, dispatch_s=dispatch)
        jperf.note_step(arts[1], wall, host_s=host, dispatch_s=dispatch)
    names = ["perf/mfu", "perf/mfu_mean", "perf/model_flops_per_s",
             "perf/phase_host_frac", "perf/phase_dispatch_frac",
             "perf/phase_device_frac"]
    for n in names:
        got, want = obs.registry().get(n), jobs.registry().get(n)
        assert (got is None) == (want is None) == (host is None and
                                                   "phase" in n), n
        if want is not None:
            assert got.value == want.value, n
    assert obs.registry().counter("perf/model_flops").value == \
        jobs.registry().counter("perf/model_flops").value == 3 * flops
    # a missing artifact or one without FLOPs publishes nothing
    perf.reset()
    obs.registry().reset()
    perf.note_step(None, 1.0)
    perf.note_step(perf.CompiledArtifact("x", "forward", []), 1.0)
    perf.note_step("no such program", 1.0)
    assert obs.registry().get("perf/mfu") is None


def test_optimizer_step_records_artifact_and_mfu():
    obs.enable()
    opt = _train(steps=4)
    arts = [a for a in perf.registry().artifacts() if a.name == "optim/step"]
    assert len(arts) == 1
    a = arts[0]
    assert a.kind == "train_step" and a.steps_per_program == 1
    assert a.compile_seconds > 0 and a.input_shapes
    # the MLP's matrix products at batch 16: forward, the weights'
    # gradients and the hidden layer's input gradient
    B, I, H, O = 16, 8, 16, 1
    assert a.flops == 2 * B * (I * H + H * O) + 2 * B * (I * H + H * O) \
        + 2 * B * H * O
    live = obs.registry().gauge("perf/mfu_mean").value
    walls = [d + s for d, s in zip(opt.metrics.values["data_time"][1:],
                                   opt.metrics.values["step_time"][1:])]
    offline = a.flops * len(walls) / sum(walls) / 1e9
    assert live == pytest.approx(offline, rel=0.10)
    for n in ("host", "dispatch", "device"):
        assert 0.0 <= obs.registry().gauge(
            f"perf/phase_{n}_frac").value <= 1.0


def test_superstep_group_records_k():
    obs.enable()
    _train(steps=4, superstep=2)
    a = perf.registry().latest("optim/step")
    assert a is not None and a.steps_per_program == 2
    assert any(s.startswith("(2, ") for s in a.input_shapes), a.input_shapes
    assert a.flops_per_step == a.flops / 2


def test_evaluator_and_predictor_record_artifacts():
    from bigdl_tpu_torch.optim.evaluator import Evaluator
    from bigdl_tpu_torch.optim.predictor import Predictor
    from bigdl_tpu_torch.optim.validation import Top1Accuracy
    obs.enable()
    m = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))
    rng = np.random.RandomState(1)
    x = rng.randn(32, 8).astype(np.float32)
    y = rng.randint(1, 5, (32,)).astype(np.float32)
    ds = DataSet.array([Sample(a, b) for a, b in zip(x, y)])
    Evaluator(m).evaluate(ds, [Top1Accuracy()], batch_size=16)
    Predictor(m).predict(ds, batch_size=16)
    Predictor(m).set_superstep(2).predict(ds, batch_size=8)
    names = {a.name for a in perf.registry().artifacts()}
    assert {"eval/forward_stats", "predict/forward/Sequential",
            "predict/forward_scan/Sequential"} <= names, names
    scan = perf.registry().latest("predict/forward_scan/Sequential")
    assert scan.flops == 2 * 2 * 8 * (8 * 16 + 16 * 4)


def test_decode_scheduler_records_its_step():
    from bigdl_tpu_torch.serving import DecodeScheduler
    obs.enable()
    lm = TransformerLM(vocab_size=32, hidden_size=16, num_heads=2,
                       filter_size=32, num_layers=1, max_len=64,
                       device="cpu")
    with DecodeScheduler(lm, max_slots=2, block_size=4, max_seq_len=32,
                         prefill_chunk=8) as s:
        s.generate([1, 2, 3], 3, timeout=60)
    arts = [a for a in perf.registry().artifacts()
            if a.name == "serve/decode_step"]
    assert arts and all(a.kind == "forward" and a.flops > 0 for a in arts)


def test_flight_bundle_and_dump_carry_the_programs_as_jax():
    obs.enable()
    _train(steps=2)
    bundle = flight.crash_bundle(error=RuntimeError("x"))
    assert any(p["name"] == "optim/step" for p in bundle["programs"])
    path = perf.dump_artifacts()
    doc = json.load(open(path))
    assert os.path.basename(path) == f"xla_programs_{os.getpid()}.json"
    # JAX's document, key for key
    jdoc_keys = {"schema", "written_at", "pid", "programs", "metrics"}
    assert set(doc) == jdoc_keys and doc["schema"] == jperf.ARTIFACT_SCHEMA
    jart = jperf.CompiledArtifact("optim/step", "train_step", [])
    assert set(doc["programs"][0]) == set(jart.to_dict())
    assert "compile/programs" in doc["metrics"]


# -- the kernels' tallies ---------------------------------------------------------

def _count(fn, *args):
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return fc.get_total_flops()


def test_each_wrapper_formula_equals_its_plain_version_count():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    q, k, v = r(2, 3, 7, 16), r(2, 3, 9, 16), r(2, 3, 9, 16)
    assert _count(fa.flash_fwd_reference, q, k, v, True, 2, 6) == \
        fa._fwd_flops(q, 6, 16)
    q9 = r(2, 3, 9, 16)
    o, lse = fa.flash_fwd_reference(q9, k, v, True)
    assert _count(fa.flash_bwd_reference, q9, k, v, o, lse, r(*o.shape),
                  True) == fa._bwd_flops(q9, k, 16)
    qp, pages = r(2, 4, 1, 16), r(6, 2, 4, 16)
    tables = torch.tensor([[1, 2, 0], [3, 4, 5]], dtype=torch.int32)
    pos = torch.tensor([5, 9], dtype=torch.int32)
    assert _count(pa.paged_attention_reference, qp, pages, pages, tables,
                  pos) == pa._flops_of(qp, pages, tables)
    M, K, N = 10, 12, 6
    x, w, a, b = r(M, K), r(K, N), r(K), r(K)
    fm, fc_, fcv = (kernels.fused_matmul, kernels.fused_chain,
                    kernels.fused_conv)
    assert _count(fm.fused_matmul_fwd_reference, x, w, a, b, True, True) \
        == 2 * M * K * N
    z, s1, s2 = fm.fused_matmul_fwd_reference(x, w, a, b, True, True)
    assert _count(fm.fused_matmul_bwd_reference, x, w, a, b, z, r(M, N),
                  r(N), r(N), True, True) == 4 * M * K * N
    assert _count(fc_.residual_chain_reference, x, x, a, b, w) \
        == 2 * M * K * N
    h, zo, s1, s2 = fc_.residual_chain_reference(x, x, a, b, w)
    assert _count(fc_.residual_chain_bwd_reference, x, x, a, b, w, zo,
                  r(M, K), r(M, N), r(N), r(N), True) == 4 * M * K * N
    xc, wc = r(2, 6, 6, 4), r(3, 3, 4, 5)
    M2 = 2 * 3 * 3
    assert _count(fcv.conv3x3_reference, xc, wc, r(4), r(4), 2) \
        == 2 * M2 * 5 * 9 * 4
    i8 = lambda *s: torch.randint(-128, 128, s, dtype=torch.int8,
                                  generator=g)
    A, Bm = i8(7, 33), i8(5, 33)
    assert _count(kernels.int8_matmul, A, Bm) == 2 * 7 * 5 * 33
    xq, wq = i8(2, 6, 9, 9), i8(4, 3, 3, 3)
    out = kernels.int8_conv2d(xq, wq, 2, 1, 1, 2)
    assert _count(kernels.int8_conv2d, xq, wq, 2, 1, 1, 2) \
        == 2 * out.numel() * 3 * 3 * 3


def _hidden(fn, name, formula):
    """``fn`` with its aten operations hidden from the counter and its
    formula tallied instead: what a kernel launch looks like to it."""
    def run(*args, **kw):
        with _disable_current_modes():
            out = fn(*args, **kw)
        _flops.tally(name, formula(*args, **kw))
        return out
    return run


def _lm_step_flops():
    torch.manual_seed(0)
    lm = TransformerLM(vocab_size=64, hidden_size=32, num_heads=4,
                       filter_size=64, num_layers=2, max_len=32,
                       device="cpu")
    ids = torch.from_numpy(np.random.RandomState(0).randint(1, 64, (2, 17)))
    leaves = list(lm.parameters())

    def step(params, x, y):
        h = lm.hidden_states(params, x, training=True)
        loss = lm_loss_chunked(h, params["embed"], y, chunk=8)
        return torch.autograd.grad(loss, leaves)
    f = perf.instrument_jit(step, name="t/lm_step", kind="train_step",
                            key_argnums=(1, 2))
    f(lm.params, ids[:, :-1], ids[:, 1:])
    return f.last_artifact.flops


def test_lm_step_counts_the_same_through_the_kernel_tallies(monkeypatch):
    """The count of a training step with the attention's plain versions
    counted by the counter equals the count with them hidden and their
    wrappers' formulas tallied, as on the card."""
    obs.enable()
    plain = _lm_step_flops()
    orig = {n: getattr(fa, n) for n in ("flash_fwd_reference",
                                        "flash_bwd_reference")}
    monkeypatch.setattr(fa, "flash_fwd_reference", _hidden(
        fa.flash_fwd_reference, "flash_fwd",
        lambda q, k, v, causal=False, q_offset=0, kv_len=None:
        fa._fwd_flops(q, k.shape[2] if kv_len is None else kv_len,
                      q.shape[-1])))
    monkeypatch.setattr(fa, "flash_bwd_reference", _hidden(
        fa.flash_bwd_reference, "flash_bwd",
        lambda q, k, *a, **kw: fa._bwd_flops(q, k, q.shape[-1])))
    tallied = _lm_step_flops()
    assert plain == tallied
    # hidden and not tallied, the count misses exactly the attention: 2
    # layers, (B, H, T, D) = (2, 4, 16, 8), forward 4 BHT^2D and
    # backward 10 BHT^2D each
    for name in ("flash_fwd_reference", "flash_bwd_reference"):
        monkeypatch.setattr(fa, name, _hidden(orig[name], name,
                                              lambda *a, **kw: 0))
    assert tallied - _lm_step_flops() == 2 * 14 * 2 * 4 * 16 * 16 * 8
    # a tally outside a counting context goes nowhere
    _flops.tally("flash_fwd", 10**9)
