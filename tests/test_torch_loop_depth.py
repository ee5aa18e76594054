"""The port's training-loop depth against the JAX package's loop
(``tests/test_pipeline_loop.py`` and ``tests/test_superstep.py`` there):
the batch stager, the sync policies, supersteps, the NaN policies under a
lagged read, trigger clamping, the evaluator's prefetch and superstep, and
the observability counters.

Tolerances: against JAX, losses and parameters within 1e-5 (float32 on
both sides, the same formulas); the port against itself bit for bit
across prefetch, superstep and window, since the same ops run in the same
order; host state (neval, epoch, counts) exactly.
"""
import threading

import numpy as np
import pytest
import torch

import bigdl_tpu.observability as jobs
import bigdl_tpu_torch.observability as tobs
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.optim import Evaluator, Loss, Top1Accuracy
from bigdl_tpu_torch.optim.staging import (BatchStager, staged,
                                           stager_threads_alive)
from tests.torch_loop_helpers import (assert_close, assert_equal, conv_net,
                                      data_pair, image_batches, mlp,
                                      optimizers, recording, twins,
                                      vector_batches)

torch.set_num_threads(1)

CE = lambda pkg: pkg.CrossEntropyCriterion()
SGDM = lambda o: o.SGD(learningrate=0.1, momentum=0.9)


def _run(policy="sync", k=1, prefetch=0, iters=8, batches=None, fixed=False,
         nan_policy="error", method=SGDM, build=mlp):
    """Train the twin MLPs on the same batches under one configuration:
    (port optimizer, JAX optimizer, port losses, JAX losses)."""
    jm, tm, _ = twins(build)
    batches = batches or vector_batches(12)
    jl, tl = [], []
    ends = iter((jl, tl))
    jopt, topt = optimizers(
        jm, tm, data_pair(batches, fixed), CE, method,
        lambda o: o.Trigger(recording(o.max_iteration(iters), next(ends))),
        8, set_sync_policy=(policy,), set_superstep=(k,),
        set_prefetch=(prefetch,), set_nan_policy=(nan_policy,))
    return topt, jopt, tl, jl


def _port_ref():
    topt, _, tl, _ = _run()
    topt.optimize()
    return (convert.to_numpy_tree(topt.model.params),
            topt.optim_method.state["loss"])


CASES = [(p, k, d) for p in ("sync", "async", "window:4") for k in (1, 4)
         for d in (0, 2)]


@pytest.mark.parametrize("policy,k,prefetch", CASES,
                         ids=[f"{p}-k{k}-prefetch{d}" for p, k, d in CASES])
def test_loop_options_match_jax_and_the_serial_loop(policy, k, prefetch):
    """Losses as the triggers see them, final parameters, optimizer state
    and host state against JAX's loop under the same options at 1e-5;
    the final parameters bit for bit the port's serial 'sync' K=1 run."""
    topt, jopt, tl, jl = _run(policy, k, prefetch)
    topt.optimize()
    jopt.optimize()
    assert len(tl) == len(jl)
    np.testing.assert_allclose(
        [np.nan if v is None else v for v in tl],
        [np.nan if v is None else v for v in jl], atol=1e-5, rtol=1e-5)
    got = convert.to_numpy_tree(topt.model.params)
    assert_close(got, jopt.model.params, what="params")
    ts, js = topt.optim_method.state, jopt.optim_method.state
    assert (ts["neval"], ts["epoch"]) == (js["neval"], js["epoch"]) == (8, 1)
    np.testing.assert_allclose(ts["loss"], js["loss"], rtol=1e-5)
    ref, ref_loss = _port_ref()
    assert_equal(got, ref, "against the serial sync K=1 run")
    assert ts["loss"] == ref_loss       # after the drain of a lagged read
    assert stager_threads_alive() == 0


def _counts(pkg_obs, run):
    pkg_obs.enable()
    pkg_obs.registry().reset()
    try:
        run()
        reg = pkg_obs.registry()
        return {n: reg.counter(n).value for n in
                ("optim/loss_syncs", "engine/dispatches", "optim/steps")}
    finally:
        pkg_obs.disable()
        pkg_obs.registry().reset()


@pytest.mark.parametrize("policy,k,want", [
    ("sync", 1, (8, 8, 8)), ("window:4", 1, (5, 8, 8)),
    ("async", 1, (8, 8, 8)), ("sync", 4, (2, 2, 8))],
    ids=["sync", "window4", "async", "superstep4"])
def test_loss_syncs_dispatches_and_steps_count_as_in_jax(policy, k, want):
    """``optim/loss_syncs``, ``engine/dispatches`` and ``optim/steps``
    while observability is on: the port's counts equal JAX's (a window
    of 4 reads 5 of 8 losses in the loop, the rest at the drain; a
    superstep of 4 reads 2)."""
    topt, jopt, _, _ = _run(policy, k)
    got = _counts(tobs, topt.optimize)
    ref = _counts(jobs, jopt.optimize)
    assert got == ref
    assert (got["optim/loss_syncs"], got["engine/dispatches"],
            got["optim/steps"]) == want


# -- NaN policies under a lagged read and inside a superstep ------------------

NAN_CASES = [
    ("skip", "window:4", 1, (3,)), ("skip", "sync", 4, (5,)),
    ("skip", "window:4", 1, (7,)), ("skip", "async", 1, (7,)),
    ("error", "window:4", 1, (3,)), ("error", "sync", 4, (5,)),
    ("error", "window:4", 1, (7,)), ("resume", "window:3", 1, (4,)),
    ("resume", "sync", 3, (4,)), ("resume", "sync", 1, (4,)),
]


@pytest.mark.parametrize(
    "nan_policy,policy,k,poison", NAN_CASES,
    ids=[f"{a}-{b}-k{c}-nan@{d[0]}" for a, b, c, d in NAN_CASES])
def test_nan_policies_match_jax(nan_policy, policy, k, poison, tmp_path):
    """A NaN batch mid-window, inside a superstep group and on the final
    step: 'error' raises in both loops, 'skip' counts the same skips,
    'resume' restores the same checkpoint; host state, metrics and
    parameters as in JAX's loop."""
    batches = vector_batches(8, poison=poison)
    topt, jopt, _, _ = _run(policy, k, 0, iters=12, batches=batches,
                            fixed=True, nan_policy=nan_policy)
    if nan_policy == "resume":
        import bigdl_tpu.optim as jo
        import bigdl_tpu_torch.optim as to
        jopt.set_checkpoint(jo.several_iteration(2), str(tmp_path / "j"))
        topt.set_checkpoint(to.several_iteration(2), str(tmp_path / "t"))
    if nan_policy == "error":
        with pytest.raises(FloatingPointError):
            jopt.optimize()
        with pytest.raises(FloatingPointError):
            topt.optimize()
        assert stager_threads_alive() == 0
        return
    jopt.optimize()
    topt.optimize()
    ts, js = topt.optim_method.state, jopt.optim_method.state
    for key in ("neval", "epoch", "epoch_finished"):
        assert ts.get(key) == js.get(key), key
    np.testing.assert_allclose(ts["loss"], js["loss"], rtol=1e-5)
    for m in ("nan_skips", "nan_resumes"):
        assert len(topt.metrics.values.get(m, [])) == \
            len(jopt.metrics.values.get(m, [])), m
    assert_close(convert.to_numpy_tree(topt.model.params), jopt.model.params)
    assert all(np.isfinite(v).all() for v in
               convert.flatten(convert.to_numpy_tree(topt.model.params))
               .values())
    assert stager_threads_alive() == 0


def test_nan_on_the_final_steps_is_not_swallowed():
    """A NaN still in flight when the loop ends surfaces at the drain,
    in both packages; with 'skip' it is counted."""
    batches = vector_batches(4, poison=(3,))
    for nan_policy in ("error", "skip"):
        topt, jopt, _, _ = _run("window:4", 1, 2, iters=4, batches=batches,
                                fixed=True, nan_policy=nan_policy)
        if nan_policy == "error":
            with pytest.raises(FloatingPointError, match="final step"):
                topt.optimize()
            with pytest.raises(FloatingPointError, match="final step"):
                jopt.optimize()
        else:
            topt.optimize()
            jopt.optimize()
            assert topt.metrics.values["nan_skips"] == \
                jopt.metrics.values["nan_skips"] == [1.0]
    assert stager_threads_alive() == 0


# -- trigger clamping and ragged groups ---------------------------------------

def test_superstep_cuts_groups_at_checkpoint_and_end_triggers(tmp_path):
    """Checkpoints every 3 steps and an end at 10 with K=8: the same
    checkpoint files (epoch, iteration) as K=1, holding the same tensors
    bit for bit, and the run ends at 10, as in JAX."""
    import bigdl_tpu.optim as jo
    import bigdl_tpu_torch.optim as to
    files = {}
    for k in (1, 8):
        topt, jopt, _, _ = _run(k=k, iters=10, batches=vector_batches(12))
        jd, td = tmp_path / f"j{k}", tmp_path / f"t{k}"
        jopt.set_checkpoint(jo.several_iteration(3), str(jd), False)
        topt.set_checkpoint(to.several_iteration(3), str(td), False)
        jopt.optimize()
        topt.optimize()
        assert topt.optim_method.state["neval"] == 10
        files[k] = sorted(p.name for p in td.iterdir())
        assert files[k] == sorted(p.name for p in jd.iterdir())
    assert files[1] == files[8] == [f"checkpoint_e1_i{i}.bigdl"
                                    for i in (3, 6, 9)]
    import pickle
    for f in files[1]:
        a = pickle.load(open(tmp_path / "t1" / f, "rb"))
        b = pickle.load(open(tmp_path / "t8" / f, "rb"))
        assert a["neval"] == b["neval"]
        assert_equal(a["params"], b["params"], f)
        assert_equal(a["opt_state"], b["opt_state"], f)


def test_superstep_cuts_groups_at_validation():
    """A validation every 3 steps under K=4: the trigger fires at the
    same iterations as K=1 (the groups are cut there), with the same
    scores, and the parameters end bit for bit the K=1 run's."""
    import bigdl_tpu_torch.optim as to
    from bigdl_tpu_torch.dataset import Sample
    held = [Sample(x, y) for xb, yb in vector_batches(2, seed=5)
            for x, y in zip(xb, yb)]
    out = {}
    for k in (1, 4):
        topt, _, _, _ = _run(k=k, iters=8)
        seen, validate = [], topt._validate
        topt._validate = lambda s: seen.append(s["neval"]) or validate(s)
        topt.set_validation(to.several_iteration(3), held, [Loss()])
        topt.optimize()
        out[k] = (seen, topt.optim_method.state["score"],
                  convert.to_numpy_tree(topt.model.params))
    assert out[1][0] == out[4][0] == [3, 6]
    assert out[1][1] == out[4][1]
    assert_equal(out[1][2], out[4][2])


@pytest.mark.parametrize("prefetch", [0, 3], ids=["serial", "threaded"])
def test_ragged_epoch_tail_starts_its_own_group(prefetch):
    """A batch-level data set ending each epoch with a smaller batch, and
    epochs not a multiple of K: the stacking stage cuts the group at the
    shape change and at the epoch's end; two epochs match K=1 bit for
    bit and JAX's K=3 run at 1e-5."""
    sizes = [8, 8, 8, 8, 3]
    batches = vector_batches(5, sizes=sizes)
    got = {}
    for k in (1, 3):
        topt, jopt, _, _ = _run(k=k, prefetch=prefetch, iters=10,
                                batches=batches, fixed=True)
        topt.optimize()
        assert topt.optim_method.state["neval"] == 10
        got[k] = convert.to_numpy_tree(topt.model.params)
        if k == 3:
            jopt.optimize()
            assert_close(got[k], jopt.model.params)
    assert_equal(got[1], got[3])
    assert stager_threads_alive() == 0


def test_plateau_reduction_lands_in_the_next_group():
    """``Plateau`` on the loss under K=4: each group's lr vector is
    computed at its start from the losses read so far, so a reduction
    decided from one group's readback applies from the next group on;
    the lr vectors and the trajectory equal JAX's K=4 run's."""
    vectors = {}
    method = lambda o: o.SGD(learningrate=0.1, learningrate_schedule=o.Plateau(
        "loss", factor=0.5, patience=1, epsilon=10.0))
    topt, jopt, tl, jl = _run(k=4, iters=12, method=method)
    for name, opt in (("port", topt), ("jax", jopt)):
        m = opt.optim_method
        orig, vectors[name] = m.current_lr_vector, []
        m.current_lr_vector = lambda k, orig=orig, rec=vectors[name]: \
            rec.append(orig(k)) or rec[-1]
        opt.optimize()
    assert len(vectors["port"]) == 3
    np.testing.assert_allclose(np.array(vectors["port"]),
                               np.array(vectors["jax"]), rtol=1e-12)
    assert vectors["port"][0][-1] > vectors["port"][-1][0]
    assert_close(convert.to_numpy_tree(topt.model.params), jopt.model.params)


# -- the stager ----------------------------------------------------------------

def test_stager_keeps_order_and_raises_at_the_matching_next():
    class Exploding:
        def __iter__(self):
            yield from range(3)
            raise ValueError("decode failed")

    st = BatchStager(Exploding(), lambda v: v * 2, depth=2, device="cpu")
    got = []
    with pytest.raises(ValueError, match="decode failed"):
        for v in st:
            got.append(v)
    assert got == [0, 2, 4]
    st.close()
    assert stager_threads_alive() == 0


def test_stager_closes_mid_stream_and_the_serial_form_has_its_surface():
    st = staged(iter(range(100)), lambda v: v + 1, depth=3, device="cpu")
    assert next(st) == 1
    st.close()
    assert stager_threads_alive() == 0
    ser = staged(iter(range(3)), lambda v: v + 1, depth=1, device="cpu")
    assert list(ser) == [1, 2, 3]
    ser.close()
    grp = staged(iter(range(7)), lambda v: v, depth=2, group=3,
                 group_fn=list, device="cpu")
    assert list(grp) == [[0, 1, 2], [3, 4, 5], [6]]
    grp.close()
    assert stager_threads_alive() == 0


def test_no_stager_thread_outlives_an_optimize():
    """Normal exit, an end trigger mid-epoch, a raising step and a
    raising data set all join the stager thread."""
    before = {t.ident for t in threading.enumerate()}
    topt, _, _, _ = _run(prefetch=3, iters=4)      # ends mid-epoch
    topt.optimize()
    topt, _, _, _ = _run(prefetch=3, iters=12, nan_policy="error",
                         batches=vector_batches(12, poison=(2,)))
    with pytest.raises(FloatingPointError):
        topt.optimize()

    class Raising:
        def size(self):
            return 64

        def batches_per_epoch(self):
            return 8

        def shuffle(self):
            return self

        def data(self, train=True):
            from bigdl_tpu_torch.dataset import MiniBatch
            x, y = vector_batches(1)[0]
            yield MiniBatch(x, y)
            raise OSError("read failed")

    topt, _, _, _ = _run(prefetch=3, iters=12)
    topt.set_traindata(Raising())
    with pytest.raises(OSError, match="read failed"):
        topt.optimize()
    assert stager_threads_alive() == 0
    leaked = [t for t in threading.enumerate()
              if t.ident not in before and t.name.startswith("bigdl_tpu")]
    assert leaked == []


# -- the evaluator -------------------------------------------------------------

@pytest.mark.parametrize("prefetch,k", [(0, 1), (2, 4), (0, 3)],
                         ids=["serial", "prefetch-superstep4",
                              "serial-superstep3"])
def test_evaluator_prefetch_and_superstep_match_jax(prefetch, k):
    """The evaluator's stager and superstep against JAX's ``Evaluator``
    with the same options (100 rows in batches of 10: groups 4 + 4 + 2),
    and the integer counts exactly."""
    from bigdl_tpu.optim import Evaluator as JaxEvaluator
    from bigdl_tpu.optim.validation import Loss as JLoss, \
        Top1Accuracy as JTop1
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu.dataset import DataSet as JaxDataSet
    jm, tm, _ = twins(mlp)
    rng = np.random.RandomState(0)
    xs = rng.randn(100, 6).astype(np.float32)
    ys = rng.randint(1, 4, size=100).astype(np.float32)
    want = JaxEvaluator(jm, prefetch).set_superstep(k).evaluate(
        JaxDataSet.from_arrays(xs, ys), [JTop1(), JLoss()], 10)
    got = Evaluator(tm, prefetch).set_superstep(k).evaluate(
        DataSet.from_arrays(xs, ys), [Top1Accuracy(), Loss()], 10)
    assert (got[0].correct, got[0].count) == (want[0].correct,
                                              want[0].count)
    np.testing.assert_allclose(got[1].result()[0], want[1].result()[0],
                               rtol=1e-5)
    assert stager_threads_alive() == 0


def test_conv_net_options_match_jax():
    """The LeNet-sized conv net under prefetch 2, 'window:3' and K=2
    against JAX's loop under the same options."""
    batches = image_batches(6)
    topt, jopt, tl, jl = _run("window:3", 2, 2, iters=6, batches=batches,
                              build=conv_net)
    topt.optimize()
    jopt.optimize()
    assert_close(convert.to_numpy_tree(topt.model.params), jopt.model.params)
    np.testing.assert_allclose(topt.optim_method.state["loss"],
                               jopt.optim_method.state["loss"], rtol=1e-5)


def test_resume_schedule_of_the_card_smoke(tmp_path):
    """``chip_smoke.py`` phase 12 (d)'s schedule: 8 fixed batches, a NaN
    in batch 6, checkpoints every 4 iterations, 'resume', an end at 8.
    Both loops restore once to the iteration-4 checkpoint, finish the
    epoch, and end at neval 8 in epoch 2 with the same checkpoints."""
    import bigdl_tpu.optim as jo
    import bigdl_tpu_torch.optim as to
    topt, jopt, _, _ = _run(iters=8, batches=vector_batches(8, poison=(5,)),
                            fixed=True, nan_policy="resume")
    jopt.set_checkpoint(jo.several_iteration(4), str(tmp_path / "j"), False)
    topt.set_checkpoint(to.several_iteration(4), str(tmp_path / "t"), False)
    jopt.optimize()
    topt.optimize()
    for opt in (jopt, topt):
        st = opt.optim_method.state
        assert (st["neval"], st["epoch"]) == (8, 2)
        assert opt.metrics.values["nan_resumes"] == [1.0]
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == \
        sorted(p.name for p in (tmp_path / "j").iterdir()) == \
        ["checkpoint_e1_i4.bigdl", "checkpoint_e2_i8.bigdl"]
    assert_close(convert.to_numpy_tree(topt.model.params), jopt.model.params)
