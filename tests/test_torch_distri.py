"""``DistriOptimizer`` of the port on 4 gloo ranks against JAX's on a
4-device mesh, from the same weights on the same data: JAX's ``_train``
setup (LeNet-5 on the MNIST stand-in, batch 64, SGD 0.05, 8 iterations,
``test_distributed.py``) in every parameter mode and gradient wire plus
Adam in ZeRO-1; a BatchNorm model in ``replicated`` (global statistics:
equal to a local run over the global batch) and in ``zero1`` (per-shard
statistics); a padded ``TimeDistributedMaskCriterion`` whose ranks hold
unequal counts; the Parallax sparse-embedding wire, its ``"auto"``
selection, its contract and refusals; supersteps; clipping and frozen
leaves in ZeRO-1; the NaN guard ('skip') and 'resume'; the uneven-split
refusal; the ``Optimizer`` factory; ``ShardedDataSet``;
``DistriValidator`` and the summaries.

Tolerances: 1e-5 for one step's worth of arithmetic; 1e-4 (JAX's own in
``test_distri_matches_local``) for parameters after several steps, whose
all-reduces sum in another order than XLA's; bf16 for ``compress``
(the reduce-scatter sums in bf16, in gloo's order on one side and XLA's
on the other). One world for every training case (~10 s), one for the
refusal; each has the helpers' deadline."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.optim as jo
from bigdl_tpu import nn as jnn
from bigdl_tpu import observability as jobs
from bigdl_tpu.dataset import DataSet as JDataSet, Sample as JSample, mnist
from bigdl_tpu.dataset.minibatch import MiniBatch as JMiniBatch
from bigdl_tpu.models import LeNet5 as JLeNet5
from bigdl_tpu.parallel import data_parallel_mesh
from bigdl_tpu_torch import convert, nn as tnn
from bigdl_tpu_torch.models import LeNet5
from torch_dist_helpers import (build, criterion, distri_cases, method,
                                run_world, setup, uneven_split)

torch.set_num_threads(1)
N = 4
STEP = dict(atol=1e-5, rtol=1e-5)
STEPS = dict(atol=1e-4, rtol=1e-4)      # JAX's own, test_distributed.py:49


def _weights(model):
    return convert.host_copy_tree(model.params)


def _lenet_case(name, mode, meth="sgd", **kw):
    return dict(name=name, model="lenet", data=LENET_DATA, crit="nll",
                method=meth, iters=8, batch=64, mode=mode, kw=kw,
                weights=LENET_W, val=LENET_VAL)


def _vector_batches(n, b=8, poison=()):
    rng = np.random.RandomState(5)
    xs, ys = [], []
    for i in range(n):
        x = rng.randn(b, 6).astype(np.float32)
        if i in poison:
            x[3, 0] = np.nan
        xs.append(x)
        ys.append(rng.randint(1, 4, b).astype(np.float32))
    return ("fixed", xs, ys)


def _image_batches(n, b=8):
    rng = np.random.RandomState(1)
    return ("fixed", [rng.randn(b, 6, 6, 3).astype(np.float32)
                      for _ in range(n)],
            [rng.randint(1, 4, b).astype(np.float32) for _ in range(n)])


def _float_target_batches(n, probs, b=8):
    """x (b, 6) with float targets (b, 3): rows of probabilities or
    regression targets."""
    rng = np.random.RandomState(6)
    xs, ys = [], []
    for _ in range(n):
        xs.append(rng.randn(b, 6).astype(np.float32))
        y = rng.randn(b, 3).astype(np.float32)
        if probs:
            y = np.exp(y) / np.exp(y).sum(1, keepdims=True)
        ys.append(y.astype(np.float32))
    return ("fixed", xs, ys)


def _masked_batches():
    """Ids (8, 6) with padded targets: the ranks' rows (2 each) hold
    12, 7, 3 and 10 counted positions."""
    rng = np.random.RandomState(2)
    xs, ys = [], []
    for i in range(3):
        x = rng.randint(1, 21, (8, 6)).astype(np.float32)
        y = rng.randint(1, 6, (8, 6)).astype(np.float32)
        for r, keep in enumerate((12, 7, 3, 10)):
            blk = y[2 * r:2 * r + 2].reshape(-1)
            blk[keep:] = 0
            y[2 * r:2 * r + 2] = blk.reshape(2, 6)
        xs.append(x)
        ys.append(y)
    return ("fixed", xs, ys)


def _sparse_data():
    rng = np.random.RandomState(3)
    x = rng.randint(1, 513, size=(256, 4)).astype(np.float32)
    y = (rng.randint(0, 5, size=(256,)) + 1).astype(np.float32)
    return ("samples", x, y)


def _nan_resume_data():
    """JAX's ``test_zero1_nan_resume_and_checkpoint_layout`` data: a NaN
    in the last batch of epoch 1."""
    xs = np.random.RandomState(0).randn(32, 6).astype(np.float32)
    probe = JDataSet.array(list(range(32)))
    probe.shuffle()
    xs[list(probe.data(train=True))[-1]] = np.nan
    return ("samples", xs,
            np.array([i % 3 + 1 for i in range(32)], np.float32))


_imgs, _labels = mnist.load(n_synthetic=320)
_samples = mnist.to_samples(_imgs, _labels)
_feats = np.stack([s.feature() for s in _samples]).astype(np.float32)
_labs = np.stack([np.float32(s.label()) for s in _samples])
LENET_DATA = ("samples", _feats[:256], _labs[:256])
LENET_VAL = (_feats[256:], _labs[256:])      # 64 rows: batches 32, 32
LENET_W = _weights(LeNet5(10, device="cpu"))


def _cases(tmp):
    mlp_w = _weights(build("mlp", tnn))
    lin_w = _weights(build("linear", tnn))
    bn_w = _weights(build("bn_net", tnn))
    m_w = _weights(build("masked", tnn))
    s_w = _weights(build("sparse", tnn))
    lsm_w = _weights(build("mlp_lsm", tnn))
    drop_w = _weights(build("mlp_drop", tnn))
    vb = _vector_batches(8)
    ib = _image_batches(4)
    mb = _masked_batches()
    sd = _sparse_data()
    cases = [
        _lenet_case("L_local", "local"),
        _lenet_case("L_rep", "replicated"),
        _lenet_case("L_z1", "zero1"),
        _lenet_case("L_z1c", "zero1", compress="bf16"),
        _lenet_case("L_z1w", "zero1", wire_dtype="bf16"),
        _lenet_case("L_adam", "zero1", meth="adam"),
    ]
    for mode in ("local", "replicated", "zero1"):
        cases.append(dict(name=f"BN_{mode}", model="bn_net", data=ib,
                          crit="ce", method="sgd1", iters=4, batch=8,
                          mode=mode, weights=bn_w))
    for mode in ("local", "replicated"):
        cases.append(dict(name=f"M_{mode}", model="masked", data=mb,
                          crit="masked", method="sgd1", iters=3, batch=8,
                          mode=mode, weights=m_w,
                          kw={} if mode == "local" else
                          {"sparse_embedding": False}))
    # the other reduction families in replicated mode: each rank's loss
    # is scaled so that the mean over the ranks is the global batch's
    for mode in ("local", "replicated"):
        cases.append(dict(name=f"MCE_{mode}", model="masked", data=mb,
                          crit="masked_ce", method="sgd1", iters=3, batch=8,
                          mode=mode, weights=m_w,
                          kw={} if mode == "local" else
                          {"sparse_embedding": False}))
        cases.append(dict(name=f"SUM_{mode}", model="linear",
                          data=_float_target_batches(3, False),
                          crit="smoothl1w", method="sgd1", iters=3, batch=8,
                          mode=mode, weights=lin_w))
        cases.append(dict(name=f"KLS_{mode}", model="mlp_lsm",
                          data=_float_target_batches(3, True),
                          crit="distkl_sum", method="sgd1", iters=3,
                          batch=8, mode=mode, weights=lsm_w))
        # dropout: the same masks as a local run over the global batch
        cases.append(dict(name=f"D_{mode}", model="mlp_drop", data=vb,
                          crit="ce", method="sgd1", iters=4, batch=8,
                          mode=mode, weights=drop_w))
    for sparse in (True, False):
        cases.append(dict(name=f"S_{sparse}", model="sparse", data=sd,
                          crit="nll", method="sgd", iters=6, batch=64,
                          mode="replicated", weights=s_w,
                          kw={"sparse_embedding": sparse}, observe=sparse))
    for mode in ("replicated", "zero1"):
        for k in (1, 2):
            cases.append(dict(name=f"SS_{mode}_{k}", model="mlp", data=vb,
                              crit="ce", method="sgdm", iters=7, batch=8,
                              mode=mode, weights=mlp_w,
                              setup=[("set_superstep", (k,))]))
    cases.append(dict(name="CF_z1", model="mlp", data=vb, crit="ce",
                      method="sgdm", iters=4, batch=8, mode="zero1",
                      weights=mlp_w, freeze=0,
                      setup=[("set_gradclip_l2norm", (0.5,))]))
    cases.append(dict(name="N_skip", model="mlp",
                      data=_vector_batches(4, poison=(1,)), crit="ce",
                      method="sgd1", iters=4, batch=8, mode="replicated",
                      weights=mlp_w, setup=[("set_nan_policy", ("skip",))]))
    ck = os.path.join(tmp, "port_ckpt")
    cases.append(dict(name="N_resume", model="linear",
                      data=_nan_resume_data(), crit="ce", method="sgd1",
                      iters=4, batch=8, mode="zero1", weights=lin_w,
                      ckpt=ck, setup=[("set_checkpoint", (ck,)),
                                      ("set_nan_policy", ("resume",))]))
    return cases


def jax_train(case, tmp):
    """JAX's half of a case on ``data_parallel_mesh(4)`` (or its local
    optimizer): the trained (params, state) as numpy trees."""
    if case["model"] == "lenet":
        jm = JLeNet5(10)
    else:
        jm = build(case["model"], jnn)
    jm.ensure_initialized()
    jm.params = jax.tree_util.tree_map(jnp.array, case["weights"])
    if case.get("freeze") is not None:
        jm.modules[case["freeze"]].freeze()
    kind, a, b = case["data"]
    if kind == "fixed":
        from torch_loop_helpers import FixedBatches
        data = FixedBatches(list(zip(a, b)), JMiniBatch)
    else:
        data = JDataSet.array([JSample(f, l) for f, l in zip(a, b)])
    args = (jm, data, criterion(case["crit"], jnn),
            method(case["method"], jo), jo.max_iteration(case["iters"]))
    if case["mode"] == "local":
        opt = jo.LocalOptimizer(*args, batch_size=case["batch"])
    else:
        opt = jo.DistriOptimizer(*args, batch_size=case["batch"],
                                 mesh=data_parallel_mesh(N),
                                 parameter_mode=case["mode"],
                                 **case.get("kw", {}))
    c = dict(case)
    if case.get("ckpt"):
        c["setup"] = [(n, (os.path.join(tmp, "jax_ckpt"),) if
                       n == "set_checkpoint" else a)
                      for n, a in case["setup"]]
    setup(opt, c, jo)
    opt.optimize()
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return tree(jm.params), tree(jm.state)


def close(got, want, tol, what=""):
    g, w = convert.flatten(got), convert.flatten(want)
    assert set(g) == set(w), (what, sorted(g), sorted(w))
    for k in g:
        np.testing.assert_allclose(np.asarray(g[k], np.float64),
                                   np.asarray(w[k], np.float64),
                                   err_msg=f"{what} {k}", **tol)


def differ(a, b, by):
    return max(np.abs(np.asarray(x) - np.asarray(y)).max() for x, y in
               zip(convert.flatten(a).values(),
                   convert.flatten(b).values())) > by


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("distri"))
    cases = _cases(tmp)
    out = run_world(distri_cases, N, cases, tmp)[0]
    return out, {c["name"]: c for c in cases}, tmp


@pytest.fixture(scope="module")
def jax_runs(world):
    _, cases, tmp = world
    return _Lazy(lambda name: jax_train(cases[name], tmp))


class _Lazy(dict):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def __missing__(self, key):
        self[key] = v = self.fn(key)
        return v


@pytest.mark.parametrize("name", ["L_rep", "L_z1", "L_adam"])
def test_lenet_train_setup_matches_jax(world, jax_runs, name):
    out, _, _ = world
    # Adam divides by sqrt(v): where a gradient is within rounding of 0
    # the summation order moves its normalised step (~lr = 0.01) by a few
    # percent, so Adam's leaves are held to 5e-4
    tol = dict(atol=5e-4, rtol=1e-4) if name == "L_adam" else STEPS
    close(out[name]["params"], jax_runs[name][0], tol, name)


def test_replicated_and_zero1_equal_local_on_lenet(world):
    out, _, _ = world
    for name in ("L_rep", "L_z1"):
        close(out[name]["params"], out["L_local"]["params"], STEPS, name)


def test_zero1_gradient_wires_match_jax(world, jax_runs):
    out, _, _ = world
    # wire_dtype: rounded once, float32 sums: as close as the f32 wire
    close(out["L_z1w"]["params"], jax_runs["L_z1w"][0], STEPS, "wire")
    # compress: bf16 sums of 4 shards in two orders, over 8 steps
    close(out["L_z1c"]["params"], jax_runs["L_z1c"][0],
          dict(atol=2e-3, rtol=0), "compress")
    assert differ(out["L_z1w"]["params"], out["L_z1"]["params"], 0)


def test_batchnorm_replicated_takes_global_statistics(world, jax_runs):
    out, _, _ = world
    jp, js = jax_runs["BN_replicated"]
    close(out["BN_replicated"]["params"], jp, STEP, "params")
    close(out["BN_replicated"]["state"], js, STEP, "state")
    close(out["BN_replicated"]["params"], out["BN_local"]["params"], STEP)
    close(out["BN_replicated"]["state"], out["BN_local"]["state"], STEP)
    # the test has power: per-shard statistics give other numbers
    zp, zs = jax_runs["BN_zero1"]
    assert differ(zs, js, 1e-3)


def test_batchnorm_zero1_takes_per_shard_statistics(world, jax_runs):
    out, _, _ = world
    zp, zs = jax_runs["BN_zero1"]
    close(out["BN_zero1"]["params"], zp, STEP, "params")
    close(out["BN_zero1"]["state"], zs, STEP, "state")


def test_masked_criterion_divides_by_the_global_count(world, jax_runs):
    out, _, _ = world
    close(out["M_replicated"]["params"], jax_runs["M_replicated"][0], STEP)
    close(out["M_replicated"]["params"], out["M_local"]["params"], STEP)


@pytest.mark.parametrize("family", ["MCE", "SUM", "KLS"])
def test_replicated_sum_and_row_criteria_match_jax(world, jax_runs, family):
    """A criterion applied row by row under the mask, a plain batch sum
    (``SmoothL1CriterionWithWeights``, divided by ``num``) and a
    ``size_average=False`` sum (``DistKLDivCriterion``): replicated on 4
    ranks equals JAX's replicated step and a local run over the global
    batch (a sum left unscaled would give a quarter of the gradient)."""
    out, _, _ = world
    rep = out[f"{family}_replicated"]["params"]
    close(rep, jax_runs[f"{family}_replicated"][0], STEP, family)
    close(rep, out[f"{family}_local"]["params"], STEP, family)


def test_replicated_dropout_draws_the_global_batch_masks(world):
    """Replicated dropout draws the global batch's mask on every rank and
    applies this rank's rows of it: the run equals a local run over the
    global batch (the port's draws; JAX's bits differ), so no two ranks'
    rows share a mask."""
    out, _, _ = world
    close(out["D_replicated"]["params"], out["D_local"]["params"], STEP,
          "dropout")


def test_sparse_embedding_wire(world, jax_runs):
    out, _, _ = world
    assert out["S_True"]["selected"] is True
    assert out["S_False"]["selected"] is False
    # the sparse step is local, as JAX's shard_map body; the mean
    # criterion over equal shards makes both wires train the same
    close(out["S_True"]["params"], jax_runs["S_True"][0], STEPS)
    close(out["S_True"]["params"], out["S_False"]["params"], STEPS)
    c = out["S_True"]["counters"]
    b_local, T, H, V = 64 // N, 4, 16, 512
    # per step the embedding ships B_local*T*(H+1) elements, not V*H
    assert c["collective/sparse_grad_wire_traced_bytes"] == \
        6 * b_local * T * (H + 1) * 4
    assert c["collective/sparse_grad_wire_traced_bytes"] / 6 < \
        V * H * 4 / 5
    assert c["collective/sparse_layers_selected"] == 1
    assert c["collective/grad_dense_traced_bytes"] / 6 < V * H * 4


def test_sparse_embedding_selection_and_refusals(world):
    out, _, _ = world
    assert "per-LAYER" in out["refuse_zero1_sparse"]
    assert "LookupTable" in out["refuse_no_embedding"]
    assert "regulariz" in out["refuse_regularized"]
    # auto: a clean leading LookupTable, off, LeNet, regularized, zero1
    assert out["auto"] == [True, False, False, False, False]


@pytest.mark.parametrize("mode", ["replicated", "zero1"])
def test_supersteps_equal_single_steps(world, mode):
    out, _, _ = world
    a, b = out[f"SS_{mode}_1"], out[f"SS_{mode}_2"]
    for k, v in convert.flatten(a["params"]).items():
        np.testing.assert_array_equal(v, convert.flatten(b["params"])[k])


def test_zero1_clipping_and_frozen_leaves_match_jax(world, jax_runs):
    out, cases, _ = world
    close(out["CF_z1"]["params"], jax_runs["CF_z1"][0], STEP)
    # the frozen layer kept its weights
    close(out["CF_z1"]["params"]["0"], cases["CF_z1"]["weights"]["0"],
          dict(atol=0, rtol=0))


def test_nan_guard_skips_on_every_rank(world, jax_runs):
    out, _, _ = world
    p = out["N_skip"]["params"]
    assert all(np.isfinite(v).all() for v in convert.flatten(p).values())
    assert out["N_skip"]["metrics"]["nan_skips"] == 1
    close(p, jax_runs["N_skip"][0], STEP)


def test_zero1_nan_resume_and_checkpoint_layout(world, jax_runs):
    out, _, _ = world
    r = out["N_resume"]
    assert r["metrics"]["nan_resumes"] >= 1
    assert r["params"]["0"]["weight"].shape == (3, 6)
    close(r["params"], jax_runs["N_resume"][0], STEP)
    assert r["ckpt"] == ["checkpoint.bigdl"]


def test_uneven_splits_are_refused_within_the_deadline():
    msgs = run_world(uneven_split, 2, [24, 16], timeout_s=60)
    for m in msgs:
        assert m is not None and "disagree on batches/epoch [3, 2]" in m


def test_optimizer_factory(world):
    out, cases, _ = world
    assert out["factory"] == ["DistriOptimizer"] * 3
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import LocalOptimizer, Optimizer
    opt = Optimizer(LeNet5(10, device="cpu"), DataSet.array([]),
                    tnn.ClassNLLCriterion(), device="cpu")
    assert type(opt) is LocalOptimizer


def test_sharded_dataset_divides_over_shards():
    from bigdl_tpu_torch.dataset import DataSet, ShardedDataSet
    ds = DataSet.array(list(range(40)))
    assert ShardedDataSet(ds, 32, num_shards=4).num_shards == 4
    with pytest.raises(ValueError, match="divide over 4"):
        ShardedDataSet(ds, 30, num_shards=4)


def test_distri_validator_and_summaries(world):
    out, _, _ = world
    dv, ev = out["validator"]
    for a, b in zip(dv, ev):
        np.testing.assert_allclose(a, b, **STEP)
    jm = JLeNet5(10)
    jm.ensure_initialized()
    jm.params = jax.tree_util.tree_map(jnp.array, LENET_W)
    feats, labs = LENET_VAL
    jres = jm.evaluate_dataset(
        JDataSet.array([JSample(f, l) for f, l in zip(feats, labs)]),
        [jo.Top1Accuracy(), jo.Loss(jnn.ClassNLLCriterion())], 32)
    for a, r in zip(dv, jres):
        np.testing.assert_allclose(a, r.result(), **STEP)
    losses, accs = out["summaries"]
    assert [s for s, _ in losses] == [1, 2, 3, 4, 5, 6]
    # the trigger is asked after every step and again at the epoch's end
    # (4 batches), as in JAX's loop
    assert [s for s, _ in accs] == [2, 4, 4, 6]
