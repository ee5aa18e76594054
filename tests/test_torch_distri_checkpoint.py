"""ZeRO-1 checkpoints across the packages and across world sizes: JAX's
``DistriOptimizer`` at 4 devices writes a ZeRO-1 checkpoint (Adam: its
vector state ``m`` / ``v`` and its scalar ``t``, in the canonical
params-shaped form); the port resumes it at 2 gloo ranks, writes its
own, resumes that at 1 rank, and ends where JAX's own chain of the same
resumes ends (1e-4, JAX's tolerance for parameters after several steps;
a resumed run restarts its epoch's data in both packages, so the chains
resume the same way). JAX also resumes the port's 2-rank checkpoint.
Each world has the helpers' deadline."""
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.optim as jo
from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import DataSet as JDataSet, Sample as JSample
from bigdl_tpu.parallel import data_parallel_mesh
from bigdl_tpu_torch import convert, nn as tnn
from torch_dist_helpers import (build, criterion, method, resume_zero1,
                                run_world)

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)


def _case():
    rng = np.random.RandomState(9)
    x = rng.randn(64, 6).astype(np.float32)
    y = rng.randint(1, 4, 64).astype(np.float32)
    return dict(model="mlp", data=("samples", x, y), crit="ce",
                method="adam", batch=16,
                weights=convert.host_copy_tree(build("mlp", tnn).params))


def _jax_run(case, iters, out_dir, every, ckpt=None, n=4):
    jm = build("mlp", jnn)
    jm.ensure_initialized()
    jm.params = jax.tree_util.tree_map(jnp.array, case["weights"])
    _, x, y = case["data"]
    opt = jo.DistriOptimizer(
        jm, JDataSet.array([JSample(a, b) for a, b in zip(x, y)]),
        criterion("ce", jnn), method("adam", jo), jo.max_iteration(iters),
        batch_size=16, mesh=data_parallel_mesh(n), parameter_mode="zero1")
    if ckpt is not None:
        opt.load_checkpoint(ckpt)
    opt.set_checkpoint(jo.several_iteration(every), out_dir)
    opt.optimize()
    return jax.tree_util.tree_map(np.asarray, jm.params), \
        os.path.join(out_dir, "checkpoint.bigdl")


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def close(got, want, what=""):
    g, w = convert.flatten(got), convert.flatten(want)
    assert set(g) == set(w), (what, sorted(g), sorted(w))
    for k in g:
        np.testing.assert_allclose(np.asarray(g[k], np.float64),
                                   np.asarray(w[k], np.float64),
                                   err_msg=f"{what} {k}", **TOL)


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero1_ckpt")
    d = {k: str(tmp / k) for k in ("a", "jb", "jc", "pb", "pc", "x")}
    case = _case()
    # JAX at 4 devices: 4 steps = one epoch
    _, ck_a = _jax_run(case, 4, d["a"], 4)
    # JAX's own chain: resume at 4 devices to 6, then to 8
    _, ck_jb = _jax_run(case, 6, d["jb"], 2, ckpt=ck_a)
    jax_final, _ = _jax_run(case, 8, d["jc"], 2, ckpt=ck_jb)
    # the port: JAX's checkpoint at 2 ranks to 6, its own at 1 rank to 8
    pb_params, pb_payload = run_world(resume_zero1, 2, case, ck_a, 6,
                                      d["pb"], 2)[0]
    ck_pb = os.path.join(d["pb"], "checkpoint.bigdl")
    pc_params, _ = run_world(resume_zero1, 1, case, ck_pb, 8, d["pc"],
                             2)[0]
    # JAX resumes the port's 2-rank checkpoint
    x_final, _ = _jax_run(case, 8, d["x"], 2, ckpt=ck_pb)
    return dict(jb=_load(ck_jb), jax_final=jax_final, pb=pb_payload,
                pb_params=pb_params, pc_params=pc_params, x_final=x_final,
                a=_load(ck_a))


def test_jax_checkpoint_is_canonical(chains):
    st = chains["a"]["opt_state"]
    params = chains["a"]["params"]
    assert set(st) == {"m", "v", "t"}
    for k in ("m", "v"):
        assert jax.tree_util.tree_structure(st[k]) == \
            jax.tree_util.tree_structure(params)
    assert int(np.asarray(st["t"])) == 4


def test_port_two_ranks_resumes_jax_and_writes_the_same_checkpoint(chains):
    pb, jb = chains["pb"], chains["jb"]
    assert set(pb) == set(jb)
    assert (pb["epoch"], pb["neval"]) == (jb["epoch"], jb["neval"])
    assert pb["neval"] == 6
    close(pb["params"], jb["params"], "params")
    close(pb["model_state"], jb["model_state"], "model_state")
    assert int(np.asarray(pb["opt_state"]["t"])) == 6
    close({k: pb["opt_state"][k] for k in ("m", "v")},
          {k: jb["opt_state"][k] for k in ("m", "v")}, "opt_state")


def test_port_one_rank_resumes_the_two_rank_checkpoint(chains):
    close(chains["pc_params"], chains["jax_final"], "final params")


def test_jax_resumes_the_port_checkpoint(chains):
    close(chains["x_final"], chains["jax_final"], "jax from port")
