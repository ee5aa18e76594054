"""Checkpoints of the port's training loop against the JAX package's
(``set_checkpoint``, ``load_checkpoint``, the writer thread, 'resume'),
``save_weights`` / ``load_weights`` and ``OptimMethod.save`` / ``load`` /
``clone``.

A checkpoint holds JAX's keys and tree names with numpy leaves in JAX's
layout, so a run moves between the packages: a checkpoint written by
either resumes in the other, and the two continued runs agree within 1e-5
(float32, the same formulas). On the port itself a resumed run ends bit
for bit where the uninterrupted run ends, and the writer thread writes the
bytes the synchronous write does.
"""
import os
import pickle

import numpy as np
import pytest
import torch

import bigdl_tpu.optim as jo
import bigdl_tpu_torch.optim as to
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.optim.optimizer import _AsyncCheckpointWriter
from bigdl_tpu_torch.parallel.elastic import find_latest_checkpoint
from tests.torch_loop_helpers import (assert_close, assert_equal, bn_net,
                                      data_pair, image_batches, jax_tree,
                                      optimizers, twins)

torch.set_num_threads(1)

CE = lambda pkg: pkg.CrossEntropyCriterion()
METHODS = {"sgd_momentum": lambda o: o.SGD(0.1, momentum=0.9),
           "adam": lambda o: o.Adam(0.01)}
BATCHES = image_batches(8)


def _pair(method, iters, batches=BATCHES, seed=0):
    jm, tm, _ = twins(bn_net, seed)
    return optimizers(jm, tm, data_pair(batches), CE, method,
                      lambda o: o.max_iteration(iters), 8,
                      set_prefetch=(0,))


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _shape(tree):
    """A tree's structure: nested keys, empty subtrees included."""
    return {k: _shape(v) if isinstance(v, dict) else None
            for k, v in tree.items()}


@pytest.mark.parametrize("name", sorted(METHODS))
def test_checkpoint_holds_jax_keys_names_layouts_and_values(name, tmp_path):
    jopt, topt = _pair(METHODS[name], 8)
    jopt.set_checkpoint(jo.several_iteration(4), str(tmp_path / "j"), False)
    topt.set_checkpoint(to.several_iteration(4), str(tmp_path / "t"), False)
    jopt.optimize()
    topt.optimize()
    files = sorted(os.listdir(tmp_path / "t"))
    assert files == sorted(os.listdir(tmp_path / "j")) == \
        ["checkpoint_e1_i4.bigdl", "checkpoint_e1_i8.bigdl"]
    for f in files:
        t, j = _load(tmp_path / "t" / f), _load(tmp_path / "j" / f)
        assert set(t) == set(j)
        assert (t["epoch"], t["neval"]) == (j["epoch"], j["neval"])
        assert set(t["optim_host_state"]) == set(j["optim_host_state"])
        for part in ("params", "opt_state", "model_state"):
            assert _shape(t[part]) == _shape(j[part]), part
            tl, jl = convert.flatten(t[part]), convert.flatten(j[part])
            for k in tl:
                assert isinstance(tl[k], np.ndarray), k
                assert tl[k].dtype == np.asarray(jl[k]).dtype, k
                assert tl[k].shape == np.shape(jl[k]), k
            assert_close(t[part], j[part], what=f"{f} {part}")


def _resume(opt, path, tail):
    opt.load_checkpoint(path)
    opt.set_traindata(tail)
    opt.optimize()
    return opt


@pytest.mark.parametrize("name", sorted(METHODS))
@pytest.mark.parametrize("async_write", [False, True],
                         ids=["sync_write", "async_write"])
def test_resume_ends_bit_for_bit_where_the_run_ends(name, async_write,
                                                     tmp_path):
    """8 iterations with checkpoints at 4 and 8; a fresh model and
    optimizer resume from the first and train the epoch's other 4 batches
    (the loop restarts its epoch on resume, as JAX's does): parameters,
    model state and the last checkpoint's optimizer state bit for bit the
    uninterrupted run's. The writer thread writes what the synchronous
    write does."""
    _, topt = _pair(METHODS[name], 8)
    topt.set_checkpoint(to.several_iteration(4), str(tmp_path / "a"), False,
                        async_write)
    topt.optimize()
    assert not [f for f in os.listdir(tmp_path / "a") if f.endswith(".tmp")]
    _, fresh = _pair(METHODS[name], 8, seed=1)
    fresh.set_checkpoint(to.several_iteration(4), str(tmp_path / "b"), False)
    _resume(fresh, tmp_path / "a" / "checkpoint_e1_i4.bigdl",
            data_pair(BATCHES[4:])[1])
    assert fresh.optim_method.state["neval"] == 8
    assert_equal(convert.to_numpy_tree(fresh.model.params),
                 convert.to_numpy_tree(topt.model.params))
    assert_equal(convert.to_numpy_tree(fresh.model.state),
                 convert.to_numpy_tree(topt.model.state))
    a = _load(tmp_path / "a" / "checkpoint_e1_i8.bigdl")
    b = _load(tmp_path / "b" / "checkpoint_e1_i8.bigdl")
    for part in ("params", "opt_state", "model_state"):
        assert_equal(a[part], b[part], part)
    if async_write:
        _, sync = _pair(METHODS[name], 8)
        sync.set_checkpoint(to.several_iteration(4), str(tmp_path / "s"),
                            False)
        sync.optimize()
        for f in os.listdir(tmp_path / "s"):
            s, w = _load(tmp_path / "s" / f), _load(tmp_path / "a" / f)
            for part in ("params", "opt_state", "model_state"):
                assert_equal(s[part], w[part], part)
            assert s["optim_host_state"] == w["optim_host_state"]


@pytest.mark.parametrize("name", sorted(METHODS))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_checkpoint_resumes_in_the_other_package(name, writer, tmp_path):
    """A checkpoint written at iteration 4 by one package's loop resumes
    in both; the two continued runs agree at 1e-5, and each reads back
    the other's state (neval, epoch, Adam's t)."""
    jopt, topt = _pair(METHODS[name], 8)
    first = jopt if writer == "jax" else topt
    mod = jo if writer == "jax" else to
    first.set_checkpoint(mod.several_iteration(4), str(tmp_path), False)
    first.optimize()
    path = tmp_path / "checkpoint_e1_i4.bigdl"
    tail = data_pair(BATCHES[4:])
    jopt2, topt2 = _pair(METHODS[name], 8, seed=1)
    _resume(jopt2, str(path), tail[0])
    _resume(topt2, str(path), tail[1])
    for opt in (jopt2, topt2):
        assert (opt.optim_method.state["neval"],
                opt.optim_method.state["epoch"]) == (8, 1)
    assert_close(convert.to_numpy_tree(topt2.model.params),
                 jopt2.model.params)
    assert_close(convert.to_numpy_tree(topt2.model.state), jopt2.model.state)
    assert_close(convert.to_numpy_tree(topt2.model.params),
                 convert.to_numpy_tree(topt.model.params) if writer == "port"
                 else jopt.model.params)
    np.testing.assert_allclose(topt2.optim_method.state["loss"],
                               jopt2.optim_method.state["loss"], rtol=1e-5)


def test_load_checkpoint_copies_into_the_live_tensors(tmp_path):
    """The model keeps its tensors: a checkpoint is copied into them, and
    'resume' restores into the tensors the step writes."""
    _, topt = _pair(METHODS["adam"], 4)
    topt.set_checkpoint(to.several_iteration(2), str(tmp_path))
    topt.optimize()
    _, fresh = _pair(METHODS["adam"], 4, seed=1)
    before = {k: id(v) for k, v in convert.flatten(fresh.model.params).items()}
    fresh.load_checkpoint(str(tmp_path / "checkpoint.bigdl"))
    assert {k: id(v) for k, v in
            convert.flatten(fresh.model.params).items()} == before
    assert_equal(convert.to_numpy_tree(fresh.model.params),
                 convert.to_numpy_tree(topt.model.params))
    assert int(fresh._resume_opt_state["t"]) == 4
    fresh.set_model(fresh.model)
    assert fresh._resume_opt_state is None
    assert fresh.optim_method.state == {"neval": 0, "epoch": 1}


def test_async_writer_orders_writes_and_raises_at_flush(tmp_path):
    w = _AsyncCheckpointWriter()
    for i in range(5):
        w.submit(str(tmp_path / "c.bigdl"), {"i": i})
    w.flush()
    assert _load(tmp_path / "c.bigdl") == {"i": 4}
    w.submit(str(tmp_path / "no" / "such" / "dir" / "x.bigdl"), {"a": 1})
    with pytest.raises(RuntimeError, match="async checkpoint"):
        w.flush()
    w.close()
    assert w._thread is None
    assert os.listdir(tmp_path) == ["c.bigdl"]


def test_find_latest_checkpoint_matches_jax(tmp_path):
    from bigdl_tpu.parallel.elastic import find_latest_checkpoint as jfind
    assert find_latest_checkpoint(str(tmp_path)) is None
    assert find_latest_checkpoint(None) is None
    for i, name in enumerate(["checkpoint_e1_i2.bigdl", "other.bigdl",
                              "checkpoint_e1_i4.bigdl", "checkpoint.tmp"]):
        (tmp_path / name).write_bytes(b"x")
        os.utime(tmp_path / name, (100 + i, 100 + i))
    assert find_latest_checkpoint(str(tmp_path)) == \
        jfind(str(tmp_path)) == str(tmp_path / "checkpoint_e1_i4.bigdl")


def test_save_weights_and_load_weights_cross_the_packages(tmp_path):
    """``save_weights`` files under JAX's "/"-joined names load in the
    other package, both ways; ``get_weights`` / ``set_weights`` carry the
    same tree."""
    jm, tm, w = twins(bn_net)
    tm.save_weights(str(tmp_path / "port"))
    assert sorted(np.load(tmp_path / "port.npz").files) == \
        ["0/weight", "1/bias", "1/weight", "4/bias", "4/weight"]
    jm2, _, _ = twins(bn_net, seed=1)
    jm2.load_weights(str(tmp_path / "port.npz"))
    assert_equal(jax_tree(jm2.params), w)
    jm.save_weights(str(tmp_path / "jax.npz"))
    _, tm2, _ = twins(bn_net, seed=1)
    tm2.load_weights(str(tmp_path / "jax"))
    assert_equal(convert.to_numpy_tree(tm2.params), w)
    _, tm3, _ = twins(bn_net, seed=2)
    got = tm3.set_weights(jax_tree(jm.get_weights())).get_weights()
    assert_equal(got, w)
    got["0"]["weight"][...] = 0          # a copy, not the parameter
    assert float(tm3.params["0"]["weight"].detach().abs().sum()) > 0


def test_optim_method_save_load_clone(tmp_path):
    m = to.SGD(0.1, momentum=0.9, learningrate_schedule=to.Plateau("loss"))
    m.state.update(neval=7, epoch=2, loss=0.5)
    m.learningrate_schedule.update_lr(0.1, m.state)
    m.save(str(tmp_path / "sgd.bin"))
    with pytest.raises(IOError):
        m.save(str(tmp_path / "sgd.bin"), overwrite=False)
    back = to.OptimMethod.load(str(tmp_path / "sgd.bin"))
    assert type(back) is to.SGD and back.state == m.state
    assert back.momentum == 0.9 and back.learningrate_schedule.best == 0.5
    c = m.clone()
    c.state["neval"] = 0
    assert m.state["neval"] == 7
    (tmp_path / "bad.bin").write_bytes(pickle.dumps({"not": "a method"}))
    with pytest.raises(TypeError):
        to.OptimMethod.load(str(tmp_path / "bad.bin"))
