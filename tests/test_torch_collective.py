"""The port's collectives, meshes, data-parallel placements and ZeRO-1
wires on 4 gloo ranks against JAX's on a 4-device mesh
(``bigdl_tpu/parallel``): every collective of ``parallel.collective``
under ``shard_map`` on the same per-device inputs, the gradients the port
carries through them against JAX's gradient of the same global function,
the mesh factories, ``shard_batch`` / ``gather_to_host`` and friends, the
Parallax sparse exchange, ``FlatParameter``'s order and pads, and
``AllReduceParameter``'s three gradient wires. One gloo world (every
case of it) for the file; tolerances: 1e-5 for the collectives (float32
sums in another order), one ulp for the ``wire_dtype`` update (rounded
once, summed in rank order in float32 as ``jnp.sum(axis=0)`` sums), bf16
rounding for ``compress="bf16"``, which sums in bf16 on both sides in
different orders."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree
from jax.sharding import PartitionSpec as P

from bigdl_tpu.optim import SGD as JaxSGD
from bigdl_tpu.parallel import collective as JC
from bigdl_tpu.parallel import data_parallel_mesh
from bigdl_tpu.parallel.allreduce import (
    AllReduceParameter as JaxARP, FlatParameter as JaxFlat,
    sparse_embedding_grad_allreduce as jax_sparse)
from bigdl_tpu.utils.compat import shard_map
from torch_dist_helpers import collectives, run_world

torch.set_num_threads(1)
N = 4
TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs():
    rng = np.random.RandomState(0)
    xs = rng.randn(N, 8, 4).astype(np.float32)
    ids = rng.randint(0, 50, size=(N * 16,)).astype(np.int32)
    ids[:8] = ids[8]                      # duplicates across ranks
    rows = rng.randn(N * 16, 8).astype(np.float32)
    tree = {"2": {"w": rng.randn(37, 5).astype(np.float32)},
            "10": {"w": rng.randn(3, 2).astype(np.float32)},
            "b": rng.randn(10).astype(np.float32)}
    size = sum(v.size for v in jax.tree_util.tree_leaves(tree))
    padded = size + (-size) % N
    grads = rng.randn(N, padded).astype(np.float32)
    return xs, ids, rows, tree, grads


@pytest.fixture(scope="module")
def world():
    xs, ids, rows, tree, grads = _inputs()
    out = run_world(collectives, N, xs, ids, rows, 50, tree, grads, None)
    return out, (xs, ids, rows, tree, grads)


def _jax_per_device(fn, xs):
    mesh = data_parallel_mesh(N)
    f = shard_map(lambda x: fn(x[0])[None], mesh=mesh, in_specs=P("data"),
                  out_specs=P("data"), check_vma=False)
    return np.asarray(jax.jit(f)(jnp.asarray(xs)))


CASES = {
    "psum": lambda x: JC.psum(x, "data"),
    "pmean": lambda x: JC.pmean(x, "data"),
    "gather": lambda x: JC.all_gather(x, "data"),
    "gather_stacked": lambda x: JC.all_gather(x, "data", tiled=False),
    "scatter0": lambda x: JC.reduce_scatter(x, "data"),
    "scatter1": lambda x: JC.reduce_scatter(x, "data", 1),
    "ring1": lambda x: JC.ppermute_ring(x, "data", 1),
    "ring3": lambda x: JC.ppermute_ring(x, "data", 3),
    "a2a": lambda x: JC.all_to_all(x, "data", 0, 1),
    "a2a_t": lambda x: JC.all_to_all(x, "data", 1, 0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_collective_matches_jax_under_shard_map(world, name):
    out, (xs, *_) = world
    want = _jax_per_device(CASES[name], xs)
    for r in range(N):
        np.testing.assert_allclose(out[r][name], want[r], err_msg=name,
                                   **TOL)


def test_tree_collectives_and_gradients(world):
    out, (xs, *_) = world
    for r in range(N):
        np.testing.assert_allclose(out[r]["tree"]["a"], xs.mean(0), **TOL)
        np.testing.assert_allclose(out[r]["tree"]["b"], 2 * xs.mean(0),
                                   **TOL)
    # the port's gradient on rank r is the gradient of the sum over the
    # ranks' losses with respect to rank r's input: JAX's gradient of the
    # same global function
    w = jnp.arange(xs[0].size * N, dtype=jnp.float32)

    def total(X):
        g = X.reshape(-1, X.shape[-1])            # all_gather, tiled
        s = X.sum(0)                              # psum
        k = X.shape[1] // N
        per = [jnp.sum(g.reshape(-1) * w) + jnp.sum(s * X[r])
               + jnp.sum(s[r * k:(r + 1) * k]) * (r + 1) for r in range(N)]
        return sum(per)

    want = np.asarray(jax.grad(total)(jnp.asarray(xs)))
    for r in range(N):
        np.testing.assert_allclose(out[r]["grad"], want[r], **TOL)


def test_mesh_factories(world):
    out, _ = world
    for r in range(N):
        names, nd, nm, model_group = out[r]["mesh2"]
        assert names == ("data", "model") and (nd, nm) == (2, 2)
        # ranks laid out row-major, as make_mesh reshapes JAX's devices
        assert model_group == [2 * (r // 2), 2 * (r // 2) + 1]
        assert out[r]["hybrid"] == ((1, 4), ("data", "model"))
        assert out[r]["too_many"] == "mesh needs 8 devices, have 4"
        assert out[r]["engine_mesh"] == (True, ("data", "seq"), 4)
    jm = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                           ("data", "model"))
    assert dict(jm.shape) == {"data": 2, "model": 2}


def test_data_parallel_placements(world):
    out, _ = world
    batch = np.arange(24, dtype=np.float32).reshape(8, 3)
    stack = np.stack([batch, batch + 100])
    # JAX's P('data') gives device r rows [2r, 2r + 2)
    mesh = data_parallel_mesh(N)
    placed = jax.device_put(batch, jax.sharding.NamedSharding(mesh,
                                                              P("data")))
    shards = {s.device.id: np.asarray(s.data)
              for s in placed.addressable_shards}
    for r in range(N):
        o = out[r]
        np.testing.assert_array_equal(o["shard_batch"], shards[r])
        np.testing.assert_array_equal(o["put"], shards[r])
        np.testing.assert_array_equal(o["put_rep"], batch)
        np.testing.assert_array_equal(o["stacked"],
                                      stack[:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(o["gathered"]["v"], batch)
        assert float(o["gathered"]["t"]) == 3.0
        assert o["multi"] is True
        assert o["survivors"] == [0, 1, 2]
        # the broken row [2, 3] is dropped, the model groups stay whole
        assert o["after_loss"] == [[0, 1]]
        assert o["after_loss_1d"] == [0, 3]


def test_sparse_exchange_matches_jax(world):
    out, (_, ids, rows, _, _) = world
    mesh = data_parallel_mesh(N)
    f = shard_map(lambda i, r: jax_sparse(i, r, vocab_size=50,
                                          axis="data"),
                  mesh=mesh, in_specs=(P("data"), P("data", None)),
                  out_specs=P(), check_vma=False)
    want = np.asarray(jax.jit(f)(ids, rows))
    dense = np.zeros((50, 8), np.float32)
    np.add.at(dense, ids, rows)
    np.testing.assert_allclose(want, dense / N, atol=1e-5)
    for r in range(N):
        np.testing.assert_allclose(out[r]["sparse"], want, **TOL)


def test_flat_parameter_order_and_pads_match_jax(world):
    out, (_, _, _, tree, _) = world
    jf = JaxFlat(tree, N)
    orig, padded, shard, flat = out[0]["flat"]
    assert (orig, padded, shard) == (jf.orig_size, jf.padded_size,
                                     jf.shard_size) == (201, 204, 51)
    np.testing.assert_array_equal(flat, np.asarray(jf.flatten(tree)))
    np.testing.assert_array_equal(flat[:orig], np.asarray(
        ravel_pytree(tree)[0]))


@pytest.mark.parametrize("wire", ["wire", "compress", "none"])
def test_zero1_wires_match_jax(world, wire):
    out, (_, _, _, tree, grads) = world
    mesh = data_parallel_mesh(N)
    arp = JaxARP(JaxSGD(learningrate=0.1), mesh,
                 wire_dtype="bf16" if wire == "wire" else "none",
                 compress="bf16" if wire == "compress" else "none")
    flat_w, st = arp.prepare(jax.tree_util.tree_map(jnp.asarray, tree))
    f = shard_map(lambda g, w, s: arp.update(g[0], w, s, 0.1), mesh=mesh,
                  in_specs=(P("data"), P(), arp.state_specs()),
                  out_specs=(P(), arp.state_specs()), check_vma=False)
    want = np.asarray(f(jnp.asarray(grads), flat_w, st)[0])
    for r in range(N):
        got = out[r]["arp_" + wire]
        if wire == "wire":
            np.testing.assert_array_max_ulp(got, want, maxulp=1)
        elif wire == "compress":
            # bf16 sums of 4 terms in two orders: a few bf16 ulps of the
            # mean gradient, times the learning rate
            np.testing.assert_allclose(got, want, atol=0.1 * 4 * 2 ** -7
                                       * np.abs(grads).max(), rtol=0)
        else:
            np.testing.assert_allclose(got, want, **TOL)
    if wire == "wire":
        # the rounding is real: the float32 wire differs
        f32 = np.asarray(flat_w) - 0.1 * grads.mean(0)
        assert not np.array_equal(out[0]["arp_wire"], f32)
