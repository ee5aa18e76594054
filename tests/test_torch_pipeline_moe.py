"""GPipe and the expert-parallel MoE FFN in the port on a gloo world of 4
ranks, held against JAX's on 4 virtual CPU devices
(``tests/test_pipeline_moe.py``): the pipelined outputs at 1e-5 and each
rank's stage gradients at 1e-5 against JAX's ``jax.grad`` through the
shard_mapped pipeline (each port rank's loss is its 1/n share of the
replicated loss; the masked ``psum`` that broadcasts the last stage sums
the shares back); ``moe_ffn``'s outputs, aux loss, the router's gradient
summed over the ranks and each rank's expert gradient at 1e-5; and
``stack_stage_params`` / ``unstack_stage_params``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from bigdl_tpu.parallel.moe import moe_ffn
from bigdl_tpu.parallel.pipeline import gpipe, stack_stage_params
from bigdl_tpu.utils.compat import shard_map

import torch_dist_helpers as dh

torch.set_num_threads(1)
N, TOL = 4, dict(rtol=1e-5, atol=1e-5)
_r = np.random.RandomState(0)
STAGES = {"w": (_r.randn(N, 8, 8) * 0.3).astype(np.float32),
          "b": (_r.randn(N, 8) * 0.1).astype(np.float32)}
X = _r.randn(6, 2, 8).astype(np.float32)
Y = _r.randn(6, 2, 8).astype(np.float32)
ROUTER = (_r.randn(8, N) * 0.5).astype(np.float32)
WS = (_r.randn(N, 8, 8) * 0.3).astype(np.float32)
MOE_X = _r.randn(N * 4, 8).astype(np.float32)
CAP = 2.0
_cache = {}


def _world():
    if "w" not in _cache:
        _cache["w"] = dh.run_world(dh.pipe_moe, N, STAGES, X, Y, ROUTER, WS,
                                   MOE_X, CAP, timeout_s=90)
    return _cache["w"]


def _mesh(axis):
    return Mesh(np.array(jax.devices()[:N]), (axis,))


def _jax_pipe():
    run = gpipe(lambda p, x: jnp.tanh(x @ p["w"] + p["b"]), axis="pipe")
    specs = {"w": P("pipe"), "b": P("pipe")}

    def loss(params, x, y):
        def inner(p, xx, yy):
            out = run(p, xx)
            return jnp.mean((out - yy) ** 2) * jnp.ones((1,)), out
        l, out = shard_map(inner, mesh=_mesh("pipe"),
                           in_specs=(specs, P(), P()),
                           out_specs=(P(), P()))(params, x, y)
        return l.sum(), out
    params = {k: jnp.asarray(v) for k, v in STAGES.items()}
    (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, jnp.asarray(X), jnp.asarray(Y))
    return np.asarray(out), {k: np.asarray(v) for k, v in g.items()}


def test_gpipe_outputs_equal_jax_and_sequential():
    out = _world()
    want, _ = _jax_pipe()
    ref = X
    for i in range(N):
        ref = np.tanh(ref @ STAGES["w"][i] + STAGES["b"][i])
    np.testing.assert_allclose(want, ref, atol=1e-5)
    for o in out:
        np.testing.assert_allclose(o["pipe"][0], want, **TOL)


def test_gpipe_stage_gradients_equal_jax():
    out = _world()
    _, g = _jax_pipe()
    for r, o in enumerate(out):
        gw, gb = o["pipe"][1]
        np.testing.assert_allclose(gw, g["w"][r:r + 1], **TOL)
        np.testing.assert_allclose(gb, g["b"][r:r + 1], **TOL)
        assert np.abs(gw).sum() > 0


def _jax_moe():
    run = moe_ffn(lambda p, h: jnp.tanh(h @ p["w"]), axis="expert",
                  capacity_factor=CAP)
    mesh = _mesh("expert")

    def loss(rw, params, x):
        def inner(r_, p, xx):
            y, aux = run(r_, p, xx)
            val = jax.lax.pmean(jnp.mean(y ** 2), "expert") + 0.01 * aux
            return val * jnp.ones((1,)), y, aux
        v, y, aux = shard_map(inner, mesh=mesh,
                              in_specs=(P(), {"w": P("expert")},
                                        P("expert")),
                              out_specs=(P(), P("expert"), P()))(
            rw, params, x)
        return v.sum(), (y, aux)
    (_, (y, aux)), (gr, gw) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(ROUTER), {"w": jnp.asarray(WS)}, jnp.asarray(MOE_X))
    return np.asarray(y), float(aux), np.asarray(gr), np.asarray(gw["w"])


def test_moe_ffn_outputs_and_aux_equal_jax():
    out = _world()
    y, aux, _, _ = _jax_moe()
    got = np.concatenate([o["moe"][0] for o in out], 0)
    np.testing.assert_allclose(got, y, **TOL)
    for o in out:
        np.testing.assert_allclose(o["moe"][1], aux, **TOL)


def test_moe_ffn_gradients_equal_jax():
    out = _world()
    _, _, gr, gw = _jax_moe()
    for r, o in enumerate(out):
        np.testing.assert_allclose(o["moe"][2], gr, **TOL)
        np.testing.assert_allclose(o["moe"][3], gw[r:r + 1], **TOL)


def test_stack_unstack_stage_params_equal_jax():
    from bigdl_tpu_torch.parallel.pipeline import (
        stack_stage_params as tstack, unstack_stage_params as tunstack)
    per = [{"w": torch.from_numpy(STAGES["w"][i]),
            "b": torch.from_numpy(STAGES["b"][i])} for i in range(N)]
    st = tstack(per)
    want = stack_stage_params([{k: jnp.asarray(v[i]) for k, v in
                                STAGES.items()} for i in range(N)])
    for k in st:
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(want[k]))
    for a, b in zip(tunstack(st, N), per):
        for k in a:
            assert torch.equal(a[k], b[k])


def test_moe_ffn_refuses_two_experts_a_rank():
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.parallel.collective import over
    from bigdl_tpu_torch.parallel.moe import moe_ffn as tmoe
    mesh = make_mesh((1,), ("expert",), device="cpu")
    run = tmoe(lambda p, h: h @ p["w"], "expert")
    with over(mesh), pytest.raises(ValueError, match="exactly one expert"):
        run(torch.zeros(8, 1), {"w": torch.zeros(2, 8, 8)},
            torch.zeros(4, 8))
