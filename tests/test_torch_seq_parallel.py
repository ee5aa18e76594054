"""Sequence parallelism in the port on a gloo world of 4 ranks, held
against JAX's on 4 virtual CPU devices (``tests/test_seq_parallel.py``,
``tests/test_ring_flash.py`` and the sequence-sharded decode of
``tests/test_distributed.py``): the plain ring, ring-flash (the flash
blocks' plain versions on the CPU, the hand-derived ring backward),
the all-to-all with and without flash, causal and not, forward and the
gradients of sum(sin(out)) at 1e-5; ``Attention(seq_axis=)`` with RoPE
(positions offset by the rank's block) and GQA (K/V heads broadcast
before the exchange) by ring and by all-to-all at 1e-5, its parameters'
gradients summed over the ranks; the time-sharded decode across shard
edges for MHA and GQA at 2e-5 (JAX's own bound); and JAX's refusals
(attention dropout with ``seq_axis``, a2a with indivisible heads).
"""
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bigdl_tpu import nn as jnn
from bigdl_tpu.parallel import make_seq_sharded_decoder
from bigdl_tpu.parallel.ring_attention import make_ring_attention
from bigdl_tpu.parallel.ring_flash import make_ring_flash_attention
from bigdl_tpu.parallel.seq_all_to_all import a2a_attention
from bigdl_tpu.utils.compat import shard_map

import torch_dist_helpers as dh

torch.set_num_threads(1)
N, TOL = 4, dict(rtol=1e-5, atol=1e-5)
B, H, T, D = 2, 4, 32, 8
_rng = np.random.RandomState(0)
QKV = [(_rng.randn(B, H, T, D) * 0.5).astype(np.float32) for _ in range(3)]
X = _rng.randn(2, 32, 32).astype(np.float32)
ATTN = [("ring", 2), ("a2a", 2), ("a2a", None)]
DECODE_CASES = [(4, 4), (4, 2)]
_cache = {}


def _mesh(axis="seq"):
    return Mesh(np.array(jax.devices()[:N]), (axis,))


def _attn_weights(kvh):
    m = jnn.Attention(32, 8, causal=True, num_kv_heads=kvh, rope=True)
    params, _ = m.init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def _decode_steps():
    r = np.random.RandomState(3)
    out = {}
    for nh, kvh in DECODE_CASES:
        out[(nh, kvh)] = [tuple(r.randn(*s).astype(np.float32) for s in
                                ((2, nh, 1, 8), (2, kvh, 1, 8),
                                 (2, kvh, 1, 8))) for _ in range(7)]
    return out


def _world():
    if "w" not in _cache:
        out = dh.run_world(dh.seq_parallel, N, QKV, ATTN, X,
                           {kvh: _attn_weights(kvh) for _, kvh in ATTN},
                           _decode_steps(), timeout_s=120)
        _cache["w"] = out
    return _cache["w"]


def _cat(out, key, part, dim):
    return np.concatenate([o[key][part] if part is not None else o[key]
                           for o in out], dim)


def _jax_fn(kind, causal):
    mesh = _mesh()
    spec = P(None, None, "seq", None)
    if kind == "ring":
        return make_ring_attention(mesh, "seq", causal)
    if kind == "ring_flash":
        return make_ring_flash_attention(mesh, "seq", causal)
    return shard_map(partial(a2a_attention, axis="seq", causal=causal,
                             use_flash=kind == "a2a_flash"),
                     mesh=mesh, in_specs=(spec,) * 3, out_specs=spec)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("kind", ["ring", "ring_flash", "a2a_flash", "a2a"])
def test_seq_attention_forward_and_grads_equal_jax(kind, causal):
    out = _world()
    f = _jax_fn(kind, causal)
    q, k, v = (jnp.asarray(a) for a in QKV)
    want = np.asarray(jax.jit(f)(q, k, v))
    got = np.concatenate([o[(kind, causal)][0] for o in out], 2)
    np.testing.assert_allclose(got, want, **TOL)
    gw = jax.jit(jax.grad(lambda q, k, v: jnp.sum(jnp.sin(f(q, k, v))),
                          argnums=(0, 1, 2)))(q, k, v)
    for i, g in enumerate(gw):
        mine = np.concatenate([o[(kind, causal)][1][i] for o in out], 2)
        np.testing.assert_allclose(mine, np.asarray(g), **TOL,
                                   err_msg=f"d{'qkv'[i]}")


@pytest.mark.parametrize("impl,kvh", ATTN, ids=[f"{i}-kv{k}" for i, k in ATTN])
def test_attention_seq_axis_equals_jax(impl, kvh):
    out = _world()
    w = jax.tree_util.tree_map(jnp.asarray, _attn_weights(kvh))
    sp = jnn.Attention(32, 8, causal=True, seq_axis="seq", seq_impl=impl,
                       num_kv_heads=kvh, rope=True)
    x = jnp.asarray(X)

    def fwd(p, xx):
        f = shard_map(lambda pp, xb: sp.apply(pp, {}, xb, training=False)[0],
                      mesh=_mesh(), in_specs=(P(), P(None, "seq", None)),
                      out_specs=P(None, "seq", None))
        return f(p, xx)
    want = np.asarray(jax.jit(fwd)(w, x))
    key = ("attn", impl, kvh)
    np.testing.assert_allclose(np.concatenate([o[key][0] for o in out], 1),
                               want, **TOL)
    # and the dense module on one device
    dense = jnn.Attention(32, 8, causal=True, num_kv_heads=kvh, rope=True,
                          use_flash=False)
    ref, _ = dense.apply(w, {}, x, training=False)
    np.testing.assert_allclose(want, np.asarray(ref), atol=2e-5)
    gp, gx = jax.jit(jax.grad(lambda p, xx: jnp.sum(jnp.sin(fwd(p, xx))),
                              argnums=(0, 1)))(w, x)
    np.testing.assert_allclose(np.concatenate([o[key][1] for o in out], 1),
                               np.asarray(gx), **TOL)
    for name, g in gp.items():
        np.testing.assert_allclose(out[0][key][2][name], np.asarray(g),
                                   **TOL, err_msg=name)


@pytest.mark.parametrize("nh,kvh", DECODE_CASES, ids=["mha", "gqa"])
def test_seq_sharded_decode_across_shard_edges_equals_jax(nh, kvh):
    out = _world()
    mesh = _mesh()
    step = jax.jit(make_seq_sharded_decoder(mesh, "seq"))
    sh = NamedSharding(mesh, P(None, None, "seq", None))
    kc = jax.device_put(jnp.zeros((2, kvh, 16, 8)), sh)
    vc = jax.device_put(jnp.zeros((2, kvh, 16, 8)), sh)
    want = []
    for pos, (q, kt, vt) in enumerate(_decode_steps()[(nh, kvh)]):
        o, kc, vc = step(q, kt, vt, kc, vc, jnp.int32(pos))
        want.append(np.asarray(o))
    for o in out:
        np.testing.assert_allclose(o[("decode", nh, kvh)], np.stack(want),
                                   rtol=2e-5, atol=2e-5)


def test_seq_axis_with_attention_dropout_refused():
    from bigdl_tpu_torch import nn
    with pytest.raises(ValueError, match="dropout"):
        nn.Attention(16, 2, 0.1, True, "seq")
    with pytest.raises(ValueError, match="dropout"):
        jnn.Attention(16, 2, 0.1, True, "seq")


def test_a2a_indivisible_heads_refused():
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.parallel.collective import over
    from bigdl_tpu_torch.parallel.seq_all_to_all import a2a_attention as ta
    mesh = make_mesh((1,), ("seq",), device="cpu")
    q = torch.zeros(1, 3, 4, 8)
    with over(mesh):
        assert ta(q, q, q, "seq").shape == q.shape    # 3 % 1 == 0
    import bigdl_tpu_torch.parallel.seq_all_to_all as m
    orig = m.collective.axis_group
    m.collective.axis_group = lambda axis: (None, 2, 0)
    try:
        with pytest.raises(ValueError, match="divisible"):
            ta(q, q, q, "seq")
    finally:
        m.collective.axis_group = orig
