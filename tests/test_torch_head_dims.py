"""Head dims of the attention kernels (ROADMAP C.3).

JAX's Pallas kernels take the whole head dim D as one block, so a
TransformerLM with D = 96 (hidden 768, 8 heads) or 16 runs there. The
port's CUDA kernels are instantiated per D: every multiple of 16 up to 256
on the CUDA-core routes (the float32 flash backward up to 192), up to 128
on the bf16 tensor-core route and up to 112 on the float32 flash
forward's 3xTF32 route (a wider float32 forward takes the CUDA cores);
another D takes the next wider instantiation on its route, zero-padded
(the padded route), and a D past the widest raises. These tests hold the
plain versions against the Pallas kernels in interpret mode at D = 16 and
96, and the wrappers' tables against the ``case`` lines of the CUDA
sources. The kernels themselves, padded route included, are held against
the plain versions on the card by ``chip_smoke.py``.

Tolerance, float32: atol = rtol = 1e-5 (same softmax in float32, other
summation order and exp implementation; the backward here sums at most
40 products per element).
"""
import math
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigdl_tpu.kernels import flash_attention as jfa
from bigdl_tpu.kernels import paged_attention as jpa
from bigdl_tpu_torch import kernels
from bigdl_tpu_torch.kernels import _build
from bigdl_tpu_torch.kernels import flash_attention as fa
from bigdl_tpu_torch.kernels import paged_attention as pa

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("D", [16, 96])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_plain_matches_pallas_interpret(D, causal):
    rng = np.random.RandomState(D)
    q, k, v = [jnp.asarray(rng.randn(2, 2, 24, D).astype(np.float32))
               for _ in range(3)]
    jo, jlse = jfa._flash_fwd(q, k, v, causal, 1.0 / math.sqrt(D), 128, 128,
                              True)
    o, lse = kernels.flash_fwd(_t(q), _t(k), _t(v), causal=causal)
    torch.testing.assert_close(o, _t(jo), **TOL)
    torch.testing.assert_close(lse, _t(jlse), **TOL)


@pytest.mark.parametrize("D", [16, 96])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_plain_matches_pallas_interpret(D, causal):
    rng = np.random.RandomState(D + 1)
    q, k, v, do = [jnp.asarray(rng.randn(2, 2, 24, D).astype(np.float32))
                   for _ in range(4)]
    scale = 1.0 / math.sqrt(D)
    o, lse = jfa._flash_fwd(q, k, v, causal, scale, 128, 128, True)
    want = jfa._flash_bwd(causal, scale, 128, 128, True, (q, k, v, o, lse),
                          do)
    got = kernels.flash_bwd(_t(q), _t(k), _t(v), _t(o), _t(lse), _t(do),
                            causal)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, _t(w), **TOL)


@pytest.mark.parametrize("D", [16, 96])
@pytest.mark.parametrize("scale", [None, 0.3])
def test_paged_plain_matches_pallas_interpret(D, scale):
    """GQA decode over pages, with a padded slot; ``scale`` as JAX takes
    it (None: 1 / sqrt(D))."""
    rng = np.random.RandomState(D)
    B, nH, kvH, S, bs, nblk = 3, 4, 2, 2, 4, 5
    NB = 1 + B * nblk
    kp = rng.randn(NB, kvH, bs, D).astype(np.float32)
    vp = rng.randn(NB, kvH, bs, D).astype(np.float32)
    tables = np.stack([rng.permutation(np.arange(1, NB))[:nblk]
                       for _ in range(B)]).astype(np.int32)
    pos = rng.randint(0, nblk * bs - S, size=B).astype(np.int32)
    tables[-1], pos[-1] = 0, 0
    q = rng.randn(B, nH, S, D).astype(np.float32)
    want = jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(pos), scale=scale, interpret=True)
    got = kernels.paged_decode_attention(
        _t(q), _t(kp), _t(vp), torch.from_numpy(tables),
        torch.from_numpy(pos), scale)
    torch.testing.assert_close(got, _t(want), **TOL)


def _cases(source, pattern):
    text = (_build.CSRC / source).read_text()
    return tuple(int(d) for d in re.findall(pattern, text))


@pytest.mark.parametrize("table,route,source,pattern", [
    (fa._FWD_DIMS, "f32", "flash_fwd.cu",
     r"case (\d+): return bigdl::launch_flash"),
    (fa._BWD_DIMS, "f32", "flash_bwd.cu",
     r"case (\d+): return bigdl::launch_bwd"),
    (fa._FWD_DIMS, "bf16_sm90", "flash_fwd_sm90.cu",
     r"case (\d+): return bigdl::sm90::launch_fwd"),
    (fa._FWD_DIMS, "f32_sm90", "flash_fwd_tf32_sm90.cu",
     r"case (\d+): return bigdl_fg::sm90::tf32::launch_flash"),
    (fa._BWD_DIMS, "bf16_sm90", "flash_bwd_sm90.cu",
     r"case (\d+): return launch_bwd"),
    (fa._BWD_DIMS, "f32_sm90", "flash_bwd_tf32_sm90.cu",
     r"case (\d+): return bigdl_fg::sm90::tf32::launch_bwd"),
    ({"pages": pa._DIMS}, "pages", "paged_attention.cu",
     r"case (\d+): return dispatch_tpr"),
    ({"pages": pa._DIMS}, "pages", "paged_attention_sm90.cu",
     r"case (\d+): return launch<T"),
], ids=["flash_fwd_f32", "flash_bwd_f32", "flash_fwd_bf16",
        "flash_fwd_f32_tf32", "flash_bwd_bf16", "flash_bwd_f32_tf32", "paged",
        "paged_split"])
def test_every_claimed_head_dim_is_instantiated_or_padded(table, route,
                                                          source, pattern):
    """The wrapper's table is exactly the source's instantiations; every D
    up to the widest launches one of them (itself, or the next wider one
    through the padded route); D = 272 and anything past the widest
    raise, naming the ROADMAP item."""
    dims = table[route]
    assert dims == _cases(source, pattern)
    assert dims == tuple(sorted(dims)) and all(d % 16 == 0 for d in dims)
    for d in range(1, dims[-1] + 1):
        w = fa.head_dim_width("t", route, d, dims)
        assert w in dims and w >= d
        assert [x for x in dims if d <= x < w] == []    # the next wider one
    for d in (dims[-1] + 1, 272):
        with pytest.raises(ValueError, match="ROADMAP.md B.5"):
            fa.head_dim_width("t", route, d, dims)


def test_routes_cover_every_multiple_of_16_up_to_their_widest():
    assert fa._FWD_DIMS["f32"] == tuple(range(16, 257, 16))
    assert fa._BWD_DIMS["f32"] == tuple(range(16, 193, 16))
    assert pa._DIMS == tuple(range(16, 257, 16))
    assert fa._FWD_DIMS["bf16_sm90"] == fa._BWD_DIMS["bf16_sm90"] == tuple(
        range(16, 129, 16))
    assert fa._FWD_DIMS["f32_sm90"] == tuple(range(16, 113, 16))
    assert fa._BWD_DIMS["f32_sm90"] == tuple(range(16, 65, 16))
    # float32 forward: past 112 the CUDA-core route, padded there too
    assert [fa.fwd_route(torch.float32, d) for d in (112, 113, 128, 256)] == [
        "f32_sm90", "f32", "f32", "f32"]
    # float32 backward: past 64 the CUDA-core route
    assert [fa.bwd_route(torch.float32, d) for d in (48, 64, 65, 192)] == [
        "f32_sm90", "f32_sm90", "f32", "f32"]
    # K2: the split-K kernel at every head dim, both page dtypes
    assert {pa.route(dt, d) for dt in (torch.float32, torch.bfloat16)
            for d in pa._DIMS} == {"f32_split", "bf16_split"}
    assert fa.head_dim_width("t", "f32", 120, fa._FWD_DIMS["f32"]) == 128
    # the padded route takes the rest: D = 40 -> 48, 100 -> 112, 8 -> 16
    assert [fa.head_dim_width("t", "bf16_sm90", d, fa._FWD_DIMS["bf16_sm90"])
            for d in (40, 100, 8, 96)] == [48, 112, 16, 96]


@pytest.mark.parametrize("D", [16, 96, 272])
def test_cpu_calls_at_any_head_dim_take_the_plain_version(D):
    """On the CPU every D runs the plain version (no table, no launch);
    the per-route counters hold a padded key per route."""
    kernels.reset_launch_counts()
    q = torch.randn(1, 2, 8, D)
    o, lse = kernels.flash_fwd(q, q, q, causal=True)
    kernels.flash_bwd(q, q, q, o, lse, q, True)
    tables = torch.zeros((1, 2), dtype=torch.int32)
    kernels.paged_decode_attention(q, torch.randn(3, 2, 4, D),
                                   torch.randn(3, 2, 4, D), tables,
                                   torch.zeros((1,), dtype=torch.int32))
    routes = kernels.launches_by_route()
    assert set(routes["flash_fwd"]) == {"bf16_sm90", "bf16_sm90_padded",
                                        "f32_sm90", "f32_sm90_padded",
                                        "f32", "f32_padded"}
    assert set(routes["flash_bwd"]) == {"bf16_sm90", "bf16_sm90_padded",
                                        "f32_sm90", "f32_sm90_padded",
                                        "f32", "f32_padded"}
    assert set(routes["paged_attention"]) == {
        "f32_split", "f32_split_padded", "bf16_split", "bf16_split_padded",
        "f32", "f32_padded", "bf16", "bf16_padded"}
    assert all(set(r.values()) == {0} for r in routes.values())
    assert set(kernels.launch_counts().values()) == {0}
