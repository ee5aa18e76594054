"""The port's attention kernels, held against the JAX package's Pallas
kernels run in interpret mode.

On the CPU a kernel wrapper of ``bigdl_tpu_torch`` runs its plain PyTorch
version, so these tests pin the plain versions to the Pallas kernels'
function (o and lse of ``_flash_fwd``; dq, dk, dv of ``_flash_bwd``;
``paged_decode_attention``). The CUDA kernels themselves are held against
the same plain versions on the card by ``chip_smoke.py``.

Tolerance: atol = rtol = 1e-5 in float32 for the forwards - both sides
compute the same online/exact softmax in float32 and differ only in
summation order and in the exp implementation (a few ulps on values of
order 1). The backward sums T products per gradient element (T up to 200
here) and recomputes p from lse: atol 5e-5, rtol 1e-4 in float32 (the
interpret kernel and an einsum autodiff already differ by 1.2e-5 at
T = 200).

With bf16 inputs both sides round p (and in the backward ds) to bf16 before
their products, as the Pallas kernels do, and round o or the gradients to
bf16. What is left: the Pallas forward rounds p against the running maximum
of its key block, the plain version against the row's final maximum, and the
two exp implementations differ by an ulp of float32, so a rounding can fall
the other way - one bf16 ulp of an output (2^-8 relative, 0.004 below 1,
0.016 at magnitudes of 2-4). bf16 forward: o at atol = rtol = 4e-3, lse (a
float32 sum of unrounded p on both sides) at the float32 1e-5. bf16
backward: atol = rtol = 8e-3 (read: 2e-3 at gradients up to 4.9). The
float32 gradients of the ring form (external delta, ``out_dtype`` float32):
atol = rtol = 2e-3 (read: 4.4e-4), p and ds still rounded to bf16 on both
sides.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigdl_tpu.kernels import flash_attention as jfa
from bigdl_tpu.kernels import paged_attention as jpa
from bigdl_tpu_torch import kernels
from bigdl_tpu_torch.kernels import (flash_bwd, flash_fwd,
                                     paged_decode_attention)
from bigdl_tpu_torch.nn.attention import causal_mask, dot_product_attention
from bigdl_tpu_torch.parallel.flash import flash_attention

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


_FWD_CASES = [  # (B, H, Tq, Tkv, D, causal, q_offset, kv_len, dtype)
    (2, 2, 16, 16, 8, True, 0, 16, "float32"),    # causal self-attention
    (1, 3, 13, 13, 16, True, 0, 13, "float32"),   # ragged T (not a tile multiple)
    (2, 2, 11, 20, 8, False, 0, 20, "float32"),   # non-causal, Tq != Tkv
    (1, 2, 9, 40, 8, True, 12, 21, "float32"),    # chunk: q_offset + kv_len prefix
    (2, 1, 8, 32, 16, False, 0, 19, "float32"),   # non-causal over a kv_len prefix
    (2, 2, 16, 16, 8, True, 0, 16, "bfloat16"),   # bf16: causal
    (1, 3, 13, 13, 16, True, 0, 13, "bfloat16"),  # bf16: ragged T
    (2, 2, 150, 150, 16, True, 0, 150, "bfloat16"),   # bf16: two JAX blocks
    (1, 2, 9, 40, 8, True, 12, 21, "bfloat16"),   # bf16: chunk form
    (1, 2, 40, 200, 16, True, 100, 140, "bfloat16"),  # bf16: chunk, longer
]


@pytest.mark.parametrize(
    "B,H,Tq,Tkv,D,causal,q_offset,kv_len,dtype", _FWD_CASES,
    ids=["-".join(map(str, c[:-1])) + ("" if c[-1] == "float32" else "-bf16")
         for c in _FWD_CASES])
def test_flash_plain_matches_pallas_interpret(B, H, Tq, Tkv, D, causal,
                                              q_offset, kv_len, dtype):
    rng = np.random.RandomState(B * 100 + Tq)
    jdt = jnp.dtype(dtype)
    q, k, v = [jnp.asarray(rng.randn(B, H, t, D).astype(np.float32))
               .astype(jdt) for t in (Tq, Tkv, Tkv)]
    jo, jlse = jfa._flash_fwd(q, k, v, causal, 1.0 / math.sqrt(D),
                              128, 128, True, q_offset=q_offset,
                              kv_len=kv_len)
    tdt = getattr(torch, dtype)
    tt = lambda a: _t(a.astype(jnp.float32)).to(tdt)
    o, lse = flash_fwd(tt(q), tt(k), tt(v), causal=causal,
                       q_offset=q_offset, kv_len=kv_len)
    assert o.dtype == tdt
    otol = TOL if dtype == "float32" else dict(atol=4e-3, rtol=4e-3)
    torch.testing.assert_close(o.float(), _t(jo.astype(jnp.float32)), **otol)
    torch.testing.assert_close(lse, _t(jlse), **TOL)


@pytest.mark.parametrize("T,D,causal,dtype", [
    (77, 32, True, "float32"),     # ragged T, one JAX block
    (200, 64, True, "float32"),    # ragged T over two JAX blocks
    (77, 64, False, "float32"),    # non-causal
    (200, 32, False, "float32"),
    (200, 64, True, "bfloat16"),   # bf16 inputs, the training dtype
])
def test_flash_bwd_plain_matches_pallas_interpret(T, D, causal, dtype):
    """flash_bwd's plain version on the Pallas forward's residuals
    (q, k, v, o, lse) against ``_flash_bwd`` in interpret mode."""
    rng = np.random.RandomState(T + D)
    jdt = jnp.dtype(dtype)
    q, k, v, do = [jnp.asarray(rng.randn(2, 2, T, D).astype(np.float32))
                   .astype(jdt) for _ in range(4)]
    scale = 1.0 / math.sqrt(D)
    o, lse = jfa._flash_fwd(q, k, v, causal, scale, 128, 128, True)
    want = jfa._flash_bwd(causal, scale, 128, 128, True, (q, k, v, o, lse),
                          do)
    tdt = getattr(torch, dtype)
    tt = lambda a: _t(a.astype(jnp.float32)).to(tdt)
    got = flash_bwd(tt(q), tt(k), tt(v), tt(o), _t(lse), tt(do), causal)
    tol = (dict(atol=5e-5, rtol=1e-4) if dtype == "float32"
           else dict(atol=8e-3, rtol=8e-3))
    for g, w in zip(got, want):
        assert g.dtype == tdt
        torch.testing.assert_close(g.float(), _t(w.astype(jnp.float32)),
                                   **tol)


@pytest.mark.parametrize("T,D,causal", [(200, 64, True), (77, 32, False)])
def test_flash_bwd_external_delta_f32_out_matches_pallas_interpret(T, D,
                                                                   causal):
    """The ring-backward form: bf16 residuals, delta = rowsum(dO * O)
    passed in, float32 gradients (``_flash_bwd(..., delta=,
    out_dtype=jnp.float32)``, as ``parallel/ring_flash.py`` calls it)."""
    rng = np.random.RandomState(T + D)
    q, k, v, do = [jnp.asarray(rng.randn(2, 2, T, D).astype(np.float32))
                   .astype(jnp.bfloat16) for _ in range(4)]
    scale = 1.0 / math.sqrt(D)
    o, lse = jfa._flash_fwd(q, k, v, causal, scale, 128, 128, True)
    delta = jnp.sum(do.astype(jnp.float32) * o.astype(jnp.float32), -1)
    want = jfa._flash_bwd(causal, scale, 128, 128, True, (q, k, v, o, lse),
                          do, delta=delta, out_dtype=jnp.float32)
    tt = lambda a: _t(a.astype(jnp.float32)).to(torch.bfloat16)
    got = flash_bwd(tt(q), tt(k), tt(v), tt(o), _t(lse), tt(do), causal,
                    delta=_t(delta), out_dtype=torch.float32)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, _t(w), atol=2e-3, rtol=2e-3)
    # the delta passed in is the one used: a zero delta changes dq
    dq0 = flash_bwd(tt(q), tt(k), tt(v), tt(o), _t(lse), tt(do), causal,
                    delta=torch.zeros_like(_t(delta)),
                    out_dtype=torch.float32)[0]
    assert not torch.allclose(dq0, got[0], atol=1e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_function_gradients_match_autograd(causal):
    """The autograd.Function (K1-fwd forward, K1-bwd backward; plain
    versions here) against autograd through the einsum attention."""
    rng = np.random.RandomState(3)
    q, k, v = [_t(rng.randn(2, 3, 37, 16)).requires_grad_()
               for _ in range(3)]
    do = _t(rng.randn(2, 3, 37, 16))
    kernels.reset_launch_counts()
    o = flash_attention(q, k, v, causal=causal)
    got = torch.autograd.grad(o, (q, k, v), do)
    ref = dot_product_attention(q, k, v, causal_mask(37) if causal else None)
    want = torch.autograd.grad(ref, (q, k, v), do)
    torch.testing.assert_close(o, ref, **TOL)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)
    assert set(kernels.launch_counts().values()) == {0}


def _paged_case(rng, B, nH, kvH, S, D, bs, nblk):
    NB = 1 + B * nblk
    kp = rng.randn(NB, kvH, bs, D).astype(np.float32)
    vp = rng.randn(NB, kvH, bs, D).astype(np.float32)
    tables = np.zeros((B, nblk), np.int32)
    for b in range(B):
        tables[b] = rng.permutation(np.arange(1, NB))[:nblk]
    pos = rng.randint(0, nblk * bs - S, size=B).astype(np.int32)
    q = rng.randn(B, nH, S, D).astype(np.float32)
    return q, kp, vp, tables, pos


@pytest.mark.parametrize("B,nH,kvH,S,D,bs,nblk,null_row", [
    (2, 4, 4, 1, 16, 8, 4, False),    # MHA decode step
    (3, 4, 2, 1, 8, 4, 6, True),      # GQA decode step + padded slot
    (2, 4, 4, 8, 8, 4, 8, True),      # MHA chunked prefill + padded slot
    (1, 8, 2, 5, 16, 16, 4, False),   # GQA, S > 1
])
def test_paged_plain_matches_pallas_interpret(B, nH, kvH, S, D, bs, nblk,
                                              null_row):
    rng = np.random.RandomState(B * 10 + S)
    q, kp, vp, tables, pos = _paged_case(rng, B, nH, kvH, S, D, bs, nblk)
    if null_row:   # a padded decode slot: all-null table at position 0
        tables[-1] = 0
        pos[-1] = 0
    want = jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(pos), interpret=True)
    got = paged_decode_attention(_t(q), _t(kp), _t(vp),
                                 torch.from_numpy(tables),
                                 torch.from_numpy(pos))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, _t(want), **TOL)


def test_paged_bf16_query_over_f32_pages_keeps_query_dtype():
    """bf16 weights over the default f32 pool: the wrapper attends in the
    page dtype and returns q's dtype, as the Pallas kernel does."""
    rng = np.random.RandomState(7)
    q, kp, vp, tables, pos = _paged_case(rng, 2, 4, 2, 1, 8, 4, 3)
    qb = _t(q).to(torch.bfloat16)
    got = paged_decode_attention(qb, _t(kp), _t(vp),
                                 torch.from_numpy(tables),
                                 torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16
    want = paged_decode_attention(qb.float(), _t(kp), _t(vp),
                                  torch.from_numpy(tables),
                                  torch.from_numpy(pos))
    torch.testing.assert_close(got, want.to(torch.bfloat16), atol=0, rtol=0)


def test_flash_plain_fully_masked_rows_are_zero():
    q = torch.randn(1, 1, 4, 8)
    k = torch.randn(1, 1, 6, 8)
    o, lse = flash_fwd(q, k, k, causal=False, kv_len=0)
    assert torch.equal(o, torch.zeros_like(o))
    assert torch.isneginf(lse).all()


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    kernels.reset_launch_counts()
    q = torch.randn(1, 2, 8, 8)
    flash_fwd(q, q, q, causal=True)
    tables = torch.zeros((1, 2), dtype=torch.int32)
    paged_decode_attention(q, torch.randn(3, 2, 4, 8), torch.randn(3, 2, 4, 8),
                           tables, torch.zeros((1,), dtype=torch.int32))
    assert set(kernels.launch_counts().values()) == {0}


def test_flash_routes_by_dtype_one_kernel_each():
    """bf16 goes to the tensor-core sources; float32 to the 3xTF32 sources
    up to their widest head dims and to the CUDA-core ones past them;
    every route's library is in the build list with its headers, and each
    source exists."""
    from bigdl_tpu_torch.kernels import _build
    from bigdl_tpu_torch.kernels import flash_attention as fa
    assert {fa.bwd_route(torch.bfloat16, 64), fa.bwd_route(torch.float32, 64),
            fa.bwd_route(torch.float32, 80)} == {"bf16_sm90", "f32_sm90",
                                                  "f32"}
    assert set(fa._FWD_FN) == {"bf16_sm90", "f32_sm90", "f32"}
    assert set(fa._BWD_FN) == set(fa._FWD_FN)
    for table in (fa._FWD_FN, fa._BWD_FN):
        libs = {route: lib for route, (lib, _) in table.items()}
        assert libs["bf16_sm90"].endswith("_sm90")
        for lib in libs.values():
            for f in _build.SOURCES[lib]:
                assert (_build.CSRC / f).exists(), f
    assert fa._FWD_FN["f32_sm90"] == ("flash_fwd_tf32_sm90",
                                      "bigdl_flash_fwd_tf32_sm90")
    assert fa._BWD_FN["f32_sm90"] == ("flash_bwd_tf32_sm90",
                                      "bigdl_flash_bwd_tf32_sm90")
    assert _build.SOURCES["flash_fwd_sm90"][1] == "attn_sm90.cuh"
    for lib in ("flash_fwd_tf32_sm90", "flash_bwd_tf32_sm90"):
        assert {"attn_tf32_sm90.cuh",
                "fused_gemm_tf32_sm90.cuh"} <= set(_build.SOURCES[lib])


@pytest.mark.parametrize("d", [8, 16, 40, 48, 64, 65, 80, 96, 128, 192])
def test_flash_backward_route_by_dtype_and_head_dim(d):
    """float32: 3xTF32 up to D = 64 (padded between its instantiations),
    the CUDA cores past it; bf16: its tensor-core route; the route's
    width is the next instantiation."""
    from bigdl_tpu_torch.kernels import flash_attention as fa
    want = "f32_sm90" if d <= 64 else "f32"
    assert fa.bwd_route(torch.float32, d) == want
    assert fa.bwd_route(torch.bfloat16, d) == "bf16_sm90"
    w = fa.head_dim_width("t", want, d, fa._BWD_DIMS[want])
    assert w >= d and w - d < 16


@pytest.mark.parametrize("dt,d", [(torch.float32, 64), (torch.bfloat16, 64),
                                  (torch.float32, 256), (torch.bfloat16, 40)])
def test_paged_route_is_the_split_kernel_for_every_head_dim(dt, d):
    """Every page dtype and head dim the wrapper takes launches the
    split-K kernel; the unsplit kernel keeps its entry and counters."""
    from bigdl_tpu_torch.kernels import _build
    from bigdl_tpu_torch.kernels import paged_attention as pa
    want = "f32_split" if dt == torch.float32 else "bf16_split"
    assert pa.route(dt, d) == want
    assert pa._FN[want] == ("paged_attention_sm90",
                            "bigdl_paged_attention_sm90")
    assert pa._FN[want[:-len("_split")]] == ("paged_attention",
                                             "bigdl_paged_attention")
    for lib, _ in pa._FN.values():
        for f in _build.SOURCES[lib]:
            assert (_build.CSRC / f).exists(), f


@pytest.mark.parametrize("d", [8, 16, 40, 64, 100, 112, 113, 120, 128, 256])
def test_flash_forward_route_by_dtype_and_head_dim(d):
    """float32: 3xTF32 up to D = 112 (padded between its instantiations),
    the CUDA cores past it; bf16: its tensor-core route at any D it
    takes; the backward keeps one route a dtype."""
    from bigdl_tpu_torch.kernels import flash_attention as fa
    want = "f32_sm90" if d <= 112 else "f32"
    assert fa.fwd_route(torch.float32, d) == want
    assert fa.fwd_route(torch.bfloat16, d) == "bf16_sm90"
    w = fa.head_dim_width("t", want, d, fa._FWD_DIMS[want])
    assert w >= d and w - d < 16
    kv, extra = fa._kv_split(want, 2, 3, 77, w, "cpu")
    if want == "f32_sm90":
        assert kv.numel() == 4 * 2 * 3 * 80 * w and extra == (kv.data_ptr(),)
    else:
        assert kv is None and extra == ()


def test_cpu_flash_calls_count_no_launch_on_any_route():
    kernels.reset_launch_counts()
    fused = {"bf16_sm90": 0, "bf16_ragged": 0, "f32_sm90": 0, "f32": 0}
    conv = fused
    flash = {"bf16_sm90": 0, "bf16_sm90_padded": 0, "f32_sm90": 0,
             "f32_sm90_padded": 0, "f32": 0, "f32_padded": 0}
    paged = {"f32_split": 0, "f32_split_padded": 0, "bf16_split": 0,
             "bf16_split_padded": 0, "f32": 0, "f32_padded": 0, "bf16": 0,
             "bf16_padded": 0}
    assert kernels.launches_by_route() == {
        "flash_fwd": flash, "flash_bwd": flash, "paged_attention": paged,
        "fused_matmul_fwd": fused, "fused_matmul_bwd": fused,
        "fused_chain_fwd": fused, "fused_chain_bwd": fused,
        "fused_conv_fwd": conv}
    q = torch.randn(1, 2, 8, 8).to(torch.bfloat16)
    o, lse = flash_fwd(q, q, q, causal=True)
    flash_bwd(q, q, q, o, lse, q, True, out_dtype=torch.float32)
    assert set(kernels.launches_by_route()["flash_fwd"].values()) == {0}
    assert set(kernels.launches_by_route()["flash_bwd"].values()) == {0}
    with pytest.raises(TypeError):
        flash_bwd(q, q, q, o, lse, q, True, out_dtype=torch.float16)
