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
T = 200). With bf16 inputs the Pallas kernel rounds p and ds to bf16 before
its products (2^-9 relative each) and both sides round the gradients to
bf16 (2^-8 relative, one ulp = 0.016 at magnitudes of 2-4): atol = rtol =
2e-2.
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


@pytest.mark.parametrize("B,H,Tq,Tkv,D,causal,q_offset,kv_len", [
    (2, 2, 16, 16, 8, True, 0, 16),      # causal self-attention
    (1, 3, 13, 13, 16, True, 0, 13),     # ragged T (not a tile multiple)
    (2, 2, 11, 20, 8, False, 0, 20),     # non-causal, Tq != Tkv
    (1, 2, 9, 40, 8, True, 12, 21),      # chunk: q_offset + kv_len prefix
    (2, 1, 8, 32, 16, False, 0, 19),     # non-causal over a kv_len prefix
])
def test_flash_plain_matches_pallas_interpret(B, H, Tq, Tkv, D, causal,
                                              q_offset, kv_len):
    rng = np.random.RandomState(B * 100 + Tq)
    q = rng.randn(B, H, Tq, D).astype(np.float32)
    k = rng.randn(B, H, Tkv, D).astype(np.float32)
    v = rng.randn(B, H, Tkv, D).astype(np.float32)
    jo, jlse = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal, 1.0 / math.sqrt(D),
                              128, 128, True, q_offset=q_offset,
                              kv_len=kv_len)
    o, lse = flash_fwd(_t(q), _t(k), _t(v), causal=causal,
                       q_offset=q_offset, kv_len=kv_len)
    torch.testing.assert_close(o, _t(jo), **TOL)
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
           else dict(atol=2e-2, rtol=2e-2))
    for g, w in zip(got, want):
        assert g.dtype == tdt
        torch.testing.assert_close(g.float(), _t(w.astype(jnp.float32)),
                                   **tol)


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
