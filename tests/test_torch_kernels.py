"""The port's attention kernels, held against the JAX package's Pallas
kernels run in interpret mode.

On the CPU a kernel wrapper of ``bigdl_tpu_torch`` runs its plain PyTorch
version, so these tests pin the plain versions to the Pallas kernels'
function (o and lse of ``_flash_fwd``; ``paged_decode_attention``). The
CUDA kernels themselves are held against the same plain versions on the
card by ``chip_smoke.py``.

Tolerance: atol = rtol = 1e-5 in float32 - both sides compute the same
online/exact softmax in float32 and differ only in summation order and in
the exp implementation (a few ulps on values of order 1).
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigdl_tpu.kernels import flash_attention as jfa
from bigdl_tpu.kernels import paged_attention as jpa
from bigdl_tpu_torch import kernels
from bigdl_tpu_torch.kernels import flash_fwd, paged_decode_attention

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
    assert kernels.launch_counts() == {"flash_fwd": 0, "paged_attention": 0}
