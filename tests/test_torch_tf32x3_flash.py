"""A torch model of the 3xTF32 numerics of the float32 flash-attention
forward on the tensor cores (``csrc/flash_fwd_tf32_sm90.cu``), held against
the JAX package's Pallas kernel run in interpret mode.

Per key tile (64 keys, 32 past D = 64) the kernel takes S = Q K^T as three
tf32 products of the hi / lo halves (``tests/test_torch_tf32x3.py``'s
``tf32_rn`` and ``split``), the online softmax (m, l) in float32 with
exp2, P split into hi and lo in registers and P V as three products into a
fresh sum that joins the output as acc = acc * alpha + tile (the promotion
that keeps the tensor cores' accumulation from drifting). V^T holds each
group of 8 keys in the order 0, 2, 4, 6, 1, 3, 5, 7, so that the S
accumulator's registers are P's A fragment without a shuffle; the model
takes P V through that order, and one test builds the fragment from an
accumulator laid out as wgmma returns it and shows the product is P V.
Also: one TF32 pass misses the float32 tolerance (1e-5 of the largest |o|,
1e-5 on lse), which three passes hold.

On the card ``chip_smoke.py`` holds the kernel itself against the plain
float32 version (o within 2e-5, lse within 1e-4).
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigdl_tpu.kernels import flash_attention as jfa
from test_torch_tf32x3 import split

torch.set_num_threads(1)
TOL = 1e-5
LOG2E = 1.4426950408889634
# V^T's order within each group of 8 keys: position p holds key PERM[p]
PERM = (0, 2, 4, 6, 1, 3, 5, 7)


def vt_pos(k):
    """The split kernel's position of key k in V^T (vt_pos)."""
    return (k & ~7) | ((k & 1) << 2) | ((k >> 1) & 3)


def _tile(d):
    return 64 if d <= 64 else 32


def _three(ah, al, bh, bl):
    """lo hi + hi lo + hi hi of the halves, in float32."""
    return al @ bh + ah @ bl + ah @ bh


def flash_model(q, k, v, causal, q_offset=0, kv_len=None, passes=3):
    """o, lse of the 3xTF32 kernel (passes=3) or of one TF32 pass (hi hi
    alone, passes=1) for float32 q (B, H, Tq, D), k / v (B, H, Tkv, D)."""
    B, H, Tq, D = q.shape
    kv_len = k.shape[2] if kv_len is None else kv_len
    bk = _tile(D)
    sl2 = LOG2E / math.sqrt(D)
    qh, ql = split(q)
    rows = q_offset + torch.arange(Tq)
    m = torch.full((B, H, Tq, 1), -math.inf)
    l = torch.zeros(B, H, Tq, 1)
    acc = torch.zeros(B, H, Tq, D)
    # the tiles as TMA brings them: bk keys each, zeros past the end
    pad = -k.shape[2] % bk
    k = torch.nn.functional.pad(k, (0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    # V^T's key order (vt_pos) within a tile; P's columns are taken in it
    order = [(i & ~7) + PERM[i & 7] for i in range(bk)]
    for j0 in range(0, kv_len, bk):
        kt = k[:, :, j0:j0 + bk]
        vt = v[:, :, [j0 + i for i in order]].transpose(2, 3)
        kh, kl = split(kt)
        if passes == 3:
            s = _three(qh, ql, kh.transpose(2, 3), kl.transpose(2, 3))
        else:
            s = qh @ kh.transpose(2, 3)
        cols = j0 + torch.arange(bk)
        keep = cols[None, :] < kv_len
        if causal:
            keep = keep & (cols[None, :] <= rows[:, None])
        s = s.masked_fill(~keep, -math.inf)
        mnew = torch.maximum(m, s.amax(-1, keepdim=True) * sl2)
        base = torch.where(mnew == -math.inf, torch.zeros_like(mnew), mnew)
        alpha = torch.exp2(m - base)
        p = torch.exp2(s * sl2 - base)
        l = l * alpha + p.sum(-1, keepdim=True)
        m = mnew
        pa = p[..., order]
        ph, pl = split(pa)
        vh, vl = split(vt.transpose(2, 3))
        part = _three(ph, pl, vh, vl) if passes == 3 else ph @ vh
        acc = acc * alpha + part
    o = acc / torch.where(l > 0, l, torch.ones_like(l))
    lse = torch.where(l > 0, m * math.log(2.0) + torch.log(l),
                      torch.full_like(l, -math.inf))[..., 0]
    return o, lse


def _inputs(seed, B, H, Tq, Tkv, D):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, t, D).astype(np.float32) for t in (Tq, Tkv, Tkv)]


def _pallas(q, k, v, causal, q_offset, kv_len):
    """The JAX package's o (flash_attention_fused, or flash_chunk_attention
    for the chunk form) and lse (_flash_fwd) in interpret mode."""
    q, k, v = map(jnp.asarray, (q, k, v))
    D = q.shape[-1]
    if q_offset or kv_len is not None:
        o = jfa.flash_chunk_attention(q, k, v, q_offset, kv_len,
                                      block_q=128, block_k=128,
                                      interpret=True)
    else:
        o = jfa.flash_attention_fused(q, k, v, causal, block_q=128,
                                      block_k=128, interpret=True)
    _, lse = jfa._flash_fwd(q, k, v, causal or bool(q_offset),
                            1.0 / math.sqrt(D), 128, 128, True,
                            q_offset=q_offset, kv_len=kv_len)
    return np.asarray(o), np.asarray(lse)


def _errs(got, want):
    (o, lse), (jo, jl) = got, want
    jo, jl = torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jl))
    oerr = float((o - jo).abs().max()) / max(float(jo.abs().max()), 1e-6)
    fin = torch.isfinite(jl)
    assert torch.equal(torch.isfinite(lse), fin)
    lerr = float((lse[fin] - jl[fin]).abs().max()) if fin.any() else 0.0
    return oerr, lerr


CASES = [
    # B, H, Tq, Tkv, D, causal, q_offset, kv_len
    (2, 2, 77, 77, 64, True, 0, None),        # ragged T, causal
    (1, 2, 96, 130, 64, False, 0, None),      # non-causal, Tq != Tkv
    (1, 2, 32, 160, 64, True, 96, 128),       # a chunk: q_offset, kv_len
    (1, 2, 40, 40, 16, True, 0, None),
    (1, 2, 70, 70, 96, True, 0, None),        # 32-key tiles past D = 64
    (1, 1, 8, 1024, 64, False, 0, None),      # rows of 1024 keys
]


@pytest.mark.parametrize("B,H,Tq,Tkv,D,causal,q_offset,kv_len", CASES)
def test_flash_3xtf32_model_holds_the_pallas_kernel(B, H, Tq, Tkv, D, causal,
                                                    q_offset, kv_len):
    q, k, v = _inputs(Tq + Tkv + D, B, H, Tq, Tkv, D)
    want = _pallas(q, k, v, causal, q_offset, kv_len)
    got = flash_model(*map(torch.from_numpy, (q, k, v)), causal, q_offset,
                      kv_len)
    oerr, lerr = _errs(got, want)
    assert oerr <= TOL and lerr <= TOL, (oerr, lerr)


def test_one_tf32_pass_misses_the_flash_tolerance():
    """hi hi alone leaves o a few 1e-4 of its largest value off: above
    1e-5, where three passes stay."""
    q, k, v = _inputs(5, 1, 2, 96, 256, 64)
    want = _pallas(q, k, v, False, 0, None)
    t = list(map(torch.from_numpy, (q, k, v)))
    e3 = _errs(flash_model(*t, False), want)
    e1 = _errs(flash_model(*t, False, passes=1), want)
    assert max(e3) <= TOL < 3 * TOL < max(e1), (e3, e1)


def test_vt_pos_is_the_inverse_of_the_fragment_order():
    for k in range(64):
        p = vt_pos(k)
        assert p // 8 == k // 8 and (k & ~7) + PERM[p & 7] == k
    assert sorted(vt_pos(k) for k in range(64)) == list(range(64))


def _acc_regs(s):
    """The m64n8 accumulator of one 8-key slice as wgmma returns it: thread
    t (warp w, g = lane / 4, q = lane % 4) holds d[e] at row 16 w + g + 8
    (e >> 1), column 2 q + (e & 1)."""
    regs = torch.zeros(128, 4, dtype=s.dtype)
    for t in range(128):
        w, g, q = t // 32, (t % 32) // 4, t % 4
        for e in range(4):
            regs[t, e] = s[16 * w + g + 8 * (e >> 1), 2 * q + (e & 1)]
    return regs


def _a_matrix(frag):
    """The 64 x 8 tf32 A operand that register fragments stand for: thread
    t's a[e] at row 16 w + g + 8 (e & 1), column q + 4 (e >> 1)."""
    a = torch.zeros(64, 8, dtype=frag.dtype)
    for t in range(128):
        w, g, q = t // 32, (t % 32) // 4, t % 4
        for e in range(4):
            a[16 * w + g + 8 * (e & 1), q + 4 * (e >> 1)] = frag[t, e]
    return a


def test_accumulator_registers_are_the_a_fragment_of_p_v():
    """The kernel feeds each thread's accumulator registers {d0, d2, d1,
    d3} of an 8-key slice as the A fragment and V^T in vt_pos order as B:
    the product is P V, exactly (integer values). Without the key order,
    or with the registers in their own order, it is not."""
    rng = np.random.RandomState(0)
    p = torch.from_numpy(rng.randint(-8, 9, (64, 8)).astype(np.float64))
    v = torch.from_numpy(rng.randint(-8, 9, (8, 24)).astype(np.float64))
    regs = _acc_regs(p)
    frag = regs[:, [0, 2, 1, 3]]
    vt = torch.zeros(24, 8, dtype=v.dtype)
    for key in range(8):
        vt[:, vt_pos(key)] = v[key]
    want = p @ v
    assert torch.equal(_a_matrix(frag) @ vt.T, want)
    assert not torch.equal(_a_matrix(frag) @ v, want)
    assert not torch.equal(_a_matrix(regs) @ vt.T, want)
