"""A torch model of the 3xTF32 numerics of the float32 flash-attention
backward on the tensor cores (``csrc/flash_bwd_tf32_sm90.cu``), held
against the JAX package's Pallas kernel ``_flash_bwd`` run in interpret
mode.

The kernel pair streams 32-row tiles. The dK/dV kernel takes, per query
tile, S^T = K Q^T and dP^T = V dO^T as three tf32 products of the hi / lo
halves over the whole head dim (``tests/test_torch_tf32x3.py``'s
``tf32_rn`` and ``split``), P^T = exp2(S^T scale log2(e) - lse log2(e)) and
dS^T = P^T (dP^T - delta) scale in float32, then dV += P^T dO and dK +=
dS^T Q: P^T and dS^T split into hi and lo in registers (the A operand), dO
and Q transposed in shared memory with each group of 8 queries in the
order 0, 2, 4, 6, 1, 3, 5, 7, three products into a fresh register set
that joins the float32 total (the promotion that keeps the tensor cores'
accumulation from drifting over many tiles). The dQ kernel does the same
per key tile: S and dP, dS, dQ += dS K over K^T. Rows and keys past the
ends come in as zeros (TMA); rows past Tq and rows whose lse is -inf get
p = 0.

The model follows that, and shows at 1e-5 of the largest gradient:

* it holds the Pallas backward for causal and non-causal attention,
  ragged T, D = 16, 64 and 96, the external-delta form and T = 1024;
* with the tensor cores' one-way drift (2^-25 of the sum per k8 product,
  as measured on an H100 for the 3xTF32 GEMM core) added to every product,
  whole-D S and dP contractions stay inside the tolerance up to D = 112,
  so they need no 32-deep promotion;
* one TF32 pass (hi hi alone) misses it: the reason for three;
* the S^T accumulator's registers {d0, d2, d1, d3} are the A fragment of
  P^T dO against dO^T in that query order, exactly;
* the split kernel's addressing (the TMA's swizzle read back, the
  transposed tiles written in 128-byte-swizzled rows) puts every element
  of a streamed tile once in each of its four tiles.

On the card ``chip_smoke.py`` holds the kernels themselves against the
plain float32 version (1e-4 of the largest gradient) with two launches bit
for bit.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigdl_tpu.kernels import flash_attention as jfa
from test_torch_tf32x3 import split
from test_torch_tf32x3_flash import _a_matrix, _acc_regs, vt_pos

torch.set_num_threads(1)
TOL = 1e-5
LOG2E = 1.4426950408889634
BT = 32             # rows of a streamed tile
DRIFT = 2.0 ** -25  # the tensor cores' accumulation, per k8 product
# a tile's contraction index in the transposed operands' order (vt_pos)
ORDER = [(i & ~7) + (0, 2, 4, 6, 1, 3, 5, 7)[i & 7] for i in range(BT)]


def _pad(t, n, value=0.0):
    """t padded along dim 2 to n rows (the TMA's zeros past the end)."""
    tail = (0, 0) if t.dim() == 4 else ()
    return torch.nn.functional.pad(t, tail + (0, n - t.shape[2]), value=value)


def bwd_model(q, k, v, o, lse, do, causal, delta=None, passes=3,
              drift=False):
    """(dq, dk, dv) of the 3xTF32 kernel pair (passes=3) or of one TF32
    pass (hi hi alone, passes=1); with ``drift`` every product also grows
    by 2^-25 of itself per k8 product it took, all one way."""
    B, H, Tq, D = q.shape
    Tkv = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    sl2 = scale * LOG2E
    if delta is None:
        delta = (do * o).sum(-1)
    nq, nk = -(-Tq // BT) * BT, -(-Tkv // BT) * BT
    q, do = _pad(q, nq), _pad(do, nq)
    k, v = _pad(k, nk), _pad(v, nk)
    lse2 = torch.where(lse == -math.inf, torch.full_like(lse, math.inf),
                       lse * LOG2E)
    lse2 = _pad(lse2, nq, math.inf)
    delta = _pad(delta, nq)
    halves = [split(t) for t in (q, k, v, do)]
    (qh, ql), (kh, kl), (vh, vl), (doh, dol) = halves

    def prod3(ah, al, bh, bl, depth):
        out = al @ bh + ah @ bl + ah @ bh if passes == 3 else ah @ bh
        return out * (1 + 3 * (depth // 8) * DRIFT) if drift else out

    T = lambda t: t.transpose(-1, -2)
    qi, ki = torch.arange(nq), torch.arange(nk)
    # the dK/dV kernel: query tiles
    dk = torch.zeros(B, H, nk, D)
    dv = torch.zeros(B, H, nk, D)
    for q0 in range(0, nq, BT):
        s = slice(q0, q0 + BT)
        st = prod3(kh, kl, T(qh[:, :, s]), T(ql[:, :, s]), D)
        dpt = prod3(vh, vl, T(doh[:, :, s]), T(dol[:, :, s]), D)
        p = torch.exp2(st * sl2 - lse2[:, :, None, s])
        if causal:
            p = torch.where(ki[:, None] > qi[None, s], torch.zeros_like(p), p)
        ds = p * (dpt - delta[:, :, None, s]) * scale
        rows = [q0 + i for i in ORDER]
        ph, pl = split(p[..., ORDER].contiguous())
        dv = dv + prod3(ph, pl, doh[:, :, rows], dol[:, :, rows], BT)
        sh, sl = split(ds[..., ORDER].contiguous())
        dk = dk + prod3(sh, sl, qh[:, :, rows], ql[:, :, rows], BT)
    # the dQ kernel: key tiles
    dq = torch.zeros(B, H, nq, D)
    for k0 in range(0, nk, BT):
        s = slice(k0, k0 + BT)
        sc = prod3(qh, ql, T(kh[:, :, s]), T(kl[:, :, s]), D)
        dp = prod3(doh, dol, T(vh[:, :, s]), T(vl[:, :, s]), D)
        p = torch.exp2(sc * sl2 - lse2[..., None])
        gone = ki[None, s] >= Tkv
        if causal:
            gone = gone | (ki[None, s] > qi[:, None])
        p = torch.where(gone, torch.zeros_like(p), p)
        ds = p * (dp - delta[..., None]) * scale
        cols = [k0 + i for i in ORDER]
        sh, sl = split(ds[..., ORDER].contiguous())
        dq = dq + prod3(sh, sl, kh[:, :, cols], kl[:, :, cols], BT)
    return dq[:, :, :Tq], dk[:, :, :Tkv], dv[:, :, :Tkv]


def _case(seed, B, H, T, D, causal):
    """q, k, v, dO (numpy) and the Pallas forward's o and lse."""
    rng = np.random.RandomState(seed)
    q, k, v, do = [rng.randn(B, H, T, D).astype(np.float32)
                   for _ in range(4)]
    o, lse = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal, 1.0 / math.sqrt(D), 128, 128, True)
    return q, k, v, do, np.array(o), np.array(lse)


def _pallas_bwd(q, k, v, do, o, lse, causal, delta=None):
    D = q.shape[-1]
    res = tuple(map(jnp.asarray, (q, k, v, o, lse)))
    kw = {} if delta is None else dict(delta=jnp.asarray(delta),
                                       out_dtype=jnp.float32)
    return [np.array(g) for g in jfa._flash_bwd(
        causal, 1.0 / math.sqrt(D), 128, 128, True, res, jnp.asarray(do),
        **kw)]


def _rel(got, want):
    """The largest |got - want| of dq, dk, dv, each over its largest
    |want|."""
    return max(float((g - torch.from_numpy(w)).abs().max())
               / max(float(np.abs(w).max()), 1e-6)
               for g, w in zip(got, want))


def _model(case, causal, **kw):
    q, k, v, do, o, lse = map(torch.from_numpy, case)
    return bwd_model(q, k, v, o, lse, do, causal, **kw)


CASES = [
    # B, H, T, D, causal
    (2, 2, 77, 64, True),      # ragged T, causal
    (2, 2, 77, 64, False),     # non-causal
    (1, 2, 200, 16, True),     # two Pallas blocks, D = 16
    (1, 2, 130, 96, False),    # D = 96
    (1, 2, 45, 48, True),
    (1, 1, 1024, 64, True),    # rows of 1024 keys
]


@pytest.mark.parametrize("B,H,T,D,causal", CASES)
def test_flash_bwd_3xtf32_model_holds_the_pallas_kernel(B, H, T, D, causal):
    case = _case(T + D, B, H, T, D, causal)
    want = _pallas_bwd(*case[:4], *case[4:], causal)
    err = _rel(_model(case, causal), want)
    assert err <= TOL, err


def test_external_delta_float32_out():
    """The ring form: delta passed in (here rowsum(dO O) computed apart),
    float32 gradients; a zero delta moves dq, so the one passed is used."""
    case = _case(3, 2, 2, 100, 64, True)
    q, k, v, do, o, lse = case
    delta = (do.astype(np.float64) * o).sum(-1).astype(np.float32)
    want = _pallas_bwd(q, k, v, do, o, lse, True, delta=delta)
    got = _model(case, True, delta=torch.from_numpy(delta))
    assert _rel(got, want) <= TOL
    zero = _model(case, True, delta=torch.zeros(2, 2, 100))
    assert _rel(zero, want) > 100 * TOL


@pytest.mark.parametrize("D", [64, 112])
def test_whole_head_dim_contractions_hold_with_the_drift(D):
    """S and dP contract over the whole head dim into one accumulator (the
    kernel takes D up to 64; 112 is the 3xTF32 forward's widest): with
    every product grown one way by 2^-25 per k8 product, the gradients
    stay within 1e-5."""
    case = _case(D, 1, 2, 256, D, True)
    want = _pallas_bwd(*case[:4], *case[4:], True)
    assert _rel(_model(case, True, drift=True), want) <= TOL


def test_one_tf32_pass_misses_the_flash_bwd_tolerance():
    case = _case(9, 1, 2, 256, 64, True)
    want = _pallas_bwd(*case[:4], *case[4:], True)
    e3 = _rel(_model(case, True), want)
    e1 = _rel(_model(case, True, passes=1), want)
    assert e3 <= TOL < 3 * TOL < e1, (e3, e1)


def test_s_transpose_registers_are_the_a_fragment_of_p_transpose_do():
    """The dK/dV kernel feeds each thread's S^T accumulator registers
    {d0, d2, d1, d3} of an 8-query slice as the A fragment and dO^T (D
    rows of the tile's 32 queries, in vt_pos order) as B: over the tile's
    four slices the product is P^T dO, exactly (integer values)."""
    rng = np.random.RandomState(1)
    pt = torch.from_numpy(rng.randint(-8, 9, (64, BT)).astype(np.float64))
    do = torch.from_numpy(rng.randint(-8, 9, (BT, 24)).astype(np.float64))
    dot = torch.zeros(24, BT, dtype=do.dtype)      # dO^T as the kernel holds it
    for qq in range(BT):
        dot[:, vt_pos(qq)] = do[qq]
    got = torch.zeros(64, 24, dtype=do.dtype)
    for kk in range(BT // 8):
        regs = _acc_regs(pt[:, 8 * kk:8 * kk + 8])
        frag = regs[:, [0, 2, 1, 3]]
        got += _a_matrix(frag) @ dot[:, 8 * kk:8 * kk + 8].T
    assert torch.equal(got, pt @ do)


def _swz_unit(r, u, sw):
    """swz_unit<SW>: the TMA's swizzle of 16-byte unit u of row r."""
    x = (r & 7) if sw == 128 else ((r >> 1) & 3)
    return r * sw + ((u ^ x) << 4)


def _swz4(r, c):
    """swz4: float32 column c of row r of a 128-byte-swizzled tile."""
    return r * 128 + (((c >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2)


@pytest.mark.parametrize("D", [16, 32, 48, 64])
def test_split_tile_addressing_covers_every_element_once(D):
    """split_tile's loop (unit u: row u % 32, column unit u / 32) reads
    each element of a raw tile once, where the TMA's swizzle put it, and
    writes the transposed tiles' row d, column vt_pos(row) once each."""
    sw = 128 if (4 * D) % 128 == 0 else 64
    upr = sw // 16
    raw = {}                            # byte offset -> (row, column)
    for r in range(BT):
        for c in range(D):
            cu = c // 4
            off = (cu // upr) * BT * sw + _swz_unit(r, cu % upr, sw) + 4 * (c % 4)
            raw[off] = (r, c)
    assert len(raw) == BT * D and max(raw) < BT * D * 4
    natural, trans = set(), {}
    for ct in range(256):
        for u in range(ct, BT * D // 4, 256):
            r, cu = u % BT, u // BT
            off = (cu // upr) * BT * sw + _swz_unit(r, cu % upr, sw)
            for e in range(4):
                assert raw[off + 4 * e] == (r, 4 * cu + e)
                natural.add(off + 4 * e)
                t = _swz4(4 * cu + e, vt_pos(r))
                assert t not in trans and t < D * 128
                trans[t] = (r, 4 * cu + e)
    assert len(natural) == len(trans) == BT * D
    # row d of the transposed tile holds column d of the raw rows, row r
    # at position vt_pos(r)
    for t, (r, c) in trans.items():
        assert t // 128 == c and _swz4(c, vt_pos(r)) == t
