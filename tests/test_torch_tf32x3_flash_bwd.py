"""A torch model of the 3xTF32 numerics of the float32 flash-attention
backward on the tensor cores (``csrc/flash_bwd_tf32_sm90.cu``), held
against the JAX package's Pallas kernel ``_flash_bwd`` run in interpret
mode.

The kernel pair streams tiles of BT rows: 32 up to D = 64; past it the
widest of 32 and 16 rows whose shared memory fits beside the block's 64
raw fixed rows (:func:`tile_rows`: 32 up to D = 128 in the dK/dV kernel
and up to 144 in the dQ kernel, else 16). The dK/dV kernel takes, per
query tile, S^T = K Q^T and dP^T = V dO^T as three tf32 products of the hi
/ lo halves (``tests/test_torch_tf32x3.py``'s ``tf32_rn`` and ``split``)
over the whole head dim up to D = 64 and in 64-column pieces past it, each
piece's sum added in float32; P^T = exp2(S^T scale log2(e) - lse log2(e))
and dS^T = P^T (dP^T - delta) scale in float32, then dV += P^T dO and dK +=
dS^T Q: P^T and dS^T split into hi and lo in registers (the A operand), dO
and Q transposed in shared memory with each group of 8 queries in the
order 0, 2, 4, 6, 1, 3, 5, 7, three products into a fresh register set
that joins the float32 total (the promotion that keeps the tensor cores'
accumulation from drifting over many tiles). The dQ kernel does the same
per key tile: S and dP, dS, dQ += dS K over K^T. Rows and keys past the
ends come in as zeros (TMA); rows past Tq and rows whose lse is -inf get
p = 0. Past D = 64 the two consumer warpgroups of a block share out the
products (one makes P^T and dV, the other dS^T and dK; in the dQ kernel
one P, the other dS, and each half of dQ's columns): that moves no sum,
so the model need not follow it.

The model follows that, and shows at 1e-5 of the largest gradient:

* it holds the Pallas backward for causal and non-causal attention,
  ragged T, D = 16, 48, 64 and every wide tile shape (80, 96, 128, 144,
  192), the external-delta form and T = 1024;
* with the tensor cores' one-way drift (2^-25 of the sum per k8 product,
  as measured on an H100 for the 3xTF32 GEMM core) added to every product,
  whole-D S and dP contractions stay inside the tolerance at D = 64 and
  the 64-column pieces up to D = 192;
* one TF32 pass (hi hi alone) misses it: the reason for three;
* the S^T accumulator's registers {d0, d2, d1, d3} are the A fragment of
  P^T dO against dO^T in that query order, exactly;
* the split's addressing (the TMA's swizzle read back, the transposed
  tiles written in 4 BT-byte-swizzled rows) puts every element of a
  streamed tile once in each of its four tiles, at BT = 32 and 16;
* the wide pair's register A fragments, read from the raw 64-row fixed
  tile as TMA swizzled it, are each element of a k8 slice once, at the
  fragment's row and column.

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
BT = 32             # rows of a streamed tile up to D = 64
DRIFT = 2.0 ** -25  # the tensor cores' accumulation, per k8 product
SMEM_MAX = 232448   # a block's shared memory on an H100 (kSmemMax)


def order(bt):
    """A tile's contraction index in the transposed operands' order
    (vt_pos)."""
    return [(i & ~7) + (0, 2, 4, 6, 1, 3, 5, 7)[i & 7] for i in range(bt)]


ORDER = order(BT)


def wide_smem(D, kv, bt, stages):
    """Shared memory of a wide kernel (``WideCfg``): the alignment slack,
    64 raw fixed rows of two tensors, the split set (8 tiles for dK/dV, 6
    for dQ) and ``stages`` raw stages of two tiles, the statistics and the
    barriers (the 64 x bt hand-over buffer lies over a natural lo tile)."""
    nset = 8 if kv else 6
    return (1024 + 2 * 64 * D * 4 + (nset + 2 * stages) * bt * D * 4
            + (stages + 1) * 2 * bt * 4 + 64)


def tile_rows(D, kv):
    """Rows of the dK/dV kernel's (kv) or the dQ kernel's streamed tile:
    32 up to D = 64, else 32 where the wide kernel's shared memory with
    one raw stage fits, else 16."""
    if D <= 64:
        return BT
    return 32 if wide_smem(D, kv, 32, 1) <= SMEM_MAX else 16


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

    def over_d(ah, al, bh, bl):
        """S or dP: the whole head dim in one sum up to D = 64, else a
        fresh sum per 64 columns added in float32."""
        if D <= 64:
            return prod3(ah, al, bh, bl, D)
        out = None
        for c in range(0, D, 64):
            piece = prod3(ah[..., c:c + 64], al[..., c:c + 64],
                          bh[..., c:c + 64, :], bl[..., c:c + 64, :],
                          min(64, D - c))
            out = piece if out is None else out + piece
        return out

    T = lambda t: t.transpose(-1, -2)
    qi, ki = torch.arange(nq), torch.arange(nk)
    # the dK/dV kernel: query tiles
    bt = tile_rows(D, True)
    dk = torch.zeros(B, H, nk, D)
    dv = torch.zeros(B, H, nk, D)
    for q0 in range(0, nq, bt):
        s = slice(q0, q0 + bt)
        st = over_d(kh, kl, T(qh[:, :, s]), T(ql[:, :, s]))
        dpt = over_d(vh, vl, T(doh[:, :, s]), T(dol[:, :, s]))
        p = torch.exp2(st * sl2 - lse2[:, :, None, s])
        if causal:
            p = torch.where(ki[:, None] > qi[None, s], torch.zeros_like(p), p)
        ds = p * (dpt - delta[:, :, None, s]) * scale
        rows = [q0 + i for i in order(bt)]
        ph, pl = split(p[..., order(bt)].contiguous())
        dv = dv + prod3(ph, pl, doh[:, :, rows], dol[:, :, rows], bt)
        sh, sl = split(ds[..., order(bt)].contiguous())
        dk = dk + prod3(sh, sl, qh[:, :, rows], ql[:, :, rows], bt)
    # the dQ kernel: key tiles
    bt = tile_rows(D, False)
    dq = torch.zeros(B, H, nq, D)
    for k0 in range(0, nk, bt):
        s = slice(k0, k0 + bt)
        sc = over_d(qh, ql, T(kh[:, :, s]), T(kl[:, :, s]))
        dp = over_d(doh, dol, T(vh[:, :, s]), T(vl[:, :, s]))
        p = torch.exp2(sc * sl2 - lse2[..., None])
        gone = ki[None, s] >= Tkv
        if causal:
            gone = gone | (ki[None, s] > qi[:, None])
        p = torch.where(gone, torch.zeros_like(p), p)
        ds = p * (dp - delta[..., None]) * scale
        cols = [k0 + i for i in order(bt)]
        sh, sl = split(ds[..., order(bt)].contiguous())
        dq = dq + prod3(sh, sl, kh[:, :, cols], kl[:, :, cols], bt)
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
    # the wide pair: 32-row tiles both ways (80, 96, 128), 16 in dK/dV and
    # 32 in dQ (144), 16 both ways (192); ragged T past one 64-row block
    (1, 2, 77, 80, True),
    (1, 2, 77, 80, False),
    (1, 2, 100, 96, True),
    (2, 1, 77, 128, True),
    (2, 1, 77, 128, False),
    (1, 2, 130, 144, True),
    (1, 2, 45, 144, False),
    (1, 1, 100, 192, True),
    (1, 1, 100, 192, False),
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


@pytest.mark.parametrize("D", [64, 112, 128, 192])
def test_whole_head_dim_contractions_hold_with_the_drift(D):
    """S and dP contract over the whole head dim into one accumulator up
    to D = 64 (24 products) and in 64-column pieces past it (24 products
    each, the pieces added in float32): with every product grown one way
    by 2^-25 per k8 product, the gradients stay within 1e-5."""
    case = _case(D, 1, 2, 256, D, True)
    want = _pallas_bwd(*case[:4], *case[4:], True)
    assert _rel(_model(case, True, drift=True), want) <= TOL


def test_one_tf32_pass_misses_the_flash_bwd_tolerance():
    case = _case(9, 1, 2, 256, 64, True)
    want = _pallas_bwd(*case[:4], *case[4:], True)
    e3 = _rel(_model(case, True), want)
    e1 = _rel(_model(case, True, passes=1), want)
    assert e3 <= TOL < 3 * TOL < e1, (e3, e1)


@pytest.mark.parametrize("D", [128, 192])
def test_one_tf32_pass_misses_the_wide_flash_bwd_tolerance(D):
    """The wide pair's tile shapes (64-column pieces; 16-row tiles at D =
    192): three products hold 1e-5, one misses it."""
    case = _case(9 + D, 1, 2, 256, D, True)
    want = _pallas_bwd(*case[:4], *case[4:], True)
    e3 = _rel(_model(case, True), want)
    e1 = _rel(_model(case, True, passes=1), want)
    assert e3 <= TOL < 3 * TOL < e1, (e3, e1)


@pytest.mark.parametrize("D,kv,bt,stages", [
    (80, True, 32, 2), (96, True, 32, 2), (112, True, 32, 2),
    (128, True, 32, 1), (176, True, 16, 2), (192, True, 16, 1),
    (128, False, 32, 2), (144, False, 32, 1), (160, False, 16, 2),
    (192, False, 16, 2)])
def test_wide_tiles_are_the_widest_that_fit_a_block(D, kv, bt, stages):
    """The streamed tile and the raw stages of each wide kernel: the
    widest tile, then the most stages, whose shared memory fits 227 KB."""
    assert tile_rows(D, kv) == bt
    assert wide_smem(D, kv, bt, stages) <= SMEM_MAX
    if stages == 1:
        assert wide_smem(D, kv, bt, 2) > SMEM_MAX
    if bt == 16:
        assert wide_smem(D, kv, 32, 1) > SMEM_MAX


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


def _swz_f32(r, c, sw):
    """swz_f32<SW>: float32 column c of row r of an SW-byte-swizzled tile
    (the 16-byte unit XORed with the row's bits above it)."""
    off = r * sw + 4 * c
    return off ^ ((off >> 3) & {128: 0x70, 64: 0x30, 32: 0x10}[sw])


def _raw_tile(rows, D, sw):
    """byte offset -> (row, column) of a raw tile of ``rows`` D-wide rows
    as TMA lays it out: chunks of sw / 4 columns, rows * sw bytes apart,
    each row's 16-byte units swizzled (swz_unit)."""
    upr = sw // 16
    raw = {}
    for r in range(rows):
        for c in range(D):
            cu = c // 4
            off = ((cu // upr) * rows * sw + _swz_unit(r, cu % upr, sw)
                   + 4 * (c % 4))
            raw[off] = (r, c)
    assert len(raw) == rows * D and max(raw) < rows * D * 4
    return raw


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


@pytest.mark.parametrize("D,bt", [(80, 32), (96, 32), (112, 32), (128, 32),
                                  (144, 16), (144, 32), (160, 16), (176, 16),
                                  (192, 16)])
def test_wide_split_tile_addressing_covers_every_element_once(D, bt):
    """split_tile at the wide pair's tiles, by one warpgroup (128 threads;
    bt rows; transposed rows of bt floats in a 4 bt-byte swizzle): the
    whole tile (the dK/dV kernel) reads each element of the raw tile once,
    where the TMA's swizzle put it, and writes the transposed tiles' row d,
    column vt_pos(row) once each; the dQ kernel's two column halves (C0 = 0
    and D / 2) write each transposed row once between them, the second
    half starting on the swizzle's 8-row repeat."""
    sw = 128 if (4 * D) % 128 == 0 else 64
    swt = 4 * bt
    upr = sw // 16
    raw = _raw_tile(bt, D, sw)

    def walk(c0, nc):
        natural, trans = set(), {}
        for t in range(128):
            for u in range(t, bt * nc // 4, 128):
                r, cu = u % bt, c0 // 4 + u // bt
                off = (cu // upr) * bt * sw + _swz_unit(r, cu % upr, sw)
                for e in range(4):
                    assert raw[off + 4 * e] == (r, 4 * cu + e)
                    natural.add(off + 4 * e)
                    tp = _swz_f32(4 * cu + e, vt_pos(r), swt)
                    assert tp not in trans and c0 * swt <= tp < (c0 + nc) * swt
                    trans[tp] = (r, 4 * cu + e)
        return natural, trans

    natural, trans = walk(0, D)
    assert len(natural) == len(trans) == bt * D
    for tp, (r, c) in trans.items():
        assert tp // swt == c and (tp % swt) // 16 ^ ((c >> 1) & 3 if swt == 64
                                                      else c & 7) \
            == vt_pos(r) // 4
    lo, hi = walk(0, D // 2)[1], walk(D // 2, D // 2)[1]
    assert not set(lo) & set(hi) and {**lo, **hi} == trans
    assert (D // 2) % 8 == 0


@pytest.mark.parametrize("D", [80, 96, 112, 128, 144, 160, 176, 192])
def test_wide_fixed_fragments_read_every_element_once(D):
    """s_wide's register A fragments of the raw 64-row fixed tile (K, V,
    Q or dO as TMA put it): thread t's register e of k8 slice kk reads row
    16 (t / 32) + (t % 32) / 4 + 8 (e & 1), column 8 kk + t % 4 + 4 (e >>
    1), at byte col / (sw / 4) * 64 sw + swz_f32(row, col % (sw / 4)),
    which is that element; over the slices every element is read once and
    the fragments make the 64 x 8 A operand of each slice."""
    sw = 128 if (4 * D) % 128 == 0 else 64
    raw = _raw_tile(64, D, sw)
    seen = set()
    for kk in range(D // 8):
        frag = torch.zeros(128, 4, dtype=torch.float64)
        for t in range(128):
            frow = 16 * (t // 32) + (t % 32) // 4
            for e in range(4):
                row, col = frow + 8 * (e & 1), 8 * kk + t % 4 + 4 * (e >> 1)
                off = (col // (sw // 4) * 64 * sw
                       + _swz_f32(row, col % (sw // 4), sw))
                assert raw[off] == (row, col) and off not in seen
                seen.add(off)
                frag[t, e] = row * 1000 + col
        want = torch.tensor([[r * 1000 + 8 * kk + c for c in range(8)]
                             for r in range(64)], dtype=torch.float64)
        assert torch.equal(_a_matrix(frag), want)
    assert len(seen) == 64 * D
