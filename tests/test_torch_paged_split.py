"""A torch model of the split-K paged attention kernel
(``csrc/paged_attention_sm90.cu``), held against the JAX package's Pallas
kernel run in interpret mode.

The kernel cuts each row's logical keys into spans (``split_plan``); a
block owns one span of one (batch row, kv head) and the query rows of its
tile. Its 4 warps take the span's KT-key tiles in turn (warp w: tiles w, w +
4, ...), each half warp half of a tile's keys, and each half warp keeps its
own float32 online softmax (m, l, acc), updated once a tile in base 2; the
8 half-warp states merge in a fixed order (acc and l scaled by 2^(m - M)),
and a second kernel merges a row's spans in one pass in split order. A span
that starts past its row's last visible key writes m = -inf, l = 0, acc =
0. The model below follows that partition and order and shows:

* it holds the Pallas kernel at 1e-5 (float32 pages) for decode (S = 1),
  chunked prefill (S = 32), grouped-query heads, a span past a row's end,
  the null-table slot at position 0, and one-span tables; bf16 pages at
  1.6e-2 (the Pallas kernel rounds p to bf16 before P V, the port's
  kernels keep it float32, as its plain version does; one bf16 ulp at
  magnitudes of 2-4);
* ``split_plan`` covers every table with spans of whole 16-key steps,
  between 64 and 256 keys where the table allows, and one span (no
  combine) for tables under 128 keys.

On the card ``chip_smoke.py`` holds the kernels themselves against the
plain version (2e-5 float32, 1.6e-2 bf16) with two launches bit for bit.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigdl_tpu.kernels import paged_attention as jpa
from bigdl_tpu_torch.kernels import paged_attention as pa

torch.set_num_threads(1)
TOL = 1e-5
LOG2E = 1.4426950408889634
WARPS = 4


def tile_keys(d, esz):
    """Keys of one ring tile (``PagedCfg::KT``): a K tile of at most 4 KB,
    16 keys at most."""
    row = d * esz
    return 16 if row <= 256 else 8 if row <= 512 else 4


def _online(state, s, v):
    """One tile of an online softmax in base 2: s (rows, keys) already
    scaled by log2(e) / sqrt(D), -inf where masked; v (keys, D)."""
    m, l, acc = state
    mnew = torch.maximum(m, s.amax(-1, keepdim=True))
    base = torch.where(mnew == -math.inf, torch.zeros_like(mnew), mnew)
    alpha = torch.exp2(m - base)
    p = torch.exp2(s - base)
    return mnew, l * alpha + p.sum(-1, keepdim=True), acc * alpha + p @ v


def _merge(states):
    """Merge (m, l, acc) states in the given order (the kernels' fixed
    order): scale by 2^(m - M), a state with m = -inf weighing 0."""
    M = torch.stack([m for m, _, _ in states]).amax(0)
    L = torch.zeros_like(states[0][1])
    A = torch.zeros_like(states[0][2])
    for m, l, acc in states:
        w = torch.where(m == -math.inf, torch.zeros_like(m), torch.exp2(m - M))
        L = L + w * l
        A = A + w * acc
    return M, L, A


def _combine(parts):
    """The combine kernel's merge of a row's splits: one pass in split
    order, acc and l rescaled as the running maximum moves."""
    M = torch.full_like(parts[0][0], -math.inf)
    L = torch.zeros_like(parts[0][1])
    A = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        mn = torch.maximum(M, m)
        base = torch.where(mn == -math.inf, torch.zeros_like(mn), mn)
        a, w = torch.exp2(M - base), torch.exp2(m - base)
        L, A, M = L * a + w * l, A * a + w * acc, mn
    return M, L, A


def split_model(q, kp, vp, tables, pos, splits, span):
    """o (B, nH, S, D) of the split-K kernel for float32 q and pages (the
    bf16 route widens its pages to float32 in registers)."""
    B, nH, S, D = q.shape
    kvH, bs = kp.shape[1], kp.shape[2]
    G = nH // kvH
    kt = tile_keys(D, kp.element_size())
    sl2 = LOG2E / math.sqrt(D)
    out = torch.zeros(B, kvH, G * S, D)
    for b in range(B):
        n_valid = min(int(pos[b]) + S, tables.shape[1] * bs)
        # the logical (B, T) view of the row's keys, through its table
        kg = kp[tables[b].long()].transpose(0, 1).reshape(kvH, -1, D).float()
        vg = vp[tables[b].long()].transpose(0, 1).reshape(kvH, -1, D).float()
        rows = torch.arange(G * S)
        lim = int(pos[b]) + rows % S          # the last key a row sees
        for h in range(kvH):
            qh = q[b].reshape(kvH, G * S, D)[h].float()
            parts = []
            for i in range(splits):
                kbeg, kend = i * span, min((i + 1) * span, n_valid)
                empty = (torch.full((G * S, 1), -math.inf),
                         torch.zeros(G * S, 1), torch.zeros(G * S, D))
                if kbeg >= kend:
                    parts.append(empty)
                    continue
                halves = []
                ntiles = -(-(kend - kbeg) // kt)
                for w in range(WARPS):
                    hs = [empty, empty]
                    for t in range(w, ntiles, WARPS):
                        for half in range(2):
                            k0 = kbeg + t * kt + half * (kt // 2)
                            keys = torch.arange(k0, k0 + kt // 2)
                            ok = keys < kend
                            ks = kg[h][keys.clamp(max=kg.shape[1] - 1)]
                            vs = vg[h][keys.clamp(max=vg.shape[1] - 1)]
                            ks = ks * ok[:, None]
                            vs = vs * ok[:, None]
                            s = (qh @ ks.T) * sl2
                            vis = (keys[None, :] <= torch.minimum(
                                lim, torch.tensor(kend - 1))[:, None])
                            s = s.masked_fill(~vis, -math.inf)
                            hs[half] = _online(hs[half], s, vs)
                    halves += hs
                parts.append(_merge(halves))
            _, L, A = _combine(parts) if splits > 1 else parts[0]
            out[b, h] = torch.where(L > 0, A / torch.where(
                L > 0, L, torch.ones_like(L)), torch.zeros_like(A))
    return out.reshape(B, nH, S, D)


def _inputs(seed, B, nH, kvH, S, D, bs, nblk, null_row, pos_hi=None):
    rng = np.random.RandomState(seed)
    NB = 1 + B * nblk
    kp = rng.randn(NB, kvH, bs, D).astype(np.float32)
    vp = rng.randn(NB, kvH, bs, D).astype(np.float32)
    tables = np.zeros((B, nblk), np.int32)
    for b in range(B):
        tables[b] = rng.permutation(np.arange(1, NB))[:nblk]
    hi = nblk * bs - S if pos_hi is None else pos_hi
    pos = rng.randint(0, hi + 1, size=B).astype(np.int32)
    if null_row:    # a padded decode slot: the null table at position 0
        tables[-1] = 0
        pos[-1] = 0
    q = rng.randn(B, nH, S, D).astype(np.float32)
    return q, kp, vp, tables, pos


def _pallas(q, kp, vp, tables, pos):
    return np.array(jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(pos), interpret=True)
        .astype(jnp.float32))


CASES = [
    # B, nH, kvH, S, D, bs, nblk, null_row, sms, pos_hi
    (4, 4, 4, 1, 64, 16, 12, True, 132, None),     # decode, several spans
    (3, 8, 2, 1, 16, 8, 24, True, 132, 40),        # GQA; spans past rows' ends
    (1, 4, 4, 32, 16, 16, 12, False, 132, None),   # chunked prefill, S = 32
    (2, 8, 2, 32, 32, 16, 8, True, 132, None),     # GQA chunk + padded slot
    (2, 4, 4, 1, 64, 16, 4, False, 132, None),     # a one-span table
    (2, 4, 2, 5, 144, 4, 40, True, 40, None),      # 2 rows a block past 128
]


@pytest.mark.parametrize("B,nH,kvH,S,D,bs,nblk,null_row,sms,pos_hi", CASES)
def test_split_model_holds_the_pallas_kernel(B, nH, kvH, S, D, bs, nblk,
                                             null_row, sms, pos_hi):
    q, kp, vp, tables, pos = _inputs(B * 7 + S + D, B, nH, kvH, S, D, bs,
                                     nblk, null_row, pos_hi)
    splits, span = pa.split_plan(B, kvH, nH // kvH * S, nblk * bs, D, sms)
    if nblk * bs > 64:
        assert splits > 1
    if pos_hi is not None:     # some span starts past a row's last key
        assert (splits - 1) * span > pos.min() + S - 1
    got = split_model(*map(torch.from_numpy, (q, kp, vp, tables, pos)),
                      splits, span)
    want = torch.from_numpy(_pallas(q, kp, vp, tables, pos))
    err = float((got - want).abs().max()) / max(float(want.abs().max()), 1.0)
    assert err <= TOL, err
    # the model is the function the wrapper's plain version computes
    ref = pa.paged_attention_reference(
        *map(torch.from_numpy, (q, kp, vp, tables, pos)))
    assert float((got - ref).abs().max()) <= TOL * max(
        float(ref.abs().max()), 1.0)


@pytest.mark.parametrize("kvH,S", [(4, 1), (2, 32)])
def test_split_model_bf16_pages(kvH, S):
    q, kp, vp, tables, pos = _inputs(11 + S, 2, 4, kvH, S, 32, 16, 10, True)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    qb, kb, vb = bf(q), bf(kp), bf(vp)
    splits, span = pa.split_plan(2, kvH, 4 // kvH * S, 160, 32, 132)
    assert splits > 1
    got = split_model(qb, kb, vb, torch.from_numpy(tables),
                      torch.from_numpy(pos), splits, span)
    got = got.to(torch.bfloat16).float()       # o in the page dtype
    f = lambda t: t.float().numpy()
    want = torch.from_numpy(_pallas(f(qb), f(kb), f(vb), tables, pos))
    assert float((got - want).abs().max()) <= 1.6e-2


@pytest.mark.parametrize("B,kvH,rows,keys,d", [
    (8, 16, 1, 336, 64), (8, 16, 1, 4112, 64), (1, 16, 32, 352, 64),
    (8, 16, 1, 384, 64), (8, 4, 4, 336, 64), (1, 1, 1, 16, 256),
    (8, 16, 1, 64, 64), (64, 32, 1, 100000, 128), (2, 2, 128, 48, 256)])
def test_split_plan_covers_the_table(B, kvH, rows, keys, d):
    splits, span = pa.split_plan(B, kvH, rows, keys, d, 132)
    assert span % 16 == 0 and splits >= 1
    assert (splits - 1) * span < keys <= splits * span
    assert span <= 256 and (span >= 64 or keys < 64)
    if keys < 128:
        assert splits == 1


def test_split_plan_at_the_smoke_shapes():
    """The decode step of the smoke's serving (bucket 8, 16 heads, 24
    blocks of 16) takes 3 spans, its decode case (21 blocks) 3, its long
    case 17, the chunk case 5; a 4-block table one span, which launches no
    combine."""
    assert pa.split_plan(8, 16, 1, 24 * 16, 64, 132) == (3, 128)
    assert pa.split_plan(8, 16, 1, 21 * 16, 64, 132) == (3, 112)
    assert pa.split_plan(8, 16, 1, 257 * 16, 64, 132) == (17, 256)
    assert pa.split_plan(8, 16, 1, 4 * 16, 64, 132) == (1, 64)
    assert pa.split_plan(1, 16, 32, 22 * 16, 64, 132) == (5, 80)
    assert [pa.rows_per_block(d) for d in (64, 80, 128, 144, 256)] == [
        8, 4, 4, 2, 2]
