"""The int8 contraction (int8 x int8 -> int32, and the quantized layers'
rescale and bias after it): the CUDA kernel and its plain versions.

Replaces no Pallas kernel: the JAX package leaves its int8 contractions to
XLA (``bigdl_tpu/quantization/quantize.py:89`` ``lax.dot_general(...,
preferred_element_type=int32)``, and ``lax.conv_general_dilated`` over int8
at ``:136`` and ``:190``), and XLA fuses the float32 rescale and bias that
follow into them. No PyTorch op computes them on a CUDA device
(``torch.matmul`` and ``F.conv2d`` refuse int8 and int32 tensors,
``torch._int_mm`` takes only some shapes), so the card runs the
hand-written tensor-core GEMM ``csrc/int8_gemm_sm90.cu``: C[g] (M x N) =
A[g] (M x K, int8) . B[g] (N x K, int8)^T over G groups, in int32, or with
a per-column ``scale`` and an optional ``bias`` as float32 ``float32(acc) *
scale[n] + bias[n]``, bit for bit torch's ``acc.to(float32) * scale +
bias``. Its header note says what bounds it on an H100 and what the design
does about it.

:func:`int8_matmul` (a . b^T) and :func:`int8_conv2d` (an NCHW
convolution) are the wrappers: tensors on the CPU take
:func:`int8_matmul_reference` / :func:`int8_conv2d_reference`, exact int32
products in plain PyTorch, then ``.to(float32) * scale + bias`` where
given; tensors on a CUDA device launch the kernel or raise.
:func:`int8_conv2d` forms A on the card as an int8 im2col of its own (the
padded input viewed through strides, one copy; ``F.unfold`` refuses int8),
rows (b, y, x) and columns (channel, ky, kx), so group g's columns are one
contiguous run: a grouped or depthwise convolution is one launch over G
groups. TMA, which loads the kernel's tiles, needs row strides that are
multiples of 16 bytes: the im2col writes each group's columns padded to a
multiple of 16 (the padding is never read: the kernel's K stays the
group's), and the weights get the same padded stride (a small copy a
call). :func:`int8_matmul` copies an operand to a padded stride only where
K is not a multiple of 16 or the operand does not start on a 16-byte
boundary.

:func:`plan` is the kernel's launch plan (its tile width, K split, grid
and workspace), a plain function so that it can be read and tested off the
card. Each wrapper counts its launches (``.launches``) and, by the plan,
``.launches_by_route``: ``"tiles"`` (one part a tile) or ``"split_k"`` (K
split, the parts summed by the last to finish).

The sums are exact in int32 while K * 128 * 128 < 2^31 (K <= 131071, which
holds -128 too; JAX's operands, clipped to +-127, would allow K < 133,152):
both wrappers refuse a larger K.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build, _flops

_FN = ("int8_gemm_sm90", "bigdl_int8_gemm")
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
             + [ctypes.c_longlong] * 7 + [ctypes.c_int] * 3
             + [ctypes.c_void_p])
MAX_K = (2**31 - 1) // (128 * 128)
_ROUTES = ("tiles", "split_k")
TILE_M = 128                        # rows of a tile: two warpgroups of 64
TILE_K = 128                        # K of one pipeline stage (128 bytes)
TILE_NS = (16, 32, 64, 128, 256)    # the kernel's tile widths
SMS = 132                           # an H100 SXM's SMs (the default card)


class Plan(NamedTuple):
    """How the kernel covers one call: ``tiles`` output tiles of
    ``tile_m`` x ``tile_n`` (over all groups), K in ``steps`` stages of
    ``TILE_K`` split into ``splits`` parts a tile (part p takes steps
    [p steps // splits, (p + 1) steps // splits)), ``grid`` persistent
    blocks, and ``workspace_bytes`` of int32 partial tiles (tiles x
    splits x tile_m x tile_n x 4 where K is split, else 0)."""
    tile_m: int
    tile_n: int
    splits: int
    tiles: int
    steps: int
    grid: int
    workspace_bytes: int


# The plan's cost model, microseconds of one launch: T0 + W (sp (A + B
# tile_n) + C + D tile_n) + [splits > 1] (E + F tile_n (splits - 1)), with
# W = ceil(tiles splits / SMs) waves of work items and sp = ceil(steps /
# splits) K steps a part. Fitted (least squares on relative error) to every
# plan's time at the int8 Inception v1 B32/224 contractions and phase 21
# (a)'s shapes, tools/torch_int8_gemm_sweep.py on an NVIDIA H100 80GB HBM3
# at 700 W; within 7% on average of those readings.
_COST = dict(T0=2.65, A=0.2178, B=0.00109, C=0.5514, D=0.03675, E=2.161,
             F=0.00382)


def plan_us(tile_n, splits, tiles, steps, sms=SMS):
    """The cost model's microseconds for one plan (see ``_COST``)."""
    c = _COST
    waves = -(-tiles * splits // sms)
    per_part = -(-steps // splits)
    t = c["T0"] + waves * (per_part * (c["A"] + c["B"] * tile_n) + c["C"]
                           + c["D"] * tile_n)
    if splits > 1:
        t += c["E"] + c["F"] * tile_n * (splits - 1)
    return t


@functools.lru_cache(maxsize=4096)
def plan(G, M, N, K, sms=SMS) -> Plan:
    """The launch plan of a (G, M, N, K) contraction on a card of ``sms``
    SMs: the tile width and K split of least ``plan_us`` among the widths
    of ``TILE_NS`` up to the narrowest that holds N (any width for N >
    256) and the splits that keep a split plan in one wave (tiles x splits
    <= sms, at most one part a K step); the first on a tie, widths from
    the narrowest, splits from 1. Narrow tiles fill the card before K is
    split: a split costs a second pass over the partial tiles."""
    widest = TILE_NS[-1] if N > TILE_NS[-1] else \
        next(b for b in TILE_NS if b >= N)
    steps = -(-K // TILE_K)
    best = None
    for bn in TILE_NS[:TILE_NS.index(widest) + 1]:
        tiles = G * -(-M // TILE_M) * -(-N // bn)
        most = min(steps, sms // tiles) if 0 < tiles < sms else 1
        for splits in range(1, max(most, 1) + 1):
            t = plan_us(bn, splits, tiles, steps, sms)
            if best is None or t < best[0]:
                best = (t, bn, splits, tiles)
    _, bn, splits, tiles = best
    ws = tiles * splits * TILE_M * bn * 4 if splits > 1 else 0
    return Plan(TILE_M, bn, splits, tiles, steps,
                max(1, min(tiles * splits, sms)), ws)


def int8_matmul_reference(a, b):
    """Plain version: ``a.to(int32) @ b.to(int32)^T`` (exact)."""
    return a.to(torch.int32) @ b.to(torch.int32).transpose(-1, -2)


def _pads(padding):
    """((top, bottom), (left, right)) from ints, pairs or per-dim pairs."""
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    ph, pw = padding
    ph = (ph, ph) if isinstance(ph, int) else tuple(ph)
    pw = (pw, pw) if isinstance(pw, int) else tuple(pw)
    return ph, pw


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def int8_conv2d_reference(xq, wq, stride=1, padding=0, dilation=1, groups=1):
    """Plain version: the convolution of ``int8_conv2d`` in int32 (exact).
    PyTorch has no integer convolution with dilation; a dilated one runs in
    float64, exact too (every sum is below 2^31 in magnitude) and returned
    as int32."""
    (pt, pb), (pl, pr) = _pads(padding)
    dt = torch.int32 if _pair(dilation) == (1, 1) else torch.float64
    x = F.pad(xq.to(dt), (pl, pr, pt, pb))
    return F.conv2d(x, wq.to(dt), None, _pair(stride), 0, _pair(dilation),
                    groups).to(torch.int32)


def _check_k(fn, k):
    if k > MAX_K:
        raise ValueError(f"{fn}: K = {k} would overflow the int32 sums "
                         f"(K <= {MAX_K})")


def _padded_k(k):
    """K rounded up to a multiple of 16 (at least 16): a row stride TMA
    takes."""
    return max(16, -(-k // 16) * 16)


def _epilogue_args(fn, scale, bias, n):
    """Checks the epilogue's vectors: ``scale`` (n,) and, with it, an
    optional ``bias`` (n,); a bias without a scale is refused."""
    if scale is None:
        if bias is not None:
            raise ValueError(f"{fn}: a bias needs a scale")
        return
    for name, v in (("scale", scale), ("bias", bias)):
        if v is not None and tuple(v.shape) != (n,):
            raise ValueError(f"{fn}: {name} of shape {tuple(v.shape)}, "
                             f"expected ({n},)")


def _rescaled(acc, scale, bias, cols):
    """The plain epilogue: ``acc.to(float32) * scale + bias``, the vectors
    broadcast along the columns (``cols`` = their shape in ``acc``)."""
    if scale is None:
        return acc
    y = acc.to(torch.float32) * scale.reshape(cols)
    return y if bias is None else y + bias.reshape(cols)


def _card_vector(fn, name, v, dev):
    """``v`` as a contiguous float32 vector on ``dev`` for the kernel
    (bf16 and float16 convert exactly; a wider type is refused: the
    kernel's epilogue is float32)."""
    if v is None:
        return None
    if v.device != dev:
        raise ValueError(f"{fn}: {name} on {v.device}, operands on {dev}")
    if v.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"{fn}: {name} of type {v.dtype}: the epilogue is "
                        f"float32")
    return v.to(torch.float32).contiguous()


_SMS: dict = {}         # device index -> SM count
_COUNTERS: dict = {}    # (device index, stream) -> the tiles' counters


def _sm_count(dev):
    n = _SMS.get(dev.index)
    if n is None:
        n = _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return n


def _counters(dev, stream, n):
    """The split tiles' arrival counters of ``stream`` on ``dev``: zeros,
    which every launch leaves at zero (a stream's launches run in turn)."""
    key = (dev.index, stream)
    c = _COUNTERS.get(key)
    if c is None or c.numel() < n:
        c = _COUNTERS[key] = torch.zeros(n, dtype=torch.int32, device=dev)
    return c


def _launch(a, b, c, G, M, N, K, lda, ldb, ldc, sa, sb, sc, scale=None,
            bias=None, sv=0):
    """One launch of the GEMM on ``a``'s stream; returns the route. With
    ``scale`` (float32, group g's columns at + g ``sv``) ``c`` is
    float32, else int32."""
    dev = a.device
    pl = plan(G, M, N, K, _sm_count(dev))
    if G and M and N:
        stream = torch.cuda.current_stream(dev).cuda_stream
        ws = cnt = None
        if pl.splits > 1:
            ws = torch.empty(pl.workspace_bytes // 4, dtype=torch.int32,
                             device=dev)
            cnt = _counters(dev, stream, max(pl.tiles, _sm_count(dev)))
        fn = _build.function(*_FN, _ARGTYPES)
        ptr = lambda t: None if t is None else t.data_ptr()
        err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), ptr(scale),
                 ptr(bias), ptr(cnt), ptr(ws), G, M, N, K, lda, ldb, ldc, sa,
                 sb, sc, sv, pl.tile_n, pl.splits, pl.grid, stream)
        if err:
            raise RuntimeError(f"int8 GEMM launch failed: CUDA error {err}")
    return "split_k" if pl.splits > 1 else "tiles"


def _kmajor(t):
    """``t`` (..., rows, K) int8 with a row stride TMA takes: ``t`` itself
    (contiguous, K a multiple of 16, 16-byte aligned), else a copy into
    rows of ``_padded_k(K)`` bytes whose tail is never read. Returns (the
    operand, its row stride)."""
    k = t.shape[-1]
    if k % 16 == 0 and k and t.data_ptr() % 16 == 0:
        return t, k
    kp = _padded_k(k)
    out = torch.empty(t.shape[:-1] + (kp,), dtype=torch.int8, device=t.device)
    out[..., :k].copy_(t)
    return out, kp


def _aligned(t):
    """``t``, or a copy of it where it does not start on a 16-byte
    boundary (TMA's alignment)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _conv_operands(xq, wq, stride, padding, dilation, groups,
                   dtype=torch.int32):
    """The GEMM operands of a convolution: the int8 im2col ``cols`` (B Ho
    Wo, G Kp), rows (b, y, x) and group g's columns (c, ky, kx) at g Kp ..
    g Kp + Kg - 1 (Kg = C / G kh kw, Kp = ``_padded_k(Kg)``; the columns
    past Kg are never read), made by one copy of a strided view of the
    zero-padded input (none where that view is already those rows: a
    channels-last input to a 1x1 convolution at stride 1); the weights (O, Kp), rows (o) and columns (c, ky,
    kx); the (B, Ho, Wo, O) output of ``dtype``; and the kernel's (G, M,
    N, K, lda, ldb, ldc, sa, sb, sc): group g is columns g Kp .. of
    ``cols``, rows g Og .. of the weights and columns g Og .. of the
    output, with K = Kg."""
    O, Cg, kh, kw = wq.shape
    (pt, pb), (pl, pr) = _pads(padding)
    sh, sw = _pair(stride)
    dh, dw = _pair(dilation)
    pads = (pl, pr, pt, pb)
    xp = F.pad(xq, pads) if any(pads) else xq
    B, C, Hp, Wp = xp.shape
    Ho = (Hp - dh * (kh - 1) - 1) // sh + 1
    Wo = (Wp - dw * (kw - 1) - 1) // sw + 1
    if Ho <= 0 or Wo <= 0:
        raise ValueError(f"int8_conv2d: no output for x{tuple(xq.shape)} "
                         f"w{tuple(wq.shape)}")
    M, Kg, Og = B * Ho * Wo, Cg * kh * kw, O // groups
    Kp = _padded_k(Kg)
    # the input's own strides, whatever its memory format: a channels-last
    # input (the layout the kernel writes) needs no copy for a 1x1
    # convolution at stride 1, and no transpose for any other
    nB, nC, nH, nW = xp.stride()
    view = xp.as_strided((B, Ho, Wo, groups, Cg, kh, kw),
                         (nB, sh * nH, sw * nW, Cg * nC, nC, dh * nH,
                          dw * nW), xp.storage_offset())
    if Kp == Kg:
        cols = _aligned(view.contiguous())
        w = _aligned(wq.contiguous())
    else:
        cols = torch.empty((B, Ho, Wo, groups, Kp), dtype=torch.int8,
                           device=xq.device)
        cols[..., :Kg].view(B, Ho, Wo, groups, Cg, kh, kw).copy_(view)
        w = torch.empty((O, Kp), dtype=torch.int8, device=xq.device)
        w[:, :Kg].copy_(wq.reshape(O, Kg))
    out = torch.empty((B, Ho, Wo, O), dtype=dtype, device=xq.device)
    return (cols.reshape(M, groups * Kp), w.reshape(O, Kp), out,
            (groups, M, Og, Kg, groups * Kp, Kp, O, Kp, Og * Kp, Og))


def _cuda_only(fn, *tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"{fn}: no kernel for device {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{fn}: tensors on {t.device} and {dev}")
        if t.dtype != torch.int8:
            raise TypeError(f"{fn}: int8 operands expected, got {t.dtype}")


def int8_matmul(a, b, scale=None, bias=None):
    """``a . b^T`` in int32: a (M, K) and b (N, K) int8, or a (G, M, K) and
    b (G, N, K) for G independent products. Returns (M, N) or (G, M, N)
    int32; with ``scale`` (N,) (and ``bias`` (N,)) float32
    ``acc.to(float32) * scale + bias``, the vectors shared by the groups,
    computed in the kernel's epilogue on the card."""
    if a.dim() not in (2, 3) or b.dim() != a.dim() \
            or a.shape[-1] != b.shape[-1] \
            or (a.dim() == 3 and a.shape[0] != b.shape[0]):
        raise ValueError(f"int8_matmul: a{tuple(a.shape)} . "
                         f"b{tuple(b.shape)}^T")
    _check_k("int8_matmul", a.shape[-1])
    N = b.shape[-2]
    _epilogue_args("int8_matmul", scale, bias, N)
    if a.device.type == "cpu":
        return _rescaled(int8_matmul_reference(a, b), scale, bias, (N,))
    _cuda_only("int8_matmul", a, b)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("int8_matmul: operands must be contiguous")
    s = _card_vector("int8_matmul", "scale", scale, a.device)
    bv = _card_vector("int8_matmul", "bias", bias, a.device)
    G = a.shape[0] if a.dim() == 3 else 1
    M, K = a.shape[-2:]
    ap, lda = _kmajor(a)
    bp, ldb = _kmajor(b)
    c = torch.empty(a.shape[:-1] + (N,), device=a.device,
                    dtype=torch.int32 if s is None else torch.float32)
    rt = _launch(ap, bp, c, G, M, N, K, lda, ldb, N, M * lda, N * ldb, M * N,
                 s, bv, 0)
    int8_matmul.launches += 1
    int8_matmul.launches_by_route[rt] += 1
    _flops.tally("int8_matmul", 2 * G * M * N * K)
    return c


int8_matmul.launches = 0
int8_matmul.launches_by_route = dict.fromkeys(_ROUTES, 0)


def int8_conv2d(xq, wq, stride=1, padding=0, dilation=1, groups=1,
                scale=None, bias=None):
    """The convolution of NCHW int8 ``xq`` (B, C, H, W) with OIHW int8 ``wq``
    (O, C / groups, kh, kw) in int32: ``padding`` an int, a (ph, pw) pair
    or ((top, bottom), (left, right)) of zeros, ``stride`` and
    ``dilation`` ints or pairs. Returns (B, O, Ho, Wo) int32 (on the card a
    channels-last view of the kernel's (B, Ho, Wo, O) output); with
    ``scale`` (O,) (and ``bias`` (O,)) float32 ``acc.to(float32) *
    scale[o] + bias[o]``, computed in the kernel's epilogue on the card."""
    if xq.dim() != 4 or wq.dim() != 4 or xq.shape[1] != wq.shape[1] * groups \
            or wq.shape[0] % groups:
        raise ValueError(f"int8_conv2d: x{tuple(xq.shape)} w{tuple(wq.shape)}"
                         f" groups {groups}")
    O, Cg, kh, kw = wq.shape
    _check_k("int8_conv2d", Cg * kh * kw)
    _epilogue_args("int8_conv2d", scale, bias, O)
    if xq.device.type == "cpu":
        return _rescaled(int8_conv2d_reference(xq, wq, stride, padding,
                                               dilation, groups),
                         scale, bias, (O, 1, 1))
    _cuda_only("int8_conv2d", xq, wq)
    s = _card_vector("int8_conv2d", "scale", scale, xq.device)
    bv = _card_vector("int8_conv2d", "bias", bias, xq.device)
    cols, w, out, gemm = _conv_operands(
        xq, wq, stride, padding, dilation, groups,
        torch.int32 if s is None else torch.float32)
    G, M, Og, Kg = gemm[:4]
    rt = _launch(cols, w, out, *gemm, s, bv, Og)
    int8_conv2d.launches += 1
    int8_conv2d.launches_by_route[rt] += 1
    _flops.tally("int8_conv2d", 2 * M * G * Og * Kg)
    return out.permute(0, 3, 1, 2)


int8_conv2d.launches = 0
int8_conv2d.launches_by_route = dict.fromkeys(_ROUTES, 0)


__all__ = ["MAX_K", "TILE_NS", "Plan", "plan", "plan_us", "int8_matmul",
           "int8_matmul_reference", "int8_conv2d", "int8_conv2d_reference"]
