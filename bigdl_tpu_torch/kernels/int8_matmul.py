"""The int8 contraction (int8 x int8 -> int32): the CUDA kernel and its plain
versions.

Replaces no Pallas kernel: the JAX package leaves its int8 contractions to
XLA (``bigdl_tpu/quantization/quantize.py:89`` ``lax.dot_general(...,
preferred_element_type=int32)``, and ``lax.conv_general_dilated`` over int8
at ``:136`` and ``:190``). No PyTorch op computes them on a CUDA device
(``torch.matmul`` and ``F.conv2d`` refuse int8 and int32 tensors,
``torch._int_mm`` takes only some shapes), so the card runs the
hand-written tensor-core GEMM ``csrc/int8_gemm_sm90.cu``: C[g] (M x N,
int32) = A[g] (M x K, int8) . B[g] (N x K, int8)^T over G groups. Its
header note says what bounds it on an H100 and what the design does
about it.

:func:`int8_matmul` (a . b^T) and :func:`int8_conv2d` (an NCHW
convolution) are the wrappers: tensors on the CPU take
:func:`int8_matmul_reference` / :func:`int8_conv2d_reference`, exact int32
products in plain PyTorch; tensors on a CUDA device launch the kernel or
raise. :func:`int8_conv2d` forms A on the card as an int8 im2col of its own
(the padded input viewed through strides, one copy; ``F.unfold`` refuses
int8), rows (b, y, x) and columns (channel, ky, kx), so group g's columns
are one contiguous run: a grouped or depthwise convolution is one launch
over G groups. Each wrapper counts its launches (``.launches``) and, by the
kernel's loader, ``.launches_by_route``: ``"aligned"`` where every row of
both operands starts on a 16-byte boundary (16 bytes a thread),
``"ragged"`` otherwise (a byte a thread; Inception's first convolution, K
= 147, and a depthwise 3x3, K = 9).

The sums are exact in int32 while K * 128 * 128 < 2^31 (K <= 131071, which
holds -128 too; JAX's operands, clipped to +-127, would allow K < 133,152):
both wrappers refuse a larger K.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build, _flops

_FN = ("int8_gemm_sm90", "bigdl_int8_gemm")
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
             + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
MAX_K = (2**31 - 1) // (128 * 128)
_ROUTES = ("aligned", "ragged")


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


def _launch(a, b, c, G, M, N, K, lda, ldb, ldc, sa, sb, sc):
    """One launch of the GEMM on ``a``'s stream; returns the route."""
    aligned = (a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
               and lda % 16 == 0 and ldb % 16 == 0
               and (G == 1 or (sa % 16 == 0 and sb % 16 == 0)))
    if G and M and N:
        fn = _build.function(*_FN, _ARGTYPES)
        err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), G, M, N, K, lda,
                 ldb, ldc, sa, sb, sc,
                 torch.cuda.current_stream(a.device).cuda_stream)
        if err:
            raise RuntimeError(f"int8 GEMM launch failed: CUDA error {err}")
    return "aligned" if aligned else "ragged"


def _conv_operands(xq, wq, stride, padding, dilation, groups):
    """The GEMM operands of a convolution: the int8 im2col ``cols`` (B Ho
    Wo, C kh kw), rows (b, y, x) and columns (c, ky, kx), made by one copy
    of a strided view of the zero-padded input; the weights (O, Cg kh
    kw); the (B, Ho, Wo, O) int32 output; and the kernel's (G, M, N, K,
    lda, ldb, ldc, sa, sb, sc): group g is columns g Kg .. of ``cols``,
    rows g Og .. of the weights and columns g Og .. of the output."""
    O, Cg, kh, kw = wq.shape
    (pt, pb), (pl, pr) = _pads(padding)
    sh, sw = _pair(stride)
    dh, dw = _pair(dilation)
    xp = F.pad(xq, (pl, pr, pt, pb)).contiguous()
    B, C, Hp, Wp = xp.shape
    Ho = (Hp - dh * (kh - 1) - 1) // sh + 1
    Wo = (Wp - dw * (kw - 1) - 1) // sw + 1
    if Ho <= 0 or Wo <= 0:
        raise ValueError(f"int8_conv2d: no output for x{tuple(xq.shape)} "
                         f"w{tuple(wq.shape)}")
    cols = xp.as_strided((B, Ho, Wo, C, kh, kw),
                         (C * Hp * Wp, sh * Wp, sw, Hp * Wp, dh * Wp, dw))
    cols = cols.contiguous()
    M, Kg, Og = B * Ho * Wo, Cg * kh * kw, O // groups
    out = torch.empty((B, Ho, Wo, O), dtype=torch.int32, device=xq.device)
    return (cols, wq.contiguous(), out,
            (groups, M, Og, Kg, C * kh * kw, Kg, O, Kg, Og * Kg, Og))


def _cuda_only(fn, *tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"{fn}: no kernel for device {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{fn}: tensors on {t.device} and {dev}")
        if t.dtype != torch.int8:
            raise TypeError(f"{fn}: int8 operands expected, got {t.dtype}")


def int8_matmul(a, b):
    """``a . b^T`` in int32: a (M, K) and b (N, K) int8, or a (G, M, K) and
    b (G, N, K) for G independent products. Returns (M, N) or (G, M, N)
    int32."""
    if a.dim() not in (2, 3) or b.dim() != a.dim() \
            or a.shape[-1] != b.shape[-1] \
            or (a.dim() == 3 and a.shape[0] != b.shape[0]):
        raise ValueError(f"int8_matmul: a{tuple(a.shape)} . "
                         f"b{tuple(b.shape)}^T")
    _check_k("int8_matmul", a.shape[-1])
    if a.device.type == "cpu":
        return int8_matmul_reference(a, b)
    _cuda_only("int8_matmul", a, b)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("int8_matmul: operands must be contiguous")
    G = a.shape[0] if a.dim() == 3 else 1
    M, K = a.shape[-2:]
    N = b.shape[-2]
    c = torch.empty(a.shape[:-1] + (N,), dtype=torch.int32, device=a.device)
    rt = _launch(a, b, c, G, M, N, K, K, K, N, M * K, N * K, M * N)
    int8_matmul.launches += 1
    int8_matmul.launches_by_route[rt] += 1
    _flops.tally("int8_matmul", 2 * G * M * N * K)
    return c


int8_matmul.launches = 0
int8_matmul.launches_by_route = dict.fromkeys(_ROUTES, 0)


def int8_conv2d(xq, wq, stride=1, padding=0, dilation=1, groups=1):
    """The convolution of NCHW int8 ``xq`` (B, C, H, W) with OIHW int8 ``wq``
    (O, C / groups, kh, kw) in int32: ``padding`` an int, a (ph, pw) pair
    or ((top, bottom), (left, right)) of zeros, ``stride`` and
    ``dilation`` ints or pairs. Returns (B, O, Ho, Wo) int32 (on the card a
    channels-last view of the kernel's (B, Ho, Wo, O) output)."""
    if xq.dim() != 4 or wq.dim() != 4 or xq.shape[1] != wq.shape[1] * groups \
            or wq.shape[0] % groups:
        raise ValueError(f"int8_conv2d: x{tuple(xq.shape)} w{tuple(wq.shape)}"
                         f" groups {groups}")
    O, Cg, kh, kw = wq.shape
    _check_k("int8_conv2d", Cg * kh * kw)
    if xq.device.type == "cpu":
        return int8_conv2d_reference(xq, wq, stride, padding, dilation,
                                     groups)
    _cuda_only("int8_conv2d", xq, wq)
    cols, w, out, gemm = _conv_operands(xq, wq, stride, padding, dilation,
                                        groups)
    rt = _launch(cols, w, out, *gemm)
    int8_conv2d.launches += 1
    int8_conv2d.launches_by_route[rt] += 1
    G, M, Og, Kg = gemm[:4]
    _flops.tally("int8_conv2d", 2 * M * G * Og * Kg)
    return out.permute(0, 3, 1, 2)


int8_conv2d.launches = 0
int8_conv2d.launches_by_route = dict.fromkeys(_ROUTES, 0)


__all__ = ["MAX_K", "int8_matmul", "int8_matmul_reference", "int8_conv2d",
           "int8_conv2d_reference"]
