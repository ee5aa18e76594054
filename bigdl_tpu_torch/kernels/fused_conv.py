"""Fused BatchNorm-apply + ReLU + 3x3 conv + batch statistics (K4): the CUDA
kernel, its plain version and the ``autograd.Function`` around it.

Replaces the Pallas kernel of ``bigdl_tpu/kernels/fused_conv.py``
``fused_bn_relu_conv3x3`` (``_cvfwd``). The wrapper picks its kernel by
dtype and one shape rule per dtype (:func:`route`):

- ``"bf16_sm90"``: bfloat16 with C and N multiples of 8 (every ResNet-50
  call) takes ``csrc/fused_conv_sm90.cu`` (an implicit GEMM on bf16 wgmma,
  the tap gather and the prologue in registers);
- ``"bf16_ragged"``: other bfloat16 shapes take the CUDA-core kernel of
  ``csrc/fused_conv.cu`` in bf16;
- ``"f32_sm90"``: float32 with C a multiple of 32 and N a multiple of 4
  (every ResNet-50 call) takes ``csrc/fused_conv_tf32_sm90.cu`` (the same
  implicit GEMM in 3xTF32 on wgmma: each float32 operand split into tf32
  hi and lo halves, three products, which keeps float32 accuracy; a 32-deep
  chunk of the contraction is one tap);
- ``"f32"``: other float32 shapes take ``csrc/fused_conv.cu``.

Each source's header note says what bounds it on an H100 and what the
design does about it; ``fused_conv_fwd.launches_by_route`` counts the
launches per route. The backward stays what it is in the JAX package (``_cv_bwd``): plain
ops outside any kernel, here PyTorch's - recompute x_hat, inject the
statistics' gradient, take the conv's input and weight gradients, then the
ReLU mask, da and db.

:func:`fused_conv_fwd` is the wrapper: tensors on the CPU take
:func:`conv3x3_reference` (plain PyTorch with the kernel's rounding
points: x_hat rounded to x's dtype, float32 sums and statistics); tensors
on a CUDA device launch the kernel or raise. JAX's VMEM fitter (and the
None it returns when no batch block fits) is not ported.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..utils.engine import refuse_unported
from . import _build
from .fused_matmul import (_DTYPES, _PART_ROWS, _RAGGED, _check_aligned,
                           _f32, _ptr, _stream, _wsplit)
from .fused_matmul import route as _k3_route

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
# each route's (library, symbol)
_FWD_FN = {"bf16_sm90": ("fused_conv_sm90", "bigdl_fused_conv_sm90_fwd"),
           _RAGGED: ("fused_conv", "bigdl_fused_conv_fwd"),
           "f32_sm90": ("fused_conv_tf32_sm90",
                        "bigdl_fused_conv_tf32_sm90_fwd"),
           "f32": ("fused_conv", "bigdl_fused_conv_fwd")}
# the tensor-core routes (TMA and 16-byte copies: 16-byte aligned x and w)
_TC = ("bf16_sm90", "f32_sm90")


def route(dtype, c: int, n: int) -> str:
    """K4's route: ``fused_matmul.route`` for bfloat16; float32 takes
    ``"f32_sm90"`` (3xTF32) when C is a multiple of 32 (a 32-deep chunk of
    the contraction is one tap) and N a multiple of 4, else ``"f32"`` (the
    CUDA cores)."""
    if dtype == torch.float32:
        return "f32_sm90" if c % 32 == 0 and n % 4 == 0 else "f32"
    return _k3_route(dtype, c, n)


def _xhat(x, a, b):
    """relu(x * a + b): the affine in float32, rounded to x's dtype."""
    return torch.relu(x.float() * a.float() + b.float()).to(x.dtype)


def _conv(xh, w, stride):
    """3x3 conv, padding 1, NHWC input and HWIO weight -> NHWC output."""
    y = F.conv2d(xh.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=1)
    return y.permute(0, 2, 3, 1)


def conv3x3_reference(x, w, a, b, stride: int = 1, stats: bool = True):
    """Plain version: x (B, H, W, C) NHWC, w (3, 3, C, N) HWIO, a/b (C,).
    Returns ``(z, s1, s2)``: z = conv3x3(relu(x * a + b), w) with padding
    1 and ``stride``, summed in float32 and written in x's dtype; s1 / s2
    the float32 per-channel sums of z and z^2 (None without ``stats``)."""
    zf = _conv(_xhat(x, a, b).float(), w.float(), stride)
    if stats:
        return (zf.to(x.dtype), zf.sum((0, 1, 2)),
                (zf * zf).sum((0, 1, 2)))
    return zf.to(x.dtype), None, None


def _check(x, w, a, b, stride):
    for name, t in (("w", w), ("a", a), ("b", b)):
        if t.device != x.device:
            raise ValueError(f"fused_conv_fwd: {name} on {t.device}, x on "
                             f"{x.device}")
    for name, t in (("x", x), ("w", w), ("a", a), ("b", b)):
        if t.requires_grad and torch.is_grad_enabled():
            raise ValueError("fused_conv_fwd: the kernel builds no autograd "
                             "graph; differentiate through FusedConv3x3 or "
                             "run under torch.no_grad()")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"fused_conv_fwd: x {x.dtype} and w {w.dtype} must "
                        f"be one of float32, bfloat16")
    if (x.dim() != 4 or w.dim() != 4 or w.shape[:3] != (3, 3, x.shape[3])
            or a.shape != (x.shape[3],) or b.shape != (x.shape[3],)):
        raise ValueError(f"fused_conv_fwd: x{tuple(x.shape)} "
                         f"w{tuple(w.shape)} a{tuple(a.shape)} "
                         f"b{tuple(b.shape)}")
    if stride not in (1, 2):
        raise ValueError(f"fused_conv_fwd: stride {stride} (1 or 2)")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("fused_conv_fwd: x and w must be contiguous")
    if 0 in x.shape or 0 in w.shape:
        raise ValueError(f"fused_conv_fwd: empty x{tuple(x.shape)} or "
                         f"w{tuple(w.shape)}")
    if x.numel() >= 2**31 or 9 * x.shape[3] * w.shape[3] >= 2**31:
        raise ValueError(f"fused_conv_fwd: x{tuple(x.shape)} is past the "
                         f"kernel's 32-bit indices")


def fused_conv_fwd(x, w, a, b, stride: int = 1, stats: bool = True):
    """K4 forward: x (B, H, W, C) and w (3, 3, C, N) of one dtype (float32
    or bfloat16), a/b (C,). Returns ``(z (B, H2, W2, N), s1, s2)`` with H2
    = ceil(H / stride) (s1/s2 None without ``stats``)."""
    if x.device.type == "cpu":
        return conv3x3_reference(x, w, a, b, stride, stats)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_conv_fwd: no kernel for device {x.device}")
    _check(x, w, a, b, stride)
    B, H, W, C = x.shape
    N = w.shape[3]
    rt = route(x.dtype, C, N)
    if rt in _TC:
        _check_aligned("fused_conv_fwd", x, w)
    H2, W2 = -(-H // stride), -(-W // stride)
    M = B * H2 * W2
    z = torch.empty((B, H2, W2, N), dtype=x.dtype, device=x.device)
    part = s = None
    if stats:
        part = torch.empty((2, -(-M // _PART_ROWS[rt]), N), device=x.device)
        s = torch.empty((2, N), device=x.device)
    af, bf = _f32(a), _f32(b)      # held until the launch is queued
    wsp, extra = _wsplit(rt, 9 * C, N, x.device)
    fn = _build.function(*_FWD_FN[rt],
                         _ARGTYPES + [ctypes.c_void_p] * len(extra))
    err = fn(x.data_ptr(), w.data_ptr(), af.data_ptr(), bf.data_ptr(),
             z.data_ptr(), _ptr(part),
             None if part is None else part[1].data_ptr(), _ptr(s),
             None if s is None else s[1].data_ptr(), _DTYPES[x.dtype], B, H,
             W, C, N, int(stride), int(bool(stats)), _stream(x), *extra)
    if err:
        raise RuntimeError(f"fused_conv_fwd kernel launch failed ({rt}): "
                           f"CUDA error {err}")
    fused_conv_fwd.launches += 1
    fused_conv_fwd.launches_by_route[rt] += 1
    return (z, s[0], s[1]) if stats else (z, None, None)


fused_conv_fwd.launches = 0
fused_conv_fwd.launches_by_route = dict.fromkeys(_FWD_FN, 0)


def conv3x3_bwd(x, w, a, b, z, dz, ds1, ds2, stride: int, stats: bool):
    """The backward of K4 in plain PyTorch on any device, as the JAX
    package's ``_cv_bwd`` is plain XLA: returns ``(dx, dw, da, db)``."""
    dt = x.dtype
    af = a.float()
    d = dz.float()
    if stats and ds1 is not None:
        d = d + ds1.float() + 2.0 * z.float() * ds2.float()
    d = d.to(dt).permute(0, 3, 1, 2)
    u = x.float() * af + b.float()
    xh = torch.relu(u).to(dt).permute(0, 3, 1, 2)
    wk = w.permute(3, 2, 0, 1)
    dxh = torch.nn.grad.conv2d_input(xh.shape, wk, d, stride=stride,
                                     padding=1).permute(0, 2, 3, 1)
    dw = torch.nn.grad.conv2d_weight(xh, wk.shape, d, stride=stride,
                                     padding=1).permute(2, 3, 1, 0)
    g = torch.where(u > 0, dxh.float(), torch.zeros_like(u))
    return ((g * af).to(dt), dw.to(w.dtype).contiguous(),
            (g * x.float()).sum((0, 1, 2)), g.sum((0, 1, 2)))


class FusedConv3x3(torch.autograd.Function):
    """``FusedConv3x3.apply(x, w, a, b, stride, stats)`` -> (z, s1, s2):
    the forward through :func:`fused_conv_fwd`, saving (x, w, a, b, z), the
    backward through :func:`conv3x3_bwd` (JAX's ``_cv`` ``custom_vjp``).
    da / db come back in a's / b's dtype."""

    @staticmethod
    def forward(ctx, x, w, a, b, stride, stats):
        z, s1, s2 = fused_conv_fwd(x, w, a, b, stride, stats)
        ctx.save_for_backward(x, w, a, b, z if stats else None)
        ctx.stride, ctx.stats = stride, stats
        return z, s1, s2

    @staticmethod
    def backward(ctx, dz, ds1, ds2):
        x, w, a, b, z = ctx.saved_tensors
        dx, dw, da, db = conv3x3_bwd(x, w, a, b, z, dz, ds1, ds2, ctx.stride,
                                     ctx.stats)
        return dx, dw, da.to(a.dtype), db.to(b.dtype), None, None


def fused_bn_relu_conv3x3(x, w, scale, bias, *, stride: int = 1,
                          stats: bool = True, interpret: bool = False):
    """relu(x * scale + bias) -> 3x3 conv (padding 1) -> (z, s1, s2). x
    (B, H, W, C) NHWC; w (3, 3, C, N) HWIO; stride 1 or 2. s1 / s2 are
    float32 (N,), or None without ``stats``. JAX's ``interpret`` is not
    ported."""
    refuse_unported("fused_bn_relu_conv3x3", interpret=(interpret, False))
    return FusedConv3x3.apply(x, w, scale, bias, int(stride), bool(stats))
