"""Flash attention forward (K1-fwd): the CUDA kernel and its plain version.

Replaces the Pallas kernel ``bigdl_tpu/kernels/flash_attention.py``
``_flash_fwd`` (body ``_fwd_kernel``) with ``csrc/flash_fwd.cu``. The
source's header note says what bounds it on an H100 and what the design
does about it.

:func:`flash_fwd` is the wrapper: a tensor on the CPU takes
:func:`flash_fwd_reference`, the plain PyTorch version of the same
function; a tensor on a CUDA device launches the kernel or raises. The
serving path needs no gradient, so the wrapper refuses tensors that require
one (the ``autograd.Function`` arrives with the backward kernels).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_void_p])


def flash_fwd_reference(q, k, v, causal: bool = False, q_offset: int = 0,
                        kv_len=None):
    """Plain version: softmax(q k^T / sqrt(D)) v over the first ``kv_len``
    keys, query row r at global position ``q_offset + r`` seeing keys
    ``<= q_offset + r`` when ``causal``. Computes in float32 and returns
    ``(o in q's dtype, lse float32 (B, H, Tq))``; a row that sees no key
    gives o = 0 and lse = -inf, as the kernel does."""
    tkv = k.shape[2]
    kv_len = tkv if kv_len is None else int(kv_len)
    scale = 1.0 / math.sqrt(q.shape[-1])
    if kv_len == 0:
        return (torch.zeros_like(q),
                torch.full(q.shape[:3], float("-inf"), device=q.device))
    qf = q.float()
    kf = k[:, :, :kv_len].float()
    vf = v[:, :, :kv_len].float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if causal:
        rows = q_offset + torch.arange(q.shape[2], device=q.device)
        cols = torch.arange(kv_len, device=q.device)
        keep = cols[None, :] <= rows[:, None]
        s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vf) / torch.where(
        l > 0, l, torch.ones_like(l))
    lse = torch.where(l > 0, m + torch.log(l),
                      torch.full_like(l, float("-inf")))[..., 0]
    return o.to(q.dtype), lse


def _check(q, k, v, q_offset, kv_len):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_fwd: {name} on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_fwd: {name} is {t.dtype}, q is "
                            f"{q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"flash_fwd: {name} must be (B, H, T, D), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_fwd: {name} must be contiguous")
        if t.requires_grad:
            raise ValueError("flash_fwd: forward-only kernel; run under "
                             "torch.no_grad()")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_fwd: dtype {q.dtype} not supported "
                        f"(float32, bfloat16)")
    B, H, _, D = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError(f"flash_fwd: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} disagree")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_fwd: head dim {D} not in {_HEAD_DIMS}")
    if not 0 <= kv_len <= k.shape[2] or q_offset < 0:
        raise ValueError(f"flash_fwd: kv_len {kv_len} / q_offset "
                         f"{q_offset} out of range for {k.shape[2]} keys")


def flash_fwd(q, k, v, causal: bool = False, q_offset: int = 0, kv_len=None):
    """Flash attention forward. q (B, H, Tq, D), k/v (B, H, Tkv, D), float32
    or bfloat16; attends the first ``kv_len`` keys (default all), causal or
    rectangular-causal with ``q_offset``. Returns ``(o, lse)``."""
    kv_len = k.shape[2] if kv_len is None else int(kv_len)
    q_offset = int(q_offset)
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal, q_offset, kv_len)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_fwd: no kernel for device {q.device}")
    _check(q, k, v, q_offset, kv_len)
    B, H, Tq, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    fn = _build.function("flash_fwd", "bigdl_flash_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), _DTYPES[q.dtype], B, H, Tq, k.shape[2], D,
             int(bool(causal)), q_offset, kv_len, 1.0 / math.sqrt(D),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0
