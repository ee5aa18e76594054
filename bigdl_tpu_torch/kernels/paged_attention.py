"""Paged attention (K2): the CUDA kernel and its plain version.

Replaces the Pallas kernel ``bigdl_tpu/kernels/paged_attention.py``
``paged_decode_attention`` (body ``_kernel``) with
``csrc/paged_attention.cu``. The source's header note says what bounds it
on an H100 and what the design does about it.

:func:`paged_decode_attention` is the wrapper: tensors on the CPU take
:func:`paged_attention_reference` (the gathered-view einsum of
``Attention._paged_gather_attend``, the JAX kernel's own oracle); tensors
on a CUDA device launch the kernel or raise.

dtype rule: the pages may be float32 while q is bfloat16 (bf16 weights
over the default float32 pool). The wrapper casts q to the page dtype (q
is small), as JAX's type promotion of that pair does, and casts the output
back to q's dtype, as the Pallas kernel's output does.

Head dims: the kernel is instantiated for every multiple of 16 up to 256
(``_DIMS``); another D up to 256 takes the next one with q and the pages
zero-padded (exact, as for the flash kernels, but a copy of the pool: such
calls count under ``"<route>_padded"`` in ``launches_by_route``, the route
being the page dtype, ``"f32"`` or ``"bf16"``); a wider D raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..utils.engine import refuse_unported
from . import _build
from .flash_attention import _PADDED, _pad_d, head_dim_width

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_DIMS = tuple(range(16, 257, 16))
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_void_p])


def paged_attention_reference(q, k_pages, v_pages, block_tables, positions,
                              scale=None):
    """Plain version: gather the logical (B, kvH, T, D) view through the
    block tables and attend over it in float32, query row s of batch row b
    seeing positions ``<= positions[b] + s``, logits scaled by ``scale``
    (default 1 / sqrt(D)). Grouped-query heads fold kv-major (query head h
    = kv_head * G + g). Returns q's shape and dtype."""
    B, nH, S, D = q.shape
    kvH, bs = k_pages.shape[1], k_pages.shape[2]
    G = nH // kvH
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    tables = block_tables.long()
    t = tables.shape[1] * bs
    # (B, nblk, kvH, bs, D) -> (B, kvH, T, D)
    kg = k_pages[tables].transpose(1, 2).reshape(B, kvH, t, D).float()
    vg = v_pages[tables].transpose(1, 2).reshape(B, kvH, t, D).float()
    pos_s = positions.long()[:, None] + torch.arange(S, device=q.device)
    keep = torch.arange(t, device=q.device)[None, None, :] <= pos_s[:, :, None]
    qg = q.float().reshape(B, kvH, G, S, D)
    logits = torch.einsum("bkgsd,bktd->bkgst", qg, kg) * scale
    logits = logits.masked_fill(~keep[:, None, None], float("-inf"))
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", w, vg)
    return o.reshape(B, nH, S, D).to(q.dtype)


def _check(q, k_pages, v_pages, block_tables, positions):
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables),
                    ("positions", positions)):
        if t.device != dev:
            raise ValueError(f"paged_attention: {name} on {t.device}, q on "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    if q.requires_grad:
        raise ValueError("paged_attention: forward-only kernel; run under "
                         "torch.no_grad()")
    if k_pages.dtype not in _DTYPES or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"paged_attention: page dtypes {k_pages.dtype}/"
                        f"{v_pages.dtype} not supported (float32, bfloat16)")
    if block_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("paged_attention: block_tables and positions must be "
                        "int32")
    if q.dim() != 4 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"paged_attention: q{tuple(q.shape)} "
                         f"k_pages{tuple(k_pages.shape)} "
                         f"v_pages{tuple(v_pages.shape)}")
    B, nH, _, D = q.shape
    kvH = k_pages.shape[1]
    if nH % kvH or k_pages.shape[3] != D:
        raise ValueError(f"paged_attention: {nH} query heads of dim {D} vs "
                         f"pages {tuple(k_pages.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or positions.shape != (B,):
        raise ValueError(f"paged_attention: tables {tuple(block_tables.shape)}"
                         f" / positions {tuple(positions.shape)} vs batch {B}")


def paged_decode_attention(q, k_pages, v_pages, block_tables, positions,
                           scale=None, interpret: bool = False, vma=None):
    """Attention over a paged KV pool, in place. q (B, nH, S, D) at per-row
    positions ``positions[b] .. positions[b]+S-1``; k_pages/v_pages
    (num_blocks, kvH, block_size, D) already holding this chunk's K/V;
    block_tables (B, max_blocks) int32 (0 = the null block); positions (B,)
    int32; ``scale`` multiplies the logits (default 1 / sqrt(D)). Returns
    (B, nH, S, D) in q's dtype. JAX's ``interpret`` (the Pallas interpreter)
    and ``vma`` (shard_map's varying axes) are not ported."""
    refuse_unported("paged_decode_attention",
                    interpret=(bool(interpret), False), vma=(vma, None))
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, block_tables,
                                         positions, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"paged_attention: no kernel for device "
                           f"{q.device}")
    _check(q, k_pages, v_pages, block_tables, positions)
    B, nH, S, D = q.shape
    NB, kvH, bs, _ = k_pages.shape
    G = nH // kvH
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    route = _ROUTES[k_pages.dtype]
    w = head_dim_width("paged_attention", route, D, _DIMS)
    # (B, nH, S, D) is already the kv-major (B, kvH, G*S, D) fold
    qk = q.to(k_pages.dtype).contiguous()
    if w != D:
        qk, k_pages, v_pages = (_pad_d(t, w) for t in (qk, k_pages, v_pages))
    o = torch.empty_like(qk)
    if qk.numel() == 0:
        return o[..., :D].to(q.dtype)
    fn = _build.function("paged_attention", "bigdl_paged_attention",
                         _ARGTYPES)
    err = fn(qk.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_tables.data_ptr(), positions.data_ptr(), o.data_ptr(),
             _DTYPES[k_pages.dtype], B, kvH, G * S, S, w, bs,
             block_tables.shape[1], scale,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    paged_decode_attention.launches += 1
    if w == D:
        paged_decode_attention.launches_by_route[route] += 1
        return o.to(q.dtype)
    paged_decode_attention.launches_by_route[route + _PADDED] += 1
    return o[..., :D].to(q.dtype).contiguous()


paged_decode_attention.launches = 0
paged_decode_attention.launches_by_route = dict.fromkeys(
    [r + p for r in _ROUTES.values() for p in ("", _PADDED)], 0)
