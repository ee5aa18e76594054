"""Paged attention (K2): the CUDA kernels and their plain version.

Replaces the Pallas kernel ``bigdl_tpu/kernels/paged_attention.py``
``paged_decode_attention`` (body ``_kernel``). Every call on the card takes
the split-K kernel ``csrc/paged_attention_sm90.cu`` (routes ``"f32_split"``
and ``"bf16_split"`` by page dtype; :func:`route`): the grid splits each
row's page walk into spans of logical keys (:func:`split_plan` sizes them
from the table's width and the card's SM count), each block writes a
float32 partial (acc, m, l) of its span, and a second kernel merges a row's
partials in split order; a table one split wide takes the first kernel
alone. ``csrc/paged_attention.cu`` (routes ``"f32"`` and ``"bf16"``: one
block per batch row and kv head walking the whole history) keeps its entry
point and counters; no rule picks it. The sources' header notes say what
bounds each on an H100 and what the design does about it.

:func:`paged_decode_attention` is the wrapper: tensors on the CPU take
:func:`paged_attention_reference` (the gathered-view einsum of
``Attention._paged_gather_attend``, the JAX kernel's own oracle); tensors
on a CUDA device launch the kernels or raise.

dtype rule: the pages may be float32 while q is bfloat16 (bf16 weights
over the default float32 pool). The wrapper casts q to the page dtype (q
is small), as JAX's type promotion of that pair does, and casts the output
back to q's dtype, as the Pallas kernel's output does.

Head dims: the kernels are instantiated for every multiple of 16 up to 256
(``_DIMS``); another D up to 256 takes the next one with q and the pages
zero-padded (exact, as for the flash kernels, but a copy of the pool: such
calls count under ``"<route>_padded"`` in ``launches_by_route``); a wider D
raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..utils.engine import refuse_unported
from . import _build
from .flash_attention import _PADDED, _pad_d, head_dim_width

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SPLIT_ROUTES = {torch.float32: "f32_split", torch.bfloat16: "bf16_split"}
# each route's (library, symbol); the split routes take the partials'
# scratch, the number of splits and their span beside the other arguments
_FN = {"f32_split": ("paged_attention_sm90", "bigdl_paged_attention_sm90"),
       "bf16_split": ("paged_attention_sm90", "bigdl_paged_attention_sm90"),
       "f32": ("paged_attention", "bigdl_paged_attention"),
       "bf16": ("paged_attention", "bigdl_paged_attention")}
_DIMS = tuple(range(16, 257, 16))
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_void_p])
_SPLIT_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_void_p])
# split sizing: a span holds 64 to 256 logical keys (a multiple of 16), and
# the grid aims at _WAVES blocks for each SM of the card (three fit one);
# measured on an H100 at the smoke's decode and long decode cases
_MIN_SPAN, _MAX_SPAN, _SPAN_STEP, _WAVES = 64, 256, 16, 2
_SMS = {}       # device index -> multiprocessor count


def route(page_dtype, d: int) -> str:
    """K2's route for pages of ``page_dtype`` and head dim ``d``: the
    split-K kernel (``"f32_split"`` / ``"bf16_split"``), which is
    instantiated for every head dim the wrapper takes (``_DIMS``)."""
    return _SPLIT_ROUTES[page_dtype]


def rows_per_block(d: int) -> int:
    """Query rows a block of the split-K kernel holds (``PagedCfg::R``): 8
    up to D = 64, 4 up to 128, 2 past it, so that a lane's D / 16 columns
    of q and of the output of every row stay within 64 registers."""
    return 8 if d <= 64 else 4 if d <= 128 else 2


def split_plan(B: int, kvH: int, rows: int, table_keys: int, d: int,
               sms: int):
    """(splits, span) of the split-K kernel for B batch rows of kvH heads
    and ``rows`` query rows (G * S) over a table of ``table_keys`` logical
    keys (max_blocks * block_size), on a card with ``sms``
    multiprocessors: enough splits that the grid has about _WAVES blocks
    an SM, each span at least _MIN_SPAN keys, and at most _MAX_SPAN keys a
    span however many blocks that makes; span a multiple of 16, splits x
    span covering the table. One split writes o directly."""
    keys = max(int(table_keys), 1)
    tiles = -(-rows // rows_per_block(d))
    want = -(-_WAVES * sms // max(B * kvH * tiles, 1))
    splits = max(-(-keys // _MAX_SPAN), min(want, keys // _MIN_SPAN), 1)
    span = -(-keys // splits)
    span = -(-span // _SPAN_STEP) * _SPAN_STEP
    return -(-keys // span), span


def _sm_count(device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


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
    rt = route(k_pages.dtype, D)
    w = head_dim_width("paged_attention", rt, D, _DIMS)
    # (B, nH, S, D) is already the kv-major (B, kvH, G*S, D) fold
    qk = q.to(k_pages.dtype).contiguous()
    if w != D:
        qk, k_pages, v_pages = (_pad_d(t, w) for t in (qk, k_pages, v_pages))
    o = torch.empty_like(qk)
    if qk.numel() == 0:
        return o[..., :D].to(q.dtype)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (qk.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), positions.data_ptr(), o.data_ptr())
    shape = (B, kvH, G * S, S, w, bs, block_tables.shape[1])
    if rt.endswith("_split"):
        splits, span = split_plan(B, kvH, G * S, block_tables.shape[1] * bs,
                                  w, _sm_count(q.device))
        # the partials, held until the launches are queued
        part = (torch.empty(B * kvH * splits * G * S * (w + 2),
                            device=q.device) if splits > 1 else None)
        fn = _build.function(*_FN[rt], _SPLIT_ARGTYPES)
        err = fn(*args, part.data_ptr() if part is not None else None,
                 _DTYPES[k_pages.dtype], *shape, splits, span, scale, stream)
    else:
        fn = _build.function(*_FN[rt], _ARGTYPES)
        err = fn(*args, _DTYPES[k_pages.dtype], *shape, scale, stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed ({rt}): "
                           f"CUDA error {err}")
    paged_decode_attention.launches += 1
    if w == D:
        paged_decode_attention.launches_by_route[rt] += 1
        return o.to(q.dtype)
    paged_decode_attention.launches_by_route[rt + _PADDED] += 1
    return o[..., :D].to(q.dtype).contiguous()


paged_decode_attention.launches = 0
paged_decode_attention.launches_by_route = dict.fromkeys(
    [r + p for r in _FN for p in ("", _PADDED)], 0)
