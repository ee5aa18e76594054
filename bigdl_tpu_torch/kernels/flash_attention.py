"""Flash attention forward (K1-fwd) and backward (K1-bwd): the CUDA kernels,
their plain versions and the ``autograd.Function`` around them.

Replaces the Pallas kernels of ``bigdl_tpu/kernels/flash_attention.py``:
``_flash_fwd`` (body ``_fwd_kernel``) and ``_flash_bwd`` (``_bwd_kv_kernel``,
``_bwd_q_kernel``). Each wrapper picks its kernel by its own route rule:

- ``"bf16_sm90"``: bfloat16 inputs take the tensor-core kernels
  ``csrc/flash_fwd_sm90.cu`` and ``csrc/flash_bwd_sm90.cu`` (bf16 wgmma over
  TMA-staged tiles);
- ``"f32_sm90"``: float32 calls up to the widest head dim of the 3xTF32
  kernels (wgmma on tf32 hi and lo halves of each float32 operand, three
  products, which keeps float32 accuracy) take them: forwards with D up
  to 112 ``csrc/flash_fwd_tf32_sm90.cu`` (a split kernel writes K's and
  V^T's halves into scratch first; :func:`fwd_route`), backwards with D up
  to 64 ``csrc/flash_bwd_tf32_sm90.cu`` (the streamed tiles split and
  transposed in shared memory; :func:`bwd_route`);
- ``"f32"``: wider float32 calls take the CUDA-core kernels
  ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` (float32 FMAs).

Each source's header note says what bounds it on an H100 and what the design
does about it. Besides ``<wrapper>.launches``, each wrapper counts its
launches per route in ``<wrapper>.launches_by_route``.

Head dims: each route's kernels are instantiated for the widths in
``_FWD_DIMS`` / ``_BWD_DIMS`` (the ``case`` lines of the sources). A D
between them goes to the next wider one with q, k, v (and dO)
zero-padded and the scale of the true D (:func:`head_dim_width`), which is
exact: zero columns add nothing to q.k and give zero output columns. Such
calls count under ``"<route>_padded"``. A float32 forward call past the
3xTF32 kernel's widest D takes the CUDA-core route; a D past a dtype's
widest raises.

:func:`flash_fwd` and :func:`flash_bwd` are the wrappers: tensors on the CPU
take :func:`flash_fwd_reference` / :func:`flash_bwd_reference`, the plain
PyTorch versions of the same functions; tensors on a CUDA device launch the
kernels or raise. :class:`FlashAttention` is the counterpart of the JAX
package's ``_flash`` ``custom_vjp``: forward through :func:`flash_fwd`,
saving (q, k, v, o, lse), backward through :func:`flash_bwd`. The wrappers
themselves build no graph, so they refuse tensors that require a gradient
while grad mode is on (inside the Function's forward it is off); the chunk
form (``q_offset``/``kv_len``) stays forward-only, as in JAX.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _build, _flops

_DTYPES = (torch.float32, torch.bfloat16)
# each route's (library, symbol) for the forward and backward (the routes:
# fwd_route, bwd_route)
_FWD_FN = {"bf16_sm90": ("flash_fwd_sm90", "bigdl_flash_fwd_sm90"),
           "f32_sm90": ("flash_fwd_tf32_sm90", "bigdl_flash_fwd_tf32_sm90"),
           "f32": ("flash_fwd", "bigdl_flash_fwd")}
_BWD_FN = {"bf16_sm90": ("flash_bwd_sm90", "bigdl_flash_bwd_sm90"),
           "f32_sm90": ("flash_bwd_tf32_sm90", "bigdl_flash_bwd_tf32_sm90"),
           "f32": ("flash_bwd", "bigdl_flash_bwd")}
# the head dims each route's kernels are instantiated for: every multiple
# of 16, up to 128 on the bf16 tensor cores (the accumulators of wider rows
# would not fit the consumers' registers), up to 112 for the 3xTF32 forward
# (the two float32 halves of a 128-row Q tile and two stages of K and V^T
# halves fill a block's shared memory) and 64 for the 3xTF32 backward (the
# hi and lo halves of 128 rows of K and V, the split and transposed set of a
# 32-row tile and two raw stages fill it), and on the CUDA cores as far as
# their float32 tiles fit in shared memory (the backward keeps four 64-row
# tiles of D + 1 floats)
_FWD_DIMS = {"bf16_sm90": tuple(range(16, 129, 16)),
             "f32_sm90": tuple(range(16, 113, 16)),
             "f32": tuple(range(16, 257, 16))}
_BWD_DIMS = {"bf16_sm90": tuple(range(16, 129, 16)),
             "f32_sm90": tuple(range(16, 65, 16)),
             "f32": tuple(range(16, 193, 16))}
_PADDED = "_padded"
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_void_p])
_SPLIT_KEYS = 8    # the 3xTF32 scratch holds kv_len keys rounded up to 8
_F32_BWD_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                     + [ctypes.c_float, ctypes.c_void_p])
_BWD_ARGTYPES = {
    "bf16_sm90": ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                  + [ctypes.c_float, ctypes.c_void_p]),
    "f32_sm90": _F32_BWD_ARGTYPES, "f32": _F32_BWD_ARGTYPES}


def flash_fwd_reference(q, k, v, causal: bool = False, q_offset: int = 0,
                        kv_len=None):
    """Plain version: softmax(q k^T / sqrt(D)) v over the first ``kv_len``
    keys, query row r at global position ``q_offset + r`` seeing keys
    ``<= q_offset + r`` when ``causal``. Computes in float32 and returns
    ``(o in q's dtype, lse float32 (B, H, Tq))``; a row that sees no key
    gives o = 0 and lse = -inf, as the kernel does. p is rounded to the
    input type before the PV product (a no-op in float32), where the JAX
    kernel rounds it (``flash_attention.py:104``); l sums it unrounded."""
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
    pr = p.to(q.dtype).float()
    o = torch.einsum("bhqk,bhkd->bhqd", pr, vf) / torch.where(
        l > 0, l, torch.ones_like(l))
    lse = torch.where(l > 0, m + torch.log(l),
                      torch.full_like(l, float("-inf")))[..., 0]
    return o.to(q.dtype), lse


def head_dim_width(fn: str, route: str, d: int, dims) -> int:
    """The instantiated width a call with head dim ``d`` launches on
    ``route``, whose kernels take ``dims``: d itself, or the next wider one
    (the wrapper zero-pads to it). Raises past the widest."""
    for w in dims:
        if w >= d:
            return w
    raise ValueError(f"{fn}: head dim {d} is wider than the {route!r} "
                     f"kernels take (at most {dims[-1]}); see ROADMAP.md "
                     f"B.5 (head dims past the widest instantiation)")


def fwd_route(dtype, d: int) -> str:
    """K1-fwd's route for a call with head dim ``d``: bfloat16 ->
    ``"bf16_sm90"``; float32 -> ``"f32_sm90"`` (3xTF32) up to the widest
    head dim that kernel is instantiated for, else ``"f32"`` (the CUDA
    cores)."""
    if dtype == torch.bfloat16:
        return "bf16_sm90"
    return "f32_sm90" if d <= _FWD_DIMS["f32_sm90"][-1] else "f32"


def bwd_route(dtype, d: int) -> str:
    """K1-bwd's route for a call with head dim ``d``: bfloat16 ->
    ``"bf16_sm90"``; float32 -> ``"f32_sm90"`` (3xTF32) up to the widest
    head dim that kernel is instantiated for, else ``"f32"`` (the CUDA
    cores)."""
    if dtype == torch.bfloat16:
        return "bf16_sm90"
    return "f32_sm90" if d <= _BWD_DIMS["f32_sm90"][-1] else "f32"


def _kv_split(route, B, H, kv_len, w, device):
    """(scratch, the trailing C arguments) of a forward route: the 3xTF32
    entry takes 4 x B x H x kvp x w float32 (kvp: kv_len rounded up to 8,
    at least 8) for the tf32 hi and lo halves of K and V^T, which its split
    kernel writes each call; the other routes take none. The caller holds
    the scratch until the launch is queued."""
    if route != "f32_sm90":
        return None, ()
    kvp = -(-max(kv_len, 1) // _SPLIT_KEYS) * _SPLIT_KEYS
    t = torch.empty(4 * B * H * kvp * w, device=device)
    return t, (t.data_ptr(),)


def _pad_d(t, w):
    """t with its last dim zero-padded to ``w`` (a new contiguous
    tensor)."""
    return F.pad(t, (0, w - t.shape[-1]))


def _check(fn, q, k, v, *same_as_q):
    """What both kernels take: (B, H, T, D) contiguous tensors of one
    dtype (float32 or bfloat16) on q's device, k/v of one shape;
    ``same_as_q`` (o, dO) of q's shape."""
    for name, t in (("q", q), ("k", k), ("v", v)) + same_as_q:
        if t.device != q.device:
            raise ValueError(f"{fn}: {name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{fn}: {name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{fn}: {name} must be (B, H, T, D), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            raise ValueError(f"{fn}: the kernel builds no autograd graph; "
                             f"differentiate through FlashAttention or run "
                             f"under torch.no_grad()")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{fn}: dtype {q.dtype} not supported "
                        f"(float32, bfloat16)")
    B, H, _, D = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError(f"{fn}: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} disagree")
    for name, t in same_as_q:
        if t.shape != q.shape:
            raise ValueError(f"{fn}: {name}{tuple(t.shape)} is not shaped "
                             f"like q{tuple(q.shape)}")


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
    _check("flash_fwd", q, k, v)
    if not 0 <= kv_len <= k.shape[2] or q_offset < 0:
        raise ValueError(f"flash_fwd: kv_len {kv_len} / q_offset "
                         f"{q_offset} out of range for {k.shape[2]} keys")
    B, H, Tq, D = q.shape
    route = fwd_route(q.dtype, D)
    w = head_dim_width("flash_fwd", route, D, _FWD_DIMS[route])
    if w != D:
        q, k, v = (_pad_d(t, w) for t in (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o[..., :D], lse
    ws, extra = _kv_split(route, B, H, kv_len, w, q.device)  # held
    fn = _build.function(*_FWD_FN[route],
                         _ARGTYPES + [ctypes.c_void_p] * len(extra))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), B, H, Tq, k.shape[2], w, int(bool(causal)),
             q_offset, kv_len, 1.0 / math.sqrt(D),
             torch.cuda.current_stream(q.device).cuda_stream, *extra)
    if err:
        raise RuntimeError(f"flash_fwd kernel launch failed ({route}): "
                           f"CUDA error {err}")
    flash_fwd.launches += 1
    _flops.tally("flash_fwd", _fwd_flops(q, kv_len, D))
    if w == D:
        flash_fwd.launches_by_route[route] += 1
        return o, lse
    flash_fwd.launches_by_route[route + _PADDED] += 1
    return o[..., :D].contiguous(), lse


flash_fwd.launches = 0
flash_fwd.launches_by_route = dict.fromkeys(
    [r + p for r in _FWD_FN for p in ("", _PADDED)], 0)


def _fwd_flops(q, kv_len, d):
    """The FLOPs of the plain forward's two products (the cost notes'
    tally of a launch; ``kernels._flops``)."""
    B, H, Tq = q.shape[:3]
    return _flops.attention(B, H, Tq, kv_len, d)


def _bwd_flops(q, k, d):
    """The FLOPs of the plain backward's five (Tq x Tkv x D) products."""
    B, H, Tq = q.shape[:3]
    return 10 * B * H * Tq * k.shape[2] * d


def flash_bwd_reference(q, k, v, o, lse, do, causal: bool = False,
                        delta=None, out_dtype=None):
    """Plain version of the backward: gradients of
    softmax(q k^T / sqrt(D)) v (causal: key c visible to row r iff
    c <= r) from the forward's o and lse and the output gradient ``do``.
    Recomputes p = exp(s - lse) in float32 (0 on masked keys and on rows
    whose lse is -inf), then dV = p^T dO, ds = p (dO v^T - delta) / sqrt(D),
    dK = ds^T q, dQ = ds k, with p and ds rounded to the input type before
    their products (a no-op in float32) where the JAX kernels round them
    (``flash_attention.py:215``, ``:218``, ``:256``). ``delta`` (B, H, Tq)
    float32 defaults to rowsum(dO * O). Returns (dq, dk, dv) in
    ``out_dtype`` (default: the input dtype)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    dt = q.dtype
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    keep = torch.isfinite(lse)[..., None].expand_as(s)
    if causal:
        rows = torch.arange(q.shape[2], device=q.device)
        cols = torch.arange(k.shape[2], device=q.device)
        keep = keep & (cols[None, :] <= rows[:, None])
    p = torch.where(keep, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    if delta is None:
        delta = (dof * o.float()).sum(-1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dt).float(), dof)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf)
              - delta[..., None]) * scale
    dsr = ds.to(dt).float()
    dk = torch.einsum("bhqk,bhqd->bhkd", dsr, qf)
    dq = torch.einsum("bhqk,bhkd->bhqd", dsr, kf)
    out = out_dtype or dt
    return dq.to(out), dk.to(out), dv.to(out)


def flash_bwd(q, k, v, o, lse, do, causal: bool = False, delta=None,
              out_dtype=None):
    """Flash attention backward (K1-bwd): q (B, H, Tq, D), k/v (B, H, Tkv,
    D), the forward's o (like q) and lse (B, H, Tq) float32, and the output
    gradient ``do`` (like q). Returns (dq, dk, dv) in ``out_dtype``: the
    input dtype by default, or ``torch.float32`` for callers that sum the
    gradients of several calls (the JAX ``_flash_bwd``'s ``out_dtype``).
    delta = rowsum(dO * O) (B, H, Tq) float32 is computed here with one
    torch op, as the JAX package computes it in XLA outside its kernels,
    unless the caller passes it (``delta``, as a ring backward does). The
    CUDA side launches the dK/dV kernel and then the dQ kernel (one launch
    of the pair is one count in ``flash_bwd.launches``)."""
    if out_dtype not in (None, q.dtype, torch.float32):
        raise TypeError(f"flash_bwd: out_dtype {out_dtype} not supported "
                        f"(the input dtype or float32)")
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, o, lse, do, causal, delta,
                                   out_dtype)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_bwd: no kernel for device {q.device}")
    _check("flash_bwd", q, k, v, ("o", o), ("do", do))
    B, H, Tq, D = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t is not None and (t.shape != (B, H, Tq)
                              or t.dtype != torch.float32
                              or t.device != q.device
                              or not t.is_contiguous()):
            raise ValueError(f"flash_bwd: {name} must be contiguous float32 "
                             f"{(B, H, Tq)} on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    route = bwd_route(q.dtype, D)
    out = out_dtype or q.dtype
    if delta is None:
        delta = (do.float() * o.float()).sum(-1)
    w = head_dim_width("flash_bwd", route, D, _BWD_DIMS[route])
    if w != D:
        q, k, v, do = (_pad_d(t, w) for t in (q, k, v, do))
    dq = torch.empty(q.shape, dtype=out, device=q.device)
    dk = torch.empty(k.shape, dtype=out, device=q.device)
    dv = torch.empty(v.shape, dtype=out, device=q.device)
    fn = _build.function(*_BWD_FN[route], _BWD_ARGTYPES[route])
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr())
    flags = (int(out == torch.float32),) if route == "bf16_sm90" else ()
    err = fn(*ptrs, *flags, B, H, Tq, k.shape[2], w, int(bool(causal)),
             1.0 / math.sqrt(D),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_bwd kernel launch failed ({route}): "
                           f"CUDA error {err}")
    flash_bwd.launches += 1
    _flops.tally("flash_bwd", _bwd_flops(q, k, D))
    if w == D:
        flash_bwd.launches_by_route[route] += 1
        return dq, dk, dv
    flash_bwd.launches_by_route[route + _PADDED] += 1
    return tuple(t[..., :D].contiguous() for t in (dq, dk, dv))


flash_bwd.launches = 0
flash_bwd.launches_by_route = dict.fromkeys(
    [r + p for r in _BWD_FN for p in ("", _PADDED)], 0)


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the JAX package's ``_flash``
    ``custom_vjp``): ``FlashAttention.apply(q, k, v, causal)`` -> o. The
    forward saves (q, k, v, o, lse); the backward runs :func:`flash_bwd` on
    a contiguous dO."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_fwd(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(), ctx.causal)
        return dq, dk, dv, None


def flash_attention_fused(q, k, v, causal: bool = False,
                          scale: float | None = None,
                          block_q: int = 512, block_k: int = 512,
                          interpret: bool = False):
    """Differentiable flash attention, the JAX package's public entry:
    q, k, v (B, H, T, D) -> (B, H, T, D), ``FlashAttention.apply``
    (K1-fwd, and K1-bwd for the gradient). ``scale`` is 1/sqrt(D) and
    ``block_q`` / ``block_k`` are the TPU kernel's tile sizes: other
    values are refused. ``interpret`` selects JAX's Pallas interpreter,
    which has no counterpart here; it is accepted and does nothing (a CPU
    tensor always runs the plain version, a CUDA tensor the kernel)."""
    _refuse_tiles("flash_attention_fused", q, scale, block_q, block_k)
    return FlashAttention.apply(q, k, v, bool(causal))


def flash_chunk_attention(q, k, v, q_offset: int, kv_len: int = None,
                          scale: float | None = None,
                          block_q: int = 512, block_k: int = 512,
                          interpret: bool = False):
    """Rectangular-causal flash attention for chunked cached decode, the
    JAX package's public entry: q (B, H, S, D) at positions
    ``q_offset..q_offset+S-1`` over the first ``kv_len`` keys of k / v
    (all of them by default); row r attends keys <= q_offset + r. Forward
    only, as JAX's. ``scale``, ``block_q`` / ``block_k`` and
    ``interpret`` as in :func:`flash_attention_fused`."""
    _refuse_tiles("flash_chunk_attention", q, scale, block_q, block_k)
    return flash_fwd(q, k, v, causal=True, q_offset=int(q_offset),
                     kv_len=kv_len)[0]


def _refuse_tiles(owner, q, scale, block_q, block_k):
    from ..utils.engine import refuse_unported
    default = 1.0 / math.sqrt(q.shape[-1])
    refuse_unported(owner,
                    scale=(default if scale is None else float(scale),
                           default),
                    block_q=(int(block_q), 512), block_k=(int(block_k), 512))


__all__ = ["flash_fwd_reference", "head_dim_width", "fwd_route", "bwd_route",
           "flash_fwd", "flash_bwd_reference", "flash_bwd", "FlashAttention",
           "flash_attention_fused", "flash_chunk_attention"]
