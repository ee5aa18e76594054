"""Ring attention with flash-kernel blocks and the hand-derived ring
backward (counterpart of ``bigdl_tpu/parallel/ring_flash.py``).

Each rank holds T/n of Q, K and V. Forward: the K/V blocks travel around
the ring while each block's (output, logsumexp) pair from the flash
forward (K1-fwd, ``kernels.flash_attention.flash_fwd``) merges into this
rank's output by the log-sum-exp rule. Backward (the flash-attention-2
recomputation as a second ring pass): delta = rowsum(dO * O) is computed
once, outside the hops; each block's contribution is the flash backward
(K1-bwd, ``flash_bwd(..., delta=, out_dtype=torch.float32)``) from the
global (O, lse); the dK / dV accumulators travel with their K / V blocks
and arrive home after n hops while dQ stays, all in float32, cast once at
the end. Under ``causal``, a block wholly after this rank's queries
(``src > idx``) launches nothing, the diagonal block runs the causal
kernel and earlier blocks the full one. Residuals are (q, k, v, o, lse).

The hop is ``collective._rotate``: a send / receive pair, staged through
host buffers on a gloo group with CUDA tensors (``collective._hop_route``).
On the CPU the kernels' plain versions run.
"""
from __future__ import annotations

import torch

from ..kernels.flash_attention import flash_bwd, flash_fwd
from . import collective
from .collective import _rotate

__all__ = ["ring_flash_attention", "make_ring_flash_attention"]


def _merge(o, lse, o_i, lse_i):
    """Merge a block's (o_i, lse_i) into the running (o, lse)."""
    new = torch.logaddexp(lse, lse_i)
    w = torch.exp(lse - new)[..., None].to(o.dtype)
    w_i = torch.exp(lse_i - new)[..., None].to(o.dtype)
    return o * w + o_i * w_i, new


def _blocks(n, idx, causal):
    """(step, diagonal) of the ring steps that launch a block."""
    for s in range(n):
        src = (idx - s) % n
        if causal and src > idx:
            continue
        yield s, causal and src == idx


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, n, idx, causal):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        b, h, tb, _ = q.shape
        o = torch.zeros_like(q)
        lse = torch.full((b, h, tb), float("-inf"), dtype=torch.float32,
                         device=q.device)
        live = dict(_blocks(n, idx, causal))
        kb, vb = k, v
        for s in range(n):
            if s in live:
                o_i, lse_i = flash_fwd(q, kb, vb, causal=live[s])
                o, lse = _merge(o, lse, o_i, lse_i)
            if s < n - 1:
                kb, vb = _rotate(kb, group, n, 1), _rotate(vb, group, n, 1)
        o = o.contiguous()
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.ring = (group, n, idx, causal)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        group, n, idx, causal = ctx.ring
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1)    # hop-invariant
        live = dict(_blocks(n, idx, causal))
        kb, vb = k, v
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        for s in range(n):
            if s in live:
                dq_i, dk_i, dv_i = flash_bwd(q, kb, vb, o, lse, do,
                                             causal=live[s], delta=delta,
                                             out_dtype=torch.float32)
                dq += dq_i
                dk += dk_i
                dv += dv_i
            if s < n - 1:
                kb, vb = _rotate(kb, group, n, 1), _rotate(vb, group, n, 1)
            # the accumulators ride with their blocks: n hops bring them home
            dk, dv = _rotate(dk, group, n, 1), _rotate(dv, group, n, 1)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def ring_flash_attention(q, k, v, axis: str = "seq", causal: bool = False):
    """q, k, v: this rank's (B, H, Tblock, D) blocks (block i on rank i of
    ``axis``); returns this rank's output block. Differentiable (the ring
    backward above)."""
    group, n, idx = collective.axis_group(axis)
    return _RingFlash.apply(q, k, v, group, n, idx, bool(causal))


def make_ring_flash_attention(mesh, axis: str = "seq",
                              causal: bool = False):
    """``f(q, k, v)`` over this rank's (B, H, T/n, D) blocks on ``mesh``
    (JAX's ``shard_map`` over the global arrays; a rank holds and returns
    only its block)."""
    def f(q, k, v):
        with collective.over(mesh):
            return ring_flash_attention(q, k, v, axis=axis, causal=causal)
    return f
