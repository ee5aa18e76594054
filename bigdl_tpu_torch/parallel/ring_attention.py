"""Ring attention: sequence parallelism over a mesh ``seq`` axis
(counterpart of ``bigdl_tpu/parallel/ring_attention.py``).

Each rank holds a T/n block of Q, K and V; the K/V blocks travel around
the ring (``collective.ppermute_ring``, n hops) while an online softmax
accumulates this rank's output block, so memory per rank is O(T/n). This
is the plain form (einsum blocks, autograd through the hops, whose
gradient is the reverse rotation); ``ring_flash`` is the kernel form.

JAX calls it inside ``shard_map``; the port's ranks each call it on their
own block, with the axis resolving on the mesh ``collective.over`` sets.
"""
from __future__ import annotations

import math

import torch

from . import collective
from .collective import ppermute_ring

__all__ = ["ring_attention", "make_ring_attention"]


def ring_attention(q, k, v, axis: str = "seq", causal: bool = False):
    """q, k, v: this rank's (B, H, Tblock, D) blocks (block i of the
    sequence on rank i of ``axis``). Returns this rank's output block."""
    _, n, idx = collective.axis_group(axis)
    tb, d = q.shape[-2], q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    q_pos = idx * tb + torch.arange(tb, device=q.device)
    b, h = q.shape[0], q.shape[1]
    m = torch.full((b, h, tb), float("-inf"), dtype=q.dtype, device=q.device)
    l = torch.zeros((b, h, tb), dtype=q.dtype, device=q.device)
    o = torch.zeros_like(q)
    k_blk, v_blk = k, v
    for step in range(n):
        src = (idx - step) % n          # whose block this rank holds
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k_blk) * scale
        if causal:
            k_pos = src * tb + torch.arange(tb, device=q.device)
            keep = q_pos[:, None] >= k_pos[None, :]
            logits = logits.masked_fill(~keep, float("-inf"))
        new_m = torch.maximum(m, logits.amax(-1))
        safe_m = torch.where(torch.isfinite(new_m), new_m,
                             torch.zeros_like(new_m))
        p = torch.exp(logits - safe_m[..., None])
        p = torch.where(torch.isfinite(logits), p, torch.zeros_like(p))
        corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m),
                           torch.zeros_like(m))
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v_blk)
        m = new_m
        k_blk = ppermute_ring(k_blk, axis)
        v_blk = ppermute_ring(v_blk, axis)
    return o / l[..., None].clamp(min=1e-20)


def make_ring_attention(mesh, axis: str = "seq", causal: bool = False):
    """``f(q, k, v)`` over this rank's (B, H, T/n, D) blocks on ``mesh``
    (JAX's ``shard_map`` of :func:`ring_attention` over the global
    arrays; a rank holds and returns only its block)."""
    def f(q, k, v):
        with collective.over(mesh):
            return ring_attention(q, k, v, axis=axis, causal=causal)
    return f
