"""Sequence-sharded KV-cache decode (counterpart of
``bigdl_tpu/parallel/seq_decode.py``).

The cache is split over a mesh axis along TIME: rank d owns the global
positions d*Tl .. (d+1)*Tl - 1. Each step writes this step's K/V on the
owning rank only, runs one partial attention over this rank's slice, and
merges the ranks' online-softmax statistics with three small collectives:
the maximum of the running maxima (``collective._pmax``), then the sums
of the rescaled weights and of the weighted values. Per step a rank reads
only its 1/n of the cache.
"""
from __future__ import annotations

import math

import torch

from . import collective
from .collective import _pmax

__all__ = ["make_seq_sharded_decoder"]


def _partial_decode_attention(q, k_shard, v_shard, pos, axis):
    """q (B, H, 1, D) replicated; k/v (B, kvH, Tl, D) this rank's slice of
    global positions d*Tl..; returns the merged (B, H, 1, D)."""
    group, _, d_ix = collective.axis_group(axis)
    tl = k_shard.shape[2]
    base = d_ix * tl
    b, h, _, dd = q.shape
    groups = h // k_shard.shape[1]
    qg = q.reshape(b, h // groups, groups, dd)
    s = torch.einsum("bkgd,bktd->bkgt", qg, k_shard) / math.sqrt(dd)
    keep = (base + torch.arange(tl, device=q.device)) <= pos
    s = torch.where(keep[None, None, None], s, torch.full_like(s, -1e30))
    m = _pmax(s.amax(-1), axis)                          # (B, kvH, G)
    p = torch.exp(s - m[..., None])
    l = collective.psum(p.sum(-1), axis)
    o = collective.psum(torch.einsum("bkgt,bktd->bkgd", p.to(v_shard.dtype),
                                     v_shard), axis)
    out = o / l.clamp(min=1e-30)[..., None]
    return out.reshape(b, h, 1, dd).to(q.dtype)


def _shard_write(cache, x_t, pos, axis):
    """Write x_t (B, kvH, 1, D) at GLOBAL position ``pos`` into this rank's
    time slice, in place; a no-op on every rank but the owner."""
    _, _, d_ix = collective.axis_group(axis)
    tl = cache.shape[2]
    local = pos - d_ix * tl
    if 0 <= local < tl:
        cache[:, :, local] = x_t[:, :, 0].to(cache.dtype)
    return cache


def make_seq_sharded_decoder(mesh, axis: str = "seq"):
    """A decode step over a time-sharded KV cache:
    ``decode(q, k_t, v_t, k_cache, v_cache, pos)`` writes this step's K/V
    (B, kvH, 1, D) at global ``pos`` (an int) into the owning rank's slice,
    attends q (B, nH, 1, D) over every position <= pos, and returns (out,
    k_cache, v_cache). The caches are this rank's (B, kvH, Tmax/n, D)
    slices, written in place; GQA caches are compact. ``pos`` must be <
    Tmax, as in JAX (no rank owns a later position)."""

    def decode(q, k_t, v_t, k_cache, v_cache, pos):
        pos = int(pos)
        with collective.over(mesh):
            k_cache = _shard_write(k_cache, k_t, pos, axis)
            v_cache = _shard_write(v_cache, v_t, pos, axis)
            out = _partial_decode_attention(q, k_cache, v_cache, pos, axis)
        return out, k_cache, v_cache

    return decode
