"""Switch-style top-1 routing (counterpart of ``bigdl_tpu/parallel/moe.py``).

Routing builds dense (tokens, experts, capacity) dispatch and combine
tensors (the Mesh-TensorFlow formulation), so a mixture-of-experts layer
moves its tokens with two products and no dynamic shapes.

Every step runs in the logits' dtype, as the JAX package's does, and
rounds where JAX rounds: the softmax is ``exp(x - max)`` over its sum (the
sum accumulated in float32 and rounded once, as ``jnp.sum`` upcasts bf16),
and the queue positions are a cumulative sum of the one-hot assignment in
that dtype, summed in the order XLA sums it (:func:`_cumsum`). In bf16 the positions round past 256, so several tokens can
share one capacity slot; the port reproduces this (ROADMAP.md, reference
caveats) instead of fixing it.

``moe_ffn`` is the expert-parallel layer: one expert per rank of an
``expert`` axis, which doubles as the token axis; two ``all_to_all``
exchanges move each rank's queues to the experts' owners and back.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

__all__ = ["expert_capacity", "top1_routing", "moe_ffn"]

_SCAN_BLOCK = 16    # XLA's CPU rewrite of a cumulative sum: 16-row blocks


def expert_capacity(tokens: int, n_experts: int, factor: float) -> int:
    """Per-expert queue length: ceil(factor * tokens / n_experts), min 1."""
    return max(1, math.ceil(factor * tokens / n_experts))


def _sum(x, dim, keepdim=False):
    """``jnp.sum``: float32 accumulation, the result in x's dtype."""
    return x.sum(dim, keepdim=keepdim, dtype=torch.float32).to(x.dtype)


def _mean(x, dim):
    """``jnp.mean``: the float32 sum over the count, in x's dtype (divided
    by a tensor: CUDA divides by a Python number through its reciprocal,
    which rounds differently)."""
    s = x.sum(dim, dtype=torch.float32)
    return (s / torch.full_like(s, x.shape[dim])).to(x.dtype)


def _cumsum(x):
    """``jnp.cumsum`` over dim 0 as XLA computes it on the CPU: in blocks
    of 16 rows, each summed one row after another in x's dtype (rounded
    at every add), the blocks' totals scanned the same way, recursively,
    and each block's exclusive prefix added to its own running sums. In
    bf16 this rounding pattern decides which tokens share a slot, so the
    port takes it over exactly (a float32 accumulation would round
    differently; on integer counts below 2^24 in float32 every order is
    exact)."""
    n = x.shape[0]
    if n <= 1:
        return x.clone()
    nb = -(-n // _SCAN_BLOCK)
    pad = x.new_zeros((nb * _SCAN_BLOCK,) + tuple(x.shape[1:]))
    pad[:n] = x
    blocks = pad.reshape((nb, _SCAN_BLOCK) + tuple(x.shape[1:]))
    runs = [blocks[:, 0]]
    for i in range(1, _SCAN_BLOCK):
        runs.append(runs[-1] + blocks[:, i])
    within = torch.stack(runs, 1)
    if nb == 1:
        return within.reshape(pad.shape)[:n]
    incl = _cumsum(within[:, -1])
    excl = torch.cat([torch.zeros_like(incl[:1]), incl[:-1]])
    return (excl[:, None] + within).reshape(pad.shape)[:n]


def _softmax(x):
    """``jax.nn.softmax`` over the last dim, rounded op by op in x's dtype."""
    e = torch.exp(x - x.max(-1, keepdim=True).values)
    return e / _sum(e, -1, keepdim=True)


def top1_routing(logits, capacity: int):
    """Switch routing: (tokens, E) logits -> dispatch (t, E, C) 0/1,
    combine (t, E, C) gate-weighted, and the load-balance aux loss, each
    in the logits' dtype (JAX's dispatch is a bool-valued array of that
    dtype too)."""
    t, E = logits.shape
    dt = logits.dtype
    probs = _softmax(logits)
    gate = probs.max(-1).values
    expert = probs.argmax(-1)               # the first maximum, as jnp's
    onehot = F.one_hot(expert, E).to(dt)                        # (t, E)
    # position of each token within its expert's queue
    pos = _cumsum(onehot) * onehot - 1.0                # (t, E)
    pos_of_token = _sum(pos * onehot, -1)                       # (t,)
    keep = pos_of_token < capacity
    # clipped in float32: a bf16 bound of capacity - 1 can round up to
    # capacity, out of one_hot's range (the rows it changes are dropped)
    pos_clip = pos_of_token.float().clamp(0, capacity - 1).to(torch.int64)
    pos_onehot = F.one_hot(pos_clip, capacity).to(dt)           # (t, C)
    dispatch = (onehot * keep[:, None].to(dt))[:, :, None] \
        * pos_onehot[:, None, :]                                # (t, E, C)
    combine = dispatch * gate[:, None, None]
    # load-balance auxiliary loss (Switch Transformer eq. 4)
    frac_tokens = _mean(onehot, 0)
    frac_probs = _mean(probs, 0)
    aux = E * _sum(frac_tokens * frac_probs, -1)
    return dispatch, combine, aux


def moe_ffn(expert_fn: Callable, axis: str = "expert",
            capacity_factor: float = 1.25):
    """The per-rank expert-parallel MoE apply: ``expert_fn(expert_params,
    x) -> y`` is one expert's FFN over an (n, d) batch. Returns
    ``run(router_w, expert_params, x)``: ``router_w`` (d, E) the same on
    every rank, ``expert_params`` this rank's expert (leading expert dim
    of 1, squeezed here: exactly one expert a rank), ``x`` this rank's
    (t_local, d) tokens. Returns ((t_local, d) outputs, the aux loss
    averaged over the axis)."""
    from . import collective
    from .collective import all_to_all, pmean

    def squeeze(a):
        if a.dim() and a.shape[0] != 1:
            raise ValueError(
                "moe_ffn supports exactly one expert per device: local "
                f"expert-param slice has leading dim {a.shape[0]} (shard "
                "the stacked expert axis over the mesh axis)")
        return a[0] if a.dim() else a

    def tree(fn, t):
        if isinstance(t, dict):
            return {k: tree(fn, v) for k, v in t.items()}
        return fn(t)

    def run(router_w, expert_params, x):
        _, E, _ = collective.axis_group(axis)
        tloc, d = x.shape
        expert_params = tree(squeeze, expert_params)
        capacity = expert_capacity(tloc, E, capacity_factor)
        logits = x @ router_w                                   # (t, E)
        dispatch, combine, aux = top1_routing(logits, capacity)
        expert_in = torch.einsum("td,tec->ecd", x, dispatch)    # (E, C, d)
        # queue e goes to expert e's owner; this rank receives every
        # rank's queue for its own expert, stacked by source rank
        recv = all_to_all(expert_in, axis, split_axis=0, concat_axis=0)
        out = expert_fn(expert_params, recv.reshape(E * capacity, d))
        back = all_to_all(out.reshape(E, capacity, -1), axis, split_axis=0,
                          concat_axis=0)
        y = torch.einsum("tec,ecd->td", combine, back)
        return y, pmean(aux, axis)

    return run
