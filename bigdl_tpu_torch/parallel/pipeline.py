"""Pipeline parallelism, the GPipe schedule over a ``pipe`` mesh axis
(counterpart of ``bigdl_tpu/parallel/pipeline.py``).

Every rank holds ONE stage's parameters (a homogeneous stack, such as
transformer blocks); activations hop stage to stage around the ring
(``collective.ppermute_ring``) once a tick, and microbatches fill the
pipe (bubble (S-1)/(S-1+M)). JAX's ``lax.scan`` over the ticks is a Python
loop here, and the backward schedule comes from autograd: the gradient of
a hop is the reverse hop. Every rank runs every tick (stage 0 on the
microbatch, later stages on what they received), and the choices between
the two are ``torch.where``, so every rank's graph holds every hop and
the ranks' backward passes meet at the same reverse hops.

Gradients follow the port's collective convention: each rank's loss is
its share of the whole (the replicated output's loss over n), and the
last stage's outputs reach every rank through a masked ``psum`` whose
backward sums the shares.
"""
from __future__ import annotations

from typing import Callable

import torch

from . import collective
from .collective import ppermute_ring, psum

__all__ = ["gpipe", "stack_stage_params", "unstack_stage_params"]


def _tree_map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def gpipe(stage_fn: Callable, axis: str = "pipe"):
    """The per-rank pipelined apply: ``stage_fn(stage_params, x) -> y``
    must keep x's shape. Returns ``run(params, x_stack)``: ``params`` this
    rank's stage (a leading stage dim of 1 is squeezed), ``x_stack``
    (n_micro, micro_batch, ...) the same on every rank; returns the last
    stage's (n_micro, micro_batch, ...) outputs on every rank."""

    def run(params, x_stack):
        _, n_stages, idx = collective.axis_group(axis)
        n_micro = x_stack.shape[0]
        ticks = n_micro + n_stages - 1
        params = _tree_map(lambda a: a[0] if a.dim() and a.shape[0] == 1
                           else a, params)
        first = torch.tensor(idx == 0, device=x_stack.device)
        recv = torch.zeros_like(x_stack[0])
        outs = [torch.zeros_like(x_stack[0]) for _ in range(n_micro)]
        for t in range(ticks):
            mb = min(max(t, 0), n_micro - 1)
            out = stage_fn(params, torch.where(first, x_stack[mb], recv))
            # the last stage finishes microbatch m at tick m + S - 1
            m = t - (n_stages - 1)
            if m >= 0:
                valid = torch.tensor(idx == n_stages - 1,
                                     device=x_stack.device)
                outs[m] = torch.where(valid, out, outs[m])
            recv = ppermute_ring(out, axis)
        is_last = float(idx == n_stages - 1)
        return psum(torch.stack(outs) * is_last, axis)

    return run


def stack_stage_params(per_stage_params):
    """Stack a list of per-stage parameter trees along a new leading dim."""
    return _tree_map(lambda *xs: torch.stack(list(xs), 0), *per_stage_params)


def unstack_stage_params(stacked, n_stages: int):
    """Inverse of :func:`stack_stage_params`."""
    return [_tree_map(lambda a, i=i: a[i], stacked) for i in range(n_stages)]
