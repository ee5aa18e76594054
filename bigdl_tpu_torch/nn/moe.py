"""Mixture-of-Experts layer, single-program form (counterpart of
``bigdl_tpu/nn/moe.py``).

Top-1 routing with capacity (``parallel.moe.top1_routing``) and experts
evaluated through the dense dispatch / combine products, as the JAX
package computes them outside any kernel: four plain matrix products
(``torch.matmul`` / ``bmm``) over (tokens, experts, capacity) tensors.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.moe import expert_capacity, top1_routing
from .module import Module

__all__ = ["MixtureOfExperts"]


class MixtureOfExperts(Module):
    """Switch-style MoE FFN as an ordinary layer over (B, T, D) or (N, D)
    inputs: ``router`` (D, E), experts ``w1`` (E, D, hidden) and ``w2``
    (E, hidden, D), drawn N(0, 1/D) and N(0, 1/hidden) from
    ``generator``. The load-balance loss of the last forward is the state
    ``aux_loss``; ``call`` returns the output alone (JAX's generic
    ``apply`` of an FFN drops the state the same way)."""

    def __init__(self, hidden_size: int, n_experts: int,
                 ffn_hidden: Optional[int] = None,
                 capacity_factor: float = 1.25, name=None, generator=None):
        super().__init__(name=name)
        self.hidden_size = hidden_size
        self.n_experts = n_experts
        self.ffn_hidden = ffn_hidden or 4 * hidden_size
        self.capacity_factor = capacity_factor
        d, h, E = hidden_size, self.ffn_hidden, n_experts
        P = torch.nn.Parameter
        self.router = P(torch.empty(d, E))
        self.w1 = P(torch.empty(E, d, h))
        self.w2 = P(torch.empty(E, h, d))
        self.register_buffer("aux_loss", torch.zeros(()))
        self._reset(generator)

    def _reset(self, generator):
        d, h = self.hidden_size, self.ffn_hidden
        with torch.no_grad():
            for w, s in ((self.router, 1 / math.sqrt(d)),
                         (self.w1, 1 / math.sqrt(d)),
                         (self.w2, 1 / math.sqrt(h))):
                w.normal_(0.0, s, generator=generator)
            self.aux_loss.zero_()

    def _route(self, params, x):
        """(y, aux): the layer's output in x's shape and its load-balance
        loss."""
        shape = x.shape
        t = math.prod(shape[:-1])
        w1, w2, router = params["w1"], params["w2"], params["router"]
        dt = torch.promote_types(x.dtype, router.dtype)
        h = x.reshape(t, shape[-1]).to(dt)
        E = self.n_experts
        capacity = expert_capacity(t, E, self.capacity_factor)
        logits = h @ router.to(dt)
        dispatch, combine, aux = top1_routing(logits, capacity)
        # "td,tec->ecd", "ecd,edh->ech", "ech,ehd->ecd", "tec,ecd->td"
        expert_in = (dispatch.reshape(t, E * capacity).T @ h).reshape(
            E, capacity, -1)
        mid = F.relu(torch.bmm(expert_in, w1.to(dt)))
        out = torch.bmm(mid, w2.to(dt))
        y = combine.reshape(t, E * capacity) @ out.reshape(E * capacity, -1)
        return y.reshape(shape), aux

    def call(self, params, x, training: bool = False, generator=None):
        return self._route(params, x)[0]

    def apply(self, params, state, x, training: bool = False,
              generator=None):
        y, aux = self._route(params, x)
        return y, {**state, "aux_loss": aux}
