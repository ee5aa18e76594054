"""Weight-only int8 / int4 quantization for the transformer LM inference
path (counterpart of ``bigdl_tpu/quantization/lm.py``).

Decode is bound by the bytes of the weights: every generated token reads
all block weights again while the activations are one row. The block
matmul weights are stored as int8 with per-output-channel scales, or int4
with a scale per group of contraction rows. :class:`QuantizedWeight` and
:class:`QuantizedWeightInt4` compute ``x @ w`` through ``__rmatmul__``,
so quantized params drop into the unchanged forward / prefill / decode
code, as in JAX; the tied embedding stays dense.

``__rmatmul__`` is JAX's arithmetic in plain PyTorch:
``(x @ q.to(x.dtype)) * s.to(x.dtype)``, and the int4 form its two
einsums. On the card that is a cuBLAS product over a dequantized copy
(JAX leaves it to XLA too, outside any Pallas kernel); a fused
dequantizing matmul kernel is later work.

Both classes are :class:`~bigdl_tpu_torch.utils.carrier.TreeCarrier`
nodes with children ``(q, s)``: the port's tree walkers (device placement,
``bf16_params``, the collectives' and the pipeline's maps, ``convert``)
go into them as JAX's walks go into the registered pytrees.

int4 storage: torch has no int4 dtype the card computes with, so the
codes are held in an ``int8`` tensor with values in [-8, 7];
:func:`lm_quantized_bytes` counts them at JAX's packed size, two a byte.
"""
from __future__ import annotations

import logging
import math

import torch

from ..utils.carrier import TreeCarrier

__all__ = ["QuantizedWeight", "QuantizedWeightInt4", "quantize_weight_int8",
           "quantize_weight_int4", "quantize_lm_params",
           "lm_quantized_bytes"]


class QuantizedWeight(TreeCarrier):
    """Per-output-channel symmetric int8 weight: ``w ≈ q * s``.

    Supports the one operation the transformer stack needs
    (``x @ w`` via ``__rmatmul__``); anything else should fail loudly
    rather than silently densify.
    """

    def __init__(self, q, s):
        self.q = q            # (K, N) int8
        self.s = s            # (N,) f32 scale

    def children(self):
        return (self.q, self.s)

    def with_children(self, children):
        return QuantizedWeight(*children)

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):  # the EFFECTIVE dtype seen by consumers
        return self.s.dtype

    def __rmatmul__(self, x):
        return (x @ self.q.to(x.dtype)) * self.s.to(x.dtype)

    def dequantize(self):
        return self.q.to(self.s.dtype) * self.s

    def __repr__(self):
        return f"QuantizedWeight{tuple(self.q.shape)}"


class QuantizedWeightInt4(TreeCarrier):
    """Group-wise symmetric int4 weight: ``w[k, n] ≈ q[k, n] * s[k//g, n]``.

    int4 per-output-channel alone is too coarse for transformer weights;
    the standard recipe is a scale per GROUP of ``g`` contraction rows
    (default 128). The matmul is computed as per-group partial
    contractions — ``sum_g (x_g @ q_g) * s_g``. ``q`` holds the int4
    codes in an int8 tensor.
    """

    GROUP = 128

    def __init__(self, q, s, group=GROUP):
        self.q = q            # (K, N) int8 holding [-8, 7]
        self.s = s            # (K // group, N) f32 scale
        self.group = int(group)

    def children(self):
        return (self.q, self.s)

    def with_children(self, children):
        return QuantizedWeightInt4(*children, group=self.group)

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):  # the EFFECTIVE dtype seen by consumers
        return self.s.dtype

    def __rmatmul__(self, x):
        K, N = self.q.shape
        G = K // self.group
        xg = x.reshape(x.shape[:-1] + (G, self.group))
        qg = self.q.reshape(G, self.group, N).to(x.dtype)
        partial = torch.einsum("...gk,gkn->...gn", xg, qg)
        return torch.einsum("...gn,gn->...n", partial, self.s.to(x.dtype))

    def dequantize(self):
        K, N = self.q.shape
        qf = self.q.to(self.s.dtype).reshape(self.s.shape[0], self.group, N)
        return (qf * self.s[:, None, :]).reshape(K, N)

    def __repr__(self):
        return f"QuantizedWeightInt4{tuple(self.q.shape)}g{self.group}"


_DEFAULT_KEYS = frozenset({"wq", "wk", "wv", "wo", "w1", "w2"})


def quantize_weight_int8(w):
    """(K, N) weight → :class:`QuantizedWeight` with per-OUT-channel
    scales (``quantize.quantize_weight`` along the kept axis 1)."""
    from .quantize import quantize_weight
    q, s = quantize_weight(w, axis=1)
    return QuantizedWeight(q, s.reshape(-1))


def quantize_weight_int4(w, group=QuantizedWeightInt4.GROUP):
    """(K, N) weight → :class:`QuantizedWeightInt4` with a symmetric
    max-abs scale per (group-of-K-rows, out-channel) block. K must be a
    multiple of ``group``."""
    w = (w.detach() if isinstance(w, torch.Tensor)
         else torch.as_tensor(w)).to(torch.float32)
    K, N = w.shape
    if K % group:
        raise ValueError(
            f"int4 group quantization needs K % group == 0, got K={K} "
            f"group={group}")
    wg = w.reshape(K // group, group, N)
    s = wg.abs().amax(dim=1) / 7.0                # symmetric [-7, 7]
    s = torch.where(s == 0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(wg / s[:, None, :]), -8, 7)
    q = q.reshape(K, N).to(torch.int8)
    return QuantizedWeightInt4(q, s, group=group)


def quantize_lm_params(params, keys=_DEFAULT_KEYS, bits=8,
                       group=QuantizedWeightInt4.GROUP):
    """Replace the 2-D block matmul weights named in ``keys`` with
    :class:`QuantizedWeight` (``bits=8``, per-out-channel scales) or
    :class:`QuantizedWeightInt4` (``bits=4``, group-wise scales).
    Everything else (embedding, layernorms, biases, the MoE's 3-D expert
    weights) keeps its dtype. The result drops into ``model.apply`` /
    ``generate`` / ``translate`` unchanged."""
    if bits == 8:
        quantize = quantize_weight_int8
    elif bits == 4:
        def quantize(w):
            # auto-fit the group to this weight's K (gcd keeps it a
            # divisor; small models just get finer-grained scales)
            g = group if w.shape[0] % group == 0 \
                else math.gcd(w.shape[0], group)
            if g < 4:
                logging.getLogger("bigdl_tpu").warning(
                    "int4 group degraded to %d for K=%d (gcd with %d): "
                    "scale overhead makes this LARGER than bf16 — pass "
                    "a group that divides K", g, w.shape[0], group)
            return quantize_weight_int4(w, group=g)
    else:
        raise ValueError(f"bits must be 8 or 4, got {bits}")

    def walk(node):
        if isinstance(node, dict):
            return {k: (quantize(v)
                        if k in keys and hasattr(v, "ndim") and v.ndim == 2
                        else walk(v))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    with torch.no_grad():
        return walk(params)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def lm_quantized_bytes(params) -> dict:
    """Weight-byte accounting: {'quantized': n, 'dense': n}. int4 payloads
    are counted at their packed size (two values per byte), JAX's
    count, though the port holds them a byte each."""
    qb = db = 0
    for leaf in _leaves(params):
        if isinstance(leaf, QuantizedWeightInt4):
            qb += (leaf.q.numel() + 1) // 2 + leaf.s.nbytes
        elif isinstance(leaf, QuantizedWeight):
            qb += leaf.q.nbytes + leaf.s.nbytes
        elif hasattr(leaf, "nbytes"):
            db += leaf.nbytes
    return {"quantized": int(qb), "dense": int(db)}
