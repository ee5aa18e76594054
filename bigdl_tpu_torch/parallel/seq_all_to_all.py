"""All-to-all (Ulysses-style) sequence parallelism (counterpart of
``bigdl_tpu/parallel/seq_all_to_all.py``).

One all-to-all turns sequence sharding (B, H, T/n, D) into head sharding
(B, H/n, T, D); attention then runs whole-sequence on this rank's heads
through the flash kernel (K1-fwd forward, K1-bwd backward); a second
all-to-all restores sequence sharding. Two exchanges of the activations
whatever n is, against the ring's n hops, at the price of
``num_heads % n == 0``. The exchanges' gradients are the reverse
exchanges (``collective.all_to_all``).
"""
from __future__ import annotations

from . import collective
from .collective import all_to_all

__all__ = ["a2a_attention"]


def a2a_attention(q, k, v, axis: str = "seq", causal: bool = False,
                  use_flash: bool = True):
    """q, k, v: this rank's (B, H, T/n, D) sequence blocks (all heads).
    Returns this rank's (B, H, T/n, D) output block. Raises when H does
    not divide by the size of ``axis``."""
    _, n, _ = collective.axis_group(axis)
    h = q.shape[1]
    if h % n:
        raise ValueError(
            f"a2a (Ulysses) sequence parallelism needs num_heads ({h}) "
            f"divisible by the '{axis}' axis size ({n}); use ring "
            "attention otherwise")

    def scatter_heads(x):
        return all_to_all(x, axis, split_axis=1, concat_axis=2)

    qh, kh, vh = scatter_heads(q), scatter_heads(k), scatter_heads(v)
    if use_flash:
        from .flash import flash_attention
        o = flash_attention(qh.contiguous(), kh.contiguous(),
                            vh.contiguous(), causal=causal)
    else:
        from ..nn.attention import causal_mask, dot_product_attention
        mask = (causal_mask(qh.shape[-2], device=qh.device) if causal
                else None)
        o = dot_product_attention(qh, kh, vh, mask)
    return all_to_all(o, axis, split_axis=2, concat_axis=1)
