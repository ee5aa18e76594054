"""The attention seam: every attention kernel call of the port goes
through here (counterpart of ``bigdl_tpu/parallel/flash.py``).

There is one policy and no option: the kernel wrappers run their plain
PyTorch version for tensors on the CPU and the CUDA kernel for tensors on a
CUDA device, where a failure raises. Nothing falls back, so a run on the
card that did not go through a kernel cannot pass for one that did.
"""
from __future__ import annotations

from ..kernels.flash_attention import FlashAttention, flash_fwd
from ..kernels.paged_attention import paged_decode_attention


def flash_attention(q, k, v, causal: bool = False):
    """q, k, v: (B, H, T, D) -> (B, H, T, D); differentiable (K1-fwd
    forward, K1-bwd backward)."""
    return FlashAttention.apply(q, k, v, causal)


def flash_chunk_attention(q, k, v, q_offset: int, kv_len=None):
    """Rectangular-causal chunk attention over the first ``kv_len``
    positions of a dense KV cache: q (B, H, S, D) at global positions
    ``q_offset..``; k/v the whole cache (B, H, Tmax, D), already holding
    the chunk's keys. The kernel reads only the valid prefix. Forward
    only, as in the JAX package."""
    return flash_fwd(q, k, v, causal=True, q_offset=q_offset,
                     kv_len=kv_len)[0]


def paged_attention(q, k_pages, v_pages, block_tables, positions,
                    dense_fn):
    """q (B, nH, S, D); pages (num_blocks, kvH, block_size, D) already
    holding this chunk's K/V; block_tables (B, max_blocks) int32;
    positions (B,) int32. ``dense_fn()`` is the caller's gathered-view
    einsum, JAX's fallback and oracle; the port never falls back (on the
    CPU the kernel's plain version is that einsum), so it is not called."""
    return paged_decode_attention(q, k_pages, v_pages, block_tables,
                                  positions)


__all__ = ["flash_attention", "flash_chunk_attention", "paged_attention"]
