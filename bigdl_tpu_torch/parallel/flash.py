"""The attention seam: every attention kernel call of the port goes
through here (counterpart of ``bigdl_tpu/parallel/flash.py``).

There is one policy and no option: the kernel wrappers run their plain
PyTorch version for tensors on the CPU and the CUDA kernel for tensors on a
CUDA device, where a failure raises. Nothing falls back, so a run on the
card that did not go through a kernel cannot pass for one that did.
"""
from __future__ import annotations

import contextlib
import contextvars

from ..kernels.flash_attention import FlashAttention, flash_fwd
from ..kernels.paged_attention import paged_decode_attention

# The serving step's (mesh, kv-head shard axis), set around its dispatch
# (a context variable, not a model attribute, so two schedulers serving
# one model at different placements never see each other's mesh).
_PAGED_CTX = contextvars.ContextVar("bigdl_tpu_torch_paged_ctx",
                                    default=(None, None))


@contextlib.contextmanager
def paged_serving_context(mesh=None, shard_axis=None):
    """Set by the serving step around its ``decode_paged`` call:
    ``shard_axis`` names the mesh axis the KV pages' kv-head dim is split
    over (None: the pages hold every head). Attention is head-local, so
    under a split each rank's paged kernel runs unchanged on its own heads;
    :func:`paged_attention` checks that the pages hold kvH / n of them."""
    tok = _PAGED_CTX.set((mesh, shard_axis))
    try:
        yield
    finally:
        _PAGED_CTX.reset(tok)


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
    CPU the kernel's plain version is that einsum), so it is not called.
    Under a :func:`paged_serving_context` with a shard axis, q and the
    pages hold this rank's heads only (``Attention.decode_paged`` reads
    the context and checks that the pages hold kvH / n of them); the
    kernel runs unchanged."""
    return paged_decode_attention(q, k_pages, v_pages, block_tables,
                                  positions)


__all__ = ["flash_attention", "flash_chunk_attention", "paged_attention",
           "paged_serving_context"]
