"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (see ``_build`` for how they are compiled and loaded).

Each wrapper counts its launches in a plain integer attribute,
``<wrapper>.launches``, bumped only where the kernel is launched, so a run
can show that its path went through the kernels."""
from .flash_attention import (FlashAttention, flash_bwd, flash_bwd_reference,
                              flash_fwd, flash_fwd_reference)
from .paged_attention import paged_attention_reference, paged_decode_attention

WRAPPERS = {"flash_fwd": flash_fwd, "flash_bwd": flash_bwd,
            "paged_attention": paged_decode_attention}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0


__all__ = ["FlashAttention", "flash_fwd", "flash_fwd_reference", "flash_bwd",
           "flash_bwd_reference", "paged_decode_attention",
           "paged_attention_reference", "launch_counts",
           "reset_launch_counts", "WRAPPERS"]
