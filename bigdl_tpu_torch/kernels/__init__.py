"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (see ``_build`` for how they are compiled and loaded).

Each wrapper counts its launches in a plain integer attribute,
``<wrapper>.launches``, bumped only where the kernel is launched, so a run
can show that its path went through the kernels. The flash, K3, K4 and K5
wrappers also count per route (``launches_by_route``: ``"bf16_sm90"``,
``"f32"``, and for K3 / K4 / K5 ``"bf16_ragged"``), so a run can show which
of their kernels it went through."""
from .flash_attention import (FlashAttention, flash_bwd, flash_bwd_reference,
                              flash_fwd, flash_fwd_reference)
from .fused_chain import (FusedResidualMatmul, fused_chain_bwd,
                          fused_chain_fwd, fused_residual_matmul_nhwc,
                          residual_chain_bwd_reference,
                          residual_chain_reference)
from .fused_conv import (FusedConv3x3, conv3x3_bwd, conv3x3_reference,
                         fused_bn_relu_conv3x3, fused_conv_fwd)
from .fused_matmul import (FusedBnReluMatmul, fused_bn_relu_matmul,
                           fused_bn_relu_matmul_nhwc, fused_matmul_bwd,
                           fused_matmul_bwd_reference, fused_matmul_fwd,
                           fused_matmul_fwd_reference)
from .paged_attention import paged_attention_reference, paged_decode_attention

WRAPPERS = {"flash_fwd": flash_fwd, "flash_bwd": flash_bwd,
            "paged_attention": paged_decode_attention,
            "fused_matmul_fwd": fused_matmul_fwd,
            "fused_matmul_bwd": fused_matmul_bwd,
            "fused_chain_fwd": fused_chain_fwd,
            "fused_chain_bwd": fused_chain_bwd,
            "fused_conv_fwd": fused_conv_fwd}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def launches_by_route() -> dict:
    """{wrapper name: {route: launches}} for the wrappers with routes."""
    return {name: dict(fn.launches_by_route) for name, fn in WRAPPERS.items()
            if hasattr(fn, "launches_by_route")}


def reset_launch_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0
        if hasattr(fn, "launches_by_route"):
            fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)


__all__ = ["FlashAttention", "flash_fwd", "flash_fwd_reference", "flash_bwd",
           "flash_bwd_reference", "paged_decode_attention",
           "paged_attention_reference", "FusedBnReluMatmul",
           "fused_bn_relu_matmul", "fused_bn_relu_matmul_nhwc",
           "fused_matmul_fwd", "fused_matmul_bwd",
           "fused_matmul_fwd_reference", "fused_matmul_bwd_reference",
           "FusedResidualMatmul", "fused_residual_matmul_nhwc",
           "fused_chain_fwd", "fused_chain_bwd", "residual_chain_reference",
           "residual_chain_bwd_reference", "FusedConv3x3",
           "fused_bn_relu_conv3x3", "fused_conv_fwd", "conv3x3_reference",
           "conv3x3_bwd", "launch_counts", "launches_by_route",
           "reset_launch_counts", "WRAPPERS"]
