"""Mixed precision (counterpart of ``bigdl_tpu/utils/amp.py``)."""
from __future__ import annotations

import torch

__all__ = ["bf16_params"]


def bf16_params(tree):
    """Cast every float32 tensor of a nested dict of tensors to bfloat16
    (other tensors pass through). Returns a new tree."""
    if isinstance(tree, dict):
        return {k: bf16_params(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.float32:
        return tree.detach().to(torch.bfloat16)
    return tree
