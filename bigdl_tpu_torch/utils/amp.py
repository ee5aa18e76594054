"""Mixed precision (counterpart of ``bigdl_tpu/utils/amp.py``).

The bf16 training recipe: keep float32 MASTER params (the optimizer update
stays float32), cast them to bfloat16 inside the loss so the matrix
products run in bf16, and let autograd carry the gradients back through
the cast to the float32 masters.
"""
from __future__ import annotations

import torch

__all__ = ["bf16_params"]


def bf16_params(tree):
    """Cast every float32 tensor of a nested dict of tensors to bfloat16
    (other tensors pass through). Returns a new tree. The cast is
    differentiable, as JAX's ``astype`` is: gradients of the bf16 copies
    flow back to the float32 originals. Callers that want leaves (serving,
    a weight registry) cast under ``torch.no_grad()`` or detach."""
    if isinstance(tree, dict):
        return {k: bf16_params(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.float32:
        return tree.to(torch.bfloat16)
    return tree
