"""What the loaders and savers read of the port's modules, under the JAX
modules' attribute names (the port's layers keep some settings in other
forms: a convolution's ``kernel`` / ``stride`` / ``padding`` tuples, a
bias as a parameter or None), and how they write a loaded array into
one."""
from __future__ import annotations

import numpy as np
import torch


def children(m):
    """A container's children in order."""
    return list(m._modules.values())


def conv_geometry(m):
    """((kh, kw), (sh, sw), (pad_h, pad_w)) of a SpatialConvolution."""
    return tuple(m.kernel), tuple(m.stride), tuple(m.padding)


def has_bias(m) -> bool:
    return getattr(m, "bias", None) is not None


def host(t):
    """A tensor (or array) as a host numpy array; bfloat16 as float32."""
    if torch.is_tensor(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(t)


def assign(t, arr):
    """Copy an array into a parameter or buffer in place, reshaped to its
    shape (float32 values; the array is copied, never aliased)."""
    with torch.no_grad():
        t.copy_(torch.from_numpy(np.array(
            arr, np.float32).reshape(tuple(t.shape))))
