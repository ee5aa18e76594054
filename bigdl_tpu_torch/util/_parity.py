"""Shared helper for the pyspark-parity re-export shims (counterpart of
``bigdl_tpu/util/_parity.py``, written for this package's name)."""
from __future__ import annotations

import inspect


def public_names(mod):
    """Names a parity shim should re-export from ``mod``: public,
    non-module, defined inside this package (so star imports bind layer
    classes - never numpy / torch or submodule objects)."""
    out = []
    for n in dir(mod):
        if n.startswith("_"):
            continue
        obj = getattr(mod, n)
        if inspect.ismodule(obj):
            continue
        owner = getattr(obj, "__module__", "") or ""
        if owner == "bigdl_tpu_torch" or owner.startswith("bigdl_tpu_torch."):
            out.append(n)
    return out
