"""Shape buckets (the part of ``bigdl_tpu/optim/predictor.py`` the serving
slice needs)."""
from __future__ import annotations


def bucket_for(n: int, max_batch: int) -> int:
    """Smallest power of two >= ``n``, capped at ``max_batch``: the padded
    batch size a ragged batch of ``n`` rows dispatches as."""
    if n <= 0:
        raise ValueError(f"batch rows must be positive, got {n}")
    if n >= max_batch:
        return max_batch
    b = 1
    while b < n:
        b <<= 1
    return min(b, max_batch)
