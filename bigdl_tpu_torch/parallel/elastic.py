"""The latest checkpoint of a directory (the part of
``bigdl_tpu/parallel/elastic.py`` the one-device loop needs: the 'resume'
NaN policy's trust anchor). The restart supervisor, ``ElasticRunner``,
comes with multi-GPU training."""
from __future__ import annotations

import os
from typing import Optional

__all__ = ["find_latest_checkpoint"]


def find_latest_checkpoint(checkpoint_dir: str) -> Optional[str]:
    """The newest ``checkpoint*.bigdl`` under ``checkpoint_dir`` by
    modification time, or None."""
    if not checkpoint_dir or not os.path.isdir(checkpoint_dir):
        return None
    snaps = [os.path.join(checkpoint_dir, f)
             for f in os.listdir(checkpoint_dir)
             if f.startswith("checkpoint") and f.endswith(".bigdl")]
    return max(snaps, key=os.path.getmtime) if snaps else None
