"""``bigdl_tpu_torch.dataset.base`` — pyspark-parity helpers (reference
``bigdl/dataset/base.py``, counterpart of ``bigdl_tpu/dataset/base.py``):
download + progress utilities. The port downloads nothing:
``maybe_download`` resolves files already present and raises
``FileNotFoundError`` naming the URL for any other (the JAX package's
``BIGDL_TPU_ALLOW_DOWNLOAD`` gate has no counterpart)."""
from __future__ import annotations

import os
import sys
import time

__all__ = ["Progbar", "maybe_download", "display_table"]


class Progbar:
    """Text progress bar (reference ``dataset/base.py`` Progbar)."""

    def __init__(self, target, width=30, verbose=1, interval=0.01):
        self.target = target
        self.width = width
        self.verbose = verbose
        self.interval = interval
        self.seen_so_far = 0
        self.start = time.time()
        self.last_update = 0.0

    def update(self, current, values=None, force=False):
        self.seen_so_far = current
        done = self.target and current >= self.target
        now = time.time()
        # the completing update always renders (and terminates the line) —
        # the interval throttle must not swallow the final state
        if not (force or done) and now - self.last_update < self.interval:
            return
        self.last_update = now
        if self.verbose:
            frac = current / self.target if self.target else 1.0
            bar = int(self.width * frac)
            sys.stdout.write("\r[%s%s] %d/%d" % (
                "=" * bar, "." * (self.width - bar), current, self.target))
            if done:
                sys.stdout.write("\n")
            sys.stdout.flush()

    def add(self, n, values=None):
        self.update(self.seen_so_far + n, values)


def maybe_download(filename, work_directory, source_url):
    """``work_directory/filename`` if it is there; otherwise
    ``FileNotFoundError`` naming ``source_url`` to fetch it from (put the
    file there by hand)."""
    os.makedirs(work_directory, exist_ok=True)
    filepath = os.path.join(work_directory, filename)
    if os.path.exists(filepath):
        return filepath
    raise FileNotFoundError(
        f"{filepath} not present, and nothing is downloaded: fetch "
        f"{source_url} into {work_directory}")


def display_table(rows, positions):
    def display_row(objects, positions):
        line = ""
        for i, o in enumerate(objects):
            line += str(o)
            line = line[:positions[i]]
            line += " " * (positions[i] - len(line))
        print(line)
    for row in rows:
        display_row(row, positions)
