"""Runtime utilities (counterpart of ``bigdl_tpu/utils/misc.py``; parity:
the reference's ``utils/LoggerFilter.scala``, ``utils/File.scala``,
``utils/Crc32.scala`` + ``HashFunc``, ``utils/ThreadPool.scala``), and the
profiling hooks on ``torch.profiler`` and the device's own memory
statistics (``torch.cuda.memory_stats``)."""
from __future__ import annotations

import concurrent.futures
import contextlib
import hashlib
import logging
import os
import pickle
import zlib

__all__ = ["redirect_spark_info_logs", "File", "crc32", "string_hash",
           "ThreadPool", "profile_trace", "device_memory_stats"]


# ---------------------------------------------------------------------------
# LoggerFilter (utils/LoggerFilter.scala)
# ---------------------------------------------------------------------------
def redirect_spark_info_logs(log_file: str = "bigdl.log",
                             quiet_loggers=("jax", "absl")):
    """Quiet noisy third-party loggers to a file, keep bigdl_tpu on console
    (parity: LoggerFilter.redirectSparkInfoLogs). The default list keeps
    JAX's names; pass PyTorch's (``"torch"``) to quiet those."""
    handler = logging.FileHandler(log_file)
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s %(message)s"))
    for name in quiet_loggers:
        lg = logging.getLogger(name)
        lg.handlers = [handler]
        lg.propagate = False
        # capture INFO into the file (otherwise the logger inherits the
        # root's WARNING level and INFO records are dropped, not redirected)
        lg.setLevel(logging.INFO)
    logging.getLogger("bigdl_tpu").setLevel(logging.INFO)


# ---------------------------------------------------------------------------
# File (utils/File.scala)
# ---------------------------------------------------------------------------
class File:
    @staticmethod
    def save(obj, path: str, overwrite: bool = True):
        if not overwrite and os.path.exists(path):
            raise IOError(f"{path} exists; overwrite=False")
        with open(path, "wb") as f:
            pickle.dump(obj, f)

    @staticmethod
    def load(path: str):
        with open(path, "rb") as f:
            return pickle.load(f)


# ---------------------------------------------------------------------------
# Crc32 / HashFunc (utils/Crc32.scala, utils/HashFunc.scala)
# ---------------------------------------------------------------------------
def crc32(data: bytes, seed: int = 0) -> int:
    return zlib.crc32(data, seed) & 0xFFFFFFFF


def string_hash(s: str) -> int:
    return int.from_bytes(hashlib.md5(s.encode()).digest()[:8], "big")


# ---------------------------------------------------------------------------
# ThreadPool (utils/ThreadPool.scala) — host-side only
# ---------------------------------------------------------------------------
class ThreadPool:
    """Host-side executor for IO / augmentation (the device's parallelism
    is its own kernels')."""

    def __init__(self, pool_size: int):
        self.pool_size = pool_size
        self._ex = concurrent.futures.ThreadPoolExecutor(pool_size)

    def invoke(self, fns):
        return [self._ex.submit(fn) for fn in fns]

    def invoke_and_wait(self, fns):
        return [f.result() for f in self.invoke(fns)]

    def shutdown(self):
        self._ex.shutdown()


# ---------------------------------------------------------------------------
# Profiling (torch.profiler + device memory stats)
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def profile_trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the block (CPU, and CUDA where
    there is a device) into ``logdir`` as a Chrome trace
    (``trace_<pid>.json``), viewable in Perfetto."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}.json"))


def device_memory_stats():
    """Per-device memory statistics (``torch.cuda.memory_stats``, the
    device allocator's own), keyed like JAX's by the device's name
    (``cuda:0``); empty without a CUDA device."""
    import torch
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}
