"""Build and load the hand-written CUDA kernels under ``bigdl_tpu_torch/csrc``.

Each ``.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``. Builds
happen on first use, all sources at once (one ``nvcc`` process each, started
together), into ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``). A library's file name carries a digest of its source, the
headers it includes and the flags, so an edited source or header rebuilds
the libraries that include it (and no other), and a stale library is never
loaded.
``nvcc``'s ``-Xptxas -v`` report (registers, shared memory, spills) is kept
beside each library as ``<name>-<digest>.log``.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# library name -> (source, the headers under csrc/ that it includes,
# directly or through another header)
SOURCES = {"flash_fwd": ("flash_fwd.cu", "attn_tile.cuh"),
           "flash_bwd": ("flash_bwd.cu", "attn_tile.cuh"),
           "flash_fwd_sm90": ("flash_fwd_sm90.cu", "attn_sm90.cuh"),
           "flash_bwd_sm90": ("flash_bwd_sm90.cu", "attn_sm90.cuh"),
           "paged_attention": ("paged_attention.cu", "attn_tile.cuh"),
           "fused_matmul": ("fused_matmul.cu", "fused_gemm.cuh"),
           "fused_chain": ("fused_chain.cu", "fused_gemm.cuh"),
           "fused_conv": ("fused_conv.cu", "fused_gemm.cuh"),
           "fused_matmul_sm90": ("fused_matmul_sm90.cu", "fused_gemm_sm90.cuh",
                                 "attn_sm90.cuh", "fused_gemm.cuh"),
           "fused_conv_sm90": ("fused_conv_sm90.cu", "fused_gemm_sm90.cuh",
                               "attn_sm90.cuh", "fused_gemm.cuh"),
           "fused_chain_sm90": ("fused_chain_sm90.cu", "fused_gemm_sm90.cuh",
                                "attn_sm90.cuh", "fused_gemm.cuh"),
           "fused_matmul_tf32_sm90": ("fused_matmul_tf32_sm90.cu",
                                      "fused_gemm_tf32_sm90.cuh",
                                      "fused_gemm_sm90.cuh", "attn_sm90.cuh",
                                      "fused_gemm.cuh"),
           "fused_chain_tf32_sm90": ("fused_chain_tf32_sm90.cu",
                                     "fused_gemm_tf32_sm90.cuh",
                                     "fused_gemm_sm90.cuh", "attn_sm90.cuh",
                                     "fused_gemm.cuh"),
           "fused_conv_tf32_sm90": ("fused_conv_tf32_sm90.cu",
                                    "fused_gemm_tf32_sm90.cuh",
                                    "fused_gemm_sm90.cuh", "attn_sm90.cuh",
                                    "fused_gemm.cuh"),
           "flash_fwd_tf32_sm90": ("flash_fwd_tf32_sm90.cu",
                                   "attn_tf32_sm90.cuh",
                                   "fused_gemm_tf32_sm90.cuh",
                                   "fused_gemm_sm90.cuh", "attn_sm90.cuh",
                                   "fused_gemm.cuh"),
           "flash_bwd_tf32_sm90": ("flash_bwd_tf32_sm90.cu",
                                   "attn_tf32_sm90.cuh",
                                   "fused_gemm_tf32_sm90.cuh",
                                   "fused_gemm_sm90.cuh", "attn_sm90.cuh",
                                   "fused_gemm.cuh"),
           "paged_attention_sm90": ("paged_attention_sm90.cu",
                                    "attn_tile.cuh")}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}     # library name -> ctypes.CDLL
_fns: dict = {}      # (library name, symbol) -> configured C function


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels are built from source "
                           "on first use")
    return found


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in SOURCES[name]:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all() -> float:
    """Compile every source whose library is missing, in parallel. Returns
    the wall seconds spent (0.0 when everything was already built). Raises
    ``RuntimeError`` with the compiler's output when a build fails."""
    todo = [n for n in SOURCES if not lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name in todo:
        out = lib_path(name)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name][0])]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, p in procs:
        log, _ = p.communicate()
        out.with_suffix(".log").write_text(log)
        if p.returncode != 0:
            failed.append(f"{name} (nvcc exit {p.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def function(name: str, symbol: str, argtypes):
    """The C function ``symbol`` of kernel library ``name``, built if
    needed, with ``argtypes`` set and an ``int`` (cudaError_t) result."""
    fn = _fns.get((name, symbol))
    if fn is not None:
        return fn
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(lib_path(name)))
            _libs[name] = lib
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(name, symbol)] = fn
    return fn


def build_log(name: str) -> str:
    """The ``-Xptxas -v`` report of the last build of ``name`` ('' if the
    library was built by an earlier process and the log is gone)."""
    log = lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
