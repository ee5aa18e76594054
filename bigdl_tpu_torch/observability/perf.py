"""Performance introspection: what the programs COST (counterpart of
``bigdl_tpu/observability/perf.py``).

The span / health layers say *that* a step is slow; this module says *how
far from the hardware ceiling* it is. Three pieces:

* **Program cost notes** — the training step, the evaluator / predictor
  forwards and the decode scheduler's step run through
  :class:`InstrumentedJit`, which on each new input-shape signature runs
  the call once under ``torch.utils.flop_counter.FlopCounterMode`` and
  records a :class:`CompiledArtifact` into the process
  :class:`ArtifactRegistry`. PyTorch runs eagerly, so there is no
  compiled program: the artifact describes that call. Its FLOPs are the
  counter's, with the hand kernels' own tallies added (``kernels._flops``:
  a ``ctypes`` launch is no aten operation, so each kernel wrapper adds
  what its plain version's aten operations would count), which makes the
  count the same on the CPU and on the card. On the card its memory
  fields are the arguments' and outputs' tensor bytes and the
  temporaries' (``torch.cuda`` peak allocation during the call less what
  was allocated before it and the outputs; the counted call resets the
  device's peak-memory statistics). Fields with no eager meaning
  (``bytes_accessed``, ``transcendentals``, ``alias_bytes``,
  ``generated_code_bytes``) are absent, as on JAX's degraded backends;
  ``compile_seconds`` is the counted call's wall time, and that call is
  ``last_call_compiled`` (the counter slows it, so MFU skips it as JAX
  skips a compile).
* **Live MFU** — :func:`note_step` divides the artifact's model FLOPs
  by the step wall time the loop already measures and by the device's
  peak FLOP/s (:func:`peak_flops`, overridable with
  ``BIGDL_TPU_PEAK_FLOPS``), publishing ``perf/mfu`` (last dispatch),
  ``perf/mfu_mean`` (run-cumulative), ``perf/model_flops_per_s`` and a
  host / dispatch / device step-phase split (``perf/phase_*_frac``).
* **Artifact export** — :func:`dump_artifacts` writes the registry (with
  the ``mem/*`` and ``compile/*`` metrics) as strict JSON next to the
  flight bundles, under JAX's schema name.

The peak table holds the card's row: the H100's dense bf16 tensor-core
rate (989 TFLOP/s), which is also the default.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional

from . import metrics as _metrics
from . import trace as _trace

_LOG = logging.getLogger("bigdl_tpu.observability.perf")

ARTIFACT_SCHEMA = "bigdl_tpu.xla_programs.v1"

# bf16 dense peak FLOP/s by device-name substring (NVIDIA's data sheet);
# first match wins
PEAK_FLOPS_TABLE = (("H100", 989.0e12),)

#: assumed ceiling when the device name matches nothing (the H100's). CPU
#: runs land here too: MFU on the CPU means something only against an
#: explicit BIGDL_TPU_PEAK_FLOPS.
DEFAULT_PEAK_FLOPS = 989.0e12

__all__ = ["ARTIFACT_SCHEMA", "PEAK_FLOPS_TABLE", "DEFAULT_PEAK_FLOPS",
           "peak_flops", "analyze_compiled", "CompiledArtifact",
           "ArtifactRegistry", "registry", "reset", "record_compiled",
           "InstrumentedJit", "instrument_jit", "note_step",
           "artifacts_snapshot", "dump_artifacts"]


def peak_flops(device_kind: str = "") -> float:
    """Peak FLOP/s for ``device_kind``. ``BIGDL_TPU_PEAK_FLOPS`` (a
    float, e.g. ``1e12``) overrides the table."""
    env = os.environ.get("BIGDL_TPU_PEAK_FLOPS")
    if env:
        try:
            return float(env)
        except ValueError:
            _LOG.warning("ignoring unparsable BIGDL_TPU_PEAK_FLOPS=%r", env)
    dk = (device_kind or "").lower()
    for sub, f in PEAK_FLOPS_TABLE:
        if sub.lower() in dk:
            return f
    return DEFAULT_PEAK_FLOPS


def analyze_compiled(compiled) -> Dict[str, float]:
    """The cost and memory fields of an object with JAX's
    ``cost_analysis()`` / ``memory_analysis()`` protocol (a compiled
    program's; the port's counted calls build their fields directly).
    Every field is optional: what the object lacks contributes nothing,
    never an exception."""
    out: Dict[str, float] = {}
    try:
        ca = compiled.cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0] if ca else {}
        if isinstance(ca, dict):
            for src, dst in (("flops", "flops"),
                             ("bytes accessed", "bytes_accessed"),
                             ("transcendentals", "transcendentals")):
                v = ca.get(src)
                if isinstance(v, (int, float)) and v >= 0:
                    out[dst] = float(v)
    except Exception:  # noqa: BLE001 — analytics must never break a run
        pass
    try:
        ma = compiled.memory_analysis()
        for src, dst in (
                ("argument_size_in_bytes", "argument_bytes"),
                ("output_size_in_bytes", "output_bytes"),
                ("temp_size_in_bytes", "temp_bytes"),
                ("alias_size_in_bytes", "alias_bytes"),
                ("generated_code_size_in_bytes", "generated_code_bytes")):
            v = getattr(ma, src, None)
            if isinstance(v, (int, float)) and v >= 0:
                out[dst] = float(v)
    except Exception:  # noqa: BLE001
        pass
    return out


class CompiledArtifact:
    """One program (in the port: one counted call), as the introspection
    plane sees it."""

    __slots__ = ("name", "kind", "input_shapes", "steps_per_program",
                 "compile_seconds", "analysis", "cache_hits",
                 "cache_misses", "backend", "device_kind", "created_at",
                 "degraded")

    def __init__(self, name: str, kind: str, input_shapes: List[str],
                 steps_per_program: int = 1, compile_seconds: float = 0.0,
                 analysis: Optional[Dict[str, float]] = None,
                 cache_hits: int = 0, cache_misses: int = 0,
                 backend: str = "", device_kind: str = "",
                 degraded: Optional[str] = None):
        self.name = name
        self.kind = kind
        self.input_shapes = list(input_shapes)
        self.steps_per_program = int(steps_per_program)
        self.compile_seconds = float(compile_seconds)
        self.analysis = dict(analysis or {})
        self.cache_hits = int(cache_hits)
        self.cache_misses = int(cache_misses)
        self.backend = backend
        self.device_kind = device_kind
        self.created_at = time.time()
        self.degraded = degraded

    @property
    def flops(self) -> Optional[float]:
        return self.analysis.get("flops")

    @property
    def flops_per_step(self) -> Optional[float]:
        f = self.analysis.get("flops")
        if f is None:
            return None
        return f / max(1, self.steps_per_program)

    def resident_bytes(self) -> Optional[float]:
        """Device-memory footprint of one execution (arguments + outputs
        + temporaries)."""
        keys = ("argument_bytes", "output_bytes", "temp_bytes")
        if not any(k in self.analysis for k in keys):
            return None
        return sum(self.analysis.get(k, 0.0) for k in keys)

    def to_dict(self) -> Dict:
        return {
            "name": self.name, "kind": self.kind,
            "input_shapes": list(self.input_shapes),
            "steps_per_program": self.steps_per_program,
            "compile_seconds": round(self.compile_seconds, 6),
            "analysis": dict(self.analysis),
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "backend": self.backend, "device_kind": self.device_kind,
            "created_at": self.created_at,
            "degraded": self.degraded,
        }

    def __repr__(self):
        f = self.flops
        return (f"CompiledArtifact({self.name!r}, kind={self.kind!r}, "
                f"flops={f if f is not None else 'n/a'}, "
                f"compile={self.compile_seconds:.3f}s)")


class ArtifactRegistry:
    """Process-wide list of artifacts (thread-safe). Recording also
    mirrors aggregates into the metrics registry — ``compile/programs``,
    ``compile/wall_s`` (histogram), ``compile/flops_last`` /
    ``compile/resident_bytes_last`` gauges."""

    def __init__(self):
        self._artifacts: List[CompiledArtifact] = []
        self._lock = threading.Lock()

    def record(self, artifact: CompiledArtifact) -> CompiledArtifact:
        with self._lock:
            self._artifacts.append(artifact)
        reg = _metrics.registry()
        reg.counter("compile/programs").inc()
        reg.histogram("compile/wall_s", unit="s").observe(
            artifact.compile_seconds)
        if artifact.degraded:
            reg.counter("compile/degraded").inc()
        if artifact.flops is not None:
            reg.gauge("compile/flops_last", unit="flops").set(artifact.flops)
        rb = artifact.resident_bytes()
        if rb is not None:
            reg.gauge("compile/resident_bytes_last", unit="bytes").set(rb)
        return artifact

    def artifacts(self) -> List[CompiledArtifact]:
        with self._lock:
            return list(self._artifacts)

    def latest(self, name: str) -> Optional[CompiledArtifact]:
        with self._lock:
            for a in reversed(self._artifacts):
                if a.name == name:
                    return a
        return None

    def by_name(self) -> Dict[str, List[CompiledArtifact]]:
        out: Dict[str, List[CompiledArtifact]] = {}
        for a in self.artifacts():
            out.setdefault(a.name, []).append(a)
        return out

    def clear(self):
        with self._lock:
            self._artifacts.clear()


_registry = ArtifactRegistry()


def registry() -> ArtifactRegistry:
    return _registry


def reset():
    """Clear artifacts AND the live-MFU accumulators (tests)."""
    _registry.clear()
    _steps.reset()


def _backend_info():
    """(backend, device_kind): ``("cuda", <the card's name>)`` or
    ``("cpu", "")``."""
    import torch
    if torch.cuda.is_available():
        return "cuda", torch.cuda.get_device_name(torch.cuda.current_device())
    return "cpu", ""


def _leaves(x):
    """The leaves of an argument tree: dicts, lists, tuples and Tables
    walked, tensor carriers (the quantized weights) opened."""
    from ..utils.carrier import TreeCarrier
    from ..utils.table import Table
    if isinstance(x, dict):
        return [l for v in x.values() for l in _leaves(v)]
    if isinstance(x, (list, tuple, Table)):
        return [l for v in x for l in _leaves(v)]
    if isinstance(x, TreeCarrier):
        return [l for v in x.children() for l in _leaves(v)]
    return [x]


def _shape_strs(args) -> List[str]:
    """Flat ``shape:dtype`` strings for an argument tuple."""
    leaves = [l for l in _leaves(args) if l is not None]
    out = []
    for l in leaves[:64]:  # bound: a big param tree is provenance noise
        shape = getattr(l, "shape", ())
        dtype = getattr(l, "dtype", type(l).__name__)
        out.append(f"{tuple(shape)}:{dtype}")
    if len(leaves) > 64:
        out.append(f"... +{len(leaves) - 64} more leaves")
    return out


def record_compiled(name: str, kind: str, compiled=None, *,
                    compile_seconds: float = 0.0, input_shapes=None,
                    steps_per_program: int = 1, cache_hits: int = 0,
                    cache_misses: int = 0,
                    degraded: Optional[str] = None) -> CompiledArtifact:
    """Record one program into the process registry (and the
    ``compile/*`` metrics). ``compiled`` may be None (degraded sites)."""
    analysis = analyze_compiled(compiled) if compiled is not None else {}
    if compiled is not None and not analysis and degraded is None:
        degraded = "cost/memory analysis unavailable on this backend"
    backend, device_kind = _backend_info()
    return _registry.record(CompiledArtifact(
        name, kind, input_shapes or [], steps_per_program=steps_per_program,
        compile_seconds=compile_seconds, analysis=analysis,
        cache_hits=cache_hits, cache_misses=cache_misses,
        backend=backend, device_kind=device_kind, degraded=degraded))


def _tensor_bytes(tree) -> int:
    import torch
    seen, n = set(), 0
    for t in _leaves(tree):
        if isinstance(t, torch.Tensor) and t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            n += t.nbytes
    return n


def _device(args):
    import torch
    for t in _leaves(args):
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cpu")


class InstrumentedJit:
    """Counting wrapper around an eager callable (JAX's wraps a
    ``jax.jit``-ed function): the same call surface, and on every new
    input-shape signature the call runs once under a FLOP counter and
    its :class:`CompiledArtifact` lands in the registry.

    * One counted call per signature; ``key_argnums`` limits the key to
      the data arguments where the parameter trees are shape-stable.
    * An exception of the call propagates as it is (the counted call is
      the real call).
    * When observability is disabled the wrapper IS the plain call — one
      flag read of overhead, no artifacts.
    """

    def __init__(self, jit_fn, *, name: str, kind: str,
                 key_argnums: Optional[tuple] = None,
                 steps_per_program=1):
        self._jit = jit_fn
        self.name = name
        self.kind = kind
        self.key_argnums = tuple(key_argnums) if key_argnums else None
        #: int, or ``callable(args) -> int`` resolved on the counted call
        self.steps_per_program = steps_per_program \
            if callable(steps_per_program) else int(steps_per_program)
        self._artifacts: Dict[tuple, CompiledArtifact] = {}
        #: artifact of the program the LAST __call__ ran — what an MFU
        #: caller must read
        self.last_artifact: Optional[CompiledArtifact] = None
        #: True when the last __call__ was the counted one — its wall time
        #: includes the counter; MFU accounting skips it
        self.last_call_compiled = False
        self._lock = threading.Lock()

    def _key(self, args) -> tuple:
        src = args if self.key_argnums is None else \
            tuple(args[i] for i in self.key_argnums)
        return tuple(
            (tuple(getattr(l, "shape", ())),
             str(getattr(l, "dtype", type(l).__name__)))
            for l in _leaves(src))

    def _steps(self, args) -> int:
        if not callable(self.steps_per_program):
            return self.steps_per_program
        return int(self.steps_per_program(args))

    def _count(self, key, args):
        """Run the call once under the counter; (output, artifact)."""
        import torch
        from torch.utils.flop_counter import FlopCounterMode
        from ..kernels import _flops
        dev = _device(args)
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.synchronize(dev)
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with FlopCounterMode(display=False) as fc, _flops.counting(fc):
            out = self._jit(*args)
        analysis = {"flops": float(fc.get_total_flops())}
        if cuda:
            torch.cuda.synchronize(dev)
            analysis["argument_bytes"] = float(_tensor_bytes(args))
            analysis["output_bytes"] = float(_tensor_bytes(out))
            analysis["temp_bytes"] = float(max(
                0, torch.cuda.max_memory_allocated(dev) - before
                - analysis["output_bytes"]))
        backend, device_kind = _backend_info()
        art = _registry.record(CompiledArtifact(
            self.name, self.kind, _shape_strs(args),
            steps_per_program=self._steps(args),
            compile_seconds=time.perf_counter() - t0, analysis=analysis,
            backend=backend, device_kind=device_kind))
        with self._lock:
            self._artifacts[key] = art
        return out, art

    def __call__(self, *args):
        if not _trace.enabled():
            return self._jit(*args)
        key = self._key(args)
        art = self._artifacts.get(key)
        if art is not None:
            self.last_artifact = art
            self.last_call_compiled = False
            return self._jit(*args)
        out, self.last_artifact = self._count(key, args)
        self.last_call_compiled = True
        return out

    def compiled_shape_count(self) -> int:
        return len(self._artifacts)


def instrument_jit(jit_fn, *, name: str, kind: str,
                   key_argnums: Optional[tuple] = None,
                   steps_per_program: int = 1) -> InstrumentedJit:
    """Wrap a callable for artifact capture."""
    return InstrumentedJit(jit_fn, name=name, kind=kind,
                           key_argnums=key_argnums,
                           steps_per_program=steps_per_program)


# ------------------------------------------------------------------ MFU

class _StepPerf:
    """Run-cumulative live-MFU bookkeeping (host floats only)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._total_flops = 0.0
        self._total_wall = 0.0
        self._peak = None       # resolved lazily, re-resolved on env change
        self._peak_env = None   # the override value the cache was built for

    def reset(self):
        with self._lock:
            self._total_flops = 0.0
            self._total_wall = 0.0
            self._peak = None
            self._peak_env = None

    def peak(self) -> float:
        # re-resolved whenever the BIGDL_TPU_PEAK_FLOPS override CHANGES,
        # including being unset (an override must not leak into a later
        # measurement in the same process)
        env = os.environ.get("BIGDL_TPU_PEAK_FLOPS")
        if self._peak is None or env != self._peak_env:
            _, dk = _backend_info()
            self._peak = peak_flops(dk)
            self._peak_env = env
        return self._peak

    def note(self, flops: Optional[float], wall_s: float,
             host_s: Optional[float] = None,
             dispatch_s: Optional[float] = None):
        """``wall_s`` is the FULL iteration wall (fetch + dispatch +
        resolve): MFU as delivered FLOPs per second of wall clock, which
        can only under-claim."""
        if flops is None or wall_s <= 0:
            return
        peak = self.peak()
        with self._lock:
            self._total_flops += flops
            self._total_wall += wall_s
            tf, tw = self._total_flops, self._total_wall
        reg = _metrics.registry()
        reg.gauge("perf/model_flops_per_s", unit="flops/s").set(
            flops / wall_s)
        reg.gauge("perf/mfu").set(flops / wall_s / peak)
        reg.gauge("perf/mfu_mean").set(tf / tw / peak)
        reg.counter("perf/model_flops", unit="flops").inc(flops)
        if host_s is not None and dispatch_s is not None:
            # host = producing/fetching the batch, dispatch = queueing the
            # step, device = the remainder of the iteration
            total = max(wall_s, 1e-12)
            device_s = max(wall_s - host_s - dispatch_s, 0.0)
            reg.gauge("perf/phase_host_frac").set(host_s / total)
            reg.gauge("perf/phase_dispatch_frac").set(dispatch_s / total)
            reg.gauge("perf/phase_device_frac").set(device_s / total)


_steps = _StepPerf()


def note_step(artifact, wall_s: float,
              host_s: Optional[float] = None,
              dispatch_s: Optional[float] = None):
    """Publish the live MFU gauges for one completed step: ``artifact`` is
    the :class:`CompiledArtifact` of the call that just ran (an
    :class:`InstrumentedJit`'s ``last_artifact``), or a registry name to
    look up the newest by. ``wall_s`` is the full iteration wall. Does
    nothing when the artifact is missing or carries no FLOPs."""
    art = _registry.latest(artifact) if isinstance(artifact, str) \
        else artifact
    if art is None:
        return
    _steps.note(art.flops, wall_s, host_s=host_s, dispatch_s=dispatch_s)


# ---------------------------------------------------------------- export

def artifacts_snapshot() -> List[Dict]:
    return [a.to_dict() for a in _registry.artifacts()]


def dump_artifacts(path: Optional[str] = None) -> Optional[str]:
    """Write the artifact registry (with the ``mem/*`` and ``compile/*``
    metrics) as strict JSON; returns the path. Defaults into the
    flight-bundle directory (``xla_programs_<pid>.json``, JAX's name).
    Never raises — export is advisory."""
    try:
        from . import flight as _flight
        if path is None:
            d = _flight.bundle_dir()
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"xla_programs_{os.getpid()}.json")
        mem = {name: inst for name, inst in
               _metrics.registry().snapshot().items()
               if name.startswith("mem/") or name.startswith("compile/")}
        doc = {
            "schema": ARTIFACT_SCHEMA,
            "written_at": time.time(),
            "pid": os.getpid(),
            "programs": artifacts_snapshot(),
            "metrics": mem,
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(_flight._json_safe(doc), f, indent=1, default=str,
                      allow_nan=False)
        os.replace(tmp, path)
        return path
    except Exception:  # noqa: BLE001
        _LOG.exception("failed to dump program artifacts")
        return None
