"""The online serving engine: queue -> batcher thread -> shared forward
(counterpart of ``bigdl_tpu/serving/engine.py``).

``submit(sample)`` runs admission control against a bounded queue (full:
typed :class:`~.batching.QueueFull`) and returns a future. One batcher
thread coalesces queued requests into a micro-batch, flushing at
``max_batch`` or after ``max_wait_ms``, pads it to a power-of-two bucket
(``optim.predictor.bucket_for``) with zero rows, moves it to the engine's
device (``optim.staging.place_host_value``: pinned, to a card), reads the
active model version once, runs the model's one shared forward
(``optim.predictor.shared_forward``: ``apply(params, state, x,
training=False)``) and scatters row ``i`` of the readback to request
``i``'s future.

A malformed input fails its own future in assembly (``batching.assemble``)
and the batch around it still serves; a forward error fails that batch's
futures and the batcher lives on. A transient failure replays the batch
under ``fault_policy`` (the forward and its readback, where a CUDA fault
surfaces, are one unit; the ``serving/engine_dispatch`` chaos site fires
inside it). Deadlines expire in the batcher; ``shutdown()`` drains by
default. Hot swap rides the version registry: every batch reads one
version, so each response is old or new, never mixed. The batcher pulses
a stall-watchdog beacon (``serving/batcher[<name>]``).

The engine runs on its registry's device: the CUDA device unless the
caller passes ``device="cpu"``.

Over a mesh (``mesh``, ``placement``, ``batch_spec``): the registry keeps
each rank's block of every version (``sharding.serving_param_specs``), and
each padded bucket's rows split over the batch axes
(``sharding.serving_batch_spec``: ``replica`` x ``data`` where the mesh
has them), so every bucket is a multiple of the shard count (the bucket
floor). The ranks run in lockstep (``_lockstep``): mesh rank 0 takes the
requests and cuts the batches, and for each it sends the padded batch and
the version to every rank; each rank runs its rows, and rank 0 gathers
the rows back. A ``Transformer`` / ``TransformerLM`` runs its own
per-block path on the version's blocks (each block gathers its ``data``
slices just before it runs and drops them after; its ``model`` blocks
stay this rank's), so a rank holds at most one gathered block at a time;
any other model gathers the version's slices whole for the dispatch (a
generic model has no per-layer hook; they are dropped after it). On every other
rank ``start()`` runs the worker loop and ``submit`` raises.
"""
from __future__ import annotations

import itertools
import logging
import queue
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .. import observability as obs
from ..observability import cluster as _cluster
from ..observability import flight as _flight
from ..observability import health as _health
from ..optim.predictor import (bucket_for, pad_leading, shape_buckets,
                               shared_forward)
from ..optim.staging import place_host_value
from ..parallel import chaos as _chaos
from ..parallel.failure import FaultPolicy, classify_failure
from ..utils.engine import resolve_device
from ._lockstep import Lockstep
from .batching import (DeadlineExceeded, EngineStopped, QueueFull, Request,
                       ServeFuture, assemble)
from .registry import ModelRegistry

__all__ = ["ServingEngine", "serving_threads_alive"]

THREAD_NAME = "bigdl_tpu_torch-serving-batcher"

_STAT_KEYS = ("submitted", "completed", "rejected", "timeouts", "batches",
              "batch_errors", "request_errors", "swaps",
              "transient_retries")


class ServingEngine:
    """In-process online inference over one model architecture.

    model : a port ``Module`` with ``apply(params, state, x, training)``;
        its current params and state become version ``v0``.
    input_shape : per-sample shape (no batch dim). When given, ``start``
        drives every bucket once and assembly checks against it; when
        None, the first request of a batch sets the template.
    input_dtype : the host dtype requests are converted to.
    max_batch / max_wait_ms : the bucket ceiling (and flush size) and the
        batching window.
    max_queue : admission bound; ``submit`` past it raises
        :class:`QueueFull`.
    default_deadline_ms : per-request deadline when ``submit`` passes none.
    registry : a :class:`ModelRegistry` to serve from (default: one on the
        engine's device).
    warmup : drive every bucket at ``start`` (needs ``input_shape``).
    stall_deadline_s : the batcher beacon's watchdog deadline (None: the
        ``BIGDL_TPU_STALL_S`` default; active while observability is on).
    name / tags : replica name (beacon ``serving/batcher[<name>]``, chaos
        tag) and capability labels for a ``Router``.
    fault_policy : the batch replay budget (default
        ``FaultPolicy(max_restarts=1, backoff_base_s=0)``).
    device : where the engine serves: the CUDA device by default, ``'cpu'``
        for the CPU; with an explicit ``registry`` its device when this is
        None.
    """

    def __init__(self, model, *, input_shape: Optional[Sequence[int]] = None,
                 input_dtype=np.float32, max_batch: int = 16,
                 max_wait_ms: float = 2.0, max_queue: int = 128,
                 default_deadline_ms: Optional[float] = None,
                 registry: Optional[ModelRegistry] = None,
                 warmup: bool = True,
                 stall_deadline_s: Optional[float] = None,
                 mesh=None, placement=None, batch_spec=None,
                 name: Optional[str] = None, tags=(),
                 fault_policy: Optional[FaultPolicy] = None, device=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.model = model
        model.ensure_initialized()
        self.input_shape = (tuple(input_shape)
                            if input_shape is not None else None)
        self.input_dtype = np.dtype(input_dtype)
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.max_queue = int(max_queue)
        self.default_deadline_ms = default_deadline_ms
        self._warmup_on_start = warmup
        self._fwd = shared_forward(model)
        self.name = name
        self.tags = tuple(tags)
        self.beacon_name = ("serving/batcher" if name is None
                            else f"serving/batcher[{name}]")
        self.mesh = mesh
        self._batch_spec = None
        self._bucket_floor = 1
        self._ls = None
        if mesh is not None:
            from ..parallel import sharding as _sh
            from ..parallel.mesh import mesh_device
            if registry is not None and placement is not None:
                raise ValueError(
                    "placement= is applied by the registry the engine "
                    "builds - with an explicit registry= it would be "
                    "silently ignored; construct the registry with "
                    "mesh/param_specs yourself, or drop one argument")
            spec = (tuple(batch_spec) if batch_spec is not None
                    else _sh.serving_batch_spec(mesh))
            self._batch_spec = spec
            self._bucket_floor = _sh.batch_shard_count(mesh, spec)
            if self._bucket_floor > self.max_batch \
                    or self.max_batch % self._bucket_floor:
                raise ValueError(
                    f"max_batch {self.max_batch} must be a multiple of the "
                    f"batch shard count {self._bucket_floor} (mesh "
                    f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}, batch "
                    f"spec {spec}) so every bucket splits into whole "
                    "per-shard rows")
            self._specs = _sh.serving_param_specs(model.params, mesh,
                                                  placement)
            from ..nn.attention import Transformer
            # the model gathers its own slices block by block
            self._per_block = isinstance(model, Transformer) and all(
                ax in (None, "data", "model")
                for ax in _spec_axes(self._specs))
            if registry is None:
                registry = ModelRegistry(mesh=mesh, param_specs=self._specs)
            device = mesh_device(mesh)
        if registry is None:
            registry = ModelRegistry(device=resolve_device(device))
        self.device = resolve_device(registry.device if device is None
                                     else device)
        self.registry = registry
        if self.registry.current() is None:
            self.registry.publish(model.params, model.state, version="v0",
                                  activate=True)
        if mesh is not None:
            self._ls = Lockstep(mesh)
            if self._ls.is_root:
                self.registry.add_publish_listener(self._ls.on_publish)
        self._q: queue.Queue = queue.Queue(maxsize=int(max_queue))
        self._thread: Optional[threading.Thread] = None
        self._closed = False      # no new admissions; batcher drains
        self._stop = threading.Event()   # hard stop: abandon the queue
        self._pending = 0         # submitted, future not yet done
        self._cond = threading.Condition()
        self._stats = dict.fromkeys(_STAT_KEYS, 0)
        self._stats_lock = threading.Lock()
        self._rids = itertools.count()
        self.fault_policy = (fault_policy if fault_policy is not None
                             else FaultPolicy(max_restarts=1,
                                              backoff_base_s=0.0))
        self.stall_deadline_s = stall_deadline_s
        self._beacon = _health.NULL_BEACON
        self._snap_writer = _cluster.default_writer()

    # -- lifecycle -------------------------------------------------------

    def start(self):
        """Spawn the batcher (idempotent); with ``input_shape`` known,
        drive every bucket once first."""
        if self._thread is not None and self._thread.is_alive():
            return self
        if self._closed:
            raise EngineStopped("engine was shut down; build a new one")
        if self._ls is not None and not self._ls.is_root:
            # a worker rank: run rank 0's batches (its warmup included)
            self._thread = threading.Thread(
                target=self._work, name=THREAD_NAME + "-worker", daemon=True)
            self._thread.start()
            return self
        if self._warmup_on_start and self.input_shape is not None:
            self.warmup()
        self._beacon = _health.beacon(self.beacon_name,
                                      deadline_s=self.stall_deadline_s)
        self._thread = threading.Thread(
            target=self._batcher, name=THREAD_NAME, daemon=True)
        self._thread.start()
        return self

    def warmup(self):
        """Run the forward once at every bucket of
        ``shape_buckets(max_batch)`` against the active version (kernel
        builds and library setup before the first request)."""
        if self.input_shape is None:
            raise ValueError("warmup needs input_shape")
        mv = self.registry.current()
        for b in self._buckets():
            with obs.span("serve/warmup", bucket=b):
                self._run(mv, np.zeros((b,) + self.input_shape,
                                       self.input_dtype))
        return self

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every admitted request has resolved (True) or
        ``timeout`` seconds pass (False)."""
        with self._cond:
            return self._cond.wait_for(lambda: self._pending == 0, timeout)

    def shutdown(self, drain: bool = True, timeout: float = 30.0):
        """Graceful by default: stop admitting, flush the queue, join.
        ``drain=False`` fails queued requests with :class:`EngineStopped`."""
        with self._cond:
            self._closed = True
        if self._ls is not None and not self._ls.is_root:
            if self._thread is not None:     # runs until rank 0 stops
                self._thread.join()
            return
        if not drain:
            self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                logging.getLogger(__name__).warning(
                    "serving batcher did not join within %.0fs", timeout)
        self._beacon.close()
        if self._ls is not None:
            self._ls.stop()
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if not req.future.cancelled():
                try:
                    req.future.set_exception(
                        EngineStopped("engine shut down before dispatch"))
                except Exception:
                    pass

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.shutdown(drain=exc_type is None)
        return False

    # -- client surface --------------------------------------------------

    def submit(self, x, deadline_ms: Optional[float] = None) -> ServeFuture:
        """Enqueue ONE unbatched sample; returns the future its batch will
        resolve. Raises :class:`QueueFull` or :class:`EngineStopped`. A
        request whose deadline passes before its batch dispatches fails
        with :class:`DeadlineExceeded`. Submitting before :meth:`start`
        queues the request."""
        if self._ls is not None and not self._ls.is_root:
            raise RuntimeError("only mesh rank 0 takes requests; this rank "
                               "runs its batches (start() runs the worker "
                               "loop)")
        ms = deadline_ms if deadline_ms is not None else \
            self.default_deadline_ms
        req = Request(x, deadline_s=ms / 1000.0 if ms is not None else None,
                      rid=next(self._rids))
        try:
            # the closed check and the enqueue are one step against
            # shutdown's close, so the drain always sees the request
            with self._cond:
                if self._closed:
                    raise EngineStopped("engine is shutting down")
                self._q.put_nowait(req)
                self._pending += 1
        except queue.Full:
            self._bump("rejected")
            if obs.enabled():
                obs.counter("serve/rejected").inc()
            raise QueueFull(f"request queue at capacity ({self.max_queue})")
        req.future.add_done_callback(
            lambda f, t0=req.t_enqueue: self._on_done(f, t0))
        self._bump("submitted")
        if obs.enabled():
            obs.gauge("serve/queue_depth").set(self._q.qsize())
        return req.future

    def predict(self, x, timeout: Optional[float] = None,
                deadline_ms: Optional[float] = None):
        """Synchronous ``submit(x).result(timeout)``."""
        if self._thread is None:
            raise RuntimeError("engine not started - call start() or use "
                               "it as a context manager")
        return self.submit(x, deadline_ms=deadline_ms).result(timeout)

    def swap(self, params, state=None, version: Optional[str] = None) -> str:
        """Hot swap: place new params on the engine's device (on this
        thread, traffic flowing) and activate them; batches already cut
        finish on the old version. ``state=None`` inherits the active
        version's state. Returns the new version id."""
        if state is None:
            cur = self.registry.current()
            state = cur.state if cur is not None else self.model.state
        v = self.registry.publish(params, state, version=version,
                                  activate=False)
        self.registry.activate(v)
        self._bump("swaps")
        if obs.enabled():
            obs.instant("serve/swap", version=v)
        return v

    def stats(self) -> dict:
        with self._stats_lock:
            out = dict(self._stats)
        out["pending"] = self._pending
        out["queue_depth"] = self._q.qsize()
        out["active_version"] = self.registry.active_version
        return out

    # -- batcher ---------------------------------------------------------

    def _batcher(self):
        try:
            while not self._stop.is_set():
                self._beacon.pulse()
                if obs.enabled():
                    self._snap_writer.maybe_write()
                batch = self._collect()
                if batch:
                    self._dispatch(batch)
                elif self._closed:
                    break  # drained: closed engine with an empty queue
        except BaseException as e:  # noqa: BLE001 - post-mortem, then die
            if obs.enabled():
                _flight.dump_crash_bundle(error=e, context={
                    "component": "serving/batcher", "stats": self.stats()})
            raise

    def _collect(self):
        """One micro-batch: the first request blocks (bounded poll), then
        fill until ``max_batch`` or the window ends; once closing, the
        window collapses."""
        try:
            first = self._q.get(timeout=0.05)
        except queue.Empty:
            return None
        batch = [first]
        flush_at = time.monotonic() + self.max_wait_ms / 1000.0
        while len(batch) < self.max_batch and not self._stop.is_set():
            wait = flush_at - time.monotonic()
            if self._closed:
                wait = 0.0
            try:
                if wait <= 0:
                    batch.append(self._q.get_nowait())
                else:
                    batch.append(self._q.get(timeout=wait))
            except queue.Empty:
                break
        if obs.enabled():
            obs.gauge("serve/queue_depth").set(self._q.qsize())
        return batch

    def _dispatch(self, batch):
        """Serve one micro-batch against ONE version: expire, assemble,
        pad, place, forward and read back (the replay unit), scatter."""
        t_cut_ns = time.perf_counter_ns()
        now = time.monotonic()
        ready = []
        for r in batch:
            if r.future.cancelled():
                continue
            if r.expired(now):
                self._bump("timeouts")
                if obs.enabled():
                    obs.counter("serve/timeouts").inc()
                try:
                    r.future.set_exception(DeadlineExceeded(
                        "deadline passed while queued"))
                except Exception:
                    pass
                continue
            if not r.future.set_running_or_notify_cancel():
                continue
            ready.append(r)
        with obs.span("serve/assemble", rids=[r.rid for r in ready]):
            x, live = assemble(ready, template_shape=self.input_shape,
                               dtype=self.input_dtype)
        t_asm_ns = time.perf_counter_ns()
        if len(ready) != len(live):
            self._bump("request_errors", len(ready) - len(live))
        if x is None:
            return
        n = len(live)
        rids = [r.rid for r in live]
        assemble_ms = (t_asm_ns - t_cut_ns) / 1e6
        if obs.enabled():
            qh = obs.histogram("serve/queue_wait_ms", unit="ms")
            for r in live:
                # one virtual lane per request: the waits all end at the
                # cut and would otherwise nest as siblings
                obs.complete("serve/queue_wait", r.t_enqueue_ns, t_cut_ns,
                             tid=-(r.rid + 1), rid=r.rid)
                qh.observe((t_cut_ns - r.t_enqueue_ns) / 1e6)
            obs.histogram("serve/assemble_ms", unit="ms").observe(
                assemble_ms)
        bucket = self._bucket_for(n)
        mv = self.registry.current()  # ONE version per batch
        sp = obs.span("serve/batch", bucket=bucket, n=n, version=mv.version)
        t_fwd_ns = time.perf_counter_ns()

        def forward():
            _chaos.maybe_fire("serving/engine_dispatch", tag=self.name)
            # the readback is inside the unit: a CUDA fault surfaces here
            return self._run(mv, pad_leading(x, bucket))

        pol = self.fault_policy
        try:
            with sp:
                attempt = 0
                while True:
                    try:
                        with obs.span("serve/dispatch" if attempt == 0
                                      else "serve/retry_dispatch",
                                      rids=rids, bucket=bucket,
                                      version=mv.version):
                            host = forward()
                        pol.record_success()
                        break
                    except BaseException as e:  # noqa: BLE001 - classify
                        cls = classify_failure(e)
                        if self._stop.is_set() or not pol.should_retry(cls):
                            raise
                        pol.record_failure()
                        attempt += 1
                        self._bump("transient_retries")
                        if obs.enabled():
                            obs.counter("serve/transient_retries").inc()
                            _health.emit("serve_retry", bucket=bucket, n=n,
                                         version=mv.version, attempt=attempt,
                                         error=f"{type(e).__name__}: {e}")
                        delay = pol.backoff_s()
                        if delay > 0:
                            pol.sleep(delay)
        except BaseException as e:  # noqa: BLE001 - batch fails, batcher lives
            # the next batch is a fresh unit with its own budget
            pol.reset()
            self._bump("batch_errors")
            if obs.enabled():
                obs.counter("serve/batch_errors").inc()
            for r in live:
                try:
                    r.future.set_exception(e)
                except Exception:
                    pass
            return
        dispatch_ms = (time.perf_counter_ns() - t_fwd_ns) / 1e6
        if obs.enabled():
            obs.histogram("serve/dispatch_ms", unit="ms").observe(
                dispatch_ms)
        for i, r in enumerate(live):
            r.future.version = mv.version
            r.future.trace = {
                "rid": r.rid,
                "queue_wait_ms": (t_cut_ns - r.t_enqueue_ns) / 1e6,
                "assemble_ms": assemble_ms,
                "dispatch_ms": dispatch_ms,
                "bucket": bucket,
                "version": mv.version,
            }
            try:
                # a copy: a client keeping its row must not pin the batch
                r.future.set_result(host[i].copy())
            except Exception:
                pass
        self._bump("batches")
        self._bump("completed", n)
        if obs.enabled():
            obs.counter("serve/batches").inc()
            obs.counter("serve/requests").inc(n)
            obs.histogram("serve/batch_occupancy").observe(n / bucket)
            _flight.record("serve/batch", n=n, bucket=bucket,
                           version=mv.version, rid_first=rids[0],
                           rid_last=rids[-1],
                           dispatch_ms=round(dispatch_ms, 3))

    # -- internals -------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        """Padded batch size for ``n`` live rows: the power-of-two bucket,
        rounded up to a multiple of the mesh's batch shard count (every
        shard gets whole rows; ``max_batch`` is a multiple of it)."""
        b = max(bucket_for(n, self.max_batch), self._bucket_floor)
        f = self._bucket_floor
        if b % f:
            b = min(self.max_batch, -(-b // f) * f)
        return b

    def _buckets(self):
        """The reachable buckets: ``shape_buckets`` through the shard
        rounding (what warmup drives)."""
        out = []
        for b in shape_buckets(self.max_batch):
            rb = self._bucket_for(b)
            if rb not in out:
                out.append(rb)
        return tuple(out)

    def _run(self, mv, x):
        """The forward of one padded host batch under version ``mv`` and
        its readback (numpy). Over a mesh, rank 0 first sends the batch to
        every rank, and the rows come back from the ranks that ran them."""
        if self._ls is None:
            return self._fwd(mv.params, mv.state,
                             self._place_batch(x)).cpu().numpy()
        self._ls.send(("run", mv.version, np.asarray(x)))
        return self._run_shard(mv, x)

    def _run_shard(self, mv, x):
        """This rank's rows of the batch ``x`` (the rows the batch spec
        gives it) under ``mv``'s gathered parameters; on rank 0, every
        block gathered back in row order."""
        import torch.distributed as dist
        from ..parallel.collective import over
        from ..parallel.mesh import mesh_ranks
        from ..parallel.sharding import _axes_index, _gather_whole, _rows
        axes = self._batch_spec[0] if self._batch_spec else ()
        axes = axes if isinstance(axes, tuple) else (axes,)
        xs = _rows(x, self.mesh, axes) if axes else x
        with over(self.mesh):
            params = (mv.params if self._per_block
                      else _gather_whole(mv.params, self._specs, self.mesh))
            out = self._fwd(params, mv.state, self._place_batch(xs))
        del params
        out = out.contiguous()
        # every rank's block (in the lockstep group's rank order), then the
        # blocks in row order by each rank's batch index
        both = out.new_empty((self.mesh.size(),) + tuple(out.shape))
        dist.all_gather_into_tensor(both, out[None], group=self._ls.group)
        parts = both.unbind(0)
        if not self._ls.is_root:
            return None
        ranks = sorted(int(r) for r in mesh_ranks(self.mesh).flat)
        n, _ = _axes_index(self.mesh, axes) if axes else (1, 0)
        coords = {int(r): c for c, r in np.ndenumerate(
            mesh_ranks(self.mesh))}
        names = list(self.mesh.mesh_dim_names)
        blocks = [None] * n
        for g, t in zip(ranks, parts):
            i = 0
            for a in axes:
                k = names.index(a)
                i = i * self.mesh.shape[k] + coords[g][k]
            if blocks[i] is None:
                blocks[i] = t
        return torch.cat(blocks).cpu().numpy()

    def _work(self):
        """The worker loop of a rank other than mesh rank 0: run each of
        rank 0's batches on this rank's rows until it shuts down."""
        while True:
            cmd = self._ls.recv()
            if cmd[0] == "stop":
                return
            if cmd[0] == "run":
                self._run_shard(self.registry.get(cmd[1]), cmd[2])
            elif cmd[0] == "publish":
                _, version, params, state = cmd
                self.registry.publish(params, state, version=version,
                                      activate=True)
            elif cmd[0] == "retire":
                if self.registry.active_version != cmd[1]:
                    self.registry.retire(cmd[1])

    def _place_batch(self, x):
        return place_host_value(x, self.device)

    def _on_done(self, future, t_enqueue):
        # latency covers served requests only
        if obs.enabled() and not future.cancelled() \
                and future.exception() is None:
            obs.histogram("serve/latency_ms", unit="ms").observe(
                (time.monotonic() - t_enqueue) * 1000.0)
        with self._cond:
            self._pending -= 1
            self._cond.notify_all()

    def _bump(self, key: str, n: int = 1):
        with self._stats_lock:
            self._stats[key] += n


def _spec_axes(specs):
    """Every axis name a spec tree splits over."""
    if isinstance(specs, dict):
        return [a for v in specs.values() for a in _spec_axes(v)]
    spec = tuple(getattr(specs, "spec", specs) or ())
    return [a for ax in spec
            for a in (ax if isinstance(ax, tuple) else (ax,))]


def serving_threads_alive() -> int:
    """Live batcher threads (tests assert 0 after shutdown)."""
    return sum(1 for t in threading.enumerate()
               if t.name == THREAD_NAME and t.is_alive())
