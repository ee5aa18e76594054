"""Continuous batching: iteration-level LM decode scheduling (counterpart
of ``bigdl_tpu/serving/decode_scheduler.py``, core only).

Requests join the running batch at the step boundary after they arrive and
leave at the step they finish; every step is one ``Transformer.decode_paged``
call over the paged KV pool (``kv_cache.PagedKVCache``), whose attention is
the paged-attention kernel on a CUDA device.

* Active rows pad to power-of-two buckets with a floor of 2 (the JAX
  package's GEMM M-class rule; it also bounds the set of shapes).
* Prompts prefill in fixed chunks (power-of-two tail) through the same
  paged step, interleaved one chunk per step boundary with the decode
  steps, so a long prompt delays the running batch by one chunk at a time.
* Admission is FIFO and reserves each request's worst-case blocks up
  front, so no step runs out of blocks mid-flight.
* A request pins the model version active at its admission; each dispatch
  serves one version group (hot swap never mixes versions).
* Per-request sampling: greedy by default; with ``temperature > 0``,
  temperature + top-p sampling whose uniform draw for position ``p`` comes
  from a ``torch.Generator`` seeded by (request seed, p), so a request's
  samples do not depend on what shares its batch.

Not in this slice (and not accepted by the constructor): the prefix
cache, speculative decoding, the host KV tier and preemption, mesh/tensor
parallel serving, fault replay, chaos sites and observability.
"""
from __future__ import annotations

import itertools
import logging
import queue
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..optim.predictor import bucket_for
from ..utils.engine import refuse_unported
from .batching import DeadlineExceeded, EngineStopped, QueueFull, ServeFuture
from .kv_cache import KVCacheOOM, PagedKVCache, blocks_for_tokens
from .registry import ModelRegistry

THREAD_NAME = "bigdl_tpu_torch-serving-decode-scheduler"

_STAT_KEYS = ("submitted", "completed", "rejected", "timeouts",
              "decode_steps", "prefill_chunks", "tokens", "swaps")

_MASK64 = (1 << 64) - 1


def _pow2_bucket(n: int, cap: int, floor: int = 2) -> int:
    """Smallest power of two >= n, floored and capped."""
    b = floor
    while b < n:
        b <<= 1
    return min(b, cap)


def prefill_schedule(prompt_len: int, chunk: int):
    """The chunked-prefill plan for a prompt: [(start, real, padded)].
    Full chunks run at ``chunk``; the tail pads to a power-of-two bucket
    (floor 2)."""
    out = []
    s = 0
    while s < prompt_len:
        real = min(chunk, prompt_len - s)
        out.append((s, real, _pow2_bucket(real, chunk)))
        s += real
    return out


def prefill_padded_end(prompt_len: int, chunk: int) -> int:
    """Highest position (exclusive) the padded prefill writes."""
    s, real, padded = prefill_schedule(prompt_len, chunk)[-1]
    return s + padded


def sample_seed(seed: int, position: int) -> int:
    """The seed of the ``torch.Generator`` that draws request ``seed``'s
    token at ``position`` (a splitmix64 finalizer of the pair)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(position) * 0xBF58476D1CE4E5B9
         + 0x94D049BB133111EB) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


class LMRequest:
    """One in-flight generation: prompt, budget, and decode state."""

    __slots__ = ("prompt", "max_new_tokens", "eos_id", "future", "rid",
                 "deadline", "t_enqueue", "t_enqueue_ns", "t_admit_ns",
                 "t_first_ns", "t_done_ns", "prefill_ms", "version",
                 "model_version", "slot", "pos", "generated", "steps",
                 "chunks", "pf_i", "temperature", "top_p", "seed")

    def __init__(self, prompt, max_new_tokens, eos_id, deadline_s, rid,
                 temperature: float = 0.0, top_p: float = 1.0,
                 seed: int = 0, priority: int = 0):
        refuse_unported("LMRequest", priority=(priority, 0))
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.seed = int(seed) & 0xFFFFFFFF
        self.future = ServeFuture()
        self.future.rid = rid
        self.rid = rid
        self.t_enqueue = time.monotonic()
        self.t_enqueue_ns = time.perf_counter_ns()
        self.t_admit_ns = None
        self.t_first_ns = None
        self.t_done_ns = None
        self.prefill_ms = 0.0
        self.deadline = (self.t_enqueue + deadline_s
                         if deadline_s is not None else None)
        self.version = None
        self.model_version = None
        self.slot = None
        self.pos = 0          # next cache write position
        self.generated = []
        self.steps = 0
        self.chunks = None
        self.pf_i = 0

    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline is not None
                and (now or time.monotonic()) > self.deadline)


class DecodeScheduler:
    """Iteration-level LM serving over one decoder-only model.

    model : a ``Transformer`` (``models.TransformerLM``); the scheduler
        runs on the model's device.
    max_slots : slot capacity of the running batch (>= 2).
    block_size / max_seq_len : paged-KV geometry; ``max_seq_len`` bounds
        prompt + generation per request (<= the model's ``max_len``).
    num_blocks : pooled block count (+1 null block); the default lets
        every slot hold a full ``max_seq_len`` sequence.
    prefill_chunk : chunked-prefill piece size (power of two >= 2).
    admission : ``"continuous"`` or ``"static"`` (a batch admits only
        when the previous one fully drained - the baseline).
    eos_id : default end-of-sequence id (per-request override at submit).
    sampling_seed : base of the per-request seeds of sampled requests.
    prefix_cache : JAX's default (True) shares the KV blocks of equal
        prompt prefixes; the port has no prefix cache yet (ROADMAP A.1),
        so True and False both serve without sharing (the tokens are the
        same, the block use is not).
    preempt : as in JAX, preemption needs the host KV tier
        (``host_blocks`` > 0), which is not ported, so it never fires.

    Not ported, and refused at a value other than JAX's default:
    ``draft_model`` / ``spec_k`` (speculative decoding),
    ``stall_deadline_s``, ``prefix_cache_entries``, ``mesh`` /
    ``placement``, ``name``, ``tags``, ``fault_policy``, ``audit_every``
    (periodic audits; :meth:`audit` runs one on demand) and
    ``host_blocks``.
    """

    def __init__(self, model, *, max_slots: int = 8, block_size: int = 16,
                 max_seq_len: int = 256, num_blocks: Optional[int] = None,
                 prefill_chunk: int = 32, draft_model=None, spec_k: int = 4,
                 max_queue: int = 256,
                 default_deadline_ms: Optional[float] = None,
                 eos_id: Optional[int] = None,
                 registry: Optional[ModelRegistry] = None,
                 admission: str = "continuous",
                 static_wait_ms: float = 4.0,
                 stall_deadline_s: Optional[float] = None,
                 sampling_seed: int = 0, prefix_cache: bool = True,
                 prefix_cache_entries: Optional[int] = None, mesh=None,
                 placement=None, name: Optional[str] = None, tags=(),
                 fault_policy=None, audit_every: int = 256,
                 host_blocks: int = 0, preempt: bool = True):
        refuse_unported("DecodeScheduler", draft_model=(draft_model, None),
                        spec_k=(spec_k, 4),
                        stall_deadline_s=(stall_deadline_s, None),
                        prefix_cache_entries=(prefix_cache_entries, None),
                        mesh=(mesh, None), placement=(placement, None),
                        name=(name, None), tags=(tuple(tags), ()),
                        fault_policy=(fault_policy, None),
                        audit_every=(audit_every, 256),
                        host_blocks=(host_blocks, 0))
        if model.mode != "lm":
            raise ValueError("DecodeScheduler serves LM-mode models")
        if max_slots < 2:
            raise ValueError(f"max_slots must be >= 2 (the bucket floor), "
                             f"got {max_slots}")
        if prefill_chunk < 2 or (prefill_chunk & (prefill_chunk - 1)):
            raise ValueError(f"prefill_chunk must be a power of two >= 2, "
                             f"got {prefill_chunk}")
        if max_seq_len > model.max_len:
            raise ValueError(f"max_seq_len {max_seq_len} > model.max_len "
                             f"{model.max_len}")
        if admission not in ("continuous", "static"):
            raise ValueError(f"admission must be 'continuous' or 'static', "
                             f"got {admission!r}")
        self.model = model
        self.device = model.device
        self.max_slots = int(max_slots)
        self.max_seq_len = int(max_seq_len)
        self.prefill_chunk = int(prefill_chunk)
        self.admission = admission
        self.default_deadline_ms = default_deadline_ms
        self.eos_id = eos_id
        self.sampling_seed = int(sampling_seed)
        mbs = blocks_for_tokens(max_seq_len, block_size)
        if num_blocks is None:
            num_blocks = self.max_slots * mbs + 1
        self.kv = PagedKVCache(model, num_blocks=num_blocks,
                               block_size=block_size, max_blocks_per_seq=mbs)
        self.registry = registry or ModelRegistry(device=self.device)
        if self.registry.current() is None:
            self.registry.publish(model.params, model.state, version="v0",
                                  activate=True)
        self.static_wait_ms = float(static_wait_ms)
        self.max_queue = int(max_queue)
        self._q: queue.Queue = queue.Queue(maxsize=self.max_queue)
        self._backlog: deque = deque()     # arrival order
        self._prefilling: deque = deque()  # admitted, prompt mid-prefill
        self._active: list = []            # decoding requests
        self._free_slots = list(range(self.max_slots - 1, -1, -1))
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._stop = threading.Event()
        self._pending = 0
        self._cond = threading.Condition()
        self._stats = dict.fromkeys(_STAT_KEYS, 0)
        self._stats_lock = threading.Lock()
        self._rids = itertools.count()

    # -- the step --------------------------------------------------------

    def _dispatch(self, params, tokens, positions, tables, rows):
        """One ``decode_paged`` call over the pool (pages updated in
        place) and the token choice for every (row, chunk position).
        ``rows``: the requests of the first rows (the rest is padding).
        Returns (B, S) int numpy choices - the one readback of a step."""
        dev = self.device
        logits, _ = self.model.decode_paged(
            params, torch.from_numpy(tokens).to(dev),
            torch.from_numpy(positions).to(dev), self.kv.pages(),
            torch.from_numpy(tables).to(dev))
        choices = logits.argmax(-1)
        sampled = [(i, r) for i, r in enumerate(rows) if r.temperature > 0.0]
        if sampled:
            choices = choices.clone()
            for i, r in sampled:
                choices[i] = self._sample_row(logits[i], int(positions[i]),
                                              r)
        return choices.cpu().numpy()

    def _sample_row(self, logits, pos0, req):
        """Temperature + top-p (nucleus) choice for one row's S positions:
        keep the smallest prefix of the sorted distribution whose mass
        before a token is < top_p (the top token always survives), then
        invert the kept CDF at a uniform draw seeded by (seed, position)."""
        S, V = logits.shape
        scaled = logits.float() / max(req.temperature, 1e-6)
        srt, order = scaled.sort(-1, descending=True)
        probs = torch.softmax(srt, -1)
        keep = (probs.cumsum(-1) - probs) < req.top_p
        kept = torch.where(keep, probs, torch.zeros_like(probs))
        cdf = kept.cumsum(-1)
        u = torch.tensor(
            [torch.rand((), generator=torch.Generator().manual_seed(
                sample_seed(req.seed, pos0 + s))).item() for s in range(S)],
            dtype=torch.float32, device=logits.device)
        idx = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None])
        idx = torch.minimum(idx, keep.sum(-1, keepdim=True) - 1)
        return order.gather(-1, idx)[:, 0]

    # -- lifecycle -------------------------------------------------------

    def start(self, warmup: bool = True):
        if self._thread is not None and self._thread.is_alive():
            return self
        if self._closed:
            raise EngineStopped("scheduler was shut down; build a new one")
        if warmup:
            self.warmup()
        self._thread = threading.Thread(target=self._loop, name=THREAD_NAME,
                                        daemon=True)
        self._thread.start()
        return self

    def warmup(self):
        """Drive every shape the scheduler dispatches once - decode buckets
        {2, 4, ..., max_slots} and prefill chunk shapes {2, ...,
        prefill_chunk} - against the null table (writes land in the null
        block), so kernel builds and library setup happen before the
        first request."""
        def shapes_upto(cap):
            out, b = [], 2
            while b < cap:
                out.append(b)
                b <<= 1
            return out + [cap]

        params = self.registry.current().params
        mbs = self.kv.max_blocks_per_seq
        for B, S in ([(b, 1) for b in shapes_upto(self.max_slots)]
                     + [(1, s) for s in shapes_upto(self.prefill_chunk)]):
            self._dispatch(params, np.zeros((B, S), np.int32),
                           np.zeros((B,), np.int32),
                           np.zeros((B, mbs), np.int32), ())
        return self

    def drain(self, timeout: Optional[float] = None) -> bool:
        with self._cond:
            return self._cond.wait_for(lambda: self._pending == 0, timeout)

    def shutdown(self, drain: bool = True, timeout: float = 60.0):
        """Graceful by default: stop admitting, finish everything queued
        or active, join. ``drain=False`` fails in-flight work with
        :class:`EngineStopped`. Every KV block returns to the free list."""
        with self._cond:
            self._closed = True
        if not drain:
            self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                logging.getLogger(__name__).warning(
                    "decode scheduler did not join within %.0fs - "
                    "hard-stopping", timeout)
                self._stop.set()
                t.join(10.0)
                if t.is_alive():
                    logging.getLogger(__name__).error(
                        "decode scheduler wedged - skipping state cleanup")
                    return
        self._abandon_inflight("scheduler shut down before completion")

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.shutdown(drain=exc_type is None)
        return False

    # -- client surface --------------------------------------------------

    def submit(self, prompt_ids, max_new_tokens: int,
               deadline_ms: Optional[float] = None, eos_id="default",
               temperature: float = 0.0, top_p: float = 1.0,
               seed: Optional[int] = None) -> ServeFuture:
        """Enqueue one generation request: ``prompt_ids`` (1-D int) ->
        future resolving to the GENERATED ids (np.int32, prompt excluded).
        Raises :class:`QueueFull` at capacity and ``ValueError`` for a
        request that cannot fit ``max_seq_len``; a deadline that expires
        fails the future with :class:`DeadlineExceeded` carrying the tokens
        so far on ``.partial``."""
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must be non-empty")
        worst = max(prefill_padded_end(prompt.size, self.prefill_chunk),
                    prompt.size + max_new_tokens)
        if worst > self.max_seq_len:
            raise ValueError(
                f"prompt {prompt.size} + max_new {max_new_tokens} (+ prefill "
                f"padding) needs {worst} positions > max_seq_len "
                f"{self.max_seq_len}")
        ms = deadline_ms if deadline_ms is not None \
            else self.default_deadline_ms
        eid = self.eos_id if eos_id == "default" else eos_id
        rid = next(self._rids)
        if seed is None:
            seed = ((self.sampling_seed * 0x9E3779B9 + rid * 0x85EBCA6B
                     + 0xC2B2AE35) & 0xFFFFFFFF)
        req = LMRequest(prompt, max_new_tokens, eid,
                        ms / 1000.0 if ms is not None else None, rid,
                        temperature=temperature, top_p=top_p, seed=seed)
        try:
            with self._cond:
                if self._closed:
                    raise EngineStopped("scheduler is shutting down")
                self._q.put_nowait(req)
                self._pending += 1
        except queue.Full:
            self._bump("rejected")
            raise QueueFull(f"request queue at capacity ({self.max_queue})")
        req.future.add_done_callback(self._on_done)
        self._bump("submitted")
        return req.future

    def generate(self, prompt_ids, max_new_tokens: int,
                 timeout: Optional[float] = None, **kw) -> np.ndarray:
        """Synchronous ``submit(...).result(timeout)``."""
        if self._thread is None:
            raise RuntimeError("scheduler not started - call start() or use "
                               "it as a context manager")
        return self.submit(prompt_ids, max_new_tokens, **kw).result(timeout)

    def swap(self, params, state=None, version: Optional[str] = None) -> str:
        """Hot swap: publish and activate new params (and state). In-flight
        requests keep the version they pinned at admission. ``state=None``
        inherits the active version's state."""
        if state is None:
            cur = self.registry.current()
            state = cur.state if cur is not None else self.model.state
        v = self.registry.publish(params, state, version=version,
                                  activate=True)
        self._bump("swaps")
        return v

    def stats(self) -> dict:
        with self._stats_lock:
            out = dict(self._stats)
        out["pending"] = self._pending
        out["queue_depth"] = self._q.qsize() + len(self._backlog)
        out["active"] = len(self._active)
        out["prefilling"] = len(self._prefilling)
        out["active_version"] = self.registry.active_version
        out["kv"] = self.kv.stats()
        return out

    def audit(self) -> dict:
        """The KV ledger audit (call at a quiesced point)."""
        return self.kv.audit(prefix_pins={})

    # -- scheduler loop --------------------------------------------------

    def _loop(self):
        try:
            while not self._stop.is_set():
                self._pull_pending()
                self._admit()
                stepped = self._advance_prefill()
                stepped |= self._step_all()
                self._evict_expired()
                if self._closed and not self._active \
                        and not self._prefilling and not self._backlog \
                        and self._q.empty():
                    break
                if not stepped:
                    try:
                        self._backlog.append(self._q.get(
                            timeout=0.002 if self._backlog else 0.02))
                    except queue.Empty:
                        pass
        except BaseException as e:  # noqa: BLE001 - fail every client, then die
            logging.getLogger(__name__).exception("decode scheduler died")
            with self._cond:
                self._closed = True
            self._abandon_inflight(
                f"decode scheduler died: {type(e).__name__}: {e}")
            raise

    def _pull_pending(self):
        while True:
            try:
                self._backlog.append(self._q.get_nowait())
            except queue.Empty:
                return

    def _abandon_inflight(self, msg: str):
        leftovers = list(self._active) + list(self._prefilling) \
            + list(self._backlog)
        self._active.clear()
        self._prefilling.clear()
        self._backlog.clear()
        while True:
            try:
                leftovers.append(self._q.get_nowait())
            except queue.Empty:
                break
        for r in leftovers:
            partial = np.asarray(r.generated, np.int32)
            self._release(r)
            if not r.future.done():
                exc = EngineStopped(msg)
                exc.partial = partial
                r.future.set_exception(exc)

    def _admit(self):
        """Admit the backlog head-of-line into free slots while its
        worst-case block need is reservable (FIFO: a smaller later request
        never overtakes). Static mode waits for the running batch to
        drain and for a fill window."""
        if self.admission == "static":
            if self._active or self._prefilling:
                return
            if self._backlog and len(self._backlog) < self.max_slots \
                    and not self._closed:
                oldest = self._backlog[0].t_enqueue
                if (time.monotonic() - oldest) * 1000.0 < \
                        self.static_wait_ms:
                    return
        while self._backlog and self._free_slots:
            req = self._backlog[0]
            if req.future.cancelled():
                self._backlog.popleft()
                self._finish(req, cancel=True)
                continue
            if req.expired():
                self._backlog.popleft()
                self._expire(req)
                continue
            worst = max(prefill_padded_end(req.prompt.size,
                                           self.prefill_chunk),
                        req.prompt.size + req.max_new_tokens)
            try:
                self.kv.ensure_capacity(req.rid, worst)
            except KVCacheOOM:
                break   # backpressure: retry at the next boundary
            mv = self.registry.current()
            self._backlog.popleft()
            req.slot = self._free_slots.pop()
            req.version = mv.version
            req.model_version = mv
            req.t_admit_ns = time.perf_counter_ns()
            req.chunks = prefill_schedule(req.prompt.size,
                                          self.prefill_chunk)
            req.pf_i = 0
            if not req.future.set_running_or_notify_cancel():
                self._finish(req, cancel=True)
                continue
            self._prefilling.append(req)

    def _advance_prefill(self) -> bool:
        """ONE prefill chunk of the head prefilling request. The last
        chunk's final real position gives the first generated token."""
        if not self._prefilling:
            return False
        req = self._prefilling[0]
        t0 = time.perf_counter_ns()
        s, real, padded = req.chunks[req.pf_i]
        last = req.pf_i == len(req.chunks) - 1
        toks = np.zeros((1, padded), np.int32)
        toks[0, :real] = req.prompt[s:s + real]
        choices = self._dispatch(req.model_version.params, toks,
                                 np.asarray([s], np.int32),
                                 self.kv.block_table(req.rid)[None], [req])
        self._bump("prefill_chunks")
        req.pf_i += 1
        req.prefill_ms += (time.perf_counter_ns() - t0) / 1e6
        if not last:
            return True
        self._prefilling.popleft()
        # the reservation covered the padded prefill tail; give back the
        # blocks past what generation needs
        self.kv.truncate(req.rid, int(req.prompt.size) + req.max_new_tokens)
        req.pos = int(req.prompt.size)
        req.t_first_ns = time.perf_counter_ns()
        self._bump("tokens")
        self._active.append(req)
        self._emit(req, int(choices[0, real - 1]))
        return True

    def _emit(self, req, token) -> bool:
        """Append one token; finish the request on EOS or budget."""
        req.generated.append(int(token))
        done = (req.eos_id is not None and int(token) == req.eos_id) \
            or len(req.generated) >= req.max_new_tokens
        if done:
            self._finish(req)
        return done

    def _step_all(self) -> bool:
        """One decode dispatch per active version group."""
        if not self._active:
            return False
        groups = {}
        for r in self._active:
            groups.setdefault(r.version, []).append(r)
        for rows in groups.values():
            self._step_group(rows)
        return True

    def _step_group(self, rows):
        n = len(rows)
        bucket = bucket_for(max(n, 2), self.max_slots)
        tokens = np.zeros((bucket, 1), np.int32)
        positions = np.zeros((bucket,), np.int32)
        tables = np.zeros((bucket, self.kv.max_blocks_per_seq), np.int32)
        for i, r in enumerate(rows):
            tokens[i, 0] = r.generated[-1]
            positions[i] = r.pos
            tables[i] = self.kv.block_table(r.rid)
        toks = self._dispatch(rows[0].model_version.params, tokens,
                              positions, tables, rows)[:, 0]
        self._bump("decode_steps")
        self._bump("tokens", n)
        for i, r in enumerate(rows):
            r.pos += 1
            r.steps += 1
            self._emit(r, toks[i])

    # -- eviction / completion -------------------------------------------

    def _evict_expired(self):
        now = time.monotonic()
        for r in list(self._active) + list(self._prefilling):
            if r.expired(now):
                self._expire(r)
        for r in list(self._backlog):
            if r.expired(now):
                self._backlog.remove(r)
                self._expire(r)

    def _expire(self, req):
        self._bump("timeouts")
        exc = DeadlineExceeded(
            f"deadline passed after {len(req.generated)} of "
            f"{req.max_new_tokens} tokens")
        exc.partial = np.asarray(req.generated, np.int32)
        self._release(req)
        if not req.future.done():
            req.future.set_exception(exc)

    def _finish(self, req, cancel: bool = False):
        req.t_done_ns = time.perf_counter_ns()
        version = req.version
        self._release(req)
        if cancel:
            return
        out = np.asarray(req.generated, np.int32)
        n = out.size
        tpot = ((req.t_done_ns - req.t_first_ns) / 1e6 / (n - 1)
                if (req.t_first_ns and n > 1) else 0.0)
        req.future.version = version
        req.future.trace = {
            "rid": req.rid,
            "queue_wait_ms": ((req.t_admit_ns or req.t_enqueue_ns)
                              - req.t_enqueue_ns) / 1e6,
            "prefill_ms": req.prefill_ms,
            "ttft_ms": ((req.t_first_ns - req.t_enqueue_ns) / 1e6
                        if req.t_first_ns else None),
            "tpot_ms": tpot,
            "decode_steps": req.steps,
            "tokens": n,
            "version": version,
        }
        self._bump("completed")
        if not req.future.done():
            req.future.set_result(out)

    def _release(self, req):
        """Return the request's slot and KV blocks (safe to call twice)."""
        if req in self._active:
            self._active.remove(req)
        if req in self._prefilling:
            self._prefilling.remove(req)
        if req.slot is not None:
            self._free_slots.append(req.slot)
            req.slot = None
        self.kv.free(req.rid)
        req.model_version = None

    def _on_done(self, future):
        with self._cond:
            self._pending -= 1
            self._cond.notify_all()

    def _bump(self, key: str, n: int = 1):
        with self._stats_lock:
            self._stats[key] += n


def decode_scheduler_threads_alive() -> int:
    """Live scheduler threads (tests assert 0 after shutdown)."""
    return sum(1 for t in threading.enumerate()
               if t.name == THREAD_NAME and t.is_alive())
