"""Continuous batching: iteration-level LM decode scheduling (counterpart
of ``bigdl_tpu/serving/decode_scheduler.py``).

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
  front (speculative overshoot included, less the shared prefix it adopts,
  plus the copy-on-write forks its plan takes), so no step runs out of
  blocks mid-flight.
* Shared prompt prefixes come from the content-addressed prefix cache
  (``prefix_cache.PrefixCache``, on by default): admission adopts the
  longest cached prefix aligned to ``max(prefill_chunk, block_size)`` and
  runs only the cold schedule's remaining chunks, so a warm request's
  tokens are those of a cold solo decode. A fully cached aligned prompt
  reruns its last chunk, after copy-on-write forks of the shared blocks
  that chunk writes (the port's pages are written in place, so without
  the fork the write would change every holder's prefix).
* With ``draft_model``, every greedy row of a version group drafts
  ``spec_k`` tokens in ``spec_k+1`` batched paged draft steps (the token
  feed stays on the device) and one verify at ``S = spec_k+1`` scores the
  whole group; each row advances by its own acceptance length
  (``nn.speculative.batched_acceptance``, one readback a round). Sampled
  rows ride the verify masked to one real token; sampled-majority groups
  and boundaries with a prompt mid-prefill take the plain step.
* With ``host_blocks``, evicted prefix chains spill to host RAM and refill
  on a later hit, and a higher-``priority`` request under block pressure
  swaps a lower-priority decoding request out; it resumes from its
  refilled pages, or recomputes its KV from its tokens when the stage
  failed (``kv_cache.KVSwapManager``).
* A request pins the model version active at its admission; each dispatch
  serves one version group (hot swap never mixes versions).
* Per-request sampling: greedy by default; with ``temperature > 0``,
  temperature + top-p sampling whose uniform draw for position ``p`` comes
  from a ``torch.Generator`` seeded by (request seed, p), so a request's
  samples do not depend on what shares its batch.

* The control plane: the loop pulses a stall-watchdog beacon
  (``stall_deadline_s``, named by ``name``); each prefill chunk, decode
  group and speculative round is a replay unit under ``fault_policy``
  (a transient failure restores the rows' counters and dispatches the
  unit again; its page writes land at the same positions with the same
  values, so nothing is copied); ``audit_every`` boundaries run the KV
  ledger audit, and a violation quarantines the ledger (it still serves
  but adopts and registers no prefixes); a loop that dies leaves a crash
  bundle with per-request triage. The chaos sites ``serving/prefill``,
  ``serving/scheduler_step`` and ``serving/spec_round`` fire inside the
  units, tagged with ``name``; metrics and spans follow the JAX package's
  names (``serve/ttft_ms``, ``serve/decode_step``, ...).

* Mesh serving (``mesh``, ``placement``): the registry keeps each rank's
  block of every version (``"tp"``: Megatron tensor parallelism over
  ``model``, ``"fsdp"``: slices over ``data``; ``parallel.sharding``), and
  under ``"tp"`` with kv heads that divide by the ``model`` axis each
  rank's pool holds its kvH / n heads of every block (otherwise every
  head). The model runs the per-layer collectives itself, so every rank
  must run every step, with the same shapes, in the same order. JAX has
  one controller thread for the whole mesh; the port has one process a
  rank, and keeps them in LOCKSTEP: mesh rank 0 alone takes requests and
  makes every decision (admission, prefix plans, preemption, defrag,
  replay, the version pin), and before each step and each page copy
  (copy-on-write forks, defrag moves) it broadcasts a small command over
  the mesh's ranks - the op, the tokens, positions and block tables, the
  copies, the version. A published version reaches the other ranks as a
  command before any step can use it. On every other rank ``start()`` (or
  ``with sched:``) runs the worker loop, which replays each command on
  that rank's shard until rank 0 shuts down, and ``submit`` raises.
  Speculative decoding and the host tier are single-device (refused with
  a mesh).
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

from .. import observability as obs
from ..nn.speculative import batched_acceptance
from ..observability import cluster as _cluster
from ..observability import flight as _flight
from ..observability import health as _health
from ..optim.predictor import bucket_for
from ..parallel import chaos as _chaos
from ..parallel.failure import (TRANSIENT, FaultPolicy, TransientDeviceError,
                                classify_failure)
from ._lockstep import Lockstep, host as _host
from .batching import DeadlineExceeded, EngineStopped, QueueFull, ServeFuture
from .kv_cache import (SPILL_PENDING, KVCacheOOM, KVSwapManager,
                       PagedKVCache, blocks_for_tokens)
from .prefix_cache import PrefixCache
from .registry import ModelRegistry

THREAD_NAME = "bigdl_tpu_torch-serving-decode-scheduler"

_STAT_KEYS = ("submitted", "completed", "rejected", "timeouts",
              "decode_steps", "prefill_chunks", "tokens", "swaps",
              "spec_rounds", "spec_accepted", "spec_row_rounds",
              "spec_fallbacks", "defrags", "prefix_hits", "prefix_misses",
              "prefix_reused_tokens", "prefix_cow_forks", "step_replays",
              "kv_corruptions", "preemptions", "resumes",
              "resume_recomputes")

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
                 "chunks", "pf_i", "temperature", "top_p", "seed",
                 "hit_tokens", "draft_pos", "spec_rounds",
                 "spec_accepted", "priority", "swap_handle", "resume_seq")

    def __init__(self, prompt, max_new_tokens, eos_id, deadline_s, rid,
                 temperature: float = 0.0, top_p: float = 1.0,
                 seed: int = 0, priority: int = 0):
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
        self.hit_tokens = 0   # prefix-cache hit length (tokens)
        self.draft_pos = 0    # draft-cache frontier; < pos: catch up first
        self.spec_rounds = 0
        self.spec_accepted = 0
        self.priority = int(priority)   # preemption class (higher wins)
        self.swap_handle = None         # HostKVHandle while preempted
        self.resume_seq = None          # tokens to re-prefill on recompute

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
    draft_model / spec_k : batched greedy speculative decoding with a
        draft LM over the same vocabulary (its own paged pool,
        ``metric_prefix="serve/draft_kv"``), ``spec_k`` draft tokens a
        round.
    admission : ``"continuous"`` or ``"static"`` (a batch admits only
        when the previous one fully drained - the baseline).
    eos_id : default end-of-sequence id (per-request override at submit).
    sampling_seed : base of the per-request seeds of sampled requests.
    prefix_cache / prefix_cache_entries : content-addressed KV block
        sharing (on by default), optionally capped at a number of entries.
    stall_deadline_s : the loop beacon's watchdog deadline (None: the
        ``BIGDL_TPU_STALL_S`` default; active while observability is
        enabled).
    name / tags : replica name (the beacon is
        ``serving/decode_scheduler[<name>]``, chaos sites are tagged with
        it) and capability labels a ``Router`` class may demand.
    fault_policy : the replay budget of a dispatch unit (default
        ``FaultPolicy(max_restarts=1, backoff_base_s=0)``).
    audit_every : run the KV ledger audit every this many loop passes
        (0: only at shutdown).
    host_blocks : size of the host-RAM KV tier in blocks (0: none).
    preempt : allow swap-based preemption (needs ``host_blocks``).

    mesh / placement : serve over a ``parallel.mesh`` mesh, the
        parameters placed by ``placement`` (``"tp"``, ``"fsdp"``,
        ``"replicated"`` / None, a callable or a spec tree;
        ``sharding.serving_param_specs``), in lockstep (module docstring):
        every rank of the mesh builds the scheduler the same way; rank 0
        serves, the others run the worker loop.
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
        if mesh is not None and draft_model is not None:
            raise ValueError("speculative decoding is single-device only - "
                             "drop draft_model or the mesh")
        model.ensure_initialized()
        self.model = model
        self.device = model.device
        self.mesh = mesh
        self._page_axis = None   # mesh axis the pages' kv heads split over
        self._ls = None          # the lockstep channel under a mesh
        page_sharding = None
        if mesh is not None:
            from ..parallel import sharding as _sh
            from ..parallel.mesh import mesh_device
            if registry is not None and placement is not None:
                raise ValueError(
                    "placement= is applied by the registry the scheduler "
                    "builds - with an explicit registry= it would be "
                    "silently ignored; construct the registry with "
                    "mesh/param_specs yourself, or drop one argument")
            if host_blocks > 0:
                raise ValueError("the host KV tier is single-device only - "
                                 "drop host_blocks or the mesh")
            if mesh_device(mesh) != self.device:
                raise ValueError(f"mesh on {mesh_device(mesh)}, model on "
                                 f"{self.device}")
            if registry is None:
                registry = ModelRegistry(
                    mesh=mesh, param_specs=_sh.serving_param_specs(
                        model.params, mesh, placement))
            if registry.current() is None:
                registry.publish(model.params, model.state, version="v0",
                                 activate=True)
            # pages split over kv heads where this rank's attention holds
            # a tensor-parallel share of them (JAX: kvH % tp == 0)
            attn = model.blocks[0].attn
            n = attn._tp(registry.current().params["block0"]["attn"])
            if n > 1 and attn._kvh() % n == 0 and attn.num_heads % n == 0:
                page_sharding = _sh.Placement(mesh, (None, "model"))
                self._page_axis = "model"
            else:
                page_sharding = _sh.Placement(mesh, ())
            self._ls = Lockstep(mesh)
        self.max_slots = int(max_slots)
        self.max_seq_len = int(max_seq_len)
        self.prefill_chunk = int(prefill_chunk)
        self.admission = admission
        self.default_deadline_ms = default_deadline_ms
        self.eos_id = eos_id
        self.sampling_seed = int(sampling_seed)
        self.spec_k = int(spec_k)
        self.name = name
        self.tags = tuple(tags)
        self.beacon_name = ("serving/decode_scheduler" if name is None
                            else f"serving/decode_scheduler[{name}]")
        mbs = blocks_for_tokens(max_seq_len, block_size)
        if num_blocks is None:
            num_blocks = self.max_slots * mbs + 1
        self.kv = PagedKVCache(model, num_blocks=num_blocks,
                               block_size=block_size, max_blocks_per_seq=mbs,
                               sharding=page_sharding)
        self.kv_swap = (KVSwapManager(self.kv, host_blocks, tag=name)
                        if host_blocks > 0 else None)
        self.preempt_enabled = bool(preempt) and self.kv_swap is not None
        # hits align to max(chunk, block): a warm plan reruns exactly the
        # cold schedule's remaining chunks (same shapes, same inputs)
        self.hit_align = max(self.prefill_chunk, int(block_size))
        self.prefix = (PrefixCache(self.kv, max_entries=prefix_cache_entries,
                                   swap=self.kv_swap)
                       if prefix_cache else None)
        self.draft_model = draft_model
        self.draft_kv = None
        if draft_model is not None:
            if draft_model.vocab_size != model.vocab_size:
                raise ValueError("draft and target must share a vocabulary")
            if draft_model.device != self.device:
                raise ValueError(f"draft model on {draft_model.device}, "
                                 f"target on {self.device}")
            self.draft_kv = PagedKVCache(draft_model, num_blocks=num_blocks,
                                         block_size=block_size,
                                         max_blocks_per_seq=mbs,
                                         metric_prefix="serve/draft_kv")
        self.registry = registry or ModelRegistry(device=self.device)
        if self.registry.current() is None:
            self.registry.publish(model.params, model.state, version="v0",
                                  activate=True)
        if self._ls is not None and self._ls.is_root:
            # every later publish and page copy reaches the other ranks
            self.registry.add_publish_listener(self._ls.on_publish)
            self.kv._mirror = lambda op, payload: self._ls.send((op, payload))
        self.static_wait_ms = float(static_wait_ms)
        self.max_queue = int(max_queue)
        self._q: queue.Queue = queue.Queue(maxsize=self.max_queue)
        self._defrag_wanted = threading.Event()
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
        self.stall_deadline_s = stall_deadline_s
        self._beacon = _health.NULL_BEACON
        self._snap_writer = _cluster.default_writer()
        self.fault_policy = (fault_policy if fault_policy is not None
                             else FaultPolicy(max_restarts=1,
                                              backoff_base_s=0.0))
        self.audit_every = int(audit_every)
        self._audit_tick = 0
        self._quarantined = False

    # -- the step --------------------------------------------------------

    def _dev(self, a):
        return torch.from_numpy(a).to(self.device) if isinstance(
            a, np.ndarray) else a

    def _forward(self, model, params, kv, tokens, positions, tables):
        """One ``decode_paged`` call of ``model`` over ``kv``'s pool (pages
        updated in place): logits (B, S, V). Operands are numpy arrays or
        device tensors. Under a mesh, rank 0 first sends the step to the
        other ranks (they run it on their shards)."""
        if self._ls is not None and model is self.model:
            self._ls.send(("fwd", self._version_of(params),
                           *(_host(a) for a in (tokens, positions, tables))))
        return self._forward_local(model, params, kv, tokens, positions,
                                   tables)

    def _forward_local(self, model, params, kv, tokens, positions, tables):
        """The step on this rank: under a mesh, with the mesh's axes and
        the pages' head split in scope."""
        if self.mesh is None:
            logits, _ = model.decode_paged(params, self._dev(tokens),
                                           self._dev(positions), kv.pages(),
                                           self._dev(tables))
            return logits
        from ..parallel.collective import over
        from ..parallel.flash import paged_serving_context
        with over(self.mesh), paged_serving_context(self.mesh,
                                                    self._page_axis):
            logits, _ = model.decode_paged(params, self._dev(tokens),
                                           self._dev(positions), kv.pages(),
                                           self._dev(tables))
        return logits

    def _version_of(self, params) -> str:
        for v in self.registry.versions():
            if self.registry.get(v).params is params:
                return v
        raise KeyError("the step's parameters are no published version")

    # -- lockstep: the other ranks of a mesh --------------------------------

    def _work(self):
        """The worker loop of a rank other than mesh rank 0: replay rank
        0's commands on this rank's shard until it shuts down."""
        while True:
            cmd = self._ls.recv()
            op = cmd[0]
            if op == "stop":
                return
            if op == "fwd":
                _, version, tokens, positions, tables = cmd
                self._forward_local(self.model,
                                    self.registry.get(version).params,
                                    self.kv, tokens, positions, tables)
            elif op == "copy":
                self.kv._copy_pages(cmd[1])
            elif op == "publish":
                _, version, params, state = cmd
                self.registry.publish(params, state, version=version,
                                      activate=True)
            elif op == "retire":
                if self.registry.active_version != cmd[1]:
                    self.registry.retire(cmd[1])

    def _choose(self, logits, positions, rows):
        """(B, S) device token choices: argmax, and for the sampled rows
        of ``rows`` (the first rows; the rest is padding) their sampled
        tokens."""
        choices = logits.argmax(-1)
        sampled = [(i, r) for i, r in enumerate(rows) if r.temperature > 0.0]
        if sampled:
            choices = choices.clone()
            for i, r in sampled:
                choices[i] = self._sample_row(logits[i], int(positions[i]),
                                              r)
        return choices

    def _dispatch(self, params, tokens, positions, tables, rows):
        """One target step and the token choice for every (row, chunk
        position) as (B, S) int numpy - the one readback of a step."""
        logits = self._forward(self.model, params, self.kv, tokens,
                               positions, tables)
        return self._choose(logits, positions, rows).cpu().numpy()

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

    def _draft_params(self):
        return self.draft_model.params

    # -- lifecycle -------------------------------------------------------

    def start(self, warmup: bool = True):
        if self._thread is not None and self._thread.is_alive():
            return self
        if self._closed:
            raise EngineStopped("scheduler was shut down; build a new one")
        if self._ls is not None and not self._ls.is_root:
            # a worker rank: replay rank 0's steps (its warmup included)
            self._thread = threading.Thread(target=self._work,
                                            name=THREAD_NAME + "-worker",
                                            daemon=True)
            self._thread.start()
            return self
        if warmup:
            self.warmup()
        self._beacon = _health.beacon(self.beacon_name,
                                      deadline_s=self.stall_deadline_s)
        self._thread = threading.Thread(target=self._run, name=THREAD_NAME,
                                        daemon=True)
        self._thread.start()
        return self

    def warmup(self):
        """Drive every shape the scheduler dispatches once - decode
        buckets {2, 4, ..., max_slots} and prefill chunk shapes {2, ...,
        prefill_chunk}, and with a draft the draft steps and the verify
        at ``S = spec_k+1`` in every bucket - against the null table
        (writes land in the null block), so kernel builds and library
        setup happen before the first request."""
        def shapes_upto(cap):
            out, b = [], 2
            while b < cap:
                out.append(b)
                b <<= 1
            return out + [cap]

        def drive(model, params, kv, B, S):
            self._forward(model, params, kv, np.zeros((B, S), np.int32),
                          np.zeros((B,), np.int32),
                          np.zeros((B, kv.max_blocks_per_seq), np.int32))

        params = self.registry.current().params
        for b in shapes_upto(self.max_slots):
            drive(self.model, params, self.kv, b, 1)
        for s in shapes_upto(self.prefill_chunk):
            drive(self.model, params, self.kv, 1, s)
        if self.draft_model is not None:
            dparams = self._draft_params()
            for b in shapes_upto(self.max_slots):
                drive(self.draft_model, dparams, self.draft_kv, b, 1)
                drive(self.model, params, self.kv, b, self.spec_k + 1)
            for s in shapes_upto(self.prefill_chunk):
                drive(self.draft_model, dparams, self.draft_kv, 1, s)
        if self.kv_swap is not None:
            self.kv_swap.warmup()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def drain(self, timeout: Optional[float] = None) -> bool:
        with self._cond:
            return self._cond.wait_for(lambda: self._pending == 0, timeout)

    def shutdown(self, drain: bool = True, timeout: float = 60.0):
        """Graceful by default: stop admitting, finish everything queued
        or active, join. ``drain=False`` fails in-flight work with
        :class:`EngineStopped`. Every KV block (and host block) returns
        to its free list."""
        with self._cond:
            self._closed = True
        if self._ls is not None and not self._ls.is_root:
            # a worker rank runs until rank 0 shuts down
            if self._thread is not None:
                self._thread.join()
            return
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
                    self._beacon.close()
                    return
        self._beacon.close()
        self._abandon_inflight("scheduler shut down before completion")
        # the ledger must be consistent at the end of every run
        # (a violation quarantines and leaves a bundle, never raises)
        self._audit("shutdown")
        self._close_tiers()
        if self._ls is not None:
            self._ls.stop()

    def _close_tiers(self):
        """Drop the prefix cache's pins (the shared pages return too) and
        stop the host tier's stager."""
        if self.prefix is not None:
            self.prefix.clear()
        if self.kv_swap is not None:
            self.kv_swap.shutdown()

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.shutdown(drain=exc_type is None)
        return False

    # -- client surface --------------------------------------------------

    def _spec_over(self) -> int:
        """Per-slot speculative overshoot: a verify writes spec_k+1
        positions past the row's position."""
        return (self.spec_k + 1) if self.draft_model is not None else 0

    def submit(self, prompt_ids, max_new_tokens: int,
               deadline_ms: Optional[float] = None, eos_id="default",
               temperature: float = 0.0, top_p: float = 1.0,
               seed: Optional[int] = None, priority: int = 0) -> ServeFuture:
        """Enqueue one generation request: ``prompt_ids`` (1-D int) ->
        future resolving to the GENERATED ids (np.int32, prompt excluded).
        Raises :class:`QueueFull` at capacity and ``ValueError`` for a
        request that cannot fit ``max_seq_len``; a deadline that expires
        fails the future with :class:`DeadlineExceeded` carrying the tokens
        so far on ``.partial``. ``priority`` is the preemption class
        (higher wins; equal priorities never preempt each other)."""
        if self._ls is not None and not self._ls.is_root:
            raise RuntimeError("only mesh rank 0 takes requests; this rank "
                               "replays its steps (start() runs the worker "
                               "loop)")
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
                    prompt.size + max_new_tokens + self._spec_over())
        if worst > self.max_seq_len:
            raise ValueError(
                f"prompt {prompt.size} + max_new {max_new_tokens} (+ prefill "
                f"padding / speculation headroom) needs {worst} positions > "
                f"max_seq_len {self.max_seq_len}")
        ms = deadline_ms if deadline_ms is not None \
            else self.default_deadline_ms
        eid = self.eos_id if eos_id == "default" else eos_id
        rid = next(self._rids)
        if seed is None:
            seed = ((self.sampling_seed * 0x9E3779B9 + rid * 0x85EBCA6B
                     + 0xC2B2AE35) & 0xFFFFFFFF)
        req = LMRequest(prompt, max_new_tokens, eid,
                        ms / 1000.0 if ms is not None else None, rid,
                        temperature=temperature, top_p=top_p, seed=seed,
                        priority=priority)
        try:
            with self._cond:
                if self._closed:
                    raise EngineStopped("scheduler is shutting down")
                self._q.put_nowait(req)
                self._pending += 1
        except queue.Full:
            self._bump("rejected")
            if obs.enabled():
                obs.counter("serve/rejected").inc()
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
        if obs.enabled():
            obs.instant("serve/swap", version=v)
        return v

    def defrag(self) -> int:
        """Repack both pools at the next step boundary (returns -1:
        deferred); synchronous before start() or after shutdown (returns
        the blocks moved)."""
        if self._thread is None or not self._thread.is_alive():
            return self._defrag_now()
        self._defrag_wanted.set()
        return -1

    def _defrag_now(self) -> int:
        n = self.kv.defrag()
        if self.draft_kv is not None:
            n += self.draft_kv.defrag()
        if n:
            self._bump("defrags")
        return n

    def stats(self) -> dict:
        with self._stats_lock:
            out = dict(self._stats)
        out["pending"] = self._pending
        out["queue_depth"] = self._q.qsize() + len(self._backlog)
        out["active"] = len(self._active)
        out["prefilling"] = len(self._prefilling)
        out["active_version"] = self.registry.active_version
        out["quarantined"] = self._quarantined
        out["kv"] = self.kv.stats()
        out["prefix"] = (self.prefix.stats() if self.prefix is not None
                         else None)
        out["host"] = (self.kv_swap.stats() if self.kv_swap is not None
                       else None)
        return out

    def cached_prefix_tokens(self, prompt_ids) -> int:
        """How many leading tokens of this prompt admission would reuse
        from the prefix cache under the active version (the cached chain
        aligned down to ``hit_align``; 0 without a cache or with the ledger
        quarantined, whose admission adopts nothing)."""
        if self.prefix is None or self._quarantined:
            return 0
        mv = self.registry.current()
        if mv is None:
            return 0
        t = self.prefix.peek(prompt_ids, mv.version)
        return t - t % self.hit_align

    # -- transient step replay -------------------------------------------

    def _snapshot_step_state(self, rows):
        """What one dispatch unit changes on the host, taken before it: the
        rows' decode counters. The pages need no copy: a unit writes only
        at positions at or past each row's ``pos`` (``draft_pos`` in the
        draft pool), into blocks admission made private, and attention
        never reads a position past the query's, so a replay from these
        counters writes the same values at the same places."""
        return [(r, r.pos, r.steps, len(r.generated), r.pf_i, r.draft_pos)
                for r in rows]

    def _restore_step_state(self, snap):
        for r, pos, steps, ngen, pf_i, draft_pos in snap:
            r.pos, r.steps, r.pf_i = pos, steps, pf_i
            r.draft_pos = draft_pos
            del r.generated[ngen:]

    def _replay_group(self, stage, rows, fn):
        """Run the dispatch unit ``fn`` (its readback included, where a
        CUDA fault surfaces) under the fault policy: a failure in the
        policy's retry classes restores the snapshot, backs off and runs
        ``fn`` again; anything else, or an exhausted budget, propagates to
        :meth:`_die`."""
        pol = self.fault_policy
        snap = self._snapshot_step_state(rows)
        while True:
            try:
                out = fn()
            except BaseException as e:  # noqa: BLE001 - classify, maybe replay
                cls = classify_failure(e)
                self._restore_step_state(snap)
                if pol is None or self._stop.is_set() \
                        or not pol.should_retry(cls):
                    raise
                pol.record_failure()
                self._bump("step_replays")
                if obs.enabled():
                    obs.counter("serve/step_replays").inc()
                _health.emit("serve_step_replay", stage=stage,
                             failure_class=cls, attempt=pol.consecutive,
                             rids=[r.rid for r in rows],
                             error=f"{type(e).__name__}: {e}")
                delay = pol.backoff_s()
                if delay > 0:
                    pol.sleep(delay)
                continue
            if pol is not None:
                pol.record_success()
            return out

    # -- KV ledger audit ---------------------------------------------------

    def audit(self) -> dict:
        """The KV ledger audit of the target pool (with the prefix cache's
        exact pins) and the draft pool (call at a quiesced point)."""
        pins = (self.prefix.pinned_blocks() if self.prefix is not None
                else {})
        rep = self.kv.audit(prefix_pins=pins)
        if self.draft_kv is not None:
            drep = self.draft_kv.audit(prefix_pins={})
            rep = {"ok": rep["ok"] and drep["ok"],
                   "violations": rep["violations"]
                   + [f"draft: {v}" for v in drep["violations"]],
                   "blocks": rep["blocks"] + drep["blocks"],
                   "owners": rep["owners"] + drep["owners"]}
        return rep

    def _audit(self, where: str) -> dict:
        """Cadence and shutdown audit: a violation QUARANTINES the ledger
        (it serves on, but adopts and registers no prefixes, which would
        spread the corruption). The first detection counts one
        ``kv_corruptions``, emits one ``health/kv_corruption`` event and
        dumps one crash bundle; later audits change nothing."""
        rep = self.audit()
        if rep["ok"]:
            return rep
        first = not self._quarantined
        self._quarantined = True
        if first:
            self._bump("kv_corruptions")
            if obs.enabled():
                obs.counter("serve/kv_corruptions").inc()
            _health.emit("kv_corruption", component=self.beacon_name,
                         where=where, n_violations=len(rep["violations"]),
                         violations=rep["violations"][:8])
            if obs.enabled():
                _flight.dump_crash_bundle(error=None, context={
                    "component": "serving/decode_scheduler",
                    "event": "kv_corruption", "where": where,
                    "violations": rep["violations"][:32],
                    "requests": self._triage()})
        return rep

    # -- scheduler loop --------------------------------------------------

    def _run(self):
        try:
            self._loop()
        except BaseException as e:  # noqa: BLE001 - post-mortem, then die
            logging.getLogger(__name__).exception("decode scheduler died")
            self._die(e)
            raise

    def _triage(self):
        """Per-request state for the crash bundle: who was in flight, how
        far along, and what it held."""
        out = []

        def add(r, stage):
            out.append({"rid": r.rid, "stage": stage,
                        "prompt_len": int(r.prompt.size),
                        "tokens": len(r.generated),
                        "kv_blocks": self.kv.owned(r.rid),
                        "version": r.version})

        for r in self._active:
            add(r, "decode")
        for r in self._prefilling:
            add(r, "prefill")
        for r in self._backlog:
            add(r, "backlog")
        return out

    def _die(self, error):
        """Loop death (a permanent fault or a spent replay budget): the
        crash bundle with per-request triage, then every in-flight request
        fails typed with its generated tokens on ``exc.partial`` (a Router
        failover resumes from them), and every block goes back."""
        if obs.enabled():
            _flight.dump_crash_bundle(error=error, context={
                "component": "serving/decode_scheduler",
                "failure_class": classify_failure(error),
                "requests": self._triage(),
                "stats": {k: v for k, v in self.stats().items()
                          if k not in ("kv", "prefix")}})
        with self._cond:
            self._closed = True
        self._abandon_inflight(
            f"decode scheduler died: {type(error).__name__}: {error}")
        self._close_tiers()
        self._beacon.close()

    def _loop(self):
        while not self._stop.is_set():
            self._beacon.pulse()
            if self._ls is not None:
                self._ls.keepalive()
            if obs.enabled():
                self._snap_writer.maybe_write()
            self._pull_pending()
            self._admit()
            stepped = self._advance_prefill()
            stepped |= self._step_all()
            self._evict_expired()
            if self._defrag_wanted.is_set():
                self._defrag_wanted.clear()
                try:
                    self._defrag_now()
                except Exception as e:  # noqa: BLE001 - transient: skip
                    # a transient page-copy fault aborts the repack with
                    # the ledger untouched: skip this round
                    if classify_failure(e) != TRANSIENT:
                        raise
                    _health.emit("serve_defrag_skipped",
                                 error=f"{type(e).__name__}: {e}")
            if self.audit_every > 0:
                self._audit_tick += 1
                if self._audit_tick >= self.audit_every:
                    self._audit_tick = 0
                    self._audit("cadence")
            if self._closed and not self._active and not self._prefilling \
                    and not self._backlog and self._q.empty():
                break
            if not stepped:
                try:
                    self._backlog.append(self._q.get(
                        timeout=0.002 if self._backlog else 0.02))
                except queue.Empty:
                    pass

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
        worst-case private block need is reservable (FIFO: a smaller later
        request never overtakes). One transaction per request: adopt the
        cached prefix, evict unreferenced prefix entries under pressure,
        reserve, fork copy-on-write pages eagerly; on ``KVCacheOOM`` undo
        all of it and defer (or preempt a lower-priority request). Static
        mode waits for the running batch to drain and for a fill
        window."""
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
            if req.swap_handle is not None or req.resume_seq is not None:
                # a preempted request resumes through its refill, at the
                # head of the line
                if not self._resume_preempted(req):
                    break
                continue
            worst = max(prefill_padded_end(req.prompt.size,
                                           self.prefill_chunk),
                        req.prompt.size + req.max_new_tokens
                        + self._spec_over())
            mv = self.registry.current()
            cold = prefill_schedule(req.prompt.size, self.prefill_chunk)
            plan, adopted, fork_idxs = self._prefix_plan(req, mv.version,
                                                         cold)
            forked = []
            try:
                need = (blocks_for_tokens(worst, self.kv.block_size)
                        - len(adopted) + len(fork_idxs))
                if adopted:
                    self.kv.adopt(req.rid, adopted)
                try:
                    # the blocks just adopted are pinned (refcount >= 2):
                    # eviction cannot take them back
                    if not self._make_room(
                            need, blocks_for_tokens(worst,
                                                    self.kv.block_size)):
                        raise KVCacheOOM(f"need {need} private blocks, "
                                         f"{self.kv.blocks_free()} free")
                    self._reserve(req.rid, worst)
                    if fork_idxs:
                        # inside the transaction that checked the free
                        # list: a later admission cannot take the blocks
                        forked = self.kv.fork_blocks(req.rid, fork_idxs)
                except (KVCacheOOM, TransientDeviceError):
                    self.kv.free(req.rid)
                    if self.draft_kv is not None:
                        self.draft_kv.free(req.rid)
                    raise
            except (KVCacheOOM, TransientDeviceError) as e:
                # backpressure, or a transient fault inside the transaction
                # (an injected fork / evict failure): it unwound, defer
                if isinstance(e, KVCacheOOM) and self._try_preempt(req):
                    continue
                break   # retry at the next boundary
            self._backlog.popleft()
            req.slot = self._free_slots.pop()
            req.version = mv.version
            req.model_version = mv
            req.t_admit_ns = time.perf_counter_ns()
            req.chunks = plan
            req.pf_i = 0
            if self.prefix is not None:
                self._bump("prefix_hits" if req.hit_tokens
                           else "prefix_misses")
                # tokens the warm plan does not prefill (a rerun last
                # chunk's tokens are computed again and do not count)
                reused = int(req.prompt.size) - sum(c[1] for c in plan)
                if reused:
                    self._bump("prefix_reused_tokens", reused)
                if forked:
                    self._bump("prefix_cow_forks", len(forked))
                if obs.enabled():
                    obs.counter("serve/prefix_hits" if req.hit_tokens
                                else "serve/prefix_misses").inc()
                    if reused:
                        obs.counter("serve/prefix_reused_tokens").inc(reused)
                    if forked:
                        obs.counter("serve/prefix_cow_forks").inc(
                            len(forked))
            if not req.future.set_running_or_notify_cancel():
                self._finish(req, cancel=True)
                continue
            self._prefilling.append(req)

    def _make_room(self, need: int, draft_need: int,
                   evict: bool = True) -> bool:
        """Evict unreferenced prefix entries (when ``evict``) while the
        target pool is short of ``need`` blocks; True when it can cover
        them and the draft pool (if any) ``draft_need``."""
        if evict and self.prefix is not None \
                and not self.kv.can_allocate(need):
            self.prefix.evict(need - self.kv.blocks_free())
        return self.kv.can_allocate(need) and (
            self.draft_kv is None or self.draft_kv.can_allocate(draft_need))

    def _reserve(self, rid, upto: int):
        """Grow ``rid``'s tables in both pools to ``upto`` tokens (the
        worst case :meth:`_make_room` checked)."""
        self.kv.ensure_capacity(rid, upto)
        if self.draft_kv is not None:
            self.draft_kv.ensure_capacity(rid, upto)

    def _prefix_plan(self, req, version, cold):
        """``(chunks_to_run, adopted_blocks, cow_fork_idxs)``. A miss runs
        the cold schedule. A hit adopts the longest cached
        ``hit_align``-aligned prefix and keeps the cold chunks at and
        after it; a fully cached aligned prompt keeps its last chunk, and
        the adopted blocks that chunk writes are returned for the
        admission transaction to fork."""
        req.hit_tokens = 0
        if self.prefix is None or self._quarantined:
            # a quarantined ledger serves, but adopting shared pages out
            # of it would spread whatever the audit caught
            return cold, [], []
        bs = self.kv.block_size
        chain = self.prefix.lookup(req.prompt, version)
        h = min(len(chain) * bs, int(req.prompt.size))
        h -= h % self.hit_align
        if h <= 0:
            return cold, [], []
        adopted = chain[:h // bs]
        plan = [c for c in cold if c[0] >= h] or [cold[-1]]
        fork_idxs = []
        s0, _, padded0 = plan[0]
        if s0 < h:
            fork_idxs = list(range(
                s0 // bs, min(len(adopted), -(-(s0 + padded0) // bs))))
        req.hit_tokens = h
        return plan, adopted, fork_idxs

    def _register_prefix(self, req):
        """Prefill done: register every FULL prompt block for later hits
        (the partial tail block, still receiving this request's decode
        writes, is never shared)."""
        if self.prefix is None or self._quarantined:
            return
        nfull = int(req.prompt.size) // self.kv.block_size
        if not nfull:
            return
        try:
            self.prefix.insert(req.prompt, req.version,
                               self.kv.owner_blocks(req.rid)[:nfull])
        except Exception as e:  # noqa: BLE001 - transient: skip the entry
            # a transient fault registering the prefix costs later hits,
            # never correctness
            if classify_failure(e) != TRANSIENT:
                raise
            _health.emit("prefix_insert_skipped", rid=req.rid,
                         error=f"{type(e).__name__}: {e}")

    # -- swap-based preemption -------------------------------------------

    def _try_preempt(self, for_req) -> bool:
        """Admission hit block pressure: swap the cheapest lower-priority
        DECODING request out to the host tier (its pages gathered at this
        boundary, its blocks freed) and put it back in the backlog right
        behind ``for_req``. Returns True when a victim was preempted."""
        if not self.preempt_enabled:
            return False
        cands = [r for r in self._active if r.priority < for_req.priority]
        if not cands:
            return False
        victim = min(cands, key=lambda r: (r.priority,
                                           self.kv.owned(r.rid)))
        blocks = self.kv.owner_blocks(victim.rid)
        if not blocks:
            return False
        h = self.kv_swap.spill(blocks, tag="preempt")
        if h is None and self.prefix is not None \
                and self.prefix.drop_spilled(len(blocks)):
            # a running request's state outranks cold spilled chains
            h = self.kv_swap.spill(blocks, tag="preempt")
        if h is None:
            return False
        victim.swap_handle = h
        self.kv.free(victim.rid)
        if self.draft_kv is not None:
            self.draft_kv.free(victim.rid)
        victim.draft_pos = 0
        self._active.remove(victim)
        self._free_slots.append(victim.slot)
        victim.slot = None
        self._backlog.insert(1, victim)
        self._bump("preemptions")
        if obs.enabled():
            obs.counter("serve/preemptions").inc()
        _flight.record("serve/preempt", rid=victim.rid, for_rid=for_req.rid,
                       blocks=len(blocks))
        return True

    def _resume_preempted(self, req) -> bool:
        """Refill-before-resume for the backlog head: land the preempted
        request's pages back and return it to the running batch at the
        position it left. A stage in flight or a full pool defers (False);
        a failed or corrupt stage recomputes the KV from the request's
        tokens through the ordinary chunk schedule. Returns True when the
        request left the backlog."""
        keep = int(req.prompt.size) + req.max_new_tokens + self._spec_over()
        h = req.swap_handle
        if h is not None:
            if h.state == SPILL_PENDING:
                return False
            if not self._make_room(h.n_blocks, blocks_for_tokens(
                    keep, self.kv.block_size),
                    evict=not self._quarantined):
                return False
            try:
                ids = self.kv_swap.refill(req.rid, h)
            except KVCacheOOM:
                return False
            if ids is not None:
                req.swap_handle = None
                # the refilled blocks are the victim's whole reservation:
                # the target's reserve is a no-op, the draft's is fresh
                self._reserve(req.rid, keep)
                self._backlog.popleft()
                req.slot = self._free_slots.pop()
                self._active.append(req)
                self._bump("resumes")
                if obs.enabled():
                    obs.counter("serve/resumes").inc()
                return True
            # the stage failed (settled by the manager): recompute
            req.swap_handle = None
            req.resume_seq = np.concatenate(
                [req.prompt, np.asarray(req.generated, np.int32)])[:req.pos]
        seq = req.resume_seq
        worst = max(prefill_padded_end(seq.size, self.prefill_chunk), keep)
        need = blocks_for_tokens(worst, self.kv.block_size)
        if not self._make_room(need, need, evict=not self._quarantined):
            return False
        self._reserve(req.rid, worst)
        req.chunks = prefill_schedule(seq.size, self.prefill_chunk)
        req.pf_i = 0
        self._backlog.popleft()
        req.slot = self._free_slots.pop()
        self._prefilling.append(req)
        self._bump("resume_recomputes")
        if obs.enabled():
            obs.counter("serve/resume_recomputes").inc()
        _health.emit("kv_swap_recompute", rid=req.rid, tokens=int(seq.size))
        return True

    # -- prefill and decode ------------------------------------------------

    def _advance_prefill(self) -> bool:
        """ONE prefill chunk of the head prefilling request. The last
        chunk's final real position gives the first generated token (not
        for a recompute, whose next token comes from the decode step)."""
        if not self._prefilling:
            return False
        req = self._prefilling[0]
        t0 = time.perf_counter_ns()
        s, real, padded = req.chunks[req.pf_i]
        last = req.pf_i == len(req.chunks) - 1
        resumed = req.resume_seq is not None
        src = req.resume_seq if resumed else req.prompt
        # every block this chunk writes is private: warm chunks start past
        # the adopted prefix, and a rerun chunk's blocks were forked
        toks = np.zeros((1, padded), np.int32)
        toks[0, :real] = src[s:s + real]
        pos = np.asarray([s], np.int32)
        drafted = self.draft_kv is not None and req.hit_tokens == 0

        def dispatch():
            _chaos.maybe_fire("serving/prefill", tag=self.name)
            with obs.span("serve/prefill", rid=req.rid, chunk=req.pf_i,
                          of=len(req.chunks), version=req.version):
                logits = self._forward(self.model, req.model_version.params,
                                       self.kv, toks, pos,
                                       self.kv.block_table(req.rid)[None])
                if drafted:
                    # a warm hit's draft catches up lazily on its first
                    # round
                    self._forward(self.draft_model, self._draft_params(),
                                  self.draft_kv, toks, pos,
                                  self.draft_kv.block_table(req.rid)[None])
                if last and not resumed:
                    return int(self._choose(logits[:, real - 1:real],
                                            [s + real - 1], [req])[0, 0])
                return None

        first_tok = self._replay_group("prefill", [req], dispatch)
        if drafted:
            req.draft_pos = s + real
        self._bump("prefill_chunks")
        req.pf_i += 1
        req.prefill_ms += (time.perf_counter_ns() - t0) / 1e6
        if not last:
            return True
        self._prefilling.popleft()
        self._register_prefix(req)
        # the reservation covered the padded prefill tail; give back the
        # blocks past what generation (and speculation) needs
        keep = int(req.prompt.size) + req.max_new_tokens + self._spec_over()
        self.kv.truncate(req.rid, keep)
        if self.draft_kv is not None:
            self.draft_kv.truncate(req.rid, keep)
        if resumed:
            req.pos = int(req.resume_seq.size)
            req.resume_seq = None
            self._active.append(req)
            return True
        req.pos = int(req.prompt.size)
        req.t_first_ns = time.perf_counter_ns()
        self._bump("tokens")
        if obs.enabled():
            obs.histogram("serve/prefill_ms", unit="ms").observe(
                req.prefill_ms)
            obs.histogram("serve/ttft_ms", unit="ms").observe(
                (req.t_first_ns - req.t_enqueue_ns) / 1e6)
            obs.counter("serve/lm_tokens").inc()
        self._active.append(req)
        self._emit(req, first_tok)
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
        """One dispatch per active version group: a speculative round for
        a greedy-majority group when a draft is armed and no prompt is
        mid-prefill, else the plain decode step."""
        if not self._active:
            return False
        groups = {}
        for r in self._active:
            groups.setdefault(r.version, []).append(r)
        for version, rows in groups.items():
            n_elig = sum(1 for r in rows if r.temperature <= 0.0)
            if self.draft_model is not None and n_elig >= 1 \
                    and 2 * n_elig >= len(rows) and not self._prefilling:
                self._spec_step(version, rows)
            else:
                if self.draft_model is not None:
                    self._bump("spec_fallbacks")
                    if obs.enabled():
                        obs.counter("serve/spec_fallbacks").inc()
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
        params = rows[0].model_version.params
        version = rows[0].version
        rids = [r.rid for r in rows]

        def dispatch():
            _chaos.maybe_fire("serving/scheduler_step", tag=self.name)
            with obs.span("serve/decode_step", rids=rids, bucket=bucket,
                          version=version):
                return self._dispatch(params, tokens, positions, tables,
                                      rows)[:, 0]

        toks = self._replay_group("decode", rows, dispatch)
        self._bump("decode_steps")
        self._bump("tokens", n)
        for i, r in enumerate(rows):
            r.pos += 1
            r.steps += 1
            self._emit(r, toks[i])
        if obs.enabled():
            obs.counter("serve/decode_steps").inc()
            obs.counter("serve/lm_tokens").inc(n)
            obs.histogram("serve/decode_occupancy").observe(n / bucket)
            obs.gauge("serve/active_slots").set(len(self._active))

    def _draft_catchup(self, req, dparams):
        """Bring one row's draft cache level with its target cache:
        re-prefill positions ``draft_pos..pos-1`` from the row's prompt
        and generated tokens in chunk shapes, the tail's padding halved
        until it fits the row's owned draft capacity."""
        seq = np.concatenate([req.prompt,
                              np.asarray(req.generated, np.int32)])
        dtable = self.draft_kv.block_table(req.rid)[None]
        cap = min(self.max_seq_len,
                  self.draft_kv.owned(req.rid) * self.draft_kv.block_size)
        while req.draft_pos < req.pos:
            real = min(self.prefill_chunk, req.pos - req.draft_pos)
            padded = _pow2_bucket(real, self.prefill_chunk)
            while req.draft_pos + padded > cap:
                padded >>= 1
            real = min(real, padded)
            toks = np.zeros((1, padded), np.int32)
            toks[0, :real] = seq[req.draft_pos:req.draft_pos + real]
            self._forward(self.draft_model, dparams, self.draft_kv, toks,
                          np.asarray([req.draft_pos], np.int32), dtable)
            req.draft_pos += real

    def _spec_step(self, version, rows):
        """ONE batched speculative round for a version group: greedy rows
        that trail the draft cache catch up; ``spec_k+1`` batched draft
        steps propose (the token feed stays on the device; the extra step
        writes d_k's K/V; ineligible rows ride against the null table);
        one verify at ``S = spec_k+1`` scores every row's ``[last, d_1..
        d_k]``; ``batched_acceptance`` gives each row's acceptance length
        and tokens in one readback (ineligible rows: 0, their plain
        step). Rollback is positional: rejected positions hold values the
        position-masked attention never reads, in both pools, and
        ``draft_pos`` snaps to ``pos``."""
        k = self.spec_k
        n = len(rows)
        bucket = bucket_for(max(n, 2), self.max_slots)
        elig = np.zeros((bucket,), bool)
        last = np.zeros((bucket, 1), np.int32)
        positions = np.zeros((bucket,), np.int32)
        dpositions = np.zeros((bucket,), np.int32)
        tables = np.zeros((bucket, self.kv.max_blocks_per_seq), np.int32)
        dtables = np.zeros((bucket, self.draft_kv.max_blocks_per_seq),
                           np.int32)
        for i, r in enumerate(rows):
            elig[i] = r.temperature <= 0.0
            last[i, 0] = r.generated[-1]
            positions[i] = r.pos
            tables[i] = self.kv.block_table(r.rid)
        dparams = self._draft_params()
        params = rows[0].model_version.params
        rids = [r.rid for r in rows]

        def round_fn():
            _chaos.maybe_fire("serving/spec_round", tag=self.name)
            with obs.span("serve/spec_round", rids=rids, k=k, bucket=bucket,
                          version=version):
                # inside the replay unit: the snapshot restores draft_pos,
                # and a replayed catch-up rewrites the same positions
                for i, r in enumerate(rows):
                    if elig[i]:
                        if r.draft_pos < r.pos:
                            self._draft_catchup(r, dparams)
                        dtables[i] = self.draft_kv.block_table(r.rid)
                        dpositions[i] = r.pos
                last_dev = self._dev(last)
                dpos_dev = self._dev(dpositions)
                dtab_dev = self._dev(dtables)
                tok, drafts = last_dev, []
                for i in range(k + 1):
                    lg = self._forward(self.draft_model, dparams,
                                       self.draft_kv, tok, dpos_dev + i,
                                       dtab_dev)
                    tok = lg.argmax(-1)
                    if i < k:
                        drafts.append(tok)
                drafts_c = torch.cat(drafts, dim=1)              # (B, k)
                chunk = torch.cat([last_dev.to(drafts_c.dtype), drafts_c],
                                  dim=1)
                vlogits = self._forward(self.model, params, self.kv, chunk,
                                        positions, tables)
                vchoices = self._choose(vlogits, positions, rows)
                j, emit = batched_acceptance(drafts_c, vchoices,
                                             self._dev(elig))
                return torch.cat([j[:, None], emit], dim=1).cpu().numpy()

        got = self._replay_group("spec", rows, round_fn)
        j, emit = got[:, 0], got[:, 1:]
        self._bump("decode_steps")
        self._bump("spec_rounds")
        nrow = nacc = ntok = 0
        for i, r in enumerate(rows):
            ji = int(j[i])
            r.pos += ji + 1
            r.steps += 1
            if elig[i]:
                r.draft_pos = r.pos
                r.spec_rounds += 1
                r.spec_accepted += ji
                nrow += 1
                nacc += ji
                if obs.enabled():
                    obs.histogram("serve/spec_accepted_len").observe(ji)
            for t in emit[i, :ji + 1]:
                ntok += 1
                if self._emit(r, int(t)):
                    break
        self._bump("spec_row_rounds", nrow)
        self._bump("spec_accepted", nacc)
        self._bump("tokens", ntok)
        if obs.enabled():
            obs.counter("serve/spec_rounds").inc()
            obs.counter("serve/spec_accepted").inc(nacc)
            obs.counter("serve/lm_tokens").inc(ntok)

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
        if obs.enabled():
            obs.counter("serve/timeouts").inc()
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
            "prefix_hit_tokens": req.hit_tokens,
            "spec_rounds": req.spec_rounds,
            "spec_accepted": req.spec_accepted,
        }
        self._bump("completed")
        if obs.enabled():
            obs.counter("serve/lm_completed").inc()
            if tpot:
                obs.histogram("serve/tpot_ms", unit="ms").observe(tpot)
            _flight.record("serve/lm_done", rid=req.rid, tokens=n,
                           steps=req.steps, version=version)
        if not req.future.done():
            req.future.set_result(out)

    def _release(self, req):
        """Return the request's slot, its KV blocks (both pools) and any
        host reservation a preemption left (safe to call twice)."""
        if req in self._active:
            self._active.remove(req)
        if req in self._prefilling:
            self._prefilling.remove(req)
        if req.slot is not None:
            self._free_slots.append(req.slot)
            req.slot = None
        self.kv.free(req.rid)
        if self.draft_kv is not None:
            self.draft_kv.free(req.rid)
        if req.swap_handle is not None:
            self.kv_swap.discard(req.swap_handle)
            req.swap_handle = None
        req.resume_seq = None
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
