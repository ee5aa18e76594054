"""Paged KV cache: fixed-size device blocks + per-request block tables, and
the host-RAM tier under them (counterpart of
``bigdl_tpu/serving/kv_cache.py``).

All cache memory is pooled into ``num_blocks`` blocks of ``block_size``
positions, per layer ``k_pages, v_pages : (num_blocks, kvH, block_size,
D)``, and each request gets a BLOCK TABLE: logical block ``i`` of its
sequence lives at physical page ``table[i]``. Block 0 is the reserved NULL
block: unallocated table entries and the padded rows of a decode bucket
point there, so their writes land in space no real row reads.

Unlike the JAX package's functional pages, the pages here are updated IN
PLACE by ``Transformer.decode_paged`` (scatter through the tables); the
cache hands out the same tensors for the life of the pool. Every argument
the JAX package rests on immutable page arrays is made here by a copy on
the compute stream instead:

* copy-on-write (:meth:`PagedKVCache.fork_blocks`) and :meth:`defrag` copy
  the moved pages (``pages[dst] = pages[src]``, right side gathered
  first) before the next dispatch writes;
* a spill (:meth:`PagedKVCache.snapshot_blocks`) gathers the spilled pages
  into a fresh device buffer at the boundary where it is decided, so the
  caller may free the blocks at once: the next prefill's writes land after
  the gather in stream order, and the stager copies the buffer to pinned
  host memory on a device-to-host stream after an event;
* a refill stages the host bytes through a ring of pinned buffers, copies
  them on a host-to-device stream of its own (so it never queues behind a
  spill's copy), and the compute stream waits on that copy's event before
  the scatter into the pages.

The ledger (free list, per-owner block lists, per-block reference counts)
is host state under a lock, and the scheduler's admission authority: a
request is admitted only when its worst-case need fits the free list, so
no step can run out of blocks mid-flight. A block referenced more than
once (adopted by several tables through the prefix cache, or pinned by the
cache itself) is read-only: :meth:`PagedKVCache.fork_blocks` gives an owner
a private copy before its first divergent write.
"""
from __future__ import annotations

import hashlib
import itertools
import queue
import threading
import time
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import observability as obs
from ..observability import health as _health
from ..parallel import chaos as _chaos
from ..parallel.failure import TransientDeviceError


class KVCacheOOM(RuntimeError):
    """The free list cannot cover a requested allocation (typed, so
    admission can defer instead of failing)."""


class HostPoolOOM(RuntimeError):
    """The host block pool cannot cover a spill reservation (typed, so a
    spill degrades to a drop instead of failing admission)."""


def _host_pages(t):
    """A device page copy on the host: numpy, or a CPU bfloat16 tensor
    (numpy has no bfloat16)."""
    t = t.cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _as_pages(a):
    """Transferred pages (numpy, or a bfloat16 tensor) as a tensor."""
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(
        np.asarray(a))


def blocks_for_tokens(tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``tokens`` positions (ceil division)."""
    return -(-int(tokens) // int(block_size))


class PagedKVCache:
    """Pooled page storage on the model's device + the block ledger.

    A block with reference count 1 belongs to one referent and may be
    written; a block referenced more than once is shared and read-only
    (``fork_blocks`` before writing). ``metric_prefix`` names the pool's
    metrics (the scheduler's draft pool is ``"serve/draft_kv"``): the
    counters ``<prefix>_allocs`` / ``_frees`` / ``_cow_forks`` /
    ``_defrag_moves`` and the gauges ``<prefix>_blocks_*`` /
    ``_shared_blocks`` / ``_high_water`` / ``_frag_blocks``, as in the JAX
    package, written while observability is enabled. The chaos sites
    ``kv/cow_fork`` and ``kv/page_copy`` fire before the ledger changes.
    ``sharding`` (a ``parallel.sharding.Placement`` of the pages, say
    ``Placement(mesh, (None, 'model'))``) puts the pool on the mesh's
    device, with this rank's kvH / n heads when dim 1 is split. A lockstep
    serving loop sets ``_mirror`` (``fn(op, payload)``) on the rank that
    decides, so every page copy reaches the other ranks' pools too."""

    _mirror = None

    def __init__(self, model, *, num_blocks: int, block_size: int = 16,
                 max_blocks_per_seq: int, dtype=torch.float32,
                 metric_prefix: str = "serve/kv", sharding=None):
        if num_blocks < 2:
            raise ValueError(f"num_blocks must be >= 2 (block 0 is the "
                             f"reserved null block), got {num_blocks}")
        if block_size < 2 or (block_size & (block_size - 1)):
            raise ValueError(f"block_size must be a power of two >= 2, "
                             f"got {block_size}")
        if max_blocks_per_seq < 1:
            raise ValueError("max_blocks_per_seq must be >= 1")
        attn = model.blocks[0].attn
        self.metric_prefix = metric_prefix
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.max_blocks_per_seq = int(max_blocks_per_seq)
        self.max_seq_len = self.max_blocks_per_seq * self.block_size
        self.kv_heads = int(attn._kvh())
        self.head_dim = int(model.hidden_size // attn.num_heads)
        self.n_layers = len(model.blocks)
        self.page_dtype = dtype
        self.device = model.device
        # mesh-sharded serving: ``sharding`` is a ``parallel.sharding.
        # Placement`` of the page tensors; with dim 1 (kv heads) split over
        # an axis, this rank's pool holds its kvH / n heads of every block
        self.sharding = sharding
        kvh = self.kv_heads
        if sharding is not None:
            from ..parallel.mesh import axis_size, mesh_device
            self.device = mesh_device(sharding.mesh)
            spec = tuple(sharding.spec)
            if len(spec) > 1 and spec[1] is not None:
                n = axis_size(sharding.mesh, spec[1])
                if self.kv_heads % n:
                    raise ValueError(f"{self.kv_heads} kv heads do not "
                                     f"split over {n} {spec[1]!r} ranks")
                kvh = self.kv_heads // n
        shape = (num_blocks, kvh, block_size, self.head_dim)
        self._pages = [(torch.zeros(shape, dtype=dtype, device=self.device),
                        torch.zeros(shape, dtype=dtype, device=self.device))
                       for _ in model.blocks]
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._owned: Dict[object, List[int]] = {}
        self._refs: Dict[int, int] = {}
        self._high_water = 0
        self._lock = threading.Lock()
        self._remap_listeners: List[Callable[[dict], None]] = []
        self._set_gauges()

    # -- device pages ----------------------------------------------------

    def pages(self):
        """Per-layer [(k_pages, v_pages), ...], updated in place."""
        return self._pages

    def set_pages(self, new_pages):
        """Replace the page tensors (JAX's functional hand-back; the port's
        steps write in place and never need it)."""
        self._pages = list(new_pages)

    def _idx(self, ids):
        return torch.as_tensor(ids, dtype=torch.long, device=self.device)

    def _copy_pages(self, moves):
        """``pages[dst] = pages[src]`` for every (src, dst) in one gather
        and one scatter per layer half, on the current stream (the
        gather completes before the scatter: disjoint or not, no page is
        read after it is written)."""
        if self._mirror is not None:
            self._mirror("copy", [(int(a), int(b)) for a, b in moves])
        src = self._idx([s for s, _ in moves])
        dst = self._idx([d for _, d in moves])
        for k, v in self._pages:
            k[dst] = k[src]
            v[dst] = v[src]

    # -- ledger ----------------------------------------------------------

    def blocks_free(self) -> int:
        with self._lock:
            return len(self._free)

    def blocks_in_use(self) -> int:
        """Unique physical blocks with at least one referent (a block
        shared by ten tables and the prefix cache counts once)."""
        with self._lock:
            return self.num_blocks - 1 - len(self._free)

    def shared_blocks(self) -> int:
        """Blocks with reference count >= 2."""
        with self._lock:
            return sum(1 for r in self._refs.values() if r >= 2)

    def owned(self, owner) -> int:
        with self._lock:
            return len(self._owned.get(owner, ()))

    def block_refs(self, block: int) -> int:
        with self._lock:
            return self._refs.get(int(block), 0)

    def can_allocate(self, n_blocks: int) -> bool:
        with self._lock:
            return n_blocks <= len(self._free)

    def ensure_capacity(self, owner, upto_tokens: int):
        """Grow ``owner``'s allocation so positions ``0..upto_tokens-1``
        fit. Raises :class:`KVCacheOOM` (allocating NOTHING) when the free
        list cannot cover the growth, ``ValueError`` past the table
        width. Adopted blocks count toward the capacity."""
        need = blocks_for_tokens(upto_tokens, self.block_size)
        if need > self.max_blocks_per_seq:
            raise ValueError(
                f"{upto_tokens} tokens need {need} blocks > "
                f"max_blocks_per_seq {self.max_blocks_per_seq} "
                f"(max_seq_len {self.max_seq_len})")
        with self._lock:
            have = self._owned.setdefault(owner, [])
            grow = need - len(have)
            if grow <= 0:
                return
            if grow > len(self._free):
                if not have:
                    self._owned.pop(owner, None)
                in_use = self.num_blocks - 1 - len(self._free)
                raise KVCacheOOM(
                    f"need {grow} blocks, {len(self._free)} free "
                    f"(in use {in_use}/{self.num_blocks - 1})")
            for _ in range(grow):
                b = self._free.pop()
                self._refs[b] = 1
                have.append(b)
            self._high_water = max(self._high_water,
                                   self.num_blocks - 1 - len(self._free))
        if obs.enabled():
            obs.counter(f"{self.metric_prefix}_allocs").inc(grow)
        self._set_gauges()

    def adopt(self, owner, blocks: Sequence[int]):
        """Prefix-cache hit: append already-resident shared blocks to
        ``owner``'s table (refcount +1 each, no page copy). Refused once
        the owner holds blocks (the shared prefix lands first)."""
        blocks = [int(b) for b in blocks]
        with self._lock:
            have = self._owned.setdefault(owner, [])
            if have:
                raise ValueError(
                    f"adopt() must precede private allocation - owner "
                    f"{owner!r} already holds {len(have)} blocks")
            for b in blocks:
                if self._refs.get(b, 0) < 1:
                    if not have:
                        self._owned.pop(owner, None)
                    raise ValueError(f"block {b} is not live - a prefix "
                                     "entry outlived its page")
            for b in blocks:
                self._refs[b] += 1
            have.extend(blocks)
        self._set_gauges()

    def retain(self, blocks: Sequence[int]):
        """Ownerless references: refcount +1 each, all or nothing."""
        with self._lock:
            ids = [int(b) for b in blocks]
            for b in ids:
                if self._refs.get(b, 0) < 1:
                    raise ValueError(f"cannot retain free block {b}")
            for b in ids:
                self._refs[b] += 1
        self._set_gauges()

    def release(self, blocks: Sequence[int]) -> int:
        """Drop ownerless references; a release past refcount zero is
        refused (``ValueError``). Returns how many blocks went back to the
        free list."""
        freed = 0
        with self._lock:
            ids = [int(b) for b in blocks]
            for b in ids:
                if self._refs.get(b, 0) < 1:
                    raise ValueError(f"double-free refused: block {b} has "
                                     "no live references")
            for b in ids:
                r = self._refs[b]
                if r == 1:
                    del self._refs[b]
                    self._free.append(b)
                    freed += 1
                else:
                    self._refs[b] = r - 1
        self._count_frees(freed)
        return freed

    def _drop(self, blocks) -> int:
        """Drop one reference to each block (caller holds the lock);
        blocks reaching zero go back to the free list, LIFO. Returns how
        many did."""
        returned = 0
        for b in reversed(blocks):
            r = self._refs.get(b, 0)
            if r <= 1:
                self._refs.pop(b, None)
                self._free.append(b)
                returned += 1
            else:
                self._refs[b] = r - 1
        return returned

    def _count_frees(self, returned: int):
        if returned and obs.enabled():
            obs.counter(f"{self.metric_prefix}_frees").inc(returned)
        self._set_gauges()

    def free(self, owner) -> int:
        """Drop every reference ``owner``'s table holds. Returns the number
        of table entries released (0 for an unknown owner)."""
        with self._lock:
            blocks = self._owned.pop(owner, [])
            returned = self._drop(blocks)
        self._count_frees(returned)
        return len(blocks)

    def truncate(self, owner, keep_tokens: int) -> int:
        """Drop the tail of ``owner``'s table past ``keep_tokens``
        positions. Returns the number of table entries dropped."""
        keep = (blocks_for_tokens(keep_tokens, self.block_size)
                if keep_tokens > 0 else 0)
        with self._lock:
            have = self._owned.get(owner)
            if have is None or len(have) <= keep:
                return 0
            tail = have[keep:]
            del have[keep:]
            returned = self._drop(tail)
        self._count_frees(returned)
        return len(tail)

    def fork_blocks(self, owner, idxs: Sequence[int]) -> List[int]:
        """Copy-on-write: replace the given logical indices of ``owner``'s
        table with private copies wherever the physical block is shared
        (refcount >= 2). The pages are copied on the current stream before
        anything later writes them. Returns the logical indices forked;
        raises :class:`KVCacheOOM` when the free list cannot cover the
        forks (admission reserves them up front)."""
        _chaos.maybe_fire("kv/cow_fork")
        moves, forked = [], []
        with self._lock:
            have = self._owned.get(owner)
            if have is None:
                raise ValueError(f"unknown owner {owner!r}")
            want = [i for i in idxs
                    if i < len(have) and self._refs.get(have[i], 0) >= 2]
            if not want:
                return []
            if len(want) > len(self._free):
                raise KVCacheOOM(
                    f"copy-on-write fork needs {len(want)} blocks, "
                    f"{len(self._free)} free")
            for i in want:
                src = have[i]
                dst = self._free.pop()
                self._refs[dst] = 1
                self._refs[src] -= 1
                have[i] = dst
                moves.append((src, dst))
                forked.append(i)
            self._copy_pages(moves)
            self._high_water = max(self._high_water,
                                   self.num_blocks - 1 - len(self._free))
        if obs.enabled():
            obs.counter(f"{self.metric_prefix}_cow_forks").inc(len(moves))
        self._set_gauges()
        return forked

    # -- page transfer -----------------------------------------------------

    def geometry(self) -> dict:
        """The page-shape contract two pools must agree on before pages
        move between them: per-layer pages are ``(n, kv_heads, block_size,
        head_dim)`` of the page dtype across ``n_layers`` layers. The dtype
        is tagged as the transport tags the pages' buffers (numpy's
        ``dtype.str``, JAX's tag, e.g. ``"<f4"``; ``"bfloat16"`` for
        bfloat16 pages, which numpy lacks)."""
        dt = ("bfloat16" if self.page_dtype == torch.bfloat16 else
              np.dtype(str(self.page_dtype).replace("torch.", "")).str)
        return {"n_layers": self.n_layers, "kv_heads": self.kv_heads,
                "block_size": self.block_size, "head_dim": self.head_dim,
                "dtype": dt}

    def export_blocks(self, owner=None, blocks=None):
        """Host copies of the K/V pages behind ``owner``'s table (or an
        explicit physical-block list - the prefix cache's chain) for a
        cross-process handoff: per layer one ``(n, kvH, bs, D)`` pair in
        logical order, numpy arrays (bfloat16 pages: CPU bfloat16
        tensors, numpy having no bfloat16). Returns ``(block_ids, [(k, v),
        ...])``; exporting a dead block is refused (``ValueError``).

        COPY FIRST: the pages here are updated in place, so where the JAX
        package captures immutable page handles under the ledger lock, the
        port takes a device copy of the named blocks of every layer (one
        ``index_select`` a layer half, on the calling thread's stream)
        while it holds the lock. A defrag (which moves pages and frees
        their old blocks for reuse) or a decode step that runs after the
        lock is released writes the pool, never the copy, so the export
        cannot tear. The host fetch of the copy happens after the lock is
        released."""
        with self._lock:
            if blocks is None:
                if owner is None:
                    raise ValueError("export_blocks needs owner= or "
                                     "blocks=")
                ids = list(self._owned.get(owner, ()))
            else:
                ids = [int(b) for b in blocks]
            for b in ids:
                if self._refs.get(b, 0) < 1:
                    raise ValueError(
                        f"cannot export dead block {b} - the handle "
                        "outlived its page")
            if not ids:
                return [], []
            idx = self._idx(ids)
            copies = [(k.index_select(0, idx), v.index_select(0, idx))
                      for k, v in self._pages]
        return ids, [(_host_pages(k), _host_pages(v)) for k, v in copies]

    def snapshot_blocks(self, blocks):
        """The spill's capture: ``(ids, [(k, v), ...])`` where each pair is
        a fresh DEVICE copy of the blocks' pages (one ``index_select`` per
        layer half on the current stream, under the ledger lock). The
        copies keep every byte the ids name after the blocks are freed
        and rewritten, so the caller may free them at the same
        boundary."""
        with self._lock:
            ids = [int(b) for b in blocks]
            for b in ids:
                if self._refs.get(b, 0) < 1:
                    raise ValueError(f"cannot snapshot dead block {b} - a "
                                     "spill is decided while the pages are "
                                     "referenced")
            idx = self._idx(ids)
            return ids, [(k.index_select(0, idx), v.index_select(0, idx))
                         for k, v in self._pages]

    def _gather(self, ids):
        """A fresh device copy of the pages of physical blocks ``ids``,
        with no ledger check: a lockstep worker's spill, whose ledger is
        rank 0's (the decision was checked there)."""
        idx = self._idx(ids)
        return [(k.index_select(0, idx), v.index_select(0, idx))
                for k, v in self._pages]

    def _write(self, ids, dev):
        """``pages[ids] = dev`` for every layer, no ledger change: a
        lockstep worker's refill into the blocks rank 0 allocated."""
        dst = self._idx(ids)
        for (k, v), (dk, dv) in zip(self._pages, dev):
            k[dst] = dk.to(k.dtype)
            v[dst] = dv.to(v.dtype)

    def adopt_serialized(self, owner, layers, *, stage=None) -> List[int]:
        """Allocate fresh private blocks for ``owner`` and write
        transferred pages into them. ``layers`` is ``[(k_np, v_np), ...]``
        (bfloat16 pages: CPU bfloat16 tensors, as :meth:`export_blocks`
        gives and the transport decodes them),
        per layer ``(n, kvH, block_size, D)`` in logical order; geometry is checked before any
        ledger change and the allocation is all or nothing. ``stage``
        (``f(k_np, v_np) -> (k_dev, v_dev)``) replaces the plain
        host-to-device copy (the swap tier's pinned ring). Returns the new
        physical ids in logical order."""
        geo = self.geometry()
        if len(layers) != geo["n_layers"]:
            raise ValueError(f"handoff geometry mismatch: {len(layers)} "
                             f"layers vs this pool's {geo['n_layers']}")
        # this pool's pages: under a mesh, this rank's kv heads
        want = tuple(self._pages[0][0].shape[1:])
        n = None
        for li, (k, v) in enumerate(layers):
            if tuple(k.shape) != tuple(v.shape) or k.ndim != 4 \
                    or tuple(k.shape[1:]) != want:
                raise ValueError(
                    f"handoff geometry mismatch at layer {li}: "
                    f"k{tuple(k.shape)}/v{tuple(v.shape)} vs (n, "
                    f"{want[0]}, {want[1]}, {want[2]})")
            if n is None:
                n = int(k.shape[0])
            elif int(k.shape[0]) != n:
                raise ValueError("handoff layers disagree on block count")
        if not n:
            return []
        if stage is None:
            dev = [(_as_pages(lk).to(self.device, self.page_dtype),
                    _as_pages(lv).to(self.device, self.page_dtype))
                   for lk, lv in layers]
        else:
            dev = [stage(lk, lv) for lk, lv in layers]
        with self._lock:
            if self._owned.get(owner):
                raise ValueError(f"adopt_serialized owner {owner!r} "
                                 "already holds blocks")
            if n > len(self._free):
                raise KVCacheOOM(
                    f"handoff needs {n} blocks, {len(self._free)} free")
            ids = [self._free.pop() for _ in range(n)]
            for b in ids:
                self._refs[b] = 1
            self._owned[owner] = list(ids)
            dst = self._idx(ids)
            for (k, v), (dk, dv) in zip(self._pages, dev):
                k[dst] = dk.to(k.dtype)
                v[dst] = dv.to(v.dtype)
            self._high_water = max(self._high_water,
                                   self.num_blocks - 1 - len(self._free))
        if obs.enabled():
            obs.counter(f"{self.metric_prefix}_allocs").inc(n)
        self._set_gauges()
        return ids

    def block_table(self, owner) -> np.ndarray:
        """``owner``'s (max_blocks_per_seq,) int32 table, null-padded."""
        out = np.zeros((self.max_blocks_per_seq,), np.int32)
        with self._lock:
            blocks = self._owned.get(owner, ())
            out[:len(blocks)] = blocks
        return out

    def owner_blocks(self, owner) -> List[int]:
        with self._lock:
            return list(self._owned.get(owner, ()))

    def null_table(self) -> np.ndarray:
        """The all-null table a padded decode row carries."""
        return np.zeros((self.max_blocks_per_seq,), np.int32)

    # -- defrag ----------------------------------------------------------

    def add_remap_listener(self, fn: Callable[[dict], None]):
        """Register a ``{old_physical: new_physical}`` callback that
        :meth:`defrag` fires right after the table rewrite, outside the
        ledger lock (the prefix cache re-keys its index through it)."""
        self._remap_listeners.append(fn)

    def frag_blocks(self) -> int:
        """Free holes below the highest allocated physical id (0 when the
        live blocks are packed at ids 1..n)."""
        with self._lock:
            ids = list(self._refs)
            if not ids:
                return 0
            return max(ids) - len(ids)

    def defrag(self) -> int:
        """Repack live blocks into the lowest physical ids: copy each
        out-of-place block's pages down (one gather and one scatter per
        layer half) and rewrite every table; a shared page moves once and
        the remap listeners follow it. Returns the number of blocks moved.
        Run at a step boundary. Handles already staged to host RAM are not
        touched (they hold bytes, not ids). The ``kv/page_copy`` chaos site
        fires before the ledger lock: an injected fault leaves the ledger
        untouched."""
        _chaos.maybe_fire("kv/page_copy")
        with self._lock:
            live = sorted(self._refs)
            n = len(live)
            free_targets = sorted(set(range(1, n + 1)) - set(live))
            moves = [(src, free_targets.pop(0))
                     for src in sorted(b for b in live if b > n)]
            if not moves:
                return 0
            remap = dict(moves)
            self._copy_pages(moves)
            for blocks in self._owned.values():
                for i, b in enumerate(blocks):
                    blocks[i] = remap.get(b, b)
            self._refs = {remap.get(b, b): r for b, r in self._refs.items()}
            self._free = list(range(self.num_blocks - 1, n, -1))
        for fn in self._remap_listeners:
            fn(remap)
        if obs.enabled():
            obs.counter(f"{self.metric_prefix}_defrag_moves").inc(len(moves))
        self._set_gauges()
        return len(moves)

    # -- auditor ---------------------------------------------------------

    def audit(self, prefix_pins: Optional[Dict[int, int]] = None) -> dict:
        """Ledger invariant check over one consistent snapshot; never
        raises. Partition (every id 1..num_blocks-1 free XOR referenced,
        block 0 neither), table references within refcounts, no owner
        aliasing a block twice, no table entry on a dead block, and - with
        ``prefix_pins`` ({block: ownerless references}, the prefix cache's
        pins; ``{}`` without one) - refcount equal to table references plus
        pins and no pin on a dead block. Returns ``{"ok", "violations",
        "blocks", "owners"}``."""
        with self._lock:
            free = list(self._free)
            refs = dict(self._refs)
            owned = {o: list(b) for o, b in self._owned.items()}
        v: List[str] = []
        freeset = set(free)
        if len(freeset) != len(free):
            dup = sorted(b for b, c in Counter(free).items() if c > 1)
            v.append(f"free list holds duplicate block ids {dup[:8]}")
        if 0 in freeset:
            v.append("reserved null block 0 is on the free list")
        if 0 in refs:
            v.append("reserved null block 0 carries a refcount")
        both = sorted(freeset & set(refs))
        if both:
            v.append(f"blocks both free and referenced: {both[:8]}")
        lost = sorted(set(range(1, self.num_blocks)) - freeset - set(refs))
        if lost:
            v.append(f"blocks neither free nor referenced (leaked): "
                     f"{lost[:8]}")
        table_refs: Counter = Counter()
        for owner, blocks in owned.items():
            dup = sorted(b for b, c in Counter(blocks).items() if c > 1)
            if dup:
                v.append(f"owner {owner!r} table aliases block(s) {dup[:8]}")
            for b in blocks:
                table_refs[b] += 1
                if b not in refs:
                    v.append(f"owner {owner!r} references dead block {b}")
        for b in sorted(refs):
            r, t = refs[b], table_refs.get(b, 0)
            if r < 1:
                v.append(f"block {b} has non-positive refcount {r}")
            if t > r:
                v.append(f"block {b} aliased: {t} table references exceed "
                         f"refcount {r}")
            elif prefix_pins is not None and r - t != prefix_pins.get(b, 0):
                v.append(f"block {b} refcount {r} != {t} table refs + "
                         f"{prefix_pins.get(b, 0)} prefix pins")
        if prefix_pins:
            dead = sorted(b for b in prefix_pins if b not in refs)
            if dead:
                v.append(f"prefix entries pin dead block(s) {dead[:8]}")
        return {"ok": not v, "violations": v,
                "blocks": self.num_blocks - 1, "owners": len(owned)}

    def stats(self) -> dict:
        with self._lock:
            in_use = self.num_blocks - 1 - len(self._free)
            return {"blocks_total": self.num_blocks - 1,
                    "blocks_in_use": in_use,
                    "blocks_free": len(self._free),
                    "shared_blocks": sum(1 for r in self._refs.values()
                                         if r >= 2),
                    "owners": len(self._owned),
                    "high_water": self._high_water,
                    "block_size": self.block_size,
                    "max_blocks_per_seq": self.max_blocks_per_seq}

    def _set_gauges(self):
        if not obs.enabled():
            return
        s = self.stats()
        pre = self.metric_prefix
        obs.gauge(f"{pre}_blocks_total").set(s["blocks_total"])
        obs.gauge(f"{pre}_blocks_in_use").set(s["blocks_in_use"])
        obs.gauge(f"{pre}_blocks_free").set(s["blocks_free"])
        obs.gauge(f"{pre}_shared_blocks").set(s["shared_blocks"])
        obs.gauge(f"{pre}_high_water").set(s["high_water"])
        obs.gauge(f"{pre}_frag_blocks").set(self.frag_blocks())


# -- host-RAM paging tier ------------------------------------------------

#: HostKVHandle lifecycle: PENDING while the stager's copy is in flight,
#: READY once the bytes are in host RAM, FAILED when the copy died
#: (consumers recompute), FREED once the reservation is back in the pool.
SPILL_PENDING = "pending"
SPILL_READY = "ready"
SPILL_FAILED = "failed"
SPILL_FREED = "freed"

SWAP_THREAD_NAME = "bigdl_tpu_torch-kv-swap-stager"


class HostKVHandle:
    """One spilled segment of ``n_blocks`` pages. Whoever holds it (a
    spilled prefix entry, a preempted request) settles it exactly once: a
    successful refill or a discard."""

    __slots__ = ("n_blocks", "tag", "state", "layers", "digest", "nbytes",
                 "hid")

    def __init__(self, n_blocks: int, tag=None):
        self.n_blocks = int(n_blocks)
        self.tag = tag
        self.hid = None      # the lockstep id a mesh's ranks share
        self.state = SPILL_PENDING
        self.layers = None   # [(k_np, v_np), ...] per layer, once READY
        self.digest = None   # blake2b over the page bytes
        self.nbytes = 0


class HostKVPool:
    """Host-RAM block accounting: a budget of ``num_blocks`` spill slots
    (one device page per layer each). Reservation happens when a spill is
    decided, so in-flight stages cannot oversubscribe it."""

    def __init__(self, num_blocks: int,
                 metric_prefix: str = "serve/kv_host"):
        if num_blocks < 1:
            raise ValueError(f"host pool needs >= 1 block, got "
                             f"{num_blocks}")
        self.num_blocks = int(num_blocks)
        self.metric_prefix = metric_prefix
        self._lock = threading.Lock()
        self._in_use = 0
        self._spills = 0
        self._set_gauges()

    def alloc(self, n_blocks: int, tag=None) -> HostKVHandle:
        """Reserve ``n_blocks`` slots; :class:`HostPoolOOM` (nothing
        reserved) when the budget cannot cover it."""
        n = int(n_blocks)
        if n < 1:
            raise ValueError(f"spill needs >= 1 block, got {n}")
        with self._lock:
            free = self.num_blocks - self._in_use
            if n > free:
                raise HostPoolOOM(
                    f"spill needs {n} host blocks, {free} free of "
                    f"{self.num_blocks}")
            self._in_use += n
            self._spills += 1
            h = HostKVHandle(n, tag)
        self._set_gauges()
        return h

    def store(self, handle: HostKVHandle, layers, digest) -> bool:
        """Stager side: land the copied pages. False when the handle was
        freed or failed while the copy was in flight."""
        nbytes = sum(int(k.nbytes) + int(v.nbytes) for k, v in layers)
        with self._lock:
            if handle.state != SPILL_PENDING:
                return False
            handle.layers = layers
            handle.digest = digest
            handle.nbytes = nbytes
            handle.state = SPILL_READY
        return True

    def payload(self, handle: HostKVHandle):
        """``(layers, digest)`` when READY, else None (does not free)."""
        with self._lock:
            if handle.state != SPILL_READY:
                return None
            return handle.layers, handle.digest

    def fail(self, handle: HostKVHandle):
        """Stager side: the copy died. PENDING -> FAILED, the reservation
        goes back; consumers see FAILED and recompute."""
        with self._lock:
            if handle.state != SPILL_PENDING:
                return
            handle.state = SPILL_FAILED
            handle.layers = None
            self._in_use -= handle.n_blocks
        self._set_gauges()

    def free(self, handle: HostKVHandle) -> int:
        """Settle a handle and return its reservation (idempotent).
        Returns the blocks returned."""
        with self._lock:
            if handle.state not in (SPILL_PENDING, SPILL_READY):
                return 0
            handle.state = SPILL_FREED
            handle.layers = None
            self._in_use -= handle.n_blocks
        self._set_gauges()
        return handle.n_blocks

    def blocks_in_use(self) -> int:
        with self._lock:
            return self._in_use

    def stats(self) -> dict:
        with self._lock:
            return {"host_blocks_total": self.num_blocks,
                    "host_blocks_in_use": self._in_use,
                    "host_blocks_free": self.num_blocks - self._in_use,
                    "host_spills": self._spills}

    def _set_gauges(self):
        if not obs.enabled():
            return
        with self._lock:
            in_use = self._in_use
        pre = self.metric_prefix
        obs.gauge(f"{pre}_blocks_total").set(self.num_blocks)
        obs.gauge(f"{pre}_blocks_in_use").set(in_use)
        obs.gauge(f"{pre}_blocks_free").set(self.num_blocks - in_use)


def _concat_layers(runs):
    """Several handles' host layers as one run: per layer (k, v), the
    handles' blocks in order."""
    return [tuple(np.concatenate([ls[li][half] for ls in runs])
                  for half in (0, 1)) for li in range(len(runs[0]))]


def _pages_digest(layers) -> bytes:
    """blake2b over host page bytes: a refill re-checks it before the
    pages land."""
    h = hashlib.blake2b(digest_size=16)
    for k, v in layers:
        h.update(np.ascontiguousarray(k).tobytes())
        h.update(np.ascontiguousarray(v).tobytes())
    return h.digest()


class _StagingRing:
    """Pinned host buffers for the refill's host-to-device copies, one
    slot a call in turn. A slot is reused only after the event of its last
    copy has completed; with two slots a layer, that copy is a whole
    refill old, so the wait (the one on the scheduler thread) is almost
    never paid. The compute stream waits on each copy's event, never the
    host. ``events`` collects (start, end) CUDA events around each call's
    copies on ``side``, the host-to-device stream."""

    def __init__(self, device, side, slots: int):
        self.device, self.side = device, side
        self._slots = [None] * max(2, int(slots))  # (k, v, cap, event)
        self._i = 0
        self.events = []

    def to_device(self, lk: np.ndarray, lv: np.ndarray):
        n = int(lk.shape[0])
        self._i = (self._i + 1) % len(self._slots)
        slot = self._slots[self._i]
        if slot is not None and slot[3] is not None:
            slot[3].synchronize()
        if slot is None or slot[2] < n:
            cap = max(n, slot[2] if slot is not None else 0)
            shape = (cap,) + tuple(lk.shape[1:])
            slot = tuple(torch.empty(shape, dtype=torch.from_numpy(
                a[:0]).dtype, pin_memory=True) for a in (lk, lv)) + (cap,
                                                                     None)
        kb, vb = slot[0][:n], slot[1][:n]
        kb.numpy()[...] = lk
        vb.numpy()[...] = lv
        compute = torch.cuda.current_stream(self.device)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.side):
            dk = torch.empty(kb.shape, dtype=kb.dtype, device=self.device)
            dv = torch.empty(vb.shape, dtype=vb.dtype, device=self.device)
            t0.record(self.side)
            dk.copy_(kb, non_blocking=True)
            dv.copy_(vb, non_blocking=True)
            t1.record(self.side)
        self._slots[self._i] = (slot[0], slot[1], slot[2], t1)
        self.events.append((t0, t1))
        compute.wait_event(t1)
        dk.record_stream(compute)
        dv.record_stream(compute)
        return dk, dv


class KVSwapManager:
    """Asynchronous host-RAM staging under one :class:`PagedKVCache`.

    **Spill never blocks the decode loop.** The caller (a step-boundary
    path on the scheduler thread) reserves host slots, and
    :meth:`PagedKVCache.snapshot_blocks` gathers the pages into a fresh
    device buffer on the compute stream; an event is recorded after it
    and the stager thread copies the buffer, once that event has passed,
    on the device-to-host stream into pinned host buffers that every
    spill reuses. The caller may free the device blocks at the same
    boundary.

    **Refill runs on the scheduler thread** at a boundary and only issues
    work: the host bytes go through a pinned staging ring, the
    host-to-device copy runs on a stream of its own (never behind a
    spill's copy), and the compute stream waits on its event before the
    scatter into the pages.

    **Failures degrade**: a copy that raises fails its handles (a spilled
    prefix chain becomes a cold miss, a preempted request recomputes from
    its host-resident tokens); a digest mismatch on refill does the same.
    On the CPU both directions are plain copies on the calling threads.

    **Under a mesh** (lockstep serving, ``serving/_lockstep.py``) every
    rank's manager spills and refills its own pool's kv heads. Mesh rank 0
    decides every spill, refill and discard; ``_mirror`` (set on rank 0,
    ``fn(op, payload)``) sends each as a lockstep command - ``("spill",
    [(hid, ids, tag), ...])`` before the gather, ``("refill", ids,
    [hid, ...])`` after the adopt, ``("hfree", [hid, ...])`` when a
    handle is settled without a refill - and the other ranks replay them
    in order (:meth:`_replay`), so every rank's device pool and host pool
    stay in step. Handles carry the id (``hid``) the ranks share. Only the
    thread that decides sends; the stager thread never issues a
    collective. A worker waits for its own stager to land a handle before
    refilling it; a worker whose copy failed or whose digest does not hold
    where rank 0's did cannot follow, and raises (the lockstep group then
    fails as a whole).
    """

    _mirror = None

    def __init__(self, kv: PagedKVCache, host_blocks: int, *, tag=None):
        self.kv = kv
        self.tag = tag
        self._hids = itertools.count(1)
        self._handles: Dict[int, HostKVHandle] = {}   # a worker's, by hid
        self.pool = HostKVPool(host_blocks,
                               metric_prefix=f"{kv.metric_prefix}_host")
        self._cuda = kv.device.type == "cuda"
        # one stream a direction: a refill's copy, and the compute stream
        # that waits on it, never queue behind a spill's copy
        self._d2h = torch.cuda.Stream(kv.device) if self._cuda else None
        self._ring = (_StagingRing(kv.device, torch.cuda.Stream(kv.device),
                                   2 * kv.n_layers)
                      if self._cuda else None)
        self._spill_host = []   # pinned (k, v) a layer, stager thread only
        self._q: "queue.Queue" = queue.Queue()
        self._stats_lock = threading.Lock()
        self._out_bytes = 0
        self._in_bytes = 0
        self._out_s = 0.0
        self._in_s = 0.0
        self._failures = 0
        self._thread = threading.Thread(
            target=self._worker, name=SWAP_THREAD_NAME, daemon=True)
        self._thread.start()

    def warmup(self, max_bucket: int = 32):
        """Pay the first pinned allocations and copies before traffic: one
        round trip of ``min(max_bucket, num_blocks)`` null pages through
        both directions' buffers."""
        n = max(1, min(int(max_bucket), self.kv.num_blocks - 1))
        k = self.kv.pages()[0][0]
        z = torch.zeros((n,) + tuple(k.shape[1:]), dtype=k.dtype,
                        device=k.device)
        host = z.cpu().numpy()
        if self._cuda:
            self._spill_buffers(n)
            self._ring.to_device(host, host)
            torch.cuda.current_stream(self.kv.device).synchronize()
            self._ring.events.clear()

    # -- spill ------------------------------------------------------------

    def spill(self, blocks, tag=None) -> Optional[HostKVHandle]:
        """Boundary op, scheduler thread: reserve host slots and queue the
        copy of ``blocks``. Returns the PENDING handle, or None when the
        host pool cannot cover it (the caller drops the pages instead).
        The caller may free the device blocks as soon as this returns."""
        out = self.spill_many([blocks], tag=tag)
        return out[0] if out else None

    def spill_many(self, groups, tag=None):
        """One handle per group of blocks (None where the host pool is
        short), one gather and one stager job for all of them."""
        plans, flat, handles, sent = [], [], [], []
        for blocks in groups:
            ids = [int(b) for b in blocks]
            if not ids:
                handles.append(None)
                continue
            try:
                h = self.pool.alloc(len(ids), tag if tag is not None
                                    else self.tag)
            except HostPoolOOM:
                handles.append(None)
                continue
            h.hid = next(self._hids)
            plans.append((h, len(flat), len(ids)))
            sent.append((h.hid, ids, h.tag))
            flat += ids
            handles.append(h)
        if plans:
            if self._mirror is not None:
                self._mirror("spill", sent)
            _, pages = self.kv.snapshot_blocks(flat)
            self._stage_out(plans, pages)
        return handles

    def _stage_out(self, plans, pages):
        """Queue the gathered ``pages`` for the stager (after an event on
        the compute stream, on a card)."""
        ev = None
        if self._cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.kv.device))
        self._q.put((plans, pages, ev))

    def _worker(self):
        while True:
            job = self._q.get()
            if job is None:
                return
            plans, pages, ev = job
            try:
                self._fetch(plans, pages, ev)
            except Exception:  # noqa: BLE001 - a swap never kills serving
                for h, _s, _n in plans:
                    self._note_failure(h, "out", "unexpected stager error")

    def _fetch(self, plans, pages, ev):
        """Stager thread: copy the gathered pages to host RAM and land each
        handle's share with its digest."""
        live = [(h, s, n) for h, s, n in plans if h.state == SPILL_PENDING]
        if not live:
            return
        host = last = None
        for _attempt in (0, 1):
            try:
                _chaos.maybe_fire("kv/swap_out", tag=live[0][0].tag)
                host, secs = self._copy_out(pages, ev)
                break
            except TransientDeviceError as e:
                last = e   # the gathered buffer is unchanged: copy again
            except Exception as e:  # noqa: BLE001 - degrade, never die
                last = e
                break
        if host is None:
            for h, _s, _n in live:
                self._note_failure(h, "out", repr(last))
            return
        flat = [(k.numpy(), v.numpy()) for k, v in host]
        stored = 0
        for h, s, n in live:
            layers = [(np.array(k[s:s + n]), np.array(v[s:s + n]))
                      for k, v in flat]
            if self.pool.store(h, layers, _pages_digest(layers)):
                stored += h.nbytes
        with self._stats_lock:
            self._out_bytes += stored
            self._out_s += secs
        if stored and obs.enabled():
            obs.counter(f"{self.kv.metric_prefix}_swap_out_bytes").inc(
                stored)

    def _copy_out(self, pages, ev):
        """The gathered pages in host memory (pinned, on a card: copied on
        the device-to-host stream after ``ev``) and the copy's seconds."""
        if self._cuda:
            host = self._spill_buffers(int(pages[0][0].shape[0]))
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            with torch.cuda.device(self.kv.device), \
                    torch.cuda.stream(self._d2h):
                self._d2h.wait_event(ev)
                t0.record(self._d2h)
                for (k, v), (hk, hv) in zip(pages, host):
                    hk.copy_(k, non_blocking=True)
                    hv.copy_(v, non_blocking=True)
                t1.record(self._d2h)
            t1.synchronize()
            return host, t0.elapsed_time(t1) / 1e3
        return pages, 0.0

    def _spill_buffers(self, n: int):
        """The pinned (k, v) buffers a layer, first ``n`` blocks: one set,
        grown to the largest spill seen and reused by every job (a job's
        bytes are copied out of it before the next job starts)."""
        if not self._spill_host or self._spill_host[0][0].shape[0] < n:
            self._spill_host = [tuple(
                torch.empty((n,) + tuple(t.shape[1:]), dtype=t.dtype,
                            pin_memory=True) for t in kv)
                for kv in self.kv.pages()]
        return [(hk[:n], hv[:n]) for hk, hv in self._spill_host]

    def _note_failure(self, h: HostKVHandle, direction: str, error: str):
        self.pool.fail(h)
        with self._stats_lock:
            self._failures += 1
        if obs.enabled():
            obs.counter(f"{self.kv.metric_prefix}_swap_failures").inc()
        _health.emit("kv_swap_failed", direction=direction,
                     blocks=h.n_blocks, tag=str(h.tag), error=error)

    # -- refill -----------------------------------------------------------

    def _verified(self, h: HostKVHandle):
        """The handle's layers when READY and its digest holds; None
        otherwise (a failed, freed or corrupt handle is settled here).
        The ``kv/swap_in`` chaos site fires before the check: a transient
        fault retries it once (the host bytes do not change), any other
        failure settles the handle."""
        got = self.pool.payload(h)
        if got is None:
            if h.state != SPILL_PENDING:
                self._settle([h])
            return None
        layers, digest = got
        last = None
        for _attempt in (0, 1):
            try:
                _chaos.maybe_fire("kv/swap_in", tag=h.tag)
                if _pages_digest(layers) != digest:
                    raise RuntimeError(f"host page digest mismatch over "
                                       f"{h.n_blocks} blocks")
                return layers
            except TransientDeviceError as e:
                last = e
            except Exception as e:  # noqa: BLE001 - degrade, never die
                last = e
                break
        self._note_failure(h, "in", repr(last))
        self._settle([h])   # fail() is a no-op on a READY handle
        return None

    def _settle(self, handles):
        """Free settled handles' reservations; under a mesh the other
        ranks free theirs too."""
        for h in handles:
            self.pool.free(h)
        if self._mirror is not None:
            self._mirror("hfree", [h.hid for h in handles])

    def refill(self, owner, handle: HostKVHandle) -> Optional[List[int]]:
        """Boundary op, scheduler thread: land a READY handle's pages in
        fresh device blocks for ``owner``. Returns the new ids (the host
        reservation goes back), or None when the handle cannot serve
        (still PENDING: retry at a later boundary; failed, freed or
        corrupt: settled here, the caller degrades). Raises
        :class:`KVCacheOOM` with the handle intact when the device pool
        cannot fit it."""
        if handle.state == SPILL_PENDING:
            return None
        layers = self._verified(handle)
        if layers is None:
            return None
        ids = self._adopt(owner, layers, handle.nbytes, [handle])
        self.pool.free(handle)
        return ids

    def refill_many(self, owner, handles):
        """Land the longest clean leading run of READY handles in one
        adopt. Returns ``(ids, consumed, dropped)``: ``ids`` cover
        ``handles[:consumed]`` in logical order, the next ``dropped``
        handles were settled here (failed or corrupt), later ones are
        untouched. The run is clamped to the free list; raises
        :class:`KVCacheOOM` with every handle intact when not even one
        fits."""
        run, run_layers, dropped = [], [], 0
        for h in handles:
            if h.state == SPILL_PENDING:
                break
            layers = self._verified(h)
            if layers is None:
                dropped = 1
                break
            run.append(h)
            run_layers.append(layers)
        if not run:
            return None, 0, dropped
        free = self.kv.blocks_free()
        while run and sum(h.n_blocks for h in run) > free:
            run.pop()
            run_layers.pop()
            dropped = 0
        if not run:
            raise KVCacheOOM(
                f"refill needs {handles[0].n_blocks} blocks, {free} free")
        ids = self._adopt(owner, _concat_layers(run_layers),
                          sum(h.nbytes for h in run), run)
        for h in run:
            self.pool.free(h)
        return ids, len(run), dropped

    def _adopt(self, owner, layers, nbytes, handles):
        ids = self.kv.adopt_serialized(
            owner, layers, stage=self._ring.to_device if self._cuda else None)
        if self._mirror is not None:
            self._mirror("refill", (ids, [h.hid for h in handles]))
        self._count_in(nbytes)
        return ids

    def _count_in(self, nbytes):
        with self._stats_lock:
            self._in_bytes += nbytes
        if obs.enabled():
            obs.counter(f"{self.kv.metric_prefix}_swap_in_bytes").inc(nbytes)

    # -- lockstep: the other ranks of a mesh --------------------------------

    REPLAY_WAIT_S = 60.0

    def _replay(self, op, payload):
        """Replay one of mesh rank 0's host-tier commands on this rank's
        pool (see the class docstring)."""
        if op == "spill":
            plans, flat = [], []
            for hid, ids, tag in payload:
                h = self.pool.alloc(len(ids), tag)
                h.hid = hid
                self._handles[hid] = h
                plans.append((h, len(flat), len(ids)))
                flat += ids
            self._stage_out(plans, self.kv._gather(flat))
        elif op == "refill":
            ids, hids = payload
            hs = [self._handles.pop(hid) for hid in hids]
            run = []
            for h in hs:
                deadline = time.monotonic() + self.REPLAY_WAIT_S
                while h.state == SPILL_PENDING \
                        and time.monotonic() < deadline:
                    time.sleep(0.001)
                layers = self._verified(h)
                if layers is None:
                    raise RuntimeError(
                        f"lockstep refill of host handle {h.hid}: this "
                        f"rank's copy is {h.state}, rank 0's refilled - "
                        "the pools cannot stay in step")
                run.append(layers)
            cat = _concat_layers(run)
            if self._cuda:
                dev = [self._ring.to_device(lk, lv) for lk, lv in cat]
            else:
                dev = [(torch.as_tensor(lk), torch.as_tensor(lv))
                       for lk, lv in cat]
            self.kv._write(ids, dev)
            self._count_in(sum(h.nbytes for h in hs))
            for h in hs:
                self.pool.free(h)
        elif op == "hfree":
            for hid in payload:
                h = self._handles.pop(hid, None)
                if h is not None:
                    self.pool.free(h)

    # -- lifecycle --------------------------------------------------------

    def discard(self, handle: HostKVHandle) -> int:
        """Drop a handle without refilling it (idempotent); returns the
        host blocks returned."""
        n = self.pool.free(handle)
        if self._mirror is not None and handle.hid is not None:
            self._mirror("hfree", [handle.hid])
        return n

    def stats(self) -> dict:
        """Bytes each way, failures and the host pool's counts; on a card
        also the device seconds the copies took (``swap_out_s``: the
        stager's device-to-host copies; ``swap_in_s``: the refills'
        host-to-device copies, read from their CUDA events, so this waits
        for any still in flight). ``None`` off the card."""
        secs = 0.0
        while self._cuda and self._ring.events:
            t0, t1 = self._ring.events.pop(0)
            t1.synchronize()
            secs += t0.elapsed_time(t1) / 1e3
        with self._stats_lock:
            self._in_s += secs
            out = {"swap_out_bytes": self._out_bytes,
                   "swap_in_bytes": self._in_bytes,
                   "swap_failures": self._failures,
                   "swap_out_s": self._out_s if self._cuda else None,
                   "swap_in_s": self._in_s if self._cuda else None}
        out.update(self.pool.stats())
        return out

    def shutdown(self, timeout: float = 10.0):
        """Stop the stager thread; jobs still queued fail their handles."""
        self._q.put(None)
        self._thread.join(timeout)
        while True:
            try:
                job = self._q.get_nowait()
            except queue.Empty:
                break
            if job is not None:
                for h, _s, _n in job[0]:
                    self.pool.fail(h)


def kv_swap_threads_alive() -> int:
    """Live swap-stager threads (tests check 0 after shutdown)."""
    return sum(1 for t in threading.enumerate()
               if t.name == SWAP_THREAD_NAME and t.is_alive())
