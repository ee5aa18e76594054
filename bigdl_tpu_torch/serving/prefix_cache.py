"""Content-addressed prefix index over the paged KV block pool (counterpart
of ``bigdl_tpu/serving/prefix_cache.py``).

Block ``i`` of a prompt is keyed by a rolling digest::

    key_i = blake2b(key_{i-1} || tokens[i*bs:(i+1)*bs])
    key_-1 = version || 0x00 || str(block_size)

so a key commits to the whole token history and to the model version (a
hot swap stops old entries matching; they age out). Each entry pins ONE
physical block of the :class:`~.kv_cache.PagedKVCache` ledger (an ownerless
reference). A lookup walks the chain until the first absent entry.

* **insert**: after a request's prefill, the scheduler registers every
  FULL prompt block; new entries retain the owner's block, which from then
  on is shared and read-only.
* **hit**: a later admission adopts the matched blocks into its table
  (refcount +1 each, no page copy) and skips their prefill chunks.
* **evict**: under block pressure, least recently used entries whose block
  only the cache holds go first, leaves before parents.
* **second chance**: with a :class:`~.kv_cache.KVSwapManager`, an evicted
  entry's page spills to host RAM and its key moves to a second-chance
  index; a later lookup that walks into spilled keys refills them
  (digest-checked) and takes the ordinary warm-hit path. A spill the host
  pool cannot hold is a plain drop.
* **defrag**: a remap listener on the ledger follows moved pages.

Thread safety: one lock; the scheduler thread mutates, other threads only
:meth:`PrefixCache.peek`.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import List, Optional, Sequence

import numpy as np

from .. import observability as obs
from ..parallel import chaos as _chaos
from .kv_cache import (SPILL_FAILED, SPILL_FREED, SPILL_PENDING, SPILL_READY,
                       KVCacheOOM, PagedKVCache)


def chain_keys(token_ids, block_size: int, version: str,
               max_blocks: Optional[int] = None) -> List[bytes]:
    """The rolling digests of every FULL ``block_size`` chunk of
    ``token_ids`` under ``version``: ``keys[i]`` commits to tokens
    ``[0, (i+1)*block_size)`` (their int32 bytes) and the version."""
    toks = np.asarray(token_ids, np.int32).reshape(-1)
    n = toks.size // block_size
    if max_blocks is not None:
        n = min(n, max_blocks)
    keys: List[bytes] = []
    prev = version.encode() + b"\x00" + str(block_size).encode()
    for i in range(n):
        h = hashlib.blake2b(prev, digest_size=16)
        h.update(toks[i * block_size:(i + 1) * block_size].tobytes())
        prev = h.digest()
        keys.append(prev)
    return keys


class _Entry:
    __slots__ = ("key", "parent", "block", "depth", "children")

    def __init__(self, key: bytes, parent: Optional[bytes], block: int,
                 depth: int):
        self.key = key
        self.parent = parent
        self.block = block
        self.depth = depth          # chain position (0 = first block)
        self.children = 0           # present child entries


class PrefixCache:
    """Content-addressed block sharing over one :class:`PagedKVCache`.

    kv : the ledger whose blocks the index pins.
    max_entries : optional cap on resident entries (insert evicts past it);
        ``None`` bounds the cache by the pool alone.
    metric_prefix : the ``serve/prefix`` namespace of the counters
        (``_evictions``, ``_spills``, ``_refills``, ``_hits_after_spill``)
        and gauges (``_entries``, ``_shared_blocks``, ``_spilled_entries``).
    swap : optional :class:`~.kv_cache.KVSwapManager`: evicted entries
        spill to host RAM and refill on a later lookup.
    """

    def __init__(self, kv: PagedKVCache, *,
                 max_entries: Optional[int] = None,
                 metric_prefix: str = "serve/prefix", swap=None):
        self.kv = kv
        self.block_size = kv.block_size
        self.max_entries = max_entries
        self.metric_prefix = metric_prefix
        self.swap = swap
        self._entries: "OrderedDict[bytes, _Entry]" = OrderedDict()
        # second chance: key -> (HostKVHandle, depth), oldest spill first
        self._spilled: "OrderedDict[bytes, tuple]" = OrderedDict()
        self._lock = threading.Lock()
        self._evictions = 0
        self._spills = 0
        self._refills = 0
        self._hits_after_spill = 0
        kv.add_remap_listener(self._on_remap)

    # -- lookup ----------------------------------------------------------

    def _next_key(self, prev: bytes, toks: np.ndarray, i: int) -> bytes:
        h = hashlib.blake2b(prev, digest_size=16)
        h.update(toks[i * self.block_size:
                      (i + 1) * self.block_size].tobytes())
        return h.digest()

    def _walk(self, token_ids, version: str, touch: bool):
        """Digest the chain incrementally, stopping at the first absent
        entry. Returns ``(blocks, parent_key, prev_digest, stop_i,
        tokens)``."""
        toks = np.asarray(token_ids, np.int32).reshape(-1)
        n = toks.size // self.block_size
        prev = version.encode() + b"\x00" + str(self.block_size).encode()
        parent: Optional[bytes] = None
        blocks: List[int] = []
        i = 0
        with self._lock:
            while i < n:
                key = self._next_key(prev, toks, i)
                e = self._entries.get(key)
                if e is None:
                    break
                if touch:
                    self._entries.move_to_end(key)
                blocks.append(e.block)
                parent = prev = key
                i += 1
        return blocks, parent, prev, i, toks

    def lookup(self, token_ids, version: str) -> List[int]:
        """The physical blocks of the longest cached chain of this prompt
        (possibly empty); touches the matched entries. With a swap
        manager the walk continues into spilled keys: a run of READY
        ones refills and extends the hit, a PENDING one ends the walk
        (a cold path this time), a failed one is dropped."""
        blocks, parent, prev, i, toks = self._walk(token_ids, version,
                                                   touch=True)
        if self.swap is None:
            return blocks
        n = toks.size // self.block_size
        run = []
        while i < n:
            key = self._next_key(prev, toks, i)
            with self._lock:
                got = self._spilled.get(key)
            if got is None:
                break
            handle, depth = got
            state = handle.state
            if state == SPILL_PENDING:
                break
            if state in (SPILL_FAILED, SPILL_FREED):
                with self._lock:
                    self._spilled.pop(key, None)
                self.swap.discard(handle)
                break
            run.append((key, handle, depth))
            prev = key
            i += 1
        if run:
            blocks += self._refill_run(run, parent, blocks)
        return blocks

    def _refill_run(self, run, parent: Optional[bytes],
                    protect: Sequence[int]) -> List[int]:
        """Land a run of spilled pages back in the pool with one batched
        adopt and re-insert their entries (cache-pinned). Under block
        pressure the coldest unreferenced residents are evicted first,
        with ``protect`` (the resident head this run extends) pinned
        meanwhile. Returns the refilled blocks (possibly a leading part of
        the run, or none)."""
        need = sum(h.n_blocks for _, h, _ in run)
        short = need - self.kv.blocks_free()
        if short > 0:
            self.kv.retain(protect)
            try:
                self.evict(short)
            finally:
                self.kv.release(protect)
        tmp = ("prefix-refill", run[0][0])
        try:
            ids, consumed, dropped = self.swap.refill_many(
                tmp, [h for _, h, _ in run])
        except KVCacheOOM:
            return []
        for key, _h, _d in run[consumed:consumed + dropped]:
            with self._lock:
                self._spilled.pop(key, None)
        if not consumed:
            return []
        # the refill owner's table references become the cache's pins
        self.kv.retain(ids)
        self.kv.free(tmp)
        with self._lock:
            for (key, _h, depth), block in zip(run[:consumed], ids):
                self._spilled.pop(key, None)
                self._entries[key] = _Entry(key, parent, int(block), depth)
                if parent is not None:
                    p = self._entries.get(parent)
                    if p is not None:
                        p.children += 1
                self._refills += 1
                parent = key
            self._hits_after_spill += 1
        if obs.enabled():
            obs.counter(f"{self.metric_prefix}_hits_after_spill").inc()
            obs.counter(f"{self.metric_prefix}_refills").inc(consumed)
        self._set_gauges()
        return [int(b) for b in ids]

    def peek(self, token_ids, version: str) -> int:
        """Cached prefix length in TOKENS (resident chain plus READY
        spilled keys), without touching recency."""
        blocks, _parent, prev, i, toks = self._walk(token_ids, version,
                                                    touch=False)
        hit = len(blocks)
        if self.swap is not None:
            n = toks.size // self.block_size
            while i < n:
                key = self._next_key(prev, toks, i)
                with self._lock:
                    got = self._spilled.get(key)
                if got is None or got[0].state != SPILL_READY:
                    break
                hit += 1
                prev = key
                i += 1
        return hit * self.block_size

    # -- insert ----------------------------------------------------------

    def insert(self, token_ids, version: str,
               owner_blocks: Sequence[int]) -> int:
        """Register a prefilled prompt's FULL blocks (``owner_blocks``:
        the owner's physical ids for chain positions 0..len-1). Present
        entries are refreshed; new ones retain the owner's block. Returns
        the number of new entries. The ``prefix/insert`` chaos site fires
        before any index change."""
        _chaos.maybe_fire("prefix/insert")
        keys = chain_keys(token_ids, self.block_size, version,
                          max_blocks=len(owner_blocks))
        new = 0
        stale = []
        with self._lock:
            parent: Optional[bytes] = None
            for i, k in enumerate(keys):
                if k in self._entries:
                    self._entries.move_to_end(k)
                    parent = k
                    continue
                # chains register root first: the parent is resident
                if parent is not None and parent not in self._entries:
                    raise RuntimeError("prefix chain registered out of "
                                       "order")
                self.kv.retain([owner_blocks[i]])
                self._entries[k] = _Entry(k, parent, int(owner_blocks[i]), i)
                if parent is not None:
                    self._entries[parent].children += 1
                parent = k
                new += 1
                old = self._spilled.pop(k, None)
                if old is not None:
                    stale.append(old[0])
            over = (len(self._entries) - self.max_entries
                    if self.max_entries is not None else 0)
        for h in stale:
            self.swap.discard(h)
        if over > 0:
            self.evict(over)
        if new:
            self._set_gauges()
        return new

    # -- evict -----------------------------------------------------------

    def evict(self, n_blocks: int) -> int:
        """Reclaim up to ``n_blocks`` pages from entries only the cache
        references (refcount 1), least recently used first, leaves before
        parents. Returns the pages returned to the free list. The
        ``prefix/evict`` chaos site fires first."""
        _chaos.maybe_fire("prefix/evict")
        freed = 0
        while freed < n_blocks:
            victims = []
            with self._lock:
                for e in self._entries.values():
                    if freed + len(victims) >= n_blocks:
                        break
                    if e.children == 0 and self.kv.block_refs(e.block) == 1:
                        victims.append(e)
                for e in victims:
                    del self._entries[e.key]
                    if e.parent is not None:
                        p = self._entries.get(e.parent)
                        if p is not None:
                            p.children -= 1
            if not victims:
                break
            if self.swap is not None:
                # spill each victim's page (one gather for the sweep)
                # BEFORE its block is released
                hs = self.swap.spill_many([[e.block] for e in victims],
                                          tag="prefix")
                short = [i for i, h in enumerate(hs) if h is None]
                if short and self.drop_spilled(len(short)):
                    again = self.swap.spill_many(
                        [[victims[i].block] for i in short], tag="prefix")
                    for i, h in zip(short, again):
                        hs[i] = h
                spilled = 0
                for e, h in zip(victims, hs):
                    if h is None:
                        continue
                    with self._lock:
                        old = self._spilled.pop(e.key, None)
                        self._spilled[e.key] = (h, e.depth)
                    if old is not None:
                        self.swap.discard(old[0])
                    spilled += 1
                self._spills += spilled
                if spilled and obs.enabled():
                    obs.counter(f"{self.metric_prefix}_spills").inc(spilled)
            self.kv.release([e.block for e in victims])
            freed += len(victims)
            self._evictions += len(victims)
            if obs.enabled():
                obs.counter(f"{self.metric_prefix}_evictions").inc(
                    len(victims))
        if freed:
            self._set_gauges()
        return freed

    def drop_spilled(self, n_blocks: int) -> int:
        """Reclaim host reservations from the oldest spilled keys; returns
        the host blocks returned."""
        dropped, got = [], 0
        with self._lock:
            while got < n_blocks and self._spilled:
                _key, (h, _depth) = self._spilled.popitem(last=False)
                dropped.append(h)
                got += h.n_blocks
        freed = sum(self.swap.discard(h) for h in dropped)
        if dropped:
            self._set_gauges()
        return freed

    def clear(self) -> int:
        """Release every entry's page and settle every spilled handle.
        Returns the entry count dropped."""
        with self._lock:
            entries = list(self._entries.values())
            self._entries.clear()
            spilled = [h for h, _d in self._spilled.values()]
            self._spilled.clear()
        for e in entries:
            self.kv.release([e.block])
        for h in spilled:
            self.swap.discard(h)
        self._set_gauges()
        return len(entries)

    # -- internals -------------------------------------------------------

    def _on_remap(self, remap: dict):
        """Defrag moved pages: follow them."""
        with self._lock:
            for e in self._entries.values():
                e.block = remap.get(e.block, e.block)

    def pinned_blocks(self) -> dict:
        """``{physical_block: pin_count}`` of every resident entry (the
        ledger audit's exact accounting)."""
        with self._lock:
            out: dict = {}
            for e in self._entries.values():
                out[e.block] = out.get(e.block, 0) + 1
            return out

    def stats(self) -> dict:
        with self._lock:
            n = len(self._entries)
            depth = max((e.depth + 1 for e in self._entries.values()),
                        default=0)
            spilled = len(self._spilled)
        return {"entries": n, "max_chain_blocks": depth,
                "evictions": self._evictions,
                "shared_blocks": self.kv.shared_blocks(),
                "spilled_entries": spilled, "spills": self._spills,
                "refills": self._refills,
                "hits_after_spill": self._hits_after_spill}

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def _set_gauges(self):
        if not obs.enabled():
            return
        pre = self.metric_prefix
        obs.gauge(f"{pre}_entries").set(len(self))
        obs.gauge(f"{pre}_shared_blocks").set(self.kv.shared_blocks())
        with self._lock:
            spilled = len(self._spilled)
        obs.gauge(f"{pre}_spilled_entries").set(spilled)
