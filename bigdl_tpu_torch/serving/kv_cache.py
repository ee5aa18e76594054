"""Paged KV cache: fixed-size device blocks + per-request block tables
(counterpart of ``bigdl_tpu/serving/kv_cache.py``).

All cache memory is pooled into ``num_blocks`` blocks of ``block_size``
positions, per layer ``k_pages, v_pages : (num_blocks, kvH, block_size,
D)``, and each request gets a BLOCK TABLE: logical block ``i`` of its
sequence lives at physical page ``table[i]``. Block 0 is the reserved NULL
block: unallocated table entries and the padded rows of a decode bucket
point there, so their writes land in space no real row reads.

Unlike the JAX package's functional pages, the pages here are updated IN
PLACE by ``Transformer.decode_paged`` (scatter through the tables); the
cache hands out the same tensors for the life of the pool.

The ledger (free list, per-owner block lists, per-block reference counts)
is host state under a lock, and the scheduler's admission authority: a
request is admitted only when its worst-case need fits the free list, so
no step can run out of blocks mid-flight.
"""
from __future__ import annotations

import threading
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..utils.engine import refuse_unported


class KVCacheOOM(RuntimeError):
    """The free list cannot cover a requested allocation (typed, so
    admission can defer instead of failing)."""


def blocks_for_tokens(tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``tokens`` positions (ceil division)."""
    return -(-int(tokens) // int(block_size))


class PagedKVCache:
    """Pooled page storage on the model's device + the block ledger.

    A block with reference count 1 belongs to one referent and may be
    written; ``retain``/``release`` add and drop ownerless references."""

    def __init__(self, model, *, num_blocks: int, block_size: int = 16,
                 max_blocks_per_seq: int, dtype=torch.float32,
                 metric_prefix: str = "serve/kv", sharding=None):
        refuse_unported("PagedKVCache", metric_prefix=(metric_prefix,
                                                        "serve/kv"),
                        sharding=(sharding, None))
        if num_blocks < 2:
            raise ValueError(f"num_blocks must be >= 2 (block 0 is the "
                             f"reserved null block), got {num_blocks}")
        if block_size < 2 or (block_size & (block_size - 1)):
            raise ValueError(f"block_size must be a power of two >= 2, "
                             f"got {block_size}")
        if max_blocks_per_seq < 1:
            raise ValueError("max_blocks_per_seq must be >= 1")
        attn = model.blocks[0].attn
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.max_blocks_per_seq = int(max_blocks_per_seq)
        self.max_seq_len = self.max_blocks_per_seq * self.block_size
        self.kv_heads = int(attn._kvh())
        self.head_dim = int(model.hidden_size // attn.num_heads)
        self.n_layers = len(model.blocks)
        self.page_dtype = dtype
        self.device = model.device
        shape = (num_blocks, self.kv_heads, block_size, self.head_dim)
        self._pages = [(torch.zeros(shape, dtype=dtype, device=self.device),
                        torch.zeros(shape, dtype=dtype, device=self.device))
                       for _ in model.blocks]
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._owned: Dict[object, List[int]] = {}
        self._refs: Dict[int, int] = {}
        self._high_water = 0
        self._lock = threading.Lock()

    # -- device pages ----------------------------------------------------

    def pages(self):
        """Per-layer [(k_pages, v_pages), ...], updated in place."""
        return self._pages

    # -- ledger ----------------------------------------------------------

    def blocks_free(self) -> int:
        with self._lock:
            return len(self._free)

    def owned(self, owner) -> int:
        with self._lock:
            return len(self._owned.get(owner, ()))

    def block_refs(self, block: int) -> int:
        with self._lock:
            return self._refs.get(int(block), 0)

    def ensure_capacity(self, owner, upto_tokens: int):
        """Grow ``owner``'s allocation so positions ``0..upto_tokens-1``
        fit. Raises :class:`KVCacheOOM` (allocating NOTHING) when the free
        list cannot cover the growth, ``ValueError`` past the table
        width."""
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

    def retain(self, blocks: Sequence[int]):
        """Ownerless references: refcount +1 each, all or nothing."""
        with self._lock:
            ids = [int(b) for b in blocks]
            for b in ids:
                if self._refs.get(b, 0) < 1:
                    raise ValueError(f"cannot retain free block {b}")
            for b in ids:
                self._refs[b] += 1

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
        return freed

    def _drop(self, blocks):
        """Drop one reference to each block (caller holds the lock);
        blocks reaching zero go back to the free list, LIFO."""
        for b in reversed(blocks):
            r = self._refs.get(b, 0)
            if r <= 1:
                self._refs.pop(b, None)
                self._free.append(b)
            else:
                self._refs[b] = r - 1

    def free(self, owner) -> int:
        """Drop every reference ``owner``'s table holds. Returns the number
        of table entries released (0 for an unknown owner)."""
        with self._lock:
            blocks = self._owned.pop(owner, [])
            self._drop(blocks)
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
            self._drop(tail)
        return len(tail)

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

    # -- auditor ---------------------------------------------------------

    def audit(self, prefix_pins: Optional[Dict[int, int]] = None) -> dict:
        """Ledger invariant check over one consistent snapshot; never
        raises. Partition (every id 1..num_blocks-1 free XOR referenced,
        block 0 neither), table references within refcounts, no owner
        aliasing a block twice, no table entry on a dead block, and - with
        ``prefix_pins`` ({block: ownerless references}, the prefix cache's
        pins; ``{}`` without one) - refcount equal to table references plus
        pins. Returns ``{"ok", "violations", "blocks",
        "owners"}``."""
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
                         f"{prefix_pins.get(b, 0)} pins")
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
