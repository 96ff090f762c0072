"""Paged-KV block allocator: refcounted and content-addressed.

Counterpart of ``multiverso_tpu/serving/block_pool.py``. The paged layout
carves the KV cache into fixed-size **blocks** of ``block_size`` token
positions; a sequence owns the blocks listed in its row of the engine's
block table. This module is the host-side half: an allocator over block
ids (the device pools ``[L, n_blocks + 1, block_size, D]`` live in the
engine). A block moves through three states:

* **free**: on the free list, content undefined;
* **live**: held by one or more sequences (refcount >= 1). A block held
  by several is *shared*: every holder reads it, nobody writes it (the
  engine copies a shared block before a write could land in it);
* **cached**: refcount 0 but content-addressed (registered under a hash
  chain identity), so it stays resident in LRU order until a later prompt
  with the same prefix reactivates it (:meth:`lookup`) or allocation
  pressure evicts it back to the free list.

A full block's identity is the blake2b-128 hash of its token span chained
with its predecessor's hash and a seed (the engine seeds with the pinned
snapshot version): :func:`chain_hashes` gives the same bytes as the JAX
function. Allocating past free + cached capacity, a double ``decref``,
freeing a shared block or registering a block that is not live raises:
a bookkeeping hole here corrupts a neighbouring sequence's cache.
:meth:`drift` scans every invariant without raising, for the watchdog.

The locks are plain ``threading`` locks (the JAX module takes them from
its lock-order witness, which the port does not have yet).
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..dashboard import Dashboard

# block id 0: reserved scratch, the block-table pad sentinel and the
# parking target for dead-lane and pad-position writes. Never allocated.
SCRATCH_BLOCK = 0


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def kv_bytes_per_block(n_layers: int, d_model: int, block_size: int,
                       dtype=np.float32, quant: str = "none") -> int:
    """Device bytes one block costs across both pools (K and V);
    ``dtype`` is a numpy or torch dtype. ``quant="int8"`` counts the int8
    payload plus the fp32 scale each pool keeps per (layer, block)."""
    if quant == "int8":
        return 2 * n_layers * (block_size * d_model + 4)
    return 2 * n_layers * block_size * d_model * _itemsize(dtype)


def blocks_for_bytes(budget_bytes: int, n_layers: int, d_model: int,
                     block_size: int, dtype=np.float32,
                     quant: str = "none") -> int:
    """Usable blocks a KV-bytes budget buys (the scratch block's bytes
    ride along but hold no sequence). Raises for a budget too small for
    scratch + one block: 0 would read as the auto-sized pool."""
    per = kv_bytes_per_block(n_layers, d_model, block_size, dtype, quant)
    n = budget_bytes // per - 1
    if n < 1:
        raise ValueError(
            f"KV budget {budget_bytes} B buys no usable block: need >= "
            f"{2 * per} B (scratch + 1 block of {per} B at block_size "
            f"{block_size})")
    return int(n)


def chain_hashes(tokens: Sequence[int], block_size: int,
                 seed: bytes = b"") -> List[bytes]:
    """Hash-chained identities of every FULL block of ``tokens``:
    ``hashes[k]`` identifies span ``[k*Bs, (k+1)*Bs)`` given its whole
    prefix (each digest folds in its predecessor's, starting from
    ``seed``). Tokens hash as int32 bytes, as in the JAX package."""
    arr = np.ascontiguousarray(np.asarray(tokens, np.int32).ravel())
    out: List[bytes] = []
    h = seed
    for k in range(arr.shape[0] // block_size):
        d = hashlib.blake2b(h, digest_size=16)
        d.update(arr[k * block_size:(k + 1) * block_size].tobytes())
        h = d.digest()
        out.append(h)
    return out


class BlockPool:
    """Refcounted free-list allocator over ``n_blocks`` usable KV blocks,
    ids ``1 .. n_blocks`` (0 is the scratch block)."""

    def __init__(self, n_blocks: int, block_size: int,
                 name: str = "") -> None:
        if n_blocks < 1:
            raise ValueError(f"BlockPool needs >= 1 usable block, "
                             f"got {n_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.capacity = int(n_blocks)
        self.block_size = int(block_size)
        # pop() hands out 1 first
        self._free: List[int] = list(range(n_blocks, 0, -1))
        self._ref: Dict[int, int] = {}       # live block -> refcount >= 1
        self._n_shared = 0                   # live blocks with refcount >= 2
        # content index: chain hash <-> block id (live or cached), and the
        # cached tier in LRU order (oldest first; eviction pops the front)
        self._index: Dict[bytes, int] = {}
        self._hash_of: Dict[int, bytes] = {}
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        self._lock = threading.Lock()
        self.allocs = 0                # blocks taken off the free list
        self.frees = 0                 # blocks returned to the free list
        self.hits = 0                  # prefix-cache block hits
        self.misses = 0                # full blocks looked up and absent
        self.evictions = 0             # cached blocks reclaimed by pressure
        label = name or "pool"
        self.free_gauge = Dashboard.get_or_create_gauge(
            f"KV_BLOCKS_FREE[{label}]")
        self.live_gauge = Dashboard.get_or_create_gauge(
            f"KV_BLOCKS_LIVE[{label}]")
        self.shared_gauge = Dashboard.get_or_create_gauge(
            f"KV_BLOCKS_SHARED[{label}]")
        self.alloc_counter = Dashboard.get_or_create_counter(
            f"BLOCK_ALLOC[{label}]")
        self.free_counter = Dashboard.get_or_create_counter(
            f"BLOCK_FREE[{label}]")
        self.hit_counter = Dashboard.get_or_create_counter(
            f"PREFIX_HITS[{label}]")
        self.miss_counter = Dashboard.get_or_create_counter(
            f"PREFIX_MISSES[{label}]")
        self.evict_counter = Dashboard.get_or_create_counter(
            f"PREFIX_EVICTIONS[{label}]")
        self.free_gauge.set(float(n_blocks))
        self.live_gauge.set(0.0)
        self.shared_gauge.set(0.0)

    # -- sizing -------------------------------------------------------------
    def blocks_needed(self, n_tokens: int) -> int:
        """Blocks covering ``n_tokens`` cache positions."""
        return -(-int(n_tokens) // self.block_size)

    def covers(self, n_tokens: int) -> bool:
        """Whether the pool could ever hold ``n_tokens`` positions."""
        return self.blocks_needed(n_tokens) <= self.capacity

    # -- allocation ---------------------------------------------------------
    @property
    def n_free(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def n_live(self) -> int:
        with self._lock:
            return len(self._ref)

    @property
    def n_cached(self) -> int:
        with self._lock:
            return len(self._cached)

    @property
    def n_shared(self) -> int:
        with self._lock:
            return self._n_shared

    def can_alloc(self, n: int) -> bool:
        """Cached blocks count: they are reclaimable on demand."""
        with self._lock:
            return n <= len(self._free) + len(self._cached)

    def _evict_one_locked(self) -> None:
        block, _ = self._cached.popitem(last=False)
        h = self._hash_of.pop(block)
        del self._index[h]
        self._free.append(block)
        self.evictions += 1
        self.frees += 1

    def alloc(self, n: int) -> List[int]:
        """``n`` fresh block ids (refcount 1), evicting LRU cached blocks
        under free-list pressure; raises if even the cache cannot cover
        it (callers gate on :meth:`can_alloc`)."""
        with self._lock:
            evicted0 = self.evictions
            if n > len(self._free) + len(self._cached):
                raise RuntimeError(
                    f"BlockPool: alloc({n}) with only {len(self._free)} "
                    f"free + {len(self._cached)} cached of {self.capacity}")
            while len(self._free) < n:
                self._evict_one_locked()
            blocks = [self._free.pop() for _ in range(n)]
            for b in blocks:
                self._ref[b] = 1
            self.allocs += n
            evicted = self.evictions - evicted0
            self._update_gauges_locked()
        self.alloc_counter.inc(n)
        if evicted:
            self.evict_counter.inc(evicted)
            self.free_counter.inc(evicted)
        return blocks

    def free(self, blocks: Iterable[int]) -> None:
        """Hard-return sole-owner blocks (the strict API): a shared, a
        cached or a foreign id raises. Refcounting callers ``decref``."""
        blocks = list(blocks)
        with self._lock:
            for b in blocks:
                r = self._ref.get(b)
                if r is None:
                    raise RuntimeError(
                        f"BlockPool: freeing block {b} that is not live "
                        f"(double-free or foreign id)")
                if r != 1:
                    raise RuntimeError(
                        f"BlockPool: freeing block {b} with refcount {r} "
                        f"(shared; use decref)")
                del self._ref[b]
                h = self._hash_of.pop(b, None)
                if h is not None:
                    del self._index[h]
                self._free.append(b)
            self.frees += len(blocks)
            self._update_gauges_locked()
        self.free_counter.inc(len(blocks))

    # -- sharing ------------------------------------------------------------
    def decref(self, blocks: Iterable[int]) -> None:
        """Drop one holder per block. A block reaching refcount 0 goes
        cached if it is content-addressed (most-recent end of the LRU),
        else back to the free list."""
        blocks = list(blocks)
        freed = 0
        with self._lock:
            for b in blocks:
                r = self._ref.get(b)
                if r is None:
                    raise RuntimeError(
                        f"BlockPool: decref on block {b} that is not live "
                        f"(double-decref or foreign id)")
                if r > 1:
                    self._ref[b] = r - 1
                    if r == 2:
                        self._n_shared -= 1
                    continue
                del self._ref[b]
                if b in self._hash_of:
                    self._cached[b] = None
                else:
                    self._free.append(b)
                    freed += 1
            self.frees += freed
            self._update_gauges_locked()
        if freed:
            self.free_counter.inc(freed)

    # -- content addressing -------------------------------------------------
    def register(self, block: int, chain_hash: bytes) -> bool:
        """Index a live, fully written block under its chain hash; False
        (a no-op) when the hash is already indexed. A block that already
        carries another identity raises: addressed content is
        immutable."""
        with self._lock:
            if block not in self._ref:
                raise RuntimeError(
                    f"BlockPool: registering block {block} that is not live")
            if chain_hash in self._index:
                return False
            if block in self._hash_of:
                raise RuntimeError(
                    f"BlockPool: block {block} already content-addressed")
            self._index[chain_hash] = block
            self._hash_of[block] = chain_hash
        return True

    def peek(self, hashes: Sequence[bytes]) -> int:
        """Longest indexed prefix of ``hashes``, with no refcount change
        and no hit/miss accounting."""
        return self.peek_counts(hashes)[0]

    def peek_counts(self, hashes: Sequence[bytes]) -> tuple:
        """``(matched, matched_cached)`` for the longest indexed prefix:
        a matched block in the cached tier still consumes one unit of
        the reclaimable supply when claimed, a live-shared one does
        not."""
        with self._lock:
            m = cached = 0
            for h in hashes:
                b = self._index.get(h)
                if b is None:
                    break
                m += 1
                if b in self._cached:
                    cached += 1
        return m, cached

    def lookup(self, hashes: Sequence[bytes]) -> List[int]:
        """Claim the longest cached prefix: each matched block gains a
        holder (cached blocks reactivate at refcount 1). Counts one hit
        per matched block and one miss per full block past the match."""
        matched: List[int] = []
        with self._lock:
            for h in hashes:
                b = self._index.get(h)
                if b is None:
                    break
                if b in self._cached:
                    del self._cached[b]
                    self._ref[b] = 1
                else:
                    r = self._ref[b]
                    self._ref[b] = r + 1
                    if r == 1:
                        self._n_shared += 1
                matched.append(b)
            self.hits += len(matched)
            self.misses += len(hashes) - len(matched)
            self._update_gauges_locked()
        if matched:
            self.hit_counter.inc(len(matched))
        if len(hashes) > len(matched):
            self.miss_counter.inc(len(hashes) - len(matched))
        return matched

    def indexed_hashes(self, limit: Optional[int] = None) -> List[bytes]:
        """Chain hashes content-addressed here (live or cached), in
        insertion order, optionally capped: a decode replica's dedup
        advertisement. A capped list is weaker, never wrong: an
        unadvertised block crosses the wire and dedups on arrival."""
        with self._lock:
            out = list(self._index)
        return out if limit is None else out[:int(limit)]

    def flush_cache(self) -> int:
        """Drop every content identity and free all cached blocks (the
        pinned snapshot moved: cached K/V of the old params is garbage).
        Live blocks keep running without index entries. Returns the
        blocks freed."""
        with self._lock:
            freed = len(self._cached)
            for b in self._cached:
                self._free.append(b)
            self._cached.clear()
            self._index.clear()
            self._hash_of.clear()
            self.frees += freed
            self._update_gauges_locked()
        if freed:
            self.free_counter.inc(freed)
        return freed

    def _update_gauges_locked(self) -> None:
        self.free_gauge.set(float(len(self._free)))
        self.live_gauge.set(float(len(self._ref)))
        self.shared_gauge.set(float(self._n_shared))

    # -- introspection ------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "block_size": self.block_size,
                "free": len(self._free),
                "live": len(self._ref),
                "cached": len(self._cached),
                "blocks_shared": self._n_shared,
                "allocs": self.allocs,
                "frees": self.frees,
                "prefix_hits": self.hits,
                "prefix_misses": self.misses,
                "prefix_evictions": self.evictions,
            }

    def drift(self) -> Optional[str]:
        """Invariant scan: a violation's description, or None when the
        books balance. Never raises (the watchdog's poll). Free, live and
        cached partition the capacity; a cached block is exactly a
        refcount-0 content-addressed one."""
        with self._lock:
            free = set(self._free)
            if len(free) != len(self._free):
                return (f"duplicate ids in free list "
                        f"({len(self._free)} entries, {len(free)} unique)")
            live = set(self._ref)
            cached = set(self._cached)
            for a, b, what in ((free, live, "free and live"),
                               (free, cached, "free and cached"),
                               (live, cached, "live and cached")):
                both = a & b
                if both:
                    return (f"{len(both)} id(s) both {what}: "
                            f"{sorted(both)[:8]}")
            if len(free) + len(live) + len(cached) != self.capacity:
                return (f"leak: {len(free)} free + {len(live)} live + "
                        f"{len(cached)} cached != capacity {self.capacity}")
            if any(SCRATCH_BLOCK in s for s in (free, live, cached)):
                return "scratch block entered circulation"
            bad = [b for b, r in self._ref.items() if r < 1]
            if bad:
                return f"live block(s) with refcount < 1: {sorted(bad)[:8]}"
            shared = sum(1 for r in self._ref.values() if r >= 2)
            if shared != self._n_shared:
                return (f"shared-count skew: {self._n_shared} tracked, "
                        f"{shared} actual")
            if set(self._hash_of) != {b for b in self._index.values()}:
                return "content index and hash map disagree on blocks"
            for h, b in self._index.items():
                if self._hash_of.get(b) != h:
                    return f"content index not a bijection at block {b}"
            unindexed = cached - set(self._hash_of)
            if unindexed:
                return (f"cached block(s) without a content identity: "
                        f"{sorted(unindexed)[:8]}")
            stray = set(self._hash_of) - live - cached
            if stray:
                return (f"content-addressed block(s) neither live nor "
                        f"cached: {sorted(stray)[:8]}")
        return None

    def check(self) -> None:
        """:meth:`drift` as an assertion (tests)."""
        msg = self.drift()
        if msg is not None:
            raise AssertionError(f"BlockPool: {msg}")
