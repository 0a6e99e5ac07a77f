"""Paged KV cache pool: fixed block inventory shared by all requests (port
of ``repro.serve.paged_kv``).

The pool owns the device tensors ([L, n_blocks, block_size, Hkv, hd] per
K/V, plus f32 scale planes for FP8 layouts) and a host-side allocator in
plain Python and numpy.  Requests hold block sets; the engine passes
per-slot block tables into the paged forwards (``models.decoder``), which
gather and scatter through them, writing the pool in place.  Allocation
and free are host-side and O(blocks); the device tensors never
reallocate.

Blocks are refcounted so a prefix cache can share one physical block
across many requests.  A block is in exactly one of three states:

  * FREE    — on the free list, contents dead, allocatable.
  * ACTIVE  — refcount >= 1; referenced by at least one block table.
  * CACHED  — refcount == 0 but retained by the :class:`PrefixCache`
              (registered content, evictable under pressure).

``alloc`` hands out FREE blocks at refcount 1; ``free`` is a decref — the
block only leaves the ACTIVE state when the last reference drops, and then
either parks in the cache (if its content is registered) or returns to the
free list.  Classic reserve-at-admission serving never shares blocks, so
every alloc/free pair degenerates to the old exclusive semantics.
"""
from __future__ import annotations

import hashlib
import math
from collections import OrderedDict

import numpy as np


class PoolExhausted(RuntimeError):
    """Raised by ``alloc`` when the pool cannot satisfy a reservation."""


class PagedKVPool:
    """Refcounted block allocator + device storage for the paged KV cache.

    ``data`` is a dict of device tensors (leading dims [L, n_blocks,
    block_size]): "k"/"v" pages and, for FP8 layouts, "k_scale"/"v_scale"
    f32 planes; FP8 pages always travel with their scales.  The paged
    forwards write these tensors in place (the reference donates them and
    replaces ``data`` after each step).
    """

    def __init__(self, data: dict, block_size: int, n_shards: int = 1):
        self.data = data
        self.block_size = int(block_size)
        # tensor parallelism: ``data`` holds this rank's KV heads, one of
        # ``n_shards`` equal tiles of the pool
        self.n_shards = int(n_shards)
        self.n_blocks = int(data["k"].shape[1])
        if data["k"].shape[2] != block_size:
            raise ValueError(f"pages {tuple(data['k'].shape)} do not hold "
                             f"blocks of {block_size}")
        self._free = list(range(self.n_blocks - 1, -1, -1))
        self._free_set = set(self._free)
        self._refcnt: dict[int, int] = {}
        self._cached: set[int] = set()
        # set by PrefixCache.attach: called when a block's refcount drops to
        # zero; returning True parks the block in the cache instead of
        # returning it to the free list.
        self._retain_hook = None
        self.peak_used = 0

    # -- capacity ----------------------------------------------------------

    @property
    def fp8(self) -> bool:
        return "k_scale" in self.data

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        """Blocks not on the free list (ACTIVE + CACHED)."""
        return self.n_blocks - len(self._free)

    @property
    def active_blocks(self) -> int:
        """Blocks referenced by at least one block table (refcount >= 1)."""
        return len(self._refcnt)

    @property
    def cached_blocks(self) -> int:
        """Unreferenced blocks retained by the prefix cache."""
        return len(self._cached)

    @property
    def shared_blocks(self) -> int:
        """Blocks referenced by more than one block table."""
        return sum(1 for c in self._refcnt.values() if c > 1)

    def refcount(self, b: int) -> int:
        return self._refcnt.get(b, 0)

    def utilization(self) -> float:
        return self.used_blocks / max(self.n_blocks, 1)

    def occupancy(self) -> tuple[int, int]:
        """(used, capacity) in blocks — the telemetry pool-occupancy pair."""
        return self.used_blocks, self.n_blocks

    def blocks_for(self, n_tokens: int) -> int:
        return max(1, math.ceil(n_tokens / self.block_size))

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def nbytes(self) -> int:
        """Bytes of the whole pool, over every rank."""
        return self.nbytes_per_device() * self.n_shards

    def nbytes_per_device(self) -> int:
        """Bytes one device holds: the pool divided by the KV-head
        sharding under tensor parallelism (``nbytes()`` on one device)."""
        return sum(a.numel() * a.element_size() for a in self.data.values())

    # -- alloc / free ------------------------------------------------------

    def alloc(self, n: int) -> list[int]:
        if not self.can_alloc(n):
            raise PoolExhausted(
                f"need {n} blocks, {len(self._free)} free of {self.n_blocks}")
        ids = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(ids)
        for b in ids:
            self._refcnt[b] = 1
        self.peak_used = max(self.peak_used, self.used_blocks)
        return ids

    def incref(self, ids: list[int]) -> None:
        """Take a reference on blocks that are ACTIVE or CACHED.

        Reviving a CACHED block (a prefix-cache hit on an unreferenced
        entry) moves it back to ACTIVE at refcount 1 without touching its
        device page.
        """
        for b in ids:
            if not (0 <= b < self.n_blocks):
                raise ValueError(f"block id {b} out of range")
            if b in self._free_set:
                raise ValueError(f"incref of free block {b}")
            if b in self._cached:
                self._cached.discard(b)
                self._refcnt[b] = 1
            else:
                self._refcnt[b] += 1

    def free(self, ids: list[int]) -> None:
        """Drop one reference per id; blocks whose count reaches zero go
        back to the free list unless the prefix cache retains them."""
        for b in ids:
            if not (0 <= b < self.n_blocks):
                raise ValueError(f"block id {b} out of range")
            if b in self._free_set:
                raise ValueError(f"double free of block {b}")
            if b in self._cached:
                raise ValueError(f"free of cache-retained block {b}")
            rc = self._refcnt[b] - 1
            if rc > 0:
                self._refcnt[b] = rc
                continue
            del self._refcnt[b]
            if self._retain_hook is not None and self._retain_hook(b):
                self._cached.add(b)
            else:
                self._free.append(b)
                self._free_set.add(b)

    def reclaim(self, ids: list[int]) -> None:
        """Move CACHED blocks to the free list (prefix-cache eviction)."""
        for b in ids:
            if b not in self._cached:
                raise ValueError(f"reclaim of non-cached block {b}")
            self._cached.discard(b)
            self._free.append(b)
            self._free_set.add(b)

    def truncate_to(self, block_ids: list[int],
                    n_tokens: int) -> tuple[list[int], list[int]]:
        """Release the tail of a block list not needed to hold ``n_tokens``.

        The speculative engine's KV-rollback primitive: after rejection, a
        request's valid cache length is its ACCEPTED token count, so any
        trailing blocks holding only proposed-and-rejected positions can go
        back to the free list (device pages are not cleared — validity is
        the length mask; a freed block's contents are dead the moment no
        block table references it).  ``n_tokens == 0`` frees every block.
        Returns (kept_ids, freed_ids); the caller must replace its block
        list with ``kept_ids``.  With refcounting, "freed" means one
        reference dropped: a shared prefix block survives for its other
        holders (rollback never destroys a block with refcount > 1).
        """
        if n_tokens < 0:
            raise ValueError(f"negative length {n_tokens}")
        keep = min(self.blocks_for(n_tokens) if n_tokens else 0,
                   len(block_ids))
        kept, freed = list(block_ids[:keep]), list(block_ids[keep:])
        if freed:
            self.free(freed)
        return kept, freed

    def stats(self) -> dict:
        return {"n_blocks": self.n_blocks, "block_size": self.block_size,
                "used_blocks": self.used_blocks,
                "active_blocks": self.active_blocks,
                "cached_blocks": self.cached_blocks,
                "shared_blocks": self.shared_blocks,
                "peak_used_blocks": self.peak_used,
                "utilization": self.utilization(),
                "peak_utilization": self.peak_used / max(self.n_blocks, 1),
                "fp8": self.fp8, "pool_bytes": self.nbytes(),
                "pool_bytes_per_device": self.nbytes_per_device()}


def _chain_key(parent: bytes, tokens: np.ndarray) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(parent)
    h.update(np.asarray(tokens, np.int32).tobytes())
    return h.digest()


class _CacheEntry:
    __slots__ = ("block", "parent", "tokens")

    def __init__(self, block: int, parent: bytes, tokens: np.ndarray):
        self.block = block
        self.parent = parent
        self.tokens = np.asarray(tokens, np.int32).copy()


class PrefixCache:
    """Content-hashed block-granular prefix cache over a :class:`PagedKVPool`.

    Keys are chain hashes: ``key_i = H(key_{i-1} || tokens_of_block_i)``
    with the root seeded from the quantization signature and block size, so
    a full-block key commits to the ENTIRE token prefix and the numerics
    config.  Entries additionally store their own tokens and parent key and
    are re-verified on lookup, so a hash collision degrades to a miss, never
    to wrong KV.

    Sharing is bitwise-sound because paged prefill (``prefill_mode="paged"``)
    computes every block's pool content as a pure function of its token
    prefix: chunks replay through the token-scope verify forward against
    the pool itself, so a consumer that skips a hit block sees exactly the
    bytes it would have computed.

    Lifecycle: ``acquire`` increfs hit blocks into a request's table;
    ``register`` records a request's freshly prefilled full blocks; when the
    last reference drops the pool parks registered blocks here (LRU order)
    instead of freeing them; ``evict`` pops LRU entries back to the free
    list under pressure.
    """

    def __init__(self, pool: PagedKVPool, qsig: str):
        self.pool = pool
        self.root = _chain_key(b"root",
                               np.frombuffer(
                                   hashlib.blake2b(
                                       f"{qsig}|bs={pool.block_size}"
                                       .encode(), digest_size=16).digest(),
                                   dtype=np.uint8).astype(np.int32))
        self._entries: dict[bytes, _CacheEntry] = {}
        self._by_block: dict[int, bytes] = {}
        self._lru: OrderedDict[bytes, None] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        pool._retain_hook = self._retain

    # -- pool callback -----------------------------------------------------

    def _retain(self, block: int) -> bool:
        key = self._by_block.get(block)
        if key is None:
            return False
        self._lru[key] = None
        self._lru.move_to_end(key)
        return True

    # -- lookup / acquire --------------------------------------------------

    def _walk(self, tokens: np.ndarray, max_blocks: int):
        """Yield (key, entry) for the longest verified chain of full-block
        hits over ``tokens``, capped at ``max_blocks``."""
        bs = self.pool.block_size
        key = self.root
        out = []
        for i in range(min(len(tokens) // bs, max_blocks)):
            blk = np.asarray(tokens[i * bs:(i + 1) * bs], np.int32)
            k = _chain_key(key, blk)
            e = self._entries.get(k)
            if e is None or e.parent != key or not np.array_equal(e.tokens, blk):
                break
            out.append((k, e))
            key = k
        return out

    def lookup(self, tokens) -> int:
        """Number of leading full blocks of ``tokens`` available for reuse
        (non-acquiring; capped so the final position is always recomputed)."""
        tokens = np.asarray(tokens, np.int32)
        cap = max(0, (len(tokens) - 1) // self.pool.block_size)
        return len(self._walk(tokens, cap))

    def acquire(self, tokens) -> list[int]:
        """Take references on the longest cached prefix of ``tokens``.

        Returns the hit block ids, in prefix order.  At least the last
        prompt position is always left to recompute so the prefill has
        logits to sample the first token from.  Counts hits/misses over
        the full-block prefix for telemetry.
        """
        tokens = np.asarray(tokens, np.int32)
        bs = self.pool.block_size
        cap = max(0, (len(tokens) - 1) // bs)
        chain = self._walk(tokens, cap)
        ids = [e.block for _, e in chain]
        self.pool.incref(ids)
        for k, _ in chain:
            self._lru.pop(k, None)
        self.hits += len(ids)
        self.misses += max(0, cap - len(ids))
        return ids

    # -- registration ------------------------------------------------------

    def register(self, tokens, block_ids: list[int]) -> int:
        """Record the full-block prefix of a freshly prefilled context.

        ``block_ids[i]`` must hold tokens ``[i*bs, (i+1)*bs)`` of
        ``tokens``.  Blocks whose chain key is already registered (the
        request acquired them as hits, or a sibling won the race) are
        skipped; a block can back at most one entry.  Returns the number
        of newly registered blocks.
        """
        tokens = np.asarray(tokens, np.int32)
        bs = self.pool.block_size
        key = self.root
        added = 0
        for i in range(min(len(tokens) // bs, len(block_ids))):
            blk = tokens[i * bs:(i + 1) * bs]
            k = _chain_key(key, blk)
            if k not in self._entries:
                b = block_ids[i]
                if b not in self._by_block:
                    self._entries[k] = _CacheEntry(b, key, blk)
                    self._by_block[b] = k
                    added += 1
            key = k
        return added

    # -- eviction ----------------------------------------------------------

    @property
    def evictable(self) -> int:
        return len(self._lru)

    def evict(self, n: int) -> list[int]:
        """Drop up to ``n`` LRU unreferenced entries; their blocks return
        to the pool free list.  Returns the reclaimed block ids."""
        out = []
        while self._lru and len(out) < n:
            key, _ = self._lru.popitem(last=False)
            e = self._entries.pop(key)
            del self._by_block[e.block]
            out.append(e.block)
        if out:
            self.pool.reclaim(out)
            self.evictions += len(out)
        return out

    def drop_block(self, block: int) -> None:
        """Deregister a block (copy-on-write: its content is about to
        diverge from the registered tokens).  ACTIVE blocks just lose
        their entry; CACHED blocks also return to the free list."""
        key = self._by_block.pop(block, None)
        if key is None:
            return
        self._entries.pop(key, None)
        self._lru.pop(key, None)
        if block in self.pool._cached:
            self.pool.reclaim([block])

    def stats(self) -> dict:
        return {"entries": len(self._entries), "evictable": len(self._lru),
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}
