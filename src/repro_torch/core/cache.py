"""Block cache + pinned L0: the store's memory-management accounting.

Counterpart of ``repro.core.cache`` for one store (the sharded facade's
namespaced views and per-namespace budgets are not ported).  The paper's
second idea beside Garnering is that a *small bounded amount of DRAM* can
absorb most of the read cost of the upper tree: the first level is kept
resident, and a shared block cache serves the hot tail of the deeper
levels.

``BlockCache``
    A charged-bytes cache of ``(run_id, block_id)`` entries with two
    eviction policies, ``"lru"`` (exact recency order) and ``"clock"``
    (second chance: a hit sets a reference bit; the eviction hand clears
    bits until it finds a cold entry).  Every block read of the store goes
    through :meth:`read_block`/:meth:`read_blocks`, which record a hit
    (``IOStats.cache_hit_blocks``; no block I/O charged) or a miss
    (``cache_miss_blocks`` + ``blocks_read``) and admit the block.

``PinnedLevelManager``
    Keeps level-0 runs resident: after every commit it re-derives the pin
    set from the current L0, newest run first, admitting whole runs while
    they fit ``pin_l0_bytes``.  Pinned blocks live outside the eviction
    order and are charged to the pin budget, not ``cache_bytes``.  Pinning
    on the flush path is free; repinning on recovery or on attaching a
    cache to a live store charges a miss and a block read per block.

This is the reference's accounting model, on the host: the runs themselves
stay in device memory whatever the cache decides, so a "hit" is a block
read the model does not charge, not a transfer that was avoided.  Cached
blocks are keyed by immutable run id and can never go stale; after each
commit the store calls :meth:`BlockCache.retain` with the ids still live
in ``RunStorage``, then ``PinnedLevelManager.repin`` with the new L0.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .types import IOStats

CacheKey = Tuple[int, int]      # (run_id, block_id)


class BlockCache:
    """Charged-bytes block cache with LRU or CLOCK (second-chance)
    eviction.

    Thread-safety: one reentrant mutex guards the eviction order, the
    pinned set and the byte/hit counters, so reader threads admitting
    blocks race safely with the scheduler's post-install :meth:`retain`
    and :meth:`set_pinned` (batched reads take the lock once per batch).
    """

    def __init__(self, capacity_bytes: int, policy: str = "clock"):
        if policy not in ("lru", "clock"):
            raise ValueError(f"unknown cache policy {policy!r}")
        self.capacity_bytes = int(capacity_bytes)
        self.policy = policy
        self._mu = threading.RLock()
        # Eviction order: front = next eviction candidate.  CLOCK entries
        # carry a reference bit; the "hand" is the front of the same ordered
        # dict (a second chance moves the entry to the back, bit cleared).
        self._entries: "OrderedDict[CacheKey, List[int]]" = OrderedDict()
        self._pinned: Dict[CacheKey, int] = {}  # key -> nbytes (L0 residency)
        self._bytes = 0          # charged bytes, evictable entries only
        self._pinned_bytes = 0   # charged bytes, pinned entries
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -------------------------------------------------------------- accounting
    @property
    def charged_bytes(self) -> int:
        return self._bytes

    @property
    def pinned_bytes(self) -> int:
        return self._pinned_bytes

    def __len__(self) -> int:
        return len(self._entries) + len(self._pinned)

    def __contains__(self, key: CacheKey) -> bool:
        return key in self._pinned or key in self._entries

    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    # ------------------------------------------------------------------- reads
    def read_block(self, run_id: int, block_id: int, nbytes: int,
                   stats: IOStats) -> bool:
        """Account one block read through the cache; True on a hit (no
        block I/O charged).  A miss is charged to ``stats.blocks_read`` and
        admitted, evicting cold entries to stay within ``capacity_bytes``."""
        with self._mu:
            key = (run_id, block_id)
            if key in self._pinned:
                self.hits += 1
                stats.cache_hit_blocks += 1
                return True
            e = self._entries.get(key)
            if e is not None:
                self.hits += 1
                stats.cache_hit_blocks += 1
                if self.policy == "lru":
                    self._entries.move_to_end(key)
                else:
                    e[1] = 1  # clock reference bit
                return True
            self.misses += 1
            stats.cache_miss_blocks += 1
            stats.blocks_read += 1
            self._admit(key, nbytes)
            return False

    def read_blocks(self, run_id: int, block_ids, block_bytes,
                    stats: IOStats) -> int:
        """:meth:`read_block` once per id in order (the same hit and miss
        decisions and admission sequence), with the lock and the counters
        taken once for the batch; ``block_bytes(bid)`` is asked only on a
        miss.  Returns the number of hits."""
        with self._mu:
            pinned = self._pinned
            entries = self._entries
            lru = self.policy == "lru"
            move = entries.move_to_end
            get = entries.get
            hits = misses = 0
            for bid in block_ids:
                key = (run_id, bid)
                if key in pinned:
                    hits += 1
                    continue
                e = get(key)
                if e is not None:
                    hits += 1
                    if lru:
                        move(key)
                    else:
                        e[1] = 1
                    continue
                misses += 1
                self._admit(key, block_bytes(bid))
            self.hits += hits
            self.misses += misses
            stats.cache_hit_blocks += hits
            stats.cache_miss_blocks += misses
            stats.blocks_read += misses
            return hits

    def read_block_span(self, run_id: int, first_block: int, last_block: int,
                        block_bytes, stats: IOStats) -> int:
        """Charge the contiguous span [first_block, last_block] (an
        iterator cursor's advance) in one call.  Returns the hit count."""
        if last_block < first_block:
            return 0
        return self.read_blocks(run_id, range(first_block, last_block + 1),
                                block_bytes, stats)

    # -------------------------------------------------------------- admission
    def _admit(self, key: CacheKey, nbytes: int) -> None:
        nbytes = int(nbytes)
        if nbytes <= 0 or nbytes > self.capacity_bytes:
            return  # uncacheable (oversized block, or cache disabled)
        while self._bytes + nbytes > self.capacity_bytes and self._entries:
            self._evict_one()
        self._entries[key] = [nbytes, 0]
        self._bytes += nbytes

    def _evict_one(self) -> None:
        if self.policy == "lru":
            key = next(iter(self._entries))
        else:
            # CLOCK: sweep from the hand, granting second chances.
            while True:
                key, e = next(iter(self._entries.items()))
                if not e[1]:
                    break
                e[1] = 0
                self._entries.move_to_end(key)
        self._bytes -= self._entries.pop(key)[0]
        self.evictions += 1

    def resize(self, capacity_bytes: int) -> None:
        """Set a new capacity and evict down to it; surviving entries keep
        serving hits."""
        with self._mu:
            self.capacity_bytes = int(capacity_bytes)
            while self._bytes > self.capacity_bytes and self._entries:
                self._evict_one()

    # ------------------------------------------------------------- pin control
    def set_pinned(self, blocks: Dict[CacheKey, int]) -> None:
        """Replace the pinned set (the resident L0) wholesale.  Newly
        pinned blocks leave the evictable order (their bytes move from the
        cache budget to the pin budget); blocks leaving the set lose
        residency and re-enter the cache on demand."""
        with self._mu:
            self._pinned = dict(blocks)
            self._pinned_bytes = sum(self._pinned.values())
            for key in self._pinned:
                self._unadmit(key)

    def _unadmit(self, key: CacheKey) -> None:
        """Remove an evictable entry (not an eviction: no counter charge)."""
        e = self._entries.pop(key, None)
        if e is not None:
            self._bytes -= e[0]

    # ------------------------------------------------------------ invalidation
    def retain(self, live_run_ids: Iterable[int]) -> None:
        """Drop every cached block belonging to a run that no longer
        exists."""
        with self._mu:
            live = set(live_run_ids)
            for k in [k for k in self._entries if k[0] not in live]:
                self._unadmit(k)
            for k in [k for k in self._pinned if k[0] not in live]:
                self._pinned_bytes -= self._pinned.pop(k)

    def clear(self) -> None:
        """Drop everything (process restart: DRAM contents are volatile)."""
        with self._mu:
            self._entries.clear()
            self._pinned.clear()
            self._bytes = 0
            self._pinned_bytes = 0


class PinnedLevelManager:
    """Keeps L0 runs resident in the block cache within ``pin_l0_bytes``."""

    def __init__(self, cache: BlockCache, pin_l0_bytes: int):
        self.cache = cache
        self.pin_l0_bytes = int(pin_l0_bytes)
        self.pinned_run_ids: List[int] = []

    def repin(self, l0_runs: Sequence,
              stats: Optional[IOStats] = None) -> None:
        """Re-derive the pin set from the current L0, newest run first:
        whole runs are admitted while they fit the budget (a run that does
        not fit is skipped; an older, smaller one may still fit).

        ``stats=None`` (the flush/compaction path) pins for free.  With
        ``stats`` (recovery, or attaching a cache to a live store) every
        pinned block not already cached is charged one miss and one block
        read.
        """
        budget = self.pin_l0_bytes
        blocks: Dict[CacheKey, int] = {}
        pinned_ids: List[int] = []
        for run in reversed(list(l0_runs)):
            if len(run) == 0 or run.data_bytes > budget:
                continue
            budget -= run.data_bytes
            pinned_ids.append(run.run_id)
            for bid in range(run.n_blocks):
                blocks[(run.run_id, bid)] = run.block_bytes(bid)
        if stats is not None:
            with self.cache._mu:
                missing = sum(1 for key in blocks if key not in self.cache)
                self.cache.misses += missing
            stats.cache_miss_blocks += missing
            stats.blocks_read += missing
        self.pinned_run_ids = pinned_ids
        self.cache.set_pinned(blocks)

    def is_resident(self, run_id: int) -> bool:
        return run_id in self.pinned_run_ids
