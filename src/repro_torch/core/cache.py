"""Block cache + pinned L0: the store's memory-management accounting.

Counterpart of ``repro.core.cache``.  The paper's
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

``BlockCacheView``
    A shard's lens over one shared ``BlockCache`` (the sharded facade):
    every key is namespaced ``((shard, run_id), block_id)``, admissions
    beyond the view's budget evict only that namespace's cold entries, and
    ``retain``/``set_pinned``/``clear`` touch only that namespace, so one
    shard's invalidation never drops a sibling's live blocks.

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

# (run_id, block_id); in sharded use the run id is ``(shard, run_id)``,
# minted by BlockCacheView, so shards never alias each other's blocks
CacheKey = Tuple[int, int]


def _ns_of(key: CacheKey):
    """Namespace of a cache key: ``None`` for plain (unsharded) run ids."""
    rid = key[0]
    return rid[0] if isinstance(rid, tuple) else None


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
        # Sharded use: per-namespace charged-byte budgets.  With none
        # registered the cache has one budget and one eviction domain.
        # ``_ns_keys`` mirrors ``_entries``'s order per namespace, so a
        # namespace's eviction never rescans its siblings' entries.
        self._ns_budget: Dict = {}
        self._ns_bytes: Dict = {}
        self._ns_keys: Dict = {}   # ns -> OrderedDict[key, None], hand order
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # Optional Telemetry: every 512th eviction emits a "cache_pressure"
        # event (the trace's mutex is a leaf lock, safe under this one's).
        self.telemetry = None

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
        ns = _ns_of(key) if self._ns_budget else None
        budget = self._ns_budget.get(ns, self.capacity_bytes)
        if nbytes <= 0 or nbytes > budget:
            return  # uncacheable (oversized block, or cache disabled)
        if ns is not None:
            # the namespace's budget first: one shard's pressure evicts only
            # its own cold entries, never a sibling's working set
            while (self._ns_bytes.get(ns, 0) + nbytes > budget
                   and self._evict_one_ns(ns)):
                pass
            if self._ns_bytes.get(ns, 0) + nbytes > budget:
                return  # nothing evictable left in this namespace
        # the global budget (the only loop in unsharded use)
        while self._bytes + nbytes > self.capacity_bytes and self._entries:
            self._evict_one()
        self._entries[key] = [nbytes, 0]
        self._bytes += nbytes
        if ns is not None:
            self._ns_bytes[ns] = self._ns_bytes.get(ns, 0) + nbytes
            self._ns_keys.setdefault(ns, OrderedDict())[key] = None

    def _drop_entry(self, key: CacheKey) -> None:
        nb = self._entries.pop(key)[0]
        self._bytes -= nb
        ns = _ns_of(key)
        if ns is not None:
            if ns in self._ns_bytes:
                self._ns_bytes[ns] -= nb
            nsk = self._ns_keys.get(ns)
            if nsk is not None:
                nsk.pop(key, None)
        self.evictions += 1
        tel = self.telemetry
        if tel is not None and self.evictions % 512 == 0:
            tel.emit("cache_pressure", evictions=self.evictions,
                     charged_bytes=self._bytes,
                     capacity_bytes=self.capacity_bytes)

    def _evict_one(self) -> None:
        if self.policy == "lru":
            self._drop_entry(next(iter(self._entries)))
            return
        # CLOCK: sweep from the hand, granting second chances.
        while True:
            key, e = next(iter(self._entries.items()))
            if e[1]:
                e[1] = 0
                self._entries.move_to_end(key)
            else:
                self._drop_entry(key)
                return

    def _evict_one_ns(self, ns) -> bool:
        """Evict one cold entry of ``ns`` (the same policy, its eviction
        domain the namespace; other namespaces' entries are neither touched
        nor reordered), walking the namespace's own order.  False when the
        namespace holds nothing evictable."""
        nsk = self._ns_keys.get(ns)
        if not nsk:
            return False
        if self.policy == "lru":
            self._drop_entry(next(iter(nsk)))
            return True
        # CLOCK within the namespace: a hot entry is cleared and moved to
        # the back of both orders; if all were hot, the hand wraps to the
        # (now cold) oldest one
        for _ in range(len(nsk)):
            key = next(iter(nsk))
            e = self._entries[key]
            if e[1]:
                e[1] = 0
                self._entries.move_to_end(key)
                nsk.move_to_end(key)
            else:
                self._drop_entry(key)
                return True
        self._drop_entry(next(iter(nsk)))
        return True

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
            ns = _ns_of(key)
            if ns is not None:
                if ns in self._ns_bytes:
                    self._ns_bytes[ns] -= e[0]
                nsk = self._ns_keys.get(ns)
                if nsk is not None:
                    nsk.pop(key, None)

    # ------------------------------------------------------------- namespaces
    def set_ns_budget(self, ns, budget_bytes: int) -> None:
        """Register a namespace's charged-byte budget (one namespace a
        shard, the budgets summing to ``capacity_bytes``)."""
        self._ns_budget[ns] = int(budget_bytes)

    def ns_charged_bytes(self, ns) -> int:
        with self._mu:
            return self._ns_bytes.get(ns, 0)

    def ns_pinned_bytes(self, ns) -> int:
        with self._mu:
            return sum(nb for k, nb in self._pinned.items()
                       if _ns_of(k) == ns)

    def set_pinned_ns(self, ns, blocks: Dict[CacheKey, int]) -> None:
        """:meth:`set_pinned` for ``ns`` only: other namespaces' pinned
        blocks stay (a shard's L0 repin never wipes a sibling's)."""
        with self._mu:
            kept = {k: nb for k, nb in self._pinned.items()
                    if _ns_of(k) != ns}
            kept.update(blocks)
            self._pinned = kept
            self._pinned_bytes = sum(kept.values())
            for key in blocks:
                self._unadmit(key)

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

    def retain_ns(self, ns, live_raw_ids: Iterable[int]) -> None:
        """:meth:`retain` for ``ns`` only: a shard knows only its own live
        run ids, so an unscoped retain would drop every sibling's blocks."""
        with self._mu:
            live = set(live_raw_ids)
            for k in [k for k in self._ns_keys.get(ns, ())
                      if k[0][1] not in live]:
                self._unadmit(k)
            for k in [k for k in self._pinned
                      if _ns_of(k) == ns and k[0][1] not in live]:
                self._pinned_bytes -= self._pinned.pop(k)

    def clear_ns(self, ns) -> None:
        """Drop one namespace's entries and pins (a shard's recovery)."""
        with self._mu:
            for k in list(self._ns_keys.get(ns, ())):
                self._unadmit(k)
            for k in [k for k in self._pinned if _ns_of(k) == ns]:
                self._pinned_bytes -= self._pinned.pop(k)
            self._ns_bytes.pop(ns, None)
            self._ns_keys.pop(ns, None)

    def clear(self) -> None:
        """Drop everything (process restart: DRAM contents are volatile)."""
        with self._mu:
            self._entries.clear()
            self._pinned.clear()
            self._bytes = 0
            self._pinned_bytes = 0
            self._ns_bytes.clear()
            self._ns_keys.clear()


class BlockCacheView:
    """A shard's namespaced, budgeted lens over a shared BlockCache.

    Speaks the cache protocol ``LSMStore`` and ``PinnedLevelManager`` use
    (``read_block``/``read_blocks``/``read_block_span``/``retain``/
    ``set_pinned``/``clear``/``__contains__``) with every key namespaced
    ``((namespace, run_id), block_id)``.  Hit, miss and eviction counters
    are the shared cache's (one cache, one hit rate); ``charged_bytes`` and
    ``pinned_bytes`` are the namespace's slice.
    """

    def __init__(self, cache: BlockCache, namespace, budget_bytes: int):
        self.cache = cache
        self.namespace = namespace
        self.budget_bytes = int(budget_bytes)
        cache.set_ns_budget(namespace, budget_bytes)

    def resize(self, budget_bytes: int) -> None:
        """Retarget the namespace's admission budget.  Entries over it are
        not dropped at once: the namespace's own later admissions shed
        them, so a budget shuffle never costs a cold sibling its working
        set up front."""
        self.budget_bytes = int(budget_bytes)
        self.cache.set_ns_budget(self.namespace, self.budget_bytes)

    # ---------------------------------------------------- cache protocol
    def read_block(self, run_id, block_id: int, nbytes: int,
                   stats: IOStats) -> bool:
        return self.cache.read_block((self.namespace, run_id), block_id,
                                     nbytes, stats)

    def read_blocks(self, run_id, block_ids, block_bytes,
                    stats: IOStats) -> int:
        return self.cache.read_blocks((self.namespace, run_id), block_ids,
                                      block_bytes, stats)

    def read_block_span(self, run_id, first_block: int, last_block: int,
                        block_bytes, stats: IOStats) -> int:
        return self.cache.read_block_span((self.namespace, run_id),
                                          first_block, last_block,
                                          block_bytes, stats)

    def retain(self, live_run_ids: Iterable[int]) -> None:
        self.cache.retain_ns(self.namespace, live_run_ids)

    def set_pinned(self, blocks: Dict[CacheKey, int]) -> None:
        self.cache.set_pinned_ns(
            self.namespace,
            {((self.namespace, rid), bid): nb
             for (rid, bid), nb in blocks.items()})

    def clear(self) -> None:
        self.cache.clear_ns(self.namespace)

    def __contains__(self, key: CacheKey) -> bool:
        return ((self.namespace, key[0]), key[1]) in self.cache

    # ------------------------------------------------- shared accounting
    # PinnedLevelManager counts residency misses under the cache's mutex
    # and bumps the shared miss counter; cache_summary reads the rest.
    @property
    def _mu(self):
        return self.cache._mu

    @property
    def hits(self) -> int:
        return self.cache.hits

    @property
    def misses(self) -> int:
        return self.cache.misses

    @misses.setter
    def misses(self, v: int) -> None:
        self.cache.misses = v

    @property
    def evictions(self) -> int:
        return self.cache.evictions

    def hit_rate(self) -> float:
        return self.cache.hit_rate()

    @property
    def charged_bytes(self) -> int:
        return self.cache.ns_charged_bytes(self.namespace)

    @property
    def pinned_bytes(self) -> int:
        return self.cache.ns_pinned_bytes(self.namespace)


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
