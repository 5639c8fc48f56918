"""Sharded keyspace: N independent device stores behind one facade.

Counterpart of ``repro.core.sharded``.

``ShardedLSMStore``
    Order-preserving splitters (``shards - 1`` ascending u64 bounds; key k
    lives in the first shard whose splitter exceeds it, so a key equal to a
    splitter belongs to the upper shard) route every key to one inner
    :class:`LSMStore`.  Each shard owns its WAL and memtable, its manifest
    and runs on the facade's device, and its own ``CompactionScheduler``;
    one worker budget (``compaction_workers`` permits) bounds the
    background jobs in flight across all of them.  Batched operations split
    by one ``np.searchsorted`` on the host and fan out per shard; a range
    read is a shard-ordered concatenation, since shard i's keys all precede
    shard i+1's.

Rebalancing
    With ``rebalance_interval_ops > 0`` the facade counts routed operations
    per shard in a decaying window (with a 32-bucket key histogram per
    shard), and when the max/mean share reaches ``rebalance_ratio`` it
    re-derives the splitters as load-weighted key quantiles over the
    shards' runs.  Data moves by cross-shard run migration: quiesce, export
    each shard's leaving range (columns on the device), split it on the
    device against the order-mapped new splitters and build it as an L0 run
    in each destination, log and publish the new routing, then strip every
    source to its new range.  Readers never block: the routing is one
    immutable ``_Routing`` swapped by reference, and a reader retries iff
    it moved mid-read.  Snapshots carry their routing and pin their runs,
    so they survive any number of rebalances.

Shared cache
    All shards share one budgeted :class:`BlockCache` through namespaced
    :class:`BlockCacheView` s (``cache_bytes / N`` each, re-sliced by load
    at every rebalance) and a ``pin_l0_bytes / N`` pinned L0 each.  It is
    host accounting only: the runs stay on the device.

On the device
    Every shard runs on the facade's device (``cuda:0`` unless the caller
    names another, the CPU only on request).  Each shard's worker sets its
    thread's CUDA device and launches on that device's default stream, the
    foreground's, so N workers and the foreground stay ordered with no
    event.  A migration keeps the source and destination copies on the
    device together until the strip.

Differential contract
    The plain store is the oracle: for any operation sequence every read
    returns the same answer, since each key's operations land on one shard
    in program order.  ``shards=1`` is the plain store bit for bit.

Concurrency
    One foreground thread writes; readers are lock-free per shard.  A
    rebalance runs on a foreground thread under the facade's write gate,
    never on a worker, whose ``on_idle`` hook only flags imbalance.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from bisect import bisect_left, bisect_right
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from .cache import BlockCache, BlockCacheView
from .engine import LSMConfig, LSMStore, resolve_device
from .manifest import Version
from .run import build_run
from .scheduler import CompactJob, WorkerBudget
from .tuner import TunerStep
from .types import KEY_DTYPE, IOStats

_KEY_SPACE_END = 1 << 64
_HIST_B = 32                 # buckets per shard in the load histogram


def uniform_splitters(shards: int, key_space: int = 1 << 64
                      ) -> Tuple[int, ...]:
    """``shards - 1`` ascending bounds splitting ``[0, key_space)`` evenly.

    The default (the whole u64 space) suits keys hashed over all of it
    (YCSB's scrambled keys); dense key ranges pass their own
    ``key_space``.
    """
    return tuple(key_space * (i + 1) // shards for i in range(shards - 1))


class _Routing:
    """One immutable routing epoch: the splitters and their derived forms
    (a uint64 array for the host split, and per device the order-mapped
    int64 tensor a migration splits its device columns against)."""

    __slots__ = ("lst", "arr", "epoch", "n", "_on_device")

    def __init__(self, splitters: Sequence[int], epoch: int = 0):
        self.lst = [int(x) for x in splitters]
        self.arr = np.asarray(self.lst, dtype=KEY_DTYPE)
        self.epoch = int(epoch)
        self.n = len(self.lst) + 1
        self._on_device = {}

    def shard_of(self, key: int) -> int:
        return bisect_right(self.lst, int(key))

    def split(self, keys_arr: np.ndarray) -> np.ndarray:
        """Shard of every key of a batch: one searchsorted on the host."""
        return np.searchsorted(self.arr, keys_arr, side="right")

    def split_on_device(self, keys: torch.Tensor) -> torch.Tensor:
        """Shard of every order-mapped key of a device column: one
        ``torch.searchsorted(right=True)`` against the order-mapped
        splitters (the map keeps u64 order in int64)."""
        dev = keys.device
        sp = self._on_device.get(dev)
        if sp is None:
            sp = torch.tensor([ops.order_of(s) for s in self.lst],
                              dtype=torch.int64, device=dev)
            self._on_device[dev] = sp
        return torch.searchsorted(sp, keys, right=True)

    def bounds(self, si: int) -> Tuple[int, int]:
        """Shard ``si``'s key range ``[lo, hi)`` (``hi`` may be 2**64)."""
        lo = self.lst[si - 1] if si > 0 else 0
        hi = self.lst[si] if si < self.n - 1 else _KEY_SPACE_END
        return lo, hi


@dataclasses.dataclass(frozen=True)
class ShardedSnapshot:
    """One pinned :class:`Version` per shard, in shard order, and the
    routing they were taken under: snapshot reads route with *their*
    splitters, and the pins keep migrated-away runs alive."""
    versions: Tuple[Version, ...]
    routing: Optional[_Routing] = None


class ShardedLSMStore:
    """Range-partitioned facade over ``config.shards`` device stores.

    Construct through :func:`make_store`.  Every shard shares the facade's
    *live* ``LSMConfig`` object, so runtime knobs (the write-pressure
    triggers, the rebalance knobs, the tuner's) reach every shard; the
    fields that differ per shard (cache and pin budgets, worker counts)
    were consumed at construction.
    """

    def __init__(self, config: Optional[LSMConfig] = None, device=None):
        self.config = config or LSMConfig(shards=2)
        self.device = resolve_device(device)
        n = max(1, int(self.config.shards))
        splitters = self.config.shard_splitters
        if splitters is None:
            splitters = uniform_splitters(n)
        splitters = [int(s) for s in splitters]
        if len(splitters) != n - 1:
            raise ValueError(
                f"need {n - 1} splitters for {n} shards, got {len(splitters)}")
        if splitters != sorted(set(splitters)):
            raise ValueError("splitters must be strictly ascending")
        # Routing epoch 0 and its durable log: a routing commit syncs at
        # once; crash() keeps the synced prefix, recover() the last epoch.
        self._routing = _Routing(splitters, epoch=0)
        self._routing_log: List[Tuple[int, ...]] = [tuple(splitters)]
        self._routing_synced = 1
        # at most `compaction_workers` background jobs across all shards
        # (each shard keeps its one-job-at-a-time turnstile); resizable by
        # the tuner at quiesce boundaries
        self._budget = None
        if self.config.async_compaction:
            self._budget = WorkerBudget(
                max(1, int(self.config.compaction_workers)))
        shard_cfg = dataclasses.replace(
            self.config, shards=1, shard_splitters=None,
            cache_bytes=0, pin_l0_bytes=0,   # the shared cache, below
            compaction_workers=1,            # one worker a shard
            tuner=None)                      # the facade drives the tuner
        self.shards: List[LSMStore] = [
            LSMStore(dataclasses.replace(shard_cfg), device=self.device,
                     scheduler_budget=self._budget, scheduler_offset=i)
            for i in range(n)]
        # The facade's write gate orders snapshot acquisition against
        # facade writes and rebalancing, so a snapshot never pins one shard
        # before a cross-shard batch and another after it.  Reentrant: the
        # batch entry points nest.
        self._write_gate = threading.RLock()
        # Load: the decaying trigger window (halved at each check that does
        # not trigger, reset at a rebalance), the cumulative count, and the
        # window's key histogram per shard.  Plain int bumps without a lock
        # (a heuristic; the read path takes no lock).
        self._load = [0] * n
        self._load_total = [0] * n
        self._load_hist = [np.zeros(_HIST_B) for _ in range(n)]
        self._ops_since_check = 0
        self._rebalance_needed = False
        self._in_rebalance = False
        self.rebalances = 0          # completed rebalances
        self.migrated_entries = 0    # entries moved across shards
        # host seconds of the migrations' four steps, summed over them
        self.migration_s = dict(quiesce=0.0, imports=0.0, commit=0.0,
                                strip=0.0)
        for s in self.shards:
            s.config = self.config       # live config sharing
            if s._scheduler is not None:
                # imbalance detection at drained-queue boundaries (flag only)
                s._scheduler.on_idle = self._on_shard_idle
        self.block_cache: Optional[BlockCache] = None
        if self.config.cache_bytes > 0 or self.config.pin_l0_bytes > 0:
            self._build_shared_cache()
        # the facade is the tuner's one driver (the shards carry tuner=None)
        self._tuner = self.config.tuner
        self._tune_ops = 0
        self._tune_armed = False
        self._tune_prev_shard_stats: Optional[List[IOStats]] = None
        if self._tuner is not None:
            self._tuner.bind(self)

    # ------------------------------------------------------------ partition
    @property
    def _splitters(self) -> np.ndarray:
        return self._routing.arr

    @property
    def splitters(self) -> Tuple[int, ...]:
        """The current routing bounds (they move when a rebalance lands)."""
        return tuple(self._routing.lst)

    def _note_ops(self, si: int, k: int = 1) -> None:
        self._load[si] += k
        self._load_total[si] += k
        self._ops_since_check += k

    def _note_key(self, si: int, key: int) -> None:
        """One key's load note, its histogram bucket included."""
        self._note_ops(si)
        lo, hi = self._routing.bounds(si)
        b = int((key - lo) * _HIST_B / (hi - lo))
        h = self._load_hist[si]
        h[b if 0 <= b < _HIST_B else _HIST_B - 1] += 1.0

    def _note_keys(self, si: int, keys_arr: np.ndarray) -> None:
        """A batch's load note: one bincount feeds the histogram."""
        self._note_ops(si, int(keys_arr.size))
        lo, hi = self._routing.bounds(si)
        b = ((keys_arr.astype(np.float64) - lo)
             * (_HIST_B / float(hi - lo))).astype(np.int64)
        np.clip(b, 0, _HIST_B - 1, out=b)
        self._load_hist[si] += np.bincount(b, minlength=_HIST_B)

    # ---------------------------------------------------------------- cache
    def _build_shared_cache(self) -> None:
        """One budgeted BlockCache; a namespaced view and an L0 pin slice
        per shard."""
        cfg = self.config
        n = len(self.shards)
        self.block_cache = BlockCache(cfg.cache_bytes, cfg.cache_policy)
        self.block_cache.telemetry = cfg.telemetry
        per_cache = cfg.cache_bytes // n
        per_pin = cfg.pin_l0_bytes // n
        for i, s in enumerate(self.shards):
            s.attach_cache(BlockCacheView(self.block_cache, i, per_cache),
                           per_pin)

    def configure_cache(self, cache_bytes: int, pin_l0_bytes: int = 0,
                        policy: Optional[str] = None) -> None:
        """(Re)build the shared cache on a live facade (contents dropped,
        budgets sliced ``1/N``, every shard's L0 repinned); zeros
        detach."""
        self.config.cache_bytes = int(cache_bytes)
        self.config.pin_l0_bytes = int(pin_l0_bytes)
        if policy is not None:
            self.config.cache_policy = policy
        if cache_bytes <= 0 and pin_l0_bytes <= 0:
            self.block_cache = None
            for s in self.shards:
                s.block_cache = None
                s.pinned_l0 = None
            return
        self._build_shared_cache()

    # ------------------------------------------------------------- writes
    def put(self, key: int, value: bytes) -> None:
        with self._write_gate:
            si = self._routing.shard_of(key)
            self.shards[si].put(key, value)
            self._note_key(si, key)
        self._maybe_rebalance()
        if self._tuner is not None:
            self._maybe_tune(1)

    def delete(self, key: int) -> None:
        with self._write_gate:
            si = self._routing.shard_of(key)
            self.shards[si].delete(key)
            self._note_key(si, key)
        self._maybe_rebalance()
        if self._tuner is not None:
            self._maybe_tune(1)

    def put_batch(self, keys, values) -> None:
        """Batched puts, split per shard by one searchsorted; a broadcast
        value (one ``bytes`` for every key) splits in numpy alone."""
        if isinstance(values, (bytes, bytearray)):
            keys_arr = np.asarray(keys, dtype=KEY_DTYPE)
            val = bytes(values)
            with self._write_gate:
                sids = self._routing.split(keys_arr)
                for si in np.unique(sids):
                    sel = keys_arr[sids == si]
                    self.shards[int(si)].put_batch(sel.tolist(), val)
                    self._note_keys(int(si), sel)
            self._maybe_rebalance()
            if self._tuner is not None:
                self._maybe_tune(int(keys_arr.size))
            return
        self.write_batch(zip(keys, values))

    def delete_batch(self, keys) -> None:
        self.write_batch((k, None) for k in keys)

    def write_batch(self, ops_: Iterable[Tuple[int, Optional[bytes]]]) -> None:
        """Batched puts and deletes: one searchsorted gives every operation
        its shard, and each shard takes its sub-batch through its own
        ``write_batch``.  The split is a stable partition, so each key's
        operations keep their order."""
        pairs = list(ops_)
        if not pairs:
            return
        keys_arr = np.fromiter((int(k) for k, _ in pairs), KEY_DTYPE,
                               len(pairs))
        with self._write_gate:
            # split under the gate: the routing must not move between the
            # assignment and the shards' writes
            sids = self._routing.split(keys_arr)
            for si in np.unique(sids):
                idx = np.nonzero(sids == si)[0]
                self.shards[int(si)].write_batch(pairs[int(j)] for j in idx)
                self._note_keys(int(si), keys_arr[idx])
        self._maybe_rebalance()
        if self._tuner is not None:
            self._maybe_tune(len(pairs))

    def flush(self) -> None:
        with self._write_gate:
            for s in self.shards:
                s.flush()
        self._maybe_rebalance()
        if self._tuner is not None:
            self._maybe_tune(0)

    def fsync_wal(self) -> None:
        """Durability barrier on every shard's active WAL."""
        for s in self.shards:
            s.fsync_wal()

    # -------------------------------------------------------------- reads
    def _shard_snap(self, snapshot: Optional[ShardedSnapshot], si: int
                    ) -> Optional[Version]:
        return None if snapshot is None else snapshot.versions[si]

    def _snap_routing(self, snapshot: ShardedSnapshot) -> _Routing:
        r = snapshot.routing
        return r if r is not None else self._routing

    def get(self, key: int,
            snapshot: Optional[ShardedSnapshot] = None) -> Optional[bytes]:
        if snapshot is not None:
            si = self._snap_routing(snapshot).shard_of(key)
            return self.shards[si].get(key, snapshot=snapshot.versions[si])
        while True:
            r = self._routing
            si = r.shard_of(key)
            out = self.shards[si].get(key)
            if self._routing is r:   # no migration landed mid-read
                self._note_key(si, key)
                return out

    def multi_get(self, keys: Sequence[int],
                  snapshot: Optional[ShardedSnapshot] = None
                  ) -> List[Optional[bytes]]:
        """Batched point reads: one searchsorted splits the wave, each
        shard resolves its sub-wave with its own ``multi_get`` (its own
        read-backs), and the answers go back to the callers' positions."""
        keys_arr = np.asarray(
            keys if isinstance(keys, np.ndarray) else list(keys),
            dtype=KEY_DTYPE)
        if keys_arr.size == 0:
            return []
        if snapshot is not None:
            return self._multi_get_routed(self._snap_routing(snapshot),
                                          keys_arr, snapshot)
        while True:
            r = self._routing
            results = self._multi_get_routed(r, keys_arr, None)
            if self._routing is r:
                return results

    def _multi_get_routed(self, r: _Routing, keys_arr: np.ndarray,
                          snapshot: Optional[ShardedSnapshot]
                          ) -> List[Optional[bytes]]:
        results: List[Optional[bytes]] = [None] * int(keys_arr.size)
        sids = r.split(keys_arr)
        for si in np.unique(sids):
            idx = np.nonzero(sids == si)[0]
            sub = self.shards[int(si)].multi_get(
                keys_arr[idx], snapshot=self._shard_snap(snapshot, int(si)))
            for j, v in zip(idx.tolist(), sub):
                results[j] = v
            if snapshot is None:
                self._note_keys(int(si), keys_arr[idx])
        return results

    def seek(self, key: int,
             snapshot: Optional[ShardedSnapshot] = None) -> Optional[int]:
        """The first key >= ``key`` across shards: the partition keeps key
        order, so the first shard (in range order) with an in-range answer
        holds it."""
        if snapshot is not None:
            return self._seek_routed(self._snap_routing(snapshot), key,
                                     snapshot)
        while True:
            r = self._routing
            got = self._seek_routed(r, key, None)
            if self._routing is r:
                return got

    def _seek_routed(self, r: _Routing, key: int,
                     snapshot: Optional[ShardedSnapshot]) -> Optional[int]:
        for si in range(r.shard_of(key), len(self.shards)):
            lo, hi = r.bounds(si)
            got = self.shards[si].seek(max(int(key), lo),
                                       snapshot=self._shard_snap(snapshot, si))
            if got is not None and got < hi:
                return got
        return None

    def scan(self, start_key: int, count: int,
             snapshot: Optional[ShardedSnapshot] = None
             ) -> List[Tuple[int, bytes]]:
        """Range read: the shards' scans concatenated in shard order (shard
        i's keys all precede shard i+1's); equal to the plain store's."""
        return self._scan_impl(start_key, count, snapshot, scalar=False)

    def scan_scalar(self, start_key: int, count: int,
                    snapshot: Optional[ShardedSnapshot] = None
                    ) -> List[Tuple[int, bytes]]:
        """The oracle range read, through every shard's ``scan_scalar``."""
        return self._scan_impl(start_key, count, snapshot, scalar=True)

    def _scan_impl(self, start_key: int, count: int,
                   snapshot: Optional[ShardedSnapshot], scalar: bool
                   ) -> List[Tuple[int, bytes]]:
        if snapshot is not None:
            return self._scan_routed(self._snap_routing(snapshot), start_key,
                                     count, snapshot, scalar)
        while True:
            r = self._routing
            out = self._scan_routed(r, start_key, count, None, scalar)
            if self._routing is r:
                return out

    def _scan_routed(self, r: _Routing, start_key: int, count: int,
                     snapshot: Optional[ShardedSnapshot], scalar: bool
                     ) -> List[Tuple[int, bytes]]:
        out: List[Tuple[int, bytes]] = []
        for si in range(r.shard_of(int(start_key)), len(self.shards)):
            need = count - len(out)
            if need <= 0:
                break
            lo, hi = r.bounds(si)
            shard = self.shards[si]
            fn = shard.scan_scalar if scalar else shard.scan
            part = fn(max(int(start_key), lo), need,
                      snapshot=self._shard_snap(snapshot, si))
            if part and part[-1][0] >= hi:
                # mid-migration only: clip what the captured routing gives
                # a later shard (sorted, so the kept prefix is complete)
                keys = [k for k, _ in part]
                part = part[:bisect_left(keys, hi)]
            out.extend(part)
        return out[:count]

    # ----------------------------------------------------------- snapshots
    def get_snapshot(self) -> ShardedSnapshot:
        """Pin every shard's current version as one cut.

        The write gate keeps facade writes and migrations wholly before or
        after the pins; background installs (async shards) are caught by
        pin, validate and retry: if any shard's current version moved
        while the pins were taken, they are released and taken again.  As
        in the reference, a snapshot sees installed versions only, never
        memtables, so the halves of an acknowledged batch may enter its
        visibility at their shards' own flushes; quiesce first where that
        matters.
        """
        with self._write_gate:
            while True:
                pins = tuple(s.get_snapshot() for s in self.shards)
                if all(p.version_id == s.manifest.current().version_id
                       for s, p in zip(self.shards, pins)):
                    return ShardedSnapshot(pins, self._routing)
                tel = self.config.telemetry
                if tel is not None:
                    tel.emit("snapshot_retry", shards=len(self.shards))
                for s, p in zip(self.shards, pins):
                    s.release_snapshot(p)

    def release_snapshot(self, snapshot: ShardedSnapshot) -> None:
        for s, v in zip(self.shards, snapshot.versions):
            s.release_snapshot(v)

    # ---------------------------------------------------------- rebalancing
    def _on_shard_idle(self) -> None:
        """A worker's drained-queue hook: flag a skewed window only (a
        worker must not run the rebalance, which quiesces its own
        scheduler); the next foreground write or quiesce consumes it."""
        cfg = self.config
        iv = cfg.rebalance_interval_ops
        if iv <= 0 or self._in_rebalance or self._ops_since_check < iv:
            return
        loads = self._load
        tot = sum(loads)
        if tot and max(loads) * len(loads) >= cfg.rebalance_ratio * tot:
            self._rebalance_needed = True

    def _maybe_rebalance(self) -> bool:
        """Write-boundary trigger: a flag and counter test, the full check
        at most every ``rebalance_interval_ops`` routed operations."""
        cfg = self.config
        if cfg.rebalance_interval_ops <= 0 or self._in_rebalance:
            return False
        if not self._rebalance_needed \
                and self._ops_since_check < cfg.rebalance_interval_ops:
            return False
        return self.rebalance_now()

    def arm_rebalancing(self, interval_ops: int,
                        ratio: Optional[float] = None) -> None:
        """Enable (or retune) automatic rebalancing on a live facade, and
        reset the load window: bulk-load with rebalancing off (a sorted
        preload looks maximally skewed), then arm for serving."""
        with self._write_gate:
            self.config.rebalance_interval_ops = int(interval_ops)
            if ratio is not None:
                self.config.rebalance_ratio = float(ratio)
            self._load = [0] * len(self.shards)
            self._load_hist = [np.zeros(_HIST_B)
                               for _ in range(len(self.shards))]
            self._ops_since_check = 0
            self._rebalance_needed = False

    def rebalance_now(self, force: bool = False) -> bool:
        """Check the load window and rebalance if it is skewed (or
        ``force``).  True iff a migration landed."""
        return self._rebalance(None, force)

    def rebalance_to(self, splitters: Sequence[int]) -> bool:
        """Migrate to explicit splitters (tests, operators)."""
        lst = [int(x) for x in splitters]
        if len(lst) != len(self.shards) - 1:
            raise ValueError(
                f"need {len(self.shards) - 1} splitters, got {len(lst)}")
        if lst != sorted(set(lst)):
            raise ValueError("splitters must be strictly ascending")
        return self._rebalance(lst, True)

    def _rebalance(self, target: Optional[List[int]], force: bool) -> bool:
        if self._in_rebalance:       # reentrancy (quiesce inside migration)
            return False
        with self._write_gate:
            if self._in_rebalance:
                return False
            self._in_rebalance = True
            try:
                self._rebalance_needed = False
                self._ops_since_check = 0
                loads = list(self._load)
                tot = sum(loads)
                n = len(self.shards)
                ratio = (max(loads) * n / tot) if tot else 1.0
                if not force and ratio < self.config.rebalance_ratio:
                    # decay the window so stale skew ages out
                    self._load = [v // 2 for v in loads]
                    self._load_hist = [h * 0.5 for h in self._load_hist]
                    return False
                return self._rebalance_to(target, loads, ratio)
            finally:
                self._in_rebalance = False

    def _rebalance_to(self, target: Optional[List[int]],
                      loads: List[int], ratio: float) -> bool:
        """The migration (gate held, ``_in_rebalance`` set), in the order
        that makes it crash-safe: (1) quiesce, so memtables become runs and
        the schedulers drain; (2) build and commit the imports in every
        destination; (3) log the new splitters durably, then publish them;
        (4) strip each source to its new range.  A crash before (3)
        recovers the old routing and the recovery clip drops the imports; a
        crash after it recovers the new routing and the clip finishes the
        strip."""
        t0 = time.perf_counter_ns()
        n = len(self.shards)
        for s in self.shards:                                   # (1)
            s.flush()
        for s in self.shards:
            if not s.wait_for_quiesce(timeout=120.0):
                return False     # nothing changed yet: a clean abort
        old = self._routing
        new_lst = target if target is not None \
            else self._derive_splitters(loads)
        if new_lst is None or list(new_lst) == old.lst:
            self._load = [v // 2 for v in loads]
            self._load_hist = [h * 0.5 for h in self._load_hist]
            return False
        new = _Routing(new_lst, old.epoch + 1)
        tel = self.config.telemetry
        if tel is not None:
            tel.emit("rebalance_start", epoch=new.epoch,
                     imbalance=round(ratio, 3), window_ops=int(sum(loads)))
        t1 = time.perf_counter_ns()
        self.migration_s["quiesce"] += (t1 - t0) / 1e9
        if self._budget is not None:
            # the migration rides the worker budget, taken after the
            # quiesce (a drained pipeline holds no permit; the other order
            # deadlocks at a budget of 1)
            self._budget.acquire()
        try:
            moves, moved = self._install_imports(old, new)      # (2)
            t2 = time.perf_counter_ns()
            self._commit_routing(new)                           # (3)
            t3 = time.perf_counter_ns()
            self._cleanup_sources(new)                          # (4)
            t4 = time.perf_counter_ns()
        finally:
            if self._budget is not None:
                self._budget.release()
        self.migration_s["imports"] += (t2 - t1) / 1e9
        self.migration_s["commit"] += (t3 - t2) / 1e9
        self.migration_s["strip"] += (t4 - t3) / 1e9
        if tel is not None:
            for si in range(n):
                ol, oh = old.bounds(si)
                nl, nh = new.bounds(si)
                if (nl, nh) == (ol, oh):
                    continue
                if nl >= ol and nh <= oh:
                    tel.emit("shard_split", shard=si, lo=nl, hi=nh)
                elif nl <= ol and nh >= oh:
                    tel.emit("shard_merge", shard=si, lo=nl, hi=nh)
                else:                # slid: shrank one side, grew the other
                    tel.emit("shard_shift", shard=si, lo=nl, hi=nh)
        self._reassign_cache_budgets(loads)
        # the imports land in L0 and a stripped source may be under-shaped:
        # reshape on the workers (sync shards compact inline, the oracle)
        for s in self.shards:
            if s._scheduler is not None:
                s._scheduler.submit(CompactJob())
            else:
                s._compact_until_quiet()
        self.rebalances += 1
        self._load = [0] * n
        self._load_hist = [np.zeros(_HIST_B) for _ in range(n)]
        dur = time.perf_counter_ns() - t0
        if tel is not None:
            tel.record("rebalance", dur)
            tel.emit("rebalance_end", epoch=new.epoch, moves=moves,
                     entries=moved, t0=t0, dur_ns=dur)
        return True

    def _derive_splitters(self, loads: List[int]) -> Optional[List[int]]:
        """Load-weighted key quantiles over the shards' stored keys.

        Each shard's unique keys (deduplicated on the device, subsampled by
        stride past 65,536, then read back) carry its window load, spread
        by its key histogram so a concentrated hot range is cut at its
        measured median in one step; the global cumulative weight is cut
        at i/n.  None when there is no data or no usable cut.
        """
        n = len(self.shards)
        routing = self._routing
        keys_parts: List[np.ndarray] = []
        w_parts: List[np.ndarray] = []
        for si, s in enumerate(self.shards):
            runs = [r for lvl in s._levels for r in lvl if len(r)]
            if not runs:
                continue
            kd = runs[0].keys if len(runs) == 1 else \
                torch.unique(torch.cat([r.keys for r in runs]))
            stride = max(1, kd.numel() // 65536)
            if stride > 1:
                kd = kd[::stride]
            k = ops.keys_from_device(kd)
            keys_parts.append(k)
            # each sampled key takes its bucket's observed load spread over
            # the bucket's keys, with 1/8 of a uniform mass as a floor
            lo, hi = routing.bounds(si)
            h = self._load_hist[si]
            b = ((k.astype(np.float64) - lo)
                 * (_HIST_B / float(hi - lo))).astype(np.int64)
            np.clip(b, 0, _HIST_B - 1, out=b)
            wb = h + max(float(h.sum()), 1.0) / (_HIST_B * 8.0)
            wb *= (loads[si] + 1.0) / wb.sum()
            cnt = np.maximum(np.bincount(b, minlength=_HIST_B), 1)
            w_parts.append(wb[b] / cnt[b])
        if not keys_parts:
            return None
        K = np.concatenate(keys_parts)   # sorted: shard ranges are disjoint
        W = np.concatenate(w_parts)
        cum = np.cumsum(W)
        targets = float(cum[-1]) * np.arange(1, n) / n
        idx = np.minimum(np.searchsorted(cum, targets), K.size - 1)
        out: List[int] = []
        prev = -1
        for c in K[idx]:
            c = int(c)
            if c <= prev:            # strictly ascending
                c = prev + 1
            out.append(c)
            prev = c
        if out[-1] >= _KEY_SPACE_END:
            return None              # the fix-up ran off the key space
        return out

    def _install_imports(self, old: _Routing, new: _Routing
                         ) -> Tuple[int, int]:
        """Step (2): commit every leaving range into its new owner as a
        fresh L0 run.  The exported columns stay on the device and are
        split there; each import keeps the newest version of a key and
        drops whole-key tombstones (the destination owned nothing in the
        moved range, so nothing live is shadowed)."""
        tel = self.config.telemetry
        moves = moved = 0
        for si, s in enumerate(self.shards):
            ol, oh = old.bounds(si)
            nl, nh = new.bounds(si)
            # what shard si gives away: its old range minus its new one,
            # at most a low-side and a high-side interval
            for lo, hi in ((ol, min(oh, nl)), (max(ol, nh), oh)):
                if lo >= hi:
                    continue
                cols = s.export_range(lo, hi)
                if cols is None:
                    continue
                k, sq, vl, vv = cols
                dest_ids = new.split_on_device(k)
                for dj in torch.unique(dest_ids).tolist():
                    mask = dest_ids == dj
                    dst = self.shards[dj]
                    run = build_run(k[mask], sq[mask], vl[mask], vv[mask],
                                    bits_per_key=dst._bits_for_level(0),
                                    drop_tombstones=True,
                                    block_size=self.config.block_size,
                                    key_bytes=self.config.key_bytes)
                    if len(run) == 0:
                        continue     # the slice was all tombstones
                    dst.import_migrated_run(run)
                    moves += 1
                    moved += len(run)
                    if tel is not None:
                        tel.emit("run_migrate", src=si, dst=dj,
                                 entries=len(run), bytes=run.data_bytes)
        self.migrated_entries += moved
        return moves, moved

    def _commit_routing(self, new: _Routing) -> None:
        """Step (3): the durable log append first (synced at once: routing
        changes are rare), then the readers' reference swap.  Every later
        write routes, and is logged, under the new splitters: the invariant
        recovery's clip relies on."""
        self._routing_log.append(tuple(new.lst))
        self._routing_synced = len(self._routing_log)
        self._routing = new

    def _cleanup_sources(self, new: _Routing) -> None:
        """Step (4): drop each shard's moved-away entries (durable per
        shard; recovery's clip finishes a crash part-way)."""
        for si, s in enumerate(self.shards):
            lo, hi = new.bounds(si)
            s.strip_to_range(lo, hi)

    def _reassign_cache_budgets(self, loads: List[int]) -> None:
        """Re-slice the shared cache by load, with a 1/(4N) floor; only
        admission budgets move, no entry is dropped."""
        if self.block_cache is None or self.config.cache_bytes <= 0:
            return
        total = self.config.cache_bytes
        n = len(self.shards)
        base = (sum(loads) + n) // (3 * n) + 1   # floor ≈ 1/(4N) share
        w = [ld + base for ld in loads]
        wsum = sum(w)
        budgets = [total * wi // wsum for wi in w]
        budgets[max(range(n), key=lambda i: w[i])] += total - sum(budgets)
        for i, s in enumerate(self.shards):
            if s.block_cache is not None:
                s.block_cache.budget_bytes = budgets[i]
            self.block_cache.set_ns_budget(i, budgets[i])

    # ------------------------------------------------------- online tuning
    def _shards_idle(self) -> bool:
        """True at a facade-wide compaction-chain boundary (a synchronous
        shard always is at one)."""
        return all(s._scheduler is None or s._scheduler.idle()
                   for s in self.shards)

    def _maybe_tune(self, k: int = 0) -> None:
        """Write-boundary tuning trigger: count routed operations, arm at
        ``interval_ops``, tick at the first all-shards-idle boundary."""
        tun = self._tuner
        self._tune_ops += k
        if not self._tune_armed:
            if self._tune_ops < tun.interval_ops:
                return
            self._tune_armed = True
        if not self._shards_idle():
            return
        self._tune_ops = 0
        self._tune_armed = False
        with self._write_gate:
            tun.tick(self)

    def apply_tuning(self) -> Optional[TunerStep]:
        """One tuner tick now iff every shard is at a boundary, under the
        write gate (a snapshot never sees a half-applied actuation)."""
        tun = self._tuner
        if tun is None or not self._shards_idle():
            return None
        self._tune_ops = 0
        self._tune_armed = False
        with self._write_gate:
            return tun.tick(self)

    def compact_to_shape(self, timeout: Optional[float] = 600.0) -> int:
        """Maintenance reshape of every shard (``LSMStore.compact_to_shape``)
        after draining them, under the write gate.  Returns the merges."""
        with self._write_gate:
            if not self.wait_for_quiesce(timeout):
                return 0
            return sum(s.compact_to_shape() for s in self.shards)

    def retune_policy(self, *, T: Optional[float] = None,
                      c: Optional[float] = None) -> None:
        """Swap every shard's policy for a same-family one with new knobs
        (future compaction targets only)."""
        cfg = self.config
        if T is not None:
            cfg.T = float(T)
        if c is not None:
            cfg.c = float(c)
        for s in self.shards:
            s.policy = s.policy.retuned(T=cfg.T, c=cfg.c)

    def resize_worker_budget(self, n: int) -> bool:
        """Retarget the shared worker budget (tuner actuator); a shrink
        lands only while the permits are free, as at an idle boundary."""
        if self._budget is None:
            return False
        ok = self._budget.resize(n)
        if ok:
            self.config.compaction_workers = self._budget.size
        return ok

    def set_cache_split(self, pin_l0_bytes: int) -> None:
        """Move budget between the shared cache and the per-shard pinned
        L0 slices at constant total (tuner actuator): the cache evicts down
        in place and each namespace budget rescales in proportion."""
        if self.block_cache is None:
            return
        cfg = self.config
        total = cfg.cache_bytes + cfg.pin_l0_bytes
        pin = max(0, min(int(pin_l0_bytes), total))
        cache = total - pin
        scale = cache / cfg.cache_bytes if cfg.cache_bytes > 0 else 0.0
        cfg.cache_bytes = cache
        cfg.pin_l0_bytes = pin
        self.block_cache.resize(cache)
        n = len(self.shards)
        per_pin = pin // n
        for s in self.shards:
            v = s.block_cache
            if v is not None:
                v.resize(int(v.budget_bytes * scale) if scale > 0
                         else cache // n)
            if s.pinned_l0 is not None:
                s.pinned_l0.pin_l0_bytes = per_pin
                with s._maint_lock:
                    s.pinned_l0.repin(s._levels[0], stats=s._stats.local())

    def _get_pin_frac(self) -> float:
        total = self.config.cache_bytes + self.config.pin_l0_bytes
        return self.config.pin_l0_bytes / total if total else 0.0

    def _set_pin_frac(self, v: float) -> None:
        total = self.config.cache_bytes + self.config.pin_l0_bytes
        self.set_cache_split(int(total * float(v)))

    def _tuning_actuators(self):
        """The facade's knobs: level ratios fan out to every shard; the
        pressure and worker knobs act on the shared config and budget."""
        acts = {
            "c": (lambda: self.shards[0].policy.c,
                  lambda v: self.retune_policy(c=v)),
            "T": (lambda: self.shards[0].policy.T,
                  lambda v: self.retune_policy(T=v)),
        }
        if self.config.async_compaction:
            acts["slowdown_trigger"] = (
                lambda: self.config.slowdown_trigger,
                lambda v: setattr(self.config, "slowdown_trigger", int(v)))
        if self._budget is not None:
            acts["compaction_workers"] = (lambda: self._budget.size,
                                          self.resize_worker_budget)
        if self.block_cache is not None and self.config.cache_bytes \
                + self.config.pin_l0_bytes > 0:
            acts["pin_frac"] = (self._get_pin_frac, self._set_pin_frac)
        return acts

    def _tuning_rules(self, window, stats_delta) -> None:
        """The rule the tuner runs every tick: shift the shared cache's
        namespace budgets toward the shards with the most cache misses in
        the window (the rebalance's budget rule, weighted by misses)."""
        if self.block_cache is None or self.config.cache_bytes <= 0:
            return
        cur = [s.stats for s in self.shards]
        prev = self._tune_prev_shard_stats
        self._tune_prev_shard_stats = cur
        if prev is None:
            return
        misses = [c.delta(p).cache_miss_blocks
                  for c, p in zip(cur, prev)]
        if sum(misses) <= 0:
            return
        total = self.config.cache_bytes
        n = len(self.shards)
        base = (sum(misses) + n) // (3 * n) + 1   # floor ≈ 1/(4N) share
        w = [m + base for m in misses]
        wsum = sum(w)
        budgets = [total * wi // wsum for wi in w]
        budgets[max(range(n), key=lambda i: w[i])] += total - sum(budgets)
        for i, s in enumerate(self.shards):
            if s.block_cache is not None:
                s.block_cache.resize(budgets[i])
            else:
                self.block_cache.set_ns_budget(i, budgets[i])

    # ------------------------------------------------------------ recovery
    def crash(self) -> None:
        """Whole-store crash: every shard aborts its pipeline and loses its
        volatile state; the synced prefix of the routing log survives."""
        for s in self.shards:
            s.crash()
        del self._routing_log[self._routing_synced:]

    def recover(self) -> None:
        """Recover every shard, restore the last durable routing, and clip
        each shard to its range: a crash mid-migration lands on exactly the
        pre-migration state (the routing commit did not land: the clip
        drops the imports) or the post-migration one (it did: the clip
        finishes the strip).  Replayed memtables are in range, since writes
        only route under a routing logged before them."""
        routing = _Routing(self._routing_log[-1],
                           epoch=len(self._routing_log) - 1)
        self._routing = routing
        for si, s in enumerate(self.shards):
            s.recover()
            lo, hi = routing.bounds(si)
            s.strip_to_range(lo, hi)
        self._load = [0] * len(self.shards)
        self._load_hist = [np.zeros(_HIST_B) for _ in range(len(self.shards))]
        self._ops_since_check = 0
        self._rebalance_needed = False

    def close(self) -> None:
        """Drain and stop every shard's workers (each then serves on the
        synchronous, state-equivalent path); raises the first failure
        after closing them all."""
        err = None
        for s in self.shards:
            try:
                s.close()
            except BaseException as e:
                err = err or e
        if err is not None:
            raise err

    def wait_for_quiesce(self, timeout: Optional[float] = None) -> bool:
        """Block until every shard's pipeline drains.  A quiesce is also a
        rebalance boundary: a skewed window migrates here (foreground) and
        its reshaping jobs drain within the same deadline."""
        deadline = None if timeout is None else time.monotonic() + timeout
        ok = self._drain_shards(deadline)
        if ok and not self._in_rebalance and self._maybe_rebalance():
            ok = self._drain_shards(deadline)
        if ok and self._tuner is not None and self._tune_armed:
            self.apply_tuning()
        return ok

    def _drain_shards(self, deadline: Optional[float]) -> bool:
        ok = True
        for s in self.shards:
            left = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            ok = s.wait_for_quiesce(left) and ok
        return ok

    # ------------------------------------------------------------ integrity
    @property
    def degraded(self) -> bool:
        """True when any shard is read-only after persistent background
        failure; the others keep taking writes, and every shard reads."""
        return any(s.degraded for s in self.shards)

    def degraded_shards(self) -> List[int]:
        """Indices of the read-only shards."""
        return [si for si, s in enumerate(self.shards) if s.degraded]

    def scrub(self) -> List[dict]:
        """Every shard's ``scrub`` report, each dict tagged with its
        shard, in shard order."""
        report: List[dict] = []
        for si, s in enumerate(self.shards):
            for r in s.scrub():
                r["shard"] = si
                report.append(r)
        return report

    # ---------------------------------------------------------------- info
    @property
    def stats(self) -> IOStats:
        """The shards' counters summed field by field (a fresh IOStats)."""
        return IOStats.merge(s.stats for s in self.shards)

    @property
    def shard_stats(self) -> List[dict]:
        """Each shard's ``IOStats.to_dict()``, in shard order."""
        return [s.stats.to_dict() for s in self.shards]

    def shard_load_ops(self) -> List[int]:
        """Cumulative routed operations (reads and writes) per shard."""
        return list(self._load_total)

    def shard_load_summary(self) -> List[dict]:
        """Per shard: range, routed-operation share, live bytes, and the
        counters rebalancing decisions read."""
        tot = sum(self._load_total) or 1
        out = []
        for si, s in enumerate(self.shards):
            lo, hi = self._routing.bounds(si)
            st = s.stats
            phys, _ = s._space_profile()
            out.append(dict(shard=si, lo=lo, hi=hi,
                            ops=self._load_total[si],
                            op_share=self._load_total[si] / tot,
                            window_ops=self._load[si],
                            live_bytes=phys,
                            entries=s.total_entries,
                            wal_appends=st.wal_appends,
                            point_reads=st.point_reads,
                            range_reads=st.range_reads,
                            stall_ns=st.stall_ns))
        return out

    @property
    def telemetry(self):
        """The facade's Telemetry, which every shard shares through the
        live config: one object aggregates all shards."""
        return self.config.telemetry

    @property
    def num_levels_in_use(self) -> int:
        return max(s.num_levels_in_use for s in self.shards)

    @property
    def total_entries(self) -> int:
        return sum(s.total_entries for s in self.shards)

    def total_live_entries(self) -> int:
        return sum(s.total_live_entries() for s in self.shards)

    def space_amplification(self) -> float:
        phys = logical = 0
        for s in self.shards:
            p, lg = s._space_profile()
            phys += p
            logical += lg
        return phys / logical if logical else 1.0

    def level_summary(self) -> List[dict]:
        """Per level, summed across shards (capacities too)."""
        out: List[dict] = []
        for s in self.shards:
            for d in s.level_summary():
                i = d["level"]
                while len(out) <= i:
                    out.append(dict(level=len(out), runs=0, entries=0,
                                    bytes=0, capacity=None))
                out[i]["runs"] += d["runs"]
                out[i]["entries"] += d["entries"]
                out[i]["bytes"] += d["bytes"]
                if d["capacity"] is not None:
                    out[i]["capacity"] = (out[i]["capacity"] or 0) \
                        + d["capacity"]
        return out

    def cache_summary(self) -> dict:
        """The shared cache: one hit rate, global charged bytes, and the
        pinned L0 runs of every shard."""
        if self.block_cache is None:
            return dict(enabled=False, hit_rate=0.0, hits=0, misses=0,
                        evictions=0, charged_bytes=0, pinned_bytes=0,
                        pinned_l0_runs=0)
        c = self.block_cache
        return dict(enabled=True, hit_rate=c.hit_rate(), hits=c.hits,
                    misses=c.misses, evictions=c.evictions,
                    charged_bytes=c.charged_bytes,
                    pinned_bytes=c.pinned_bytes,
                    pinned_l0_runs=sum(
                        len(s.pinned_l0.pinned_run_ids) for s in self.shards
                        if s.pinned_l0 is not None))


def make_store(config: Optional[LSMConfig] = None, device=None):
    """The store a configuration asks for, on ``device`` (``cuda:0`` when
    None): a plain :class:`LSMStore` for ``shards <= 1``, else a
    :class:`ShardedLSMStore`, whose every shard runs on that device."""
    config = config or LSMConfig()
    if config.shards <= 1:
        return LSMStore(config, device=device)
    return ShardedLSMStore(config, device=device)
