"""Shared types and cost accounting for the port of the Autumn LSM engine.

A copy of ``repro.core.types`` (host code): the analysis is written in units
of *disk block I/Os*; a "block" is a BLOCK_SIZE-byte unit of a sorted run,
and every block touch is counted by :class:`IOStats`, field for field the
reference's counters, so the port's accounting can be held against it.

On the device, keys are int64 holding the order-preserving map
``k ^ (1 << 63)`` of the u64 user key, and sequence numbers are int64;
the host side keeps numpy uint64 (``KEY_DTYPE``/``SEQ_DTYPE``) as the
reference does.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterable, List

import numpy as np

# Paper/db_bench defaults: 4 KiB blocks, 16-byte keys (8-byte user key is
# stored as uint64; the extra 8 bytes model seq/metadata overhead per entry).
BLOCK_SIZE = 4096
KEY_BYTES = 16

KEY_DTYPE = np.uint64
SEQ_DTYPE = np.uint64

# Sentinel length marking a tombstone entry inside a run.
TOMBSTONE_LEN = -1


@dataclasses.dataclass
class IOStats:
    """Counters for the disk-I/O cost model plus engine health stats."""

    blocks_read: int = 0          # data blocks touched by reads
    blocks_written: int = 0       # data blocks written by flush/compaction
    cache_hit_blocks: int = 0     # block reads served by the BlockCache
    cache_miss_blocks: int = 0    # block reads that missed the cache (charged)
    seeks: int = 0                # iterator seek operations (1 per run touched)
    bloom_probes: int = 0         # CPU cost proxy (paper §3.1 CPU Optimization)
    bloom_negatives: int = 0      # probes answered "definitely absent"
    false_positives: int = 0      # bloom said maybe, block read found nothing
    runs_touched_point: int = 0   # runs examined across all point reads
    runs_touched_range: int = 0   # runs examined across all range reads
    point_reads: int = 0
    range_reads: int = 0
    entries_flushed: int = 0      # entries written from memtable to level 0/1
    bytes_flushed: int = 0
    entries_compacted: int = 0    # entries rewritten by compactions
    bytes_compacted: int = 0
    compactions: int = 0
    delayed_last_level_compactions: int = 0  # paper §3.1 "Delayed ... Compaction"
    write_stalls: int = 0
    write_slowdowns: int = 0      # soft write-pressure events (async scheduler)
    stall_ns: int = 0             # foreground ns spent stalled/slowed on
                                  # write pressure (async scheduler)
    bg_flushes: int = 0           # memtable flushes applied by a worker thread
    bg_compactions: int = 0       # compaction tasks applied by a worker thread
    wal_appends: int = 0
    wal_fsyncs: int = 0
    view_rebuilds: int = 0        # cross-run range-view rebuilds (§13)
    bg_view_rebuilds: int = 0     # rebuilds run by a scheduler worker
    view_entries_built: int = 0   # entries indexed across all rebuilds
    view_rebuild_ns: int = 0      # wall time spent rebuilding views
    view_scans: int = 0           # range reads served by a range view
    view_fallbacks: int = 0       # view-eligible reads served by the
                                  # merging iterator (view stale mid-churn)
    bg_retries: int = 0           # background jobs re-run after a failure
                                  # (bounded exponential backoff, §16.3)
    bg_gave_up: int = 0           # background jobs abandoned after the
                                  # retry budget — store degrades read-only

    def write_amplification(self) -> float:
        """Average number of times each flushed byte was rewritten."""
        if self.bytes_flushed == 0:
            return 0.0
        return (self.bytes_flushed + self.bytes_compacted) / self.bytes_flushed

    def snapshot(self) -> "IOStats":
        return dataclasses.replace(self)

    def delta(self, since: "IOStats") -> "IOStats":
        out = IOStats()
        for f in dataclasses.fields(IOStats):
            setattr(out, f.name, getattr(self, f.name) - getattr(since, f.name))
        return out

    def __add__(self, other: "IOStats") -> "IOStats":
        """Fieldwise sum over *every* counter (cache hit/miss, stall_ns,
        bg_* included automatically — new fields join the sum by being
        declared, the single place aggregation is defined)."""
        if not isinstance(other, IOStats):
            return NotImplemented
        out = IOStats()
        for f in dataclasses.fields(IOStats):
            setattr(out, f.name, getattr(self, f.name) + getattr(other, f.name))
        return out

    def __radd__(self, other):
        # sum() support: sum(shard.stats for shard in shards)
        if other == 0:
            return self.snapshot()
        return self.__add__(other)

    @staticmethod
    def merge(stats: "Iterable[IOStats]") -> "IOStats":
        """Aggregate many stores' counters into one (the sharded facade's
        ``stats`` view).  Returns a fresh IOStats; inputs are not mutated."""
        out = IOStats()
        for s in stats:
            out = out + s
        return out

    def to_dict(self) -> Dict[str, float]:
        """Counters as a dict in declaration order, plus the derived
        ``write_amp`` (the dump ``AutumnKVCache.stats()`` uses)."""
        out = {f.name: getattr(self, f.name)
               for f in dataclasses.fields(IOStats)}
        out["write_amp"] = self.write_amplification()
        return out


class StatsHub:
    """Lossless concurrent :class:`IOStats` accumulation.

    Scheduler workers and foreground threads used to ``+=`` the *same*
    ``IOStats`` fields — a non-atomic read-modify-write that silently lost
    increments under contention (e.g. ``stall_ns`` charged by a stalled
    writer while a worker merged compaction counters).  The hub gives every
    thread its own private ``IOStats`` shard via :meth:`local`; shards are
    registered with a GIL-atomic ``list.append`` so neither registration nor
    the hot ``+=`` on a shard ever takes a lock, and no two threads ever
    mutate the same field.  :meth:`merged` folds the shards together at read
    time with the fieldwise ``IOStats.__add__`` algebra.

    Reads are monotonic-consistent (a concurrent snapshot may split an
    in-flight operation's counters across fields — the exact guarantee the
    single shared IOStats gave, minus the lost updates).  Shards of finished
    threads stay registered so their counts are never dropped; the engine
    uses a bounded worker pool, so the shard list stays small.
    """

    __slots__ = ("_tl", "_shards")

    def __init__(self):
        self._tl = threading.local()
        self._shards: List[IOStats] = []

    def local(self) -> IOStats:
        """The calling thread's private shard (create+register on first use)."""
        try:
            return self._tl.s
        except AttributeError:
            s = IOStats()
            self._tl.s = s
            self._shards.append(s)   # list.append is GIL-atomic: no lock
            return s

    def merged(self) -> IOStats:
        """Fieldwise sum of all shards (a fresh IOStats; shards unmutated)."""
        return IOStats.merge(list(self._shards))

    # ------------------------------------------------- windowed-delta API
    def snapshot(self) -> IOStats:
        """A fresh merged capture, the pair of :meth:`delta` (as
        ``Telemetry.snapshot``/``delta``): the online tuner senses both
        sources the same way."""
        return self.merged()

    def delta(self, prev: IOStats) -> IOStats:
        """Counter diffs accumulated since ``prev`` (a :meth:`snapshot`)."""
        return self.merged().delta(prev)


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 (the reference's ``types.splitmix64``)."""
    x = x.astype(np.uint64, copy=True)
    x += np.uint64(0x9E3779B97F4A7C15)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return z
