"""MVCC manifest: immutable versions of the tree + a metadata log (§2.1).

Counterpart of ``repro.core.manifest``: host metadata only (run ids per
level); the runs themselves hold their columns on the device.  Flushes and
compactions install a new version atomically.  The metadata log mirrors
RocksDB's MANIFEST: an append-only record of version edits with an fsync
watermark; the runs of the last 8 durable versions stay alive, as in the
reference, and so do the runs of every version a reader has pinned
(snapshots, refcounted).  A crash loses the edits past the fsync
watermark, and recovery restores the newest checksum-valid durable
version.
"""
from __future__ import annotations

import dataclasses
import struct
import threading
from typing import Dict, List, Sequence, Tuple

from .faults import crc32c
from .run import SortedRun
from .types import IOStats


def _edit_checksum(version_id: int, levels: Tuple[Tuple[int, ...], ...],
                   max_level: int, last_seq: int) -> int:
    """CRC-32C over a version edit's canonical encoding (DESIGN.md §16.2):
    ``<QQQ>(version_id, max_level, last_seq)`` then, per level,
    ``<q>len`` followed by each run id as ``<q>``."""
    parts = [struct.pack("<QQQ", version_id, max_level, last_seq)]
    for lvl in levels:
        parts.append(struct.pack("<q", len(lvl)))
        parts.extend(struct.pack("<q", rid) for rid in lvl)
    return crc32c(b"".join(parts))


@dataclasses.dataclass(frozen=True)
class Version:
    version_id: int
    levels: Tuple[Tuple[int, ...], ...]  # run ids per level
    max_level: int
    last_seq: int
    checksum: int = -1  # CRC-32C of the edit; -1 = legacy/unchecksummed

    def verify(self) -> bool:
        """True iff the stored edit checksum matches the fields."""
        return self.checksum == _edit_checksum(
            self.version_id, self.levels, self.max_level, self.last_seq)

    def runs(self, storage: "RunStorage") -> List[List[SortedRun]]:
        return [[storage.get(rid) for rid in lvl] for lvl in self.levels]


class RunStorage:
    """Owns immutable runs by id; refcounted by manifest versions."""

    def __init__(self):
        self._runs: Dict[int, SortedRun] = {}

    def add(self, run: SortedRun) -> int:
        self._runs[run.run_id] = run
        return run.run_id

    def get(self, run_id: int) -> SortedRun:
        return self._runs[run_id]

    def ids(self) -> List[int]:
        """Ids of every run still owned (current + snapshot-pinned versions)."""
        return list(self._runs.keys())

    def gc(self, live_ids: Sequence[int]):
        live = set(live_ids)
        for rid in [r for r in self._runs if r not in live]:
            del self._runs[rid]

    def __len__(self):
        return len(self._runs)


class Manifest:
    """Thread-safety: every method takes the manifest mutex, so version
    installs and GC interleave atomically; a :class:`Version` itself is
    immutable and is read lock-free."""

    def __init__(self, storage: RunStorage):
        self.storage = storage
        self._mu = threading.RLock()
        self._log: List[Version] = []
        self._synced_upto = 0  # number of durable versions
        self._pinned: Dict[int, Version] = {}  # long-lived reader snapshots
        self._pin_refs: Dict[int, int] = {}    # version_id -> reader refcount
        self._next_id = 0
        self.commit(levels=[[]], max_level=1, last_seq=0, stats=IOStats())
        self.fsync(IOStats())

    # ------------------------------------------------------------- writes
    def commit(self, levels: Sequence[Sequence[SortedRun]], max_level: int,
               last_seq: int, stats: IOStats) -> Version:
        with self._mu:
            lv = tuple(tuple(self.storage.add(r) for r in lvl)
                       for lvl in levels)
            v = Version(self._next_id, lv, max_level, last_seq,
                        _edit_checksum(self._next_id, lv, max_level, last_seq))
            self._next_id += 1
            self._log.append(v)
            return v

    def fsync(self, stats: IOStats):
        with self._mu:
            self._synced_upto = len(self._log)
            stats.wal_fsyncs += 1
            # Old versions with no readers can be GC'd; keep the durable tail.
            if len(self._log) > 8:
                self._log = self._log[-8:]
                self._synced_upto = len(self._log)

    # -------------------------------------------------------------- reads
    def current(self) -> Version:
        with self._mu:
            return self._log[-1]

    def pin(self, v: Version) -> Version:
        """Pin a version for a long-lived reader: its runs survive GC even
        after the version leaves the manifest's durable tail.  Pins are
        refcounted: the version stays pinned until every reader unpins."""
        with self._mu:
            self._pinned[v.version_id] = v
            self._pin_refs[v.version_id] = \
                self._pin_refs.get(v.version_id, 0) + 1
            return v

    def pin_current(self) -> Version:
        """Atomically read-and-pin the newest version."""
        with self._mu:
            return self.pin(self._log[-1])

    def unpin(self, version_id: int) -> bool:
        """Drop one reader reference; the version unpins at refcount zero.

        Returns True iff this release actually unpinned the version (callers
        skip GC work while other readers still hold it)."""
        with self._mu:
            refs = self._pin_refs.get(version_id, 0) - 1
            if refs > 0:
                self._pin_refs[version_id] = refs
                return False
            self._pin_refs.pop(version_id, None)
            return self._pinned.pop(version_id, None) is not None

    def pin_count(self, version_id: int) -> int:
        with self._mu:
            return self._pin_refs.get(version_id, 0)

    def total_pin_refs(self) -> int:
        """Sum of all reader references (leak audit hook)."""
        with self._mu:
            return sum(self._pin_refs.values())

    def crash(self, faults=None):
        """Lose the versions past the fsync watermark (simulated crash);
        reader pins are process state and go too.  A ``FaultInjector``
        armed with ``corrupt_manifest_edit()`` garbles the last surviving
        edit's ``last_seq`` without updating its checksum, so recovery
        falls back one version."""
        with self._mu:
            self._pinned.clear()
            self._pin_refs.clear()
            self._log = self._log[: max(self._synced_upto, 1)]
            if faults is not None and faults.manifest_corruption \
                    and len(self._log) > 1:
                faults.manifest_corruption = False
                faults.fired["manifest_edit"] = \
                    faults.fired.get("manifest_edit", 0) + 1
                v = self._log[-1]
                self._log[-1] = dataclasses.replace(
                    v, last_seq=v.last_seq ^ (1 << 17))

    def recover_current(self) -> Tuple[Version, int]:
        """The newest checksum-valid version, popping any corrupt tail
        edits (each popped edit was itself a durable prefix, so falling
        back is prefix-consistent); version 0, the empty tree, is the
        floor.  Returns ``(version, n_popped)``."""
        with self._mu:
            popped = 0
            while len(self._log) > 1 and not self._log[-1].verify():
                self._log.pop()
                popped += 1
            self._synced_upto = min(self._synced_upto, len(self._log))
            return self._log[-1], popped

    def live_run_ids(self) -> List[int]:
        """Runs of the durable tail and of every pinned version."""
        with self._mu:
            ids: List[int] = []
            for v in self._log + list(self._pinned.values()):
                for lvl in v.levels:
                    ids.extend(lvl)
            return ids

    def gc(self):
        with self._mu:
            self.storage.gc(self.live_run_ids())
