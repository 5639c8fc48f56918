"""MVCC manifest: immutable versions of the tree + a metadata log (§2.1).

Counterpart of ``repro.core.manifest``: host metadata only (run ids per
level); the runs themselves hold their columns on the device.  Flushes and
compactions install a new version atomically.  The metadata log mirrors
RocksDB's MANIFEST: an append-only record of version edits with an fsync
watermark; the runs of the last 8 durable versions stay alive, as in the
reference.  Reader pins (snapshots) and crash recovery of the log are left
to later slices.
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

    def live_run_ids(self) -> List[int]:
        with self._mu:
            ids: List[int] = []
            for v in self._log:
                for lvl in v.levels:
                    ids.extend(lvl)
            return ids

    def gc(self):
        with self._mu:
            self.storage.gc(self.live_run_ids())
