"""The plain definition of ``seek``, for holding the port against the reference.

``seek(key)`` is the smaller of every run's first key ``>= key`` (run
entries are not liveness-filtered: a cost probe) and every memtable's first
*live* key ``>= key``.  The reference instead takes each memtable's first
entry ``>= key`` and drops it when it is a tombstone, so a live memtable key
behind a memtable tombstone is skipped and its ``seek`` can return a key past
a live one.  The port takes the plain definition.  Both helpers read a
reference store's runs and memtables directly and charge no counter.
"""
from typing import Optional

import numpy as np


def _run_candidates(db, snapshot=None):
    levels = db._levels if snapshot is None else snapshot.runs(db.storage)
    out = []
    for lvl in levels:
        for run in lvl:
            if len(run):
                out.append(run)
    return out


def _seek(db, key: int, snapshot, live_memtable: bool) -> Optional[int]:
    cands = []
    for run in _run_candidates(db, snapshot):
        i = int(np.searchsorted(run.keys, np.uint64(key)))
        if i < len(run):
            cands.append(int(run.keys[i]))
    if snapshot is None:
        for mt in db._mem_sources():
            items = mt.scan(int(key))
            if live_memtable:
                items = [e for e in items if e[2] is not None]
            if items and items[0][2] is not None:
                cands.append(items[0][0])
    return min(cands, default=None)


def seek_plain(db, key: int, snapshot=None) -> Optional[int]:
    """The plain definition on a reference store."""
    return _seek(db, key, snapshot, live_memtable=True)


def seek_with_reference_fault(db, key: int, snapshot=None) -> Optional[int]:
    """The reference's rule: each memtable's first entry, dropped when it is
    a tombstone."""
    return _seek(db, key, snapshot, live_memtable=False)


def expected_seek(ref_answer: Optional[int], db, key: int,
                  snapshot=None) -> Optional[int]:
    """What the port's ``seek`` must return beside the reference store
    ``db`` that answered ``ref_answer``: that answer, except where the
    reference's fault shows (its rule and the plain definition differ); then
    the reference must have given its rule's answer, and the port the plain
    one."""
    plain = seek_plain(db, key, snapshot)
    faulty = seek_with_reference_fault(db, key, snapshot)
    if faulty == plain:
        return ref_answer
    assert ref_answer == faulty, (key, ref_answer, faulty)
    return plain
