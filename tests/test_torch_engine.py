"""repro_torch's store semantics vs the reference's (``tests/test_engine.py``).

The eight cases of ``tests/test_engine.py`` without a twin elsewhere
(reads, writes and deletes, newest-wins overwrites, sorted unique runs,
MVCC snapshot isolation, tombstone GC at the last level, the write-stall
counter, the dict oracle under hypothesis, scans across tombstones and
levels), with the same configuration, seeds and strategies, on
``repro_torch.LSMStore(device="cpu")`` beside ``repro.core.LSMStore``: each
case's own assertions on the port, the same answers from both stores, and
at the end the same tree (every run's columns, ``test_torch_store``'s
``assert_same_tree``) and every IOStats field equal.  The two crash cases
(``test_crash_recovery_wal``, ``test_crash_loses_unsynced_tail``) have their
twins in ``tests/test_torch_recovery.py``.  All lanes are integer:
tolerance 0.
"""
import dataclasses

import numpy as np
import torch
from hypothesis import given, settings, strategies as st

import repro.core as ref
import repro_torch as rt
from test_torch_store import assert_same_tree

# Six xdist workers share 8 cores with the reference's timing-bounded
# property tests: one intra-op thread per worker keeps them on time.
torch.set_num_threads(1)


def small_cfg(**kw) -> dict:
    base = dict(policy="garnering", T=2.0, c=0.8, memtable_bytes=1 << 12,
                base_level_bytes=1 << 14, bits_per_key=10,
                bloom_allocation="monkey")
    base.update(kw)
    return base


def pair(**kw):
    """(port, reference) stores of ``small_cfg(**kw)``."""
    cfg = small_cfg(**kw)
    return (rt.LSMStore(rt.LSMConfig(**cfg), device="cpu"),
            ref.LSMStore(ref.LSMConfig(**cfg)))


def both(dbs, name, *args, **kw):
    out = [getattr(db, name)(*args, **kw) for db in dbs]
    assert out[0] == out[1], (name, args)
    return out[0]


def assert_same(dbs):
    port, reference = dbs
    assert_same_tree(port, reference)
    assert dataclasses.asdict(port.stats) == \
        dataclasses.asdict(reference.stats)


def test_put_get_delete_scan():
    dbs = pair()
    for k in range(500):
        both(dbs, "put", k, f"v{k}".encode())
    both(dbs, "flush")
    both(dbs, "delete", 123)
    assert both(dbs, "get", 122) == b"v122"
    assert both(dbs, "get", 123) is None
    assert both(dbs, "get", 10_000) is None
    got = both(dbs, "scan", 120, 5)
    assert [k for k, _ in got] == [120, 121, 122, 124, 125]
    assert_same(dbs)


def test_overwrite_newest_wins():
    dbs = pair()
    for rep in range(4):
        for k in range(300):
            both(dbs, "put", k, f"r{rep}k{k}".encode())
        both(dbs, "flush")
    assert both(dbs, "get", 7) == b"r3k7"
    assert both(dbs, "scan", 7, 1) == [(7, b"r3k7")]
    assert_same(dbs)


def test_runs_internally_sorted_unique():
    dbs = pair()
    rng = np.random.default_rng(0)
    for k in rng.integers(0, 2000, 5000):
        both(dbs, "put", int(k), b"x" * 20)
    both(dbs, "flush")
    seen = 0
    for lvl in dbs[0]._levels:
        for run in lvl:
            # order-mapped int64 keys: strictly increasing as the u64 keys
            assert (torch.diff(run.keys) > 0).all()
            seen += 1
    assert seen > 0
    assert_same(dbs)


def test_mvcc_snapshot_isolation():
    dbs = pair()
    for k in range(200):
        both(dbs, "put", k, b"old")
    both(dbs, "flush")
    snaps = [db.get_snapshot() for db in dbs]
    for k in range(200):
        both(dbs, "put", k, b"new")
    both(dbs, "flush")
    assert both(dbs, "get", 5) == b"new"
    got = [db.get(5, snapshot=s) for db, s in zip(dbs, snaps)]
    assert got == [b"old", b"old"]
    got = [db.scan(0, 3, snapshot=s) for db, s in zip(dbs, snaps)]
    assert got[0] == got[1]
    assert [v for _, v in got[0]] == [b"old"] * 3
    assert_same(dbs)


def test_tombstones_gcd_at_last_level():
    dbs = pair()
    for k in range(400):
        both(dbs, "put", k, b"x" * 30)
    for k in range(400):
        both(dbs, "delete", k)
    both(dbs, "flush")
    assert both(dbs, "total_live_entries") == 0
    # force a full merge into the deepest level: tombstones must drop
    deepest = both(dbs, "_deepest_nonempty")
    for db, task in zip(dbs, (rt.core.CompactionTask, ref.CompactionTask)):
        for i in range(1, deepest):
            if db._levels[i]:
                db._apply(task(i, deepest, True, "test-force"))
        if db._levels[0]:
            db._apply(task(0, deepest, True, "test-force"))
    total = [sum(len(r) for lvl in db._levels[1:] for r in lvl)
             for db in dbs]
    assert total == [0, 0]
    assert both(dbs, "get", 5) is None
    assert_same(dbs)


def test_write_stall_counter():
    dbs = pair(l0_stop_writes_trigger=2, l0_compaction_trigger=100)
    for k in range(4000):
        both(dbs, "put", k, b"y" * 40)
    assert dbs[0].stats.write_stalls > 0
    assert_same(dbs)


@given(st.lists(st.tuples(st.sampled_from(["put", "del", "get"]),
                          st.integers(0, 120)), min_size=1, max_size=300))
@settings(max_examples=40, deadline=None)
def test_against_dict_oracle(ops):
    """Property: the engine behaves exactly like a dict, across flushes."""
    dbs = pair(memtable_bytes=1 << 9)
    oracle = {}
    for i, (op, k) in enumerate(ops):
        if op == "put":
            v = f"{i}".encode()
            both(dbs, "put", k, v)
            oracle[k] = v
        elif op == "del":
            both(dbs, "delete", k)
            oracle.pop(k, None)
        else:
            assert both(dbs, "get", k) == oracle.get(k)
    both(dbs, "flush")
    for k in range(121):
        assert both(dbs, "get", k) == oracle.get(k), k
    got = both(dbs, "scan", 0, len(oracle) + 5)
    assert got == sorted(oracle.items())
    assert_same(dbs)


def test_scan_crossing_tombstones_and_levels():
    dbs = pair(memtable_bytes=1 << 10)
    for k in range(0, 1000, 2):
        both(dbs, "put", k, b"even")
    both(dbs, "flush")
    for k in range(0, 1000, 4):
        both(dbs, "delete", k)
    both(dbs, "flush")
    got = both(dbs, "scan", 0, 10)
    assert [k for k, _ in got] == [2, 6, 10, 14, 18, 22, 26, 30, 34, 38]
    assert_same(dbs)
