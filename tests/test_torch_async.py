"""repro_torch's async compaction scheduler on the CPU vs the reference.

Every case of ``tests/test_async.py`` on ``repro_torch.LSMStore(device=
"cpu", async_compaction=True)``.  Where a case has a deterministic end
state it also runs on ``repro.core.LSMStore``: after ``flush()`` +
``wait_for_quiesce()`` the port's async store holds the reference's
synchronous tree bit for bit (keys, seqs, vlens, vals, bloom bits, fences,
block ids, block CRCs), answers every read as it does, and every IOStats
field that does not depend on thread timing is equal (all but ``stall_ns``,
``write_slowdowns`` and ``write_stalls``; ``bg_*`` against the reference's
async store).  All lanes are integer: tolerance 0.  The property cases run
under real hypothesis and the fixed-seed shim alike.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as ref
import repro_torch as rt
from repro_torch.core import StoreDegradedError
from test_torch_store import assert_same_tree

# Six xdist workers share 8 cores with the reference's timing-bounded
# property tests: one intra-op thread per worker keeps them on time.
torch.set_num_threads(1)

KEY_SPACE = 300
TIMING = ("stall_ns", "write_slowdowns", "write_stalls")
BACKGROUND = ("bg_flushes", "bg_compactions", "bg_retries", "bg_gave_up")


def base(**kw):
    out = dict(policy="garnering", T=2.0, c=0.8, memtable_bytes=1 << 12,
               base_level_bytes=1 << 14, bits_per_key=8,
               bloom_allocation="monkey")
    out.update(kw)
    return out


def port_db(**kw):
    return rt.LSMStore(rt.LSMConfig(**base(**kw)), device="cpu")


def ref_db(**kw):
    return ref.LSMStore(ref.LSMConfig(**base(**kw)))


def gen_ops(seed: int, n_ops: int, key_space: int = KEY_SPACE,
            del_frac: float = 0.2):
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n_ops):
        k = int(rng.integers(0, key_space))
        if rng.random() < del_frac:
            ops.append((k, None))
        else:
            ops.append((k, bytes([65 + i % 26]) * int(rng.integers(0, 100))))
    return ops


def apply_ops(db, ops):
    for k, v in ops:
        (db.delete(k) if v is None else db.put(k, v))


def counters(db, skip=()):
    return {k: v for k, v in dataclasses.asdict(db.stats).items()
            if k not in skip}


def assert_same_reads(a, b):
    keys = list(range(KEY_SPACE))
    assert a.multi_get(keys) == b.multi_get(keys)
    assert a.scan(0, KEY_SPACE) == b.scan(0, KEY_SPACE)


# ------------------------------------------------------- differential oracle
@given(st.integers(0, 10_000), st.booleans())
@settings(max_examples=10, deadline=None)
def test_async_state_identical_to_sync_oracle(seed, use_batch):
    """After quiesce the port's async store equals the port's sync store
    and the reference's: levels, max level, memtable, live entries and
    every answer; the counters equal the reference's async store's."""
    ops = gen_ops(seed, 1200)
    p_s, p_a = port_db(), port_db(async_compaction=True)
    r_s, r_a = ref_db(), ref_db(async_compaction=True)
    try:
        for db in (p_s, p_a, r_s, r_a):
            if use_batch:
                db.write_batch(ops)
            else:
                apply_ops(db, ops)
            db.flush()
        assert p_a.wait_for_quiesce(60) and r_a.wait_for_quiesce(60)
        assert not p_a._imm
        assert_same_tree(p_a, r_s)
        assert_same_tree(p_s, r_s)
        assert p_a._max_level == p_s._max_level == r_s._max_level
        assert p_a.memtable._data == p_s.memtable._data == r_s.memtable._data
        assert p_a.total_live_entries() == r_s.total_live_entries()
        assert counters(p_a, TIMING + BACKGROUND) == \
            counters(r_s, TIMING + BACKGROUND)
        assert counters(p_a, TIMING) == counters(r_a, TIMING)
        assert_same_reads(p_a, r_s)
        assert counters(p_a, TIMING + BACKGROUND) == \
            counters(r_s, TIMING + BACKGROUND)
    finally:
        p_a.close()
        r_a.close()


def test_async_multiple_workers_still_deterministic():
    """The turnstile serializes jobs in queue order, so extra workers do
    not change the final state."""
    ops = gen_ops(77, 2000)
    p_a = port_db(async_compaction=True, compaction_workers=3)
    r_s = ref_db()
    try:
        apply_ops(p_a, ops)
        apply_ops(r_s, ops)
        p_a.flush()
        r_s.flush()
        assert p_a.wait_for_quiesce(60)
        assert_same_tree(p_a, r_s)
        assert p_a.stats.bg_flushes > 0
        assert len(p_a._scheduler._threads) == 3
    finally:
        p_a.close()


# --------------------------------------------------- pipelined flush window
def test_immutable_memtable_window_readable():
    """With the scheduler paused, rotated data lives only in the immutable
    queue, and every read path still sees it (between the active memtable
    and L0) with the reference's answers."""
    dbs = [port_db(memtable_bytes=1 << 20, async_compaction=True,
                   stall_trigger=0, slowdown_trigger=0),
           ref_db(memtable_bytes=1 << 20, async_compaction=True,
                  stall_trigger=0, slowdown_trigger=0)]
    try:
        for db in dbs:
            db._scheduler.pause()
            for k in range(100):
                db.put(k, f"imm{k}".encode())
            db.flush()                   # rotate: enqueue, don't wait
            db.put(7, b"active7")        # newer overwrite, active memtable
            db.delete(8)
        for db in dbs:
            assert len(db._imm) == 1
            assert not db._levels[0]
            assert db.get(5) == b"imm5"
            assert db.get(7) == b"active7"
            assert db.get(8) is None
            assert db.multi_get([5, 7, 8, 250]) == [b"imm5", b"active7",
                                                    None, None]
            assert db.scan(4, 4) == [(4, b"imm4"), (5, b"imm5"),
                                     (6, b"imm6"), (7, b"active7")]
            assert db.seek(5) == 5
            assert db.total_entries == 102
            it = db.iterator()
            it.seek(0)
            assert [k for k, _ in it] == [k for k in range(100) if k != 8]
        before = dict(dbs[0].scan(0, 200))
        assert before == dict(dbs[1].scan(0, 200))
        for db in dbs:
            db._scheduler.resume()
            assert db.wait_for_quiesce(60)
            assert not db._imm and db._levels[0]
        assert [dict(db.scan(0, 200)) for db in dbs] == [before, before]
        assert counters(dbs[0], TIMING) == counters(dbs[1], TIMING)
    finally:
        for db in dbs:
            db.close()


def test_write_pressure_triggers_engage():
    """Low triggers + sustained load: slowdowns and/or stalls with nonzero
    stall_ns, and the backlog bounded by the stall trigger."""
    db = port_db(async_compaction=True, slowdown_trigger=1, stall_trigger=3)
    try:
        bound = 3 + db.config.l0_compaction_trigger
        for k, v in gen_ops(3, 4000, key_space=5000, del_frac=0.0):
            db.put(k, v)
            assert len(db._imm) + len(db._levels[0]) <= bound
        db.flush()
        assert db.wait_for_quiesce(60)
        assert db.stats.write_slowdowns + db.stats.write_stalls > 0
        assert db.stats.stall_ns > 0
    finally:
        db.close()


# ------------------------------------------------------------ crash safety
def test_crash_mid_compaction_leaks_nothing():
    """Crash with jobs in flight: no pin left, the block cache holds only
    live run ids after recover(), and every fsynced write survives."""
    db = port_db(async_compaction=True, wal_fsync_every_write=True,
                 cache_bytes=1 << 18, pin_l0_bytes=1 << 16)
    oracle = {}
    for k, v in gen_ops(11, 3000):
        (db.delete(k) if v is None else db.put(k, v))
        if v is None:
            oracle.pop(k, None)
        else:
            oracle[k] = v
    db.crash()
    assert db._scheduler.pending() == 0
    assert db.manifest.total_pin_refs() == 0, "leaked version pins"
    db.recover()
    live = set(db.storage.ids())
    cached = {rid for rid, _ in
              set(db.block_cache._entries) | set(db.block_cache._pinned)}
    assert cached <= live, f"orphaned cache entries: {cached - live}"
    assert db.multi_get(list(range(KEY_SPACE))) == \
        [oracle.get(k) for k in range(KEY_SPACE)]
    db.put(10**6, b"post-recover")
    db.flush()
    assert db.wait_for_quiesce(60)
    assert db.get(10**6) == b"post-recover"
    assert not db.degraded and db.stats.bg_gave_up == 0
    db.close()


def test_double_crash_recover_consolidated_wal():
    """recover() folds the immutable queue's WAL segments into one log, so
    an immediate second crash loses nothing; the port's consolidated log
    replays the reference's records."""
    dbs = [port_db(async_compaction=True, wal_fsync_every_write=True),
           ref_db(async_compaction=True, wal_fsync_every_write=True)]
    oracle = {}
    ops = gen_ops(23, 1500)
    for k, v in ops:
        if v is None:
            oracle.pop(k, None)
        else:
            oracle[k] = v
    for db in dbs:
        apply_ops(db, ops)
        db.crash()
        db.recover()
        db.crash()
        db.recover()
        assert [db.get(k) for k in range(KEY_SPACE)] == \
            [oracle.get(k) for k in range(KEY_SPACE)]
    for db in dbs:
        db.close()


# --------------------------------------------------- concurrent snapshots
@given(st.integers(0, 10_000))
@settings(max_examples=4, deadline=None)
def test_concurrent_snapshot_stress(seed):
    """Reader threads pin snapshots while the foreground churns writes
    through the async pipeline: every reader sees a frozen, internally
    consistent view."""
    db = port_db(async_compaction=True, cache_bytes=1 << 18, bits_per_key=6)
    errors = []
    stop = threading.Event()

    def reader(tid):
        rng = np.random.default_rng(seed + tid)
        try:
            while not stop.is_set():
                snap = db.get_snapshot()
                try:
                    keys = rng.integers(0, KEY_SPACE, 40).tolist()
                    first = db.multi_get(keys, snapshot=snap)
                    scan0 = db.scan(0, 60, snapshot=snap)
                    for _ in range(3):
                        assert db.multi_get(keys, snapshot=snap) == first, \
                            "snapshot view moved under a reader"
                    assert db.scan(0, 60, snapshot=snap) == scan0
                    ks = [k for k, _ in scan0]
                    assert ks == sorted(set(ks)), "scan not strictly sorted"
                    by_key = dict(scan0)
                    probe = db.multi_get(ks[:10], snapshot=snap)
                    assert probe == [by_key[k] for k in ks[:10]]
                finally:
                    db.release_snapshot(snap)
        except Exception as e:            # surface to the main thread
            errors.append(e)

    threads = [threading.Thread(target=reader, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    try:
        for wave in range(6):
            db.write_batch(gen_ops(seed + wave, 600))
            db.flush()
        assert db.wait_for_quiesce(60)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    assert not errors, errors
    assert db.manifest.total_pin_refs() == 0
    db.close()


def test_background_failure_is_loud_and_recoverable():
    """A job that raises is retried ``bg_max_retries`` times, then the
    pipeline dies loudly: the store turns read-only, wait_for_quiesce
    raises, and crash()+recover() restores a working store with all
    fsynced data."""
    db = port_db(async_compaction=True, wal_fsync_every_write=True)
    for k in range(100):
        db.put(k, b"pre")
    db.flush()
    assert db.wait_for_quiesce(60)

    def boom(imm):
        raise RuntimeError("injected background failure")

    db._bg_flush = boom
    for k in range(100, 200):
        db.put(k, b"post")
    db.flush()                            # rotates; the worker job explodes
    with pytest.raises(RuntimeError, match="background compaction failed"):
        db.wait_for_quiesce(60)
    assert db._scheduler.idle()
    assert db.degraded
    assert db.stats.bg_retries == db.config.bg_max_retries == 2
    assert db.stats.bg_gave_up == 1
    with pytest.raises(StoreDegradedError):
        db.put(500, b"refused")
    assert db.get(150) == b"post"         # reads keep serving
    del db._bg_flush
    db.crash()
    db.recover()                          # scheduler is reusable again
    assert not db.degraded
    for k in range(200):
        assert db.get(k) == (b"pre" if k < 100 else b"post"), k
    db.put(1000, b"alive")
    db.flush()
    assert db.wait_for_quiesce(60)
    assert db.get(1000) == b"alive"
    db.close()


def test_close_on_failed_pipeline_folds_stranded_rotations():
    """close() after a background failure folds the stranded rotations
    (and their WAL segments) back into the active memtable."""
    db = port_db(async_compaction=True, wal_fsync_every_write=True)
    for k in range(100):
        db.put(k, b"pre")

    def boom(imm):
        raise RuntimeError("injected background failure")

    db._bg_flush = boom
    db.flush()
    with pytest.raises(RuntimeError, match="background compaction failed"):
        db.close()
    db.close()                            # a second close does not raise
    del db._bg_flush
    assert db._scheduler is None and not db._imm
    for k in range(100):
        assert db.get(k) == b"pre", k
    assert db.total_entries == 100
    db.put(5, b"sync")
    db.flush()
    assert db.get(5) == b"sync" and db.get(6) == b"pre"
    db.crash()
    db.recover()
    assert db.get(7) == b"pre"


def test_snapshotless_readers_race_live_writer():
    """Readers on the live paths (scan, seek, multi_get, total_entries,
    space_amplification) never fail while the writer churns."""
    db = port_db(async_compaction=True)
    stop = threading.Event()
    errors = []

    def reader(seed):
        rng = np.random.default_rng(seed)
        try:
            while not stop.is_set():
                k = int(rng.integers(0, KEY_SPACE))
                got = db.scan(k, 10)
                ks = [x for x, _ in got]
                assert ks == sorted(set(ks))
                db.seek(k)
                db.multi_get([k, k + 1, k + 2])
                assert db.total_entries >= 0
                assert db.space_amplification() >= 0.0
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=reader, args=(t,)) for t in range(3)]
    for t in threads:
        t.start()
    try:
        for wave in range(8):
            for k, v in gen_ops(wave, 400, del_frac=0.1):
                (db.delete(k) if v is None else db.put(k, v))
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    assert not errors, errors
    db.flush()
    assert db.wait_for_quiesce(60)
    db.close()


def test_close_reverts_to_sync_and_state_matches():
    p = port_db(async_compaction=True)
    ops = gen_ops(5, 800)
    apply_ops(p, ops)
    p.close()                             # drains, then sync mode
    apply_ops(p, ops)
    p.flush()
    r = ref_db()
    apply_ops(r, ops)
    apply_ops(r, ops)
    r.flush()
    assert_same_tree(p, r)
    assert_same_reads(p, r)


# ------------------------------------------------ the module's own parts
def test_memtable_sorted_copy_belongs_to_each_memtable():
    """A frozen memtable keeps its key-ordered copy; a copy taken before a
    write is never served after it."""
    mt = rt.core.Memtable(1 << 20)
    mt.put(5, 1, b"a")
    mt.put(3, 2, None)
    keys, items = mt.sorted_entries()
    assert keys.tolist() == [3, 5] and items == [(3, 2, None), (5, 1, b"a")]
    assert mt.sorted_entries()[1] is items          # reused until a write
    mt.put(4, 3, b"b")
    assert mt.scan(0) == [(3, 2, None), (4, 3, b"b"), (5, 1, b"a")]
    frozen = rt.core.ImmutableMemtable(mt, rt.core.WriteAheadLog()).memtable
    copy = frozen.sorted_entries()[1]
    assert frozen.sorted_entries()[1] is copy
    with pytest.raises(RuntimeError, match="frozen"):
        frozen.put(1, 4, b"c")
    with pytest.raises(RuntimeError, match="frozen"):
        frozen.put_batch([1], [b"c"], 4)
    assert frozen.snapshot_items() == [(5, 1, b"a"), (3, 2, None),
                                       (4, 3, b"b")]


def test_worker_budget_resize():
    from repro_torch.core.scheduler import WorkerBudget
    b = WorkerBudget(2)
    assert b.resize(4) and b.size == 4
    with b:
        assert b.resize(3)
    assert all(b.acquire(blocking=False) for _ in range(2))
    assert not b.resize(1) and b.size == 3   # held permits: no shrink
    b.release()
    b.release()
    assert b.resize(1) and b.size == 1


def test_worker_that_cannot_start_fails_the_pipeline_instead_of_hanging():
    """A worker whose device setup fails poisons the pipeline: the store
    degrades, and submit and wait_for_quiesce raise instead of waiting
    for a worker that is gone."""
    from repro_torch.core.scheduler import CompactionScheduler, CompactJob

    class Store:
        device = torch.device("cuda", 10**6)   # no such card: set_device fails
        failure = None

        def _enter_degraded(self, e):
            self.failure = e

    store = Store()
    sched = CompactionScheduler(store, workers=1)
    sched._threads[0].join(timeout=30)
    assert not sched._threads[0].is_alive()
    assert store.failure is not None and sched.idle()
    with pytest.raises(RuntimeError, match="background compaction failed"):
        sched.submit(CompactJob())
    with pytest.raises(RuntimeError, match="background compaction failed"):
        sched.wait_for_quiesce(5)
