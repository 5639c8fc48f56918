"""repro_torch's sharded facade on the CPU vs the reference's, case for case.

Every case of ``tests/test_sharded.py`` runs on
``repro_torch.core.ShardedLSMStore`` (device ``"cpu"``) beside
``repro.core.ShardedLSMStore`` and the reference's plain store, the oracle:
the same ``get``/``multi_get``/``scan``/``seek`` answers at every wave, the
same shard of every key, crash and recovery of every shard with no lost
fsynced write, leaked pin or orphaned cache entry, readers racing two
shards' workers, the shared block cache's namespaces (eviction orders and
budgets equal to the reference's ``BlockCacheView``), ``IOStats``
aggregation, the factory and its validation, and snapshots never torn by a
cross-shard writer.  Beyond the reference file: splitters at
``2**63 - 1``, ``2**63`` and ``2**63 + 1``, where the port's order map
flips the sign bit, for the host split and for a migration's split of the
exported columns on the device.  All lanes are integer: tolerance 0.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as ref
import repro_torch.core as pc
from repro_torch.core.run import levels_bit_equal
from repro_torch.core.sharded import _Routing
from repro_torch.kernels import ops
from test_torch_store import assert_same_tree

# Six xdist workers share 8 cores with the reference's timing-bounded
# property tests: one intra-op thread per worker keeps them on time.
torch.set_num_threads(1)

KEY_SPACE = 400


def _kw(m):
    return {"device": "cpu"} if m is pc else {}


def cfg(m, **kw):
    base = dict(policy="garnering", T=2.0, c=0.8, memtable_bytes=1 << 12,
                base_level_bytes=1 << 14, bits_per_key=8,
                bloom_allocation="monkey")
    base.update(kw)
    return m.LSMConfig(**base)


def sharded_cfg(m, shards, key_space=KEY_SPACE, **kw):
    return cfg(m, shards=shards,
               shard_splitters=m.uniform_splitters(shards, key_space), **kw)


def make(m, config):
    return m.make_store(config, **_kw(m))


def facade(m, config):
    return m.ShardedLSMStore(config, **_kw(m))


def plain(m, config):
    return m.LSMStore(config, **_kw(m))


def gen_ops(seed: int, n_ops: int, key_space: int = KEY_SPACE,
            del_frac: float = 0.2):
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n_ops):
        k = int(rng.integers(0, key_space))
        if rng.random() < del_frac:
            ops.append((k, None))
        else:
            ops.append((k, bytes([65 + i % 26]) * int(rng.integers(0, 80))))
    return ops


def close_quiet(db):
    if hasattr(db, "close"):
        db.close()


def seek_invariant(db, k):
    """``k <= seek(k) <= first live key >= k``; past the last live key a
    flushed tombstone may still answer, at or above ``k``."""
    got = db.seek(k)
    live = db.scan(k, 1)
    if live:
        assert got is not None and k <= got <= live[0][0], (k, got)
    elif got is not None:
        assert got >= k
    return got


# ------------------------------------------------------- differential oracle
@given(st.integers(0, 10_000), st.sampled_from([1, 2, 4]))
@settings(max_examples=8, deadline=None)
def test_sharded_reads_identical_to_single_store(seed, shards):
    """Interleaved batches on an async port facade (parallel schedulers)
    and on the reference's, against the reference's synchronous plain
    store: equal reads at every wave (mid-churn) and after quiesce."""
    oracle = ref.LSMStore(cfg(ref))
    dbs = [make(m, sharded_cfg(m, shards, async_compaction=True,
                                compaction_workers=2)) for m in (pc, ref)]
    rng = np.random.default_rng(seed)
    try:
        for wave in range(4):
            ops = gen_ops(seed + 31 * wave, 500)
            if wave % 2:
                puts = [(k, v) for k, v in ops if v is not None]
                dels = [k for k, v in ops if v is None]
                for store in [oracle] + dbs:
                    store.put_batch([k for k, _ in puts],
                                    [v for _, v in puts])
                    store.delete_batch(dels)
            else:
                for store in [oracle] + dbs:
                    store.write_batch(ops)
            probes = rng.integers(0, KEY_SPACE, 32).tolist()
            want = oracle.multi_get(probes)
            start = int(rng.integers(0, KEY_SPACE))
            for db in dbs:
                assert db.multi_get(probes) == want
                assert db.scan(start, 40) == oracle.scan(start, 40)
        oracle.flush()
        for db in dbs:
            db.flush()
            assert db.wait_for_quiesce(60)
        keys = list(range(KEY_SPACE))
        full = oracle.scan_scalar(0, KEY_SPACE)
        for db in dbs:
            assert db.multi_get(keys) == oracle.multi_get(keys)
            assert [db.get(k) for k in range(0, KEY_SPACE, 7)] == \
                [oracle.get(k) for k in range(0, KEY_SPACE, 7)]
            assert db.scan(0, KEY_SPACE) == full
            assert db.scan_scalar(0, KEY_SPACE) == full
            for k in (0, KEY_SPACE // 3, KEY_SPACE - 1):
                seek_invariant(db, k)
            assert db.total_live_entries() == oracle.total_live_entries()
    finally:
        for db in dbs:
            close_quiet(db)


def test_shards1_facade_is_bit_for_bit_plain_store():
    """``shards=1``: the facade's one shard is the port's plain store bit
    for bit, and the reference's plain store column for column."""
    ops = gen_ops(3, 2000)
    plain_p = plain(pc, cfg(pc))
    facade_p = facade(pc, cfg(pc, shards=1))
    plain_r = ref.LSMStore(cfg(ref))
    for db in (plain_p, facade_p, plain_r):
        db.write_batch(ops)
        db.flush()
    assert levels_bit_equal(plain_p._levels, facade_p.shards[0]._levels)
    assert facade_p.shards[0].memtable._data == plain_p.memtable._data
    assert facade_p.shards[0]._seq == plain_p._seq == plain_r._seq
    assert_same_tree(facade_p.shards[0], plain_r)


def test_cross_shard_scan_spans_boundaries():
    dbs = [make(m, sharded_cfg(m, 4, key_space=100)) for m in (pc, ref)]
    oracle = ref.LSMStore(cfg(ref))
    for k in range(100):
        v = f"v{k}".encode()
        for db in dbs + [oracle]:
            db.put(k, v)
    for start, count in [(20, 10), (24, 2), (25, 1), (0, 100), (99, 5),
                         (23, 60)]:
        for db in dbs:
            assert db.scan(start, count) == \
                oracle.scan_scalar(start, count), (start, count)
    for db in dbs:
        assert db.seek(25) == 25
        assert db.seek(100) is None


def shard_of_each_key(db):
    return {k: si for si, s in enumerate(db.shards)
            for k, _ in s.scan(0, 1000)}


def test_splitter_boundary_keys_route_consistently():
    """A key equal to a splitter belongs to the upper shard, on both."""
    keys = (0, 24, 25, 26, 49, 50, 74, 75, 99)
    maps = []
    for m in (pc, ref):
        db = facade(m, sharded_cfg(m, 4, key_space=100))
        for k in keys:
            db.put(k, b"x" * k)
        db.flush()
        present = [(si, k) for si, s in enumerate(db.shards)
                   for k, _ in s.scan(0, 1000)]
        assert sorted(k for _, k in present) == list(keys)
        assert len({k for _, k in present}) == len(present)   # one shard
        by_key = dict((k, si) for si, k in present)
        assert by_key[24] == 0 and by_key[25] == 1  # boundary goes up
        for k in by_key:
            assert db.get(k) == b"x" * k
        maps.append(by_key)
    assert maps[0] == maps[1]


SIGN_EDGE = [2**63 - 1, 2**63, 2**63 + 1]
EDGE_KEYS = sorted({0, 1, 2**62, 2**63 - 2, 2**63 - 1, 2**63, 2**63 + 1,
                    2**63 + 2, 2**63 + 2**62, 2**64 - 2, 2**64 - 1})


@pytest.mark.parametrize("splitter", SIGN_EDGE)
def test_order_mapped_splitters_route_and_migrate(splitter):
    """Splitters where the port's order map flips the sign bit: the host
    split sends each key to the reference's shard, and a migration across
    the sign bit and back (the exported columns split on the device
    against the order-mapped splitters) leaves every shard holding exactly
    its range, equal to the reference's, every read equal."""
    dbs = [facade(m, cfg(m, shards=2, shard_splitters=(splitter,)))
           for m in (pc, ref)]
    for db in dbs:
        for k in EDGE_KEYS:
            db.put(k, b"e%d" % (k % 1000))
        db.delete(2**63 + 2)
        db.flush()
    maps = [shard_of_each_key(db) for db in dbs]
    assert maps[0] == maps[1]
    assert {k: si for k, si in maps[0].items()} == {
        k: int(k >= splitter) for k in EDGE_KEYS if k != 2**63 + 2}
    targets = [s for s in SIGN_EDGE if s != splitter] + [2**62, splitter]
    for target in targets:
        for db in dbs:
            assert db.rebalance_to([target])
            for si, s in enumerate(db.shards):
                lo, hi = db._routing.bounds(si)
                assert all(lo <= k < hi for k, _ in s.scan(0, 1000)), si
        assert shard_of_each_key(dbs[0]) == shard_of_each_key(dbs[1])
        for k in EDGE_KEYS:
            assert dbs[0].get(k) == dbs[1].get(k), k
        assert dbs[0].multi_get(EDGE_KEYS) == dbs[1].multi_get(EDGE_KEYS)
        for start in EDGE_KEYS:
            assert dbs[0].scan(start, 5) == dbs[1].scan(start, 5), start
            assert dbs[0].seek(start) == dbs[1].seek(start), start
    assert dbs[0].migrated_entries == dbs[1].migrated_entries > 0
    routing = _Routing([splitter])
    host = routing.split(np.asarray(EDGE_KEYS, dtype=np.uint64))
    dev = routing.split_on_device(ops.keys_to_device(EDGE_KEYS, "cpu"))
    np.testing.assert_array_equal(dev.numpy(), host)


# ------------------------------------------------------------ crash safety
def test_crash_mid_load_recovers_all_shards():
    """Crash with background jobs in flight on several shards: every
    fsynced write back, no pin leaked, the shared cache holding only live
    namespaced blocks, and the facade writable after recovery."""
    db = facade(pc, sharded_cfg(
        pc, 4, async_compaction=True, compaction_workers=2,
        wal_fsync_every_write=True, cache_bytes=1 << 18,
        pin_l0_bytes=1 << 16))
    oracle = {}
    for k, v in gen_ops(11, 3000):
        (db.delete(k) if v is None else db.put(k, v))
        if v is None:
            oracle.pop(k, None)
        else:
            oracle[k] = v
    db.crash()
    for s in db.shards:
        assert s._scheduler.pending() == 0
        assert s.manifest.total_pin_refs() == 0, "leaked version pins"
    db.recover()
    live = {(si, rid) for si, s in enumerate(db.shards)
            for rid in s.storage.ids()}
    cached = {k[0] for k in
              set(db.block_cache._entries) | set(db.block_cache._pinned)}
    assert cached <= live, f"orphaned cache entries: {cached - live}"
    assert db.multi_get(list(range(KEY_SPACE))) == \
        [oracle.get(k) for k in range(KEY_SPACE)]
    db.put(10**6, b"post-recover")
    db.flush()
    assert db.wait_for_quiesce(60)
    assert db.get(10**6) == b"post-recover"
    db.close()


def test_sharded_double_crash_recover():
    dbs = [facade(m, sharded_cfg(m, 2, async_compaction=True,
                                 wal_fsync_every_write=True))
           for m in (pc, ref)]
    oracle = {}
    for k, v in gen_ops(23, 1500):
        for db in dbs:
            (db.delete(k) if v is None else db.put(k, v))
        if v is None:
            oracle.pop(k, None)
        else:
            oracle[k] = v
    want = [oracle.get(k) for k in range(KEY_SPACE)]
    for db in dbs:
        db.crash()
        db.recover()
        db.crash()
        db.recover()
        assert [db.get(k) for k in range(KEY_SPACE)] == want
        db.close()


# --------------------------------------------- concurrent compaction/readers
@given(st.integers(0, 10_000))
@settings(max_examples=3, deadline=None)
def test_concurrent_readers_with_parallel_shard_compaction(seed):
    """Reader threads on live and snapshot paths while both shards'
    workers flush and compact under a budget of two: scans sorted,
    snapshots frozen, and the final state the reference oracle's."""
    db = facade(pc, sharded_cfg(pc, 2, async_compaction=True,
                                compaction_workers=2,
                                cache_bytes=1 << 18, bits_per_key=6))
    oracle = ref.LSMStore(cfg(ref, bits_per_key=6))
    errors = []
    stop = threading.Event()

    def reader(tid):
        rng = np.random.default_rng(seed + tid)
        try:
            while not stop.is_set():
                keys = rng.integers(0, KEY_SPACE, 24).tolist()
                got = db.scan(int(rng.integers(0, KEY_SPACE)), 30)
                ks = [k for k, _ in got]
                assert ks == sorted(set(ks)), "scan not strictly sorted"
                db.multi_get(keys)
                snap = db.get_snapshot()
                try:
                    first = db.multi_get(keys, snapshot=snap)
                    assert db.multi_get(keys, snapshot=snap) == first, \
                        "snapshot view moved under a reader"
                finally:
                    db.release_snapshot(snap)
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=reader, args=(t,)) for t in range(3)]
    for t in threads:
        t.start()
    try:
        for wave in range(5):
            ops = gen_ops(seed + wave, 700)
            db.write_batch(ops)
            oracle.write_batch(ops)
        db.flush()
        oracle.flush()
        assert db.wait_for_quiesce(60)
        assert all(s.stats.bg_flushes > 0 for s in db.shards)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not errors, errors
    keys = list(range(KEY_SPACE))
    assert db.multi_get(keys) == oracle.multi_get(keys)
    assert db.scan(0, KEY_SPACE) == oracle.scan(0, KEY_SPACE)
    db.close()


# ------------------------------------------------------- shared block cache
def cache_state(cache):
    """Everything a cache decides: entry order with clock bits, pins,
    byte counts (global and by namespace), counters."""
    return (list(cache._entries.items()), dict(cache._pinned),
            cache.charged_bytes, cache.pinned_bytes,
            dict(cache._ns_bytes),
            {ns: list(k) for ns, k in cache._ns_keys.items()},
            cache.hits, cache.misses, cache.evictions)


def test_shared_cache_retain_is_namespace_scoped():
    states = []
    for m in (pc, ref):
        cache = m.BlockCache(1 << 20, "lru")
        va = m.BlockCacheView(cache, 0, 1 << 19)
        vb = m.BlockCacheView(cache, 1, 1 << 19)
        stats = m.IOStats()
        va.read_block(101, 0, 4096, stats)
        vb.read_block(101, 0, 4096, stats)   # shard 1's own run 101
        vb.read_block(202, 1, 4096, stats)
        assert len(cache._entries) == 3      # namespaced: no alias
        va.retain([999])
        assert (101, 0) not in va
        assert (101, 0) in vb and (202, 1) in vb
        va.read_block(303, 0, 4096, stats)
        va.clear()
        assert (101, 0) in vb and (303, 0) not in va
        states.append((cache_state(cache), dataclasses.asdict(stats)))
    assert states[0] == states[1]


def test_shared_cache_pin_sets_are_namespace_scoped():
    states = []
    for m in (pc, ref):
        cache = m.BlockCache(1 << 20, "clock")
        va = m.BlockCacheView(cache, 0, 1 << 19)
        vb = m.BlockCacheView(cache, 1, 1 << 19)
        va.set_pinned({(1, 0): 4096, (1, 1): 4096})
        vb.set_pinned({(7, 0): 2048})
        assert va.pinned_bytes == 8192 and vb.pinned_bytes == 2048
        assert cache.pinned_bytes == 8192 + 2048
        va.set_pinned({(2, 0): 4096})
        assert (7, 0) in vb
        assert cache.pinned_bytes == 4096 + 2048
        states.append(cache_state(cache))
    assert states[0] == states[1]


@pytest.mark.parametrize("policy", ["lru", "clock"])
def test_shared_cache_budget_evicts_within_namespace_only(policy):
    """Pressure in one namespace evicts that namespace's cold entries,
    never a sibling's; the reference's case (LRU), and the same sequence
    with hits under CLOCK, in the reference's order."""
    states = []
    for m in (pc, ref):
        cache = m.BlockCache(4 * 4096, policy)
        va = m.BlockCacheView(cache, 0, 2 * 4096)
        vb = m.BlockCacheView(cache, 1, 2 * 4096)
        stats = m.IOStats()
        vb.read_block(9, 0, 4096, stats)
        vb.read_block(9, 1, 4096, stats)
        for bid in range(4):
            va.read_block(5, bid, 4096, stats)
            if policy == "clock":
                va.read_block(5, bid, 4096, stats)   # set the reference bit
        assert va.charged_bytes == 2 * 4096
        assert (9, 0) in vb and (9, 1) in vb
        assert cache.charged_bytes == 4 * 4096
        if policy == "lru":
            assert (5, 2) in va and (5, 3) in va
            assert (5, 0) not in va and (5, 1) not in va
        va.read_blocks(5, [0, 7, 8], lambda b: 4096, stats)
        vb.resize(4096)
        vb.read_block(9, 2, 4096, stats)
        states.append((cache_state(cache), dataclasses.asdict(stats)))
    assert states[0] == states[1]


def test_sharded_store_shares_one_cache_with_per_shard_budgets():
    summaries = []
    for m in (pc, ref):
        db = facade(m, sharded_cfg(m, 2, cache_bytes=1 << 18,
                                   pin_l0_bytes=1 << 14))
        assert db.block_cache is not None
        assert all(s.block_cache.cache is db.block_cache for s in db.shards)
        assert [s.block_cache.budget_bytes for s in db.shards] == \
            [(1 << 18) // 2] * 2
        for k, v in gen_ops(7, 1500, del_frac=0.0):
            db.put(k, v)
        db.flush()
        rng = np.random.default_rng(2)
        for _ in range(3):
            db.multi_get(rng.integers(0, KEY_SPACE, 64).tolist())
        summ = db.cache_summary()
        assert summ["enabled"] and summ["hits"] > 0
        assert summ["charged_bytes"] == sum(
            s.block_cache.charged_bytes for s in db.shards)
        summaries.append((summ, dataclasses.asdict(db.stats)))
        db.configure_cache(0, 0)
        assert db.block_cache is None
        assert all(s.block_cache is None for s in db.shards)
    assert summaries[0] == summaries[1]


# ----------------------------------------------------------- IOStats merge
def test_iostats_add_and_merge_cover_every_field():
    a, b = pc.IOStats(), pc.IOStats()
    for i, f in enumerate(dataclasses.fields(pc.IOStats)):
        setattr(a, f.name, i + 1)
        setattr(b, f.name, 100 * (i + 1))
    tot = a + b
    for i, f in enumerate(dataclasses.fields(pc.IOStats)):
        assert getattr(tot, f.name) == 101 * (i + 1), f.name
    assert [f.name for f in dataclasses.fields(pc.IOStats)] == \
        [f.name for f in dataclasses.fields(ref.IOStats)]
    assert pc.IOStats.merge([a, b, pc.IOStats()]).blocks_read == \
        tot.blocks_read
    assert sum([a, b]).wal_appends == tot.wal_appends
    assert a.blocks_read == 1


def test_facade_stats_aggregate_per_shard_counters():
    deltas = []
    for m in (pc, ref):
        db = facade(m, sharded_cfg(m, 4, async_compaction=True,
                                   compaction_workers=2))
        try:
            db.write_batch(gen_ops(5, 2000, del_frac=0.0))
            db.flush()
            assert db.wait_for_quiesce(60)
            keys = list(range(KEY_SPACE))
            s0 = db.stats.snapshot()
            db.multi_get(keys)
            d = db.stats.delta(s0)
            assert d.point_reads == len(keys)
            assert db.stats.bg_flushes == sum(s.stats.bg_flushes
                                              for s in db.shards)
            assert db.stats.entries_flushed == sum(s.stats.entries_flushed
                                                   for s in db.shards)
            deltas.append((dataclasses.asdict(d), db.stats.bg_flushes,
                           db.stats.entries_flushed,
                           [s.stats.to_dict()["blocks_read"]
                            for s in db.shards]))
        finally:
            db.close()
    assert deltas[0] == deltas[1]


# ------------------------------------------------------------- construction
def test_make_store_factory_and_validation():
    assert isinstance(make(pc, cfg(pc)), pc.LSMStore)
    assert isinstance(make(pc, cfg(pc, shards=1)), pc.LSMStore)
    db = make(pc, cfg(pc, shards=3))
    assert isinstance(db, pc.ShardedLSMStore) and len(db.shards) == 3
    assert len(db._splitters) == 2
    assert db.splitters == ref.make_store(cfg(ref, shards=3)).splitters
    assert all(s.device == torch.device("cpu") for s in db.shards)
    with pytest.raises(ValueError):
        facade(pc, cfg(pc, shards=3, shard_splitters=(10,)))
    with pytest.raises(ValueError):
        facade(pc, cfg(pc, shards=3, shard_splitters=(20, 10)))
    # runtime knobs on the facade's config reach every shard (live share)
    db.config.paranoid_checks = True
    assert all(s.config.paranoid_checks for s in db.shards)


# --------------------------------------------------- torn cross-shard snapshots
def test_snapshot_never_torn_by_racing_cross_shard_writer():
    """A writer landing on both shards inside the write gate, against a
    snapshot taker whose second pin is delayed: every snapshot sees both
    halves of a generation or neither."""
    db = facade(pc, cfg(pc, shards=2, shard_splitters=(KEY_SPACE // 2,),
                        memtable_bytes=1 << 12))
    k0, k1 = KEY_SPACE // 4, 3 * KEY_SPACE // 4
    inner = db.shards[1].get_snapshot

    def delayed():
        time.sleep(0.0005)
        return inner()

    db.shards[1].get_snapshot = delayed
    torn = []
    stop = threading.Event()

    def snapshotter():
        while not stop.is_set():
            snap = db.get_snapshot()
            try:
                a = db.get(k0, snapshot=snap)
                b = db.get(k1, snapshot=snap)
                if a != b:
                    torn.append((a, b))
            finally:
                db.release_snapshot(snap)

    t = threading.Thread(target=snapshotter)
    t.start()
    try:
        for i in range(120):
            v = b"gen-%06d" % i
            db.write_batch([(k0, v), (k1, v)])
            db.flush()
    finally:
        stop.set()
        t.join(timeout=30)
        db.shards[1].get_snapshot = inner
    assert not torn, f"torn snapshots observed: {torn[:5]}"
    for s in db.shards:
        assert s.manifest.pin_count(s.manifest.current().version_id) == 0


def test_snapshot_validate_retry_survives_background_installs():
    db = facade(pc, sharded_cfg(pc, 2, async_compaction=True,
                                compaction_workers=2))
    try:
        for i in range(6):
            db.write_batch(gen_ops(90 + i, 400))
            for _ in range(20):
                snap = db.get_snapshot()
                assert len(snap.versions) == 2
                for s, v in zip(db.shards, snap.versions):
                    assert s.manifest.pin_count(v.version_id) >= 1
                db.release_snapshot(snap)
        db.flush()
        assert db.wait_for_quiesce(60)
        snap = db.get_snapshot()
        live = db.total_live_entries()
        got = db.scan(0, KEY_SPACE + 1, snapshot=snap)
        assert len(got) == live
        db.release_snapshot(snap)
        for s in db.shards:
            assert s.manifest.total_pin_refs() == 0
    finally:
        close_quiet(db)


# ------------------------------------- tombstones straddling a splitter bound
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_scan_seek_tombstones_straddling_splitters(shards):
    """Delete bands on every splitter and the key space's edges: the
    facades' scans equal the reference oracle's ``scan_scalar`` with the
    tombstones in memtables and after they flush; seeks equal the
    oracle's while the tombstones are in memtables, then keep the
    cost-probe invariant."""
    oracle = ref.LSMStore(cfg(ref))
    dbs = [make(m, sharded_cfg(m, shards)) for m in (pc, ref)]
    splitters = list(ref.uniform_splitters(shards, KEY_SPACE))
    for k in range(KEY_SPACE):
        v = b"s%d-%d" % (shards, k)
        for db in dbs + [oracle]:
            db.put(k, v)
    for db in dbs + [oracle]:
        db.flush()
    bands = [range(max(0, s - 12), min(KEY_SPACE, s + 12))
             for s in splitters]
    bands.append(range(0, 9))
    bands.append(range(KEY_SPACE - 9, KEY_SPACE))
    doomed = sorted({k for b in bands for k in b})
    for k in doomed:
        for db in dbs + [oracle]:
            db.delete(k)
    probes = sorted({p for s in splitters + [0, KEY_SPACE - 1]
                     for p in (s - 13, s - 12, s - 1, s, s + 1, s + 11,
                               s + 12)
                     if 0 <= p < KEY_SPACE})
    for p in probes:
        want = oracle.scan_scalar(p, 30)
        for db in dbs:
            assert db.scan(p, 30) == want, p
            assert db.seek(p) == oracle.seek(p), p
    for db in dbs + [oracle]:
        db.flush()
    for p in probes:
        want = oracle.scan_scalar(p, 30)
        seeks = []
        for db in dbs:
            got = db.scan(p, 30)
            assert got == want == db.scan_scalar(p, 30), p
            seeks.append(seek_invariant(db, p))
        assert seeks[0] == seeks[1], p
    full = oracle.scan_scalar(0, KEY_SPACE)
    for db in dbs:
        assert db.scan(0, KEY_SPACE) == full
        assert db.total_live_entries() == oracle.total_live_entries()
