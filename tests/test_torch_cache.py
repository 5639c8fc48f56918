"""repro_torch's block cache and pinned L0 on the CPU vs the reference.

Every case of ``tests/test_cache.py``.  The ``BlockCache`` cases run on
the port's cache and on ``repro.core.BlockCache`` for the same access
sequences: the same hits, the same LRU and CLOCK eviction orders (entry
for entry, reference bits included), the same charged bytes.  The store
cases run one seeded workload on ``repro_torch.LSMStore(device="cpu")``
and on ``repro.core.LSMStore`` with the same cache configuration: the same
answers, the same pin sets (by position in L0) and every IOStats field
equal, ``cache_hit_blocks`` and ``cache_miss_blocks`` included.

The reference's ``test_hit_miss_accounting_vs_uncached_twin`` fails on
hypothesis's 200 ms deadline (its assertions hold); the port's twin runs
with ``deadline=None``, as every store-level property case here does.
"""
import dataclasses
from collections import OrderedDict

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core as ref
import repro_torch as rt
from repro_torch.core import BlockCache, IOStats

# Six xdist workers share 8 cores with the reference's timing-bounded
# property tests: one intra-op thread per worker keeps them on time.
torch.set_num_threads(1)

BLOCK_NBYTES = 512


def cfg(cache_bytes=0, pin_l0_bytes=0, policy="clock", **kw):
    base = dict(policy="garnering", c=0.8, T=2.0, memtable_bytes=1 << 11,
                base_level_bytes=1 << 13, bits_per_key=8,
                bloom_allocation="monkey", cache_bytes=cache_bytes,
                pin_l0_bytes=pin_l0_bytes, cache_policy=policy)
    base.update(kw)
    return base


def make_pair(**kw):
    """(port, reference) stores of one cache configuration."""
    c = cfg(**kw)
    return (rt.LSMStore(rt.LSMConfig(**c), device="cpu"),
            ref.LSMStore(ref.LSMConfig(**c)))


def fill(db, seed, n_ops=1200, key_space=300):
    rng = np.random.default_rng(seed)
    oracle = {}
    for i in range(n_ops):
        k = int(rng.integers(0, key_space))
        if rng.random() < 0.15:
            db.delete(k)
            oracle.pop(k, None)
        else:
            v = f"s{seed}i{i}".encode()
            db.put(k, v)
            oracle[k] = v
    db.flush()
    return oracle


def counters(db) -> dict:
    return dataclasses.asdict(db.stats)


def l0_positions(db, run_ids):
    """Positions in L0 of ``run_ids`` (run ids differ between packages)."""
    where = {r.run_id: i for i, r in enumerate(db._levels[0])}
    return sorted(where[rid] for rid in run_ids)


def cache_state(cache, order_of_ids):
    """The evictable order with each entry's (bytes, ref bit), run ids
    replaced by ``order_of_ids``, and the pinned set likewise."""
    return ([((order_of_ids(k[0]), k[1]), tuple(e))
             for k, e in cache._entries.items()],
            sorted((order_of_ids(k[0]), k[1], nb)
                   for k, nb in cache._pinned.items()),
            cache.charged_bytes, cache.pinned_bytes, cache.hits,
            cache.misses, cache.evictions)


def same_cache(port, reference):
    """The two stores' caches hold the same blocks in the same order."""
    def by(db):
        rank = {r.run_id: (li, i) for li, lvl in enumerate(db._levels)
                for i, r in enumerate(lvl)}
        return lambda rid: rank.get(rid, ("dead", rid))
    return cache_state(port.block_cache, by(port)) == \
        cache_state(reference.block_cache, by(reference))


# --------------------------------------------------------------- BlockCache
@settings(max_examples=40)
@given(st.lists(st.tuples(st.integers(0, 4), st.integers(0, 15)),
                min_size=0, max_size=120),
       st.integers(1, 12))
def test_lru_eviction_order_matches_reference_model(accesses, cap_blocks):
    """LRU contents after any access sequence == an OrderedDict LRU model
    == the reference's cache."""
    cache = BlockCache(cap_blocks * BLOCK_NBYTES, policy="lru")
    twin = ref.BlockCache(cap_blocks * BLOCK_NBYTES, policy="lru")
    model = OrderedDict()
    stats, stats_r = IOStats(), ref.IOStats()
    for rid, bid in accesses:
        hit = cache.read_block(rid, bid, BLOCK_NBYTES, stats)
        assert hit == twin.read_block(rid, bid, BLOCK_NBYTES, stats_r)
        assert hit == ((rid, bid) in model)
        if (rid, bid) in model:
            model.move_to_end((rid, bid))
        else:
            while len(model) >= cap_blocks:
                model.popitem(last=False)
            model[(rid, bid)] = True
    assert list(cache._entries) == list(model) == list(twin._entries)
    assert cache.charged_bytes == len(model) * BLOCK_NBYTES
    assert stats.cache_hit_blocks == cache.hits
    assert stats.cache_miss_blocks == cache.misses == stats.blocks_read
    assert dataclasses.asdict(stats) == dataclasses.asdict(stats_r)


@settings(max_examples=40)
@given(st.lists(st.integers(0, 25), min_size=0, max_size=150),
       st.integers(1, 10),
       st.sampled_from(["clock", "lru"]))
def test_cache_capacity_and_accounting_invariants(blocks, cap_blocks, policy):
    """Any policy: the bytes bound holds, hits+misses == accesses, charged
    bytes == the resident entries' sizes, all as in the reference."""
    cache = BlockCache(cap_blocks * BLOCK_NBYTES, policy=policy)
    twin = ref.BlockCache(cap_blocks * BLOCK_NBYTES, policy=policy)
    stats, stats_r = IOStats(), ref.IOStats()
    for bid in blocks:
        cache.read_block(0, bid, BLOCK_NBYTES, stats)
        twin.read_block(0, bid, BLOCK_NBYTES, stats_r)
        assert cache.charged_bytes <= cache.capacity_bytes
        assert cache.charged_bytes == sum(
            e[0] for e in cache._entries.values())
    assert cache.hits + cache.misses == len(blocks)
    assert cache.misses == stats.blocks_read
    assert cache.misses - cache.evictions == len(cache._entries)
    assert cache_state(cache, int) == cache_state(twin, int)


@settings(max_examples=60)
@given(st.lists(st.tuples(st.sampled_from(["read", "span", "batch", "pin",
                                           "retain", "resize"]),
                          st.integers(0, 3), st.integers(0, 30),
                          st.integers(0, 6)),
                min_size=1, max_size=80),
       st.integers(1, 16), st.sampled_from(["clock", "lru"]))
def test_eviction_orders_equal_reference_for_any_sequence(steps, cap_blocks,
                                                          policy):
    """Mixed single, span and batched reads, pin-set swaps, retains and
    resizes with ragged block sizes: the port's cache and the reference's
    hold the same entries in the same order, reference bits included,
    after every step."""
    cache = BlockCache(cap_blocks * BLOCK_NBYTES, policy=policy)
    twin = ref.BlockCache(cap_blocks * BLOCK_NBYTES, policy=policy)
    stats, stats_r = IOStats(), ref.IOStats()

    def size(bid):
        return BLOCK_NBYTES - 37 * (bid % 5)

    for op, rid, a, b in steps:
        for c, s in ((cache, stats), (twin, stats_r)):
            if op == "read":
                c.read_block(rid, a, size(a), s)
            elif op == "span":
                c.read_block_span(rid, a, a + b, size, s)
            elif op == "batch":
                c.read_blocks(rid, [a, a + b, a, b], size, s)
            elif op == "pin":
                c.set_pinned({(rid, x): size(x) for x in range(a % 7, b)})
            elif op == "retain":
                c.retain([r for r in range(4) if r != rid])
            else:
                c.resize((a % cap_blocks + 1) * BLOCK_NBYTES)
        assert cache_state(cache, int) == cache_state(twin, int)
    assert dataclasses.asdict(stats) == dataclasses.asdict(stats_r)


def test_clock_gives_hot_entry_a_second_chance():
    """A re-referenced block survives a full eviction sweep."""
    for c in (BlockCache(4 * BLOCK_NBYTES, policy="clock"),
              ref.BlockCache(4 * BLOCK_NBYTES, policy="clock")):
        stats = IOStats()
        for bid in range(4):
            c.read_block(0, bid, BLOCK_NBYTES, stats)   # fill: 0 oldest
        c.read_block(0, 0, BLOCK_NBYTES, stats)         # set 0's ref bit
        for bid in range(4, 7):
            c.read_block(0, bid, BLOCK_NBYTES, stats)   # 3 evictions
        assert (0, 0) in c
        assert (0, 1) not in c and (0, 2) not in c


def test_pinned_blocks_never_evicted_by_pressure():
    cache = BlockCache(2 * BLOCK_NBYTES, policy="clock")
    stats = IOStats()
    cache.set_pinned({(99, 0): BLOCK_NBYTES, (99, 1): BLOCK_NBYTES})
    for bid in range(20):
        cache.read_block(0, bid, BLOCK_NBYTES, stats)
    assert (99, 0) in cache and (99, 1) in cache
    assert cache.pinned_bytes == 2 * BLOCK_NBYTES
    assert cache.charged_bytes <= cache.capacity_bytes
    s = IOStats()
    assert cache.read_block(99, 0, BLOCK_NBYTES, s)
    assert s.cache_hit_blocks == 1 and s.blocks_read == 0
    with pytest.raises(ValueError, match="policy"):
        BlockCache(1, policy="fifo")


# ------------------------------------------------------- pinned L0 residency
@settings(max_examples=8, deadline=None)
@given(st.integers(1, 5), st.sampled_from(["clock", "lru"]))
def test_pinned_l0_residency_across_flush_and_compaction(seed, policy):
    """After every flush/compaction exactly the L0 runs that fit the pin
    budget are resident (the reference's, by position), and no cached
    block references a dead run."""
    dbs = make_pair(cache_bytes=1 << 16, pin_l0_bytes=1 << 20, policy=policy)
    rng = np.random.default_rng(seed)
    for i in range(900):
        k, v = int(rng.integers(0, 200)), f"x{i}".encode()
        for db in dbs:
            db.put(k, v)
        if i % 90 == 89:
            for db in dbs:
                db.flush()
                assert sorted(db.pinned_l0.pinned_run_ids) == \
                    sorted(r.run_id for r in db._levels[0])
                live = set(db.storage.ids())
                for rid, _ in list(db.block_cache._entries) + \
                        list(db.block_cache._pinned):
                    assert rid in live
                for run in db._levels[0]:
                    s = IOStats()
                    assert db.block_cache.read_block(
                        run.run_id, 0, run.block_bytes(0), s)
                    assert s.blocks_read == 0
            assert l0_positions(dbs[0], dbs[0].pinned_l0.pinned_run_ids) == \
                l0_positions(dbs[1], dbs[1].pinned_l0.pinned_run_ids)
            assert same_cache(*dbs)
    assert dbs[0].block_cache.pinned_bytes <= 1 << 20
    assert counters(dbs[0]) == counters(dbs[1])


def test_pin_budget_prefers_newest_runs():
    """When L0 outgrows pin_l0_bytes, newest runs win the budget, the same
    runs as the reference's."""
    dbs = make_pair(cache_bytes=1 << 16, pin_l0_bytes=1 << 12,
                    l0_compaction_trigger=64, l0_stop_writes_trigger=128,
                    base_level_bytes=1 << 22)
    for db in dbs:
        for wave in range(6):
            for k in range(40):
                db.put(k + 1000 * wave, bytes(40))
            db.flush()
        l0 = db._levels[0]
        assert len(l0) >= 2
        pinned = set(db.pinned_l0.pinned_run_ids)
        assert pinned and db.block_cache.pinned_bytes <= 1 << 12
        assert l0[-1].run_id in pinned
        budget = 1 << 12
        for r in reversed(l0):
            if r.run_id in pinned:
                assert r.data_bytes <= budget
                budget -= r.data_bytes
    assert l0_positions(dbs[0], dbs[0].pinned_l0.pinned_run_ids) == \
        l0_positions(dbs[1], dbs[1].pinned_l0.pinned_run_ids)
    assert dbs[0].cache_summary() == dbs[1].cache_summary()


# -------------------------------------------------- IOStats hit/miss algebra
@settings(max_examples=6, deadline=None)
@given(st.integers(1, 4), st.sampled_from(["clock", "lru"]))
def test_hit_miss_accounting_vs_uncached_twin(seed, policy):
    """On a read-only window the cached store's ``hits + misses`` equals
    the uncached store's ``blocks_read`` and its ``blocks_read`` equals
    its misses, point and range reads alike; each counter equals the
    reference's cached store's."""
    db_u = rt.LSMStore(rt.LSMConfig(**cfg()), device="cpu")
    db_c, ref_c = make_pair(cache_bytes=1 << 22, pin_l0_bytes=1 << 20,
                            policy=policy)
    oracle = fill(db_u, seed)
    assert fill(db_c, seed) == fill(ref_c, seed) == oracle
    queries = list(np.random.default_rng(seed).integers(0, 350, 250))
    s_u, s_c = db_u.stats.snapshot(), db_c.stats.snapshot()
    got_u = [db_u.get(int(k)) for k in queries]
    got_c = [db_c.get(int(k)) for k in queries]
    got_r = [ref_c.get(int(k)) for k in queries]
    assert got_u == got_c == got_r == [oracle.get(int(k)) for k in queries]
    d_u, d_c = db_u.stats.delta(s_u), db_c.stats.delta(s_c)
    assert d_c.blocks_read == d_c.cache_miss_blocks
    assert d_c.cache_hit_blocks + d_c.cache_miss_blocks == d_u.blocks_read
    for f in ("bloom_probes", "bloom_negatives", "runs_touched_point",
              "point_reads"):
        assert getattr(d_c, f) == getattr(d_u, f), f
    s_u, s_c = db_u.stats.snapshot(), db_c.stats.snapshot()
    assert db_u.scan(0, 100) == db_c.scan(0, 100) == ref_c.scan(0, 100)
    d_u, d_c = db_u.stats.delta(s_u), db_c.stats.delta(s_c)
    assert d_c.blocks_read == d_c.cache_miss_blocks
    assert d_c.cache_hit_blocks + d_c.cache_miss_blocks == d_u.blocks_read
    assert counters(db_c) == counters(ref_c)
    assert same_cache(db_c, ref_c)


def test_multi_get_cached_matches_scalar_results():
    """multi_get through the cache returns the scalar gets' answers; a
    warmed, ample cache answers the batch with hits only."""
    dbs = make_pair(cache_bytes=1 << 22, pin_l0_bytes=1 << 20)
    oracles = [fill(db, seed=9) for db in dbs]
    queries = list(np.random.default_rng(2).integers(0, 350, 300)) + [5, 5]
    for db, oracle in zip(dbs, oracles):
        scalar = [db.get(int(k)) for k in queries]
        s0 = db.stats.snapshot()
        batch = db.multi_get(queries)
        d = db.stats.delta(s0)
        assert batch == scalar == [oracle.get(int(k)) for k in queries]
        assert d.cache_miss_blocks == 0 and d.blocks_read == 0
        assert d.cache_hit_blocks > 0
    assert counters(dbs[0]) == counters(dbs[1])
    assert same_cache(*dbs)


@pytest.mark.parametrize("policy", ["lru", "clock"])
def test_zipfian_waves_evict_inside_each_wave(policy):
    """Zipfian ``multi_get`` waves through a cache of four blocks, too
    small for one wave (it evicts inside every wave), beside a pinned L0
    run: the answers equal the uncached twin's, the plain dict's and the
    reference's; wave by wave the cached store's hits + misses equal the
    twin's ``blocks_read`` and its ``blocks_read`` equals its misses; every
    counter and the cache's order equal the reference's."""
    block = 512
    db_u = rt.LSMStore(rt.LSMConfig(**cfg(block_size=block)), device="cpu")
    db_c, ref_c = make_pair(cache_bytes=4 * block, pin_l0_bytes=2 * block,
                            policy=policy, block_size=block)
    oracle = fill(db_u, seed=11, n_ops=2500, key_space=600)
    for db in (db_c, ref_c):
        assert fill(db, seed=11, n_ops=2500, key_space=600) == oracle
    assert db_c.block_cache.pinned_bytes > 0
    # YCSB's zipfian (theta 0.99) over 700 keys, 100 of them never written,
    # the hottest scattered over the key space
    rng = np.random.default_rng(7)
    space = 700
    p = 1.0 / np.arange(1, space + 1) ** 0.99
    hot = rng.permutation(space)
    for _ in range(6):
        keys = hot[rng.choice(space, 256, p=p / p.sum())].tolist()
        s_u, s_c = db_u.stats.snapshot(), db_c.stats.snapshot()
        evicted = db_c.block_cache.evictions
        got = [db.multi_get(keys) for db in (db_c, db_u, ref_c)]
        assert got[0] == got[1] == got[2] == [oracle.get(k) for k in keys]
        d_u, d_c = db_u.stats.delta(s_u), db_c.stats.delta(s_c)
        assert d_c.cache_hit_blocks + d_c.cache_miss_blocks == d_u.blocks_read
        assert d_c.blocks_read == d_c.cache_miss_blocks
        assert d_c.cache_hit_blocks > 0
        assert d_c.cache_miss_blocks > 4 and \
            db_c.block_cache.evictions > evicted
    assert counters(db_c) == counters(ref_c)
    assert same_cache(db_c, ref_c)


# ------------------------------------------------------ acceptance criterion
@pytest.mark.parametrize("policy", ["clock", "lru"])
def test_cached_reads_cheaper_identical_results(policy):
    """pin_l0_bytes sized to hold L0: point and range reads over a
    compacted store report hits and strictly fewer charged blocks than the
    cache-disabled store, identical values; every counter equals the
    reference's."""
    db_off = rt.LSMStore(rt.LSMConfig(**cfg()), device="cpu")
    db_on, ref_on = make_pair(cache_bytes=1 << 21, pin_l0_bytes=1 << 21,
                              policy=policy)
    oracle = fill(db_off, seed=3, n_ops=2500)
    assert fill(db_on, seed=3, n_ops=2500) == oracle
    fill(ref_on, seed=3, n_ops=2500)
    assert db_on.stats.compactions > 0
    queries = list(np.random.default_rng(4).integers(0, 400, 500))
    expect = [oracle.get(int(k)) for k in queries]
    wants = {start: db_off.scan_scalar(start, 60) for start in (0, 100, 333)}
    s_off, s_on = db_off.stats.snapshot(), db_on.stats.snapshot()
    for db in (db_off, db_on, ref_on):
        assert [db.get(int(k)) for k in queries] == expect
        for start, want in wants.items():
            assert db.scan(start, 60) == want
        assert db.seek(101) == db_off.seek(101)
    d_off, d_on = db_off.stats.delta(s_off), db_on.stats.delta(s_on)
    assert d_on.cache_hit_blocks > 0
    assert d_on.blocks_read < d_off.blocks_read
    assert counters(db_on) == counters(ref_on)


def test_configure_cache_on_live_store_and_detach():
    dbs = make_pair()
    oracle = [fill(db, seed=7) for db in dbs][0]
    base = [oracle.get(k) for k in range(50)]
    for db in dbs:
        assert [db.get(k) for k in range(50)] == base
        db.configure_cache(1 << 20, 1 << 20)
        assert [db.get(k) for k in range(50)] == base
        assert db.stats.cache_hit_blocks + db.stats.cache_miss_blocks > 0
        assert db.cache_summary()["enabled"]
    assert dbs[0].cache_summary() == dbs[1].cache_summary()
    for db in dbs:
        db.configure_cache(0, 0)              # detach: raw accounting again
        s0 = db.stats.snapshot()
        assert [db.get(k) for k in range(50)] == base
        d = db.stats.delta(s0)
        assert d.cache_hit_blocks == 0 and d.cache_miss_blocks == 0
        assert d.blocks_read > 0
        assert not db.cache_summary()["enabled"]
    assert counters(dbs[0]) == counters(dbs[1])


def test_cache_invalidation_on_compaction_and_recover():
    dbs = make_pair(cache_bytes=1 << 20, pin_l0_bytes=1 << 20)
    for db in dbs:
        fill(db, seed=11, n_ops=2000)
        [db.get(k) for k in range(100)]           # populate cache
        for rid, _ in list(db.block_cache._entries) + \
                list(db.block_cache._pinned):
            assert rid in set(db.storage.ids())
        # crash + recover: the cache is volatile, the pin set is rebuilt
        # from the recovered L0, and reloading it is charged
        s0 = db.stats.snapshot()
        db.crash()
        db.recover()
        d = db.stats.delta(s0)
        n_pinned = len(db.block_cache._pinned)
        assert d.cache_miss_blocks == d.blocks_read == n_pinned
        assert db.block_cache.charged_bytes == 0
        assert sorted(db.pinned_l0.pinned_run_ids) == \
            sorted(r.run_id for r in db._levels[0] if len(r))
        s0 = db.stats.snapshot()
        db.get(0)
        assert db.stats.delta(s0).point_reads == 1
    assert counters(dbs[0]) == counters(dbs[1])
    assert same_cache(*dbs)


# ------------------------------------------------------ snapshot refcounting
def test_snapshot_refcounting_shared_version():
    """Two readers pinning one version: the first release must not unpin."""
    db = rt.LSMStore(rt.LSMConfig(**cfg()), device="cpu")
    for k in range(60):
        db.put(k, b"old")
    db.flush()
    s1 = db.get_snapshot()
    s2 = db.get_snapshot()
    assert s1.version_id == s2.version_id
    assert db.manifest.pin_count(s1.version_id) == 2
    for rep in range(20):
        for k in range(60):
            db.put(k, f"r{rep}".encode())
        db.flush()
    db.release_snapshot(s1)
    assert db.manifest.pin_count(s2.version_id) == 1
    assert db.get(5, snapshot=s2) == b"old"
    assert db.scan(5, 2, snapshot=s2) == [(5, b"old"), (6, b"old")]
    db.release_snapshot(s2)
    assert db.manifest.pin_count(s2.version_id) == 0
    assert db.get(5) == b"r19"
    db.release_snapshot(s2)
    assert db.manifest.pin_count(s2.version_id) == 0


def test_snapshot_reads_with_cache_enabled_survive_churn():
    """Snapshot-pinned runs keep their cached blocks across compactions;
    the release drops them, as in the reference."""
    dbs = make_pair(cache_bytes=1 << 20, pin_l0_bytes=1 << 16)
    for db in dbs:
        for k in range(80):
            db.put(k, b"snap")
        db.flush()
        snap = db.get_snapshot()
        for rep in range(15):
            for k in range(80):
                db.put(k, f"n{rep}".encode())
            db.flush()
        assert db.multi_get([1, 2, 3], snapshot=snap) == [b"snap"] * 3
        live = set(db.storage.ids())
        assert all(rid in live for rid, _ in db.block_cache._entries)
        db.release_snapshot(snap)
        live = set(db.storage.ids())
        assert all(rid in live for rid, _ in db.block_cache._entries)
    assert counters(dbs[0]) == counters(dbs[1])
    assert dbs[0].cache_summary() == dbs[1].cache_summary()
