"""repro_torch's shard rebalancing on the CPU vs the reference's, case for case.

Every case of ``tests/test_rebalance.py`` runs on the port's
``ShardedLSMStore`` (device ``"cpu"``) beside the reference's facade and its
plain store, the oracle: reads equal through automatic and explicit
splits, merges and cross-shard run migrations; the trigger quiet under
uniform load; the splitters, ``migrated_entries`` and shared-cache budgets
equal to the reference's after ``rebalance_to``; snapshots pinned before a
migration reading the old state after it; a crash before and after the
routing commit recovering the exact pre- and post-migration state; the
quiesce boundary consuming the idle hook's flag; rebalance events and the
load summary; and the bulk-load-then-serve ``arm_rebalancing``.

The property test's ``seed=9197, shards=2`` is where the reference fails
(its ``seek`` skips a live memtable key behind a memtable tombstone, and
sharding multiplies the flush boundaries where that shows); the port, with
the plain ``seek``, must pass it.  All lanes are integer: tolerance 0.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as ref
import repro_torch.core as pc

try:
    from hypothesis import example
except ImportError:     # the fixed-seed shim has no explicit examples
    def example(**explicit):
        def deco(fn):
            done = []

            @functools.wraps(fn)
            def run(*args, **kwargs):
                if not done:
                    done.append(True)
                    fn(**explicit)
                return fn(*args, **kwargs)
            return run
        return deco

# Six xdist workers share 8 cores with the reference's timing-bounded
# property tests: one intra-op thread per worker keeps them on time.
torch.set_num_threads(1)

KEY_SPACE = 4_000


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


def facade(m, config):
    return m.ShardedLSMStore(config, **_kw(m))


def close_quiet(db):
    if hasattr(db, "close"):
        db.close()


def hot_ops(seed, n_ops, hot_lo=0, hot_hi=KEY_SPACE // 10,
            hot_frac=0.9, del_frac=0.1):
    """Skewed op stream: ``hot_frac`` of ops in [hot_lo, hot_hi)."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n_ops):
        if rng.random() < hot_frac:
            k = int(rng.integers(hot_lo, hot_hi))
        else:
            k = int(rng.integers(0, KEY_SPACE))
        if rng.random() < del_frac:
            ops.append((k, None))
        else:
            ops.append((k, bytes([65 + i % 26]) * int(rng.integers(1, 60))))
    return ops


def assert_reads_equal(db, oracle, rng, scans=4):
    probes = rng.integers(0, KEY_SPACE, 256).tolist()
    assert db.multi_get(probes) == oracle.multi_get(probes)
    for _ in range(scans):
        start = int(rng.integers(0, KEY_SPACE))
        assert db.scan(start, 50) == oracle.scan(start, 50)
    k = int(rng.integers(0, KEY_SPACE))
    live = db.scan(k, 1)
    got = db.seek(k)
    if live:
        assert got is not None and k <= got <= live[0][0], (k, got, live)


def no_leaked_pins(db):
    for s in db.shards:
        assert s.manifest.total_pin_refs() == 0, "leaked version pins"


def assert_full_reads(db, oracle):
    keys = list(range(KEY_SPACE))
    assert db.multi_get(keys) == oracle.multi_get(keys)
    assert db.scan(0, KEY_SPACE) == oracle.scan_scalar(0, KEY_SPACE)
    assert db.total_live_entries() == oracle.total_live_entries()


# ------------------------------------------------- differential under churn
@given(st.integers(0, 10_000), st.sampled_from([2, 4]))
@settings(max_examples=6, deadline=None)
@example(seed=9197, shards=2)
def test_rebalancing_reads_identical_to_single_store(seed, shards):
    """A skewed stream triggers migrations on an async port facade while
    every wave's reads equal the reference's synchronous plain store."""
    oracle = ref.LSMStore(cfg(ref))
    db = pc.make_store(sharded_cfg(pc, shards, async_compaction=True,
                                   compaction_workers=2,
                                   rebalance_interval_ops=400,
                                   rebalance_ratio=1.3), device="cpu")
    rng = np.random.default_rng(seed)
    try:
        for wave in range(6):
            ops = hot_ops(seed + 31 * wave, 400)
            oracle.write_batch(ops)
            db.write_batch(ops)
            assert_reads_equal(db, oracle, rng)
        db.flush()
        assert db.wait_for_quiesce(60)
        assert db.rebalances >= 1, "skewed stream never triggered"
        assert_full_reads(db, oracle)
        no_leaked_pins(db)
    finally:
        close_quiet(db)


def test_uniform_load_never_triggers():
    for m in (pc, ref):
        db = facade(m, sharded_cfg(m, 2, rebalance_interval_ops=200,
                                   rebalance_ratio=1.5))
        rng = np.random.default_rng(5)
        ks = rng.integers(0, KEY_SPACE, 4_000, dtype=np.uint64)
        for i in range(0, ks.size, 256):
            db.put_batch(ks[i:i + 256].tolist(), b"u" * 24)
        assert db.rebalances == 0
        assert db.splitters == tuple(m.uniform_splitters(2, KEY_SPACE))


# ------------------------------------------- explicit split/merge + budgets
def test_rebalance_to_split_merge_and_cache_budgets():
    """A split toward the hot range, then the merge back: the splitters,
    the migrated entries and the cache budgets equal the reference's (the
    hot shard's slice the larger, the slices summing to the total), and
    every read equals the oracle's."""
    total_cache = 1 << 16
    oracle = ref.LSMStore(cfg(ref))
    dbs = [facade(m, sharded_cfg(m, 2, cache_bytes=total_cache,
                                 pin_l0_bytes=0)) for m in (pc, ref)]
    ops = hot_ops(11, 3_000)
    oracle.write_batch(ops)
    oracle.flush()
    for db in dbs:
        db.write_batch(ops)
    hot_splitter = KEY_SPACE // 20
    mid = KEY_SPACE // 2
    for target in (hot_splitter, mid):
        seen = []
        for db in dbs:
            assert db.rebalance_to([target])
            assert db.splitters == (target,)
            budgets = [s.block_cache.budget_bytes for s in db.shards]
            assert sum(budgets) == total_cache
            if target == hot_splitter:
                assert db.rebalances == 1 and db.migrated_entries > 0
                assert budgets[0] > budgets[1]
            assert_full_reads(db, oracle)
            seen.append((budgets, db.migrated_entries, db.rebalances,
                         [s.total_entries for s in db.shards]))
        assert seen[0] == seen[1]
    for db in dbs:
        no_leaked_pins(db)


def test_rebalance_to_validates_splitters():
    for m in (pc, ref):
        db = facade(m, sharded_cfg(m, 4))
        with pytest.raises(ValueError):
            db.rebalance_to([10, 20])            # wrong count
        with pytest.raises(ValueError):
            db.rebalance_to([30, 20, 10])        # not ascending


# --------------------------------------------------- snapshots vs migration
def test_snapshot_pins_survive_migration():
    db = facade(pc, sharded_cfg(pc, 2))
    db.write_batch([(k, b"old-%d" % k) for k in range(0, KEY_SPACE, 3)])
    db.flush()
    snap = db.get_snapshot()
    try:
        assert db.rebalance_to([KEY_SPACE // 8])
        db.write_batch([(k, b"new-%d" % k) for k in range(0, KEY_SPACE, 3)])
        db.flush()
        for k in range(0, KEY_SPACE, 301):
            want = b"old-%d" % k if k % 3 == 0 else None
            assert db.get(k, snapshot=snap) == want
            assert db.get(k) == (b"new-%d" % k if k % 3 == 0 else None)
        assert db.scan(0, KEY_SPACE, snapshot=snap) == \
            [(k, b"old-%d" % k) for k in range(0, KEY_SPACE, 3)]
        assert db.multi_get(list(range(0, KEY_SPACE, 7)), snapshot=snap) \
            == [b"old-%d" % k if k % 3 == 0 else None
                for k in range(0, KEY_SPACE, 7)]
    finally:
        db.release_snapshot(snap)
    no_leaked_pins(db)


# ------------------------------------------------------- crash mid-migration
def _filled_pair(seed=17):
    oracle = ref.LSMStore(cfg(ref))
    db = facade(pc, sharded_cfg(pc, 2, wal_fsync_every_write=True))
    ops = hot_ops(seed, 2_500)
    oracle.write_batch(ops)
    db.write_batch(ops)
    oracle.flush()
    db.flush()
    return oracle, db


def _assert_equal_after_recovery(db, oracle):
    assert_full_reads(db, oracle)
    no_leaked_pins(db)


def test_crash_before_routing_commit_recovers_pre_migration(monkeypatch):
    """Imports committed in the destinations, routing log not: recovery
    clips the imports and lands on the old splitters' exact state."""
    oracle, db = _filled_pair()
    old = db.splitters
    before = [s.total_entries for s in db.shards]

    def boom(new):
        raise RuntimeError("crash before routing commit")

    monkeypatch.setattr(db, "_commit_routing", boom)
    with pytest.raises(RuntimeError):
        db.rebalance_to([KEY_SPACE // 8])
    monkeypatch.undo()
    assert sum(s.total_entries for s in db.shards) > sum(before)
    db.crash()
    db.recover()
    assert db.splitters == old
    assert [s.total_entries for s in db.shards] == before
    _assert_equal_after_recovery(db, oracle)


def test_crash_after_routing_commit_recovers_post_migration(monkeypatch):
    """Routing log committed, sources not stripped: recovery finishes the
    strip and lands on the new splitters' exact state."""
    oracle, db = _filled_pair(seed=23)
    target = KEY_SPACE // 8

    def boom(new):
        raise RuntimeError("crash before source cleanup")

    monkeypatch.setattr(db, "_cleanup_sources", boom)
    with pytest.raises(RuntimeError):
        db.rebalance_to([target])
    monkeypatch.undo()
    db.crash()
    db.recover()
    assert db.splitters == (target,)
    for si, s in enumerate(db.shards):
        lo, hi = db._routing.bounds(si)
        assert all(lo <= k < hi for k, _ in s.scan(0, KEY_SPACE))
    _assert_equal_after_recovery(db, oracle)


def test_rebalance_then_crash_then_recover_roundtrip():
    oracle, db = _filled_pair(seed=29)
    assert db.rebalance_to([KEY_SPACE // 8])
    db.crash()
    db.recover()
    assert db.splitters == (KEY_SPACE // 8,)
    _assert_equal_after_recovery(db, oracle)


# --------------------------------------------- quiesce trigger + telemetry
def test_quiesce_boundary_consumes_rebalance_flag():
    db = facade(pc, sharded_cfg(pc, 2, async_compaction=True,
                                compaction_workers=2,
                                rebalance_interval_ops=300,
                                rebalance_ratio=1.3))
    try:
        ops = hot_ops(41, 2_000, del_frac=0.0)
        db.write_batch(ops)
        db.flush()
        assert db.wait_for_quiesce(60)
        assert db.rebalances >= 1
        assert not db._rebalance_needed
        hot_width = KEY_SPACE // 10
        assert db.splitters[0] < pc.uniform_splitters(2, KEY_SPACE)[0]
        assert db.splitters[0] <= 2 * hot_width, db.splitters
    finally:
        close_quiet(db)


def test_rebalance_events_and_shard_stats():
    """``shard_stats``, ``shard_load_summary`` and the rebalance events on
    the trace, equal to the reference's (the splitters a forced rebalance
    derives from the load histograms included)."""
    out = []
    for m in (pc, ref):
        tel = m.Telemetry()
        db = facade(m, sharded_cfg(m, 2, telemetry=tel))
        db.write_batch(hot_ops(43, 2_000, del_frac=0.0))
        db.flush()
        stats = db.shard_stats
        assert len(stats) == 2 and all(isinstance(d, dict) for d in stats)
        assert sum(d["wal_appends"] for d in stats) > 0
        summary = db.shard_load_summary()
        assert [d["shard"] for d in summary] == [0, 1]
        assert summary[0]["lo"] == 0 and summary[1]["hi"] == 1 << 64
        assert abs(sum(d["op_share"] for d in summary) - 1.0) < 1e-9
        assert summary[0]["ops"] > summary[1]["ops"], "hot shard must lead"
        assert db.rebalance_now(force=True)
        kinds = [e.kind for e in tel.trace.dump()]
        assert "rebalance_start" in kinds and "rebalance_end" in kinds
        assert "run_migrate" in kinds
        assert "shard_split" in kinds or "shard_shift" in kinds \
            or "shard_merge" in kinds
        assert tel.percentile("rebalance", 50) > 0
        migrate = [(e.fields["src"], e.fields["dst"], e.fields["entries"],
                    e.fields["bytes"])
                   for e in tel.trace.dump() if e.kind == "run_migrate"]
        out.append((summary, [{k: v for k, v in d.items()
                               if not k.endswith("_ns")} for d in stats],
                    db.splitters, migrate, kinds))
    assert out[0] == out[1]


def test_arm_rebalancing_resets_window():
    for m in (pc, ref):
        db = facade(m, sharded_cfg(m, 2))
        for i in range(0, KEY_SPACE, 256):
            db.put_batch(list(range(i, min(i + 256, KEY_SPACE))), b"s" * 24)
        assert db.rebalances == 0
        db.arm_rebalancing(500, ratio=1.4)
        assert db._load == [0, 0] and db._ops_since_check == 0
        assert db.config.rebalance_interval_ops == 500
        rng = np.random.default_rng(47)
        ks = rng.integers(0, KEY_SPACE, 1_500, dtype=np.uint64)
        db.put_batch(ks.tolist(), b"t" * 24)
        db.flush()
        assert db.rebalances == 0
