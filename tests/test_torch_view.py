"""repro_torch's range views on the CPU vs the reference's.

Every case of ``tests/test_view.py`` but the sharded facade's runs on
``repro.core.LSMStore`` and on ``repro_torch.LSMStore(device="cpu")`` side
by side with ``use_range_views``: view-served ``scan``/``seek`` answers
equal to the reference's (and to ``scan_scalar``), every IOStats counter
(``view_*`` included; the wall-clock ``*_ns`` fields aside) equal, and the
view's four columns (``keys``, ``src``, ``rows``, ``live``) and run list
equal bit for bit, after flushes with L0 multi-run levels, tombstones and
memtable overlays; async churn against the synchronous oracle; the
incremental rebuild's level cache; freshness by list identity; and block
charging with and without a block cache.  The merge that builds the view
is the plain version of the pair merge kernel here.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as ref
import repro_torch.core as pc
from repro_torch.kernels import ops

# Six xdist workers share 8 cores with the reference's timing-bounded
# property tests: one intra-op thread per worker keeps them on time.
torch.set_num_threads(1)

KEY_SPACE = 500


def base(**kw):
    b = dict(policy="garnering", T=2.0, c=0.8, memtable_bytes=1 << 12,
             base_level_bytes=1 << 14, bits_per_key=8,
             bloom_allocation="monkey", use_range_views=True)
    b.update(kw)
    return b


def pair(**kw):
    """(port, reference) stores of the same configuration."""
    return [pc.LSMStore(pc.LSMConfig(**base(**kw)), device="cpu"),
            ref.LSMStore(ref.LSMConfig(**base(**kw)))]


def both(dbs, name, *args):
    return [getattr(db, name)(*args) for db in dbs]


def counters(db) -> dict:
    return {k: v for k, v in dataclasses.asdict(db.stats).items()
            if not k.endswith("_ns")}


def assert_same_view(vp, vr):
    """The port's view columns and run list equal the reference's."""
    assert len(vp) == len(vr)
    np.testing.assert_array_equal(ops.keys_from_device(vp.keys), vr.keys)
    for name in ("src", "rows", "live"):
        got, want = getattr(vp, name).numpy(), getattr(vr, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert vp.all_live == vr.all_live
    assert [len(r) for r in vp.runs] == [len(r) for r in vr.runs]
    assert [r.n_blocks for r in vp.runs] == [r.n_blocks for r in vr.runs]
    if len(vp):     # the port's own column: each row's block in its run
        want = np.concatenate([r.block_of for r in vr.runs])[
            np.cumsum([0] + [len(r) for r in vr.runs])[:-1][vr.src]
            + vr.rows]
        np.testing.assert_array_equal(vp.blocks.numpy(), want)


# ------------------------------------------------------- differential oracle
@given(st.integers(0, 10_000))
@settings(max_examples=10, deadline=None)
def test_view_scan_matches_scalar_oracle_property(seed):
    rng = np.random.default_rng(seed)
    dbs = pair()
    plain = ref.LSMStore(ref.LSMConfig(**base(use_range_views=False)))
    for i in range(900):
        k = int(rng.integers(0, KEY_SPACE))
        if rng.random() < 0.25:
            both(dbs + [plain], "delete", k)
        else:
            both(dbs + [plain], "put", k, b"s%d-%d" % (seed % 97, i))
        if rng.random() > 0.99:
            both(dbs + [plain], "flush")
        if i % 150 == 149:
            start = int(rng.integers(0, KEY_SPACE))
            n = int(rng.integers(1, 80))
            got = both(dbs, "scan", start, n)
            assert got[0] == got[1] == plain.scan(start, n)
            assert both(dbs, "scan_scalar", start, n) == [got[0]] * 2
            assert both(dbs, "seek", start) == [plain.seek(start)] * 2
            assert_same_view(dbs[0]._view_fresh(), dbs[1]._view_fresh())
    both(dbs + [plain], "flush")
    got = both(dbs, "scan", 0, KEY_SPACE)
    assert got[0] == got[1] == plain.scan_scalar(0, KEY_SPACE)
    assert dbs[0].stats.view_scans > 0
    assert counters(dbs[0]) == counters(dbs[1])
    assert_same_view(dbs[0]._view_fresh(), dbs[1]._view_fresh())


def test_view_seek_matches_iterator_seek():
    dbs = pair()
    plain = pc.LSMStore(pc.LSMConfig(**base(use_range_views=False)),
                        device="cpu")
    for k in range(0, 300, 3):
        both(dbs + [plain], "put", k, b"v%d" % k)
    both(dbs + [plain], "flush")
    for k in range(60, 120, 3):
        both(dbs + [plain], "delete", k)
    for p in (0, 1, 59, 60, 61, 118, 119, 120, 297, 298, 299, 300):
        assert both(dbs, "seek", p) == [plain.seek(p)] * 2, p
    assert dbs[0].stats.view_scans > 0
    assert counters(dbs[0]) == counters(dbs[1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_view_columns_and_cached_scans_equal_reference(seed):
    """Multi-run L0 levels, tombstones, empty values and u64 edge keys,
    with a block cache and a pinned L0 charging the materialization: the
    same columns, answers, cache state and counters."""
    rng = np.random.default_rng(seed)
    dbs = pair(cache_bytes=1 << 13, pin_l0_bytes=1 << 12,
               cache_policy="lru", l0_compaction_trigger=6)
    edge = [0, 2**32 - 1, 2**63 - 1, 2**63, 2**64 - 1]
    for wave in range(8):
        keys = rng.integers(0, 3000, 200).tolist() + edge
        vals = [b"w%d" % wave * int(rng.integers(0, 5)) for _ in keys]
        both(dbs, "put_batch", keys, vals)
        both(dbs, "delete_batch", rng.integers(0, 3000, 40).tolist())
        both(dbs, "flush")
        assert_same_view(dbs[0].refresh_range_view(),
                         dbs[1].refresh_range_view())
        starts = rng.integers(0, 3000, 20).tolist() + edge
        for a in starts:
            n = int(rng.integers(1, 120))
            got = both(dbs, "scan", a, n)
            assert got[0] == got[1]
            got = both(dbs, "seek", a)
            assert got[0] == got[1]
        both(dbs, "put", int(rng.integers(0, 3000)), b"overlay")
        for a in starts[:5]:      # with a memtable overlay
            got = both(dbs, "scan", a, 50)
            assert got[0] == got[1]
        both(dbs, "delete", int(rng.integers(0, 3000)))
    assert counters(dbs[0]) == counters(dbs[1])
    assert dbs[0].cache_summary() == dbs[1].cache_summary()
    assert dbs[0].stats.view_scans > 0 and dbs[0].stats.cache_hit_blocks > 0


# ---------------------------------------------------------- async churn
@given(st.integers(0, 10_000))
@settings(max_examples=4, deadline=None)
def test_view_scans_under_async_churn_match_sync_oracle(seed):
    rng = np.random.default_rng(seed)
    db = pc.LSMStore(pc.LSMConfig(**base(async_compaction=True,
                                         compaction_workers=2)),
                     device="cpu")
    oracle = ref.LSMStore(ref.LSMConfig(**base(use_range_views=False)))
    errors = []
    stop = threading.Event()

    def scanner():
        srng = np.random.default_rng(seed + 1)
        try:
            while not stop.is_set():
                start = int(srng.integers(0, KEY_SPACE))
                got = db.scan(start, 40)
                ks = [k for k, _ in got]
                assert ks == sorted(set(ks)), "view scan not sorted/unique"
                assert all(k >= start for k in ks)
        except Exception as e:
            errors.append(e)

    t = threading.Thread(target=scanner)
    t.start()
    try:
        for wave in range(6):
            ops_ = []
            for i in range(400):
                k = int(rng.integers(0, KEY_SPACE))
                v = None if rng.random() < 0.2 else b"w%d-%d" % (wave, i)
                ops_.append((k, v))
            db.write_batch(ops_)
            oracle.write_batch(ops_)
        db.flush()
        oracle.flush()
        assert db.wait_for_quiesce(60)
    finally:
        stop.set()
        t.join(timeout=30)
    assert not errors, errors
    assert db.scan(0, KEY_SPACE) == oracle.scan_scalar(0, KEY_SPACE)
    assert db.stats.bg_view_rebuilds > 0
    assert db.stats.view_rebuilds == db.stats.bg_view_rebuilds
    db.close()


def test_stale_view_falls_back_to_merging_iterator():
    db = pc.LSMStore(pc.LSMConfig(**base(async_compaction=True,
                                         compaction_workers=1)),
                     device="cpu")
    twin = ref.LSMStore(ref.LSMConfig(**base()))
    try:
        for k in range(0, 200, 2):
            both([db, twin], "put", k, b"a%d" % k)
        both([db, twin], "flush")
        assert db.wait_for_quiesce(60)
        db.scan(0, 5)
        fresh_scans = db.stats.view_scans
        orig = db._bg_refresh_view
        db._bg_refresh_view = lambda: None
        try:
            for k in range(1, 41, 2):
                both([db, twin], "put", k, b"b%d" % k)
            both([db, twin], "flush")
            assert db.wait_for_quiesce(60)
            assert db._view_fresh() is None
            before = db.stats.view_fallbacks
            rebuilds = db.stats.view_rebuilds
            got = db.scan(0, 30)
            assert got == db.scan_scalar(0, 30) == twin.scan(0, 30)
            assert db.stats.view_fallbacks == before + 1
            assert db.stats.view_scans == fresh_scans
            assert db.stats.view_rebuilds == rebuilds
        finally:
            db._bg_refresh_view = orig
        both([db, twin], "put", 999, b"tail")
        both([db, twin], "flush")
        assert db.wait_for_quiesce(60)
        assert db._view_fresh() is not None
        assert db.scan(0, 30) == got
        assert db.stats.view_scans == fresh_scans + 1
        assert_same_view(db._view_fresh(), twin.refresh_range_view())
    finally:
        db.close()


# ------------------------------------------------- incremental rebuild/cache
def test_view_rebuild_reuses_unchanged_level_columns():
    dbs = pair(use_range_views=False)
    for k in range(0, 400, 2):
        both(dbs, "put", k, b"v%d" % k)
    both(dbs, "flush")
    caches = [{}, {}]
    builds = [pc.build_range_view, ref.build_range_view]
    v1 = [b(db._levels, c) for b, db, c in zip(builds, dbs, caches)]
    assert_same_view(*v1)
    keys1 = set(caches[0].keys())
    assert keys1 and len(keys1) == len(caches[1])
    v2 = [b(db._levels, c) for b, db, c in zip(builds, dbs, caches)]
    assert v2[0].keys is v1[0].keys or torch.equal(v2[0].keys, v1[0].keys)
    assert v2[0].levels_built == 0       # every level from the cache
    assert set(caches[0].keys()) == keys1
    for k in range(1, 101, 2):
        both(dbs, "put", k, b"w%d" % k)
    both(dbs, "flush")
    v3 = [b(db._levels, c) for b, db, c in zip(builds, dbs, caches)]
    assert len(v3[0]) == len(v1[0]) + 50
    assert_same_view(*v3)
    assert len(caches[0]) == len(caches[1])
    for ck in caches[0]:
        assert any(set(ck) <= {r.run_id for r in lvl}
                   for lvl in dbs[0]._levels)


def test_view_freshness_is_cow_identity():
    db = pc.LSMStore(pc.LSMConfig(**base()), device="cpu")
    for k in range(100):
        db.put(k, b"x%d" % k)
    db.flush()
    db.scan(0, 1)
    view = db._view_fresh()
    assert view is not None and view.levels_ref is db._levels
    db.put(1000, b"y")
    db.flush()
    assert db._view_fresh() is None
    assert db.refresh_range_view() is not view
    assert db._range_view.levels_ref is db._levels
    # every install path replaces the list object: compaction, recovery
    levels = db._levels
    db.compact_to_shape()
    db.crash()
    db.recover()
    assert db._levels is not levels and db._view_fresh() is None


def test_view_holds_runs_alive_across_compaction():
    dbs = pair()
    for k in range(0, 300, 3):
        both(dbs, "put", k, b"v%d" % k)
    both(dbs, "flush")
    both(dbs, "scan", 0, 1)
    old = [db._range_view for db in dbs]
    before = [v.scan(0, 50, (), None, None) for v in old]
    assert before[0] == before[1]
    for k in range(0, 300, 3):
        both(dbs, "put", k, b"w%d" % k)
    both(dbs, "flush")
    assert [v.scan(0, 50, (), None, None) for v in old] == before
    assert both(dbs, "scan", 0, 3)[0][0][1] == b"w0"


# ------------------------------------------------------------- accounting
def test_view_counters_and_block_charging():
    dbs = pair()
    n = 600
    deltas = []
    for db in dbs:
        db.put_batch(list(range(n)), [b"val%05d" % k for k in range(n)])
        db.flush()
        assert db.stats.view_rebuilds == 0
        s0 = db.stats.snapshot()
        got = db.scan(0, 64)
        assert len(got) == 64
        d = db.stats.delta(s0)
        assert d.view_rebuilds == 1
        assert d.bg_view_rebuilds == 0
        assert d.view_entries_built == db.total_live_entries()
        assert d.view_scans == 1 and d.view_fallbacks == 0
        assert d.blocks_read > 0
        s1 = db.stats.snapshot()
        db.scan(0, 64)
        d2 = db.stats.delta(s1)
        assert d2.view_rebuilds == 0
        assert d2.view_scans == 1
        snap = db.get_snapshot()
        s2 = db.stats.snapshot()
        db.scan(0, 10, snapshot=snap)
        assert db.stats.delta(s2).view_scans == 0
        db.release_snapshot(snap)
        deltas.append([{k: v for k, v in dataclasses.asdict(x).items()
                        if not k.endswith("_ns")} for x in (d, d2)])
    assert deltas[0] == deltas[1]
    assert counters(dbs[0]) == counters(dbs[1])


def test_view_scan_with_tombstone_dense_prefix():
    dbs = pair(memtable_bytes=1 << 16, base_level_bytes=1 << 18,
               bits_per_key=0)
    n, tail = 40_000, 500
    wave = 8_192
    for i in range(0, n, wave):
        ks = list(range(i, min(i + wave, n)))
        both(dbs, "put_batch", ks, [b"v%d" % k for k in ks])
    for i in range(0, n - tail, wave):
        both(dbs, "delete_batch", list(range(i, min(i + wave, n - tail))))
    both(dbs, "flush")
    got = both(dbs, "scan", 0, 100)
    assert both(dbs, "scan_scalar", 0, 100) == [got[0]] * 2
    assert [k for k, _ in got[0]] == list(range(n - tail, n - tail + 100))
    assert dbs[0].stats.view_scans > 0
    assert not dbs[0]._view_fresh().all_live
    assert counters(dbs[0]) == counters(dbs[1])


def test_empty_store_and_edge_probes():
    dbs = pair()
    for db in dbs:
        assert db.scan(0, 10) == []
        assert db.seek(0) is None
        db.put(5, b"five")
        db.flush()
        assert db.scan(0, 10) == [(5, b"five")]
        assert db.scan(6, 10) == []
        assert db.seek(6) is None
        assert db.scan(5, 0) == []
        view = db._view_fresh() or db.refresh_range_view()
        assert len(view) == 1
    assert isinstance(dbs[0]._range_view, pc.RangeView)
    assert counters(dbs[0]) == counters(dbs[1])
    empty = pc.build_range_view([[]], device="cpu")
    assert len(empty) == 0 and empty.all_live and empty.scan(0, 5) == []
