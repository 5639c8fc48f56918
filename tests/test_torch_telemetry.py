"""repro_torch's telemetry and lossless stats vs the reference's.

Every case of ``tests/test_telemetry.py`` but the sharded facade's (and
only the single-store case of the disabled-mode identity) runs on the
port's ``repro_torch.core.telemetry`` and store (``device="cpu"``) beside
the reference's: histogram buckets, counts, sums and percentiles equal bit
for bit for the same samples; the event trace's ring buffer and cursor;
a telemetry-on store identical to a telemetry-off one and to the
reference (tree, answers, every counter but the wall-clock ``*_ns``); the
same op classes recorded the same number of times and the same sequence of
event kinds as the reference store for the same operations; and the
lossless ``StatsHub`` under thread contention.  Latencies themselves are
the only thing that may differ.

The port alone also cuts each call into the phases of
``repro_torch.core.telemetry.PHASES``: its histograms beyond the
reference's classes are exactly the phases the workload ran
(:func:`assert_phase_classes`), and the phases of each call tile it (the
tests from ``test_phases_tile_each_request`` on).
"""
import collections
import dataclasses
import math
import threading
import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as ref
import repro.core.telemetry as ref_tel
import repro_torch.core as pc
from repro_torch.core import (EventTrace, IOStats, LatencyHistogram,
                              StatsHub, telemetry)
from repro_torch.core.telemetry import (ACTIVE, BUCKET_EDGES, N_BUCKETS,
                                        PHASES, bucket_of)
from test_torch_store import assert_same_tree

# Six xdist workers share 8 cores with the reference's timing-bounded
# property tests: one intra-op thread per worker keeps them on time.
torch.set_num_threads(1)


def _oracle_nearest_rank(vals, p):
    rank = max(1, math.ceil(len(vals) * p / 100.0))
    return int(np.sort(np.asarray(vals))[rank - 1])


def _hist(cls, vals):
    h = cls()
    for v in vals:
        h.record(v)
    return h


def _same_hist(a, b):
    assert np.array_equal(a.counts, b.counts)
    assert (a.n, a.sum_ns, a.max_ns, a.min_ns) == \
        (b.n, b.sum_ns, b.max_ns, b.min_ns)


def assert_phase_classes(tel, ref_counts):
    """The port's histogram counts equal the reference's ``ref_counts``
    (op class -> samples) over the reference's classes, and its other
    classes are exactly the ``PHASES`` names the workload ran: one sample
    per buffered interval, each of a call the reference recorded too."""
    got = {op: h.n for op, h in tel.histograms().items()}
    assert {op: got.get(op) for op in ref_counts} == ref_counts
    assert tel.spans_dropped == 0
    ran = collections.Counter(name for name, *_ in tel.intervals())
    assert {op: n for op, n in got.items() if op not in ref_counts} == ran
    assert set(ran) <= set(PHASES)
    assert {name.split(".")[0] for name in ran} <= set(ref_counts)


# ------------------------------------------------------------ histogram math
def test_bucket_edges_equal_reference():
    assert N_BUCKETS == ref_tel.N_BUCKETS
    np.testing.assert_array_equal(BUCKET_EDGES, ref_tel.BUCKET_EDGES)
    probes = [0, 1, 2, 3, 181, 1 << 20, (1 << 42) + 5, 1 << 50] + \
        [int(x) for x in ref_tel.BUCKET_EDGES] + \
        [int(x) - 1 for x in ref_tel.BUCKET_EDGES]
    assert [bucket_of(v) for v in probes] == \
        [ref_tel.bucket_of(v) for v in probes]


@given(st.lists(st.integers(1, 10**9), min_size=1, max_size=400),
       st.sampled_from([0.0, 50.0, 90.0, 99.0, 99.9, 100.0]))
@settings(max_examples=60, deadline=None)
def test_histogram_percentile_matches_sorted_oracle(vals, p):
    h = _hist(LatencyHistogram, vals)
    est = h.percentile(p)
    assert np.isfinite(est) and est >= 1.0
    assert bucket_of(int(est)) == bucket_of(_oracle_nearest_rank(vals, p))
    # the reference's histogram of the same samples: same buckets and the
    # same interpolated percentile, bit for bit
    r = _hist(ref_tel.LatencyHistogram, vals)
    _same_hist(h, r)
    assert est == r.percentile(p)
    assert h.to_dict() == r.to_dict()


@given(st.lists(st.integers(1, 10**12), min_size=0, max_size=200),
       st.lists(st.integers(1, 10**12), min_size=0, max_size=200),
       st.lists(st.integers(1, 10**12), min_size=0, max_size=200))
@settings(max_examples=40, deadline=None)
def test_histogram_merge_algebra(a, b, c):
    ha, hb, hc = (_hist(LatencyHistogram, x) for x in (a, b, c))
    _same_hist(ha + hb, _hist(LatencyHistogram, a + b))
    _same_hist((ha + hb) + hc, ha + (hb + hc))
    ident = ha + LatencyHistogram()
    assert np.array_equal(ident.counts, ha.counts) and ident.n == ha.n
    s = sum([ha, hb, hc])
    assert s.n == len(a) + len(b) + len(c)
    assert s.n == LatencyHistogram.merge([ha, hb, hc]).n
    d = (ha + hb).diff(ha)
    assert np.array_equal(d.counts, hb.counts) and d.n == hb.n
    ra, rb = (_hist(ref_tel.LatencyHistogram, x) for x in (a, b))
    _same_hist(ha + hb, ra + rb)


@given(st.lists(st.integers(0, 10**13), min_size=1, max_size=300))
@settings(max_examples=40, deadline=None)
def test_record_many_matches_scalar_record(vals):
    h_scalar = _hist(LatencyHistogram, vals)
    h_bulk = LatencyHistogram()
    h_bulk.record_many(np.asarray(vals, dtype=np.int64))
    _same_hist(h_scalar, h_bulk)
    r_bulk = ref_tel.LatencyHistogram()
    r_bulk.record_many(np.asarray(vals, dtype=np.int64))
    _same_hist(h_bulk, r_bulk)


def test_histogram_edge_cases():
    h = LatencyHistogram()
    assert math.isnan(h.percentile(50)) and math.isnan(h.mean())
    h.record(0)
    h.record(1 << 50)
    assert h.n == 2 and h.min_ns == 1
    assert int(h.counts[N_BUCKETS - 1]) == 1
    d = h.to_dict()
    assert list(d.keys()) == ["count", "p50_ns", "p99_ns", "p999_ns",
                              "max_ns", "min_ns", "mean_ns"]
    r = ref_tel.LatencyHistogram()
    r.record(0)
    r.record(1 << 50)
    assert d == r.to_dict()


# ------------------------------------------------------------- event trace
def test_event_trace_wraparound_and_since():
    tr = EventTrace(capacity=8)
    for i in range(20):
        tr.emit("ev", i=i)
    assert len(tr) == 8
    assert tr.dropped == 12
    evs = tr.dump()
    assert [e.seq for e in evs] == list(range(13, 21))
    assert [e.fields["i"] for e in evs] == list(range(12, 20))
    assert all(evs[i].ts_ns <= evs[i + 1].ts_ns for i in range(len(evs) - 1))
    got, cur = tr.since(0)
    assert [e.seq for e in got] == list(range(13, 21)) and cur == 20
    got, cur = tr.since(cur)
    assert got == [] and cur == 20
    tr.emit("late", x=1)
    got, cur = tr.since(cur)
    assert len(got) == 1 and got[0].kind == "late" and cur == 21
    s = tr.emit("flush_end", t0=1000, dur_ns=50)
    ev = tr.dump()[-1]
    assert ev.seq == s and ev.interval() == (1000, 1050)
    assert tr.dump()[0].interval() is None
    text = tr.timeline(limit=4)
    assert "flush_end" in text and len(text.splitlines()) == 4


# -------------------------------------------------- disabled-mode identity
def _mixed_workload(db, n=3000):
    keys = np.random.default_rng(3).integers(0, n * 4, n, dtype=np.uint64)
    db.put_batch(keys[:n // 2].tolist(), b"x" * 40)
    for k in keys[n // 2:n // 2 + 200]:
        db.put(int(k), b"y" * 10)
    db.delete_batch(keys[:50].tolist())
    db.flush()
    reads = [db.get(int(k)) for k in keys[:300]]
    reads.append(db.multi_get(keys[:128]))
    reads.append(db.scan(0, 50))
    reads.append(db.seek(int(keys[0])))
    db.write_batch((int(k), b"z") for k in keys[200:400])
    db.flush()
    reads.append(db.scan(int(keys[5]), 30))
    # the merging iterator (a snapshot bypasses the range view) across a
    # put_batch that flushes and compacts
    snap = db.get_snapshot()
    db.put_batch(keys[n // 4:].tolist(), b"w" * 24)
    reads.append(db.scan(int(keys[9]), 70, snap))
    reads.append(db.scan(0, 40, snap))
    db.release_snapshot(snap)
    reads.append(db.scan(int(keys[11]), 25))
    return reads


def _counters(db):
    return {k: v for k, v in db.stats.to_dict().items()
            if not k.endswith("_ns")}


def _trees(db):
    return db.shards if hasattr(db, "shards") else [db]


@pytest.mark.parametrize("shards", [1, 2])
def test_disabled_mode_is_noop_identity(shards):
    def build(m, tel, **kw):
        cfg = m.LSMConfig(memtable_bytes=1 << 14, bits_per_key=8,
                          shards=shards, use_range_views=True,
                          telemetry=tel)
        return m.make_store(cfg, **kw)

    db_off = build(pc, None, device="cpu")
    db_on = build(pc, pc.Telemetry(), device="cpu")
    db_ref = build(ref, ref.Telemetry())
    r_off, r_on, r_ref = (_mixed_workload(db)
                          for db in (db_off, db_on, db_ref))
    assert r_off == r_on == r_ref
    for p_off, p_on, r in zip(_trees(db_off), _trees(db_on), _trees(db_ref)):
        assert_same_tree(p_off, r)
        assert_same_tree(p_on, r)
    assert _counters(db_off) == _counters(db_on) == _counters(db_ref)
    tel = db_on.telemetry
    assert tel.histogram("get").n == 300
    assert tel.histogram("put").n >= 200
    assert any(e.kind == "flush_end" for e in tel.trace.dump())
    rtel = db_ref.telemetry
    assert [e.kind for e in tel.trace.dump()] == \
        [e.kind for e in rtel.trace.dump()]
    assert_phase_classes(tel, {op: h.n for op, h in
                               rtel.histograms().items()})


def test_sharded_aggregates_one_telemetry():
    """Every shard records into the facade's one Telemetry (live config
    sharing): the same histogram counts and event kinds as the
    reference's facade."""
    got, tels = [], []
    for m, kw in ((pc, {"device": "cpu"}), (ref, {})):
        tel = m.Telemetry()
        db = m.make_store(m.LSMConfig(shards=3, memtable_bytes=1 << 14,
                                      telemetry=tel), **kw)
        assert isinstance(db, m.ShardedLSMStore)
        assert db.telemetry is tel
        assert all(s.telemetry is tel for s in db.shards)
        db.put_batch(list(range(3000)), b"x" * 30)
        db.flush()
        for k in (1, 1001, 2001, 2999):
            db.get(k)
        assert tel.histogram("get").n >= 4
        assert tel.histogram("flush").n >= 3
        snap = db.get_snapshot()
        db.release_snapshot(snap)
        got.append([e.kind for e in tel.trace.dump()])
        tels.append(tel)
    assert got[0] == got[1]
    assert_phase_classes(tels[0], {op: h.n for op, h in
                                   tels[1].histograms().items()})


# ------------------------------------------------------- lost-update hammer
def test_stats_hub_loses_no_increments():
    hub = StatsHub()
    T, K = 8, 20_000
    barrier = threading.Barrier(T)

    def worker():
        st_ = hub.local()
        barrier.wait()
        for _ in range(K):
            st_.point_reads += 1
            st_.stall_ns += 3
    threads = [threading.Thread(target=worker) for _ in range(T)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    merged = hub.merged()
    assert merged.point_reads == T * K
    assert merged.stall_ns == 3 * T * K
    hub.local().point_reads += 1
    assert hub.merged().point_reads == T * K + 1
    assert merged.point_reads == T * K
    snap = hub.snapshot()
    hub.local().point_reads += 2
    assert hub.delta(snap).point_reads == 2


def test_engine_counters_exact_under_concurrent_readers():
    db = pc.LSMStore(pc.LSMConfig(memtable_bytes=1 << 14, bits_per_key=8,
                                  async_compaction=True, compaction_workers=2,
                                  slowdown_trigger=0, stall_trigger=0),
                     device="cpu")
    n_keys = 6000
    db.put_batch(list(range(500)), b"seed")
    R, M = 4, 1500
    barrier = threading.Barrier(R + 1)
    rng = np.random.default_rng(9)
    read_keys = rng.integers(0, n_keys, (R, M), dtype=np.uint64)

    def reader(r):
        barrier.wait()
        for k in read_keys[r]:
            db.get(int(k))
    threads = [threading.Thread(target=reader, args=(r,)) for r in range(R)]
    for t in threads:
        t.start()
    barrier.wait()
    for k in range(500, n_keys):
        db.put(k, b"v" * 20)
    for t in threads:
        t.join()
    db.flush()
    assert db.wait_for_quiesce(600)
    db.close()
    s = db.stats
    assert s.point_reads == R * M
    assert s.wal_appends == n_keys
    assert s.entries_flushed == n_keys
    assert s.bg_flushes > 0


# ------------------------------------------------------------ engine wiring
def test_engine_records_op_classes_and_events():
    out = []
    for m, kw in ((pc, dict(device="cpu")), (ref, {})):
        tel = m.Telemetry()
        if m is pc:
            pc_tel = tel
        db = m.LSMStore(m.LSMConfig(memtable_bytes=1 << 13, bits_per_key=8,
                                    telemetry=tel), **kw)
        for i in range(4000):
            db.put(i, b"v" * 16)
        db.flush()
        db.get(1)
        db.multi_get([1, 2, 3])
        db.scan(0, 20)
        db.seek(7)
        db.delete(3)
        db.put_batch([10_000, 10_001], b"w")
        db.write_batch([(10_002, b"q"), (10_003, None)])
        s = tel.summary()
        for op in ("get", "multi_get", "put", "put_batch", "write_batch",
                   "scan", "seek", "flush", "compaction", "wal_fsync"):
            assert op in s and s[op]["count"] > 0, op
            assert np.isfinite(s[op]["p99_ns"]) and s[op]["p99_ns"] > 0
        kinds = {e.kind for e in tel.trace.dump()}
        assert {"flush_start", "flush_end",
                "compaction_start", "compaction_end"} <= kinds
        ends = [e for e in tel.trace.dump() if e.kind == "compaction_end"]
        assert all(e.interval() is not None and "entries" in e.fields
                   and "src" in e.fields and "dst" in e.fields for e in ends)
        assert "compaction" in tel.report()
        assert db.telemetry is tel
        # the port's phase classes follow the reference's in summary()
        out.append(([(e.kind, {k: v for k, v in e.fields.items()
                               if k not in ("t0", "dur_ns")})
                     for e in tel.trace.dump()],
                    {op: d["count"] for op, d in s.items()
                     if op not in PHASES},
                    [op for op in s if op not in PHASES]))
    assert out[0] == out[1]
    assert_phase_classes(pc_tel, out[1][1])


def test_slowdown_pressure_events_and_stall_histogram():
    tel = pc.Telemetry()
    db = pc.LSMStore(pc.LSMConfig(memtable_bytes=1 << 12, telemetry=tel,
                                  async_compaction=True, compaction_workers=1,
                                  slowdown_trigger=1, stall_trigger=0),
                     device="cpu")
    for i in range(4000):
        db.put(i, b"v" * 16)
    db.flush()
    assert db.wait_for_quiesce(600)
    db.close()
    assert db.stats.write_slowdowns > 0
    assert tel.histogram("stall").n == db.stats.write_slowdowns
    evs = [e for e in tel.trace.dump() if e.kind == "slowdown"]
    assert evs and all(e.interval() is not None and e.fields["depth"] >= 1
                       for e in evs)


def test_cache_pressure_events_every_512_evictions():
    out = []
    for m, kw in ((pc, dict(device="cpu")), (ref, {})):
        tel = m.Telemetry()
        db = m.LSMStore(m.LSMConfig(memtable_bytes=1 << 13, bits_per_key=8,
                                    cache_bytes=1 << 13, cache_policy="lru",
                                    telemetry=tel), **kw)
        db.put_batch(list(range(20_000)), b"c" * 24)
        db.flush()
        rng = np.random.default_rng(4)
        for _ in range(20):
            db.multi_get(rng.integers(0, 20_000, 300).tolist())
        evs = [e.fields for e in tel.trace.dump()
               if e.kind == "cache_pressure"]
        assert evs and all(e["evictions"] % 512 == 0 for e in evs)
        out.append((evs, db.cache_summary()))
    assert out[0] == out[1]


# ------------------------------------------------------------------ to_dict
def test_iostats_to_dict_stable_order():
    s = IOStats(blocks_read=3, point_reads=7)
    d = s.to_dict()
    field_names = [f.name for f in dataclasses.fields(IOStats)]
    assert list(d.keys()) == field_names + ["write_amp"]
    assert d["blocks_read"] == 3 and d["point_reads"] == 7
    assert d["write_amp"] == s.write_amplification()
    s2 = IOStats(blocks_read=5, point_reads=7)
    assert s2.delta(s).to_dict()["blocks_read"] == 2
    assert d == ref.IOStats(blocks_read=3, point_reads=7).to_dict()
    assert sum([s, s2]).blocks_read == 8


# ------------------------------------------------------------------ phases
def _phase_store(tel, faults=None, cache_bytes=0):
    """A CPU store loaded past its memtable several times over: runs on
    three levels, so reads probe runs and a batch flushes and compacts;
    with ``cache_bytes`` its block reads go through an LRU cache."""
    db = pc.LSMStore(pc.LSMConfig(memtable_bytes=1 << 13, bits_per_key=8,
                                  telemetry=tel, faults=faults,
                                  cache_bytes=cache_bytes,
                                  cache_policy="lru"),
                     device="cpu")
    keys = np.random.default_rng(5).permutation(6000).astype(np.uint64)
    db.put_batch(keys[:4000].tolist(), b"v" * 24)
    db.flush()
    db.put_batch(keys[4000:4300].tolist(), b"m" * 24)     # memtable hits
    return db, keys


def _requests(ivs):
    by = collections.defaultdict(list)
    for iv in ivs:
        by[iv[1]].append(iv)
    return dict(by)


def _assert_tiles(ivs, lo, hi, tol=1000):
    """``ivs`` (in start order) follow each other and cover [lo, hi], each
    boundary within ``tol`` ns."""
    assert ivs
    assert abs(ivs[0][2] - lo) <= tol and abs(ivs[-1][3] - hi) <= tol
    for a, b in zip(ivs, ivs[1:]):
        assert abs(b[2] - a[3]) <= tol, (a, b)
    total = sum(t1 - t0 for _, _, t0, t1 in ivs)
    assert abs(total - (hi - lo)) <= tol * len(ivs)


def _call(db, op, keys):
    if op == "multi_get":
        return db.multi_get(keys[::7][:400])
    if op == "scan":
        return db.scan(int(keys[11]), 90)
    if op == "put_batch":       # fills the memtable: a flush and compactions
        return db.put_batch(keys[1000:3000].tolist(), b"p" * 24)
    # flushes called directly; the fourth L0 run sets off compactions,
    # each a request of its own
    for i in range(4 if op == "compaction" else 1):
        db.put_batch(keys[i * 100:(i + 1) * 100].tolist(), b"f" * 24)
        db.flush()


@pytest.mark.parametrize("op", ["multi_get", "cached_multi_get", "scan",
                                "put_batch", "flush", "compaction"])
def test_phases_tile_each_request(op):
    """Each request's phases follow one another inside the call and sum to
    its recorded duration: the op's histogram sample, or for a flush or a
    compaction called outside a write its end event's interval.  A
    ``multi_get`` through a block cache cuts its ``cache`` phases out of
    ``assemble`` and still tiles."""
    tel = pc.Telemetry()
    cached = op.startswith("cached_")
    op = op.removeprefix("cached_")
    db, keys = _phase_store(tel, cache_bytes=1 << 14 if cached else 0)
    snap = tel.snapshot()
    a = time.perf_counter_ns()
    _call(db, op, keys)
    b = time.perf_counter_ns()
    win = tel.delta(snap)
    reqs = _requests(tel.intervals(snap.t_ns))
    for ivs in reqs.values():
        assert a <= ivs[0][2] and ivs[-1][3] <= b
        _assert_tiles(ivs, ivs[0][2], ivs[-1][3])
    if op in ("flush", "compaction"):
        ends = [e for e in win.events if e.kind == op + "_end"]
        assert ends and len(ends) == win.hists[op].n
        starts = {ivs[0][2]: ivs for ivs in reqs.values()}
        for e in ends:
            lo, hi = e.interval()
            ivs = starts[lo]
            assert {iv[0].split(".")[0] for iv in ivs} == {op}
            _assert_tiles(ivs, lo, hi, tol=0)
        return
    (ivs,) = reqs.values()
    assert ivs[0][0].startswith(op + ".")
    names = [iv[0] for iv in ivs]
    assert ("multi_get.cache" in names) == cached
    if cached:      # each cache phase lies inside its run's assembly
        for i, name in enumerate(names):
            if name == "multi_get.cache":
                assert names[i - 1] == names[i + 1] == "multi_get.assemble"
    if op == "put_batch":
        assert {"flush.bloom", "compaction.merge"} <= {iv[0] for iv in ivs}
    assert abs(sum(t1 - t0 for _, _, t0, t1 in ivs)
               - win.hists[op].sum_ns) <= 1000 * len(ivs)


def test_flush_and_compaction_phases_tile_their_end_events():
    """Inside writes, each ``flush_end`` / ``compaction_end`` interval is
    tiled exactly by its own phases, which carry the write's request
    id; the write's phases close on the child's first read and reopen on
    its last."""
    tel = pc.Telemetry()
    db, keys = _phase_store(tel)
    snap = tel.snapshot()
    for i in range(4):
        db.put_batch(keys[i * 1500:(i + 1) * 1500].tolist(), b"q" * 24)
    win = tel.delta(snap)
    phases = [e for e in win.events if e.kind[:-4] in PHASES]
    spans = [e for e in win.events
             if e.kind in ("flush_end", "compaction_end")]
    assert sum(e.kind == "flush_end" for e in spans) >= 4
    assert any(e.kind == "compaction_end" for e in spans)
    for e in spans:
        lo, hi = e.interval()
        parent = e.kind[:-4]
        inner = [p for p in phases if lo <= p.fields["t0"] < hi]
        assert inner and all(p.fields["parent"] == parent for p in inner)
        assert inner[0].fields["t0"] == lo
        assert inner[-1].fields["t0"] + inner[-1].fields["dur_ns"] == hi
        for x, y in zip(inner, inner[1:]):
            assert y.fields["t0"] == x.fields["t0"] + x.fields["dur_ns"]
        assert len({p.fields["req"] for p in inner}) == 1
        # the enclosing write's phase ends on the child's first read
        assert any(p.fields["t0"] + p.fields["dur_ns"] == lo
                   and p.fields["parent"] == "put_batch" for p in phases)
    # four writes, four request ids, each write's phases contiguous
    reqs = _requests([(e.kind[:-4], e.fields["req"], e.fields["t0"],
                       e.fields["t0"] + e.fields["dur_ns"]) for e in phases])
    assert len(reqs) == 4
    for ivs in reqs.values():
        _assert_tiles(ivs, ivs[0][2], ivs[-1][3], tol=0)


def test_every_phase_is_listed_and_a_request_shares_its_id():
    """A mixed workload (point reads, scans, seeks, every write entry
    point, flushes, compactions) records every name in ``PHASES`` and no
    other, each ``<parent>.<phase>``, so no listed site is lost and no
    phase folds into its neighbour; its events carry the window's fields;
    distinct calls have distinct request ids; nothing stays open after a
    call."""
    tel = pc.Telemetry()
    # a block cache, so that point reads cut their ``cache`` phases
    db = pc.make_store(pc.LSMConfig(memtable_bytes=1 << 14, bits_per_key=8,
                                    cache_bytes=1 << 16, telemetry=tel),
                       device="cpu")
    snap = tel.snapshot()
    _mixed_workload(db)
    assert ACTIVE.phases is None
    win = tel.delta(snap)
    ivs = tel.intervals()
    assert {iv[0] for iv in ivs} == set(PHASES)
    evs = [e for e in win.events if e.kind[:-4] in PHASES]
    assert len(evs) == len(ivs)
    for e, (name, req, t0, t1) in zip(evs, ivs):
        assert e.kind == name + "_end" and e.interval() == (t0, t1)
        assert e.fields["req"] == req and e.fields["parent"] == \
            name.split(".")[0] and e.ts_ns == t1
    assert [e.fields["t0"] for e in evs] == sorted(e.fields["t0"]
                                                   for e in evs)
    # one id a call: the 300 gets and 200 puts give 500 distinct ids
    gets = {req for name, req, *_ in ivs if name.startswith("get.")}
    puts = {req for name, req, *_ in ivs if name.startswith("put.")}
    assert len(gets) == 300 and len(puts) >= 200 and not gets & puts
    assert all(PHASES.count(p) == 1 for p in PHASES)
    assert all(p.count(".") == 1 for p in PHASES)


def test_no_cache_phase_without_a_cache():
    """A store with no block cache cuts no ``cache`` phase: its point
    reads record the four phases they recorded before the cache had one,
    and no ``cache`` histogram."""
    tel = pc.Telemetry()
    db, keys = _phase_store(tel)
    snap = tel.snapshot()
    db.multi_get(keys[::7][:400])
    for k in keys[4290:4310]:          # memtable hits and run hits
        db.get(int(k))
    names = {iv[0] for iv in tel.intervals(snap.t_ns)}
    assert names == {f"{parent}.{phase}" for parent in ("multi_get", "get")
                     for phase in ("memtable_probe", "upload", "run_probe",
                                   "assemble")}
    assert not any(op.endswith(".cache") for op in tel.histograms())


def test_phase_buffer_drops_the_oldest(monkeypatch):
    """A buffer smaller than the load keeps the newest intervals and
    counts the others in ``spans_dropped``; the histograms keep all."""
    monkeypatch.setattr(telemetry, "SPAN_CAPACITY", 6)
    tel = pc.Telemetry()
    db, keys = _phase_store(tel)
    db.multi_get(keys[4300:4700])       # past the memtable: several runs
    kept = tel.intervals()
    recorded = sum(h.n for op, h in tel.histograms().items() if op in PHASES)
    assert len(kept) == 6 and tel.spans_dropped == recorded - 6 > 0
    assert all(iv[0].startswith("multi_get.") for iv in kept)
    assert kept[-1][0] == "multi_get.assemble"
    assert len({iv[1] for iv in kept}) == 1


def test_failed_call_closes_its_phases():
    """A write whose flush fails leaves no phase open: the next call is a
    new request whose phases tile it."""
    faults = pc.FaultInjector()
    tel = pc.Telemetry()
    db, keys = _phase_store(tel, faults)
    faults.fail("flush_write")
    with pytest.raises(pc.InjectedFault):
        db.put_batch(keys[:2000].tolist(), b"f" * 24)
    assert ACTIVE.phases is None
    snap = tel.snapshot()
    db.multi_get(keys[:64])
    (ivs,) = _requests(tel.intervals(snap.t_ns)).values()
    _assert_tiles(ivs, ivs[0][2], ivs[-1][3], tol=0)
    assert abs(sum(t1 - t0 for *_, t0, t1 in ivs)
               - tel.delta(snap).hists["multi_get"].sum_ns) <= 1
