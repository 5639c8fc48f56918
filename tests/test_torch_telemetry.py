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
"""
import dataclasses
import math
import threading

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as ref
import repro.core.telemetry as ref_tel
import repro_torch.core as pc
from repro_torch.core import EventTrace, IOStats, LatencyHistogram, StatsHub
from repro_torch.core.telemetry import BUCKET_EDGES, N_BUCKETS, bucket_of
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
    return reads


def _counters(db):
    return {k: v for k, v in db.stats.to_dict().items()
            if not k.endswith("_ns")}


@pytest.mark.parametrize("shards", [1])
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
    assert_same_tree(db_off, db_ref)
    assert_same_tree(db_on, db_ref)
    assert _counters(db_off) == _counters(db_on) == _counters(db_ref)
    tel = db_on.telemetry
    assert tel.histogram("get").n == 300
    assert tel.histogram("put").n >= 200
    assert any(e.kind == "flush_end" for e in tel.trace.dump())
    rtel = db_ref.telemetry
    assert [e.kind for e in tel.trace.dump()] == \
        [e.kind for e in rtel.trace.dump()]
    assert {op: h.n for op, h in tel.histograms().items()} == \
        {op: h.n for op, h in rtel.histograms().items()}


def test_make_store_refuses_shards():
    with pytest.raises(NotImplementedError, match="A8"):
        pc.make_store(pc.LSMConfig(shards=2), device="cpu")
    assert isinstance(pc.make_store(pc.LSMConfig(), device="cpu"),
                      pc.LSMStore)


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
        out.append(([(e.kind, {k: v for k, v in e.fields.items()
                               if k not in ("t0", "dur_ns")})
                     for e in tel.trace.dump()],
                    {op: d["count"] for op, d in s.items()}, list(s)))
    assert out[0] == out[1]


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
