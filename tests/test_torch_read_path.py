"""repro_torch's read path on the CPU vs the reference's, case for case.

Every case of ``tests/test_read_path.py``, with one seeded workload going
into ``repro.core.LSMStore`` and into ``repro_torch.LSMStore(device="cpu")``:
the same answers from ``get``/``multi_get`` (also under a snapshot),
``scan``, ``scan_scalar``, ``seek`` and the streaming ``iterator()``, the
same refill count per scan, and every IOStats field equal after each
step.  The two Pallas-probe cases hold the port's ``probe_plain`` against
the reference's kernel (interpret mode) and its numpy filter.  Below them,
the modules the range reads stand on: ``Memtable.scan``, the run helpers
at the u64 extremes, and the manifest's reader pins.  Last, the point
read's memtable probe through its key column and through a ``dict.get``
per key, each held to the reference's scalar ``get``.  All lanes are
integer: tolerance 0.
"""
import dataclasses
import zlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as ref
import repro_torch as rt
from _seek_plain import seek_plain, seek_with_reference_fault
from repro.core import iterator as ref_iterator
from repro.core.bloom import BloomFilter as RefBloomFilter
from repro.core.types import TOMBSTONE_LEN
from repro.kernels.ops import bloom_probe_filter
from repro_torch.core import iterator as port_iterator
from repro_torch.core import memtable as port_memtable
from repro_torch.core import run as port_run
from repro_torch.core.types import IOStats
from repro_torch.kernels import bloom, ops

# Six xdist workers share 8 cores with the reference's timing-bounded
# property tests: one intra-op thread per worker keeps them on time.
torch.set_num_threads(1)

# all five policies; c only shapes Garnering (c=1 == Leveling, paper §4.1)
POLICY_C = [
    ("leveling", 1.0),
    ("tiering", 1.0),
    ("lazy-leveling", 1.0),
    ("qlsm-bush", 1.0),
    ("garnering", 1.0),
    ("garnering", 0.8),
    ("garnering", 0.4),
]
IDS = [f"{p}-c{c}" for p, c in POLICY_C]
EDGE = [0, 2**63 - 1, 2**63, 2**64 - 1]


def make_pair(policy: str, c: float, **kw):
    """(port, reference) stores of one configuration."""
    base = dict(policy=policy, c=c, T=2.0, memtable_bytes=1 << 11,
                base_level_bytes=1 << 13, bits_per_key=8,
                bloom_allocation="monkey")
    base.update(kw)
    return (rt.LSMStore(rt.LSMConfig(**base), device="cpu"),
            ref.LSMStore(ref.LSMConfig(**base)))


def seed_of(policy: str, c: float) -> int:
    return zlib.crc32(f"{policy}-{c}".encode()) % 97 + 1


def run_workload(dbs, seed: int, n_ops: int = 1500, key_space: int = 400):
    """Random puts/deletes/flushes on every store; returns (oracle,
    snapshots, snap_oracle), the snapshot taken right after a flush
    mid-workload."""
    rng = np.random.default_rng(seed)
    oracle = {}
    snaps = snap_oracle = None
    for i in range(n_ops):
        k = int(rng.integers(0, key_space))
        u = rng.random()
        if u < 0.2:
            for db in dbs:
                db.delete(k)
            oracle.pop(k, None)
        else:
            v = f"s{seed}i{i}".encode()
            for db in dbs:
                db.put(k, v)
            oracle[k] = v
        if i == n_ops // 2:
            snaps = []
            for db in dbs:
                db.flush()
                snaps.append(db.get_snapshot())
            snap_oracle = dict(oracle)
        elif u > 0.995:
            for db in dbs:
                db.flush()
    return oracle, snaps, snap_oracle


def stats(db) -> dict:
    return dataclasses.asdict(db.stats)


def assert_same_stats(port, reference):
    assert stats(port) == stats(reference)


@pytest.fixture
def refills(monkeypatch):
    """Counts ``MergingIterator._refill`` calls, per package."""
    counts = {"port": 0, "ref": 0}
    for name, mod in (("port", port_iterator), ("ref", ref_iterator)):
        orig = mod.MergingIterator._refill

        def counting(self, _orig=orig, _name=name):
            counts[_name] += 1
            return _orig(self)

        monkeypatch.setattr(mod.MergingIterator, "_refill", counting)
    return counts


def test_config_has_every_reference_field_but_the_pallas_switches():
    port = {f.name: f.default for f in dataclasses.fields(rt.LSMConfig)}
    want = {f.name: f.default for f in dataclasses.fields(ref.LSMConfig)
            if f.name not in ("use_pallas_bloom", "use_pallas_merge")}
    assert port == want


@pytest.mark.parametrize("policy,c", POLICY_C, ids=IDS)
def test_multi_get_matches_scalar_get(policy, c):
    port, reference = make_pair(policy, c)
    oracle, snaps, snap_oracle = run_workload([port, reference],
                                              seed_of(policy, c))
    rng = np.random.default_rng(5)
    # present, absent, and duplicate keys in one batch
    queries = list(rng.integers(0, 500, 300)) + [7, 7, 7]
    deltas = []
    for db in (port, reference):
        s0 = db.stats.snapshot()
        scalar = [db.get(int(k)) for k in queries]
        d_scalar = db.stats.delta(s0)
        s1 = db.stats.snapshot()
        batch = db.multi_get(queries)
        d_batch = db.stats.delta(s1)
        assert batch == scalar == [oracle.get(int(k)) for k in queries]
        assert dataclasses.asdict(d_scalar) == dataclasses.asdict(d_batch)
        deltas.append(dataclasses.asdict(d_batch))
    assert deltas[0] == deltas[1]
    # snapshot reads, scalar and batched
    want = [snap_oracle.get(int(k)) for k in queries]
    for db, snap in zip((port, reference), snaps):
        assert db.multi_get(queries, snapshot=snap) == want
        assert [db.get(int(k), snapshot=snap) for k in queries[:40]] == \
            want[:40]
    assert_same_stats(port, reference)


@pytest.mark.parametrize("policy,c", POLICY_C, ids=IDS)
def test_scan_matches_oracle_and_scalar(policy, c, refills):
    port, reference = make_pair(policy, c)
    oracle, snaps, snap_oracle = run_workload([port, reference],
                                              seed_of(policy, c) + 1)
    exp = sorted(oracle.items())
    assert port.scan(0, len(exp) + 10) == reference.scan(0, len(exp) + 10) \
        == exp
    rng = np.random.default_rng(6)
    for start in rng.integers(0, 450, 12):
        for count in (1, 5, 37):
            got = port.scan(int(start), count)
            assert got == reference.scan(int(start), count), (start, count)
            assert got == port.scan_scalar(int(start), count) \
                == reference.scan_scalar(int(start), count)
            assert got == [e for e in exp if e[0] >= start][:count]
            assert port.seek(int(start)) == reference.seek(int(start))
            assert_same_stats(port, reference)
    assert refills["port"] == refills["ref"] > 0
    # snapshot scans and seeks see the frozen state only
    snap_exp = sorted(snap_oracle.items())
    for db, snap in zip((port, reference), snaps):
        assert db.scan(0, len(snap_exp) + 10, snapshot=snap) == snap_exp
        assert db.scan_scalar(0, len(snap_exp) + 10, snapshot=snap) == \
            snap_exp
    for start in (0, 77, 399, 2**64 - 1):
        assert port.seek(start, snapshot=snaps[0]) == \
            reference.seek(start, snapshot=snaps[1])
    assert_same_stats(port, reference)
    assert refills["port"] == refills["ref"]


def test_iterator_streaming_api():
    port, reference = make_pair("garnering", 0.8)
    oracle, _, _ = run_workload([port, reference], seed=13)
    exp = sorted(oracle.items())
    for db in (port, reference):
        it = db.iterator()
        it.seek(0)
        assert [e for e in it] == exp
        # re-seek mid-stream, stream via next()
        it.seek(200)
        got = []
        while True:
            e = it.next()
            if e is None:
                break
            got.append(e)
        assert got == [e for e in exp if e[0] >= 200]
    # a small window: many refills, the same accounting
    for db in (port, reference):
        it = db.iterator(chunk=16)
        it.seek(3)
        assert list(it) == [e for e in exp if e[0] >= 3]
    keys = [k for k, _ in exp]
    assert keys == sorted(set(keys))
    assert_same_stats(port, reference)


VALUE_SHAPES = ["zero_tail", "empty", "mixed", "tombstones"]
READ_PATHS = ["runs_and_memtable", "snapshot", "block_cache", "paranoid"]


def shaped_value(shape: str, k: int, rnd: int) -> bytes:
    """Round ``rnd``'s value of key ``k``: ``zero_tail`` ends in 1-3 zero
    bytes (some with zeros inside), ``empty`` is empty every other time
    and always in round 2, ``mixed`` spans 1-40 bytes (some ending in
    zero), ``tombstones`` is a plain value (the workload deletes)."""
    h = (k * 7 + rnd * 13) % 41
    if shape == "zero_tail":
        return b"z%d\x00%d" % (k, rnd) * (h % 2) + b"\x00" * (1 + h % 3)
    if shape == "empty":
        return b"" if rnd == 2 or h % 2 else b"e%d.%d" % (k, rnd)
    if shape == "mixed":
        return bytes([(k + i) % 256 for i in range(1 + h % 40)])
    return b"t%d.%d" % (k, rnd)


@pytest.mark.parametrize("path", READ_PATHS)
@pytest.mark.parametrize("shape", VALUE_SHAPES)
def test_multi_get_value_shapes_match_reference(shape, path):
    """The hits' answers come from the fixed-width view or, for the rows
    it cannot give, their exact slice: every answer of ``multi_get`` and
    ``get`` equals the reference's, on hits in the memtable and in several
    runs, through a snapshot, the block cache and paranoid checks, and
    every IOStats field is equal."""
    kw = dict(memtable_bytes=1 << 12, base_level_bytes=1 << 14,
              bits_per_key=10)
    if path == "block_cache":
        kw["cache_bytes"] = 1 << 12
    if path == "paranoid":
        kw["paranoid_checks"] = True
    port, reference = make_pair("garnering", 0.8, **kw)
    space = 240
    snaps = None
    for rnd in range(5):
        keys = list(range(rnd * 11 % 7, space, 1 + rnd % 3))
        if shape == "tombstones" and rnd == 3:
            vals = [None] * len(keys)        # a run of tombstones alone
        else:
            vals = [None if shape == "tombstones" and k % 3 == rnd % 3
                    else shaped_value(shape, k, rnd) for k in keys]
        for db in (port, reference):
            for k, v in zip(keys, vals):
                if v is None:
                    db.delete(k)
                else:
                    db.put(k, v)
            if rnd < 4:                      # the last round stays in memory
                db.flush()
        if rnd == 2:
            snaps = [db.get_snapshot() for db in (port, reference)]
    queries = list(np.random.default_rng(len(shape)).integers(0, space + 20,
                                                              400))
    reads = [(None, None)] + ([tuple(snaps)] if path == "snapshot" else [])
    for snap_p, snap_r in reads:
        got = port.multi_get(queries, snapshot=snap_p)
        want = reference.multi_get(queries, snapshot=snap_r)
        assert got == want
        assert [port.get(int(k), snapshot=snap_p) for k in queries] == \
            [reference.get(int(k), snapshot=snap_r) for k in queries] == want
        assert_same_stats(port, reference)
    assert any(v is not None for v in want)
    if shape == "tombstones":
        assert want.count(None) > 40


def _run_of(entries, vmax: int, pad: int):
    """A run built directly from ``(key, value-or-None)`` entries, each row
    padded past its length with the byte ``pad``."""
    entries = sorted(entries)
    n = len(entries)
    vals = np.full((n, vmax), pad, dtype=np.uint8)
    vlens = np.empty(n, dtype=np.int32)
    for i, (_, v) in enumerate(entries):
        vlens[i] = TOMBSTONE_LEN if v is None else len(v)
        if v:
            vals[i, :len(v)] = np.frombuffer(v, np.uint8)
    return port_run.SortedRun(
        ops.keys_to_device([k for k, _ in entries], "cpu"),
        torch.arange(1, n + 1, dtype=torch.int64), torch.from_numpy(vlens),
        torch.from_numpy(vals), bits_per_key=10)


def test_point_get_batch_reads_value_prefix_past_nonzero_padding():
    """A run whose padding past ``vlen`` is not zero, built directly:
    ``point_get_batch``, ``point_get`` and a store's ``multi_get`` answer
    exactly ``value[:vlen]``; ``ASSEMBLY_ROWS`` counts full 100-byte
    values with a non-zero last byte as ``view`` and values ending in a
    zero byte, or padded with non-zero bytes, as ``exact``."""
    full = {k: bytes([1 + (k + i) % 255 for i in range(100)])
            for k in range(0, 400, 4)}
    run = _run_of(full.items(), 100, 0xAB)
    queries = list(range(0, 400, 2))
    before = dict(port_run.ASSEMBLY_ROWS)
    found, values, rest = run.point_get_batch(
        ops.keys_to_device(queries, "cpu"), IOStats())
    assert found.tolist() == [k in full for k in queries]
    assert values.dtype == object and values.tolist() == list(full.values())
    assert rest.numel() == len(queries) - len(full)
    assert port_run.ASSEMBLY_ROWS["view"] - before["view"] == len(full)
    assert port_run.ASSEMBLY_ROWS["exact"] == before["exact"]

    odd = {1: b"ends in zero\x00", 2: b"\x00\x00", 3: b"", 4: None,
           5: b"short", 6: b"x" * 99 + b"\x00", 7: b"y" * 100, 8: b"\x00a"}
    # 1, 2 and 6 end in a zero byte; 3, 5 and 8 are short: exact when
    # their padding is 0xAB, a view when it is zero
    for pad, exact in ((0xAB, 6), (0, 3)):
        run = _run_of(odd.items(), 100, pad)
        before = dict(port_run.ASSEMBLY_ROWS)
        keys = list(range(0, 10))
        found, values, _ = run.point_get_batch(
            ops.keys_to_device(keys, "cpu"), IOStats())
        assert found.tolist() == [k in odd for k in keys]
        assert values.tolist() == list(odd.values())
        assert [run.point_get(k, IOStats()) for k in keys] == \
            [(k in odd, odd.get(k)) for k in keys]
        # each hit row counted twice: in the batch and in its point_get
        assert port_run.ASSEMBLY_ROWS["exact"] - before["exact"] == 2 * exact
        assert port_run.ASSEMBLY_ROWS["view"] - before["view"] == \
            2 * (len(odd) - 1 - exact)

    # a run with no value bytes at all: empty values and a tombstone
    run = _run_of({1: b"", 2: None, 3: b""}.items(), 0, 0)
    before = dict(port_run.ASSEMBLY_ROWS)
    found, values, _ = run.point_get_batch(
        ops.keys_to_device([0, 1, 2, 3], "cpu"), IOStats())
    assert found.tolist() == [False, True, True, True]
    assert values.tolist() == [b"", None, b""]
    assert port_run.ASSEMBLY_ROWS["view"] - before["view"] == 2
    assert port_run.ASSEMBLY_ROWS["exact"] == before["exact"]

    # through a store: flushed runs whose padding is then made non-zero
    # (the entry checksums cover value[:vlen] only, so paranoid reads pass)
    port = rt.LSMStore(rt.LSMConfig(memtable_bytes=1 << 12,
                                    paranoid_checks=True), device="cpu")
    want = {}
    for k in range(300):
        v = None if k % 5 == 0 else b"p%d" % k + b"\x00" * (k % 3)
        want[k] = v
        if v is None:
            port.delete(k)
        else:
            port.put(k, v)
    port.flush()
    runs = list(port._runs_newest_first(port._levels))
    assert len(runs) > 1
    for r in runs:
        col = torch.arange(r.vals.shape[1])
        r.vals = torch.where(col >= r.vlens.clamp(min=0)[:, None],
                             torch.tensor(0xCD, dtype=torch.uint8), r.vals)
    queries = list(range(320))
    assert port.multi_get(queries) == [want.get(k) for k in queries]
    assert port.get(7) == want[7] and port.get(5) is None


def test_multi_get_empty_and_memtable_only():
    port, reference = make_pair("garnering", 0.8)
    for db in (port, reference):
        assert db.multi_get([]) == []
        db.put(1, b"a")
        db.delete(2)
        # memtable-resolved: value, tombstone, miss
        assert db.multi_get([1, 2, 3]) == [b"a", None, None]
        assert db.scan(0, 5) == [(1, b"a")]
        assert db.seek(2) is None and db.seek(0) == 1
    assert_same_stats(port, reference)


def test_scan_interleaves_memtable_and_runs():
    port, reference = make_pair("garnering", 0.8, memtable_bytes=1 << 14)
    for db in (port, reference):
        for k in range(0, 100, 2):
            db.put(k, b"run")
        db.flush()
        for k in range(1, 100, 2):
            db.put(k, b"mem")           # stays in the memtable
        db.delete(4)
        got = db.scan(0, 8)
        assert got == [(0, b"run"), (1, b"mem"), (2, b"run"), (3, b"mem"),
                       (5, b"mem"), (6, b"run"), (7, b"mem"), (8, b"run")]
        assert db.scan_scalar(0, 8) == got
        # the memtable tombstone hides nothing from seek's run walk
        assert db.seek(4) == 4
    assert_same_stats(port, reference)


def test_snapshot_pinned_across_many_compactions():
    """get_snapshot pins the version: its runs survive manifest GC no matter
    how many commits follow, until release_snapshot; then the pins are back
    at 0 and the snapshot's runs are gone from the run storage."""
    port, reference = make_pair("garnering", 0.8)
    snaps = []
    for db in (port, reference):
        for k in range(100):
            db.put(k, b"old")
        db.flush()
        snaps.append(db.get_snapshot())
    pinned = set(port.storage.ids())
    for rep in range(30):            # >> the manifest's 8-version tail
        for db in (port, reference):
            for k in range(100):
                db.put(k, f"r{rep}".encode())
            db.flush()
    assert pinned <= set(port.storage.ids())
    for db, snap in zip((port, reference), snaps):
        assert db.manifest.pin_count(snap.version_id) == 1
        assert db.get(5, snapshot=snap) == b"old"
        assert db.multi_get([5, 6, 7], snapshot=snap) == [b"old"] * 3
        assert db.scan(5, 3, snapshot=snap) == [(5, b"old"), (6, b"old"),
                                                (7, b"old")]
        assert db.seek(5, snapshot=snap) == 5
        it = db.iterator(snapshot=snap)
        it.seek(98)
        assert list(it) == [(98, b"old"), (99, b"old")]
    assert_same_stats(port, reference)
    for db, snap in zip((port, reference), snaps):
        db.release_snapshot(snap)
        assert db.manifest.total_pin_refs() == 0
        assert db.get(5) == b"r29"
    assert not pinned & set(port.storage.ids())
    assert sorted(port.storage.ids()) == \
        sorted(set(port.manifest.live_run_ids()))
    assert len(port.storage) == len(reference.storage)


def test_snapshot_pins_are_refcounted():
    port, reference = make_pair("garnering", 0.8)
    for db in (port, reference):
        db.put(1, b"x")
        db.flush()
    a = [db.get_snapshot() for db in (port, reference)]
    b = [db.get_snapshot() for db in (port, reference)]
    for db, sa, sb in zip((port, reference), a, b):
        assert sa.version_id == sb.version_id
        assert db.manifest.pin_count(sa.version_id) == 2
        for k in range(2, 400):
            db.put(k, b"y" * 20)
        db.release_snapshot(sa)
        assert db.manifest.pin_count(sb.version_id) == 1
        assert db.get(1, snapshot=sb) == b"x"
        assert db.get(2, snapshot=sb) is None
        db.release_snapshot(sb)
        assert db.manifest.total_pin_refs() == 0
        assert not db.manifest.unpin(sb.version_id)
    assert len(port.storage) == len(reference.storage)


def test_bloom_port_probe_and_pallas_probe_agree():
    """The port's probe (the CUDA kernel's plain version) gives the bits of
    the reference's Pallas kernel and of its numpy filter."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 2 ** 63, 900, dtype=np.uint64)
    bf = RefBloomFilter(keys, bits_per_key=10)
    bits = torch.from_numpy(np.ascontiguousarray(bf.bits, np.uint32)
                            .view(np.int32))
    for nq in (1, 64, 512, 700):   # below / at / above the kernel block
        q = np.concatenate([rng.integers(0, 2 ** 63, nq, dtype=np.uint64),
                            np.array(EDGE, np.uint64)])
        got = bloom.probe_plain(ops.keys_to_device(q, "cpu"), bits,
                                bf.k).numpy()
        np.testing.assert_array_equal(got, bloom_probe_filter(bf, q))
        np.testing.assert_array_equal(got, bf.may_contain(q))
    assert bloom.probe_plain(ops.keys_to_device(keys, "cpu"), bits,
                             bf.k).all()   # no false negatives


def test_multi_get_port_matches_pallas_route():
    port, reference = make_pair("garnering", 0.8)
    oracle, _, _ = run_workload([port, reference], seed=21, n_ops=600)
    for db in (port, reference):
        db.flush()
    queries = list(np.random.default_rng(9).integers(0, 500, 200))
    reference.config.use_pallas_bloom = True
    ops.reset_launch_counts()
    expected = reference.multi_get(queries)
    assert port.multi_get(queries) == expected
    assert expected == [oracle.get(int(k)) for k in queries]
    assert ops.PLAIN_CALLS["bloom_probe"] > 0
    assert_same_stats(port, reference)


def test_pallas_bloom_differential_bit_for_bit_same_batches():
    """The port's probe lane against the reference's Pallas route
    (interpret mode): on the same key batches the same values AND the same
    filter decisions — every probe/negative/false-positive/block counter in
    the IOStats delta matches exactly."""
    port, reference = make_pair("garnering", 0.8, bits_per_key=10)
    oracle, _, _ = run_workload([port, reference], seed=33, n_ops=1200)
    for db in (port, reference):
        db.flush()
    rng = np.random.default_rng(17)
    batches = [list(rng.integers(0, 600, sz)) for sz in (1, 63, 64, 257, 500)]
    reference.config.use_pallas_bloom = True
    deltas, results = [], []
    for db in (port, reference):
        s0 = db.stats.snapshot()
        results.append([db.multi_get(b) for b in batches])
        deltas.append(dataclasses.asdict(db.stats.delta(s0)))
    assert results[0] == results[1] == \
        [[oracle.get(int(k)) for k in b] for b in batches]
    assert deltas[0] == deltas[1]
    assert deltas[0]["bloom_probes"] > 0


# ------------------------------------------- tombstone-dense range scans (§3)
def test_tombstone_dense_scan_refill_count_is_logarithmic():
    """~120k contiguous tombstones are crossed in the reference's refill
    count, which is O(log deleted) and at most 14, with the same result as
    ``scan_scalar`` and the same accounting; a fresh scan after it starts
    from the base ramp again."""
    port, reference = make_pair("garnering", 0.8, memtable_bytes=1 << 16,
                                base_level_bytes=1 << 18, bits_per_key=0)
    n, live_tail, wave = 120_000, 1_000, 8_192
    for db in (port, reference):
        for i in range(0, n, wave):
            ks = list(range(i, min(i + wave, n)))
            db.put_batch(ks, [b"v%d" % k for k in ks])
        for i in range(0, n - live_tail, wave):
            db.delete_batch(list(range(i, min(i + wave, n - live_tail))))
        db.flush()
    counts = []
    for db in (port, reference):
        it = db.iterator()
        refills = [0]
        orig = it._refill

        def counting(_orig=orig, _refills=refills):
            _refills[0] += 1
            return _orig()

        it._refill = counting
        got = it.scan(0, 100)
        assert [k for k, _ in got] == list(range(n - live_tail,
                                                 n - live_tail + 100))
        counts.append(refills[0])
        it2 = db.iterator()
        assert it2.scan(n - live_tail, 5) == got[:5]
    assert counts[0] == counts[1] <= 14
    assert_same_stats(port, reference)
    assert port.scan_scalar(0, 100) == reference.scan_scalar(0, 100)
    assert_same_stats(port, reference)


def test_deleted_range_scan_differential_mid_range_probes():
    """Scans *starting inside* a tombstone-dense band (and exactly at its
    edges) match the reference and the scalar oracle, also with fresh
    writes in the band (memtable + runs merge)."""
    port, reference = make_pair("garnering", 0.8, memtable_bytes=1 << 13,
                                base_level_bytes=1 << 15)
    n = 6_000
    for db in (port, reference):
        db.put_batch(list(range(n)), [b"x%d" % k for k in range(n)])
        db.flush()
        db.delete_batch(list(range(1_000, 5_000)))
        db.flush()
    for start in (0, 999, 1_000, 1_001, 2_500, 4_999, 5_000, 5_001, n - 10):
        got = port.scan(start, 64)
        assert got == reference.scan(start, 64) == port.scan_scalar(start, 64)
        assert got == reference.scan_scalar(start, 64)
        assert port.seek(start) == reference.seek(start)
    for db in (port, reference):
        db.put_batch(list(range(2_000, 2_050)),
                     [b"new%d" % k for k in range(2_000, 2_050)])
    for start in (1_500, 1_999, 2_000, 2_025, 2_050, 3_000):
        got = port.scan(start, 64)
        assert got == reference.scan(start, 64) == port.scan_scalar(start, 64)
        assert got == reference.scan_scalar(start, 64)
        assert port.seek(start) == reference.seek(start)
    assert_same_stats(port, reference)


# ------------------------------------------------- the modules underneath
def test_memtable_scan_matches_reference():
    from repro.core.memtable import Memtable as RefMemtable
    from repro_torch.core.memtable import Memtable
    port, reference = Memtable(1 << 20), RefMemtable(1 << 20)
    rng = np.random.default_rng(4)
    keys = [int(k) for k in rng.integers(0, 1000, 300)] + EDGE
    for mt in (port, reference):
        for i, k in enumerate(keys):
            mt.put(k, i + 1, None if i % 7 == 0 else b"v%d" % i)
    for start in [0, 1, 500, 999, 1000] + EDGE:
        assert port.scan(start) == reference.scan(start)
        assert port.scan(start, limit=1) == reference.scan(start)[:1]
    # a write after a scan is seen by the next scan; the earlier view stays
    before = port.scan(0)
    for mt in (port, reference):
        mt.put(5, 10_000, b"late")
        mt.put_batch([6, 2**64 - 1], [b"a", None], 10_001)
    assert port.scan(0) == reference.scan(0) != before
    assert port.scan(0)[:len(before)] != before or len(before) == 0
    for mt in (port, reference):
        mt.clear()
    assert port.scan(0) == reference.scan(0) == []


def test_run_range_helpers_match_reference_at_u64_extremes():
    port, reference = make_pair("garnering", 0.8, memtable_bytes=1 << 12,
                                bits_per_key=10, l0_compaction_trigger=8)
    rng = np.random.default_rng(8)
    keys = [int(k) for k in rng.integers(0, 2**64 - 1, 500,
                                         dtype=np.uint64)] + EDGE
    for db in (port, reference):
        db.put_batch(keys, [b"k%d" % (k % 977) * (k % 5) for k in keys])
        db.delete_batch(keys[::9])
        db.flush()
    runs_p = list(port._runs_newest_first(port._levels))
    runs_r = list(reference._runs_newest_first(reference._levels))
    assert len(runs_p) == len(runs_r) > 1
    for rp, rr in zip(runs_p, runs_r):
        for key in EDGE + [1, 2**63 + 1, 2**64 - 2] + keys[:20]:
            i = rp.seek_idx(key)
            assert i == rr.seek_idx(key), key
            for count in (0, 1, 7, len(rr)):
                got, want = rp.slice_from(i, count), rr.slice_from(i, count)
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype
                    np.testing.assert_array_equal(g, w)
                assert rp.blocks_spanned(i, i + count) == \
                    rr.blocks_spanned(i, i + count)
        rows = np.array([0, len(rr) - 1, len(rr) // 2, 0], dtype=np.int64)
        want = [None if rr.vlens[r] == TOMBSTONE_LEN
                else bytes(rr.vals[r, :rr.vlens[r]]) for r in rows]
        assert rp.values_at(rows) == want
        assert rp.values_at(np.zeros(0, np.int64)) == []
    from repro_torch.core.run import seek_batch
    for key in EDGE:
        idx, at = seek_batch(runs_p, key)
        assert idx == [r.seek_idx(key) for r in runs_r]
        assert at == [int(r.keys[i]) if i < len(r) else None
                      for r, i in zip(runs_r, idx)]


def test_manifest_pins_match_reference():
    from repro.core.manifest import Manifest as RefManifest
    from repro.core.manifest import RunStorage as RefRunStorage
    from repro_torch.core.manifest import Manifest, RunStorage
    port, reference = Manifest(RunStorage()), RefManifest(RefRunStorage())
    for m in (port, reference):
        v0 = m.pin_current()
        m.pin(v0)
        assert m.pin_count(v0.version_id) == 2
        assert not m.unpin(v0.version_id)
        assert m.unpin(v0.version_id)
        assert not m.unpin(v0.version_id)
        assert m.total_pin_refs() == 0
        m.pin(m.current())
        assert m.total_pin_refs() == 1


# ------------------------------------------------ seek: first live memtable key
def test_seek_takes_the_first_live_memtable_key():
    """The minimal input of the reference's ``seek`` fault: a memtable
    tombstone (2616) before a live memtable key (2620), a run key after
    them (2622).  The reference skips 2620 and answers 2622, pinned here
    as its fault; the port answers 2620, the first live key, as ``scan``
    does.  Both through the run walk and through a range view."""
    for views in (False, True):
        cfg = dict(use_range_views=views)
        port = rt.LSMStore(rt.LSMConfig(**cfg), device="cpu")
        reference = ref.LSMStore(ref.LSMConfig(**cfg))
        for db in (port, reference):
            db.put(2622, b"a")
            db.flush()
            db.delete(2616)
            db.put(2620, b"b")
            assert db.scan(2615, 1) == [(2620, b"b")]
        assert reference.seek(2615) == 2622          # the reference's fault
        assert seek_with_reference_fault(reference, 2615) == 2622
        assert port.seek(2615) == 2620 == seek_plain(reference, 2615)
        timing_free = [{k: v for k, v in dataclasses.asdict(db.stats).items()
                        if not k.endswith("_ns")} for db in (port, reference)]
        assert timing_free[0] == timing_free[1]      # the same cost charged
        assert port.seek(2617) == 2620 and port.seek(2621) == 2622


@given(st.integers(0, 10_000), st.booleans(), st.booleans())
@settings(max_examples=12, deadline=None)
def test_seek_lies_between_key_and_first_live_key(seed, views, async_):
    """Property, on random mixes of memtable (active and rotated) and run
    entries with tombstones in both: ``key <= seek(key) <= the first live
    key >= key`` (a flushed tombstone may still answer, as a cost probe),
    and ``seek`` is the plain definition on the reference store fed the
    same operations, whose own answer differs only where its fault
    shows."""
    rng = np.random.default_rng(seed)
    cfg = dict(memtable_bytes=1 << 10, base_level_bytes=1 << 12,
               bits_per_key=8, use_range_views=views)
    port = rt.LSMStore(rt.LSMConfig(async_compaction=async_, **cfg),
                       device="cpu")
    reference = ref.LSMStore(ref.LSMConfig(**cfg))
    space = 150
    try:
        for i in range(600):
            k = int(rng.integers(0, space))
            if rng.random() < 0.4:
                both = [db.delete(k) for db in (port, reference)]
            else:
                both = [db.put(k, b"%d" % i) for db in (port, reference)]
            if rng.random() < 0.02:
                both = [db.flush() for db in (port, reference)]
            if i % 100 == 99:
                if async_:
                    assert port.wait_for_quiesce(60)
                for key in rng.integers(0, space + 5, 12).tolist():
                    got = port.seek(key)
                    live = port.scan(key, 1)
                    assert live == reference.scan(key, 1)
                    if live:
                        assert got is not None and key <= got <= live[0][0]
                    elif got is not None:
                        assert got >= key
                    assert got == seek_plain(reference, key), key
                    want = reference.seek(key)
                    if want != got:
                        assert want == seek_with_reference_fault(
                            reference, key)
        del both
    finally:
        port.close()


# ------------------------------------------ the memtable probe's two branches
PROBE_CASES = ["values_tombstones_overwrites", "active_and_immutable",
               "repeated_keys", "u64_edges", "write_between_waves",
               "after_flush_clear"]


def probe_counts() -> dict:
    return dict(port_memtable.MEMTABLE_PROBE)


def force_probe_branch(monkeypatch, branch: str) -> None:
    """Every probe through the key column, or every one through a
    ``dict.get`` per key."""
    if branch == "column":
        monkeypatch.setattr(port_memtable, "_COLUMN_MIN_KEYS", 0)
        monkeypatch.setattr(port_memtable, "_COLUMN_BUILD_RATIO", 1 << 40)
    else:
        monkeypatch.setattr(port_memtable, "_COLUMN_MIN_KEYS", 1 << 62)


def wave_vs_scalar(port, reference, wave):
    """``port.multi_get(wave)`` against the reference's ``get`` per key:
    the same answers and the same IOStats delta."""
    s_p, s_r = port.stats.snapshot(), reference.stats.snapshot()
    got = port.multi_get(wave)
    want = [reference.get(int(k)) for k in wave]
    assert got == want
    assert dataclasses.asdict(port.stats.delta(s_p)) == \
        dataclasses.asdict(reference.stats.delta(s_r))
    return got


def both(dbs, fn):
    for db in dbs:
        fn(db)


@pytest.mark.parametrize("branch", ["column", "dict"])
@pytest.mark.parametrize("case", PROBE_CASES)
def test_memtable_probe_branches_match_scalar_get(case, branch, monkeypatch):
    """``multi_get`` through either branch of the memtable probe answers
    as the reference's scalar ``get`` does, with its IOStats, wherever the
    memtable decides the answer: a value, a tombstone, an overwrite, the
    active memtable over an immutable one, a key repeated in the wave, keys
    at the u64 extremes, a write between two waves, and the runs after a
    flush's clear.  The counter shows the branch each probe took."""
    force_probe_branch(monkeypatch, branch)
    dbs = make_pair("garnering", 0.8, memtable_bytes=1 << 16,
                    async_compaction=case == "active_and_immutable",
                    stall_trigger=0, slowdown_trigger=0)
    port, reference = dbs
    before = probe_counts()
    rng = np.random.default_rng(PROBE_CASES.index(case))
    try:
        both(dbs, lambda db: db.put_batch(list(range(0, 300, 2)),
                                          [b"run%d" % k
                                           for k in range(0, 300, 2)]))
        both(dbs, lambda db: db.flush())
        if case == "active_and_immutable":
            for db in dbs:
                assert db.wait_for_quiesce(60)
                db._scheduler.pause()
                for k in range(100, 160):
                    db.put(k, b"imm%d" % k)
                db.flush()                    # rotate, do not flush
                db.put(107, b"active107")
                db.delete(108)
                db.put(400, b"active400")
                assert len(db._imm) == 1 and db._imm[0].memtable.get(107)
        elif case == "u64_edges":
            edge = EDGE + [1, 2**63 + 1]
            both(dbs, lambda db: db.put_batch(edge[:3],
                                              [b"e%d" % k for k in edge[:3]]))
            both(dbs, lambda db: db.flush())
            both(dbs, lambda db: db.put_batch(edge[2:],
                                              [b"m%d" % k for k in edge[2:]]))
            both(dbs, lambda db: db.delete(0))
        else:
            for i, k in enumerate(rng.integers(0, 400, 200).tolist()):
                if i % 5 == 0:
                    both(dbs, lambda db: db.delete(k))
                else:
                    both(dbs, lambda db: db.put(k, b"mem%d.%d" % (k, i)))
        wave = rng.integers(0, 450, 500).tolist()
        if case == "repeated_keys":
            wave = [int(k) for k in rng.choice(wave[:20], 500)]
        elif case == "active_and_immutable":
            wave += [107, 108, 400, 120, 107]
        elif case == "u64_edges":
            wave += EDGE + [1, 2, 2**63 + 1, 2**64 - 2] * 2
        got = wave_vs_scalar(port, reference, wave)
        if case == "repeated_keys":
            assert len(set(wave)) < len(wave)
            for k in set(wave):
                assert len({got[i] for i, w in enumerate(wave) if w == k}) == 1
        elif case == "active_and_immutable":
            assert got[-5:] == [b"active107", None, b"active400", b"imm120",
                                b"active107"]
        elif case == "u64_edges":
            at = dict(zip(wave, got))
            assert at[2**64 - 1] == b"m%d" % (2**64 - 1)
            assert at[2**63] == b"m%d" % 2**63 and at[0] is None
            assert at[2**63 - 1] == b"e%d" % (2**63 - 1)
        elif case == "write_between_waves":
            both(dbs, lambda db: db.put(wave[0], b"late"))
            both(dbs, lambda db: db.put_batch([wave[1], 10**6], [b"b", b"c"]))
            both(dbs, lambda db: db.delete(wave[2]))
            again = wave_vs_scalar(port, reference, wave + [10**6])
            assert again[:3] == [b"late", b"b", None] and again[-1] == b"c"
        elif case == "after_flush_clear":
            both(dbs, lambda db: db.flush())
            assert len(port.memtable) == 0
            assert wave_vs_scalar(port, reference, wave) == got
            both(dbs, lambda db: db.put(wave[3], b"fresh"))
            assert wave_vs_scalar(port, reference, wave)[3] == b"fresh"
        assert_same_stats(port, reference)
    finally:
        for db in dbs:
            if case == "active_and_immutable":
                db._scheduler.resume()
            db.close()
    after = probe_counts()
    used, unused = (("column_keys", "dict_keys") if branch == "column"
                    else ("dict_keys", "column_keys"))
    assert after[used] > before[used]
    assert after[unused] == before[unused]


def test_memtable_probe_counter_follows_the_batch():
    """Left to its rule: a large wave takes the column, which is built once
    for two waves with no write between them; a single ``get`` takes the
    dict; after a write, a batch small against the memtable takes the dict
    until a large one has built the column again."""
    port, reference = make_pair("garnering", 0.8, memtable_bytes=1 << 20)
    keys = list(range(0, 3000, 3))
    for db in (port, reference):
        db.put_batch(keys, [b"v%d" % k for k in keys])
    wave = np.random.default_rng(3).integers(0, 4000, 4096).tolist()

    def delta(fn):
        c0 = probe_counts()
        fn()
        return {k: v - c0[k] for k, v in probe_counts().items()}

    want = {"column_keys": 4096, "dict_keys": 0, "column_builds": 1}
    assert delta(lambda: wave_vs_scalar(port, reference, wave)) == want
    want["column_builds"] = 0
    assert delta(lambda: wave_vs_scalar(port, reference, wave)) == want
    def single():
        assert port.get(3) == reference.get(3) == b"v3"

    assert delta(single) == {"column_keys": 0, "dict_keys": 1,
                             "column_builds": 0}
    small = wave[:200]                  # 200 keys against 1,000 in the memtable
    assert delta(lambda: wave_vs_scalar(port, reference, small)) == {
        "column_keys": 200, "dict_keys": 0, "column_builds": 0}
    for db in (port, reference):
        db.put(5000, b"w")
    assert delta(lambda: wave_vs_scalar(port, reference, small)) == {
        "column_keys": 0, "dict_keys": 200, "column_builds": 0}
    assert delta(lambda: wave_vs_scalar(port, reference, wave)) == {
        "column_keys": 4096, "dict_keys": 0, "column_builds": 1}
    assert_same_stats(port, reference)


@pytest.mark.parametrize("key_type", ["int", "uint64"])
def test_memtable_key_column_per_generation(key_type):
    """The key column is every key as uint64 ascending, whether the dict
    holds Python ints or numpy uint64s, near 2^64 too; it is built once a
    write generation (a frozen memtable builds it once), and the column
    probe finds exactly the positions whose key is there."""
    conv = int if key_type == "int" else np.uint64
    rng = np.random.default_rng(11)
    raw = [int(k) for k in rng.integers(0, 2**64 - 1, 400, dtype=np.uint64)]
    raw += EDGE + [2**64 - 2, 5, 5]
    mt = port_memtable.Memtable(1 << 30)
    mt.put_batch([conv(k) for k in raw], [b"x"] * len(raw), 1)
    want = sorted({int(k) for k in raw})
    c0 = probe_counts()["column_builds"]
    col = mt._key_column()[1]
    assert col.dtype == np.uint64 and col.tolist() == want
    assert mt._key_column()[1] is col
    assert probe_counts()["column_builds"] == c0 + 1
    mt.put(conv(7), 10_000, None)
    col2 = mt._key_column()[1]
    assert col2 is not col and col2.tolist() == sorted(set(want) | {7})
    wave = np.array(raw[::3] + [1, 2**64 - 3, 6, 7, 2**63 + 1] +
                    rng.integers(0, 2**64 - 1, 300, dtype=np.uint64).tolist(),
                    dtype=np.uint64)
    present = set(col2.tolist())
    assert mt.probe(wave).tolist() == [i for i, k in enumerate(wave.tolist())
                                       if k in present]
    frozen = port_memtable.ImmutableMemtable(
        mt, port_memtable.WriteAheadLog()).memtable
    assert frozen._key_column()[1] is col2
    assert probe_counts()["column_builds"] == c0 + 2
    low = port_memtable.Memtable(1 << 30)         # keys past the column's end
    low.put_batch(list(range(1000)), [b"s"] * 1000, 1)
    assert low.probe(np.arange(30_000, dtype=np.uint64)).tolist() == \
        list(range(1000))
    mt2 = port_memtable.Memtable(1 << 20)
    mt2.put(1, 1, b"a")
    mt2.clear()
    assert mt2._key_column()[1].tolist() == []
    assert mt2.probe(wave).tolist() == []


@given(st.lists(st.integers(0, 2**64 - 1), max_size=300),
       st.lists(st.integers(0, 2**64 - 1), min_size=1, max_size=300),
       st.integers(0, 2**32))
@settings(max_examples=30, deadline=None)
def test_memtable_column_probe_is_exact_membership(held, asked, seed):
    """Property: the column pass returns exactly the positions of the keys
    the memtable holds, repeats included, whatever the keys' bits."""
    rng = np.random.default_rng(seed)
    mt = port_memtable.Memtable(1 << 30)
    mt.put_batch(held, [b"v"] * len(held), 1)
    if held:
        asked = asked + [held[int(i)] for i in
                         rng.integers(0, len(held), len(asked))]
    wave = np.array(asked, dtype=np.uint64)
    mt._key_column()                    # built: the column branch from 96
    pos = mt.probe(wave)
    if wave.size >= 96:
        assert pos.tolist() == [i for i, k in enumerate(asked)
                                if mt.get(k) is not None]
    else:
        assert pos.tolist() == list(range(wave.size))
