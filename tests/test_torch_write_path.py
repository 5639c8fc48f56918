"""repro_torch's write and compaction path vs the reference's
(``tests/test_write_path.py``).

The eleven cases of ``tests/test_write_path.py`` that hold the port's own
write path, with the same seeds, sizes, configurations and strategies, on
``repro_torch.LSMStore(device="cpu")`` and CPU runs beside the reference:
write_batch against the scalar loop (WAL bytes, IOStats, trees, values),
put_batch's values and duplicates, the WAL fsyncs a batch coalesces, the
k-way merge against the plain oracle ``merge_runs_scalar`` (and both
against the reference's oracle, bit for bit, counters included), tombstone
GC at the deepest level, block size and key bytes reaching every run, the
live-entry and space-amplification algebra, and the block cache's batched
lanes against per-block reads.  Every port store ends with the
reference's tree and IOStats.

The other eight cases have twins elsewhere:
  * ``test_put_batch_fsync_every_write_durability``,
    ``test_torn_batch_tail_recovery``,
    ``test_wal_append_batch_bytes_match_scalar_appends`` and
    ``test_wal_outlier_length_batch_spans_stay_bounded_and_bit_exact``, by
    name, in ``tests/test_torch_recovery.py``;
  * the four ``test_pallas_*`` cases hold the reference's Pallas lanes
    (interpret mode) against its numpy lanes.  The port has one lane per
    kernel, and these tests hold it against the Pallas lanes:
    ``test_torch_store.py::test_port_store_bit_for_bit_vs_pallas_reference``
    (the merge and bloom-build routes through flushes and compactions, the
    u64 edge keys included, trees and IOStats equal),
    ``test_torch_kernels.py::test_merge_sweep_vs_merge_runs_tiled``,
    ``::test_merge_u64_max_and_duplicates_across_sides`` and
    ``::test_build_matches_build_bits``; the maximum u64 key's merge
    through whole runs is below (``test_merge_runs_scalar_equals_the_
    reference``).
All lanes are integer: tolerance 0.
"""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as ref
import repro.core.run as ref_run
import repro.core.types as ref_types
import repro_torch as rt
from repro_torch.core import IOStats, build_run, merge_runs, merge_runs_scalar
from repro_torch.core import types as port_types
from repro_torch.core.cache import BlockCache
from repro_torch.core.types import KEY_BYTES, TOMBSTONE_LEN
from repro_torch.kernels import ops
from test_torch_store import assert_same_tree

# Six xdist workers share 8 cores with the reference's timing-bounded
# property tests: one intra-op thread per worker keeps them on time.
torch.set_num_threads(1)


def small_cfg(**kw) -> dict:
    base = dict(policy="garnering", T=2.0, c=0.8, memtable_bytes=1 << 12,
                base_level_bytes=1 << 14, bits_per_key=8,
                bloom_allocation="monkey")
    base.update(kw)
    return base


def port_store(**kw):
    return rt.LSMStore(rt.LSMConfig(**small_cfg(**kw)), device="cpu")


def ref_store(**kw):
    return ref.LSMStore(ref.LSMConfig(**small_cfg(**kw)))


def gen_ops(seed: int, n_ops: int, key_space: int = 300, del_frac: float = 0.2):
    rng = np.random.default_rng(seed)
    ops_ = []
    for i in range(n_ops):
        k = int(rng.integers(0, key_space))
        if rng.random() < del_frac:
            ops_.append((k, None))
        else:
            ops_.append((k, bytes([65 + i % 26]) * int(rng.integers(0, 120))))
    return ops_


def stats_dict(stats) -> dict:
    return dataclasses.asdict(stats)


def assert_same_as_reference(port, reference):
    assert_same_tree(port, reference)
    assert stats_dict(port.stats) == stats_dict(reference.stats)


# ----------------------------------------------------------- batched ingest
@given(st.integers(0, 10_000), st.integers(1, 600))
@settings(max_examples=12, deadline=None)
def test_write_batch_matches_scalar_loop(seed, wave):
    """Property: write_batch in arbitrary wave sizes is bit-for-bit the
    scalar loop — WAL bytes, IOStats (incl. write-amp counters), the run
    arrays of every level, and every readable value; and both are the
    reference's scalar loop."""
    ops_ = gen_ops(seed, 1200)
    db_s, db_b, want = port_store(), port_store(), ref_store()
    for k, v in ops_:
        (db_s.delete(k) if v is None else db_s.put(k, v))
        (want.delete(k) if v is None else want.put(k, v))
    for i in range(0, len(ops_), wave):
        db_b.write_batch(ops_[i:i + wave])
    assert bytes(db_s.wal._buf) == bytes(db_b.wal._buf) == bytes(want.wal._buf)
    assert stats_dict(db_s.stats) == stats_dict(db_b.stats)
    assert db_s.stats.write_amplification() == \
        db_b.stats.write_amplification() == want.stats.write_amplification()
    assert_same_as_reference(db_s, want)
    assert_same_as_reference(db_b, want)
    for k in range(300):
        assert db_s.get(k) == db_b.get(k) == want.get(k), k


def test_put_batch_values_and_duplicates():
    dbs = [port_store(memtable_bytes=1 << 20),
           ref_store(memtable_bytes=1 << 20)]
    for db in dbs:
        db.put_batch([1, 2, 3], [b"a", b"b", b"c"])
        db.put_batch([4, 5], b"bcast")           # broadcast single value
        db.write_batch([(2, None), (6, b"x"), (6, b"y"), (7, None)])
        assert db.multi_get([1, 2, 3, 4, 5, 6, 7, 8]) == \
            [b"a", None, b"c", b"bcast", b"bcast", b"y", None, None]
        db.write_batch([])                        # empty batch is a no-op
        assert db.total_live_entries() == 5
    assert bytes(dbs[0].wal._buf) == bytes(dbs[1].wal._buf)
    assert stats_dict(dbs[0].stats) == stats_dict(dbs[1].stats)


def fsync_counts(db, make_scalar_twin):
    """The reference case's counts on one package's stores: WAL fsyncs of
    a one-chunk batch, of its scalar twin, and (chunks, fsyncs, flushes)
    of a multi-chunk batch."""
    ops_ = [(k, b"x" * 10) for k in range(500)]
    fsyncs = []
    orig_fsync = db.wal.fsync
    db.wal.fsync = lambda stats: (fsyncs.append(1), orig_fsync(stats))[1]
    db.write_batch(ops_)
    db_s = make_scalar_twin(wal_fsync_every_write=True,
                            memtable_bytes=1 << 20)
    s0 = db_s.stats.snapshot()
    for k, v in ops_:
        db_s.put(k, v)
    scalar = db_s.stats.delta(s0).wal_fsyncs
    db_m = make_scalar_twin(wal_fsync_every_write=True)  # 4 KiB memtable
    chunks, fsyncs_m, flushes = [], [], []
    orig_append = db_m.wal.append_batch_cols
    orig_fsync_m = db_m.wal.fsync
    orig_flush = db_m.flush
    db_m.wal.append_batch_cols = \
        lambda *a, **k: (chunks.append(1), orig_append(*a, **k))[1]
    db_m.wal.fsync = lambda stats: (fsyncs_m.append(1), orig_fsync_m(stats))[1]
    db_m.flush = lambda: (flushes.append(1), orig_flush())[1]
    db_m.write_batch(ops_)
    return len(fsyncs), scalar, (len(chunks), len(fsyncs_m), len(flushes))


def test_write_batch_fsync_coalescing_counts():
    """With wal_fsync_every_write=True a batch fsyncs once per *chunk*
    (group commit), not once per record — asserted by counting actual WAL
    fsync calls, not just the documented contract.

    A single-chunk batch (big memtable) costs exactly one WAL fsync for
    hundreds of records; the scalar twin pays one per record.  A multi-chunk
    batch (small memtable) costs one per chunk plus the flush-path fsyncs.
    The reference counts the same.
    """
    one, scalar, (chunks, fsyncs_m, flushes) = fsync_counts(
        port_store(wal_fsync_every_write=True, memtable_bytes=1 << 20),
        port_store)
    assert one == 1
    assert scalar == 500
    assert chunks > 1 and flushes >= 1
    assert chunks < 500, "chunking degenerated to per-record"
    assert fsyncs_m == chunks + flushes
    assert (one, scalar, (chunks, fsyncs_m, flushes)) == fsync_counts(
        ref_store(wal_fsync_every_write=True, memtable_bytes=1 << 20),
        ref_store)


# ------------------------------------------------------- vectorized merges
def run_columns(seed: int, n: int, key_space: int = 3000, vmax: int = 24,
                tomb: float = 0.15, seq0: int = 0):
    """The reference case's run, as numpy columns."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, key_space, n).astype(np.uint64))
    n = len(keys)
    seqs = seq0 + rng.permutation(n).astype(np.uint64)
    vlens = rng.integers(0, vmax + 1, n).astype(np.int32)
    vlens[rng.random(n) < tomb] = TOMBSTONE_LEN
    vals = np.zeros((n, vmax), dtype=np.uint8)
    for i in range(n):
        if vlens[i] > 0:
            vals[i, :vlens[i]] = rng.integers(1, 255, vlens[i])
    return keys, seqs, vlens, vals


def run_pair(cols, bits_per_key: float = 0.0):
    """(port run on the CPU, reference run) of the same columns."""
    keys, seqs, vlens, vals = cols
    port = build_run(ops.keys_to_device(keys, "cpu"),
                     torch.from_numpy(seqs.view(np.int64).copy()),
                     torch.from_numpy(vlens.copy()),
                     torch.from_numpy(vals.copy()), bits_per_key,
                     assume_unique_sorted=True)
    return port, ref.build_run(keys, seqs, vlens, vals, bits_per_key,
                               assume_unique_sorted=True)


def assert_same_run(a, b):
    """A port run against a reference run (or another port run)."""
    def host(run):
        if isinstance(run.keys, np.ndarray):
            return run.keys, run.seqs, run.vlens, run.vals, run.bloom.bits
        return (ops.keys_from_device(run.keys),
                run.seqs.numpy().view(np.uint64), run.vlens.numpy(),
                run.vals.numpy(), run.bloom.bits_numpy())
    for x, y in zip(host(a), host(b)):
        assert x.shape == y.shape and x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert a.n_blocks == b.n_blocks and a.data_bytes == b.data_bytes


def merge_case(runs_cols, bits_per_key: float, drop: bool):
    """The port's merge_runs and merge_runs_scalar and the reference's
    merge_runs_scalar on the same runs: outputs and IOStats equal."""
    pairs = [run_pair(c) for c in runs_cols]
    port_runs = [p for p, _ in pairs]
    ref_runs = [r for _, r in pairs]
    s_ref, s_vec, s_oracle = ref.IOStats(), IOStats(), IOStats()
    want = ref_run.merge_runs_scalar(ref_runs, bits_per_key, s_ref,
                                     drop_tombstones=drop)
    oracle = merge_runs_scalar(port_runs, bits_per_key, s_oracle,
                               drop_tombstones=drop)
    out = merge_runs(port_runs, bits_per_key, s_vec, drop_tombstones=drop)
    assert_same_run(oracle, out)
    assert_same_run(oracle, want)
    assert stats_dict(s_vec) == stats_dict(s_oracle) == stats_dict(s_ref)
    return oracle


@given(st.integers(0, 10_000), st.integers(1, 6), st.booleans())
@settings(max_examples=12, deadline=None)
def test_merge_matches_scalar_oracle(seed, n_runs, drop):
    """Property: the k-way merge is bit-for-bit the concat + sort oracle —
    keys/seqs/vlens/vals/bloom AND the write-amp counter algebra (blocks
    read/written, entries/bytes compacted) — and the oracle is the
    reference's."""
    rng = np.random.default_rng(seed)
    # disjoint seq ranges per run, as engine flush/compaction produces
    runs = [run_columns(seed * 13 + i, int(rng.integers(1, 900)),
                        seq0=i * 1_000_000) for i in range(n_runs)]
    merge_case(runs, 6.0, drop)


def test_merge_large_hits_vector_path():
    """Above the reference's adaptive threshold its ladder (not its scalar
    fallback) runs; the port's ladder, its oracle and the reference's
    oracle agree bit for bit."""
    runs = [run_columns(i + 1, 9000, key_space=60_000, seq0=i * 1_000_000)
            for i in range(3)]
    assert sum(len(r[0]) for r in runs) > 8192
    ops.reset_launch_counts()
    merge_case(runs, 4.0, drop=False)
    assert ops.PLAIN_CALLS["merge_pair"] == 2     # the ladder's two merges


def test_merge_tombstone_gc_at_deepest_level():
    """Engine-level: a full merge into the deepest level drops tombstones
    on the batched write path exactly as on the scalar one."""
    dbs = [port_store(), ref_store()]
    tasks = (rt.core.CompactionTask, ref.CompactionTask)
    for db, task in zip(dbs, tasks):
        db.put_batch(list(range(400)), b"x" * 30)
        db.delete_batch(list(range(400)))
        db.flush()
        assert db.total_live_entries() == 0
        deepest = db._deepest_nonempty()
        for i in range(1, deepest):
            if db._levels[i]:
                db._apply(task(i, deepest, True, "test-force"))
        if db._levels[0]:
            db._apply(task(0, deepest, True, "test-force"))
        assert sum(len(r) for lvl in db._levels[1:] for r in lvl) == 0
        assert db.get(5) is None
    assert_same_as_reference(*dbs)


# ------------------------------------------------ block-size threading bug
def test_config_block_size_and_key_bytes_reach_runs():
    """Regression: build_run/merge_runs/Memtable.to_run used to ignore
    LSMConfig.block_size/key_bytes and always built module-default runs."""
    db = port_store(block_size=512, key_bytes=8, bits_per_key=0)
    want = ref_store(block_size=512, key_bytes=8, bits_per_key=0)
    for s in (db, want):
        s.put_batch(list(range(2000)), b"v" * 40)
        s.flush()
    seen = 0
    for lvl in db._levels:
        for run in lvl:
            seen += 1
            assert run.block_size == 512
            expect_bytes = int(torch.sum(8 + run.vlens.clamp(min=0)))
            assert run.data_bytes == expect_bytes
            assert run.n_blocks == -(-expect_bytes // 512)
    assert seen >= 1
    assert db.stats.compactions > 0     # merge outputs were checked too
    assert db.stats.blocks_written > 0
    assert_same_as_reference(db, want)
    # same tree built with defaults packs far fewer, larger blocks
    db_def = port_store(bits_per_key=0)
    db_def.put_batch(list(range(2000)), b"v" * 40)
    db_def.flush()
    assert db.stats.blocks_written > db_def.stats.blocks_written


# ------------------------------------------- live-entry / space-amp algebra
@given(st.integers(0, 10_000))
@settings(max_examples=10, deadline=None)
def test_total_live_entries_and_space_amp_match_oracle(seed):
    ops_ = gen_ops(seed, 800, key_space=200)
    db, want = port_store(), ref_store()
    oracle = {}
    for k, v in ops_:
        for s in (db, want):
            (s.delete(k) if v is None else s.put(k, v))
        oracle[k] = v
    live = {k: v for k, v in oracle.items() if v is not None}
    assert db.total_live_entries() == len(live)
    phys = sum(r.data_bytes for lvl in db._levels for r in lvl) \
        + db.memtable.size_bytes
    logical = sum(KEY_BYTES + len(v) for v in live.values())
    if logical:
        assert db.space_amplification() == pytest.approx(phys / logical)
    else:
        assert db.space_amplification() == 1.0
    assert db.space_amplification() == want.space_amplification()
    assert_same_as_reference(db, want)


def test_space_amp_shrinks_after_full_compaction():
    dbs = [port_store(bits_per_key=0, memtable_bytes=1 << 15),
           ref_store(bits_per_key=0, memtable_bytes=1 << 15)]
    amps = []
    for db, task in zip(dbs, (rt.core.CompactionTask, ref.CompactionTask)):
        for rep in range(3):                  # stack shadowed versions in L0
            db.put_batch(list(range(300)), bytes([rep + 1]) * 40)
            db.flush()                        # 3 L0 runs, below the trigger
        amp_before = db.space_amplification()
        assert amp_before > 1.2               # duplicates inflate the bytes
        deepest = db._deepest_nonempty()
        for i in range(1, deepest):
            if db._levels[i]:
                db._apply(task(i, deepest, True, "test-force"))
        if db._levels[0]:
            db._apply(task(0, deepest, True, "test-force"))
        amp_after = db.space_amplification()
        assert amp_after < amp_before
        assert amp_after == pytest.approx(1.0)   # one run, all live
        amps.append((amp_before, amp_after))
    assert amps[0] == amps[1]
    assert_same_as_reference(*dbs)


# ---------------------------------------------------- cache span charging
def test_read_blocks_and_span_match_scalar_read_block():
    """The batched cache lanes are charge-for-charge identical to a
    per-block read_block loop on a twin cache, and to the reference's
    caches driven the same way."""
    rng = np.random.default_rng(3)
    for policy in ("lru", "clock"):
        a, b = BlockCache(8 * 512, policy), BlockCache(8 * 512, policy)
        ra = ref.BlockCache(8 * 512, policy)
        sa, sb, sr = IOStats(), IOStats(), ref.IOStats()
        for _ in range(40):
            rid = int(rng.integers(0, 3))
            ids = rng.integers(0, 24, int(rng.integers(1, 9))).tolist()
            if rng.random() < 0.5:
                lo, hi = min(ids), max(ids)
                a.read_block_span(rid, lo, hi, lambda bid: 512, sa)
                ra.read_block_span(rid, lo, hi, lambda bid: 512, sr)
                for bid in range(lo, hi + 1):
                    b.read_block(rid, bid, 512, sb)
            else:
                a.read_blocks(rid, ids, lambda bid: 512, sa)
                ra.read_blocks(rid, ids, lambda bid: 512, sr)
                for bid in ids:
                    b.read_block(rid, bid, 512, sb)
        assert (a.hits, a.misses, a.evictions) == (b.hits, b.misses,
                                                   b.evictions) == \
            (ra.hits, ra.misses, ra.evictions)
        assert list(a._entries) == list(b._entries) == list(ra._entries)
        assert stats_dict(sa) == stats_dict(sb) == stats_dict(sr)


def test_batched_reads_cached_match_scalar_accounting():
    """End to end: with a cache attached, multi_get/scan accounting equals
    the scalar paths' on an identically built twin store, and the
    reference's."""
    ops_ = gen_ops(11, 1500, key_space=400)
    kw = dict(cache_bytes=64 << 10, pin_l0_bytes=8 << 10)
    db_a, db_b = port_store(**kw), port_store(**kw)
    want_a, want_b = ref_store(**kw), ref_store(**kw)
    db_a.write_batch(ops_)
    want_a.write_batch(ops_)
    for k, v in ops_:
        for s in (db_b, want_b):
            (s.delete(k) if v is None else s.put(k, v))
    queries = list(np.random.default_rng(5).integers(0, 500, 300))
    deltas, answers = [], []
    for batched, scalar in ((db_a, db_b), (want_a, want_b)):
        s_a = batched.stats.snapshot()
        got_batched = batched.multi_get(queries)
        scans_a = [batched.scan(int(k), 20) for k in queries[:30]]
        d_a = batched.stats.delta(s_a)
        s_b = scalar.stats.snapshot()
        got_scalar = [scalar.get(int(k)) for k in queries]
        scans_b = [scalar.scan(int(k), 20) for k in queries[:30]]
        d_b = scalar.stats.delta(s_b)
        assert got_batched == got_scalar and scans_a == scans_b
        assert stats_dict(d_a) == stats_dict(d_b)
        deltas.append(stats_dict(d_a))
        answers.append((got_batched, scans_a))
    assert deltas[0] == deltas[1] and answers[0] == answers[1]
    assert_same_as_reference(db_a, want_a)
    assert_same_as_reference(db_b, want_b)


# ------------------------------------------- the plain merge oracle itself
TOP = np.iinfo(np.uint64).max


def max_key_runs():
    """The reference's max-u64 case: two runs whose keys reach 2^64 - 1."""
    ka = np.array([1, 5, TOP], dtype=np.uint64)
    kb = np.array([2, 5, 9], dtype=np.uint64)
    return [(ka, np.array([1, 2, 3], np.uint64), np.array([3, 3, 3], np.int32),
             np.tile(np.array([7, 8, 9], np.uint8), (3, 1))),
            (kb, np.array([11, 12, 13], np.uint64),
             np.array([3, 3, 3], np.int32),
             np.tile(np.array([4, 5, 6], np.uint8), (3, 1)))]


@pytest.mark.parametrize("case", ["max_u64", "one_run", "widths",
                                  "all_tombstones"])
@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("bits_per_key", [0.0, 10.0])
def test_merge_runs_scalar_equals_the_reference(case, drop, bits_per_key):
    """``merge_runs_scalar`` is the reference's oracle bit for bit (the
    output run, its filter and the IOStats) and equals ``merge_runs``: at
    the maximum u64 key, on one run, on runs of different value widths,
    and on runs of tombstones only."""
    if case == "max_u64":
        runs = max_key_runs()
    elif case == "one_run":
        runs = [run_columns(5, 400)]
    elif case == "widths":
        runs = [run_columns(6, 300, vmax=4),
                run_columns(7, 500, vmax=40, seq0=10**6),
                run_columns(8, 50, vmax=0, seq0=2 * 10**6)]
    else:
        runs = [run_columns(9, 200, tomb=1.0), run_columns(
            10, 200, tomb=1.0, seq0=10**6)]
    out = merge_case(runs, bits_per_key, drop)
    if case == "max_u64":
        assert ops.keys_from_device(out.keys)[-1] == TOP


def test_merge_runs_scalar_of_no_runs_is_the_reference_empty_run():
    s, s_ref = IOStats(), ref.IOStats()
    out = merge_runs_scalar([], 10.0, s)
    want = ref_run.merge_runs_scalar([], 10.0, s_ref)
    assert len(out) == len(want) == 0 and out.device.type == "cpu"
    assert (out.n_blocks, out.data_bytes, out.bloom.m_bits) == \
        (want.n_blocks, want.data_bytes, want.bloom.m_bits)
    assert stats_dict(s) == stats_dict(s_ref)


@pytest.mark.parametrize("key_bytes", [8, KEY_BYTES])
@pytest.mark.parametrize("block_size", [512, 4096])
def test_entry_and_block_sizes_equal_the_reference(key_bytes, block_size):
    for val_len in (TOMBSTONE_LEN, 0, 1, 100, 5000):
        assert port_types.entry_bytes(val_len, key_bytes) == \
            ref_types.entry_bytes(val_len, key_bytes)
    assert port_types.entry_bytes(100) == ref_types.entry_bytes(100) == 116
    for nbytes in (0, 1, block_size - 1, block_size, block_size + 1,
                   10 ** 7):
        assert port_types.blocks_for_bytes(nbytes, block_size) == \
            ref_types.blocks_for_bytes(nbytes, block_size)
