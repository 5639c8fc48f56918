"""repro_torch's fault injection, checksums and degradation vs the reference.

Every case of ``tests/test_faults.py`` but the sharded facade's runs on
``repro.core.LSMStore`` and on ``repro_torch.LSMStore(device="cpu")`` side
by side, each side with its own package's ``FaultInjector`` (same seed) and
``Telemetry``: the crash matrix over ``FAULT_SITES`` (the migration sites
through the port's ``export_range``/``strip_to_range``/
``import_migrated_run``), the WAL tail and manifest corruptions, block
corruption quarantine, paranoid reads on a clean store, background retry
and degradation, and recovery under telemetry.  Where a case is
deterministic the two sides must agree bit for bit: the answers, the trees,
every IOStats counter (wall-clock ``*_ns`` fields aside), ``fired``, the
corrupted bytes and the raised ``(run, block)``, and the sequence of event
kinds.  Where background threads make the sequence timing-dependent, each
side is held to the reference test's own assertions.
"""
import dataclasses
import struct
import zlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as ref
import repro_torch.core as pc
from repro.core.run import build_run as ref_build_run
from repro_torch.core import run as port_run
from repro_torch.core.memtable import _CRC, _HDR, FRAME_OVERHEAD
from repro_torch.core.memtable import WriteAheadLog
from repro_torch.kernels import ops
from test_torch_store import assert_same_tree
from test_torch_telemetry import assert_phase_classes

# Six xdist workers share 8 cores with the reference's timing-bounded
# property tests: one intra-op thread per worker keeps them on time.
torch.set_num_threads(1)

KEY_SPACE = 300
_NAMES = ("LSMConfig", "FaultInjector", "Telemetry", "InjectedFault",
          "CorruptionError", "StoreDegradedError", "IOStats")
PORT = SimpleNamespace(**{n: getattr(pc, n) for n in _NAMES}, port=True,
                       LSMStore=lambda c: pc.LSMStore(c, device="cpu"))
REF = SimpleNamespace(**{n: getattr(ref, n) for n in _NAMES}, port=False,
                      LSMStore=ref.LSMStore)
BOTH = (PORT, REF)


def cfg(P, **kw):
    base = dict(policy="garnering", T=2.0, c=0.8, memtable_bytes=1 << 12,
                base_level_bytes=1 << 14, bits_per_key=8,
                bloom_allocation="monkey")
    base.update(kw)
    return P.LSMConfig(**base)


def gen_ops(seed: int, n_ops: int, key_space: int = KEY_SPACE,
            del_frac: float = 0.2):
    rng = np.random.default_rng(seed)
    ops_ = []
    for i in range(n_ops):
        k = int(rng.integers(0, key_space))
        if rng.random() < del_frac:
            ops_.append((k, None))
        else:
            ops_.append((k, bytes([65 + i % 26]) * int(rng.integers(0, 100))))
    return ops_


def apply_ops(db, ops_):
    for k, v in ops_:
        (db.delete(k) if v is None else db.put(k, v))


def db_view(db, key_space: int = KEY_SPACE):
    return {k: db.get(k) for k in range(key_space)}


def oracle_view(ops_, j, key_space: int = KEY_SPACE):
    d = {k: None for k in range(key_space)}
    for k, v in ops_[:j]:
        d[k] = v
    return d


def find_matching_prefix(db, ops_, key_space: int = KEY_SPACE):
    view = db_view(db, key_space)
    d = {k: None for k in range(key_space)}
    if view == d:
        return 0
    for j, (k, v) in enumerate(ops_, start=1):
        d[k] = v
        if view == d:
            return j
    return -1


def counters(db) -> dict:
    """IOStats without the wall-clock timers."""
    return {k: v for k, v in dataclasses.asdict(db.stats).items()
            if not k.endswith("_ns")}


def events(tel) -> list:
    """The trace's (kind, fields) without timestamps, tokens' clocks, run
    ids (a per-package counter) or exception texts."""
    drop = ("t0", "dur_ns", "error", "run_id")
    return [(e.kind, {k: v for k, v in e.fields.items() if k not in drop})
            for e in tel.trace.dump()]


def _retry(P, fn, *args):
    for _ in range(20):
        try:
            return fn(*args)
        except P.InjectedFault:
            continue
    raise AssertionError(f"injected fault at {fn.__name__} kept firing")


# ============================================================ CRC-32C oracle
def test_crc32c_known_vectors():
    for m in (ref, pc):
        assert m.crc32c(b"123456789") == 0xE3069283
        assert m.crc32c(b"") == 0
        assert m.crc32c(b"123456789") != zlib.crc32(b"123456789")


@given(st.lists(st.lists(st.integers(0, 255), max_size=40),
                min_size=0, max_size=8))
@settings(max_examples=30, deadline=None)
def test_crc32c_rows_matches_scalar(rows):
    msgs = [bytes(r) for r in rows]
    width = max([len(m) for m in msgs], default=0) or 1
    mat = np.zeros((len(msgs), width), np.uint8)
    for i, m in enumerate(msgs):
        mat[i, :len(m)] = np.frombuffer(m, np.uint8)
    lens = np.array([len(m) for m in msgs], np.int64)
    want = [ref.crc32c(m) for m in msgs]
    assert [int(x) for x in pc.crc32c_rows(mat, lens)] == want
    assert pc.crc32c_rows_torch(torch.from_numpy(mat),
                                torch.from_numpy(lens)).tolist() == want


# ================================================== WAL frame integrity
def _frame_off(i, vlen):
    return i * (FRAME_OVERHEAD + vlen)


@pytest.mark.parametrize("garbage_vlen", [0x7FFFFFFF, 13])
def test_wal_replay_stops_at_corrupt_length(garbage_vlen):
    out = []
    for wal, st_ in ((WriteAheadLog(), pc.IOStats()),
                     (ref.WriteAheadLog(), ref.IOStats())):
        vlen = 10
        for i in range(10):
            wal.append(1, i, i + 1, bytes([i]) * vlen, st_)
        wal.fsync(st_)
        off = _frame_off(5, vlen) + _CRC.size + _HDR.size - 4
        wal._buf[off:off + 4] = struct.pack("<I", garbage_vlen)
        assert [r[1] for r in wal.records()] == [0, 1, 2, 3, 4]
        dropped = wal.repair()
        assert dropped == 5 * (FRAME_OVERHEAD + vlen)
        wal.append(1, 99, 100, b"zz", st_)
        recs = list(wal.records())
        assert [r[1] for r in recs] == [0, 1, 2, 3, 4, 99]
        out.append((bytes(wal._buf), recs))
    assert out[0] == out[1]


def test_wal_torn_payload_is_dropped():
    out = []
    for wal, st_ in ((WriteAheadLog(), pc.IOStats()),
                     (ref.WriteAheadLog(), ref.IOStats())):
        for i in range(4):
            wal.append(1, i, i + 1, b"x" * 20, st_)
        wal._buf = wal._buf[:-7]
        assert [r[1] for r in wal.records()] == [0, 1, 2]
        assert wal.repair() == (FRAME_OVERHEAD + 20) - 7
        out.append(bytes(wal._buf))
    assert out[0] == out[1]


@pytest.mark.parametrize("mode", ["torn", "bitflip", "garbage"])
def test_mangle_wal_tail_draws_equal_reference(mode):
    """One seed: the same bytes kept and damaged in the same buffer."""
    rng = np.random.default_rng(3)
    buf = bytearray(rng.integers(0, 256, 200, dtype=np.uint8).tobytes())
    got = []
    for m in (pc, ref):
        f = m.FaultInjector(seed=12).corrupt_wal_tail(mode)
        b = bytearray(buf)
        keep = f.mangle_wal_tail(b, 150)
        got.append((keep, bytes(b), f.fired, f.wal_tail_mode))
    assert got[0] == got[1]


# ======================================= crash-point matrix (fail half)
def _run_script(P, db, ops_, half=KEY_SPACE // 2):
    """The reference's scripted workload: load, flush, snapshot reads,
    and a migration roundtrip (strip [0, half), re-import the copy)."""
    mid = len(ops_) // 2
    for k, v in ops_[:mid]:
        _retry(P, db.delete if v is None else db.put,
               *((k,) if v is None else (k, v)))
    _retry(P, db.flush)
    for k, v in ops_[mid:]:
        _retry(P, db.delete if v is None else db.put,
               *((k,) if v is None else (k, v)))
    _retry(P, db.flush)
    snap = db.get_snapshot()
    try:
        for k in range(0, KEY_SPACE, 7):
            _retry(P, db.get, k, snap)
    finally:
        db.release_snapshot(snap)
    cols = db.export_range(0, half)
    try:
        db.strip_to_range(half, 1 << 64)
    except P.InjectedFault:
        return
    if cols is not None:
        k, sq, vl, vv = cols
        kw = dict(bits_per_key=db._bits_for_level(0), drop_tombstones=True,
                  block_size=db.config.block_size,
                  key_bytes=db.config.key_bytes)
        if P.port:
            run = port_run.build_run(k, sq, vl, vv, **kw)
        else:
            run = ref_build_run(k, sq, vl, vv, hash_fn=db._bloom_hash_fn(),
                                **kw)
        if len(run):
            _retry(P, db.import_migrated_run, run)


@pytest.mark.parametrize("site", pc.FAULT_SITES)
def test_crash_matrix_one_shot_fault(site):
    assert pc.FAULT_SITES == ref.FAULT_SITES
    ops_ = gen_ops(101, 400)
    dbs, fired, seen = [], [], []
    for P in BOTH:
        f = P.FaultInjector(seed=5)
        f.fail(site, times=1)
        db = P.LSMStore(cfg(P, faults=f))
        _run_script(P, db, ops_)
        assert f.fired.get(site) == 1, f"site {site} never fired"
        assert db_view(db) == oracle_view(ops_, len(ops_))
        seen.append(counters(db))
        db.crash()
        db.recover()
        assert db_view(db) == oracle_view(ops_, len(ops_))
        db.put(KEY_SPACE + 1, b"post-recovery")
        assert db.get(KEY_SPACE + 1) == b"post-recovery"
        dbs.append(db)
        fired.append(dict(f.fired))
    assert fired[0] == fired[1]
    assert seen[0] == seen[1]
    assert counters(dbs[0]) == counters(dbs[1])
    assert_same_tree(*dbs)


def test_export_strip_import_equal_reference():
    """The migration primitives on their own: the same exported columns,
    dropped counts, trees and counters on both stores."""
    ops_ = gen_ops(7, 500)
    P_db = [(P, P.LSMStore(cfg(P))) for P in BOTH]
    for P, db in P_db:
        apply_ops(db, ops_)
        db.flush()
    (_, port), (_, reference) = P_db
    for lo, hi in ((0, 120), (100, 1 << 64), (250, 251), (400, 500)):
        a, b = port.export_range(lo, hi), reference.export_range(lo, hi)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(ops.keys_from_device(a[0]), b[0])
            np.testing.assert_array_equal(a[1].numpy().view(np.uint64), b[1])
            np.testing.assert_array_equal(a[2].numpy(), b[2])
            np.testing.assert_array_equal(a[3].numpy(), b[3])
    assert port.strip_to_range(50, 1 << 64) == \
        reference.strip_to_range(50, 1 << 64)
    assert port.strip_to_range(50, 260) == reference.strip_to_range(50, 260)
    assert_same_tree(port, reference)
    assert counters(port) == counters(reference)
    assert db_view(port) == db_view(reference)


def test_chaos_probabilistic_faults_recover_to_oracle():
    ops_ = gen_ops(303, 500)
    out = []
    for P in BOTH:
        f = P.FaultInjector(seed=9)
        for site in ("wal_append", "wal_fsync", "flush_write",
                     "manifest_fsync", "compaction_merge"):
            f.fail_prob(site, 0.05)
        db = P.LSMStore(cfg(P, faults=f))
        for k, v in ops_:
            _retry(P, db.delete if v is None else db.put,
                   *((k,) if v is None else (k, v)))
        f.clear()
        db.flush()
        assert db_view(db) == oracle_view(ops_, len(ops_))
        db.crash()
        db.recover()
        assert db_view(db) == oracle_view(ops_, len(ops_))
        out.append((dict(f.fired), counters(db), db))
    assert out[0][0] == out[1][0] and out[0][0]
    assert out[0][1] == out[1][1]
    assert_same_tree(out[0][2], out[1][2])


def test_wal_append_fault_excludes_the_op():
    out = []
    for P in BOTH:
        f = P.FaultInjector()
        db = P.LSMStore(cfg(P, faults=f))
        apply_ops(db, gen_ops(1, 50))
        f.fail("wal_append")
        with pytest.raises(P.InjectedFault):
            db.put(999, b"x")
        assert db.get(999) is None
        db.put(999, b"x")
        assert db.get(999) == b"x"
        f.fail("wal_append")
        with pytest.raises(P.InjectedFault):
            db.write_batch([(1000, b"y"), (1001, b"z")])
        out.append((bytes(db.wal._buf), counters(db), dict(f.fired)))
    assert out[0] == out[1]


def test_manifest_fsync_fault_keeps_wal_for_replay():
    ops_ = gen_ops(17, 120)
    dbs = []
    for P in BOTH:
        f = P.FaultInjector()
        db = P.LSMStore(cfg(P, faults=f, memtable_bytes=1 << 20))
        apply_ops(db, ops_[:60])
        db.flush()
        apply_ops(db, ops_[60:])
        f.fail("manifest_fsync")
        with pytest.raises(P.InjectedFault):
            db.flush()
        db.crash()
        db.recover()
        assert db_view(db) == oracle_view(ops_, len(ops_))
        dbs.append(db)
    assert_same_tree(*dbs)
    assert counters(dbs[0]) == counters(dbs[1])


def test_wal_fsync_fault_then_crash_loses_only_unsynced_tail():
    ops_ = gen_ops(23, 120)
    views = []
    for P in BOTH:
        f = P.FaultInjector()
        db = P.LSMStore(cfg(P, faults=f, memtable_bytes=1 << 20))
        apply_ops(db, ops_[:60])
        db.flush()
        apply_ops(db, ops_[60:])
        f.fail("wal_fsync")
        with pytest.raises(P.InjectedFault):
            db.flush()
        db.crash()
        db.recover()
        j = find_matching_prefix(db, ops_)
        assert 60 <= j < len(ops_) or \
            db_view(db) == oracle_view(ops_, len(ops_))
        views.append((db_view(db), counters(db)))
    assert views[0] == views[1]


# ================================================ corruption half
@pytest.mark.parametrize("mode", ["torn", "bitflip", "garbage"])
def test_wal_tail_corruption_is_prefix_consistent(mode):
    ops_ = gen_ops(41, 200)
    out = []
    for P in BOTH:
        f = P.FaultInjector(seed=7)
        tel = P.Telemetry()
        db = P.LSMStore(cfg(P, faults=f, telemetry=tel,
                            memtable_bytes=1 << 20))
        apply_ops(db, ops_[:100])
        db.flush()
        apply_ops(db, ops_[100:160])
        db.fsync_wal()
        apply_ops(db, ops_[160:])
        f.corrupt_wal_tail(mode)
        db.crash()
        db.recover()
        assert f.fired.get("wal_tail:" + mode) == 1
        j = find_matching_prefix(db, ops_)
        assert j >= 100
        if mode == "torn":
            assert j >= 160
        else:
            assert j < 160
            assert "corruption" in {e.kind for e in tel.trace.dump()}
        db.put(KEY_SPACE + 2, b"after-repair")
        db.flush()
        db.crash()
        db.recover()
        assert db.get(KEY_SPACE + 2) == b"after-repair"
        out.append((j, dict(f.fired), events(tel), counters(db),
                    bytes(db.wal._buf)))
    assert out[0] == out[1]


def test_manifest_corruption_falls_back_one_version():
    ops_ = gen_ops(53, 200)
    out = []
    for P in BOTH:
        f = P.FaultInjector()
        tel = P.Telemetry()
        db = P.LSMStore(cfg(P, faults=f, telemetry=tel,
                            memtable_bytes=1 << 20))
        apply_ops(db, ops_[:100])
        db.flush()
        apply_ops(db, ops_[100:])
        db.flush()
        f.corrupt_manifest_edit()
        db.crash()
        db.recover()
        assert f.fired.get("manifest_edit") == 1
        j = find_matching_prefix(db, ops_)
        assert j >= 100
        evs = [e for e in tel.trace.dump() if e.kind == "corruption"]
        assert any(e.fields.get("where") == "manifest" for e in evs)
        out.append((j, events(tel), counters(db), db))
    assert out[0][:3] == out[1][:3]
    assert_same_tree(out[0][3], out[1][3])


def test_block_corruption_quarantined_never_silent():
    ops_ = [(k, bytes([k % 251]) * 40) for k in range(KEY_SPACE)]
    out = []
    for P in BOTH:
        f = P.FaultInjector(seed=11)
        tel = P.Telemetry()
        db = P.LSMStore(cfg(P, faults=f, telemetry=tel, paranoid_checks=True,
                            memtable_bytes=1 << 20))
        apply_ops(db, ops_)
        db.flush()
        assert db.scrub() and all(not r["bad_blocks"] for r in db.scrub())
        run = db._levels[0][-1] if db._levels[0] else \
            next(r for lvl in db._levels for r in lvl if len(r))
        bid = f.corrupt_run_block(run)
        if P.port:
            keys = ops.keys_from_device(run.keys)
            victims = keys[run.block_of.numpy() == bid]
            cols = (keys, run.seqs.numpy().view(np.uint64),
                    run.vals.numpy().copy())
        else:
            victims = run.keys[run.block_of == bid]
            cols = (run.keys, run.seqs, run.vals.copy())
        assert victims.size
        with pytest.raises(P.CorruptionError) as ei:
            db.get(int(victims[0]))
        assert ei.value.run_id == run.run_id and ei.value.block_id == bid
        s_get = counters(db)
        with pytest.raises(P.CorruptionError) as ei2:
            db.multi_get([int(k) for k in victims[:4]])
        assert (ei2.value.run_id, ei2.value.block_id) == (run.run_id, bid)
        evs = [e for e in tel.trace.dump() if e.kind == "corruption"]
        assert any(e.fields.get("run_id") == run.run_id for e in evs)
        report = db.scrub()
        bad = [r for r in report if r["bad_blocks"]]
        assert len(bad) == 1 and bad[0]["run_id"] == run.run_id \
            and bid in bad[0]["bad_blocks"]
        db.crash()
        with pytest.raises(P.CorruptionError) as ei:
            db.recover()
        assert ei.value.where == "recovery scrub"
        out.append((bid, dict(f.fired), cols, s_get, counters(db),
                    events(tel), bad[0]["bad_blocks"]))
    (bp, fp, cp, *rp), (br, fr, cr, *rr) = out
    assert (bp, fp) == (br, fr)
    for a, b in zip(cp, cr):        # the same bytes corrupted
        np.testing.assert_array_equal(a, b)
    assert rp == rr


def test_paranoid_reads_bit_identical_on_clean_store():
    ops_ = gen_ops(67, 600)
    out = []
    for P in BOTH:
        db = P.LSMStore(cfg(P))
        apply_ops(db, ops_)
        db.flush()
        keys = list(range(KEY_SPACE))
        plain = (db.multi_get(keys), [db.get(k) for k in keys],
                 db.scan(0, KEY_SPACE),
                 [db.seek(k) for k in range(0, 300, 11)])
        s_plain = counters(db)
        db.config.paranoid_checks = True
        checked = (db.multi_get(keys), [db.get(k) for k in keys],
                   db.scan(0, KEY_SPACE),
                   [db.seek(k) for k in range(0, 300, 11)])
        assert plain == checked
        out.append((checked, s_plain, counters(db)))
    assert out[0] == out[1]


def test_paranoid_batch_verifies_blocks_in_one_pass_per_run():
    """A paranoid multi_get verifies each run's candidate blocks in one
    device pass, whatever the number of blocks; and the block it names on
    a corrupted run is the reference's lowest bad candidate block."""
    dbs = []
    for P in BOTH:
        db = P.LSMStore(cfg(P, paranoid_checks=True, memtable_bytes=1 << 11))
        apply_ops(db, [(k, bytes([k % 7]) * (k % 90)) for k in range(2000)])
        db.flush()
        dbs.append(db)
    port, reference = dbs
    runs = sum(1 for lvl in port._levels for r in lvl if len(r))
    keys = list(range(0, 2100, 3))
    before = dict(port_run.VERIFY_PASSES)
    assert port.multi_get(keys) == reference.multi_get(keys)
    assert port_run.VERIFY_PASSES["batch"] - before["batch"] <= runs
    assert port_run.VERIFY_PASSES["block"] == before["block"]
    assert counters(port) == counters(reference)
    lvl = max(i for i, lv in enumerate(reference._levels) if lv)
    rp, rr = port._levels[lvl][0], reference._levels[lvl][0]
    for row in (40, 41, 300, len(rr) - 1):      # three blocks, ascending
        if rr.vlens[row] > 0:
            rp.vals[row, 0] ^= 1
            rr.vals[row, 0] ^= 1
        else:
            rp.seqs[row] ^= 1
            rr.seqs[row] ^= np.uint64(1)
    got = []
    for db in dbs:
        with pytest.raises((pc.CorruptionError, ref.CorruptionError)) as ei:
            db.multi_get(keys)
        got.append(ei.value.block_id)
    assert got[0] == got[1]
    assert counters(port) == counters(reference)


def test_block_read_faults_fire_per_candidate_as_reference():
    """fail_every('block_read', n) fires on the same candidate of the same
    wave, with the same counters charged up to it."""
    out = []
    for P in BOTH:
        f = P.FaultInjector(seed=2)
        db = P.LSMStore(cfg(P, faults=f))
        apply_ops(db, gen_ops(5, 900))
        db.flush()
        f.fail_every("block_read", 37)
        raised = 0
        for lo in range(0, 300, 50):
            try:
                db.multi_get(list(range(lo, lo + 60)))
            except P.InjectedFault:
                raised += 1
        f.clear()
        out.append((raised, dict(f.fired), counters(db),
                    db.multi_get(list(range(KEY_SPACE)))))
    assert out[0] == out[1] and out[0][0] > 0


# ================================== graceful degradation (retry -> degrade)
@pytest.mark.parametrize("site", ["flush_write", "compaction_merge"])
def test_bg_transient_fault_retried_to_sync_oracle(site):
    ops_ = gen_ops(55, 1000)
    trees = []
    f = pc.FaultInjector()
    f.fail(site, times=1)
    db_a = pc.LSMStore(cfg(PORT, async_compaction=True, faults=f,
                           bg_max_retries=3), device="cpu")
    db_s = ref.LSMStore(cfg(REF))
    try:
        apply_ops(db_a, ops_)
        apply_ops(db_s, ops_)
        db_a.flush()
        db_s.flush()
        assert db_a.wait_for_quiesce(60)
        assert f.fired.get(site) == 1
        assert db_a.stats.bg_retries >= 1
        assert db_a.stats.bg_gave_up == 0
        assert not db_a.degraded
        assert_same_tree(db_a, db_s)
        keys = list(range(KEY_SPACE))
        assert db_a.multi_get(keys) == db_s.multi_get(keys)
        trees.append(db_a)
    finally:
        db_a.close()


def test_bg_persistent_fault_degrades_read_only_then_recovers():
    ops_ = gen_ops(71, 2000, del_frac=0.0)
    for P in BOTH:
        f = P.FaultInjector().fail("flush_write", times=-1)
        tel = P.Telemetry()
        db = P.LSMStore(cfg(P, async_compaction=True, faults=f,
                            bg_max_retries=1, telemetry=tel))
        applied = []
        try:
            for k, v in ops_:
                try:
                    db.put(k, v)
                    applied.append((k, v))
                except P.StoreDegradedError:
                    break
            else:
                db.flush()
                with pytest.raises(RuntimeError, match="background"):
                    db.wait_for_quiesce(60)
            assert db.degraded
            with pytest.raises(P.StoreDegradedError):
                db.put(0, b"rejected")
            with pytest.raises(P.StoreDegradedError):
                db.write_batch([(0, b"rejected")])
            db.get(applied[0][0])
            s = db.stats
            assert s.bg_retries >= 1 and s.bg_gave_up >= 1
            kinds = {e.kind for e in tel.trace.dump()}
            assert {"bg_retry", "bg_failure", "degraded"} <= kinds
            f.clear("flush_write")
            db.crash()
            db.recover()
            assert not db.degraded
            assert "bg_abort" in {e.kind for e in tel.trace.dump()}
            assert find_matching_prefix(db, applied) >= 0
            db.put(7, b"write service restored")
            assert db.get(7) == b"write service restored"
            db.flush()
            assert db.wait_for_quiesce(60)
        finally:
            db.close()


def test_degraded_close_is_idempotent_and_loss_free():
    ops_ = gen_ops(83, 600, del_frac=0.0)
    for P in BOTH:
        f = P.FaultInjector().fail("flush_write", times=-1)
        db = P.LSMStore(cfg(P, async_compaction=True, faults=f,
                            bg_max_retries=0))
        applied = []
        for k, v in ops_:
            try:
                db.put(k, v)
                applied.append((k, v))
            except P.StoreDegradedError:
                break
        with pytest.raises(RuntimeError, match="background"):
            db.close()
        db.close()
        db.close()
        assert db._scheduler is None
        assert db_view(db) == oracle_view(applied, len(applied))
        f.clear()
        db.put(KEY_SPACE + 3, b"sync path")
        db.flush()
        assert db.get(KEY_SPACE + 3) == b"sync path"


def test_rotate_losing_degradation_race_accepts_the_write():
    for P in BOTH:
        db = P.LSMStore(cfg(P, async_compaction=True))
        sched = db._scheduler
        real_submit = sched.submit
        boom = RuntimeError("simulated background job failure")

        def racing_submit(job, db=db, sched=sched, real_submit=real_submit):
            db._enter_degraded(boom)
            with sched._cv:
                if sched._failure is None:
                    sched._failure = boom
            return real_submit(job)

        sched.submit = racing_submit
        applied = []
        i = 0
        while not db.degraded:
            v = bytes([97 + i % 26]) * 50
            db.put(i % KEY_SPACE, v)
            applied.append((i % KEY_SPACE, v))
            i += 1
            assert i < 10_000, "memtable never rotated"
        sched.submit = real_submit
        with pytest.raises(P.StoreDegradedError):
            db.put(0, b"rejected")
        with pytest.raises(RuntimeError, match="background"):
            db.close()
        db.close()
        assert db._scheduler is None
        assert db_view(db) == oracle_view(applied, len(applied))


# ======================================= recovery under telemetry
def test_recover_with_telemetry_matches_plain_twin():
    ops_ = gen_ops(91, 400)
    out = []
    for P in BOTH:
        tel = P.Telemetry()
        db_t = P.LSMStore(cfg(P, telemetry=tel, memtable_bytes=1 << 14))
        db_p = P.LSMStore(cfg(P, memtable_bytes=1 << 14))
        for db in (db_t, db_p):
            apply_ops(db, ops_[:300])
            db.flush()
            apply_ops(db, ops_[300:])
            db.fsync_wal()
            db.crash()
            db.recover()
        assert db_t.memtable._data == db_p.memtable._data
        assert db_view(db_t) == db_view(db_p)
        assert counters(db_t) == counters(db_p)
        kinds = {e.kind for e in tel.trace.dump()}
        assert "wal_replay" in kinds and "scrub" in kinds
        replay = [e for e in tel.trace.dump() if e.kind == "wal_replay"][-1]
        assert replay.fields["records"] >= 0
        assert tel.histogram("scrub").n >= 1
        out.append((db_t, db_p, events(tel), counters(db_t), tel))
    assert_same_tree(out[0][0], out[1][0])
    assert_same_tree(out[0][1], out[1][1])
    assert out[0][2:4] == out[1][2:4]
    # the port's histograms beyond the reference's: the phases it ran
    assert_phase_classes(out[0][4], {op: h.n for op, h in
                                     out[1][4].histograms().items()})


def test_sharded_degradation_is_per_shard():
    """A dead pipeline in one shard rejects that shard's writes only; the
    sibling keeps full service, reads serve everywhere, and crash plus
    recover restores writes, as in the reference's facade."""
    outcomes = []
    for P, m in ((PORT, pc), (REF, ref)):
        f = P.FaultInjector()
        kw = {"device": "cpu"} if P.port else {}
        db = m.make_store(cfg(P, shards=2, async_compaction=True, faults=f,
                              bg_max_retries=0), **kw)
        try:
            # every key flushed before the fault is armed: the puts the
            # crash loses (the live memtable's, a number that depends on
            # when the worker's failure surfaces) rewrite the same values
            for i in range(100):
                db.put(i, b"v" * 50)
            db.flush()
            assert db.wait_for_quiesce(30)
            f.fail("flush_write", times=-1)
            for i in range(4000):            # all keys < 2^63: shard 0
                try:
                    db.put(i % 100, b"v" * 50)
                except P.StoreDegradedError:
                    break
            else:
                db.flush()
                try:
                    db.wait_for_quiesce(30)
                except RuntimeError:
                    pass
            assert db.degraded
            assert db.degraded_shards() == [0]
            f.clear()
            with pytest.raises(P.StoreDegradedError):
                db.put(5, b"rejected")       # shard 0: read-only
            assert db.get(5) == b"v" * 50    # reads still serve
            big = (1 << 63) + 5
            db.put(big, b"sibling ok")       # shard 1: full service
            assert db.get(big) == b"sibling ok"
            db.crash()
            db.recover()
            assert db.degraded_shards() == []
            db.put(5, b"restored")
            assert db.get(5) == b"restored"
            db.flush()
            assert db.wait_for_quiesce(30)
            report = db.scrub()
            assert report and all("shard" in r and not r["bad_blocks"]
                                  for r in report)
            outcomes.append((db.multi_get(list(range(100)) + [big]),
                             sorted({r["shard"] for r in report})))
        finally:
            db.close()
    assert outcomes[0] == outcomes[1]
