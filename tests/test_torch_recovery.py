"""repro_torch's crash and recovery on the CPU vs the reference's.

The crash cases of ``tests/test_engine.py`` and the durability cases of
``tests/test_write_path.py`` run on ``repro.core.LSMStore`` and on
``repro_torch.LSMStore(device="cpu")`` side by side: the same answers after
``crash()``/``recover()`` and every IOStats field equal.  Below them, the
modules recovery stands on, each held against its reference for the same
operations: the WAL's bytes, its ``records()`` after ``crash()`` and after
``repair()`` of a torn or corrupted log, the manifest's
``recover_current`` over a corrupted tail edit, and ``SortedRun.verify`` /
``verify_block`` on a run that the test corrupts the same way on both
sides.  All lanes are integer: tolerance 0.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch as rt
from repro.core.memtable import WriteAheadLog as RefWAL
from repro.core.run import build_run as ref_build_run
from repro_torch.core import CorruptionError, IOStats, build_run
from repro_torch.core import run as port_run
from repro_torch.core.memtable import WriteAheadLog
from repro_torch.kernels import ops
from test_torch_store import assert_same_tree

# Six xdist workers share 8 cores with the reference's timing-bounded
# property tests: one intra-op thread per worker keeps them on time.
torch.set_num_threads(1)


def pair(**kw):
    """(port, reference) stores of tests/test_engine.py's small config."""
    base = dict(policy="garnering", T=2.0, c=0.8, memtable_bytes=1 << 12,
                base_level_bytes=1 << 14, bits_per_key=10,
                bloom_allocation="monkey")
    base.update(kw)
    return (rt.LSMStore(rt.LSMConfig(**base), device="cpu"),
            ref.LSMStore(ref.LSMConfig(**base)))


def both(dbs, name, *args):
    return [getattr(db, name)(*args) for db in dbs]


def assert_same(dbs, keys):
    port, reference = dbs
    assert port.multi_get(keys) == reference.multi_get(keys)
    assert [port.get(k) for k in keys[:40]] == \
        [reference.get(k) for k in keys[:40]]
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(reference.stats)


# ------------------------------------------------ tests/test_engine.py
def test_crash_recovery_wal():
    dbs = pair(wal_fsync_every_write=True)
    for k in range(50):
        both(dbs, "put", k, b"durable")
    both(dbs, "flush")
    both(dbs, "put", 999, b"in-wal-only")
    both(dbs, "crash")
    both(dbs, "recover")
    assert [db.get(999) for db in dbs] == [b"in-wal-only"] * 2
    assert [db.get(10) for db in dbs] == [b"durable"] * 2
    assert_same(dbs, list(range(60)) + [999])
    assert_same_tree(*dbs)


def test_crash_loses_unsynced_tail():
    dbs = pair(wal_fsync_every_write=False)
    for k in range(50):
        both(dbs, "put", k, b"durable")
    both(dbs, "flush")                  # flush fsyncs + truncates WAL
    both(dbs, "put", 999, b"volatile")  # never fsynced
    both(dbs, "crash")
    both(dbs, "recover")
    assert [db.get(999) for db in dbs] == [None, None]
    assert [db.get(10) for db in dbs] == [b"durable"] * 2
    assert_same(dbs, list(range(60)) + [999])


# --------------------------------------------- tests/test_write_path.py
def test_put_batch_fsync_every_write_durability():
    dbs = pair(wal_fsync_every_write=True, memtable_bytes=1 << 20,
               bits_per_key=8)
    both(dbs, "put_batch", list(range(40)), b"durable")
    both(dbs, "crash")
    both(dbs, "recover")
    for db in dbs:
        assert [db.get(k) for k in range(40)] == [b"durable"] * 40
    assert_same(dbs, list(range(45)))


def test_torn_batch_tail_recovery():
    """A partially synced batch recovers exactly the records under the
    fsync watermark; the torn record and everything after are lost."""
    from repro_torch.core.memtable import FRAME_OVERHEAD

    dbs = pair(memtable_bytes=1 << 20, bits_per_key=8)
    both(dbs, "put_batch", list(range(50)), b"v" * 10)
    rec = FRAME_OVERHEAD + 10
    for db in dbs:
        db.wal._synced_upto = 7 * rec + 13   # cut mid-record 7
    both(dbs, "crash")
    both(dbs, "recover")
    for db in dbs:
        assert [db.get(k) for k in range(50)] == \
            [b"v" * 10 if k < 7 else None for k in range(50)]
    dbs2 = pair(memtable_bytes=1 << 20, bits_per_key=8)
    both(dbs2, "write_batch", [(k, None) if k % 3 == 0 else (k, bytes(k))
                               for k in range(30)])
    for db in dbs2:
        db.wal.fsync(db._stats.local())
        db.wal._synced_upto -= 5        # tear the last record
    both(dbs2, "crash")
    both(dbs2, "recover")
    for db in dbs2:
        assert [db.get(k) for k in range(29)] == \
            [None if k % 3 == 0 else bytes(k) for k in range(29)]
        assert db.get(29) is None
    assert_same(dbs2, list(range(31)))


def test_wal_append_batch_bytes_match_scalar_appends():
    """The port's batch append writes the reference's bytes, record for
    record, ragged and uniform."""
    items = [(5, b"abc"), (9, None), (2 ** 63, b""), (7, b"x" * 120),
             (1, None), (3, b"yz")]
    uni = [(k, b"u" * 16) for k in range(40)]
    for batch, first in ((items, 10), (uni, 1)):
        logs = [WriteAheadLog(), WriteAheadLog(), RefWAL()]
        stats = [IOStats(), IOStats(), ref.IOStats()]
        for i, (k, v) in enumerate(batch):
            logs[0].append(1 if v is None else 0, k, first + i, v or b"",
                           stats[0])
        logs[1].append_batch(batch, first, stats[1])
        logs[2].append_batch(batch, first, stats[2])
        assert bytes(logs[0]._buf) == bytes(logs[1]._buf) \
            == bytes(logs[2]._buf)
        assert [s.wal_appends for s in stats] == [len(batch)] * 3
        assert list(logs[0].records()) == list(logs[1].records()) \
            == list(logs[2].records())


def test_wal_outlier_length_batch_spans_stay_bounded_and_bit_exact():
    """Many small records beside a few 4 KB ones: the port's bytes and its
    replay through the spanned verification equal the reference's."""
    rng = np.random.default_rng(11)
    items = []
    for i in range(3000):
        if i % 500 == 250:
            items.append((i, bytes(rng.integers(0, 256, 4096, np.uint8))))
        elif i % 9 == 0:
            items.append((i, None))
        else:
            items.append((i, bytes(rng.integers(
                0, 256, int(rng.integers(0, 32)), np.uint8))))
    port, reference = WriteAheadLog(), RefWAL()
    port.append_batch(items, 7, IOStats())
    reference.append_batch(items, 7, ref.IOStats())
    assert bytes(port._buf) == bytes(reference._buf)
    assert list(port.records()) == list(reference.records())
    assert len(list(port.records())) == len(items)


# ------------------------------------------------- the WAL's replay
def wal_pair(seed: int):
    """Both logs after the same ragged appends, scalar and batched, with
    an fsync partway."""
    rng = np.random.default_rng(seed)
    logs, stats = [WriteAheadLog(), RefWAL()], [IOStats(), ref.IOStats()]
    seq = 1
    for step in range(12):
        items = [(int(rng.integers(0, 2**64 - 1, dtype=np.uint64)),
                  None if rng.random() < 0.2
                  else bytes(rng.integers(0, 256, int(rng.integers(0, 60)),
                                          np.uint8)))
                 for _ in range(int(rng.integers(1, 20)))]
        for log, st in zip(logs, stats):
            if step % 3 == 0:
                for i, (k, v) in enumerate(items):
                    log.append(1 if v is None else 0, k, seq + i, v or b"",
                               st)
            else:
                log.append_batch(items, seq, st)
            if step == 8:
                log.fsync(st)
        seq += len(items)
    return logs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wal_records_after_crash_equal_reference(seed):
    logs = wal_pair(seed)
    assert bytes(logs[0]._buf) == bytes(logs[1]._buf)
    full = list(logs[1].records())
    assert list(logs[0].records()) == full
    for log in logs:
        log.crash()
    assert bytes(logs[0]._buf) == bytes(logs[1]._buf)
    assert logs[0]._synced_upto == logs[1]._synced_upto == len(logs[0])
    kept = list(logs[0].records())
    assert kept == list(logs[1].records())
    assert 0 < len(kept) < len(full) and kept == full[:len(kept)]


@pytest.mark.parametrize("damage", ["torn", "bitflip", "length"])
def test_wal_repair_equals_reference(damage):
    """A torn tail, a flipped payload bit and a corrupt length field: the
    same bytes dropped, the same records replayed afterwards."""
    logs = wal_pair(5)
    for log in logs:
        log.fsync(IOStats())
        n = len(log._buf)
        if damage == "torn":
            log._buf = log._buf[:n - 7]
        elif damage == "bitflip":
            log._buf[n // 2] ^= 0x10
        else:   # the vlen field of the third frame
            log._buf[4 + 17 + 2 * 0] ^= 0xFF
    dropped = [log.repair() for log in logs]
    assert dropped[0] == dropped[1] > 0
    assert bytes(logs[0]._buf) == bytes(logs[1]._buf)
    assert logs[0]._synced_upto == logs[1]._synced_upto
    assert list(logs[0].records()) == list(logs[1].records())
    assert [log.repair() for log in logs] == [0, 0]


# ---------------------------------------------------- the manifest
@pytest.mark.parametrize("corrupt", [0, 1, 3])
def test_manifest_recover_current_equals_reference(corrupt):
    """Both stores after the same flushes; the last ``corrupt`` edits'
    ``last_seq`` garbled without updating their checksums: the same
    versions popped, the same version restored."""
    dbs = pair(bits_per_key=8)
    rng = np.random.default_rng(corrupt)
    for wave in range(6):
        keys = rng.integers(0, 300, 120).tolist()
        both(dbs, "put_batch", keys, [b"w%d" % wave] * len(keys))
        both(dbs, "flush")
    for db in dbs:
        log = db.manifest._log
        for i in range(1, corrupt + 1):
            log[-i] = dataclasses.replace(
                log[-i], last_seq=log[-i].last_seq ^ (1 << 17))
    both(dbs, "crash")
    (vp, popped_p), (vr, popped_r) = [db.manifest.recover_current()
                                      for db in dbs]
    assert popped_p == popped_r == corrupt
    assert (vp.version_id, vp.max_level, vp.last_seq) == \
        (vr.version_id, vr.max_level, vr.last_seq)
    assert [len(lvl) for lvl in vp.levels] == [len(lvl) for lvl in vr.levels]
    assert vp.verify() and vr.verify()
    assert len(dbs[0].manifest._log) == len(dbs[1].manifest._log)


# --------------------------------------------------- run integrity
def run_pair(seed: int, n: int = 400, vmax: int = 90):
    """The same run built by both packages (with tombstones and values
    long enough that entries straddle blocks)."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(2**62, n, replace=False).astype(np.uint64))
    keys[-1] = 2**64 - 1
    seqs = rng.integers(1, 10**6, n).astype(np.uint64)
    vlens = rng.integers(0, vmax + 1, n).astype(np.int32)
    vlens[rng.random(n) < 0.1] = -1
    vals = rng.integers(0, 256, (n, vmax), dtype=np.uint8)
    vals[np.arange(vmax)[None] >= np.maximum(vlens, 0)[:, None]] = 0
    reference = ref_build_run(keys, seqs, vlens, vals, block_size=512,
                              assume_unique_sorted=True)
    port = build_run(ops.keys_to_device(keys, "cpu"),     # own copies
                     torch.from_numpy(seqs.view(np.int64).copy()),
                     torch.from_numpy(vlens.copy()),
                     torch.from_numpy(vals.copy()),
                     block_size=512, assume_unique_sorted=True)
    return port, reference


@pytest.mark.parametrize("column", ["vals", "keys", "seqs", "vlens", "none"])
def test_verify_finds_the_reference_bad_blocks(column):
    port, reference = run_pair(4)
    assert port.n_blocks == reference.n_blocks > 20
    # rows with a value byte to flip: two neighbours, one mid-run, the last
    full = np.nonzero(reference.vlens > 0)[0]
    rows = [int(full[3]), int(full[3]) + 1, int(full[150]), int(full[-1])]
    for r in rows:
        if column == "vals":
            port.vals[r, 0] ^= 1
            reference.vals[r, 0] ^= 1
        elif column == "keys":     # the u64 key's low bit, on both sides
            port.keys[r] ^= 1
            reference.keys[r] ^= np.uint64(1)
        elif column == "seqs":
            port.seqs[r] += 1
            reference.seqs[r] += np.uint64(1)
        elif column == "vlens":
            port.vlens[r] = -1 if port.vlens[r] != -1 else 0
            reference.vlens[r] = port.vlens[r].item()
    bad = reference.verify()
    assert port.verify() == bad
    assert bool(bad) == (column != "none")
    assert [port.verify_block(b) for b in range(port.n_blocks)] == \
        [reference.verify_block(b) for b in range(reference.n_blocks)]
    assert [port.block_bytes(b) for b in range(-1, port.n_blocks + 1)] == \
        [reference.block_bytes(b) for b in range(-1, reference.n_blocks + 1)]


def test_entry_checksums_in_row_chunks_equal_one_pass(monkeypatch):
    port, reference = run_pair(6, n=700)
    monkeypatch.setattr(port_run, "_CRC_SCRATCH", 3 * 110 + 5)
    again = build_run(port.keys, port.seqs, port.vlens, port.vals,
                         block_size=512, assume_unique_sorted=True)
    assert torch.equal(again.block_crcs, port.block_crcs)
    np.testing.assert_array_equal(again.block_crcs.numpy().astype(np.uint32),
                                  reference.block_crcs)
    assert again.verify() == []


def test_scrub_reports_and_recovery_raises_on_a_bad_block():
    dbs = pair(bits_per_key=8, memtable_bytes=1 << 11)
    rng = np.random.default_rng(9)
    keys = rng.integers(0, 500, 900).tolist()
    both(dbs, "put_batch", keys, [bytes([k % 256]) * (k % 70) for k in keys])
    both(dbs, "flush")
    reports = both(dbs, "scrub")
    strip = [[{k: v for k, v in r.items() if k != "run_id"} for r in rep]
             for rep in reports]
    assert strip[0] == strip[1] and len(strip[0]) >= 2
    assert all(not r["bad_blocks"] for r in strip[0])
    lvl = max(i for i, l in enumerate(dbs[1]._levels) if l)
    dbs[0]._levels[lvl][0].vals[5, 0] ^= 1
    dbs[1]._levels[lvl][0].vals[5, 0] ^= 1
    bad = [[r["bad_blocks"] for r in rep] for rep in both(dbs, "scrub")]
    assert bad[0] == bad[1] and any(bad[0])
    both(dbs, "crash")
    for db in dbs:
        with pytest.raises((CorruptionError, ref.CorruptionError),
                           match="recovery scrub"):
            db.recover()


def test_recover_twice_and_keep_writing():
    """Two crashes back to back lose nothing fsynced; writes resume and
    flush into the same tree as the reference's."""
    dbs = pair(wal_fsync_every_write=True, bits_per_key=8)
    rng = np.random.default_rng(2)
    for i in range(700):
        k = int(rng.integers(0, 250))
        if rng.random() < 0.2:
            both(dbs, "delete", k)
        else:
            both(dbs, "put", k, b"r%d" % i)
    for _ in range(2):
        both(dbs, "crash")
        both(dbs, "recover")
    both(dbs, "put_batch", list(range(300, 340)), b"after")
    both(dbs, "flush")
    assert_same(dbs, list(range(350)))
    assert_same_tree(*dbs)
    assert [db.manifest.total_pin_refs() for db in dbs] == [0, 0]
