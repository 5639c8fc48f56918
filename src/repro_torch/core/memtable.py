"""Memtable + write-ahead log (host), and the flush that uploads a run.

Counterpart of ``repro.core.memtable``.  The memtable buffers updates in
insertion order keyed by uint64 user key (newest write to a key wins, as in
a skiplist memtable).  The WAL is an append-only in-memory byte log with an
explicit fsync barrier counter, with the reference's frames byte for byte.
Both stay on the host; :meth:`Memtable.to_run` packs the columns in numpy
and uploads them to the device once; :meth:`Memtable.scan` serves range
reads from a key-ordered copy built once after the last write.  Recovery
replays the log's checksum-valid frames (:meth:`WriteAheadLog.records`),
and async rotation freezes a memtable with its log into an
:class:`ImmutableMemtable`, as the reference does.
"""
from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from .faults import CHUNK, crc32c, crc32c_rows
from .run import SortedRun, build_run
from .types import (BLOCK_SIZE, KEY_BYTES, KEY_DTYPE, SEQ_DTYPE,
                    TOMBSTONE_LEN, IOStats)

_PUT, _DEL = 0, 1
Entry = Tuple[int, int, Optional[bytes]]    # (key, seq, value|None)
# WAL record frame (DESIGN.md §16.2): crc32c(4) | body(21) | payload(vlen)
# where the checksum covers body+payload.  Recovery verifies every frame and
# replays up to the first bad one — length fields are never trusted alone.
_CRC = struct.Struct("<I")
_HDR = struct.Struct("<BQQI")  # frame body: op, key, seq, vlen
FRAME_OVERHEAD = _CRC.size + _HDR.size  # 25 bytes per record before payload
# numpy twin of _HDR for vectorized batch appends (packed little-endian)
_HDR_DTYPE = np.dtype([("op", "u1"), ("key", "<u8"),
                       ("seq", "<u8"), ("vlen", "<u4")])
assert _HDR_DTYPE.itemsize == _HDR.size

# Cap on the transient padded scratch matrix the vectorized CRC passes
# allocate: a batch (or WAL replay) mixing many small records with one
# outlier-length value must not allocate n*max bytes at once (100k records
# next to a single 4KB value would be ~400MB of padding — and the replay
# gather's int64 index intermediate is 8x that again).  Per-span scratch is
# ~10x this cap; spans stay large enough that the vectorized pass keeps its
# throughput.
_CRC_PAD_BUDGET = 1 << 20


def _pad_spans(vlens: np.ndarray, hsz: int):
    """Row spans ``(i, j)`` for a bounded-memory padded CRC pass.

    Each span keeps ``(j-i) * (hsz + vlens[i:j].max())`` under
    :data:`_CRC_PAD_BUDGET` (a record wider than the whole budget gets a
    span of its own — that width is the record itself, not padding).  The
    width is taken over a bounded lookahead window, so uniform stretches
    keep large vectorized spans and an outlier only shrinks the spans that
    actually contain it.
    """
    n = len(vlens)
    i = 0
    while i < n:
        look = min(n, i + 65536)
        width = hsz + int(vlens[i:look].max())
        j = min(look, i + max(1, _CRC_PAD_BUDGET // width))
        yield i, j
        i = j


class WriteAheadLog:
    """Append-only log; ``records()`` replays committed entries on recovery."""

    def __init__(self):
        self._buf = bytearray()
        self._synced_upto = 0

    def append(self, op: int, key: int, seq: int, value: bytes, stats: IOStats):
        body = _HDR.pack(op, key, seq, len(value))
        msg = body + value
        if len(msg) <= CHUNK:
            crc = crc32c(msg)
        else:   # chunk-and-combine: a 9.44 MB page is not a byte loop
            crc = int(crc32c_rows(np.frombuffer(msg, np.uint8)[None],
                                  [len(msg)])[0])
        self._buf += _CRC.pack(crc)
        self._buf += body
        self._buf += value
        stats.wal_appends += 1

    def append_batch(self, items: Sequence[Tuple[int, Optional[bytes]]],
                     first_seq: int, stats: IOStats) -> None:
        """Append one batch of ``(key, value-or-None)`` records in a single
        vectorized pass; record ``i`` gets sequence ``first_seq + i``, with
        the byte layout of ``len(items)`` scalar :meth:`append` calls."""
        n = len(items)
        if n == 0:
            return
        values = [v for _, v in items]
        self.append_batch_cols(
            values,
            np.fromiter((k for k, _ in items), np.uint64, n),
            np.fromiter((_DEL if v is None else _PUT for v in values),
                        np.uint8, n),
            np.fromiter((len(v) if v is not None else 0 for v in values),
                        np.int64, n),
            first_seq, stats)

    def append_batch_cols(self, values: Sequence[Optional[bytes]],
                          keys_arr: np.ndarray, ops_arr: np.ndarray,
                          vlens_arr: np.ndarray, first_seq: int,
                          stats: IOStats) -> None:
        """Append one batch of records in a single vectorized pass: record
        ``i`` gets sequence ``first_seq + i``, with the byte layout of
        ``len(values)`` scalar :meth:`append` calls.  The engine precomputes
        the header columns once per batch and passes per-chunk views.  Headers are packed with one structured-dtype write;
        uniform-length batches interleave header and payload with a single
        2-D column copy, ragged ones with two index scatters — never a
        per-record ``struct.pack``.
        """
        n = len(values)
        if n == 0:
            return
        hdr = np.empty(n, dtype=_HDR_DTYPE)
        hdr["op"] = ops_arr
        hdr["key"] = keys_arr
        hdr["seq"] = np.arange(first_seq, first_seq + n, dtype=np.uint64)
        hdr["vlen"] = vlens_arr
        fo, hsz = _CRC.size, _HDR.size
        fsz = fo + hsz
        hview = hdr.view(np.uint8).reshape(n, hsz)
        payload = b"".join(v for v in values if v is not None)
        v0 = int(vlens_arr[0])
        if int(vlens_arr.min()) == v0 == int(vlens_arr.max()):
            # uniform record size: interleave with one 2-D column copy, then
            # checksum every frame body in one vectorized pass
            out = np.empty((n, fsz + v0), dtype=np.uint8)
            out[:, fo:fsz] = hview
            if v0:
                out[:, fsz:] = np.frombuffer(payload, np.uint8).reshape(n, v0)
            crcs = crc32c_rows(out[:, fo:], np.full(n, hsz + v0, np.int64))
            out[:, :fo] = crcs.astype("<u4").view(np.uint8).reshape(n, fo)
        else:
            vl = np.asarray(vlens_arr, np.int64)
            cum = np.cumsum(vl, dtype=np.int64)
            pstarts = cum - vl
            flat = np.frombuffer(payload, dtype=np.uint8)
            # checksum pass over padded (body | payload) matrices, masked to
            # each record's true frame-body length; _pad_spans bounds the
            # padded scratch so one outlier-length record never inflates
            # the transient allocation to n*max bytes
            crcs = np.empty(n, np.uint32)
            for i, j in _pad_spans(vl, hsz):
                w = int(vl[i:j].max())
                body = np.zeros((j - i, hsz + w), dtype=np.uint8)
                body[:, :hsz] = hview[i:j]
                if w:
                    mask = np.arange(w)[None, :] < vl[i:j, None]
                    body[:, hsz:][mask] = flat[pstarts[i]:cum[j - 1]]
                crcs[i:j] = crc32c_rows(body, hsz + vl[i:j])
            crcb = crcs.astype("<u4").view(np.uint8).reshape(n, fo)
            starts = np.arange(n, dtype=np.int64) * fsz + pstarts
            out = np.empty(n * fsz + int(cum[-1]), dtype=np.uint8)
            out[(starts[:, None] + np.arange(fo)).ravel()] = crcb.ravel()
            out[(starts[:, None] + fo + np.arange(hsz)).ravel()] = hview.ravel()
            if payload:
                intra = np.arange(flat.size, dtype=np.int64) \
                    - np.repeat(pstarts, vl)
                out[np.repeat(starts + fsz, vl) + intra] = flat
        self._buf += out.tobytes()
        stats.wal_appends += n

    def fsync(self, stats: IOStats):
        self._synced_upto = len(self._buf)
        stats.wal_fsyncs += 1

    def truncate(self):
        """Called after a successful flush: the flushed prefix is durable."""
        self._buf = bytearray()
        self._synced_upto = 0

    def crash(self, faults=None):
        """Simulate a crash: the unsynced suffix is lost.  An armed
        ``FaultInjector`` makes the loss dirtier (``mangle_wal_tail``): a
        torn write keeps a random prefix of the unsynced tail, a bit flip
        or garbage damages the synced region's last bytes, which recovery
        must then find by checksum."""
        keep = (self._synced_upto if faults is None
                else faults.mangle_wal_tail(self._buf, self._synced_upto))
        self._buf = self._buf[:keep]
        self._synced_upto = min(self._synced_upto, len(self._buf))

    def _scan_frames(self):
        """Parse and verify frames: ``(metas, frame_offsets, good_end)``.

        ``metas[i]`` is (op, key, seq, vlen) of the i-th *checksum-valid*
        frame; ``good_end`` is the byte offset just past the last valid
        frame (everything beyond is a torn tail or corruption).  The
        checksums are one vectorized :func:`crc32c_rows` pass over padded
        frame bodies in bounded spans, as the reference's.
        """
        buf = bytes(self._buf)
        fo, hsz = _CRC.size, _HDR.size
        fsz = fo + hsz
        n = len(buf)
        metas, offs, stored = [], [], []
        off = 0
        while off + fsz <= n:
            (crc,) = _CRC.unpack_from(buf, off)
            op, key, seq, vlen = _HDR.unpack_from(buf, off + fo)
            end = off + fsz + vlen
            if end > n:
                break  # torn tail (or a corrupt length running past the end)
            metas.append((op, key, seq, vlen))
            offs.append(off)
            stored.append(crc)
            off = end
        if not metas:
            return [], [], 0
        vlens = np.fromiter((m[3] for m in metas), np.int64, len(metas))
        arr = np.frombuffer(buf, np.uint8)
        starts = np.fromiter(offs, np.int64, len(offs)) + fo
        lens = hsz + vlens
        stored_a = np.fromiter(stored, np.uint32, len(stored))
        ok = np.empty(len(metas), bool)
        for i, j in _pad_spans(vlens, hsz):
            cols = np.arange(int(lens[i:j].max()), dtype=np.int64)
            mask = cols[None, :] < lens[i:j, None]
            mat = np.zeros((j - i, cols.size), np.uint8)
            mat[mask] = arr[(starts[i:j, None] + cols)[mask]]
            ok[i:j] = crc32c_rows(mat, lens[i:j]) == stored_a[i:j]
        good = len(metas) if bool(ok.all()) else int(np.argmin(ok))
        end = (offs[good - 1] + fsz + metas[good - 1][3]) if good else 0
        return metas[:good], offs[:good], end

    def repair(self) -> int:
        """Drop everything past the last checksum-valid frame (recovery
        path); returns the number of bytes discarded."""
        _, _, good_end = self._scan_frames()
        dropped = len(self._buf) - good_end
        if dropped:
            self._buf = self._buf[:good_end]
            self._synced_upto = min(self._synced_upto, good_end)
        return dropped

    def records(self) -> Iterator[Tuple[int, int, int, bytes]]:
        """Replay checksum-valid ``(op, key, seq, value)`` records; stops at
        the first bad frame."""
        metas, offs, _ = self._scan_frames()
        buf, fsz = bytes(self._buf), _CRC.size + _HDR.size
        for (op, key, seq, vlen), off in zip(metas, offs):
            p = off + fsz
            yield op, key, seq, buf[p:p + vlen]

    def __len__(self):
        return len(self._buf)


class Memtable:
    """Insertion buffer. Size accounting matches the run entry-size model.

    One thread writes; readers on other threads take point-in-time copies
    (:meth:`snapshot_items`, :meth:`sorted_entries`), never a lock.
    """

    def __init__(self, capacity_bytes: int, key_bytes: int = KEY_BYTES,
                 block_size: int = BLOCK_SIZE):
        self.capacity_bytes = capacity_bytes
        self.key_bytes = key_bytes
        self.block_size = block_size
        self.frozen = False
        self._data: Dict[int, Tuple[int, Optional[bytes]]] = {}
        self._bytes = 0
        # bumped after every write; the key-ordered copy is valid only for
        # the generation it was built at
        self._gen = 0
        self._sorted: Optional[Tuple[int, np.ndarray, List[Entry]]] = None

    def freeze(self) -> "Memtable":
        """Mark immutable (async rotation): reads stay valid from any thread
        because the dict is never touched again; writes become errors."""
        self.frozen = True
        return self

    def put(self, key: int, seq: int, value: Optional[bytes]):
        """value=None is a tombstone."""
        if self.frozen:
            raise RuntimeError("write to a frozen (rotated) memtable")
        prev = self._data.get(key)
        if prev is not None:
            self._bytes -= self.key_bytes + (len(prev[1]) if prev[1] is not None else 0)
        self._data[key] = (seq, value)
        self._bytes += self.key_bytes + (len(value) if value is not None else 0)
        self._gen += 1

    def put_batch(self, keys: Sequence[int],
                  values: Sequence[Optional[bytes]], first_seq: int,
                  added: Optional[int] = None) -> None:
        """Bulk insert: ``keys[i]`` gets sequence ``first_seq + i``.

        The last occurrence of a duplicate key wins with its own sequence
        number, exactly as a scalar put loop would leave it.  The dict is
        built and merged with C-level ``zip``/``update``; byte accounting
        refunds overwritten entries from one ``map(get)`` pass instead of a
        per-entry probe.  ``added`` optionally supplies the precomputed byte
        total of the batch (valid only without in-batch duplicates — the
        engine passes its chunk-sizing cumsum; ignored when duplicates
        collapse entries).
        """
        if self.frozen:
            raise RuntimeError("write to a frozen (rotated) memtable")
        data = self._data
        kb = self.key_bytes
        n = len(keys)
        incoming = dict(zip(keys, zip(range(first_seq, first_seq + n),
                                      values)))
        if added is None or len(incoming) != n:
            added = sum(kb + len(v) if v is not None else kb
                        for _, v in incoming.values())
        if data:
            removed = sum(
                kb + len(pv[1]) if pv[1] is not None else kb
                for pv in map(data.get, incoming) if pv is not None)
        else:
            removed = 0
        data.update(incoming)
        self._bytes += added - removed
        self._gen += 1

    def get(self, key: int) -> Optional[Tuple[int, Optional[bytes]]]:
        return self._data.get(key)

    def snapshot_items(self) -> List[Entry]:
        """Point-in-time copy of the ``(key, seq, value)`` triples, in
        insertion order.  ``dict.copy`` is one C-level call under the GIL,
        so a reader racing the writer gets a consistent copy without a
        lock."""
        return [(k, s, v) for k, (s, v) in self._data.copy().items()]

    def sorted_entries(self) -> Tuple[np.ndarray, List[Entry]]:
        """Every ``(key, seq, value|None)`` in key order, and the keys as a
        uint64 array.  Built once after the last write and shared by every
        reader until the next one; a write replaces the lists, never
        mutates them, so a reader keeps the view it took.  The generation
        is read before the copy: a copy that races a write is labelled
        with the older generation and so is never reused after it."""
        gen = self._gen
        cached = self._sorted
        if cached is None or cached[0] != gen:
            items = sorted(self.snapshot_items())
            keys = np.fromiter((e[0] for e in items), KEY_DTYPE, len(items))
            cached = (gen, keys, items)
            self._sorted = cached
        return cached[1], cached[2]

    def scan(self, start_key: int,
             limit: Optional[int] = None) -> List[Entry]:
        """``(key, seq, value|None)`` from ``start_key`` on, in key order
        (the first ``limit`` of them if given)."""
        keys, items = self.sorted_entries()
        i = int(np.searchsorted(keys, np.uint64(start_key)))
        return items[i:] if limit is None else items[i:i + limit]

    @property
    def size_bytes(self) -> int:
        return self._bytes

    def __len__(self):
        return len(self._data)

    def is_full(self) -> bool:
        return self._bytes >= self.capacity_bytes

    def to_run(self, bits_per_key: float, stats: IOStats,
               device: torch.device) -> SortedRun:
        """Freeze into a sorted run on ``device`` (one python pass +
        vectorized packing + one upload per column).

        Values are joined into one flat byte buffer and scattered into the
        padded value matrix with a single fancy-index write; the run
        inherits this memtable's ``block_size``/``key_bytes``.  Sorting,
        block layout, checksums and the bloom filter are built on the
        device.
        """
        n = len(self._data)
        keys = np.fromiter(self._data.keys(), dtype=KEY_DTYPE, count=n)
        if n:
            seq_t, val_t = zip(*self._data.values())   # two C-level passes
            seqs = np.fromiter(seq_t, dtype=SEQ_DTYPE, count=n)
            vlens = np.fromiter(
                (TOMBSTONE_LEN if v is None else len(v) for v in val_t),
                dtype=np.int32, count=n)
        else:
            val_t = ()
            seqs = np.empty(0, dtype=SEQ_DTYPE)
            vlens = np.empty(0, dtype=np.int32)
        lens = np.maximum(vlens, 0).astype(np.int64)
        vmax = int(lens.max()) if n else 0
        if vmax and int(vlens.min()) == vmax:
            # uniform value size, no tombstones: the joined payload IS the
            # row-major matrix
            flat = np.frombuffer(b"".join(val_t), dtype=np.uint8)
            vals = flat.reshape(n, vmax).copy()
        elif vmax:
            vals = np.zeros((n, vmax), dtype=np.uint8)
            flat = np.frombuffer(
                b"".join(v for v in val_t if v is not None), dtype=np.uint8)
            if flat.size:
                # row-major boolean scatter: C-order assignment walks rows
                # left-to-right, exactly the joined payload's layout
                mask = np.arange(vmax)[None, :] < lens[:, None]
                vals[mask] = flat
        else:
            vals = np.zeros((n, 0), dtype=np.uint8)
        run = build_run(ops.keys_to_device(keys, device),
                        torch.from_numpy(seqs.view(np.int64)).to(device),
                        torch.from_numpy(vlens).to(device),
                        torch.from_numpy(vals).to(device),
                        bits_per_key=bits_per_key,
                        block_size=self.block_size, key_bytes=self.key_bytes)
        stats.entries_flushed += len(run)
        stats.bytes_flushed += run.data_bytes
        stats.blocks_written += run.n_blocks
        return run

    def clear(self):
        if self.frozen:
            raise RuntimeError("clear of a frozen (rotated) memtable")
        self._data.clear()
        self._bytes = 0
        self._gen += 1


class ImmutableMemtable:
    """A frozen memtable queued for background flush, plus its WAL segment.

    Rotation (async mode) freezes the active memtable and hands it here
    with the WAL that logged exactly its records; the pair stays readable
    on every read path (between the active memtable and L0, newest first)
    until the background flush installs the run, and the WAL segment,
    fully fsynced at rotation, is replayed by recovery if a crash beats
    the flush.
    """

    __slots__ = ("memtable", "wal")

    def __init__(self, memtable: Memtable, wal: WriteAheadLog):
        self.memtable = memtable.freeze()
        self.wal = wal
