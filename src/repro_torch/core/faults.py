"""Integrity primitives and fault injection, on the host and on the device.

A copy of ``repro.core.faults``:

* ``crc32c`` — the scalar byte-loop oracle;
* ``crc32c_rows`` — its vectorized numpy twin over the rows of a padded
  byte matrix, used by the write-ahead log (host bytes);
* ``crc32c_rows_torch`` — the same function over a uint8 tensor on any
  device, bit for bit, used for the per-block checksums of runs whose
  columns live on the card.

CRC-32C is the Castagnoli polynomial (reflected 0x82F63B78); ``zlib.crc32``
is a different polynomial.  The typed failures ``InjectedFault`` (a
deliberately injected I/O error), ``CorruptionError`` (a checksum
mismatch) and ``StoreDegradedError`` (writes refused after the background
pipeline gave up) are the reference's.

:class:`FaultInjector` is the reference's, draw for draw: one seeded
``random.Random`` decides every probabilistic trigger and every corrupted
byte, so one seed fires the same sites in the same order in both packages.
Its ``corrupt_run_block`` flips a value byte or a sequence-number bit of a
run whose columns live on the device, in place on the device.

Long rows.  Both row functions step one byte column per pass, so their cost
grows with the row length: a 9.44 MB AutumnKV page would take 9.44M passes.
A matrix wider than :data:`CHUNK` bytes is instead cut into CHUNK-byte
chunks that are checksummed all at once (CHUNK passes over every chunk of
every row), and each row's chunk registers are then combined with the
zero-shift operator of zlib's ``crc32_combine`` (multiplication by
x^(8z) mod P over GF(2), here as four 256-entry tables per power of two):
a log-depth tree over the full chunks, then one shift by the length of the
row's last chunk.  A matrix no wider than one chunk keeps the byte loop.
"""
from __future__ import annotations

import random
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["CHUNK", "FAULT_SITES", "CorruptionError", "FaultInjector",
           "InjectedFault", "StoreDegradedError", "crc32c", "crc32c_rows",
           "crc32c_rows_torch"]

# Chunk length of the long-row path.  The device pass costs about seven
# launches per chunk byte, so 1 KiB keeps one long-row checksum near 7k
# launches while a 9.44 MB row still gives ~9.2k chunks of parallel work.
CHUNK = 1024
_CHUNK_BITS = CHUNK.bit_length() - 1


def _build_table() -> np.ndarray:
    poly = 0x82F63B78
    table = np.empty(256, dtype=np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table[i] = crc
    return table


_TABLE = _build_table()
_TABLE_LIST = [int(x) for x in _TABLE]  # plain ints: no numpy boxing in the scalar loop


# ------------------------------------------------------ zero-shift operator
def _shift_one_byte(x: int) -> int:
    """The raw register after one zero byte: linear over GF(2)."""
    return (x >> 8) ^ _TABLE_LIST[x & 0xFF]


def _apply_cols(cols, x: int) -> int:
    """Apply the operator given by its 32 column images to register x."""
    out = 0
    for i in range(32):
        if x >> i & 1:
            out ^= cols[i]
    return out


def _build_shift_tables() -> np.ndarray:
    """(K, 4, 256) uint32: table k shifts a register by 2^k zero bytes,
    for 2^k up to 2^31 bytes.  ``t[b, v]`` is the image of ``v << 8b``."""
    cols = [_shift_one_byte(1 << i) for i in range(32)]
    tables = []
    for _ in range(32):
        tab = np.zeros((4, 256), dtype=np.uint32)
        for b in range(4):
            for v in range(1, 256):
                low = v & -v
                tab[b, v] = tab[b, v ^ low] ^ cols[8 * b + low.bit_length() - 1]
        tables.append(tab)
        cols = [_apply_cols(cols, c) for c in cols]     # square: 2^(k+1)
    return np.stack(tables)


_SHIFT = _build_shift_tables()
# device -> (byte table, shift tables), stored as one entry so that a
# thread never finds one table of a device without the other
_TABLES_BY_DEVICE: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _device_tables(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The byte table and the shift tables as int64 tensors on ``device``."""
    tables = _TABLES_BY_DEVICE.get(device)
    if tables is None:
        tables = (torch.from_numpy(_TABLE.astype(np.int64)).to(device),
                  torch.from_numpy(_SHIFT.astype(np.int64)).to(device))
        _TABLES_BY_DEVICE[device] = tables
    return tables


def _shift(tab, x):
    """Registers ``x`` (numpy uint32 or torch int64) through one (4, 256)
    shift table."""
    return (tab[0][x & 0xFF] ^ tab[1][(x >> 8) & 0xFF]
            ^ tab[2][(x >> 16) & 0xFF] ^ tab[3][(x >> 24) & 0xFF])


def _chunk_geometry(lens):
    """Per row: index of its last chunk, and the bytes in it (0..CHUNK)."""
    last = ((lens + CHUNK - 1) // CHUNK).clip(min=1) - 1
    return last, lens - last * CHUNK


def crc32c(data: bytes) -> int:
    """Scalar CRC-32C over ``data`` — the oracle for :func:`crc32c_rows`."""
    crc = 0xFFFFFFFF
    tab = _TABLE_LIST
    for b in data:
        crc = (crc >> 8) ^ tab[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def crc32c_rows(mat: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Vectorized CRC-32C over the rows of a padded byte matrix.

    ``mat`` is ``(n, L) uint8``; row ``i``'s message is ``mat[i, :lens[i]]``
    (padding bytes beyond ``lens[i]`` never touch the checksum).  All rows
    advance one byte position per pass, masked by their remaining length —
    bit-for-bit equal to calling :func:`crc32c` per row.
    """
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    n = mat.shape[0]
    lens = np.asarray(lens, dtype=np.int64)
    if mat.shape[1] > CHUNK and n:
        return _crc32c_rows_chunked(mat, lens)
    crc = np.full(n, 0xFFFFFFFF, dtype=np.uint32)
    if n:
        for j in range(mat.shape[1]):
            active = lens > j
            if not active.any():
                break
            step = (crc >> np.uint32(8)) ^ _TABLE[(crc ^ mat[:, j]) & np.uint32(0xFF)]
            crc = np.where(active, step, crc)
    return crc ^ np.uint32(0xFFFFFFFF)


def _crc32c_rows_chunked(mat: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """:func:`crc32c_rows` of a matrix wider than one chunk (numpy)."""
    n, width = mat.shape
    nc = -(-width // CHUNK)
    chunks = np.zeros((n, nc * CHUNK), dtype=np.uint8)
    chunks[:, :width] = mat
    chunks = chunks.reshape(n, nc, CHUNK)
    clen = np.clip(lens[:, None] - np.arange(nc) * CHUNK, 0, CHUNK)
    # chunk 0 starts from the CRC's initial register, the others from 0
    reg = np.zeros((n, nc), dtype=np.uint32)
    reg[:, 0] = 0xFFFFFFFF
    for t in range(CHUNK):
        active = clen > t
        if not active.any():
            break
        step = (reg >> np.uint32(8)) ^ _TABLE[(reg ^ chunks[:, :, t]) & 0xFF]
        reg = np.where(active, step, reg)
    last, rem = _chunk_geometry(lens)
    # the full chunks (j < last), right-aligned so that every tree level
    # shifts its left half by the same 2^k chunks
    width2 = 1 << max(nc - 1, 1).bit_length()
    j = np.arange(width2)[None, :] - (width2 - last)[:, None]
    acc = np.where(j >= 0, np.take_along_axis(reg, np.maximum(j, 0), 1), 0
                   ).astype(np.uint32)
    k = _CHUNK_BITS
    while acc.shape[1] > 1:
        acc = _shift(_SHIFT[k], acc[:, 0::2]) ^ acc[:, 1::2]
        k += 1
    acc = acc[:, 0]
    for b in range(_CHUNK_BITS + 1):          # shift by the last chunk's bytes
        acc = np.where(rem >> b & 1, _shift(_SHIFT[b], acc), acc)
    acc ^= reg[np.arange(n), last]
    return acc ^ np.uint32(0xFFFFFFFF)


def crc32c_rows_torch(mat: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """:func:`crc32c_rows` over a ``(n, L)`` uint8 tensor and ``(n,)`` int64
    lengths on any device.  Returns ``(n,)`` int64 CRCs in ``[0, 2^32)``.

    One pass per byte column, every row at once, masked by length; never
    reads a result back to the host.  The matrix is transposed once so that
    each pass reads one contiguous column.  A matrix wider than
    :data:`CHUNK` takes the chunked path (see the module docstring).
    """
    table, _ = _device_tables(mat.device)
    if mat.shape[1] > CHUNK and mat.shape[0]:
        return _crc32c_rows_chunked_torch(mat, lens)
    crc = torch.full((mat.shape[0],), 0xFFFFFFFF, dtype=torch.int64,
                     device=mat.device)
    cols = mat.t().contiguous()
    for j in range(cols.shape[0]):
        step = (crc >> 8) ^ table[(crc ^ cols[j].to(torch.int64)) & 0xFF]
        crc = torch.where(lens > j, step, crc)
    return crc ^ 0xFFFFFFFF


def _crc32c_rows_chunked_torch(mat: torch.Tensor,
                               lens: torch.Tensor) -> torch.Tensor:
    """:func:`crc32c_rows_torch` of a matrix wider than one chunk: the
    twin of :func:`_crc32c_rows_chunked`, without a read-back."""
    table, shift = _device_tables(mat.device)
    n, width = mat.shape
    nc = -(-width // CHUNK)
    dev = mat.device
    # (CHUNK, n, nc): pass t reads byte t of every chunk contiguously
    cols = torch.nn.functional.pad(mat, (0, nc * CHUNK - width)).view(
        n, nc, CHUNK).permute(2, 0, 1).contiguous()
    lens = lens.to(torch.int64)
    clen = (lens[:, None] - torch.arange(nc, device=dev) * CHUNK).clamp(
        0, CHUNK)
    reg = torch.zeros((n, nc), dtype=torch.int64, device=dev)
    reg[:, 0] = 0xFFFFFFFF
    for t in range(CHUNK):
        step = (reg >> 8) ^ table[(reg ^ cols[t].to(torch.int64)) & 0xFF]
        reg = torch.where(clen > t, step, reg)
    last, rem = _chunk_geometry(lens)
    width2 = 1 << max(nc - 1, 1).bit_length()
    j = torch.arange(width2, device=dev)[None, :] - (width2 - last)[:, None]
    acc = torch.where(j >= 0, reg.gather(1, j.clamp(min=0)), 0)
    k = _CHUNK_BITS
    while acc.shape[1] > 1:
        acc = _shift(shift[k], acc[:, 0::2]) ^ acc[:, 1::2]
        k += 1
    acc = acc[:, 0]
    for b in range(_CHUNK_BITS + 1):
        acc = torch.where((rem >> b) & 1 == 1, _shift(shift[b], acc), acc)
    acc = acc ^ reg.gather(1, last[:, None])[:, 0]
    return acc ^ 0xFFFFFFFF


class InjectedFault(IOError):
    """A deliberately injected fault at a named durability/IO site."""

    def __init__(self, site: str):
        super().__init__(f"injected fault at {site!r}")
        self.site = site


class CorruptionError(RuntimeError):
    """A checksum mismatch detected on read, scrub, or recovery.

    ``run_id``/``block_id`` locate a bad sorted-run block; WAL/manifest
    corruption uses ``run_id=-1`` with a descriptive ``where``.
    """

    def __init__(self, run_id: int, block_id: int, where: str = "block"):
        super().__init__(
            f"corruption detected in {where} (run_id={run_id}, block_id={block_id})"
        )
        self.run_id = run_id
        self.block_id = block_id
        self.where = where


class StoreDegradedError(RuntimeError):
    """Writes rejected: the store is read-only after persistent background
    failure.  Reads keep serving the committed tree; ``crash()`` +
    ``recover()`` restores write service."""


# Every instrumented durability/IO site (the crash-point matrix iterates
# this).  The two migration sites belong to the sharded facade's range
# migration primitives (``export_range``/``strip_to_range``/
# ``import_migrated_run``).
FAULT_SITES = (
    "wal_append",
    "wal_fsync",
    "manifest_fsync",
    "block_read",
    "compaction_merge",
    "flush_write",
    "migration_import",
    "migration_strip",
)


class FaultInjector:
    """Trigger injected failures and corruption at named sites.

    Failure triggers (``check(site)`` raises :class:`InjectedFault`):

    * ``fail(site, times=1)``   -- fire on the next ``times`` hits
      (``times=-1`` fires forever);
    * ``fail_every(site, n)``   -- fire on every Nth hit of the site;
    * ``fail_prob(site, p)``    -- fire with probability ``p`` per hit, from
      the injector's seeded RNG.

    Corruption arming, consumed by the ``crash()`` paths:
    ``corrupt_wal_tail(mode)`` (``"torn"`` keeps a random prefix of the
    unsynced tail; ``"bitflip"``/``"garbage"`` damage the synced region's
    last bytes) and ``corrupt_manifest_edit()`` (the last edit's checksum
    stops matching).  ``corrupt_run_block(run)`` acts at once.

    ``fired`` counts every triggered failure and corruption by site.
    """

    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)
        self._times: Dict[str, int] = {}
        self._every: Dict[str, int] = {}
        self._hits: Dict[str, int] = {}
        self._prob: Dict[str, float] = {}
        self.fired: Dict[str, int] = {}
        self.wal_tail_mode: Optional[str] = None   # None | torn | bitflip | garbage
        self.manifest_corruption: bool = False

    # -- arming -------------------------------------------------------------
    def fail(self, site: str, times: int = 1) -> "FaultInjector":
        self._times[site] = times
        return self

    def fail_every(self, site: str, n: int) -> "FaultInjector":
        if n < 1:
            raise ValueError("fail_every needs n >= 1")
        self._every[site] = n
        return self

    def fail_prob(self, site: str, p: float) -> "FaultInjector":
        self._prob[site] = float(p)
        return self

    def clear(self, site: Optional[str] = None) -> None:
        if site is None:
            self._times.clear()
            self._every.clear()
            self._prob.clear()
        else:
            self._times.pop(site, None)
            self._every.pop(site, None)
            self._prob.pop(site, None)

    def corrupt_wal_tail(self, mode: str = "bitflip") -> "FaultInjector":
        if mode not in ("torn", "bitflip", "garbage"):
            raise ValueError(f"unknown WAL tail corruption mode {mode!r}")
        self.wal_tail_mode = mode
        return self

    def corrupt_manifest_edit(self) -> "FaultInjector":
        self.manifest_corruption = True
        return self

    # -- firing -------------------------------------------------------------
    def _fired(self, site: str) -> None:
        self.fired[site] = self.fired.get(site, 0) + 1
        raise InjectedFault(site)

    def check(self, site: str) -> None:
        """Raise :class:`InjectedFault` if a trigger for ``site`` fires."""
        t = self._times.get(site)
        if t is not None and t != 0:
            if t > 0:
                self._times[site] = t - 1
            self._fired(site)
        n = self._every.get(site)
        if n is not None:
            h = self._hits.get(site, 0) + 1
            self._hits[site] = h
            if h % n == 0:
                self._fired(site)
        p = self._prob.get(site)
        if p is not None and self.rng.random() < p:
            self._fired(site)

    # -- corruption helpers (called by crash() and by tests) ----------------
    def mangle_wal_tail(self, buf: bytearray, synced_upto: int) -> int:
        """Apply the armed WAL tail corruption to ``buf`` and return the
        buffer length to keep.  Consumes the armed mode."""
        mode, self.wal_tail_mode = self.wal_tail_mode, None
        if mode is None:
            return synced_upto
        self.fired["wal_tail:" + mode] = self.fired.get("wal_tail:" + mode, 0) + 1
        if mode == "torn":
            # a torn write: some prefix of the unsynced tail made it out
            extra = len(buf) - synced_upto
            return synced_upto + (self.rng.randrange(extra + 1) if extra > 0 else 0)
        # bitflip / garbage damage bytes *within* the synced region's tail,
        # so recovery cannot trust the length watermark and must checksum.
        if synced_upto == 0:
            return 0
        lo = max(0, synced_upto - 32)
        if mode == "bitflip":
            pos = self.rng.randrange(lo, synced_upto)
            buf[pos] ^= 1 << self.rng.randrange(8)
        else:  # garbage
            pos = self.rng.randrange(lo, synced_upto)
            end = min(synced_upto, pos + 8)
            for i in range(pos, end):
                buf[i] = self.rng.randrange(256)
        return synced_upto

    def corrupt_run_block(self, run) -> int:
        """Flip bits inside a sampled block of ``run`` (on its device);
        return the block id.

        Prefers a value byte (payload corruption); in a block of tombstones
        or empty values it flips a sequence-number bit instead.  Either way
        the block's checksum stops matching.  The draws are the
        reference's: the block's entries come back once (a block is at
        most a few hundred rows) to pick the entry the RNG names.
        """
        if run.n_blocks == 0 or len(run) == 0:
            raise ValueError("cannot corrupt an empty run")
        bid = self.rng.randrange(run.n_blocks)
        idx = _block_rows(run, bid)
        if idx.size == 0:  # block spanned by a giant neighbouring entry
            bid = int(run.block_of[self.rng.randrange(len(run))])
            idx = _block_rows(run, bid)
        e = int(idx[self.rng.randrange(idx.size)])
        vlen = int(run.vlens[e])
        if vlen > 0 and run.vals.dim() == 2 and run.vals.shape[1] > 0:
            col = self.rng.randrange(vlen)
            run.vals[e, col] ^= 1 << self.rng.randrange(8)
        else:
            run.seqs[e] ^= 1 << self.rng.randrange(40)
        self.fired["corrupt_block"] = self.fired.get("corrupt_block", 0) + 1
        return bid


def _block_rows(run, block_id: int) -> np.ndarray:
    """Row indices of the entries that start in ``block_id`` (host)."""
    lo, hi = torch.searchsorted(
        run.block_of, torch.tensor([block_id, block_id + 1],
                                   device=run.block_of.device)).tolist()
    return np.arange(lo, hi)
