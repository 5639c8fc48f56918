"""Integrity primitives: CRC-32C on the host and on the device.

A copy of the checksum half of ``repro.core.faults``:

* ``crc32c`` — the scalar byte-loop oracle;
* ``crc32c_rows`` — its vectorized numpy twin over the rows of a padded
  byte matrix, used by the write-ahead log (host bytes);
* ``crc32c_rows_torch`` — the same function over a uint8 tensor on any
  device, bit for bit, used for the per-block checksums of runs whose
  columns live on the card.

CRC-32C is the Castagnoli polynomial (reflected 0x82F63B78); ``zlib.crc32``
is a different polynomial.  Fault injection is left to a later slice.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["CorruptionError", "crc32c", "crc32c_rows", "crc32c_rows_torch"]


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
_TABLE_BY_DEVICE: Dict[torch.device, torch.Tensor] = {}


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
    crc = np.full(n, 0xFFFFFFFF, dtype=np.uint32)
    if n:
        for j in range(mat.shape[1]):
            active = lens > j
            if not active.any():
                break
            step = (crc >> np.uint32(8)) ^ _TABLE[(crc ^ mat[:, j]) & np.uint32(0xFF)]
            crc = np.where(active, step, crc)
    return crc ^ np.uint32(0xFFFFFFFF)


def crc32c_rows_torch(mat: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """:func:`crc32c_rows` over a ``(n, L)`` uint8 tensor and ``(n,)`` int64
    lengths on any device.  Returns ``(n,)`` int64 CRCs in ``[0, 2^32)``.

    One pass per byte column, every row at once, masked by length; never
    reads a result back to the host.  The matrix is transposed once so that
    each pass reads one contiguous column.
    """
    table = _TABLE_BY_DEVICE.get(mat.device)
    if table is None:
        table = torch.from_numpy(_TABLE.astype(np.int64)).to(mat.device)
        _TABLE_BY_DEVICE[mat.device] = table
    crc = torch.full((mat.shape[0],), 0xFFFFFFFF, dtype=torch.int64,
                     device=mat.device)
    cols = mat.t().contiguous()
    for j in range(cols.shape[0]):
        step = (crc >> 8) ^ table[(crc ^ cols[j].to(torch.int64)) & 0xFF]
        crc = torch.where(lens > j, step, crc)
    return crc ^ 0xFFFFFFFF


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
