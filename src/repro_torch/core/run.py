"""Immutable sorted runs with their columns on the device.

Counterpart of ``repro.core.run``.  A run stores its entries as parallel
tensors on one device, sorted by key:
  keys  : int64 order-mapped u64 keys (``k ^ (1 << 63)``, strictly
          increasing — duplicates are resolved at build time, newest
          sequence number wins, matching LSM merge semantics)
  seqs  : int64 sequence numbers
  vlens : int32 value lengths; TOMBSTONE_LEN marks a delete marker
  vals  : uint8 (n, Vmax) padded value payload
plus ``block_of`` (int64 block id of each entry), ``fence_keys`` (first key
of each block), ``block_crcs`` (int64 CRC-32C per block, in [0, 2^32)) and
the bloom filter's bits.  The host keeps only what planning reads:
``run_id``, ``len``, ``data_bytes``, ``n_blocks``, ``min_key``, ``max_key``,
so the policy and the manifest never wait on the device.

Point reads probe the filter with the bloom kernel, locate candidates with
``torch.searchsorted`` over the keys (the fence pointers give each its one
block), and copy hit values to the host in one transfer per run.
Compaction merges pairs of runs with the merge kernel in a Huffman-ordered
ladder, drops shadowed versions on the device, and gathers every column
once at the end.
"""
from __future__ import annotations

import heapq
import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ..kernels import ops
from ..kernels.merge import FROM_B
from .bloom import BloomFilter
from .faults import CorruptionError, crc32c_rows_torch
from .telemetry import ACTIVE
from .types import BLOCK_SIZE, KEY_BYTES, TOMBSTONE_LEN, IOStats

_run_ids = itertools.count()
_SIGN = 1 << 63
# Block verifications (under the launch counts' lock): "batch" counts the
# one device pass of a paranoid point_get_batch (all of a run's candidate
# blocks), "block" one verify_block (one block, as a paranoid seek's).
VERIFY_PASSES = {"batch": 0, "block": 0}
# Hit rows of point_get_batch (under the same lock, once per run per
# batch): "view" rows became their value through the fixed-width bytes
# view, "exact" rows (a value ending in a zero byte, or padding past its
# length that is not zero) through their own slice.
ASSEMBLY_ROWS = {"view": 0, "exact": 0}


# Scratch bound of the per-entry checksum pass: rows are checksummed in
# chunks whose padded byte matrix stays under this many bytes, so a
# verification of a 10M-entry store never holds n x (20 + Vmax) at once.
_CRC_SCRATCH = 256 << 20


def _entry_crcs(keys: torch.Tensor, seqs: torch.Tensor, vlens: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
    """CRC-32C per entry over its canonical bytes, as the reference:
    key(8 LE, the u64 key) | seq(8 LE) | vlen(4 LE, signed — tombstones
    included) | value[:max(vlen,0)].  Rows go in chunks of at most
    :data:`_CRC_SCRATCH` padded bytes."""
    n = keys.numel()
    if n == 0:
        return keys.new_zeros(0)
    step = max(1, _CRC_SCRATCH // (20 + vals.shape[1]))
    out = []
    for i in range(0, n, step):
        j = min(n, i + step)
        user_keys = keys[i:j] ^ -_SIGN      # undo the order map: the u64 bits
        mat = torch.cat([user_keys.view(torch.uint8).view(j - i, 8),
                         seqs[i:j].view(torch.uint8).view(j - i, 8),
                         vlens[i:j].view(torch.uint8).view(j - i, 4),
                         vals[i:j]], dim=1)
        out.append(crc32c_rows_torch(
            mat, 20 + vlens[i:j].clamp(min=0).to(torch.int64)))
    return out[0] if len(out) == 1 else torch.cat(out)


def _xor_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix XOR (log-step doubling; torch has no cumulative
    XOR)."""
    s = 1
    while s < x.numel():
        y = x.clone()
        y[s:] ^= x[:-s]
        x = y
        s *= 2
    return x


class SortedRun:
    __slots__ = ("run_id", "keys", "seqs", "vlens", "vals", "block_of",
                 "fence_keys", "n_blocks", "data_bytes", "block_size",
                 "bloom", "block_crcs", "min_key", "max_key", "_len")

    def __init__(self, keys: torch.Tensor, seqs: torch.Tensor,
                 vlens: torch.Tensor, vals: torch.Tensor,
                 bits_per_key: float = 0.0, block_size: int = BLOCK_SIZE,
                 key_bytes: int = KEY_BYTES,
                 bloom_geometry: Optional[Tuple[int, int]] = None):
        """Columns must already be sorted and unique (see :func:`build_run`).
        ``bloom_geometry=(m_bits, k)`` rebuilds a filter of a known shape
        instead of deriving it from ``bits_per_key``."""
        ph = ACTIVE.phases
        if ph is not None:
            ph.next("layout")
        self.block_size = block_size
        self.run_id = next(_run_ids)
        self.keys, self.seqs, self.vlens, self.vals = keys, seqs, vlens, vals
        n = self._len = int(keys.numel())
        entry_sizes = key_bytes + vlens.clamp(min=0).to(torch.int64)
        cum = torch.cumsum(entry_sizes, 0)
        # Entry i lives in the block containing its *starting* byte.
        self.block_of = (cum - entry_sizes) // block_size
        if n:
            # the one read-back of a build: what the host plans with
            data_bytes, last_block, lo, hi = torch.stack(
                [cum[-1], self.block_of[-1], keys[0], keys[-1]]).tolist()
            self.data_bytes = data_bytes
            self.n_blocks = last_block + 1
            self.min_key, self.max_key = lo + _SIGN, hi + _SIGN
            # Fence pointer = first key of each block (in-memory index).
            self.fence_keys = keys[torch.searchsorted(
                self.block_of, torch.arange(self.n_blocks,
                                            device=keys.device))]
            if ph is not None:
                ph.next("entry_crc")
            self.block_crcs = self._block_crcs_from(
                _entry_crcs(keys, seqs, vlens, vals))
        else:
            self.data_bytes = self.n_blocks = self.min_key = self.max_key = 0
            self.fence_keys = keys.new_zeros(0)
            self.block_crcs = keys.new_zeros(0)
        if ph is not None:
            ph.next("bloom")
        self.bloom = BloomFilter(keys, bits_per_key, bloom_geometry)

    # ------------------------------------------------------------------ size
    def __len__(self) -> int:
        return self._len

    @property
    def device(self) -> torch.device:
        return self.keys.device

    def bit_equal(self, other: "SortedRun") -> bool:
        """Bit-for-bit payload equality: keys/seqs/vlens/vals/bloom bits
        (compared on the CPU, so runs on different devices compare)."""
        return all(torch.equal(x.cpu(), y.cpu()) for x, y in (
            (self.keys, other.keys), (self.seqs, other.seqs),
            (self.vlens, other.vlens), (self.vals, other.vals),
            (self.bloom.bits, other.bloom.bits)))

    def block_bytes(self, block_id: int) -> int:
        """Physical bytes stored in one block (the last block may be short)."""
        if block_id < 0 or block_id >= self.n_blocks:
            return 0
        if block_id == self.n_blocks - 1:
            return self.data_bytes - block_id * self.block_size
        return self.block_size

    # ------------------------------------------------------------- integrity
    def _block_crcs_from(self, entry_crcs: torch.Tensor) -> torch.Tensor:
        """Fold per-entry CRCs into per-block checksums: the XOR of the
        block's member entries (order-independent); a block spanned
        entirely by a giant neighbouring entry has none, and 0."""
        blocks = torch.arange(self.n_blocks, device=self.keys.device)
        acc = F.pad(_xor_scan(entry_crcs), (1, 0))
        return acc[torch.searchsorted(self.block_of, blocks, right=True)] \
            ^ acc[torch.searchsorted(self.block_of, blocks)]

    def verify_block(self, block_id: int) -> bool:
        """Recompute one block's checksum from its entries; True iff
        clean.  Two waits: the block's row range, then the comparison."""
        with _build.COUNT_LOCK:
            VERIFY_PASSES["block"] += 1
        lo, hi = torch.searchsorted(self.block_of, torch.tensor(
            [block_id, block_id + 1], device=self.device)).tolist()
        fresh = _xor_scan(_entry_crcs(self.keys[lo:hi], self.seqs[lo:hi],
                                      self.vlens[lo:hi], self.vals[lo:hi]))
        fresh = fresh[-1] if hi > lo else self.block_crcs.new_zeros(())
        return bool(fresh == self.block_crcs[block_id])

    def _candidate_blocks(self, blk: torch.Tensor):
        """The distinct blocks of ``blk`` (block ids, ``n_blocks`` for "no
        candidate"), as fixed-size device columns: ``(ids, valid, start,
        count)``, sorted, with the first row and the member count of every
        distinct block and ``valid`` False on repeats and the sentinel."""
        ids = torch.sort(blk).values
        valid = torch.ones_like(ids, dtype=torch.bool)
        valid[1:] = ids[1:] != ids[:-1]
        valid &= ids < self.n_blocks
        ids = ids.clamp(max=self.n_blocks - 1)
        start = torch.searchsorted(self.block_of, ids)
        count = torch.searchsorted(self.block_of, ids, right=True) - start
        return ids, valid, start, torch.where(valid, count, 0)

    def _first_bad_block(self, ids, valid, start, count, total: int
                         ) -> torch.Tensor:
        """One device pass over the member entries of the distinct blocks
        from :meth:`_candidate_blocks` (``total`` rows in all): their
        entry CRCs folded per block with the XOR scan of
        :meth:`_block_crcs_from`, held against the stored checksums.
        Returns the lowest bad block id as a 0-d tensor (``n_blocks`` when
        every block is clean); nothing is read back here."""
        with _build.COUNT_LOCK:
            VERIFY_PASSES["batch"] += 1
        dev = self.device
        end = torch.cumsum(count, 0)
        first = end - count
        if total:
            seg = torch.repeat_interleave(
                torch.arange(ids.numel(), device=dev), count,
                output_size=total)
            rows = start[seg] + torch.arange(total, device=dev) - first[seg]
            acc = F.pad(_xor_scan(_entry_crcs(
                self.keys[rows], self.seqs[rows], self.vlens[rows],
                self.vals[rows])), (1, 0))
            fresh = acc[end] ^ acc[first]
        else:
            fresh = torch.zeros_like(ids)
        bad = valid & (fresh != self.block_crcs[ids])
        return torch.where(bad, ids, self.n_blocks).min()

    def verify(self) -> List[int]:
        """Recompute every block checksum on the device; the bad block ids
        come back in one copy (empty list == the run is clean).  Used by
        ``scrub()`` and recovery."""
        if self._len == 0:
            return []
        fresh = self._block_crcs_from(
            _entry_crcs(self.keys, self.seqs, self.vlens, self.vals))
        return torch.nonzero(fresh != self.block_crcs).squeeze(1).tolist()

    def _charge_block(self, block_id: int, stats: IOStats, cache,
                      paranoid: bool = False, faults=None) -> None:
        """One block touch: through the cache when present, else raw I/O.
        ``faults`` fires the ``block_read`` site first; ``paranoid``
        re-verifies the block after the read and raises
        :class:`CorruptionError` on a mismatch."""
        if faults is not None:
            faults.check("block_read")
        if cache is None:
            stats.blocks_read += 1
        else:
            cache.read_block(self.run_id, int(block_id),
                             self.block_bytes(int(block_id)), stats)
        if paranoid and not self.verify_block(int(block_id)):
            raise CorruptionError(self.run_id, int(block_id))

    # ----------------------------------------------------------------- reads
    def point_get_batch(self, keys: torch.Tensor, stats: IOStats,
                        use_bloom: bool = True, cache=None,
                        paranoid: bool = False, faults=None
                        ) -> Tuple[np.ndarray, np.ndarray, torch.Tensor]:
        """Vectorized point lookup of order-mapped ``keys`` (on this run's
        device).

        Returns ``(found, values, rest)``: found[i] True means key i's
        newest version lives in this run; ``values`` is an object array of
        the hits' answers in key order (``values[j]`` answers the j-th True
        of ``found``: its bytes, or None for a tombstone), made by
        :func:`_hit_values`; ``rest`` is ``keys[~found]``, still on the
        device.
        One bloom kernel launch + one searchsorted over the whole batch,
        one wait for the hit count and one device-to-host copy; aggregate
        IOStats accounting is identical to the reference's.  With a
        ``cache`` the same copy carries each key's candidate block (-1 for
        a key the filter rejected), and the candidates' reads go through
        the cache in batch order, as the reference charges them.

        ``faults`` fires the ``block_read`` site once per candidate, after
        the filter's counters and before the block charges, as the
        reference does.  ``paranoid`` verifies the candidates' distinct
        blocks in one device pass (:meth:`_first_bad_block`) whose lowest
        bad block id comes back in the same transfer; it raises
        :class:`CorruptionError` after the block charges, as the
        reference's ascending verify loop raises at its first bad block.
        A paranoid batch waits on the device twice, as a plain one does:
        the wait for the hit count also brings the verify's row count.
        """
        n = keys.numel()
        found = np.zeros(n, dtype=bool)
        values = np.empty(0, dtype=object)
        if n == 0 or self._len == 0:
            return found, values, keys
        probing = use_bloom and self.bloom.k > 0
        if probing:
            maybe = self.bloom.may_contain(keys)
        idx = torch.searchsorted(self.keys, keys)
        idxc = idx.clamp(max=self._len - 1)
        hit = (idx < self._len) & (self.keys[idxc] == keys)
        if probing:
            hit &= maybe
        if paranoid:
            blk = self.block_of[idxc]
            cand = torch.where(maybe, blk, self.n_blocks) if probing else blk
            verify = self._candidate_blocks(cand)
            n_hit, total = torch.stack([hit.sum(), verify[3].sum()]).tolist()
            hit_pos = torch.argsort((~hit).to(torch.uint8),
                                    stable=True)[:n_hit]
            bad = self._first_bad_block(*verify, total).view(1)
        else:
            hit_pos = torch.nonzero(hit).squeeze(1)  # waits for the device
            n_hit = hit_pos.numel()
        rows = idxc[hit_pos]
        n_maybe = maybe.sum() if probing else hit_pos.new_tensor(n)
        # one transfer: the candidate count, hit positions, value lengths
        # (the lowest bad block, the candidate blocks) as int64, then the
        # hit rows' values
        parts = [n_maybe.view(1), hit_pos, self.vlens[rows].to(torch.int64)]
        if paranoid:
            parts.append(bad)
        if cache is not None:
            blk = self.block_of[idxc]
            parts.append(torch.where(maybe, blk, -1) if probing else blk)
        meta = torch.cat(parts)
        n_meta = meta.numel()
        buf = torch.cat([meta.view(torch.uint8),
                         self.vals[rows].reshape(-1)]).cpu().numpy()
        ph = ACTIVE.phases
        if ph is not None:
            ph.next("assemble")
        meta = buf[:n_meta * 8].view(np.int64)
        n_cand = int(meta[0])
        if probing:
            stats.bloom_probes += n
            stats.bloom_negatives += n - n_cand
        if n_cand == 0:
            return found, values, keys
        if faults is not None:
            for _ in range(n_cand):      # one injection check per read
                faults.check("block_read")
        o = 1 + 2 * n_hit + int(paranoid)
        # Fence pointers give each candidate its unique block: 1 read apiece.
        if cache is None:
            stats.blocks_read += n_cand
        else:
            if ph is not None:
                ph.next("cache")
            blk = meta[o:]
            cache.read_blocks(self.run_id, blk[blk >= 0].tolist(),
                              self.block_bytes, stats)
            if ph is not None:
                ph.next("assemble")
        if paranoid and meta[o - 1] < self.n_blocks:
            raise CorruptionError(self.run_id, int(meta[o - 1]))
        stats.false_positives += n_cand - n_hit
        found[meta[1:1 + n_hit]] = True
        values = _hit_values(buf[n_meta * 8:], meta[1 + n_hit:1 + 2 * n_hit],
                             self.vals.shape[1])
        rest = keys[~hit] if n_hit else keys
        return found, values, rest

    # ------------------------------------------------------------ range reads
    def seek_idx(self, key: int) -> int:
        """Index of the first entry whose u64 key is >= ``key``."""
        return seek_batch([self], key)[0][0]

    def slice_from(self, start_idx: int, count: int):
        """Entries [start_idx, start_idx+count) on the host, as the
        reference holds them: (u64 keys, u64 seqs, int32 vlens, uint8
        (m, Vmax) vals)."""
        e = min(start_idx + count, len(self))
        return (ops.keys_from_device(self.keys[start_idx:e]),
                self.seqs[start_idx:e].cpu().numpy().view(np.uint64),
                self.vlens[start_idx:e].cpu().numpy(),
                self.vals[start_idx:e].cpu().numpy())

    def values_at(self, rows) -> List[Optional[bytes]]:
        """The values at ``rows`` (None at a tombstone), with one
        device-to-host copy (see :func:`fetch_values`)."""
        return fetch_values([(self, rows)])[0]

    def blocks_spanned(self, start_idx: int, end_idx: int) -> int:
        """Number of blocks touched to read entries [start_idx, end_idx)."""
        if end_idx <= start_idx or start_idx >= len(self):
            return 0
        end_idx = min(end_idx, len(self))
        first, last = torch.stack([self.block_of[start_idx],
                                   self.block_of[end_idx - 1]]).tolist()
        return last - first + 1

    def point_get(self, key: int, stats: IOStats, use_bloom: bool = True,
                  cache=None, paranoid: bool = False,
                  faults=None) -> Tuple[bool, Optional[bytes]]:
        """(found, value_or_None_if_tombstone) of one u64 key: the batch
        path on one key, with the same accounting as the reference's scalar
        ``point_get``."""
        found, values, _ = self.point_get_batch(
            ops.keys_to_device([key], self.device), stats, use_bloom, cache,
            paranoid, faults)
        return bool(found[0]), values[0] if found[0] else None


def _hit_values(raw: np.ndarray, lens: np.ndarray, vmax: int) -> np.ndarray:
    """The answers of a run's hit rows, in one pass: ``raw`` is the rows'
    read-back payload (``len(lens)`` rows of ``vmax`` bytes, flat),
    ``lens`` their value lengths.  Returns an object array of ``bytes``
    (None at a tombstone).

    The rows are viewed as fixed-width ``S{vmax}`` strings and become
    ``bytes`` in one C loop; such a string drops trailing zero bytes, so
    its ``str_len`` equals ``ln`` exactly when the row is ``value[:ln]``
    followed by zeros.  The other rows (a value ending in a zero byte,
    padding that is not zero) take their own slice ``row[:ln]``."""
    m = lens.size
    tomb = lens == TOMBSTONE_LEN
    # numpy has no zero-width string: a run of empty values views zeros
    view = raw.view(f"S{vmax}") if vmax else np.zeros(m, dtype="S1")
    values = view.astype(object)
    exact = np.flatnonzero((np.char.str_len(view) != lens) & ~tomb)
    rows = raw.reshape(m, vmax)
    for i in exact.tolist():
        values[i] = rows[i, :lens[i]].tobytes()
    values[tomb] = None
    with _build.COUNT_LOCK:
        ASSEMBLY_ROWS["exact"] += exact.size
        ASSEMBLY_ROWS["view"] += m - exact.size - int(tomb.sum())
    return values


def seek_batch(runs: Sequence[SortedRun], key: int, with_blocks=False):
    """Each non-empty run's first index whose u64 key is >= ``key``, and
    the u64 key there (None past the run's end); ``with_blocks`` adds the
    block id there (of the last entry past the end).  One searchsorted and
    one gather (two) a run are launched, and one read-back brings all of
    them."""
    if not runs:
        return ([], [], []) if with_blocks else ([], [])
    mapped = ops.order_of(key)
    parts = []
    for r in runs:
        i = torch.searchsorted(r.keys, mapped).view(1)
        ic = i.clamp(max=len(r) - 1)
        parts += [i, r.keys[ic]] + ([r.block_of[ic]] if with_blocks else [])
    width = 3 if with_blocks else 2
    flat = torch.cat(parts).tolist()
    idx = flat[0::width]
    keys = [None if i >= len(r) else k + _SIGN
            for r, i, k in zip(runs, idx, flat[1::width])]
    if with_blocks:
        return idx, keys, flat[2::3]
    return idx, keys


def fetch_values(runs_rows: Sequence[Tuple[SortedRun, "np.ndarray"]]
                 ) -> List[List[Optional[bytes]]]:
    """The values at ``rows`` of each ``(run, rows)`` (None at a
    tombstone), with one device-to-host copy for all of them: the row
    indices go up in one copy (pinned and asynchronous on a card), each
    run gathers its lengths and rows on the device, and one buffer of
    lengths then payloads comes back."""
    if not runs_rows:
        return []
    sizes = [len(rows) for _, rows in runs_rows]
    idx = torch.from_numpy(np.concatenate(
        [np.asarray(rows, dtype=np.int64) for _, rows in runs_rows]))
    dev = runs_rows[0][0].device
    if dev.type == "cuda":
        idx = idx.pin_memory().to(dev, non_blocking=True)
    lens, vals = [], []
    o = 0
    for (run, _), m in zip(runs_rows, sizes):
        rows = idx[o:o + m]
        o += m
        lens.append(run.vlens[rows])
        vals.append(run.vals[rows].reshape(-1))
    n = int(idx.numel())
    buf = torch.cat([torch.cat(lens).view(torch.uint8)] + vals).cpu().numpy()
    all_lens = buf[:4 * n].view(np.int32).tolist()
    flat = buf[4 * n:].tobytes()
    out: List[List[Optional[bytes]]] = []
    o = off = 0
    for (run, _), m in zip(runs_rows, sizes):
        vmax = run.vals.shape[1]
        vals_r: List[Optional[bytes]] = []
        for ln in all_lens[o:o + m]:
            vals_r.append(None if ln == TOMBSTONE_LEN
                          else flat[off:off + ln])
            off += vmax
        out.append(vals_r)
        o += m
    return out


def levels_bit_equal(levels_a: Sequence[Sequence[SortedRun]],
                     levels_b: Sequence[Sequence[SortedRun]]) -> bool:
    """Bit-for-bit tree equality: same level count, same runs per level,
    every run pair :meth:`SortedRun.bit_equal`."""
    if len(levels_a) != len(levels_b):
        return False
    return all(len(la) == len(lb) and all(ra.bit_equal(rb)
                                          for ra, rb in zip(la, lb))
               for la, lb in zip(levels_a, levels_b))


# --------------------------------------------------------------------- build
def build_run(keys: torch.Tensor, seqs: torch.Tensor, vlens: torch.Tensor,
              vals: torch.Tensor, bits_per_key: float = 0.0,
              assume_unique_sorted: bool = False,
              drop_tombstones: bool = False,
              block_size: int = BLOCK_SIZE, key_bytes: int = KEY_BYTES,
              bloom_geometry: Optional[Tuple[int, int]] = None) -> SortedRun:
    """Sort by key, deduplicate keeping the newest seq, optionally GC
    deletes.  Columns are tensors on one device; ``vals`` is (n, Vmax)."""
    ph = ACTIVE.phases
    if ph is not None:
        ph.next("sort")
    if not assume_unique_sorted and keys.numel():
        # Stable sort by (key, -seq): newest version of each key comes first.
        by_seq = torch.argsort(seqs, descending=True, stable=True)
        order = by_seq[torch.argsort(keys[by_seq], stable=True)]
        keys, seqs, vlens, vals = keys[order], seqs[order], vlens[order], vals[order]
        keep = torch.ones_like(keys, dtype=torch.bool)
        keep[1:] = keys[1:] != keys[:-1]
        keys, seqs, vlens, vals = keys[keep], seqs[keep], vlens[keep], vals[keep]
    if drop_tombstones and keys.numel():
        live = vlens != TOMBSTONE_LEN
        keys, seqs, vlens, vals = keys[live], seqs[live], vlens[live], vals[live]
    return SortedRun(keys, seqs, vlens, vals, bits_per_key=bits_per_key,
                     block_size=block_size, key_bytes=key_bytes,
                     bloom_geometry=bloom_geometry)


def _account_merge_output(out: SortedRun, stats: IOStats) -> SortedRun:
    """Write-side cost model, shared by every merge path (paper §2.2)."""
    stats.blocks_written += out.n_blocks
    stats.entries_compacted += len(out)
    stats.bytes_compacted += out.data_bytes
    stats.compactions += 1
    return out


def _merge_pair(a, b, seqs_cat: torch.Tensor):
    """Merge two (keys, gid) nodes of the ladder into one.

    Inputs have strictly increasing keys; the output does too (the newer
    sequence number wins each duplicate).  Nodes carry only the key column
    and a *global index* into the concatenated inputs; the interleave is
    the merge kernel (a-first on equal keys), and sequence numbers are read
    only to settle duplicates.
    """
    ka, ga = a
    kb, gb = b
    na = ka.numel()
    if na == 0:
        return b
    if kb.numel() == 0:
        return a
    keys, src = ops.merge_pair(ka, kb)
    from_b = (src & FROM_B) != 0
    row = src & (FROM_B - 1)
    gid = torch.cat([ga, gb])[torch.where(from_b, row + na, row)]
    # Dedup: a key occurs at most twice and duplicates are adjacent; the
    # newer seq wins (equal-seq ties keep the first occurrence).
    dup = keys[1:] == keys[:-1]
    second_newer = seqs_cat[gid[1:]] > seqs_cat[gid[:-1]]
    keep = torch.ones_like(keys, dtype=torch.bool)
    keep[:-1] &= ~(dup & second_newer)
    keep[1:] &= ~(dup & ~second_newer)
    return keys[keep], gid[keep]


def merge_runs(runs: Sequence[SortedRun], bits_per_key: float,
               stats: IOStats, drop_tombstones: bool = False,
               block_size: int = BLOCK_SIZE,
               key_bytes: int = KEY_BYTES) -> SortedRun:
    """K-way compaction merge of non-empty ``runs`` (one device).

    A Huffman-ordered tournament of pairwise merges over (key, global-index)
    columns, always through the merge kernel (the reference's small-merge
    shortcut is never taken, so the kernel runs on every compaction; the
    output is bit-identical either way), then one gather per column.

    Cost model: every input block is read, every output block written; the
    entry/byte counters feed write-amplification (paper §2.2).
    """
    if not runs:
        raise ValueError("merge_runs needs at least one run")
    for r in runs:
        stats.blocks_read += r.n_blocks
    seqs_cat = torch.cat([r.seqs for r in runs])
    offs = np.cumsum([0] + [len(r) for r in runs])
    dev = runs[0].device
    # Always merge the two smallest nodes, so a dominant run (the usual dst
    # level) joins only the final merges.
    heap = [(len(r), i, (r.keys, torch.arange(offs[i], offs[i + 1],
                                              device=dev)))
            for i, r in enumerate(runs)]
    heapq.heapify(heap)
    tick = len(runs)
    while len(heap) > 1:
        _, ia, a = heapq.heappop(heap)
        _, ib, b = heapq.heappop(heap)
        if ib < ia:          # keep earlier-run-first orientation for ties
            a, b = b, a
        merged = _merge_pair(a, b, seqs_cat)
        heapq.heappush(heap, (merged[0].numel(), tick, merged))
        tick += 1
    keys, gid = heap[0][2]
    vlens = torch.cat([r.vlens for r in runs])[gid]
    if drop_tombstones:
        live = vlens != TOMBSTONE_LEN
        keys, vlens, gid = keys[live], vlens[live], gid[live]
    vmax = max(r.vals.shape[1] for r in runs)
    vals = torch.cat([F.pad(r.vals, (0, vmax - r.vals.shape[1]))
                      for r in runs])[gid]
    out = SortedRun(keys, seqs_cat[gid], vlens, vals,
                    bits_per_key=bits_per_key, block_size=block_size,
                    key_bytes=key_bytes)
    return _account_merge_output(out, stats)


def merge_runs_scalar(runs: Sequence[SortedRun], bits_per_key: float,
                      stats: IOStats, drop_tombstones: bool = False,
                      block_size: int = BLOCK_SIZE,
                      key_bytes: int = KEY_BYTES) -> SortedRun:
    """The plain compaction merge, kept as the oracle of :func:`merge_runs`
    (the reference's ``merge_runs_scalar``): concatenate every run's
    columns (values padded to the widest), then sort and deduplicate from
    scratch with :func:`build_run`, ignoring that the inputs are sorted.
    The merge takes no kernel; the output's filter is built as every run's
    is.  No store path calls it.  Identical output and IOStats to
    ``merge_runs``; the result lies on the inputs' device (an empty run on
    the CPU when ``runs`` is empty).
    """
    if not runs:
        empty = torch.zeros(0, dtype=torch.int64)
        return build_run(empty, empty, torch.zeros(0, dtype=torch.int32),
                         torch.zeros((0, 0), dtype=torch.uint8),
                         bits_per_key, block_size=block_size,
                         key_bytes=key_bytes)
    vmax = max(r.vals.shape[1] for r in runs)
    for r in runs:
        stats.blocks_read += r.n_blocks
    out = build_run(torch.cat([r.keys for r in runs]),
                    torch.cat([r.seqs for r in runs]),
                    torch.cat([r.vlens for r in runs]),
                    torch.cat([F.pad(r.vals, (0, vmax - r.vals.shape[1]))
                               for r in runs]),
                    bits_per_key=bits_per_key,
                    drop_tombstones=drop_tombstones, block_size=block_size,
                    key_bytes=key_bytes)
    return _account_merge_output(out, stats)
