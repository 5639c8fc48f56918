"""Cursor-based streaming merging iterator over the device runs + memtable.

Counterpart of ``repro.core.iterator``, with the reference's design and
accounting: one forward-only cursor per run and a merge buffer refilled
incrementally.  Each refill
  1. takes a window of entries from every source, newest source first
     (memtable, then runs as ``LSMStore._runs_newest_first`` yields them);
  2. clamps every window to the *frontier*, the smallest last key among
     truncated windows, below which every version of every key is visible;
  3. merges the clamped keys with one stable sort, so the first occurrence
     of a key is its newest version;
  4. emits at most ``demand`` winners, consuming each source only up to the
     last emitted key (unconsumed entries are windowed again next refill);
  5. materializes the winners' values (tombstone winners emit ``None`` and
     are skipped on read).
``demand`` starts at ``_FIRST_DEMAND``, doubles per refill up to the
window cap, and grows by twice the tombstones the previous refill emitted,
so a scan across a deleted range takes O(log deleted) refills.

What differs is where the runs live: their keys, block ids and values are
on the device, so a literal port would wait on the device once per run per
refill for its window, once for its consumed blocks and once for its
values.  Here a seek launches every run's searchsorted and reads the
positions back once (``run.seek_batch``); a refill copies every run's
window of keys and block ids to the host in one transfer, merges on the
host exactly as the reference does, and fetches the winners' lengths and
values in one more (``run.fetch_values``).  A refill therefore waits on the
device at most twice, however many runs there are; the refill count and
every IOStats field equal the reference's.

I/O cost model: ``seek`` charges every participating run one iterator seek
(``stats.seeks``/``runs_touched_range``); ``consume`` charges every run the
data blocks *spanned* by the prefix the merged stream consumed from it,
deduplicated across refills at block granularity.  With a block cache
attached (``core.cache.BlockCache``) each newly spanned block first
consults the cache, and only misses charge ``blocks_read``.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from .memtable import Entry, Memtable
from .run import SortedRun, fetch_values, seek_batch
from .telemetry import ACTIVE
from .types import KEY_DTYPE, IOStats

_FIRST_DEMAND = 16
_MAX_WINDOW = 4096


def combined_mem_items(memtables: Sequence[Memtable], key: int
                       ) -> List[Entry]:
    """Newest-wins combination of the memtables' scans from ``key`` on.

    ``memtables`` is newest first (the engine's ``_mem_sources`` order);
    the first source holding a key owns it, so the merge sees one
    key-sorted memtable stream.
    """
    if not memtables:
        return []
    if len(memtables) == 1:
        return memtables[0].scan(key)
    combined = {}
    for mt in memtables:
        for k, s, v in mt.scan(key):
            if k not in combined:
                combined[k] = (s, v)
    return [(k, s, v) for k, (s, v) in sorted(combined.items())]


class _RunCursor:
    """Forward-only position over one immutable run, with block accounting."""

    __slots__ = ("run", "stats", "cache", "n", "pos", "_charged")

    def __init__(self, run: SortedRun, stats: IOStats, cache=None):
        self.run = run
        self.stats = stats
        self.cache = cache
        self.n = len(run)
        self.pos = self.n
        self._charged = -1

    def seek(self, pos: int) -> None:
        """Place the cursor at ``pos``, the run's first index >= the key
        (found for every run at once by the iterator)."""
        self.stats.seeks += 1
        self.stats.runs_touched_range += 1
        self.pos = pos
        self._charged = -1

    def window(self, w: int) -> Tuple[int, int, bool]:
        """Up to ``w`` entries at the cursor: (start, end, truncated)."""
        i = self.pos
        e = i + w
        if e >= self.n:
            return i, self.n, False
        return i, e, True

    def consume(self, cnt: int, blocks: np.ndarray) -> None:
        """Advance past ``cnt`` entries, charging the blocks they span;
        ``blocks`` holds the block ids of the window at the cursor.  Blocks
        already charged by an earlier refill are not charged again."""
        if cnt <= 0:
            return
        b0, b1 = int(blocks[0]), int(blocks[cnt - 1])
        first_new = max(b0, self._charged + 1)
        if self.cache is None:
            self.stats.blocks_read += b1 - first_new + 1
        else:
            # span-charge the newly consumed blocks in one cache call
            self.cache.read_block_span(self.run.run_id, first_new, b1,
                                       self.run.block_bytes, self.stats)
        self._charged = b1
        self.pos += cnt


class MergingIterator:
    """Streaming merge of runs (newest-first order) + optional memtables.

    Usage: ``it.seek(k)`` then ``it.next()`` until None; or ``it.scan(k, n)``;
    or iterate (``for key, value in it`` after a seek).  Entries come out in
    strictly increasing key order; tombstones and shadowed versions are
    consumed internally.
    """

    def __init__(self, runs: Sequence[SortedRun],
                 memtables: Optional[Sequence[Memtable]] = None,
                 stats: Optional[IOStats] = None,
                 chunk: int = _MAX_WINDOW, cache=None):
        """``memtables`` are newest first; duplicates resolve
        newest-memtable-wins at seek time.  ``cache`` charges the blocks
        the cursors consume through the block cache."""
        self.stats = stats if stats is not None else IOStats()
        self._cursors: List[_RunCursor] = [
            _RunCursor(r, self.stats, cache) for r in runs if len(r)]
        self._memtables: List[Memtable] = list(memtables or [])
        self._mem_keys = np.zeros(0, dtype=KEY_DTYPE)
        self._mem_items: List[Entry] = []
        self._mem_base = 0        # index in _mem_items of _mem_keys[0]
        self._mem_pos = 0
        self._max_window = max(int(chunk), _FIRST_DEMAND)
        self._demand = _FIRST_DEMAND
        self._tomb_carry = 0
        self._exhausted = True
        self._bk: List[int] = []                    # emitted keys
        self._bv: List[Optional[bytes]] = []        # emitted values (aligned)
        self._bi = 0

    # ------------------------------------------------------------ interface
    def seek(self, key: int, expected: int = 0) -> None:
        """Position every cursor at its first entry >= key.

        ``expected`` hints how many entries the caller intends to consume so
        the first refill can size itself to demand.
        """
        key = int(key)
        positions, _ = seek_batch([c.run for c in self._cursors], key)
        for cur, pos in zip(self._cursors, positions):
            cur.seek(pos)
        if len(self._memtables) == 1:
            # a view of the memtable's key-ordered copy, nothing copied
            keys, items = self._memtables[0].sorted_entries()
            base = int(np.searchsorted(keys, np.uint64(key)))
            self._mem_keys, self._mem_items, self._mem_base = \
                keys[base:], items, base
        else:
            self._mem_items = combined_mem_items(self._memtables, key)
            self._mem_keys = np.fromiter((e[0] for e in self._mem_items),
                                         KEY_DTYPE, len(self._mem_items))
            self._mem_base = 0
        self._mem_pos = 0
        self._demand = max(int(expected), _FIRST_DEMAND)
        self._tomb_carry = 0
        self._exhausted = False
        self._bk = []
        self._bv = []
        self._bi = 0

    def next(self) -> Optional[Tuple[int, bytes]]:
        """The next live entry, or None when the stream is exhausted."""
        while True:
            i = self._bi
            if i < len(self._bk):
                self._bi = i + 1
                v = self._bv[i]
                if v is None:          # tombstone winner
                    continue
                return self._bk[i], v
            if self._exhausted or not self._refill():
                return None

    def scan(self, start_key: int, count: int) -> List[Tuple[int, bytes]]:
        """First ``count`` live entries with key >= start_key."""
        ph = ACTIVE.phases
        self.seek(start_key, expected=count)
        if ph is not None:
            ph.next("emit")
        out: List[Tuple[int, bytes]] = []
        while len(out) < count:
            i = self._bi
            bk, bv = self._bk, self._bv
            nb = len(bk)
            if i >= nb:
                if self._exhausted or not self._refill():
                    break
                if ph is not None:
                    ph.next("emit")
                continue
            need = count - len(out)
            while i < nb and need:
                v = bv[i]
                if v is not None:
                    out.append((bk[i], v))
                    need -= 1
                i += 1
            self._bi = i
        return out

    def __iter__(self) -> Iterator[Tuple[int, bytes]]:
        while True:
            e = self.next()
            if e is None:
                return
            yield e

    # ---------------------------------------------------------------- merge
    def _run_windows(self, w: int):
        """``(sid, start, keys, blocks, truncated)`` of every cursor with
        entries left: their keys (u64) and block ids, brought to the host
        in one transfer."""
        live = [(sid, cur, *cur.window(w))
                for sid, cur in enumerate(self._cursors) if cur.pos < cur.n]
        if not live:
            return []
        spans = [e - s for _, _, s, e, _ in live]
        host = torch.cat(
            [cur.run.keys[s:e] for _, cur, s, e, _ in live]
            + [cur.run.block_of[s:e] for _, cur, s, e, _ in live]
        ).cpu().numpy()
        total = sum(spans)
        keys, blocks = ops.from_order(host[:total]), host[total:]
        out, o = [], 0
        for (sid, _, s, _, truncated), m in zip(live, spans):
            out.append((sid, s, keys[o:o + m], blocks[o:o + m], truncated))
            o += m
        return out

    def _refill(self) -> bool:
        """Merge the sources' next windows into the emit buffer.

        ``demand`` — the emission cap — is the base geometric ramp plus
        *twice* the count of tombstone winners the previous refill emitted
        (``_tomb_carry``): tombstones occupy demand slots but yield no live
        entries, and the 2x makes the growth geometric.  The window follows
        demand past the ``_MAX_WINDOW`` cap when tombstone-driven, so the
        refill count stays O(log deleted).
        """
        ph = ACTIVE.phases
        if ph is not None:
            ph.next("windows")
        demand = self._demand + 2 * self._tomb_carry
        self._demand = min(self._demand * 2, self._max_window)
        w = min(max(2 * demand, _FIRST_DEMAND),
                max(self._max_window, demand))
        # 1. windows, newest source first (memtable, then runs)
        parts_k: List[np.ndarray] = []
        sids: List[int] = []                        # -1 = memtable
        rows0: List[int] = []
        blocks = {}                                 # sid -> window block ids
        frontier: Optional[int] = None
        mi = self._mem_pos
        if mi < len(self._mem_keys):
            k = self._mem_keys[mi:mi + w]
            parts_k.append(k)
            sids.append(-1)
            rows0.append(mi)
            if mi + w < len(self._mem_keys):
                frontier = int(k[-1])
        for sid, start, k, b, truncated in self._run_windows(w):
            if truncated:
                fk = int(k[-1])
                frontier = fk if frontier is None else min(frontier, fk)
            parts_k.append(k)
            sids.append(sid)
            rows0.append(start)
            blocks[sid] = b
        if not parts_k:
            self._exhausted = True
            return False
        if ph is not None:
            ph.next("merge")
        # 2. clamp windows to the frontier (slice views, no copies)
        if frontier is not None:
            fb = np.uint64(frontier)
            cnts = [int(p.searchsorted(fb, side="right")) for p in parts_k]
            parts_k = [p[:c] for p, c in zip(parts_k, cnts)]
        else:
            cnts = [len(p) for p in parts_k]
        # 3. one stable sort; first occurrence of a key = newest version
        K = np.concatenate(parts_k) if len(parts_k) > 1 else parts_k[0]
        order = np.argsort(K, kind="stable")
        Ks = K[order]
        first = np.empty(Ks.size, dtype=bool)
        first[0] = True
        np.not_equal(Ks[1:], Ks[:-1], out=first[1:])
        widx = order[first]                 # concat-indices of winners
        wkeys = Ks[first]
        # 4. cap emission at demand; consume only up to the last emitted key
        if wkeys.size > demand:
            cutoff = np.uint64(wkeys[demand - 1])
            wkeys = wkeys[:demand]
            widx = widx[:demand]
            cnts = [int(p.searchsorted(cutoff, side="right"))
                    for p in parts_k]
        elif frontier is None:
            self._exhausted = True          # every source fully drained
        for sid, c in zip(sids, cnts):
            if sid < 0:
                self._mem_pos += c
            else:
                self._cursors[sid].consume(c, blocks[sid])
        # 5. map winners back to (source, row); one fetch for the runs'
        starts = np.cumsum([0] + [len(p) for p in parts_k])
        part_of = np.searchsorted(starts, widx, side="right") - 1
        vals: List[Optional[bytes]] = [None] * wkeys.size
        wanted = []
        for g, sid in enumerate(sids):
            sel = np.nonzero(part_of == g)[0]
            if not sel.size:
                continue
            rows = widx[sel] - starts[g] + rows0[g]
            if sid < 0:
                items, base = self._mem_items, self._mem_base
                for t, r in zip(sel.tolist(), rows.tolist()):
                    vals[t] = items[base + r][2]
            else:
                wanted.append((sel, self._cursors[sid].run, rows))
        if ph is not None:
            ph.next("fetch")
        fetched = fetch_values([(run, rows) for _, run, rows in wanted])
        for (sel, _, _), got in zip(wanted, fetched):
            for t, v in zip(sel.tolist(), got):
                vals[t] = v
        self._bk = wkeys.tolist()
        self._bv = vals
        self._bi = 0
        # tombstone winners consumed demand without yielding entries; grow
        # the next refill's demand by exactly that count (see docstring)
        self._tomb_carry = vals.count(None)
        return True
