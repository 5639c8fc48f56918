"""Cross-run range views (REMIX-style) with their columns on the device.

Counterpart of ``repro.core.view``.  A :class:`RangeView` is one globally
sorted index over every run of one tree, one row per key (the newest
version wins, the merge's resolution order), in parallel device columns:

  ``keys``    int64 order-mapped keys, strictly increasing
  ``src``     int32 index into ``runs`` (the view's newest-first run list)
  ``rows``    int64 row of the winning version inside its run
  ``live``    bool, False where the winning version is a tombstone
  ``blocks``  int64 block id of that row (the run's ``block_of`` there)

The first four are the reference's columns, bit for bit.  ``blocks`` is
the port's own: a scan charges its blocks from the same copy that brings
its rows, instead of a second look into each run.

The build.  Per-level columns are cached by the level's run-id tuple, so a
rebuild recomputes only the levels whose runs changed.  A single-run level
is free (its keys and block ids are the run's own tensors).  A multi-run
level (L0) and then the level streams, newest first, are folded with the
pair merge kernel (``kernels.ops.merge_pair``, a-first on equal keys) and
the first occurrence of each key is kept: the same winners as the
reference's one stable argsort of the concatenation, without a sort.

The reads.  A seek is one binary search and one read-back (position, key,
run and block).  A scan copies a window of view rows to the host in one
transfer (the binary search rides along with the first window), finds its
winners there exactly as the reference does (the live rows; or, with
entries in the memtables, the two-source merge against the host memtable
stream), charges their blocks, and brings the winners' values back in one
more transfer (``run.fetch_values``).  A window that falls short (a
tombstone-dense range) doubles, as the reference's sweep does, at one
transfer each.

Freshness is by identity: a view remembers the exact ``_levels`` list it
indexes (``levels_ref``), every install replaces that list, and
``levels_ref is store._levels`` is the whole check.  A view roots its runs,
so a stale view keeps retired runs on the device until it is replaced.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..kernels.merge import FROM_B
from .run import SortedRun, fetch_values
from .types import KEY_DTYPE, TOMBSTONE_LEN, IOStats

# Per-level columns: (keys, src_local, rows, live, blocks), on the device.
LevelColumns = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                     torch.Tensor]
_SIGN = 1 << 63


def _merge_newest_wins(a: LevelColumns, b: LevelColumns) -> LevelColumns:
    """Merge two strictly increasing column sets, ``a`` the newer: the
    merge kernel interleaves the keys (a-first on ties), the first
    occurrence of each key is kept, and every other column is gathered
    from its side."""
    na = a[0].numel()
    keys, src = ops.merge_pair(a[0], b[0])
    keep = torch.ones_like(keys, dtype=torch.bool)
    keep[1:] = keys[1:] != keys[:-1]
    src = src[keep]
    row = src & (FROM_B - 1)
    gid = torch.where((src & FROM_B) != 0, row + na, row)
    return (keys[keep],) + tuple(torch.cat([ca, cb])[gid]
                                 for ca, cb in zip(a[1:], b[1:]))


def _run_columns(run: SortedRun, i: int) -> LevelColumns:
    n = len(run)
    dev = run.device
    return (run.keys, torch.full((n,), i, dtype=torch.int32, device=dev),
            torch.arange(n, device=dev), run.vlens != TOMBSTONE_LEN,
            run.block_of)


def _level_columns(runs_newest_first: Sequence[SortedRun]) -> LevelColumns:
    """Sorted newest-wins columns across one level's runs: a single run's
    are its own tensors; several runs are folded newest first."""
    cols = _run_columns(runs_newest_first[0], 0)
    for i, r in enumerate(runs_newest_first[1:], start=1):
        cols = _merge_newest_wins(cols, _run_columns(r, i))
    return cols


def build_range_view(levels: Sequence[Sequence[SortedRun]],
                     level_cache: Optional[Dict[Tuple[int, ...],
                                                LevelColumns]] = None,
                     telemetry=None, device=None) -> "RangeView":
    """Build the global view from a captured (copy-on-write) level list.

    ``level_cache`` maps a level's run-id tuple to its columns: levels
    untouched since the last rebuild reuse them, and entries of retired
    run sets are pruned so the cache never roots dead runs.  ``device``
    places the columns of an empty view (a view with runs lives on theirs).
    ``telemetry`` gets a ``view_rebuild`` event per build.
    """
    t0 = time.perf_counter_ns() if telemetry is not None else 0
    view = _build_range_view(levels, level_cache, device)
    if telemetry is not None:
        dur = time.perf_counter_ns() - t0
        telemetry.emit("view_rebuild", entries=len(view),
                       runs=len(view.runs), t0=t0, dur_ns=dur)
    return view


def _build_range_view(levels, level_cache, device) -> "RangeView":
    runs: List[SortedRun] = []
    parts: List[LevelColumns] = []
    live_keys = set()
    built = 0
    for lvl in levels:
        rr = [r for r in reversed(lvl) if len(r)]  # newest first within level
        if not rr:
            continue
        ck = tuple(r.run_id for r in rr)
        live_keys.add(ck)
        cols = level_cache.get(ck) if level_cache is not None else None
        if cols is None:
            cols = _level_columns(rr)
            built += 1
            if level_cache is not None:
                level_cache[ck] = cols
        off = len(runs)
        runs.extend(rr)
        parts.append(cols if off == 0 else
                     (cols[0], cols[1] + off) + tuple(cols[2:]))
    if level_cache is not None:
        for stale in [k for k in level_cache if k not in live_keys]:
            del level_cache[stale]
    if not parts:
        dev = torch.device("cpu") if device is None else device
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        return RangeView(levels, [], z, z.to(torch.int32), z, z.bool(), z)
    cols = parts[0]
    for p in parts[1:]:         # level streams, newest level first
        cols = _merge_newest_wins(cols, p)
    return RangeView(levels, runs, *cols, levels_built=built)


class RangeView:
    """One immutable globally sorted view of one tree (see module doc)."""

    __slots__ = ("levels_ref", "runs", "keys", "src", "rows", "live",
                 "blocks", "all_live", "n", "levels_built")

    def __init__(self, levels_ref, runs: List[SortedRun], keys: torch.Tensor,
                 src: torch.Tensor, rows: torch.Tensor, live: torch.Tensor,
                 blocks: torch.Tensor, levels_built: int = 0):
        self.levels_ref = levels_ref   # identity token: the exact COW list
        self.runs = runs               # newest first; holds the runs alive
        self.keys = keys
        self.src = src
        self.rows = rows
        self.live = live
        self.blocks = blocks
        self.n = int(keys.numel())
        self.levels_built = levels_built   # levels whose columns this build
                                           # computed (not from the cache)
        # one wait per rebuild: a tombstone-free view sweeps without
        # looking at the liveness column
        self.all_live = bool(live.all())

    def __len__(self) -> int:
        return self.n

    # ------------------------------------------------------------------ reads
    def seek(self, key: int, stats: Optional[IOStats] = None,
             cache=None) -> Optional[int]:
        """First indexed key >= ``key`` (tombstone winners included: the
        approximate-liveness contract of ``LSMStore.seek``).  One binary
        search, one read-back and one block touch."""
        if self.n == 0:
            return None
        q = torch.tensor([ops.order_of(key)], dtype=torch.int64,
                         device=self.keys.device)
        i = torch.searchsorted(self.keys, q)
        ic = i.clamp(max=self.n - 1)
        i, k, s, b = torch.cat([i, self.keys[ic], self.src[ic].long(),
                                self.blocks[ic]]).tolist()
        if i >= self.n:
            return None
        if stats is not None:
            stats.seeks += 1
            stats.runs_touched_range += 1
            self.runs[s]._charge_block(b, stats, cache)
        return k + _SIGN

    def scan(self, start_key: int, count: int,
             mem_items: Sequence[Tuple[int, int, Optional[bytes]]] = (),
             stats: Optional[IOStats] = None,
             cache=None) -> List[Tuple[int, bytes]]:
        """First ``count`` live entries with key >= start_key.

        ``mem_items`` is the newest-wins, key-sorted memtable stream from
        ``start_key`` (``iterator.combined_mem_items``); its entries shadow
        same-key view entries.  Empty memtables take the pure sweep.
        """
        keys = np.fromiter((e[0] for e in mem_items), KEY_DTYPE,
                           len(mem_items))
        return self.scan_with_memtable(start_key, count, keys,
                                       list(mem_items), stats, cache)

    def scan_with_memtable(self, start_key: int, count: int,
                           mem_keys: np.ndarray, mem_items: list,
                           stats: Optional[IOStats] = None,
                           cache=None) -> List[Tuple[int, bytes]]:
        """:meth:`scan` over a key-sorted memtable stream given as its u64
        keys and aligned ``(key, seq, value|None)`` items, from any key on
        (a memtable's cached ``sorted_entries()``): only the entries from
        ``start_key`` to the scan's end are looked at."""
        if count <= 0:
            return []
        start_key = int(start_key)
        base = int(np.searchsorted(mem_keys, np.uint64(start_key)))
        if base >= mem_keys.size:
            return self._scan_sweep(start_key, count, stats, cache)
        return self._scan_with_mem(start_key, count, mem_keys[base:],
                                   mem_items, base, stats, cache)

    def _window(self, lo: int, w: int, key: Optional[int] = None):
        """View rows [lo, lo + w), cut at the end, on the host in one
        transfer: ``(lo, keys u64, live, src, rows, blocks)``.  With
        ``key``, ``lo`` is found on the device first (the first row whose
        key is >= ``key``) and comes back in the same transfer."""
        if self.n == 0 or (key is None and lo >= self.n):
            z = np.zeros(0, dtype=np.int64)
            return (self.n if key is not None else lo,
                    z.view(KEY_DTYPE), z.astype(bool), z, z, z)
        if key is None:
            sl = slice(lo, min(lo + w, self.n))
            cols = [self.keys[sl], self.live[sl].long(), self.src[sl].long(),
                    self.rows[sl], self.blocks[sl]]
            head = 0
        else:
            q = torch.tensor([ops.order_of(key)], dtype=torch.int64,
                             device=self.keys.device)
            at = torch.searchsorted(self.keys, q)
            idx = (at + torch.arange(w, device=at.device)).clamp(
                max=self.n - 1)
            cols = [at, self.keys[idx], self.live[idx].long(),
                    self.src[idx].long(), self.rows[idx], self.blocks[idx]]
            head = 1
        host = torch.cat(cols).cpu().numpy()
        if head:
            lo = int(host[0])
        width = (host.size - head) // 5
        m = max(0, min(width, self.n - lo))
        seg = [host[head + c * width:head + c * width + m] for c in range(5)]
        return (lo, ops.from_order(seg[0]), seg[1].astype(bool), seg[2],
                seg[3], seg[4])

    def _scan_sweep(self, start_key: int, count: int, stats, cache
                    ) -> List[Tuple[int, bytes]]:
        if self.all_live:
            _, keys, _, src, rows, blocks = self._window(0, count, start_key)
            vals = self._materialize(src, rows, blocks, stats, cache)
            return list(zip(keys.tolist(), vals))
        sel = []
        got = 0
        w = max(2 * count, 32)
        i, keys, live, src, rows, blocks = self._window(0, w, start_key)
        while True:
            hits = np.nonzero(live)[0][:count - got]
            if hits.size:
                sel.append((keys[hits], src[hits], rows[hits], blocks[hits]))
                got += int(hits.size)
            i += w
            w *= 2   # tombstone-dense ranges: O(log deleted) windows
            if got >= count or i >= self.n:
                break
            _, keys, live, src, rows, blocks = self._window(i, w)
        if not sel:
            return []
        keys, src, rows, blocks = (np.concatenate(c) for c in zip(*sel))
        vals = self._materialize(src, rows, blocks, stats, cache)
        return list(zip(keys.tolist(), vals))

    def _scan_with_mem(self, start_key: int, count: int, mk: np.ndarray,
                       mem_items: list, base: int, stats, cache
                       ) -> List[Tuple[int, bytes]]:
        """Two-source merge: the memtable stream (``mk``, the keys from
        ``start_key`` on; ``mem_items[base + j]`` is key ``j``'s entry)
        against growing view windows, the memtable winning duplicates,
        until ``count`` live winners exist; the view winners' values then
        come back in one batch.  The reference's loop, on host copies of
        the windows, except that a truncated window merges only the
        memtable keys up to its frontier (the reference merges them all
        and defers those beyond it): the winners are the same, and a scan
        costs its window, not the memtable's size."""
        n = self.n
        acc_keys: List[int] = []
        acc_live: List[bool] = []
        acc_mem: List[int] = []    # memtable row, or -1 for a view winner
        acc_view: List[int] = []   # view index, or -1 for a memtable winner
        got = 0
        mi = 0
        w = max(2 * count, 32)
        i, vk, vlive, vsrc, vrows, vblocks = self._window(0, w, start_key)
        i0 = i
        windows = []
        while got < count and (i < n or mi < mk.size):
            if windows:        # the first window came with the search
                _, vk, vlive, vsrc, vrows, vblocks = self._window(i, w)
            windows.append((vsrc, vrows, vblocks))
            truncated = i + w < n
            mrem = mk[mi:]
            if truncated:
                # keys beyond the view window's frontier may still be
                # preceded by unseen view keys: defer them
                frontier = np.uint64(vk[-1])
                mem_consumed = int(mrem.searchsorted(frontier, side="right"))
                mrem = mrem[:mem_consumed]
            else:
                mem_consumed = int(mrem.size)
            cat = np.concatenate([mrem, vk])
            if cat.size == 0:
                break
            order = np.argsort(cat, kind="stable")  # mem first => mem wins
            cs = cat[order]
            first = np.empty(cs.size, dtype=bool)
            first[0] = True
            np.not_equal(cs[1:], cs[:-1], out=first[1:])
            widx = order[first]
            wkeys = cs[first]
            is_mem = widx < mrem.size
            liv = np.empty(widx.size, dtype=bool)
            liv[is_mem] = [mem_items[base + mi + j][2] is not None
                           for j in widx[is_mem].tolist()]
            liv[~is_mem] = vlive[widx[~is_mem] - mrem.size]
            for t in range(widx.size):
                acc_keys.append(int(wkeys[t]))
                acc_live.append(bool(liv[t]))
                if is_mem[t]:
                    acc_mem.append(base + mi + int(widx[t]))
                    acc_view.append(-1)
                else:
                    acc_mem.append(-1)
                    acc_view.append(i + int(widx[t]) - int(mrem.size))
            got += int(np.count_nonzero(liv))
            mi += mem_consumed
            i += int(vk.size)
            w *= 2   # tombstone-dense growth, the pure sweep's law
        # the first `count` live winners in key order; the view winners'
        # values materialize in one batch
        take: List[int] = []
        for t in range(len(acc_keys)):
            if acc_live[t]:
                take.append(t)
                if len(take) == count:
                    break
        view_slots = [t for t in take if acc_view[t] >= 0]
        vvals = []
        if view_slots:
            vsrc, vrows, vblocks = (np.concatenate(c) for c in zip(*windows))
            at = np.asarray([acc_view[t] - i0 for t in view_slots],
                            dtype=np.int64)
            vvals = self._materialize(vsrc[at], vrows[at], vblocks[at],
                                      stats, cache)
        by_slot = dict(zip(view_slots, vvals))
        out: List[Tuple[int, bytes]] = []
        for t in take:
            if acc_view[t] >= 0:
                out.append((acc_keys[t], by_slot[t]))
            else:
                out.append((acc_keys[t], mem_items[acc_mem[t]][2]))
        return out

    # ------------------------------------------------------------- gathering
    def _materialize(self, src: np.ndarray, rows: np.ndarray,
                     blocks: np.ndarray, stats, cache
                     ) -> List[Optional[bytes]]:
        """Values of view rows given by their host ``src``/``rows``/
        ``blocks`` (ascending view order), charging one block read per
        distinct block of each touched run, runs in ``src`` order as the
        reference charges them; one transfer brings every value."""
        n = int(src.size)
        out: List[Optional[bytes]] = [None] * n
        if n == 0:
            return out
        order = np.argsort(src, kind="stable")
        ssrc = src[order]
        cut = np.nonzero(ssrc[1:] != ssrc[:-1])[0] + 1
        starts = [0] + cut.tolist()
        ends = cut.tolist() + [n]
        wanted = []
        for a, b in zip(starts, ends):
            m = order[a:b]
            run = self.runs[int(ssrc[a])]
            if stats is not None:
                bids = blocks[m]               # ascending: view order
                if cache is None:
                    nb = 1 if bids.size <= 1 else \
                        1 + int(np.count_nonzero(bids[1:] != bids[:-1]))
                    stats.blocks_read += nb
                else:
                    if bids.size > 1:
                        keep = np.empty(bids.size, dtype=bool)
                        keep[0] = True
                        np.not_equal(bids[1:], bids[:-1], out=keep[1:])
                        bids = bids[keep]
                    cache.read_blocks(run.run_id, bids.tolist(),
                                      run.block_bytes, stats)
            wanted.append((m, run, rows[m]))
        for (m, _, _), vals in zip(wanted, fetch_values(
                [(run, rs) for _, run, rs in wanted])):
            for t, v in zip(m.tolist(), vals):
                out[t] = v
        return out
