"""State carried across: a store's tree as plain numpy columns and back.

``store_from_columns`` builds a store on a device holding exactly the tree
described by numpy columns (for example the columns of another
implementation's store), rebuilding every run's block layout, checksums and
bloom filter with this package's own code.  ``columns_of`` returns a
store's tree as numpy columns, including the derived filter bits, fences
and block checksums, so two stores can be compared array by array.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from .engine import LSMConfig, LSMStore
from .run import SortedRun, build_run
from .types import IOStats


def store_from_columns(config: LSMConfig, levels: Sequence[Sequence[tuple]],
                       memtable_items: Iterable[Tuple[int, int, Optional[bytes]]]
                       = (), seq: int = 0, device=None,
                       max_level: Optional[int] = None) -> LSMStore:
    """A store on ``device`` holding the given tree.

    ``levels[i]`` lists level i's runs, oldest first, each a tuple
    ``(keys, seqs, vlens, vals)`` of numpy arrays (uint64 keys, strictly
    increasing; uint64 seqs; int32 vlens with -1 for tombstones; (n, Vmax)
    uint8 values), optionally followed by the bloom geometry
    ``(m_bits, k)``; without it the filter is sized from
    ``config.bits_per_key``.  ``memtable_items`` are ``(key, seq, value)``
    triples (value None for a delete), logged to the WAL and the memtable
    in order.  ``seq`` is the last sequence number handed out; ``max_level``
    defaults to the deepest level given (at least 1).  The new store's
    IOStats start at zero.
    """
    store = LSMStore(config, device)
    dev = store.device
    built: List[List[SortedRun]] = []
    for lvl in levels:
        runs = []
        for cols in lvl:
            keys, seqs, vlens, vals = (np.asarray(c) for c in cols[:4])
            vals = np.ascontiguousarray(vals, dtype=np.uint8)
            if vals.ndim == 1:
                vals = vals.reshape(keys.size, -1) if keys.size \
                    else vals.reshape(0, 0)
            runs.append(build_run(
                ops.keys_to_device(keys, dev),
                torch.from_numpy(np.ascontiguousarray(
                    seqs, dtype=np.uint64).view(np.int64)).to(dev),
                torch.from_numpy(np.ascontiguousarray(
                    vlens, dtype=np.int32)).to(dev),
                torch.from_numpy(vals).to(dev),
                bits_per_key=config.bits_per_key, assume_unique_sorted=True,
                block_size=config.block_size, key_bytes=config.key_bytes,
                bloom_geometry=tuple(cols[4]) if len(cols) > 4 else None))
        built.append(runs)
    store._levels = built or [[]]
    store._max_level = max(1, len(built) - 1) if max_level is None \
        else max_level
    store._seq = seq
    scratch = IOStats()     # carrying state in is not the new store's work
    for key, s, value in memtable_items:
        store.wal.append(1 if value is None else 0, key, s, value or b"",
                         scratch)
        store.memtable.put(int(key), s, value)
    store.manifest.commit(store._levels, store._max_level, seq, scratch)
    store.manifest.fsync(scratch)
    return store


def _run_columns(run: SortedRun) -> dict:
    def host(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy()
    return dict(keys=ops.keys_from_device(run.keys),
                seqs=host(run.seqs).view(np.uint64),
                vlens=host(run.vlens), vals=host(run.vals),
                bloom_bits=run.bloom.bits_numpy(),
                bloom_m_bits=run.bloom.m_bits, bloom_k=run.bloom.k,
                fence_keys=ops.keys_from_device(run.fence_keys),
                block_of=host(run.block_of),
                block_crcs=host(run.block_crcs).astype(np.uint32))


def columns_of(store: LSMStore) -> dict:
    """The store's tree as numpy columns.

    Returns ``{"levels", "memtable", "seq", "max_level"}``: ``levels[i]``
    lists level i's runs as dicts of ``keys``, ``seqs``, ``vlens``,
    ``vals``, ``bloom_bits`` (uint32 words), ``bloom_m_bits``,
    ``bloom_k``, ``fence_keys``, ``block_of`` and ``block_crcs`` (uint32);
    ``memtable`` lists ``(key, seq, value)`` in insertion order.
    """
    mem = [(k, s, v) for k, (s, v) in store.memtable._data.items()]
    return dict(levels=[[_run_columns(r) for r in lvl]
                        for lvl in store._levels],
                memtable=mem, seq=store._seq, max_level=store._max_level)


__all__ = ["store_from_columns", "columns_of"]
