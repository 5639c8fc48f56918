"""The Autumn LSM storage engine, with its sorted runs on the device.

Counterpart of ``repro.core.engine`` in synchronous mode: memtable + WAL on
the host, immutable sorted runs whose columns live on the store's device, a
pluggable merge policy (Garnering by default), the MVCC manifest,
Monkey/Autumn bloom allocation, and the L0 write stall.  Every read and
write is accounted in the block-I/O cost model (``types.IOStats``) exactly
as the reference accounts it, so the two can be held against each other
counter by counter.

The store's device decides how the three accelerator lanes run: on CUDA
the bloom probe, the bloom build and the compaction pair merge launch the
hand-written kernels of ``repro_torch/csrc``, and a failure raises; on the
CPU they run their plain PyTorch versions.  There is no fallback between
the two.  ``LSMStore(config)`` runs on ``cuda:0`` and raises where CUDA is
absent; only an explicit ``device="cpu"`` runs on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from .bloom import allocate_fprs, bits_for_fpr
from .manifest import Manifest, RunStorage
from .memtable import Memtable, WriteAheadLog
from .policy import CompactionTask, MergePolicy, make_policy
from .run import SortedRun, merge_runs
from .types import BLOCK_SIZE, KEY_BYTES, KEY_DTYPE, IOStats, StatsHub


@dataclasses.dataclass
class LSMConfig:
    """The reference's configuration, for what this port supports.

    The reference's ``use_pallas_bloom``/``use_pallas_merge`` switches are
    gone: the store's device decides which lane runs (kernels on CUDA,
    their plain versions on the CPU).  The fields from ``async_compaction``
    down keep the reference's names and defaults, but only their defaults
    are supported: ``LSMStore`` raises ``NotImplementedError`` for any
    other value rather than ignore it.
    """

    policy: str = "garnering"
    T: float = 2.0
    c: float = 0.8                      # Garnering scaling factor (c=1 => Leveling)
    memtable_bytes: int = 1 << 20       # 1 MiB write buffer
    base_level_bytes: int = 10 << 20    # max_bytes_for_level_base (OptimizeForSmallDb)
    l0_compaction_trigger: int = 4
    l0_stop_writes_trigger: int = 12    # rate limiter (level0_stop_writes_trigger)
    bits_per_key: float = 0.0           # 0 => no bloom filters
    bloom_allocation: str = "uniform"   # "uniform" | "monkey"
    wal_fsync_every_write: bool = False # False => fsync at flush (db default)
    block_size: int = BLOCK_SIZE
    key_bytes: int = KEY_BYTES
    # not supported by this port yet: each must stay at its default
    async_compaction: bool = False
    cache_bytes: int = 0
    pin_l0_bytes: int = 0
    shards: int = 1
    use_range_views: bool = False
    telemetry: Optional[object] = None
    faults: Optional[object] = None
    tuner: Optional[object] = None
    paranoid_checks: bool = False
    rebalance_interval_ops: int = 0


_UNSUPPORTED = ("async_compaction", "cache_bytes", "pin_l0_bytes", "shards",
                "use_range_views", "telemetry", "faults", "tuner",
                "paranoid_checks", "rebalance_interval_ops")


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda:0``, which must exist; the CPU only on request."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           f"available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class LSMStore:
    def __init__(self, config: Optional[LSMConfig] = None, device=None):
        self.config = config or LSMConfig()
        defaults = LSMConfig()
        for name in _UNSUPPORTED:
            if getattr(self.config, name) != getattr(defaults, name):
                raise NotImplementedError(
                    f"LSMConfig.{name}={getattr(self.config, name)!r} is not "
                    f"supported by repro_torch yet")
        self.device = resolve_device(device)
        self.policy: MergePolicy = make_policy(
            self.config.policy, T=self.config.T, c=self.config.c,
            l0_trigger=self.config.l0_compaction_trigger)
        self._stats = StatsHub()
        self.storage = RunStorage()
        self.manifest = Manifest(self.storage)
        self.memtable = Memtable(self.config.memtable_bytes,
                                 self.config.key_bytes,
                                 self.config.block_size)
        self.wal = WriteAheadLog()
        self._levels: List[List[SortedRun]] = [[]]
        self._max_level = 1
        self._seq = 0

    @property
    def stats(self) -> IOStats:
        """Merged view of every thread's counter shard (a fresh IOStats)."""
        return self._stats.merged()

    def close(self) -> None:
        """No-op: the synchronous store holds no workers.  Device memory is
        released with the store."""

    # ------------------------------------------------------------- writes
    def put(self, key: int, value: bytes):
        self._write(key, value)

    def delete(self, key: int):
        self._write(key, None)

    def _write(self, key: int, value: Optional[bytes]):
        st = self._stats.local()
        self._seq += 1
        self.wal.append(1 if value is None else 0, key, self._seq,
                        value or b"", st)
        if self.config.wal_fsync_every_write:
            self.wal.fsync(st)
        self.memtable.put(int(key), self._seq, value)
        if self.memtable.is_full():
            self.flush()

    # ------------------------------------------------------- batched writes
    def put_batch(self, keys, values) -> None:
        """Batched puts: semantically ``[put(k, v) for k, v in zip(...)]``.

        ``values`` is either a sequence aligned with ``keys`` or a single
        ``bytes`` broadcast to every key.  See :meth:`write_batch`.
        """
        if isinstance(values, (bytes, bytearray)):
            values = [bytes(values)] * len(keys)
        self._write_batch(zip(keys, values))

    def delete_batch(self, keys) -> None:
        """Batched deletes: semantically ``[delete(k) for k in keys]``."""
        self._write_batch((k, None) for k in keys)

    def write_batch(self, ops_: Iterable[Tuple[int, Optional[bytes]]]) -> None:
        self._write_batch(ops_)

    def _write_batch(self, ops_: Iterable[Tuple[int, Optional[bytes]]]) -> None:
        """Batched puts + deletes (value=None), the vectorized ingest lane.

        Bit-for-bit equivalent to the scalar write loop — same WAL bytes,
        same sequence numbers, same memtable state, and same flush
        boundaries, hence identical IOStats — but each chunk appends one
        vectorized WAL batch record, bulk-inserts into the memtable, and
        checks the flush trigger once.  Chunks are sized so no
        *intermediate* insert could have filled the memtable; a chunk
        degenerates to one entry only when that single entry might fill it
        — exactly where the scalar loop would flush.  With
        ``wal_fsync_every_write`` the batch fsyncs once per chunk (group
        commit), the reference's one accounting difference from the loop.
        """
        pairs = list(ops_)
        n = len(pairs)
        if n == 0:
            return
        st = self._stats.local()
        keys_l, vals_l = zip(*pairs)
        keys_l = list(map(int, keys_l))
        # one pass of column prep for the whole batch; chunks take views
        keys_arr = np.fromiter(keys_l, np.uint64, n)
        vlens = np.fromiter(
            (len(v) if v is not None else 0 for v in vals_l), np.int64, n)
        ops_arr = np.fromiter((v is None for v in vals_l), np.uint8, n)
        kb = self.memtable.key_bytes
        cum = np.cumsum(vlens + kb)
        i = 0
        while i < n:
            room = self.memtable.capacity_bytes - self.memtable.size_bytes
            base = int(cum[i - 1]) if i else 0
            j = max(i + 1,
                    int(np.searchsorted(cum, base + room, side="left")))
            chunk_vals = vals_l[i:j]
            first_seq = self._seq + 1
            self._seq += j - i
            self.wal.append_batch_cols(
                chunk_vals, keys_arr[i:j], ops_arr[i:j], vlens[i:j],
                first_seq, st)
            if self.config.wal_fsync_every_write:
                self.wal.fsync(st)
            self.memtable.put_batch(keys_l[i:j], chunk_vals, first_seq,
                                    added=int(cum[j - 1] - base))
            if self.memtable.is_full():
                self.flush()
            i = j

    def fsync_wal(self) -> None:
        """Explicit durability barrier on the active WAL."""
        self.wal.fsync(self._stats.local())

    def flush(self):
        """Freeze the memtable into an L0 run on the device (no merge —
        §3.2 L0 tiering), then compact until the policy is satisfied."""
        if len(self.memtable) == 0:
            return
        st = self._stats.local()
        # Rate limiter: too many L0 runs => write stall until compaction.
        if len(self._levels[0]) >= self.config.l0_stop_writes_trigger:
            st.write_stalls += 1
            self._compact_until_quiet()
        self.wal.fsync(st)
        run = self.memtable.to_run(self._bits_for_level(0), st, self.device)
        if len(run):
            levels = [list(lvl) for lvl in self._levels]
            levels[0].append(run)  # newest last
            self._levels = levels
            self._commit()
        # released only after the manifest commit, as the reference does
        self.memtable.clear()
        self.wal.truncate()
        self._compact_until_quiet()

    # -------------------------------------------------------- compactions
    def _plan_one(self) -> Optional[CompactionTask]:
        """Next compaction task from host metadata only (no device read)."""
        sizes = [[r.data_bytes for r in lvl] for lvl in self._levels]
        new_L, task, delayed = self.policy.plan(
            sizes, self._max_level, self.config.base_level_bytes)
        if delayed:
            self._stats.local().delayed_last_level_compactions += delayed
        self._max_level = max(self._max_level, new_L)
        return task

    def _compact_until_quiet(self):
        while True:
            task = self._plan_one()
            if task is None:
                return
            self._apply(task)

    def _apply(self, task: CompactionTask) -> None:
        """Merge the task's inputs on the device and install the result as
        a new version."""
        levels = [list(lvl) for lvl in self._levels]
        while len(levels) <= task.dst_level:
            levels.append([])
        srcs = levels[task.src_level]
        dsts = levels[task.dst_level] if task.include_dst else []
        drop_tombs = task.include_dst \
            and task.dst_level >= self._deepest_nonempty()
        merged = merge_runs(srcs + dsts, self._bits_for_level(task.dst_level),
                            self._stats.local(), drop_tombstones=drop_tombs,
                            block_size=self.config.block_size,
                            key_bytes=self.config.key_bytes)
        levels[task.src_level] = []
        if task.include_dst:
            levels[task.dst_level] = [merged] if len(merged) else []
        elif len(merged):
            levels[task.dst_level].append(merged)
        self._levels = levels
        self._max_level = max(self._max_level, task.dst_level)
        self._commit()

    def _deepest_nonempty(self) -> int:
        deepest = 1
        for i in range(len(self._levels) - 1, 0, -1):
            if self._levels[i]:
                deepest = i
                break
        return deepest

    def _commit(self):
        st = self._stats.local()
        self.manifest.commit(self._levels, self._max_level, self._seq, st)
        self.manifest.fsync(st)
        self.manifest.gc()

    # -------------------------------------------------------------- bloom
    def _bits_for_level(self, level: int) -> float:
        cfg = self.config
        if cfg.bits_per_key <= 0:
            return 0.0
        if cfg.bloom_allocation == "uniform":
            return cfg.bits_per_key
        # Monkey/Autumn allocation (Eq. 8-10): optimal FPR per level given the
        # total budget of bits_per_key * total_entries.
        counts = [sum(len(r) for r in lvl) for lvl in self._levels]
        while len(counts) <= level:
            counts.append(0)
        total = sum(counts)
        if total == 0:
            return cfg.bits_per_key
        fprs = allocate_fprs(counts, cfg.bits_per_key * total)
        return bits_for_fpr(float(fprs[level])) if counts[level] > 0 else cfg.bits_per_key

    # -------------------------------------------------------------- reads
    def _runs_newest_first(self):
        for r in reversed(self._levels[0]):
            yield r
        for lvl in self._levels[1:]:
            for r in reversed(lvl):
                yield r

    def get(self, key: int) -> Optional[bytes]:
        """Point read: ``multi_get([key])[0]``, with the same accounting as
        the reference's scalar ``get``."""
        return self.multi_get([key])[0]

    def multi_get(self, keys: Sequence[int]) -> List[Optional[bytes]]:
        """Batched point reads: semantically ``[get(k) for k in keys]``.

        Keys missing from the memtable go to the device once; then, run by
        run, newest first, the keys still pending are probed with the bloom
        kernel and located with one searchsorted.  Aggregate IOStats
        accounting is identical to the reference's.
        """
        st = self._stats.local()
        keys_arr = np.asarray(list(keys), dtype=KEY_DTYPE)
        n = int(keys_arr.size)
        st.point_reads += n
        results: List[Optional[bytes]] = [None] * n
        if n == 0:
            return results
        pending = np.arange(n, dtype=np.int64)
        mt = self.memtable
        if len(mt):
            keep = []
            for j, k in enumerate(keys_arr.tolist()):
                hit = mt.get(k)
                if hit is not None:
                    results[j] = hit[1]   # value, or None: tombstone
                else:
                    keep.append(j)
            pending = np.asarray(keep, dtype=np.int64)
        if pending.size == 0:
            return results
        q = ops.keys_to_device(keys_arr[pending], self.device)
        use_bloom = self.config.bits_per_key > 0
        for run in self._runs_newest_first():
            if pending.size == 0:
                break
            if len(run) == 0:
                continue
            st.runs_touched_point += int(pending.size)
            found, values, q = run.point_get_batch(q, st, use_bloom)
            if found.any():
                for p in np.nonzero(found)[0].tolist():
                    results[int(pending[p])] = values[p]
                pending = pending[~found]
        return results

    # -------------------------------------------------------- inspection
    def level_summary(self) -> List[dict]:
        out = []
        for i, lvl in enumerate(self._levels):
            cap = (self.policy.capacity(i, self._max_level,
                                        self.config.base_level_bytes)
                   if i >= 1 else None)
            out.append(dict(level=i, runs=len(lvl),
                            entries=sum(len(r) for r in lvl),
                            bytes=sum(r.data_bytes for r in lvl),
                            capacity=cap))
        return out

    @property
    def num_levels_in_use(self) -> int:
        return self._max_level

    @property
    def total_entries(self) -> int:
        return sum(len(r) for lvl in self._levels for r in lvl) \
            + len(self.memtable)
