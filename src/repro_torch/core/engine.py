"""The Autumn LSM storage engine, with its sorted runs on the device.

Counterpart of ``repro.core.engine``: memtable + WAL on the host, immutable
sorted runs whose columns live on the store's device, a pluggable merge
policy (Garnering by default), the MVCC manifest with refcounted
snapshots, Monkey/Autumn bloom allocation and the L0 write stall.  Reads
are point reads (``get``/``multi_get``) and range reads (``seek``, ``scan``
and ``iterator`` over the merging iterator, with ``scan_scalar`` as their
oracle), each on the current state or a snapshot.  Every read and write is
accounted in the block-I/O cost model (``types.IOStats``) exactly as the
reference accounts it, so the two can be held against each other counter
by counter.

Durability is the reference's in-memory model: the runs on the device play
the part of its ``RunStorage``, and ``crash()`` drops volatile state only
(the WAL past its fsync watermark, manifest edits past theirs, memtables,
cache contents); ``recover()`` replays the log and scrubs every run.

With ``async_compaction`` the flush/compaction pipeline moves onto a
background ``CompactionScheduler``: full memtables rotate into a readable
immutable queue, workers install versions in the synchronous order (so the
synchronous store stays the bit-for-bit oracle after ``wait_for_quiesce``),
and write pressure is governed by ``slowdown_trigger``/``stall_trigger``.
One thread writes; readers are lock-free on copy-on-write level and queue
references.  ``cache_bytes``/``pin_l0_bytes`` attach the reference's block
cache and pinned L0 (``core.cache``), an accounting model: the runs stay on
the device whatever it decides.

The reference's store subsystems ride on the same tree:

* ``use_range_views``: a cross-run range view (``core.view``) over the
  device runs, rebuilt off the write path (on the worker in async mode,
  by the first read in sync mode), serves ``scan`` and ``seek``; a stale
  view falls back to the merging iterator.  Freshness is the identity of
  the published ``_levels`` list, which every install replaces.
* ``faults`` (a ``FaultInjector``) fires at the durability and I/O sites
  (``wal_append``, ``wal_fsync``, ``flush_write``, ``compaction_merge``,
  ``manifest_fsync``, ``block_read`` and the two migration sites) and
  dirties ``crash()``; ``paranoid_checks`` verifies every block a point
  read or a seek touches, a point-read batch's blocks in one device pass.
* ``telemetry`` records per-op latency histograms and lifecycle events,
  and cuts each call into the phases of ``core.telemetry.PHASES``; it
  adds no device synchronization.
* ``tuner`` (an ``OnlineTuner``) hill-climbs ``c``, ``T``, the cache/pin
  split and ``slowdown_trigger`` from the telemetry, applying changes only
  at compaction-chain or quiesce boundaries (``apply_tuning``).
Each is off by default, and then costs one ``is None`` test per site.

The store's device decides how the three accelerator lanes run: on CUDA
the bloom probe, the bloom build and the compaction pair merge launch the
hand-written kernels of ``repro_torch/csrc``, and a failure raises; on the
CPU they run their plain PyTorch versions.  There is no fallback between
the two.  ``LSMStore(config)`` runs on ``cuda:0`` and raises where CUDA is
absent; only an explicit ``device="cpu"`` runs on the CPU.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from .bloom import allocate_fprs, bits_for_fpr
from .cache import BlockCache, PinnedLevelManager
from .faults import CorruptionError, StoreDegradedError
from .iterator import MergingIterator, combined_mem_items
from .manifest import Manifest, RunStorage, Version
from .memtable import ImmutableMemtable, Memtable, WriteAheadLog
from .policy import CompactionTask, MergePolicy, make_policy
from .run import SortedRun, build_run, merge_runs, seek_batch
from .scheduler import CompactJob, CompactionScheduler, FlushJob
from .telemetry import ACTIVE, Telemetry
from .tuner import OnlineTuner, TunerStep
from .types import (BLOCK_SIZE, KEY_BYTES, KEY_DTYPE, TOMBSTONE_LEN, IOStats,
                    StatsHub)
from .view import RangeView, build_range_view

# Soft write-pressure delay: sleep(0) yields the GIL and the CPU slice to
# the compaction workers, the point of the soft trigger (the reference's).
_SLOWDOWN_SLEEP_S = 0.0


@dataclasses.dataclass
class LSMConfig:
    """The reference's configuration, for what this port supports.

    The reference's ``use_pallas_bloom``/``use_pallas_merge`` switches are
    gone: the store's device decides which lane runs (kernels on CUDA,
    their plain versions on the CPU).  The sharded facade's fields
    (``shards``, ``shard_splitters``, ``rebalance_interval_ops``,
    ``rebalance_ratio``) are read by ``make_store`` and
    ``core.sharded.ShardedLSMStore``; a plain ``LSMStore`` ignores them,
    as the reference's does.
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
    async_compaction: bool = False      # flush + compaction on background
                                        # workers; False is the synchronous
                                        # store, the differential oracle
    cache_bytes: int = 0                # block cache budget; 0 => no cache
    pin_l0_bytes: int = 0               # resident-L0 budget (the paper's
                                        # "bounded space of DRAM"); 0 => none
    cache_policy: str = "clock"         # "clock" (second chance) | "lru"
    compaction_workers: int = 1         # background worker threads
    slowdown_trigger: int = 64          # queued L0 runs + immutable memtables
                                        # beyond which each rotation yields
                                        # to the workers; <=0 disables
    stall_trigger: int = 256            # ... beyond which rotation blocks
                                        # until the backlog drains below it
                                        # or the workers go idle; <=0 disables
    bg_max_retries: int = 2             # background job retries (bounded
                                        # backoff) before the store degrades
                                        # read-only
    use_range_views: bool = False       # cross-run range views serve scan
                                        # and seek (core.view); the merging
                                        # iterator stays the stale-view
                                        # fallback and the oracle
    telemetry: Optional[Telemetry] = None
                                        # latency histograms + event trace;
                                        # None: one `is None` test per site
    paranoid_checks: bool = False       # verify the checksum of every block
                                        # a point read or seek touches;
                                        # recovery scrubs regardless
    faults: Optional[object] = None     # a FaultInjector: injected failures
                                        # at the durability/IO sites
    tuner: Optional[OnlineTuner] = None
                                        # online knob tuning at boundaries
                                        # (needs telemetry to sense)
    # the sharded facade's (core.sharded): key-range shards, their
    # splitters (None: uniform over the u64 space), and load-driven
    # rebalancing (0 ops: off; max/mean share that triggers it)
    shards: int = 1
    shard_splitters: Optional[Tuple[int, ...]] = None
    rebalance_interval_ops: int = 0
    rebalance_ratio: float = 2.0


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda:0``, which must exist; the CPU only on request.
    A CUDA device without an index gets the current one (the scheduler's
    worker threads set it as theirs)."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           f"available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _first_live_mem_key(mems: Sequence[Memtable], key: int
                        ) -> Optional[int]:
    """The smallest live key ``>= key`` over the memtables: each one's
    cached sorted copy is searched once, then walked past tombstones."""
    best = None
    for mt in mems:
        if len(mt) == 0:
            continue
        keys, items = mt.sorted_entries()
        i = int(np.searchsorted(keys, np.uint64(key)))
        while i < len(items) and items[i][2] is None:
            i += 1
        if i < len(items) and (best is None or items[i][0] < best):
            best = items[i][0]
    return best


class _Off:
    """A store call's context with telemetry off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def done(self, **fields) -> None:
        pass


_OFF = _Off()
# calls whose CorruptionError the trace reports, as the reference's do
_REPORTS_CORRUPTION = ("get", "multi_get")


class _Call:
    """A store call with telemetry on: on entry it opens ``op`` at its
    phase ``first`` (and emits ``<event>_start`` with ``fields``); on exit,
    however the call ends, it closes the phases.  A call that returns
    records its latency in the ``op`` histogram and emits ``<event>_end``
    with the fields given to :meth:`done`, ``t0`` and ``dur_ns``."""

    __slots__ = ("tel", "op", "first", "event", "fields", "ph", "t0", "tok")

    def __init__(self, tel: Telemetry, op: str, first: str,
                 event: Optional[str], fields: dict):
        self.tel, self.op, self.first = tel, op, first
        self.event, self.fields = event, fields

    def __enter__(self):
        self.ph, self.t0 = self.tel.enter(self.op, self.first)
        if self.event is not None:
            self.tok = self.tel.emit(self.event + "_start", **self.fields)
        return self

    def done(self, **fields) -> None:
        """The fields of the ``<event>_end`` event."""
        self.fields = fields

    def __exit__(self, exc_type, exc, tb):
        tel = self.tel
        dur = self.ph.exit() - self.t0
        if exc_type is None:
            tel.record(self.op, dur)
            if self.event is not None:
                tel.emit(self.event + "_end", token=self.tok, **self.fields,
                         t0=self.t0, dur_ns=dur)
        elif issubclass(exc_type, CorruptionError) \
                and self.op in _REPORTS_CORRUPTION:
            tel.emit("corruption", run_id=exc.run_id, block_id=exc.block_id,
                     where=self.op)
        return False


def _min_key(a: Optional[int], b: Optional[int]) -> Optional[int]:
    return b if a is None else a if b is None else min(a, b)


class LSMStore:
    def __init__(self, config: Optional[LSMConfig] = None, device=None, *,
                 scheduler_budget=None, scheduler_offset: int = 0):
        # scheduler_budget / scheduler_offset: the sharded facade's wiring
        # (one worker budget shared by every shard's scheduler, and a core
        # offset per shard); a plain store leaves both at their defaults.
        self.config = config or LSMConfig()
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
        # Set to the root failure when the background pipeline exhausts its
        # retry budget: writes then raise StoreDegradedError while reads
        # keep serving the committed tree.
        self._degraded: Optional[BaseException] = None
        # the pipeline failure was raised to a caller once already, so a
        # later close() cleans up without raising it again
        self._bg_failure_surfaced = False
        # Rotated memtables queue here (oldest first) and stay readable
        # until their background flush installs; the maintenance lock
        # serializes the gc + retain + repin triplet between worker
        # installs and snapshot releases.
        self._imm: List[ImmutableMemtable] = []
        self._maint_lock = threading.Lock()
        # Online tuning: the tuner is cached on the store so the per-write
        # check is one `is None` test; bind() makes this store its owner.
        self._tuner = self.config.tuner
        self._tune_ops = 0
        self._tune_armed = False
        if self._tuner is not None:
            self._tuner.bind(self)
        # The range view indexes one published ``_levels`` list object;
        # ``_view_cache`` keeps per-level columns by run-id tuple, so a
        # rebuild re-merges only the levels whose runs changed.
        self._range_view: Optional[RangeView] = None
        self._view_cache: dict = {}
        self._scheduler: Optional[CompactionScheduler] = None
        if self.config.async_compaction:
            self._scheduler = CompactionScheduler(
                self, self.config.compaction_workers,
                budget=scheduler_budget, worker_offset=scheduler_offset)
        self.block_cache: Optional[BlockCache] = None
        self.pinned_l0: Optional[PinnedLevelManager] = None
        if self.config.cache_bytes > 0 or self.config.pin_l0_bytes > 0:
            self.configure_cache(self.config.cache_bytes,
                                 self.config.pin_l0_bytes,
                                 self.config.cache_policy)

    @property
    def stats(self) -> IOStats:
        """Merged view of every thread's counter shard (a fresh IOStats)."""
        return self._stats.merged()

    @property
    def telemetry(self) -> Optional[Telemetry]:
        return self.config.telemetry

    # ------------------------------------------------------ degraded mode
    @property
    def degraded(self) -> bool:
        """True when persistent background failure turned the store
        read-only; cleared by ``crash()`` + ``recover()``."""
        return self._degraded is not None

    def _enter_degraded(self, exc: BaseException) -> None:
        """Turn read-only (idempotent; the scheduler worker calls it when a
        job exhausts its retry budget)."""
        if self._degraded is None:
            self._degraded = exc
            tel = self.config.telemetry
            if tel is not None:
                tel.emit("degraded", error=repr(exc))

    def _raise_degraded(self) -> None:
        raise StoreDegradedError(
            "store is read-only after persistent background failure; "
            "reads keep serving — crash()+recover() to restore writes"
        ) from self._degraded

    def _call(self, op: str, first: str, event: Optional[str] = None,
              **fields):
        """The context of one instrumented call (``with``): its latency in
        the ``op`` histogram, its phases from ``first`` on, and for an
        ``event`` its start and end events (see :class:`_Call`); with
        telemetry off, one ``is None`` test and a context that does
        nothing."""
        tel = self.config.telemetry
        if tel is None:
            return _OFF
        return _Call(tel, op, first, event, fields)

    def _wal_fsync(self, st: IOStats) -> None:
        """fsync the active WAL: the one helper every durability point
        uses, so the ``wal_fsync`` fault site and histogram see them all."""
        f = self.config.faults
        if f is not None:
            f.check("wal_fsync")
        tel = self.config.telemetry
        if tel is None:
            self.wal.fsync(st)
            return
        t0 = time.perf_counter_ns()
        self.wal.fsync(st)
        tel.record("wal_fsync", time.perf_counter_ns() - t0)

    # ------------------------------------------------------------- cache
    def configure_cache(self, cache_bytes: int, pin_l0_bytes: int = 0,
                        policy: Optional[str] = None) -> None:
        """(Re)build the block cache on a live store: contents are dropped
        and the current L0 is repinned (charged) within the new budget.
        Zeros detach the cache and revert every read to raw block
        accounting; ``policy=None`` keeps the configured ``cache_policy``."""
        self.config.cache_bytes = int(cache_bytes)
        self.config.pin_l0_bytes = int(pin_l0_bytes)
        if policy is not None:
            self.config.cache_policy = policy
        if cache_bytes <= 0 and pin_l0_bytes <= 0:
            self.block_cache = None
            self.pinned_l0 = None
            return
        cache = BlockCache(cache_bytes, self.config.cache_policy)
        cache.telemetry = self.config.telemetry
        self.attach_cache(cache, pin_l0_bytes)

    def attach_cache(self, cache, pin_l0_bytes: int = 0) -> None:
        """Attach an externally owned cache (anything speaking the
        ``BlockCache`` read/retain/pin protocol) and pin the current L0
        within ``pin_l0_bytes``, charged as real reads."""
        self.block_cache = cache
        self.pinned_l0 = PinnedLevelManager(cache, pin_l0_bytes)
        with self._maint_lock:
            self.pinned_l0.repin(self._levels[0], stats=self._stats.local())

    def cache_summary(self) -> dict:
        """Memory-subsystem health: hit rate, charged bytes, residency."""
        if self.block_cache is None:
            return dict(enabled=False, hit_rate=0.0, hits=0, misses=0,
                        evictions=0, charged_bytes=0, pinned_bytes=0,
                        pinned_l0_runs=0)
        c = self.block_cache
        return dict(enabled=True, hit_rate=c.hit_rate(), hits=c.hits,
                    misses=c.misses, evictions=c.evictions,
                    charged_bytes=c.charged_bytes,
                    pinned_bytes=c.pinned_bytes,
                    pinned_l0_runs=len(self.pinned_l0.pinned_run_ids))

    # ------------------------------------------------------------- writes
    def put(self, key: int, value: bytes):
        with self._call("put", "wal_append"):
            self._write(key, value)
        if self._tuner is not None:
            self._maybe_tune(1)

    def delete(self, key: int):
        with self._call("put", "wal_append"):
            self._write(key, None)
        if self._tuner is not None:
            self._maybe_tune(1)

    def _write(self, key: int, value: Optional[bytes]):
        if self._degraded is not None:
            self._raise_degraded()
        f = self.config.faults
        if f is not None:
            f.check("wal_append")  # before any mutation: a failed append
                                   # leaves no partial record anywhere
        st = self._stats.local()
        self._seq += 1
        self.wal.append(1 if value is None else 0, key, self._seq,
                        value or b"", st)
        if self.config.wal_fsync_every_write:
            self._wal_fsync(st)
        ph = ACTIVE.phases
        if ph is not None:
            ph.next("memtable_insert")
        self.memtable.put(int(key), self._seq, value)
        if self.memtable.is_full():
            self._on_memtable_full()

    # ------------------------------------------------------- batched writes
    def put_batch(self, keys, values) -> None:
        """Batched puts: semantically ``[put(k, v) for k, v in zip(...)]``.

        ``values`` is either a sequence aligned with ``keys`` or a single
        ``bytes`` broadcast to every key.  See :meth:`write_batch`.
        """
        if isinstance(values, (bytes, bytearray)):
            values = [bytes(values)] * len(keys)
        with self._call("put_batch", "columns"):
            self._write_batch(zip(keys, values))
        if self._tuner is not None:
            self._maybe_tune(len(keys))

    def delete_batch(self, keys) -> None:
        """Batched deletes: semantically ``[delete(k) for k in keys]``."""
        self.write_batch((k, None) for k in keys)

    def write_batch(self, ops_: Iterable[Tuple[int, Optional[bytes]]]) -> None:
        with self._call("write_batch", "columns"):
            self._write_batch(ops_)
        if self._tuner is not None:
            self._maybe_tune(1)

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
        ph = ACTIVE.phases
        pairs = list(ops_)
        n = len(pairs)
        if n == 0:
            return
        if self._degraded is not None:
            self._raise_degraded()
        faults = self.config.faults
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
            if ph is not None:
                ph.next("columns")
            room = self.memtable.capacity_bytes - self.memtable.size_bytes
            base = int(cum[i - 1]) if i else 0
            j = max(i + 1,
                    int(np.searchsorted(cum, base + room, side="left")))
            chunk_vals = vals_l[i:j]
            if faults is not None:
                faults.check("wal_append")  # per chunk, before mutation
            first_seq = self._seq + 1
            self._seq += j - i
            if ph is not None:
                ph.next("wal_append")
            self.wal.append_batch_cols(
                chunk_vals, keys_arr[i:j], ops_arr[i:j], vlens[i:j],
                first_seq, st)
            if self.config.wal_fsync_every_write:
                self._wal_fsync(st)
            if ph is not None:
                ph.next("memtable_insert")
            self.memtable.put_batch(keys_l[i:j], chunk_vals, first_seq,
                                    added=int(cum[j - 1] - base))
            if self.memtable.is_full():
                self._on_memtable_full()
            i = j

    def fsync_wal(self) -> None:
        """Explicit durability barrier on the active WAL."""
        self._wal_fsync(self._stats.local())

    def _on_memtable_full(self):
        """Full write buffer: flush inline (sync) or rotate and enqueue
        (async), at exactly the point the synchronous store flushes — the
        root of the async-vs-sync differential guarantee."""
        if self._scheduler is None:
            self.flush()
        else:
            self._rotate()

    def flush(self):
        """Freeze the memtable into an L0 run on the device (no merge —
        §3.2 L0 tiering), then compact until the policy is satisfied.

        Async mode: the call only rotates the memtable into the immutable
        queue; the run build, install and compactions run on the
        scheduler's workers (``wait_for_quiesce`` waits for them)."""
        if self._scheduler is not None:
            self._rotate()
            return
        if len(self.memtable) == 0:
            return
        st = self._stats.local()
        # Rate limiter: too many L0 runs => write stall until compaction.
        if len(self._levels[0]) >= self.config.l0_stop_writes_trigger:
            st.write_stalls += 1
            self._compact_until_quiet()
        with self._call("flush", "wal_fsync", "flush",
                        entries=len(self.memtable)) as call:
            self._wal_fsync(st)
            f = self.config.faults
            if f is not None:
                f.check("flush_write")
            run = self.memtable.to_run(self._bits_for_level(0), st,
                                       self.device)
            ph = ACTIVE.phases
            if ph is not None:
                ph.next("install")
            if len(run):
                levels = [list(lvl) for lvl in self._levels]
                levels[0].append(run)  # newest last
                self._levels = levels
                self._commit()
            # released only after the manifest commit, as the reference
            # does: a failed manifest fsync leaves the records in the
            # fsynced WAL
            self.memtable.clear()
            self.wal.truncate()
            call.done(entries=len(run))
        self._compact_until_quiet()

    # ------------------------------------------------- async rotation path
    def _rotate(self):
        """Foreground half of a pipelined flush: write-pressure control,
        the WAL fsync (the rotated segment's durability point), the freeze
        of the memtable + WAL pair into the readable immutable queue, and
        the submission of its :class:`FlushJob`."""
        if len(self.memtable) == 0:
            return
        self._throttle()
        self._wal_fsync(self._stats.local())
        imm = ImmutableMemtable(self.memtable, self.wal)
        with self._scheduler.lock:
            self._imm = self._imm + [imm]   # copy-on-write: readers hold refs
        self.memtable = Memtable(self.config.memtable_bytes,
                                 self.config.key_bytes,
                                 self.config.block_size)
        self.wal = WriteAheadLog()
        try:
            self._scheduler.submit(FlushJob(imm))
        except RuntimeError as exc:
            # Raced the worker poisoning the pipeline: the write is already
            # durable in the rotated segment and readable from the queue, so
            # it is accepted; the next write meets the degraded flag.  A
            # cause-less RuntimeError (scheduler shut down) propagates.
            if exc.__cause__ is None:
                raise
            self._enter_degraded(exc.__cause__)

    def _throttle(self):
        """LevelDB-style write-pressure control at rotation points.
        Pressure = queued L0 runs + immutable memtables.  At
        ``slowdown_trigger`` a rotation yields its CPU slice to the
        workers; at ``stall_trigger`` it blocks until the backlog drains
        below the trigger or the scheduler goes idle.  Both charge
        ``IOStats.stall_ns``."""
        cfg = self.config
        st = self._stats.local()
        tel = cfg.telemetry
        depth = len(self._imm) + len(self._levels[0])
        t0 = time.perf_counter_ns()
        if cfg.stall_trigger > 0 and depth >= cfg.stall_trigger:
            st.write_stalls += 1
            tok = tel.emit("stall_enter", depth=depth) if tel is not None \
                else 0
            sched = self._scheduler
            sched.wait_until(
                lambda: sched.idle()
                or (len(self._imm) + len(self._levels[0]))
                < cfg.stall_trigger)
            dt = time.perf_counter_ns() - t0
            if tel is not None:
                tel.record("stall", dt)
                tel.emit("stall_exit", token=tok, depth=depth,
                         t0=t0, dur_ns=dt)
        elif cfg.slowdown_trigger > 0 and depth >= cfg.slowdown_trigger:
            st.write_slowdowns += 1
            time.sleep(_SLOWDOWN_SLEEP_S)
            dt = time.perf_counter_ns() - t0
            if tel is not None:
                tel.record("stall", dt)
                tel.emit("slowdown", depth=depth, t0=t0, dur_ns=dt)
        else:
            return
        st.stall_ns += time.perf_counter_ns() - t0

    def wait_for_quiesce(self, timeout: Optional[float] = None) -> bool:
        """Block until all background flush/compaction work has drained.
        After a True return the tree equals the synchronous store's for the
        same op sequence; the active memtable is not flushed (``flush()``
        rotates it first).  Sync mode returns True at once; a dead pipeline
        raises."""
        if self._scheduler is None:
            return True
        try:
            ok = self._scheduler.wait_for_quiesce(timeout)
        except RuntimeError:
            self._bg_failure_surfaced = True
            raise
        if ok and self._tuner is not None and self._tune_armed:
            self.apply_tuning()    # a drained pipeline is a tuning boundary
        return ok

    # ------------------------------------------------------- online tuning
    def _maybe_tune(self, k: int = 1) -> None:
        """Write-boundary tuning trigger: count ops; once ``interval_ops``
        elapse, arm, and tick at the first compaction-chain boundary (at
        once in sync mode, at the next idle check in async mode)."""
        tun = self._tuner
        self._tune_ops += k
        if not self._tune_armed:
            if self._tune_ops < tun.interval_ops:
                return
            self._tune_armed = True
        sched = self._scheduler
        if sched is not None and not sched.idle():
            return
        self._tune_ops = 0
        self._tune_armed = False
        tun.tick(self)

    def apply_tuning(self) -> Optional[TunerStep]:
        """One tuner tick now iff the store is at a boundary (the scheduler
        idle; a synchronous store always is, between ops): the single
        actuation point.  Returns the decision, or None when not at a
        boundary, without a bound tuner, or on a too-small window."""
        tun = self._tuner
        if tun is None:
            return None
        if self._scheduler is not None and not self._scheduler.idle():
            return None
        self._tune_ops = 0
        self._tune_armed = False
        return tun.tick(self)

    def retune_policy(self, *, T: Optional[float] = None,
                      c: Optional[float] = None) -> None:
        """Swap in a same-family policy with new knobs (tuner actuator):
        only future ``plan()`` calls see the new capacities; the installed
        tree is never rewritten."""
        cfg = self.config
        if T is not None:
            cfg.T = float(T)
        if c is not None:
            cfg.c = float(c)
        self.policy = self.policy.retuned(T=cfg.T, c=cfg.c)

    def set_cache_split(self, pin_l0_bytes: int) -> None:
        """Move budget between the block cache and the pinned L0 at constant
        total memory (tuner actuator): the cache resizes in place and the
        L0 repins under the new budget (charged)."""
        if self.block_cache is None or self.pinned_l0 is None:
            return
        cfg = self.config
        total = cfg.cache_bytes + cfg.pin_l0_bytes
        pin = max(0, min(int(pin_l0_bytes), total))
        cfg.pin_l0_bytes = pin
        cfg.cache_bytes = total - pin
        self.block_cache.resize(cfg.cache_bytes)
        self.pinned_l0.pin_l0_bytes = pin
        with self._maint_lock:
            self.pinned_l0.repin(self._levels[0], stats=self._stats.local())

    def compact_to_shape(self, max_merges: int = 64) -> int:
        """Maintenance compaction: fold the tree to the policy's shape.

        A retune that widens the capacity schedule leaves every level of
        the old, deeper shape under its new cap, so no compaction would
        ever fold it.  This merges the shallowest populated deep level into
        the next until the populated-level count matches
        ``policy.predicted_levels`` for the data size, then lets the planner
        settle (L0 keeps its own trigger).  Call at a quiesce boundary
        (returns 0 when the scheduler is busy).  Returns the merges done."""
        if self._scheduler is not None and not self._scheduler.idle():
            return 0
        self._compact_until_quiet()     # settle organic triggers first
        pred = getattr(self.policy, "predicted_levels", None)
        merges = 0
        while merges < max_merges:
            deep = [i for i, lvl in enumerate(self._levels) if lvl and i >= 1]
            if len(deep) < 2 or pred is None:
                break
            total = sum(r.data_bytes
                        for lvl in self._levels for r in lvl)
            target = max(1, int(math.ceil(
                pred(total, self.config.base_level_bytes))))
            if len(deep) <= target:
                break
            src, dst = deep[0], deep[1]
            task = CompactionTask(
                src, dst, True, "reshape",
                src_run_ids=tuple(r.run_id for r in self._levels[src]))
            if not self._apply(task):
                break       # tree changed under us: stop, planner recovers
            merges += 1
        if merges:
            # re-settle, then drop the level-count watermark to the new
            # depth so future capacity schedules price the reshaped tree
            self._compact_until_quiet()
            self._max_level = max(
                (i for i, lvl in enumerate(self._levels) if lvl), default=1)
            tel = self.config.telemetry
            if tel is not None:
                tel.emit("reshape", merges=merges,
                         levels=len([lv for lv in self._levels if lv]))
        return merges

    def _tuning_actuators(self):
        """Knob accessors the tuner climbs, ``{name: (get, set)}``: ``c``
        and ``T`` always, ``slowdown_trigger`` with the async pressure path,
        ``pin_frac`` with a cache and a pinned L0."""
        acts = {
            "c": (lambda: self.policy.c,
                  lambda v: self.retune_policy(c=v)),
            "T": (lambda: self.policy.T,
                  lambda v: self.retune_policy(T=v)),
        }
        if self._scheduler is not None:
            acts["slowdown_trigger"] = (
                lambda: self.config.slowdown_trigger,
                lambda v: setattr(self.config, "slowdown_trigger", int(v)))
        if self.block_cache is not None and self.pinned_l0 is not None:
            acts["pin_frac"] = (self._get_pin_frac, self._set_pin_frac)
        return acts

    def _get_pin_frac(self) -> float:
        total = self.config.cache_bytes + self.config.pin_l0_bytes
        return self.config.pin_l0_bytes / total if total else 0.0

    def _set_pin_frac(self, v: float) -> None:
        total = self.config.cache_bytes + self.config.pin_l0_bytes
        self.set_cache_split(int(total * float(v)))

    def close(self) -> None:
        """Drain and stop the background workers (async mode); the store
        stays usable on the synchronous path, which is state-equivalent.
        On a failed pipeline the first surfacing raises the failure, after
        the full cleanup (worker shutdown, stranded rotations folded back
        into the active WAL and memtable); later calls are no-ops."""
        sched = self._scheduler
        if sched is None:
            return
        surfaced = self._bg_failure_surfaced
        try:
            sched.wait_for_quiesce()   # raises on a dead pipeline
        except BaseException:
            self._bg_failure_surfaced = True
            if not surfaced:
                raise                  # finally still completes the cleanup
        finally:
            sched.shutdown()
            self._scheduler = None
            if self._imm:
                self._consolidate_imm_wal()
            self._degraded = None

    def _consolidate_imm_wal(self) -> int:
        """Fold the immutable queue's WAL segments into one active log and
        rebuild the memtable from it.

        Segment concatenation (oldest first, active last) is record
        concatenation, so replay order equals write order; the rotated
        segments were fsynced at rotation, so the synced watermark is their
        total length plus the active WAL's own.  Every record is replayed,
        the unsynced tail included (it is live process state).  Returns the
        number of records replayed."""
        wal = WriteAheadLog()
        buf = bytearray()
        synced = 0
        for imm in self._imm:
            buf += imm.wal._buf
            synced += len(imm.wal._buf)       # fully fsynced at rotation
        synced += self.wal._synced_upto
        buf += self.wal._buf
        wal._buf = buf
        wal._synced_upto = synced
        self.wal = wal
        self._imm = []
        self.memtable = Memtable(self.config.memtable_bytes,
                                 self.config.key_bytes,
                                 self.config.block_size)
        n = 0
        for op, key, seq, value in self.wal.records():
            n += 1
            self._seq = max(self._seq, seq)
            self.memtable.put(key, seq, None if op == 1 else value)
        return n

    # --------------------------------------------------- background applies
    def _bg_flush(self, imm: ImmutableMemtable) -> Optional[CompactJob]:
        """Worker half of a pipelined flush: the synchronous ``flush`` step
        for step (rate limiter, run build, install), then the compaction
        continuation, which the scheduler front-queues.  The immutable
        memtable leaves the queue only after the install: a reader may see
        its entries twice, never zero times."""
        sched = self._scheduler
        st = self._stats.local()
        if len(self._levels[0]) >= self.config.l0_stop_writes_trigger:
            st.write_stalls += 1
            self._compact_until_quiet()
        if sched.aborting:
            return None     # crash in progress: imm stays queued for replay
        f = self.config.faults
        if f is not None:
            f.check("flush_write")
        with self._call("flush", "columns", "flush",
                        entries=len(imm.memtable), bg=1) as call:
            run = imm.memtable.to_run(self._bits_for_level(0), st,
                                      self.device)
            ph = ACTIVE.phases
            if ph is not None:
                ph.next("install")
            if len(run):
                levels = [list(lvl) for lvl in self._levels]
                levels[0].append(run)  # newest last
                self._levels = levels
                self._commit()
            with sched.lock:
                self._imm = [m for m in self._imm if m is not imm]
                sched.lock.notify_all()     # wake write-pressure waiters
            st.bg_flushes += 1
            call.done(entries=len(run), bg=1)
        return CompactJob()

    def _bg_compact_one(self) -> Optional[CompactionTask]:
        """Plan and apply one compaction task (worker thread), with the
        input version pinned for the merge so a concurrent snapshot release
        cannot free its runs; the pin is released (and GC + cache retention
        re-run) however the apply ends."""
        if self._scheduler.aborting:
            return None
        pinned = self.manifest.pin_current()
        try:
            task = self._plan_one()
            if task is None or not self._apply(task):
                return None
            self._stats.local().bg_compactions += 1
            return task
        finally:
            if self.manifest.unpin(pinned.version_id):
                with self._maint_lock:
                    self.manifest.gc()
                    if self.block_cache is not None:
                        self.block_cache.retain(self.storage.ids())

    # -------------------------------------------------------- compactions
    def _plan_one(self) -> Optional[CompactionTask]:
        """Next compaction task from host metadata only (no device read).
        The task captures its source level's run ids, so an apply against
        a changed tree is refused rather than merging the wrong runs."""
        sizes = [[r.data_bytes for r in lvl] for lvl in self._levels]
        new_L, task, delayed = self.policy.plan(
            sizes, self._max_level, self.config.base_level_bytes)
        if delayed:
            self._stats.local().delayed_last_level_compactions += delayed
        self._max_level = max(self._max_level, new_L)
        if task is None:
            return None
        srcs = (self._levels[task.src_level]
                if task.src_level < len(self._levels) else [])
        return dataclasses.replace(
            task, src_run_ids=tuple(r.run_id for r in srcs))

    def _compact_until_quiet(self):
        while True:
            if self._scheduler is not None and self._scheduler.aborting:
                return      # crash in progress: bail at the task boundary
            task = self._plan_one()
            if task is None:
                return
            self._apply(task)

    def _apply(self, task: CompactionTask) -> bool:
        """Merge the task's inputs on the device and install the result as
        a new version, published with one reference assignment (readers
        see the old version or the new one).  Returns False, changing
        nothing, if the task's captured inputs no longer match the tree."""
        levels = [list(lvl) for lvl in self._levels]
        while len(levels) <= task.dst_level:
            levels.append([])
        srcs = levels[task.src_level]
        if not task.matches(srcs):
            return False
        dsts = levels[task.dst_level] if task.include_dst else []
        with self._call("compaction", "merge", "compaction",
                        src=task.src_level, dst=task.dst_level,
                        runs=len(srcs) + len(dsts)) as call:
            drop_tombs = task.include_dst \
                and task.dst_level >= self._deepest_nonempty()
            f = self.config.faults
            if f is not None:
                f.check("compaction_merge")
            merged = merge_runs(srcs + dsts,
                                self._bits_for_level(task.dst_level),
                                self._stats.local(),
                                drop_tombstones=drop_tombs,
                                block_size=self.config.block_size,
                                key_bytes=self.config.key_bytes)
            ph = ACTIVE.phases
            if ph is not None:
                ph.next("install")
            levels[task.src_level] = []
            if task.include_dst:
                levels[task.dst_level] = [merged] if len(merged) else []
            elif len(merged):
                levels[task.dst_level].append(merged)
            self._levels = levels
            self._max_level = max(self._max_level, task.dst_level)
            self._commit()
            call.done(src=task.src_level, dst=task.dst_level,
                      entries=len(merged))
        return True

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
        f = self.config.faults
        if f is not None:
            # after the in-memory commit, before durability: the edit is
            # appended but not synced, the window a failed fsync leaves
            f.check("manifest_fsync")
        self.manifest.fsync(st)
        with self._maint_lock:
            # gc + retain + repin must not interleave with a snapshot
            # release or another install: a retain from a stale id set could
            # drop blocks the newer version just pinned
            self.manifest.gc()
            if self.block_cache is not None:
                self.block_cache.retain(self.storage.ids())
                self.pinned_l0.repin(self._levels[0])

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
    def _read_state(self, snapshot: Optional[Version] = None
                    ) -> List[List[SortedRun]]:
        if snapshot is None:
            return self._levels
        return snapshot.runs(self.storage)

    def _mem_sources(self) -> List[Memtable]:
        """Memtables in resolution order: active, then immutables newest
        first.  The active memtable is captured *before* the queue:
        rotation publishes in the opposite order (queue append, then the
        active swap), so a racing reader may see the rotated memtable
        twice, never zero times."""
        active = self.memtable
        imm = self._imm
        if not imm:
            return [active]
        return [active] + [m.memtable for m in reversed(imm)]

    def _runs_newest_first(self, levels: List[List[SortedRun]]):
        for r in reversed(levels[0]):
            yield r
        for lvl in levels[1:]:
            for r in reversed(lvl):
                yield r

    # ------------------------------------------------------- range views
    def _view_fresh(self) -> Optional[RangeView]:
        """The range view iff it indexes the *published* level list: every
        install replaces ``self._levels``, so one identity test is the
        whole staleness check."""
        v = self._range_view
        if v is not None and v.levels_ref is self._levels:
            return v
        return None

    def refresh_range_view(self, background: bool = False
                           ) -> Optional[RangeView]:
        """(Re)build the range view from the published levels, re-merging
        only the levels whose runs changed since the last build.  Called by
        a worker once the tree is shaped (``background=True``) or by the
        first view read in sync mode, never by the write path."""
        if not self.config.use_range_views:
            return None
        levels = self._levels
        v = self._range_view
        if v is not None and v.levels_ref is levels:
            return v
        t0 = time.perf_counter_ns()
        view = build_range_view(levels, self._view_cache,
                                telemetry=self.config.telemetry,
                                device=self.device)
        dt = time.perf_counter_ns() - t0
        st = self._stats.local()
        st.view_rebuilds += 1
        if background:
            st.bg_view_rebuilds += 1
        st.view_entries_built += len(view)
        st.view_rebuild_ns += dt
        tel = self.config.telemetry
        if tel is not None:
            tel.record("view_rebuild", dt)
        self._range_view = view
        return view

    def _bg_refresh_view(self) -> None:
        """Scheduler hook: rebuild the view on the worker that found the
        tree quiet (a CompactJob with no task left)."""
        if not self.config.use_range_views:
            return
        if self._scheduler is not None and self._scheduler.aborting:
            return
        self.refresh_range_view(background=True)

    # -------------------------------------------------------- point reads
    def get(self, key: int, snapshot: Optional[Version] = None
            ) -> Optional[bytes]:
        """Point read: the batch path on one key, with the same accounting
        as the reference's scalar ``get`` (and its ``get`` span)."""
        with self._call("get", "memtable_probe"):
            return self._multi_get_impl([key], snapshot)[0]

    def multi_get(self, keys: Sequence[int],
                  snapshot: Optional[Version] = None
                  ) -> List[Optional[bytes]]:
        """Batched point reads: semantically ``[get(k) for k in keys]``.

        Keys missing from the memtable go to the device once; then, run by
        run, newest first, the keys still pending are probed with the bloom
        kernel and located with one searchsorted.  A snapshot read skips
        the memtable and walks the snapshot's runs.  Aggregate IOStats
        accounting is identical to the reference's.  The ``multi_get`` span
        ends after the last read-back, so it is the device's time too.
        """
        with self._call("multi_get", "memtable_probe"):
            return self._multi_get_impl(keys, snapshot)

    def _multi_get_impl(self, keys: Sequence[int],
                        snapshot: Optional[Version] = None
                        ) -> List[Optional[bytes]]:
        st = self._stats.local()
        keys_arr = np.asarray(
            keys if isinstance(keys, np.ndarray) else list(keys),
            dtype=KEY_DTYPE)
        n = int(keys_arr.size)
        st.point_reads += n
        if n == 0:
            return []
        answers = np.empty(n, dtype=object)      # None: not found
        pending = np.arange(n, dtype=np.int64)
        if snapshot is None:
            # memtables before levels (see _mem_sources): a racing install
            # gives a benign duplicate, never a lost read.  Only the keys
            # the memtable's probe finds go through its get; one the get
            # misses (a racing clear) stays pending.
            for mt in self._mem_sources():
                if len(mt) == 0 or pending.size == 0:
                    continue
                wanted = keys_arr[pending]
                idx = mt.probe(wanted)
                done = []
                get = mt.get
                for i, k in zip(idx.tolist(), wanted[idx].tolist()):
                    hit = get(k)
                    if hit is not None:
                        answers[pending[i]] = hit[1]  # None: tombstone
                        done.append(i)
                if done:
                    pending = np.delete(pending, done)
        if pending.size == 0:
            return answers.tolist()
        ph = ACTIVE.phases
        if ph is not None:
            ph.next("upload")
        q = ops.keys_to_device(keys_arr[pending], self.device)
        cfg = self.config
        use_bloom = cfg.bits_per_key > 0
        paranoid = cfg.paranoid_checks
        faults = cfg.faults
        cache = self.block_cache
        for run in self._runs_newest_first(self._read_state(snapshot)):
            if pending.size == 0:
                break
            if len(run) == 0:
                continue
            st.runs_touched_point += int(pending.size)
            if ph is not None:
                ph.next("run_probe")
            found, values, q = run.point_get_batch(q, st, use_bloom, cache,
                                                   paranoid, faults)
            if values.size:
                answers[pending[found]] = values
                pending = pending[~found]
        return answers.tolist()

    # -------------------------------------------------------- range reads
    def seek(self, key: int, snapshot: Optional[Version] = None
             ) -> Optional[int]:
        """The first key >= ``key`` (db_bench Seek).

        Through a fresh range view: one binary search and one block.  Else
        one seek + one block read per run with a valid position, one
        read-back bringing every run's position and key.

        Tombstone handling is approximate, as in the reference (a cost
        probe, not a correctness surface — ``scan`` is): memtable entries
        are liveness-filtered but run entries are not, so a deleted key
        stops shadowing once its tombstone flushes.  Each memtable gives
        its first *live* entry ``>= key``: a memtable tombstone never hides
        a live memtable key behind it (the reference takes each memtable's
        first entry and drops it when it is a tombstone, and so can return
        a key past a live one).
        """
        with self._call("seek", "probe"):
            return self._seek_impl(key, snapshot)

    def _seek_impl(self, key: int, snapshot: Optional[Version] = None
                   ) -> Optional[int]:
        st = self._stats.local()
        st.range_reads += 1
        best: Optional[int] = None
        cfg = self.config
        mems = self._mem_sources() if snapshot is None else []
        cache = self.block_cache
        if snapshot is None and cfg.use_range_views:
            view = self._view_fresh()
            if view is None and self._scheduler is None:
                view = self.refresh_range_view()
            if view is not None:
                st.view_scans += 1
                best = view.seek(int(key), st, cache)
                return _min_key(best, _first_live_mem_key(mems, int(key)))
            st.view_fallbacks += 1
        runs = [r for r in self._runs_newest_first(self._read_state(snapshot))
                if len(r)]
        for run, i, k, b in zip(runs, *seek_batch(
                runs, int(key), with_blocks=True)):
            st.runs_touched_range += 1
            st.seeks += 1
            if i < len(run):
                run._charge_block(b, st, cache,
                                  paranoid=cfg.paranoid_checks,
                                  faults=cfg.faults)
                if best is None or k < best:
                    best = k
        return _min_key(best, _first_live_mem_key(mems, int(key)))

    def iterator(self, snapshot: Optional[Version] = None,
                 chunk: int = 512) -> MergingIterator:
        """A streaming merging iterator over the current (or snapshot)
        state: one cursor per run + the memtable (none under a snapshot);
        see ``core.iterator`` for the merge and its accounting.  Run
        cursors read a frozen set of runs; take a snapshot for isolation
        from later memtable writes."""
        mems = self._mem_sources() if snapshot is None else None
        runs = [r for r in self._runs_newest_first(self._read_state(snapshot))
                if len(r)]
        return MergingIterator(runs, memtables=mems,
                               stats=self._stats.local(), chunk=chunk,
                               cache=self.block_cache)

    def scan(self, start_key: int, count: int,
             snapshot: Optional[Version] = None) -> List[Tuple[int, bytes]]:
        """Range read: first ``count`` live entries with key >= start_key.

        Through the merging iterator; with ``use_range_views`` a fresh
        range view serves it instead (one binary search, one sweep, one
        batched value fetch), and a stale one falls back to the iterator
        and counts ``view_fallbacks``: the answer is the same either way.
        """
        with self._call("scan", "seek"):
            return self._scan_impl(start_key, count, snapshot)

    def _scan_impl(self, start_key: int, count: int,
                   snapshot: Optional[Version] = None
                   ) -> List[Tuple[int, bytes]]:
        st = self._stats.local()
        st.range_reads += 1
        if snapshot is None and self.config.use_range_views:
            # memtables before the view capture (see _mem_sources)
            mems = self._mem_sources()
            view = self._view_fresh()
            if view is None and self._scheduler is None:
                view = self.refresh_range_view()  # lazy in sync mode
            if view is not None:
                st.view_scans += 1
                mems = [m for m in mems if len(m)]   # empty => pure sweep
                if len(mems) == 1:      # its cached key-sorted copy
                    mem_keys, mem_items = mems[0].sorted_entries()
                else:
                    mem_items = combined_mem_items(mems, int(start_key))
                    mem_keys = np.fromiter((e[0] for e in mem_items),
                                           KEY_DTYPE, len(mem_items))
                return view.scan_with_memtable(int(start_key), count,
                                               mem_keys, mem_items, st,
                                               self.block_cache)
            st.view_fallbacks += 1
        return self.iterator(snapshot).scan(int(start_key), count)

    def scan_scalar(self, start_key: int, count: int,
                    snapshot: Optional[Version] = None
                    ) -> List[Tuple[int, bytes]]:
        """Reference range read (the pre-iterator seek-retry
        implementation), kept as the differential oracle: slices ``count``
        candidates from every run, sort-merges the Python lists, and retries
        with a 4x larger window when a truncated run could still hide
        smaller keys.  It reads the device run by run, column by column."""
        st = self._stats.local()
        st.range_reads += 1
        mems = self._mem_sources() if snapshot is None else []
        runs = [r for r in self._runs_newest_first(self._read_state(snapshot))
                if len(r)]
        per_run_take = max(count, 1)
        while True:
            cand_k: List[np.ndarray] = []
            cand_s: List[np.ndarray] = []
            cand_v: List[List[Optional[bytes]]] = []
            # Results are only valid up to the smallest last-key among
            # truncated run slices.
            frontier: Optional[int] = None
            seek_positions = []
            for run in runs:
                i = run.seek_idx(int(start_key))
                seek_positions.append(i)
                k, s, l, v = run.slice_from(i, per_run_take)
                if i + per_run_take < len(run) and len(k):
                    fk = int(k[-1])
                    frontier = fk if frontier is None else min(frontier, fk)
                cand_k.append(k)
                cand_s.append(s)
                cand_v.append([None if l[j] == TOMBSTONE_LEN
                               else bytes(v[j, :l[j]])
                               for j in range(len(k))])
            mem_items: List[Tuple[int, int, Optional[bytes]]] = []
            for mt in mems:
                mem_items.extend(mt.scan(int(start_key)))
            merged = self._merge_candidates(cand_k, cand_s, cand_v, mem_items)
            live = [(k, v) for k, v in merged if v is not None and
                    (frontier is None or k <= frontier)][:count]
            if len(live) >= count or frontier is None:
                # Account I/O for the final pass only.
                end_key = live[-1][0] if live else None
                for run, i in zip(runs, seek_positions):
                    st.runs_touched_range += 1
                    st.seeks += 1
                    if i >= len(run):
                        continue
                    if end_key is None:
                        consumed_end = i + 1
                    else:
                        after = (len(run) if end_key == (1 << 64) - 1
                                 else run.seek_idx(end_key + 1))
                        consumed_end = max(after, i + 1)
                    st.blocks_read += run.blocks_spanned(i, consumed_end)
                return live
            per_run_take *= 4

    @staticmethod
    def _merge_candidates(cand_k, cand_s, cand_v, mem_items):
        ks: List[int] = []
        ss: List[int] = []
        vs: List[Optional[bytes]] = []
        for k_arr, s_arr, v_list in zip(cand_k, cand_s, cand_v):
            ks.extend(int(x) for x in k_arr)
            ss.extend(int(x) for x in s_arr)
            vs.extend(v_list)
        for k, s, v in mem_items:
            ks.append(k)
            ss.append(s)
            vs.append(v)
        order = sorted(range(len(ks)), key=lambda i: (ks[i], -ss[i]))
        out: List[Tuple[int, Optional[bytes]]] = []
        last_key = None
        for i in order:
            if ks[i] != last_key:
                out.append((ks[i], vs[i]))
                last_key = ks[i]
        return out

    # ----------------------------------------------------------- snapshots
    def get_snapshot(self) -> Version:
        """Acquire a reader reference on the current version: its runs stay
        on the device across any number of later flushes and compactions
        until the matching ``release_snapshot`` (refcounted)."""
        return self.manifest.pin_current()

    def release_snapshot(self, snapshot: Version) -> None:
        """Drop one reader reference; at the last one, the runs that only
        the snapshot held are freed (and their cached blocks dropped)."""
        if not self.manifest.unpin(snapshot.version_id):
            return  # other readers still hold the version
        with self._maint_lock:
            self.manifest.gc()
            if self.block_cache is not None:
                self.block_cache.retain(self.storage.ids())

    # ------------------------------------------------------------ recovery
    def crash(self):
        """Simulate a process crash: volatile state is lost.

        Async mode: the scheduler first aborts the in-flight job at its
        next safe point and drops the queued work, so no half-applied
        compaction, input pin or orphaned cache entry survives.  The
        immutable queue's WAL segments were fsynced at rotation and stay
        for ``recover`` to replay; the runs on the device are the durable
        medium and stay too."""
        if self._scheduler is not None:
            self._scheduler.abort_and_drain()
        f = self.config.faults
        self.wal.crash(f)
        for imm in self._imm:
            imm.wal.crash()   # fully synced at rotation: keeps every byte
        self.manifest.crash(f)
        self.memtable.clear()

    def recover(self):
        """Rebuild volatile state from the durable manifest and WAL(s).

        The newest checksum-valid version is restored; the cache is cleared
        and L0 repinned (charged); the log is repaired to its last valid
        frame; the rotated-but-unflushed segments are consolidated (oldest
        first) ahead of the active WAL and replayed, so a second crash
        before the next rotation still recovers everything; and every run
        is scrubbed on the device — a bad block raises
        :class:`CorruptionError`.  Degraded mode ends: the failed
        pipeline's state was volatile."""
        tel = self.config.telemetry
        v, popped = self.manifest.recover_current()
        if popped and tel is not None:
            tel.emit("corruption", run_id=-1, block_id=-1, where="manifest",
                     popped_versions=popped)
        self._levels = v.runs(self.storage)
        self._max_level = v.max_level
        self._seq = v.last_seq
        self._degraded = None
        self._bg_failure_surfaced = False
        if self.block_cache is not None:
            self.block_cache.clear()
            with self._maint_lock:
                self.pinned_l0.repin(self._levels[0],
                                     stats=self._stats.local())
        wal_dropped = self.wal.repair()
        if wal_dropped and tel is not None:
            tel.emit("corruption", run_id=-1, block_id=-1, where="wal",
                     dropped_bytes=wal_dropped)
        replayed = self._consolidate_imm_wal()
        if tel is not None:
            tel.emit("wal_replay", records=replayed,
                     bytes=len(self.wal._buf), dropped_bytes=wal_dropped)
        for r in self.scrub():
            if r["bad_blocks"]:
                raise CorruptionError(r["run_id"], r["bad_blocks"][0],
                                      where="recovery scrub")

    def scrub(self) -> List[dict]:
        """Verify every run's block checksums on the device; one report
        dict per run (``run_id``, ``level``, ``entries``, ``blocks``,
        ``bad_blocks``: empty == clean).  Emits a ``scrub`` event (and a
        ``corruption`` event per dirty run) but does not raise."""
        tel = self.config.telemetry
        t0 = time.perf_counter_ns() if tel is not None else 0
        report: List[dict] = []
        for li, lvl in enumerate(self._levels):
            for run in lvl:
                bad = run.verify()
                report.append({"run_id": run.run_id, "level": li,
                               "entries": len(run), "blocks": run.n_blocks,
                               "bad_blocks": bad})
                if bad and tel is not None:
                    tel.emit("corruption", run_id=run.run_id,
                             block_id=int(bad[0]), where="scrub",
                             bad_blocks=len(bad))
        if tel is not None:
            tel.record("scrub", time.perf_counter_ns() - t0)
            tel.emit("scrub", runs=len(report),
                     bad_runs=sum(1 for r in report if r["bad_blocks"]))
        return report

    # ------------------------------------------------- range migration
    # The sharded facade's three primitives (ROADMAP A8 drives them).  Each
    # assumes a quiesced store with no foreground writer, except
    # strip_to_range, which recovery also calls.
    def _range_bounds(self, run: SortedRun, lo: int, hi: int
                      ) -> Tuple[int, int]:
        """Rows of ``run`` with ``lo <= key < hi`` (``hi`` may be 2^64)."""
        dev = run.device
        q = [ops.order_of(lo)] + ([] if hi >= 1 << 64 else [ops.order_of(hi)])
        at = torch.searchsorted(run.keys, torch.tensor(
            q, dtype=torch.int64, device=dev)).tolist()
        return at[0], (len(run) if hi >= 1 << 64 else at[1])

    def export_range(self, lo: int, hi: int):
        """Columns of every stored entry with ``lo <= key < hi``, on the
        device: ``(keys, seqs, vlens, vals)`` (order-mapped keys), with
        duplicates kept (one row per surviving entry, any level, newest run
        first) so an importer's ``build_run`` keeps the newest version, or
        ``None`` when the range holds nothing.  Needs an empty memtable."""
        assert len(self.memtable) == 0 and not self._imm, \
            "export_range requires a flushed, quiesced store"
        parts, vmax = [], 0
        for run in self._runs_newest_first(self._levels):
            if len(run) == 0:
                continue
            i0, i1 = self._range_bounds(run, lo, hi)
            if i0 >= i1:
                continue
            parts.append((run.keys[i0:i1], run.seqs[i0:i1],
                          run.vlens[i0:i1], run.vals[i0:i1]))
            vmax = max(vmax, run.vals.shape[1])
        if not parts:
            return None
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]),
                torch.cat([p[2] for p in parts]),
                torch.cat([torch.nn.functional.pad(
                    p[3], (0, vmax - p[3].shape[1])) for p in parts]))

    def import_migrated_run(self, run: SortedRun) -> None:
        """Install a migrated run as the newest L0 run and commit it.  The
        caller guarantees its key range is disjoint from this store's."""
        if len(run) == 0:
            return
        f = self.config.faults
        if f is not None:
            f.check("migration_import")  # before any mutation
        self._seq = max(self._seq, int(run.seqs.max()))
        levels = [list(lvl) for lvl in self._levels]
        levels[0].append(run)          # newest last, like flush
        self._levels = levels          # COW publish
        st = self._stats.local()
        st.blocks_written += -(-run.data_bytes // self.config.block_size)
        self._commit()

    def strip_to_range(self, lo: int, hi: int) -> int:
        """Drop every stored entry outside ``[lo, hi)``; return the count.
        Runs wholly outside go, straddling runs are rebuilt from their
        in-range slice; commits only when something changed.  The memtable
        is left alone."""
        f = self.config.faults
        if f is not None:
            f.check("migration_strip")   # before any mutation
        dropped = 0
        changed = False
        levels: List[List[SortedRun]] = []
        for li, lvl in enumerate(self._levels):
            out = []
            for run in lvl:
                if len(run) == 0:
                    out.append(run)
                    continue
                i0, i1 = self._range_bounds(run, lo, hi)
                if i0 == 0 and i1 == len(run):
                    out.append(run)
                    continue
                changed = True
                dropped += len(run) - (i1 - i0)
                if i0 >= i1:
                    continue                      # wholly outside: drop
                nr = build_run(run.keys[i0:i1].clone(),
                               run.seqs[i0:i1].clone(),
                               run.vlens[i0:i1].clone(),
                               run.vals[i0:i1].clone(),
                               bits_per_key=self._bits_for_level(li),
                               assume_unique_sorted=True,
                               block_size=self.config.block_size,
                               key_bytes=self.config.key_bytes)
                self._stats.local().blocks_written += \
                    -(-nr.data_bytes // self.config.block_size)
                out.append(nr)
            levels.append(out)
        if changed:
            self._levels = levels          # COW publish: views go stale
            self._commit()
        return dropped

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
        mems = self._mem_sources()      # memtables before levels, as above
        levels = self._levels
        return sum(len(r) for lvl in levels for r in lvl) \
            + sum(len(mt) for mt in mems)

    def _live_profile(self) -> Tuple[int, int]:
        """(live entry count, live logical bytes) of the newest versions:
        every source's keys newest first (memtables, then runs in read
        order) in one stable sort on the device; the first occurrence of a
        key is its newest version.  One read-back."""
        parts_k, parts_vl = [], []
        for mt in self._mem_sources():
            items = mt.snapshot_items()
            if items:
                parts_k.append(ops.keys_to_device(
                    np.fromiter((k for k, _, _ in items), KEY_DTYPE,
                                len(items)), self.device))
                parts_vl.append(torch.tensor(
                    [TOMBSTONE_LEN if v is None else len(v)
                     for _, _, v in items], dtype=torch.int64,
                    device=self.device))
        for run in self._runs_newest_first(self._levels):
            if len(run):
                parts_k.append(run.keys)
                parts_vl.append(run.vlens.to(torch.int64))
        if not parts_k:
            return 0, 0
        keys, order = torch.sort(torch.cat(parts_k), stable=True)
        first = torch.ones_like(keys, dtype=torch.bool)
        first[1:] = keys[1:] != keys[:-1]
        win_vl = torch.cat(parts_vl)[order[first]]
        live = win_vl != TOMBSTONE_LEN
        n_live, vbytes = torch.stack([live.sum(),
                                      win_vl[live].sum()]).tolist()
        return n_live, vbytes + n_live * self.config.key_bytes

    def total_live_entries(self) -> int:
        """Logical entry count (newest versions only, tombstones excluded)."""
        return self._live_profile()[0]

    def _space_profile(self) -> Tuple[int, int]:
        """(physical bytes stored, logical live bytes): the two terms of
        space amplification, apart so the sharded facade sums shards before
        dividing."""
        mems = self._mem_sources()      # memtables before levels, as above
        phys = sum(r.data_bytes for lvl in self._levels for r in lvl) \
            + sum(mt.size_bytes for mt in mems)
        return phys, self._live_profile()[1]

    def space_amplification(self) -> float:
        """Physical bytes stored / logical bytes of the live newest versions
        (RocksDB's definition; 1.0 when nothing is live)."""
        phys, logical = self._space_profile()
        return phys / logical if logical else 1.0
