"""The Autumn LSM core on PyTorch: the store with its sorted runs on the
device, synchronous or with the background compaction scheduler.

Public API:
    LSMStore, LSMConfig, make_store — the storage engine
    CompactionScheduler           — background flush + compaction workers
    BlockCache, PinnedLevelManager — block cache and the resident L0
    MergingIterator               — streaming range reads over the runs
    RangeView, build_range_view   — cross-run range views on the device
    make_policy, Garnering, ...   — merge policies (paper §2.3/§3.1)
    BloomFilter, allocate_fprs    — device filters + Monkey/Autumn allocation
    SortedRun, build_run, merge_runs — device runs and compaction
    IOStats, StatsHub             — block-I/O cost accounting
    Telemetry, LatencyHistogram,
    EventTrace                    — latency histograms + event trace
    FaultInjector, crc32c, ...    — fault injection and checksums, with the
                                    typed failures CorruptionError,
                                    InjectedFault, StoreDegradedError
    OnlineTuner, KNOB_BOUNDS,
    tuning_objective              — online workload-adaptive tuning
    store_from_columns, columns_of — state carried to and from numpy columns
"""
from .bloom import (BloomFilter, allocate_fprs, bits_for_fpr,
                    bloom_geometry, theoretical_fpr)
from .cache import BlockCache, PinnedLevelManager
from .convert import columns_of, store_from_columns
from .engine import LSMConfig, LSMStore
from .faults import (FAULT_SITES, CorruptionError, FaultInjector,
                     InjectedFault, StoreDegradedError, crc32c, crc32c_rows,
                     crc32c_rows_torch)
from .iterator import MergingIterator
from .manifest import Manifest, RunStorage, Version
from .memtable import ImmutableMemtable, Memtable, WriteAheadLog
from .policy import (POLICIES, CompactionTask, Garnering, LazyLeveling,
                     Leveling, MergePolicy, QLSMBush, Tiering, make_policy)
from .run import SortedRun, build_run, levels_bit_equal, merge_runs
from .scheduler import CompactionScheduler
from .telemetry import (EventTrace, LatencyHistogram, Telemetry,
                        TelemetrySnapshot, TelemetryWindow, TraceEvent)
from .tuner import (FOREGROUND_OPS, KNOB_BOUNDS, OnlineTuner, TunerStep,
                    tuning_objective)
from .types import BLOCK_SIZE, KEY_BYTES, TOMBSTONE_LEN, IOStats, StatsHub
from .view import RangeView, build_range_view


def make_store(config=None, device=None) -> LSMStore:
    """The store a configuration asks for: an :class:`LSMStore` for
    ``shards <= 1``.  The sharded facade (``shards > 1``) is not ported yet
    (ROADMAP A8) and raises ``NotImplementedError``."""
    config = config or LSMConfig()
    if config.shards > 1:
        raise NotImplementedError(
            f"LSMConfig.shards={config.shards}: the sharded facade is not "
            f"ported yet (ROADMAP A8)")
    return LSMStore(config, device=device)


__all__ = [
    "LSMStore", "LSMConfig", "make_store", "MergingIterator", "IOStats",
    "StatsHub", "BloomFilter", "allocate_fprs", "bits_for_fpr",
    "bloom_geometry", "theoretical_fpr", "Manifest", "RunStorage", "Version",
    "Memtable", "WriteAheadLog", "ImmutableMemtable", "BlockCache",
    "PinnedLevelManager", "CompactionScheduler", "POLICIES",
    "CompactionTask", "Garnering", "LazyLeveling", "Leveling", "MergePolicy",
    "QLSMBush", "Tiering", "make_policy", "SortedRun", "build_run",
    "merge_runs", "levels_bit_equal", "store_from_columns", "columns_of",
    "RangeView", "build_range_view",
    "Telemetry", "LatencyHistogram", "EventTrace", "TraceEvent",
    "TelemetrySnapshot", "TelemetryWindow",
    "OnlineTuner", "TunerStep", "KNOB_BOUNDS", "FOREGROUND_OPS",
    "tuning_objective",
    "FAULT_SITES", "FaultInjector", "InjectedFault", "CorruptionError",
    "StoreDegradedError", "crc32c", "crc32c_rows", "crc32c_rows_torch",
    "BLOCK_SIZE", "KEY_BYTES", "TOMBSTONE_LEN",
]
