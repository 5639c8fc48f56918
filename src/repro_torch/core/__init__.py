"""The Autumn LSM core on PyTorch: the store with its sorted runs on the
device, synchronous or with the background compaction scheduler.

Public API:
    LSMStore, LSMConfig           — the storage engine
    CompactionScheduler           — background flush + compaction workers
    BlockCache, PinnedLevelManager — block cache and the resident L0
    MergingIterator               — streaming range reads over the runs
    make_policy, Garnering, ...   — merge policies (paper §2.3/§3.1)
    BloomFilter, allocate_fprs    — device filters + Monkey/Autumn allocation
    SortedRun, build_run, merge_runs — device runs and compaction
    IOStats, StatsHub             — block-I/O cost accounting
    store_from_columns, columns_of — state carried to and from numpy columns
"""
from .bloom import (BloomFilter, allocate_fprs, bits_for_fpr,
                    bloom_geometry, theoretical_fpr)
from .cache import BlockCache, PinnedLevelManager
from .convert import columns_of, store_from_columns
from .engine import LSMConfig, LSMStore
from .faults import (CorruptionError, StoreDegradedError, crc32c, crc32c_rows,
                     crc32c_rows_torch)
from .iterator import MergingIterator
from .manifest import Manifest, RunStorage, Version
from .memtable import ImmutableMemtable, Memtable, WriteAheadLog
from .policy import (POLICIES, CompactionTask, Garnering, LazyLeveling,
                     Leveling, MergePolicy, QLSMBush, Tiering, make_policy)
from .run import SortedRun, build_run, levels_bit_equal, merge_runs
from .scheduler import CompactionScheduler
from .types import BLOCK_SIZE, KEY_BYTES, TOMBSTONE_LEN, IOStats, StatsHub

__all__ = [
    "LSMStore", "LSMConfig", "MergingIterator", "IOStats", "StatsHub",
    "BloomFilter", "allocate_fprs", "bits_for_fpr", "bloom_geometry",
    "theoretical_fpr", "Manifest", "RunStorage", "Version", "Memtable",
    "WriteAheadLog", "ImmutableMemtable", "BlockCache",
    "PinnedLevelManager", "CompactionScheduler", "POLICIES", "CompactionTask", "Garnering",
    "LazyLeveling", "Leveling", "MergePolicy", "QLSMBush", "Tiering",
    "make_policy", "SortedRun", "build_run", "merge_runs",
    "levels_bit_equal", "store_from_columns", "columns_of",
    "CorruptionError", "StoreDegradedError", "crc32c", "crc32c_rows", "crc32c_rows_torch",
    "BLOCK_SIZE", "KEY_BYTES", "TOMBSTONE_LEN",
]
