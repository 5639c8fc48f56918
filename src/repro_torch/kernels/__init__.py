"""Hand-written Hopper kernels of the store's path, each beside its plain
PyTorch version:
  bloom  — batched bloom-filter probe and filter build (csrc/bloom.cu)
  merge  — pair merge of sorted key columns for compaction (csrc/merge.cu)
  ops    — dispatch by device, launch counts, the u64 key map
"""
from .ops import (bloom_build, bloom_probe, launch_counts, merge_pair,
                  reset_launch_counts)
