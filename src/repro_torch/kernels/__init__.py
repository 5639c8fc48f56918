"""Hand-written Hopper kernels of the port's paths, each beside its plain
PyTorch version:
  bloom  — batched bloom-filter probe and filter build (csrc/bloom.cu)
  merge  — pair merge of sorted key columns for compaction (csrc/merge.cu)
  attention — flash (prefill) and paged (decode) GQA attention
           (csrc/attention.cu)
  ops    — dispatch by device, launch counts, the u64 key map
"""
from .ops import (bloom_build, bloom_probe, flash_attention, launch_counts,
                  merge_pair, paged_attention, reset_launch_counts)
