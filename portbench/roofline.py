"""The frozen roofline of the store's kernels: the H100's peaks and the
bytes and operations each launch needs, from its launch sizes alone.

A copy (of ``chip_smoke.py``'s ``bound`` and of the counts beside each
kernel), kept here so that a later kernel change cannot move the
yardstick.  A launch's bound is the larger of its bytes over the memory
rate and its operations over the peak rate; a kernel's share of its
roofline is the sum of its launches' bounds over its device time.  Each
input byte is counted read once and each output byte written once.
"""
from __future__ import annotations

import math
import subprocess

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s.  The data sheet gives no
# integer ALU peak; the fp32 CUDA-core peak (67 TFLOP/s) is the highest
# non-tensor rate, so operations over it stay a lower bound on time.
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
HASH_OPS = 30       # hash_pair: two mix32 chains, xors, or
PROBE_OPS = 6       # one bit test: mul, add, mod, shift, and, test


def bound_s(nbytes: float, nops: float) -> float:
    """The least time the card could take for this work."""
    return max(nbytes / HBM_BYTES_PER_S, nops / ALU_OPS_PER_S)


def probe_bound_s(n: int, m_words: int) -> float:
    """K1, ``bloom_probe`` of ``n`` keys against a filter of ``m_words``
    32-bit words: each key read once (8 bytes), one byte out, and the
    first filter word each key tests (at most the filter).  A key that
    passes its first bit test reads further words, which only the filter's
    bits decide; they are left out, so the bound is low and the share a
    lower bound.  Operations: the hash and one bit test a key."""
    return bound_s(n * 9 + min(n, m_words) * 4, n * (HASH_OPS + PROBE_OPS))


def build_bound_s(n: int, m_words: int, k: int) -> float:
    """K1b, ``bloom_build`` of ``n`` keys into ``m_words`` words with ``k``
    hashes: the keys read once and the words written once; the hash and
    ``k`` positions a key."""
    return bound_s(n * 8 + m_words * 4, n * (HASH_OPS + k * PROBE_OPS))


def merge_bound_s(na: int, nb: int) -> float:
    """K2, ``merge_pair`` of two sorted key columns of ``na`` and ``nb``
    keys: the keys read once (8 bytes), the merged keys and their source
    rows written once (8 + 8 bytes); each key's rank by a binary search
    of the other column."""
    n = na + nb
    ops = n * 4 + 5 * (na * math.ceil(math.log2(nb + 1))
                       + nb * math.ceil(math.log2(na + 1)))
    return bound_s(n * 24, ops)


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=30).stdout
    return out.strip().splitlines()[0]
