"""Bloom-filter hash, probe and build: CUDA kernels and their plain versions.

Counterpart of ``repro.kernels.bloom_probe`` and of the bloom half of
``repro.kernels.ref``.  Keys are int64 tensors holding the order-preserving
map ``k ^ (1 << 63)`` of u64 keys (see :mod:`repro_torch.kernels.ops`); the
hash family runs on the original u64 key's (lo, hi) u32 halves, bit for bit
the reference's ``hash_pair``.  Filter bits are int32 tensors holding the
reference's uint32 words.

The plain versions carry u32 lanes in int64 masked to 32 bits (torch has no
arithmetic on uint32), and split each 32-bit product so that no int64
product overflows.  The ``*_cuda`` wrappers launch the kernels of
``csrc/bloom.cu``; each adds one to :data:`LAUNCHES` where it launches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import _build

M32 = 0xFFFFFFFF

# kernel launches by wrapper (see ops.launch_counts)
LAUNCHES = {"bloom_probe": 0, "bloom_build": 0}


# ------------------------------------------------------------ plain versions
def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32): two partial products < 2^48."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def _mix32(x: torch.Tensor, c1: int, c2: int) -> torch.Tensor:
    """murmur3-style 32-bit finalizer (the reference's ``_mix32``)."""
    x = x ^ (x >> 16)
    x = _mul32(x, c1)
    x = x ^ (x >> 13)
    x = _mul32(x, c2)
    return x ^ (x >> 16)


def split_lanes(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Order-mapped int64 keys -> the original u64 key's (lo, hi) u32
    halves, each in int64."""
    lo = keys & M32
    hi = ((keys >> 32) & M32) ^ 0x80000000
    return lo, hi


def hash_pair(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h1, h2) u32 hashes (in int64) of order-mapped keys; h2 is odd."""
    lo, hi = split_lanes(keys)
    h1 = _mix32(lo ^ _mix32(hi, 0x85EBCA6B, 0xC2B2AE35),
                0xCC9E2D51, 0x1B873593)
    h2 = _mix32(hi ^ _mix32(lo, 0x27D4EB2F, 0x165667B1),
                0x9E3779B9, 0x85EBCA77) | 1
    return h1, h2


def _positions(h1: torch.Tensor, h2: torch.Tensor, i: int,
               m_bits: int) -> torch.Tensor:
    # the reference computes h1 + i*h2 in u32 (wrapping) before the modulo
    return ((h1 + i * h2) & M32) % m_bits


def probe_plain(keys: torch.Tensor, bits: torch.Tensor,
                k: int) -> torch.Tensor:
    """(n,) bool "maybe present" of each key against the filter words."""
    maybe = torch.ones(keys.numel(), dtype=torch.bool, device=keys.device)
    if k == 0 or keys.numel() == 0:
        return maybe
    m_bits = bits.numel() * 32
    h1, h2 = hash_pair(keys)
    for i in range(k):
        pos = _positions(h1, h2, i, m_bits)
        word = bits[pos >> 5].to(torch.int64) & M32
        maybe &= ((word >> (pos & 31)) & 1) != 0
    return maybe


def u32_to_i32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same 32 bits."""
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def build_plain(keys: torch.Tensor, m_words: int, k: int) -> torch.Tensor:
    """(m_words,) int32 filter words with every key's k bits set: the word
    and bit layout of the reference's ``build_bits``."""
    m_bits = m_words * 32
    bitmap = torch.zeros(m_bits, dtype=torch.bool, device=keys.device)
    if keys.numel():
        h1, h2 = hash_pair(keys)
        for i in range(k):
            bitmap[_positions(h1, h2, i, m_bits)] = True
    shifts = torch.arange(32, dtype=torch.int64, device=keys.device)
    words = (bitmap.view(m_words, 32).to(torch.int64) << shifts).sum(1)
    return u32_to_i32(words)


# ------------------------------------------------------------ CUDA wrappers
def _check_cuda(t: torch.Tensor, dtype: torch.dtype, name: str,
                device: torch.device) -> None:
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor")


def _check_geometry(m_words: int, k: int) -> None:
    if not 0 < m_words * 32 < 1 << 32:
        raise ValueError(f"filter of {m_words} words outside (0, 2^32) bits")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")


def probe_cuda(keys: torch.Tensor, bits: torch.Tensor,
               k: int) -> torch.Tensor:
    """:func:`probe_plain` on the card (``bloom_probe_launch``)."""
    _check_cuda(keys, torch.int64, "keys", keys.device)
    _check_cuda(bits, torch.int32, "bits", keys.device)
    n = keys.numel()
    if k == 0 or n == 0:
        return torch.ones(n, dtype=torch.bool, device=keys.device)
    _check_geometry(bits.numel(), k)
    out = torch.empty(n, dtype=torch.bool, device=keys.device)
    lib = _build.load("bloom")
    with torch.cuda.device(keys.device):
        rc = lib.bloom_probe_launch(
            keys.data_ptr(), n, bits.data_ptr(), bits.numel(), k,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check("bloom", rc, "bloom_probe")
    LAUNCHES["bloom_probe"] += 1
    return out


def build_cuda(keys: torch.Tensor, m_words: int, k: int) -> torch.Tensor:
    """:func:`build_plain` on the card (``bloom_build_launch``)."""
    _check_cuda(keys, torch.int64, "keys", keys.device)
    _check_geometry(m_words, k)
    bits = torch.zeros(m_words, dtype=torch.int32, device=keys.device)
    n = keys.numel()
    if n == 0:
        return bits
    lib = _build.load("bloom")
    with torch.cuda.device(keys.device):
        rc = lib.bloom_build_launch(
            keys.data_ptr(), n, bits.data_ptr(), m_words, k,
            torch.cuda.current_stream().cuda_stream)
    _build.check("bloom", rc, "bloom_build")
    LAUNCHES["bloom_build"] += 1
    return bits
