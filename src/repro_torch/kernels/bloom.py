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
``csrc/bloom.cu``; each adds one to :data:`LAUNCHES` where it launches (a
build is two kernels, counted once) and appends its size to
:data:`LAUNCH_SIZES` (keys of a build; keys and filter words of a
probe).  :func:`build_plan` sizes the build's
slices and passes from the filter, the keys and the card's shared memory
and SM count; :func:`fastmod` is the exact remainder the kernels use.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, Tuple

import torch

from .. import _build

M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1

# kernel launches by wrapper (see ops.launch_counts)
LAUNCHES = {"bloom_probe": 0, "bloom_build": 0}
# keys of every bloom_build launch, and (keys, filter words) of every
# bloom_probe launch, in order (see ops.launch_sizes)
LAUNCH_SIZES: Dict[str, list] = {"bloom_build": [], "bloom_probe": []}

HASH_OPS = 30      # hash_pair: two mix32 chains, xors, or
PROBE_OPS = 6      # one bit test: mul, add, mod, shift, and, test
H100_SMEM_OPTIN = 232_448    # bytes of shared memory one block may take
H100_SMS = 132               # streaming multiprocessors of an H100 SXM
STAGE = 32_768               # positions a bucket block sorts, at the most
MIN_STAGE = 2_048            # and at the least
MAX_SLICES = 4_096           # slices a bucket block counts in shared memory
MIN_SLICE_SHIFT = 12         # 2^12-bit slices at the least (512 bytes)
U16_SLICE_SHIFT = 16         # the largest slices with 16-bit offsets


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


def probe_work(n: int, m_words: int, k: int) -> Tuple[int, int]:
    """``(operations, bytes)`` of a probe of ``n`` keys from shapes alone:
    every key's hash and all ``k`` bit tests (a clear bit stops a key
    early, which only its data shows), the keys read, one byte out a
    key, and each filter word that ``k`` positions a key can reach read
    once."""
    return n * (HASH_OPS + k * PROBE_OPS), n * 9 + min(m_words, n * k) * 4


def build_work(n: int, m_words: int, k: int) -> Tuple[int, int]:
    """``(operations, bytes)`` of a build of ``n`` keys into ``m_words``
    words: the hash and ``k`` positions a key, the keys read and the words
    written once."""
    return n * (HASH_OPS + k * PROBE_OPS), n * 8 + m_words * 4


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


# ------------------------------------------------------------ the kernels' plan
def fastmod_magic(d: int) -> int:
    """The 64-bit magic of :func:`fastmod` for divisor ``1 <= d < 2^32``:
    2^64 / d rounded up, modulo 2^64."""
    return (M64 // d + 1) & M64


def fastmod(a: int, magic: int, d: int) -> int:
    """``a % d`` for 32-bit ``a`` as the kernels compute it: the high 64
    bits of ((magic * a) mod 2^64) * d (Lemire's fastmod), taken as
    (hi * d + (lo * d >> 32)) >> 32 of that low product's 32-bit halves."""
    low = (magic * a) & M64
    return ((low >> 32) * d + (((low & M32) * d) >> 32)) >> 32


@dataclasses.dataclass(frozen=True)
class BuildPlan:
    """How ``csrc/bloom.cu`` builds one filter: a bucket pass of ``blocks``
    blocks of ``keys_per_block`` keys (``keys_per_block * k <= stage``),
    then one block per slice of ``2^slice_shift`` bits; slice ``s`` holds
    words ``[s * slice_words, min((s + 1) * slice_words, m_words))`` and its
    segment ``cap`` offsets."""
    blocks: int
    keys_per_block: int
    slice_shift: int
    n_slices: int
    cap: int
    stage: int

    @property
    def slice_words(self) -> int:
        return 1 << (self.slice_shift - 5)

    @property
    def offset_bytes(self) -> int:
        """Bytes of one in-slice offset in the segments."""
        return 2 if self.slice_shift <= U16_SLICE_SHIFT else 4


def slice_cap(expected: float) -> int:
    """Offsets a segment holds: the expected count plus eight standard
    deviations (binomial, so about sqrt(expected)) plus 64, rounded up to a
    multiple of 8 so that every segment starts 16-byte aligned."""
    cap = expected + 8 * math.sqrt(expected) + 64
    return -(-int(math.ceil(cap)) // 8) * 8


def bucket_smem(stage: int, n_slices: int) -> int:
    """Shared memory of a bucket block: ``stage`` positions, two counters a
    slice and 32 words of scan scratch."""
    return 4 * (stage + 2 * n_slices + 32)


def build_plan(n: int, m_words: int, k: int,
               smem_bytes: int = H100_SMEM_OPTIN,
               sm_count: int = H100_SMS) -> BuildPlan:
    """The build's plan for ``n`` keys, ``m_words`` filter words and ``k``
    bits a key on a card of ``sm_count`` SMs whose blocks may take
    ``smem_bytes`` of shared memory."""
    _check_geometry(m_words, k)
    m_bits = 32 * m_words
    # about 1,024 slices, so that the set pass fills the card, but slices
    # of 2^12 to 2^16 bits (16-bit offsets) where MAX_SLICES allow
    log_m = (m_bits - 1).bit_length()
    shift = max(log_m - (MAX_SLICES.bit_length() - 1),
                min(U16_SLICE_SHIFT, max(MIN_SLICE_SHIFT, log_m - 10)))
    n_slices = -(-m_bits >> shift)
    # a bucket block stages up to STAGE positions, fewer while the keys
    # would leave SMs without a block (the runs shorten, the card fills)
    per_sm = max(1, n * k // sm_count)
    stage = min(STAGE, max(MIN_STAGE, 1 << (per_sm.bit_length() - 1)))
    while stage > k and bucket_smem(stage, n_slices) > smem_bytes:
        stage //= 2
    if k > stage or (1 << shift) // 8 > smem_bytes:
        raise ValueError(f"no build plan for k={k}, {m_words} words in "
                         f"{smem_bytes} bytes of shared memory")
    kpb = stage // k
    return BuildPlan(max(1, -(-n // kpb)), kpb, shift, n_slices,
                     slice_cap(n * k * (1 << shift) / m_bits), stage)


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
    sms = card_limits(keys.device)[1]
    with torch.cuda.device(keys.device):
        rc = lib.bloom_probe_launch(
            keys.data_ptr(), n, bits.data_ptr(), bits.numel(), k,
            out.data_ptr(), sms, torch.cuda.current_stream().cuda_stream)
    _build.check("bloom", rc, "bloom_probe")
    with _build.COUNT_LOCK:
        LAUNCHES["bloom_probe"] += 1
        LAUNCH_SIZES["bloom_probe"].append((n, bits.numel()))
    return out


_card: Dict[int, Tuple[int, int]] = {}


def card_limits(device: torch.device) -> Tuple[int, int]:
    """(bytes of shared memory one block may take, SM count) of
    ``device``."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _card:
        lib = _build.load("bloom")
        smem = ctypes.c_int(0)
        _build.check("bloom", lib.bloom_smem_optin(index, ctypes.byref(smem)),
                     "bloom_smem_optin")
        _card[index] = (smem.value, torch.cuda.get_device_properties(
            index).multi_processor_count)
    return _card[index]


def build_cuda(keys: torch.Tensor, m_words: int, k: int) -> torch.Tensor:
    """:func:`build_plain` on the card (``bloom_build_launch``), sized by
    :func:`build_plan`."""
    _check_cuda(keys, torch.int64, "keys", keys.device)
    _check_geometry(m_words, k)
    n = keys.numel()
    if n == 0:
        return torch.zeros(m_words, dtype=torch.int32, device=keys.device)
    lib = _build.load("bloom")
    plan = build_plan(n, m_words, k, *card_limits(keys.device))
    bits = torch.empty(m_words, dtype=torch.int32, device=keys.device)
    fill = torch.zeros(plan.n_slices, dtype=torch.int64, device=keys.device)
    seg = torch.empty(plan.n_slices * plan.cap * plan.offset_bytes,
                      dtype=torch.uint8, device=keys.device)
    with torch.cuda.device(keys.device):
        rc = lib.bloom_build_launch(
            keys.data_ptr(), n, bits.data_ptr(), m_words, k,
            plan.keys_per_block, plan.slice_shift, plan.n_slices, plan.stage,
            plan.cap, fill.data_ptr(), seg.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check("bloom", rc, "bloom_build")
    with _build.COUNT_LOCK:
        LAUNCHES["bloom_build"] += 1
        LAUNCH_SIZES["bloom_build"].append(n)
    return bits
