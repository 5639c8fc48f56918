"""Bloom filters on the device + the Monkey/Autumn FPR allocation (host).

Counterpart of ``repro.core.bloom``.  ``BloomFilter`` keeps its uint32 word
bitset as an int32 tensor on the run's device and builds and probes it
through :mod:`repro_torch.kernels.ops` (the CUDA kernels on the card, their
plain versions on the CPU), with the reference's geometry
(``m_bits`` rounded up to whole words, ``k = round(bits_per_key * ln2)``)
and hash family, so its bits equal ``repro.core.bloom.build_bits`` word for
word.

``allocate_fprs``, ``bits_for_fpr``, ``theoretical_fpr`` and the analytic
read-cost model (``fprs_to_bits_per_key``, ``garnering_theoretical_fprs``,
``zero_result_read_cost``) are the reference's host math, copied: minimize
the zero-result point-read cost R = sum_i p_i subject to the total filter
memory budget (paper Eq. 7-10).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops

LN2 = math.log(2.0)
LN2_SQ = LN2 * LN2


def bloom_geometry(n_keys: int, bits_per_key: float) -> Tuple[int, int]:
    """(m_bits, k) of the reference's filter over ``n_keys`` keys; (0, 0)
    is the degenerate filter that answers "maybe" for everything."""
    if n_keys == 0 or bits_per_key <= 0:
        return 0, 0
    # whole uint32 words: the probe derives m from the word count
    m = -(-max(64, int(round(bits_per_key * n_keys))) // 32) * 32
    return m, max(1, int(round(bits_per_key * LN2)))


class BloomFilter:
    """Double-hashing bloom filter over order-mapped int64 key tensors.

    ``bits`` is an int32 tensor of ``m_bits // 32`` words on the keys'
    device.  ``geometry=(m_bits, k)`` rebuilds a filter of a known shape
    (state carried across from another store) instead of deriving it from
    ``bits_per_key``.
    """

    __slots__ = ("m_bits", "k", "bits", "n_keys")

    def __init__(self, keys: torch.Tensor, bits_per_key: float,
                 geometry: Optional[Tuple[int, int]] = None):
        self.n_keys = int(keys.numel())
        m, k = geometry if geometry is not None \
            else bloom_geometry(self.n_keys, bits_per_key)
        if m == 0 or k == 0:
            m, k = 0, 0
            self.bits = torch.zeros(0, dtype=torch.int32, device=keys.device)
        else:
            self.bits = ops.bloom_build(keys, m // 32, k)
        self.m_bits = m
        self.k = k

    def may_contain(self, keys: torch.Tensor) -> torch.Tensor:
        """(n,) bool: True = maybe present, False = absent."""
        return ops.bloom_probe(keys, self.bits, self.k)

    def bits_numpy(self) -> np.ndarray:
        """The words as the reference's uint32 numpy array."""
        return self.bits.cpu().numpy().view(np.uint32)

    @property
    def memory_bits(self) -> int:
        return self.m_bits

    def expected_fpr(self) -> float:
        if self.m_bits == 0:
            return 1.0
        return theoretical_fpr(self.m_bits / max(self.n_keys, 1))


def theoretical_fpr(bits_per_key: float) -> float:
    """Eq. 2: FPR = e^{-ln(2)^2 * M/N}."""
    if bits_per_key <= 0:
        return 1.0
    return math.exp(-LN2_SQ * bits_per_key)


def bits_for_fpr(p: float) -> float:
    """Invert Eq. 2: bits/key needed for target FPR p (p in (0, 1])."""
    if p >= 1.0:
        return 0.0
    return -math.log(p) / LN2_SQ


def allocate_fprs(level_sizes: Sequence[int], total_bits: float) -> np.ndarray:
    """Monkey/Autumn water-filling (Eq. 7-10 generalized to measured N_i).

    Minimize sum_i p_i  s.t.  sum_i (-N_i ln p_i / ln2^2) = total_bits,
    0 < p_i <= 1.  KKT => p_i = lam * N_i on the interior, p_i = 1 where the
    budget runs out (largest levels saturate first, exactly as the paper sets
    p_L = 1 in the "Filter Memory Budget" analysis).
    Returns the optimal per-level FPRs.
    """
    sizes = np.asarray([max(int(s), 0) for s in level_sizes], dtype=np.float64)
    L = sizes.size
    fprs = np.ones(L)
    if total_bits <= 0 or L == 0:
        return fprs
    active = sizes > 0
    # Saturate levels (p_i = 1) from the largest down until the remaining
    # budget supports an interior solution with p_i <= 1 for all active i.
    order = np.argsort(-sizes)  # largest first
    saturated = np.zeros(L, dtype=bool)
    for cut in range(L + 1):
        interior = active & ~saturated
        if not interior.any():
            break
        n_int = sizes[interior]
        # Interior solution: p_i = lam*N_i; budget constraint gives
        # sum(-N_i ln(lam N_i)) / ln2^2 = total_bits  =>  solve for ln lam.
        s = n_int.sum()
        ln_lam = -(total_bits * LN2_SQ + (n_int * np.log(n_int)).sum()) / s
        p = np.exp(ln_lam) * n_int
        if (p <= 1.0 + 1e-12).all():
            fprs[interior] = np.minimum(p, 1.0)
            return fprs
        # Saturate the largest not-yet-saturated level and retry.
        for idx in order:
            if active[idx] and not saturated[idx]:
                saturated[idx] = True
                break
    return fprs


def fprs_to_bits_per_key(fprs: Sequence[float]) -> np.ndarray:
    return np.asarray([bits_for_fpr(p) for p in fprs])


def garnering_theoretical_fprs(L: int, T: float, c: float, p_last: float = 1.0
                               ) -> np.ndarray:
    """Closed-form Eq. 9: p_{L-i} = p_L * c^{i(i-1)/2} / T^i (1-indexed levels)."""
    out = np.empty(L)
    for i in range(L):  # i = distance from last level
        out[L - 1 - i] = p_last * (c ** (i * (i - 1) / 2)) / (T ** i)
    return np.minimum(out, 1.0)


def zero_result_read_cost(fprs: Sequence[float]) -> float:
    """Eq. 7: expected blocks read by a point query for an absent key."""
    return float(np.sum(fprs))
