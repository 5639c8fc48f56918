"""repro_torch's bloom filters and filter allocation vs the reference's.

Every case of ``tests/test_bloom.py`` (paper Eq. 2, 7-10: no false
negatives, the false-positive rate of Eq. 2, the degenerate filter, the
Monkey water-filling's budget and KKT conditions, Eq. 9 against
water-filling, the read cost's convergence, Eq. 2's inverse), with the same
seeds, sizes and hypothesis strategies, on ``repro_torch.core``: filters on
CPU tensors (the plain versions of the port's bloom kernels) beside the
reference's numpy filters, with equal bits and equal answers; the host
math equal to the reference's (the allocation exactly, Eq. 7/9 within
1e-12).  Below them, the read-cost model's helpers and the filter's
``memory_bits``/``expected_fpr`` against the reference, through every way
a port filter is built.
"""
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as ref
import repro.core.bloom as ref_bloom
import repro_torch as rt
from repro_torch.core import (BloomFilter, allocate_fprs, bits_for_fpr,
                              garnering_theoretical_fprs, theoretical_fpr,
                              zero_result_read_cost)
from repro_torch.core import bloom as port_bloom
from repro_torch.kernels import ops

# Six xdist workers share 8 cores with the reference's timing-bounded
# property tests: one intra-op thread per worker keeps them on time.
torch.set_num_threads(1)


def port_filter(keys: np.ndarray, bits_per_key: float) -> BloomFilter:
    return BloomFilter(ops.keys_to_device(keys, "cpu"), bits_per_key)


def may_contain(bf: BloomFilter, keys: np.ndarray) -> np.ndarray:
    return bf.may_contain(ops.keys_to_device(keys, "cpu")).numpy()


def assert_same_filter(bf: BloomFilter, want: "ref.BloomFilter", probes):
    assert (bf.m_bits, bf.k, bf.n_keys) == (want.m_bits, want.k, want.n_keys)
    np.testing.assert_array_equal(bf.bits_numpy(), want.bits)
    np.testing.assert_array_equal(may_contain(bf, probes),
                                  want.may_contain(probes))


def test_no_false_negatives():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**63, 5000, dtype=np.uint64)
    bf = port_filter(keys, bits_per_key=10)
    assert may_contain(bf, keys).all()
    assert_same_filter(bf, ref.BloomFilter(keys, bits_per_key=10), keys)


def test_fpr_matches_eq2():
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 2**62, 20_000, dtype=np.uint64)
    bf = port_filter(keys, bits_per_key=10)
    absent = rng.integers(2**62, 2**63, 50_000, dtype=np.uint64)
    fpr = float(np.mean(may_contain(bf, absent)))
    expected = theoretical_fpr(10)  # ~0.0082 (paper: 10 bits => ~1%)
    assert fpr < 3 * expected and fpr > expected / 5
    assert_same_filter(bf, ref.BloomFilter(keys, bits_per_key=10), absent)


def test_zero_bits_always_maybe():
    keys = np.arange(10, dtype=np.uint64)
    bf = port_filter(keys, bits_per_key=0)
    probes = np.arange(100, dtype=np.uint64)
    assert may_contain(bf, probes).all()
    assert_same_filter(bf, ref.BloomFilter(keys, bits_per_key=0), probes)


@given(st.lists(st.integers(min_value=0, max_value=10**7), min_size=1,
                max_size=8),
       st.floats(min_value=1.0, max_value=16.0))
@settings(max_examples=60, deadline=None)
def test_monkey_allocation_budget_and_kkt(sizes, bits_per_key):
    """Water-filling invariants: (a) budget is respected, (b) interior FPRs
    are proportional to level sizes (KKT), (c) all FPRs in (0, 1]; and the
    allocation is the reference's, exactly."""
    total = sum(sizes)
    if total == 0:
        return
    budget = bits_per_key * total
    fprs = allocate_fprs(sizes, budget)
    np.testing.assert_array_equal(fprs, ref.allocate_fprs(sizes, budget))
    assert ((fprs > 0) & (fprs <= 1.0 + 1e-12)).all()
    spent = sum(-n * math.log(p) / math.log(2) ** 2
                for n, p in zip(sizes, fprs) if n > 0)
    assert spent <= budget * 1.001
    interior = [(n, p) for n, p in zip(sizes, fprs) if n > 0 and p < 0.999]
    for (n1, p1), (n2, p2) in zip(interior, interior[1:]):
        assert p1 * n2 == pytest.approx(p2 * n1, rel=1e-6)


def test_eq9_closed_form_matches_waterfilling():
    """Optimal FPRs on Garnering capacities reproduce Eq. 9's shape."""
    T, c, L, B = 2.0, 0.8, 6, 1000
    sizes = [int(B * T ** i / c ** ((2 * L - 1 - i) * i / 2))
             for i in range(1, L + 1)]
    fprs = allocate_fprs(sizes, 8.0 * sum(sizes))
    theory = garnering_theoretical_fprs(L, T, c, p_last=fprs[-1])
    np.testing.assert_array_equal(fprs, ref.allocate_fprs(sizes,
                                                          8.0 * sum(sizes)))
    np.testing.assert_allclose(
        theory, ref.garnering_theoretical_fprs(L, T, c, p_last=fprs[-1]),
        rtol=0, atol=1e-12)
    interior = [i for i in range(L) if fprs[i] < 0.999]
    for i in interior:
        assert fprs[i] == pytest.approx(theory[i], rel=0.05)


def test_read_cost_converges_faster_than_geometric():
    """Paper §3.1: R = sum p_i converges to O(p_L) because numerators carry
    c^{i(i-1)/2}."""
    for L in (4, 8, 16):
        fprs = garnering_theoretical_fprs(L, T=2.0, c=0.8, p_last=0.01)
        r = zero_result_read_cost(fprs)
        geo = 0.01 * sum(0.5 ** i for i in range(L))
        assert r <= geo + 1e-12
        assert abs(r - ref.zero_result_read_cost(
            ref.garnering_theoretical_fprs(L, T=2.0, c=0.8, p_last=0.01))) \
            <= 1e-12


def test_bits_for_fpr_roundtrip():
    for p in (0.5, 0.1, 0.01, 1.0):
        assert theoretical_fpr(bits_for_fpr(p)) == pytest.approx(p, rel=1e-9)
        assert bits_for_fpr(p) == ref.bits_for_fpr(p)


# ------------------------------------------------ the read-cost model
@pytest.mark.parametrize("L", [1, 2, 5, 9, 16])
@pytest.mark.parametrize("T,c", [(2.0, 0.8), (2.0, 0.5), (3.0, 1.0),
                                 (10.0, 0.3)])
@pytest.mark.parametrize("p_last", [1.0, 0.01, 1e-5])
def test_read_cost_model_equals_the_reference(L, T, c, p_last):
    """Eq. 9's closed form, Eq. 7's cost and the bits a key of each level
    within 1e-12 of the reference's."""
    got = garnering_theoretical_fprs(L, T, c, p_last)
    want = ref_bloom.garnering_theoretical_fprs(L, T, c, p_last)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert abs(zero_result_read_cost(got)
               - ref_bloom.zero_result_read_cost(want)) <= 1e-12
    np.testing.assert_allclose(port_bloom.fprs_to_bits_per_key(got),
                               ref_bloom.fprs_to_bits_per_key(want),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("n,bits_per_key", [(0, 10.0), (1, 10.0), (5, 0.0),
                                            (7, 3.3), (3000, 10.0),
                                            (5000, 8.0)])
def test_filter_memory_bits_and_expected_fpr(n, bits_per_key):
    """``memory_bits`` and ``expected_fpr()`` equal the reference's, for a
    filter built directly, through a run, and through the carry-across of
    ``store_from_columns`` (which rebuilds the filter of a known
    geometry)."""
    keys = np.unique(np.random.default_rng(n).integers(
        0, 2**64 - 1, n, dtype=np.uint64))
    want = ref.BloomFilter(keys, bits_per_key)
    bf = port_filter(keys, bits_per_key)
    run = rt.core.build_run(ops.keys_to_device(keys, "cpu"),
                            torch.arange(keys.size, dtype=torch.int64),
                            torch.full((keys.size,), 3, dtype=torch.int32),
                            torch.ones((keys.size, 3), dtype=torch.uint8),
                            bits_per_key=bits_per_key,
                            assume_unique_sorted=True)
    cols = (keys, np.arange(keys.size, dtype=np.uint64),
            np.full(keys.size, 3, np.int32), np.ones((keys.size, 3), np.uint8),
            (want.m_bits, want.k))
    store = rt.store_from_columns(rt.LSMConfig(bits_per_key=bits_per_key),
                                  [[], [cols]], device="cpu")
    for got in (bf, run.bloom, store._levels[1][0].bloom):
        assert got.n_keys == want.n_keys == keys.size
        assert got.memory_bits == want.memory_bits
        assert got.expected_fpr() == want.expected_fpr()
