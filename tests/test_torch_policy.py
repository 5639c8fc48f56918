"""repro_torch's merge policies vs the reference's (paper Eq. 4-6).

Every case of ``tests/test_policy.py`` (Eq. 4's capacity ratio, c = 1 as
Leveling, capacities growing with L, Eq. 6's sub-logarithmic levels,
delayed compaction, plan ordering, the Garnering invariants under
hypothesis, Eq. 6 against a growing tree, and every policy's plan loop
reaching a quiet state), with the same parameters and strategies, on
``repro_torch.core.policy``.  Each case also holds the port against the
reference on the same inputs: capacities and Eq. 6 equal as floats, every
planned ``(L, task, delayed)`` equal, and the growing trees of
``test_predicted_levels_tracks_empirical_growth`` built by
``repro_torch.LSMStore(device="cpu")`` beside ``repro.core.LSMStore`` with
equal levels and IOStats.
"""
import dataclasses
import math

import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as ref
from repro_torch.core import (Garnering, Leveling, LSMConfig, LSMStore,
                              make_policy)

# Six xdist workers share 8 cores with the reference's timing-bounded
# property tests: one intra-op thread per worker keeps them on time.
torch.set_num_threads(1)


def plan_fields(planned):
    """(L, task fields or None, delayed) of a ``plan`` result, comparable
    across the two packages."""
    new_L, task, delayed = planned
    return (new_L, None if task is None else dataclasses.astuple(task),
            delayed)


def test_eq4_capacity_ratio():
    """C_i / C_{i-1} = T / c^{L-i} (Eq. 4), with C_0 = B."""
    g = Garnering(T=2.0, c=0.8)
    want = ref.Garnering(T=2.0, c=0.8)
    B, L = 1 << 20, 7
    prev = float(B)
    for i in range(1, L + 1):
        cap = g.capacity(i, L, B)
        assert cap == want.capacity(i, L, B)
        assert cap / prev == pytest.approx(2.0 / 0.8 ** (L - i), rel=1e-9)
        prev = cap


def test_c_equals_one_is_leveling():
    """Paper §4.1: Garnering with c=1 has Leveling's capacity ratios."""
    g = Garnering(T=3.0, c=1.0)
    lv = Leveling(T=3.0)
    for i in range(1, 8):
        assert g.capacity(i, 8, 1000) == pytest.approx(lv.capacity(i, 8, 1000))
        assert lv.capacity(i, 8, 1000) == \
            ref.Leveling(T=3.0).capacity(i, 8, 1000)


def test_capacities_grow_with_L():
    """Delayed last-level compaction is sound because every capacity grows
    when L grows (paper §3.1)."""
    g = Garnering(T=2.0, c=0.8)
    want = ref.Garnering(T=2.0, c=0.8)
    for i in range(1, 6):
        for L in range(i, 10):
            assert g.capacity(i, L + 1, 1000) > g.capacity(i, L, 1000)
            assert g.capacity(i, L, 1000) == want.capacity(i, L, 1000)


def test_eq6_levels_sublogarithmic():
    g = Garnering(T=2.0, c=0.8)
    want = ref.Garnering(T=2.0, c=0.8)
    B = 1 << 20
    prev_L = 0.0
    ratios = []
    for k in range(4, 16):
        L = g.predicted_levels(B * 2 ** k, B)
        assert L == want.predicted_levels(B * 2 ** k, B)
        ratios.append(L / math.sqrt(k))
        assert L >= prev_L
        prev_L = L
    # L / sqrt(log N) is ~constant => predicted levels track Eq. 6
    assert max(ratios) / min(ratios) < 1.6


def test_delayed_compaction_counted():
    g = Garnering(T=2.0, c=0.8)
    B = 1000
    # last level (1) marginally overfull: plan grows L instead of compacting
    # (capacity(1, 2) = capacity(1, 1)/c covers the overflow — §3.1)
    levels = [[], [int(g.capacity(1, 1, B) * 1.1)]]
    planned = g.plan(levels, 1, B)
    new_L, task, delayed = planned
    assert delayed >= 1 and new_L >= 2
    assert task is None or task.src_level == 0
    assert plan_fields(planned) == plan_fields(
        ref.Garnering(T=2.0, c=0.8).plan(levels, 1, B))


def test_garnering_plan_prioritizes_lower_levels():
    g = Garnering(T=2.0, c=0.8, l0_trigger=4)
    B = 1000
    big = int(1e9)
    levels = [[], [big], [big]]
    planned = g.plan(levels, 3, B)
    new_L, task, _ = planned
    assert task is not None and task.src_level == 1
    assert plan_fields(planned) == plan_fields(
        ref.Garnering(T=2.0, c=0.8, l0_trigger=4).plan(levels, 3, B))


# ---------------------------------------------------- Garnering invariants
@given(st.floats(min_value=1.1, max_value=8.0),
       st.integers(min_value=1, max_value=12),
       st.integers(min_value=10, max_value=10 ** 9))
@settings(max_examples=40, deadline=None)
def test_c1_capacities_equal_leveling_exactly(T, L, B):
    """Paper §4.1: Garnering with c=1 *is* Leveling — capacities are equal
    exactly (c^x == 1.0 in floating point), at every level and tree height."""
    g = Garnering(T=T, c=1.0)
    lv = Leveling(T=T)
    for i in range(1, L + 1):
        assert g.capacity(i, L, B) == lv.capacity(i, L, B)
        assert g.capacity(i, L, B) == \
            ref.Garnering(T=T, c=1.0).capacity(i, L, B)


@given(st.floats(min_value=1.1, max_value=8.0),
       st.floats(min_value=0.05, max_value=1.0),
       st.integers(min_value=1, max_value=12),
       st.integers(min_value=10, max_value=10 ** 9))
@settings(max_examples=60, deadline=None)
def test_capacities_monotone_in_level(T, c, L, B):
    """C_i is strictly increasing in i (Eq. 4: each ratio is T/c^{L-i} > 1),
    so deeper levels always hold more — the shape delayed compaction needs."""
    g = Garnering(T=T, c=c)
    caps = [g.capacity(i, L, B) for i in range(1, L + 1)]
    assert caps == [ref.Garnering(T=T, c=c).capacity(i, L, B)
                    for i in range(1, L + 1)]
    for lo, hi in zip(caps, caps[1:]):
        assert hi > lo


def test_predicted_levels_tracks_empirical_growth():
    """Eq. 6's prediction stays within a constant factor of the levels an
    actual Garnering tree grows as N scales up."""
    ratios = []
    for n in (2000, 6000, 18000):
        kw = dict(policy="garnering", T=2.0, c=0.8, memtable_bytes=1 << 12,
                  base_level_bytes=1 << 14)
        db = LSMStore(LSMConfig(**kw), device="cpu")
        want = ref.LSMStore(ref.LSMConfig(**kw))
        for k in range(n):
            db.put(k, b"x" * 40)
            want.put(k, b"x" * 40)
        db.flush()
        want.flush()
        pred = db.policy.predicted_levels(n * 56, db.config.base_level_bytes)
        emp = db.num_levels_in_use
        assert emp >= 1 and pred > 0
        assert (emp, pred) == (want.num_levels_in_use,
                               want.policy.predicted_levels(
                                   n * 56, want.config.base_level_bytes))
        assert dataclasses.asdict(db.stats) == dataclasses.asdict(want.stats)
        ratios.append(emp / pred)
    # constant-factor tracking: the ratio neither explodes nor collapses
    assert 0.3 < min(ratios) and max(ratios) < 3.5
    assert max(ratios) / min(ratios) < 2.0


@pytest.mark.parametrize("name", ["leveling", "tiering", "lazy-leveling",
                                  "qlsm-bush", "garnering"])
def test_plan_terminates(name):
    """Repeatedly applying plan+simulated-merge reaches a quiet state, with
    the reference's plan at every step."""
    p = make_policy(name, T=2.0, c=0.8)
    want = ref.make_policy(name, T=2.0, c=0.8)
    B = 1000
    levels = [[B] * 6, [B], [2 * B], [4 * B]]
    L = 3
    for _ in range(100):
        expected = plan_fields(want.plan(levels, L, B))
        planned = p.plan(levels, L, B)
        assert plan_fields(planned) == expected
        L, task, _ = planned
        if task is None:
            break
        while len(levels) <= task.dst_level:
            levels.append([])
        moved = sum(levels[task.src_level])
        if task.include_dst:
            levels[task.dst_level] = [moved + sum(levels[task.dst_level])]
        else:
            levels[task.dst_level].append(moved)
        levels[task.src_level] = []
    else:
        pytest.fail(f"{name}: compaction loop did not quiesce")
