"""Merge policies: Leveling, Tiering, Lazy-Leveling, QLSM-Bush, and Garnering.

A verbatim copy of ``repro.core.policy`` (pure Python, host only): the port
plans compactions exactly as the reference does.

A policy answers two questions given the current tree state:
  * ``capacity(i, L, B)`` — byte capacity of level i (1-indexed; level 0 is
    the tiered flush level, capped by run count not bytes).
  * ``plan(...)`` — the next compaction task, or None when the tree is shaped.

Garnering (the paper's contribution, §3.1) implements:
  Eq. 4   C_i / C_{i-1} = T / c^{L-i}
  Eq. 5   C_i = B * T^i / c^{(2L-1-i) i / 2}
  Delayed last-level compaction — when level L overflows, grow L instead of
  compacting (every capacity grows with L, so the overflow resolves itself),
  counting ``delayed_last_level_compactions``.
  L0 tiering (§3.2) — level 0 holds a constant number of runs and flush never
  merges; this is shared by all policies here, as in RocksDB/LevelDB.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class CompactionTask:
    src_level: int
    dst_level: int
    include_dst: bool  # True => sort-merge with dst runs (leveled landing)
    reason: str
    # Input freshness guard for decoupled generation/apply (async scheduler):
    # the planner captures the source level's run ids at plan time; apply
    # refuses a task whose inputs no longer match the tree (the scheduler
    # then replans against current state).  None (the policies' own tasks)
    # means "apply against whatever is there now" — the synchronous
    # plan-then-apply loop never goes stale.
    src_run_ids: Optional[Tuple[int, ...]] = None

    def matches(self, src_runs: Sequence) -> bool:
        """True iff the task's captured inputs are still the level's runs."""
        if self.src_run_ids is None:
            return True
        return tuple(r.run_id for r in src_runs) == self.src_run_ids


LevelSizes = Sequence[Sequence[int]]  # [level][run] -> bytes


def _level_bytes(levels: LevelSizes, i: int) -> int:
    return sum(levels[i]) if i < len(levels) else 0


def _run_count(levels: LevelSizes, i: int) -> int:
    return len(levels[i]) if i < len(levels) else 0


class MergePolicy:
    name = "base"

    def __init__(self, T: float = 2.0, c: float = 1.0, l0_trigger: int = 4):
        assert T > 1, "size ratio T must exceed 1"
        assert 0 < c <= 1.0, "Garnering scaling factor c must be in (0, 1]"
        self.T = float(T)
        self.c = float(c)
        self.l0_trigger = int(l0_trigger)

    def retuned(self, *, T: Optional[float] = None,
                c: Optional[float] = None) -> "MergePolicy":
        """A fresh policy of the same family with adjusted knobs — the
        online tuner's level-ratio actuator (DESIGN.md §17).  The caller
        swaps it in at a compaction-chain boundary; only *future* ``plan``
        calls see the new capacities, so the installed tree is never
        rewritten (Garnering's capacities are pure functions of (i, L, B),
        no state carries over)."""
        return type(self)(T=self.T if T is None else T,
                          c=self.c if c is None else c,
                          l0_trigger=self.l0_trigger)

    # -- shape -----------------------------------------------------------
    def capacity(self, i: int, L: int, B: int) -> float:
        raise NotImplementedError

    def runs_allowed(self, i: int, L: int) -> int:
        return 1

    # -- planning --------------------------------------------------------
    def plan(self, levels: LevelSizes, L: int, B: int
             ) -> Tuple[int, Optional[CompactionTask], int]:
        """Returns (new_L, task_or_None, delayed_compactions_added)."""
        raise NotImplementedError

    # shared L0 handling: flush-only level, run-count trigger
    def _l0_task(self, levels: LevelSizes) -> Optional[CompactionTask]:
        if _run_count(levels, 0) >= self.l0_trigger:
            return CompactionTask(0, 1, True, "l0-run-count")
        return None


class Leveling(MergePolicy):
    """Classic leveled LSM: C_i = B * T^i, one run per level (§2.3.1)."""

    name = "leveling"

    def capacity(self, i: int, L: int, B: int) -> float:
        return B * self.T ** i

    def plan(self, levels, L, B):
        L = max(L, _deepest(levels))
        t = self._l0_task(levels)
        if t:
            return L, t, 0
        for i in range(1, len(levels)):
            if _level_bytes(levels, i) > self.capacity(i, L, B):
                return max(L, i + 1), CompactionTask(i, i + 1, True, "over-capacity"), 0
        return L, None, 0


class Tiering(MergePolicy):
    """Tiered LSM: level i holds up to T runs of size ~B*T^(i-1) (§2.3.1)."""

    name = "tiering"

    def capacity(self, i: int, L: int, B: int) -> float:
        return B * self.T ** i

    def runs_allowed(self, i: int, L: int) -> int:
        return max(2, int(math.ceil(self.T)))

    def plan(self, levels, L, B):
        L = max(L, _deepest(levels))
        if _run_count(levels, 0) >= self.l0_trigger:
            return L, CompactionTask(0, 1, False, "l0-run-count"), 0
        for i in range(1, len(levels)):
            if _run_count(levels, i) >= self.runs_allowed(i, L):
                return max(L, i + 1), CompactionTask(i, i + 1, False, "run-count"), 0
        return L, None, 0


class LazyLeveling(MergePolicy):
    """Dostoevsky's lazy leveling: tiered at levels 1..L-1, leveled last."""

    name = "lazy-leveling"

    def capacity(self, i: int, L: int, B: int) -> float:
        return B * self.T ** i

    def runs_allowed(self, i: int, L: int) -> int:
        return 1 if i >= L else max(2, int(math.ceil(self.T)))

    def plan(self, levels, L, B):
        L = max(L, _deepest(levels), 1)
        t = self._l0_task(levels)
        if t and L == 1:
            return L, CompactionTask(0, 1, True, "l0-run-count"), 0
        if _run_count(levels, 0) >= self.l0_trigger:
            return L, CompactionTask(0, 1, False, "l0-run-count"), 0
        for i in range(1, len(levels)):
            if i < L and _run_count(levels, i) >= self.runs_allowed(i, L):
                grow = i + 1 > L
                return max(L, i + 1), CompactionTask(i, i + 1, i + 1 >= L and not grow,
                                                     "run-count"), 0
            if i == L and _level_bytes(levels, i) > self.capacity(i, L, B):
                return L + 1, CompactionTask(i, i + 1, True, "last-over-capacity"), 0
        return L, None, 0


class QLSMBush(MergePolicy):
    """LSM-Bush approximation: doubly-exponential gaps, C_i = B*T^(2^i - 1).

    Level i (i < L) holds up to C_i/C_{i-1} = T^(2^(i-1)) runs; the last level
    is one run.  Used only as a Table-2/Fig-1 baseline (DESIGN.md §1).
    """

    name = "qlsm-bush"

    def capacity(self, i: int, L: int, B: int) -> float:
        return B * self.T ** (2 ** i - 1)

    def runs_allowed(self, i: int, L: int) -> int:
        if i >= L:
            return 1
        return max(2, int(math.ceil(self.T ** (2 ** (i - 1)))))

    def plan(self, levels, L, B):
        L = max(L, _deepest(levels), 1)
        if _run_count(levels, 0) >= self.l0_trigger:
            return L, CompactionTask(0, 1, L == 1, "l0-run-count"), 0
        for i in range(1, len(levels)):
            if i < L and _run_count(levels, i) >= self.runs_allowed(i, L):
                return max(L, i + 1), CompactionTask(i, i + 1, False, "run-count"), 0
            if i == L and _level_bytes(levels, i) > self.capacity(i, L, B):
                return L + 1, CompactionTask(i, i + 1, True, "last-over-capacity"), 0
        return L, None, 0


class Garnering(MergePolicy):
    """The paper's policy (§3.1). One run per level; capacities from Eq. 5
    grow with the total level count L; last-level compactions are delayed by
    growing L instead."""

    name = "garnering"

    def capacity(self, i: int, L: int, B: int) -> float:
        # Eq. 5: C_i = T^i / c^((2L-1-i) i / 2) * B.  With c = 1 this is
        # exactly Leveling, as the paper notes (§4.1).
        expo = (2 * L - 1 - i) * i / 2.0
        return B * (self.T ** i) / (self.c ** expo)

    def predicted_levels(self, N: int, B: int) -> float:
        """Eq. 6: L = O(sqrt(-log_c(N/(B*T))))."""
        x = max(N / (B * self.T), 1.000001)
        if self.c >= 1.0:
            return math.log(x) / math.log(self.T) + 1
        return math.sqrt(math.log(x) / math.log(1.0 / self.c))

    def plan(self, levels, L, B):
        L = max(L, _deepest(levels), 1)
        delayed = 0
        # Delayed last-level compaction: grow L until the last level fits.
        while _level_bytes(levels, L) > self.capacity(L, L, B):
            L += 1
            delayed += 1
        t = self._l0_task(levels)
        if t:
            return L, t, delayed
        # Lower levels first — Garnering inherently concentrates merges there.
        for i in range(1, min(len(levels), L)):
            if _level_bytes(levels, i) > self.capacity(i, L, B):
                return L, CompactionTask(i, i + 1, True, "over-capacity"), delayed
        return L, None, delayed


POLICIES = {p.name: p for p in (Leveling, Tiering, LazyLeveling, QLSMBush, Garnering)}


def make_policy(name: str, T: float = 2.0, c: float = 1.0,
                l0_trigger: int = 4) -> MergePolicy:
    if name not in POLICIES:
        raise ValueError(f"unknown policy {name!r}; options: {sorted(POLICIES)}")
    return POLICIES[name](T=T, c=c, l0_trigger=l0_trigger)


def _deepest(levels: LevelSizes) -> int:
    deepest = 0
    for i in range(len(levels)):
        if levels[i]:
            deepest = i
    return deepest
