"""Online workload-adaptive tuning.

A copy of ``repro.core.tuner`` (host logic): the knob bounds and steps, the
objective and the controller's decisions are the reference's, so the same
window gives the same decision in both packages.  What differs between two
runs is only what the store measures: the objective is built from latency
histograms, so a trajectory depends on the host's timing and is compared
across packages only on synthetic windows.

The loop is sense -> decide -> actuate:

**Sense.**  Each tick reads windowed deltas: ``Telemetry.delta(prev)``
(histogram diffs per op class and the trace events since) and
``IOStats.delta`` counter diffs.

**Decide.**  A bounded hill-climb, one knob per tick (round-robin
coordinate descent with per-knob direction memory): the previous tick's
trial is kept if the objective did not worsen beyond ``tolerance``, else
reverted and its direction flipped.  Knobs and bounds
(:data:`KNOB_BOUNDS`): Garnering's ``c`` in [0.4, 1.0] and ``T`` in
[2, 6] (a retune swaps in a fresh policy that shapes only future
compactions), ``pin_frac`` (the cache <-> pinned-L0 split at constant
total memory), ``slowdown_trigger`` (multiplicative steps) and
``compaction_workers``.

The objective (:func:`tuning_objective`) is the ops-weighted mean of the
per-op-class p99 latency over the window's *foreground* classes (stalls
are inside the put histograms, so write pressure is priced in).

**Actuate.**  The tuner applies nothing mid-op: a store calls ``tick`` only
from ``apply_tuning()`` at compaction-chain or quiesce boundaries (the
scheduler idle; a synchronous store always is, between ops).  Every
decision is emitted as a ``tuner_step`` trace event.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

__all__ = ["KNOB_BOUNDS", "FOREGROUND_OPS", "OnlineTuner", "TunerStep",
           "tuning_objective"]

# Hill-climb bounds per knob (the paper's family for c/T; pressure/memory
# knobs bounded to sane engine ranges).  Stores expose only the knobs that
# exist on them (e.g. no pin_frac without a cache, no workers on a plain
# sync store) — the tuner round-robins whatever the store offers.
KNOB_BOUNDS: Dict[str, Tuple[float, float]] = {
    "c": (0.4, 1.0),
    "T": (2.0, 6.0),
    "pin_frac": (0.0, 0.75),
    "slowdown_trigger": (8, 512),
    "compaction_workers": (1, 8),
}

# Proposal step per knob: additive for the smooth knobs, multiplicative for
# slowdown_trigger (its useful range spans orders of magnitude).
_KNOB_STEP: Dict[str, float] = {
    "c": 0.1,
    "T": 1.0,
    "pin_frac": 0.125,
    "slowdown_trigger": 2.0,
    "compaction_workers": 1.0,
}
_MULTIPLICATIVE = frozenset(("slowdown_trigger",))
_INT_KNOBS = frozenset(("slowdown_trigger", "compaction_workers"))
# First trial direction: lean read-optimized (smaller c), wider ratio,
# more cache headroom for pins, less throttling, more workers.
_INIT_DIR: Dict[str, int] = {
    "c": -1, "T": 1, "pin_frac": 1, "slowdown_trigger": 1,
    "compaction_workers": 1,
}

# Op classes the objective prices: the *served* surface.  Background classes
# (flush/compaction/wal_fsync/...) are excluded — their cost already shows
# up as foreground stalls and slow reads, which is where it should be paid.
FOREGROUND_OPS = ("get", "multi_get", "scan", "seek",
                  "put", "put_batch", "write_batch")


def tuning_objective(hists: Dict[str, "LatencyHistogram"],
                     ops: Tuple[str, ...] = FOREGROUND_OPS) -> float:
    """p99-weighted cost of a window: ops-weighted mean per-class p99 (ns).

    ``sum_op n_op * p99_ns(op) / sum_op n_op`` over the foreground classes —
    the per-op tail cost a serving client sees, the same metric
    ``benchmarks/serve_latency.py`` reports (lower is better).  Weighting by
    sample count keeps a rare op class from dominating; using p99 instead of
    the mean makes stalls and cache-miss storms visible to the controller.
    Returns ``inf`` for an empty window (no decision should be made on it).
    """
    total = 0
    cost = 0.0
    for op in ops:
        h = hists.get(op)
        if h is None or h.n <= 0:
            continue
        cost += h.n * h.percentile(99.0)
        total += h.n
    return cost / total if total else math.inf


@dataclasses.dataclass
class TunerStep:
    """One controller decision (also emitted as a ``tuner_step`` event)."""

    tick: int                      # 1-based decision index
    knob: Optional[str]            # knob trialled this tick (None: none fit)
    before: float                  # its value before this tick's proposal
    after: float                   # ... and after (== before when no move)
    objective: float               # window objective that informed the tick
    prev_objective: float          # baseline it was compared against (nan
                                   # on the first decision)
    accepted: bool                 # previous trial kept (False == reverted)
    window_ops: int                # foreground samples in the window
    knobs: Dict[str, float]        # full knob vector after actuation


class OnlineTuner:
    """Feedback controller over a live store's tuning knobs.

    Attach via ``LSMConfig.tuner``; the store (or sharded facade) binds
    itself as the single owner and calls :meth:`tick` from its
    ``apply_tuning()`` boundary hook every ``interval_ops`` writes.  See the
    module docstring for the control loop; :attr:`steps` keeps the full
    decision trajectory for benchmarks/tests.
    """

    def __init__(self, interval_ops: int = 4096, *,
                 min_window_ops: int = 64, tolerance: float = 0.05,
                 bounds: Optional[Dict[str, Tuple[float, float]]] = None):
        assert interval_ops > 0 and min_window_ops > 0
        self.interval_ops = int(interval_ops)
        self.min_window_ops = int(min_window_ops)
        self.tolerance = float(tolerance)
        self.bounds = dict(KNOB_BOUNDS)
        if bounds:
            self.bounds.update(bounds)
        self.owner = None              # the one store driving this tuner
        self.ticks = 0                 # boundary ticks consumed (incl. the
                                       # baseline + too-small-window ones)
        self.steps: List[TunerStep] = []
        self._prev_tel = None          # TelemetrySnapshot at window start
        self._prev_stats = None        # IOStats at window start
        self._baseline = None          # objective the next trial compares to
        self._pending: Optional[Tuple[str, float]] = None  # (knob, before)
        self._dirs: Dict[str, int] = {}
        self._rr = 0

    # ------------------------------------------------------------ ownership
    def bind(self, store) -> bool:
        """First binder wins; per-shard configs carry ``tuner=None`` so the
        facade is the owner in sharded mode.  Returns True iff ``store`` is
        (now) the owner."""
        if self.owner is None:
            self.owner = store
        return self.owner is store

    # -------------------------------------------------------------- control
    def tick(self, store) -> Optional[TunerStep]:
        """One sense → decide → actuate pass.  Caller guarantees a
        compaction-chain/quiesce boundary (``apply_tuning`` does).

        Returns the :class:`TunerStep` when a decision was made, or None on
        the baseline tick, a too-small window, or a store without telemetry
        (no sensors → the controller stays inert, never guesses).
        """
        if self.owner is not store:
            return None
        tel = store.config.telemetry
        if tel is None:
            return None
        self.ticks += 1
        if self._prev_tel is None:      # baseline: open the first window
            self._prev_tel = tel.snapshot()
            self._prev_stats = store.stats
            return None
        window = tel.delta(self._prev_tel)
        fg = {op: h for op, h in window.hists.items()
              if op in FOREGROUND_OPS}
        window_ops = sum(h.n for h in fg.values())
        if window_ops < self.min_window_ops:
            return None                 # keep the window open: too noisy
        stats_now = store.stats
        stats_delta = stats_now.delta(self._prev_stats)
        self._prev_tel = window.end
        self._prev_stats = stats_now
        objective = tuning_objective(fg)
        acts = store._tuning_actuators()

        # -- judge the previous trial: paired windows ---------------------
        # The trial window is compared against the window *immediately
        # before* the trial was applied, and the baseline re-anchors to
        # every measured window (accepted or not).  A sticky
        # best-objective baseline wedges the controller: one lucky window
        # becomes a bar no honest window clears, and every later move —
        # including good ones — gets rejected forever.  Paired windows
        # keep judgments local; a noise-driven mis-accept is self-
        # correcting the next time the knob comes around.
        accepted = True
        if self._pending is not None:
            knob, before = self._pending
            self._pending = None
            if (self._baseline is not None and knob in acts
                    and objective > self._baseline * (1.0 + self.tolerance)):
                acts[knob][1](before)   # revert (we are at a boundary)
                self._dirs[knob] = -self._dirs.get(knob, 1)
                accepted = False
        prev_objective = self._baseline
        self._baseline = objective

        # -- propose the next move (round-robin coordinate descent) ------
        knob = None
        before = after = float("nan")
        names = [k for k in acts if k in self.bounds]
        if names:
            knob = names[self._rr % len(names)]
            self._rr += 1
            get, set_ = acts[knob]
            before = after = float(get())
            d = self._dirs.setdefault(knob, _INIT_DIR.get(knob, 1))
            proposal = self._propose(knob, before, d)
            if proposal == before:      # pinned at a bound: flip and retry
                self._dirs[knob] = d = -d
                proposal = self._propose(knob, before, d)
            if proposal != before:
                set_(proposal)
                after = proposal
                self._pending = (knob, before)

        knobs = {k: float(g()) for k, (g, _) in acts.items()}
        step = TunerStep(
            tick=len(self.steps) + 1, knob=knob, before=before, after=after,
            objective=objective,
            prev_objective=(float("nan") if prev_objective is None
                            else prev_objective),
            accepted=accepted, window_ops=window_ops, knobs=knobs)
        self.steps.append(step)
        tel.emit("tuner_step", knob=knob or "", before=round(before, 4),
                 after=round(after, 4), objective=round(objective, 1),
                 accepted=accepted, window_ops=window_ops,
                 knobs={k: round(v, 4) for k, v in knobs.items()})
        # Rule-based actuation (no hill-climb): e.g. the facade shifts
        # shared-cache namespace budgets toward hit-rate-starved shards.
        rules = getattr(store, "_tuning_rules", None)
        if rules is not None:
            rules(window, stats_delta)
        return step

    def _propose(self, knob: str, cur: float, direction: int) -> float:
        lo, hi = self.bounds[knob]
        step = _KNOB_STEP.get(knob, 0.1)
        if knob in _MULTIPLICATIVE:
            nxt = cur * step if direction > 0 else cur / step
        else:
            nxt = cur + direction * step
        nxt = min(float(hi), max(float(lo), nxt))
        if knob in _INT_KNOBS:
            return float(int(round(nxt)))
        return round(nxt, 4)

    # ------------------------------------------------------------ reporting
    def knob_trajectory(self) -> List[Dict[str, float]]:
        """Knob vector after each decision (benchmark convergence plots)."""
        return [dict(s.knobs) for s in self.steps]

    def last_knobs(self) -> Dict[str, float]:
        return dict(self.steps[-1].knobs) if self.steps else {}

    def best_knobs(self) -> Dict[str, float]:
        """Knob vector with the best *judged* objective.

        Step k's vector (trial included) is live for the whole of step
        k+1's window, so k+1's objective scores it.  On a noisy box the
        walk's last-visited vector is one random step; the best-judged one
        is the search's actual result — restore it when exploration ends
        (stochastic search's keep-the-incumbent rule)."""
        if not self.steps:
            return {}
        best_k, best_obj = len(self.steps) - 1, math.inf
        for k in range(len(self.steps) - 1):
            obj = self.steps[k + 1].objective
            if obj < best_obj:
                best_k, best_obj = k, obj
        return dict(self.steps[best_k].knobs)

    def restore_best(self, store) -> Dict[str, float]:
        """End-of-exploration restore: settle on the walk's *incumbent*.

        Reverts any still-unjudged trailing trial (it never earned its
        keep) and re-actuates the resulting vector clamped to the bounds
        (a knob never trialled can still carry an out-of-bounds *starting*
        value).  Deliberately NOT a global argmin over window objectives:
        store state drifts across an exploration phase (tree ages, cache
        churns), so early windows systematically score better than late
        ones and a cross-phase argmin just restores the starting knobs —
        only the paired adjacent-window judgments the walk already made
        are drift-safe, and their product is the incumbent.  Call at a
        quiesce boundary; returns the restored vector ({} if not the
        owner / no steps)."""
        if self.owner is not store:
            return {}
        if not self.steps:
            return {}
        acts = store._tuning_actuators()
        if self._pending is not None:
            knob, before = self._pending
            self._pending = None
            if knob in acts:
                acts[knob][1](before)
        ks = {}
        for k, (get, set_) in acts.items():
            v = float(get())
            if k in self.bounds:
                lo, hi = self.bounds[k]
                clamped = min(float(hi), max(float(lo), v))
                if clamped != v:
                    set_(clamped)
                    v = clamped
            ks[k] = v
        self._baseline = None
        return ks
