"""repro_torch's online tuner vs the reference's.

Every case of ``tests/test_tuner.py`` but the sharded facade's runs on the
port (``device="cpu"``).  The tuner is timing-driven, so its trajectories
are not compared across packages; what is compared bit for bit: the knob
bounds, ``tuning_objective``, ``_propose`` and every field of ``tick``'s
decisions on synthetic windows (fixed latency samples, fixed counters); a
tuned port store's reads against an untuned reference store fed the same
operations; and ``compact_to_shape``'s tree against the reference's.  The
knobs stay within ``KNOB_BOUNDS``, and only ``apply_tuning`` boundaries
actuate.
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as ref
import repro.core.tuner as ref_tuner
import repro_torch.core as pc
import repro_torch.core.tuner as port_tuner
from repro_torch.core import KNOB_BOUNDS, OnlineTuner, Telemetry
from repro_torch.core.scheduler import WorkerBudget
from test_torch_store import assert_same_tree

# Six xdist workers share 8 cores with the reference's timing-bounded
# property tests: one intra-op thread per worker keeps them on time.
torch.set_num_threads(1)


def tuned_cfg(**kw):
    """Tiny store with an aggressive tuner: ticks every 8 writes, decides
    on any non-empty window, so knobs actually move inside small tests."""
    base = dict(policy="garnering", T=2.0, c=1.0, memtable_bytes=1 << 9,
                base_level_bytes=1 << 11, bits_per_key=10,
                bloom_allocation="monkey", cache_bytes=1 << 14,
                pin_l0_bytes=1 << 13, telemetry=Telemetry(),
                tuner=OnlineTuner(interval_ops=8, min_window_ops=1,
                                  tolerance=0.0))
    base.update(kw)
    return pc.LSMConfig(**base)


def plain_kw(**kw):
    base = dict(policy="garnering", T=2.0, c=1.0, memtable_bytes=1 << 9,
                base_level_bytes=1 << 11, bits_per_key=10,
                bloom_allocation="monkey")
    base.update(kw)
    return base


def port_store(cfg):
    return pc.LSMStore(cfg, device="cpu")


def assert_reads_identical(db, twin, universe):
    for k in universe:
        assert db.get(k) == twin.get(k), k
    keys = np.asarray(list(universe), np.uint64)
    assert db.multi_get(keys) == twin.multi_get(keys)
    n = len(universe) + 4
    assert db.scan(0, n) == twin.scan(0, n)
    assert db.scan_scalar(0, n) == twin.scan_scalar(0, n)


def assert_in_bounds(steps):
    for s in steps:
        for k, v in s.knobs.items():
            lo, hi = KNOB_BOUNDS[k]
            assert lo - 1e-9 <= v <= hi + 1e-9, (k, v)


# --------------------------------------------------- host logic, bit for bit
def test_knob_bounds_and_objective_equal_reference():
    assert port_tuner.KNOB_BOUNDS == ref_tuner.KNOB_BOUNDS
    assert port_tuner.FOREGROUND_OPS == ref_tuner.FOREGROUND_OPS
    assert port_tuner._KNOB_STEP == ref_tuner._KNOB_STEP
    assert port_tuner._INIT_DIR == ref_tuner._INIT_DIR
    rng = np.random.default_rng(1)
    for _ in range(20):
        hists = [{}, {}]
        for op in ("get", "multi_get", "put", "scan", "flush", "seek"):
            vals = rng.integers(1, 10**7, int(rng.integers(0, 50)))
            for h, m in zip(hists, (pc, ref)):
                h[op] = m.LatencyHistogram()
                h[op].record_many(vals)
        a = port_tuner.tuning_objective(hists[0])
        b = ref_tuner.tuning_objective(hists[1])
        assert a == b or (math.isinf(a) and math.isinf(b))
    assert math.isinf(port_tuner.tuning_objective({}))
    tp, tr = OnlineTuner(), ref.OnlineTuner()
    for knob, (lo, hi) in KNOB_BOUNDS.items():
        for cur in np.linspace(lo, hi, 7).tolist() + [lo - 1, hi + 1]:
            for d in (-1, 1):
                assert tp._propose(knob, cur, d) == tr._propose(knob, cur, d)


class _Synthetic:
    """A store stand-in for ``tick``: its own package's Telemetry and
    IOStats, and knobs in a dict, fed the same samples on both sides."""

    def __init__(self, m, knobs):
        self.config = dataclasses.make_dataclass(
            "Cfg", [("telemetry", object)])(m.Telemetry())
        self._m = m
        self._io = m.IOStats()
        self.knobs = dict(knobs)

    @property
    def stats(self):
        return self._io.snapshot()

    def _tuning_actuators(self):
        return {k: (lambda k=k: self.knobs[k],
                    lambda v, k=k: self.knobs.__setitem__(k, v))
                for k in self.knobs}


def test_tick_decisions_on_synthetic_windows_equal_reference():
    rng = np.random.default_rng(5)
    knobs = dict(c=0.8, T=2.0, pin_frac=0.25, slowdown_trigger=64)
    sides = []
    for m in (pc, ref):
        store = _Synthetic(m, knobs)
        tun = m.OnlineTuner(interval_ops=8, min_window_ops=4, tolerance=0.05)
        assert tun.bind(store)
        sides.append((store, tun))
    for t in range(40):
        n = int(rng.integers(0, 30))
        samples = {op: rng.integers(10**3, 10**6 * (1 + t % 5), n)
                   for op in ("get", "put", "scan", "flush")}
        for store, tun in sides:
            for op, vals in samples.items():
                for v in vals.tolist():
                    store.config.telemetry.record(op, v)
            store._io.point_reads += n
            tun.tick(store)
    (sp, tp), (sr, tr) = sides
    assert tp.ticks == tr.ticks
    # (json: the first decision's prev_objective is NaN on both sides)
    assert json.dumps([dataclasses.asdict(s) for s in tp.steps]) == \
        json.dumps([dataclasses.asdict(s) for s in tr.steps])
    assert len(tp.steps) > 10 and sp.knobs == sr.knobs
    assert tp.knob_trajectory() == tr.knob_trajectory()
    assert tp.best_knobs() == tr.best_knobs()
    ev = [json.dumps([(e.kind, e.fields)
                      for e in s.config.telemetry.trace.dump()])
          for s in (sp, sr)]
    assert ev[0] == ev[1]
    assert tp.restore_best(sp) == tr.restore_best(sr)


# ------------------------------------------------------- differential twin
@given(st.lists(st.tuples(st.sampled_from(["put", "del", "get"]),
                          st.integers(0, 80)), min_size=20, max_size=300))
@settings(max_examples=25, deadline=None)
def test_tuned_store_reads_bit_identical(ops_):
    db = port_store(tuned_cfg())
    twin = ref.LSMStore(ref.LSMConfig(**plain_kw()))
    tun = db.config.tuner
    for i, (op, k) in enumerate(ops_):
        if op == "put":
            v = f"{i}".encode()
            db.put(k, v)
            twin.put(k, v)
        elif op == "del":
            db.delete(k)
            twin.delete(k)
        else:
            assert db.get(k) == twin.get(k), k
    db.flush()
    twin.flush()
    db.apply_tuning()
    assert_reads_identical(db, twin, range(81))
    if len(ops_) >= 60:
        assert tun.ticks > 0
    assert_in_bounds(tun.steps)


# ------------------------------------------------------------- knob bounds
def test_knob_bounds_hold_under_long_drive():
    db = port_store(tuned_cfg())
    twin = ref.LSMStore(ref.LSMConfig(**plain_kw()))
    tun = db.config.tuner
    rng = np.random.default_rng(11)
    ks = rng.integers(0, 400, 4_000, dtype=np.uint64)
    for i, k in enumerate(ks):
        db.put(int(k), b"x" * 24)
        twin.put(int(k), b"x" * 24)
        if i % 3 == 0:
            assert db.get(int(ks[i // 2])) == twin.get(int(ks[i // 2]))
    assert len(tun.steps) >= 10
    assert_in_bounds(tun.steps)
    assert {"c", "T", "pin_frac"} <= {s.knob for s in tun.steps}
    assert db.policy.c == pytest.approx(tun.last_knobs()["c"])
    assert db.policy.T == pytest.approx(tun.last_knobs()["T"])
    assert sum(1 for e in db.telemetry.trace.dump()
               if e.kind == "tuner_step") == len(tun.steps)
    db.close()


def test_bounds_are_policy_family_safe():
    for c in np.linspace(*KNOB_BOUNDS["c"], 5):
        for T in np.linspace(*KNOB_BOUNDS["T"], 5):
            p = pc.make_policy("garnering", T=float(T), c=float(c))
            assert type(p.retuned(c=float(c))) is type(p)


# ------------------------------------------------- boundary-only actuation
def test_apply_only_at_boundary():
    db = port_store(tuned_cfg(async_compaction=True, memtable_bytes=1 << 9,
                              stall_trigger=10_000, slowdown_trigger=0))
    tun = db.config.tuner
    db._scheduler.pause()
    for k in range(200):
        db.put(k, b"y" * 40)
    assert not db._scheduler.idle()
    before = len(tun.steps)
    knobs = {k: g() for k, (g, _) in db._tuning_actuators().items()}
    assert db.apply_tuning() is None
    assert len(tun.steps) == before
    assert {k: g() for k, (g, _) in db._tuning_actuators().items()} == knobs
    db._scheduler.resume()
    assert db.wait_for_quiesce(60)
    for k in range(50):
        db.put(k, b"z" * 24)
        db.get(k)
    assert db.wait_for_quiesce(60)
    st1 = db.apply_tuning()
    for k in range(50):
        db.get(k)
    st2 = db.apply_tuning()
    assert st1 is not None or st2 is not None
    assert len(tun.steps) > before
    assert "slowdown_trigger" in db._tuning_actuators()
    db.close()


def test_second_store_cannot_drive_anothers_tuner():
    tun = OnlineTuner(interval_ops=8, min_window_ops=1)
    db = port_store(tuned_cfg(tuner=tun))
    other = port_store(tuned_cfg(tuner=tun))
    assert tun.owner is db
    assert tun.tick(other) is None
    db.close()
    other.close()


def test_disabled_path_stays_inert():
    db = port_store(pc.LSMConfig(**plain_kw()))
    assert db.config.tuner is None and db._tuner is None
    for k in range(300):
        db.put(k, b"q" * 16)
    assert db.apply_tuning() is None
    db.close()


# ------------------------------------------------------------ worker budget
def test_worker_budget_resize_semantics():
    b = WorkerBudget(2)
    assert b.size == 2
    assert b.resize(4) and b.size == 4
    assert b.resize(1) and b.size == 1
    b.acquire()
    assert b.resize(2) and b.size == 2
    b.acquire()
    assert not b.resize(1) and b.size == 2
    b.release()
    b.release()
    assert b.resize(1) and b.size == 1
    with b:
        assert not b._sem.acquire(blocking=False)


# ------------------------------------------------- maintenance reshape
def test_compact_to_shape_preserves_reads_and_folds_levels():
    """The retune and the fold on both stores: the same merges, the same
    tree, and reads equal to an untouched twin."""
    dbs = [port_store(pc.LSMConfig(**plain_kw())),
           ref.LSMStore(ref.LSMConfig(**plain_kw()))]
    twin = ref.LSMStore(ref.LSMConfig(**plain_kw()))
    for i in range(600):
        v = f"v{i}".encode()
        for db in dbs + [twin]:
            db.put(i % 200, v)
    for db in dbs + [twin]:
        db.flush()
    deep_before = len([lv for lv in dbs[0]._levels if lv])
    merges = []
    for db in dbs:
        db.retune_policy(T=6.0, c=0.4)
        merges.append(db.compact_to_shape())
    assert merges[0] == merges[1]
    assert_same_tree(*dbs)
    db = dbs[0]
    total = sum(r.data_bytes for lvl in db._levels for r in lvl)
    target = max(1, math.ceil(db.policy.predicted_levels(
        total, db.config.base_level_bytes)))
    deep_after = len([lv for i, lv in enumerate(db._levels) if lv and i >= 1])
    if deep_before > target + 1:
        assert merges[0] >= 1
    assert deep_after <= max(target, 1)
    assert_reads_identical(db, twin, range(200))
    assert db.compact_to_shape() == 0
    db.close()


def test_reshape_event_and_set_cache_split_equal_reference():
    """The two actuators beside the policy's, driven by hand on both
    stores: the same reshape events, cache state and counters."""
    out = []
    for m, kw in ((pc, dict(device="cpu")), (ref, {})):
        tel = m.Telemetry()
        db = m.LSMStore(m.LSMConfig(**plain_kw(cache_bytes=1 << 14,
                                               pin_l0_bytes=1 << 13,
                                               telemetry=tel)), **kw)
        for i in range(800):
            db.put(i % 250, f"s{i}".encode())
        db.set_cache_split(1 << 12)
        db.multi_get(list(range(250)))
        db._set_pin_frac(0.5)
        db.retune_policy(T=5.0, c=0.5)
        db.compact_to_shape()
        out.append(([e.kind for e in tel.trace.dump()],
                    db.cache_summary(), db._get_pin_frac(),
                    {k: v for k, v in dataclasses.asdict(db.stats).items()
                     if not k.endswith("_ns")}))
    assert out[0] == out[1]
    assert "reshape" in out[0][0]


def test_restore_best_settles_incumbent_within_bounds():
    db = port_store(tuned_cfg())
    tun = db.config.tuner
    for i in range(400):
        db.put(i % 64, f"r{i}".encode())
        if i % 40 == 39:
            db.flush()
            db.apply_tuning()
    assert len(tun.steps) >= 3
    best = tun.best_knobs()
    objs = [s.objective for s in tun.steps[1:]]
    k_best = int(np.argmin(objs))
    assert best == dict(tun.steps[k_best].knobs)
    pending = tun._pending
    restored = tun.restore_best(db)
    assert tun._pending is None
    if pending is not None and pending[0] in restored:
        assert restored[pending[0]] == pytest.approx(pending[1])
    for k, v in restored.items():
        lo, hi = KNOB_BOUNDS[k]
        assert lo - 1e-9 <= v <= hi + 1e-9, (k, v)
    assert db.policy.c == pytest.approx(restored["c"])
    assert db.policy.T == pytest.approx(restored["T"])
    other = port_store(pc.LSMConfig(**plain_kw()))
    assert tun.restore_best(other) == {}
    db.close()
    other.close()


def test_tuned_sharded_matches_single_oracle():
    """A tuned async two-shard port facade (the tuner bound to the facade,
    ticking at all-shards-idle boundaries) reads what the reference's
    plain store reads; knobs stay in bounds."""
    tel = Telemetry()
    cfg = tuned_cfg(shards=2, async_compaction=True, compaction_workers=2,
                    telemetry=tel,
                    tuner=OnlineTuner(interval_ops=64, min_window_ops=1,
                                      tolerance=0.0))
    db = pc.make_store(cfg, device="cpu")
    assert isinstance(db, pc.ShardedLSMStore)
    assert db.config.tuner.owner is db
    twin = ref.LSMStore(ref.LSMConfig(**plain_kw()))
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 1 << 40, 3_000, dtype=np.uint64)
    for wave in range(6):
        lo, hi = wave * 500, (wave + 1) * 500
        for k in keys[lo:hi]:
            v = f"w{wave}k{int(k)}".encode()
            db.put(int(k), v)
            twin.put(int(k), v)
        for k in keys[max(0, lo - 200):lo:7]:
            assert db.get(int(k)) == twin.get(int(k))
        assert db.wait_for_quiesce(60)
        db.apply_tuning()
    probe = keys[::5]
    assert db.multi_get(probe) == twin.multi_get(probe)
    start = int(keys.min())
    assert db.scan(start, 200) == twin.scan(start, 200)
    assert db.scan_scalar(start, 200) == twin.scan_scalar(start, 200)
    assert db.config.tuner.ticks > 0
    assert_in_bounds(db.config.tuner.steps)
    assert set(db._tuning_actuators()) == set(ref.make_store(
        ref.LSMConfig(**plain_kw(shards=2, async_compaction=True,
                                 cache_bytes=1 << 14,
                                 pin_l0_bytes=1 << 13)))._tuning_actuators())
    db.close()
    twin.close()


def test_facade_compact_to_shape_matches_oracle():
    tel = Telemetry()
    tun = OnlineTuner(interval_ops=8, min_window_ops=1, tolerance=0.0)
    db = pc.make_store(tuned_cfg(telemetry=tel, tuner=tun, shards=2,
                                 async_compaction=True), device="cpu")
    twin = ref.LSMStore(ref.LSMConfig(**plain_kw()))
    for i in range(400):
        v = f"w{i}".encode()
        db.put(i % 150, v)
        twin.put(i % 150, v)
    assert db.wait_for_quiesce(120)
    db.retune_policy(T=6.0, c=0.5)
    assert all((s.policy.T, s.policy.c) == (6.0, 0.5) for s in db.shards)
    db.compact_to_shape()
    twin.flush()
    assert_reads_identical(db, twin, range(150))
    assert db.compact_to_shape() == 0          # in shape: a no-op
    db.close()
    twin.close()


def test_facade_tuning_rules_shift_cache_budgets_as_the_reference():
    """The facade's tick-time rule (cache budgets toward the shards with
    the most misses in the window) and its worker-budget and cache-split
    actuators give the reference's budgets on the same traffic."""
    out = []
    for m, kw in ((pc, {"device": "cpu"}), (ref, {})):
        db = m.make_store(m.LSMConfig(**plain_kw(
            shards=2, shard_splitters=(200,), async_compaction=True,
            compaction_workers=2, cache_bytes=1 << 14,
            pin_l0_bytes=1 << 12)), **kw)
        for k in range(400):
            db.put(k, b"v%d" % k * 40)
        db.flush()
        assert db.wait_for_quiesce(60)
        db._tuning_rules(None, None)            # opens the window
        db.multi_get(list(range(0, 200)) * 3)   # misses in shard 0 only
        db.multi_get(list(range(200, 210)))
        db._tuning_rules(None, None)
        budgets = [s.block_cache.budget_bytes for s in db.shards]
        assert budgets[0] > budgets[1] and sum(budgets) == 1 << 14
        assert db.resize_worker_budget(1) and db.config.compaction_workers == 1
        db.set_cache_split(1 << 13)
        out.append((budgets, [s.block_cache.budget_bytes for s in db.shards],
                    [s.pinned_l0.pin_l0_bytes for s in db.shards],
                    db.block_cache.capacity_bytes, db.cache_summary()))
        db.close()
    assert out[0] == out[1]
