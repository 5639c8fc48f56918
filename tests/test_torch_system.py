"""The paper's headline claims on repro_torch's store, beside the
reference's (``tests/test_system.py``).

The seven cases of ``tests/test_system.py`` (Garnering has fewer levels
than Leveling, zero-result point reads and range reads touch fewer runs,
Monkey filters make zero-result reads near free, write amplification
between Tiering's and Leveling's, delayed last-level compactions happen,
Eq. 6 tracks the tree) on ``repro_torch.LSMStore(device="cpu")``, with the
reference's module fixture of four 120,000-entry stores, its seeds and its
configurations.  Every store is built twice, by the port and by
``repro.core.LSMStore`` from the same puts: each case's assertions on the
port's stores, and the same per-read costs (every IOStats field of the
reads' deltas) from both packages.  ``test_port_stores_equal_the_reference_
stores`` holds each port store's levels, IOStats and write amplification
after the load against the reference store's.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch as rt

# Six xdist workers share 8 cores with the reference's timing-bounded
# property tests: one intra-op thread per worker keeps them on time.
torch.set_num_threads(1)


def load(policy, c, n=120_000, bits=0.0):
    """(port store, reference store, their IOStats after the load)."""
    kw = dict(policy=policy, c=c, T=2.0, memtable_bytes=1 << 14,
              base_level_bytes=1 << 16, bits_per_key=bits,
              bloom_allocation="monkey")
    db = rt.LSMStore(rt.LSMConfig(**kw), device="cpu")
    want = ref.LSMStore(ref.LSMConfig(**kw))
    rng = np.random.default_rng(42)
    for k in rng.integers(0, n * 8, n, dtype=np.uint64):
        db.put(int(k), b"x" * 50)
        want.put(int(k), b"x" * 50)
    db.flush()
    want.flush()
    return db, want, (db.stats.snapshot(), want.stats.snapshot())


@pytest.fixture(scope="module")
def pairs():
    return {"leveling": load("leveling", 1.0),
            "garnering8": load("garnering", 0.8),
            "garnering5": load("garnering", 0.5),
            "tiering": load("tiering", 1.0)}


@pytest.fixture(scope="module")
def dbs(pairs):
    return {name: p[0] for name, p in pairs.items()}


def stats_dict(stats) -> dict:
    return dataclasses.asdict(stats)


def zero_read_stats(db, n_ops=400):
    rng = np.random.default_rng(7)
    s0 = db.stats.snapshot()
    for k in rng.integers(1 << 62, 1 << 63, n_ops):
        assert db.get(int(k)) is None
    d = db.stats.delta(s0)
    return (d.runs_touched_point / n_ops, d.blocks_read / n_ops), d


def both_zero_read_stats(pair):
    (got, d), (want, d_ref) = (zero_read_stats(db) for db in pair[:2])
    assert got == want
    assert stats_dict(d) == stats_dict(d_ref)
    return got


def test_port_stores_equal_the_reference_stores(pairs):
    """The one assertion the reference lacks: the port's four stores after
    the load have the reference's levels, IOStats and write
    amplification."""
    for name, (db, want, (s_port, s_ref)) in pairs.items():
        assert db.num_levels_in_use == want.num_levels_in_use, name
        assert stats_dict(s_port) == stats_dict(s_ref), name
        assert s_port.write_amplification() == \
            s_ref.write_amplification(), name
        assert db.total_entries == want.total_entries, name
        assert db.level_summary() == want.level_summary(), name


def test_fewer_levels_than_leveling(dbs):
    assert dbs["garnering8"].num_levels_in_use < \
        dbs["leveling"].num_levels_in_use
    assert dbs["garnering5"].num_levels_in_use <= \
        dbs["garnering8"].num_levels_in_use


def test_point_reads_touch_fewer_runs(pairs):
    runs_lv, _ = both_zero_read_stats(pairs["leveling"])
    runs_g, _ = both_zero_read_stats(pairs["garnering5"])
    assert runs_g <= runs_lv


def test_bloom_makes_zero_reads_near_free():
    pair = load("garnering", 0.8, n=60_000, bits=10)
    _, blocks = both_zero_read_stats(pair)
    assert blocks < 0.2  # Monkey: sum of FPRs << 1 block per lookup


def test_range_reads_touch_fewer_runs(pairs):
    def range_runs(db, n_ops=150):
        rng = np.random.default_rng(9)
        s0 = db.stats.snapshot()
        answers = [db.scan(int(k), 10)
                   for k in rng.integers(0, 120_000 * 8, n_ops)]
        d = db.stats.delta(s0)
        return d.runs_touched_range / n_ops, answers, stats_dict(d)

    runs = {}
    for name in ("garnering5", "leveling"):
        got, want = (range_runs(db) for db in pairs[name][:2])
        assert got == want
        runs[name] = got[0]
    assert runs["garnering5"] <= runs["leveling"]


def test_write_amp_ordering(dbs):
    wa = {k: v.stats.write_amplification() for k, v in dbs.items()}
    assert wa["tiering"] < wa["leveling"]
    assert wa["garnering8"] < wa["leveling"] * 1.2  # not catastrophically worse


def test_delayed_compactions_happen(dbs):
    assert dbs["garnering8"].stats.delayed_last_level_compactions > 0
    assert dbs["leveling"].stats.delayed_last_level_compactions == 0


def test_eq6_prediction_tracks_reality(pairs):
    db, want, _ = pairs["garnering8"]
    pred = db.policy.predicted_levels(db.total_entries * 66,
                                      db.config.base_level_bytes)
    assert pred == want.policy.predicted_levels(want.total_entries * 66,
                                                want.config.base_level_bytes)
    assert abs(db.num_levels_in_use - pred) <= 2.5
