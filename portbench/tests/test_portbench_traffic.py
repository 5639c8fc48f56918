"""The generator: the same records and op stream for the same seed,
others for another seed; each mix's op shapes as its file states."""
import numpy as np
import pytest

from conftest import CELLS, SEED, configuration, mix_of, tiny, workload
from portbench import generator as gen


def stream(cell, seed, n_ops=40):
    config = workload(cell)["config"]
    records = {**configuration(config)["records"],
               **tiny(config)["records"]}
    mix = mix_of(cell)
    rec = gen.load_records(seed, records)
    ops = gen.OpStream(seed, mix, rec)
    return rec, mix, [next(ops) for _ in range(n_ops)]


def digest(rec, ops):
    return (rec.writes.tobytes(), rec.keys.tobytes(), rec.pattern.tobytes(),
            [(o.kind, o.keys.tobytes(), o.start, o.length, o.gen)
             for o in ops])


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_stream_other_seed_other(cell):
    a, b, c = (digest(*(lambda r, m, o: (r, o))(*stream(cell, s)))
               for s in (SEED, SEED, SEED + 1))
    assert a == b
    assert a[2] != c[2] and a[3] != c[3]


@pytest.mark.parametrize("cell", CELLS)
def test_ops_take_the_shapes_the_mix_states(cell):
    rec, mix, ops = stream(cell, SEED, 200)
    kinds = {o["kind"]: o for o in mix["ops"]}
    loaded = set(rec.keys.tolist())
    for op in ops:
        assert op.kind in kinds
        spec = kinds[op.kind]
        if op.kind == "scan":
            lo, hi = spec["length"]
            assert lo <= op.length <= hi and op.start in loaded
            continue
        assert op.keys.size == spec.get("batch", 1)
        if op.kind == "insert":
            assert not loaded & set(op.keys.tolist())
            continue
        froms = {src["from"] for src in spec["keys"]}
        if froms == {"loaded"}:
            assert set(op.keys.tolist()) <= loaded
        if froms == {"space"}:
            assert int(op.keys.max()) < rec.space
            # db_bench's draw over the fillrandom space: 1 - 1/e written
            found = np.isin(op.keys, rec.keys).mean()
            assert abs(found - (1 - np.exp(-1))) < 0.03, found
    writes = [o.gens for o in ops if o.kind in ("update", "insert")]
    if writes:
        g = np.concatenate(writes)
        assert np.unique(g).size == g.size and g.min() >= 1


def test_fillrandom_load_is_db_benchs():
    rec = gen.load_records(SEED, {"count": 20_000, "keys": "fillrandom",
                                  "value_bytes": 100})
    assert rec.writes.size == 20_000 and rec.space == 20_000
    assert int(rec.writes.max()) < 20_000
    assert np.array_equal(np.unique(rec.writes), np.sort(rec.keys))
    assert abs(rec.keys.size / 20_000 - (1 - np.exp(-1))) < 0.01
    first = {}
    for k in rec.writes.tolist():
        first.setdefault(k, len(first))
    assert rec.keys.tolist() == list(first)


def test_values_name_their_key_and_generation():
    rec, _, _ = stream("dbbench.readrandom", SEED, 1)
    keys = rec.keys[:5]
    rows = gen.value_rows(keys, [0, 1, 2, 3, 2**32 - 1], rec)
    assert rows.shape == (5, rec.value_bytes)
    assert (rows[:, :8].copy().view("<u8").ravel() == keys).all()
    assert rows[:, 8:12].copy().view("<u4").ravel().tolist() == \
        [0, 1, 2, 3, 2**32 - 1]
    assert gen.as_values(rows) == [r.tobytes() for r in rows]
    rows[:, 20:] = 0            # zero bytes inside a value are kept
    rows[:, -1] = rec.pattern[-1]
    assert gen.as_values(rows) == [r.tobytes() for r in rows]


def test_zipfian_is_skewed_and_scrambled():
    rng = np.random.default_rng(3)
    z = gen.Zipfian(rng, 10_000, 0.99)
    draws = z.sample(rng, 100_000)
    counts = np.bincount(draws, minlength=10_000)
    top = np.sort(counts)[::-1]
    assert top[0] > 50 * np.median(counts)       # a hot head
    assert np.argmax(counts) == z.perm[0]        # the hottest item moved


def test_fnv64_is_ycsbs_fnv1a():
    # FNV-1a 64 over the eight octets of 0: the offset basis times the
    # prime, eight times, with zero octets xored in
    h = 0xCBF29CE484222325
    for _ in range(8):
        h = (h * 0x100000001B3) % 2**64
    assert int(gen.fnv64(np.array([0], np.uint64))[0]) == h
