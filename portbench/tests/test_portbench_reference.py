"""The plain reference against a dictionary written out, on random
streams of writes, point reads and scans."""
import numpy as np
import pytest

from portbench.reference.kv import NONE, KVReference


@pytest.mark.parametrize("seed", range(5))
def test_reference_equals_a_dict(seed):
    rng = np.random.default_rng(seed)
    space = np.unique(rng.integers(0, 2**64 - 1, 400, dtype=np.uint64))
    loaded = rng.choice(space[:300], 400)     # repeats, as fillrandom's
    ref = KVReference(loaded, space)
    state = {int(k): 0 for k in loaded}
    gen = 1
    for _ in range(60):
        keys = rng.choice(space, int(rng.integers(1, 40)))
        ref.write(keys, np.arange(gen, gen + keys.size))
        for k in keys.tolist():
            state[k] = gen
            gen += 1
        q = rng.choice(space, 50)
        assert ref.get(q).tolist() == [state.get(k, NONE)
                                       for k in q.tolist()]
        start = int(rng.choice(space))
        n = int(rng.integers(1, 30))
        live = sorted(k for k, g in state.items() if g != NONE
                      and k >= start)[:n]
        ks, gs = ref.scan(start, n)
        assert ks.tolist() == live
        assert gs.tolist() == [state[k] for k in live]


def test_a_write_outside_the_universe_is_refused():
    ref = KVReference(np.arange(10, dtype=np.uint64),
                      np.arange(20, 30, dtype=np.uint64))
    ref.write(np.array([25, 3], np.uint64), np.array([1, 2]))
    assert ref.get(np.array([25, 3, 26], np.uint64)).tolist() == [1, 2, NONE]
    with pytest.raises(KeyError):
        ref.write(np.array([15], np.uint64), np.array([3]))
