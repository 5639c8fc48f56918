"""State carried across: a reference tree's columns rebuilt in repro_torch.

The columns are taken out of a ``repro.core`` store here; the port's
``store_from_columns`` sees only numpy arrays.  The rebuilt store must
answer ``multi_get`` exactly as the reference does, with the same IOStats
deltas, and ``columns_of`` must round-trip.  Integer lanes: tolerance 0.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch as rt
from repro_torch.core import levels_bit_equal

from test_torch_store import EDGE, gen_ops, read_batches

# Six xdist workers share 8 cores with the reference's timing-bounded
# property tests: one intra-op thread per worker keeps them on time.
torch.set_num_threads(1)


def reference_store(**kw):
    cfg = dict(memtable_bytes=2 << 10, base_level_bytes=4 << 10,
               l0_compaction_trigger=3, **kw)
    store = ref.LSMStore(ref.LSMConfig(**cfg))
    for kind, args in gen_ops(19, 2500):
        getattr(store, kind)(*args)
    store.put_batch(EDGE, [b"e"] * len(EDGE))       # left in the memtable
    return store, rt.LSMConfig(**cfg)


def run_tuple(cols: dict) -> tuple:
    """A ``columns_of`` run dict as a ``store_from_columns`` run tuple."""
    return (cols["keys"], cols["seqs"], cols["vlens"], cols["vals"],
            (cols["bloom_m_bits"], cols["bloom_k"]))


def reference_columns(store):
    levels = [[(r.keys, r.seqs, r.vlens, r.vals, (r.bloom.m_bits, r.bloom.k))
               for r in lvl] for lvl in store._levels]
    mem = [(k, s, v) for k, (s, v) in store.memtable._data.items()]
    return levels, mem


def delta_dict(stats, since) -> dict:
    return dataclasses.asdict(stats.delta(since))


@pytest.mark.parametrize("kw", [dict(bits_per_key=10.0),
                                dict(bits_per_key=10.0,
                                     bloom_allocation="monkey"),
                                dict()], ids=["uniform", "monkey", "nobloom"])
def test_reference_tree_answers_identically(kw):
    reference, port_cfg = reference_store(**kw)
    levels, mem = reference_columns(reference)
    port = rt.store_from_columns(port_cfg, levels, mem, reference._seq,
                                 device="cpu",
                                 max_level=reference._max_level)
    assert all(v == 0 for v in dataclasses.asdict(port.stats).values())
    cols = rt.columns_of(port)
    for lvl_p, lvl_r in zip(cols["levels"], reference._levels):
        for p, r in zip(lvl_p, lvl_r):
            np.testing.assert_array_equal(p["bloom_bits"], r.bloom.bits)
            np.testing.assert_array_equal(p["fence_keys"], r.fence_keys)
            np.testing.assert_array_equal(p["block_crcs"], r.block_crcs)
    before_r, before_p = reference.stats, port.stats
    for batch in read_batches(23) + [EDGE]:
        assert port.multi_get(batch) == reference.multi_get(batch)
    assert delta_dict(port.stats, before_p) == \
        delta_dict(reference.stats, before_r)
    # the carried store keeps working like the reference
    for s in (port, reference):
        s.put_batch([1, 2, 3], [b"a", b"b", b"c"])
        s.flush()
    assert port.multi_get([1, 2, 3, 4]) == reference.multi_get([1, 2, 3, 4])


def test_columns_of_round_trips():
    reference, port_cfg = reference_store(bits_per_key=10.0,
                                          bloom_allocation="monkey")
    levels, mem = reference_columns(reference)
    first = rt.store_from_columns(port_cfg, levels, mem, reference._seq,
                                  device="cpu")
    cols = rt.columns_of(first)
    second = rt.store_from_columns(
        port_cfg, [[run_tuple(r) for r in lvl] for lvl in cols["levels"]],
        cols["memtable"], cols["seq"], device="cpu",
        max_level=cols["max_level"])
    again = rt.columns_of(second)
    assert again["memtable"] == cols["memtable"] == mem
    assert (again["seq"], again["max_level"]) == (cols["seq"],
                                                  cols["max_level"])
    assert [len(lvl) for lvl in again["levels"]] == \
        [len(lvl) for lvl in cols["levels"]]
    for lvl_a, lvl_b in zip(again["levels"], cols["levels"]):
        for a, b in zip(lvl_a, lvl_b):
            assert a.keys() == b.keys()
            for name in a:
                np.testing.assert_array_equal(a[name], b[name],
                                              err_msg=name)
    assert levels_bit_equal(first._levels, second._levels)
    second.put(1, b"changed")
    second.flush()
    assert not levels_bit_equal(first._levels, second._levels)
    first.put(1, b"changed")
    first.flush()
    assert levels_bit_equal(first._levels, second._levels)


def test_uniform_filters_rebuild_without_geometry():
    reference, port_cfg = reference_store(bits_per_key=10.0)
    levels, mem = reference_columns(reference)
    port = rt.store_from_columns(
        port_cfg, [[cols[:4] for cols in lvl] for lvl in levels], mem,
        reference._seq, device="cpu")
    for lvl_p, lvl_r in zip(rt.columns_of(port)["levels"],
                            reference._levels):
        for p, r in zip(lvl_p, lvl_r):
            np.testing.assert_array_equal(p["bloom_bits"], r.bloom.bits)
