"""repro_torch's store on the CPU vs the reference store, bit for bit.

One seeded op sequence (puts, overwrites, deletes, batches, explicit
flushes, edge keys) goes to ``repro.core.LSMStore`` on its numpy lanes, to
the same store with its Pallas lanes on (interpret mode), and to
``repro_torch.LSMStore(device="cpu")``, whose lanes are the plain versions
of the port's CUDA kernels.  After every flush and at the end: the same
level shapes and ``_max_level``, every run bit-equal column by column (keys,
seqs, vlens, vals, bloom bits, fences, block ids, block CRCs), every IOStats
field equal, and the same ``get``/``multi_get`` answers.  All lanes are
integer: tolerance 0.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch as rt
from repro_torch.kernels import ops

# Six xdist workers share 8 cores with the reference's timing-bounded
# property tests: one intra-op thread per worker keeps them on time.
torch.set_num_threads(1)

EDGE = [0, 2**32 - 1, 2**63 - 1, 2**63, 2**64 - 1]
SPACE = 4000


def gen_ops(seed: int, n: int):
    """A seeded op script: (kind, args) steps over a small key space plus
    the u64 edge keys, with value lengths 0..40 (empty values included)."""
    rng = np.random.default_rng(seed)
    space = np.concatenate([np.arange(SPACE, dtype=np.uint64),
                            np.array(EDGE, dtype=np.uint64)])
    steps = []
    done = 0
    while done < n:
        kind = rng.choice(["put_batch", "delete_batch", "put", "delete",
                           "write_batch", "flush"],
                          p=[0.35, 0.1, 0.2, 0.1, 0.2, 0.05])
        m = int(rng.integers(1, 120))
        keys = [int(k) for k in rng.choice(space, m)]
        vals = [bytes([k & 0xFF]) * int(rng.integers(0, 41)) for k in keys]
        if kind == "put_batch":
            steps.append((kind, (keys, vals)))
        elif kind == "delete_batch":
            steps.append((kind, (keys,)))
        elif kind == "put":
            steps.append((kind, (keys[0], vals[0])))
            m = 1
        elif kind == "delete":
            steps.append((kind, (keys[0],)))
            m = 1
        elif kind == "write_batch":
            dels = rng.random(m) < 0.3
            steps.append((kind, ([(k, None if d else v)
                                  for k, v, d in zip(keys, vals, dels)],)))
        else:
            steps.append(("flush", ()))
            m = 0
        done += m
    return steps


def read_batches(seed: int):
    rng = np.random.default_rng(seed)
    space = np.concatenate([np.arange(SPACE + 100, dtype=np.uint64),
                            np.array(EDGE, dtype=np.uint64)])
    return [[int(k) for k in rng.choice(space, m)] for m in (0, 1, 700)]


def stats_dict(store) -> dict:
    return dataclasses.asdict(store.stats)


def assert_same_tree(port, reference):
    assert port._max_level == reference._max_level
    cols = rt.columns_of(port)["levels"]
    assert [len(lvl) for lvl in cols] == \
        [len(lvl) for lvl in reference._levels]
    for lvl_p, lvl_r in zip(cols, reference._levels):
        for p, r in zip(lvl_p, lvl_r):
            for name, want in (("keys", r.keys), ("seqs", r.seqs),
                               ("vlens", r.vlens), ("vals", r.vals),
                               ("bloom_bits", r.bloom.bits),
                               ("fence_keys", r.fence_keys),
                               ("block_of", r.block_of),
                               ("block_crcs", r.block_crcs)):
                got = p[name]
                assert got.shape == want.shape, name
                assert got.dtype == want.dtype, name
                np.testing.assert_array_equal(got, want, err_msg=name)
            assert (p["bloom_m_bits"], p["bloom_k"]) == \
                (r.bloom.m_bits, r.bloom.k)


def drive(stores, steps, check_every_flush: bool):
    """Apply ``steps`` to every store; after each explicit flush compare
    each reference store with the port (stores[0])."""
    for kind, args in steps:
        for s in stores:
            getattr(s, kind)(*args)
        if kind == "flush" and check_every_flush:
            compare(stores)


def compare(stores):
    port = stores[0]
    for reference in stores[1:]:
        assert_same_tree(port, reference)
        assert stats_dict(port) == stats_dict(reference)


CONFIGS = [
    pytest.param(dict(policy="garnering", c=0.8), id="garnering-c0.8"),
    pytest.param(dict(policy="garnering", c=1.0), id="garnering-c1.0"),
    pytest.param(dict(policy="leveling"), id="leveling"),
    pytest.param(dict(policy="tiering"), id="tiering"),
    pytest.param(dict(policy="lazy-leveling"), id="lazy-leveling"),
    pytest.param(dict(policy="qlsm-bush"), id="qlsm-bush"),
]
BLOOMS = [
    pytest.param(dict(bits_per_key=0.0), id="nobloom"),
    pytest.param(dict(bits_per_key=10.0), id="bloom10-uniform"),
    pytest.param(dict(bits_per_key=10.0, bloom_allocation="monkey"),
                 id="bloom10-monkey"),
]


def configs(policy: dict, blooms: dict, memtable_bytes: int = 2 << 10):
    kw = dict(memtable_bytes=memtable_bytes, base_level_bytes=4 << 10,
              l0_compaction_trigger=3, **policy, **blooms)
    return ref.LSMConfig(**kw), rt.LSMConfig(**kw)


@pytest.mark.parametrize("blooms", BLOOMS)
@pytest.mark.parametrize("policy", CONFIGS)
def test_port_store_bit_for_bit_vs_numpy_reference(policy, blooms):
    ref_cfg, port_cfg = configs(policy, blooms)
    port = rt.LSMStore(port_cfg, device="cpu")
    numpy_ref = ref.LSMStore(ref_cfg)
    ops.reset_launch_counts()
    drive([port, numpy_ref], gen_ops(7, 4000), check_every_flush=True)
    compare([port, numpy_ref])
    assert numpy_ref.stats.compactions > 20 and numpy_ref._max_level >= 3
    # the port's compactions went through its merge lane (the reference's
    # silent fallback shows why equal output alone proves nothing)
    assert ops.PLAIN_CALLS["merge_pair"] > 0
    assert (ops.PLAIN_CALLS["bloom_build"] > 0) == \
        (blooms["bits_per_key"] > 0)
    for batch in read_batches(11):
        assert port.multi_get(batch) == numpy_ref.multi_get(batch)
        assert [port.get(k) for k in batch[:50]] == \
            [numpy_ref.get(k) for k in batch[:50]]
        assert stats_dict(port) == stats_dict(numpy_ref)
    assert (ops.PLAIN_CALLS["bloom_probe"] > 0) == \
        (blooms["bits_per_key"] > 0)
    assert port.num_levels_in_use == numpy_ref.num_levels_in_use
    assert port.total_entries == numpy_ref.total_entries
    assert port.level_summary() == numpy_ref.level_summary()
    assert set(ops.launch_counts().values()) == {0}   # no CUDA here


@pytest.mark.parametrize("blooms", [BLOOMS[1], BLOOMS[2]])
def test_port_store_bit_for_bit_vs_pallas_reference(blooms):
    """The reference with its Pallas bloom and merge lanes (interpret
    mode): the same tree, stats and answers as the port."""
    garnering = CONFIGS[0].values[0]
    ref_cfg, port_cfg = configs(garnering, blooms, memtable_bytes=8 << 10)
    ref_cfg.use_pallas_bloom = ref_cfg.use_pallas_merge = True
    port = rt.LSMStore(port_cfg, device="cpu")
    pallas_ref = ref.LSMStore(ref_cfg)
    numpy_ref = ref.LSMStore(configs(garnering, blooms,
                                     memtable_bytes=8 << 10)[0])
    drive([port, pallas_ref, numpy_ref], gen_ops(3, 700),
          check_every_flush=False)
    compare([port, pallas_ref, numpy_ref])
    assert pallas_ref._pallas_merge_fn is not None       # lane resolved
    assert pallas_ref.stats.compactions > 0
    for batch in read_batches(5):
        want = pallas_ref.multi_get(batch)
        assert port.multi_get(batch) == want == numpy_ref.multi_get(batch)
    compare([port, pallas_ref, numpy_ref])


def test_edge_keys_and_tombstones_round_trip():
    ref_cfg, port_cfg = configs(dict(policy="garnering", c=0.8),
                                dict(bits_per_key=10.0))
    port = rt.LSMStore(port_cfg, device="cpu")
    numpy_ref = ref.LSMStore(ref_cfg)
    for s in (port, numpy_ref):
        s.put_batch(EDGE, [b"edge%d" % i for i in range(len(EDGE))])
        s.flush()
        s.delete(EDGE[1])
        s.put(EDGE[2], b"")
    want = [b"edge0", None, b"", b"edge3", b"edge4"]
    assert port.multi_get(EDGE) == numpy_ref.multi_get(EDGE) == want
    for s in (port, numpy_ref):
        s.flush()
    assert port.multi_get(EDGE + [1, 2**64 - 2]) == want + [None, None]
    assert numpy_ref.multi_get(EDGE + [1, 2**64 - 2]) == want + [None, None]
    compare([port, numpy_ref])
    # one run's scalar point read, counter for counter
    run_p, run_r = port._levels[0][-1], numpy_ref._levels[0][-1]
    st_p, st_r = rt.core.IOStats(), ref.IOStats()
    for key in EDGE + [1, 2**64 - 2]:
        assert run_p.point_get(key, st_p) == run_r.point_get(key, st_r)[:2]
    assert dataclasses.asdict(st_p) == dataclasses.asdict(st_r)


@pytest.mark.parametrize("sizes", [[0], [5], [100, 0, 3], [10**6, 10**5],
                                   [7, 7, 7, 7]])
def test_bloom_allocation_host_math_matches_reference(sizes):
    for total in (0.0, 1e3, 8e6):
        np.testing.assert_array_equal(rt.core.allocate_fprs(sizes, total),
                                      ref.allocate_fprs(sizes, total))
    for p in (1e-4, 0.01, 0.5, 1.0):
        assert rt.core.bits_for_fpr(p) == ref.bits_for_fpr(p)
    for bpk in (0.0, 1.0, 10.0):
        assert rt.core.theoretical_fpr(bpk) == ref.theoretical_fpr(bpk)
