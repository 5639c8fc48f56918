"""repro_torch's delta-checkpoint store on the CPU vs the reference's.

Every case of ``tests/test_checkpoint.py`` runs on
``repro_torch.checkpoint.CheckpointStore(device="cpu")`` over torch trees
beside ``repro.checkpoint.CheckpointStore`` over the same leaves as numpy
arrays: restores bit-exact, the same latest step, the same delta skips and
chunk writes, a crash keeping every durable checkpoint, the async writer,
and Garnering's shallower tree.  Beyond the reference file: for equal leaf
bytes the two stores hold the same keys and chunk values (manifests
included), with one shard and with two, and leaves of every dtype the
models use round-trip through ``restore_leaf`` and ``restore_tree``.
"""
import numpy as np
import pytest
import torch

import repro.checkpoint as refck
import repro.core as ref
import repro_torch.core as pc
from repro_torch import checkpoint as ck

# Six xdist workers share 8 cores with the reference's timing-bounded
# property tests: one intra-op thread per worker keeps them on time.
torch.set_num_threads(1)


def np_tree(seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"layer": {"w": rng.standard_normal((64, 32)).astype(np.float32)
                      * scale,
                      "b": rng.standard_normal(32).astype(np.float32)},
            "embed": rng.standard_normal((100, 16)).astype(np.float32)}


def to_torch(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def leaves(tree):
    return [leaf for _, leaf in ck.store._leaf_paths(tree)]


def assert_tree_equal(want_np, got):
    """Bit for bit: same leaves, same bytes, same dtype and shape."""
    w, g = leaves(want_np), leaves(got)
    assert len(w) == len(g)
    for x, y in zip(w, g):
        assert isinstance(y, torch.Tensor) and y.device.type == "cpu"
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
        assert y.numpy().dtype == np.asarray(x).dtype


def pair(**kw):
    """(port, reference) checkpoint stores; ``kw`` are LSMConfig fields
    (none: both packages' default store)."""
    if not kw:
        return ck.CheckpointStore(device="cpu"), refck.CheckpointStore()
    return (ck.CheckpointStore(pc.LSMConfig(**kw), device="cpu"),
            refck.CheckpointStore(ref.LSMConfig(**kw)))


def test_roundtrip_exact():
    st, rs = pair()
    t = np_tree(0)
    st.save(10, to_torch(t))
    rs.save(10, t)
    assert st.latest_step() == rs.latest_step() == 10
    assert_tree_equal(t, st.restore_tree(10, to_torch(t)))


def test_multiple_steps_and_latest():
    st, rs = pair()
    for step in (10, 20, 30):
        st.save(step, to_torch(np_tree(step)))
        rs.save(step, np_tree(step))
    assert st.latest_step() == rs.latest_step() == 30
    assert_tree_equal(np_tree(30), st.restore_tree(None, to_torch(np_tree(0))))
    assert_tree_equal(np_tree(30), st.restore_tree(30, to_torch(np_tree(0))))


def test_delta_checkpoints_skip_unchanged():
    st, rs = pair()
    t = np_tree(1)
    t2 = {"layer": {"w": t["layer"]["w"], "b": t["layer"]["b"] + 1.0},
          "embed": t["embed"]}
    for s, conv in ((st, to_torch), (rs, lambda x: x)):
        s.save(1, conv(t))
        w0 = s.stats_chunks_written
        s.save(2, conv(t2))
        assert s.stats_deltas_skipped > 0
        assert s.stats_chunks_written - w0 < w0   # only 'b' rewritten
    assert (st.stats_chunks_written, st.stats_deltas_skipped) == \
        (rs.stats_chunks_written, rs.stats_deltas_skipped)
    assert_tree_equal(t2, st.restore_tree(2, to_torch(t)))


def test_point_read_single_leaf():
    st, rs = pair()
    t = np_tree(3)
    st.save(5, to_torch(t))
    rs.save(5, t)
    import jax
    path = jax.tree_util.keystr(
        jax.tree_util.tree_flatten_with_path(t)[0][1][0])
    got = st.restore_leaf(5, path)
    want = rs.restore_leaf(5, path)
    assert got is not None
    np.testing.assert_array_equal(got.numpy(), want)
    assert st.restore_leaf(5, "['missing']") is None
    assert st.restore_leaf(6, path) is None


def test_crash_recovery_keeps_durable_checkpoints():
    st, rs = pair()
    t = np_tree(4)
    st.save(7, to_torch(t))
    rs.save(7, t)
    st.crash()
    rs.crash()
    assert st.latest_step() == rs.latest_step() == 7
    assert_tree_equal(t, st.restore_tree(7, to_torch(t)))


def test_async_checkpointer():
    st, _ = pair()
    w = ck.AsyncCheckpointer(st)
    trees = {s: np_tree(s) for s in (1, 2, 3)}
    for s, t in trees.items():
        live = to_torch(t)
        w.submit(s, live)
        live["embed"].add_(1.0)     # after submit: must not reach the save
    w.close()
    assert st.latest_step() == 3
    assert_tree_equal(trees[3], st.restore_tree(3, to_torch(trees[3])))


def test_garnering_restore_reads_few_runs():
    """After many delta saves a restore (a range read) returns the last
    step, and Garnering keeps the tree no deeper than Leveling's, with the
    reference's level counts."""
    base = dict(T=2.0, memtable_bytes=1 << 12, base_level_bytes=1 << 14,
                bits_per_key=10, bloom_allocation="monkey")
    st, st_r = pair(policy="garnering", c=0.6, **base)
    lv, lv_r = pair(policy="leveling", **base)
    for step in range(30):
        t = np_tree(step)
        for s in (st, lv):
            s.save(step, to_torch(t))
        for s in (st_r, lv_r):
            s.save(step, t)
    assert st.db.num_levels_in_use <= lv.db.num_levels_in_use
    assert (st.db.num_levels_in_use, lv.db.num_levels_in_use) == \
        (st_r.db.num_levels_in_use, lv_r.db.num_levels_in_use)
    assert_tree_equal(np_tree(29), st.restore_tree(29, to_torch(np_tree(0))))


@pytest.mark.parametrize("shards", [1, 2])
def test_keys_and_chunk_values_equal_the_reference(shards):
    """Equal leaf bytes in, equal store contents out: every key (chunk ids
    and manifests) and every value, after a full save and a delta save, on
    one shard and on two; and the restores bit-exact."""
    kw = dict(policy="garnering", T=2.0, c=0.8, memtable_bytes=1 << 17,
              base_level_bytes=1 << 19, bits_per_key=10,
              bloom_allocation="monkey", shards=shards,
              shard_splitters=(8,) if shards > 1 else None)
    st, rs = pair(**kw)
    rng = np.random.default_rng(shards)
    t = {"b": [rng.standard_normal((300, 70)).astype(np.float32),
               (rng.integers(0, 9, (5, 3)).astype(np.int64), None)],
         "a": {"z": rng.standard_normal(150_000).astype(np.float32),
               "y": np.asarray(rng.random(17) > 0.5)}}
    t2 = {"b": [t["b"][0], (t["b"][1][0] + 1, None)],
          "a": {"z": t["a"]["z"], "y": t["a"]["y"]}}
    for step, tree in ((0, t), (1, t2)):
        assert st.save(step, to_torch(tree)) == rs.save(step, tree)
    assert (st.stats_chunks_written, st.stats_deltas_skipped) == \
        (rs.stats_chunks_written, rs.stats_deltas_skipped)
    got = st.db.scan(0, 1 << 20)
    assert got == rs.db.scan(0, 1 << 20)
    assert len(got) == rs._next_id - 1 + 2        # chunks + two manifests
    if shards > 1:                  # both shards hold chunks
        per_shard = [len(s.scan(0, 1 << 20)) for s in st.db.shards]
        assert per_shard == [len(s.scan(0, 1 << 20)) for s in rs.db.shards]
        assert min(per_shard) > 0
    assert_tree_equal(t2, st.restore_tree(1, to_torch(t)))
    assert_tree_equal(t2, st.restore_tree(None, to_torch(t)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int32, torch.bool])
def test_every_dtype_round_trips(dtype):
    """Leaves in every dtype the models hold, bf16 included (no numpy
    dtype), and an empty leaf: ``restore``, ``restore_leaf`` and
    ``restore_tree`` give the saved bits, dtype and shape."""
    g = torch.Generator().manual_seed(7)
    x = (torch.randn(513, 129, generator=g) * 5).to(dtype)
    tree = {"x": x, "s": [x[3, :7].clone(), torch.zeros(0, 4, dtype=dtype)]}
    st = ck.CheckpointStore(device="cpu")
    st.save(0, tree)
    flat = st.restore(0)
    assert list(flat) == ["['s'][0]", "['s'][1]", "['x']"]
    back = st.restore_tree(0, tree)
    for want, got in zip(leaves(tree), leaves(back)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.view(torch.uint8) if got.numel() else got,
                           want.view(torch.uint8) if want.numel() else want)
    assert torch.equal(st.restore_leaf(0, "['x']").view(torch.uint8),
                       x.view(torch.uint8))
