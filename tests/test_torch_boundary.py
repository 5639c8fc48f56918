"""The port's boundaries: no JAX and no ``repro`` inside it, no silent CPU
fallback, every configuration field acting as in the reference.

The checks marked ``cuda`` need a CUDA card and ``nvcc``: they build the
kernels, hold each against its plain version on the card, and hold a CUDA
store against a CPU store.  Without a card they skip.
"""
import ast
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

# deterministic cuBLAS for the training check on the card: read when the
# CUDA context is created, so set before torch touches the card
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.kernels import attention, bloom, merge, ops  # noqa: E402

# Six xdist workers share 8 cores with the reference's timing-bounded
# property tests: one intra-op thread per worker keeps them on time.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + sorted((ROOT / "examples" / "torch").glob("*.py")) \
    + sorted((ROOT / "portbench").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def forbidden_imports(path: Path):
    """(line, text) of every import of jax or repro, and every ``jax.``
    attribute use, in one Python file."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and node.value.id == "jax":
            bad.append((node.lineno, "jax." + node.attr))
            continue
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "repro"):
                bad.append((node.lineno, name))
    return bad


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_neither_jax_nor_repro(path):
    assert forbidden_imports(path) == []


def test_import_check_covers_every_store_module():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for module in ("engine", "iterator", "manifest", "memtable", "run"):
        assert f"src/repro_torch/core/{module}.py" in names


def test_import_check_covers_the_mesh_modules():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for module in ("launch/mesh", "launch/sharding", "launch/train",
                   "models/layers", "models/blocks", "models/model",
                   "models/train", "serve/engine"):
        assert f"src/repro_torch/{module}.py" in names


def test_import_check_covers_the_dryrun_and_the_examples():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for path in ("src/repro_torch/launch/specs.py",
                 "src/repro_torch/launch/dryrun.py",
                 "src/repro_torch/launch/trace_cost.py",
                 "examples/torch/quickstart.py",
                 "examples/torch/kernels_demo.py",
                 "examples/torch/serve_autumnkv.py",
                 "examples/torch/train_with_failures.py"):
        assert path in names


def test_ast_walk_catches_a_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.core import run\n"
                 "from .x import y\nimport repro_torch\nz = jax.jit\n")
    assert [n for _, n in forbidden_imports(f)] == \
        ["jax.numpy", "repro.core", "jax.jit"]


def test_port_runs_with_jax_and_repro_blocked():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import torch
        torch.set_num_threads(1)
        import repro_torch as rt
        s = rt.LSMStore(rt.LSMConfig(memtable_bytes=1024, bits_per_key=10),
                        device="cpu")
        s.put_batch(list(range(400)), [b"v%d" % i for i in range(400)])
        s.delete(7)
        s.flush()
        assert s.multi_get([0, 7, 399, 400]) == [b"v0", None, b"v399", None]
        assert s.stats.compactions > 0
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_device_is_cuda_and_never_the_cpu():
    if torch.cuda.is_available():
        assert rt.LSMStore(rt.LSMConfig()).device == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            rt.LSMStore(rt.LSMConfig())
        with pytest.raises(RuntimeError, match="CUDA"):
            rt.LSMStore(rt.LSMConfig(), device="cuda")
    assert rt.LSMStore(rt.LSMConfig(), device="cpu").device.type == "cpu"


def test_sharded_facade_default_device_is_cuda_and_never_the_cpu():
    """``make_store`` of a sharded configuration means ``cuda:0`` for the
    facade and every shard, as a plain store does; the CPU only on
    request."""
    cfg = rt.core.LSMConfig(shards=2)
    if torch.cuda.is_available():
        db = rt.core.make_store(cfg)
        assert db.device == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            rt.core.make_store(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            rt.core.ShardedLSMStore(cfg, device="cuda")
    db = rt.core.make_store(cfg, device="cpu")
    assert isinstance(db, rt.core.ShardedLSMStore)
    assert [s.device.type for s in db.shards] == ["cpu", "cpu"]


# the sharded facade's fields (they need shards=2 to act on anything)
FACADE = {"shards": 2, "shard_splitters": (200,),
          "rebalance_interval_ops": 100, "rebalance_ratio": 1.5}
# every field that has a non-default value to act on: the scheduler and the
# block cache, the range views, faults, telemetry, the tuner and the
# sharded facade's (an object field gets each package's own instance, made
# by the function given here)
LIFTED = {**FACADE, "async_compaction": True, "cache_bytes": 1 << 20,
          "pin_l0_bytes": 1 << 20, "cache_policy": "lru",
          "compaction_workers": 2, "slowdown_trigger": 8,
          "stall_trigger": 16, "bg_max_retries": 0,
          "use_range_views": True, "paranoid_checks": True,
          "telemetry": lambda m: m.Telemetry(),
          "faults": lambda m: m.FaultInjector(3).fail("wal_append"),
          "tuner": lambda m: m.OnlineTuner(interval_ops=64,
                                           min_window_ops=1)}


@pytest.mark.parametrize("field", sorted(LIFTED))
def test_lifted_config_field_takes_effect_as_in_the_reference(field):
    """One lifted field at its non-default value, on a CPU store and on
    the reference store with the same configuration (the scheduler's knobs
    with ``async_compaction``, the policy with a cache, where alone they
    act on nothing in either; the facade's with ``shards=2``), built
    through ``make_store``: the field acts the same way on both, and both
    end with the same tree, answers and counters."""
    import repro.core as ref
    from test_torch_store import assert_same_tree
    kw = dict(memtable_bytes=1 << 11, base_level_bytes=1 << 13,
              bits_per_key=8, bloom_allocation="monkey")
    if field in ("compaction_workers", "slowdown_trigger", "stall_trigger",
                 "bg_max_retries"):
        kw["async_compaction"] = True
    if field == "cache_policy":
        kw["cache_bytes"] = 1 << 14
    if field in FACADE and field != "shards":
        kw["shards"] = 2
    if field == "rebalance_ratio":   # shard 1 takes 85% of the load: 1.7
        kw.update(shard_splitters=(60,), rebalance_interval_ops=300)

    def config(m):
        value = LIFTED[field]
        extra = {field: value(m) if callable(value) else value}
        if field == "tuner":             # the tuner senses through telemetry
            extra["telemetry"] = m.Telemetry()
        return m.LSMConfig(**kw, **extra)

    stores = [rt.core.make_store(config(rt.core), device="cpu"),
              ref.make_store(config(ref))]
    rng = np.random.default_rng(len(field))
    keys = rng.integers(0, 400, 1500).tolist()
    for s, m in zip(stores, (rt.core, ref)):
        if callable(LIFTED[field]):
            assert type(getattr(s.config, field)).__module__ \
                == type(LIFTED[field](m)).__module__
        else:
            assert getattr(s.config, field) == LIFTED[field]
        if field in ("slowdown_trigger", "bg_max_retries"):
            s._scheduler.pause()         # the backlog grows: every rotation
        if field == "faults":            # the first write is refused once
            with pytest.raises(m.InjectedFault):
                s.put(keys[0], b"refused")
        for i, k in enumerate(keys):     # past the 8th is a slowdown
            s.put(k, b"%d" % i)
        if field == "bg_max_retries":    # the first flush job fails
            def boom(imm):
                raise RuntimeError("injected background failure")
            s._bg_flush = boom
        s.flush()
        if field == "slowdown_trigger":
            assert s.stats.write_slowdowns == len(s._imm) - 8 > 0
        if field in ("slowdown_trigger", "bg_max_retries"):
            s._scheduler.resume()
        if field == "bg_max_retries":
            with pytest.raises(RuntimeError, match="background"):
                s.wait_for_quiesce(60)
            assert s.degraded and s.stats.bg_retries == 0
            assert s.stats.bg_gave_up == 1
            del s._bg_flush
            s.crash()
            s.recover()
        assert s.wait_for_quiesce(60)
        if field == "stall_trigger":
            assert s.stats.write_stalls == 0     # 16 never reached
        if field == "compaction_workers":
            assert len(s._scheduler._threads) == 2
        if field == "cache_policy":
            assert s.block_cache.policy == "lru"
        if field == "pin_l0_bytes":
            assert s.block_cache.capacity_bytes == 0
            assert s.pinned_l0.pin_l0_bytes == 1 << 20
        if field == "async_compaction":
            assert s.stats.bg_flushes > 0
        if field == "faults":
            assert s.config.faults.fired == {"wal_append": 1}
        if field == "tuner":
            s.apply_tuning()
            assert s.config.tuner.ticks > 0
        if field == "shards":
            assert len(s.shards) == 2
        if field == "shard_splitters":
            assert s.splitters == (200,)
        if field in ("rebalance_interval_ops", "rebalance_ratio"):
            assert s.rebalances > 0
    answers = [[s.get(k) for k in range(0, 420, 7)]
               + s.multi_get(list(range(420))) + s.scan(13, 50)
               + [s.seek(k) for k in range(0, 420, 41)]
               for s in stores]
    assert answers[0] == answers[1]
    if field == "use_range_views":
        assert all(s.stats.view_scans > 0 for s in stores)
    if field == "telemetry":
        assert [e.kind for e in stores[0].telemetry.trace.dump()] == \
            [e.kind for e in stores[1].telemetry.trace.dump()]
    if field == "tuner":                # the knobs move with the host's
        for s in stores:                # timing: the data must not
            s.close()
        return
    if field in FACADE:
        assert stores[0].splitters == stores[1].splitters
        assert stores[0].rebalances == stores[1].rebalances
    if field != "bg_max_retries":       # recovery rebuilt the memtable
        for p, r in zip(getattr(stores[0], "shards", stores[:1]),
                        getattr(stores[1], "shards", stores[1:])):
            assert_same_tree(p, r)
    timing = ("stall_ns", "write_stalls", "view_rebuild_ns") + (
        () if field == "slowdown_trigger" else ("write_slowdowns",))
    st = [{k: v for k, v in dataclasses.asdict(s.stats).items()
           if k not in timing} for s in stores]
    assert st[0] == st[1]
    assert stores[0].cache_summary() == stores[1].cache_summary()
    for s in stores:
        s.close()


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch import _build
    try:
        _build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_kernels_equal_plain_versions_on_the_card(cuda):
    rng = np.random.default_rng(0)
    keys = ops.keys_to_device(rng.integers(0, 2**64 - 1, 100_000,
                                           dtype=np.uint64), cuda)
    for n_words, k in ((1, 1), (3125, 7), (100_003, 5)):
        bits = bloom.build_cuda(keys, n_words, k)
        assert torch.equal(bits, bloom.build_plain(keys, n_words, k))
        q = torch.cat([keys[:777], ops.keys_to_device(rng.integers(
            0, 2**64 - 1, 1000, dtype=np.uint64), cuda)])
        assert torch.equal(bloom.probe_cuda(q, bits, k),
                           bloom.probe_plain(q, bits, k))
    for na, nb in ((0, 5), (5, 0), (1, 100_000), (40_000, 60_000)):
        a = torch.sort(keys[:na]).values
        b = torch.sort(torch.cat([keys[na // 2:na], keys[-nb:]])[:nb]).values
        got, want = merge.merge_pair_cuda(a, b), merge.merge_pair_plain(a, b)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.cuda.synchronize()


def bloom_card_sizes(device):
    """Filter sizes in words at the card's edges: one word either side of
    the largest filter one block's shared memory holds, at and beside
    slice boundaries, and past 2^28 bits (17-bit slices, 32-bit
    offsets)."""
    switch = bloom.card_limits(device)[0] // 4
    return [1, 11_300, switch, switch + 1, 2048 * 29, 2048 * 29 + 1,
            2048 * 30 - 1, (1 << 23) + 1]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 7, 20])
def test_bloom_build_ways_equal_plain_on_the_card(cuda, k):
    rng = np.random.default_rng(k)
    keys = ops.keys_to_device(rng.integers(0, 2**64 - 1, 1_000_000,
                                           dtype=np.uint64), cuda)
    same = ops.keys_to_device(np.full(1_000_000, 12345, np.uint64), cuda)
    ops.reset_launch_counts()
    for m_words in bloom_card_sizes(cuda):
        for n in (0, 1, 1_000_000):
            got = bloom.build_cuda(keys[:n], m_words, k)
            assert torch.equal(got, bloom.build_plain(keys[:n], m_words, k)), \
                (m_words, n, k)
        # one key a million times: its slices overflow their segments
        assert torch.equal(bloom.build_cuda(same, m_words, k),
                           bloom.build_plain(same, m_words, k)), m_words
    assert ops.launch_counts()["bloom_build"] == \
        len(ops.launch_sizes()["bloom_build"]) == 3 * len(
            bloom_card_sizes(cuda))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_merge_pair_tiles_equal_plain_on_the_card(cuda):
    rng = np.random.default_rng(2)
    tile = merge.TILE
    top = np.uint64(2**64 - 1)

    def rand(n, hi=2**64 - 1):
        return np.sort(rng.integers(0, hi, n, dtype=np.uint64))

    # equal keys across a tile boundary; duplicates across sides at a tile
    # edge; one element against a million and back; one side empty; the
    # u64 maximum on both sides; duplicates within a side
    edge = rand(tile)
    shared_edge = np.sort(np.concatenate([edge, edge[tile // 2 - 8:
                                                     tile // 2 + 8]]))
    cases = [
        (np.full(3000, 5, np.uint64), np.full(3000, 5, np.uint64)),
        (shared_edge, np.sort(np.concatenate([edge[tile // 2 - 8:
                                                   tile // 2 + 8],
                                              rand(tile - 16)]))),
        (rand(1), rand(1_000_000)), (rand(1_000_000), rand(1)),
        (rand(0), rand(5000)), (rand(5000), rand(0)),
        (np.append(rand(3000), top), np.append(rand(2000), [top, top])),
        (rand(7000, 50), rand(9000, 50)),
        (rand(tile - 1), rand(tile + 1)), (rand(tile), rand(tile)),
        # past merge.SPLIT_TILES tiles: the ends from the split kernel
        (rand(2_500_000), rand(2_000_000)),
        (rand(2_200_000, 1000), rand(2_200_000, 1000)),
    ]
    assert -(-(4_400_000) // tile) >= merge.SPLIT_TILES
    for a, b in cases:
        ta, tb = ops.keys_to_device(a, cuda), ops.keys_to_device(b, cuda)
        gk, gs = merge.merge_pair_cuda(ta, tb)
        wk, ws = merge.merge_pair_plain(ta, tb)
        assert torch.equal(gk, wk) and torch.equal(gs, ws), (a.size, b.size)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_store_equals_cpu_store(cuda):
    from test_torch_store import gen_ops, read_batches
    cfg = rt.LSMConfig(memtable_bytes=2 << 10, base_level_bytes=4 << 10,
                       bits_per_key=10.0)
    stores = [rt.LSMStore(cfg, device=cuda), rt.LSMStore(cfg, device="cpu")]
    ops.reset_launch_counts()
    for kind, args in gen_ops(7, 3000):
        for s in stores:
            getattr(s, kind)(*args)
    for batch in read_batches(1):
        assert stores[0].multi_get(batch) == stores[1].multi_get(batch)
    a, b = (rt.columns_of(s) for s in stores)
    assert dataclasses.asdict(stores[0].stats) == \
        dataclasses.asdict(stores[1].stats)
    for lvl_a, lvl_b in zip(a["levels"], b["levels"]):
        for ra, rb in zip(lvl_a, lvl_b):
            for name in ra:
                np.testing.assert_array_equal(ra[name], rb[name])
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in ("bloom_probe", "bloom_build",
                                       "merge_pair"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_kernels_equal_plain_versions_on_the_card(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    tol = {"float32": 2e-5, "bfloat16": 2e-2}[dtype]

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=cuda).to(dt)

    # dh 1..128 (20 and 1: rows not 16-byte aligned), Sq no multiple of the
    # 64-row tile, Sq != Sk, rows that the window leaves without a key,
    # causal and not
    for B, Sq, Sk, H, KH, dh, causal, window in [
            (2, 100, 100, 4, 2, 8, True, 0), (2, 256, 256, 4, 2, 32, True, 64),
            (1, 70, 130, 16, 1, 64, False, 50), (1, 200, 100, 4, 4, 128,
                                                 True, 30),
            (1, 300, 300, 8, 2, 128, False, 0), (1, 1, 50, 4, 2, 16, True, 0),
            (2, 130, 130, 6, 3, 20, True, 0), (1, 65, 65, 2, 1, 1, False, 0),
            (1, 90, 40, 4, 2, 64, False, 20)]:
        q, k, v = randn(B, Sq, H, dh), randn(B, Sk, KH, dh), \
            randn(B, Sk, KH, dh)
        got = attention.flash_cuda(q, k, v, causal=causal, window=window)
        want = attention.flash_plain(q, k, v, causal=causal, window=window)
        assert float((got.float() - want.float()).abs().max()) <= tol
    # lengths 0, 1, page and P * page; groups 1, 4 and 32; splits of one
    # tile and of several (B, H, KH, dh, page, P, lengths)
    for B, H, KH, dh, page, P, lens in [
            (2, 4, 4, 16, 8, 3, [1, 24]), (3, 8, 2, 32, 16, 4, [5, 64, 0]),
            (1, 16, 1, 64, 32, 2, [33]),
            (5, 32, 8, 128, 64, 16, [0, 1, 64, 1024, 600]),
            (4, 32, 1, 64, 16, 40, [0, 1, 16, 640]),
            (3, 8, 8, 64, 32, 6, [0, 32, 192]),
            (2, 16, 8, 128, 64, 64, [4096, 3000]),
            (2, 4, 2, 6, 8, 5, [7, 40])]:
        nphys = B * P + 2
        q, kp, vp = randn(B, H, dh), randn(nphys, page, KH, dh), \
            randn(nphys, page, KH, dh)
        bt = torch.randint(0, nphys, (B, P), generator=g, device=cuda,
                           dtype=torch.int32)
        ln = torch.tensor(lens, dtype=torch.int32, device=cuda)
        got = attention.paged_cuda(q, kp, vp, bt, ln)
        want = attention.paged_plain(q, kp, vp, bt, ln)
        assert float((got.float() - want.float()).abs().max()) <= tol
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_decode_partials_merge_to_one_paged_call_on_the_card(cuda,
                                                                    dtype):
    """Flash-decoding across ranks (ROADMAP A16a): K3's partials entry on
    each half of every row's pages, merged as two ranks merge them, against
    one K3 call over all pages and against the plain partials; the same
    bits twice."""
    g = torch.Generator(device=cuda).manual_seed(1)
    dt = getattr(torch, dtype)
    tol = {"float32": 2e-5, "bfloat16": 2e-2}[dtype]
    B, H, KH, dh, page, P = 4, 32, 8, 128, 64, 16
    q = torch.randn(B, H, dh, generator=g, device=cuda).to(dt)
    kp = torch.randn(B * P, page, KH, dh, generator=g, device=cuda).to(dt)
    vp = torch.randn(B * P, page, KH, dh, generator=g, device=cuda).to(dt)
    bt = torch.randperm(B * P, generator=g, device=cuda).to(
        torch.int32).view(B, P)
    lens = torch.tensor([1, 500, 513, P * page], dtype=torch.int32,
                        device=cuda)
    half = P // 2 * page

    def halves(partials):
        return [partials(q, kp, vp, bt[:, r * P // 2:(r + 1) * P // 2]
                         .contiguous(), torch.clamp(lens - r * half, 0, half)
                         .to(torch.int32)) for r in (0, 1)]

    got = attention.merge_across(halves(attention.paged_partials_cuda))
    again = attention.merge_across(halves(attention.paged_partials_cuda))
    plain = attention.merge_across(halves(attention.paged_partials_plain))
    one = attention.paged_cuda(q, kp, vp, bt, lens).float()
    for a, b, c in zip(got, again, plain):
        assert torch.equal(a, b)
        assert float((a - c).abs().max()) <= 2e-5
        assert float((a.to(dt).float() - one).abs().max()) <= tol
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_kernels_at_head_dim_256_on_the_card(cuda, dtype):
    """K4 and K3 past dh 128 (the reference's kernels block on any dh):
    gemma3's and recurrentgemma's dh 256 with G 4 and 10, windowed,
    non-causal with Sq != Sk, dh 192 and 250 (padded to 256; 250 takes
    the element loads); the same bits twice; a group too wide for one
    paged block raises instead of answering."""
    g = torch.Generator(device=cuda).manual_seed(2)
    dt = getattr(torch, dtype)
    tol = {"float32": 2e-5, "bfloat16": 2e-2}[dtype]

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=cuda).to(dt)

    for B, Sq, Sk, H, KH, dh, causal, window in [
            (2, 130, 130, 4, 1, 256, True, 64),
            (1, 200, 200, 10, 1, 256, True, 0),
            (1, 70, 200, 8, 2, 256, False, 0),
            (1, 1, 90, 4, 1, 256, False, 0),
            (1, 100, 100, 4, 2, 192, True, 30),
            (1, 80, 80, 2, 1, 250, True, 0)]:
        q, k, v = randn(B, Sq, H, dh), randn(B, Sk, KH, dh), \
            randn(B, Sk, KH, dh)
        got = attention.flash_cuda(q, k, v, causal=causal, window=window)
        want = attention.flash_plain(q, k, v, causal=causal, window=window)
        assert float((got.float() - want.float()).abs().max()) <= tol
        assert torch.equal(got, attention.flash_cuda(q, k, v, causal=causal,
                                                     window=window))
    for B, H, KH, dh, page, P, lens in [
            (2, 4, 1, 256, 64, 8, [512, 37]),
            (2, 10, 1, 256, 64, 16, [1024, 700]),
            (3, 10, 1, 256, 64, 32, [0, 1, 2048]),
            (2, 8, 2, 200, 16, 5, [80, 3])]:
        nphys = B * P + 2
        q, kp, vp = randn(B, H, dh), randn(nphys, page, KH, dh), \
            randn(nphys, page, KH, dh)
        bt = torch.randint(0, nphys, (B, P), generator=g, device=cuda,
                           dtype=torch.int32)
        ln = torch.tensor(lens, dtype=torch.int32, device=cuda)
        got = attention.paged_cuda(q, kp, vp, bt, ln)
        want = attention.paged_plain(q, kp, vp, bt, ln)
        assert float((got.float() - want.float()).abs().max()) <= tol
        assert torch.equal(got, attention.paged_cuda(q, kp, vp, bt, ln))
    q, kp = randn(1, 32, 256), randn(4, 64, 1, 256)
    if dtype == "float32":                      # 32 heads x 64 chunks
        with pytest.raises(ValueError, match="outputs one block holds"):
            attention.paged_cuda(q, kp, kp, torch.zeros(
                1, 4, dtype=torch.int32, device=cuda), torch.ones(
                1, dtype=torch.int32, device=cuda))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_kernels_are_deterministic_on_the_card(cuda, dtype):
    """Two calls give the same bits; a paged row alone gives the bits it
    gets inside a batch of rows of other lengths."""
    g = torch.Generator(device=cuda).manual_seed(1)
    dt = getattr(torch, dtype)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=cuda).to(dt)

    q, k, v = randn(2, 300, 8, 128), randn(2, 300, 2, 128), \
        randn(2, 300, 2, 128)
    assert torch.equal(attention.flash_cuda(q, k, v),
                       attention.flash_cuda(q, k, v))
    B, H, KH, dh, page, P = 4, 32, 8, 128, 64, 16
    q, kp, vp = randn(B, H, dh), randn(B * P, page, KH, dh), \
        randn(B * P, page, KH, dh)
    bt = torch.randperm(B * P, generator=g, device=cuda).to(
        torch.int32).view(B, P)
    ln = torch.tensor([700, 1, 1024, 0], dtype=torch.int32, device=cuda)
    batch = attention.paged_cuda(q, kp, vp, bt, ln)
    assert torch.equal(batch, attention.paged_cuda(q, kp, vp, bt, ln))
    alone = attention.paged_cuda(q[:1].contiguous(), kp, vp,
                                 bt[:1].contiguous(), ln[:1].contiguous())
    assert torch.equal(alone[0], batch[0])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 7, 20])
def test_bloom_probe_equals_plain_on_the_card(cuda, k):
    """The probe at k 1/7/20 (an odd k leaves the last pair of positions
    half empty) against filters of 1 word, a flush's and nearly 2^32 bits;
    0 to a few thousand keys, views at odd element offsets, the u64
    extremes, and a launch larger than one pass of the grid."""
    rng = np.random.default_rng(10 + k)
    keys = ops.keys_to_device(rng.integers(0, 2**64 - 1, 2_600_000,
                                           dtype=np.uint64), cuda)
    edge = ops.keys_to_device(np.array([0, 1, 2**63 - 1, 2**63, 2**64 - 2,
                                        2**64 - 1], np.uint64), cuda)
    q_all = torch.cat([edge, keys[:1000], keys[200_000:203_000]])
    ops.reset_launch_counts()
    for m_words in (1, 11_300, (1 << 27) - 1):
        bits = bloom.build_cuda(keys[:100_000], m_words, k)
        for n in (0, 1, 3, 4, 5, 7, 8, 9, 63, 64, 65, 255, 256, 257, 4003):
            for off in (0, 1, 2, 3):
                q = q_all[off:off + n]
                assert torch.equal(bloom.probe_cuda(q, bits, k),
                                   bloom.probe_plain(q, bits, k)), \
                    (m_words, n, off)
        assert torch.equal(bloom.probe_cuda(keys[1:], bits, k),
                           bloom.probe_plain(keys[1:], bits, k)), m_words
    sizes = ops.launch_sizes()["bloom_probe"]
    assert ops.launch_counts()["bloom_probe"] == len(sizes) > 0
    assert (keys.numel() - 1, (1 << 27) - 1) in sizes
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_store_range_reads_equal_cpu_store(cuda):
    """scan, seek, the streaming iterator and multi_get on a CUDA store and
    a CPU store, on the current state and under a snapshot taken mid-load:
    the same answers and IOStats; no pin left after the release."""
    from test_torch_store import gen_ops
    cfg = rt.LSMConfig(memtable_bytes=2 << 10, base_level_bytes=4 << 10,
                       bits_per_key=10.0)
    stores = [rt.LSMStore(cfg, device=cuda), rt.LSMStore(cfg, device="cpu")]
    steps = gen_ops(5, 3000)
    for kind, args in steps[:len(steps) // 2]:
        for s in stores:
            getattr(s, kind)(*args)
    for s in stores:
        s.flush()
    snaps = [s.get_snapshot() for s in stores]
    for kind, args in steps[len(steps) // 2:]:
        for s in stores:
            getattr(s, kind)(*args)
    starts = [0, 1, 2**63 - 1, 2**63, 2**64 - 1] + list(range(0, 4100, 97))

    def answers(s, snap):
        it = s.iterator(snapshot=snap)
        it.seek(50)
        return ([s.scan(a, 1 + a % 60, snapshot=snap) for a in starts],
                [s.seek(a, snapshot=snap) for a in starts],
                list(it), s.multi_get(starts, snapshot=snap),
                s.scan_scalar(7, 40, snapshot=snap))

    for snap_a, snap_b in ((None, None), tuple(snaps)):
        assert answers(stores[0], snap_a) == answers(stores[1], snap_b)
    assert dataclasses.asdict(stores[0].stats) == \
        dataclasses.asdict(stores[1].stats)
    for s, snap in zip(stores, snaps):
        s.release_snapshot(snap)
        assert s.manifest.total_pin_refs() == 0
    assert len(stores[0].storage) == len(stores[1].storage)
    torch.cuda.synchronize()


def store_pair_steps(cuda, sync_cpu: bool, **kw):
    """A CUDA store with async compaction, a block cache and a pin budget,
    and a CPU store of the same configuration (synchronous if
    ``sync_cpu``), after the same seeded op script."""
    from test_torch_store import gen_ops
    base = dict(memtable_bytes=2 << 10, base_level_bytes=4 << 10,
                bits_per_key=10.0, cache_bytes=1 << 16, pin_l0_bytes=1 << 14,
                cache_policy="lru", **kw)
    stores = [rt.LSMStore(rt.LSMConfig(async_compaction=True, **base),
                          device=cuda.type),      # "cuda": no index given
              rt.LSMStore(rt.LSMConfig(async_compaction=not sync_cpu,
                                       **base), device="cpu")]
    for kind, args in gen_ops(7, 3000):
        for s in stores:
            getattr(s, kind)(*args)
    return stores


def timing_free(store) -> dict:
    skip = ("stall_ns", "write_stalls", "write_slowdowns", "bg_flushes",
            "bg_compactions")
    return {k: v for k, v in dataclasses.asdict(store.stats).items()
            if k not in skip}


@pytest.mark.cuda
def test_cuda_async_cached_store_equals_cpu_sync_store(cuda):
    """The CUDA store's flushes and compactions run on the scheduler's
    worker thread, its reads through the block cache: after quiesce the
    tree, every answer and every counter equal the CPU synchronous
    store's, and the store kernels launched from the worker."""
    from test_torch_store import read_batches
    ops.reset_launch_counts()
    stores = store_pair_steps(cuda, sync_cpu=True)
    assert stores[0].device == cuda
    for s in stores:
        s.flush()
    assert stores[0].wait_for_quiesce(120)
    counts = ops.launch_counts()
    assert counts["bloom_build"] > 0 and counts["merge_pair"] > 0
    for batch in read_batches(1):
        assert stores[0].multi_get(batch) == stores[1].multi_get(batch)
    starts = [0, 5, 2**63, 2**64 - 1] + list(range(0, 4100, 211))
    assert [stores[0].scan(a, 30) for a in starts] == \
        [stores[1].scan(a, 30) for a in starts]
    assert [stores[0].seek(a) for a in starts] == \
        [stores[1].seek(a) for a in starts]
    assert ops.launch_counts()["bloom_probe"] > 0
    a, b = (rt.columns_of(s) for s in stores)
    for lvl_a, lvl_b in zip(a["levels"], b["levels"]):
        for ra, rb in zip(lvl_a, lvl_b):
            for name in ra:
                np.testing.assert_array_equal(ra[name], rb[name])
    assert timing_free(stores[0]) == timing_free(stores[1])
    assert stores[0].cache_summary() == stores[1].cache_summary()
    st = stores[0].stats
    assert st.bg_flushes > 0 and st.bg_retries == st.bg_gave_up == 0
    assert not stores[0].degraded
    stores[0].close()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_crash_recover_reads_back_every_fsynced_write(cuda):
    """Crash the CUDA store with rotations queued and an unsynced tail:
    recovery (WAL replay, scrub of every run on the card) reads back every
    fsynced write and loses the tail, as the CPU store does."""
    stores = store_pair_steps(cuda, sync_cpu=False)
    for s in stores:
        s.flush()                          # fsyncs: all of the script
        s.put_batch(list(range(5000, 5040)), b"unsynced")
    want = stores[1].multi_get(list(range(4100)))
    for s in stores:
        s.crash()
        assert s.manifest.total_pin_refs() == 0
        s.recover()
        assert not s.degraded and s.stats.bg_gave_up == 0
    keys = list(range(4100)) + list(range(5000, 5040))
    got = [s.multi_get(keys) for s in stores]
    assert got[0] == got[1] and got[0][:4100] == want
    assert got[0][4100:] == [None] * 40
    assert all(not r["bad_blocks"] for r in stores[0].scrub())
    for s in stores:
        s.put(1, b"after")
        s.flush()
        assert s.wait_for_quiesce(120)
        assert s.get(1) == b"after"
        s.close()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_paranoid_batch_verify_equals_cpu_on_the_card(cuda):
    """The batched block verify of a paranoid multi_get on the card: the
    same answers, counters and one pass per run as on the CPU, and on a
    corrupted run the same lowest bad block."""
    from repro_torch.core import run as port_run
    cfg = rt.LSMConfig(memtable_bytes=2 << 10, base_level_bytes=4 << 10,
                       bits_per_key=10.0, paranoid_checks=True)
    stores = [rt.LSMStore(cfg, device=cuda), rt.LSMStore(cfg, device="cpu")]
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 4000, 3000).tolist()
    for s in stores:
        s.put_batch(keys, [bytes([k % 251]) * (k % 120) for k in keys])
        s.flush()
    probe = rng.integers(0, 4400, 20_000).tolist()
    before = port_run.VERIFY_PASSES["batch"]
    got = stores[0].multi_get(probe)
    passes = port_run.VERIFY_PASSES["batch"] - before
    assert got == stores[1].multi_get(probe)
    assert passes <= sum(len(lvl) for lvl in stores[0]._levels)
    assert dataclasses.asdict(stores[0].stats) == \
        dataclasses.asdict(stores[1].stats)
    lvl = max(i for i, lv in enumerate(stores[1]._levels) if lv)
    bids = []
    for s in stores:
        bids.append(rt.core.FaultInjector(7).corrupt_run_block(
            s._levels[lvl][0]))
    assert bids[0] == bids[1]
    raised = []
    for s in stores:
        with pytest.raises(rt.core.CorruptionError) as ei:
            s.multi_get(probe)
        raised.append(ei.value.block_id)
    assert raised[0] == raised[1]
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_range_view_build_equals_cpu_on_the_card(cuda):
    """The range view built with the merge kernel on the card: the same
    five columns as the CPU store's plain build, the same scans and seeks
    and counters, after flushes that leave a multi-run L0."""
    cfg = rt.LSMConfig(memtable_bytes=2 << 10, base_level_bytes=4 << 10,
                       bits_per_key=10.0, use_range_views=True,
                       l0_compaction_trigger=6)
    stores = [rt.LSMStore(cfg, device=cuda), rt.LSMStore(cfg, device="cpu")]
    rng = np.random.default_rng(4)
    ops.reset_launch_counts()
    for wave in range(6):
        keys = rng.integers(0, 6000, 500).tolist()
        for s in stores:
            s.put_batch(keys, [b"w%d" % wave * (k % 9) for k in keys])
            s.delete_batch(keys[:40])
            s.flush()
        views = [s.refresh_range_view() for s in stores]
        for name in ("keys", "src", "rows", "live", "blocks"):
            assert torch.equal(getattr(views[0], name).cpu(),
                               getattr(views[1], name)), name
    assert ops.launch_counts()["merge_pair"] > 0
    starts = [0, 1, 2**63, 2**64 - 1] + rng.integers(0, 6000, 60).tolist()
    for s in stores:
        s.put(17, b"overlay")
    assert [stores[0].scan(a, 1 + a % 90) for a in starts] == \
        [stores[1].scan(a, 1 + a % 90) for a in starts]
    assert [stores[0].seek(a) for a in starts] == \
        [stores[1].seek(a) for a in starts]
    skip = ("view_rebuild_ns",)
    assert {k: v for k, v in dataclasses.asdict(stores[0].stats).items()
            if k not in skip} == \
        {k: v for k, v in dataclasses.asdict(stores[1].stats).items()
         if k not in skip}
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_sharded_facade_equals_cpu_facade(cuda):
    """A two-shard facade on the card and one on the CPU after the same
    script: the same answers and IOStats, before and after ``rebalance_to``
    moves the splitter across the sign bit of the order map (the migration
    splits the exported device columns on the card), and the same shard
    contents after it."""
    from test_torch_store import gen_ops
    cfg = dict(shards=2, memtable_bytes=2 << 10, base_level_bytes=4 << 10,
               bits_per_key=10.0, shard_splitters=(2000,))
    stores = [rt.core.make_store(rt.LSMConfig(**cfg), device=cuda),
              rt.core.make_store(rt.LSMConfig(**cfg), device="cpu")]
    assert all(s.device == cuda for s in stores[0].shards)
    for kind, args in gen_ops(11, 3000):
        for s in stores:
            getattr(s, kind)(*args)
    starts = [0, 1, 1999, 2000, 2**63 - 1, 2**63, 2**64 - 1] \
        + list(range(0, 4100, 97))

    def answers(s):
        return ([s.scan(a, 1 + a % 60) for a in starts],
                [s.seek(a) for a in starts], s.multi_get(starts),
                s.scan_scalar(7, 40), [s.get(a) for a in starts[:20]])

    for target in (None, 2**63, 3000):
        if target is not None:
            for s in stores:
                assert s.rebalance_to([target])
        assert answers(stores[0]) == answers(stores[1])
        assert dataclasses.asdict(stores[0].stats) == \
            dataclasses.asdict(stores[1].stats)
        assert [sh.scan(0, 1 << 20) for sh in stores[0].shards] == \
            [sh.scan(0, 1 << 20) for sh in stores[1].shards]
    assert stores[0].migrated_entries == stores[1].migrated_entries > 0
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_make_store_sharded_lands_on_cuda_0(cuda):
    db = rt.core.make_store(rt.LSMConfig(shards=2))
    assert isinstance(db, rt.core.ShardedLSMStore)
    assert db.device == torch.device("cuda:0")
    assert all(s.device == torch.device("cuda:0") for s in db.shards)
    db.put_batch(list(range(100)) + [2**63 + 5], b"v")
    db.flush()
    assert db.multi_get([5, 2**63 + 5, 7000]) == [b"v", b"v", None]
    assert all(r.keys.device.type == "cuda"
               for s in db.shards for lvl in s._levels for r in lvl)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm_135m", "granite_moe_1b_a400m",
                                  "mamba2_130m"])
def test_train_step_on_the_card_equals_the_cpu(cuda, arch):
    """A smoke config (float32) on the card, under deterministic
    algorithms, against the CPU from the same parameters and batch: every
    gradient leaf within 1e-4 of max(1, |leaf|); one make_train_step step
    (AdamW at lr 1e-4: its first step is about g / (|g| + 1e-8), so a
    gradient near 1e-8 moves the update by up to lr when it rounds
    otherwise) with loss, grad norm and every updated parameter within
    1e-4 (rtol and atol); a second step on the card gives the same bits."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.train import deterministic_algorithms
    from repro_torch.models import init_params
    from repro_torch.models import train as T
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.train import OptConfig, init_opt_state, make_train_step
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16))
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int32)),
             "labels": torch.from_numpy(np.roll(tokens, -1, 1))}
    on = lambda tree: tree_map(lambda t: t.to(cuda), tree)
    _, want_g = T.value_and_grad(params, batch, cfg)
    with deterministic_algorithms():
        _, got_g = T.value_and_grad(on(params), on(batch), cfg)
    for (path, a), (_, b) in zip(tree_leaves(got_g), tree_leaves(want_g)):
        tol = 1e-4 * max(1.0, float(b.abs().max()))
        assert torch.allclose(a.cpu(), b, rtol=1e-4, atol=tol), path
    step = make_train_step(cfg, OptConfig(peak_lr=1e-4, warmup_steps=1,
                                          total_steps=10))
    want_p, _, want_m = step(params, init_opt_state(params), batch)
    with deterministic_algorithms():
        runs = [step(on(params), init_opt_state(on(params)), on(batch))
                for _ in range(2)]
    got_p, _, got_m = runs[0]
    for k in ("loss", "grad_norm"):
        assert abs(float(got_m[k]) - float(want_m[k])) <= \
            1e-4 + 1e-4 * abs(float(want_m[k])), k
    for (path, a), (_, b) in zip(tree_leaves(got_p), tree_leaves(want_p)):
        assert torch.allclose(a.cpu(), b, rtol=1e-4, atol=1e-4), path
    for (path, a), (_, b) in zip(tree_leaves(got_p),
                                 tree_leaves(runs[1][0])):
        assert torch.equal(a.view(-1).view(torch.uint8),
                           b.view(-1).view(torch.uint8)), path
