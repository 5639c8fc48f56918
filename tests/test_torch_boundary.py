"""The port's boundaries: no JAX and no ``repro`` inside it, no silent CPU
fallback, no unsupported option accepted and ignored.

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
import torch

import repro_torch as rt
from repro_torch.core.engine import _UNSUPPORTED
from repro_torch.kernels import attention, bloom, merge, ops

# Six xdist workers share 8 cores with the reference's timing-bounded
# property tests: one intra-op thread per worker keeps them on time.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
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


OFF_DEFAULT = {"async_compaction": True, "cache_bytes": 1 << 20,
               "pin_l0_bytes": 1 << 20, "shards": 2,
               "use_range_views": True, "telemetry": object(),
               "faults": object(), "tuner": object(),
               "paranoid_checks": True, "rebalance_interval_ops": 100}


@pytest.mark.parametrize("field", sorted(OFF_DEFAULT))
def test_unsupported_config_fields_raise(field):
    assert field in _UNSUPPORTED
    cfg = rt.LSMConfig(**{field: OFF_DEFAULT[field]})
    with pytest.raises(NotImplementedError, match=field):
        rt.LSMStore(cfg, device="cpu")


def test_unsupported_list_covers_every_non_default_field():
    assert set(OFF_DEFAULT) == set(_UNSUPPORTED)
    names = {f.name for f in dataclasses.fields(rt.LSMConfig)}
    assert "use_pallas_bloom" not in names
    assert "use_pallas_merge" not in names


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
