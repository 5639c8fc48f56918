"""The port's sharding rules against the reference's, the cross-rank merge
of split decode attention, and the port on meshes of one and of four gloo
ranks on the CPU against the reference's meshless results.

The rule tests are twins of ``tests/test_sharding.py`` on the same
shape-only 16 x 16 mesh, plus every cell and mode on four mesh shapes
against ``repro.launch.sharding`` key for key.  The ranks run
``_torch_mesh_worker.py`` (torch only); their full results are held here
against JAX: the loss, metrics and every gradient leaf within 1e-4 of
max(1, |reference|) in float32, prefill and decode logits within 1e-4
with equal greedy tokens.  Mesh (1, 1) must give no mesh's bits.
"""
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import _torch_mesh as TM  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch import sharding as RS  # noqa: E402
from repro.models.model import cache_logical_specs as ref_cache_specs  # noqa: E402,E501
from repro.models.params import logical_specs as ref_logical_specs  # noqa: E402,E501
from repro_torch.configs import (ARCH_IDS, SHAPES, all_cells,  # noqa: E402
                                 get_config, shape_applicable)
from repro_torch.kernels import attention  # noqa: E402
from repro_torch.launch.sharding import make_rules, spec_for  # noqa: E402
from repro_torch.models import cache_logical_specs  # noqa: E402
from repro_torch.models.params import (logical_specs, param_table,  # noqa: E402,E501
                                       tree_leaves)

F32_TOL = 1e-4
ROOT = Path(__file__).resolve().parents[1]


class FakeMesh:
    """Shape-only stand-in (tests must not allocate 256 devices)."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.zeros(shape)
        self.shape = dict(zip(names, shape))


MESH = FakeMesh((16, 16), ("data", "model"))
MESHES = {"16x16": FakeMesh((16, 16), ("data", "model")),
          "2x16x16": FakeMesh((2, 16, 16), ("pod", "data", "model")),
          "2x2": FakeMesh((2, 2), ("data", "model")),
          "1x4": FakeMesh((1, 4), ("data", "model"))}


# ------------------------------------------- twins of tests/test_sharding.py
def test_spec_dedup_never_reuses_axis():
    rules = {"a": "model", "b": "model", "c": ("data",)}
    assert spec_for(("a", "b", "c"), rules) == ("model", None, "data")


def test_heads_fallback_smollm():
    cfg = get_config("smollm_135m")  # 9 heads
    prules, arules = make_rules(cfg, MESH, "train", 256, 4096)
    assert prules["heads"] is None and prules["mlp"] == "model"
    assert arules["seq"] == "model"  # SP fallback engaged


def test_heads_tp_qwen3():
    cfg = get_config("qwen3_4b")  # 32 heads
    prules, arules = make_rules(cfg, MESH, "train", 256, 4096)
    assert prules["heads"] == "model"
    assert arules["seq"] is None
    # decode: kv=8 unshardable => flash-decoding over kv_seq
    _, drules = make_rules(cfg, MESH, "decode", 128, 32768)
    assert drules["kv_seq"] == "model" and drules["heads"] is None


def test_moe_expert_rules():
    g = get_config("granite_moe_1b_a400m")   # 32 experts: EP
    m = get_config("mixtral_8x22b")          # 8 experts: fallback to TP
    assert make_rules(g, MESH, "train", 256, 4096)[0]["expert"] == "model"
    assert make_rules(m, MESH, "train", 256, 4096)[0]["expert"] is None


def test_batch1_cells_replicate_batch():
    cfg = get_config("gemma3_1b")
    _, arules = make_rules(cfg, MESH, "decode", 1, 524288)
    assert arules["batch"] is None
    assert arules["kv_seq"] == ("data", "model")


def test_every_cell_has_valid_param_specs():
    """Every runnable (arch x shape): all param specs rank-match and every
    sharded dim is divisible by its mesh axes."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        specs = [lg for _, lg in tree_leaves(
            logical_specs(cfg), is_leaf=lambda x: isinstance(x, tuple))]
        table = [s for _, s in tree_leaves(
            param_table(cfg), is_leaf=lambda x: hasattr(x, "logical"))]
        for shape in SHAPES.values():
            if not shape_applicable(cfg, shape)[0]:
                continue
            prules, _ = make_rules(cfg, MESH, shape.mode,
                                   shape.global_batch, shape.seq_len)
            for lg, tbl in zip(specs, table):
                p = spec_for(lg, prules)
                assert len(p) <= len(tbl.shape)
                for dim, part in zip(tbl.shape, p):
                    if part is None:
                        continue
                    parts = (part,) if isinstance(part, str) else part
                    k = int(np.prod([MESH.shape[a] for a in parts]))
                    assert dim % k == 0, (arch, tbl.shape, p)


# ------------------------------------------- the rules equal the reference's
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_and_specs_equal_the_reference(arch, mesh):
    """Every cell of ``arch`` in train, prefill and decode on ``mesh``:
    both rule tables key for key, and the spec of every parameter leaf and
    every cache leaf."""
    fake = MESHES[mesh]
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    leaves = [lg for _, lg in tree_leaves(
        logical_specs(cfg), is_leaf=lambda x: isinstance(x, tuple))]
    import jax
    ref_leaves = jax.tree.flatten(ref_logical_specs(ref_cfg),
                                  is_leaf=lambda x: isinstance(x, tuple))[0]
    assert leaves == [tuple(x) for x in ref_leaves]
    cache = [lg for _, lg in tree_leaves(
        cache_logical_specs(cfg, 2, 64),
        is_leaf=lambda x: isinstance(x, tuple))]
    ref_cache = jax.tree.flatten(ref_cache_specs(ref_cfg, 2, 64),
                                 is_leaf=lambda x: isinstance(x, tuple))[0]
    assert sorted(map(repr, cache)) == sorted(repr(tuple(x))
                                              for x in ref_cache)
    cells = [s for a, s in all_cells() if a == arch]
    assert cells == list(SHAPES)
    for shape_name in cells:
        shape = SHAPES[shape_name]
        for mode in ("train", "prefill", "decode"):
            got = make_rules(cfg, fake, mode, shape.global_batch,
                             shape.seq_len)
            want = RS.make_rules(ref_cfg, fake, mode, shape.global_batch,
                                 shape.seq_len)
            for g, w in zip(got, want):
                assert g == w, (shape_name, mode)
                for lg in leaves + cache:
                    assert spec_for(lg, g) == tuple(RS.spec_for(lg, w)), \
                        (shape_name, mode, lg)


# --------------------------------------------------- the cross-rank merge
@pytest.mark.parametrize("G,dtype", [(1, torch.float32), (4, torch.float32),
                                     (8, torch.bfloat16)])
def test_partials_of_two_halves_merge_to_paged_plain(G, dtype):
    """Split decode attention (ROADMAP A16a): the plain partials of each
    half of every row's pages, merged as two ranks merge them, against
    ``paged_plain`` over all of them; a row whose length ends in the first
    half leaves the second rank only masked positions, whose weight in the
    merge is 0."""
    g = torch.Generator().manual_seed(G)
    B, KH, dh, page, P = 4, 2, 16, 8, 6
    H = G * KH
    q = torch.randn(B, H, dh, generator=g).to(dtype)
    kp = torch.randn(B * P, page, KH, dh, generator=g).to(dtype)
    vp = torch.randn(B * P, page, KH, dh, generator=g).to(dtype)
    bt = torch.randperm(B * P, generator=g).to(torch.int32).view(B, P)
    lens = torch.tensor([1, 20, 25, P * page], dtype=torch.int32)
    half = P // 2 * page
    parts = [attention.paged_partials_plain(
        q, kp, vp, bt[:, r * P // 2:(r + 1) * P // 2].contiguous(),
        torch.clamp(lens - r * half, 0, half).to(torch.int32), pps)
        for r, pps in ((0, 1), (1, 2))]
    want = attention.paged_plain(q, kp, vp, bt, lens).float()
    for got in attention.merge_across(parts):
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        np.testing.assert_allclose(got.to(dtype).float().numpy(),
                                   want.numpy(), rtol=tol, atol=tol)


def test_merge_of_one_rank_is_the_split_kernels_combine():
    """One rank, no all-reduce: ``merge_partials`` is ``paged_split_plain``
    (the kernel's combine), bit for bit."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 8, generator=g)
    kp = torch.randn(8, 4, 2, 8, generator=g)
    vp = torch.randn(8, 4, 2, 8, generator=g)
    bt = torch.arange(8, dtype=torch.int32).view(2, 4)
    lens = torch.tensor([5, 16], dtype=torch.int32)
    parts = attention.paged_partials_plain(q, kp, vp, bt, lens, 1)
    assert torch.equal(attention.merge_partials(*parts),
                       attention.paged_split_plain(q, kp, vp, bt, lens, 1))


# ------------------------------------------------- ranks against the reference
NAMED = ("qwen3_4b", "gemma3_1b", "smollm_135m", "granite_moe_1b_a400m")


def grads_task(arch, mesh):
    return dict(name=f"grads {arch}", kind="grads", arch=arch, mesh=mesh,
                params=TM.reference_params(arch),
                batch=TM.train_batch(arch))


def serve_task(arch, mesh, steps=TM.DECODE_STEPS):
    tokens, extras, fed = TM.serve_inputs(arch)
    return dict(name=f"serve {arch}", kind="serve", arch=arch, mesh=mesh,
                params=TM.reference_params(arch), tokens=tokens,
                extras=extras, steps=fed[:steps], s_max=TM.S_MAX)


def check_grads(arch, got):
    params, batch = TM.reference_params(arch), TM.train_batch(arch)
    loss, metrics, grads = TM.reference_grads(arch, params, batch)
    for k, a, b in [("loss", got["loss"], loss)] + [
            (k, got["metrics"][k], metrics[k]) for k in metrics]:
        assert abs(a - b) <= F32_TOL * max(1.0, abs(b)), (arch, k, a, b)
    import jax
    want = jax.tree.flatten(grads)[0]
    have = [x for _, x in tree_leaves(got["grads"])]
    assert len(have) == len(want)
    for a, b in zip(have, want):
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=F32_TOL, atol=F32_TOL * scale,
                                   err_msg=arch)


def check_serve(arch, got, steps=TM.DECODE_STEPS):
    tokens, extras, fed = TM.serve_inputs(arch)
    want = TM.reference_serve(arch, TM.reference_params(arch), tokens,
                              extras, fed[:steps])
    pairs = [(got["prefill"], want["prefill"])] + list(
        zip(got["decode"], want["decode"]))
    assert len(pairs) == steps + 1
    vocab = TM.ref_config(arch).vocab
    for i, (a, b) in enumerate(pairs):
        np.testing.assert_allclose(a, b, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=f"{arch} step {i}")
        np.testing.assert_array_equal(a[:, :vocab].argmax(-1),
                                      np.asarray(b)[:, :vocab].argmax(-1))


@pytest.fixture(scope="module")
def mesh_1x4():
    """The four named configurations on four ranks as (1, 4): TP heads
    (qwen3_4b), kv_seq decode over a single KV head (gemma3_1b), the
    sequence-parallel fallback of 6 heads on 4 (smollm_135m), experts
    (granite_moe_1b_a400m)."""
    tasks = [t for a in NAMED for t in (grads_task(a, (1, 4)),
                                        serve_task(a, (1, 4)))]
    return TM.run_ranks(4, tasks, timeout=600)


@pytest.mark.parametrize("arch", NAMED)
def test_loss_and_grads_on_mesh_1x4_equal_the_reference(mesh_1x4, arch):
    check_grads(arch, mesh_1x4[f"grads {arch}"])


@pytest.mark.parametrize("arch", NAMED)
def test_prefill_and_decode_on_mesh_1x4_equal_the_reference(mesh_1x4, arch):
    check_serve(arch, mesh_1x4[f"serve {arch}"])


@pytest.fixture(scope="module")
def one_rank():
    tasks = []
    for a in ARCH_IDS:
        _, _, fed = TM.serve_inputs(a)
        tasks.append(dict(name=a, kind="one_rank", arch=a,
                          params=TM.reference_params(a),
                          batch=TM.train_batch(a), steps=fed[:2],
                          s_max=TM.S_MAX))
    return TM.run_ranks(1, tasks, timeout=600)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_mesh_of_one_rank_keeps_the_meshless_bits(one_rank, arch):
    """Mesh (1, 1) against no mesh: two train steps (loss, metrics,
    parameters and AdamW state) and the served logits, bit for bit."""
    assert one_rank[arch]["differ"] == []


def test_data_axes_and_abstract_params():
    from repro_torch.launch.mesh import dp_axes, dp_size
    from repro_torch.models.params import abstract_params
    assert dp_axes(MESHES["2x16x16"]) == ("pod", "data")
    assert dp_size(MESHES["2x16x16"]) == 32 and dp_size(MESHES["1x4"]) == 1
    import jax
    from repro.models.params import abstract_params as ref_abstract
    for arch in ARCH_IDS:
        got = [t for _, t in tree_leaves(abstract_params(get_config(arch)))]
        want = jax.tree.flatten(ref_abstract(ref_get_config(arch)))[0]
        assert [tuple(t.shape) for t in got] == [w.shape for w in want]
        assert all(t.device.type == "meta" and t.dtype == torch.float32
                   for t in got)


def test_production_mesh_shapes_allocate_nothing():
    """The production meshes' shapes read without a process group, and the
    meshes themselves built over a fake group in a child process (the
    dry-run's), holding no device tensor."""
    from repro_torch.launch.mesh import PRODUCTION_SHAPES
    assert PRODUCTION_SHAPES[False] == ((16, 16), ("data", "model"))
    shape, names = PRODUCTION_SHAPES[True]
    assert math.prod(shape) == 512 and names == ("pod", "data", "model")
    code = textwrap.dedent("""
        import json
        import torch.distributed as dist
        from repro_torch.launch.mesh import make_production_mesh
        out = []
        for multi in (False, True):
            m = make_production_mesh(multi_pod=multi)
            out.append([list(m.shape), list(m.mesh_dim_names),
                        m.device_type, dist.get_backend(),
                        dist.get_world_size()])
        print(json.dumps(out))
    """)
    got = subprocess.run([sys.executable, "-c", code], env=dict(
        os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=120)
    assert got.returncode == 0, got.stderr
    assert json.loads(got.stdout.strip().splitlines()[-1]) == [
        [[16, 16], ["data", "model"], "cpu", "fake", 256],
        [[2, 16, 16], ["pod", "data", "model"], "cpu", "fake", 512]]
