"""The port's dry-run (``repro_torch.launch.{trace_cost,specs,dryrun}``):
the twins of ``tests/test_dryrun.py`` on their own bars, and the cost
model held against counts written out here.

Each case runs in a process of its own: a fake process group (one process
playing rank 0 of a mesh) must never leak into the rest of the test run.
"""
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def run_sub(code: str, *args: str) -> dict:
    """The last line of a child's output, as JSON."""
    out = subprocess.check_output(
        [sys.executable, "-c", textwrap.dedent(code), *args],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 CUDA_VISIBLE_DEVICES=""),
        stderr=subprocess.STDOUT, text=True, timeout=500)
    return json.loads(out.strip().splitlines()[-1])


def test_cost_model_counts_every_layer_of_a_sharded_loop():
    """The twin of ``test_hlo_cost_model_counts_scan_trips``: five layers
    of tanh(c @ w) on a fake (2, 4) mesh, w (5, 256, 256) split (None,
    data, model) and x (64, 256) split (data, None), through the Sharder:
    the per-device FLOPs within the reference's 2% of 5*2*64*256*256/8,
    and the collective bytes as counted below."""
    data = run_sub("""
        import json, torch
        torch.set_num_threads(1)
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor import DTensor
        from repro_torch.launch.mesh import fake_mesh
        from repro_torch.launch.sharding import Sharder, placements
        from repro_torch.launch.trace_cost import trace
        mesh = fake_mesh((2, 4), ("data", "model"))
        sh = Sharder(mesh, {"batch": ("data",), "embed": None,
                            "mlp": "model"})
        fm = FakeTensorMode()
        with fm:
            ws = DTensor.from_local(
                torch.empty(5, 128, 64), mesh,
                placements((None, "data", "model"), mesh), run_check=False)
            x = DTensor.from_local(
                torch.empty(32, 256), mesh, placements(("data", None), mesh),
                run_check=False)

        def f(ws, x):
            w = sh.param(ws, ("layers", "embed", "mlp"))
            c = x.to_local()
            for i in range(5):
                c = sh(torch.tanh(c @ w[i]), "batch", "embed",
                       src=("batch", "mlp"))
            return sh.token_sum(c.sum())

        cost = trace(f, (ws, x), fm)
        print(json.dumps(cost.as_dict()))
    """)
    assert data["flops"] == pytest.approx(5 * 2 * 64 * 256 * 256 / 8,
                                          rel=0.02)
    assert data["flops_by_dtype"] == {"float32": 5 * 2 * 32 * 256 * 64}
    # the weights gathered over 'data' (2 ranks) once, each layer's output
    # over 'model' (4), the loss summed over 'data'
    gather_w = 2 * 5 * 128 * 64 * 4 * (2 - 1) / 2
    gather_c = 5 * 4 * 32 * 64 * 4 * (4 - 1) / 4
    assert data["coll_by_kind"] == {"all-gather": gather_w + gather_c,
                                    "all-reduce": 2 * 4 * (2 - 1) / 2}
    assert data["coll_count"] == 7
    # ranks 0..7 sit on one host of eight: every group on NVLink
    assert data["coll_by_link"] == {"nvlink": data["coll_bytes"]}
    assert data["argument_bytes"] == (5 * 128 * 64 + 32 * 256) * 4
    assert data["peak_bytes"] >= data["argument_bytes"] + 5 * 256 * 64 * 4


def test_functional_collectives_are_refused():
    """A functional collective (the kind DTensor's redistributions issue)
    has no count in the cost model: it raises rather than passing
    uncounted."""
    data = run_sub("""
        import json, torch
        torch.set_num_threads(1)
        import torch.distributed._functional_collectives as funcol
        from torch._subclasses.fake_tensor import FakeTensorMode
        from repro_torch.launch.mesh import fake_mesh
        from repro_torch.launch.trace_cost import CostMode
        mesh = fake_mesh((2, 4), ("data", "model"))
        fm = FakeTensorMode()
        with fm:
            x = torch.empty(8, 4)
        try:
            with fm, CostMode((x,)):
                funcol.all_reduce(x, "sum", mesh.get_group("data"))
            print(json.dumps({"raised": None}))
        except ValueError as e:
            print(json.dumps({"raised": str(e)}))
    """)
    assert data["raised"] == ("a collective the cost model does not count: "
                              "_c10d_functional.all_reduce")


MINI_CELLS = """
    import json, sys, torch
    torch.set_num_threads(1)
    import repro_torch.configs as C
    from repro_torch.configs import ShapeSpec, get_smoke
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.launch.specs import build_cell
    C.SHAPES["mini_train"] = ShapeSpec("mini_train", 64, 8, "train")
    C.SHAPES["mini_decode"] = ShapeSpec("mini_decode", 64, 8, "decode")
    mesh = fake_mesh(tuple(json.loads(sys.argv[1])), ("data", "model"))
    report = {}
    for shape in ("mini_train", "mini_decode"):
        cell = build_cell("qwen3_4b", shape, mesh,
                          cfg_override=get_smoke("qwen3_4b"))
        cost, _ = trace_cell(cell)
        report[shape] = cost.as_dict()
    print(json.dumps(report))
"""


@pytest.mark.parametrize("mesh", [(2, 4), (1, 1)], ids=["2x4", "1x1"])
def test_mini_cell_is_traced_and_collectives_follow_the_mesh(mesh):
    """The twin of ``test_mini_dryrun_cell_compiles_and_is_sharded``: the
    smoke qwen3_4b cell traces with a positive peak; on a (2, 4) mesh its
    step issues collectives, on (1, 1) none."""
    data = run_sub(MINI_CELLS, json.dumps(mesh))
    for shape, r in data.items():
        assert r["peak_bytes"] > r["argument_bytes"] > 0, shape
        assert r["flops"] > 0 and r["hbm_bytes"] > 0, shape
        if mesh == (1, 1):
            assert r["coll_count"] == 0 and r["coll_bytes"] == 0, shape
        else:
            assert r["coll_count"] > 0 and r["coll_bytes"] > 0, shape
    assert data["mini_decode"]["launches"]["paged_attention"] == 3
    assert "flash_attention" not in data["mini_train"]["launches"]


def test_artifacts_of_a_sweep(tmp_path):
    """The twin of ``test_artifacts_when_present``: smollm_135m's four
    shapes on both production meshes: three cells traced and one skipped
    a mesh, every peak within one card's 80 GB, every FLOP count
    positive."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm_135m", "--out", str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=500)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().splitlines()[-1].startswith(
        "done: ok=6 skip=2 err=0")
    for mesh in ("pod16x16", "pod2x16x16"):
        arts = [json.loads(f.read_text())
                for f in sorted(tmp_path.glob(f"*__{mesh}.json"))]
        assert sorted(a["status"] for a in arts) == ["ok"] * 3 + ["skipped"]
        for a in arts:
            if a["status"] != "ok":
                assert a["shape"] == "long_500k"
                continue
            assert a["chips"] == (256 if mesh == "pod16x16" else 512)
            assert 0 < a["memory_analysis"]["peak_estimate_bytes"] < 80e9
            assert a["trace_cost"]["flops"] > 0
            assert a["roofline"]["dominant"] in ("compute", "memory",
                                                 "collective")


def test_prefill_cell_flops_and_roofline_by_hand(tmp_path):
    """smollm_135m's prefill_32k on 16 x 16: the traced FLOPs within 3% of
    the products counted here (the rank's 2 rows of 32,768 tokens; heads
    replicated, 9 being no multiple of 16; the MLP and the vocabulary
    split over 'model'; the logits of the last token; K4's work), and
    ``roofline_terms`` against a hand computation."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import flash_pairs
    from repro_torch.models import count_params
    a = run_sub("""
        import json, sys, torch
        torch.set_num_threads(1)
        from repro_torch.launch.dryrun import run_cell
        print(json.dumps(run_cell("smollm_135m", "prefill_32k", False,
                                  force=True, out_dir=sys.argv[1])))
    """, str(tmp_path))
    assert a["status"] == "ok", a.get("error")
    cfg = get_config("smollm_135m")
    D, H, KH, dh, F = cfg.d_model, cfg.n_q, cfg.n_kv, cfg.d_head, cfg.d_ff
    assert H % 16 and F % 16 == 0 and cfg.vocab_padded % 16 == 0
    B, S = 32 // 16, 32_768
    T = B * S
    per_layer = (2 * T * D * H * dh + 2 * 2 * T * D * KH * dh
                 + 2 * T * H * dh * D + 3 * 2 * T * D * F // 16
                 + 4 * dh * B * H * flash_pairs(S, S, True, 0))
    want = cfg.n_layers * per_layer + 2 * B * D * cfg.vocab_padded // 16
    cost = a["trace_cost"]
    assert cost["flops"] == pytest.approx(want, rel=0.03)
    assert cost["launches"]["flash_attention"] == cfg.n_layers
    # the roofline by hand, from the artifact's counts
    rf = a["roofline"]
    compute = sum(f / {"bfloat16": 989e12}.get(dt, 67e12)
                  for dt, f in cost["flops_by_dtype"].items())
    coll = cost["coll_by_link"].get("ib", 0) / 50e9 \
        + cost["coll_by_link"].get("nvlink", 0) / 450e9
    terms = {"compute": compute, "memory": cost["hbm_bytes"] / 3.35e12,
             "collective": coll}
    for k, v in terms.items():
        assert rf[f"{k}_s"] == pytest.approx(v, rel=1e-12)
    assert rf["dominant"] == max(terms, key=terms.get)
    mf = 2 * count_params(cfg, active_only=True) * 32 * S / 256
    assert rf["model_flops_per_chip"] == pytest.approx(mf, rel=1e-12)
    assert rf["useful_flop_ratio"] == pytest.approx(mf / cost["flops"])
    assert rf["roofline_fraction"] == pytest.approx(
        mf / 989e12 / max(terms.values()))
    assert math.isfinite(a["trace_s"]) and a["chips"] == 256
