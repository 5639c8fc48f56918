"""A cell, a configuration, a traffic mix and a per-layer metric added as
files and entries only, and found by name; each configuration's tiny size
for the CPU tests; the benchmark's imports; the command without a card or
without the program."""
import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, PB, ROOT, SEED, configuration, tiny, tiny_path
from portbench import cell


def test_added_files_are_found_by_name(tmp_path):
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((PB / "configs/leveldb_dbbench.json").read_text())
    cfg["records"]["value_bytes"] = 50
    (tmp_path / "portbench/configs/small_values.json").write_text(
        json.dumps(cfg))
    (tmp_path / "portbench/traffic/scan_heavy.json").write_text(json.dumps(
        {"warmup_ops": 4,
         "ops": [{"kind": "scan", "share": 0.5,
                  "start": {"from": "loaded", "distribution": "uniform"},
                  "length": [1, 20]},
                 {"kind": "read", "share": 0.5, "batch": 64,
                  "keys": [{"from": "loaded", "share": 0.5},
                           {"from": "space", "share": 0.5}]}]}))
    (tmp_path / "portbench/metrics/scans_per_read.py").write_text(
        "def read(run):\n"
        "    return run.requests.get('scan', 0) / run.requests['read']\n")
    bench["configs"].append({"name": "small_values", "source": "test",
                             "file": "portbench/configs/small_values.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "small.scan_heavy",
                               "config": "small_values",
                               "traffic": "scan_heavy", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "scans_per_read.mix", "unit": "x",
                               "better": "lower", "source": "host_clock",
                               "layer": "range read",
                               "moves": "ycsb_ops_per_s",
                               "workloads": ["small.scan_heavy"]})
    for m in bench["end_to_end"]:
        if m["name"] == "ycsb_ops_per_s":
            m["workloads"].append("small.scan_heavy")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for trace in (False, True):
        out = cell.run("small.scan_heavy", SEED, 0.3, trace, device="cpu",
                       root=tmp_path, bench_dir=tmp_path / "portbench",
                       config_override=tiny("leveldb_dbbench"))
        assert out["correct"] is True
        want = ({"scans_per_read.mix"} if trace
                else {"ycsb_ops_per_s", "setup_s"})
        assert set(out["metrics"]) == want
    assert all(p.read_bytes() == b for p, b in before.items())


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_configuration_has_a_tiny_size(config):
    """Each configuration's size for the CPU tests is a file of its own,
    ``tests/tiny/<config>.json``, whose fields the configuration has."""
    assert tiny_path(config).exists(), (
        f"configuration {config!r} has no tiny size for the CPU tests: "
        f"add {tiny_path(config)}")
    cfg = configuration(config)
    for key, val in tiny(config).items():
        assert key in cfg, key
        if isinstance(val, dict):
            assert set(val) <= set(cfg[key]), (key, set(val) - set(cfg[key]))


def imports_of(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_and_a_reference_apart_from_the_program():
    files = sorted(PB.rglob("*.py"))
    assert files
    for f in files:
        tops = set(imports_of(f))
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, f
        if "reference" in f.relative_to(PB).parts:
            assert "repro_torch" not in tops, f
            assert tops <= {"__future__", "bisect", "typing", "numpy"}, f


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert cell.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert cell.forbidden_modules() == ["repro.core"]


def run_command(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "portbench/run.py", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120)


ARGS = ("--workload", "dbbench.readrandom", "--seed", str(SEED),
        "--seconds", "1", "--trace", "0")


def test_command_without_a_card_prints_no_result():
    p = run_command(ROOT, *ARGS)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_command_alone_prints_no_result(tmp_path):
    shutil.copytree(PB, tmp_path / "portbench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = run_command(tmp_path, *ARGS)
    assert p.returncode != 0 and p.stdout.strip() == ""
