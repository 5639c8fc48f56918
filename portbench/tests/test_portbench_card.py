"""The command on the card: one short run of each cell, untraced and
traced, each correct and with every metric the cell lists."""
import json
import subprocess
import sys

import pytest

from conftest import BENCH, CELLS, ROOT, SEED


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_command_on_the_card(cuda_card, cell, trace):
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["compared"]
    assert out["device"]["platform"] == "gpu"
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in BENCH[kind]
            if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == want
    if trace:
        assert out["device"]["busy_s"] > 0
        for name, m in out["metrics"].items():
            if name.split(".")[0].endswith("_roofline") or \
                    name.startswith("device_idle"):
                assert 0 < m["value"] <= 100, name
