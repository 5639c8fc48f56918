"""Each cell at a tiny size on the port's CPU store, judged against the
reference, and the shape of the line a run prints."""
import json

import pytest

from conftest import BENCH, CELLS, run_cell

TOP_KEYS = ("correct", "attempted", "failed", "metrics", "device")


def cell_metrics(cell, kind):
    return [m for m in BENCH[kind] if cell in m.get("workloads", [cell])]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_cpu_store(cell):
    out = run_cell(cell)
    assert out["correct"] is True, out["compared"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["checked_answers"] > 0


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line_shape(cell, trace):
    out = run_cell(cell, trace=bool(trace))
    line = json.loads(json.dumps(out))
    assert all(k in line for k in TOP_KEYS)
    assert list(line)[-1] == "compared"
    for name, c in line["compared"].items():
        assert set(c) == {"value", "limit"}, name
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"]: m["unit"] for m in cell_metrics(cell, kind)}
    got = line["metrics"]
    if trace:
        # device readings come from a card only; the counters and the
        # program's spans read on the CPU store too
        assert {"busy_s", "window_s"} <= set(dev)
        device_only = {m["name"] for m in cell_metrics(cell, kind)
                       if m["source"] == "device_trace"}
        assert set(got) == set(want) - device_only
    else:
        assert set(got) == set(want)
    for name, m in got.items():
        assert m["unit"] == want[name] and isinstance(m["value"], float)
    every = cell_metrics(cell, "end_to_end") if not trace else []
    assert all(m["name"] in got for m in every)


def test_every_cell_reports_setup_an_end_to_end_metric_and_a_layer():
    for cell in CELLS:
        e2e = {m["name"] for m in cell_metrics(cell, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell_metrics(cell, "per_layer")
