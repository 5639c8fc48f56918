"""Shared pieces of the benchmark's CPU tests: the cells of
``BENCHMARK.json``, each configuration's tiny size, a run of a cell on the
CPU store, and the checks of a cell's phase shares.  Every table here is
found by name from the files, so that a cell, a configuration, a mix or a
metric added as files and entries needs no edit to a test."""
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
torch.set_num_threads(1)

PB = ROOT / "portbench"
SEED = 2**31 + 4097          # larger than 32 signed bits, as a check's are


def read_bench(root=ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


BENCH = read_bench()
CELLS = [w["name"] for w in BENCH["workloads"]]


def workload(name, bench=BENCH) -> dict:
    return next(w for w in bench["workloads"] if w["name"] == name)


def configuration(config, root=ROOT) -> dict:
    """The file of configuration ``config``, as its entry names it."""
    entry = next(c for c in read_bench(root)["configs"] if c["name"] == config)
    return json.loads((root / entry["file"]).read_text())


def tiny_path(config, bench_dir=PB) -> Path:
    return bench_dir / "tests" / "tiny" / f"{config}.json"


def tiny(config, bench_dir=PB) -> dict:
    """The configuration's size for a test run, ``tests/tiny/<config>.json``:
    a few thousand records and a store small enough to flush and compact
    many times in a short window; the fields it names replace the
    configuration's."""
    path = tiny_path(config, bench_dir)
    if not path.exists():
        raise FileNotFoundError(f"configuration {config!r} has no tiny size "
                                f"for the CPU tests: add {path}")
    return json.loads(path.read_text())


def mix_of(name, root=ROOT) -> dict:
    """The traffic mix of cell ``name``."""
    traffic = workload(name, read_bench(root))["traffic"]
    return json.loads((root / "portbench" / "traffic" / f"{traffic}.json")
                      .read_text())


def run_cell(name, seed=SEED, seconds=0.4, trace=False, root=ROOT, **kw):
    """One run of cell ``name`` of ``root/BENCHMARK.json`` on the CPU store
    at its configuration's tiny size."""
    from portbench import cell
    bench_dir = root / "portbench"
    config = workload(name, read_bench(root))["config"]
    kw.setdefault("config_override", tiny(config, bench_dir))
    return cell.run(name, seed, seconds, trace, device="cpu", root=root,
                    bench_dir=bench_dir, **kw)


def phase_shares(bench=BENCH) -> dict:
    """The per-layer shares of the program's phases, by name: every
    ``program_span`` metric but ``flush_compaction_pct``, which reads the
    flush and compaction spans whole."""
    return {m["name"]: m for m in bench["per_layer"]
            if m["source"] == "program_span"
            and m["name"].split(".")[0] != "flush_compaction_pct"}


def reader_phases(name, bench_dir=PB) -> tuple:
    """The phases the reader of metric ``name`` names (its ``PHASES``)."""
    from portbench import cell
    return tuple(cell.metric_reader(name, bench_dir).__globals__
                 .get("PHASES", ()))


def check_share_entry(name, root=ROOT):
    """Phase share ``name`` of ``root/BENCHMARK.json`` is a percentage read
    for the cells it lists, by a reader whose ``PHASES`` are phases the
    program cuts."""
    from repro_torch.core import telemetry
    bench = read_bench(root)
    m = phase_shares(bench)[name]
    assert m["unit"] == "%"
    assert isinstance(m.get("workloads"), list) and m["workloads"]
    assert set(m["workloads"]) <= {w["name"] for w in bench["workloads"]}
    phases = reader_phases(name, root / "portbench")
    assert phases and set(phases) <= set(telemetry.PHASES), phases


def check_phase_shares(name, monkeypatch, root=ROOT):
    """A traced run of cell ``name``: it is correct; each of its phase
    shares reads a value in [0, 100]; the distinct phases its shares' readers
    name, each counted once, take at most the whole window, since phases
    tile a call; and every phase interval of the window reaches the trace
    reduction's program spans.  Returns the result line and the run's
    :class:`~portbench.cell.RunRecord`."""
    from portbench import cell, trace
    from repro_torch.core import telemetry
    bench_dir = root / "portbench"
    mine = [n for n, m in phase_shares(read_bench(root)).items()
            if name in m["workloads"]]
    assert mine, f"{name} lists no phase share"
    named = {p: None for n in mine for p in reader_phases(n, bench_dir)}
    windows, handed, records = [], [], []
    delta, read_profile = telemetry.Telemetry.delta, trace.read_profile
    find_reader = cell.metric_reader

    def keep_window(self, prev):
        win = delta(self, prev)
        windows.append(win)
        return win

    def keep_spans(events, host_start_ns, spans):
        handed.append(list(spans))
        return read_profile(events, host_start_ns, spans)

    def keep_record(metric, where=cell.HERE):
        read = find_reader(metric, where)

        def reading(run):
            records.append(run)
            return read(run)
        return reading

    monkeypatch.setattr(telemetry.Telemetry, "delta", keep_window)
    monkeypatch.setattr(trace, "read_profile", keep_spans)
    monkeypatch.setattr(cell, "metric_reader", keep_record)
    out = run_cell(name, trace=True, root=root)
    assert out["correct"] is True
    for n in mine:
        assert 0.0 <= out["metrics"][n]["value"] <= 100.0, n
    run = records[0]
    assert all(r is run for r in records)
    tiled = 100.0 * sum(run.span_s.get(p, 0.0) for p in named) / run.window_s
    assert tiled <= 100.0, (name, tiled)
    (win,), (spans,) = windows, handed
    phases = [(e.kind[:-4], *e.interval()) for e in win.events
              if e.kind[:-4] in telemetry.PHASES]
    assert phases and set(phases) <= set(spans)
    return out, run


@pytest.fixture
def cuda_card():
    """cuda:0 where a card and nvcc exist; the test skips elsewhere."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch import _build
    try:
        _build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda:0")
