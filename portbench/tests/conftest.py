"""Shared pieces of the benchmark's CPU tests: the cells of
``BENCHMARK.json``, tiny stores for each configuration, and a run of a
cell on the CPU store."""
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
torch.set_num_threads(1)

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 4097          # larger than 32 signed bits, as a check's are
# each configuration at a size a test run holds: a few thousand records and
# a store small enough to flush and compact many times in a short window
TINY = {"leveldb_dbbench": {"records": {"count": 6000},
                            "store": {"memtable_bytes": 32 << 10,
                                      "base_level_bytes": 128 << 10}},
        "ycsb_zipf": {"records": {"count": 1200},
                      "store": {"memtable_bytes": 32 << 10,
                                "base_level_bytes": 128 << 10}}}
CONFIG_OF = {w["name"]: w["config"] for w in BENCH["workloads"]}


def run_cell(name, seed=SEED, seconds=0.4, trace=False, **kw):
    from portbench import cell
    kw.setdefault("config_override", TINY[CONFIG_OF[name]])
    return cell.run(name, seed, seconds, trace, device="cpu", **kw)


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
