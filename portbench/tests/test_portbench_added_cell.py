"""A cell on a new configuration under a new mix, with a new share,
added to a copy of the benchmark as files and entries only, passes the
suite's own checks through the helpers that find every table by name: a
YCSB-C-shaped cell of zipfian point reads through an LRU block cache and a
pinned L0, at a tiny size at which the cache evicts."""
import json
import shutil

import pytest

from conftest import (PB, ROOT, check_phase_shares, check_share_entry,
                      configuration, mix_of, run_cell, tiny, workload)
from faults import faults_of

CELL, CONFIG, MIX = "cached.reads", "zipf_cached", "zipf_reads"
# a batch goes to multi_get, whose memtable probe an existing reader reads;
# a single key to get, whose phases a reader added as a file reads
SHARES = {64: "memtable_probe_pct.cached", 1: "get_probe_pct.cached"}
GET_READER = """from portbench.phase_share import share

PHASES = ("get.memtable_probe", "get.upload", "get.run_probe", "get.assemble")


def read(run):
    return share(run, "read", "get", PHASES)
"""


def add_cached_cell(root, batch):
    """Add the cell, its configuration, tiny size, mix and share to the
    copy of the benchmark at ``root``."""
    pb = root / "portbench"
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = configuration("ycsb_zipf")
    cfg["name"] = CONFIG
    # LevelDB's default 8 MiB LRU block cache; L0 pinned at its trigger of
    # four 4 MiB write buffers
    cfg["store"].update(cache_bytes=8 << 20, cache_policy="lru",
                        pin_l0_bytes=16 << 20)
    (pb / "configs" / f"{CONFIG}.json").write_text(json.dumps(cfg))
    small = tiny("ycsb_zipf")
    # four 4 KiB blocks of cache, L0 pinned at four tiny memtables
    small["store"] = {**small["store"], "cache_bytes": 16 << 10,
                      "pin_l0_bytes": 4 * small["store"]["memtable_bytes"]}
    (pb / "tests" / "tiny" / f"{CONFIG}.json").write_text(json.dumps(small))
    (pb / "traffic" / f"{MIX}.json").write_text(json.dumps(
        {"warmup_ops": 3,
         "ops": [{"kind": "read", "share": 1.0, "batch": batch,
                  "keys": [{"from": "loaded", "share": 1.0,
                            "distribution": "zipfian", "theta": 0.99}]}]}))
    bench["configs"].append({"name": CONFIG, "source": "test",
                             "file": f"portbench/configs/{CONFIG}.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": CONFIG,
                               "traffic": MIX, "chips": 1, "why": "test"})
    if batch == 1:
        (pb / "metrics" / "get_probe_pct.py").write_text(GET_READER)
    bench["per_layer"].append({"name": SHARES[batch], "unit": "%",
                               "better": "lower", "source": "program_span",
                               "layer": "point read",
                               "moves": "get_keys_per_s",
                               "workloads": [CELL]})
    for m in bench["end_to_end"]:
        if m["name"] in ("get_keys_per_s", "get_batch_p95_ms"):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.mark.parametrize("batch", [64, 1])
def test_cached_cell_added_as_files_is_checked(tmp_path, monkeypatch, batch):
    from repro_torch.core import LSMStore
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    add_cached_cell(tmp_path, batch)
    assert workload(CELL, json.loads((tmp_path / "BENCHMARK.json")
                                     .read_text()))["config"] == CONFIG
    caches = []
    attach = LSMStore.attach_cache

    def keep_cache(self, cache, pin_l0_bytes=0):
        caches.append(cache)
        return attach(self, cache, pin_l0_bytes)

    with monkeypatch.context() as mp:
        mp.setattr(LSMStore, "attach_cache", keep_cache)
        check_share_entry(SHARES[batch], tmp_path)
        _, run = check_phase_shares(CELL, mp, tmp_path)
    assert run.stats["cache_hit_blocks"] > 0
    assert run.stats["cache_miss_blocks"] > 0
    (cache,) = caches
    assert cache.policy == "lru" and cache.evictions > 0
    out = run_cell(CELL, root=tmp_path)
    assert out["correct"] is True, out["compared"]
    assert set(out["metrics"]) == {"get_keys_per_s", "get_batch_p95_ms",
                                   "setup_s"}
    out = run_cell(CELL, root=tmp_path, control=True)
    assert out["correct"] is False and out["failed"] > 0
    faults = faults_of(mix_of(CELL, tmp_path))
    assert [f.__name__ for f in faults] == (
        ["half_read_batch", "altered_read"] if batch > 1
        else ["altered_get"])
    for fault in faults:
        with monkeypatch.context() as mp:
            out = run_cell(CELL, root=tmp_path,
                           on_window=lambda: fault(LSMStore, mp))
        assert out["correct"] is False, fault.__name__
        assert out["failed"] > 0
    assert all(p.read_bytes() == b for p, b in before.items())
