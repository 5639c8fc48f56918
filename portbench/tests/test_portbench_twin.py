"""``twin.py`` on the CPU store at each cached configuration's tiny size:
the cached store answers as its uncached twin, its hits and misses are
the twin's block reads, its block reads its misses, and the cache evicts
inside the waves; a cell with no cache is refused."""
import pytest

from conftest import CELLS, SEED, configuration, tiny, workload
from portbench import twin


def store_of(cell) -> dict:
    config = workload(cell)["config"]
    return {**configuration(config)["store"], **tiny(config)["store"]}


CACHED = [c for c in CELLS if store_of(c).get("cache_bytes")]


@pytest.mark.parametrize("cell", CACHED)
def test_cached_store_reads_as_its_uncached_twin(cell):
    out = twin.twin(cell, SEED, 6, device="cpu",
                    config_override=tiny(workload(cell)["config"]))
    assert out["ok"] is True, out
    assert out["broken_waves"] == [] and out["verdict"]["checked_answers"] > 0
    c = out["counts"]
    assert min(c["hits"]) > 0 and sum(c["evictions"]) > 0
    assert [h + m for h, m in zip(c["hits"], c["misses"])] == \
        c["twin_blocks_read"]
    assert c["blocks_read"] == c["misses"]
    start = out["cache_summary"]["window_start"]
    assert start["enabled"]
    assert start["pinned_bytes"] <= store_of(cell).get("pin_l0_bytes", 0)


def test_a_cell_without_a_cache_is_refused():
    plain = next(c for c in CELLS if c not in CACHED)
    with pytest.raises(ValueError, match="no cache"):
        twin.twin(plain, SEED, 1, device="cpu",
                  config_override=tiny(workload(plain)["config"]))
