"""A cell's block cache held to an uncached twin, wave by wave.  The cell's
configuration is built twice from one seed, once as it is and once with
no cache and no pinned L0; each store is loaded as ``cell.py`` loads it;
both answer the same first waves of the cell's stream.  For every wave:
the answers are identical, the twin's ``blocks_read`` equals the cached
store's ``cache_hit_blocks + cache_miss_blocks``, and the cached store's
``blocks_read`` equals its ``cache_miss_blocks``.  The cached store's
answers are then judged against the reference as a run's are.  The
benchmark's own runs never run it.

    python3 portbench/twin.py --workload <name> --seed <n> --waves 100

prints one JSON line: ``ok``, the waves that broke a rule, each wave's
counts, the cached store's ``cache_summary()`` after the load, after the
mix's warm-up (where a run's window starts) and at the end, and the
reference's verdict.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def twin(workload: str, seed: int, waves: int, device: str = "cuda:0",
         config_override: dict = None, root: Path = ROOT,
         bench_dir: Path = HERE) -> dict:
    """The check above over the first ``waves`` ops of ``workload``'s
    stream; the line ``main`` prints.  ``config_override`` as in
    ``cell.run`` (tests run tiny stores)."""
    import torch
    from portbench import cell
    from portbench import generator as gen
    from repro_torch.core import LSMConfig, LSMStore
    dev = torch.device(device)
    found = cell.find_cell(workload, root, bench_dir)
    cfg = json.loads(json.dumps(found.config))
    for key, val in (config_override or {}).items():
        if isinstance(val, dict):
            cfg[key].update(val)
        else:
            cfg[key] = val
    records = gen.load_records(seed, cfg["records"])
    uncached = {"cache_bytes": 0, "pin_l0_bytes": 0}
    stores = []
    t = time.perf_counter()
    for extra in ({}, uncached):
        store = LSMStore(LSMConfig(**{**cfg["store"], **extra}), device=dev)
        for i in range(0, records.writes.size, cell.LOAD_BATCH):
            k = records.writes[i:i + cell.LOAD_BATCH]
            store.put_batch(k, gen.as_values(gen.value_rows(k, 0, records)))
        stores.append(store)
    cell._sync(torch, dev)
    load_s = time.perf_counter() - t
    cached, plain = stores
    if cached.block_cache is None:
        raise ValueError(f"{workload}'s configuration attaches no cache")
    summaries = {"loaded": cached.cache_summary()}
    warmup = int(found.mix.get("warmup_ops", 0))
    stream = gen.OpStream(seed, found.mix, records)
    log, broken = [], []
    counts = {k: [] for k in ("hits", "misses", "blocks_read",
                              "twin_blocks_read", "evictions")}
    for w in range(waves):
        if w == warmup:
            summaries["window_start"] = cached.cache_summary()
        op = next(stream)
        if op.kind != "read":
            raise ValueError(f"the twin compares point reads, not {op.kind}")
        s_c, s_p = cached.stats.snapshot(), plain.stats.snapshot()
        evicted = cached.block_cache.evictions
        got = cached.multi_get(op.keys)
        want = plain.multi_get(op.keys)
        d_c, d_p = cached.stats.delta(s_c), plain.stats.delta(s_p)
        log.append((op, got))
        row = (d_c.cache_hit_blocks, d_c.cache_miss_blocks, d_c.blocks_read,
               d_p.blocks_read, cached.block_cache.evictions - evicted)
        for k, v in zip(counts, row):
            counts[k].append(int(v))
        hits, misses, blocks, twin_blocks, _ = row
        if (got != want or hits + misses != twin_blocks
                or blocks != misses):
            broken.append(w)
    summaries["end"] = cached.cache_summary()
    del stores, cached, plain
    t = time.perf_counter()
    verdict = cell.judge(log, records, range(len(log)))
    return {"workload": workload, "seed": seed, "waves": waves,
            "ok": not broken and verdict["wrong_answers"] == 0
            and verdict["missing_answers"] == 0,
            "broken_waves": broken, "verdict": verdict,
            "cache_summary": summaries, "counts": counts,
            "load_s": load_s, "check_s": time.perf_counter() - t}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--waves", type=int, default=100)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("twin: no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    out = twin(args.workload, args.seed, args.waves)
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
