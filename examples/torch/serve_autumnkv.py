"""End-to-end serving on the PyTorch + CUDA port, the twin of
examples/serve_autumnkv.py.

Serves a small qwen3-family model over the AutumnKV prefix cache: three
request waves with overlapping prompts show cache hits skipping prefill and
content-addressed pages deduplicating storage.

    PYTHONPATH=src python examples/torch/serve_autumnkv.py            # the card
    PYTHONPATH=src python examples/torch/serve_autumnkv.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.engine import resolve_device
from repro_torch.models import count_params, init_params
from repro_torch.serve import Request, ServeEngine


def main(device=None, params=None) -> dict:
    """Serves the reference example's three waves on ``device`` (the card
    unless ``"cpu"``) with ``params`` (drawn from seed 0 by default: the
    reference's draws come through ``models.convert``); prints and returns
    what it prints, and every decoded token."""
    dev = resolve_device(device)
    cfg = get_smoke("qwen3_4b")
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    print(f"model: {cfg.name} ({count_params(cfg)/1e6:.2f}M params)")
    engine = ServeEngine(cfg, params, batch=4, s_max=96, device=dev)
    rng = np.random.default_rng(7)
    system_prompt = rng.integers(0, cfg.vocab, 64, dtype=np.int32)  # shared
    other_prompt = rng.integers(0, cfg.vocab, 64, dtype=np.int32)
    waves = [
        ("cold wave (4 misses)", [Request(system_prompt, 8)] * 4),
        ("warm wave (4 hits) ", [Request(system_prompt, 8)] * 4),
        ("mixed wave         ", [Request(other_prompt, 8)] * 2 +
         [Request(system_prompt, 8)] * 2),
    ]
    records = []
    for name, reqs in waves:
        t0 = time.perf_counter()
        outs = engine.serve_batch(reqs)
        dt = time.perf_counter() - t0
        s = engine.kv.stats()
        records.append(dict(wave=name.strip(), ms=dt * 1e3, hits=s["hits"],
                            pages_written=s["pages_written"],
                            pages_deduped=s["pages_deduped"],
                            tokens=[[int(t) for t in o] for o in outs]))
        print(f"{name}: {dt*1e3:7.1f} ms | hits={s['hits']:2d} "
              f"pages_written={s['pages_written']} "
              f"deduped={s['pages_deduped']} "
              f"| first tokens: {[int(o[0]) for o in outs]}")
    s = engine.kv.stats()
    print(f"\nAutumnKV store: L={s['levels']} levels, "
          f"bloom probes={s['io']['bloom_probes']}, "
          f"blocks read={s['io']['blocks_read']}")
    print(f"engine metrics: {engine.metrics}")
    out = dict(waves=records, levels=s["levels"],
               bloom_probes=s["io"]["bloom_probes"],
               blocks_read=s["io"]["blocks_read"],
               metrics=dict(engine.metrics))
    engine.kv.close()
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda:0 by default; cpu to run on the CPU")
    main(ap.parse_args().device)
