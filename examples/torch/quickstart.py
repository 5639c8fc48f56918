"""Quickstart on the PyTorch + CUDA port: the Autumn LSM engine and the
Garnering policy, the twin of examples/quickstart.py.

    PYTHONPATH=src python examples/torch/quickstart.py            # the card
    PYTHONPATH=src python examples/torch/quickstart.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core import LSMConfig, LSMStore


def main(device=None, n_keys: int = 100_000, seed: int = 0) -> dict:
    """Loads ``n_keys`` keys into an Autumn store and a Leveling store on
    ``device`` (the card unless ``"cpu"``); prints and returns what the
    reference prints."""
    # --- 1. a read-optimized store (the paper's Autumn: Garnering c=0.8)
    db = LSMStore(LSMConfig(policy="garnering", T=2.0, c=0.8,
                            memtable_bytes=32 << 10,
                            base_level_bytes=128 << 10, bits_per_key=10,
                            bloom_allocation="monkey"), device=device)
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 40, n_keys, dtype=np.uint64)
    for k in keys:
        db.put(int(k), b"value-" + int(k).to_bytes(8, "little"))
    db.flush()
    out = {"point_read": db.get(int(keys[123]))[:6],
           "range_read": [k for k, _ in db.scan(int(keys[0]), 5)]}
    print("point read :", out["point_read"])
    print("range read :", out["range_read"])
    db.delete(int(keys[123]))
    assert db.get(int(keys[123])) is None

    # --- 2. what Garnering buys you (paper Table 2 / Eq. 6)
    out.update(levels=db.num_levels_in_use,
               predicted_levels=db.policy.predicted_levels(
                   n_keys * 70, 128 << 10),
               write_amplification=db.stats.write_amplification(),
               delayed_last_level_compactions=(
                   db.stats.delayed_last_level_compactions))
    print(f"\nlevels in use            : {out['levels']} "
          f"(Eq. 6 predicts ~{out['predicted_levels']:.1f})")
    print(f"write amplification      : {out['write_amplification']:.2f}")
    print(f"delayed last-level compactions: "
          f"{out['delayed_last_level_compactions']}")
    s0 = db.stats.snapshot()
    for k in rng.integers(1 << 62, 1 << 63, 1000):
        db.get(int(k))                      # zero-result lookups
    d = db.stats.delta(s0)
    out.update(zero_result_blocks_per_op=d.blocks_read / 1000,
               bloom_negatives=d.bloom_negatives, bloom_probes=d.bloom_probes)
    print(f"zero-result point read   : {d.blocks_read / 1000:.3f} blocks/op "
          f"(Monkey bloom: {d.bloom_negatives}/{d.bloom_probes} probes "
          f"negative)")

    # --- 3. versus Leveling (RocksDB default)
    lv = LSMStore(LSMConfig(policy="leveling", memtable_bytes=32 << 10,
                            base_level_bytes=128 << 10), device=device)
    for k in keys:
        lv.put(int(k), b"x" * 14)
    lv.flush()
    out.update(leveling_levels=lv.num_levels_in_use,
               leveling_write_amplification=lv.stats.write_amplification())
    print(f"\nLeveling levels          : {out['leveling_levels']}  "
          f"(Autumn: {out['levels']})")
    print(f"Leveling write amp       : "
          f"{out['leveling_write_amplification']:.2f}  "
          f"(Autumn: {out['write_amplification']:.2f})")
    db.close()
    lv.close()
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda:0 by default; cpu to run on the CPU")
    main(ap.parse_args().device)
