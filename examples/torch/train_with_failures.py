"""Fault-tolerant training on the PyTorch + CUDA port, the twin of
examples/train_with_failures.py: train a smolLM-family model with async
Autumn checkpoints, kill the "host" mid-run, recover, and finish.

    PYTHONPATH=src python examples/torch/train_with_failures.py     # the card
    PYTHONPATH=src python examples/torch/train_with_failures.py --device cpu
"""
import argparse
import os

# bit-exact training on the card needs deterministic cuBLAS, set before
# the CUDA context exists
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

from repro_torch.checkpoint import AsyncCheckpointer, CheckpointStore  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.launch.train import SimulatedHostFailure, Trainer  # noqa: E402
from repro_torch.train import OptConfig  # noqa: E402


def main(device=None, steps: int = 60, fail_at: int = 40) -> dict:
    """Trains ``steps`` steps on ``device`` (the card unless ``"cpu"``),
    crashing at ``fail_at`` and resuming from the checkpoint store; prints
    and returns what the reference prints, and the losses."""
    cfg = get_smoke("smollm_135m")
    store = CheckpointStore(device=device)
    trainer = Trainer(
        cfg,
        OptConfig(peak_lr=1e-3, warmup_steps=5, total_steps=steps,
                  schedule="wsd"),
        DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8),
        store, checkpoint_every=15, device=device)
    trainer.init(try_restore=False)
    out = {"resumed": None, "losses": []}
    try:
        out["losses"] += trainer.run(steps, inject_failure_at=fail_at)
    except SimulatedHostFailure as e:
        print(f"!! {e}")
        trainer.simulate_crash()
        out["resumed"] = trainer.init(try_restore=True)
        print(f"   restored from Autumn store at step {out['resumed']} "
              f"(L={store.db.num_levels_in_use}, "
              f"delta-skipped={store.stats_deltas_skipped} chunks)")
        trainer.ckpt = AsyncCheckpointer(store)
        out["losses"] += trainer.run(steps)
    out.update(step=trainer.step, chunks_written=store.stats_chunks_written,
               deltas_skipped=store.stats_deltas_skipped,
               write_amplification=store.db.stats.write_amplification(),
               levels=store.db.num_levels_in_use)
    print(f"\ncheckpoint store: {out['chunks_written']} chunks written, "
          f"{out['deltas_skipped']} delta-skipped, "
          f"WA={out['write_amplification']:.2f}, L={out['levels']}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda:0 by default; cpu to run on the CPU")
    main(ap.parse_args().device)
