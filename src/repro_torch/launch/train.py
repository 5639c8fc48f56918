"""End-to-end training loop with Autumn-checkpoint fault tolerance.

A copy of ``repro.launch.train`` (the single-device path; a device mesh is
ROADMAP A16's and raises ``NotImplementedError``): a training loop with

  * periodic asynchronous checkpoints of the parameters and the optimizer
    state through the device store (``checkpoint.AsyncCheckpointer`` over
    ``CheckpointStore``: every flush builds a bloom filter, compactions
    merge, restores probe);
  * crash and restart: ``--inject-failure`` simulates a host dying, the
    volatile state is dropped, the store's WAL and manifest recover the
    last durable checkpoint, and the seekable data pipeline resumes at the
    exact step.

Resume is bit-exact: train(n) equals train(k) + crash + restore + the
rest.  On the card that needs deterministic kernels, so every step runs
under ``torch.use_deterministic_algorithms(True)``, and cuBLAS needs
``CUBLAS_WORKSPACE_CONFIG`` (``:4096:8``) set before the CUDA context
exists: :func:`main` sets it, and a :class:`Trainer` on the card refuses
to run without it.

Usage (on the card; ``--device cpu`` runs on the CPU):
  python -m repro_torch.launch.train --arch smollm_135m --smoke \\
      --steps 60 --checkpoint-every 20 --inject-failure 37
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Any, Dict, Optional

import torch

from ..checkpoint.store import AsyncCheckpointer, CheckpointStore
from ..configs import get_config, get_smoke
from ..core.engine import resolve_device
from ..data import DataConfig, SyntheticTokens, stub_frontend_inputs
from ..models.params import init_params
from ..train import OptConfig, init_opt_state, make_train_step

CUBLAS_WORKSPACE = ":4096:8"


@contextlib.contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True)`` inside the block, the
    previous setting after it (the flag is process-wide)."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)


class Trainer:
    def __init__(self, cfg, opt_cfg: OptConfig, data_cfg: DataConfig,
                 store: Optional[CheckpointStore] = None,
                 checkpoint_every: int = 0, mesh=None, device=None):
        if mesh is not None:
            raise NotImplementedError("training on a device mesh (ROADMAP "
                                      "A16) is not ported yet")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and os.environ.get(
                "CUBLAS_WORKSPACE_CONFIG") not in (":4096:8", ":16:8"):
            raise RuntimeError(
                "bit-exact training on the card needs deterministic cuBLAS: "
                f"set CUBLAS_WORKSPACE_CONFIG={CUBLAS_WORKSPACE} before the "
                "CUDA context is created")
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.data = SyntheticTokens(data_cfg)
        self.data_cfg = data_cfg
        self.store = store or CheckpointStore(device=self.device)
        self.ckpt = AsyncCheckpointer(self.store) if checkpoint_every \
            else None
        self.checkpoint_every = checkpoint_every
        self.step_fn = make_train_step(cfg, opt_cfg)
        self.params = None
        self.opt_state = None
        self.step = 0

    # ------------------------------------------------------------------ init
    def init(self, seed: int = 0, try_restore: bool = True) -> int:
        """Fresh parameters from ``seed`` (a ``torch.Generator`` on the
        device) and a zeroed optimizer state; then, with ``try_restore``,
        the store's latest checkpoint over them.  Returns the step."""
        restored_step = self.store.latest_step() if try_restore else None
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = init_params(self.cfg, gen, self.device)
        self.opt_state = init_opt_state(self.params)
        if restored_step is not None:
            restored = self.store.restore_tree(
                restored_step, {"params": self.params, "opt": self.opt_state})
            if restored is not None:
                self.params = restored["params"]
                self.opt_state = restored["opt"]
                self.step = restored_step
        return self.step

    # ------------------------------------------------------------------- run
    def batch_for(self, step: int) -> Dict[str, Any]:
        b = dict(self.data.get_batch(step))
        b.update(stub_frontend_inputs(self.cfg, self.data_cfg.host_batch,
                                      rng_seed=step))
        return {k: torch.from_numpy(v).to(self.device) for k, v in b.items()}

    def train_step(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One step on ``batch``, deterministic on the card."""
        guard = deterministic_algorithms() if self.device.type == "cuda" \
            else contextlib.nullcontext()
        with guard:
            self.params, self.opt_state, m = self.step_fn(
                self.params, self.opt_state, batch)
        return m

    def run(self, steps: int, inject_failure_at: Optional[int] = None,
            log_every: int = 10):
        """Train until ``steps``; returns [(step, loss)] at every
        ``log_every``-th step and the last.  A checkpoint is submitted
        every ``checkpoint_every`` steps and at the end."""
        metrics_hist = []
        t0 = time.time()
        while self.step < steps:
            if inject_failure_at is not None and \
                    self.step == inject_failure_at:
                raise SimulatedHostFailure(self.step)
            m = self.train_step(self.batch_for(self.step))
            self.step += 1
            if self.checkpoint_every and \
                    self.step % self.checkpoint_every == 0:
                self.ckpt.submit(self.step, {"params": self.params,
                                             "opt": self.opt_state})
            if self.step % log_every == 0 or self.step == steps:
                loss = float(m["loss"])
                metrics_hist.append((self.step, loss))
                print(f"step {self.step:5d} loss {loss:8.4f} "
                      f"lr {float(m['lr']):.2e} "
                      f"({(time.time()-t0)/max(self.step,1)*1e3:.0f} "
                      f"ms/step)", flush=True)
        if self.ckpt:
            self.ckpt.submit(self.step, {"params": self.params,
                                         "opt": self.opt_state})
            self.ckpt.close()
            self.ckpt = None
        return metrics_hist

    def simulate_crash(self):
        """Volatile state gone; durable LSM state survives."""
        if self.ckpt:
            self.ckpt.close()
            self.ckpt = None
        self.store.crash()
        self.params = self.opt_state = None
        self.step = 0


class SimulatedHostFailure(RuntimeError):
    def __init__(self, step: int):
        super().__init__(f"simulated host failure at step {step}")
        self.step = step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_135m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--inject-failure", type=int, default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--schedule", default="wsd")
    ap.add_argument("--device", default=None,
                    help="cuda:0 unless given (cpu runs on the CPU)")
    args = ap.parse_args(argv)
    # before the CUDA context exists: deterministic cuBLAS for the steps
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    opt_cfg = OptConfig(peak_lr=args.lr, warmup_steps=10,
                        total_steps=args.steps, schedule=args.schedule)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch)
    store = CheckpointStore(device=resolve_device(args.device))
    trainer = Trainer(cfg, opt_cfg, data_cfg, store,
                      checkpoint_every=args.checkpoint_every,
                      device=args.device)
    trainer.init()
    try:
        hist = trainer.run(args.steps, inject_failure_at=args.inject_failure)
    except SimulatedHostFailure as e:
        print(f"!! {e} -- recovering from the Autumn checkpoint store")
        trainer.simulate_crash()
        resumed = trainer.init(try_restore=True)
        print(f"   restored at step {resumed}; resuming")
        trainer.ckpt = AsyncCheckpointer(store) \
            if args.checkpoint_every else None
        hist = trainer.run(args.steps)
    first, last = hist[0][1], hist[-1][1]
    print(f"loss {first:.4f} -> {last:.4f}  "
          f"(delta-skipped chunks: {store.stats_deltas_skipped}, "
          f"written: {store.stats_chunks_written}, "
          f"L={store.db.num_levels_in_use}, "
          f"WA={store.db.stats.write_amplification():.2f})")
    if not last < first:
        raise SystemExit("training did not reduce the loss")


if __name__ == "__main__":
    main()
