"""End-to-end training loop with Autumn-checkpoint fault tolerance.

A copy of ``repro.launch.train``: a training loop, on one device or on a
device mesh, with

  * periodic asynchronous checkpoints of the parameters and the optimizer
    state through the device store (``checkpoint.AsyncCheckpointer`` over
    ``CheckpointStore``: every flush builds a bloom filter, compactions
    merge, restores probe);
  * crash and restart: ``--inject-failure`` simulates a host dying, the
    volatile state is dropped, the store's WAL and manifest recover the
    last durable checkpoint, and the seekable data pipeline resumes at the
    exact step.

On a mesh (``Trainer(mesh=...)``: a ``DeviceMesh`` or a ``(data, model)``
shape over the process group's ranks; ``--mesh DATAxMODEL`` under
``torchrun``-style environment variables, or one rank) the step runs under
the train rules' ``Sharder``: parameters and AdamW's moments are
``DTensor`` leaves placed by the parameter rules (FSDP over ``data``, TP over
``model``), each rank reads its rows of the global batch from the
seekable pipeline, and gradients are summed over the axes that split the
tokens (as GSPMD sums them for the reference).  Checkpoints hold the full
tensors, gathered on every rank and written by rank 0 alone; a restore
reads them on rank 0, broadcasts them, and places every leaf by the rules
of the restoring mesh, which may differ from the writer's.

Resume is bit-exact: train(n) equals train(k) + crash + restore + the
rest.  On the card that needs deterministic kernels, so every step runs
under ``torch.use_deterministic_algorithms(True)``, and cuBLAS needs
``CUBLAS_WORKSPACE_CONFIG`` (``:4096:8``) set before the CUDA context
exists: :func:`main` sets it, and a :class:`Trainer` on the card refuses
to run without it.

Usage (on the card; ``--device cpu`` runs on the CPU):
  python -m repro_torch.launch.train --arch smollm_135m --smoke \\
      --steps 60 --checkpoint-every 20 --inject-failure 37
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --smoke \\
      --mesh 2x2 --device cpu          # four gloo ranks on the CPU
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from ..checkpoint.store import AsyncCheckpointer, CheckpointStore
from ..configs import get_config, get_smoke
from ..core.engine import resolve_device
from ..data import DataConfig, SyntheticTokens, stub_frontend_inputs
from ..models.layers import identity_shard
from ..models.params import init_params, logical_specs, tree_leaves
from ..train import OptConfig, init_opt_state, make_train_step
from .mesh import make_mesh
from .sharding import Sharder, full_tree, make_rules, place_tree

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
        self.device = resolve_device(device)
        if self.device.type == "cuda" and os.environ.get(
                "CUBLAS_WORKSPACE_CONFIG") not in (":4096:8", ":16:8"):
            raise RuntimeError(
                "bit-exact training on the card needs deterministic cuBLAS: "
                f"set CUBLAS_WORKSPACE_CONFIG={CUBLAS_WORKSPACE} before the "
                "CUDA context is created")
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.data_cfg = data_cfg
        self.rows = (0, data_cfg.host_batch)
        self.sharder = identity_shard
        self.rank0 = True
        if mesh is not None:
            if not hasattr(mesh, "mesh_dim_names"):
                mesh = make_mesh(tuple(mesh), self.device)
            self.param_rules, act_rules = make_rules(
                cfg, mesh, "train", data_cfg.global_batch, data_cfg.seq_len)
            self.sharder = Sharder(mesh, act_rules)
            self.rows = self.sharder.span("batch", data_cfg.global_batch)
            n = self.rows[1] - self.rows[0]
            data_cfg = dataclasses.replace(
                data_cfg, num_hosts=data_cfg.global_batch // n,
                host_id=self.rows[0] // n)
            self.rank0 = dist.get_rank() == 0
        self.mesh = mesh
        self.data = SyntheticTokens(data_cfg)
        # rank 0 writes and reads the checkpoints
        self.store = (store or CheckpointStore(device=self.device)) \
            if self.rank0 else None
        self.ckpt = AsyncCheckpointer(self.store) \
            if checkpoint_every and self.rank0 else None
        self.checkpoint_every = checkpoint_every
        self.step_fn = make_train_step(cfg, opt_cfg, shard=self.sharder)
        self.params = None
        self.opt_state = None
        self.step = 0

    # ------------------------------------------------------------------ init
    def init(self, seed: int = 0, try_restore: bool = True) -> int:
        """Fresh parameters from ``seed`` (a ``torch.Generator`` on the
        device) and a zeroed optimizer state; then, with ``try_restore``,
        the store's latest checkpoint over them, as rank 0 reads it.  A
        checkpoint that cannot be read leaves the fresh state, as the
        reference does.  Returns the step.  On a mesh every rank draws the
        same parameters, takes rank 0's restore, and keeps its shards."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        state = {"params": init_params(self.cfg, gen, self.device)}
        state["opt"] = init_opt_state(state["params"])
        step = self.store.latest_step() if self.rank0 and try_restore \
            else None
        restored = self.store.restore_tree(step, state) \
            if step is not None else None
        # every rank learns from rank 0 whether it restored, then the state
        step = int(self._from_rank0(torch.tensor(
            -1 if restored is None else step, device=self.device)))
        if step >= 0:
            state = restored if self.rank0 else state
            for _, leaf in tree_leaves(state):
                self._from_rank0(leaf)
            self.step = step
        if self.mesh is not None:
            logical = logical_specs(self.cfg)
            state["params"] = place_tree(state["params"], logical, self.mesh,
                                         self.param_rules)
            state["opt"] = {
                k: place_tree(v, logical, self.mesh, self.param_rules)
                if k != "step" else v for k, v in state["opt"].items()}
        self.params, self.opt_state = state["params"], state["opt"]
        return self.step

    def _from_rank0(self, value: torch.Tensor) -> torch.Tensor:
        """``value`` as rank 0 holds it, on every rank of the mesh."""
        if self.mesh is not None and self.mesh.size() > 1:
            dist.broadcast(value, src=0)
        return value

    # ------------------------------------------------------------------- run
    def batch_for(self, step: int) -> Dict[str, Any]:
        """The step's batch: on a mesh, the rank's rows of it."""
        b = dict(self.data.get_batch(step))
        lo, hi = self.rows
        b.update({k: v[lo:hi] for k, v in stub_frontend_inputs(
            self.cfg, self.data_cfg.host_batch, rng_seed=step).items()})
        return {k: torch.from_numpy(v).to(self.device) for k, v in b.items()}

    def _checkpoint(self) -> None:
        """Submits the full state at this step (on a mesh every rank joins
        the gathers and rank 0 writes)."""
        tree = full_tree({"params": self.params, "opt": self.opt_state})
        if self.ckpt is not None:
            self.ckpt.submit(self.step, tree)

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
                self._checkpoint()
            if self.step % log_every == 0 or self.step == steps:
                loss = float(m["loss"])
                metrics_hist.append((self.step, loss))
                if self.rank0:
                    print(f"step {self.step:5d} loss {loss:8.4f} "
                          f"lr {float(m['lr']):.2e} "
                          f"({(time.time()-t0)/max(self.step,1)*1e3:.0f} "
                          f"ms/step)", flush=True)
        if self.checkpoint_every:
            self._checkpoint()
            if self.ckpt:
                self.ckpt.close()
                self.ckpt = None
        return metrics_hist

    def simulate_crash(self):
        """Volatile state gone; durable LSM state survives."""
        if self.ckpt:
            self.ckpt.close()
            self.ckpt = None
        if self.store is not None:
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
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="train on a (data, model) mesh over the ranks that "
                         "RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT name "
                         "(torchrun), or over this process alone")
    args = ap.parse_args(argv)
    # before the CUDA context exists: deterministic cuBLAS for the steps
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    opt_cfg = OptConfig(peak_lr=args.lr, warmup_steps=10,
                        total_steps=args.steps, schedule=args.schedule)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch)
    device = resolve_device(args.device)
    # a process group made here (by torchrun's variables or the one-rank
    # mesh) ends here
    had_group = dist.is_initialized()
    mesh = None
    if args.mesh:
        if "WORLD_SIZE" in os.environ and not dist.is_initialized():
            if device.type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group(
                "nccl" if device.type == "cuda" else "gloo")
        mesh = tuple(int(n) for n in args.mesh.lower().split("x"))
    store = CheckpointStore(device=device) \
        if not dist.is_initialized() or dist.get_rank() == 0 else None
    trainer = Trainer(cfg, opt_cfg, data_cfg, store,
                      checkpoint_every=args.checkpoint_every, mesh=mesh,
                      device=args.device)
    say = print if trainer.rank0 else (lambda *a, **k: None)
    trainer.init()
    try:
        hist = trainer.run(args.steps, inject_failure_at=args.inject_failure)
    except SimulatedHostFailure as e:
        say(f"!! {e} -- recovering from the Autumn checkpoint store")
        trainer.simulate_crash()
        resumed = trainer.init(try_restore=True)
        say(f"   restored at step {resumed}; resuming")
        trainer.ckpt = AsyncCheckpointer(store) \
            if args.checkpoint_every and trainer.rank0 else None
        hist = trainer.run(args.steps)
    first, last = hist[0][1], hist[-1][1]
    if store is not None:
        say(f"loss {first:.4f} -> {last:.4f}  "
            f"(delta-skipped chunks: {store.stats_deltas_skipped}, "
            f"written: {store.stats_chunks_written}, "
            f"L={store.db.num_levels_in_use}, "
            f"WA={store.db.stats.write_amplification():.2f})")
    if not had_group and dist.is_initialized():
        dist.destroy_process_group()
    if not last < first:
        raise SystemExit("training did not reduce the loss")


if __name__ == "__main__":
    main()
