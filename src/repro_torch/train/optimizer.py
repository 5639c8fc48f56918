"""AdamW with pluggable schedules, on torch tensors.

A copy of ``repro.train.optimizer``: cosine (the default), WSD
(warmup-stable-decay, MiniCPM's, arXiv:2404.06395 section 4: linear
warmup, a long plateau at the peak rate, a short exponential decay tail)
and constant schedules; AdamW with global-norm clipping and an optional
float32 master copy.

The functions are pure, as the reference's: :func:`adamw_update` returns
new parameter and state trees and leaves its inputs unchanged.  The
schedule and the bias corrections are float32 tensor arithmetic in the
reference's order of operations, never Python float64, so that the rate
and the parameters after a step round as the reference's do.  A division
by a constant divides by a 0-dim float32 tensor: CUDA multiplies by the
reciprocal of a Python scalar divisor instead, which rounds differently.

On a mesh the parameter, gradient and moment leaves are ``DTensor`` leaves of
one placement: the update runs on each rank's shards, ``m`` and ``v``
keep their parameter's placement, and the global norm sums each leaf's
squares over the mesh dims that split it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from ..models.params import tree_leaves, tree_map

Pytree = Any


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"        # "cosine" | "wsd" | "constant"
    wsd_decay_frac: float = 0.1     # fraction of total steps spent decaying
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim float32 constant on ``like``'s device."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def schedule_lr(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """The learning rate at ``step`` (a 0-dim integer tensor), float32."""
    s = step.float()
    warm = torch.clamp(s / f32(max(cfg.warmup_steps, 1), s), max=1.0)
    if cfg.schedule == "constant":
        frac = torch.ones((), dtype=torch.float32, device=s.device)
    elif cfg.schedule == "wsd":
        decay_steps = max(int(cfg.total_steps * cfg.wsd_decay_frac), 1)
        decay_start = cfg.total_steps - decay_steps
        in_decay = torch.clamp(s - decay_start, min=0.0) \
            / f32(decay_steps, s)
        # exponential-ish decay tail to min_lr_frac
        frac = torch.where(s < decay_start, f32(1.0, s),
                           torch.pow(f32(cfg.min_lr_frac, s),
                                     torch.clamp(in_decay, max=1.0)))
    else:  # cosine
        prog = torch.clamp((s - cfg.warmup_steps) / f32(
            max(cfg.total_steps - cfg.warmup_steps, 1), s), 0.0, 1.0)
        frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * \
            0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.peak_lr * warm * frac


def _local(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor``'s shard on this rank; any other tensor as it is."""
    return t.to_local() if hasattr(t, "placements") else t


def _like(t: torch.Tensor, leaf) -> torch.Tensor:
    """``t`` placed as ``leaf`` is (a ``DTensor`` leaf), else ``t``."""
    if not hasattr(leaf, "placements"):
        return t
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, leaf.device_mesh, leaf.placements,
                              run_check=False)


def _sum_squares(leaf: torch.Tensor) -> torch.Tensor:
    """Sum of squares of a leaf in float32: of every shard of a
    ``DTensor`` (summed over the mesh dims that split it)."""
    out = torch.sum(_local(leaf).float() ** 2)
    if hasattr(leaf, "placements"):
        import torch.distributed as dist
        mesh = leaf.device_mesh
        for i, pl in enumerate(leaf.placements):
            if pl.is_shard() and mesh.size(i) > 1:
                dist.all_reduce(out, group=mesh.get_group(i))
    return out


def init_opt_state(params: Pytree, master: bool = False) -> Dict[str, Any]:
    """Zeroed float32 moments and a 0-dim int32 step on the parameters'
    device; ``master=True`` also keeps a float32 master copy (for bf16
    parameters)."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    device = next(iter(tree_leaves(params)))[1].device
    out = {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
           "step": torch.zeros((), dtype=torch.int32, device=device)}
    if master:
        out["master"] = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return out


def global_norm(tree: Pytree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(_sum_squares(leaf)
                          for _, leaf in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(params: Pytree, grads: Pytree, state: Dict[str, Any],
                 cfg: OptConfig) -> Tuple[Pytree, Dict[str, Any],
                                          Dict[str, torch.Tensor]]:
    """One AdamW step: (new params, new state, {"lr", "grad_norm"})."""
    step = state["step"] + 1
    lr = schedule_lr(step, cfg)
    gnorm = global_norm(grads)
    scale = torch.clamp(f32(cfg.grad_clip, gnorm) / (gnorm + 1e-9),
                        max=1.0) if cfg.grad_clip > 0 \
        else torch.ones((), dtype=torch.float32, device=gnorm.device)

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()

    def upd(p, g, m, v, w32):
        g = g.float() * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        u = u + cfg.weight_decay * w32
        w32 = w32 - lr * u
        return w32.to(p.dtype), m, v, w32

    master = state.get("master")
    out = tree_map(lambda p, g, m, v, w: upd(*map(_local, (p, g, m, v, w))),
                   params, grads, state["m"], state["v"],
                   master if master is not None
                   else tree_map(lambda p: _local(p).float(), params))
    pick = lambda i: tree_map(lambda o, p: _like(o[i], p), out, params,
                              is_leaf=lambda o: isinstance(o, tuple))
    new_state = {"m": pick(1), "v": pick(2), "step": step}
    if master is not None:
        new_state["master"] = pick(3)
    return pick(0), new_state, {"lr": lr, "grad_norm": gnorm}
