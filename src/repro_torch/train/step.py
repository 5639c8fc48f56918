"""Train step: loss, gradients, AdamW, with microbatch gradient
accumulation.

A copy of ``repro.train.step``.  With ``accum_steps > 1`` the batch is cut
along its first axis into microbatches, whose gradients are summed in
float32 and divided by their count (the reference's scan), the main
activation-memory lever beside per-block remat (``ModelConfig.remat``).
The loss is the microbatches' mean, the other loss metrics the last
microbatch's.  ``shard`` (a ``launch.sharding.Sharder`` with the train
rules) runs the step on a mesh: ``DTensor`` parameters, each rank's rows
of the batch.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from ..models import train as T
from ..models.config import ModelConfig
from ..models.layers import Shard, identity_shard
from ..models.params import tree_map
from .optimizer import OptConfig, _local, adamw_update, f32

Pytree = Any
Batch = Dict[str, torch.Tensor]


def _split_batch(batch: Batch, accum: int):
    """The ``accum`` microbatches of ``batch``, in order."""
    B = next(iter(batch.values())).shape[0]
    if B % accum:
        raise ValueError(f"batch {B} is no multiple of accum_steps {accum}")
    mb = B // accum
    return [{k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            for i in range(accum)]


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                    accum_steps: int = 1,
                    shard: Shard = identity_shard) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; the inputs are left unchanged."""

    def train_step(params: Pytree, opt_state: Pytree, batch: Batch):
        if accum_steps == 1:
            (loss, metrics), grads = T.value_and_grad(params, batch, cfg,
                                                      shard)
        else:
            grads = tree_map(lambda p: torch.zeros(
                _local(p).shape, dtype=torch.float32, device=p.device),
                params)
            loss = None
            for mb in _split_batch(batch, accum_steps):
                (l, metrics), g = T.value_and_grad(params, mb, cfg, shard)
                grads = tree_map(lambda a, b: a + _local(b).float(), grads,
                                 g)
                loss = l if loss is None else loss + l
            n = f32(accum_steps, loss)
            grads = tree_map(lambda g: g / n, grads)
            loss = loss / n
        new_params, new_opt, opt_metrics = adamw_update(
            params, grads, opt_state, opt_cfg)
        return new_params, new_opt, dict(metrics, loss=loss, **opt_metrics)

    return train_step


def make_eval_step(cfg: ModelConfig) -> Callable:
    @torch.no_grad()
    def eval_step(params: Pytree, batch: Batch):
        loss, metrics = T.loss_fn(params, batch, cfg)
        return dict(metrics, loss=loss)
    return eval_step
