"""Gradient compression for slow-link data parallelism.

A copy of ``repro.train.compress``: int8 symmetric quantization with a
per-tensor scale and error feedback (Seide et al.; EF-SGD).  The
quantization residual is carried beside the optimizer state and added back
before the next compression, so the scheme is unbiased over time and
training converges to the uncompressed fixed point.

Two entry points:
  quantize / dequantize      -- the tensor-level codecs;
  compressed_grad_allreduce  -- the data-parallel all-reduce of compressed
                                gradients over a ``torch.distributed``
                                process group (the reference's
                                ``shard_map`` over a named mesh axis).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..models.params import tree_map
from .optimizer import f32

Pytree = Any


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 symmetric quantization: (codes, scale) with
    scale = max(max |x| / 127, 1e-12), codes = clip(round(x / scale))
    (round half to even, as ``jnp.round``)."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf))
    scale = torch.clamp(amax / f32(127.0, amax), min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_with_feedback(g: torch.Tensor, err: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(codes, scale, new_err) with new_err = (g + err) - dequant(codes)."""
    corrected = g.float() + err
    q, scale = quantize(corrected)
    return q, scale, corrected - dequantize(q, scale)


def init_error_state(grads: Pytree) -> Pytree:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def compressed_grad_allreduce(grads: Pytree, err_state: Pytree,
                              group: Optional[Any] = None
                              ) -> Tuple[Pytree, Pytree]:
    """int8-compress each gradient leaf with feedback, all-reduce (sum)
    the int32-widened codes and, separately, the scales over ``group`` (a
    ``torch.distributed`` process group; the default group when None), and
    return (mean grads in each leaf's dtype, new error state).  Each rank
    used its own scale: the sum is approximated with the mean scale,
    ``qsum * (ssum / n) / n``, and the error is absorbed by the feedback
    at the next step.

    Wire format per leaf: int8 codes and one float32 scale, the payload
    the reference's docstring promises (4x smaller than float32, about 2x
    smaller than bf16).  Like the reference's ``psum``, the all-reduce
    adds the codes widened to int32, so that the sum is exact: the bytes
    it moves are int32's.
    """
    import torch.distributed as dist
    n = dist.get_world_size(group)

    def leaf(g, e):
        q, scale, new_e = compress_with_feedback(g, e)
        qsum = q.to(torch.int32)
        dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=group)
        ssum = scale.clone()
        dist.all_reduce(ssum, op=dist.ReduceOp.SUM, group=group)
        mean = qsum.float() * (ssum / f32(n, ssum)) / f32(n, ssum)
        return mean.to(g.dtype), new_e

    out = tree_map(leaf, grads, err_state)
    pick = lambda i: tree_map(lambda o: o[i], out,
                              is_leaf=lambda o: isinstance(o, tuple))
    return pick(0), pick(1)
