"""Weights and caches carried across as numpy arrays.

``params_from_numpy`` takes a reference-layout parameter tree of numpy
arrays (for example the reference's ``init_params`` output passed through
``numpy.asarray``) to torch tensors on a device, checking every leaf
against this package's parameter table; ``params_to_numpy`` is its
inverse.  ``opt_state_from_numpy`` does the same for an AdamW state (the
float32 moments ``m`` and ``v``, the 0-dim int32 ``step`` and, where it
has one, the float32 ``master`` copy), and ``cache_from_numpy`` and
``cache_to_numpy`` for decode caches.  Like the rest of the package,
each puts its tensors on ``cuda:0`` unless it is given ``device="cpu"``,
and raises where CUDA is absent.  NumPy has no bfloat16 of its own: an ``ml_dtypes.bfloat16``
array is read through a uint16 view, and a bfloat16 tensor comes back as
its uint16 bit pattern, so the bytes on both sides are the same.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.engine import resolve_device
from .config import ModelConfig, torch_dtype
from .params import ParamSpec, param_table, tree_map

Pytree = Any


def tensor_from_numpy(arr, device=None) -> torch.Tensor:
    """One array to a tensor (an array whose dtype is named ``bfloat16``
    becomes a bfloat16 tensor with the same bits)."""
    device = resolve_device(device)
    arr = np.array(arr, order="C")       # a copy; keeps 0-dim arrays 0-dim
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor to numpy (bfloat16 as its uint16 bits)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def params_from_numpy(tree: Pytree, cfg: ModelConfig, device=None) -> Pytree:
    """A reference parameter tree (numpy leaves) as torch tensors."""
    dtype = torch_dtype(cfg.param_dtype)
    device = resolve_device(device)

    def one(spec: ParamSpec, arr):
        arr = np.asarray(arr)
        if tuple(arr.shape) != spec.shape:
            raise ValueError(f"parameter shape {arr.shape} != {spec.shape}")
        return tensor_from_numpy(arr, device).to(dtype)

    return tree_map(one, param_table(cfg), tree,
                    is_leaf=lambda x: isinstance(x, ParamSpec))


def params_to_numpy(params: Pytree) -> Pytree:
    return tree_map(tensor_to_numpy, params)


def opt_state_from_numpy(state: Pytree, cfg: ModelConfig,
                         device=None) -> Pytree:
    """A reference AdamW state (numpy leaves) as torch tensors: every
    moment (and master) leaf checked against the parameter table and kept
    in float32, ``step`` a 0-dim int32."""
    device = resolve_device(device)

    def moments(tree):
        def one(spec: ParamSpec, arr):
            arr = np.asarray(arr)
            if tuple(arr.shape) != spec.shape or arr.dtype != np.float32:
                raise ValueError(f"optimizer leaf {arr.shape} {arr.dtype} "
                                 f"!= {spec.shape} float32")
            return tensor_from_numpy(arr, device)
        return tree_map(one, param_table(cfg), tree,
                        is_leaf=lambda x: isinstance(x, ParamSpec))

    step = np.asarray(state["step"])
    if step.shape != () or step.dtype != np.int32:
        raise ValueError(f"step {step.shape} {step.dtype} != () int32")
    out = {"m": moments(state["m"]), "v": moments(state["v"]),
           "step": tensor_from_numpy(step, device)}
    if "master" in state:
        out["master"] = moments(state["master"])
    return out


def cache_from_numpy(tree: Pytree, device=None) -> Pytree:
    """A reference decode cache (numpy leaves) as torch tensors."""
    device = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)


def cache_to_numpy(cache: Pytree) -> Pytree:
    return tree_map(tensor_to_numpy, cache)
