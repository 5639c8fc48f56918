"""Compute layers of the dense ``attn`` family in PyTorch.

Counterpart of ``repro.models.layers`` (``rms_norm``, ``rope``,
``attn_project_qkv``, ``attn_output``, ``dense_mlp``, ``mlp``).
Conventions are the reference's:
  x          : (B, S, D) activations in the compute dtype
  attention  : q (B, S, H, dh), k/v (B, S, KH, dh); GQA groups G = H // KH
Softmax and norm statistics are computed in float32.  Weights arrive
already in the compute dtype (:class:`.model.Model` keeps one copy made at
load), which rounds exactly as the reference's per-einsum ``.astype``.
Attention itself is in :mod:`..kernels` (flash for prefill, paged for
decode); there is no sharding callback.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig

Params = Dict[str, torch.Tensor]


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, dh) rotated by position; positions: (..., S)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[..., None] * freqs          # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                   # over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk"): one matrix product over the flattened
    heads."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def attn_project_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig,
                     positions: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Self-attention q, k, v with qk_norm and rope at ``positions``."""
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qk_norm and "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return rope(q, positions, cfg.rope_theta), \
        rope(k, positions, cfg.rope_theta), v


def attn_output(p: Params, ctx: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd")."""
    h, k, d = p["wo"].shape
    return ctx.flatten(-2) @ p["wo"].reshape(h * k, d)


def dense_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["wg"]
    u = x @ p["wu"]
    return (F.silu(h) * u) @ p["wd"]


def mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if not p:
        return torch.zeros_like(x)
    if cfg.moe is not None and "router" in p:
        raise NotImplementedError("MoE MLPs are not ported yet: ROADMAP.md "
                                  "A11 step 3")
    return dense_mlp(p, x)
