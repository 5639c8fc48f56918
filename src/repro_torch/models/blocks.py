"""The ``attn`` block in prefill and decode modes.

Counterpart of ``repro.models.blocks`` (``ring_positions``,
``attn_prefill``, ``attn_decode`` for kind ``"attn"``).  Decode KV caches
are ring buffers, as in the reference: the token at position ``pos`` goes
to slot ``pos % s_cache``.

Attention goes through :mod:`..kernels.ops`: prefill calls
``flash_attention`` (the reference computes it with XLA ``gqa_attention``),
and decode calls ``paged_attention`` on a zero-copy view of the layer's
cache ``(B, s_cache, KH, dh)`` as ``(B * s_cache / page, page, KH, dh)``
with the identity block table ``block_tables[b, p] = b * s_cache / page + p``
and ``lengths = min(pos + 1, s_cache)``.  That is the reference's ring mask
for ``attn``: slots above ``pos`` hold negative positions until the ring
wraps, and after it wraps every slot is valid; the softmax does not depend
on the order of the slots.

Caches are updated in place: the model allocates one cache tree and each
layer writes its own slice of it.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..kernels import ops
from .config import ModelConfig
from .layers import attn_output, attn_project_qkv, mlp, rms_norm

Params = Dict[str, torch.Tensor]
Cache = Dict[str, torch.Tensor]
DECODE_PAGE = 64


def ring_positions(pos: torch.Tensor, s_cache: int) -> torch.Tensor:
    slots = torch.arange(s_cache, dtype=torch.int32, device=pos.device)
    return pos - ((pos - slots) % s_cache)


def decode_page(s_cache: int) -> int:
    """Page of the decode view: 64 where it divides ``s_cache``, else the
    largest power of two that does."""
    page = DECODE_PAGE
    while s_cache % page:
        page //= 2
    return page


def attn_prefill(p: Params, x: torch.Tensor, cache: Cache,
                 positions: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One layer over the prompt; writes the layer's (zeroed) ``cache``
    slots and returns the new residual stream."""
    S = x.shape[1]
    s_cache = cache["k"].shape[1]
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v = attn_project_qkv(p, h, cfg, positions)
    ctx = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=True)
    x = x + attn_output(p, ctx)
    take = min(S, s_cache)
    slots = (torch.arange(take, device=x.device) + S - take) % s_cache
    cache["k"][:, slots] = k[:, S - take:].to(cache["k"].dtype)
    cache["v"][:, slots] = v[:, S - take:].to(cache["v"].dtype)
    return x + mlp(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg)


def attn_decode(p: Params, cache: Cache, x: torch.Tensor, pos: torch.Tensor,
                block_tables: torch.Tensor, lengths: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """One layer for one token per row at position ``pos`` (0-dim int32 on
    the device); writes slot ``pos % s_cache`` of the layer's cache."""
    B = x.shape[0]
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v = attn_project_qkv(p, h, cfg, pos.expand(B, 1))
    ck, cv = cache["k"], cache["v"]
    _, s_cache, KH, dh = ck.shape
    slot = (pos % s_cache).view(1).long()
    ck.index_copy_(1, slot, k.to(ck.dtype))
    cv.index_copy_(1, slot, v.to(cv.dtype))
    page = s_cache // block_tables.shape[1]
    ctx = ops.paged_attention(q[:, 0].contiguous(),
                              ck.view(-1, page, KH, dh),
                              cv.view(-1, page, KH, dh), block_tables,
                              lengths)
    x = x + attn_output(p, ctx[:, None])
    return x + mlp(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
