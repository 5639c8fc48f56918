"""Per-kind blocks in train, prefill and decode modes.

Counterpart of ``repro.models.blocks`` (``ring_positions``, the
``*_train``, ``*_prefill`` and ``*_decode`` of every kind, ``cross_kv``,
``_cross_attn``, the Mamba-2 and RG-LRU helpers and the routing tables
``TRAIN``, ``PREFILL`` and ``DECODE``).

A train block takes ``(kind, params, x, ctx, cfg)`` and returns ``(x,
aux)``, the MoE load-balancing loss of its MLP (0 without one), with no
cache.  Its attention is :func:`.layers.gqa_attention` in differentiable
torch ops, the reference's training route; ``ctx`` holds ``positions``
and, where the model has them, ``enc_out`` and ``img_embeds``.

Decode KV caches are ring buffers, as in the reference: the token at
position ``pos`` goes to slot ``pos % s_cache``, and a ``lattn`` ring
holds ``min(window, s_max)`` slots.

Attention goes through :mod:`..kernels.ops`.  Prefill calls
``flash_attention`` (the reference computes it with XLA
``gqa_attention``): causal for ``attn``, causal with ``window`` for
``lattn``, non-causal for cross-attention (prefill and decode alike, the
query over every source position).  Self-attention decode calls
``paged_attention`` on a zero-copy view of the layer's cache
``(B, s_cache, KH, dh)`` as ``(B * s_cache / page, page, KH, dh)`` with
the identity block table ``block_tables[b, p] = b * s_cache / page + p``
and ``lengths = min(pos + 1, s_cache)``.  That is the reference's ring
mask: slots above ``pos`` hold negative positions until the ring wraps,
and after it wraps every slot holds a position in
``(pos - s_cache, pos]``, inside a ``lattn`` window since
``s_cache <= window``; the softmax does not depend on the order of the
slots.

A serving block takes ``(kind, params, x, cache, ctx, cfg)``, writes its
layer's slice of the model's one cache tree in place and returns the
residual stream.  ``ctx`` holds ``positions`` (prefill), ``enc_out`` and
``img_embeds`` (prefill, cross-attention sources), and ``pos`` and
``tables`` (decode: ``tables[s_cache]`` is the ``(block_tables,
lengths)`` pair of the caches of that extent).

Every block takes the reference's ``shard`` callback last.  On a mesh the
parameters and caches are each rank's shards (``launch.sharding``): the
rank's query and KV heads, MLP columns, experts and recurrence channels,
and, where the rules split a cache's sequence (``kv_seq``), its range of
ring slots.  Decode over such a cache is flash-decoding: K3's partial
softmax statistics of the rank's pages, merged across the ranks
(``kernels.attention.merge_partials``).  Under sequence parallelism
(training) each rank holds its range of positions; attention gathers the
keys, and the scans and the MoE routing, which need the whole sequence,
run on it gathered and keep the rank's range of the result.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import attention, ops
from .config import ModelConfig
from .layers import (Shard, attn_output, attn_project_qkv, causal_conv1d,
                     causal_conv1d_step, gqa_attention, heads_kv,
                     identity_shard, mlp, mlp_train, proj, rglru_scan,
                     rglru_step, rms_norm, ssd_scan, ssd_step)

Params = Dict[str, Any]
Cache = Dict[str, torch.Tensor]
Ctx = Dict[str, Any]
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


def _mlp_out(p: Params, x: torch.Tensor, cfg: ModelConfig,
             shard: Shard) -> torch.Tensor:
    return mlp(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg, shard)


def _mlp_train(p: Params, x: torch.Tensor, cfg: ModelConfig, shard: Shard):
    """(MLP output, aux loss) of the block's MLP, for training."""
    return mlp_train(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg,
                     shard)


def _attend_train(p: Params, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, cfg: ModelConfig, q_pos: torch.Tensor,
                  k_pos: torch.Tensor, causal: bool, window, shard: Shard,
                  kv_layout: str = "seq") -> torch.Tensor:
    k, v = heads_kv(k, v, cfg.n_q, shard)
    o = gqa_attention(q, k, v, q_positions=q_pos, k_positions=k_pos,
                      causal=causal, window=window, q_chunk=cfg.q_chunk,
                      scores_dtype=cfg.scores_dtype, shard=shard,
                      kv_layout=kv_layout)
    return attn_output(p, o, shard)


def _self_attn_train(p: Params, h: torch.Tensor, cfg: ModelConfig,
                     positions: torch.Tensor, window,
                     shard: Shard) -> torch.Tensor:
    q, k, v = attn_project_qkv(p, h, cfg, positions, shard)
    return _attend_train(p, q, k, v, cfg, positions, positions, True, window,
                         shard)


def _whole_seq(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The whole sequence of ``x`` (B, S, D) on every rank (under SP the
    ranks' ranges gathered)."""
    return shard(x, "batch", None, "embed", src=("batch", "seq", "embed"))


def _own_seq(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The rank's range of a whole sequence (under SP)."""
    return shard(x, "batch", "seq", "embed", src=("batch", None, "embed"))


def _ring_slots(cache: torch.Tensor, t: torch.Tensor, S: int, s_cache: int,
                lo: int) -> None:
    """Writes the last ``min(S, s_cache)`` positions of ``t`` (B, S, ...)
    into their ring slots ``pos % s_cache``: those of the rank's range
    ``[lo, lo + cache.shape[1])``."""
    take = min(S, s_cache)
    if cache.shape[1] == s_cache:
        slots = (torch.arange(take, device=t.device) + S - take) % s_cache
        cache[:, slots] = t[:, S - take:].to(cache.dtype)
        return
    # the rank's slots, found on the host from the shapes alone
    slots = (np.arange(take) + S - take) % s_cache
    rows = np.flatnonzero((slots >= lo) & (slots < lo + cache.shape[1]))
    cache[:, torch.from_numpy(slots[rows] - lo).to(t.device)] = \
        t[:, S - take:][:, torch.from_numpy(rows).to(t.device)].to(
            cache.dtype)


# ====================================================================== attn
def attn_prefill(kind: str, p: Params, x: torch.Tensor, cache: Cache,
                 ctx: Ctx, cfg: ModelConfig,
                 shard: Shard = identity_shard) -> torch.Tensor:
    """One layer over the prompt; writes the layer's (zeroed) ring."""
    window = cfg.window if kind == "lattn" else 0
    S = x.shape[1]
    s_cache = cache["k"].shape[1] * shard.shards("kv_seq")
    lo = shard.span("kv_seq", s_cache)[0]
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v = attn_project_qkv(p, h, cfg, ctx["positions"], shard)
    o = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=True, window=window)
    x = x + attn_output(p, o, shard)
    _ring_slots(cache["k"], k, S, s_cache, lo)
    _ring_slots(cache["v"], v, S, s_cache, lo)
    return x + _mlp_out(p, x, cfg, shard)


def attn_decode(kind: str, p: Params, cache: Cache, x: torch.Tensor,
                ctx: Ctx, cfg: ModelConfig,
                shard: Shard = identity_shard) -> torch.Tensor:
    """One layer for one token per row at position ``ctx["pos"]`` (0-dim
    int32 on the device); writes slot ``pos % s_cache`` of the ring (on
    the rank whose range holds it)."""
    B = x.shape[0]
    pos = ctx["pos"]
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v = attn_project_qkv(p, h, cfg, pos.expand(B, 1), shard)
    ck, cv = cache["k"], cache["v"]
    _, s_local, KH, dh = ck.shape
    block_tables, lengths = ctx["tables"][s_local]
    page = s_local // block_tables.shape[1]
    kp, vp = ck.view(-1, page, KH, dh), cv.view(-1, page, KH, dh)
    s_cache = s_local * shard.shards("kv_seq")
    if s_local == s_cache:
        slot = (pos % s_cache).view(1).long()
        ck.index_copy_(1, slot, k.to(ck.dtype))
        cv.index_copy_(1, slot, v.to(cv.dtype))
        o = ops.paged_attention(q[:, 0].contiguous(), kp, vp, block_tables,
                                lengths)
    else:
        local = pos % s_cache - shard.span("kv_seq", s_cache)[0]
        mine = (local >= 0) & (local < s_local)
        slot = local.clamp(0, s_local - 1).view(1).long()
        ck.index_copy_(1, slot, torch.where(mine, k.to(ck.dtype),
                                            ck.index_select(1, slot)))
        cv.index_copy_(1, slot, torch.where(mine, v.to(cv.dtype),
                                            cv.index_select(1, slot)))
        o = attention.merge_partials(
            *ops.paged_attention_partials(q[:, 0].contiguous(), kp, vp,
                                          block_tables, lengths),
            all_max=lambda t: shard.max(t, "kv_seq"),
            all_sum=lambda t: shard(t, partial="kv_seq")).to(q.dtype)
    x = x + attn_output(p, o[:, None], shard)
    return x + _mlp_out(p, x, cfg, shard)


def attn_train(kind: str, p: Params, x: torch.Tensor, ctx: Ctx,
               cfg: ModelConfig, shard: Shard = identity_shard):
    """One layer over the whole sequence with no cache: (x, aux)."""
    window = cfg.window if kind == "lattn" else None
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    x = x + _self_attn_train(p, h, cfg, ctx["positions"], window, shard)
    y, aux = _mlp_train(p, x, cfg, shard)
    return x + y, aux


# ================================================================ cross-attn
def cross_kv(p: Params, src: torch.Tensor, cfg: ModelConfig,
             shard: Shard = identity_shard):
    """Cross-attention K and V of a source sequence (B, T, D): the rank's
    KV heads."""
    src = shard.enter(src, "kv_heads")
    k, v = proj(src, p["wk"]), proj(src, p["wv"])
    if cfg.qk_norm and "k_norm" in p:
        k = rms_norm(k, shard.enter(p["k_norm"], "kv_heads"), cfg.norm_eps)
    return k, v


def _cross_q(p: Params, h: torch.Tensor, cfg: ModelConfig,
             shard: Shard) -> torch.Tensor:
    q = proj(shard.enter(h, "heads"), p["wq"])
    if cfg.qk_norm and "q_norm" in p:
        q = rms_norm(q, shard.enter(p["q_norm"], "heads"), cfg.norm_eps)
    return q


def cross_attn(p: Params, h: torch.Tensor, src_k: torch.Tensor,
               src_v: torch.Tensor, cfg: ModelConfig,
               shard: Shard = identity_shard) -> torch.Tensor:
    """Every query over every source position (no rope, no mask)."""
    q = _cross_q(p, h, cfg, shard)
    o = ops.flash_attention(q.contiguous(), src_k.contiguous(),
                            src_v.contiguous(), causal=False)
    return attn_output(p, o, shard)


def _gate(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(g.float()).to(x.dtype)


def _xattn(p: Params, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           cfg: ModelConfig, shard: Shard) -> torch.Tensor:
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    x = x + _gate(p["xgate"], x) * cross_attn(p, h, k, v, cfg, shard)
    return x + _gate(p["mgate"], x) * _mlp_out(p, x, cfg, shard)


def _cross_attn_train(p: Params, h: torch.Tensor, src_k: torch.Tensor,
                      src_v: torch.Tensor, cfg: ModelConfig,
                      shard: Shard) -> torch.Tensor:
    """Every query over every source position, in ``gqa_attention``
    (positions all 0, non-causal: no mask)."""
    q = _cross_q(p, h, cfg, shard)
    kpos = torch.zeros(1, src_k.shape[1], dtype=torch.int32,
                       device=h.device)
    qpos = torch.zeros(h.shape[:2], dtype=torch.int32, device=h.device)
    return _attend_train(p, q, src_k, src_v, cfg, qpos, kpos, False, None,
                         shard, "enc_seq")


def xattn_train(kind: str, p: Params, x: torch.Tensor, ctx: Ctx,
                cfg: ModelConfig, shard: Shard = identity_shard):
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    k, v = cross_kv(p, ctx["img_embeds"], cfg, shard)
    x = x + _gate(p["xgate"], x) * _cross_attn_train(p, h, k, v, cfg, shard)
    y, aux = _mlp_train(p, x, cfg, shard)
    return x + _gate(p["mgate"], x) * y, aux


def xattn_prefill(kind: str, p: Params, x: torch.Tensor, cache: Cache,
                  ctx: Ctx, cfg: ModelConfig,
                  shard: Shard = identity_shard) -> torch.Tensor:
    k, v = cross_kv(p, ctx["img_embeds"], cfg, shard)
    cache["k"].copy_(k)
    cache["v"].copy_(v)
    return _xattn(p, x, k, v, cfg, shard)


def xattn_decode(kind: str, p: Params, cache: Cache, x: torch.Tensor,
                 ctx: Ctx, cfg: ModelConfig,
                 shard: Shard = identity_shard) -> torch.Tensor:
    return _xattn(p, x, cache["k"], cache["v"], cfg, shard)


# ========================================== whisper decoder (self + cross)
_NOOP_MLP: Params = {}     # reuses the attn block with no MLP of its own


def _self_cache(cache: Cache) -> Cache:
    return {"k": cache["k"], "v": cache["v"]}


def _wdec_cross(p: Params, x: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, cfg: ModelConfig,
                shard: Shard) -> torch.Tensor:
    hx = rms_norm(x, p["ln_x"], cfg.norm_eps)
    x = x + cross_attn(p["x"], hx, k, v, cfg, shard)
    return x + _mlp_out(p, x, cfg, shard)


def wdec_prefill(kind: str, p: Params, x: torch.Tensor, cache: Cache,
                 ctx: Ctx, cfg: ModelConfig,
                 shard: Shard = identity_shard) -> torch.Tensor:
    x = attn_prefill("attn", {**p, "mlp": _NOOP_MLP}, x, _self_cache(cache),
                     ctx, cfg, shard)
    k, v = cross_kv(p["x"], ctx["enc_out"], cfg, shard)
    cache["xk"].copy_(k)
    cache["xv"].copy_(v)
    return _wdec_cross(p, x, k, v, cfg, shard)


def wdec_train(kind: str, p: Params, x: torch.Tensor, ctx: Ctx,
               cfg: ModelConfig, shard: Shard = identity_shard):
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    x = x + _self_attn_train(p, h, cfg, ctx["positions"], None, shard)
    hx = rms_norm(x, p["ln_x"], cfg.norm_eps)
    k, v = cross_kv(p["x"], ctx["enc_out"], cfg, shard)
    x = x + _cross_attn_train(p["x"], hx, k, v, cfg, shard)
    y, aux = _mlp_train(p, x, cfg, shard)
    return x + y, aux


def wdec_decode(kind: str, p: Params, cache: Cache, x: torch.Tensor,
                ctx: Ctx, cfg: ModelConfig,
                shard: Shard = identity_shard) -> torch.Tensor:
    x = attn_decode("attn", {**p, "mlp": _NOOP_MLP}, _self_cache(cache), x,
                    ctx, cfg, shard)
    return _wdec_cross(p, x, cache["xk"], cache["xv"], cfg, shard)


# ================================================================== Mamba-2
def _ssd_proj(p: Params, x: torch.Tensor, cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    pr = h @ p["in_proj"]
    z = pr[..., :d_inner]
    xBC = pr[..., d_inner:2 * d_inner + 2 * s.d_state]
    dt_raw = pr[..., 2 * d_inner + 2 * s.d_state:]
    return z, xBC, dt_raw, d_inner, H


def _ssd_split(xBC: torch.Tensor, d_inner: int, d_state: int):
    return (xBC[..., :d_inner], xBC[..., d_inner:d_inner + d_state],
            xBC[..., d_inner + d_state:])


def _ssd_chunk(S: int, pref: int) -> int:
    """Largest divisor of S not exceeding the preferred chunk size."""
    for c in range(min(pref, S), 0, -1):
        if S % c == 0:
            return c
    return 1


def _ssd_mix(p: Params, x: torch.Tensor, y: torch.Tensor, xh: torch.Tensor,
             z: torch.Tensor, d_skip: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    """y + D x, gated norm, out projection, residual."""
    y = (y + xh * d_skip.to(x.dtype)).reshape(z.shape)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return x + y @ p["out_proj"]


def _ssd_out(p: Params, x: torch.Tensor, y: torch.Tensor, xh: torch.Tensor,
             z: torch.Tensor, d_skip: torch.Tensor,
             cfg: ModelConfig, shard: Shard) -> torch.Tensor:
    """:func:`_ssd_mix` and the MLP, where the block has one."""
    x = _ssd_mix(p, x, y, xh, z, d_skip, cfg)
    if "mlp" in p:
        x = x + _mlp_out(p, x, cfg, shard)
    return x


def _ssd_core(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """The block up to the scan: (z, the conv input, xh, dt, A, B, C)."""
    s = cfg.ssm
    z, conv_in, dt_raw, d_inner, H = _ssd_proj(p, x, cfg)
    xBC = F.silu(causal_conv1d(conv_in, p["conv_w"], p["conv_b"]))
    xs, Bm, Cm = _ssd_split(xBC, d_inner, s.d_state)
    B_, S, _ = x.shape
    xh = xs.reshape(B_, S, H, s.head_dim)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    return z, conv_in, xh, dt, A, Bm, Cm


def ssd_train(kind: str, p: Params, x: torch.Tensor, ctx: Ctx,
              cfg: ModelConfig, shard: Shard = identity_shard):
    xs = _whole_seq(x, shard)         # the scan runs over the whole sequence
    z, _, xh, dt, A, Bm, Cm = _ssd_core(p, xs, cfg)
    y, _ = ssd_scan(xh, dt, A, Bm, Cm, _ssd_chunk(xs.shape[1],
                                                   cfg.ssm.chunk))
    x = _own_seq(_ssd_mix(p, xs, y, xh, z,
                          p["D"].float()[None, None, :, None], cfg), shard)
    if "mlp" in p:
        y2, aux = _mlp_train(p, x, cfg, shard)
        return x + y2, aux
    return x, x.new_zeros((), dtype=torch.float32)


def ssd_prefill(kind: str, p: Params, x: torch.Tensor, cache: Cache,
                ctx: Ctx, cfg: ModelConfig,
                shard: Shard = identity_shard) -> torch.Tensor:
    s = cfg.ssm
    z, conv_in, xh, dt, A, Bm, Cm = _ssd_core(p, x, cfg)
    S = x.shape[1]
    y, state = ssd_scan(xh, dt, A, Bm, Cm, _ssd_chunk(S, s.chunk))
    cache["state"].copy_(state)
    cache["conv"].copy_(conv_in[:, S - (s.conv_width - 1):])
    return _ssd_out(p, x, y, xh, z,
                    p["D"].float()[None, None, :, None], cfg, shard)


def ssd_decode(kind: str, p: Params, cache: Cache, x: torch.Tensor,
               ctx: Ctx, cfg: ModelConfig,
               shard: Shard = identity_shard) -> torch.Tensor:
    s = cfg.ssm
    z, xBC, dt_raw, d_inner, H = _ssd_proj(p, x, cfg)
    xBC_t, conv_state = causal_conv1d_step(xBC[:, 0], cache["conv"],
                                           p["conv_w"], p["conv_b"])
    xs, B_t, C_t = _ssd_split(F.silu(xBC_t), d_inner, s.d_state)
    xh = xs.reshape(x.shape[0], H, s.head_dim)
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    y, state = ssd_step(xh, dt, A, B_t, C_t, cache["state"])
    cache["state"].copy_(state)
    cache["conv"].copy_(conv_state)
    return _ssd_out(p, x, y, xh, z, p["D"].float()[None, :, None], cfg,
                    shard)


# =================================================================== RG-LRU
def _rglru_gates(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 shard: Shard):
    """The recurrent branch and the gate: the rank's channels."""
    h = shard.enter(rms_norm(x, p["ln"], cfg.norm_eps), "rec")
    gate = F.gelu(h @ p["wy"], approximate="tanh")    # jax.nn.gelu's default
    return h @ p["wx"], gate


def _rglru_ri(p: Params, u: torch.Tensor, shard: Shard):
    """The recurrence and input gates r, i (block-diagonal where the gate
    weights are (blocks, w, w): the rank's blocks); a dense gate reads
    every channel of ``u``."""
    ba, bi = p["ba_gate"].to(u.dtype), p["bi_gate"].to(u.dtype)
    if p["wa_gate"].dim() == 3:
        B_, S_, W_ = u.shape
        nb, wb, _ = p["wa_gate"].shape
        ub = u.reshape(B_, S_, nb, wb)
        r = torch.einsum("bsnw,nwv->bsnv", ub, p["wa_gate"]).reshape(
            B_, S_, W_) + ba
        i = torch.einsum("bsnw,nwv->bsnv", ub, p["wi_gate"]).reshape(
            B_, S_, W_) + bi
        return torch.sigmoid(r), torch.sigmoid(i)
    u = shard.enter(shard(u, "batch", "seq", None,
                          src=("batch", "seq", "rec")), "rec")
    return torch.sigmoid(u @ p["wa_gate"] + ba), \
        torch.sigmoid(u @ p["wi_gate"] + bi)


def _rglru_out(p: Params, h: torch.Tensor, gate: torch.Tensor,
               shard: Shard) -> torch.Tensor:
    """(h gate) wout, summed over the ranks' channels."""
    return shard((h * gate) @ p["wout"], "batch", "seq", "embed",
                 partial="rec")


def rglru_prefill(kind: str, p: Params, x: torch.Tensor, cache: Cache,
                  ctx: Ctx, cfg: ModelConfig,
                  shard: Shard = identity_shard) -> torch.Tensor:
    u_raw, gate = _rglru_gates(p, x, cfg, shard)
    u = causal_conv1d(u_raw, p["conv_w"], p["conv_b"])
    r, i = _rglru_ri(p, u, shard)
    h, h_last = rglru_scan(u, r, i, p["Lambda"], cfg.rglru.power)
    x = x + _rglru_out(p, h, gate, shard)
    cache["h"].copy_(h_last)
    cache["conv"].copy_(u_raw[:, x.shape[1] - (cfg.rglru.conv_width - 1):])
    return x + _mlp_out(p, x, cfg, shard)


def rglru_train(kind: str, p: Params, x: torch.Tensor, ctx: Ctx,
                cfg: ModelConfig, shard: Shard = identity_shard):
    xs = _whole_seq(x, shard)         # the scan runs over the whole sequence
    u, gate = _rglru_gates(p, xs, cfg, shard)
    u = causal_conv1d(u, p["conv_w"], p["conv_b"])
    r, i = _rglru_ri(p, u, shard)
    h, _ = rglru_scan(u, r, i, p["Lambda"], cfg.rglru.power)
    x = x + _own_seq(_rglru_out(p, h, gate, shard), shard)
    y, aux = _mlp_train(p, x, cfg, shard)
    return x + y, aux


def rglru_decode(kind: str, p: Params, cache: Cache, x: torch.Tensor,
                 ctx: Ctx, cfg: ModelConfig,
                 shard: Shard = identity_shard) -> torch.Tensor:
    u_raw, gate = _rglru_gates(p, x, cfg, shard)
    u_t, conv_state = causal_conv1d_step(u_raw[:, 0], cache["conv"],
                                         p["conv_w"], p["conv_b"])
    r, i = _rglru_ri(p, u_t[:, None], shard)
    h, h_new = rglru_step(u_t, r[:, 0], i[:, 0], p["Lambda"],
                          cfg.rglru.power, cache["h"])
    x = x + _rglru_out(p, h, gate[:, 0], shard)[:, None]
    cache["h"].copy_(h_new)
    cache["conv"].copy_(conv_state)
    return x + _mlp_out(p, x, cfg, shard)


# ------------------------------------------------------------------ routing
TRAIN = {"attn": attn_train, "lattn": attn_train, "xattn": xattn_train,
         "wdec": wdec_train, "ssd": ssd_train, "rglru": rglru_train}
PREFILL = {"attn": attn_prefill, "lattn": attn_prefill,
           "xattn": xattn_prefill, "wdec": wdec_prefill,
           "ssd": ssd_prefill, "rglru": rglru_prefill}
DECODE = {"attn": attn_decode, "lattn": attn_decode, "xattn": xattn_decode,
          "wdec": wdec_decode, "ssd": ssd_decode, "rglru": rglru_decode}
SELF_ATTN_KINDS = ("attn", "lattn", "wdec")   # kinds that decode through K3
