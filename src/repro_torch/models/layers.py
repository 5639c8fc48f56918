"""Compute layers shared by every architecture family, in PyTorch.

Counterpart of ``repro.models.layers`` (``rms_norm``, ``rope``,
``_mask_bias``, ``gqa_attention``, ``attn_project_qkv``, ``attn_output``,
``dense_mlp``, ``moe_mlp``, ``mlp``, ``causal_conv1d``/``_step``,
``_segsum``, ``ssd_scan``/``ssd_step`` and ``rglru_scan``/``rglru_step``).  Conventions are the reference's:
  x          : (B, S, D) activations in the compute dtype
  attention  : q (B, S, H, dh), k/v (B, S, KH, dh); GQA groups G = H // KH
Softmax, norm, scan and gate statistics are computed in float32.  Weight
matrices arrive already in the compute dtype (:class:`.model.Model` keeps
one copy made at load), which rounds exactly as the reference's per-einsum
``.astype``; vectors and the few matrices the reference reads in float32
(the router, the conv taps) keep the parameter dtype and are cast here as
the reference casts them.  Serving attention is in :mod:`..kernels`
(flash for prefill, cross-attention and the encoder, paged for decode);
training attention is :func:`gqa_attention`, the reference's own route in
differentiable ops, and :func:`mlp_train` keeps the MoE aux loss that the
serving :func:`mlp` drops.

``shard`` is the reference's activation callback.  The port computes on
each rank's local tensors, so the callback does the work where a layout
changes (``launch.sharding.Sharder``): a contraction over a split dim is
summed (``partial``), a dim is gathered or cut (``src``), a replicated
tensor meeting the rank's shard passes ``enter``.  :data:`identity_shard`,
the default, is the meshless case: every call returns its input.

The reference's sequential scans become loops (``ssd_scan``'s inter-chunk
recurrence, one step per chunk) or a log-depth scan (``rglru_scan``, in
place of ``associative_scan``): the same recurrences in another order of
float32 additions.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig, torch_dtype

Params = Dict[str, torch.Tensor]


class IdentityShard:
    """The meshless ``shard`` callback (the reference's ``_IdentityShard``):
    one rank holds every tensor whole, so no layout ever changes and every
    method returns its input.  ``launch.sharding.Sharder`` is the mesh's."""

    mesh = None
    token_shards = 1

    def __call__(self, x: torch.Tensor, *logical: Optional[str],
                 src: Optional[Sequence[Optional[str]]] = None,
                 partial: Optional[str] = None) -> torch.Tensor:
        return x

    def is_sharded(self, name: str) -> bool:
        return False

    def shards(self, name: str) -> int:
        """How many ranks split a dim under the rule ``name``."""
        return 1

    def span(self, name: str, n: int) -> Tuple[int, int]:
        """This rank's range of a dim of ``n`` split by the rule ``name``."""
        return 0, n

    def local_shape(self, shape: Sequence[int],
                    logical: Sequence[Optional[str]]) -> Tuple[int, ...]:
        """The rank's shard of a tensor of ``shape`` in layout
        ``logical``."""
        return tuple(shape)

    def enter(self, x: torch.Tensor, name: Optional[str]) -> torch.Tensor:
        return x

    def max(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return x

    def token_sum(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def param(self, leaf: torch.Tensor, logical: tuple) -> torch.Tensor:
        return leaf

    def param_grad(self, g: torch.Tensor, leaf, logical: tuple
                   ) -> torch.Tensor:
        return g


identity_shard = IdentityShard()
Shard = IdentityShard


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


# --------------------------------------------------------------- attention
NEG_INF = -1e30


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: Optional[int],
               k_len: Optional[torch.Tensor]) -> torch.Tensor:
    """(..., Sq, Sk) float32 additive bias; ``window`` counts positions
    (q - window, q]."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    ok = kp >= 0     # ring slots never written carry negative positions
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & (kp > qp - window)
    if k_len is not None:
        ok = ok & (kp < k_len)
    return torch.where(ok, 0.0, NEG_INF).float()


def _dot(eq: str, a: torch.Tensor, b: torch.Tensor,
         out_dtype: torch.dtype) -> torch.Tensor:
    """einsum with the reference's ``preferred_element_type``: float32
    output from float32 arithmetic on the (exactly widened) inputs."""
    if out_dtype == torch.float32:
        return torch.einsum(eq, a.float(), b.float())
    return torch.einsum(eq, a, b).to(out_dtype)


def _repeat_kv(t: torch.Tensor, G: int) -> torch.Tensor:
    """``jnp.repeat(t, G, axis=2)`` as a broadcast: its backward is a sum
    over the G copies, with no index scatter."""
    B, S, KH, dh = t.shape
    return t[:, :, :, None].expand(B, S, KH, G, dh).reshape(B, S, KH * G, dh)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  q_positions: torch.Tensor, k_positions: torch.Tensor,
                  causal: bool, window: Optional[int],
                  k_len: Optional[torch.Tensor] = None,
                  q_chunk: int = 1024,
                  scores_dtype: str = "float32",
                  shard: Shard = identity_shard,
                  kv_layout: str = "seq") -> torch.Tensor:
    """The reference's training attention (``repro.models.layers``
    ``gqa_attention``) in differentiable torch ops: the repeat-KV form,
    scores in ``scores_dtype``, the softmax max held out of the gradient,
    the normaliser floored at 1e-30 and folded into the (C, dh) output,
    queries in ``q_chunk`` blocks, and the grouped route for one query.

    q: (B, Sq, H, dh), k/v: (B, Sk, KH, dh), H = G KH; output in q's dtype.
    ``kv_layout`` names the keys' sequence dim (``"seq"`` for
    self-attention, ``"enc_seq"`` for an encoder's keys): under sequence
    parallelism each rank's queries read every key, gathered here with
    their positions.
    This is the reference's own route for training: its training path
    reaches no Pallas kernel, and neither package's flash kernel has a
    backward, so serving's ``ops.flash_attention`` is not used here.
    """
    kv_src = ("batch", kv_layout, None, "head_dim")
    k = shard(k, "batch", "att_kv_seq", None, "head_dim", src=kv_src)
    v = shard(v, "batch", "att_kv_seq", None, "head_dim", src=kv_src)
    k_positions = shard(k_positions, None, "att_kv_seq",
                        src=(None, kv_layout))
    B, Sq, H, dh = q.shape
    KH = k.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(dh)
    sdt = torch_dtype(scores_dtype)

    if Sq == 1 and G > 1:
        qg = q.reshape(B, 1, KH, G, dh)
        s = _dot("bqkgd,bskd->bkgqs", qg, k, sdt) * scale
        bias = _mask_bias(q_positions, k_positions, causal, window, k_len)
        s = s + bias[:, None, None].to(sdt)
        m = torch.amax(s, dim=-1, keepdim=True)
        p = torch.exp(s - m.detach())
        l = torch.sum(p, dim=-1, keepdim=True)
        o = _dot("bkgqs,bskd->bqkgd", p.to(v.dtype), v, torch.float32)
        o = o / torch.clamp(l.permute(0, 3, 1, 2, 4), min=1e-30).float()
        return o.reshape(B, 1, H, dh).to(q.dtype)

    if G > 1:
        k, v = _repeat_kv(k, G), _repeat_kv(v, G)

    def attend(q_blk: torch.Tensor, qpos_blk: torch.Tensor) -> torch.Tensor:
        s = _dot("bqhd,bshd->bhqs", q_blk, k, sdt) * scale
        bias = _mask_bias(qpos_blk, k_positions, causal, window, k_len)
        s = s + bias[:, None].to(sdt)                 # (B, H, C, Sk)
        m = torch.amax(s, dim=-1, keepdim=True)
        p = torch.exp(s - m.detach())
        l = torch.sum(p, dim=-1, keepdim=True)        # (B, H, C, 1)
        o = _dot("bhqs,bshd->bqhd", p.to(v.dtype), v, torch.float32)
        o = o / torch.clamp(l.transpose(1, 2), min=1e-30).float()
        return o.to(q.dtype)

    if Sq <= q_chunk or Sq % q_chunk != 0:
        return attend(q, q_positions)
    return torch.cat([attend(q[:, c:c + q_chunk],
                             q_positions[..., c:c + q_chunk])
                      for c in range(0, Sq, q_chunk)], dim=1)


def proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk"): one matrix product over the flattened
    heads."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def attn_project_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig,
                     positions: torch.Tensor, shard: Shard = identity_shard
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Self-attention q, k, v with qk_norm and rope at ``positions``: the
    rank's query heads and KV heads (the weights' shards)."""
    xq, xk = shard.enter(x, "heads"), shard.enter(x, "kv_heads")
    q, k, v = proj(xq, p["wq"]), proj(xk, p["wk"]), proj(xk, p["wv"])
    if cfg.qk_norm and "q_norm" in p:
        q = rms_norm(q, shard.enter(p["q_norm"], "heads"), cfg.norm_eps)
        k = rms_norm(k, shard.enter(p["k_norm"], "kv_heads"), cfg.norm_eps)
    return rope(q, positions, cfg.rope_theta), \
        rope(k, positions, cfg.rope_theta), v


def heads_kv(k: torch.Tensor, v: torch.Tensor, n_q: int,
             shard: Shard = identity_shard
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The KV heads that the rank's query heads read: ``k``, ``v`` as they
    are unless the rules split the query heads and not the KV heads (the
    reference repeats KV to every query head and splits that), where each
    rank keeps the KV heads of its query heads."""
    if shard.shards("heads") == 1 or shard.shards("kv_heads") > 1:
        return k, v
    G = n_q // k.shape[2]
    h0, h1 = shard.span("heads", n_q)
    k0, k1 = h0 // G, (h1 - 1) // G + 1
    return shard.enter(k, "heads")[:, :, k0:k1], \
        shard.enter(v, "heads")[:, :, k0:k1]


def attn_output(p: Params, ctx: torch.Tensor,
                shard: Shard = identity_shard) -> torch.Tensor:
    """einsum("bshk,hkd->bsd"), summed over the ranks' heads."""
    h, k, d = p["wo"].shape
    return shard(ctx.flatten(-2) @ p["wo"].reshape(h * k, d),
                 "batch", "seq", "embed", partial="heads")


# -------------------------------------------------------------------- mlps
def dense_mlp(p: Params, x: torch.Tensor,
              shard: Shard = identity_shard) -> torch.Tensor:
    x = shard.enter(x, "mlp")
    h = x @ p["wg"]
    u = x @ p["wu"]
    return shard((F.silu(h) * u) @ p["wd"], "batch", "seq", "embed",
                 partial="mlp")


def moe_capacity(S: int, cfg: ModelConfig) -> int:
    """Expert slots per sequence: ceil(S K cf / E), within [1, S K]."""
    m = cfg.moe
    C = max(1, int(math.ceil(S * m.top_k * m.capacity_factor
                             / m.num_experts)))
    return min(C, S * m.top_k)


def moe_dispatch(top_ids: torch.Tensor, E: int, C: int):
    """The reference's sort-based dispatch of (B, S, K) expert choices:
    ``order`` (the stable sort by expert of the flattened choices), each
    sorted choice's ``slot`` in the (E * C) expert buffer and ``keep``
    (False where its expert's C slots were taken by earlier tokens)."""
    B, S, K = top_ids.shape
    ids = top_ids.reshape(B, S * K)
    order = torch.argsort(ids, dim=-1, stable=True)
    sids = torch.gather(ids, 1, order)
    experts = torch.arange(E, device=ids.device, dtype=sids.dtype)
    seg_start = torch.searchsorted(sids, experts.expand(B, E).contiguous())
    pos_in_e = torch.arange(S * K, device=ids.device)[None] \
        - torch.gather(seg_start, 1, sids)
    keep = pos_in_e < C
    slot = sids * C + torch.clamp(pos_in_e, max=C - 1)
    return order, slot, keep


def moe_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig,
            shard: Shard = identity_shard
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based token-choice top-k MoE (drop on capacity, per sequence)
    and the Switch load-balancing aux loss, as the reference computes them.

    Tokens are replicated K times, stably sorted by expert id, packed into
    (B, E, C, D) buffers (each kept choice has a slot of its own, so the
    pack is a plain indexed copy), run through batched expert products,
    then gathered back.  The un-sort is deterministic: each choice's output
    returns to its (token, k) place by a permutation, and a token's K
    outputs are summed one after another in increasing expert id, the
    order in which the reference's ``.at[tok].add`` visits them; there is
    no float atomic, so the same inputs give the same bits.

    On a mesh the routing runs on every rank of the model axis over the
    whole sequence (capacity is per sequence); each rank runs its experts
    (EP) or its shard of every expert's hidden dim, and the outputs of all
    experts meet before the un-sort.
    """
    m = cfg.moe
    x = shard(x, "batch", None, "embed", src=("batch", "seq", "embed"))
    B, S, D = x.shape
    E, K = m.num_experts, m.top_k
    C = moe_capacity(S, cfg)
    router = shard(p["router"], "embed", None, src=("embed", "expert"))
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    top_w, top_ids = torch.topk(probs, K, dim=-1)     # (B, S, K)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    dispatch_frac = F.one_hot(top_ids, E).float().mean(dim=(1, 2))
    aux = E * torch.mean(torch.sum(dispatch_frac * probs.mean(1), -1))

    order, slot, keep = moe_dispatch(top_ids, E, C)
    sw = torch.gather(top_w.reshape(B, S * K), 1, order)
    tok = order // K                                  # source token
    xg = torch.gather(x, 1, tok[..., None].expand(B, S * K, D))
    # dropped choices go to one spare row past the buffer, sliced off after:
    # fixed shapes, so nothing waits on the device for a count
    buf = x.new_zeros(B * E * C + 1, D)
    rows = torch.arange(B, device=x.device)[:, None] * (E * C) + slot
    rows = torch.where(keep, rows, B * E * C)
    buf.index_copy_(0, rows.reshape(-1), xg.reshape(-1, D))
    buf = buf[:-1].view(B, E, C, D).transpose(0, 1).reshape(E, B * C, D)
    # the rank's experts (EP), or its shard of every expert's hidden dim
    inner = None if shard.shards("expert") > 1 else "mlp"
    e0, e1 = shard.span("expert", E)
    buf = shard.enter(shard.enter(buf, "expert"), inner)[e0:e1]
    h = torch.bmm(buf, p["wg"])
    u = torch.bmm(buf, p["wu"])
    y = torch.bmm(F.silu(h) * u, p["wd"])             # (E, B * C, D)
    y = shard(y, "expert", None, "embed", partial=inner)
    y = shard(y, None, None, "embed", src=("expert", None, "embed"))
    y = y.view(E, B, C, D).transpose(0, 1).reshape(B, E * C, D)
    yg = torch.gather(y, 1, slot[..., None].expand(B, S * K, D))
    yg = yg * keep.to(x.dtype)[..., None] * sw.to(x.dtype)[..., None]
    # back to (token, k) places, then the K outputs in increasing expert id
    yk = torch.empty_like(yg).scatter_(
        1, order[..., None].expand(B, S * K, D), yg).view(B, S, K, D)
    by_expert = torch.argsort(top_ids, dim=-1)        # ids of a token differ
    yk = torch.gather(yk, 2, by_expert[..., None].expand(B, S, K, D))
    out = yk[:, :, 0]
    for j in range(1, K):
        out = out + yk[:, :, j]
    return shard(out, "batch", "seq", "embed",
                 src=("batch", None, "embed")), aux


def mlp_train(p: Params, x: torch.Tensor, cfg: ModelConfig,
              shard: Shard = identity_shard
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block's MLP output and its load-balancing aux loss (0 for a
    dense MLP or none), as the reference's ``mlp`` returns them."""
    if not p:
        return torch.zeros_like(x), x.new_zeros((), dtype=torch.float32)
    if cfg.moe is not None and "router" in p:
        return moe_mlp(p, x, cfg, shard)
    return dense_mlp(p, x, shard), x.new_zeros((), dtype=torch.float32)


def mlp(p: Params, x: torch.Tensor, cfg: ModelConfig,
        shard: Shard = identity_shard) -> torch.Tensor:
    """The block's MLP output (an empty ``p`` stands for none: zeros)."""
    if not p:
        return torch.zeros_like(x)
    if cfg.moe is not None and "router" in p:
        return moe_mlp(p, x, cfg, shard)[0]
    return dense_mlp(p, x, shard)


# ------------------------------------------------------- causal conv (SSM)
def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, C), w: (K, C)."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):           # K is tiny (4): unrolled adds, as the ref
        out = out + pad[:, i:i + S].float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def causal_conv1d_step(x_t: torch.Tensor, conv_state: torch.Tensor,
                       w: torch.Tensor, b: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. x_t: (B, C); conv_state: (B, K-1, C)."""
    full = torch.cat([conv_state, x_t[:, None]], dim=1)      # (B, K, C)
    y = torch.einsum("bkc,kc->bc", full.float(), w.float()) + b.float()
    return y.to(x_t.dtype), full[:, 1:]


# ------------------------------------------------------------- Mamba-2 SSD
def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., T) -> (..., T, T) with out[i, j] = sum_{k in (j, i]} x[k],
    -inf where i < j."""
    T = x.shape[-1]
    cs = torch.cumsum(x, -1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, -math.inf)


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked state-space-duality scan (Mamba-2, arXiv:2405.21060
    listing 1).

    xh: (B, S, H, P) dt: (B, S, H) A: (H,) < 0  Bm, Cm: (B, S, N).
    Returns (y (B, S, H, P), final_state (B, H, P, N) float32).
    """
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    nc = S // chunk
    if nc * chunk != S:
        raise ValueError(f"sequence {S} is no multiple of chunk {chunk}")
    x_ = (xh * dt[..., None]).reshape(Bsz, nc, chunk, H, P).float()
    dA = (dt * A).reshape(Bsz, nc, chunk, H)                 # (b, z, q, h)
    dA_cs = torch.cumsum(dA, dim=2)
    Bc = Bm.reshape(Bsz, nc, chunk, N).float()
    Cc = Cm.reshape(Bsz, nc, chunk, N).float()

    # (1) within-chunk ("diagonal block"), fp32 accumulation
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))           # (b, z, h, q, k)
    scores = torch.einsum("bzqn,bzkn->bzqk", Cc, Bc)
    y_diag = torch.einsum("bzhqk,bzkhp->bzqhp", L * scores[:, :, None], x_)

    # (2) per-chunk outgoing states
    decay_out = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)      # (b, z, q, h)
    states = torch.einsum("bzkn,bzkhp->bzhpn", Bc,
                          decay_out[..., None] * x_)

    # (3) inter-chunk recurrence: the state before each chunk
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])              # (b, z, h)
    carry = torch.zeros(Bsz, H, P, N, dtype=torch.float32,
                        device=xh.device) if init_state is None \
        else init_state.float()
    prev = []
    for z in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, z, :, None, None] + states[:, z]
    prev_states = torch.stack(prev, dim=1)                   # (b, z, h, p, n)

    # (4) within-chunk contribution of the incoming state
    decay_in = torch.exp(dA_cs)                              # (b, z, q, h)
    y_off = torch.einsum("bzqn,bzhpn->bzqhp", Cc, prev_states) \
        * decay_in[..., None]
    y = (y_diag + y_off).reshape(Bsz, S, H, P).to(xh.dtype)
    return y, carry


def ssd_step(x_t: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B_t: torch.Tensor, C_t: torch.Tensor, state: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step. x_t: (B, H, P) dt: (B, H) B_t, C_t: (B, N)
    state: (B, H, P, N) float32."""
    dA = torch.exp(dt * A)                                   # (B, H)
    upd = (dt[..., None] * x_t.float())[..., None] \
        * B_t.float()[:, None, None, :]
    state = state * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, C_t.float())
    return y.to(x_t.dtype), state


# ------------------------------------------------------------------ RG-LRU
def _rglru_coeffs(r: torch.Tensor, i: torch.Tensor, u: torch.Tensor,
                  lam: torch.Tensor, power: float):
    """(a, b) of h_t = a_t h_{t-1} + b_t, in float32."""
    log_a = -power * F.softplus(lam.float()) * r.float()
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6)) \
        * (i * u).float()
    return a, b


def rglru_scan(u: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
               lam: torch.Tensor, power: float,
               init_h: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Griffin RG-LRU over a sequence: u, r, i (B, S, W); lam (W,).
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t u_t),
    a_t = exp(-power softplus(lam) r_t).  A log-depth (Hillis-Steele)
    inclusive scan of the pairs (a, b) in float32.
    Returns (h (B, S, W) in u's dtype, final_h (B, W) float32)."""
    a, b = _rglru_coeffs(r, i, u, lam, power)
    if init_h is not None:
        b = b.clone()
        b[:, 0] = b[:, 0] + a[:, 0] * init_h.float()
    S, d = a.shape[1], 1
    while d < S:
        # (A, B)[t] = (A[t - d] A[t], A[t] B[t - d] + B[t]) for t >= d
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b.to(u.dtype), b[:, -1]


def rglru_step(u_t: torch.Tensor, r_t: torch.Tensor, i_t: torch.Tensor,
               lam: torch.Tensor, power: float, h: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step; u_t, r_t, i_t: (B, W); h: (B, W) float32."""
    a, b = _rglru_coeffs(r_t, i_t, u_t, lam, power)
    h = a * h + b
    return h.to(u_t.dtype), h
