"""The models' training forward and loss, over a parameter tree that may
require grad.

Counterpart of the training half of ``repro.models.model``: the embedding
and unembedding as the loss uses them, ``encoder_forward`` (training use),
``_make_ctx_train``, ``_remat2_group``, ``run_stages_train``,
``_nll_of_chunk`` and ``loss_fn``, with :func:`value_and_grad` in the
place of ``jax.value_and_grad(loss_fn, has_aux=True)``.

:class:`.model.Model` serves from frozen weights and a compute-dtype copy
made once at load; these are plain functions of the reference-layout tree
(``cfg.param_dtype`` leaves).  Every cast to the compute dtype is an op of
the autograd graph, where the reference casts: the stage and encoder
matrices once a step (each layer then takes a view by ``unbind``), the
embedding at the lookup and again at the tied unembedding of each loss
chunk.  So each use's gradient reaches the parameter through its own cast,
in float32, as in JAX.

``remat`` is non-reentrant ``torch.utils.checkpoint`` around each layer
(each super-block of a stage) and each encoder layer; ``remat2`` (with
``remat``) checkpoints groups of ``_remat2_group(repeat)`` layers instead,
as the reference's outer scan does; the vocab-chunked loss checkpoints
each chunk.  Attention is :func:`.layers.gqa_attention`.

On a mesh (``shard`` a ``launch.sharding.Sharder`` with the train rules)
each rank computes on its rows of the batch (``batch`` over the data axes)
and, under sequence parallelism, its range of positions; every loss term
is summed over the ranks that split the tokens, and :func:`value_and_grad`
takes ``DTensor`` parameters and returns each gradient in its parameter's
placement.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from . import blocks
from .config import ModelConfig, find_stages, torch_dtype
from .layers import (Shard, attn_output, gqa_attention, identity_shard,
                     mlp_train, proj, rms_norm)
from .model import (NEG_LOGIT, _compute_copy, sinusoid_positions,
                    vocab_logits, vocab_lookup)
from .params import logical_specs, param_table, tree_map

Pytree = Any
Batch = Dict[str, torch.Tensor]


def _remat(fn, *args):
    """``jax.checkpoint``: the block's activations are recomputed in the
    backward pass (nothing in the graph draws random numbers)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _unstack(stacked: Pytree, repeat: int):
    """The per-layer trees of a stacked (layers, ...) tree: one ``unbind``
    of each leaf, whose backward stacks the layers' gradients."""
    parts = tree_map(lambda a: a.unbind(0), stacked)
    return [tree_map(lambda t: t[i], parts,
                     is_leaf=lambda t: isinstance(t, tuple))
            for i in range(repeat)]


def compute_view(params: Pytree, cfg: ModelConfig) -> Pytree:
    """The stages (and the encoder) with their matrices cast to the compute
    dtype inside the graph; vectors, the router and the conv taps as
    stored (the rule :class:`.model.Model` applies at load)."""
    table = param_table(cfg)
    cd = torch_dtype(cfg.compute_dtype)
    out = {"stages": _compute_copy(table["stages"], params["stages"], cd)}
    if cfg.encoder is not None:
        out["encoder"] = _compute_copy(table["encoder"], params["encoder"],
                                       cd)
    return out


# ---------------------------------------------------------------- embedding
def embed_tokens(params: Pytree, tokens: torch.Tensor,
                 cfg: ModelConfig, shard: Shard = identity_shard
                 ) -> torch.Tensor:
    """The lookup in the parameter dtype, then the cast (the reference's
    ``jnp.take`` then ``astype``)."""
    return vocab_lookup(params["embed"], tokens, cfg.vocab_padded,
                        shard).to(torch_dtype(cfg.compute_dtype))


def unembed(params: Pytree, x: torch.Tensor, cfg: ModelConfig,
            shard: Shard = identity_shard) -> torch.Tensor:
    """Final norm and logits (B, S, vocab_padded); the padding columns
    hold -1e30 so that they fall out of the log-sum-exp."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    tied = cfg.tie_embeddings
    logits = vocab_logits(x, params["embed" if tied else "lm_head"].to(
        x.dtype), tied, cfg, shard)
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab
        logits = logits.masked_fill(pad, NEG_LOGIT)
    return logits


# ------------------------------------------------------------------ encoder
def encoder_forward(params: Pytree, cp: Pytree, frames: torch.Tensor,
                    cfg: ModelConfig, shard: Shard = identity_shard
                    ) -> torch.Tensor:
    """Whisper-style bidirectional encoder over (stubbed) frame embeddings
    (B, T, D), each layer rematerialised under ``remat``."""
    x = frames.to(torch_dtype(cfg.compute_dtype))
    x = x + sinusoid_positions(x.shape[1], cfg.d_model,
                               x.device).to(x.dtype)
    B, T, _ = x.shape
    pos = torch.arange(T, dtype=torch.int32, device=x.device).expand(B, T)

    def body(xc, p):
        h = rms_norm(xc, p["ln"], cfg.norm_eps)
        hq, hk = shard.enter(h, "heads"), shard.enter(h, "kv_heads")
        o = gqa_attention(proj(hq, p["wq"]), proj(hk, p["wk"]),
                          proj(hk, p["wv"]), q_positions=pos,
                          k_positions=pos, causal=False, window=None,
                          q_chunk=cfg.q_chunk, scores_dtype=cfg.scores_dtype,
                          shard=shard, kv_layout="enc_seq")
        xc = xc + attn_output(p, o, shard)
        y, _ = mlp_train(p["mlp"], rms_norm(xc, p["ln2"], cfg.norm_eps), cfg,
                         shard)
        return xc + y

    for p in _unstack(cp["encoder"]["blocks"], cfg.encoder.n_layers):
        x = _remat(body, x, p) if cfg.remat else body(x, p)
    return rms_norm(x, params["encoder"]["final_norm"], cfg.norm_eps)


# ------------------------------------------------------------------- stages
def _make_ctx_train(cfg: ModelConfig, params: Pytree, cp: Pytree,
                    batch: Batch, S: int, B: int, device: torch.device,
                    shard: Shard = identity_shard) -> Dict[str, Any]:
    pos = torch.arange(S, dtype=torch.int32, device=device).expand(B, S)
    pos = shard(pos, "batch", "seq", src=("batch", None))
    ctx: Dict[str, Any] = {"positions": pos, "s_max": S}
    if cfg.encoder is not None:
        ctx["enc_out"] = encoder_forward(params, cp, batch["enc_frames"],
                                         cfg, shard)
    if cfg.vision is not None:
        ctx["img_embeds"] = batch["img_embeds"].to(
            torch_dtype(cfg.compute_dtype))
    return ctx


def _remat2_group(repeat: int) -> int:
    """Largest divisor of ``repeat`` not exceeding sqrt(repeat)."""
    g = int(math.isqrt(repeat))
    while g > 1 and repeat % g:
        g -= 1
    return max(g, 1)


def run_stages_train(cp: Pytree, x: torch.Tensor, ctx: Dict[str, Any],
                     cfg: ModelConfig, shard: Shard = identity_shard
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every layer over the whole sequence; returns (x, the summed aux
    loss).  The aux losses add up as the reference's scans add them: a
    super-block's in order, then the stage's stacked layers (or, under
    remat2, each group's, then the groups') in one sum."""
    aux_total = x.new_zeros((), dtype=torch.float32)
    for si, st in enumerate(find_stages(cfg.layer_pattern)):
        layers = _unstack(cp["stages"][si], st.repeat)

        def body(xc, lp, _st=st):
            aux = xc.new_zeros((), dtype=torch.float32)
            for j, kind in enumerate(_st.block):
                xc, a = blocks.TRAIN[kind](kind, lp["blocks"][j], xc, ctx,
                                           cfg, shard)
                aux = aux + a
            return xc, aux

        def group(xc, lps):
            auxs = []
            for lp in lps:
                xc, a = body(xc, lp)
                auxs.append(a)
            return xc, torch.stack(auxs).sum()

        g = _remat2_group(st.repeat) if (cfg.remat2 and cfg.remat) else 1
        auxs = []
        for k in range(0, st.repeat, g):
            if g > 1:      # remat^2: one rematerialised unit per group
                x, a = _remat(group, x, layers[k:k + g])
            elif cfg.remat:
                x, a = _remat(body, x, layers[k])
            else:
                x, a = body(x, layers[k])
            auxs.append(a)
        aux_total = aux_total + torch.stack(auxs).sum()
    return x, aux_total


# --------------------------------------------------------------------- loss
def _nll_of_chunk(params: Pytree, xc: torch.Tensor, lc: torch.Tensor,
                  mc: torch.Tensor, cfg: ModelConfig,
                  shard: Shard = identity_shard):
    """(sum of masked NLL, sum of masked lse^2) over a chunk of positions."""
    logits = unembed(params, xc, cfg, shard).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
    nll = lse - gold
    return torch.sum(nll * mc), torch.sum((lse ** 2) * mc)


def loss_fn(params: Pytree, batch: Batch, cfg: ModelConfig,
            aux_coef: float = 0.01, z_coef: float = 1e-4,
            shard: Shard = identity_shard
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token NLL over the masked positions, plus ``aux_coef``
    times the MoE aux loss and ``z_coef`` times the z-loss (the mean
    lse^2).  ``batch``: ``tokens`` and ``labels`` (B, S), optional
    ``loss_mask`` (B, S), and the frontends' ``enc_frames`` /
    ``img_embeds`` where the model has them.  Returns (loss, {"ce", "aux",
    "zloss", "ntokens"}).  On a mesh ``batch`` holds the rank's rows."""
    B, S = batch["tokens"].shape

    def own(t):       # the rank's positions (under sequence parallelism)
        return shard(t, "batch", "seq", src=("batch", None))

    tokens, labels = own(batch["tokens"]), own(batch["labels"])
    cp = compute_view(params, cfg)
    x = embed_tokens(params, tokens, cfg, shard)
    ctx = _make_ctx_train(cfg, params, cp, batch, S, B, x.device, shard)
    x, aux = run_stages_train(cp, x, ctx, cfg, shard)
    S = x.shape[1]
    mask = batch.get("loss_mask")
    mask = torch.ones(B, S, dtype=torch.float32, device=x.device) \
        if mask is None else own(mask.float())
    ntok = torch.clamp(shard.token_sum(torch.sum(mask)), min=1.0)
    # vocab-chunked loss: the (B, S, V) float32 logits never exist for the
    # whole sequence at once
    C = cfg.loss_chunk
    if S > C and S % C == 0:
        parts = [_remat(_nll_of_chunk, params, x[:, c:c + C],
                        labels[:, c:c + C], mask[:, c:c + C], cfg, shard)
                 for c in range(0, S, C)]
        nll_sum = torch.stack([n for n, _ in parts]).sum()
        z_sum = torch.stack([z for _, z in parts]).sum()
    else:
        nll_sum, z_sum = _nll_of_chunk(params, x, labels, mask, cfg, shard)
    ce = shard.token_sum(nll_sum) / ntok
    zloss = shard.token_sum(z_sum) / ntok
    if shard.token_shards > 1:    # a batch mean, each rank's rows' share
        aux = shard.token_sum(aux / shard.token_shards)
    loss = ce + aux_coef * aux + z_coef * zloss
    return loss, {"ce": ce, "aux": aux, "zloss": zloss, "ntokens": ntok}


def value_and_grad(params: Pytree, batch: Batch, cfg: ModelConfig,
                   shard: Shard = identity_shard, **loss_kw
                   ) -> Tuple[Tuple[torch.Tensor, Dict], Pytree]:
    """((loss, metrics), grads): the gradient of :func:`loss_fn` with
    respect to every leaf of ``params`` (zeros where a leaf is unused), in
    the leaf's dtype; ``params`` itself is left as it is.  On a mesh every
    leaf is a ``DTensor``: it is computed with in the layout
    ``shard.param`` gives it, and its gradient comes back in the leaf's
    placement."""
    leaves = []

    def track(t, logical):
        leaves.append(shard.param(t, logical).detach().requires_grad_())
        return leaves[-1]

    logical = logical_specs(cfg)
    tree = tree_map(track, params, logical)
    loss, metrics = loss_fn(tree, batch, cfg, shard=shard, **loss_kw)
    grads = iter([torch.zeros_like(t) if g is None else g for t, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))])

    def placed(t, lg):
        g = shard.param_grad(next(grads), t, lg)
        if not hasattr(t, "placements"):
            return g
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(g, t.device_mesh, t.placements,
                                  run_check=False)

    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), \
        tree_map(placed, params, logical)
