"""Model assembly for serving: embedding, the encoder, layers, unembedding,
caches.

Counterpart of ``repro.models.model`` (``embed_tokens``, ``unembed``,
``sinusoid_positions``, ``encoder_forward``, ``prefill``, ``decode_step``,
``cache_table``, ``init_cache``, ``cache_logical_specs``) for every layer
kind.  The reference scans each stage with ``lax.scan``; PyTorch runs
eagerly, so the layers are a Python loop over views into the stacked
parameters.

The parameter and cache trees keep the reference's layout, with a leading
layers axis per stage:
  params: {"embed", "final_norm", ["lm_head"], ["encoder"],
           "stages": [{"blocks": [...]}]}
  cache:  {"pos", "stages": [{"blocks": [{leaf: (layers, B, ...)}]}]}
``pos`` is a 0-dim int32 tensor on the device, never read back by a step.
Unlike the reference's pure functions, ``decode_step`` updates the cache in
place and returns it.

On a mesh (``shard`` a ``launch.sharding.Sharder`` with the decode rules,
which the reference's engine also passes to prefill and decode alike) the
model keeps each rank's shard of every weight and cache: ``prefill`` and
``decode_step`` take and return the whole batch (the rank computes its
rows of it) while the cache stays the rank's.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..core.engine import resolve_device
from ..kernels import ops
from . import blocks
from .config import ModelConfig, find_stages, torch_dtype
from .layers import (Shard, attn_output, identity_shard, mlp, proj,
                     rms_norm)
from .params import (ParamSpec, logical_specs, param_table, tree_leaves,
                     tree_map)

Pytree = Any
NEG_LOGIT = -1e30
# matrices the reference reads in float32 (the router's logits, the conv
# taps): kept in the parameter dtype like every vector
_PARAM_DTYPE_MATRICES = ("router", "conv_w")


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    shape: Tuple[int, ...]
    dtype: torch.dtype
    logical: Tuple[Optional[str], ...]


def _block_cache_spec(cfg: ModelConfig, kind: str, B: int,
                      s_max: int) -> Dict[str, CacheSpec]:
    cd = torch_dtype(cfg.compute_dtype)
    KH, dh = cfg.n_kv, cfg.d_head
    kv_logical = ("batch", "kv_seq", "kv_heads", "head_dim")
    enc_logical = ("batch", "enc_seq", "kv_heads", "head_dim")
    if kind in ("attn", "lattn"):
        sc = min(cfg.window, s_max) if kind == "lattn" else s_max
        return {"k": CacheSpec((B, sc, KH, dh), cd, kv_logical),
                "v": CacheSpec((B, sc, KH, dh), cd, kv_logical)}
    if kind == "xattn":
        T = cfg.vision.n_img_tokens
        return {"k": CacheSpec((B, T, KH, dh), cd, enc_logical),
                "v": CacheSpec((B, T, KH, dh), cd, enc_logical)}
    if kind == "wdec":
        T = cfg.encoder.seq_len
        return {"k": CacheSpec((B, s_max, KH, dh), cd, kv_logical),
                "v": CacheSpec((B, s_max, KH, dh), cd, kv_logical),
                "xk": CacheSpec((B, T, KH, dh), cd, enc_logical),
                "xv": CacheSpec((B, T, KH, dh), cd, enc_logical)}
    if kind == "ssd":
        s = cfg.ssm
        d_inner = s.expand * cfg.d_model
        H = d_inner // s.head_dim
        return {"state": CacheSpec((B, H, s.head_dim, s.d_state),
                                   torch.float32,
                                   ("batch", "ssm_heads", "head_dim",
                                    "ssm_state")),
                "conv": CacheSpec((B, s.conv_width - 1,
                                   d_inner + 2 * s.d_state), cd,
                                  ("batch", None, "ssm_inner"))}
    if kind == "rglru":
        W = cfg.rglru.width or cfg.d_model
        return {"h": CacheSpec((B, W), torch.float32, ("batch", "rec")),
                "conv": CacheSpec((B, cfg.rglru.conv_width - 1, W), cd,
                                  ("batch", None, "rec"))}
    raise ValueError(f"unknown layer kind {kind!r}")


def cache_table(cfg: ModelConfig, B: int, s_max: int) -> Pytree:
    out: List[Pytree] = []
    for st in find_stages(cfg.layer_pattern):
        blocks_specs = []
        for kind in st.block:
            spec = _block_cache_spec(cfg, kind, B, s_max)
            blocks_specs.append({
                k: CacheSpec((st.repeat,) + v.shape, v.dtype,
                             ("layers",) + v.logical)
                for k, v in spec.items()})
        out.append({"blocks": blocks_specs})
    return {"stages": out, "pos": CacheSpec((), torch.int32, ())}


def _is_cache_spec(x) -> bool:
    return isinstance(x, CacheSpec)


def init_cache(cfg: ModelConfig, B: int, s_max: int, device=None,
               shard: Shard = identity_shard) -> Pytree:
    """A zeroed decode cache on ``device`` (``cuda:0`` unless ``"cpu"``):
    on a mesh, the rank's shard of it."""
    device = resolve_device(device)
    return tree_map(lambda s: torch.zeros(shard.local_shape(s.shape,
                                                            s.logical),
                                          dtype=s.dtype, device=device),
                    cache_table(cfg, B, s_max), is_leaf=_is_cache_spec)


def cache_logical_specs(cfg: ModelConfig, B: int, s_max: int) -> Pytree:
    return tree_map(lambda s: s.logical, cache_table(cfg, B, s_max),
                    is_leaf=_is_cache_spec)


def sinusoid_positions(T: int, D: int, device=None) -> torch.Tensor:
    """(T, D) float32 sin/cos position table of the encoder."""
    half = D // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=device) / max(half - 1, 1))
    ang = torch.arange(T, dtype=torch.float32, device=device)[:, None] \
        * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[:, :D]


def vocab_lookup(table: torch.Tensor, tokens: torch.Tensor, n_vocab: int,
                 shard: Shard = identity_shard) -> torch.Tensor:
    """Rows of the embedding ``table`` (the rank's vocab rows on a mesh:
    each token is looked up by the rank that holds it, the others add
    zeros)."""
    v0, v1 = shard.span("vocab", n_vocab)
    if v1 - v0 == n_vocab:
        return table[tokens.long()]
    t = tokens.long() - v0
    mine = ((t >= 0) & (t < v1 - v0))[..., None]
    x = torch.where(mine, table[t.clamp(0, v1 - v0 - 1)], 0)
    return shard(x, "batch", "seq", "embed", partial="vocab")


def vocab_logits(x: torch.Tensor, table: torch.Tensor, tied: bool,
                 cfg: ModelConfig, shard: Shard = identity_shard
                 ) -> torch.Tensor:
    """Logits over the whole padded vocab from the final-normed ``x``
    (the rank's vocab columns gathered)."""
    x = shard.enter(x, "vocab")
    logits = x @ table.t() if tied else x @ table
    return shard(logits, "batch", "seq", None, src=("batch", "seq", "vocab"))


def _compute_copy(table: Pytree, params: Pytree, cd: torch.dtype,
                  name: str = "") -> Pytree:
    """The parameter tree as computed with: matrices in the compute dtype,
    vectors and ``_PARAM_DTYPE_MATRICES`` as stored."""
    if isinstance(table, ParamSpec):
        dims = [a for a in table.logical if a != "layers"]
        if len(dims) >= 2 and name not in _PARAM_DTYPE_MATRICES:
            return params.to(cd)
        return params
    if isinstance(table, dict):
        return {k: _compute_copy(table[k], params[k], cd, k) for k in table}
    return [_compute_copy(t, p, cd, name) for t, p in zip(table, params)]


class Model(nn.Module):
    """A decoder of any of the reference's layer kinds (and whisper's
    encoder) over a parameter tree.

    ``params`` is the reference-layout tree of ``cfg.param_dtype`` tensors
    (from :func:`.params.init_params` or :func:`.convert.params_from_numpy`),
    all on one device, or their ``DTensor`` placements on ``shard``'s mesh;
    the module keeps the rank's shard of each leaf that ``shard`` computes
    with, and registers each as a frozen parameter.  Matrices are also kept once in ``cfg.compute_dtype`` (the
    same tensor when the two dtypes agree), which rounds exactly as the
    reference's per-einsum ``.astype``; vectors, the router and the conv
    taps stay in the parameter dtype and are cast where the reference
    casts them.
    """

    def __init__(self, cfg: ModelConfig, params: Pytree,
                 shard: Shard = identity_shard):
        super().__init__()
        if shard.shards("seq") > 1 or (shard.shards("heads") > 1
                                       and shard.shards("kv_heads") == 1):
            raise ValueError("serving takes the decode rules "
                             "(make_rules(cfg, mesh, 'decode', ...)): one "
                             "cache layout for prefill and decode")
        self.cfg = cfg
        self.shard = shard
        params = tree_map(shard.param, params, logical_specs(cfg))
        self.params = params
        for path, leaf in tree_leaves(params):   # e.g. stages_0_blocks_0_wq
            self.register_parameter(re.sub(r"\W+", "_", path).strip("_"),
                                    nn.Parameter(leaf, requires_grad=False))
        self.compute = _compute_copy(param_table(cfg), params,
                                     torch_dtype(cfg.compute_dtype))
        # (kind, stage, block, layer index, layer params) in execution order
        self.layers = []
        for si, st in enumerate(find_stages(cfg.layer_pattern)):
            for i in range(st.repeat):
                for j, kind in enumerate(st.block):
                    lp = tree_map(lambda a: a[i],
                                  self.compute["stages"][si]["blocks"][j])
                    self.layers.append((kind, si, j, i, lp))
        self.encoder_layers = []
        if cfg.encoder is not None:
            enc = self.compute["encoder"]["blocks"]
            self.encoder_layers = [tree_map(lambda a: a[i], enc)
                                   for i in range(cfg.encoder.n_layers)]
        self._tables: Dict[Tuple[int, int], torch.Tensor] = {}

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    # ------------------------------------------------------------ embedding
    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return vocab_lookup(self.compute["embed"], tokens,
                            self.cfg.vocab_padded, self.shard)

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = rms_norm(x, self.compute["final_norm"], cfg.norm_eps)
        tied = cfg.tie_embeddings
        logits = vocab_logits(x, self.compute["embed" if tied else "lm_head"],
                              tied, cfg, self.shard)
        if cfg.vocab_padded != cfg.vocab:  # mask the padding out of argmax
            logits[..., cfg.vocab:] = NEG_LOGIT
        return logits

    def _rows(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's rows of a whole batch."""
        return self.shard(t, "batch", *(None,) * (t.dim() - 1),
                          src=(None,) * t.dim())

    def _all_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The whole batch from every rank's rows."""
        return self.shard(t, *(None,) * t.dim(),
                          src=("batch",) + (None,) * (t.dim() - 1))

    def encoder_forward(self, frames: torch.Tensor) -> torch.Tensor:
        """Whisper-style bidirectional encoder over (stubbed) frame
        embeddings (B, T, D): every layer's attention non-causal through
        ``flash_attention``."""
        cfg, shard = self.cfg, self.shard
        x = frames.to(torch_dtype(cfg.compute_dtype))
        x = x + sinusoid_positions(x.shape[1], cfg.d_model,
                                   x.device).to(x.dtype)
        for p in self.encoder_layers:
            h = rms_norm(x, p["ln"], cfg.norm_eps)
            hq, hk = shard.enter(h, "heads"), shard.enter(h, "kv_heads")
            o = ops.flash_attention(proj(hq, p["wq"]).contiguous(),
                                    proj(hk, p["wk"]).contiguous(),
                                    proj(hk, p["wv"]).contiguous(),
                                    causal=False)
            x = x + attn_output(p, o, shard)
            x = x + mlp(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg,
                        shard)
        return rms_norm(x, self.compute["encoder"]["final_norm"],
                        cfg.norm_eps)

    def init_cache(self, B: int, s_max: int) -> Pytree:
        """The rank's shard of a zeroed cache of ``B`` rows."""
        return init_cache(self.cfg, B, s_max, self.device, self.shard)

    @staticmethod
    def _layer_cache(cache: Pytree, si: int, j: int, i: int):
        return {k: t[i] for k, t in cache["stages"][si]["blocks"][j].items()}

    # -------------------------------------------------------------- serving
    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, s_max: int,
                extras: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Pytree]:
        """Logits of the last prompt token (B, vocab_padded) and a fresh
        decode cache holding the prompt.  ``extras`` carries the
        modality frontends' stubbed embeddings where the model has them:
        ``enc_frames`` (B, T, D) for an encoder, ``img_embeds`` (B, T, D)
        for cross-attention image layers."""
        cfg = self.cfg
        extras = {k: self._rows(v) for k, v in (extras or {}).items()}
        cache = self.init_cache(tokens.shape[0], s_max)
        tokens = self._rows(tokens)
        B, S = tokens.shape
        x = self.embed_tokens(tokens)
        ctx: Dict[str, Any] = {"positions": torch.arange(
            S, dtype=torch.int32, device=x.device).expand(B, S)}
        if cfg.encoder is not None:
            ctx["enc_out"] = self.encoder_forward(extras["enc_frames"])
        if cfg.vision is not None:
            ctx["img_embeds"] = extras["img_embeds"].to(x.dtype)
        for kind, si, j, i, lp in self.layers:
            x = blocks.PREFILL[kind](kind, lp, x,
                                     self._layer_cache(cache, si, j, i), ctx,
                                     cfg, self.shard)
        cache["pos"] = torch.tensor(S, dtype=torch.int32, device=x.device)
        return self._all_rows(self.unembed(x[:, -1:])[:, 0]), cache

    def _block_table(self, B: int, s_cache: int) -> torch.Tensor:
        """The identity block table of the decode view (cached)."""
        key = (B, s_cache)
        if key not in self._tables:
            n = s_cache // blocks.decode_page(s_cache)
            self._tables[key] = torch.arange(
                B * n, dtype=torch.int32, device=self.device).view(B, n)
        return self._tables[key]

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: Pytree
                    ) -> Tuple[torch.Tensor, Pytree]:
        """tokens: (B, 1) at position ``cache["pos"]``.  Writes the cache in
        place; returns the logits (B, vocab_padded) and the cache with
        ``pos`` advanced."""
        pos = cache["pos"]
        tokens = self._rows(tokens)
        B = tokens.shape[0]
        x = self.embed_tokens(tokens)
        tables: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        ctx = {"pos": pos, "tables": tables}
        for kind, si, j, i, lp in self.layers:
            lc = self._layer_cache(cache, si, j, i)
            if kind in blocks.SELF_ATTN_KINDS:
                s_local = lc["k"].shape[1]   # a block table per ring extent
                if s_local not in tables:
                    s_cache = s_local * self.shard.shards("kv_seq")
                    lengths = torch.clamp(pos + 1, max=s_cache)
                    if s_local != s_cache:   # the rank's range of the ring
                        lo = self.shard.span("kv_seq", s_cache)[0]
                        lengths = torch.clamp(lengths - lo, 0, s_local)
                    tables[s_local] = (self._block_table(B, s_local),
                                       lengths.to(torch.int32).expand(
                                           B).contiguous())
            x = blocks.DECODE[kind](kind, lp, lc, x, ctx, self.cfg,
                                    self.shard)
        cache["pos"] = pos + 1
        return self._all_rows(self.unembed(x)[:, 0]), cache
