"""Model assembly for serving: embedding, layers, unembedding, caches.

Counterpart of ``repro.models.model`` for the dense ``attn`` family
(``embed_tokens``, ``unembed``, ``prefill``, ``decode_step``,
``cache_table``, ``init_cache``, ``cache_logical_specs``).  The reference
scans each stage with ``lax.scan``; PyTorch runs eagerly, so the layers are
a Python loop over views into the stacked parameters.

The parameter and cache trees keep the reference's layout, with a leading
layers axis per stage:
  params: {"embed", "final_norm", ["lm_head"], "stages": [{"blocks": [...]}]}
  cache:  {"pos", "stages": [{"blocks": [{"k", "v"}]}]}
``pos`` is a 0-dim int32 tensor on the device, never read back by a step.
Unlike the reference's pure functions, ``decode_step`` updates the cache in
place and returns it.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from . import blocks
from .config import ModelConfig, find_stages, torch_dtype
from .layers import rms_norm
from .params import ParamSpec, param_table, tree_leaves, tree_map

Pytree = Any
NEG_LOGIT = -1e30


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    shape: Tuple[int, ...]
    dtype: torch.dtype
    logical: Tuple[Optional[str], ...]


def _block_cache_spec(cfg: ModelConfig, kind: str, B: int,
                      s_max: int) -> Dict[str, CacheSpec]:
    if kind != "attn":
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet "
                                  f"(ROADMAP.md A11)")
    cd = torch_dtype(cfg.compute_dtype)
    kv_logical = ("batch", "kv_seq", "kv_heads", "head_dim")
    shape = (B, s_max, cfg.n_kv, cfg.d_head)
    return {"k": CacheSpec(shape, cd, kv_logical),
            "v": CacheSpec(shape, cd, kv_logical)}


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


def init_cache(cfg: ModelConfig, B: int, s_max: int, device=None) -> Pytree:
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device),
                    cache_table(cfg, B, s_max), is_leaf=_is_cache_spec)


def cache_logical_specs(cfg: ModelConfig, B: int, s_max: int) -> Pytree:
    return tree_map(lambda s: s.logical, cache_table(cfg, B, s_max),
                    is_leaf=_is_cache_spec)


class Model(nn.Module):
    """A decoder of ``attn`` blocks over a parameter tree.

    ``params`` is the reference-layout tree of ``cfg.param_dtype`` tensors
    (from :func:`.params.init_params` or :func:`.convert.params_from_numpy`),
    all on one device; the module registers each leaf as a frozen
    parameter.  Matrices are also kept once in ``cfg.compute_dtype`` (the
    same tensor when the two dtypes agree), which rounds exactly as the
    reference's per-einsum ``.astype``; norm scales stay in the parameter
    dtype and are read in float32.
    """

    def __init__(self, cfg: ModelConfig, params: Pytree):
        super().__init__()
        self.cfg = cfg
        table = param_table(cfg)
        self.params = params
        for path, leaf in tree_leaves(params):   # e.g. stages_0_blocks_0_wq
            self.register_parameter(re.sub(r"\W+", "_", path).strip("_"),
                                    nn.Parameter(leaf, requires_grad=False))
        cd = torch_dtype(cfg.compute_dtype)
        self.compute = tree_map(
            lambda spec, t: t if spec.logical[-1] == "norm" else t.to(cd),
            table, params, is_leaf=lambda x: isinstance(x, ParamSpec))
        # (stage, block, layer index, layer params) in execution order
        self.layers = []
        for si, st in enumerate(find_stages(cfg.layer_pattern)):
            for i in range(st.repeat):
                for j in range(len(st.block)):
                    lp = tree_map(lambda a: a[i],
                                  self.compute["stages"][si]["blocks"][j])
                    self.layers.append((si, j, i, lp))
        self._tables: Dict[Tuple[int, int], torch.Tensor] = {}

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    # ------------------------------------------------------------ embedding
    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.compute["embed"][tokens.long()]

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = rms_norm(x, self.compute["final_norm"], cfg.norm_eps)
        if cfg.tie_embeddings:
            logits = x @ self.compute["embed"].t()
        else:
            logits = x @ self.compute["lm_head"]
        if cfg.vocab_padded != cfg.vocab:  # mask the padding out of argmax
            logits[..., cfg.vocab:] = NEG_LOGIT
        return logits

    def init_cache(self, B: int, s_max: int) -> Pytree:
        return init_cache(self.cfg, B, s_max, self.device)

    def _layer_cache(self, cache: Pytree, si: int, j: int, i: int):
        c = cache["stages"][si]["blocks"][j]
        return {"k": c["k"][i], "v": c["v"][i]}

    # -------------------------------------------------------------- serving
    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, s_max: int
                ) -> Tuple[torch.Tensor, Pytree]:
        """Logits of the last prompt token (B, vocab_padded) and a fresh
        decode cache holding the prompt."""
        B, S = tokens.shape
        x = self.embed_tokens(tokens)
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
        cache = self.init_cache(B, s_max)
        for si, j, i, lp in self.layers:
            x = blocks.attn_prefill(lp, x, self._layer_cache(cache, si, j, i),
                                    positions, self.cfg)
        cache["pos"] = torch.tensor(S, dtype=torch.int32, device=x.device)
        return self.unembed(x[:, -1:])[:, 0], cache

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
        B = tokens.shape[0]
        x = self.embed_tokens(tokens)
        tables = {}
        for si, j, i, lp in self.layers:
            lc = self._layer_cache(cache, si, j, i)
            s_cache = lc["k"].shape[1]
            if s_cache not in tables:
                lengths = torch.clamp(pos + 1, max=s_cache).to(
                    torch.int32).expand(B).contiguous()
                tables[s_cache] = (self._block_table(B, s_cache), lengths)
            x = blocks.attn_decode(lp, lc, x, pos, *tables[s_cache],
                                   self.cfg)
        cache["pos"] = pos + 1
        return self.unembed(x)[:, 0], cache
