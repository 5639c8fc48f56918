"""Declarative parameter table and initialisation for every architecture
family.

Counterpart of ``repro.models.params``: every parameter is described once by
a :class:`ParamSpec` (shape, logical axes, init rule), and
:func:`init_params` and :func:`count_params` derive from that one table.  The
tree has the reference's layout — ``{"embed", "final_norm", ["lm_head"],
["encoder"], "stages": [{"blocks": [{...}]}]}`` with a leading layers axis
on every stacked leaf — so weights carry across leaf for leaf
(:mod:`.convert`).  The block tables are the reference's: attention
(``attn``, ``lattn``), gated cross-attention (``xattn``), whisper's decoder
block (``wdec``), Mamba-2 (``ssd``), RG-LRU (``rglru``, with
block-diagonal gates where ``gate_blocks`` is set), dense or MoE MLPs, and
whisper's encoder.

The init rules and scales are the reference's: ``normal`` draws N(0, 1)
scaled by fan_in^-1/2, ``output`` further by (2 L)^-1/2, ``zeros`` and
``ones`` are constants.  The draws come from an explicit
``torch.Generator``, so they are not JAX's numbers: equality with the
reference goes through :func:`.convert.params_from_numpy`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch

from .config import ModelConfig, find_stages, torch_dtype

Pytree = Any


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones | output (scaled 1/sqrt(2L))
    fan_in_axes: Tuple[int, ...] = (0,)

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} vs logical {self.logical}")


# ------------------------------------------------------------- tree helpers
def tree_leaves(tree: Pytree, is_leaf: Callable[[Any], bool] = None
                ) -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs in JAX's flattening order: dict keys sorted,
    lists by index.  Paths read like ``jax.tree_util.keystr``."""
    if is_leaf is not None and is_leaf(tree):
        yield "", tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            for p, v in tree_leaves(tree[k], is_leaf):
                yield f"[{k!r}]{p}", v
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            for p, v in tree_leaves(sub, is_leaf):
                yield f"[{i}]{p}", v
    else:
        yield "", tree


def tree_map(fn: Callable, tree: Pytree, *rest: Pytree,
             is_leaf: Callable[[Any], bool] = None) -> Pytree:
    """Map ``fn`` over the leaves of ``tree`` (and of same-shaped ``rest``)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def _is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


# --------------------------------------------------------------------- table
def _mlp_specs(cfg: ModelConfig) -> Dict[str, Any]:
    D, F = cfg.d_model, cfg.d_ff
    if cfg.moe is not None:
        E = cfg.moe.num_experts
        return {
            "router": ParamSpec((D, E), ("embed", "expert")),
            "wg": ParamSpec((E, D, F), ("expert", "embed", "mlp"),
                            fan_in_axes=(1,)),
            "wu": ParamSpec((E, D, F), ("expert", "embed", "mlp"),
                            fan_in_axes=(1,)),
            "wd": ParamSpec((E, F, D), ("expert", "mlp", "embed"), "output",
                            fan_in_axes=(1,)),
        }
    return {
        "wg": ParamSpec((D, F), ("embed", "mlp")),
        "wu": ParamSpec((D, F), ("embed", "mlp")),
        "wd": ParamSpec((F, D), ("mlp", "embed"), "output"),
    }


def _attn_core_specs(cfg: ModelConfig) -> Dict[str, Any]:
    D, H, KH, dh = cfg.d_model, cfg.n_q, cfg.n_kv, cfg.d_head
    out: Dict[str, Any] = {
        "wq": ParamSpec((D, H, dh), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((D, KH, dh), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((D, KH, dh), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((H, dh, D), ("heads", "head_dim", "embed"), "output",
                        fan_in_axes=(0, 1)),
    }
    if cfg.qk_norm:
        out["q_norm"] = ParamSpec((dh,), ("norm",), "ones")
        out["k_norm"] = ParamSpec((dh,), ("norm",), "ones")
    return out


def _block_specs(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    D = cfg.d_model
    ln = lambda: ParamSpec((D,), ("norm",), "ones")
    if kind in ("attn", "lattn"):
        return {"ln": ln(), **_attn_core_specs(cfg), "ln2": ln(),
                "mlp": _mlp_specs(cfg)}
    if kind == "xattn":
        return {"ln": ln(), **_attn_core_specs(cfg),
                "xgate": ParamSpec((1,), ("norm",), "zeros"),
                "ln2": ln(), "mlp": _mlp_specs(cfg),
                "mgate": ParamSpec((1,), ("norm",), "zeros")}
    if kind == "wdec":  # whisper decoder block: self-attn + cross-attn + mlp
        return {"ln": ln(), **_attn_core_specs(cfg), "ln_x": ln(),
                "x": _attn_core_specs(cfg), "ln2": ln(),
                "mlp": _mlp_specs(cfg)}
    if kind == "ssd":
        s = cfg.ssm
        d_inner = s.expand * D
        H = d_inner // s.head_dim
        conv_dim = d_inner + 2 * s.d_state
        out = {
            "ln": ln(),
            "in_proj": ParamSpec((D, 2 * d_inner + 2 * s.d_state + H),
                                 ("embed", "ssm_inner")),
            "conv_w": ParamSpec((s.conv_width, conv_dim),
                                ("conv_w", "ssm_inner"), fan_in_axes=(0,)),
            "conv_b": ParamSpec((conv_dim,), ("ssm_inner",), "zeros"),
            "A_log": ParamSpec((H,), ("ssm_heads",), "ones"),
            "D": ParamSpec((H,), ("ssm_heads",), "ones"),
            "dt_bias": ParamSpec((H,), ("ssm_heads",), "zeros"),
            "norm": ParamSpec((d_inner,), ("ssm_inner",), "ones"),
            "out_proj": ParamSpec((d_inner, D), ("ssm_inner", "embed"),
                                  "output"),
        }
        if cfg.d_ff > 0:
            out["ln2"] = ln()
            out["mlp"] = _mlp_specs(cfg)
        return out
    if kind == "rglru":
        r = cfg.rglru
        W = r.width or D
        nb = r.gate_blocks
        if nb:
            if W % nb:
                raise ValueError(f"width {W} is no multiple of {nb} blocks")
            gate = lambda: ParamSpec((nb, W // nb, W // nb),
                                     ("rec_blocks", "rec_blk_in",
                                      "rec_blk_out"), fan_in_axes=(1,))
        else:
            gate = lambda: ParamSpec((W, W), ("rec_in", "rec"))
        return {
            "ln": ln(),
            "wx": ParamSpec((D, W), ("embed", "rec")),       # recurrent branch
            "wy": ParamSpec((D, W), ("embed", "rec")),       # gate branch
            "conv_w": ParamSpec((r.conv_width, W), ("conv_w", "rec"),
                                fan_in_axes=(0,)),
            "conv_b": ParamSpec((W,), ("rec",), "zeros"),
            "wa_gate": gate(),                               # recurrence gate
            "ba_gate": ParamSpec((W,), ("rec",), "zeros"),
            "wi_gate": gate(),                               # input gate
            "bi_gate": ParamSpec((W,), ("rec",), "zeros"),
            "Lambda": ParamSpec((W,), ("rec",), "ones"),
            "wout": ParamSpec((W, D), ("rec", "embed"), "output"),
            "ln2": ln(),
            "mlp": _mlp_specs(cfg),
        }
    raise ValueError(f"unknown layer kind {kind!r}")


def _encoder_block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    e = cfg.encoder
    D = cfg.d_model
    dh = D // e.n_heads
    ln = lambda: ParamSpec((D,), ("norm",), "ones")
    return {
        "ln": ln(),
        "wq": ParamSpec((D, e.n_heads, dh), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((D, e.n_heads, dh), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((D, e.n_heads, dh), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((e.n_heads, dh, D), ("heads", "head_dim", "embed"),
                        "output", fan_in_axes=(0, 1)),
        "ln2": ln(),
        "mlp": {
            "wg": ParamSpec((D, e.d_ff), ("embed", "mlp")),
            "wu": ParamSpec((D, e.d_ff), ("embed", "mlp")),
            "wd": ParamSpec((e.d_ff, D), ("mlp", "embed"), "output"),
        },
    }


def _stack_specs(tree: Pytree, repeat: int) -> Pytree:
    def stack(spec: ParamSpec) -> ParamSpec:
        return ParamSpec((repeat,) + spec.shape, ("layers",) + spec.logical,
                         spec.init, tuple(a + 1 for a in spec.fan_in_axes))
    return tree_map(stack, tree, is_leaf=_is_spec)


def param_table(cfg: ModelConfig) -> Dict[str, Any]:
    """Full tree of ParamSpec. Stage leaves carry a leading 'layers' axis."""
    D, V = cfg.d_model, cfg.vocab_padded
    table: Dict[str, Any] = {
        "embed": ParamSpec((V, D), ("vocab", "embed")),
        "final_norm": ParamSpec((D,), ("norm",), "ones"),
    }
    if not cfg.tie_embeddings:
        table["lm_head"] = ParamSpec((D, V), ("embed", "vocab"))
    table["stages"] = [
        {"blocks": [_stack_specs(_block_specs(cfg, k), st.repeat)
                    for k in st.block]}
        for st in find_stages(cfg.layer_pattern)]
    if cfg.encoder is not None:
        table["encoder"] = {
            "blocks": _stack_specs(_encoder_block_specs(cfg),
                                   cfg.encoder.n_layers),
            "final_norm": ParamSpec((D,), ("norm",), "ones"),
        }
    return table


# ------------------------------------------------------------ materializers
def _init_one(spec: ParamSpec, generator: torch.Generator, dtype,
              n_layers_total: int, device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    fan_in = 1
    for a in spec.fan_in_axes:
        fan_in *= spec.shape[a]
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    if spec.init == "output":  # residual-output scaling
        scale /= math.sqrt(2.0 * max(n_layers_total, 1))
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return x.mul_(scale).to(dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Pytree:
    """The parameter tree, drawn leaf by leaf (in JAX's leaf order) from
    ``generator``, which must live on ``device``."""
    device = torch.device(device) if device is not None \
        else generator.device
    dtype = torch_dtype(cfg.param_dtype)
    return tree_map(lambda s: _init_one(s, generator, dtype, cfg.n_layers,
                                        device),
                    param_table(cfg), is_leaf=_is_spec)


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Leaf path -> shape, in JAX's leaf order."""
    return {p: s.shape for p, s in tree_leaves(param_table(cfg), _is_spec)}


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Analytic parameter count; with ``active_only``, MoE expert weights
    count top_k / E of their size (the parameters a token runs through)."""
    total = 0
    for path, spec in tree_leaves(param_table(cfg), _is_spec):
        n = math.prod(spec.shape)
        if active_only and cfg.moe and "['mlp']" in path \
                and "expert" in spec.logical:
            n = n * cfg.moe.top_k // cfg.moe.num_experts
        total += n
    return total
