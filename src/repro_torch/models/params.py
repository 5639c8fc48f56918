"""Declarative parameter table and initialisation for the dense ``attn``
family.

Counterpart of ``repro.models.params``: every parameter is described once by
a :class:`ParamSpec` (shape, logical axes, init rule), and
:func:`init_params` and :func:`count_params` derive from that one table.  The
tree has the reference's layout — ``{"embed", "final_norm", ["lm_head"],
"stages": [{"blocks": [{...}]}]}`` with a leading layers axis on every stage
leaf — so weights carry across leaf for leaf (:mod:`.convert`).

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
        raise NotImplementedError("MoE MLPs are not ported yet: ROADMAP.md "
                                  "A11 step 3")
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
    if kind != "attn":
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet "
                                  f"(ROADMAP.md A11)")
    ln = lambda: ParamSpec((D,), ("norm",), "ones")
    return {"ln": ln(), **_attn_core_specs(cfg), "ln2": ln(),
            "mlp": _mlp_specs(cfg)}


def _stack_specs(tree: Pytree, repeat: int) -> Pytree:
    def stack(spec: ParamSpec) -> ParamSpec:
        return ParamSpec((repeat,) + spec.shape, ("layers",) + spec.logical,
                         spec.init, tuple(a + 1 for a in spec.fan_in_axes))
    return tree_map(stack, tree, is_leaf=_is_spec)


def param_table(cfg: ModelConfig) -> Dict[str, Any]:
    """Full tree of ParamSpec. Stage leaves carry a leading 'layers' axis."""
    if cfg.encoder is not None:
        raise NotImplementedError("encoders are not ported yet: ROADMAP.md "
                                  "A11 step 6")
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


def count_params(cfg: ModelConfig) -> int:
    """Analytic parameter count."""
    return sum(math.prod(s) for s in param_shapes(cfg).values())
