"""Logical-axis -> mesh-axis rules, parameter placement, and the activation
Sharder.

Counterpart of ``repro.launch.sharding``.  :func:`make_rules` and
:func:`spec_for` are the reference's, pure functions of the config and the
mesh's shape (the same tables key for key; ``spec_for`` returns the
reference's ``PartitionSpec`` entries as a tuple):

  * heads/kv_heads/expert shard over 'model' only when divisible;
  * decode KV caches shard their *sequence* dim over 'model' whenever the
    kv head count cannot use the axis (flash-decoding: the softmax
    statistics of each rank's pages merge by two small all-reduces);
  * train/prefill shard the query sequence over 'model' where the heads
    cannot use it (sequence parallelism, SP);
  * batch=1 cells fold the idle 'data' axis into the cache sequence.

Parameters are ``DTensor`` leaves placed by :func:`placements` of their spec
(FSDP over the data axes, ``"embed": dp``, and TP over 'model').  The
model computes on local tensors: :class:`Sharder` gives each leaf the
layout its computation needs (``param``: the data axes gathered, 'model'
kept where the activations' rules split the same dim) and returns each
gradient to its leaf's placement (``param_grad``: summed over the axes
that split the tokens, then cut to the leaf's shard).  Between layers a
layout changes only at a Sharder call, with the layout named on both
sides (``src`` and the target) or a pending partial sum named
(``partial``).  An axis of size 1 never enters a Sharder's tables, so on a
one-rank mesh every call finds nothing to do: the same code runs on one
rank and on four, at the cost of a comparison.

The gradient of an activation stays complete for the layout it has, with
one convention per axis: along an axis that splits the tokens (the batch
over the data axes, the sequence over 'model' under SP) each rank's
gradient is its own tokens' share, and parameters sum them; along a
tensor-parallel axis a replicated tensor that meets rank-dependent work
passes :meth:`Sharder.enter` (identity forward, all-reduce backward) and a
contraction over a split dim is summed by ``partial``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..models.config import ModelConfig
from ..models.layers import IdentityShard
from ..models.params import tree_map
from .mesh import axis_sizes, dp_axes

Rules = Dict[str, Union[None, str, Tuple[str, ...]]]
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

__all__ = ["Rules", "make_rules", "spec_for", "placements", "tree_shardings",
           "Sharder", "place", "place_tree", "full_tensor", "full_tree"]


def make_rules(cfg: ModelConfig, mesh, mode: str = "train",
               global_batch: int = 0, seq_len: int = 0
               ) -> Tuple[Rules, Rules]:
    """Returns (param_rules, act_rules)."""
    axes = axis_sizes(mesh)
    model = "model" if "model" in axes else None
    msize = axes.get("model", 1)
    dp = dp_axes(mesh)
    dpsize = 1
    for a in dp:
        dpsize *= axes[a]

    def div(n: int):
        return model if (model and n and n % msize == 0) else None

    rec_width = (cfg.rglru.width or cfg.d_model) if cfg.rglru else 0
    param_rules: Rules = {
        "vocab": model,
        "embed": dp,                       # FSDP/ZeRO over the data axes
        "mlp": model,
        "heads": div(cfg.n_q),
        "kv_heads": div(cfg.n_kv),
        "head_dim": None,
        "expert": div(cfg.moe.num_experts) if cfg.moe else None,
        "ssm_inner": None,
        "ssm_heads": None,
        "ssm_state": None,
        "rec": div(rec_width),
        "rec_in": None,
        "rec_blocks": div(cfg.rglru.gate_blocks) if cfg.rglru else None,
        "rec_blk_in": None,
        "rec_blk_out": None,
        "conv_w": None,
        "norm": None,
        "layers": None,
        "enc_seq": None,
    }

    batch_rule: Union[None, Tuple[str, ...]] = dp
    if global_batch and dpsize and global_batch % dpsize != 0:
        batch_rule = None  # e.g. long_500k's global_batch=1
    heads_rule = div(cfg.n_q)
    # sequence parallelism where the heads cannot use the model axis
    sp = (mode in ("train", "prefill") and heads_rule is None and model
          and seq_len and seq_len % msize == 0)
    seq_rule = model if sp else None
    # KV caches shard their sequence where the raw KV head count cannot
    # use the model axis; decode then keeps the query heads replicated
    kv_seq: Union[None, str, Tuple[str, ...]] = None
    att_kv_seq: Union[None, str, Tuple[str, ...]] = None
    if mode in ("prefill", "decode") and div(cfg.n_kv) is None:
        kv_seq = model
        if batch_rule is None:
            kv_seq = dp + (model,) if model else dp
        if mode == "decode":
            att_kv_seq = kv_seq
            heads_rule = None
    act_rules: Rules = {
        "batch": batch_rule,
        "seq": seq_rule,
        "embed": None,
        "mlp": model,
        "heads": heads_rule,
        "kv_heads": div(cfg.n_kv),
        "head_dim": None,
        "vocab": model,
        "expert": div(cfg.moe.num_experts) if cfg.moe else None,
        "kv_seq": kv_seq,
        "att_kv_seq": att_kv_seq,
        "enc_seq": None,
        "ssm_inner": None,
        "ssm_heads": None,
        "ssm_state": None,
        "rec": div(rec_width),
        "rec_in": None,
        "rec_blocks": div(cfg.rglru.gate_blocks) if cfg.rglru else None,
        "rec_blk_in": None,
        "rec_blk_out": None,
        "layers": None,
        "conv_w": None,
    }
    return param_rules, act_rules


def _names(m) -> Tuple[str, ...]:
    if m is None:
        return ()
    return (m,) if isinstance(m, str) else tuple(m)


def spec_for(logical: Sequence[Optional[str]], rules: Rules) -> Spec:
    """Mesh axes per dim, greedily left to right, never one axis twice:
    the reference's ``PartitionSpec`` entries (``None``, an axis name, or a
    tuple of them)."""
    used: set = set()
    parts: List[Union[None, str, Tuple[str, ...]]] = []
    for name in logical:
        ms = tuple(a for a in _names(rules.get(name) if name is not None
                                     else None) if a not in used)
        if not ms:
            parts.append(None)
        else:
            used.update(ms)
            parts.append(ms[0] if len(ms) == 1 else ms)
    return tuple(parts)


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim ``d`` that names it, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    out = []
    for a in names:
        dims = [d for d, part in enumerate(spec) if a in _names(part)]
        out.append(Shard(dims[0]) if dims else Replicate())
    for part in spec:      # nested shards follow the mesh's axis order
        ms = _names(part)
        if list(ms) != sorted(ms, key=names.index):
            raise ValueError(f"spec {spec} splits a dim over axes out of "
                             f"the mesh's order {names}")
    return out


def tree_shardings(logical_tree: Any, mesh, rules: Rules) -> Any:
    """A tree of logical-axis tuples -> a tree of DTensor placements."""
    return tree_map(lambda lg: placements(spec_for(lg, rules), mesh),
                    logical_tree, is_leaf=lambda x: isinstance(x, tuple))


# ------------------------------------------------------------- collectives
def _all_gather(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def _all_reduce(x: torch.Tensor, groups, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    x = x.clone(memory_format=torch.contiguous_format)
    for g in groups:
        dist.all_reduce(x, op=op, group=g)
    return x


def _chunk(x: torch.Tensor, dim: int, axes) -> torch.Tensor:
    """This rank's chunk of ``dim`` over ``axes`` ((group, size, coord),
    the first major)."""
    n, idx = 1, 0
    for _, size, coord in axes:
        n, idx = n * size, idx * size + coord
    step = x.shape[dim] // n
    return x.narrow(dim, idx * step, step)


def _gather(x: torch.Tensor, dim: int, axes) -> torch.Tensor:
    for group, size, _ in reversed(axes):      # the minor axis first
        x = _all_gather(x, dim, group, size)
    return x


class _Sum(torch.autograd.Function):
    """Partial sums -> their total on every rank; the gradient of the
    total is each summand's."""

    @staticmethod
    def forward(ctx, x, groups):
        return _all_reduce(x, groups)

    @staticmethod
    def backward(ctx, gy):
        return gy, None


class _Enter(torch.autograd.Function):
    """A replicated tensor meeting rank-dependent work: the same values;
    the gradient, which each rank holds in part, summed."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, gy):
        return _all_reduce(gy, ctx.groups), None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; the gradient is cut back to this rank's
    chunk, summed first where the gathered axes split the tokens (each
    rank then holds only its tokens' share of it)."""

    @staticmethod
    def forward(ctx, x, dim, axes, summed):
        ctx.dim, ctx.axes, ctx.summed = dim, axes, summed
        return _gather(x, dim, axes)

    @staticmethod
    def backward(ctx, gy):
        if ctx.summed:
            gy = _all_reduce(gy, [g for g, _, _ in ctx.axes])
        return _chunk(gy, ctx.dim, ctx.axes).contiguous(), None, None, None


# ------------------------------------------------------------- the Sharder
class Sharder(IdentityShard):
    """The activation callback passed through the model, over ``mesh`` (a
    ``DeviceMesh``) with the rules of one mode (``make_rules``'s
    ``act_rules``); ``Sharder(None)`` is the identity.

    The rules the computation follows (``crules``) are ``act_rules``, with
    the sequence taking precedence under SP as it does in every
    sequence-bearing activation of the reference (``spec_for`` gives the
    axis to ``seq`` first): no other dim but the expert buffers' is split
    over the sequence's axes then.
    """

    def __init__(self, mesh=None, act_rules: Optional[Rules] = None):
        self.mesh = mesh
        self.rules: Rules = dict(act_rules or {})
        self.crules: Rules = {}
        self._axis: Dict[str, tuple] = {}
        self._axes: Dict[str, tuple] = {}
        self._specs: Dict[tuple, tuple] = {}
        self.token_axes: Tuple[str, ...] = ()
        self.token_shards = 1
        self._token_groups: list = []
        self._token_set: set = set()
        if mesh is None:
            return
        sizes = axis_sizes(mesh)
        self._axis = {a: (mesh.get_group(a), s, mesh.get_local_rank(a))
                      for a, s in sizes.items() if s > 1}
        seq = set(_names(self.rules.get("seq")))
        self.crules = {k: (None if seq and k not in ("seq", "batch", "expert")
                           and set(_names(v)) & seq else v)
                       for k, v in self.rules.items()}
        for k, v in self.crules.items():
            self._axes[k] = tuple(self._axis[a] for a in _names(v)
                                  if a in self._axis)
        self.token_axes = tuple(a for a in _names(self.rules.get("batch"))
                                + tuple(seq) if a in self._axis)
        for a in self.token_axes:
            self.token_shards *= self._axis[a][1]
        self._token_groups = [self._axis[a][0] for a in self.token_axes]
        self._token_set = {id(self._axis[a][0]) for a in self.token_axes}

    # ---------------------------------------------------------- queries
    def is_sharded(self, name: str) -> bool:
        return bool(self.rules.get(name))

    def shards(self, name: str) -> int:
        out = 1
        for _, size, _ in self._axes.get(name, ()):
            out *= size
        return out

    def span(self, name: str, n: int) -> Tuple[int, int]:
        axes = self._axes.get(name, ())
        if not axes:
            return 0, n
        k, idx = 1, 0
        for _, size, coord in axes:
            k, idx = k * size, idx * size + coord
        if n % k:
            raise ValueError(f"{name}: {n} is no multiple of {k} shards")
        return idx * (n // k), (idx + 1) * (n // k)

    def local_shape(self, shape: Sequence[int],
                    logical: Sequence[Optional[str]]) -> Tuple[int, ...]:
        out = []
        for n, axes in zip(shape, self._spec(tuple(logical))):
            k = 1
            for _, size, _ in axes:
                k *= size
            if n % k:
                raise ValueError(f"dim {n} of {tuple(logical)} is no "
                                 f"multiple of {k} shards")
            out.append(n // k)
        return tuple(out)

    def _spec(self, logical: tuple) -> tuple:
        out = self._specs.get(logical)
        if out is None:
            out = tuple(tuple(self._axis[a] for a in _names(part)
                              if a in self._axis)
                        for part in spec_for(logical, self.crules))
            self._specs[logical] = out
        return out

    def _summed(self, axes) -> bool:
        return all(id(g) in self._token_set for g, _, _ in axes)

    # ---------------------------------------------------------- layouts
    def __call__(self, x: torch.Tensor, *logical: Optional[str],
                 src: Optional[Sequence[Optional[str]]] = None,
                 partial: Optional[str] = None) -> torch.Tensor:
        """``x`` in the layout ``logical`` names.  ``partial=name``: ``x``
        holds partial sums over the dim the rule ``name`` split (a
        contraction over it), summed here.  ``src``: the layout ``x`` has
        now, one name a dim: each dim whose axes differ is gathered from
        the old axes and cut to the new.  Neither: ``x`` is in the layout
        already."""
        if partial is not None:
            axes = self._axes.get(partial, ())
            return _Sum.apply(x, [g for g, _, _ in axes]) if axes else x
        if src is None:
            return x
        for d, (a, b) in enumerate(zip(self._spec(tuple(src)),
                                       self._spec(logical))):
            if a == b:
                continue
            if a:
                x = _Gather.apply(x, d, a, self._summed(a))
            if b:
                x = _chunk(x, d, b)
        return x

    def enter(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """``x``, replicated over the axes of ``name``, about to meet the
        rank's shard of a dim split by ``name``."""
        groups = [g for g, _, _ in self._axes.get(name, ())
                  if id(g) not in self._token_set]
        return _Enter.apply(x, groups) if groups else x

    def max(self, x: torch.Tensor, name: str) -> torch.Tensor:
        axes = self._axes.get(name, ())
        if not axes:
            return x
        return _all_reduce(x, [g for g, _, _ in axes], dist.ReduceOp.MAX)

    def token_sum(self, x: torch.Tensor) -> torch.Tensor:
        """A sum over the tokens of every rank: each rank's term summed
        over the axes that split the tokens."""
        return _Sum.apply(x, self._token_groups) if self._token_groups \
            else x

    # ------------------------------------------------------- parameters
    def _leaf_axes(self, leaf) -> Tuple[torch.Tensor, list]:
        """(local tensor, per dim the axes its placement splits)."""
        from torch.distributed.tensor import DTensor, Shard
        if not isinstance(leaf, DTensor):
            return leaf, [()] * leaf.dim()
        per_dim: list = [[] for _ in range(leaf.dim())]
        for a, pl in zip(leaf.device_mesh.mesh_dim_names, leaf.placements):
            if isinstance(pl, Shard) and a in self._axis:
                per_dim[pl.dim].append(self._axis[a])
        return leaf.to_local(), [tuple(x) for x in per_dim]

    def param(self, leaf, logical: tuple) -> torch.Tensor:
        """A parameter leaf (a full tensor, or a ``DTensor``) in the layout
        its computation takes: the rank's chunk of each dim the compute
        rules split, the whole of every other."""
        local, have = self._leaf_axes(leaf)
        for d, (a, b) in enumerate(zip(have, self._spec(logical))):
            if a == b:
                continue
            if a:
                local = _gather(local, d, a)
            if b:
                local = _chunk(local, d, b)
        return local

    def param_grad(self, g: torch.Tensor, leaf, logical: tuple
                   ) -> torch.Tensor:
        """The gradient of :meth:`param`'s tensor, as the leaf's own: summed
        over every token-splitting axis that the computation did not split
        the leaf over, then cut to the leaf's chunk."""
        _, have = self._leaf_axes(leaf)
        want = self._spec(logical)
        used = {id(x[0]) for dims in want for x in dims}
        groups = [self._axis[a][0] for a in self.token_axes
                  if id(self._axis[a][0]) not in used]
        if groups:
            g = _all_reduce(g, groups)
        for d, (a, b) in enumerate(zip(have, want)):
            if a == b:
                continue
            if b:
                raise ValueError(f"computed split over {b}, stored over {a}")
            g = _chunk(g, d, a)
        return g.contiguous()


# ------------------------------------------------------ placed parameters
def place(full: torch.Tensor, spec: Spec, mesh):
    """A ``DTensor`` of ``full``'s chunk on this rank, placed by ``spec``
    (no communication: every rank holds ``full``)."""
    from torch.distributed.tensor import DTensor
    sizes = axis_sizes(mesh)
    local = full
    for d, part in enumerate(spec):
        axes = [(None, sizes[a], mesh.get_local_rank(a))
                for a in _names(part)]
        if axes:
            local = _chunk(local, d, axes)
    return DTensor.from_local(local.contiguous(), mesh,
                              placements(spec, mesh), run_check=False)


def place_tree(tree: Any, logical_tree: Any, mesh, rules: Rules) -> Any:
    """Every leaf of a full tree placed by ``spec_for(logical, rules)``."""
    return tree_map(lambda t, lg: place(t, spec_for(lg, rules), mesh),
                    tree, logical_tree)


def full_tensor(t) -> torch.Tensor:
    """The whole tensor on every rank: a ``DTensor``'s shards gathered over
    the mesh dims it is split on (none on a one-rank mesh: the local
    tensor itself); any other tensor as it is."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    local = t.to_local()
    per_dim: Dict[int, list] = {}
    for a, pl in zip(mesh.mesh_dim_names, t.placements):
        if isinstance(pl, Shard) and mesh.size(
                mesh.mesh_dim_names.index(a)) > 1:
            per_dim.setdefault(pl.dim, []).append(
                (mesh.get_group(a), mesh.size(mesh.mesh_dim_names.index(a)),
                 mesh.get_local_rank(a)))
    for d, axes in per_dim.items():
        local = _gather(local, d, axes)
    return local


def full_tree(tree: Any) -> Any:
    return tree_map(full_tensor, tree)
