"""Per-cell (arch x shape x mesh) arguments with no data, and the step
function the port runs on them.

Counterpart of ``repro.launch.specs``.  The reference's arguments are
``ShapeDtypeStruct``s with a sharding; the port's are ``DTensor`` leaves
over the mesh, each made from a fake local shard (``FakeTensorMode``), so
a cell allocates nothing: mixtral_8x22b's float32 parameters alone would
be ~564 GB.  Every leaf of every argument carries its global shape, its
dtype and its placement (``placements`` of ``spec_for`` of its logical
axes), so the cells compare with the reference's leaf by leaf.

The step functions are the port's own, as its engine and trainer call
them: ``make_train_step`` (the parameters and AdamW's moments as
``DTensor``s, each rank's rows of the batch), ``Model(...).prefill`` and
``Model(...).decode_step`` (the whole batch on every rank, the rank's
shard of the cache).  ``Model`` is built inside the step, so a serving
cell pays its parameter gathers and compute-dtype copies on every call,
as the reference's jitted step gathers its FSDP parameters.  Serving
takes the decode rules for prefill too (ROADMAP A16a: no sequence-parallel
prefill yet), while a prefill cell's arguments keep the reference's
prefill layout.  ``donate`` is the reference's metadata: the port's train
step returns new parameters and moments and leaves its inputs unchanged,
so old and new are live together.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs import SHAPES, ShapeSpec, get_config, shape_applicable
from ..models.config import ModelConfig, torch_dtype
from ..models.model import Model, cache_table
from ..models.params import param_table, tree_leaves, tree_map
from ..train.optimizer import OptConfig
from ..train.step import make_train_step
from .mesh import axis_sizes
from .sharding import Sharder, _names, make_rules, placements, spec_for

Pytree = Any

# Microbatch (gradient-accumulation) factors for the train_4k shape: the
# reference's table, so that a cell means the same work in both packages.
TRAIN_ACCUM: Dict[str, int] = {
    "mixtral_8x22b": 16,
    "llama32_vision_90b": 16,
    "qwen3_4b": 4,
    "minicpm_2b": 2,
    "whisper_medium": 2,
    "granite_moe_1b_a400m": 4,
    "recurrentgemma_2b": 2,
    "gemma3_1b": 2,
}


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeSpec
    cfg: ModelConfig
    fn: Callable          # the step, on the args (or on real twins of them)
    args: Tuple           # DTensor leaves with fake local shards
    mode: str
    accum: int = 1
    donate: Tuple[int, ...] = ()
    fake_mode: Any = None  # the FakeTensorMode that holds the args

    @property
    def name(self) -> str:
        return f"{self.arch}/{self.shape.name}"


def _leaf(shape, dtype, spec, mesh, device):
    """A ``DTensor`` of global ``shape`` placed by ``spec`` on ``mesh``,
    over an empty local shard of rank 0 (the fake mode's when one is
    active)."""
    from torch.distributed.tensor import DTensor
    sizes = axis_sizes(mesh)
    local = list(shape)
    for d, part in enumerate(spec):
        for a in _names(part):
            local[d] = -(-local[d] // sizes[a])
    stride, acc = [], 1
    for n in reversed(shape):
        stride.insert(0, acc)
        acc *= max(n, 1)
    return DTensor.from_local(
        torch.empty(local, dtype=dtype, device=device), mesh,
        placements(spec, mesh), run_check=False, shape=torch.Size(shape),
        stride=tuple(stride))


def opt_abstract(params: Pytree, device) -> Pytree:
    """AdamW's state beside ``params``: float32 moments of each leaf's
    shape and placement, and a 0-dim int32 step."""
    def f32(p):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(
            torch.empty(p.to_local().shape, dtype=torch.float32,
                        device=device), p.device_mesh, p.placements,
            run_check=False, shape=p.shape, stride=p.stride())
    return {"m": tree_map(f32, params), "v": tree_map(f32, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _rows(t):
    """A batch leaf as the trainer gives it to a rank: its rows of the
    batch, every position of them (the model cuts the sequence itself
    under sequence parallelism), uploaded from the host."""
    local = t.to_local()
    want = (local.shape[0],) + tuple(t.shape[1:])
    return local if tuple(local.shape) == want else local.new_empty(want)


def _whole(t):
    """A batch leaf as the engine gives it to every rank: the whole batch,
    uploaded from the host."""
    local = t.to_local()
    return local if tuple(local.shape) == tuple(t.shape) \
        else local.new_empty(t.shape)


def build_cell(arch: str, shape_name: str, mesh,
               cfg_override: Optional[ModelConfig] = None,
               opt_cfg: Optional[OptConfig] = None,
               accum: Optional[int] = None, device=None) -> Cell:
    """The cell ``arch`` x ``shape_name`` on ``mesh`` (a ``DeviceMesh``):
    its step and its arguments as ``DTensor`` leaves with fake local
    shards on ``device`` (the CPU by default: they hold no data), made in
    a ``FakeTensorMode`` of its own, which the cell keeps."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = cfg_override or get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{arch}/{shape_name}: {why}")
    fake_mode = FakeTensorMode()
    device = torch.device(device or "cpu")
    param_rules, act_rules = make_rules(cfg, mesh, shape.mode,
                                        shape.global_batch, shape.seq_len)
    B, S = shape.global_batch, shape.seq_len
    pdt = torch_dtype(cfg.param_dtype)
    tok_spec = spec_for(("batch", "seq"), act_rules)
    emb3_spec = spec_for(("batch", "enc_seq", "embed"), act_rules)

    with fake_mode:
        params = tree_map(
            lambda s: _leaf(s.shape, pdt, spec_for(s.logical, param_rules),
                            mesh, device),
            param_table(cfg), is_leaf=lambda x: hasattr(x, "logical"))

        def batch_specs(seq: int) -> Dict[str, Any]:
            out = {"tokens": _leaf((B, seq), torch.int32, tok_spec, mesh,
                                   device)}
            if cfg.encoder is not None:
                out["enc_frames"] = _leaf(
                    (B, cfg.encoder.seq_len, cfg.d_model), torch.float32,
                    emb3_spec, mesh, device)
            if cfg.vision is not None:
                out["img_embeds"] = _leaf(
                    (B, cfg.vision.n_img_tokens, cfg.d_model),
                    torch.float32, emb3_spec, mesh, device)
            return out

        if shape.mode == "train":
            acc = accum if accum is not None else TRAIN_ACCUM.get(arch, 1)
            sharder = Sharder(mesh, act_rules)
            # a rank with fewer rows than microbatches (256 rows over 32
            # data ranks, accum 16) takes one row a microbatch: the same
            # tokens and, microbatches being equal, the same mean loss
            rows = sharder.local_shape((B,), ("batch",))[0]
            step = make_train_step(cfg, opt_cfg or OptConfig(),
                                   min(acc, rows), shard=sharder)
            batch = dict(batch_specs(S), labels=_leaf(
                (B, S), torch.int32, tok_spec, mesh, device))
            args = (params, opt_abstract(params, device), batch)

            def train_fn(params, opt_state, batch):
                return step(params, opt_state,
                            {k: _rows(v) for k, v in batch.items()})

            return Cell(arch, shape, cfg, train_fn, args, "train", acc,
                        donate=(0, 1), fake_mode=fake_mode)
        # serving computes in the decode layout (see the module docstring)
        _, serve_rules = make_rules(cfg, mesh, "decode", B, S)
        sharder = Sharder(mesh, serve_rules)
        if shape.mode == "prefill":
            def prefill_fn(params, batch):
                batch = {k: _whole(v) for k, v in batch.items()}
                tokens = batch.pop("tokens")
                return Model(cfg, params, sharder).prefill(tokens, S,
                                                           batch or None)

            return Cell(arch, shape, cfg, prefill_fn,
                        (params, batch_specs(S)), "prefill",
                        fake_mode=fake_mode)
        # decode: one new token against a cache of seq_len
        cache = tree_map(
            lambda s: _leaf(s.shape, s.dtype, spec_for(s.logical, act_rules),
                            mesh, device),
            cache_table(cfg, B, S), is_leaf=lambda x: hasattr(x, "logical"))

        def decode_fn(params, tokens, cache):
            return Model(cfg, params, sharder).decode_step(
                _whole(tokens), tree_map(lambda t: t.to_local(), cache))

        args = (params, _leaf((B, 1), torch.int32, tok_spec, mesh, device),
                cache)
        return Cell(arch, shape, cfg, decode_fn, args, "decode",
                    donate=(2,), fake_mode=fake_mode)


def leaf_layouts(tree: Pytree) -> list:
    """``(path, global shape, dtype, spec)`` of every leaf, in the tree's
    leaf order; ``spec`` names, per dim, the mesh axes that split it, in
    the mesh's order (a ``DTensor``), or none (any other tensor)."""
    out = []
    for path, t in tree_leaves(tree):
        spec = [[] for _ in range(t.dim())]
        if hasattr(t, "placements"):
            for a, pl in zip(t.device_mesh.mesh_dim_names, t.placements):
                if pl.is_shard():
                    spec[pl.dim].append(a)
        out.append((path, tuple(t.shape), t.dtype,
                    tuple(None if not p else p[0] if len(p) == 1
                          else tuple(p) for p in spec)))
    return out

