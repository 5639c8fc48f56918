"""Model configuration: a copy of ``repro.models.config``.

A model is a sequence of *stages*; each stage repeats a stack of identical
super-blocks (an ordered tuple of layer kinds).  ``find_stages`` compresses
an explicit per-layer pattern into (super_block, repeat) stages; the port
keeps the reference's stage layout so that parameter and cache trees have
the same shapes (a leading layers axis per stage).

Layer kinds:
  attn    — global self-attention (GQA, optional qk_norm)
  lattn   — local/sliding-window self-attention
  xattn   — cross-attention (vision / encoder-decoder)
  ssd     — Mamba-2 state-space duality block
  rglru   — RG-LRU recurrent block (Griffin/RecurrentGemma)
  wdec    — whisper decoder block (self-attention + cross-attention)

Dtype fields stay strings, as in the reference; :func:`torch_dtype` maps
them to torch dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

LayerKind = str
ATTN_KINDS = ("attn", "lattn", "xattn")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config dtype string (``"bfloat16"`` etc.)."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 256
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    width: int = 0          # 0 => d_model
    conv_width: int = 4
    power: float = 8.0      # the "c" constant in a = exp(-c*softplus(L)*r)
    # block-diagonal r/i gates: number of blocks (0 = dense gates)
    gate_blocks: int = 0


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec models. The modality frontend is a stub:
    input_specs() provides precomputed frame embeddings (B, seq, d_model)."""
    n_layers: int
    n_heads: int
    d_ff: int
    seq_len: int            # number of frames after the (stubbed) conv frontend


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """Cross-attention image layers. The patch frontend is a stub: input_specs
    provides precomputed patch embeddings (B, n_img_tokens, d_model)."""
    n_img_tokens: int = 1600
    xattn_every: int = 5    # every 5th layer is cross-attention


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_q: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int = 0                     # 0 => d_model // n_q
    layer_pattern: Tuple[LayerKind, ...] = ()  # () => all "attn"
    window: int = 4096                  # sliding window for "lattn" kinds
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionConfig] = None
    max_seq_len: int = 131_072
    q_chunk: int = 1024              # score-buffer bound (training attention)
    loss_chunk: int = 1024           # vocab-loss seq chunking (memory lever)
    pad_vocab_to: int = 256          # TP-divisible vocab padding
    scores_dtype: str = "float32"    # reference's score dtype (kernels: fp32)
    # long_500k applicability: True only for sub-quadratic stacks
    subquadratic: bool = False
    # rematerialisation in training (models/train.py), and dtypes
    remat: bool = True
    remat2: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // max(self.n_q, 1))
        if not self.layer_pattern:
            object.__setattr__(self, "layer_pattern", ("attn",) * self.n_layers)
        if len(self.layer_pattern) != self.n_layers:
            raise ValueError(f"{self.name}: pattern len "
                             f"{len(self.layer_pattern)} != {self.n_layers}")

    @property
    def has_decoder_attn_cache(self) -> bool:
        return any(k in ATTN_KINDS for k in self.layer_pattern)

    @property
    def vocab_padded(self) -> int:
        """Vocab padded for clean TP sharding (Megatron's
        make-vocab-divisible); pad logits are masked to -inf in the loss."""
        pad = self.pad_vocab_to
        return -(-self.vocab // pad) * pad

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS = 6*N*D roofline)."""
        from .params import count_params  # local import to avoid cycle
        return count_params(self)

    def active_param_count(self) -> int:
        from .params import count_params
        return count_params(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class Stage:
    block: Tuple[LayerKind, ...]   # kinds inside one super-block
    repeat: int                    # scan length


def find_stages(pattern: Sequence[LayerKind], max_period: int = 8) -> List[Stage]:
    """Compress a layer pattern into scanned stages of repeating super-blocks.

    Finds the smallest period p (<= max_period) such that a prefix of the
    pattern is a whole number of repetitions of pattern[:p]; the remainder is
    recursively compressed.  Concatenation of stage blocks x repeats
    reproduces ``pattern`` exactly.
    """
    pattern = tuple(pattern)
    if not pattern:
        return []
    best: Optional[Stage] = None
    for p in range(1, min(max_period, len(pattern)) + 1):
        block = pattern[:p]
        reps = 0
        while (reps + 1) * p <= len(pattern) and \
                pattern[reps * p:(reps + 1) * p] == block:
            reps += 1
        covered = reps * p
        if best is None or covered > best.repeat * len(best.block):
            best = Stage(block, reps)
    covered = best.repeat * len(best.block)
    return [best] + find_stages(pattern[covered:], max_period)


def expand_stages(stages: Sequence[Stage]) -> Tuple[LayerKind, ...]:
    out: List[LayerKind] = []
    for s in stages:
        out.extend(s.block * s.repeat)
    return tuple(out)
