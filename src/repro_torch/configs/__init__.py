"""Architecture registry: ``get_config(arch_id)`` / ``get_smoke(arch_id)``.

Counterpart of ``repro.configs``.  Each ``<arch>.py`` defines CONFIG (the
full-size configuration) and SMOKE (a reduced same-family config for CPU
tests), copied from the reference; every architecture of ``ARCH_IDS`` is
ported.  The four input shapes of the assignment (``SHAPES``), their
applicability (``long_500k`` runs only for sub-quadratic stacks) and the
40 (arch, shape) cells are the reference's too.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Tuple

from ..models.config import ModelConfig

ARCH_IDS = [
    "whisper_medium",
    "mamba2_130m",
    "minicpm_2b",
    "smollm_135m",
    "qwen3_4b",
    "gemma3_1b",
    "granite_moe_1b_a400m",
    "mixtral_8x22b",
    "recurrentgemma_2b",
    "llama32_vision_90b",
]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str            # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def _canon(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def _module(arch: str):
    arch = _canon(arch)
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch!r}")
    return importlib.import_module(f"{__name__}.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Assignment-spec applicability of an (arch, shape) cell."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("skipped: pure full-attention arch; long_500k requires "
                       "sub-quadratic attention (DESIGN.md §6)")
    return True, ""


def all_cells() -> List[Tuple[str, str]]:
    """Every (arch, shape) cell of the assignment: 40 in all."""
    return [(a, s) for a in ARCH_IDS for s in SHAPES]
