"""Architecture registry: ``get_config(arch_id)`` / ``get_smoke(arch_id)``.

Counterpart of ``repro.configs``.  Each ported ``<arch>.py`` defines CONFIG
(the full-size configuration) and SMOKE (a reduced same-family config for
CPU tests), copied from the reference.  Only the dense ``attn`` family is
ported so far; the other architectures raise ``NotImplementedError``
naming the ROADMAP.md item that ports their layer kinds.
"""
from __future__ import annotations

import importlib

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

PORTED = ("qwen3_4b", "smollm_135m")

# ROADMAP.md section A, item 11 (the model zoo), by layer family
NOT_PORTED = {
    "minicpm_2b": "A11 (dense attn family: config not copied yet)",
    "gemma3_1b": "A11 step 2 (lattn)",
    "granite_moe_1b_a400m": "A11 step 3 (MoE)",
    "mixtral_8x22b": "A11 step 3 (MoE)",
    "mamba2_130m": "A11 step 4 (ssd)",
    "recurrentgemma_2b": "A11 step 5 (rglru)",
    "llama32_vision_90b": "A11 step 6 (xattn/encoder)",
    "whisper_medium": "A11 step 6 (xattn/encoder)",
}


def _canon(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def _module(arch: str):
    arch = _canon(arch)
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"{arch} is not ported to repro_torch yet: ROADMAP.md "
            f"{NOT_PORTED[arch]}")
    if arch not in PORTED:
        raise ValueError(f"unknown architecture {arch!r}")
    return importlib.import_module(f"{__name__}.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
