"""Architecture registry: ``get_config(arch_id)`` / ``get_smoke(arch_id)``.

Counterpart of ``repro.configs``.  Each ``<arch>.py`` defines CONFIG (the
full-size configuration) and SMOKE (a reduced same-family config for CPU
tests), copied from the reference; every architecture of ``ARCH_IDS`` is
ported.
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
