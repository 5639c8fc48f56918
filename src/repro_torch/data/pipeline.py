"""Stubbed modality-frontend inputs: a copy of the reference's
``data/pipeline.py`` ``stub_frontend_inputs`` (the rest of that module, the
token pipeline for training, waits for ROADMAP A15)."""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..models.config import ModelConfig


def stub_frontend_inputs(cfg: ModelConfig, batch_size: int, rng_seed: int = 0
                         ) -> Dict[str, np.ndarray]:
    """Precomputed modality-frontend embeddings: whisper frame embeddings
    ``enc_frames`` (B, encoder.seq_len, d_model) and vision patch
    embeddings ``img_embeds`` (B, vision.n_img_tokens, d_model), float32
    drawn from ``rng_seed`` exactly as the reference draws them."""
    out: Dict[str, np.ndarray] = {}
    rng = np.random.default_rng(rng_seed)
    if cfg.encoder is not None:
        out["enc_frames"] = rng.standard_normal(
            (batch_size, cfg.encoder.seq_len, cfg.d_model),
            dtype=np.float32) * 0.02
    if cfg.vision is not None:
        out["img_embeds"] = rng.standard_normal(
            (batch_size, cfg.vision.n_img_tokens, cfg.d_model),
            dtype=np.float32) * 0.02
    return out
