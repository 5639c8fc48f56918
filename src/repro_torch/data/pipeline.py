"""Deterministic, seekable data pipeline: a copy of the reference's
``data/pipeline.py``.

Every batch is a pure function of (seed, step, host): there is no cursor
state to checkpoint, a restore at step k after a failure reproduces the
exact token stream, and a different host count re-partitions the same
global stream.  The trainer's crash recovery relies on it.

Two sources, whose batches are numpy arrays equal bit for bit to the
reference's:
  SyntheticTokens -- a splitmix64 hash token stream (next-token targets
                     with a planted bigram structure, so the loss must
                     fall);
  MemmapCorpus    -- windows over a tokenized numpy corpus on disk;
and the stubbed modality frontends' inputs (``stub_frontend_inputs``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from ..core.types import splitmix64
from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.num_hosts:
            raise ValueError(f"global batch {self.global_batch} is no "
                             f"multiple of {self.num_hosts} hosts")
        return self.global_batch // self.num_hosts


class SyntheticTokens:
    """Deterministic pseudo-corpus.  Every odd position is a fixed planted
    bigram of the token before it, so a model that learns the table halves
    its loss: a real training signal in tests."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed + 7)
        self._bigram = rng.integers(0, cfg.vocab, size=cfg.vocab,
                                    dtype=np.int64)

    def get_batch(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        B, S = c.host_batch, c.seq_len
        row0 = step * c.global_batch + c.host_id * B
        idx = (np.arange(row0, row0 + B, dtype=np.uint64)[:, None] *
               np.uint64(1_000_003) +
               np.arange(S, dtype=np.uint64)[None, :] +
               np.uint64(c.seed) * np.uint64(0x9E37_79B9))
        raw = (splitmix64(idx) % np.uint64(c.vocab)).astype(np.int64)
        # plant structure: each odd position is bigram[previous even token]
        tokens = raw.copy()
        n_odd = len(range(1, S, 2))
        tokens[:, 1::2] = self._bigram[tokens[:, 0::2][:, :n_odd]]
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = tokens[:, 0]
        return {"tokens": tokens.astype(np.int32),
                "labels": labels.astype(np.int32)}


class MemmapCorpus:
    """Sequential windows over a flat tokenized corpus (an ``np.save``
    file, memory-mapped)."""

    def __init__(self, cfg: DataConfig, path: str):
        self.cfg = cfg
        self.data = np.load(path, mmap_mode="r")
        if self.data.ndim != 1:
            raise ValueError(f"corpus of shape {self.data.shape} is not flat")

    def get_batch(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        B, S = c.host_batch, c.seq_len
        n = self.data.shape[0] - (S + 1)
        starts = (np.arange(B, dtype=np.int64) +
                  (step * c.global_batch + c.host_id * B)) * S % max(n, 1)
        toks = np.stack([self.data[s:s + S + 1] for s in starts])
        return {"tokens": toks[:, :S].astype(np.int32),
                "labels": toks[:, 1:S + 1].astype(np.int32)}


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
