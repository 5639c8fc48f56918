"""Batched serving engine over the AutumnKV prefix cache.

Counterpart of ``repro.serve.engine``, with the same wave semantics:
  1. batched AutumnKV lookup — one store ``multi_get`` resolves the whole
     wave's page keys; full-prompt hits are restored from stored pages;
  2. every row is prefilled together (flash attention on the card);
  3. freshly prefilled prompts (the misses) are inserted as
     content-addressed pages, and hit rows are spliced into the batched
     cache;
  4. all rows decode together for gen_len greedy steps (paged attention on
     the card; ``torch.argmax`` takes the first maximum, as ``jnp.argmax``).

With ``use_prefix_cache=False`` there is no AutumnKV: no lookup and no
insert, every row prefilled and decoded.  ``serve_batch(requests,
extras)`` passes the modality frontends' stubbed embeddings
(``enc_frames`` for whisper's encoder, ``img_embeds`` for cross-attention
image layers; numpy arrays or tensors, moved to the engine's device) to
the prefill.  AutumnKV's keys are the prompt tokens alone, as in the
reference: two requests with equal tokens and different extras share a
cached state (ROADMAP C9).

The engine runs on ``cuda:0`` unless it is given ``device="cpu"``, and
raises where CUDA is absent.  Each wave records where its time went
(``last_timings``: lookup, prefill, insert, each decode step), measured on
the host clock with the device synchronised at the boundaries.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.engine import resolve_device
from ..kvcache.autumnkv import AutumnKVCache
from ..models.config import ModelConfig
from ..models.model import Model, init_cache
from ..models.params import tree_map

Pytree = Any


@dataclasses.dataclass
class Request:
    prompt: np.ndarray            # (S,) int32, S multiple of page for reuse
    gen_len: int = 8


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: Pytree, batch: int,
                 s_max: int, use_prefix_cache: bool = True, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = Model(cfg, tree_map(lambda t: t.to(self.device),
                                         params))
        self.batch = batch
        self.s_max = s_max
        self.kv = AutumnKVCache(cfg, 1, s_max, device=self.device) \
            if use_prefix_cache else None
        self.metrics: Dict[str, float] = {"prefill_tokens": 0,
                                          "decoded_tokens": 0,
                                          "cache_hits": 0, "batches": 0}
        self.last_timings: Dict[str, Any] = {}

    def _sync(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    # ----------------------------------------------------------------- wave
    @torch.no_grad()
    def serve_batch(self, requests: List[Request],
                    extras: Optional[Dict[str, Any]] = None
                    ) -> List[np.ndarray]:
        if not 0 < len(requests) <= self.batch:
            raise ValueError(f"a wave holds 1..{self.batch} requests, got "
                             f"{len(requests)}")
        S = len(requests[0].prompt)
        if any(len(r.prompt) != S for r in requests):
            raise ValueError("one wave = one prompt length (bucketing "
                             "upstream)")
        t0 = self._sync()
        hits: Dict[int, Pytree] = {}
        if self.kv is not None:
            template = init_cache(self.cfg, 1, self.s_max, self.device)
            # one batched store multi_get across the whole wave's page keys
            got = self.kv.lookup_batch([r.prompt for r in requests],
                                       template)
            hits = {i: g for i, g in enumerate(got) if g is not None}
        self.metrics["cache_hits"] += len(hits)
        t1 = self._sync()
        tokens = torch.from_numpy(np.stack([np.asarray(r.prompt, np.int32)
                                            for r in requests])
                                  ).to(self.device)
        extras = {k: torch.as_tensor(v).to(self.device)
                  for k, v in (extras or {}).items()}
        miss_idx = [i for i in range(len(requests)) if i not in hits]
        logits, cache = self.model.prefill(tokens, self.s_max, extras)
        self.metrics["prefill_tokens"] += S * len(miss_idx)
        t2 = self._sync()
        if self.kv is not None:
            for i in miss_idx:
                self.kv.insert(requests[i].prompt, _batch_row(cache, i))
        # splice hit rows into the batched cache (validates stored pages)
        for i, row_cache in hits.items():
            _set_batch_row(cache, row_cache, i)
        t3 = self._sync()
        # greedy decode; tokens stay on the device until the wave ends
        last = torch.argmax(logits, -1)[:, None].to(torch.int32)
        outs = []
        steps = []
        for _ in range(max(r.gen_len for r in requests)):
            outs.append(last)
            ts = time.perf_counter()
            logits, cache = self.model.decode_step(last, cache)
            last = torch.argmax(logits, -1)[:, None].to(torch.int32)
            steps.append(self._sync() - ts)
            self.metrics["decoded_tokens"] += len(requests)
        out = torch.cat(outs, 1).cpu().numpy() if outs else \
            np.zeros((len(requests), 0), np.int32)
        t4 = time.perf_counter()
        self.metrics["batches"] += 1
        self.metrics["last_wave_s"] = t4 - t0
        self.last_timings = dict(lookup_s=t1 - t0, prefill_s=t2 - t1,
                                 insert_s=t3 - t2, decode_step_s=steps)
        return [out[i, :r.gen_len] for i, r in enumerate(requests)]

    def close(self) -> None:
        """Retire the engine: drain the prefix cache's background workers."""
        if self.kv is not None:
            self.kv.close()


def _batch_row(cache: Pytree, i: int) -> Pytree:
    """Row ``i`` as a batch-1 cache view: leaves are (layers, batch, ...);
    'pos' is 0-dim."""
    return tree_map(lambda a: a[:, i:i + 1] if a.dim() >= 2 else a, cache)


def _set_batch_row(cache: Pytree, row: Pytree, i: int) -> None:
    def put(a, r):
        if a.dim() >= 2:
            a[:, i:i + 1] = r
        return a
    tree_map(put, cache, row)
