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

On a mesh (``shard``: a ``launch.sharding.Sharder`` with the decode rules,
``make_rules(cfg, mesh, "decode", batch, s_max)``, one layout for prefill
and decode as in the reference) every rank runs the engine on the same
wave: prefill and decode run on the rank's rows, heads and (where the
rules split the cache's sequence) pages.  AutumnKV stays one store, on
rank 0: it looks the wave up and broadcasts what it found, and it inserts
pages from the full cache gathered from every rank, so a page's bytes do
not depend on the mesh.  A wave's row count must then divide among the
data axes.

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
import torch.distributed as dist

from ..core.engine import resolve_device
from ..kvcache.autumnkv import AutumnKVCache
from ..models.config import ModelConfig
from ..models.layers import Shard, identity_shard
from ..models.model import Model, cache_logical_specs, init_cache
from ..models.params import tree_leaves, tree_map

Pytree = Any


@dataclasses.dataclass
class Request:
    prompt: np.ndarray            # (S,) int32, S multiple of page for reuse
    gen_len: int = 8


class ServeEngine:
    """``params`` is the full tree (on a mesh every rank holds it and the
    model keeps the rank's shards); ``prefix_cache`` serves over an
    existing AutumnKV cache (engines over the same weights share its
    store) in place of a new one."""

    def __init__(self, cfg: ModelConfig, params: Pytree, batch: int,
                 s_max: int, use_prefix_cache: bool = True, device=None,
                 shard: Shard = identity_shard,
                 prefix_cache: Optional[AutumnKVCache] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.shard = shard
        self.model = Model(cfg, tree_map(lambda t: t.to(self.device),
                                         params), shard)
        self.batch = batch
        self.s_max = s_max
        self.use_prefix_cache = use_prefix_cache
        # the ranks that serve together: the process group's, on a mesh
        self.world = dist.get_world_size() if shard.mesh is not None else 1
        rank0 = shard.mesh is None or dist.get_rank() == 0
        self.kv = (prefix_cache or AutumnKVCache(cfg, 1, s_max,
                                                 device=self.device)) \
            if use_prefix_cache and rank0 else None
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
        if self.use_prefix_cache:
            hits = self._lookup(requests)
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
        if self.use_prefix_cache and miss_idx:
            full = self._whole(cache, len(requests))
            if self.kv is not None:
                for i in miss_idx:
                    self.kv.insert(requests[i].prompt, _batch_row(full, i))
        # splice hit rows into the batched cache (validates stored pages)
        b0, b1 = self.shard.span("batch", len(requests))
        for i, row_cache in hits.items():
            if b0 <= i < b1:
                _set_batch_row(cache, self._own(row_cache), i - b0)
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

    # ------------------------------------------------------------- the mesh
    def _lookup(self, requests: List[Request]) -> Dict[int, Pytree]:
        """{row: its stored cache} of the wave's full-prompt hits: the
        store's one batched ``multi_get`` on rank 0, broadcast to every
        rank of a mesh."""
        template = init_cache(self.cfg, 1, self.s_max, self.device)
        got = self.kv.lookup_batch([r.prompt for r in requests], template) \
            if self.kv is not None else [None] * len(requests)
        if self.world > 1:
            found = torch.tensor([g is not None for g in got],
                                 device=self.device)
            dist.broadcast(found, src=0)
            got = [(g if g is not None else init_cache(
                self.cfg, 1, self.s_max, self.device)) if f else None
                for g, f in zip(got, found.tolist())]
            for g in got:
                for _, leaf in tree_leaves(g) if g is not None else ():
                    dist.broadcast(leaf, src=0)
        return {i: g for i, g in enumerate(got) if g is not None}

    def _whole(self, cache: Pytree, B: int) -> Pytree:
        """The wave's full cache from every rank's shard of it."""
        return tree_map(lambda t, lg: self.shard(t, *(None,) * len(lg),
                                                 src=lg),
                        cache, cache_logical_specs(self.cfg, B, self.s_max))

    def _own(self, row: Pytree) -> Pytree:
        """The rank's shard of one row's full cache."""
        return tree_map(lambda t, lg: self.shard(
            t, *(None if a == "batch" else a for a in lg),
            src=(None,) * len(lg)),
            row, cache_logical_specs(self.cfg, 1, self.s_max))

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
