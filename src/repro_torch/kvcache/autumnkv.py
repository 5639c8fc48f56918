"""AutumnKV: an LSM-backed, content-addressed prefix cache for serving.

Counterpart of ``repro.kvcache.autumnkv``.  Prompts are split into
PAGE_TOKENS-token pages; each page's KV slice is stored in the Autumn store
under a *chain hash* (a rolling hash of every token up to the page end), so
identical prefixes across requests share storage, and a wave's lookups are
one batched ``multi_get`` of bloom-filtered point reads.  The full-prompt
record (bit 63 set on the last page's hash) holds the cache's non-paged
leaves, so a full hit restores the decode cache exactly.

The port keeps the reference's blobs byte for byte: the codec walks the
cache's leaves in JAX's flattening order (dict keys sorted, so ``"pos"``
before ``"stages"`` and ``"k"`` before ``"v"``), and bfloat16 leaves are
serialised from their bits on the device.  A page blob is sliced on the
device and crosses to the host in one copy; writing one back is one copy
the other way, into the cache in place.

The store runs the reference's configuration on the port's device store:
async compaction on two workers, a 4 MiB block cache and a 2 MiB pinned
L0.  Only ``shards=2`` is left at its default, one store, until the
sharded facade is ported (ROADMAP.md A8); answers, hits and pages are the
same either way.  With a ``Telemetry`` on the store (``lsm_config=
LSMConfig(..., telemetry=...)``) ``stats()`` adds per-op latency summaries
and the trace's event count.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import LSMConfig, LSMStore
from ..core.types import splitmix64
from ..models import model as M
from ..models.config import ModelConfig
from ..models.params import tree_leaves, tree_map

PAGE_TOKENS = 64
Pytree = Any
_STATE_TAG = np.uint64(1) << np.uint64(63)


def chain_hashes(tokens: np.ndarray, page: int = PAGE_TOKENS) -> List[int]:
    """Rolling hash at each full page boundary (uint64, never 0)."""
    out = []
    h = np.uint64(0x243F6A8885A308D3)
    for i, t in enumerate(np.asarray(tokens, dtype=np.uint64)):
        h = splitmix64(np.asarray([h ^ (t + np.uint64(0x9E3779B97F4A7C15))]))[0]
        if (i + 1) % page == 0:
            # page keys live in the lower half-space; bit 63 tags state records
            out.append(int(h & ((np.uint64(1) << np.uint64(63)) -
                               np.uint64(1))) or 1)
    return out


def store_config() -> LSMConfig:
    """The reference's AutumnKV store configuration but ``shards=2``,
    which waits for the sharded facade: hot page blocks served from the
    cache, L0 pinned so fresh inserts stay resident, and page-insert bursts
    after prefill returning without paying flush or compaction."""
    return LSMConfig(policy="garnering", T=2.0, c=0.8, memtable_bytes=1 << 20,
                     base_level_bytes=8 << 20, bits_per_key=10,
                     bloom_allocation="monkey",
                     cache_bytes=4 << 20, pin_l0_bytes=2 << 20,
                     async_compaction=True, compaction_workers=2)


def _kv_axis(logical: Tuple[Optional[str], ...]) -> Optional[int]:
    for i, name in enumerate(logical):
        if name == "kv_seq":
            return i
    return None


def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as a flat uint8 tensor (same device)."""
    return t.contiguous().view(-1).view(torch.uint8)


@dataclasses.dataclass
class CacheCodec:
    """Splits a decode cache tree into per-page KV slices + a state blob."""
    cfg: ModelConfig
    batch: int
    s_max: int

    def __post_init__(self):
        self.logical = [lg for _, lg in tree_leaves(
            M.cache_logical_specs(self.cfg, self.batch, self.s_max),
            lambda x: isinstance(x, tuple))]

    def leaves(self, cache: Pytree):
        """(path, tensor, logical axes) in JAX's leaf order."""
        return [(p, t, lg) for (p, t), lg in zip(tree_leaves(cache),
                                                 self.logical)]

    def _page_slices(self, cache: Pytree, page_idx: int, page: int):
        for _, leaf, lg in self.leaves(cache):
            ax = _kv_axis(lg)
            if ax is None:
                continue
            lo = page_idx * page
            if lo < leaf.shape[ax]:
                yield leaf.narrow(ax, lo, min(page, leaf.shape[ax] - lo))

    def page_bytes(self, cache: Pytree, page_idx: int,
                   page: int = PAGE_TOKENS) -> bytes:
        """Serialize every kv_seq slice [page_idx*page, (page_idx+1)*page)."""
        parts = [_bytes_of(s) for s in self._page_slices(cache, page_idx,
                                                          page)]
        if not parts:
            return b""
        return torch.cat(parts).cpu().numpy().tobytes()

    def state_bytes(self, cache: Pytree) -> bytes:
        """Serialize every non-paged leaf (here the position)."""
        parts = [_bytes_of(leaf) for _, leaf, lg in self.leaves(cache)
                 if _kv_axis(lg) is None]
        return torch.cat(parts).cpu().numpy().tobytes() if parts else b""

    @staticmethod
    def _fill(targets: List[torch.Tensor], blob: bytes) -> None:
        """Copy ``blob`` into ``targets`` in order: one upload, then one
        device copy per target."""
        if not targets:
            return
        flat = torch.frombuffer(bytearray(blob), dtype=torch.uint8).to(
            targets[0].device)
        off = 0
        for t in targets:
            n = t.numel() * t.element_size()
            t.copy_(flat[off:off + n].view(t.dtype).view(t.shape))
            off += n

    def write_page(self, cache: Pytree, blob: bytes, page_idx: int,
                   page: int = PAGE_TOKENS) -> Pytree:
        """Write a page blob into ``cache`` in place; returns ``cache``."""
        self._fill(list(self._page_slices(cache, page_idx, page)), blob)
        return cache

    def write_state(self, cache: Pytree, blob: bytes) -> Pytree:
        """Write a state blob into ``cache`` in place; returns ``cache``."""
        self._fill([leaf for _, leaf, lg in self.leaves(cache)
                    if _kv_axis(lg) is None], blob)
        return cache


class AutumnKVCache:
    """Content-addressed page store over the Autumn LSM store.

    The store lives on ``device`` (``cuda:0`` by default, which must exist;
    ``"cpu"`` only on request), as the caches it serves do."""

    def __init__(self, cfg: ModelConfig, batch: int, s_max: int, device=None,
                 lsm_config: Optional[LSMConfig] = None):
        self.cfg = cfg
        self.codec = CacheCodec(cfg, batch, s_max)
        self.page = PAGE_TOKENS
        self.db = LSMStore(lsm_config or store_config(), device=device)
        self.hits = 0
        self.misses = 0
        self.pages_written = 0
        self.pages_deduped = 0

    # ------------------------------------------------------------ interface
    def _restore(self, template: Pytree, state_blob: bytes,
                 page_blobs: List[bytes]) -> Pytree:
        cache = tree_map(torch.clone, template)
        self.codec.write_state(cache, state_blob)
        for i, blob in enumerate(page_blobs):
            self.codec.write_page(cache, blob, i, self.page)
        return cache

    def lookup_batch(self, prompts: List[np.ndarray],
                     template: Pytree) -> List[Optional[Pytree]]:
        """Full-prompt hits of a serving wave: for each prompt, a copy of
        ``template`` holding its stored cache, or None.  Every prompt's
        state and page keys are resolved with ONE ``LSMStore.multi_get``;
        hit/miss semantics and counters are the reference's."""
        metas: List[Tuple[List[int], bool]] = []
        all_keys: List[int] = []
        for tokens in prompts:
            hs = chain_hashes(tokens, self.page)
            ok = bool(hs) and len(tokens) % self.page == 0
            metas.append((hs, ok))
            if ok:
                all_keys.append(int(np.uint64(hs[-1]) | _STATE_TAG))
                all_keys.extend(hs)
        blobs = self.db.multi_get(all_keys) if all_keys else []
        out: List[Optional[Pytree]] = []
        off = 0
        for hs, ok in metas:
            if not ok:
                self.misses += 1
                out.append(None)
                continue
            state_blob = blobs[off]
            page_blobs = blobs[off + 1: off + 1 + len(hs)]
            off += 1 + len(hs)
            if state_blob is None or any(b is None for b in page_blobs):
                self.misses += 1
                out.append(None)
                continue
            self.hits += 1
            out.append(self._restore(template, state_blob, page_blobs))
        return out

    def insert(self, tokens: np.ndarray, cache: Pytree):
        hs = chain_hashes(tokens, self.page)
        for i, h in enumerate(hs):
            if self.db.get(h) is not None:   # content-addressed dedup
                self.pages_deduped += 1
                continue
            self.db.put(h, self.codec.page_bytes(cache, i, self.page))
            self.pages_written += 1
        if hs:
            self.db.put(int(np.uint64(hs[-1]) | _STATE_TAG),
                        self.codec.state_bytes(cache))
        self.db.flush()

    def stats(self) -> Dict[str, Any]:
        out = dict(hits=self.hits, misses=self.misses,
                   pages_written=self.pages_written,
                   pages_deduped=self.pages_deduped,
                   levels=self.db.num_levels_in_use,
                   block_cache=self.db.cache_summary(),
                   io=self.db.stats.to_dict())
        tel = self.db.telemetry
        if tel is not None:
            out["latency"] = tel.summary()
            out["trace_events"] = len(tel.trace)
        return out

    def close(self) -> None:
        """Drain and stop the store's background compaction workers; the
        cache keeps serving afterwards on the synchronous path."""
        self.db.close()
