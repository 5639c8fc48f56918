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
two shards under one budget of two background workers, a 4 MiB block
cache shared by the shards and a 2 MiB pinned L0.  Page keys lie below
2^63 and state records above it, so the default splitter (2^63) puts
every page on shard 0 and every state record on shard 1.  With a
``Telemetry`` on the store (``lsm_config=LSMConfig(..., telemetry=...)``)
``stats()`` adds per-op latency summaries and the trace's event count.

Rings longer than their prompt are paged; rings the prompt wrapped are not.
A ``kv_seq`` leaf holds a ring of ``min(window, s_max)`` slots (``s_max``
for global attention), and the reference slices slots ``[64 i, 64 i + 64)``
into page ``i``.  Once a prompt is longer than a ring, those slots hold the
prompt's last positions, not page ``i``'s, and a second prompt sharing page
``i`` would restore another prompt's keys (the reference's fault, ROADMAP
C8).  The port pages a leaf only while the prompt fits in it, which keeps
the blobs byte-identical to the reference's there; a leaf the prompt
wrapped goes whole into the full-prompt state record, keyed by the whole
prompt's hash.  Page blobs of such a prompt hold fewer leaves, so their
keys are the chain hashes salted with the number of ring extents the
prompt wrapped: prompts share a page blob only when it has the same
layout.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import LSMConfig, make_store
from ..core.types import splitmix64
from ..models import model as M
from ..models.config import ModelConfig
from ..models.params import tree_leaves, tree_map

PAGE_TOKENS = 64
Pytree = Any
_STATE_TAG = np.uint64(1) << np.uint64(63)
_PAGE_MASK = (np.uint64(1) << np.uint64(63)) - np.uint64(1)
_SALT = 0x9E3779B97F4A7C15


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
    """The reference's AutumnKV store configuration: hot page blocks served
    from the shared cache, L0 pinned so fresh inserts stay resident,
    page-insert bursts after prefill returning without paying flush or
    compaction, and two shards under one budget of two workers."""
    return LSMConfig(policy="garnering", T=2.0, c=0.8, memtable_bytes=1 << 20,
                     base_level_bytes=8 << 20, bits_per_key=10,
                     bloom_allocation="monkey",
                     cache_bytes=4 << 20, pin_l0_bytes=2 << 20,
                     async_compaction=True, shards=2, compaction_workers=2)


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
        specs = [spec for _, spec in tree_leaves(
            M.cache_table(self.cfg, self.batch, self.s_max),
            lambda x: isinstance(x, M.CacheSpec))]
        self.logical = [spec.logical for spec in specs]
        # the distinct extents of the kv_seq rings, ascending
        self.ring_extents = sorted({spec.shape[ax] for spec in specs
                                    if (ax := _kv_axis(spec.logical))
                                    is not None})

    def leaves(self, cache: Pytree):
        """(path, tensor, logical axes) in JAX's leaf order."""
        return [(p, t, lg) for (p, t), lg in zip(tree_leaves(cache),
                                                 self.logical)]

    def wrapped_extents(self, prompt_len: int) -> int:
        """How many ring extents a prompt of ``prompt_len`` tokens wraps."""
        return sum(e < prompt_len for e in self.ring_extents)

    @staticmethod
    def _paged_axis(leaf: torch.Tensor, lg, prompt_len: int):
        """The leaf's kv_seq axis if it is paged for this prompt, else
        None (not a ring, or a ring the prompt wrapped)."""
        ax = _kv_axis(lg)
        if ax is None or leaf.shape[ax] < prompt_len:
            return None
        return ax

    def _page_slices(self, cache: Pytree, page_idx: int, prompt_len: int,
                     page: int):
        for _, leaf, lg in self.leaves(cache):
            ax = self._paged_axis(leaf, lg, prompt_len)
            if ax is None:
                continue
            lo = page_idx * page
            if lo < leaf.shape[ax]:
                yield leaf.narrow(ax, lo, min(page, leaf.shape[ax] - lo))

    def _state_leaves(self, cache: Pytree, prompt_len: int):
        return [leaf for _, leaf, lg in self.leaves(cache)
                if self._paged_axis(leaf, lg, prompt_len) is None]

    def page_bytes(self, cache: Pytree, page_idx: int, prompt_len: int,
                   page: int = PAGE_TOKENS) -> bytes:
        """Serialize the kv_seq slice [page_idx*page, (page_idx+1)*page) of
        every ring a prompt of ``prompt_len`` tokens fits in."""
        parts = [_bytes_of(s) for s in self._page_slices(
            cache, page_idx, prompt_len, page)]
        if not parts:
            return b""
        return torch.cat(parts).cpu().numpy().tobytes()

    def state_bytes(self, cache: Pytree, prompt_len: int) -> bytes:
        """Serialize every non-paged leaf: the position, recurrent states,
        conv tails, cross-attention K/V, and each ring a prompt of
        ``prompt_len`` tokens wrapped, whole."""
        parts = [_bytes_of(leaf) for leaf in self._state_leaves(cache,
                                                                prompt_len)]
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
                   prompt_len: int, page: int = PAGE_TOKENS) -> Pytree:
        """Write a page blob into ``cache`` in place; returns ``cache``."""
        self._fill(list(self._page_slices(cache, page_idx, prompt_len,
                                          page)), blob)
        return cache

    def write_state(self, cache: Pytree, blob: bytes,
                    prompt_len: int) -> Pytree:
        """Write a state blob into ``cache`` in place; returns ``cache``."""
        self._fill(self._state_leaves(cache, prompt_len), blob)
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
        self.db = make_store(lsm_config or store_config(), device=device)
        self.hits = 0
        self.misses = 0
        self.pages_written = 0
        self.pages_deduped = 0

    # ------------------------------------------------------------ interface
    def page_keys(self, tokens: np.ndarray) -> List[int]:
        """The store keys of a prompt's pages: its chain hashes, salted
        with the count of ring extents the prompt wraps where it wraps any
        (the page blobs then hold fewer leaves)."""
        hs = chain_hashes(tokens, self.page)
        n = self.codec.wrapped_extents(len(tokens))
        if not n:
            return hs
        salt = np.uint64(n * _SALT % 2 ** 64)
        salted = splitmix64(np.asarray(hs, np.uint64) ^ salt) & _PAGE_MASK
        return [int(h) or 1 for h in salted]

    def _restore(self, template: Pytree, prompt_len: int, state_blob: bytes,
                 page_blobs: List[bytes]) -> Pytree:
        cache = tree_map(torch.clone, template)
        self.codec.write_state(cache, state_blob, prompt_len)
        for i, blob in enumerate(page_blobs):
            self.codec.write_page(cache, blob, i, prompt_len, self.page)
        return cache

    def lookup(self, tokens: np.ndarray,
               template: Pytree) -> Optional[Pytree]:
        """Full-prompt hit: a copy of ``template`` holding the prompt's
        stored cache, else None (a one-prompt :meth:`lookup_batch`, with
        the reference's hit and miss counts)."""
        return self.lookup_batch([tokens], template)[0]

    def lookup_batch(self, prompts: List[np.ndarray],
                     template: Pytree) -> List[Optional[Pytree]]:
        """Full-prompt hits of a serving wave: for each prompt, a copy of
        ``template`` holding its stored cache, or None.  Every prompt's
        state and page keys are resolved with ONE ``multi_get`` (split into
        one sub-wave a shard); hit/miss semantics and counters are the
        reference's."""
        metas: List[Tuple[List[int], bool, int]] = []
        all_keys: List[int] = []
        for tokens in prompts:
            hs = chain_hashes(tokens, self.page)
            ok = bool(hs) and len(tokens) % self.page == 0
            metas.append((hs, ok, len(tokens)))
            if ok:
                all_keys.append(int(np.uint64(hs[-1]) | _STATE_TAG))
                all_keys.extend(self.page_keys(tokens))
        blobs = self.db.multi_get(all_keys) if all_keys else []
        out: List[Optional[Pytree]] = []
        off = 0
        for hs, ok, n_tokens in metas:
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
            out.append(self._restore(template, n_tokens, state_blob,
                                     page_blobs))
        return out

    def insert(self, tokens: np.ndarray, cache: Pytree):
        hs = chain_hashes(tokens, self.page)
        n_tokens = len(tokens)
        for i, key in enumerate(self.page_keys(tokens)):
            if self.db.get(key) is not None:   # content-addressed dedup
                self.pages_deduped += 1
                continue
            self.db.put(key, self.codec.page_bytes(cache, i, n_tokens,
                                                   self.page))
            self.pages_written += 1
        if hs:
            self.db.put(int(np.uint64(hs[-1]) | _STATE_TAG),
                        self.codec.state_bytes(cache, n_tokens))
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
