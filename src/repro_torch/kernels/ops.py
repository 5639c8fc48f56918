"""Public kernel entry points: dispatch by device, launch counts, key map.

Counterpart of ``repro.kernels.ops`` for the store's three lanes (bloom
probe, bloom build, pair merge) and the model's two attention calls (flash
attention for prefill, paged attention for decode).  A CUDA tensor goes
to the hand-written kernel, which launches or raises; a CPU tensor goes to
the kernel's plain version.  There is no fallback from one to the other.

A tensor with no data (a fake tensor of ``FakeTensorMode``, or one on the
``meta`` device) takes a third route, the dry-run's: it gets empty outputs
of the kernel's shapes and dtypes and its work, counted from the shapes,
goes to every sink in :data:`WORK_SINKS` (``launch.trace_cost``).  That
route computes nothing, never reaches a kernel, and counts neither in the
launch counts nor in :data:`PLAIN_CALLS`: it stands in for no kernel and
for no plain version.

Keys on the device are int64 holding ``k ^ (1 << 63)`` for u64 key ``k``:
signed int64 order then equals unsigned u64 order, so ``torch.searchsorted``
and ``torch.sort`` work on them (torch has no ordering on uint64).  Signed
keys need no map at all: the reference's ``_to_u64_order`` flips their sign
bit, and flipping it back gives the int64 value itself.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .. import _build
from . import attention as _attention
from . import bloom as _bloom
from . import merge as _merge

SIGN = np.uint64(1 << 63)

# plain-version calls by entry point: the CPU twin of the launch counts
PLAIN_CALLS = {"bloom_probe": 0, "bloom_build": 0, "merge_pair": 0,
               "flash_attention": 0, "paged_attention": 0}


# the shape-only route's sinks: each is called with (entry point, operations,
# bytes, dtype of the products) once a call (see launch.trace_cost)
WORK_SINKS: list = []


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    with _build.COUNT_LOCK:
        return {**_bloom.LAUNCHES, **_merge.LAUNCHES, **_attention.LAUNCHES}


def launch_sizes() -> Dict[str, list]:
    """The elements of every store-kernel launch since the last reset:
    keys of each ``bloom_build``, ``(keys, filter words)`` of each
    ``bloom_probe``, ``(na, nb)`` of each ``merge_pair``."""
    with _build.COUNT_LOCK:
        return {name: list(v) for name, v in
                {**_bloom.LAUNCH_SIZES, **_merge.LAUNCH_SIZES}.items()}


def reset_launch_counts() -> None:
    with _build.COUNT_LOCK:
        for counts in (_bloom.LAUNCHES, _merge.LAUNCHES, _attention.LAUNCHES,
                       PLAIN_CALLS):
            for name in counts:
                counts[name] = 0
        for sizes in (_bloom.LAUNCH_SIZES, _merge.LAUNCH_SIZES):
            for name in sizes:
                sizes[name].clear()


# ------------------------------------------------------------- key map
def to_order(keys) -> np.ndarray:
    """Integer keys of any dtype -> order-preserving int64 (numpy)."""
    keys = np.asarray(keys)
    if keys.dtype == np.uint64:
        return (keys ^ SIGN).view(np.int64)
    if np.issubdtype(keys.dtype, np.unsignedinteger) \
            or np.issubdtype(keys.dtype, np.signedinteger):
        return keys.astype(np.int64)
    raise TypeError(f"integer keys required, got {keys.dtype}")


def from_order(mapped: np.ndarray, dtype=np.uint64) -> np.ndarray:
    """Invert :func:`to_order` back to ``dtype``."""
    mapped = np.asarray(mapped, dtype=np.int64)
    if np.dtype(dtype) == np.uint64:
        return mapped.view(np.uint64) ^ SIGN
    return mapped.astype(dtype)


def order_of(key: int) -> int:
    """One u64 key -> its order-mapped int64 value (a Python int)."""
    mapped = int(key) ^ (1 << 63)
    return mapped - (1 << 64) if mapped >= 1 << 63 else mapped


def keys_to_device(keys, device) -> torch.Tensor:
    """u64 keys (numpy or ints) -> order-mapped int64 tensor on ``device``."""
    mapped = to_order(np.asarray(keys, dtype=np.uint64))
    return torch.from_numpy(np.ascontiguousarray(mapped)).to(device)


def keys_from_device(keys: torch.Tensor) -> np.ndarray:
    """Order-mapped int64 tensor -> numpy uint64 keys."""
    return from_order(keys.cpu().numpy())


# ------------------------------------------------------------- dispatch
def shape_only(t: torch.Tensor) -> bool:
    """True for a tensor with no data: fake (``FakeTensorMode``) or meta."""
    if t.device.type == "meta":
        return True
    if type(t) is torch.Tensor:          # the hot path: a plain tensor
        return False
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(t)


def _route(t: torch.Tensor, name: str) -> str:
    """``"shape"`` for a tensor with no data, ``"kernel"`` for a CUDA
    tensor, ``"plain"`` for a CPU tensor (and counts it)."""
    if shape_only(t):
        return "shape"
    if t.device.type == "cuda":
        return "kernel"
    if t.device.type == "cpu":
        with _build.COUNT_LOCK:
            PLAIN_CALLS[name] += 1
        return "plain"
    raise ValueError(f"{name}: unsupported device {t.device}")


def _record(name: str, work: Tuple[int, int], dtype: torch.dtype) -> None:
    """The shape-only route's account of one call."""
    for sink in list(WORK_SINKS):
        sink(name, work[0], work[1], dtype)


def bloom_probe(keys: torch.Tensor, bits: torch.Tensor,
                k: int) -> torch.Tensor:
    """(n,) bool "maybe present" of order-mapped keys against a filter."""
    route = _route(keys, "bloom_probe")
    if route == "shape":
        _record("bloom_probe", _bloom.probe_work(keys.numel(), bits.numel(),
                                                 k), keys.dtype)
        return keys.new_empty(keys.shape, dtype=torch.bool)
    if route == "kernel":
        return _bloom.probe_cuda(keys, bits, k)
    return _bloom.probe_plain(keys, bits, k)


def bloom_build(keys: torch.Tensor, m_words: int, k: int) -> torch.Tensor:
    """(m_words,) int32 filter words holding every key."""
    route = _route(keys, "bloom_build")
    if route == "shape":
        _record("bloom_build", _bloom.build_work(keys.numel(), m_words, k),
                keys.dtype)
        return keys.new_empty((m_words,), dtype=torch.int32)
    if route == "kernel":
        return _bloom.build_cuda(keys, m_words, k)
    return _bloom.build_plain(keys, m_words, k)


def merge_pair(a: torch.Tensor, b: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merged keys and source rows (bit 31 = from ``b``), a-first on ties."""
    route = _route(a, "merge_pair")
    if route == "shape":
        _record("merge_pair", _merge.merge_work(a.numel(), b.numel()),
                a.dtype)
        n = a.numel() + b.numel()
        return a.new_empty((n,)), a.new_empty((n,))
    if route == "kernel":
        return _merge.merge_pair_cuda(a, b)
    return _merge.merge_pair_plain(a, b)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """GQA attention, q (B, Sq, H, dh) over k/v (B, Sk, KH, dh)."""
    route = _route(q, "flash_attention")
    if route == "shape":
        _record("flash_attention", _attention.flash_work(
            q.shape, k.shape, q.dtype, causal, window), q.dtype)
        return torch.empty_like(q, memory_format=torch.contiguous_format)
    if route == "kernel":
        return _attention.flash_cuda(q, k, v, causal=causal, window=window)
    return _attention.flash_plain(q, k, v, causal=causal, window=window)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """One-token GQA attention, q (B, H, dh), over a block-table page
    pool."""
    route = _route(q, "paged_attention")
    if route == "shape":
        _record("paged_attention", _attention.paged_work(
            q.shape, k_pages.shape, block_tables.shape, q.dtype), q.dtype)
        return torch.empty_like(q, memory_format=torch.contiguous_format)
    if route == "kernel":
        return _attention.paged_cuda(q, k_pages, v_pages, block_tables,
                                     lengths)
    return _attention.paged_plain(q, k_pages, v_pages, block_tables,
                                  lengths)


def paged_attention_partials(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor,
                             block_tables: torch.Tensor,
                             lengths: torch.Tensor):
    """The paged attention's split softmax statistics ``(acc, ml, live)``
    before the combine, for a merge across ranks
    (``attention.merge_partials``).  Without data the split count is an
    H100 SXM's (``bloom.H100_SMS``), as no card is asked."""
    route = _route(q, "paged_attention")
    if route == "shape":
        _record("paged_attention", _attention.paged_work(
            q.shape, k_pages.shape, block_tables.shape, q.dtype), q.dtype)
        B, H, dh = q.shape
        splits, _ = _attention.paged_splits(
            k_pages.shape[2], block_tables.shape[1], k_pages.shape[1],
            _bloom.H100_SMS)
        return (q.new_empty((B, H, splits, dh), dtype=torch.float32),
                q.new_empty((B, H, splits, 2), dtype=torch.float32),
                q.new_empty((B, splits), dtype=torch.bool))
    if route == "kernel":
        return _attention.paged_partials_cuda(q, k_pages, v_pages,
                                              block_tables, lengths)
    return _attention.paged_partials_plain(q, k_pages, v_pages, block_tables,
                                           lengths)
