"""Pair merge of two sorted key columns: CUDA kernel and its plain version.

Counterpart of ``repro.kernels.merge_path`` as composed by
``repro.kernels.ops.merge_runs_tiled`` (``kernels/ops.py:125-183``): given
two sorted int64 key columns ``a`` and ``b`` (order-mapped u64 keys, see
:mod:`repro_torch.kernels.ops`), return the merged keys and, per output
slot, the source row, with bit 31 set for rows of ``b``.  Equal keys come
a-first, and within one input by row.  Each input holds at most 2^31 - 1
rows, the reference's limit.

The plain version scatters each element to its rank: ``a[i]`` lands at
``i + lower_bound(b, a[i])`` and ``b[j]`` at ``j + upper_bound(a, b[j])``,
with ``torch.searchsorted``, and stands as the contract.
:func:`merge_pair_cuda` launches ``csrc/merge.cu``, which cuts the output
into tiles of :data:`TILE` slots at the merge-path splits that
:func:`merge_path_splits_plain` computes and merges each tile in shared
memory; it adds one to :data:`LAUNCHES` where it launches (a merge of
:data:`SPLIT_TILES` tiles or more first runs a split kernel: two launches,
counted once) and appends ``(na, nb)`` to :data:`LAUNCH_SIZES`.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from .. import _build

FROM_B = 1 << 31
MAX_ROWS = (1 << 31) - 1
TILE = 2048        # outputs a block of merge_tile_kernel merges
SPLIT_TILES = 2048  # tiles from which a split pass searches the tile ends

# kernel launches by wrapper (see ops.launch_counts)
LAUNCHES = {"merge_pair": 0}
# (na, nb) of every merge_pair launch, in order (see ops.launch_sizes)
LAUNCH_SIZES: Dict[str, List[Tuple[int, int]]] = {"merge_pair": []}


def _check_rows(na: int, nb: int) -> None:
    if na > MAX_ROWS or nb > MAX_ROWS:
        raise ValueError(f"merge_pair takes at most {MAX_ROWS} rows per "
                         f"input, got {na} and {nb}")


def merge_work(na: int, nb: int) -> Tuple[int, int]:
    """``(operations, bytes)`` of a merge: each key's rank by a binary
    search of the other column, the keys read and the keys and sources
    written once."""
    n = na + nb
    return (n * 4 + 5 * (na * math.ceil(math.log2(nb + 1))
                         + nb * math.ceil(math.log2(na + 1))), n * 8 + n * 16)


def merge_pair_plain(a: torch.Tensor, b: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(merged keys, source) of two sorted int64 key columns."""
    na, nb = a.numel(), b.numel()
    _check_rows(na, nb)
    dev = a.device
    pos_a = torch.arange(na, device=dev) + torch.searchsorted(b, a)
    pos_b = torch.arange(nb, device=dev) + torch.searchsorted(a, b, right=True)
    keys = torch.empty(na + nb, dtype=torch.int64, device=dev)
    src = torch.empty(na + nb, dtype=torch.int64, device=dev)
    keys[pos_a] = a
    keys[pos_b] = b
    src[pos_a] = torch.arange(na, device=dev)
    src[pos_b] = torch.arange(nb, device=dev) | FROM_B
    return keys, src


def tile_diagonals(n: int, tile: int = TILE) -> torch.Tensor:
    """The output diagonals the tiles start at, and ``n``: ``ceil(n /
    tile) + 1`` values, ``min(t * tile, n)``."""
    n_tiles = -(-n // tile)
    return torch.clamp(torch.arange(n_tiles + 1, dtype=torch.int64) * tile,
                       max=n)


def merge_path_splits_plain(a: torch.Tensor, b: torch.Tensor,
                            tile: int = TILE) -> torch.Tensor:
    """Elements of ``a`` among the first ``d`` outputs of the merge
    (a-first on ties) at every tile diagonal ``d``: where each tile of
    ``merge_tile_kernel`` starts and ends, by a binary search run for all
    diagonals at once."""
    na, nb = a.numel(), b.numel()
    d = tile_diagonals(na + nb, tile).to(a.device)
    lo = torch.clamp(d - nb, min=0)
    hi = torch.clamp(d, max=na)
    while bool((lo < hi).any()):
        live = lo < hi
        mid = lo + ((hi - lo) >> 1)
        ka = a[torch.clamp(mid, max=max(na - 1, 0))] if na else mid
        kb = b[torch.clamp(d - 1 - mid, 0, max(nb - 1, 0))] if nb else mid
        go_right = live & (ka <= kb)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(live & ~go_right, mid, hi)
    return lo


def merge_pair_cuda(a: torch.Tensor, b: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`merge_pair_plain` on the card (``merge_pair_launch``)."""
    for name, t in (("a", a), ("b", b)):
        if t.device != a.device or t.device.type != "cuda":
            raise ValueError(f"{name} must be on {a.device}, got {t.device}")
        if t.dtype != torch.int64:
            raise TypeError(f"{name} must be int64, got {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor")
    na, nb = a.numel(), b.numel()
    _check_rows(na, nb)
    keys = torch.empty(na + nb, dtype=torch.int64, device=a.device)
    src = torch.empty(na + nb, dtype=torch.int64, device=a.device)
    if na + nb == 0:
        return keys, src
    lib = _build.load("merge")
    if lib.merge_tile_size() != TILE:
        raise RuntimeError(f"merge.cu merges tiles of {lib.merge_tile_size()}"
                           f" outputs, merge.py sizes them as {TILE}")
    n_tiles = -(-(na + nb) // TILE)
    splits = torch.empty(n_tiles + 1, dtype=torch.int64, device=a.device) \
        if n_tiles >= SPLIT_TILES else None
    with torch.cuda.device(a.device):
        rc = lib.merge_pair_launch(
            a.data_ptr(), na, b.data_ptr(), nb,
            None if splits is None else splits.data_ptr(), keys.data_ptr(),
            src.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check("merge", rc, "merge_pair")
    with _build.COUNT_LOCK:
        LAUNCHES["merge_pair"] += 1
        LAUNCH_SIZES["merge_pair"].append((na, nb))
    return keys, src
