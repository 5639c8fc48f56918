"""Pair merge of two sorted key columns: CUDA kernel and its plain version.

Counterpart of ``repro.kernels.merge_path`` as composed by
``repro.kernels.ops.merge_runs_tiled`` (``kernels/ops.py:125-183``): given
two sorted int64 key columns ``a`` and ``b`` (order-mapped u64 keys, see
:mod:`repro_torch.kernels.ops`), return the merged keys and, per output
slot, the source row, with bit 31 set for rows of ``b``.  Equal keys come
a-first, and within one input by row.  Each input holds at most 2^31 - 1
rows, the reference's limit.

Both versions scatter each element to its rank: ``a[i]`` lands at
``i + lower_bound(b, a[i])`` and ``b[j]`` at ``j + upper_bound(a, b[j])``.
The plain version does it with ``torch.searchsorted`` and stands as the
contract; :func:`merge_pair_cuda` launches ``csrc/merge.cu`` and adds one
to :data:`LAUNCHES` where it launches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import _build

FROM_B = 1 << 31
MAX_ROWS = (1 << 31) - 1

# kernel launches by wrapper (see ops.launch_counts)
LAUNCHES = {"merge_pair": 0}


def _check_rows(na: int, nb: int) -> None:
    if na > MAX_ROWS or nb > MAX_ROWS:
        raise ValueError(f"merge_pair takes at most {MAX_ROWS} rows per "
                         f"input, got {na} and {nb}")


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
    with torch.cuda.device(a.device):
        rc = lib.merge_pair_launch(
            a.data_ptr(), na, b.data_ptr(), nb, keys.data_ptr(),
            src.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check("merge", rc, "merge_pair")
    LAUNCHES["merge_pair"] += 1
    return keys, src
