"""GQA attention: flash (prefill) and paged (decode) CUDA kernels, each
beside its plain PyTorch version.

Counterpart of ``repro.kernels.flash_attention`` / ``paged_attention`` and
of their oracles ``repro.kernels.ref.flash_attention_ref`` /
``paged_attention_ref``.  Layouts are the reference's:
  flash: q (B, Sq, H, dh); k, v (B, Sk, KH, dh)         -> (B, Sq, H, dh)
  paged: q (B, H, dh); k/v pages (n_phys, page, KH, dh);
         block_tables (B, P) int32; lengths (B,) int32 -> (B, H, dh)
Query head h reads KV head h // (H // KH).  Scores are scaled by dh^-0.5
and masked with -1e30; the softmax runs in float32 and the output comes
back in q's dtype (float32 or bfloat16).

The plain versions are the ``ref.py`` formulas and stand as the contract;
``flash_cuda`` and ``paged_cuda`` launch ``csrc/attention.cu`` and each adds
one to :data:`LAUNCHES` where it launches (a ``paged_cuda`` call is two
kernel launches, the split pass and the combine, counted once).
:func:`paged_splits` sizes the paged kernel's grid, and
:func:`paged_split_plain` repeats that kernel's split-and-combine
arithmetic for the tests; no path calls it.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from .. import _build

# kernel launches by wrapper (see ops.launch_counts)
LAUNCHES = {"flash_attention": 0, "paged_attention": 0}

NEG = -1e30
MAX_DH = 256
MAX_PAGE = 128
MAX_GROUP = 32
# (head, 16-byte chunk) outputs one paged block holds: 8 a thread x 128
PAGED_MAX_PAIRS = 1024
SPLIT_MIN_KEYS = 64     # positions a paged split covers at the least
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ------------------------------------------------------------ plain versions
def flash_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool = True, window: int = 0) -> torch.Tensor:
    """``flash_attention_ref``: GQA attention with a causal and/or window
    mask, in float32."""
    B, Sq, H, dh = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    qg = q.float().reshape(B, Sq, KH, G, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * dh ** -0.5
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= kpos > qpos - window
    p = torch.softmax(torch.where(ok, s, NEG), dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, dh).to(q.dtype)


def paged_plain(q: torch.Tensor, k_pages: torch.Tensor,
                v_pages: torch.Tensor, block_tables: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
    """``paged_attention_ref``: one-token GQA attention over the pages of
    each row's block table, positions >= length masked, in float32."""
    B, H, dh = q.shape
    _, page, KH, _ = k_pages.shape
    G = H // KH
    P = block_tables.shape[1]
    bt = block_tables.long()
    k = k_pages[bt].reshape(B, P * page, KH, dh).float()
    v = v_pages[bt].reshape(B, P * page, KH, dh).float()
    s = torch.einsum("bkgd,bskd->bkgs", q.float().reshape(B, KH, G, dh),
                     k) * dh ** -0.5
    mask = torch.arange(P * page, device=q.device)[None] \
        < lengths.long()[:, None]
    p = torch.softmax(torch.where(mask[:, None, None], s, NEG), dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v)
    return out.reshape(B, H, dh).to(q.dtype)


def paged_splits(KH: int, P: int, page: int, n_sm: int) -> Tuple[int, int]:
    """``(splits, pps)``: the paged kernel's grid is (splits, KH, B), and
    split ``s`` covers pages ``[s * pps, (s + 1) * pps)`` of each row.

    A pure function of the shape and the card's SM count: the lengths never
    enter, so a shape always gets the same split.  The batch size does not
    enter either, so a row's split, and with it the order of its sums, is
    the same whatever else is in the batch.  ``pps`` is the larger of the
    pages that make 64 positions and ``P * KH // n_sm``: a single row then
    fills the card's SMs with blocks whenever splits of 64 positions allow
    it, and ``splits * pps >= P`` with no split left empty.
    """
    pps = min(P, max(-(-SPLIT_MIN_KEYS // page), P * KH // n_sm))
    return -(-P // pps), pps


def paged_split_plain(q: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, block_tables: torch.Tensor,
                      lengths: torch.Tensor, pps: int) -> torch.Tensor:
    """The paged kernel's arithmetic in plain PyTorch, for the tests: per
    split of ``pps`` pages, (m, l, acc) of a softmax over the split's live
    positions (below ``ceil(length / page)`` pages, or all P at length 0),
    then the live splits merged in increasing order."""
    B, H, dh = q.shape
    _, page, KH, _ = k_pages.shape
    G = H // KH
    P = block_tables.shape[1]
    splits = -(-P // pps)
    n = splits * pps * page
    bt = block_tables.long()
    k = k_pages[bt].reshape(B, P * page, KH, dh).float()
    v = v_pages[bt].reshape(B, P * page, KH, dh).float()
    s = torch.einsum("bkgd,bskd->bkgs", q.float().reshape(B, KH, G, dh),
                     k) * dh ** -0.5
    ln = lengths.long()
    n_pages = torch.where(ln > 0, torch.clamp((ln + page - 1) // page,
                                              max=P), P)
    pos = torch.arange(n, device=q.device)
    s = torch.nn.functional.pad(s, (0, n - P * page))
    s = torch.where((pos[None] < ln[:, None])[:, None, None], s, NEG)
    s = torch.where((pos[None] < (n_pages * page)[:, None])[:, None, None],
                    s, -torch.inf)                   # pages never read
    s = s.reshape(B, KH, G, splits, pps * page)
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, n - P * page))
    m = s.amax(-1).clamp_min(NEG)                    # the kernel starts at NEG
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bkgcn,bcnkd->bkgcd", p,
                       v.reshape(B, splits, pps * page, KH, dh))
    live = (torch.arange(splits, device=q.device)[None] * pps
            < n_pages[:, None])[:, None, None]       # (B, 1, 1, splits)
    M = torch.where(live, m, -torch.inf).amax(-1, keepdim=True)
    w = torch.where(live, torch.exp(m - M), 0.0)
    out = (w[..., None] * acc).sum(-2) \
        / (w * l).sum(-1).clamp_min(1e-30)[..., None]
    return out.reshape(B, H, dh).to(q.dtype)


# ------------------------------------------------------------ CUDA wrappers
def _check(name: str, dev: torch.device, dtype: torch.dtype, **tensors):
    for arg, t in tensors.items():
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} must be on {dev}, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _check_heads(name: str, H: int, KH: int, dh: int) -> None:
    if KH < 1 or H % KH:
        raise ValueError(f"{name}: {H} query heads over {KH} KV heads")
    if not 1 <= dh <= MAX_DH:
        raise ValueError(f"{name}: head dim {dh} outside [1, {MAX_DH}]")


def flash_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool = True, window: int = 0) -> torch.Tensor:
    """:func:`flash_plain` on the card (``flash_attention_launch``)."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention: unsupported dtype {q.dtype}")
    _check("flash_attention", q.device, q.dtype, q=q, k=k, v=v)
    B, Sq, H, dh = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    if k.shape != (B, Sk, KH, dh) or v.shape != k.shape or Sk < 1:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    _check_heads("flash_attention", H, KH, dh)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = _build.load("attention")
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk, H, KH, dh, int(causal), int(window), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check("attention", rc, "flash_attention")
    with _build.COUNT_LOCK:
        LAUNCHES["flash_attention"] += 1
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def paged_cuda(q: torch.Tensor, k_pages: torch.Tensor,
               v_pages: torch.Tensor, block_tables: torch.Tensor,
               lengths: torch.Tensor) -> torch.Tensor:
    """:func:`paged_plain` on the card (``paged_attention_launch``: the
    split pass over a :func:`paged_splits` grid, then the combine).  Reads
    block-table entries only for pages below ``ceil(length / page)``."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"paged_attention: unsupported dtype {q.dtype}")
    _check("paged_attention", q.device, q.dtype, q=q, k_pages=k_pages,
           v_pages=v_pages)
    _check("paged_attention", q.device, torch.int32,
           block_tables=block_tables, lengths=lengths)
    B, H, dh = q.shape
    _, page, KH, _ = k_pages.shape
    P = block_tables.shape[1]
    if (k_pages.shape[3] != dh or v_pages.shape != k_pages.shape
            or block_tables.shape != (B, P) or lengths.shape != (B,)):
        raise ValueError(f"paged_attention: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, "
                         f"block_tables {tuple(block_tables.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    _check_heads("paged_attention", H, KH, dh)
    if not 1 <= page <= MAX_PAGE or H // KH > MAX_GROUP or P < 1:
        raise ValueError(f"paged_attention: page {page} (at most "
                         f"{MAX_PAGE}), group {H // KH} (at most "
                         f"{MAX_GROUP}), {P} pages per row")
    chunks = -(-dh * q.element_size() // 16)
    if H // KH * chunks > PAGED_MAX_PAIRS:
        raise ValueError(f"paged_attention: group {H // KH} x {chunks} "
                         f"16-byte chunks of a head ({dh} x {q.dtype}) "
                         f"exceeds the {PAGED_MAX_PAIRS} outputs one block "
                         f"holds")
    out = torch.empty_like(q)
    if B == 0:
        return out
    splits, pps = paged_splits(KH, P, page, _sm_count(q.device.index or 0))
    part_acc = torch.empty((B, H, splits, dh), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B, H, splits, 2), dtype=torch.float32,
                          device=q.device)
    lib = _build.load("attention")
    with torch.cuda.device(q.device):
        rc = lib.paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), part_acc.data_ptr(),
            part_ml.data_ptr(), out.data_ptr(), B, H, KH, dh, page, P, pps,
            splits, _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check("attention", rc, "paged_attention")
    with _build.COUNT_LOCK:
        LAUNCHES["paged_attention"] += 1
    return out
