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
one to :data:`LAUNCHES` where it launches.
"""
from __future__ import annotations

import torch

from .. import _build

# kernel launches by wrapper (see ops.launch_counts)
LAUNCHES = {"flash_attention": 0, "paged_attention": 0}

NEG = -1e30
MAX_DH = 128
MAX_PAGE = 128
MAX_GROUP = 32
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
    LAUNCHES["flash_attention"] += 1
    return out


def paged_cuda(q: torch.Tensor, k_pages: torch.Tensor,
               v_pages: torch.Tensor, block_tables: torch.Tensor,
               lengths: torch.Tensor) -> torch.Tensor:
    """:func:`paged_plain` on the card (``paged_attention_launch``).  Reads
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
    out = torch.empty_like(q)
    if B == 0:
        return out
    lib = _build.load("attention")
    with torch.cuda.device(q.device):
        rc = lib.paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), B,
            H, KH, dh, page, P, _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check("attention", rc, "paged_attention")
    LAUNCHES["paged_attention"] += 1
    return out
