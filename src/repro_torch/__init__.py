"""PyTorch + CUDA port of the Autumn LSM store and of the serving path over
it (the ``repro`` package is the JAX reference and is never imported here).

The store's runs live on the device; the bloom probe, the bloom build and
the compaction pair merge are hand-written CUDA kernels for Hopper
(``csrc/``), each beside its plain PyTorch version in ``kernels/``.  The
serving path (``serve.ServeEngine`` over ``kvcache.AutumnKVCache`` and the
``models`` of every family of the reference) runs prefill, cross-attention
and encoder attention on the flash-attention kernel and self-attention
decode on the paged-attention kernel.
"""
from .core import LSMConfig, LSMStore, columns_of, store_from_columns

__all__ = ["LSMConfig", "LSMStore", "columns_of", "store_from_columns"]
