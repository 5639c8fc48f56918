from .autumnkv import PAGE_TOKENS, AutumnKVCache, CacheCodec, chain_hashes

__all__ = ["PAGE_TOKENS", "AutumnKVCache", "CacheCodec", "chain_hashes"]
