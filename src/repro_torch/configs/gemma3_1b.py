"""gemma3-1b [hf:google/gemma-3-1b-pt]: 5:1 local:global attention, 128k ctx.

26 layers, d_model=1152, 4 heads (GQA kv=1), head_dim=256, d_ff=6912,
vocab=262144, sliding window 512, qk_norm.  Pattern: (5 local, 1 global) x 4
+ 2 local.  Sub-quadratic enough for long_500k: local layers cache only their
512-token window; the few global layers keep the full 500k KV, which at
global_batch=1 is ~3 GB sharded — exact attention, no eviction needed
(DESIGN.md §6).  4 query heads do not divide the 16-way model axis: TP rules
fall back to replicated attention projections.
A copy of the reference's ``configs/gemma3_1b.py``.
"""
from ..models.config import ModelConfig

_PATTERN = (("lattn",) * 5 + ("attn",)) * 4 + ("lattn",) * 2

CONFIG = ModelConfig(
    name="gemma3_1b",
    n_layers=26,
    d_model=1152,
    n_q=4,
    n_kv=1,
    d_ff=6912,
    vocab=262144,
    d_head=256,
    layer_pattern=_PATTERN,
    window=512,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
    subquadratic=True,
)

SMOKE = ModelConfig(
    name="gemma3_1b_smoke",
    n_layers=8,
    d_model=32,
    n_q=4,
    n_kv=1,
    d_ff=64,
    vocab=128,
    d_head=8,
    layer_pattern=(("lattn",) * 3 + ("attn",)) * 2,
    window=8,
    qk_norm=True,
    tie_embeddings=True,
    subquadratic=True,
)
