"""recurrentgemma-2b [arXiv:2402.19427]: Griffin — RG-LRU + local attention 1:2.

26 layers, d_model=2560, 10 heads (GQA kv=1), head_dim=256, d_ff=7680,
vocab=256000, window 2048.  Pattern: (rglru, rglru, lattn) x 8 + 2 rglru.
Sub-quadratic: O(1) recurrent state + bounded window KV => runs long_500k.
A copy of the reference's ``configs/recurrentgemma_2b.py``.
"""
from ..models.config import ModelConfig, RGLRUConfig

_PATTERN = (("rglru", "rglru", "lattn")) * 8 + ("rglru", "rglru")

CONFIG = ModelConfig(
    name="recurrentgemma_2b",
    n_layers=26,
    d_model=2560,
    n_q=10,
    n_kv=1,
    d_ff=7680,
    vocab=256000,
    d_head=256,
    layer_pattern=_PATTERN,
    window=2048,
    rglru=RGLRUConfig(width=2560, conv_width=4, power=8.0),
    tie_embeddings=True,
    subquadratic=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma_2b_smoke",
    n_layers=5,
    d_model=32,
    n_q=4,
    n_kv=1,
    d_ff=64,
    vocab=128,
    d_head=8,
    layer_pattern=("rglru", "rglru", "lattn", "rglru", "rglru"),
    window=8,
    rglru=RGLRUConfig(width=32, conv_width=4, power=8.0),
    tie_embeddings=True,
    subquadratic=True,
)
