"""qwen3-4b [hf:Qwen/Qwen3-8B family]: dense with qk_norm and GQA.

36 layers, d_model=2560, 32 heads (GQA kv=8), head_dim=128 (explicit, as in
Qwen3), d_ff=9728, vocab=151936, rope_theta=1e6.  A copy of the
reference's ``configs/qwen3_4b.py``.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3_4b",
    n_layers=36,
    d_model=2560,
    n_q=32,
    n_kv=8,
    d_ff=9728,
    vocab=151936,
    d_head=128,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
    subquadratic=False,
)

SMOKE = ModelConfig(
    name="qwen3_4b_smoke",
    n_layers=3,
    d_model=48,
    n_q=8,
    n_kv=2,
    d_ff=96,
    vocab=128,
    d_head=8,
    qk_norm=True,
    tie_embeddings=True,
)
