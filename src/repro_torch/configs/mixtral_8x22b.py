"""mixtral-8x22b [arXiv:2401.04088]: 8-expert top-2 MoE with sliding-window
attention.

56 layers, d_model=6144, 48 heads (GQA kv=8), head_dim=128, expert d_ff=16384,
vocab=32768, SWA window 4096.  ~141 B total / ~39 B active parameters —
requires FSDP+TP+EP sharding to fit (the reference's launch/sharding.py).
Note: SWA everywhere is technically sub-quadratic, but the assignment's
long_500k set is SSM/hybrid/linear-attn only — mixtral reports 3 shapes.
A copy of the reference's ``configs/mixtral_8x22b.py``.
"""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral_8x22b",
    n_layers=56,
    d_model=6144,
    n_q=48,
    n_kv=8,
    d_ff=16384,
    vocab=32768,
    d_head=128,
    layer_pattern=("lattn",) * 56,
    window=4096,
    moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25),
    tie_embeddings=False,
    subquadratic=False,
)

SMOKE = ModelConfig(
    name="mixtral_8x22b_smoke",
    n_layers=3,
    d_model=32,
    n_q=8,
    n_kv=2,
    d_ff=64,
    vocab=128,
    d_head=8,
    layer_pattern=("lattn",) * 3,
    window=8,
    moe=MoEConfig(num_experts=4, top_k=2, capacity_factor=1.25),
    tie_embeddings=False,
)
