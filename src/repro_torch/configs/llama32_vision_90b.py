"""llama-3.2-vision-90b [hf:meta-llama/Llama-3.2-11B-Vision family].

100 layers, d_model=8192, 64 heads (GQA kv=8), head_dim=128, d_ff=28672,
vocab=128256.  Every 5th layer is a gated cross-attention image layer
(pattern: 4 self + 1 cross, x20).  The vision patch frontend is a STUB per
the assignment: input_specs() provides precomputed patch embeddings
(B, 1600, 8192).
A copy of the reference's ``configs/llama32_vision_90b.py``.
"""
from ..models.config import ModelConfig, VisionConfig

CONFIG = ModelConfig(
    name="llama32_vision_90b",
    n_layers=100,
    d_model=8192,
    n_q=64,
    n_kv=8,
    d_ff=28672,
    vocab=128256,
    d_head=128,
    layer_pattern=(("attn",) * 4 + ("xattn",)) * 20,
    vision=VisionConfig(n_img_tokens=1600, xattn_every=5),
    rope_theta=500_000.0,
    tie_embeddings=False,
    subquadratic=False,
)

SMOKE = ModelConfig(
    name="llama32_vision_90b_smoke",
    n_layers=5,
    d_model=32,
    n_q=8,
    n_kv=2,
    d_ff=64,
    vocab=128,
    d_head=8,
    layer_pattern=("attn", "attn", "attn", "attn", "xattn"),
    vision=VisionConfig(n_img_tokens=8, xattn_every=5),
    tie_embeddings=False,
)
