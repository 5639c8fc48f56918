"""mamba2-130m [arXiv:2405.21060]: attention-free SSD (state-space duality).

24 layers, d_model=768, no MLP (d_ff=0), vocab=50280, ssm_state=128.
Sub-quadratic: runs the long_500k shape (O(1) decode state).
A copy of the reference's ``configs/mamba2_130m.py``.
"""
from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2_130m",
    n_layers=24,
    d_model=768,
    n_q=1,
    n_kv=1,
    d_ff=0,
    vocab=50280,
    d_head=64,
    layer_pattern=("ssd",) * 24,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256),
    tie_embeddings=True,
    subquadratic=True,
)

SMOKE = ModelConfig(
    name="mamba2_130m_smoke",
    n_layers=3,
    d_model=32,
    n_q=1,
    n_kv=1,
    d_ff=0,
    vocab=128,
    d_head=16,
    layer_pattern=("ssd",) * 3,
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, chunk=8),
    tie_embeddings=True,
    subquadratic=True,
)
