"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base].

24 layers, d_model=1024, 16 heads (GQA kv=8), expert d_ff=512, vocab=49155,
MoE 32 experts top-8.  EP: experts sharded over the model axis.
A copy of the reference's ``configs/granite_moe_1b_a400m.py``.
"""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite_moe_1b_a400m",
    n_layers=24,
    d_model=1024,
    n_q=16,
    n_kv=8,
    d_ff=512,
    vocab=49155,
    d_head=64,
    moe=MoEConfig(num_experts=32, top_k=8, capacity_factor=1.25),
    tie_embeddings=True,
    subquadratic=False,
)

SMOKE = ModelConfig(
    name="granite_moe_1b_a400m_smoke",
    n_layers=3,
    d_model=32,
    n_q=4,
    n_kv=2,
    d_ff=32,
    vocab=128,
    d_head=8,
    moe=MoEConfig(num_experts=8, top_k=4, capacity_factor=1.25),
    tie_embeddings=True,
)
