"""smollm-135m [hf:HuggingFaceTB/SmolLM-135M]: llama-arch small.

30 layers, d_model=576, 9 heads (GQA kv=3), d_ff=1536, vocab=49152.
A copy of the reference's ``configs/smollm_135m.py``.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm_135m",
    n_layers=30,
    d_model=576,
    n_q=9,
    n_kv=3,
    d_ff=1536,
    vocab=49152,
    d_head=64,
    tie_embeddings=True,
    subquadratic=False,
)

SMOKE = ModelConfig(
    name="smollm_135m_smoke",
    n_layers=3,
    d_model=48,
    n_q=6,
    n_kv=2,
    d_ff=96,
    vocab=128,
    d_head=8,
    tie_embeddings=True,
)
