"""minicpm-2b [arXiv:2404.06395]: dense llama-like, trained with the WSD
(warmup-stable-decay) schedule — implemented in the
reference's train/optimizer.py.

40 layers, d_model=2304, 36 heads (kv=36, MHA), d_ff=5760, vocab=122753.
A copy of the reference's ``configs/minicpm_2b.py``.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm_2b",
    n_layers=40,
    d_model=2304,
    n_q=36,
    n_kv=36,
    d_ff=5760,
    vocab=122753,
    d_head=64,
    tie_embeddings=True,
    subquadratic=False,
    # 36-head MHA at 32k under sequence parallelism: halve the attention
    # score working set so prefill_32k fits 16 GiB/chip (dry-run §Dry-run).
    q_chunk=512,
)

SMOKE = ModelConfig(
    name="minicpm_2b_smoke",
    n_layers=3,
    d_model=48,
    n_q=6,
    n_kv=6,
    d_ff=96,
    vocab=128,
    d_head=8,
    tie_embeddings=True,
)
