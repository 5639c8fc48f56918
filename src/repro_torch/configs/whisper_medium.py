"""whisper-medium [arXiv:2212.04356]: enc-dec audio transformer backbone.

24 decoder layers (self+cross+mlp), 24 encoder layers, d_model=1024, 16 heads
(MHA: kv=16), d_ff=4096, vocab=51865.  The conv audio frontend is a STUB per
the assignment: input_specs() provides precomputed frame embeddings
(B, 1500, 1024).  Deviation noted in DESIGN.md: decoder self-attn uses RoPE
instead of learned absolute positions (backbone-only fidelity; enables the
32k-sequence assigned shapes, which exceed whisper's native 448 positions).
A copy of the reference's ``configs/whisper_medium.py``.
"""
from ..models.config import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper_medium",
    n_layers=24,
    d_model=1024,
    n_q=16,
    n_kv=16,
    d_ff=4096,
    vocab=51865,
    d_head=64,
    layer_pattern=("wdec",) * 24,
    encoder=EncoderConfig(n_layers=24, n_heads=16, d_ff=4096, seq_len=1500),
    tie_embeddings=True,
    subquadratic=False,
)

SMOKE = ModelConfig(
    name="whisper_medium_smoke",
    n_layers=3,
    d_model=32,
    n_q=4,
    n_kv=4,
    d_ff=64,
    vocab=128,
    d_head=8,
    layer_pattern=("wdec",) * 3,
    encoder=EncoderConfig(n_layers=2, n_heads=4, d_ff=64, seq_len=12),
    tie_embeddings=True,
)
