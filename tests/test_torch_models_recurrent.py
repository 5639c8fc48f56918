"""repro_torch models against the JAX reference: mamba2_130m (Mamba-2 SSD) and recurrentgemma_2b (RG-LRU with local attention at G 4).

Prefill and eight decode steps (past ``s_max`` and past the smoke window,
so every ring wraps) on the smoke configs with the reference's weights:
logits at rtol = atol = 1e-4 in float32, the fp32 cache leaf for leaf, and
bfloat16 within the bounds of ``_torch_families.assert_logits_close``
(``BF16_SHARE`` states the wider ones and why).
"""
import pytest
import torch

from _torch_families import check_prefill_and_decode

# Six xdist workers share 8 cores with the reference's timing-bounded
# property tests: one intra-op thread per worker keeps them on time.
torch.set_num_threads(1)

ARCHS = ['mamba2_130m', 'recurrentgemma_2b']


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch, dtype):
    check_prefill_and_decode(arch, dtype)
