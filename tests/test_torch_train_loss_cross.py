"""The port's training loss and gradients against the JAX reference:
cross-attention families (whisper's encoder and decoder, llama32's gated
image layers).

Loss, ce, aux, zloss and every gradient leaf against
``jax.value_and_grad(repro.models.model.loss_fn)`` in float32 on the
smoke configs (B 2, S 16), within 1e-4 of max(1, |leaf|): the
whole-sequence loss, and the vocab-chunked loss (``loss_chunk`` 8, two
checkpointed chunks) under a ``loss_mask`` with zeros; the bf16 loss within the bound
stated in ``_torch_train``; and remat off, on and remat2 equal bit for
bit within the port.
"""
import pytest
import torch

from _torch_train import (check_bf16_loss, check_loss_and_grads,
                          remat_variants_equal)

# Six xdist workers share 8 cores with the reference's timing-bounded
# property tests: one intra-op thread per worker keeps them on time.
torch.set_num_threads(1)

ARCHS = ["whisper_medium", "llama32_vision_90b"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("loss_chunk,masked", [(1024, False), (8, True)],
                         ids=["whole", "chunked_masked"])
def test_loss_and_grads_match_jax(arch, loss_chunk, masked):
    check_loss_and_grads(arch, loss_chunk, masked)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_within_bound(arch):
    check_bf16_loss(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_variants_give_equal_bits(arch):
    # four layers of the arch's first kind: one stage of repeat 4, which
    # remat2 cuts into two groups of two
    remat_variants_equal(arch, 4)
