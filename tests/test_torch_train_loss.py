"""The port's training loss and gradients against the JAX reference:
dense and local-attention families.

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

ARCHS = ["smollm_135m", "qwen3_4b", "minicpm_2b", "gemma3_1b"]


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


ATTN_CASES = {
    # (B, Sq, Sk, H, KH, dh, causal, window, k_len, q_chunk, q from)
    "causal_gqa_q_chunks": (2, 16, 16, 6, 2, 8, True, None, None, 4, 0),
    "window_one_q_chunk": (2, 12, 12, 4, 4, 8, True, 5, None, 1024, 0),
    "non_causal_cross": (2, 8, 20, 4, 1, 16, False, None, None, 1024, 0),
    "one_query_grouped": (3, 1, 20, 8, 2, 8, True, 6, 15, 1024, 14),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_gqa_attention_and_its_gradient_match_jax(case):
    """layers.gqa_attention (the training attention) against the
    reference's: outputs and the gradients of q, k and v of a weighted
    sum, float32, within 1e-5 of max(1, |reference|); the q-chunked, the
    windowed (k_len cut), the non-causal and the one-query grouped
    routes."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.models import layers as RL
    from repro_torch.models import layers as L
    B, Sq, Sk, H, KH, dh, causal, window, k_len, q_chunk, q0 = \
        ATTN_CASES[case]
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Sq, H, dh), (B, Sk, KH, dh), (B, Sk, KH, dh)))
    w = rng.standard_normal((B, Sq, H, dh)).astype(np.float32)
    qpos = np.broadcast_to(np.arange(q0, q0 + Sq, dtype=np.int32),
                           (B, Sq)).copy()
    kpos = np.arange(Sk, dtype=np.int32)[None] - (2 if k_len else 0)
    kw = dict(causal=causal, window=window, q_chunk=q_chunk)

    def ref(q, k, v):
        o = RL.gqa_attention(q, k, v, q_positions=jnp.asarray(qpos),
                             k_positions=jnp.asarray(kpos),
                             k_len=None if k_len is None
                             else jnp.asarray(k_len), **kw)
        return jnp.sum(o * w), o

    (_, want), want_g = jax.value_and_grad(ref, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = L.gqa_attention(qt, kt, vt, q_positions=torch.from_numpy(qpos),
                          k_positions=torch.from_numpy(kpos),
                          k_len=None if k_len is None
                          else torch.tensor(k_len), **kw)
    got_g = torch.autograd.grad((got * torch.from_numpy(w)).sum(),
                                (qt, kt, vt))
    for name, a, b in [("out", got, want)] + list(zip("qkv", got_g, want_g)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(b).max()),
                                   err_msg=name)
