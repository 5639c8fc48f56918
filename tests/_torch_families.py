"""Shared checks of the port's models against the JAX reference, for the
``test_torch_models*.py`` files (one file a family group, so that
pytest-xdist's ``--dist loadfile`` spreads the JAX compiles over workers).

Weights come from the reference's ``init_params(cfg, PRNGKey(0))`` and
cross through numpy (``params_from_numpy``); frontend extras come from
each package's ``stub_frontend_inputs`` with the same seed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.data import stub_frontend_inputs as ref_stub_frontend_inputs
from repro.models import model as RM
from repro.models.params import init_params as ref_init_params
from repro_torch.configs import get_smoke
from repro_torch.data import stub_frontend_inputs
from repro_torch.kernels import ops
from repro_torch.models import Model
from repro_torch.models.convert import params_from_numpy, tensor_to_numpy
from repro_torch.models.params import tree_leaves

# bfloat16 logits against the reference's, as a share of the largest real
# logit (the vocab padding excluded): 3e-2 where only roundings differ in
# order.  Wider bounds sit just above what these checks read (weights from
# PRNGKey(0), tokens from default_rng(0)): mamba2_130m 0.047 and
# recurrentgemma_2b 0.049, where bf16 rounding feeds the SSD and RG-LRU
# recurrences through the sequence.  That cause is shown in
# test_torch_train_loss_recurrent.py: with float32 inputs the port's scans
# sit a few ulp from the reference's (its order of additions is not at
# fault), and the reference's own bf16 logits move from its float32 ones
# by 0.066 (mamba2_130m) and 0.030 (recurrentgemma_2b), the size of these
# gaps.  mixtral_8x22b reads 0.123, where the router flips a choice: with
# routing that cannot flip (every expert chosen, nothing dropped;
# ``check_moe_routing_cannot_flip``) both MoE families read 0.017 and 0.014
# and are held at 3e-2.
BF16_SHARE = {"mamba2_130m": 6e-2, "recurrentgemma_2b": 6e-2,
              "mixtral_8x22b": 1.5e-1}


def assert_logits_close(got: torch.Tensor, want, dtype: str,
                        msg: str = "", vocab: int = 0,
                        bf16_share: float = 3e-2) -> None:
    """float32: rtol = atol = 1e-4.  bfloat16: max abs error <= 2e-2 of
    max(1, |want|) over every column; then, with ``vocab``, the padding
    columns equal and the real columns within ``bf16_share`` of max(1,
    largest real |want|)."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=msg)
        return
    err = float(np.abs(got - want).max())
    assert err <= 2e-2 * max(1.0, float(np.abs(want).max())), (msg, err)
    if vocab:
        np.testing.assert_array_equal(got[:, vocab:], want[:, vocab:])
        real = float(np.abs(got[:, :vocab] - want[:, :vocab]).max())
        scale = max(1.0, float(np.abs(want[:, :vocab]).max()))
        assert real <= bf16_share * scale, (msg, real, scale)


def reference_params(cfg):
    return jax.tree.map(np.asarray, ref_init_params(cfg, jax.random.PRNGKey(0)))


def extras_pair(cfg, ref_cfg, batch: int, seed: int = 0):
    """The same frontend extras for both packages (numpy, torch on the
    CPU); equal draws from the two ``stub_frontend_inputs``."""
    ours = stub_frontend_inputs(cfg, batch, seed)
    ref = ref_stub_frontend_inputs(ref_cfg, batch, seed)
    assert sorted(ours) == sorted(ref)
    for k in ours:
        np.testing.assert_array_equal(ours[k], ref[k])
    return ({k: jnp.asarray(v) for k, v in ref.items()},
            {k: torch.from_numpy(v) for k, v in ours.items()})


def check_prefill_and_decode(arch: str, dtype: str, share: float = None,
                             edit=lambda c: c) -> None:
    """``prefill`` of 2 x 16 tokens and eight ``decode_step``s (positions
    16..23: past ``s_max`` 20 and past the smoke window 8, so every ring
    wraps) against the reference, and the fp32 cache leaf for leaf; the
    smoke config passed through ``edit`` on both sides, bf16 within
    ``share`` (by default the arch's ``BF16_SHARE``)."""
    ref_cfg = dataclasses.replace(edit(ref_get_smoke(arch)),
                                  compute_dtype=dtype)
    cfg = dataclasses.replace(edit(get_smoke(arch)), compute_dtype=dtype)
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    model = Model(cfg, params_from_numpy(jax.tree.map(np.asarray,
                                                      ref_params), cfg,
                                         device="cpu"))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    ref_extras, extras = extras_pair(cfg, ref_cfg, 2)
    s_max = 20
    share = share or BF16_SHARE.get(arch, 3e-2)
    ops.reset_launch_counts()
    want, ref_cache = RM.prefill(ref_params, {"tokens": jnp.asarray(tokens),
                                              **ref_extras},
                                 ref_cfg, s_max=s_max)
    got, cache = model.prefill(torch.from_numpy(tokens), s_max, extras)
    assert got.shape == (2, cfg.vocab_padded)
    assert got.dtype == getattr(torch, dtype)
    assert_logits_close(got, want, dtype, "prefill", cfg.vocab, share)
    for step in range(8):
        t = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        want, ref_cache = RM.decode_step(ref_params, jnp.asarray(t),
                                         ref_cache, ref_cfg)
        got, cache = model.decode_step(torch.from_numpy(t), cache)
        assert_logits_close(got, want, dtype, f"decode step {step}",
                            cfg.vocab, share)
    assert int(cache["pos"]) == int(ref_cache["pos"]) == 24
    ref_leaves = list(tree_leaves(jax.tree.map(np.asarray, ref_cache)))
    got_leaves = list(tree_leaves(cache))
    assert [p for p, _ in got_leaves] == [p for p, _ in ref_leaves]
    for (path, a), (_, b) in zip(got_leaves, ref_leaves):
        a = tensor_to_numpy(a)       # bfloat16 comes back as its bits
        want_dtype = np.uint16 if b.dtype.name == "bfloat16" else b.dtype
        assert a.shape == b.shape and a.dtype == want_dtype, path
        if dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                       err_msg=path)
    # on the CPU the attention calls take their plain versions: one flash
    # call per self-attention layer, cross-attention layer and encoder
    # layer in prefill; one paged call per self-attention layer and one
    # flash call per cross-attention layer in each decode step
    kinds = cfg.layer_pattern
    self_attn = sum(k in ("attn", "lattn", "wdec") for k in kinds)
    cross = sum(k in ("xattn", "wdec") for k in kinds)
    enc = cfg.encoder.n_layers if cfg.encoder else 0
    assert ops.PLAIN_CALLS["flash_attention"] == \
        self_attn + cross + enc + 8 * cross
    assert ops.PLAIN_CALLS["paged_attention"] == 8 * self_attn


def check_moe_routing_cannot_flip(arch: str, dtype: str) -> None:
    """The MoE family with every expert chosen and room for every choice
    (top_k = capacity_factor = num_experts): no bf16 rounding can change a
    token's experts or drop it, and the logits hold the dense bound."""
    def every_expert(c):
        E = c.moe.num_experts
        return dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, top_k=E, capacity_factor=float(E)))
    check_prefill_and_decode(arch, dtype, 3e-2, every_expert)
