"""repro_torch models against the JAX reference: every architecture's
configuration, parameter table and init rules, the dense ``attn`` family's
logits, and the reference's own smoke-model tests on the port.

Weights come from the reference's ``init_params(cfg, PRNGKey(0))`` and
cross through numpy (``params_from_numpy``), so both sides hold the same
numbers.  Prefill and decode logits agree at rtol = atol = 1e-4 in float32
compute; in bfloat16 (where the reference also rounds the softmax weights
to bfloat16 before the PV product and the port's kernels keep them in
float32) within 2e-2 of scale over every column and 3e-2 of the largest
real logit over the real vocab (``_torch_families.assert_logits_close``).
Decoding runs past ``s_max``, so the ring wraps.  The other families'
logits are in ``test_torch_models_{local,recurrent,cross}.py``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_families import check_prefill_and_decode, reference_params
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke as ref_get_smoke
from repro.models.params import count_params as ref_count_params
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.data import stub_frontend_inputs
from repro_torch.models import Model, count_params, init_params
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.params import param_shapes, tree_leaves

# Six xdist workers share 8 cores with the reference's timing-bounded
# property tests: one intra-op thread per worker keeps them on time.
torch.set_num_threads(1)

ARCHS = list(ARCH_IDS)
DENSE_ARCHS = ["qwen3_4b", "smollm_135m", "minicpm_2b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    for port, ref in ((get_config(arch), ref_get_config(arch)),
                      (get_smoke(arch), ref_get_smoke(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert count_params(port) == ref_count_params(ref)
        assert count_params(port, active_only=True) == \
            ref_count_params(ref, active_only=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_the_reference_leaf_for_leaf(arch):
    cfg = get_smoke(arch)
    ref = reference_params(ref_get_smoke(arch))
    ref_leaves = [(jax.tree_util.keystr(p), a.shape) for p, a in
                  jax.tree_util.tree_flatten_with_path(ref)[0]]
    assert list(param_shapes(cfg).items()) == ref_leaves
    params = params_from_numpy(ref, cfg, device="cpu")
    back = params_to_numpy(params)
    for (_, a), (_, b) in zip(tree_leaves(back), tree_leaves(ref)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_follows_the_reference_rules(arch):
    cfg = get_smoke(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ref = reference_params(ref_get_smoke(arch))
    for (path, t), (_, r) in zip(tree_leaves(params), tree_leaves(ref)):
        assert tuple(t.shape) == r.shape and t.dtype == torch.float32, path
        if np.all(r == 1) or np.all(r == 0):        # ones / zeros rules
            np.testing.assert_array_equal(t.numpy(), r, err_msg=path)
        else:                                       # the same scale
            assert 0.8 < float(t.std()) / float(r.std()) < 1.25, path
    again = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for (_, a), (_, b) in zip(tree_leaves(params), tree_leaves(again)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_prefill_and_decode_logits_match_jax(arch, dtype):
    check_prefill_and_decode(arch, dtype)


# ------------------------- the reference's tests/test_models_smoke.py, ported
def _model(cfg, seed):
    return Model(cfg, init_params(cfg, torch.Generator().manual_seed(seed),
                                  "cpu"))


def _extras(cfg, B):
    return {k: torch.from_numpy(v)
            for k, v in stub_frontend_inputs(cfg, B).items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """decode(prefill(S-1)) logits == prefill(S) logits, in float32; S = 17
    so the S-1 = 16 prefix divides the SSD chunk.  MoE configs run
    dropless: with capacity drops prefill routes tokens against
    sequence-wide competition while decode routes alone."""
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    model = _model(cfg, 1)
    B, S = 2, 17
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, S)).astype(np.int32))
    extras = _extras(cfg, B)
    full, _ = model.prefill(tokens, S + 4, extras)
    _, cache = model.prefill(tokens[:, :S - 1], S + 4, extras)
    step, _ = model.decode_step(tokens[:, S - 1:], cache)
    np.testing.assert_allclose(step[:, :cfg.vocab].numpy(),
                               full[:, :cfg.vocab].numpy(), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_family(arch):
    """Full config param counts are in the family's published ballpark."""
    expected = {
        "whisper_medium": (0.7e9, 1.2e9),
        "mamba2_130m": (0.11e9, 0.16e9),
        "minicpm_2b": (2.0e9, 3.3e9),
        "smollm_135m": (0.12e9, 0.16e9),
        "qwen3_4b": (3.3e9, 4.8e9),
        "gemma3_1b": (0.8e9, 1.3e9),
        "granite_moe_1b_a400m": (1.0e9, 1.7e9),
        "mixtral_8x22b": (1.3e11, 1.5e11),
        "recurrentgemma_2b": (2.2e9, 3.3e9),
        "llama32_vision_90b": (0.8e11, 1.0e11),
    }
    lo, hi = expected[arch]
    n = count_params(get_config(arch))
    assert lo <= n <= hi, f"{arch}: {n / 1e9:.2f}B outside [{lo / 1e9}, " \
                          f"{hi / 1e9}]"


def test_sliding_window_restricts_attention():
    """A token beyond the window cannot influence a local-attention output
    (dense FFN: MoE capacity routing would couple distant tokens)."""
    cfg = ModelConfig("win", n_layers=2, d_model=32, n_q=4, n_kv=2, d_ff=64,
                      vocab=64, d_head=8, layer_pattern=("lattn", "lattn"),
                      window=8, compute_dtype="float32")
    model = _model(cfg, 3)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (1, 16)).astype(
        np.int32)
    toks2 = toks.copy()
    toks2[0, 0] = (toks2[0, 0] + 1) % cfg.vocab   # perturb far-away token
    out1, _ = model.prefill(torch.from_numpy(toks), 16)
    out2, _ = model.prefill(torch.from_numpy(toks2), 16)
    # position 15 attends to (7..15] only => logits unchanged
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_ring_buffer_matches_full_cache():
    """lattn ring cache (window-sized) == attention over the whole prompt
    restricted by the window."""
    cfg = ModelConfig("ring", n_layers=2, d_model=32, n_q=4, n_kv=2,
                      d_ff=64, vocab=64, d_head=8, window=8,
                      layer_pattern=("lattn", "lattn"),
                      compute_dtype="float32")
    model = _model(cfg, 0)
    S, gen = 12, 6
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 64, (1, S + gen)).astype(np.int32))
    full, _ = model.prefill(toks, S + gen)
    _, cache = model.prefill(toks[:, :S], S + gen)
    assert cache["stages"][0]["blocks"][0]["k"].shape[2] == 8
    for i in range(S, S + gen):
        logits, cache = model.decode_step(toks[:, i:i + 1], cache)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=3e-2,
                               atol=3e-2)
