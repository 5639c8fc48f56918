"""repro_torch models: the dense ``attn`` family against the JAX reference.

Weights come from the reference's ``init_params(cfg, PRNGKey(0))`` and
cross through numpy (``params_from_numpy``), so both sides hold the same
numbers.  Prefill and decode logits agree at rtol = atol = 1e-4 in float32
compute and 2e-2 in bfloat16 (where the reference also rounds the softmax
weights to bfloat16 before the PV product and the port's kernels keep them
in float32).  Decoding runs past ``s_max``, so the ring wraps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke as ref_get_smoke
from repro.models import model as RM
from repro.models.params import count_params as ref_count_params
from repro.models.params import init_params as ref_init_params
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.kernels import ops
from repro_torch.models import Model, count_params, init_params
from repro_torch.models.convert import (params_from_numpy, params_to_numpy,
                                        tensor_to_numpy)
from repro_torch.models.params import param_shapes, tree_leaves

# Six xdist workers share 8 cores with the reference's timing-bounded
# property tests: one intra-op thread per worker keeps them on time.
torch.set_num_threads(1)

ARCHS = ["qwen3_4b", "smollm_135m"]


def assert_logits_close(got: torch.Tensor, want, dtype: str,
                        msg: str = "") -> None:
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=msg)
    else:
        err = float(np.abs(got - want).max())
        assert err <= 2e-2 * max(1.0, float(np.abs(want).max())), (msg, err)


def reference_params(cfg):
    return jax.tree.map(np.asarray, ref_init_params(cfg, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    for port, ref in ((get_config(arch), ref_get_config(arch)),
                      (get_smoke(arch), ref_get_smoke(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert count_params(port) == ref_count_params(ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_the_reference_leaf_for_leaf(arch):
    cfg = get_smoke(arch)
    ref = reference_params(ref_get_smoke(arch))
    ref_leaves = [(jax.tree_util.keystr(p), a.shape) for p, a in
                  jax.tree_util.tree_flatten_with_path(ref)[0]]
    assert list(param_shapes(cfg).items()) == ref_leaves
    params = params_from_numpy(ref, cfg)
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
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch, dtype):
    ref_cfg = dataclasses.replace(ref_get_smoke(arch), compute_dtype=dtype)
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype=dtype)
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    model = Model(cfg, params_from_numpy(jax.tree.map(np.asarray,
                                                      ref_params), cfg))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    s_max = 20
    ops.reset_launch_counts()
    want, ref_cache = RM.prefill(ref_params, {"tokens": jnp.asarray(tokens)},
                                 ref_cfg, s_max=s_max)
    got, cache = model.prefill(torch.from_numpy(tokens), s_max)
    assert got.shape == (2, cfg.vocab_padded)
    assert got.dtype == getattr(torch, dtype)
    assert_logits_close(got, want, dtype, "prefill")
    for step in range(8):                    # positions 16..23: wraps at 20
        t = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        want, ref_cache = RM.decode_step(ref_params, jnp.asarray(t),
                                         ref_cache, ref_cfg)
        got, cache = model.decode_step(torch.from_numpy(t), cache)
        assert_logits_close(got, want, dtype, f"decode step {step}")
    assert int(cache["pos"]) == int(ref_cache["pos"]) == 24
    if dtype == "float32":
        for (_, a), (_, b) in zip(tree_leaves(cache),
                                  tree_leaves(jax.tree.map(np.asarray,
                                                           ref_cache))):
            np.testing.assert_allclose(tensor_to_numpy(a), b, rtol=1e-4,
                                       atol=1e-4)
    # on the CPU both attention calls take their plain versions
    assert ops.PLAIN_CALLS["flash_attention"] == cfg.n_layers
    assert ops.PLAIN_CALLS["paged_attention"] == 8 * cfg.n_layers


def test_unported_architectures_name_their_roadmap_item():
    for arch in ARCH_IDS:
        if arch in ARCHS:
            continue
        with pytest.raises(NotImplementedError, match="ROADMAP.md A11"):
            get_smoke(arch)
