"""Shared checks of the port's training path against the JAX reference,
for the ``test_torch_train*.py`` files (split by family, so that
pytest-xdist's ``--dist loadfile`` spreads the JAX compiles).

Both packages start from the reference's ``init_params(cfg, PRNGKey(0))``
(``params_from_numpy``), and take the same batch: tokens drawn from
``default_rng(seed)``, next-token labels, an optional ``loss_mask`` with
zeros, and the frontends' stubbed extras.
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
from repro_torch.models import train as T
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.params import tree_leaves

# float32: loss, metrics and every gradient leaf within 1e-4 of
# max(1, |reference|) (the leaf's largest magnitude for a gradient).
F32_TOL = 1e-4
# bfloat16 compute (float32 parameters): |loss - reference loss| within
# 2e-3 of max(1, |reference|).  Both sides round the activations to bf16
# in different orders: the ten smoke configs read gaps of 9e-5 to 1.5e-3
# (losses near 5), and 5.4e-3 for mixtral_8x22b, whose router can flip a
# choice (see _torch_families.BF16_SHARE).
BF16_LOSS_TOL = 2e-3


def configs(arch: str, dtype: str = "float32", **edit):
    """(reference config, port config), the smoke config edited alike."""
    return (dataclasses.replace(ref_get_smoke(arch), compute_dtype=dtype,
                                **edit),
            dataclasses.replace(get_smoke(arch), compute_dtype=dtype,
                                **edit))


def batch_np(cfg, B: int = 2, S: int = 16, masked: bool = False,
             seed: int = 0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    out = {"tokens": tokens, "labels": np.roll(tokens, -1, 1)}
    if masked:
        mask = np.ones((B, S), np.float32)
        mask[0, 3:7] = 0
        mask[-1, -2:] = 0
        out["loss_mask"] = mask
    out.update(ref_stub_frontend_inputs(cfg, B, seed))
    return out


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch, device="cpu"):
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def both_params(ref_cfg, cfg, seed: int = 0):
    ref = ref_init_params(ref_cfg, jax.random.PRNGKey(seed))
    return ref, params_from_numpy(jax.tree.map(np.asarray, ref), cfg,
                                  device="cpu")


def assert_trees_close(got, want, tol: float = F32_TOL, what: str = ""):
    """Leaf for leaf (same paths, shapes), each within tol of
    max(1, its reference's largest magnitude)."""
    got_l, want_l = list(tree_leaves(got)), list(
        tree_leaves(jax.tree.map(np.asarray, want)))
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, a), (_, b) in zip(got_l, want_l):
        a = a.detach().float().numpy()
        assert a.shape == b.shape, path
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale,
                                   err_msg=f"{what}{path}")


def check_loss_and_grads(arch: str, loss_chunk: int = 1024,
                         masked: bool = False) -> None:
    """loss, ce, aux, zloss and every gradient leaf against
    ``jax.value_and_grad(loss_fn)`` in float32."""
    ref_cfg, cfg = configs(arch, loss_chunk=loss_chunk)
    ref, params = both_params(ref_cfg, cfg)
    batch = batch_np(cfg, masked=masked)
    (want, want_m), want_g = jax.value_and_grad(
        lambda p: RM.loss_fn(p, to_jax(batch), ref_cfg), has_aux=True)(ref)
    (got, got_m), got_g = T.value_and_grad(params, to_torch(batch), cfg)
    for k, a, b in [("loss", got, want)] + [(k, got_m[k], want_m[k])
                                            for k in ("ce", "aux", "zloss",
                                                      "ntokens")]:
        b = float(b)
        assert abs(float(a) - b) <= F32_TOL * max(1.0, abs(b)), (k, a, b)
    assert_trees_close(got_g, want_g, what="grad ")


def check_bf16_loss(arch: str) -> float:
    """The bf16 loss (fp32 parameters, bf16 compute) against the
    reference's; returns the gap."""
    ref_cfg, cfg = configs(arch, "bfloat16")
    ref, params = both_params(ref_cfg, cfg)
    batch = batch_np(cfg, masked=True)
    want, _ = RM.loss_fn(ref, to_jax(batch), ref_cfg)
    with torch.no_grad():
        got, _ = T.loss_fn(params, to_torch(batch), cfg)
    gap = abs(float(got) - float(want))
    assert np.isfinite(float(got))
    assert gap <= BF16_LOSS_TOL * max(1.0, abs(float(want))), (arch, gap)
    return gap


def remat_variants_equal(arch: str, n_layers: int) -> None:
    """remat off, on, and remat2 (groups of _remat2_group(repeat) layers)
    give the same loss and gradients, bit for bit."""
    base = get_smoke(arch)
    cfg = dataclasses.replace(base, compute_dtype="float32",
                              n_layers=n_layers,
                              layer_pattern=base.layer_pattern[:1] *
                              n_layers)
    from repro_torch.models import init_params
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = to_torch(batch_np(cfg, masked=True))
    out = []
    for remat, remat2 in ((False, False), (True, False), (True, True)):
        c = dataclasses.replace(cfg, remat=remat, remat2=remat2)
        out.append(T.value_and_grad(params, batch, c))
    (l0, m0), g0 = out[0]
    for (l, m), g in out[1:]:
        assert torch.equal(l, l0)
        for k in m0:
            assert torch.equal(m[k], m0[k]), k
        for (p, a), (_, b) in zip(tree_leaves(g), tree_leaves(g0)):
            assert torch.equal(a, b), p
