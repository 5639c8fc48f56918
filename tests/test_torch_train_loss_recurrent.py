"""The port's training loss and gradients against the JAX reference:
recurrent families (the SSD and RG-LRU scans' backward).

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

ARCHS = ["mamba2_130m", "recurrentgemma_2b"]


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


def _scan_inputs(rng, shapes):
    return [rng.standard_normal(s).astype("float32") for s in shapes]


def test_scans_in_float32_agree_with_the_reference():
    """ROADMAP C10, part 1: the port's ``ssd_scan`` (a Python loop over
    chunks) and ``rglru_scan`` (a Hillis-Steele scan) against the
    reference's (``lax.scan``, ``associative_scan``) with float32 inputs
    on both sides: the other order of float32 additions moves the outputs
    by a few ulp (read: 2.5e-7 of the largest |y| for ssd, 1.1e-7 for
    rglru), nowhere near the bf16 bounds' 4.7e-2."""
    import jax.numpy as jnp
    import numpy as np
    from repro.models import layers as RL
    from repro_torch.models import layers as L
    rng = np.random.default_rng(0)
    B, S, H, P, N, W = 2, 16, 4, 8, 16, 32
    xh, Bm, Cm = _scan_inputs(rng, [(B, S, H, P), (B, S, N), (B, S, N)])
    dt = np.abs(_scan_inputs(rng, [(B, S, H)])[0]) * 0.5
    A = -np.abs(_scan_inputs(rng, [(H,)])[0])
    for chunk in (16, 8, 4):
        (yr, sr) = RL.ssd_scan(*map(jnp.asarray, (xh, dt, A, Bm, Cm)), chunk)
        (yp, sp) = L.ssd_scan(*map(torch.from_numpy, (xh, dt, A, Bm, Cm)),
                              chunk)
        for a, b in ((yp, yr), (sp, sr)):
            b = np.asarray(b)
            assert np.abs(a.numpy() - b).max() <= 1e-6 * np.abs(b).max()
    u, r, i = _scan_inputs(rng, [(B, S, W)] * 3)
    r, i = 1 / (1 + np.exp(-r)), 1 / (1 + np.exp(-i))
    lam = _scan_inputs(rng, [(W,)])[0]
    hr, lr = RL.rglru_scan(*map(jnp.asarray, (u, r, i, lam)), 8.0)
    hp, lp = L.rglru_scan(*map(torch.from_numpy, (u, r, i, lam)), 8.0)
    for a, b in ((hp, hr), (lp, lr)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-6 * np.abs(b).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_bound_is_the_references_own_bf16_rounding(arch):
    """ROADMAP C10, part 2: prefill and eight decode steps (the checks of
    ``_torch_families``) in float32 and in bfloat16 on both packages.  In
    float32 the port's logits sit within 1e-5 of scale of the reference's
    at every step: the recurrences' order of additions is not at fault.
    In bfloat16 the reference's own logits move from its float32 ones by
    3.0e-2 (recurrentgemma_2b) and 6.6e-2 (mamba2_130m) of scale, the
    size of the port-to-reference gaps the 6e-2 bound holds (4.9e-2 and
    4.7e-2; the port's own move is 4.5e-2 and 3.4e-2): bf16 rounding fed
    through the recurrences, on each side on its own."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from _torch_families import BF16_SHARE
    from repro.models import model as RM
    from repro.models.params import init_params as ref_init_params
    from repro_torch.models import Model
    from repro_torch.models.convert import params_from_numpy
    from _torch_train import configs
    logits = {}
    for dtype in ("float32", "bfloat16"):
        ref_cfg, cfg = configs(arch, dtype)
        ref = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
        model = Model(cfg, params_from_numpy(jax.tree.map(np.asarray, ref),
                                             cfg, device="cpu"))
        rng = np.random.default_rng(0)
        t = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
        want, rc = RM.prefill(ref, {"tokens": jnp.asarray(t)}, ref_cfg,
                              s_max=20)
        got, cache = model.prefill(torch.from_numpy(t), 20)
        steps = [(want, got)]
        for _ in range(8):
            t = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
            want, rc = RM.decode_step(ref, jnp.asarray(t), rc, ref_cfg)
            got, cache = model.decode_step(torch.from_numpy(t), cache)
            steps.append((want, got))
        V = cfg.vocab
        logits[dtype] = [(np.asarray(w, np.float32)[:, :V],
                          g.float().numpy()[:, :V]) for w, g in steps]
    own, cross = 0.0, 0.0
    for (r32, p32), (r16, p16) in zip(logits["float32"],
                                      logits["bfloat16"]):
        scale = max(1.0, float(np.abs(r32).max()))
        assert np.abs(p32 - r32).max() <= 1e-5 * scale
        own = max(own, float(np.abs(r16 - r32).max()) / scale)
        cross = max(cross, float(np.abs(p16 - r16).max()) / scale)
    assert own >= 2e-2, own
    assert cross <= BF16_SHARE[arch], cross
