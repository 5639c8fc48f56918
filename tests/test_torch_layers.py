"""repro_torch layers against ``repro.models.layers`` on seeded numpy
inputs, in float32: the MoE MLP (the same tokens dropped, the same aux
loss; its un-sort gives the same bits twice), the causal conv and its
step, the SSD scan with and without an incoming state (and against its
step unrolled), the RG-LRU scan (and its step unrolled), the whisper
encoder and cross-attention.

Tolerances: rtol = atol = 1e-5, except the scans against their unrolled
steps and against the reference's scans at 1e-4: the chunked SSD scan and
the RG-LRU's log-depth scan (the reference's ``associative_scan`` is
another tree) add the same float32 terms in other orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import reference_params
from repro.configs import get_smoke as ref_get_smoke
from repro.models import blocks as RB
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch.configs import get_smoke
from repro_torch.models import Model, blocks, layers
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import sinusoid_positions

# Six xdist workers share 8 cores with the reference's timing-bounded
# property tests: one intra-op thread per worker keeps them on time.
torch.set_num_threads(1)


def randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.numpy() if torch.is_tensor(got) else got,
                               np.asarray(want), rtol=tol, atol=tol)


def t(a):
    return torch.from_numpy(np.array(a))


# -------------------------------------------------------------------- MoE
def _moe_case(capacity_factor, seed=0):
    cfg = dataclasses.replace(get_smoke("granite_moe_1b_a400m"),
                              compute_dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    rng = np.random.default_rng(seed)
    E, D, F = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    p = {"router": randn(rng, D, E), "wg": randn(rng, E, D, F, scale=0.2),
         "wu": randn(rng, E, D, F, scale=0.2),
         "wd": randn(rng, E, F, D, scale=0.2)}
    x = randn(rng, 2, 24, D)
    return cfg, p, x


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25, 8.0])
def test_moe_mlp_matches_the_reference(capacity_factor):
    cfg, p, x = _moe_case(capacity_factor)
    want, want_aux = RL.moe_mlp({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), cfg, RL.identity_shard)
    got, aux = layers.moe_mlp({k: t(v) for k, v in p.items()}, t(x), cfg)
    close(got, want)
    close(aux, want_aux)
    # the same choices dropped: the reference's dispatch formula in numpy
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(p["router"]), -1)
    _, top_ids = jax.lax.top_k(probs, cfg.moe.top_k)
    ids = np.asarray(top_ids).reshape(2, -1)
    C = layers.moe_capacity(x.shape[1], cfg)
    want_keep = []
    for row in ids:
        order = np.argsort(row, kind="stable")
        sids = row[order]
        seg = np.searchsorted(sids, np.arange(cfg.moe.num_experts))
        want_keep.append(np.arange(len(row)) - seg[sids] < C)
    _, _, keep = layers.moe_dispatch(t(np.asarray(top_ids)),
                                     cfg.moe.num_experts, C)
    np.testing.assert_array_equal(keep.numpy(), np.stack(want_keep))
    if capacity_factor < 1:               # fewer slots than choices: drops
        assert not keep.all()
    if capacity_factor >= cfg.moe.num_experts:
        assert keep.all()


def test_moe_unsort_gives_the_same_bits_twice():
    cfg, p, x = _moe_case(1.25, seed=3)
    tp = {k: t(v) for k, v in p.items()}
    a, aux_a = layers.moe_mlp(tp, t(x), cfg)
    b, aux_b = layers.moe_mlp(tp, t(x), cfg)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    # each token's K outputs summed in increasing expert id, one by one
    probs = torch.softmax(t(x) @ tp["router"], -1)
    w, ids = torch.topk(probs, cfg.moe.top_k)
    w = w / w.sum(-1, keepdim=True)
    wide = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    dropless, _ = layers.moe_mlp(tp, t(x), wide)
    want = torch.zeros_like(dropless)
    for e in range(cfg.moe.num_experts):
        y = layers.dense_mlp({k: tp[k][e] for k in ("wg", "wu", "wd")},
                             t(x))
        want = want + (w * (ids == e)).sum(-1, keepdim=True) * y
    close(dropless, want)


# ------------------------------------------------------------- causal conv
def test_causal_conv1d_and_step_match_the_reference():
    rng = np.random.default_rng(1)
    x, w, b = randn(rng, 2, 10, 6), randn(rng, 4, 6), randn(rng, 6)
    close(layers.causal_conv1d(t(x), t(w), t(b)),
          RL.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    state, x_t = randn(rng, 2, 3, 6), randn(rng, 2, 6)
    got, got_state = layers.causal_conv1d_step(t(x_t), t(state), t(w), t(b))
    want, want_state = RL.causal_conv1d_step(
        jnp.asarray(x_t), jnp.asarray(state), jnp.asarray(w),
        jnp.asarray(b))
    close(got, want)
    close(got_state, want_state)
    # the step over the conv's own tail gives the conv's next output
    full = layers.causal_conv1d(t(x), t(w), t(b))
    step, _ = layers.causal_conv1d_step(t(x[:, 9]), t(x[:, 6:9]), t(w),
                                        t(b))
    close(step, full[:, 9])


# --------------------------------------------------------------------- SSD
def _ssd_inputs(seed, S=16, H=3, P=4, N=5):
    rng = np.random.default_rng(seed)
    xh = randn(rng, 2, S, H, P)
    dt = np.log1p(np.exp(randn(rng, 2, S, H)))             # softplus > 0
    A = -np.exp(randn(rng, H, scale=0.5))
    return xh, dt, A, randn(rng, 2, S, N), randn(rng, 2, S, N)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan_matches_the_reference_and_its_step(with_state):
    xh, dt, A, Bm, Cm = _ssd_inputs(2)
    init = randn(np.random.default_rng(3), 2, 3, 4, 5) if with_state \
        else None
    y, final = layers.ssd_scan(t(xh), t(dt), t(A), t(Bm), t(Cm), 4,
                               None if init is None else t(init))
    want_y, want_final = RL.ssd_scan(
        jnp.asarray(xh), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(Bm),
        jnp.asarray(Cm), 4, None if init is None else jnp.asarray(init))
    close(y, want_y, 1e-4)
    close(final, want_final, 1e-4)
    state = torch.zeros(2, 3, 4, 5) if init is None else t(init)
    for s in range(xh.shape[1]):
        y_s, state = layers.ssd_step(t(xh[:, s]), t(dt[:, s]), t(A),
                                     t(Bm[:, s]), t(Cm[:, s]), state)
        close(y_s, y[:, s], 1e-4)
    close(state, final, 1e-4)


# ------------------------------------------------------------------ RG-LRU
@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_scan_matches_the_reference_and_its_step(with_state):
    rng = np.random.default_rng(4)
    S, W = 37, 6                          # not a power of two
    u = randn(rng, 2, S, W)
    r = 1 / (1 + np.exp(-randn(rng, 2, S, W)))
    i = 1 / (1 + np.exp(-randn(rng, 2, S, W)))
    lam = randn(rng, W)
    h0 = randn(rng, 2, W) if with_state else None
    h, last = layers.rglru_scan(t(u), t(r), t(i), t(lam), 8.0,
                                None if h0 is None else t(h0))
    want_h, want_last = RL.rglru_scan(
        jnp.asarray(u), jnp.asarray(r), jnp.asarray(i), jnp.asarray(lam),
        8.0, None if h0 is None else jnp.asarray(h0))
    close(h, want_h, 1e-4)
    close(last, want_last, 1e-4)
    state = torch.zeros(2, W) if h0 is None else t(h0)
    for s in range(S):
        h_s, state = layers.rglru_step(t(u[:, s]), t(r[:, s]), t(i[:, s]),
                                       t(lam), 8.0, state)
        close(h_s, h[:, s], 1e-4)
    close(state, last, 1e-4)


# ------------------------------------------ the encoder and cross-attention
def _model_pair(arch):
    ref_cfg = dataclasses.replace(ref_get_smoke(arch),
                                  compute_dtype="float32")
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    ref = reference_params(ref_cfg)
    return ref_cfg, cfg, jax.tree.map(jnp.asarray, ref), \
        Model(cfg, params_from_numpy(ref, cfg, device="cpu"))


def test_encoder_forward_matches_the_reference():
    ref_cfg, cfg, ref_params, model = _model_pair("whisper_medium")
    frames = randn(np.random.default_rng(5), 2, cfg.encoder.seq_len,
                   cfg.d_model, scale=0.02)
    want = RM.encoder_forward(ref_params, jnp.asarray(frames), ref_cfg,
                              RL.identity_shard)
    close(model.encoder_forward(t(frames)), want)
    close(sinusoid_positions(12, 32), RM.sinusoid_positions(12, 32))


@pytest.mark.parametrize("arch", ["llama32_vision_90b", "whisper_medium"])
def test_cross_attn_matches_the_reference(arch):
    ref_cfg, cfg, ref_params, model = _model_pair(arch)
    kind = "xattn" if arch.startswith("llama") else "wdec"
    _, stage, blk, i, lp = next(layer for layer in model.layers
                                if layer[0] == kind)
    rp = jax.tree.map(lambda a: a[i],
                      ref_params["stages"][stage]["blocks"][blk])
    if kind == "wdec":
        lp, rp = lp["x"], rp["x"]
    rng = np.random.default_rng(6)
    h, src = randn(rng, 2, 5, cfg.d_model), randn(rng, 2, 9, cfg.d_model)
    for sq in (5, 1):                     # prefill, and one decode token
        k, v = blocks.cross_kv(lp, t(src), cfg)
        rk, rv = RB.cross_kv(rp, jnp.asarray(src), ref_cfg,
                             RL.identity_shard)
        close(k, rk)
        close(v, rv)
        close(blocks.cross_attn(lp, t(h[:, :sq]), k, v, cfg),
              RB._cross_attn(rp, jnp.asarray(h[:, :sq]), rk, rv, ref_cfg,
                             RL.identity_shard))
