"""The port's optimizer, train step and gradient compression against the
JAX reference (``repro.train``), and the reference's train-step smoke test
on the port for all ten architectures.

Schedules within 1e-6 (relative; the cosine's ``cos`` rounds its last bit
differently), AdamW's new parameters, moments and master copy within
1e-6 of max(1, |leaf|), one ``make_train_step`` step (``accum_steps`` 1
and 2) within 1e-4 of max(1, |leaf|) from the same parameters and batch;
int8 codes and scales bit for bit; ``compressed_grad_allreduce`` on a
one-rank gloo group against the reference's ``shard_map`` on one device.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train import (assert_trees_close, batch_np, both_params,
                          configs, to_jax, to_torch)
from repro.train import OptConfig as RefOptConfig
from repro.train import adamw_update as ref_adamw_update
from repro.train import init_opt_state as ref_init_opt_state
from repro.train import make_train_step as ref_make_train_step
from repro.train import schedule_lr as ref_schedule_lr
from repro.train import compress as RC
from repro_torch.configs import ARCH_IDS, get_smoke
from repro_torch.models import init_params
from repro_torch.models.convert import (opt_state_from_numpy,
                                        params_from_numpy, tensor_to_numpy)
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.train import (OptConfig, adamw_update, init_opt_state,
                               make_eval_step, make_train_step, schedule_lr)
from repro_torch.train import compress as C

# Six xdist workers share 8 cores with the reference's timing-bounded
# property tests: one intra-op thread per worker keeps them on time.
torch.set_num_threads(1)

SCHEDULES = {
    "cosine": dict(peak_lr=3e-4, warmup_steps=10, total_steps=100),
    "wsd": dict(peak_lr=1.0, warmup_steps=10, total_steps=100,
                schedule="wsd", wsd_decay_frac=0.2, min_lr_frac=0.1),
    "constant": dict(peak_lr=2e-3, warmup_steps=5, total_steps=50,
                     schedule="constant"),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_lr_matches_the_reference(name):
    kw = SCHEDULES[name]
    steps = range(0, kw["total_steps"] + 5)
    want = np.array([float(ref_schedule_lr(jnp.asarray(s, jnp.int32),
                                           RefOptConfig(**kw)))
                     for s in steps], np.float32)
    got = torch.stack([schedule_lr(torch.tensor(s, dtype=torch.int32),
                                   OptConfig(**kw)) for s in steps])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("master", [False, True], ids=["plain", "master"])
def test_adamw_update_matches_the_reference(master):
    """Two AdamW steps on smollm's smoke tree with random gradients (a
    large one so that clipping acts); with ``master``, bf16 parameters
    beside the float32 master copy."""
    ref_cfg, cfg = configs("smollm_135m")
    ref, params = both_params(ref_cfg, cfg)
    if master:
        ref = jax.tree.map(lambda a: a.astype(jnp.bfloat16), ref)
        params = tree_map(lambda t: t.to(torch.bfloat16), params)
    rng = np.random.default_rng(1)
    opt = OptConfig(peak_lr=1e-2, warmup_steps=1, total_steps=10,
                    weight_decay=0.1, grad_clip=1.0)
    ref_opt = RefOptConfig(**dataclasses.asdict(opt))
    ref_state = ref_init_opt_state(ref, master=master)
    state = init_opt_state(params, master=master)
    for step in range(2):
        grads_np = jax.tree.map(
            lambda a: (rng.standard_normal(a.shape) * (3.0 if step else 0.01)
                       ).astype(np.float32), jax.tree.map(np.asarray, ref))
        ref, ref_state, ref_m = ref_adamw_update(
            ref, jax.tree.map(jnp.asarray, grads_np), ref_state, ref_opt)
        params, state, m = adamw_update(
            params, params_from_numpy(grads_np, cfg, device="cpu"), state,
            opt)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(ref_m[k]),
                                       rtol=1e-6)
    assert int(state["step"]) == 2 and state["step"].dtype == torch.int32
    for k in ("m", "v") + (("master",) if master else ()):
        assert_trees_close(state[k], ref_state[k], 1e-6, f"{k} ")
    # bf16 parameters: the master copy rounded, one bf16 step (2^-8) apart
    # at most where the two masters straddle a rounding boundary
    assert_trees_close(params, jax.tree.map(
        lambda a: np.asarray(a, np.float32), ref),
        2.0 ** -8 if master else 1e-6)


def test_opt_state_crosses_from_numpy():
    ref_cfg, cfg = configs("granite_moe_1b_a400m")
    ref, _ = both_params(ref_cfg, cfg)
    state = ref_init_opt_state(ref, master=True)
    got = opt_state_from_numpy(jax.tree.map(np.asarray, state), cfg,
                               device="cpu")
    assert sorted(got) == ["m", "master", "step", "v"]
    assert got["step"].shape == () and got["step"].dtype == torch.int32
    for k in ("m", "v", "master"):
        for (p, a), (_, b) in zip(tree_leaves(got[k]), tree_leaves(
                jax.tree.map(np.asarray, state[k]))):
            assert a.dtype == torch.float32, p
            np.testing.assert_array_equal(tensor_to_numpy(a), b)


@pytest.mark.parametrize("arch", ["smollm_135m", "granite_moe_1b_a400m"])
@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_the_reference(arch, accum):
    """One make_train_step step (B 4, fp32) from the same parameters and
    batch; with ``accum_steps`` 2 the gradients are two microbatches'
    float32 mean."""
    ref_cfg, cfg = configs(arch)
    ref, params = both_params(ref_cfg, cfg)
    batch = batch_np(cfg, B=4, masked=True)
    kw = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    want_p, want_o, want_m = jax.jit(ref_make_train_step(
        ref_cfg, RefOptConfig(**kw), accum_steps=accum))(
        ref, ref_init_opt_state(ref), to_jax(batch))
    got_p, got_o, got_m = make_train_step(cfg, OptConfig(**kw), accum)(
        params, init_opt_state(params), to_torch(batch))
    assert sorted(got_m) == sorted(want_m)
    for k in got_m:
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    assert int(got_o["step"]) == 1
    assert_trees_close(got_p, want_p)
    for k in ("m", "v"):
        assert_trees_close(got_o[k], want_o[k], what=f"{k} ")


def test_eval_step_is_the_loss_without_a_graph():
    cfg = dataclasses.replace(get_smoke("qwen3_4b"), compute_dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = to_torch(batch_np(cfg))
    m = make_eval_step(cfg)(params, batch)
    assert not m["loss"].requires_grad
    _, _, tm = make_train_step(cfg, OptConfig())(
        params, init_opt_state(params), batch)
    assert torch.equal(m["loss"], tm["loss"])


@pytest.mark.parametrize("arch", list(ARCH_IDS))
def test_train_step_smoke(arch):
    """The reference's test_models_smoke.py::test_train_step_smoke on the
    port: a finite loss, the step counter at 1, parameters moved."""
    cfg = get_smoke(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = init_opt_state(params)
    step = make_train_step(cfg, OptConfig(peak_lr=1e-3, warmup_steps=1,
                                          total_steps=10))
    batch = to_torch(batch_np(cfg, B=2, S=16))
    new_params, new_opt, metrics = step(params, opt, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert int(new_opt["step"]) == 1
    moved = [float(torch.max(torch.abs(a - b)))
             for (_, a), (_, b) in zip(tree_leaves(params),
                                       tree_leaves(new_params))]
    assert max(moved) > 0


# ------------------------------------------------------------- compression
QUANT_INPUTS = {
    "normal": lambda rng: rng.standard_normal(257).astype(np.float32),
    "ties": lambda rng: (np.arange(-254, 255) / 2.0).astype(np.float32),
    "zeros": lambda rng: np.zeros(9, np.float32),
    "tiny": lambda rng: rng.standard_normal(33).astype(np.float32) * 1e-14,
    "matrix": lambda rng: rng.standard_normal((17, 9)).astype(np.float32)
    * 40,
}


@pytest.mark.parametrize("name", list(QUANT_INPUTS))
def test_quantize_codes_equal_the_reference(name):
    x = QUANT_INPUTS[name](np.random.default_rng(0))
    want_q, want_s = RC.quantize(jnp.asarray(x))
    got_q, got_s = C.quantize(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_q.shape == x.shape
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    assert got_s.numpy().tobytes() == np.asarray(want_s).tobytes()
    np.testing.assert_array_equal(C.dequantize(got_q, got_s).numpy(),
                                  np.asarray(RC.dequantize(want_q, want_s)))


def test_compress_with_feedback_equals_the_reference_over_steps():
    """Fifty steps of error feedback: codes, scales and the carried error
    bit for bit; the reference's unbiasedness test on the port (the sent
    sum plus the final residual is the true sum)."""
    rng = np.random.default_rng(0)
    err, ref_err = torch.zeros(32), jnp.zeros(32)
    sent, true = np.zeros(32), np.zeros(32)
    for _ in range(50):
        g = rng.standard_normal(32).astype(np.float32)
        q, s, err = C.compress_with_feedback(torch.from_numpy(g), err)
        rq, rs, ref_err = RC.compress_with_feedback(jnp.asarray(g), ref_err)
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert s.numpy().tobytes() == np.asarray(rs).tobytes()
        assert err.numpy().tobytes() == np.asarray(ref_err).tobytes()
        sent += C.dequantize(q, s).numpy()
        true += g
    np.testing.assert_allclose(sent + err.numpy(), true, rtol=1e-4,
                               atol=1e-4)


def g_of(tree, path):
    """The leaf of ``tree`` at a ``tree_leaves`` path."""
    return dict(tree_leaves(tree))[path]


def test_compressed_allreduce_on_one_rank_gloo_matches_shard_map():
    """compressed_grad_allreduce on an in-process one-rank gloo group
    against the reference's under shard_map over one device: the mean
    gradient bit for bit; the new error state within 1e-6 of the largest
    corrected gradient (one rounding of it), since jitted XLA fuses
    ``corrected - q * scale`` into one rounding (the eager reference's
    error equals the port's by bits, above)."""
    import socket

    import torch.distributed as dist
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    rng = np.random.default_rng(2)
    g = {"w": np.arange(8, dtype=np.float32),
         "b": [rng.standard_normal((3, 5)).astype(np.float32)]}
    e = {"w": rng.standard_normal(8).astype(np.float32) * 0.01,
         "b": [np.zeros((3, 5), np.float32)]}
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    want, want_e = jax.jit(shard_map(
        lambda g, e: RC.compressed_grad_allreduce(g, e, "data"), mesh=mesh,
        in_specs=(P(), P()), out_specs=(P(), P())))(
        jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, e))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        tt = lambda tree: tree_map(torch.from_numpy, tree)
        got, got_e = C.compressed_grad_allreduce(tt(g), tt(e))
    finally:
        dist.destroy_process_group()
    for (p, x), (_, y) in zip(tree_leaves(got), tree_leaves(
            jax.tree.map(np.asarray, want))):
        assert x.numpy().tobytes() == y.tobytes(), p
    for (p, x), (_, y) in zip(tree_leaves(got_e), tree_leaves(
            jax.tree.map(np.asarray, want_e))):
        big = float(np.abs(g_of(g, p) + g_of(e, p)).max())
        np.testing.assert_allclose(x.numpy(), y, rtol=0, atol=1e-6 * big,
                                   err_msg=p)
    np.testing.assert_allclose(got["w"].numpy(), np.arange(8), atol=0.05)
