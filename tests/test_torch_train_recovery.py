"""The reference's training-substrate tests (``tests/test_train_recovery.py``,
all eight) on the port, with the port's ``Trainer`` on the CPU: convergence,
bit-exact failure recovery through the device checkpoint store, the WSD
schedule, the data pipeline's determinism and seekability, its planted
bigrams, the int8 codec's error bound, error feedback, and the compressed
all-reduce; then the trainer's own edges (the optimizer's 0-dim int32
step through the store, no mesh, no silent CPU, the command line).
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.checkpoint import AsyncCheckpointer
from repro_torch.configs import get_smoke
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.launch.train import SimulatedHostFailure, Trainer, main
from repro_torch.models.params import tree_leaves
from repro_torch.train import OptConfig, schedule_lr
from repro_torch.train.compress import (compress_with_feedback, dequantize,
                                        init_error_state, quantize)

# Six xdist workers share 8 cores with the reference's timing-bounded
# property tests: one intra-op thread per worker keeps them on time.
torch.set_num_threads(1)


def mk_trainer(steps=20, ckpt_every=5):
    cfg = get_smoke("smollm_135m")
    opt = OptConfig(peak_lr=1e-3, warmup_steps=2, total_steps=steps,
                    schedule="wsd")
    data = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    return Trainer(cfg, opt, data, checkpoint_every=ckpt_every,
                   device="cpu")


def test_loss_decreases():
    tr = mk_trainer(steps=30)
    tr.init(try_restore=False)
    hist = tr.run(30, log_every=30)
    assert hist[-1][1] < 6.0


def test_failure_recovery_bit_exact():
    """train(20) == train(12) + crash + restore(10) + train(10..20):
    deterministic data pipeline + exact state restore => identical
    params and optimizer state, leaf for leaf, by bits."""
    tr1 = mk_trainer(steps=20, ckpt_every=5)
    tr1.init(try_restore=False)
    tr1.run(20, log_every=100)

    tr2 = mk_trainer(steps=20, ckpt_every=5)
    tr2.init(try_restore=False)
    with pytest.raises(SimulatedHostFailure):
        tr2.run(20, inject_failure_at=12, log_every=100)
    tr2.simulate_crash()
    resumed = tr2.init(try_restore=True)
    assert resumed == 10  # last durable checkpoint
    step = tr2.opt_state["step"]
    assert step.shape == () and step.dtype == torch.int32 and int(step) == 10
    tr2.ckpt = AsyncCheckpointer(tr2.store)
    tr2.run(20, log_every=100)
    for want, got in ((tr1.params, tr2.params),
                      (tr1.opt_state, tr2.opt_state)):
        a, b = list(tree_leaves(want)), list(tree_leaves(got))
        assert [p for p, _ in a] == [p for p, _ in b]
        for (path, x), (_, y) in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape, path
            assert torch.equal(x.reshape(-1).view(torch.uint8),
                               y.reshape(-1).view(torch.uint8)), path


def test_wsd_schedule_shape():
    cfg = OptConfig(peak_lr=1.0, warmup_steps=10, total_steps=100,
                    schedule="wsd", wsd_decay_frac=0.2, min_lr_frac=0.1)
    lrs = [float(schedule_lr(torch.tensor(s), cfg)) for s in range(101)]
    assert lrs[5] < lrs[10]                     # warmup
    assert lrs[10] == pytest.approx(1.0)
    assert lrs[50] == pytest.approx(1.0)        # stable plateau
    assert lrs[100] == pytest.approx(0.1, rel=1e-3)  # decayed tail


def test_data_pipeline_deterministic_and_seekable():
    d1 = SyntheticTokens(DataConfig(vocab=100, seq_len=16, global_batch=4))
    d2 = SyntheticTokens(DataConfig(vocab=100, seq_len=16, global_batch=4))
    np.testing.assert_array_equal(d1.get_batch(7)["tokens"],
                                  d2.get_batch(7)["tokens"])
    # host partitioning is disjoint and covers the global batch
    g = SyntheticTokens(DataConfig(vocab=100, seq_len=16, global_batch=4))
    h0 = SyntheticTokens(DataConfig(vocab=100, seq_len=16, global_batch=4,
                                    num_hosts=2, host_id=0))
    h1 = SyntheticTokens(DataConfig(vocab=100, seq_len=16, global_batch=4,
                                    num_hosts=2, host_id=1))
    full = g.get_batch(3)["tokens"]
    np.testing.assert_array_equal(
        np.concatenate([h0.get_batch(3)["tokens"],
                        h1.get_batch(3)["tokens"]]), full)


def test_planted_bigram_learnable():
    """The synthetic stream's planted structure gives a learnable signal."""
    d = SyntheticTokens(DataConfig(vocab=50, seq_len=32, global_batch=8))
    toks = d.get_batch(0)["tokens"]
    # odd positions are a deterministic function of the preceding token
    f, consistent, total = {}, 0, 0
    for row in toks:
        for i in range(1, len(row), 2):
            total += 1
            prev = row[i - 1]
            if prev in f:
                consistent += f[prev] == row[i]
            else:
                f[prev] = row[i]
                consistent += 1
    assert consistent / total > 0.95


@given(st.lists(st.floats(-100, 100, allow_nan=False), min_size=1,
                max_size=64))
@settings(max_examples=50, deadline=None)
def test_quantize_error_bounded(xs):
    x = torch.tensor(np.asarray(xs, np.float32))
    q, scale = quantize(x)
    err = (dequantize(q, scale) - x).abs()
    assert float(err.max()) <= float(scale) * 0.5 + 1e-6


def test_error_feedback_unbiased_over_time():
    """Sum of dequantized updates + final residual == sum of true grads."""
    rng = np.random.default_rng(0)
    err = torch.zeros(32)
    total_sent, total_true = np.zeros(32), np.zeros(32)
    for _ in range(50):
        g = torch.from_numpy(rng.standard_normal(32).astype(np.float32))
        q, scale, err = compress_with_feedback(g, err)
        total_sent += dequantize(q, scale).numpy()
        total_true += g.numpy()
    np.testing.assert_allclose(total_sent + err.numpy(), total_true,
                               rtol=1e-4, atol=1e-4)


def test_compressed_allreduce():
    """int8 gradient all-reduce over a one-rank gloo group (the
    reference's shard_map over the data axis of one device)."""
    import socket

    import torch.distributed as dist
    from repro_torch.train.compress import compressed_grad_allreduce
    g = {"w": torch.arange(8, dtype=torch.float32)}
    e = init_error_state(g)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        out, new_e = compressed_grad_allreduce(g, e)
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(out["w"].numpy(), np.arange(8), atol=0.05)
    assert new_e["w"].dtype == torch.float32


# --------------------------------------------------------- trainer edges
def test_trainer_on_a_mesh_is_not_ported_yet():
    cfg = get_smoke("smollm_135m")
    with pytest.raises(NotImplementedError):
        Trainer(cfg, OptConfig(), DataConfig(vocab=cfg.vocab, seq_len=8,
                                             global_batch=2),
                mesh=object(), device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no CUDA")
def test_no_silent_cpu_fallback():
    cfg = get_smoke("smollm_135m")
    data = DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg, OptConfig(), data)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--smoke", "--steps", "2"])


def test_command_line_recovers_from_an_injected_failure(capsys):
    main(["--arch", "smollm_135m", "--smoke", "--steps", "12", "--batch",
          "4", "--seq", "16", "--checkpoint-every", "4",
          "--inject-failure", "7", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "simulated host failure at step 7" in out
    assert "restored at step 4; resuming" in out
    assert "step    12 loss" in out
