"""The kernels' three routes by the tensor they are given: a tensor with no
data (fake or meta) gets empty outputs and its work counted, never a
kernel; a CPU tensor the plain version; a CUDA tensor the kernel.

This file imports no JAX, so its ``cuda``-marked check also runs on the
card's machine.
"""
import math

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import _build
from repro_torch.kernels import attention, bloom, merge, ops

torch.set_num_threads(1)


def _entry_calls(dev):
    """Every entry point of ``ops`` on tensors made on ``dev``: (name,
    call, expected output shapes and dtypes, expected work)."""
    B, S, H, KH, dh, page, P = 2, 48, 8, 2, 64, 16, 4
    q = torch.empty(B, S, H, dh, dtype=torch.bfloat16, device=dev)
    k = torch.empty(B, S, KH, dh, dtype=torch.bfloat16, device=dev)
    q1 = torch.empty(B, H, dh, dtype=torch.float32, device=dev)
    kp = torch.empty(B * P, page, KH, dh, dtype=torch.float32, device=dev)
    bt = torch.empty(B, P, dtype=torch.int32, device=dev)
    ln = torch.empty(B, dtype=torch.int32, device=dev)
    keys = torch.empty(100, dtype=torch.int64, device=dev)
    keys_b = torch.empty(30, dtype=torch.int64, device=dev)
    bits = torch.empty(64, dtype=torch.int32, device=dev)
    splits, _ = attention.paged_splits(KH, P, page, bloom.H100_SMS)
    return [
        ("flash_attention",
         lambda: ops.flash_attention(q, k, k, causal=True, window=16),
         [((B, S, H, dh), torch.bfloat16)],
         attention.flash_work(q.shape, k.shape, torch.bfloat16, True, 16)),
        ("paged_attention", lambda: ops.paged_attention(q1, kp, kp, bt, ln),
         [((B, H, dh), torch.float32)],
         attention.paged_work(q1.shape, kp.shape, bt.shape, torch.float32)),
        ("paged_attention",
         lambda: ops.paged_attention_partials(q1, kp, kp, bt, ln),
         [((B, H, splits, dh), torch.float32),
          ((B, H, splits, 2), torch.float32), ((B, splits), torch.bool)],
         attention.paged_work(q1.shape, kp.shape, bt.shape, torch.float32)),
        ("bloom_probe", lambda: ops.bloom_probe(keys, bits, 7),
         [((100,), torch.bool)], bloom.probe_work(100, 64, 7)),
        ("bloom_build", lambda: ops.bloom_build(keys, 64, 7),
         [((64,), torch.int32)], bloom.build_work(100, 64, 7)),
        ("merge_pair", lambda: ops.merge_pair(keys, keys_b),
         [((130,), torch.int64), ((130,), torch.int64)],
         merge.merge_work(100, 30)),
    ]


@pytest.mark.parametrize("device", ["cuda", "meta", "cpu-fake"])
def test_a_tensor_with_no_data_never_reaches_a_kernel(device, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a tensor with no data reached a kernel build")
    monkeypatch.setattr(_build, "load", refuse)
    ops.reset_launch_counts()
    seen = []
    ops.WORK_SINKS.append(lambda *rec: seen.append(rec))
    try:
        mode = FakeTensorMode() if device != "meta" else None
        with mode or torch.no_grad():
            dev = "cpu" if device == "cpu-fake" else device
            for name, call, shapes, work in _entry_calls(dev):
                outs = call()
                outs = outs if isinstance(outs, tuple) else (outs,)
                assert [(tuple(o.shape), o.dtype) for o in outs] == shapes
                assert all(ops.shape_only(o) for o in outs)
                assert seen[-1][:3] == (name, *work), name
    finally:
        ops.WORK_SINKS.pop()
    assert len(seen) == 6
    assert all(v == 0 for v in ops.launch_counts().values())
    assert all(v == 0 for v in ops.PLAIN_CALLS.values())


def test_a_real_cpu_tensor_still_takes_the_plain_version():
    ops.reset_launch_counts()
    seen = []
    ops.WORK_SINKS.append(lambda *rec: seen.append(rec))
    try:
        g = torch.Generator().manual_seed(0)
        q = torch.randn(1, 16, 4, 8, generator=g)
        k = torch.randn(1, 16, 2, 8, generator=g)
        out = ops.flash_attention(q, k, k)
    finally:
        ops.WORK_SINKS.pop()
    assert torch.equal(out, attention.flash_plain(q, k, k))
    assert ops.PLAIN_CALLS["flash_attention"] == 1 and seen == []
    assert ops.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (48, 48, True, 0), (48, 48, True, 16), (1, 40, False, 0),
    (30, 50, False, 7), (50, 30, True, 0), (64, 64, True, 64)])
def test_flash_pairs_counts_what_the_mask_lets_through(Sq, Sk, causal,
                                                       window):
    ok = np.ones((Sq, Sk), bool)
    qi, ki = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    if causal:
        ok &= ki <= qi
    if window > 0:
        ok &= ki > qi - window
    assert attention.flash_pairs(Sq, Sk, causal, window) == int(ok.sum())


def test_paged_work_counts_the_live_positions():
    # the serve shape of chip_smoke's kernel rows: lengths 513..528
    n_tok = sum(range(513, 517))
    ops_, nbytes = attention.paged_work((4, 32, 128), (64, 64, 8, 128),
                                        (4, 16), torch.bfloat16, n_tok)
    assert ops_ == 4 * 32 * 128 * n_tok
    assert nbytes == (2 * 4 * 32 * 128 + 2 * n_tok * 8 * 128) * 2 \
        + 4 * 16 * 4 + 4 * 4
    assert attention.paged_work((4, 32, 128), (64, 64, 8, 128), (4, 16),
                                torch.bfloat16)[0] == 4 * 32 * 128 * 4096


@pytest.mark.cuda
def test_a_real_cuda_tensor_launches_its_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ops.reset_launch_counts()
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(1, 64, 4, 64, generator=g, device="cuda").bfloat16()
    k = torch.randn(1, 64, 2, 64, generator=g, device="cuda").bfloat16()
    out = ops.flash_attention(q, k, k)
    err = float((out.float() - attention.flash_plain(q, k, k).float())
                .abs().max())
    assert ops.launch_counts()["flash_attention"] == 1
    assert ops.PLAIN_CALLS["flash_attention"] == 0
    assert math.isfinite(err) and err <= 2e-2
