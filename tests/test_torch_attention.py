"""repro_torch attention: the plain versions of the flash and paged kernels
against the JAX reference, the paged kernel's split arithmetic and the
shape-only sizing of its grid, and the decode view the model uses.

The reference's Pallas kernels run in interpret mode, as its own tests run
them (``tests/test_kernels.py``), at the same shapes and tolerances: float32
at 2e-5, bfloat16 at 2e-2.  The CUDA kernels themselves are held against
these plain versions on the card (the ``cuda``-marked test in
``tests/test_torch_boundary.py``, which imports no JAX, and
``chip_smoke.py`` at the serving shapes).
"""
import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels.paged_attention import paged_attention_pallas
from repro.models.blocks import ring_positions as ref_ring_positions
from repro.models.layers import gqa_attention
from repro_torch.kernels import attention, ops
from repro_torch.models.blocks import decode_page, ring_positions

# Six xdist workers share 8 cores with the reference's timing-bounded
# property tests: one intra-op thread per worker keeps them on time.
torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def both(arr: np.ndarray, dtype: str):
    """One float32 numpy array as the same values in JAX and in torch."""
    j = jnp.asarray(arr, JNP[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(TORCH[dtype])
    return j, t


def close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KH,dh,page,P", [
    (2, 4, 4, 16, 8, 3),     # MHA
    (3, 8, 2, 32, 16, 4),    # GQA
    (1, 16, 1, 64, 32, 2),   # MQA
])
def test_paged_plain_matches_reference_kernel(B, H, KH, dh, page, P, dtype):
    rng = np.random.default_rng(B * H)
    nphys = P * B + 2
    q, tq = both(rng.standard_normal((B, H, dh)), dtype)
    kp, tkp = both(rng.standard_normal((nphys, page, KH, dh)), dtype)
    vp, tvp = both(rng.standard_normal((nphys, page, KH, dh)), dtype)
    bt = rng.integers(0, nphys, (B, P)).astype(np.int32)
    ln = rng.integers(1, P * page + 1, B).astype(np.int32)
    want = ref_ops.paged_attention(q, kp, vp, jnp.asarray(bt),
                                   jnp.asarray(ln))
    got = attention.paged_plain(tq, tkp, tvp, torch.from_numpy(bt),
                                torch.from_numpy(ln))
    assert got.dtype == TORCH[dtype] and got.shape == (B, H, dh)
    close(got, want, TOL[dtype])


SPLIT_PAGE, SPLIT_P, SPLIT_KH, SPLIT_DH = 16, 4, 2, 32
# lengths 0 (all pages, uniform), 1, one page, one page and one, all pages
SPLIT_LENGTHS = [0, 1, SPLIT_PAGE, SPLIT_PAGE + 1, SPLIT_P * SPLIT_PAGE]


@functools.lru_cache(maxsize=None)
def split_case(G: int, dtype: str):
    """Inputs and the two reference answers (the oracle and the Pallas
    kernel in interpret mode) for one group size and type."""
    rng = np.random.default_rng(G)
    B, H = len(SPLIT_LENGTHS), G * SPLIT_KH
    nphys = B * SPLIT_P + 3
    q, tq = both(rng.standard_normal((B, H, SPLIT_DH)), dtype)
    kp, tkp = both(rng.standard_normal((nphys, SPLIT_PAGE, SPLIT_KH,
                                        SPLIT_DH)), dtype)
    vp, tvp = both(rng.standard_normal((nphys, SPLIT_PAGE, SPLIT_KH,
                                        SPLIT_DH)), dtype)
    bt = rng.permutation(nphys)[:B * SPLIT_P].reshape(B, SPLIT_P)
    bt = bt.astype(np.int32)
    ln = np.array(SPLIT_LENGTHS, np.int32)
    args = (q, kp, vp, jnp.asarray(bt), jnp.asarray(ln))
    wants = (np.asarray(ref_ref.paged_attention_ref(*args), np.float32),
             np.asarray(paged_attention_pallas(*args, interpret=True),
                        np.float32))
    return (tq, tkp, tvp, torch.from_numpy(bt), torch.from_numpy(ln)), wants


@pytest.mark.parametrize("pps", range(1, SPLIT_P + 1))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 4, 8])
def test_paged_split_plain_matches_reference(G, dtype, pps):
    """The split kernel's arithmetic (per-split softmax partials, then the
    ordered combine) against the reference oracle and Pallas kernel, for
    every split width, at lengths 0, 1, page, page + 1 and P * page."""
    inputs, wants = split_case(G, dtype)
    got = attention.paged_split_plain(*inputs, pps)
    assert got.dtype == TORCH[dtype] and got.shape == inputs[0].shape
    for want in wants:
        close(got, want, TOL[dtype])


SERVE_SHAPE = dict(B=4, KH=8, P=16, page=64)     # qwen3_4b decode, s_max 1024


@pytest.mark.parametrize("B,KH,P,page", [
    tuple(SERVE_SHAPE.values()), (1, 8, 16, 64), (4, 8, 64, 64),
    (1, 8, 512, 16), (2, 2, 3, 16), (1, 1, 1, 1), (3, 4, 100, 7),
    (1, 32, 1, 128)])
def test_paged_splits_depend_on_the_shape_only(B, KH, P, page):
    """The paged grid comes from the shape and the SM count alone (no
    lengths, no batch size), covers every page with no empty split, and
    fills the card's 132 SMs at the serving shape."""
    assert list(inspect.signature(attention.paged_splits).parameters) == \
        ["KH", "P", "page", "n_sm"]
    n_sm = 132
    splits, pps = attention.paged_splits(KH, P, page, n_sm)
    assert 1 <= pps <= P and splits * pps >= P > (splits - 1) * pps
    assert pps * page >= min(P * page, attention.SPLIT_MIN_KEYS)
    if dict(B=B, KH=KH, P=P, page=page) == SERVE_SHAPE:
        assert splits * KH * B >= n_sm
    if P * KH >= n_sm and page >= attention.SPLIT_MIN_KEYS:
        assert splits * KH >= n_sm           # one row alone fills the card
    assert attention.paged_splits(KH, P, page, n_sm) == (splits, pps)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0)])
def test_flash_plain_matches_reference_kernel(dtype, causal, window):
    rng = np.random.default_rng(42)
    q, tq = both(rng.standard_normal((2, 256, 4, 32)), dtype)
    k, tk = both(rng.standard_normal((2, 256, 2, 32)), dtype)
    v, tv = both(rng.standard_normal((2, 256, 2, 32)), dtype)
    want = ref_ops.flash_attention(q, k, v, causal=causal, window=window,
                                   bq=64, bk=64)
    got = attention.flash_plain(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == TORCH[dtype]
    close(got, want, TOL[dtype])


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (100, 100, True, 0), (70, 130, False, 50), (200, 100, True, 30)])
def test_flash_plain_ragged_lengths_match_reference(Sq, Sk, causal, window):
    """Lengths that are no multiple of any tile (the Pallas kernel asserts
    divisibility; its oracle does not), including rows with no valid key."""
    rng = np.random.default_rng(Sq + Sk)
    q, tq = both(rng.standard_normal((2, Sq, 4, 16)), "float32")
    k, tk = both(rng.standard_normal((2, Sk, 2, 16)), "float32")
    v, tv = both(rng.standard_normal((2, Sk, 2, 16)), "float32")
    want = ref_ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    got = attention.flash_plain(tq, tk, tv, causal=causal, window=window)
    close(got, want, TOL["float32"])


def test_flash_plain_matches_model_attention():
    """Prefill attention in the port against the reference's XLA path."""
    rng = np.random.default_rng(5)
    q, tq = both(rng.standard_normal((2, 128, 8, 16)), "float32")
    k, tk = both(rng.standard_normal((2, 128, 2, 16)), "float32")
    v, tv = both(rng.standard_normal((2, 128, 2, 16)), "float32")
    pos = jnp.broadcast_to(jnp.arange(128)[None], (2, 128))
    want = gqa_attention(q, k, v, q_positions=pos, k_positions=pos,
                         causal=True, window=None)
    close(attention.flash_plain(tq, tk, tv, causal=True), want, 2e-5)


@pytest.mark.parametrize("s_cache,pos", [(80, 3), (80, 79), (80, 85),
                                         (96, 250), (64, 64)])
def test_decode_view_equals_ring_attention(s_cache, pos):
    """The identity-block-table view of a ring cache, lengths
    min(pos + 1, s_cache), equals the reference's decode attention with
    ring positions, before and after the ring wraps."""
    rng = np.random.default_rng(s_cache + pos)
    B, H, KH, dh = 3, 8, 2, 16
    q, tq = both(rng.standard_normal((B, 1, H, dh)), "float32")
    ck, tck = both(rng.standard_normal((B, s_cache, KH, dh)), "float32")
    cv, tcv = both(rng.standard_normal((B, s_cache, KH, dh)), "float32")
    kp = ref_ring_positions(jnp.int32(pos), s_cache)[None]
    np.testing.assert_array_equal(
        ring_positions(torch.tensor(pos, dtype=torch.int32), s_cache).numpy(),
        np.asarray(kp[0]))
    want = gqa_attention(q, ck, cv, q_positions=jnp.full((B, 1), pos),
                         k_positions=kp, causal=True, window=None)
    page = decode_page(s_cache)
    n = s_cache // page
    got = attention.paged_plain(
        tq[:, 0], tck.view(-1, page, KH, dh), tcv.view(-1, page, KH, dh),
        torch.arange(B * n, dtype=torch.int32).view(B, n),
        torch.full((B,), min(pos + 1, s_cache), dtype=torch.int32))
    close(got[:, None], want, 2e-5)


def test_decode_page_divides_the_cache():
    assert [decode_page(s) for s in (1024, 96, 80, 64, 7)] == [64, 32, 16,
                                                              64, 1]


def test_cpu_attention_takes_the_plain_version_and_counts_it():
    ops.reset_launch_counts()
    q = torch.randn(1, 8, 4, 16)
    k = torch.randn(1, 8, 2, 16)
    ops.flash_attention(q, k, k)
    ops.paged_attention(q[:, 0], k, k, torch.zeros((1, 1), dtype=torch.int32),
                        torch.ones(1, dtype=torch.int32))
    assert ops.PLAIN_CALLS["flash_attention"] == 1
    assert ops.PLAIN_CALLS["paged_attention"] == 1
    assert ops.launch_counts()["flash_attention"] == 0
    assert ops.launch_counts()["paged_attention"] == 0


def test_cuda_wrappers_refuse_cpu_tensors():
    q = torch.randn(1, 8, 4, 16)
    with pytest.raises(ValueError, match="must be on"):
        attention.flash_cuda(q, q[:, :, :2], q[:, :, :2].contiguous())
    with pytest.raises(ValueError, match="must be on"):
        attention.paged_cuda(q[:, 0], q, q,
                             torch.zeros((1, 1), dtype=torch.int32),
                             torch.ones(1, dtype=torch.int32))
