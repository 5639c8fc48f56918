"""repro_torch serving for every family against the reference engine, the
prefix cache switched off, and AutumnKV's ring pages.

* ``ServeEngine`` tokens, hits, page counts and metrics equal the
  reference engine's at float32 for each family beyond the dense one
  (whisper and llama32 with their stubbed extras), and for every family
  with ``use_prefix_cache=False`` (no AutumnKV at all);
* a prompt longer than a sliding-window ring: the reference stores the
  ring's slots as the prompt's pages, so a second prompt sharing the first
  page restores the wrong keys and its hit decodes other tokens than its
  miss (ROADMAP C8; pinned below).  The port keeps a wrapped ring in the
  full-prompt state record: hit and miss decode the same tokens, whatever
  prompt wrote the shared pages first.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.data import stub_frontend_inputs as ref_stub_frontend_inputs
from repro.models.params import init_params as ref_init_params
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro_torch.configs import ARCH_IDS, get_smoke
from repro_torch.data import stub_frontend_inputs
from repro_torch.kvcache import AutumnKVCache, chain_hashes
from repro_torch.models import init_params
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import Request, ServeEngine

# Six xdist workers share 8 cores with the reference's timing-bounded
# property tests: one intra-op thread per worker keeps them on time.
torch.set_num_threads(1)

FAMILY_ARCHS = [a for a in ARCH_IDS if a not in ("qwen3_4b", "smollm_135m")]


def engines(arch, batch, s_max, use_prefix_cache=True):
    """The reference engine and the port's on the same float32 weights."""
    ref_cfg = dataclasses.replace(ref_get_smoke(arch), compute_dtype="float32")
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                               device="cpu")
    return (RefEngine(ref_cfg, ref_params, batch=batch, s_max=s_max,
                      use_prefix_cache=use_prefix_cache),
            ServeEngine(cfg, params, batch=batch, s_max=s_max,
                        use_prefix_cache=use_prefix_cache, device="cpu"))


def three_waves(ref, port, arch):
    """Cold, warm and mixed waves of 64-token prompts on both engines,
    tokens equal wave for wave."""
    ref_extras = ref_stub_frontend_inputs(ref.cfg, 4) or None
    extras = stub_frontend_inputs(port.cfg, 4) or None
    rng = np.random.default_rng(7)
    a, b = (rng.integers(0, port.cfg.vocab, 64, dtype=np.int32)
            for _ in range(2))
    for prompts in ([a] * 4, [a] * 4, [b] * 2 + [a] * 2):
        want = ref.serve_batch([RefRequest(p, 8) for p in prompts],
                               ref_extras)
        got = port.serve_batch([Request(p, 8) for p in prompts], extras)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=arch)
    for key in ("prefill_tokens", "decoded_tokens", "cache_hits", "batches"):
        assert port.metrics[key] == ref.metrics[key], key


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_engine_tokens_equal_the_reference_engine(arch):
    ref, port = engines(arch, 4, 96)
    try:
        three_waves(ref, port, arch)
        r, s = ref.kv.stats(), port.kv.stats()
        for k in ("hits", "misses", "pages_written", "pages_deduped"):
            assert s[k] == r[k], k
        assert port.kv.hits == 6
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_engine_without_prefix_cache_equals_the_reference(arch):
    ref, port = engines(arch, 4, 96, use_prefix_cache=False)
    try:
        assert ref.kv is None and port.kv is None
        three_waves(ref, port, arch)
        assert port.metrics["cache_hits"] == 0
        assert port.metrics["prefill_tokens"] == 3 * 4 * 64
    finally:
        ref.close()
        port.close()


# ------------------------------------------------------- ring pages (C8)
def _long_prompts(vocab):
    rng = np.random.default_rng(7)
    A, B, C = (rng.integers(0, vocab, 64, dtype=np.int32) for _ in range(3))
    return np.concatenate([A, B]), np.concatenate([A, C])


def test_long_prompt_hit_equals_miss_and_the_reference_fault_is_pinned():
    """gemma3's smoke config (window 8), s_max 160: serve A+B, then A+C (a
    miss sharing page A), then A+C again (a hit)."""
    ref, port = engines("gemma3_1b", 1, 160)
    try:
        p1, p2 = _long_prompts(port.cfg.vocab)
        want = [ref.serve_batch([RefRequest(p, 8)])[0] for p in (p1, p2, p2)]
        got = [port.serve_batch([Request(p, 8)])[0] for p in (p1, p2, p2)]
        assert ref.kv.hits == port.kv.hits == 1
        # the reference: its hit restores A+B's ring as A+C's first page
        assert not np.array_equal(want[2], want[1])
        # the port: the miss path is the reference's, and the hit equals it
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], got[1])
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("arch", ["gemma3_1b", "mixtral_8x22b",
                                  "recurrentgemma_2b"])
@pytest.mark.parametrize("short_first", [True, False])
def test_short_and_long_prompts_sharing_a_page_both_hit_right(arch,
                                                              short_first):
    """With a window of 64, a 64-token prompt fits every ring (its pages
    hold every layer) and a 128-token prompt sharing its page wraps the
    window rings (its pages hold only the global layers, none for
    mixtral): whichever is stored first, each one's hit decodes its miss's
    tokens."""
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32",
                              window=64)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cold = ServeEngine(cfg, params, 1, 160, use_prefix_cache=False,
                       device="cpu")
    eng = ServeEngine(cfg, params, 1, 160, device="cpu")
    try:
        long_p, _ = _long_prompts(cfg.vocab)
        short_p = long_p[:64]
        order = [short_p, long_p] if short_first else [long_p, short_p]
        for p in order:
            eng.serve_batch([Request(p, 8)])
        for p in order:
            np.testing.assert_array_equal(
                eng.serve_batch([Request(p, 8)])[0],
                cold.serve_batch([Request(p, 8)])[0])
        assert eng.kv.hits == 2
    finally:
        eng.close()


def test_wrapped_rings_go_whole_into_the_state_record():
    cfg = get_smoke("gemma3_1b")                      # window 8, s_max 160
    kv = AutumnKVCache(cfg, 1, 160, device="cpu")
    try:
        assert kv.codec.ring_extents == [8, 160]
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        eng = ServeEngine(cfg, params, 1, 160, use_prefix_cache=False,
                          device="cpu")
        p1, _ = _long_prompts(cfg.vocab)
        _, cache = eng.model.prefill(torch.from_numpy(p1[None]), 160)
        n_lattn = sum(k == "lattn" for k in cfg.layer_pattern)
        n_attn = cfg.n_layers - n_lattn
        kv_bytes = 2 * cfg.n_kv * cfg.d_head * 2           # k and v, bf16
        # 128 tokens wrap the 8-slot rings: pages hold the global layers
        assert kv.codec.wrapped_extents(128) == 1
        assert len(kv.codec.page_bytes(cache, 0, 128)) == \
            n_attn * 64 * kv_bytes
        assert len(kv.codec.state_bytes(cache, 128)) == \
            4 + n_lattn * 8 * kv_bytes
        # and are keyed apart from the pages of prompts that fit every ring
        assert kv.page_keys(p1) != chain_hashes(p1)
        assert kv.page_keys(p1[:8]) == chain_hashes(p1[:8]) == []
        # the reference's layout where the prompt fits: every ring paged
        assert kv.codec.wrapped_extents(8) == 0
        assert len(kv.codec.page_bytes(cache, 0, 8)) == \
            (n_attn * 64 + n_lattn * 8) * kv_bytes
        assert len(kv.codec.state_bytes(cache, 8)) == 4
    finally:
        kv.close()
