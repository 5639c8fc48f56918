"""repro_torch serving: AutumnKV and the serve engine against the reference.

* ``ServeEngine`` tokens equal the reference engine's, wave for wave, with
  the same hits, page writes and dedups, at float32 compute (weights carried
  across through numpy);
* the reference's own serving tests (``tests/test_serve_kvcache.py``) pass
  on the port for the ported architectures;
* chain hashes are equal, and codec page and state blobs are byte-identical
  to ``repro.kvcache.CacheCodec``'s for the same cache contents;
* the engine runs on the card unless asked for the CPU.

Every reference ``ServeEngine`` built here is closed (its store runs
background workers).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.kvcache import AutumnKVCache as RefKV
from repro.kvcache import chain_hashes as ref_chain_hashes
from repro.models import model as RM
from repro.models.params import init_params as ref_init_params
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro_torch.configs import get_smoke
from repro_torch.kvcache import AutumnKVCache, chain_hashes
from repro_torch.models import init_cache, init_params
from repro_torch.models.convert import (cache_from_numpy, cache_to_numpy,
                                        params_from_numpy, params_to_numpy,
                                        tensor_from_numpy)
from repro_torch.models.params import tree_leaves
from repro_torch.serve import Request, ServeEngine

# Six xdist workers share 8 cores with the reference's timing-bounded
# property tests: one intra-op thread per worker keeps them on time.
torch.set_num_threads(1)

ARCHS = ["qwen3_4b", "smollm_135m"]


def port_engine(cfg, batch=2, s_max=80, seed=0):
    params = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    return ServeEngine(cfg, params, batch=batch, s_max=s_max, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_equal_the_reference_engine(arch):
    ref_cfg = dataclasses.replace(ref_get_smoke(arch), compute_dtype="float32")
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                               device="cpu")
    ref = RefEngine(ref_cfg, ref_params, batch=4, s_max=96)
    port = ServeEngine(cfg, params, batch=4, s_max=96, device="cpu")
    try:
        rng = np.random.default_rng(7)
        a, b = (rng.integers(0, cfg.vocab, 64, dtype=np.int32)
                for _ in range(2))
        for prompts in ([a] * 4, [a] * 4, [b] * 2 + [a] * 2):
            want = ref.serve_batch([RefRequest(p, 8) for p in prompts])
            got = port.serve_batch([Request(p, 8) for p in prompts])
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            r, s = ref.kv.stats(), port.kv.stats()
            assert [s[k] for k in ("hits", "misses", "pages_written",
                                   "pages_deduped")] == \
                [r[k] for k in ("hits", "misses", "pages_written",
                                "pages_deduped")]
        assert port.kv.hits == 6
        for key in ("prefill_tokens", "decoded_tokens", "cache_hits",
                    "batches"):
            assert port.metrics[key] == ref.metrics[key], key
    finally:
        ref.close()


# ------------------------------------ the reference's serving tests, ported
@pytest.mark.parametrize("arch", ARCHS)
def test_hit_and_miss_paths_identical(arch):
    cfg = get_smoke(arch)
    eng = port_engine(cfg)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab, 64, dtype=np.int32)
    reqs = [Request(prompt, gen_len=4)] * 2
    out1 = eng.serve_batch(reqs)
    out2 = eng.serve_batch(reqs)
    for a, b in zip(out1, out2):
        np.testing.assert_array_equal(a, b)
    assert eng.kv.hits >= 2


@pytest.mark.parametrize("arch", ARCHS)
def test_content_addressed_dedup(arch):
    cfg = get_smoke(arch)
    eng = port_engine(cfg)
    rng = np.random.default_rng(2)
    p = rng.integers(0, cfg.vocab, 64, dtype=np.int32)
    eng.serve_batch([Request(p, 2), Request(p, 2)])
    s = eng.kv.stats()
    assert s["pages_written"] == 1 and s["pages_deduped"] == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_different_prompts_no_false_hits(arch):
    cfg = get_smoke(arch)
    eng = port_engine(cfg)
    rng = np.random.default_rng(3)
    p1 = rng.integers(0, cfg.vocab, 64, dtype=np.int32)
    p2 = rng.integers(0, cfg.vocab, 64, dtype=np.int32)
    eng.serve_batch([Request(p1, 2), Request(p1, 2)])
    eng.serve_batch([Request(p2, 2), Request(p2, 2)])
    assert eng.kv.hits == 0
    assert eng.kv.pages_written == 2


def test_chain_hash_prefix_property_and_reference_equality():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 1000, 192, dtype=np.int64)
    b = a.copy()
    b[130] += 1  # diverge in the 3rd page
    ha, hb = chain_hashes(a), chain_hashes(b)
    assert ha[0] == hb[0] and ha[1] == hb[1]
    assert ha[2] != hb[2]
    for toks, page in ((a, 64), (b, 64), (rng.integers(0, 2**31, 200), 16),
                       (a[:63], 64)):
        assert chain_hashes(toks, page) == ref_chain_hashes(toks, page)


# ------------------------------------------------------------ the codec
@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_codec_blobs_are_byte_identical(arch, compute_dtype):
    ref_cfg = dataclasses.replace(ref_get_smoke(arch),
                                  compute_dtype=compute_dtype)
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype=compute_dtype)
    params = ref_init_params(ref_cfg, jax.random.PRNGKey(5))
    rng = np.random.default_rng(5)
    toks = jnp.asarray(rng.integers(0, cfg.vocab, (1, 64)))
    _, ref_cache = RM.prefill(params, {"tokens": toks}, ref_cfg, s_max=80)
    ref_cache = jax.tree.map(np.asarray, ref_cache)
    cache = cache_from_numpy(ref_cache, device="cpu")
    for (_, a), (_, b) in zip(tree_leaves(cache_to_numpy(cache)),
                              tree_leaves(ref_cache)):
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
    ref_kv, kv = RefKV(ref_cfg, 1, 80), AutumnKVCache(cfg, 1, 80,
                                                      device="cpu")
    try:
        for page in (0, 1, 2):               # full, partial (64..80), past
            assert kv.codec.page_bytes(cache, page) == \
                ref_kv.codec.page_bytes(ref_cache, page)
        assert kv.codec.state_bytes(cache) == \
            ref_kv.codec.state_bytes(ref_cache)
        # a blob written back restores the slice it came from
        blank = init_cache(cfg, 1, 80, device="cpu")
        kv.codec.write_state(blank, kv.codec.state_bytes(cache))
        kv.codec.write_page(blank, kv.codec.page_bytes(cache, 0), 0)
        assert int(blank["pos"]) == 64
        for (_, a), (_, b) in zip(tree_leaves(cache), tree_leaves(blank)):
            if a.dim():
                assert torch.equal(a[:, :, :64], b[:, :, :64])
                assert not b[:, :, 64:].any()
    finally:
        ref_kv.close()


def test_engine_runs_on_the_card_unless_asked_for_the_cpu():
    cfg = get_smoke("qwen3_4b")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    if torch.cuda.is_available():
        assert ServeEngine(cfg, params, 1, 64).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            ServeEngine(cfg, params, 1, 64)
    assert ServeEngine(cfg, params, 1, 64, device="cpu").device.type == "cpu"


CARRY_ACROSS = {
    "tensor_from_numpy": lambda cfg, dev: tensor_from_numpy(
        np.ones((2, 3), np.float32), **dev),
    "params_from_numpy": lambda cfg, dev: params_from_numpy(
        params_to_numpy(init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")), cfg, **dev)["embed"],
    "cache_from_numpy": lambda cfg, dev: cache_from_numpy(
        cache_to_numpy(init_cache(cfg, 1, 64, device="cpu")), **dev)["pos"],
    "init_cache": lambda cfg, dev: init_cache(cfg, 1, 64, **dev)["pos"],
}


@pytest.mark.parametrize("name", sorted(CARRY_ACROSS))
def test_weights_and_caches_go_to_the_card_unless_asked_for_the_cpu(name):
    """The functions that carry weights and caches across, like the engine,
    mean ``cuda:0`` by default and raise without CUDA."""
    cfg = get_smoke("qwen3_4b")
    make = CARRY_ACROSS[name]
    if torch.cuda.is_available():
        assert make(cfg, {}).device == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(cfg, {})
    assert make(cfg, {"device": "cpu"}).device.type == "cpu"
