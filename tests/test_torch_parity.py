"""Every public name of the reference has its counterpart in the port.

For each module of ``src/repro/`` with a counterpart file in
``src/repro_torch/`` (the same path), the reference's public names must
exist in the port's module: its ``__all__``, else the functions and classes
it defines (a package: that it exports); for each class it defines, the
public methods and properties, and for a dataclass its fields.  A reference module with no counterpart
file must be mapped in ``MODULES`` to the port module that holds its work.

Deliberate exceptions are listed in ``EXCEPTIONS``, each with the port
name that does the same work (resolved by the test) or the reason it has
none.  An exception that the port no longer needs fails the test, so the
list stays true.

Below, the results of the names that closed the last gaps: the model
configuration's ``expand_stages``, ``has_decoder_attn_cache``,
``param_count`` and ``active_param_count`` and ``abstract_cache`` for all
ten architectures, and ``AutumnKVCache.lookup`` (hits, misses and the
restored cache), each against the reference.  The store's and the filter's
(``merge_runs_scalar``, ``entry_bytes``, ``blocks_for_bytes``, the read-cost
model, ``memory_bits``, ``expected_fpr``) are held in
``tests/test_torch_write_path.py`` and ``tests/test_torch_bloom.py``.
"""
import dataclasses
import importlib
import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# Six xdist workers share 8 cores with the reference's timing-bounded
# property tests: one intra-op thread per worker keeps them on time.
torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"

# reference modules without a counterpart file -> the port module(s) that
# hold their work
MODULES = {
    "repro.kernels.bloom_probe": "repro_torch.kernels.bloom",
    "repro.kernels.merge_path": "repro_torch.kernels.merge",
    "repro.kernels.paged_attention": "repro_torch.kernels.attention",
    "repro.kernels.flash_attention": "repro_torch.kernels.attention",
    # the plain versions live beside each CUDA kernel's wrapper
    "repro.kernels.ref": ("repro_torch.kernels.bloom",
                          "repro_torch.kernels.merge",
                          "repro_torch.kernels.attention"),
    "repro.launch.hlo_analysis": "repro_torch.launch.trace_cost",
}

_NUMPY_LANE = ("the numpy twin of the Pallas hash; the port hashes on the "
               "device")
_JAX_LANE = "a JAX lane of the reference's Pallas switches"
# (reference module, name) -> (port counterpart or None, why)
EXCEPTIONS = {
    ("repro.core.bloom", "hash_pair"):
        ("repro_torch.kernels.bloom.hash_pair", _NUMPY_LANE),
    ("repro.core.bloom", "build_bits"):
        ("repro_torch.kernels.bloom.build_plain", _NUMPY_LANE),
    ("repro.core.engine", "LSMConfig.use_pallas_bloom"):
        (None, "a Pallas switch: the port's filters always go through "
               "its bloom kernels (plain versions on the CPU)"),
    ("repro.core.engine", "LSMConfig.use_pallas_merge"):
        (None, "a Pallas switch: the port's compactions always go through "
               "its merge kernel (plain version on the CPU)"),
    ("repro.core.engine", "LSMStore._bloom_probe_fn"):
        ("repro_torch.kernels.ops.bloom_probe", _JAX_LANE),
    ("repro.core.engine", "LSMStore._bloom_hash_fn"):
        ("repro_torch.kernels.ops.bloom_build", _JAX_LANE),
    ("repro.core.engine", "LSMStore._pair_merge_fn"):
        ("repro_torch.kernels.ops.merge_pair", _JAX_LANE),
    ("repro.kernels.ops", "split_u64"):
        ("repro_torch.kernels.ops.keys_to_device",
         "u64 keys live on the device as int64 order-mapped keys, not "
         "as u32 halves"),
    ("repro.kernels.ops", "bloom_probe_filter"):
        ("repro_torch.kernels.ops.bloom_probe", _JAX_LANE),
    ("repro.kernels.ops", "bloom_build_hashes"):
        ("repro_torch.kernels.ops.bloom_build", _JAX_LANE),
    ("repro.kernels.ops", "merge_sorted_tiles"):
        ("repro_torch.kernels.ops.merge_pair", _JAX_LANE),
    ("repro.kernels.ops", "merge_runs_tiled"):
        ("repro_torch.kernels.ops.merge_pair", _JAX_LANE),
    ("repro.kernels", "split_u64"):
        ("repro_torch.kernels.ops.keys_to_device",
         "u64 keys live on the device as int64 order-mapped keys, not "
         "as u32 halves"),
    ("repro.kernels", "merge_sorted_tiles"):
        ("repro_torch.kernels.ops.merge_pair", _JAX_LANE),
    ("repro.kernels", "merge_runs_tiled"):
        ("repro_torch.kernels.ops.merge_pair", _JAX_LANE),
    ("repro.models", "prefill"):
        ("repro_torch.models.Model.prefill",
         "the port's serving model is an nn.Module"),
    ("repro.models", "decode_step"):
        ("repro_torch.models.Model.decode_step",
         "the port's serving model is an nn.Module"),
    ("repro.models.layers", "shard_knows"):
        ("repro_torch.models.layers.Shard.is_sharded",
         "every port Shard has is_sharded, so no probe is needed"),
    ("repro.models.model", "embed_tokens"):
        ("repro_torch.models.model.Model.embed_tokens",
         "the port's serving model is an nn.Module"),
    ("repro.models.model", "unembed"):
        ("repro_torch.models.model.Model.unembed",
         "the port's serving model is an nn.Module"),
    ("repro.models.model", "encoder_forward"):
        ("repro_torch.models.model.Model.encoder_forward",
         "the port's serving model is an nn.Module"),
    ("repro.models.model", "prefill"):
        ("repro_torch.models.model.Model.prefill",
         "the port's serving model is an nn.Module"),
    ("repro.models.model", "decode_step"):
        ("repro_torch.models.model.Model.decode_step",
         "the port's serving model is an nn.Module"),
    ("repro.models.model", "run_stages_prefill"):
        ("repro_torch.models.model.Model.prefill",
         "a Python loop over layers inside Model.prefill (no lax.scan)"),
    ("repro.models.model", "run_stages_decode"):
        ("repro_torch.models.model.Model.decode_step",
         "a Python loop over layers inside Model.decode_step"),
    ("repro.models.model", "run_stages_train"):
        ("repro_torch.models.train.run_stages_train",
         "training lives in models/train.py"),
    ("repro.models.model", "loss_fn"):
        ("repro_torch.models.train.loss_fn",
         "training lives in models/train.py"),
}


def module_name(path: Path) -> str:
    parts = path.relative_to(SRC).with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def reference_modules():
    return sorted(module_name(p) for p in (SRC / "repro").rglob("*.py"))


def counterpart_file(name: str) -> Path:
    rel = Path(*name.split(".")[1:])
    pkg = SRC / "repro_torch" / rel / "__init__.py"
    return pkg if (SRC / "repro" / rel / "__init__.py").exists() \
        else SRC / "repro_torch" / rel.with_suffix(".py")


def public_names(mod) -> list:
    """``__all__``, else the functions and classes the module defines (a
    package: that it exports)."""
    names = getattr(mod, "__all__", None)
    if names is None:
        package = hasattr(mod, "__path__")
        names = [n for n, o in vars(mod).items() if not n.startswith("_")
                 and (inspect.isfunction(o) or inspect.isclass(o))
                 and (package or o.__module__ == mod.__name__)]
    return list(names)


def class_members(cls) -> list:
    out = [n for n, o in vars(cls).items() if not n.startswith("_") and (
        inspect.isfunction(o)
        or isinstance(o, (property, staticmethod, classmethod)))]
    if dataclasses.is_dataclass(cls):
        out += [f.name for f in dataclasses.fields(cls) if f.name not in out]
    return out


def has_member(cls, name: str) -> bool:
    if hasattr(cls, name):
        return True
    return dataclasses.is_dataclass(cls) and name in {
        f.name for f in dataclasses.fields(cls)}


def resolve(dotted: str):
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise ImportError(dotted)


def gaps(name: str) -> list:
    """The reference module's public names (``Class.member`` for class
    members) that its port counterpart lacks."""
    ref = importlib.import_module(name)
    port = importlib.import_module("repro_torch" + name[len("repro"):])
    out = []
    for n in public_names(ref):
        if not hasattr(port, n):
            out.append(n)
            continue
        obj = getattr(ref, n)
        if inspect.isclass(obj) and obj.__module__ == ref.__name__:
            out += [f"{n}.{m}" for m in class_members(obj)
                    if not has_member(getattr(port, n), m)]
    return out


WITH_COUNTERPART = [m for m in reference_modules()
                    if counterpart_file(m).exists()]


def test_every_reference_module_has_a_counterpart():
    unmapped = [m for m in reference_modules()
                if not counterpart_file(m).exists() and m not in MODULES]
    assert not unmapped, f"reference modules with no port counterpart: " \
        f"{unmapped}"
    for ports in MODULES.values():
        for p in (ports,) if isinstance(ports, str) else ports:
            importlib.import_module(p)
    assert len(WITH_COUNTERPART) > 40


@pytest.mark.parametrize("name", WITH_COUNTERPART)
def test_reference_public_names_exist_in_the_port(name):
    missing = [n for n in gaps(name) if (name, n) not in EXCEPTIONS]
    assert not missing, f"{name}: the port lacks {missing}"


def test_exceptions_are_needed_and_name_their_counterparts():
    for (name, what), (counterpart, why) in EXCEPTIONS.items():
        assert why, (name, what)
        ref = importlib.import_module(name)
        port = importlib.import_module("repro_torch" + name[len("repro"):])
        owner, _, member = what.rpartition(".")
        if owner:
            assert has_member(getattr(ref, owner), member), (name, what)
            assert not has_member(getattr(port, owner), member), \
                f"{name}.{what} exists in the port now: drop its exception"
        else:
            assert hasattr(ref, what), (name, what)
            assert not hasattr(port, what), \
                f"{name}.{what} exists in the port now: drop its exception"
        if counterpart is not None:
            assert callable(resolve(counterpart)) or isinstance(
                resolve(counterpart), property), counterpart


# ---------------------------------------- the results of the closed gaps
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.kvcache import AutumnKVCache as RefKV  # noqa: E402
from repro.models import config as ref_config  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke  # noqa: E402
from repro_torch.kvcache import AutumnKVCache  # noqa: E402
from repro_torch.models import (abstract_cache, expand_stages,  # noqa: E402
                                find_stages, init_cache)
from repro_torch.models.convert import cache_from_numpy  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_config_helpers_equal_the_reference(arch):
    for cfg, want in ((get_config(arch), ref_get_config(arch)),
                      (get_smoke(arch), ref_get_smoke(arch))):
        stages = find_stages(cfg.layer_pattern)
        assert expand_stages(stages) == cfg.layer_pattern == \
            ref_config.expand_stages(ref_config.find_stages(
                want.layer_pattern))
        assert cfg.has_decoder_attn_cache == want.has_decoder_attn_cache
        assert cfg.param_count() == want.param_count()
        assert cfg.active_param_count() == want.active_param_count()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_cache_matches_the_reference_leaf_for_leaf(arch):
    for cfg, want_cfg, B, s_max in ((get_smoke(arch), ref_get_smoke(arch),
                                     2, 40),
                                    (get_config(arch), ref_get_config(arch),
                                     4, 32_768)):
        got = abstract_cache(cfg, B, s_max, pos=3)
        want = ref_model.abstract_cache(want_cfg, B, s_max, pos=3)
        got_leaves = list(tree_leaves(got))
        want_leaves = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in got_leaves] == \
            [jax.tree_util.keystr(p) for p, _ in want_leaves]
        for (path, t), (_, w) in zip(got_leaves, want_leaves):
            assert t.device.type == "meta", path
            assert tuple(t.shape) == tuple(w.shape), path
            assert str(t.dtype).split(".")[-1] == str(w.dtype), path
        # the concrete cache has the same leaves
        if s_max == 40:
            real = tree_leaves(init_cache(cfg, B, s_max, device="cpu"))
            assert [(p, t.shape, t.dtype) for p, t in real] == \
                [(p, t.shape, t.dtype) for p, t in got_leaves]


@pytest.mark.parametrize("arch", ["qwen3_4b", "smollm_135m"])
def test_lookup_hits_and_misses_as_the_reference(arch):
    """``lookup``: a stored prompt hits and restores its cache, an unseen
    prompt, a prompt that is not whole pages and the empty prompt miss,
    with the reference's counters after every call."""
    cfg, ref_cfg = get_smoke(arch), ref_get_smoke(arch)
    rng = np.random.default_rng(8)
    stored = rng.integers(0, cfg.vocab, 64, dtype=np.int32)
    params = ref_model_params(ref_cfg)
    _, ref_cache = ref_model.prefill(
        params, {"tokens": jnp.asarray(stored[None])}, ref_cfg, s_max=80)
    ref_cache = jax.tree.map(np.asarray, ref_cache)
    cache = cache_from_numpy(ref_cache, device="cpu")
    ref_kv, kv = RefKV(ref_cfg, 1, 80), AutumnKVCache(cfg, 1, 80,
                                                      device="cpu")
    try:
        ref_kv.insert(stored, ref_cache)
        kv.insert(stored, cache)
        ref_template = ref_model.init_cache(ref_cfg, 1, 80)
        template = init_cache(cfg, 1, 80, device="cpu")
        prompts = [stored, rng.integers(0, cfg.vocab, 64, dtype=np.int32),
                   stored[:63], stored[:0], stored]
        for tokens in prompts:
            got = kv.lookup(tokens, template)
            want = ref_kv.lookup(tokens, ref_template)
            assert (got is None) == (want is None)
            assert (kv.hits, kv.misses) == (ref_kv.hits, ref_kv.misses)
            if got is not None:
                for (path, t), w in zip(tree_leaves(got),
                                        jax.tree_util.tree_leaves(want)):
                    w = np.asarray(w)
                    assert t.float().numpy().tobytes() == \
                        w.astype(np.float32).tobytes(), path
        assert (kv.hits, kv.misses) == (2, 3)
        assert not any(t.any() for _, t in tree_leaves(template))
    finally:
        ref_kv.close()
        kv.close()


def ref_model_params(ref_cfg):
    from repro.models.params import init_params
    return init_params(ref_cfg, jax.random.PRNGKey(5))
