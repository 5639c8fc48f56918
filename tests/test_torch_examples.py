"""The examples' twins (``examples/torch/``) on the CPU, each held against
its reference example (``examples/*.py``) run in this process."""
import contextlib
import dataclasses
import io
import importlib.util
import re
import runpy
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro_torch.models.convert import params_from_numpy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def run_reference(name: str):
    """(globals, printed lines) of ``examples/<name>.py``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        g = runpy.run_path(str(ROOT / "examples" / f"{name}.py"),
                           run_name="__main__")
    return g, buf.getvalue().splitlines()


def run_twin(name: str, **kw):
    """(records, printed lines) of ``examples/torch/<name>.py``'s main on
    the CPU."""
    spec = importlib.util.spec_from_file_location(
        f"example_torch_{name}", ROOT / "examples" / "torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = mod.main(device="cpu", **kw)
    return out, buf.getvalue().splitlines()


def test_quickstart_prints_the_references_answers():
    _, want = run_reference("quickstart")
    got, lines = run_twin("quickstart")
    assert lines == want
    assert got["point_read"] == b"value-" and got["levels"] == 4


def test_kernels_demo_matches_the_reference():
    ref, _ = run_reference("kernels_demo")
    got, _ = run_twin("kernels_demo")
    assert got["members_all_hit"]
    assert got["fpr"] == ref["fpr"]
    assert got["merged"] == len(ref["merged"]) == 8000
    assert got["from_b"] == int((np.asarray(ref["src"]) >> 31).sum())
    assert got["bloom_mismatches"] == got["merge_mismatches"] == 0
    # the reference's kernel tests' tolerances: 2e-5 (f32), 2e-2 (bf16)
    np.testing.assert_allclose(got["paged_out"], np.asarray(ref["out"]),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(
        got["flash_out"], np.asarray(ref["o"].astype(np.float32)),
        atol=2e-2, rtol=0)


WAVE = re.compile(r"hits=\s*(\d+) pages_written=(\d+) deduped=(\d+) "
                  r"\| first tokens: \[([\d, ]*)\]")


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_serve_autumnkv_with_the_references_weights(compute_dtype,
                                                    monkeypatch):
    """The waves' hits, pages and first tokens as the reference prints them,
    at the example's own config (bf16 compute) and at float32, where every
    decoded token of the last wave must equal the reference's too (bf16
    greedy decodes may part at near ties, as the serving tests find)."""
    import repro.configs
    import repro_torch.configs
    for mod in (repro.configs, repro_torch.configs):
        smoke = mod.get_smoke
        monkeypatch.setattr(mod, "get_smoke", lambda a, smoke=smoke:
                            dataclasses.replace(smoke(a),
                                                compute_dtype=compute_dtype))
    ref, lines = run_reference("serve_autumnkv")
    want = [WAVE.search(x).groups() for x in lines if WAVE.search(x)]
    cfg = repro_torch.configs.get_smoke("qwen3_4b")
    assert cfg.compute_dtype == compute_dtype
    params = params_from_numpy(jax.tree.map(np.asarray, ref["params"]), cfg,
                               "cpu")
    got, _ = run_twin("serve_autumnkv", params=params)
    assert [(w["hits"], w["pages_written"], w["pages_deduped"],
             [t[0] for t in w["tokens"]]) for w in got["waves"]] == \
        [(int(h), int(p), int(d), [int(t) for t in f.split(",")])
         for h, p, d, f in want]
    assert [w["hits"] for w in got["waves"]] == [0, 4, 6]
    if compute_dtype == "float32":
        assert got["waves"][-1]["tokens"] == [
            [int(t) for t in o] for o in ref["outs"]]


def test_train_with_failures_resumes_where_the_reference_does():
    ref, _ = run_reference("train_with_failures")
    got, lines = run_twin("train_with_failures")
    assert got["resumed"] == ref["resumed"] == 30
    assert got["step"] == ref["trainer"].step == 60
    assert any("restored from Autumn store at step 30" in x for x in lines)
