"""Shared pieces of the port's mesh tests (``test_torch_mesh.py``,
``test_torch_sharding.py``): the reference's meshless JAX results of a
smoke config, and a launcher of gloo ranks on the CPU that run
``_torch_mesh_worker.py``.

Every rank group is spawned once for a whole list of tasks, with a
timeout; the ranks import torch and ``repro_torch`` only.
"""
import dataclasses
import os
import pickle
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke as ref_get_smoke
from repro.data import stub_frontend_inputs as ref_stub_frontend_inputs
from repro.models import model as RM
from repro.models.params import init_params as ref_init_params

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_torch_mesh_worker.py"
S_MAX = 20          # decode past s_max and the smoke window: rings wrap
DECODE_STEPS = 8


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(world: int, tasks: list, timeout: float = 600.0) -> dict:
    """Runs ``tasks`` on ``world`` gloo ranks; rank 0's results."""
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        (d / "inputs.pkl").write_bytes(pickle.dumps(tasks))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT / "src")] + [p for p in os.environ.get(
                "PYTHONPATH", "").split(os.pathsep) if p]),
            OMP_NUM_THREADS="1")
        port = str(free_port())
        procs = [subprocess.Popen(
            [sys.executable, str(WORKER), str(r), str(world), port, str(d)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0].decode()[-4000:])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        errors = sorted(d.glob("error_*.txt"))
        if errors or any(p.returncode for p in procs):
            raise AssertionError("mesh ranks failed:\n" + "\n".join(
                e.read_text() for e in errors) + "\n".join(logs))
        return pickle.loads((d / "outputs.pkl").read_bytes())


def ref_config(arch: str, **edit):
    return dataclasses.replace(ref_get_smoke(arch), compute_dtype="float32",
                               **edit)


def reference_params(arch: str):
    cfg = ref_config(arch)
    return jax.tree.map(np.asarray, ref_init_params(cfg,
                                                    jax.random.PRNGKey(0)))


def train_batch(arch: str, B: int = 2, S: int = 16):
    """Tokens from ``default_rng(0)``, next-token labels, a ``loss_mask``
    with zeros, and the frontends' stubbed extras."""
    cfg = ref_config(arch)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[0, 3:7] = 0
    mask[-1, -2:] = 0
    out = {"tokens": tokens, "labels": np.roll(tokens, -1, 1),
           "loss_mask": mask}
    out.update(ref_stub_frontend_inputs(cfg, B, 0))
    return out


def reference_grads(arch: str, params, batch):
    """(loss, metrics, grads) of ``jax.value_and_grad(loss_fn)``."""
    cfg = ref_config(arch)
    (loss, m), g = jax.value_and_grad(
        lambda p: RM.loss_fn(p, {k: jnp.asarray(v) for k, v in
                                 batch.items()}, cfg), has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    return float(loss), {k: float(v) for k, v in m.items()}, \
        jax.tree.map(np.asarray, g)


def serve_inputs(arch: str, B: int = 2, S: int = 16):
    """A prompt batch, the frontends' extras, and the tokens fed to each
    decode step."""
    cfg = ref_config(arch)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    steps = [rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
             for _ in range(DECODE_STEPS)]
    return tokens, ref_stub_frontend_inputs(cfg, B, 0), steps


def reference_serve(arch: str, params, tokens, extras, steps):
    """The reference's prefill logits and each decode step's logits."""
    cfg = ref_config(arch)
    p = jax.tree.map(jnp.asarray, params)
    logits, cache = RM.prefill(p, {"tokens": jnp.asarray(tokens),
                                   **{k: jnp.asarray(v) for k, v in
                                      extras.items()}}, cfg, s_max=S_MAX)
    out = {"prefill": np.asarray(logits), "decode": []}
    for t in steps:
        logits, cache = RM.decode_step(p, jnp.asarray(t), cache, cfg)
        out["decode"].append(np.asarray(logits))
    return out
