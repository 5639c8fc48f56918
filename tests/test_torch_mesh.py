"""The port on a device mesh of four gloo ranks on the CPU, (2, 2), against
the reference's meshless results: every family's loss and gradients, its
prefill and decode logits, the serving engine over AutumnKV on rank 0, and
the trainer's crash and bit-exact resume on the mesh with a restore onto
another mesh (ROADMAP A16a).

One spawn of the ranks runs every case (``_torch_mesh_worker.py``, torch
only); the bars are ``test_torch_sharding.py``'s: float32 loss, metrics
and gradients within 1e-4 of max(1, |reference|), logits within 1e-4 with
equal greedy tokens.  The four configurations named there decode eight
steps; the other six take one step and one decode.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import _torch_mesh as TM  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from test_torch_sharding import (NAMED, check_grads, check_serve,  # noqa: E402,E501
                                 grads_task, serve_task)

MESH = (2, 2)
ENGINE_ARCHS = ("qwen3_4b", "gemma3_1b")      # TP heads; kv_seq pages
TRAINER_MESHES = ((2, 2), (1, 4))
TRAINER_STEPS = 6
GRAD_CLIP = 0.05    # below every step's gradient norm: every step clips


def steps_of(arch):
    return TM.DECODE_STEPS if arch in NAMED else 1


@pytest.fixture(scope="module")
def mesh_2x2():
    tasks = [t for a in ARCH_IDS for t in (
        grads_task(a, MESH), serve_task(a, MESH, steps_of(a)))]
    tokens, extras, fed = TM.serve_inputs("gemma3_1b", B=1)
    tasks.append(dict(name="serve batch 1", kind="serve", arch="gemma3_1b",
                      mesh=MESH, params=TM.reference_params("gemma3_1b"),
                      tokens=tokens, extras=extras, steps=fed,
                      s_max=TM.S_MAX))
    rng = np.random.default_rng(0)
    for a in ENGINE_ARCHS:
        prompt = rng.integers(0, 128, 64).astype(np.int32)
        tasks.append(dict(name=f"engine {a}", kind="engine", arch=a,
                          mesh=MESH, params=TM.reference_params(a),
                          prompts=[prompt, prompt[::-1].copy()], s_max=96))
    tasks.append(dict(name="trainer", kind="trainer", arch="smollm_135m",
                      mesh=MESH, restore_mesh=(1, 4)))
    tasks.append(dict(name="trainer steps", kind="trainer_steps",
                      arch="smollm_135m", meshes=TRAINER_MESHES,
                      steps=TRAINER_STEPS, grad_clip=GRAD_CLIP))
    tasks.append(dict(name="cli", kind="cli", argv=[
        "--smoke", "--steps", "12", "--batch", "4", "--seq", "16",
        "--checkpoint-every", "4", "--inject-failure", "7", "--mesh", "2x2",
        "--device", "cpu"]))
    return TM.run_ranks(4, tasks, timeout=900)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_on_mesh_2x2_equal_the_reference(mesh_2x2, arch):
    check_grads(arch, mesh_2x2[f"grads {arch}"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_decode_on_mesh_2x2_equal_the_reference(mesh_2x2, arch):
    check_serve(arch, mesh_2x2[f"serve {arch}"], steps_of(arch))


def test_batch_of_one_decodes_over_both_axes(mesh_2x2):
    """gemma3_1b at batch 1 (the reference's rule for long_500k): the batch
    cannot use the data axis, so the cache's sequence splits over
    ("data", "model") and the merge all-reduces over both."""
    tokens, extras, fed = TM.serve_inputs("gemma3_1b", B=1)
    want = TM.reference_serve("gemma3_1b", TM.reference_params("gemma3_1b"),
                              tokens, extras, fed)
    got = mesh_2x2["serve batch 1"]
    for a, b in zip([got["prefill"]] + got["decode"],
                    [want["prefill"]] + want["decode"]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_engine_on_mesh_serves_the_meshless_tokens(mesh_2x2, arch):
    """A cold and a warm wave through ``ServeEngine(shard=...)`` with
    AutumnKV on rank 0: the tokens of the engine with no mesh (held to the
    reference's engine by test_torch_serve.py), and both warm rows hit."""
    got = mesh_2x2[f"engine {arch}"]
    for a, b in zip(got["mesh"]["tokens"], got["none"]["tokens"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got["mesh"]["tokens"][0],
                                  got["mesh"]["tokens"][1])
    assert got["mesh"]["hits"] == got["none"]["hits"] == 2


def test_trainer_on_mesh_resumes_bit_exact(mesh_2x2):
    """The reference test's run (smollm_135m SMOKE, seq 32, batch 4, a
    checkpoint every 5 steps) on (2, 2): train(20) against train(12) +
    crash + restore at step 10 + the rest, every parameter and AdamW leaf
    by bits."""
    got = mesh_2x2["trainer"]
    assert (got["failed_at"], got["resumed"]) == (12, 10)
    assert got["differ"] == []


@pytest.mark.parametrize("mesh", TRAINER_MESHES, ids=str)
def test_trainer_on_mesh_matches_the_meshless_trainer(mesh_2x2, mesh):
    """``Trainer(mesh=...)`` against the meshless ``Trainer`` (its step
    and its data held to the reference by test_torch_train_step.py and
    test_torch_train_data.py) from one seed and one
    ``DataConfig``, float32, six steps that each clip: each step's loss
    and gradient norm (``global_norm``'s all-reduce), then every parameter
    and AdamW leaf, within 1e-4 of max(1, |meshless|).  The ranks' rows
    tile the global batch, each data rank its own."""
    got = mesh_2x2["trainer steps"]
    want, run = got[None], got[mesh]
    spans = sorted(set(run["rows"]))
    assert len(spans) == mesh[0]
    assert [lo for lo, _ in spans] == [0] + [hi for _, hi in spans[:-1]]
    assert spans[-1][1] == 4
    assert len(run["hist"]) == TRAINER_STEPS
    for (loss, norm), (loss0, norm0) in zip(run["hist"], want["hist"]):
        assert norm0 > GRAD_CLIP
        assert abs(loss - loss0) <= 1e-4 * max(1.0, abs(loss0))
        assert abs(norm - norm0) <= 1e-4 * max(1.0, abs(norm0))
    for (path, a), (_, b) in zip(tree_leaves(run["state"]),
                                 tree_leaves(want["state"])):
        scale = max(1.0, float(np.max(np.abs(b))))
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * scale,
                                   err_msg=path)


def test_restore_places_every_leaf_by_the_new_meshs_rules(mesh_2x2):
    """The step-20 checkpoint written on (2, 2), restored onto (1, 4):
    every parameter placed by (1, 4)'s rules, ``m`` and ``v`` as their
    parameter, and every value equal to the writer's."""
    got = mesh_2x2["trainer"]
    assert got["restored_at"] == 20
    assert got["misplaced"] == []
    assert got["restore_differ"] == []


def test_unreadable_checkpoint_keeps_the_fresh_state_on_every_rank(mesh_2x2):
    """A restore on (1, 4) whose checkpoint rank 0 cannot read: every rank
    goes on from step 0 with the seed's fresh state, by bits, as the
    meshless trainer and the reference do (no rank left in a broadcast)."""
    got = mesh_2x2["trainer"]
    assert got["unreadable_at"] == 0
    assert got["unreadable_differ"] == []


def test_command_line_trains_on_a_mesh(mesh_2x2):
    """``python -m repro_torch.launch.train --mesh 2x2`` on the four ranks:
    an injected failure at step 7, restored at step 4, the loss falling."""
    out = mesh_2x2["cli"]
    assert "simulated host failure at step 7" in out
    assert "restored at step 4; resuming" in out
    assert "step    12 loss" in out
