"""One rank of the port's multi-rank mesh checks: a gloo process on the
CPU that imports torch and ``repro_torch`` only.

  python tests/_torch_mesh_worker.py RANK WORLD PORT DIR

reads ``DIR/inputs.pkl`` (a list of tasks), runs each task on every rank
and, on rank 0, writes ``DIR/outputs.pkl`` ({task name: result}); a rank
that fails writes its traceback to ``DIR/error_RANK.txt``.  Every result
is numpy: the parameters come in as the reference's numpy trees, and what
goes back is gathered to full tensors (``tests/_torch_mesh.py`` holds it
against the JAX reference).
"""
import dataclasses
import os
import pickle
import sys
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.sharding import (Sharder,  # noqa: E402
                                         make_rules, placements,
                                         place_tree, spec_for,
                                         tree_shardings)
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import train as T  # noqa: E402
from repro_torch.models.layers import identity_shard  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        params_to_numpy)
from repro_torch.models.params import logical_specs, tree_leaves  # noqa: E402,E501

_MESHES = {}


def mesh_of(shape):
    """The (data, model) mesh over every rank (``make_host_mesh``)."""
    shape = tuple(shape)
    if shape not in _MESHES:
        _MESHES[shape] = make_host_mesh(shape[1], "cpu")
        assert tuple(_MESHES[shape].shape) == shape
    return _MESHES[shape]


def config(task):
    return dataclasses.replace(get_smoke(task["arch"]),
                               compute_dtype="float32",
                               **task.get("edit", {}))


def numpy_tree(tree):
    """Full numpy arrays of a tree placed on a mesh (or not)."""
    return params_to_numpy(tree)


def rows_of(sharder, batch, n):
    lo, hi = sharder.span("batch", n)
    return {k: torch.from_numpy(np.ascontiguousarray(v[lo:hi]))
            for k, v in batch.items()}


def task_grads(task):
    """loss, metrics and every gradient of ``T.value_and_grad`` on the
    mesh (or with no mesh), full."""
    cfg = config(task)
    params = params_from_numpy(task["params"], cfg, device="cpu")
    batch = task["batch"]
    B, S = batch["tokens"].shape
    if task["mesh"] is None:
        sharder, placed = identity_shard, params
        local = {k: torch.from_numpy(v) for k, v in batch.items()}
    else:
        mesh = mesh_of(task["mesh"])
        prules, arules = make_rules(cfg, mesh, "train", B, S)
        sharder = Sharder(mesh, arules)
        placed = place_tree(params, logical_specs(cfg), mesh, prules)
        local = rows_of(sharder, batch, B)
    (loss, metrics), grads = T.value_and_grad(placed, local, cfg, sharder)
    return {"loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": numpy_tree(grads)}


def task_serve(task):
    """Prefill logits and the logits of each decode step (the tokens fed
    are the task's), through ``Model`` on the mesh's decode rules."""
    cfg = config(task)
    params = params_from_numpy(task["params"], cfg, device="cpu")
    tokens = torch.from_numpy(task["tokens"])
    B = tokens.shape[0]
    if task["mesh"] is None:
        model = Model(cfg, params)
    else:
        mesh = mesh_of(task["mesh"])
        _, arules = make_rules(cfg, mesh, "decode", B, task["s_max"])
        model = Model(cfg, params, Sharder(mesh, arules))
    extras = {k: torch.from_numpy(v) for k, v in task["extras"].items()}
    logits, cache = model.prefill(tokens, task["s_max"], extras)
    out = {"prefill": logits.numpy().copy(), "decode": []}
    for t in task["steps"]:
        logits, cache = model.decode_step(torch.from_numpy(t), cache)
        out["decode"].append(logits.numpy().copy())
    return out


def task_engine(task):
    """A cold and a warm wave through ``ServeEngine`` over AutumnKV (on
    rank 0), on the mesh's decode rules and with no mesh: tokens and the
    warm wave's hits."""
    from repro_torch.serve import Request, ServeEngine
    cfg = config(task)
    params = params_from_numpy(task["params"], cfg, device="cpu")
    prompts = list(task["prompts"])
    B = len(prompts)
    _, arules = make_rules(cfg, mesh_of(task["mesh"]), "decode", B,
                           task["s_max"])
    out = {}
    for name, shard in (("mesh", Sharder(mesh_of(task["mesh"]), arules)),
                        ("none", identity_shard)):
        eng = ServeEngine(cfg, params, batch=B, s_max=task["s_max"],
                          device="cpu", shard=shard)
        waves = [np.stack(eng.serve_batch([Request(p, 8) for p in prompts]))
                 for _ in range(2)]
        out[name] = {"tokens": waves, "hits": eng.metrics["cache_hits"]}
        eng.close()
    return out


def task_trainer(task):
    """The reference test's crash-and-resume run on a mesh, against an
    uninterrupted one, then a restore of its last checkpoint onto another
    mesh, and one that rank 0 cannot read."""
    from repro_torch.checkpoint import AsyncCheckpointer
    from repro_torch.data import DataConfig
    from repro_torch.launch.train import SimulatedHostFailure, Trainer
    from repro_torch.train import OptConfig
    cfg = get_smoke(task["arch"])
    opt = OptConfig(peak_lr=1e-3, warmup_steps=2, total_steps=20,
                    schedule="wsd")
    data = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    rank0 = dist.get_rank() == 0

    def mk(shape, store=None):
        return Trainer(cfg, opt, data, store=store, checkpoint_every=5,
                       mesh=mesh_of(shape), device="cpu")

    tr1 = mk(task["mesh"])
    tr1.init(0, try_restore=False)
    tr1.run(20, log_every=100)
    tr2 = mk(task["mesh"])
    tr2.init(0, try_restore=False)
    failed_at = None
    try:
        tr2.run(20, inject_failure_at=12, log_every=100)
    except SimulatedHostFailure as e:
        failed_at = e.step
    tr2.simulate_crash()
    resumed = tr2.init(0, try_restore=True)
    if rank0:
        tr2.ckpt = AsyncCheckpointer(tr2.store)
    tr2.run(20, log_every=100)
    full1 = numpy_tree({"params": tr1.params, "opt": tr1.opt_state})
    full2 = numpy_tree({"params": tr2.params, "opt": tr2.opt_state})
    differ = [p for (p, a), (_, b) in zip(tree_leaves(full1),
                                          tree_leaves(full2))
              if a.dtype != b.dtype or a.tobytes() != b.tobytes()]
    # the last checkpoint (step 20) restored onto another mesh
    tr3 = mk(task["restore_mesh"], store=tr2.store if rank0 else None)
    restored_at = tr3.init(0, try_restore=True)
    rules = tr3.param_rules
    misplaced = []
    for (path, leaf), (_, lg) in zip(
            tree_leaves(tr3.params),
            tree_leaves(logical_specs(cfg),
                        is_leaf=lambda x: isinstance(x, tuple))):
        want = placements(spec_for(lg, rules), tr3.mesh)
        if list(leaf.placements) != want:
            misplaced.append(path)
    for name in ("m", "v"):
        for (path, leaf), (_, p) in zip(tree_leaves(tr3.opt_state[name]),
                                        tree_leaves(tr3.params)):
            if list(leaf.placements) != list(p.placements):
                misplaced.append(f"{name}{path}")
    full3 = numpy_tree({"params": tr3.params, "opt": tr3.opt_state})
    differ3 = [p for (p, a), (_, b) in zip(tree_leaves(full2),
                                           tree_leaves(full3))
               if a.tobytes() != b.tobytes()]
    # a checkpoint that rank 0 cannot read: every rank keeps the fresh
    # state together (as the reference does), none waits on a broadcast
    tr4 = mk(task["restore_mesh"], store=tr2.store if rank0 else None)
    if rank0:
        tr4.store.restore_tree = lambda step, like: None
    unreadable_at = tr4.init(0, try_restore=True)
    fresh = mk(task["restore_mesh"])
    fresh.init(0, try_restore=False)
    full4, full5 = (numpy_tree({"params": t.params, "opt": t.opt_state})
                    for t in (tr4, fresh))
    differ4 = [p for (p, a), (_, b) in zip(tree_leaves(full4),
                                           tree_leaves(full5))
               if a.tobytes() != b.tobytes()]
    return {"failed_at": failed_at, "resumed": resumed,
            "differ": differ, "restored_at": restored_at,
            "misplaced": misplaced, "restore_differ": differ3,
            "unreadable_at": unreadable_at, "unreadable_differ": differ4}


def task_trainer_steps(task):
    """``Trainer`` steps from one seed and one ``DataConfig`` with no mesh
    and on each of the task's meshes: each step's loss and gradient norm,
    the final parameters and AdamW state (full), and every rank's rows of
    the global batch."""
    from repro_torch.data import DataConfig
    from repro_torch.launch.train import Trainer
    from repro_torch.train import OptConfig
    cfg = config(task)
    opt = OptConfig(peak_lr=1e-3, warmup_steps=2, total_steps=20,
                    schedule="wsd", grad_clip=task["grad_clip"])
    data = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    out = {}
    for shape in [None] + [tuple(m) for m in task["meshes"]]:
        tr = Trainer(cfg, opt, data, mesh=shape and mesh_of(shape),
                     device="cpu")
        tr.init(0, try_restore=False)
        hist = []
        for _ in range(task["steps"]):
            m = tr.train_step(tr.batch_for(tr.step))
            tr.step += 1
            hist.append((float(m["loss"]), float(m["grad_norm"])))
        rows = [None] * dist.get_world_size()
        dist.all_gather_object(rows, tr.rows)
        out[shape] = {"hist": hist, "rows": rows, "state": numpy_tree(
            {"params": tr.params, "opt": tr.opt_state})}
    return out


def task_one_rank(task):
    """Mesh (1, 1) against no mesh: the gradients, a full train step and
    the served logits, each pair by bits."""
    from repro_torch.train import OptConfig, init_opt_state, \
        make_train_step
    cfg = config(task)
    params = params_from_numpy(task["params"], cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in task["batch"].items()}
    B, S = batch["tokens"].shape
    mesh = mesh_of((1, 1))
    prules, arules = make_rules(cfg, mesh, "train", B, S)
    sharder = Sharder(mesh, arules)
    placed = place_tree(params, logical_specs(cfg), mesh, prules)
    shardings = [x for _, x in tree_leaves(
        tree_shardings(logical_specs(cfg), mesh, prules),
        is_leaf=lambda x: isinstance(x, list) and all(
            hasattr(pl, "is_shard") for pl in x))]
    differ = [p for (p, t), want in zip(tree_leaves(placed), shardings)
              if list(t.placements) != want]
    opt = OptConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    step0 = make_train_step(cfg, opt)
    step1 = make_train_step(cfg, opt, shard=sharder)
    p0, s0 = params, init_opt_state(params)
    p1 = placed
    s1 = {k: v if k == "step" else place_tree(v, logical_specs(cfg), mesh,
                                              prules)
          for k, v in init_opt_state(params).items()}
    for _ in range(2):
        p0, s0, m0 = step0(p0, s0, batch)
        p1, s1, m1 = step1(p1, s1, batch)
    differ += [k for k in m0 if not torch.equal(m0[k], m1[k])]
    a, b = numpy_tree({"p": p0, "s": s0}), numpy_tree({"p": p1, "s": s1})
    differ += [p for (p, x), (_, y) in zip(tree_leaves(a), tree_leaves(b))
               if x.tobytes() != y.tobytes()]
    _, drules = make_rules(cfg, mesh, "decode", B, task["s_max"])
    served = []
    for model in (Model(cfg, params), Model(cfg, params,
                                            Sharder(mesh, drules))):
        logits, cache = model.prefill(batch["tokens"], task["s_max"], {
            k: v for k, v in batch.items() if k in ("enc_frames",
                                                     "img_embeds")})
        outs = [logits]
        for t in task["steps"]:
            logits, cache = model.decode_step(torch.from_numpy(t), cache)
            outs.append(logits)
        served.append(torch.stack(outs))
    if not torch.equal(served[0], served[1]):
        differ.append("served logits")
    return {"differ": differ}


def task_cli(task):
    """``launch.train.main`` on the ranks; its standard output."""
    import contextlib
    import io
    from repro_torch.launch.train import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(task["argv"])
    return buf.getvalue()


TASKS = {"cli": task_cli, "grads": task_grads, "serve": task_serve,
         "trainer": task_trainer, "trainer_steps": task_trainer_steps,
         "one_rank": task_one_rank, "engine": task_engine}


def main():
    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], Path(sys.argv[4]))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        tasks = pickle.loads((out / "inputs.pkl").read_bytes())
        results = {t["name"]: TASKS[t["kind"]](t) for t in tasks}
        if rank == 0:
            (out / "outputs.pkl").write_bytes(pickle.dumps(results))
    except Exception:
        # a rank that fails leaves the others blocked in a collective: its
        # traceback goes to the launcher, and the process ends at once
        (out / f"error_{rank}.txt").write_text(traceback.format_exc())
        os._exit(1)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
