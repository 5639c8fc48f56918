"""Device meshes over the ranks of a process group.

Counterpart of ``repro.launch.mesh``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose axes are named as the
reference's (``("data", "model")``, or ``("pod", "data", "model")`` for
the multi-pod production shape).  Importing this module touches neither a
device nor a process group.

:func:`axis_sizes`, :func:`dp_axes` and :func:`dp_size` also read a
shape-only mesh (an object with ``axis_names`` and ``devices.shape``, as
the reference's tests build), so the sharding rules are pure functions of
a mesh's shape.

The dry-run's meshes (:func:`make_production_mesh`, :func:`fake_mesh`)
stand over a fake process group (``torch.testing``'s ``FakeStore`` and the
``fake`` backend): one process plays rank 0 of all the ranks, and its
collectives move nothing.  They are for tensors with no data only
(``launch.dryrun``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

from ..core.engine import resolve_device

# the reference's production meshes: 16 x 16 = 256 chips a pod, 2 pods
PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def fake_process_group(world_size: int) -> None:
    """Rank 0 of a fake process group of ``world_size`` ranks, made where
    none exists (an existing fake group of another size is replaced; any
    other group is an error)."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group exists: the dry-run's "
                               "fake group needs a process of its own")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def fake_mesh(shape: Tuple[int, ...], names: Tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` over a fake process group of as many
    ranks, seen from rank 0."""
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for d in shape:
        n *= d
    fake_process_group(n)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh, 16 x 16 chips a pod or (2, 16, 16)
    over two pods, as a ``DeviceMesh`` over a fake process group of 256
    (or 512) ranks, made where none exists (:func:`fake_mesh`)."""
    return fake_mesh(*PRODUCTION_SHAPES[multi_pod])


def ensure_process_group(device=None) -> None:
    """A process group over the ranks that exist: the caller's (a
    ``torchrun``-style launch or ``init_process_group`` of its own) or,
    where there is none, one rank over an in-process store (``gloo`` on
    the CPU, ``nccl`` on the card)."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(shape: Tuple[int, int], device=None):
    """A ``(data, model)`` mesh of ``shape`` over every rank of the process
    group (made with one rank where there is none), on ``device``'s type:
    ``cuda`` unless the caller asks for the CPU."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    ensure_process_group(dev)
    n = dist.get_world_size()
    if len(shape) != 2 or shape[0] * shape[1] != n:
        raise ValueError(f"mesh {tuple(shape)} over {n} ranks")
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=("data", "model"))


def make_host_mesh(model_parallel: int = 1, device=None):
    """The reference's host mesh: every rank, ``model_parallel`` of them
    on the ``model`` axis and the rest on ``data``.  With no process
    group it is the one-rank mesh (1, 1)."""
    ensure_process_group(device)
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"{n} ranks are no multiple of model_parallel "
                         f"{model_parallel}")
    return make_mesh((n // model_parallel, model_parallel), device)


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, of a ``DeviceMesh`` or a shape-only mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))


def dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    out = 1
    for a in dp_axes(mesh):
        out *= sizes[a]
    return out
