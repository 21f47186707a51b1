"""Device meshes over ``torch.distributed`` process groups.

The port of ``odigos_tpu/parallel/mesh.py``. The reference is
single-controller: one process holds a ``jax.sharding.Mesh`` over every
device and XLA places the shards. The port is multi-process and SPMD: one
rank per device under ``torch.distributed``, every rank runs the same
program on its own shard, and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks, whose axes
carry one process group each. The axis names are the reference's:

    data  — the batch (trace) dimension: data-parallel scoring and training
    model — tensor parallelism (ROADMAP A8.2: refused until it is ported)
    seq   — sequence parallelism (ring attention over long traces)

:func:`init_group` starts this process's group: NCCL for ``"cuda"``, gloo
for ``"cpu"``. Nothing picks gloo because NCCL or the card is missing:
``"cuda"`` without a card raises, as ``utils.device.resolve_device`` does.
The reference's CPU mesh is n virtual devices in one process
(``ensure_host_devices``); the port's twin is n gloo processes, one a rank,
started by ``parallel.launch.spawn``.
"""

from __future__ import annotations

import math
from datetime import timedelta
from typing import Any, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..utils.device import resolve_device

DEFAULT_AXES = ("data", "model")
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
GROUP_TIMEOUT = timedelta(seconds=300)


def init_group(device: str | torch.device = "cuda", *, rank: int = 0,
               world_size: int = 1,
               store: Optional[dist.Store] = None) -> None:
    """Start this process's default process group for ``device``: NCCL for
    ``"cuda"`` (the rank's card, ``rank % device_count``), gloo for
    ``"cpu"``. A world of 1 needs no rendezvous (an in-process store);
    a larger one takes a ``store`` (``parallel.launch.spawn`` gives each
    rank a ``FileStore``). If a group is already up it must be the
    device's backend, else this raises."""
    backend = BACKENDS[resolve_device(device).type]
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:
            raise ValueError(f"the process group runs {have!r}; {device!r} "
                             f"needs {backend!r}")
        return
    if store is None:
        if world_size != 1:
            raise ValueError(f"a world of {world_size} needs a store "
                             f"(parallel.launch.spawn gives each rank a "
                             f"FileStore)")
        store = dist.HashStore()
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size, timeout=GROUP_TIMEOUT)


def mesh_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def mesh_shape(mesh: DeviceMesh) -> dict[str, int]:
    """``{axis: size}``, the reference's ``Mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The size of ``axis``, 1 where the mesh has no such axis (as the
    reference's ``mesh.shape.get(axis, 1)``)."""
    return int(mesh_shape(mesh).get(axis, 1))


def mesh_key(shape: Any) -> str:
    """Stable label for a mesh shape (``"data4xmodel2"``), the reference's:
    a ``DeviceMesh``, a dict or an ``((axis, size), ...)`` tuple; size-1
    axes are elided, and a mesh of none is ``"single"``."""
    if isinstance(shape, DeviceMesh):
        shape = mesh_shape(shape)
    items = dict(shape).items() if not isinstance(shape, tuple) else shape
    parts = [f"{a}{int(n)}" for a, n in items if int(n) > 1]
    return "x".join(parts) if parts else "single"


def make_mesh(shape: Optional[Mapping[str, int]] = None, *,
              axes: Sequence[str] = DEFAULT_AXES,
              device: str | torch.device = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` over the first ranks of the world, as the
    reference builds a ``Mesh`` over the first devices:

        make_mesh()                          -> every rank on the data axis
        make_mesh({"data": 4, "model": 2})   -> explicit 4x2

    A shape may use a prefix of the ranks (``{"data": 3, "model": 2}`` on
    8: ranks 6 and 7 hold no coordinate); one that needs more raises.
    Every rank of the world must call it (it makes the axes' groups). With
    no group up it starts a world of 1 (:func:`init_group`); ``device``
    defaults to the card and raises without one."""
    dev = resolve_device(device)
    init_group(dev)
    n = dist.get_world_size()
    if shape is None:
        shape = {axes[0]: n, **{a: 1 for a in axes[1:]}}
    shape = dict(shape)
    total = math.prod(shape.values())
    if total > n:
        raise ValueError(f"mesh shape {shape} needs {total} devices, have "
                         f"{n}")
    ranks = torch.arange(total, dtype=torch.int).reshape(
        tuple(shape.values()))
    return DeviceMesh(dev.type, ranks, mesh_dim_names=tuple(shape))
