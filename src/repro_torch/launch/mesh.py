"""Process groups and meshes of the multi-process step.

The port of ``repro.launch.mesh``'s ``make_test_mesh``: a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
group, with one process group per named axis (``mesh.get_group("data")``).
The collectives of ``dist.collectives`` take those groups
(``collectives.axis_groups``).

The backend follows the device: ``nccl`` for ``cuda`` and ``gloo`` for
``cpu``.  NCCL puts one rank on a card, so several ranks on one card need
``backend="gloo"``, which the caller asks for by name; the collectives then
stage CUDA tensors through pinned host memory.

The reference's TPU constants (``HW``) and its 256-chip production mesh
(``make_production_mesh``) have no counterpart here.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["default_backend", "join_process_group", "make_test_mesh"]


def default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def join_process_group(
    device_type: str,
    backend: str | None = None,
    init_method: str = "env://",
    rank: int | None = None,
    world_size: int | None = None,
) -> torch.device:
    """Join the default group as ``torchrun`` describes it (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` in the environment,
    or ``rank``/``world_size`` given) and return this rank's device: rank r
    on ``cuda`` takes ``cuda:{LOCAL_RANK % device_count}``.  ``init_method``
    is ``init_process_group``'s (``env://``, ``file://...``, ``tcp://...``)."""
    backend = backend or default_backend(device_type)
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    device = torch.device("cpu")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch sees no CUDA card; pass --device cpu")
        cards = torch.cuda.device_count()
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        if backend == "nccl" and local_world > cards:
            raise ValueError(
                f"{local_world} ranks on {cards} card(s): NCCL puts one rank on a card and refuses two "
                "on one (duplicate GPU). Run several ranks on one card with --dist-backend gloo "
                "(the ring's buffers then go through pinned host memory)."
            )
        device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)
    return device


def make_test_mesh(shape=(4, 2), axes=("data", "model"), device_type: str = "cpu") -> DeviceMesh:
    """A mesh of ``shape`` over the first ``prod(shape)`` ranks of the default
    group (``init_device_mesh`` when it covers every rank).  Every rank of the
    default group must call this, in the same order: building the axis
    groups is collective.  A rank past the mesh belongs to none of them."""
    n = math.prod(shape)
    if n > dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {n} ranks; the group has {dist.get_world_size()}")
    if n == dist.get_world_size():
        return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)), mesh_dim_names=tuple(axes))

