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

``HW`` holds the roofline constants of the card the port runs on, an H100
SXM (the reference's are a TPU v5e's).  ``make_production_mesh`` returns the
reference's production meshes, 16 x 16 ("data", "model") and 2 x 16 x 16
("pod", "data", "model"), as a :class:`StandinMesh`: their names and sizes,
which is all the launch plan (``launch.specs``) and the spec audit read.  The
machine has one card, so no such mesh is ever built of processes.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["HW", "StandinMesh", "default_backend", "join_process_group", "make_production_mesh", "make_test_mesh"]


class HW:
    """H100 SXM roofline constants (per card): the dense peaks, HBM's rate and
    size, and NVLink's rate (the counterpart of the reference's ICI link)."""

    PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense
    PEAK_FLOPS_F32 = 67e12  # FLOP/s, CUDA cores
    HBM_BW = 3.35e12  # bytes/s
    HBM_BYTES = 80e9  # capacity
    NVLINK_BW = 900e9  # bytes/s per card, all links


@dataclasses.dataclass(frozen=True)
class StandinMesh:
    """A mesh's axis names and sizes, without processes: ``shape`` is
    ``{axis: size}`` and ``axis_names`` the axes in order, the two attributes
    the spec assigners and ``launch.specs.train_partition`` read."""

    axes: tuple  # ((axis, size), ...)

    @property
    def shape(self) -> dict:
        return dict(self.axes)

    @property
    def axis_names(self) -> tuple:
        return tuple(a for a, _ in self.axes)

    @property
    def size(self) -> int:
        return math.prod(s for _, s in self.axes)


def make_production_mesh(*, multi_pod: bool = False) -> StandinMesh:
    """The reference's production mesh: (16, 16) = ("data", "model"), or
    (2, 16, 16) = ("pod", "data", "model") across two pods."""
    if multi_pod:
        return StandinMesh((("pod", 2), ("data", 16), ("model", 16)))
    return StandinMesh((("data", 16), ("model", 16)))


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

