"""Per-rank collective traces: each rank's step run in turn under a recording fake process group.

The counterpart of ``repro.analysis.jaxpr_walk``.  The reference walks a
jaxpr statically; the port's step runs eagerly and branches on host
integers (the allocation, the trip counts), so its collectives are recorded
instead.  :func:`trace_ranks` runs a body once per rank of a mesh, in this
process, each time under torch's fake process group
(``torch.testing._internal.distributed.fake_pg``, which gives every rank
its groups and moves nothing) with a ``DeviceMesh`` of the given shape, and
records, in place of making them, the ``torch.distributed`` calls the
port's collectives make
(``dist.collectives``: ``all_reduce``, ``broadcast``, the ring's
neighbour exchanges, the FSDP gathers and reduce-scatters).  A record holds
the op, the mesh axis of its group, the tensor's shape, dtype and bytes, and
the source line that called into ``dist.collectives`` (where an
``# analysis: ignore[rule]`` pragma waives a finding).

Run it on meta tensors: the step then computes nothing either.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import sys
from collections.abc import Callable, Iterator
from unittest import mock

import torch
import torch.distributed as dist

from repro_torch.analysis.findings import src_of

__all__ = ["Record", "recording", "trace_ranks"]

_TORCH_DIR = os.path.dirname(torch.__file__)
_SKIP_FILES = {os.path.abspath(__file__)}


@dataclasses.dataclass(frozen=True)
class Record:
    """One collective call as one rank made it."""

    op: str  # all_reduce | broadcast | all_gather | reduce_scatter | sendrecv
    axis: str  # the mesh axis of its group ("world" for the default group)
    shape: tuple
    dtype: str
    nbytes: int
    src: str  # "file.py:123" of the call into dist.collectives

    def key(self) -> tuple:
        return (self.op, self.axis, self.shape, self.dtype)


def _caller_src() -> str:
    """The first frame outside torch, this module and ``dist/collectives.py``."""
    import repro_torch.dist.collectives as coll

    skip = _SKIP_FILES | {os.path.abspath(coll.__file__)}
    frame = sys._getframe(2)
    while frame is not None:
        fname = os.path.abspath(frame.f_code.co_filename)
        if fname not in skip and not fname.startswith(_TORCH_DIR) and "contextlib" not in fname:
            return src_of(frame.f_code.co_filename, frame.f_lineno)
        frame = frame.f_back
    return ""


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).split(".")[-1]


@contextlib.contextmanager
def recording(axis_of: dict[int, str]) -> Iterator[list[Record]]:
    """Record every collective call made inside the block, in place of making
    it (as the fake process group would: nothing moves); ``axis_of`` maps
    ``id(group)`` to its mesh axis."""
    records: list[Record] = []

    def axis(group) -> str:
        return "world" if group is None else axis_of.get(id(group), "unknown")

    def add(op, t, group, nbytes=None):
        records.append(Record(op, axis(group), tuple(t.shape), _dtype(t),
                              t.numel() * t.element_size() if nbytes is None else nbytes, _caller_src()))

    def all_reduce(tensor, op=None, group=None, async_op=False):
        add("all_reduce", tensor, group)

    def broadcast(tensor, src=None, group=None, async_op=False, **kw):
        add("broadcast", tensor, group)

    def all_gather(tensor_list, tensor, group=None, async_op=False):
        add("all_gather", tensor, group)

    def reduce_scatter(output, input_list, op=None, group=None, async_op=False):
        add("reduce_scatter", output, group, sum(t.numel() * t.element_size() for t in input_list))

    def batch_isend_irecv(p2p_op_list):
        send = next((p for p in p2p_op_list if p.op is dist.isend), p2p_op_list[0])
        add("sendrecv", send.tensor, send.group)
        return []

    with contextlib.ExitStack() as stack:
        for name, fn in (("all_reduce", all_reduce), ("broadcast", broadcast), ("all_gather", all_gather),
                         ("reduce_scatter", reduce_scatter), ("batch_isend_irecv", batch_isend_irecv)):
            stack.enter_context(mock.patch.object(dist, name, fn))
        yield records


def trace_ranks(body: Callable, shape: tuple, axes: tuple, ranks=None) -> list[list[Record]]:
    """``body(mesh)`` once per rank (``ranks``, default every rank of the
    mesh), each under a fake process group of ``prod(shape)`` ranks and a
    ``DeviceMesh`` of ``shape`` named ``axes``; returns each rank's records."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.dist.collectives import axis_groups

    if dist.is_initialized():
        raise RuntimeError("trace_ranks needs a process without a process group (it makes a fake one per rank)")
    world = math.prod(shape)
    out = []
    for rank in range(world) if ranks is None else ranks:
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
        try:
            mesh = init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))
            axis_of = {id(g): name for name, g in axis_groups(mesh).items()}
            with recording(axis_of) as records:
                body(mesh)
            out.append(records)
        finally:
            dist.destroy_process_group()
    return out
