"""Known-bad (and known-good) step fixtures for the analyzer's selftest.

The port of ``repro.analysis.fixtures``, as torch steps over a mesh's
"data" group.  ``deadlock_step`` is the canonical member of the bug class
the checker exists for: each rank loops over its own allocation (rank r
runs r + 1 trips) with an ``all_reduce`` INSIDE the loop.  Ranks with small
allocations leave the loop while larger ranks still wait on them: a hang on
real hardware, and exactly what ``HeteroStepConfig.validate`` forbids for
``mode="while"`` with per-microbatch FSDP.

``clean_step`` is the corrected form (the collective after the loop, once
per rank) and must produce no finding.  ``suppressed_step`` is the bad form
with the inline pragma on the offending line, exercising the
``# analysis: ignore[rule]`` waiver path end to end.

Each ``trace_*`` runs its step on every rank of a (4,) "data" mesh under
``recorder.trace_ranks`` and returns the ranks' records.
"""

from __future__ import annotations

import torch

from repro_torch.analysis.recorder import trace_ranks
from repro_torch.dist.collectives import all_reduce

__all__ = ["clean_step", "deadlock_step", "suppressed_step", "trace_clean_step", "trace_deadlock_step",
           "trace_suppressed_step"]


def _inputs(mesh):
    x = torch.zeros((4, 8), dtype=torch.float32, device="meta")
    return x, mesh.get_local_rank("data") + 1, mesh.get_group("data")


def deadlock_step(mesh):
    """all_reduce inside a loop whose trip count differs by rank — must be flagged."""
    acc, trips, group = _inputs(mesh)
    for _ in range(trips):
        acc = acc + all_reduce(acc.clone(), group)  # deadlocks: trips diverge
    return acc


def clean_step(mesh):
    """Same shape of program, the collective hoisted out — must pass."""
    x, trips, group = _inputs(mesh)
    acc = x
    for _ in range(trips):
        acc = acc * 0.5 + x
    return all_reduce(acc, group)  # uniform: once per rank, after


def suppressed_step(mesh):
    """The deadlock form, waived by an inline pragma on the collective's line."""
    acc, trips, group = _inputs(mesh)
    for _ in range(trips):
        acc = acc + all_reduce(acc.clone(), group)  # analysis: ignore[divergent-collective]
    return acc


def _trace(step, n: int = 4):
    return trace_ranks(step, (n,), ("data",))


def trace_deadlock_step(n: int = 4):
    return _trace(deadlock_step, n)


def trace_clean_step(n: int = 4):
    return _trace(clean_step, n)


def trace_suppressed_step(n: int = 4):
    return _trace(suppressed_step, n)
