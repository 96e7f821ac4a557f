"""The program's own ranges in a device trace.

Under ``torch.profiler`` the port's training path opens host ranges named
``repro.*`` (``repro_torch.obs.ranges``): the driver's batch, the step, each
slot, the forward, the backward, the accumulation, the reduction, the
optimizer, and the model's attention, MoE (its routing and its experts),
dense MLP and head, each model range with a ``.bwd`` twin that the autograd
engine's thread opens.  :func:`attribute` puts each device operation of a
traced segment down to the ranges open on the host, on any thread, when it
was launched (the CUDA runtime call that shares its correlation id), and each
idle gap of the card to the innermost range open at its midpoint.  Its keys
extend the summary of ``harness.trace.summarize``; that function's keys are
computed there alone, and the ranges' device-side twins are no operations.
"""

from __future__ import annotations

import bisect
import collections

import torch

from harness import trace

PREFIX = "repro."

# the readers of the program's ranges, (metric, unit); see bench/metrics/<name>.py
METRICS = (("attn_ms.train", "ms"), ("moe_ms.train", "ms"), ("optimizer_ms.train", "ms"),
           ("launches_per_slot.train", "count"))


def _is_device(e) -> bool:
    return e.device_type() == torch.autograd.DeviceType.CUDA


def _open_at(ranges, times):
    """For each time, the ranges open then, outermost first (ranges nest on
    each thread; across threads the later-started is the inner one).  A
    range holds its own start and end."""
    marks = []
    for k, (s, e, _) in enumerate(ranges):
        marks.append((s, 0, k))
        marks.append((e, 2, k))
    for i, t in enumerate(times):
        marks.append((t, 1, i))
    marks.sort()
    open_, out = [], [()] * len(times)
    for _, what, k in marks:
        if what == 0:
            open_.append(k)
        elif what == 2:
            open_.remove(k)
        else:
            out[k] = tuple(ranges[j][2] for j in open_)
    return out


def attribute(events, seg: tuple[int, int]) -> dict:
    """``program_s`` (device seconds by the innermost ``repro.*`` range open at
    each operation's launch), ``program_ops`` (operations, the same rule),
    ``program_incl_ops`` (operations under every range open at their
    launch), ``program_calls`` (host ranges by name, started in ``seg``) and
    ``program_gaps`` (idle seconds of ``seg`` by the innermost range open at
    each gap's midpoint, else by the harness's span, as ``idle_gaps``)."""
    dev, launch, ranges, spans = [], {}, [], []
    for e in events:
        name = e.name()
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if _is_device(e):
            if not (name.startswith("bench.") or name.startswith(PREFIX) or e.is_user_annotation()):
                dev.append((start, end, e.correlation_id()))
        elif name.startswith(PREFIX) and e.is_user_annotation():
            ranges.append((start, end, name))
        elif name.startswith("bench.span.") and name != "bench.span.traced":
            spans.append((start, end, name[len("bench.span."):]))
        elif name.startswith("cu") and not e.is_user_annotation():  # a CUDA runtime or driver call
            launch[e.correlation_id()] = start
    ranges.sort()
    ops = [(launch[c], e - s) for s, e, c in dev if c in launch]
    held = _open_at(ranges, [t for t, _ in ops])
    program_ns, n_ops, n_incl = collections.Counter(), collections.Counter(), collections.Counter()
    for (_, ns), names in zip(ops, held):
        if names:
            program_ns[names[-1]] += ns
            n_ops[names[-1]] += 1
            n_incl.update(set(names))
    _, merged = trace._union([(max(s, seg[0]), min(e, seg[1])) for s, e, _ in dev if e > seg[0] and s < seg[1]])
    gaps, cursor = [], seg[0]
    for s, e in merged + [[seg[1], seg[1]]]:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    spans.sort(key=lambda r: (r[0], -r[1]))
    span_starts = [r[0] for r in spans]
    idle = collections.Counter()
    for (a, b), names in zip(gaps, _open_at(ranges, [(a + b) / 2 for a, b in gaps])):
        idle[names[-1] if names else trace._owner(spans, span_starts, (a + b) / 2)] += b - a
    starts = [r[0] for r in ranges]
    lo, hi = bisect.bisect_left(starts, seg[0]), bisect.bisect_right(starts, seg[1])
    return {
        "program_s": {k: v / 1e9 for k, v in program_ns.items()},
        "program_ops": dict(n_ops),
        "program_incl_ops": dict(n_incl),
        "program_calls": dict(collections.Counter(r[2] for r in ranges[lo:hi])),
        "program_gaps": {k: v / 1e9 for k, v in idle.most_common()},
    }


def summarize_program(prof) -> dict:
    """:func:`attribute` over a finished profile of ``harness.trace.traced``."""
    events = prof.profiler.kineto_results.events()
    seg = next(((e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                if e.name() == "bench.span.traced" and not _is_device(e)), None)
    if seg is None:
        raise RuntimeError("the traced segment's range is missing from the profile")
    return attribute(events, seg)
