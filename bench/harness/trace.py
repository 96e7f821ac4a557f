"""Spans, kernel ranges and the reading of the device trace.

The harness marks what it drives with ``torch.profiler.record_function``
ranges from its own files: ``bench.span.<name>`` around the calls into the
program's layers, and ``bench.kernel.<name>`` around each call of the
``repro_torch.kernels.ops`` entry points the cells reach, which
:class:`KernelRanges` wraps while it is open.  A traced segment runs under ``torch.profiler``; its
raw events give each kernel range the device time of the kernels launched
inside it (through the range's device-side twin), the device's busy time, its idle gaps by the span the host was in,
and the operations that took most time.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from harness import costs

def span(name: str):
    """A host span of the harness: a profiler range named ``bench.span.<name>``."""
    return record_function(f"bench.span.{name}")


class KernelRanges:
    """While open, the program's kernel entry points on the measured paths run
    inside ranges named ``bench.kernel.<kernel>``, and each call's operations,
    bytes and peak are kept (frozen counts, ``harness.costs``)."""

    COSTS = {"weighted_accum_tree": ("weighted_accum", costs.weighted_accum_tree_cost),
             "rwkv6_scan": ("rwkv6_scan", costs.rwkv6_scan_cost)}

    def __init__(self) -> None:
        self.calls: dict[str, list] = collections.defaultdict(list)
        self._saved: dict = {}

    def __enter__(self):
        from repro_torch.kernels import ops

        self._ops = ops
        for entry, (name, cost) in self.COSTS.items():
            fn = getattr(ops, entry)
            self._saved[entry] = fn

            def wrapped(*args, _fn=fn, _name=name, _cost=cost, **kwargs):
                with record_function(f"bench.kernel.{_name}"):
                    out = _fn(*args, **kwargs)
                self.calls[_name].append(_cost(*args, **kwargs))
                return out

            setattr(ops, entry, wrapped)
        return self

    def __exit__(self, *exc):
        for entry, fn in self._saved.items():
            setattr(self._ops, entry, fn)
        self._saved.clear()

    def bound_s(self) -> dict[str, float]:
        """The least time of all calls of each kernel on the chip, in seconds."""
        return {name: sum(costs.bound_s(*c) for c in calls) for name, calls in self.calls.items()}


@contextlib.contextmanager
def traced():
    """Profile the body on host and device; yields a dict that gets ``summary``."""
    box = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("bench.span.traced"):
            t0 = time.perf_counter()
            yield box
            torch.cuda.synchronize()
            box["window_s"] = time.perf_counter() - t0
    box["summary"] = summarize(prof, box["window_s"])


def _union(intervals):
    total, end, merged = 0, None, []
    for s, e in sorted(intervals):
        if end is None or s > end:
            merged.append([s, e])
            end = e
        elif e > end:
            merged[-1][1] = e
            end = e
    for s, e in merged:
        total += e - s
    return total, merged


def _owner(spans, starts, t) -> str:
    """The innermost span holding time ``t`` (spans nest, so the latest-starting one)."""
    i = bisect.bisect_right(starts, t) - 1
    for a, b, name in spans[max(0, i - 64):i + 1][::-1]:
        if a <= t <= b:
            return name
    return "host.other"


def summarize(prof, window_s: float) -> dict:
    """Device time per kernel range, busy seconds, idle gaps by host span, top device ops.

    The profiler gives each ``bench.*`` range a device-side twin spanning the
    operations launched inside it; a kernel range's device time is the sum of
    the operations that start within its twins."""
    events = prof.profiler.kineto_results.events()
    dev, twins, spans = [], [], []
    seg = None
    for e in events:
        name = e.name()
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if name.startswith("bench.kernel."):
                twins.append((start, end, name[len("bench.kernel."):]))
            elif not (name.startswith("bench.") or e.is_user_annotation()):
                dev.append((start, end, name))
        elif name == "bench.span.traced":
            seg = (start, end)
        elif name.startswith("bench.span."):
            spans.append((start, end, name[len("bench.span."):]))
    if seg is None:
        raise RuntimeError("the traced segment's range is missing from the profile")
    twins.sort()
    twin_starts = [t[0] for t in twins]
    kernel_ns = collections.Counter()
    for s, e, _ in dev:
        i = bisect.bisect_right(twin_starts, s) - 1
        if i >= 0 and twins[i][0] <= s <= twins[i][1]:
            kernel_ns[twins[i][2]] += e - s
    inside = [(max(s, seg[0]), min(e, seg[1])) for s, e, _ in dev if e > seg[0] and s < seg[1]]
    busy_ns, merged = _union(inside)
    gaps = collections.Counter()
    spans.sort(key=lambda r: (r[0], -r[1]))
    span_starts = [r[0] for r in spans]
    cursor = seg[0]
    for s, e in merged + [[seg[1], seg[1]]]:
        if s > cursor:
            gaps[_owner(spans, span_starts, (cursor + s) / 2)] += s - cursor
        cursor = max(cursor, e)
    ops = collections.Counter()
    for s, e, name in dev:
        ops[name[:64]] += e - s
    return {
        "kernel_s": {k: v / 1e9 for k, v in kernel_ns.items()},
        "kernel_calls": dict(collections.Counter(t[2] for t in twins)),
        "busy_s": busy_ns / 1e9,
        "window_s": window_s,
        "device_ops": [[n, v / 1e9] for n, v in ops.most_common(10)],
        "idle_gaps": [[n, v / 1e9] for n, v in gaps.most_common(10)],
        "device_events": len(dev),
    }
