"""Low-overhead span/event recorder exporting Chrome-trace-event JSON.

The exported file loads directly in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``: one *process* per subsystem ("train", "serve",
"router"), one *thread track* per worker/replica/slot, complete-event spans
for compute/wait/collective/decode phases, instant events for membership
changes and checkpoints, and counter tracks for allocation shares, queue
depth and pool utilization.

Clocks are EXPLICIT.  The recorder never reads wall time on its own: every
event carries a timestamp in seconds supplied by the caller, either from an
injected monotonic clock (:func:`time.perf_counter` on real deployments) or
from a :class:`VirtualClock` the caller advances by modeled durations
(simulated timing, tick-time serving).  Under virtual clocks the exported
bytes are a pure function of the run's seeded inputs, so CI can double-run
and ``cmp`` the file like every other deterministic artifact.

Disabled tracing is a no-op: :data:`NULL_TRACER` implements the same
surface with empty methods and ``enabled=False``, so instrumentation sites
cost one attribute check when observability is off.
"""

from __future__ import annotations

import json
import time
from typing import Callable

__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "VirtualClock"]


class VirtualClock:
    """A mutable clock the owner advances by modeled durations (seconds)."""

    def __init__(self, t: float = 0.0) -> None:
        self.t = float(t)

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t

    def __call__(self) -> float:
        return self.t


class Tracer:
    """Append-only trace-event recorder.

    Tracks are named ``"process/thread"`` (the part before the first ``/``
    groups threads under one Perfetto process; a bare name becomes a thread
    of the default ``"trace"`` process).  Track ids are assigned in
    first-use order, so a deterministic call sequence yields deterministic
    ids and deterministic exported bytes.
    """

    enabled = True

    def __init__(self, clock: Callable[[], float] | None = None) -> None:
        self._clock = clock if clock is not None else time.perf_counter
        self._origin = self._clock()
        self._events: list[dict] = []
        self._pids: dict[str, int] = {}
        self._tids: dict[tuple[str, str], int] = {}

    # -- clock ---------------------------------------------------------------

    def now(self) -> float:
        """Seconds since the tracer was constructed, on the injected clock."""
        return self._clock() - self._origin

    # -- track interning -----------------------------------------------------

    def _track(self, track: str) -> tuple[int, int]:
        proc, _, thread = track.partition("/")
        if not thread:
            proc, thread = "trace", proc
        pid = self._pids.get(proc)
        if pid is None:
            pid = self._pids[proc] = len(self._pids)
            self._events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0, "args": {"name": proc}})
            self._events.append(
                {"ph": "M", "name": "process_sort_index", "pid": pid, "tid": 0, "args": {"sort_index": pid}}
            )
        tid = self._tids.get((proc, thread))
        if tid is None:
            tid = self._tids[(proc, thread)] = sum(1 for p, _ in self._tids if p == proc)
            self._events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid, "args": {"name": thread}})
            self._events.append(
                {"ph": "M", "name": "thread_sort_index", "pid": pid, "tid": tid, "args": {"sort_index": tid}}
            )
        return pid, tid

    @staticmethod
    def _us(t: float) -> float:
        # microseconds, rounded to 0.001 us: stable float formatting without
        # losing sub-tick resolution (round() on binary64 is deterministic)
        return round(t * 1e6, 3)

    # -- events --------------------------------------------------------------

    def span(self, track: str, name: str, t0: float, dur: float, args: dict | None = None) -> None:
        """One complete span ("X" event) on ``track``: [t0, t0 + dur]."""
        pid, tid = self._track(track)
        ev = {"ph": "X", "name": name, "pid": pid, "tid": tid, "ts": self._us(t0), "dur": self._us(dur)}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def instant(self, track: str, name: str, t: float, args: dict | None = None) -> None:
        """A zero-duration annotation ("i" event, thread-scoped)."""
        pid, tid = self._track(track)
        ev = {"ph": "i", "s": "t", "name": name, "pid": pid, "tid": tid, "ts": self._us(t)}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def counter(self, track: str, name: str, t: float, values: dict) -> None:
        """A counter sample ("C" event): ``values`` maps series name -> number."""
        pid, tid = self._track(track)
        self._events.append({"ph": "C", "name": name, "pid": pid, "tid": tid, "ts": self._us(t), "args": dict(values)})

    # -- export --------------------------------------------------------------

    def to_dict(self) -> dict:
        return {"traceEvents": list(self._events), "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        """Write Perfetto-loadable JSON.  ``sort_keys`` + fixed separators so
        identical event sequences produce identical bytes."""
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, sort_keys=True, separators=(",", ":"))
            f.write("\n")

    def __len__(self) -> int:
        return len(self._events)


class NullTracer:
    """The disabled tracer: same surface, no work, ``enabled=False``."""

    enabled = False

    def now(self) -> float:
        return 0.0

    def span(self, track, name, t0, dur, args=None) -> None:
        pass

    def instant(self, track, name, t, args=None) -> None:
        pass

    def counter(self, track, name, t, values) -> None:
        pass

    def to_dict(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def export(self, path) -> None:
        raise RuntimeError("NullTracer has nothing to export — construct a Tracer")

    def __len__(self) -> int:
        return 0


NULL_TRACER = NullTracer()
