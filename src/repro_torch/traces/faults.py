"""Fault injection — the elastic event grammar, generalized.

``runtime/elastic.py`` scripts clean membership changes (``fail``/``add``/
``replace``).  Real clusters mostly degrade instead of dying (Hop, arXiv
1902.01064): workers straggle transiently, networks degrade, and outages
take out several machines at once and then give them back.  This module
extends the grammar with those fault classes and provides the runtime
pieces the elastic driver needs to inject them:

grammar (superset of ``parse_events``; same ``kind@step:spec`` terms)::

    fail@8:3                 worker 3 stops heartbeating at step 8
    add@16:v100              a V100 joins
    replace@24:0=v100        slot 0 swapped for a V100
    slow@8:2*3~6             worker 2 computes 3x SLOWER for 6 steps, then recovers
    slow@8:2*3               ... permanently (no recovery)
    netdeg@12:4~8            collectives take 4x longer for 8 steps
    outage@20:1+2~5          workers 1 AND 2 fail together (one correlated rescale);
                             5 steps later they rejoin with their original GPU types
    outage@20:1+2            ... permanently (correlated failure, no recovery)

* :func:`parse_faults` — parse + validate a schedule (same-step collisions
  rejected exactly like ``parse_events``; see ``validate_schedule``).
* :func:`sample_faults` — seeded random campaigns: draw a valid schedule
  from per-kind weights (the "as many scenarios as you can imagine" axis).
* :class:`FaultInjector` — runtime state for the timing faults: active
  slowdown windows per worker and network-degradation windows, remapped
  across membership changes like the failure detector.
* :class:`FaultyTimingSource` — wraps any ``TimingSource`` and scales the
  per-worker ``t_s`` (and records the collective scale) the controller
  sees, so injected faults flow through the SAME measurement path as real
  slowness — Simulated and Measured sources alike.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.hetero import normalize_gpu
from repro_torch.runtime.elastic import validate_schedule

__all__ = [
    "FaultEvent",
    "parse_faults",
    "faults_spec",
    "sample_faults",
    "FaultInjector",
    "FaultyTimingSource",
    "FaultyReplicaClock",
]

MEMBERSHIP_KINDS = ("fail", "add", "replace", "outage")
TIMING_KINDS = ("slow", "netdeg")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scripted fault, applied at global step ``step``.

    ``index``/``gpu`` mirror ``MembershipEvent`` for the membership kinds;
    ``workers`` lists the correlated-outage victims; ``factor`` is the
    slowdown multiple on compute (``slow``) or collective (``netdeg``)
    time; ``duration`` is the recovery horizon in steps (None = permanent).
    Worker indices refer to the membership CURRENT when the event fires.
    """

    step: int
    kind: str
    index: int | None = None
    gpu: str | None = None
    workers: tuple[int, ...] = ()
    factor: float | None = None
    duration: int | None = None

    def __post_init__(self) -> None:
        if self.kind not in MEMBERSHIP_KINDS + TIMING_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.step < 0:
            raise ValueError("fault step must be >= 0")
        if self.kind in ("fail", "replace", "slow") and (self.index is None or self.index < 0):
            raise ValueError(f"{self.kind} fault needs a worker index")
        if self.kind in ("add", "replace") and not self.gpu:
            raise ValueError(f"{self.kind} fault needs a GPU type")
        if self.kind == "outage":
            if not self.workers:
                raise ValueError("outage fault needs at least one worker")
            if len(set(self.workers)) != len(self.workers) or min(self.workers) < 0:
                raise ValueError(f"outage workers must be distinct and >= 0, got {self.workers}")
        if self.kind in TIMING_KINDS:
            if self.factor is None or self.factor <= 1.0:
                raise ValueError(f"{self.kind} fault needs a slowdown factor > 1 (times SLOWER)")
        if self.duration is not None and self.duration < 1:
            raise ValueError("fault duration must be >= 1 step")

    def spec(self) -> str:
        """Canonical grammar term — ``parse_faults(ev.spec())`` roundtrips."""
        dur = f"~{self.duration}" if self.duration is not None else ""
        if self.kind == "fail":
            return f"fail@{self.step}:{self.index}"
        if self.kind == "add":
            return f"add@{self.step}:{self.gpu}"
        if self.kind == "replace":
            return f"replace@{self.step}:{self.index}={self.gpu}"
        if self.kind == "slow":
            return f"slow@{self.step}:{self.index}*{self.factor:g}{dur}"
        if self.kind == "netdeg":
            return f"netdeg@{self.step}:{self.factor:g}{dur}"
        return f"outage@{self.step}:{'+'.join(str(w) for w in self.workers)}{dur}"


_TERM_RE = re.compile(r"^(?P<kind>fail|add|replace|slow|netdeg|outage)@(?P<step>\d+):(?P<spec>.+)$")
_SLOW_RE = re.compile(r"^(?P<idx>\d+)\*(?P<factor>[0-9.]+)(~(?P<dur>\d+))?$")
_NETDEG_RE = re.compile(r"^(?P<factor>[0-9.]+)(~(?P<dur>\d+))?$")
_OUTAGE_RE = re.compile(r"^(?P<workers>\d+(\+\d+)*)(~(?P<dur>\d+))?$")


def parse_faults(schedule: str) -> list[FaultEvent]:
    """Parse ``--faults "slow@8:2*3~6,netdeg@20:4~8,outage@30:1+2~5"``.

    Accepts every ``parse_events`` term too, so one schedule can mix clean
    membership changes with degradation faults.  Sorted by step; duplicate
    or same-step terms are rejected (order-dependent, see
    ``validate_schedule``); factors/durations/GPU names are validated at
    parse time so a typo fails before the run starts.
    """
    events: list[FaultEvent] = []
    for term in schedule.split(","):
        term = term.strip()
        if not term:
            continue
        m = _TERM_RE.match(term)
        if not m:
            raise ValueError(
                f"bad fault {term!r}: expected kind@step:spec with kind in "
                "fail/add/replace/slow/netdeg/outage"
            )
        kind, step, spec = m.group("kind"), int(m.group("step")), m.group("spec")
        try:
            if kind == "fail":
                if not spec.isdigit():
                    raise ValueError("fail takes a worker index")
                events.append(FaultEvent(step=step, kind="fail", index=int(spec)))
            elif kind == "add":
                events.append(FaultEvent(step=step, kind="add", gpu=normalize_gpu(spec)))
            elif kind == "replace":
                idx, sep, gpu = spec.partition("=")
                if not sep or not idx.isdigit():
                    raise ValueError("replace takes index=gpu")
                events.append(FaultEvent(step=step, kind="replace", index=int(idx), gpu=normalize_gpu(gpu)))
            elif kind == "slow":
                ms = _SLOW_RE.match(spec)
                if not ms:
                    raise ValueError("slow takes index*factor[~duration], e.g. slow@8:2*3~6")
                events.append(
                    FaultEvent(
                        step=step,
                        kind="slow",
                        index=int(ms.group("idx")),
                        factor=float(ms.group("factor")),
                        duration=int(ms.group("dur")) if ms.group("dur") else None,
                    )
                )
            elif kind == "netdeg":
                mn = _NETDEG_RE.match(spec)
                if not mn:
                    raise ValueError("netdeg takes factor[~duration], e.g. netdeg@12:4~8")
                events.append(
                    FaultEvent(
                        step=step,
                        kind="netdeg",
                        factor=float(mn.group("factor")),
                        duration=int(mn.group("dur")) if mn.group("dur") else None,
                    )
                )
            else:  # outage
                mo = _OUTAGE_RE.match(spec)
                if not mo:
                    raise ValueError("outage takes i+j+...[~duration], e.g. outage@20:1+2~5")
                events.append(
                    FaultEvent(
                        step=step,
                        kind="outage",
                        workers=tuple(int(w) for w in mo.group("workers").split("+")),
                        duration=int(mo.group("dur")) if mo.group("dur") else None,
                    )
                )
        except ValueError as e:
            raise ValueError(f"bad fault {term!r}: {e}") from None
    return validate_schedule(events)


def faults_spec(events: Sequence[FaultEvent]) -> str:
    """Canonical schedule string (``parse_faults`` roundtrips it)."""
    return ",".join(e.spec() for e in sorted(events, key=lambda e: e.step))


def sample_faults(
    n_workers: int,
    steps: int,
    seed: int,
    n_faults: int = 3,
    kinds: Sequence[str] = ("slow", "netdeg", "outage", "fail", "add"),
    gpu_pool: Sequence[str] = ("v100", "rtx2080ti", "gtx1080ti"),
    slow_factor: tuple[float, float] = (2.0, 5.0),
    netdeg_factor: tuple[float, float] = (2.0, 6.0),
) -> list[FaultEvent]:
    """Draw a seeded, valid random fault schedule (campaign trials).

    Steps are sampled without replacement from the middle of the run (so
    every fault has room to land and recover); membership-size bookkeeping
    keeps the worst-case fleet from dropping below 2 workers, and worker
    indices stay inside that worst-case bound so the schedule is valid
    whatever order earlier faults renumber the membership in.
    """
    if steps < 8:
        raise ValueError("need at least 8 steps to place faults")
    rng = np.random.default_rng(seed)
    lo, hi = max(2, steps // 8), max(3, steps - steps // 4)
    n_faults = min(n_faults, hi - lo)
    fault_steps = sorted(int(s) for s in rng.choice(np.arange(lo, hi), size=n_faults, replace=False))
    min_fleet = n_workers  # worst-case membership size as faults apply
    events: list[FaultEvent] = []
    def shrink_safe(kind: str, fleet: int) -> bool:
        """Is ``kind`` legal for the CURRENT worst-case fleet size?  The
        shrinking kinds (``fail`` removes one worker, ``outage`` up to two)
        are offered only while a removal still leaves >= 2 workers."""
        return kind not in ("fail", "outage") or fleet > 2

    for step in fault_steps:
        remaining = max((steps - step) // 2, 2)
        options = [k for k in kinds if shrink_safe(k, min_fleet)]
        if not options:
            raise ValueError(
                f"no legal fault kinds for a fleet of {min_fleet}: {list(kinds)} "
                "are all shrinking kinds — include slow/netdeg/add"
            )
        kind = str(rng.choice(options))
        if kind == "slow":
            events.append(
                FaultEvent(
                    step=step,
                    kind="slow",
                    index=int(rng.integers(0, min_fleet)),
                    factor=round(float(rng.uniform(*slow_factor)), 2),
                    duration=int(rng.integers(2, remaining + 1)),
                )
            )
        elif kind == "netdeg":
            events.append(
                FaultEvent(
                    step=step,
                    kind="netdeg",
                    factor=round(float(rng.uniform(*netdeg_factor)), 2),
                    duration=int(rng.integers(2, remaining + 1)),
                )
            )
        elif kind == "outage":
            k = int(rng.integers(1, min(2, min_fleet - 2) + 1))
            workers = tuple(sorted(int(w) for w in rng.choice(np.arange(min_fleet), size=k, replace=False)))
            dur = int(rng.integers(2, remaining + 1))
            events.append(FaultEvent(step=step, kind="outage", workers=workers, duration=dur))
            # recovered workers rejoin, but plan for the worst case in between
            min_fleet -= k
        elif kind == "fail":
            events.append(FaultEvent(step=step, kind="fail", index=int(rng.integers(0, min_fleet))))
            min_fleet -= 1
        elif kind == "add":
            events.append(FaultEvent(step=step, kind="add", gpu=str(rng.choice(list(gpu_pool)))))
            min_fleet += 1
        else:
            raise ValueError(f"unknown fault kind {kind!r} in kinds")
    return validate_schedule(events)


# ---------------------------------------------------------------------------
# runtime injection
# ---------------------------------------------------------------------------


class FaultInjector:
    """Active timing-fault windows, remapped across membership changes.

    Registered ``slow`` windows scale one worker's compute time; ``netdeg``
    windows scale collective time.  Windows are step-ranged (``until=None``
    = permanent) and indexed by CURRENT membership slots, so a rescale must
    remap them exactly like the failure detector remaps its miss counts —
    a window on a dead worker dies with it.
    """

    def __init__(self, n_workers: int) -> None:
        self.n_workers = n_workers
        self._slow: list[dict] = []  # {"worker", "scale", "from", "until"}
        self._net: list[dict] = []  # {"scale", "from", "until"}

    def apply(self, ev: FaultEvent) -> None:
        until = None if ev.duration is None else ev.step + ev.duration
        if ev.kind == "slow":
            if not (0 <= ev.index < self.n_workers):
                raise ValueError(f"slow fault {ev.spec()!r}: worker index out of range for n={self.n_workers}")
            self._slow.append({"worker": ev.index, "scale": float(ev.factor), "from": ev.step, "until": until})
        elif ev.kind == "netdeg":
            self._net.append({"scale": float(ev.factor), "from": ev.step, "until": until})
        else:
            raise ValueError(f"{ev.kind} is a membership fault; the driver applies it, not the injector")

    @staticmethod
    def _live(w: dict, step: int) -> bool:
        return w["from"] <= step and (w["until"] is None or step < w["until"])

    def compute_scale(self, step: int, n: int | None = None) -> np.ndarray:
        """Per-worker multiplier on compute time at ``step`` (>= 1)."""
        n = self.n_workers if n is None else n
        scale = np.ones(n, dtype=np.float64)
        for w in self._slow:
            if w["worker"] < n and self._live(w, step):
                scale[w["worker"]] *= w["scale"]
        return scale

    def collective_scale(self, step: int) -> float:
        scale = 1.0
        for w in self._net:
            if self._live(w, step):
                scale *= w["scale"]
        return scale

    def mean_compute_scale(self, steps: Sequence[int], n: int | None = None) -> np.ndarray:
        n = self.n_workers if n is None else n
        if not steps:
            return np.ones(n, dtype=np.float64)
        return np.mean([self.compute_scale(s, n) for s in steps], axis=0)

    def mean_collective_scale(self, steps: Sequence[int]) -> float:
        if not steps:
            return 1.0
        return float(np.mean([self.collective_scale(s) for s in steps]))

    def active(self, step: int) -> dict:
        """Summary of windows live at ``step`` (fault-log / BENCH reporting)."""
        return {
            "slow": [dict(w) for w in self._slow if w["until"] is None or step < w["until"]],
            "netdeg": [dict(w) for w in self._net if w["until"] is None or step < w["until"]],
        }

    def gc(self, step: int) -> None:
        """Drop windows that ended before ``step`` (state stays bounded)."""
        self._slow = [w for w in self._slow if w["until"] is None or step < w["until"]]
        self._net = [w for w in self._net if w["until"] is None or step < w["until"]]

    def rescale(self, survivors: Sequence[int], n_new: int) -> None:
        """Remap slow windows onto the post-rescale membership (survivor
        order + joiners appended); windows on removed workers are dropped."""
        remap = {int(old): new for new, old in enumerate(survivors)}
        kept = []
        for w in self._slow:
            if w["worker"] in remap:
                kept.append({**w, "worker": remap[w["worker"]]})
        self._slow = kept
        self.n_workers = len(survivors) + n_new

    def fingerprint(self) -> tuple:
        """Canonical hashable state for the protocol model checker
        (``repro.analysis.protocol``): worker count plus every live window,
        order-free (windows are commutative multipliers)."""
        slow = tuple(sorted((w["worker"], w["scale"], w["from"], w["until"]) for w in self._slow))
        net = tuple(sorted((w["scale"], w["from"], w["until"]) for w in self._net))
        return (self.n_workers, slow, net)

    # checkpoint support (bundled into the driver's metadata) ---------------

    def state_dict(self) -> dict:
        return {"n_workers": self.n_workers, "slow": [dict(w) for w in self._slow], "net": [dict(w) for w in self._net]}

    @classmethod
    def from_state_dict(cls, state: dict) -> "FaultInjector":
        inj = cls(int(state["n_workers"]))
        inj._slow = [dict(w) for w in state.get("slow", [])]
        inj._net = [dict(w) for w in state.get("net", [])]
        return inj


class FaultyTimingSource:
    """A ``TimingSource`` that perturbs what the controller measures.

    Wraps any inner source (simulated or measured) and scales the per-worker
    ``t_s`` vector by the injector's mean compute scale over the steps the
    epoch actually covered — injected stragglers look exactly like real ones
    to the controller, the straggler monitor, and the BENCH accounting.
    ``last_collective_scale`` carries the matching ``t_c`` multiplier out of
    the most recent ``epoch_times`` drain (the driver applies it to its
    collective model; a measured source folds collectives into wall time,
    where a simulated netdeg has nothing to scale).
    """

    def __init__(self, inner, injector: FaultInjector, step_of: Callable[[], int]) -> None:
        self.inner = inner
        self.injector = injector
        self._step_of = step_of
        self._steps: list[int] = []
        self.last_collective_scale = 1.0

    def record_step(self, wall_s: float, alloc: Sequence[int]) -> None:
        self._steps.append(self._step_of())
        self.inner.record_step(wall_s, alloc)

    def epoch_times(self, alloc: Sequence[int], epoch: int) -> np.ndarray:
        t = np.asarray(self.inner.epoch_times(alloc, epoch), dtype=np.float64)
        steps = self._steps or [self._step_of()]
        self.last_collective_scale = self.injector.mean_collective_scale(steps)
        t = t * self.injector.mean_compute_scale(steps, len(t))
        self._steps = []
        return t

    def reset(self) -> None:
        self.inner.reset()
        self._steps = []

    @property
    def ready(self) -> bool:
        return self.inner.ready


class FaultyReplicaClock:
    """Routes the injector's windowed timing faults onto a replica fleet's
    virtual clocks — the serving mirror of :class:`FaultyTimingSource`.

    Training scales the per-worker epoch times the controller measures;
    serving scales each replica's per-tick virtual cost: before every
    advance the router driver calls :meth:`apply`, which sets
    ``replica.tick_scale`` to the product of the replica's live ``slow``
    windows and the fleet-wide ``netdeg`` windows at the current fault step
    (= assignment index).  The scaled clock then flows through
    ``harvest_window`` into the adaptive controller exactly like real
    slowness — same measurement path, same reaction.
    """

    def __init__(self, injector: FaultInjector, step_of: Callable[[], int]) -> None:
        self.injector = injector
        self._step_of = step_of

    def scales(self, n: int) -> np.ndarray:
        """Per-replica tick-cost multiplier at the current fault step."""
        step = self._step_of()
        return self.injector.compute_scale(step, n) * self.injector.collective_scale(step)

    def apply(self, replicas: Sequence) -> None:
        for rep, s in zip(replicas, self.scales(len(replicas))):
            rep.tick_scale = float(s)
