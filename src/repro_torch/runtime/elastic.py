"""Elastic scaling + failure handling on top of the allocation controller.

The paper's fig. 11 (add a worker / replace a weak worker with a strong
one) is a *manual* elasticity experiment; this module automates it:

1. ``FailureDetector`` — heartbeat bookkeeping; a rank missing
   ``patience`` consecutive heartbeats is declared dead.
2. ``ElasticCoordinator`` — on membership change, builds a rescale plan:
   * surviving workers keep their measured speeds (warm start),
   * joiners start at the mean speed (one adaptation epoch fixes it),
   * the controller's total C is preserved -> optimizer schedule unchanged,
   * data sampler re-partitions the *next* epoch (no mid-epoch resharding —
     the paper reallocates at epoch boundaries only).
3. In-flight step loss on failure is bounded by the checkpoint period
   (``CheckpointManager``); the coordinator reports the restore step.

At real pod scale, "worker" = pod/slice (see DESIGN.md §3): a preempted
slice is a remove, a restored one a join — same code path.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Sequence

import numpy as np

from repro_torch.core.controller import AdaptiveAllocationController
from repro_torch.core.hetero import normalize_gpu

__all__ = [
    "FailureDetector",
    "RescalePlan",
    "ElasticCoordinator",
    "MembershipEvent",
    "parse_events",
    "validate_schedule",
]


class FailureDetector:
    def __init__(self, n_workers: int, patience: int = 3) -> None:
        self.patience = patience
        self._missed = np.zeros(n_workers, dtype=np.int64)
        self._alive = np.ones(n_workers, dtype=bool)
        self._seen = np.zeros(n_workers, dtype=bool)  # heartbeats this interval

    @property
    def n_workers(self) -> int:
        return len(self._alive)

    def heartbeat(self, worker: int) -> bool:
        """Record a heartbeat; returns True when it REVIVES a declared-dead
        worker (the caller should treat that as a rejoin request — before
        this returned a value, a revived worker's heartbeats were silently
        absorbed and it could never rejoin)."""
        self._missed[worker] = 0
        self._seen[worker] = True
        revived = not self._alive[worker]
        self._alive[worker] = True
        return bool(revived)

    def tick(self) -> list[int]:
        """Advance one heartbeat interval; returns newly-dead worker ids.

        Only workers that did NOT heartbeat during the interval count a
        miss — a worker that reported must never accrue one, or with
        ``patience=1`` every tick would declare the whole fleet dead.
        """
        self._missed[self._alive & ~self._seen] += 1
        self._seen[:] = False
        newly_dead = np.where(self._alive & (self._missed >= self.patience))[0]
        self._alive[newly_dead] = False
        return [int(i) for i in newly_dead]

    def rescale(self, survivors: Sequence[int], n_new: int) -> None:
        """Remap the detector onto a post-:class:`RescalePlan` membership.

        Detector state is indexed by OLD membership ids; after a rescale the
        coordinator renumbers workers to ``survivors`` order plus ``n_new``
        joiners appended at the end.  Without this remap, heartbeats and
        deadness land on the wrong workers after the first membership change.
        Joiners start alive with a clean miss count.
        """
        idx = np.asarray(survivors, dtype=np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= len(self._alive)):
            raise ValueError(f"survivor ids {survivors} out of range for n={len(self._alive)}")
        self._missed = np.concatenate([self._missed[idx], np.zeros(n_new, dtype=np.int64)])
        self._alive = np.concatenate([self._alive[idx], np.ones(n_new, dtype=bool)])
        self._seen = np.concatenate([self._seen[idx], np.zeros(n_new, dtype=bool)])

    @property
    def alive(self) -> np.ndarray:
        return self._alive.copy()

    def fingerprint(self) -> tuple:
        """Canonical hashable state — the protocol model checker's identity
        for this detector (the JAX package's ``repro.analysis.protocol``).  Covers everything
        that affects future behavior: patience, per-worker miss counts,
        aliveness, and the current interval's heartbeat set."""
        return (
            self.patience,
            tuple(int(m) for m in self._missed),
            tuple(bool(a) for a in self._alive),
            tuple(bool(s) for s in self._seen),
        )


@dataclasses.dataclass(frozen=True)
class RescalePlan:
    survivors: list[int]  # old indices kept, in new order
    n_new: int  # joiners appended at the end
    allocation: np.ndarray  # warm-start allocation for the new membership
    restore_step: int | None  # checkpoint step to resume from (None = continue)


class ElasticCoordinator:
    def __init__(self, controller: AdaptiveAllocationController) -> None:
        self.controller = controller

    def _speeds(self) -> np.ndarray | None:
        log = self.controller.log
        if len(log) == 0:
            return None
        with np.errstate(divide="ignore", invalid="ignore"):  # gate below handles inf/nan
            v = log[-1].speeds
        # Defensive length/positivity/finiteness gate: a log entry from a
        # previous membership (or a degenerate measurement — t_s of 0 reads
        # back as infinite speed) must read as "no speed history" — cold
        # equal start — never as indexable speeds for the wrong worker set.
        # resize() rebases the log, so this only fires on logs mutated
        # outside the controller.
        if v.shape != (self.controller.config.n_workers,) or np.any(v <= 0) or not np.all(np.isfinite(v)):
            return None
        return v

    def remove(self, dead: Sequence[int], restore_step: int | None = None) -> RescalePlan:
        n_old = self.controller.config.n_workers
        survivors = [i for i in range(n_old) if i not in set(dead)]
        v = self._speeds()
        carry = v[survivors] if v is not None else None
        alloc = self.controller.resize(len(survivors), carry_speeds=carry)
        return RescalePlan(survivors=survivors, n_new=0, allocation=alloc, restore_step=restore_step)

    def add(self, n_new: int, est_speed: float | None = None) -> RescalePlan:
        n_old = self.controller.config.n_workers
        v = self._speeds()
        if v is not None:
            join_speed = est_speed if est_speed is not None else float(np.mean(v))
            carry = np.concatenate([v, np.full(n_new, join_speed)])
        else:
            carry = None
        alloc = self.controller.resize(n_old + n_new, carry_speeds=carry)
        return RescalePlan(survivors=list(range(n_old)), n_new=n_new, allocation=alloc, restore_step=None)

    def replace(self, index: int, est_speed: float | None = None) -> RescalePlan:
        """Replace worker ``index`` (paper fig. 11 'weak -> strong' case)."""
        n = self.controller.config.n_workers
        v = self._speeds()
        if v is not None:
            carry = v.copy()
            carry[index] = est_speed if est_speed is not None else float(np.mean(v))
        else:
            carry = None
        alloc = self.controller.resize(n, carry_speeds=carry)
        return RescalePlan(survivors=list(range(n)), n_new=0, allocation=alloc, restore_step=None)


# ---------------------------------------------------------------------------
# scripted membership events (fig. 11 schedules for the elastic driver)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MembershipEvent:
    """One scripted fleet change, applied at global step ``step``.

    kind='fail'     worker ``index`` stops heartbeating (goes through the
                    FailureDetector, not straight to the coordinator)
    kind='add'      one worker of type ``gpu`` joins
    kind='replace'  worker ``index`` is swapped for a ``gpu`` card

    ``index`` refers to the membership CURRENT when the event fires — after
    earlier rescales renumbered workers — exactly how an operator would name
    a slot at that moment.
    """

    step: int
    kind: str  # "fail" | "add" | "replace"
    index: int | None = None
    gpu: str | None = None

    def __post_init__(self) -> None:
        if self.kind not in ("fail", "add", "replace"):
            raise ValueError(f"unknown event kind {self.kind!r}")
        if self.step < 0:
            raise ValueError("event step must be >= 0")
        if self.kind in ("fail", "replace") and (self.index is None or self.index < 0):
            raise ValueError(f"{self.kind} event needs a worker index")
        if self.kind in ("add", "replace") and not self.gpu:
            raise ValueError(f"{self.kind} event needs a GPU type")

    def spec(self) -> str:
        """Canonical grammar term — ``parse_events(ev.spec())`` roundtrips."""
        if self.kind == "fail":
            return f"fail@{self.step}:{self.index}"
        if self.kind == "add":
            return f"add@{self.step}:{self.gpu}"
        return f"replace@{self.step}:{self.index}={self.gpu}"


def validate_schedule(events: Sequence) -> list:
    """Sort a schedule by step and reject same-step collisions.

    Two events at the same step apply back-to-back, and the second sees the
    membership AFTER the first renumbered workers — ``fail@8:1,fail@8:1``
    kills two DIFFERENT physical workers, and which two depends on the
    written order.  ``parse_events`` previously accepted that silently
    (stable sort kept written order); now any two events sharing a step —
    including exact duplicates — raise with both offending terms named, so
    an argparse shim can surface the message as-is.  Works on anything with
    ``.step`` and ``.spec()`` (membership events and trace fault events).
    """
    ordered = sorted(events, key=lambda e: e.step)
    by_step: dict[int, object] = {}
    for e in ordered:
        prior = by_step.get(e.step)
        if prior is not None:
            raise ValueError(
                f"events {prior.spec()!r} and {e.spec()!r} both fire at step {e.step}: "
                "same-step events apply in written order against a renumbered "
                "membership (silently order-dependent) — give each event its own step"
            )
        by_step[e.step] = e
    return ordered


_EVENT_RE = re.compile(r"^(?P<kind>add|fail|replace)@(?P<step>\d+):(?P<spec>.+)$")


def parse_events(schedule: str) -> list[MembershipEvent]:
    """Parse ``--events "add@8:gtx1080ti,fail@16:2,replace@24:1=v100"``.

    Comma-separated ``kind@step:spec`` terms where spec is a GPU type
    (``add``), a worker index (``fail``) or ``index=gpu`` (``replace``).
    Returned sorted by step; duplicate or same-step terms are rejected (see
    :func:`validate_schedule`).  GPU names are validated against the known
    throughput table so a typo fails at parse time, not 24 steps into the
    run.
    """
    events: list[MembershipEvent] = []
    for term in schedule.split(","):
        term = term.strip()
        if not term:
            continue
        m = _EVENT_RE.match(term)
        if not m:
            raise ValueError(f"bad event {term!r}: expected kind@step:spec with kind in add/fail/replace")
        kind, step, spec = m.group("kind"), int(m.group("step")), m.group("spec")
        if kind == "add":
            events.append(MembershipEvent(step=step, kind="add", gpu=normalize_gpu(spec)))
        elif kind == "fail":
            if not spec.isdigit():
                raise ValueError(f"bad event {term!r}: fail takes a worker index")
            events.append(MembershipEvent(step=step, kind="fail", index=int(spec)))
        else:  # replace
            idx, sep, gpu = spec.partition("=")
            if not sep or not idx.isdigit():
                raise ValueError(f"bad event {term!r}: replace takes index=gpu")
            events.append(MembershipEvent(step=step, kind="replace", index=int(idx), gpu=normalize_gpu(gpu)))
    return validate_schedule(events)
