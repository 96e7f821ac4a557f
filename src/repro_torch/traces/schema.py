"""Trace schema + adapters — replay real-cluster workload shapes into the repo.

The schema is a distilled job/task/machine hierarchy in the spirit of the
Alibaba PAI GPU-cluster trace: a trace names the MACHINES that make up the
cluster (GPU type + the window they are part of it) and the TASKS that
arrive over trace time (one task == one inference request / training task
instance, with a prompt/generation size).  Everything is derived — the
checked-in trace under ``traces/data/`` is synthesized from published
diurnal/bursty arrival statistics (see ``traces/synth.py``), never copied
from raw trace rows — and everything is seeded, so a trace is a
reproducible workload artifact, not a sampling procedure.

Two adapters turn one trace into both halves of the system:

* :func:`to_requests` — serve side: tasks become ``serve.Request`` objects
  (via ``serve.workload.from_trace``), so the continuous-batching engine
  and the traffic router replay the trace's diurnal/bursty arrival pattern
  instead of a one-knob Poisson stream.
* :func:`to_fleet` / :func:`to_events` — train side: machines present at
  t=0 become the elastic trainer's ``--hetero-gpus`` fleet, and machines
  joining/leaving mid-trace become the ``--events`` membership schedule
  (``add@step:gpu`` / ``fail@step:index``), with trace time mapped onto
  the run's step budget.
"""

from __future__ import annotations

import dataclasses
import json
import os

from repro_torch.core.hetero import normalize_gpu
from repro_torch.runtime.elastic import MembershipEvent, validate_schedule

__all__ = [
    "TraceMachine",
    "TraceTask",
    "Trace",
    "load_trace",
    "save_trace",
    "bundled_trace_path",
    "bundled_trace",
    "to_requests",
    "to_fleet",
    "to_events",
]

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


@dataclasses.dataclass(frozen=True)
class TraceMachine:
    """One machine's membership window in the cluster.

    ``join``/``leave`` are in trace time (the same unit task arrivals use);
    ``leave=None`` means the machine stays for the whole trace.
    """

    machine: str  # machine id (PAI: machine)
    gpu: str  # key into GPU_RELATIVE_THROUGHPUT (PAI: gpu_type)
    join: float = 0.0
    leave: float | None = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "gpu", normalize_gpu(self.gpu))
        if self.join < 0:
            raise ValueError(f"machine {self.machine}: join must be >= 0")
        if self.leave is not None and self.leave <= self.join:
            raise ValueError(f"machine {self.machine}: leave must be after join")


@dataclasses.dataclass(frozen=True)
class TraceTask:
    """One workload arrival (PAI: a task instance of a job)."""

    job: str
    task: str
    arrival: float
    prompt_len: int
    gen_len: int

    def __post_init__(self) -> None:
        if self.arrival < 0:
            raise ValueError(f"task {self.job}/{self.task}: arrival must be >= 0")
        if self.prompt_len < 1 or self.gen_len < 1:
            raise ValueError(f"task {self.job}/{self.task}: prompt_len/gen_len must be >= 1")


@dataclasses.dataclass(frozen=True)
class Trace:
    """A replayable cluster workload: machines + task arrivals over a horizon."""

    name: str
    horizon: float
    machines: tuple[TraceMachine, ...]
    tasks: tuple[TraceTask, ...]
    meta: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.horizon <= 0:
            raise ValueError("trace horizon must be positive")
        if not self.machines:
            raise ValueError("trace needs at least one machine")
        if not any(m.join <= 0 for m in self.machines):
            raise ValueError("trace needs at least one machine present at t=0")
        ids = [m.machine for m in self.machines]
        if len(set(ids)) != len(ids):
            raise ValueError("duplicate machine ids in trace")
        for t in self.tasks:
            if t.arrival > self.horizon:
                raise ValueError(f"task {t.job}/{t.task} arrives past the horizon")
        object.__setattr__(self, "tasks", tuple(sorted(self.tasks, key=lambda t: (t.arrival, t.job, t.task))))

    @property
    def n_tasks(self) -> int:
        return len(self.tasks)

    def machines_at(self, t: float) -> list[TraceMachine]:
        return [m for m in self.machines if m.join <= t and (m.leave is None or m.leave > t)]

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "horizon": self.horizon,
            "machines": [dataclasses.asdict(m) for m in self.machines],
            "tasks": [dataclasses.asdict(t) for t in self.tasks],
            "meta": self.meta,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Trace":
        return cls(
            name=d["name"],
            horizon=float(d["horizon"]),
            machines=tuple(TraceMachine(**m) for m in d["machines"]),
            tasks=tuple(TraceTask(**t) for t in d["tasks"]),
            meta=dict(d.get("meta", {})),
        )


def load_trace(path: str) -> Trace:
    with open(path) as f:
        return Trace.from_dict(json.load(f))


def save_trace(trace: Trace, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(trace.to_dict(), f, indent=1)
        f.write("\n")


def bundled_trace_path(name: str = "pai_small") -> str:
    path = os.path.join(_DATA_DIR, f"{name}.json")
    if not os.path.exists(path):
        have = sorted(p[:-5] for p in os.listdir(_DATA_DIR) if p.endswith(".json"))
        raise FileNotFoundError(f"no bundled trace {name!r}; have {have}")
    return path


def bundled_trace(name: str = "pai_small") -> Trace:
    """The checked-in derived trace (see ``traces/synth.py`` for provenance)."""
    return load_trace(bundled_trace_path(name))


# ---------------------------------------------------------------------------
# serve-side adapter
# ---------------------------------------------------------------------------


def to_requests(
    trace: Trace,
    vocab_size: int = 256,
    seed: int = 0,
    time_scale: float = 1.0,
    limit: int | None = None,
    embed_dim: int | None = None,
) -> list:
    """Tasks -> ``serve.Request`` list via ``workload.from_trace``.

    ``time_scale`` maps trace time onto engine ticks (arrival_ticks =
    arrival * time_scale); ``limit`` truncates to the first N arrivals.
    Token contents are synthesized deterministically from ``seed`` — the
    trace carries shapes and timing, never payloads.
    """
    from repro_torch.serve.workload import from_trace

    tasks = trace.tasks[:limit] if limit is not None else trace.tasks
    records = [{"arrival": t.arrival * time_scale, "prompt_len": t.prompt_len, "gen_len": t.gen_len} for t in tasks]
    return from_trace(records, vocab_size=vocab_size, seed=seed, embed_dim=embed_dim)


# ---------------------------------------------------------------------------
# train-side adapters
# ---------------------------------------------------------------------------


def to_fleet(trace: Trace) -> list[str]:
    """GPU types of the machines present at t=0, in trace order."""
    fleet = [m.gpu for m in trace.machines if m.join <= 0]
    return fleet


def to_events(trace: Trace, n_steps: int) -> str:
    """Machine churn -> elastic ``--events`` schedule over ``n_steps`` steps.

    Trace time is mapped linearly onto [0, n_steps); a machine joining at
    trace time t becomes ``add@step:gpu`` and one leaving becomes
    ``fail@step:index``, where index is the machine's slot in the
    membership CURRENT at that moment (replayed here exactly as the driver
    renumbers: survivors keep order, joiners append).  Same-step collisions
    after rounding are bumped to the next free step so the schedule passes
    :func:`~repro_torch.runtime.elastic.validate_schedule`.
    """
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    scale = n_steps / trace.horizon
    changes: list[tuple[float, str, TraceMachine]] = []
    for m in trace.machines:
        if m.join > 0:
            changes.append((m.join, "add", m))
        if m.leave is not None:
            changes.append((m.leave, "fail", m))
    changes.sort(key=lambda c: (c[0], c[1], c[2].machine))

    order = [m.machine for m in trace.machines if m.join <= 0]
    events: list[MembershipEvent] = []
    used_steps: set[int] = set()
    for t, kind, m in changes:
        step = max(1, min(int(round(t * scale)), n_steps - 1))
        while step in used_steps:  # same-step events are rejected downstream
            step += 1
        used_steps.add(step)
        if kind == "add":
            events.append(MembershipEvent(step=step, kind="add", gpu=m.gpu))
            order.append(m.machine)
        else:
            if len(order) <= 1:
                raise ValueError(f"trace {trace.name}: machine {m.machine} leaving would empty the cluster")
            idx = order.index(m.machine)
            events.append(MembershipEvent(step=step, kind="fail", index=idx))
            order.pop(idx)
    return ",".join(e.spec() for e in validate_schedule(events))
