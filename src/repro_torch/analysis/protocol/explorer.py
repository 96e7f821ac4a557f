"""Bounded explicit-state model checking over the *real* protocol classes
(a copy of the JAX package's ``analysis/protocol/explorer.py``, pure Python).

The explorer is deliberately generic: a model is any object with

* ``initial() -> state`` — build the start state (fresh production objects);
* ``actions(state) -> list[str]`` — canonical names of the actions enabled
  in ``state``, sorted (determinism of the search order);
* ``apply(state, action) -> state`` — execute one action against COPIES of
  the production objects and return the successor (must not mutate its
  input; harnesses clone first, then drive the real class methods);
* ``fingerprint(state) -> hashable`` — canonical state identity.  Two
  states with equal fingerprints are merged, so fingerprints must cover
  everything that affects future behavior and nothing that doesn't
  (no ids, no timestamps — byte-determinism of the report depends on it);
* ``invariants(state) -> list[str]`` — violation messages (empty = OK),
  machine-checked on EVERY state the search discovers;
* ``quiescent(state) -> bool`` — whether a state with no enabled action is
  legitimate (run complete) rather than a deadlock.

:func:`explore` runs breadth-first search from ``initial()`` over canonical
fingerprints, so the action path to any state is a SHORTEST path — the raw
counterexample is already depth-minimal.  :func:`shrink` then delta-shrinks
it (greedy single-action removal to a fixed point, re-replaying each
candidate) so the script names only the actions that matter.  Violations
carry replayable scripts; :func:`replay` re-executes one against a fresh
model and returns the violation it reproduces, which is how the CLI
selftest proves counterexamples are real.
"""

from __future__ import annotations

import dataclasses
import re
from collections import deque
from typing import Sequence

__all__ = [
    "Violation",
    "ExploreResult",
    "explore",
    "replay",
    "shrink",
    "format_script",
    "parse_script",
]

_TERM_RE = re.compile(r"^(?P<kind>[a-z_]+)@(?P<step>\d+)(?::(?P<spec>.+))?$")


def format_script(actions: Sequence[str]) -> str:
    """Render an action sequence as a replayable ``kind@step[:spec]`` script
    (step = position in the sequence) — the same term shape as the runtime's
    ``--events``/``--faults`` grammar, so membership counterexamples read as
    event-schedule terms (``fail@2:1``, ``add@5:v100``, ``slow@3:1*2``)."""
    terms = []
    for i, action in enumerate(actions):
        kind, _, spec = action.partition(":")
        terms.append(f"{kind}@{i}:{spec}" if spec else f"{kind}@{i}")
    return ",".join(terms)


def parse_script(script: str) -> list[str]:
    """Parse a :func:`format_script` script back into ordered action names."""
    out = []
    for term in script.split(","):
        term = term.strip()
        if not term:
            continue
        m = _TERM_RE.match(term)
        if not m:
            raise ValueError(f"bad script term {term!r}: expected kind@step[:spec]")
        out.append((int(m.group("step")), m.group("kind"), m.group("spec")))
    out.sort(key=lambda t: t[0])
    return [f"{kind}:{spec}" if spec else kind for _, kind, spec in out]

# hard ceilings so a runaway model cannot hang the analysis lane;
# `ExploreResult.exhausted` reports whether the search hit them
DEFAULT_MAX_STATES = 200_000
DEFAULT_MAX_VIOLATIONS = 8


@dataclasses.dataclass(frozen=True)
class Violation:
    """One invariant/deadlock/action failure with its replayable script."""

    kind: str  # "invariant" | "deadlock" | "action-error"
    message: str
    script: tuple[str, ...]  # action names, in order, from the initial state
    depth: int  # length of the UNshrunk shortest path

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "message": self.message,
            "script": list(self.script),
            "depth": self.depth,
        }


@dataclasses.dataclass
class ExploreResult:
    violations: list[Violation]
    n_states: int
    n_transitions: int
    max_depth_reached: int
    exhausted: bool  # every reachable state within max_depth was expanded
    truncated_by: str | None  # "max_states" | "max_violations" | None

    def stats(self) -> dict:
        return {
            "n_states": self.n_states,
            "n_transitions": self.n_transitions,
            "max_depth_reached": self.max_depth_reached,
            "exhausted": self.exhausted,
            "truncated_by": self.truncated_by,
            "n_violations": len(self.violations),
        }


def _path(parent: dict, fp) -> tuple[str, ...]:
    """Reconstruct the action path to ``fp`` through BFS parent pointers."""
    steps: list[str] = []
    while parent[fp] is not None:
        fp, action = parent[fp]
        steps.append(action)
    return tuple(reversed(steps))


def explore(
    model,
    *,
    max_depth: int,
    max_states: int = DEFAULT_MAX_STATES,
    max_violations: int = DEFAULT_MAX_VIOLATIONS,
    shrink_scripts: bool = True,
) -> ExploreResult:
    """BFS over canonical state fingerprints up to ``max_depth`` actions."""
    init = model.initial()
    fp0 = model.fingerprint(init)
    parent: dict = {fp0: None}
    depth = {fp0: 0}
    queue: deque = deque([(init, fp0)])
    violations: list[Violation] = []
    n_transitions = 0
    max_depth_reached = 0
    truncated_by: str | None = None

    def record(kind: str, message: str, script: tuple[str, ...]) -> None:
        raw_depth = len(script)
        if shrink_scripts:
            script = shrink(model, script, kind)
        violations.append(Violation(kind=kind, message=message, script=script, depth=raw_depth))

    for msg in model.invariants(init):
        record("invariant", msg, ())

    while queue:
        if len(violations) >= max_violations:
            truncated_by = "max_violations"
            break
        state, fp = queue.popleft()
        d = depth[fp]
        actions = model.actions(state)
        if not actions and not model.quiescent(state):
            record("deadlock", "no enabled action in a non-quiescent state", _path(parent, fp))
            continue
        if d >= max_depth:
            continue  # depth bound: checked but not expanded
        for action in actions:
            n_transitions += 1
            try:
                nxt = model.apply(state, action)
            except Exception as e:  # noqa: BLE001 — an action crash IS a finding
                record(
                    "action-error",
                    f"{action!r} raised {type(e).__name__}: {e}",
                    _path(parent, fp) + (action,),
                )
                continue
            nfp = model.fingerprint(nxt)
            if nfp in parent:
                continue
            parent[nfp] = (fp, action)
            depth[nfp] = d + 1
            max_depth_reached = max(max_depth_reached, d + 1)
            for msg in model.invariants(nxt):
                record("invariant", msg, _path(parent, nfp))
            if len(parent) >= max_states:
                truncated_by = "max_states"
                queue.clear()
                break
            queue.append((nxt, nfp))

    return ExploreResult(
        violations=violations,
        n_states=len(parent),
        n_transitions=n_transitions,
        max_depth_reached=max_depth_reached,
        exhausted=truncated_by is None,
        truncated_by=truncated_by,
    )


def replay(model, script: Sequence[str]) -> Violation | None:
    """Re-execute ``script`` from a fresh initial state; return the first
    violation it produces (or None).  An action that is not enabled in the
    replayed state aborts the replay with ``None`` — shrinking uses this to
    reject candidate subsequences that break the action protocol."""
    state = model.initial()
    msgs = model.invariants(state)
    if msgs:
        return Violation(kind="invariant", message=msgs[0], script=(), depth=0)
    done: list[str] = []
    for action in script:
        if action not in model.actions(state):
            return None
        try:
            state = model.apply(state, action)
        except Exception as e:  # noqa: BLE001 — mirrors explore()
            return Violation(
                kind="action-error",
                message=f"{action!r} raised {type(e).__name__}: {e}",
                script=tuple(done) + (action,),
                depth=len(done) + 1,
            )
        done.append(action)
        msgs = model.invariants(state)
        if msgs:
            return Violation(kind="invariant", message=msgs[0], script=tuple(done), depth=len(done))
    if not model.actions(state) and not model.quiescent(state):
        return Violation(
            kind="deadlock",
            message="no enabled action in a non-quiescent state",
            script=tuple(done),
            depth=len(done),
        )
    return None


def shrink(model, script: tuple[str, ...], kind: str) -> tuple[str, ...]:
    """Greedy delta-shrink: drop one action at a time while a replay still
    reproduces a violation of the same ``kind``, to a fixed point.  BFS
    already yields depth-minimal paths, so this mostly strips actions that
    were on the shortest path for scheduling reasons, not causal ones."""
    current = tuple(script)
    changed = True
    while changed:
        changed = False
        for i in range(len(current)):
            candidate = current[:i] + current[i + 1 :]
            v = replay(model, candidate)
            if v is not None and v.kind == kind:
                current = candidate
                changed = True
                break
    return current
