"""SPMD collective-uniformity checker over per-rank collective traces.

The port of ``repro.analysis.collectives``.  The invariant it proves is the
one ``HeteroStepConfig.validate`` encodes by hand: *every rank runs the
identical sequence of collectives*, even when per-rank trip counts diverge.
A collective inside a loop whose trip count differs across ranks (the
while-mode FSDP deadlock class) hangs real hardware: small-allocation ranks
leave the loop while big ranks still wait on them.

The reference proves it statically with a rank-variance taint analysis of
the jaxpr.  The port's step runs eagerly, so the checker compares the
ranks' recorded sequences (``recorder.trace_ranks``) instead: ranks that
differ in count, order, op, axis, shape or dtype give an ``error`` at the
first point where they differ, naming the source line of the unmatched
collective:

* ``divergent-collective`` — one rank runs more of a collective at the same
  source line than another (a loop whose trip count is rank-varying), or
  the same line with another shape;
* ``divergent-branch`` — at the same point the ranks run collectives from
  different source lines (rank-varying branches with different footprints).

``meta["verdict"]`` is ``"uniform"`` when no error was found among two
ranks or more, and ``"not checked"`` for fewer: one rank's sequence has
nothing to be compared with, so it proves nothing.
"""

from __future__ import annotations

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.recorder import Record

__all__ = ["check_collective_uniformity", "summarize"]


def summarize(records: list[Record]) -> list[dict]:
    """Consecutive-run counts of one rank's sequence: ``[{"op", "axis", "shape",
    "dtype", "src", "count", "bytes"}]``, in order."""
    out: list[dict] = []
    for r in records:
        last = out[-1] if out else None
        if last and (last["op"], last["axis"], tuple(last["shape"]), last["dtype"], last["src"]) == (
                r.op, r.axis, r.shape, r.dtype, r.src):
            last["count"] += 1
            last["bytes"] += r.nbytes
        else:
            out.append({"op": r.op, "axis": r.axis, "shape": list(r.shape), "dtype": r.dtype, "src": r.src,
                        "count": 1, "bytes": r.nbytes})
    return out


def _first_difference(a: list[Record], b: list[Record]) -> int | None:
    for i, (x, y) in enumerate(zip(a, b)):
        if x.key() != y.key():
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def check_collective_uniformity(traces: list[list[Record]], target: str) -> tuple[list[Finding], dict]:
    """Compare every rank's sequence with rank 0's; returns ``(findings, meta)``."""
    findings: list[Finding] = []
    seen: set = set()
    base = traces[0] if traces else []
    for rank, seq in enumerate(traces[1:], start=1):
        i = _first_difference(base, seq)
        if i is None:
            continue
        mine = seq[i] if i < len(seq) else None
        theirs = base[i] if i < len(base) else None
        hit = mine or theirs
        other = theirs if hit is mine else mine
        same_line = other is None or other.src == hit.src
        rule = "divergent-collective" if same_line else "divergent-branch"
        if (rule, hit.src) in seen:
            continue
        seen.add((rule, hit.src))
        findings.append(Finding(
            rule=rule, severity="error", target=target, path=f"rank{rank}/{i}:{hit.op}",
            message=(
                f"rank {rank} runs {len(seq)} collectives and rank 0 {len(base)}; at call {i} "
                f"{'rank 0' if hit is theirs else f'rank {rank}'} runs {hit.op} over {hit.axis!r} "
                f"{list(hit.shape)} at {hit.src or '?'}"
                + ("" if other is None else f" where the other runs {other.op} over {other.axis!r} "
                   f"{list(other.shape)} at {other.src or '?'}")
                + " — ranks would run different collective sequences and deadlock (the while-mode "
                "FSDP class HeteroStepConfig.validate guards)"
            ),
            src=hit.src,
        ))
    meta = {
        "verdict": "divergent" if findings else "uniform" if len(traces) > 1 else "not checked",
        "n_ranks": len(traces),
        "n_collectives": [len(seq) for seq in traces],
        "collectives": summarize(base),
    }
    return findings, meta
