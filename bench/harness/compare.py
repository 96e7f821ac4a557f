"""The numbers that decide ``correct``, each against its limit.

Training (the first ``compare_steps`` steps, program against reference):

* ``loss_gap``: the largest ``|loss - loss_ref| / |loss_ref|`` over the steps;
* ``grad_gap``: over the leaves, the largest gap between the norms of the
  first step's gradient (the program's worked out from AdamW's first moment,
  ``mu / (1 - b1)``), over the larger of the reference leaf's norm and the
  median leaf's;
* ``change_gap``: the same of each leaf's change over the compared steps,
  leaving out the leaves whose reference gradient is under a thousandth of
  the median leaf's (round-off alone moves them under AdamW).

Serving: ``logit_gap``, the widest gap by which a served token's reference
logit lies below the reference's best at its position.

A limits file (``limits/<workload>.json``) gives each number that is
compared its limit and the readings it was set from; a number with no upper
reading (no control or fault that reads far enough above the program) is
reported and not compared.
"""

from __future__ import annotations

import json
import statistics
from pathlib import Path

SILENT_LEAF = 1e-3  # a leaf's reference gradient under this share of the median leaf's is left out of change_gap


def _rel_worst(prog: dict, ref: dict, names) -> tuple[float, str]:
    med = statistics.median(ref[n] for n in names)
    worst, at = 0.0, ""
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        if gap > worst:
            worst, at = gap, n
    return worst, at


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog``/``ref``: {"losses": [...], "first": {leaf: norm}, "change": {leaf: norm}}."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"], strict=True))
    grad_gap, grad_at = _rel_worst(prog["first"], ref["first"], list(ref["first"]))
    med = statistics.median(ref["first"].values())
    moved = [n for n, g in ref["first"].items() if g >= SILENT_LEAF * med]
    change_gap, change_at = _rel_worst(prog["change"], ref["change"], moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "_at": {"grad_gap": grad_at, "change_gap": change_at}, "_left_out": len(ref["first"]) - len(moved)}


def limits(root: Path, workload: str) -> dict:
    path = root / "bench" / "limits" / f"{workload}.json"
    return json.loads(path.read_text()) if path.exists() else {}


def judge(values: dict, lim: dict) -> tuple[bool, dict]:
    """(every number the limits file names within its limit, {name: {"value",
    "limit"}}).  A number the file names and the run lacks fails; a number the
    file leaves out (it has no upper reading, PERF.md) is reported, not judged."""
    checks, ok = {}, bool(lim)
    for name, entry in lim.items():
        v = values.get(name, float("nan"))
        checks[name] = {"value": v, "limit": entry["limit"]}
        ok = ok and v == v and v <= entry["limit"]
    return ok, checks
