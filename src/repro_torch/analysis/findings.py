"""Finding model + deterministic report assembly for ``repro_torch.analysis``
(a copy of the JAX package's ``analysis/findings.py``, which imports no JAX).

A finding is one (rule, severity, location) fact the analyzers proved about
a traced program or a spec table.  Reports must be *byte-deterministic*:
no timestamps, no ids, findings fully sorted, ``json.dump(sort_keys=True)``
— CI runs the CLI twice and byte-compares the artifacts.

Suppression: a finding anchored to a source line (``src = "file.py:123"``)
is suppressed when that line carries an inline pragma

    some_collective(...)  # analysis: ignore[divergent-collective]

Suppressed findings stay in the report (``suppressed: true``) but do not
count toward the error total that drives the CLI exit code.
"""

from __future__ import annotations

import dataclasses
import json
import linecache
import os
import re
import tokenize
from typing import Any, Iterable

__all__ = [
    "Finding",
    "apply_pragmas",
    "build_report",
    "scan_pragmas",
    "severity_counts",
    "stale_pragma_findings",
]

SEVERITIES = ("error", "warning", "note")
_SEV_RANK = {s: i for i, s in enumerate(SEVERITIES)}
_PRAGMA_RE = re.compile(r"#\s*analysis:\s*ignore\[([\w\-, ]+)\]")


@dataclasses.dataclass
class Finding:
    rule: str  # kebab-case rule id, e.g. "divergent-collective"
    severity: str  # "error" | "warning" | "note"
    target: str  # analyzed unit, e.g. "train:while-fsdp=gather-psum"
    path: str  # eqn path / tree path inside the target
    message: str
    src: str = ""  # "file.py:123" of the offending eqn, when known
    suppressed: bool = False

    def __post_init__(self) -> None:
        if self.severity not in SEVERITIES:
            raise ValueError(f"bad severity {self.severity!r}")

    def sort_key(self) -> tuple:
        return (_SEV_RANK[self.severity], self.rule, self.target, self.path, self.message)

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "target": self.target,
            "path": self.path,
            "message": self.message,
            "src": self.src,
            "suppressed": self.suppressed,
        }


def _relpath(path: str) -> str:
    try:
        rel = os.path.relpath(path)
    except ValueError:  # different drive (windows)
        return path
    return path if rel.startswith("..") else rel


def src_of(file_name: str | None, line: int | None) -> str:
    if not file_name or not line:
        return ""
    return f"{_relpath(file_name)}:{line}"


def apply_pragmas(findings: Iterable[Finding], used: set | None = None) -> list[Finding]:
    """Mark findings whose source line carries ``# analysis: ignore[rule]``.

    ``used`` (optional) accumulates ``(relpath, lineno, rule)`` for every
    pragma that actually suppressed something — the stale-pragma audit
    (:func:`stale_pragma_findings`) diffs the tree's pragmas against it.
    """
    out = []
    for f in findings:
        if f.src:
            fname, _, lineno = f.src.rpartition(":")
            line = linecache.getline(fname, int(lineno)) if lineno.isdigit() else ""
            m = _PRAGMA_RE.search(line)
            if m and f.rule in {r.strip() for r in m.group(1).split(",")}:
                f = dataclasses.replace(f, suppressed=True)
                if used is not None:
                    used.add((_relpath(fname), int(lineno), f.rule))
        out.append(f)
    return out


def scan_pragmas(root: str) -> list[tuple[str, int, str]]:
    """Every ``# analysis: ignore[rule]`` site under ``root``: sorted
    ``(relpath, lineno, rule)`` triples, one per waived rule.

    Only genuine ``#`` comment tokens count — pragma *examples* inside
    docstrings (this module has several) are string content, not waivers,
    and must not show up as stale.
    """
    sites = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if not d.startswith((".", "_")))
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            try:
                with open(path, encoding="utf-8") as fh:
                    toks = list(tokenize.generate_tokens(fh.readline))
            except (OSError, SyntaxError, tokenize.TokenError):
                continue
            for tok in toks:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _PRAGMA_RE.search(tok.string)
                if m:
                    for rule in m.group(1).split(","):
                        sites.append((_relpath(path), tok.start[0], rule.strip()))
    return sorted(sites)


def stale_pragma_findings(used: set, root: str) -> list[Finding]:
    """Warning findings for waivers that suppressed nothing this run.

    A pragma whose rule no longer fires is debt: either the underlying
    issue was fixed (drop the waiver) or the rule name rotted (the waiver
    silently stopped guarding anything).  Only meaningful when EVERY
    analyzer that could produce the waived finding actually ran — the CLI
    gates this on a full-target invocation.
    """
    out = []
    for fname, lineno, rule in scan_pragmas(root):
        if (fname, lineno, rule) not in used:
            out.append(
                Finding(
                    rule="stale-pragma",
                    severity="warning",
                    target="pragmas",
                    path=f"{fname}:{lineno}",
                    message=(
                        f"'# analysis: ignore[{rule}]' suppressed nothing this run — "
                        "the waived finding no longer fires; remove the pragma or fix "
                        "the rule name"
                    ),
                    src=f"{fname}:{lineno}",
                )
            )
    return out


def severity_counts(findings: Iterable[Finding]) -> dict:
    counts = {"n_error": 0, "n_warning": 0, "n_note": 0, "n_suppressed": 0}
    by_rule: dict[str, int] = {}
    by_pragma: dict[str, int] = {}
    for f in findings:
        if f.suppressed:
            counts["n_suppressed"] += 1
            key = f"{f.src}[{f.rule}]"  # one pragma site may waive several rules
            by_pragma[key] = by_pragma.get(key, 0) + 1
        else:
            counts[f"n_{f.severity}"] += 1
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    counts["by_rule"] = dict(sorted(by_rule.items()))
    counts["by_pragma"] = dict(sorted(by_pragma.items()))
    return counts


def build_report(
    findings: list[Finding],
    targets: dict[str, Any],
    *,
    used_pragmas: set | None = None,
    pragma_scan_root: str | None = None,
) -> dict:
    """Assemble the byte-deterministic report.  ``used_pragmas`` carries
    suppression sites already consumed outside the report's own findings
    (the selftest's fixture pragma); ``pragma_scan_root`` (full runs only)
    turns unconsumed waivers under that tree into stale-pragma warnings."""
    used = set() if used_pragmas is None else used_pragmas
    findings = apply_pragmas(findings, used=used)
    if pragma_scan_root is not None:
        findings = findings + stale_pragma_findings(used, pragma_scan_root)
    findings = sorted(findings, key=Finding.sort_key)
    return {
        "report": "analysis",
        "version": 1,
        "targets": {k: targets[k] for k in sorted(targets)},
        "findings": [f.to_dict() for f in findings],
        "summary": dict(severity_counts(findings), targets_run=sorted(targets)),
    }


def dump_report(report: dict, path: str) -> None:
    """Byte-deterministic serialization (matches the CI byte-compare gate)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as fh:
        json.dump(report, fh, indent=1, sort_keys=True)
        fh.write("\n")
