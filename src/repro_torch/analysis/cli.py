"""``python -m repro_torch.analysis`` — run the port's static checks, emit the report.

Targets:

* ``protocol`` — bounded explicit-state model checking of the elastic
  membership protocol (FailureDetector/ElasticCoordinator/FaultInjector)
  and paged-KV admission (PagePool/Scheduler) over the port's own classes,
  exhaustively to the documented depth bounds; violations carry minimized
  replayable ``kind@step:spec`` counterexample scripts (``--cex-out``
  writes them).

The JAX package's CLI also has ``train``, ``serve``, ``kernels`` and
``specs`` (jaxpr collective uniformity, the Pallas BlockSpec audits, the
PartitionSpec audit) and a collective-deadlock selftest over traced
fixtures; they trace JAX programs and have no counterpart here yet, so
``all`` means the targets this CLI has.  The ``protocol`` target checks
itself against known-bad models (a rescale that remaps detector state by
position instead of survivor index; a retirement that drops the page
release; a delivery path that skips duplicate suppression): each must
yield a minimized counterexample that REPLAYS, or the run fails.  Exit
status is nonzero iff any unsuppressed error-severity finding exists.

The stale-pragma audit (waivers that suppressed nothing) runs only when
every target of the JAX package's CLI ran (``REFERENCE_TARGETS``), since a
partial run never generates the findings a waiver exists for; with
``protocol`` alone it does not run yet.

The report is byte-deterministic (no timestamps, sorted findings, sorted
keys); CI runs this twice and byte-compares.
"""

from __future__ import annotations

import argparse
import os
import sys

from repro_torch.analysis.findings import Finding, build_report, dump_report

TARGETS = ("protocol",)
# the JAX package's targets: the stale-pragma audit needs every one of them
REFERENCE_TARGETS = ("train", "serve", "kernels", "specs", "protocol")

# documented exploration bounds: the clean models' FULL reachable graphs to
# these depths fit comfortably in the explorer's state ceiling, and every
# seeded bug class is found well inside them
PROTOCOL_DEPTHS = {"elastic": 7, "serve": 12, "serve-faults": 12}


def analyze_protocol() -> tuple[list[Finding], dict]:
    """Model-check the two protocol harnesses over the real classes."""
    from repro_torch.analysis.protocol import (
        ElasticModel,
        ServeFaultModel,
        ServeModel,
        explore,
        format_script,
    )

    models = {
        "elastic": (ElasticModel(), PROTOCOL_DEPTHS["elastic"]),
        "serve": (ServeModel(), PROTOCOL_DEPTHS["serve"]),
        "serve-faults": (ServeFaultModel(), PROTOCOL_DEPTHS["serve-faults"]),
    }
    findings: list[Finding] = []
    meta: dict = {}
    for name, (model, depth) in models.items():
        target = f"protocol:{name}"
        res = explore(model, max_depth=depth)
        for v in res.violations:
            findings.append(
                Finding(
                    rule=f"protocol-{v.kind}",  # -invariant | -deadlock | -action-error
                    severity="error",
                    target=target,
                    path=format_script(v.script),
                    message=f"{v.message} [replay script: {format_script(v.script) or '<initial state>'}]",
                )
            )
        if not res.exhausted:
            findings.append(
                Finding(
                    rule="protocol-truncated",
                    severity="warning",
                    target=target,
                    path="",
                    message=(
                        f"exploration truncated by {res.truncated_by} — coverage below "
                        f"the documented depth bound ({depth}); shrink the model or "
                        "raise the ceiling"
                    ),
                )
            )
        meta[name] = dict(res.stats(), max_depth=depth)
    return findings, meta


def selftest_protocol() -> tuple[list[Finding], dict]:
    """Prove the model checker catches the bug classes it exists for, and
    that its counterexamples replay.  Known-bad models: a rescale that
    remaps detector state by position instead of survivor index, and a
    retirement that forgets the page release, and a delivery path that skips
    duplicate suppression (hedged completions delivered twice)."""
    from repro_torch.analysis.protocol import (
        ElasticModel,
        ServeFaultModel,
        ServeModel,
        explore,
        format_script,
        parse_script,
        replay,
    )

    cases = {
        "elastic-remap-identity": (lambda: ElasticModel(buggy="remap-identity"), 6),
        "serve-drop-release": (lambda: ServeModel(buggy="drop-release"), 8),
        "serve-faults-double-deliver": (lambda: ServeFaultModel(buggy="double-deliver"), 6),
    }
    findings: list[Finding] = []
    meta: dict = {}
    for name, (make, depth) in cases.items():
        res = explore(make(), max_depth=depth, max_violations=1)
        script, replayed = "", False
        if res.violations:
            v = res.violations[0]
            script = format_script(v.script)
            rv = replay(make(), parse_script(script))
            replayed = rv is not None and rv.kind == v.kind
        if not replayed:
            findings.append(
                Finding(
                    rule="analysis-selftest",
                    severity="error",
                    target=f"selftest:protocol-{name}",
                    path="",
                    message=(
                        f"known-bad model {name!r} did not produce a minimized "
                        "REPLAYABLE counterexample — the protocol checker is broken"
                    ),
                )
            )
        meta[name] = {"counterexample": script, "replayed": replayed, "n_states": res.n_states}
    return findings, meta


def run(targets: list[str]) -> dict:
    findings: list[Finding] = []
    metas: dict = {}
    if "protocol" in targets:
        f, m = analyze_protocol()
        findings += f
        metas["protocol"] = m
        f, m = selftest_protocol()
        findings += f
        metas["selftest_protocol"] = m
    return build_report(findings, metas, pragma_scan_root=_pragma_scan_root(targets))


def _pragma_scan_root(targets) -> str | None:
    """Stale-pragma audit root — only for runs of every reference target: a
    partial run never generates the findings a waiver exists for, so every
    waiver would look stale."""
    if not set(REFERENCE_TARGETS).issubset(targets):
        return None
    import repro_torch

    return list(repro_torch.__path__)[0]


def write_counterexamples(report: dict, out_dir: str) -> None:
    """One replayable script file per protocol violation (CI uploads these
    as artifacts when the analysis lane fails)."""
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for f in report["findings"]:
        if not f["rule"].startswith("protocol-") or not f["path"]:
            continue
        n += 1
        name = f"{f['target'].replace(':', '-')}-{n:02d}.txt"
        with open(os.path.join(out_dir, name), "w") as fh:
            fh.write(f"# {f['rule']} in {f['target']}\n# {f['message']}\n{f['path']}\n")
    for name, m in report["targets"].get("selftest_protocol", {}).items():
        if m.get("counterexample"):
            with open(os.path.join(out_dir, f"selftest-{name}.txt"), "w") as fh:
                fh.write(f"# selftest counterexample (replayed={m['replayed']})\n{m['counterexample']}\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.analysis", description=__doc__)
    ap.add_argument("--target", default="all", choices=TARGETS + ("all",))
    ap.add_argument("--json-out", default=None, help="write the findings report here")
    ap.add_argument(
        "--cex-out",
        default=None,
        help="directory for protocol counterexample scripts (one .txt per violation)",
    )
    args = ap.parse_args(argv)
    targets = list(TARGETS) if args.target == "all" else [args.target]

    report = run(targets)
    if args.json_out:
        dump_report(report, args.json_out)
    if args.cex_out:
        write_counterexamples(report, args.cex_out)

    s = report["summary"]
    print(
        f"repro_torch.analysis [{' '.join(targets)}]: "
        f"{s['n_error']} errors, {s['n_warning']} warnings, {s['n_note']} notes, "
        f"{s['n_suppressed']} suppressed"
    )
    for f in report["findings"]:
        if f["suppressed"]:
            continue
        loc = f" ({f['src']})" if f["src"] else ""
        print(f"  [{f['severity']:7s}] {f['rule']:24s} {f['target']} {f['path']}{loc}")
        if f["severity"] == "error":
            print(f"            {f['message']}")
    if args.json_out:
        print(f"report -> {args.json_out}")
    if s["n_error"]:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
