"""``python -m repro_torch.analysis`` — run the port's static checks, emit the report.

Targets (the reference's five):

* ``train``  — run the smoke-scale train step of every (mode, fsdp,
  collective) combination that ``HeteroStepConfig.validate`` admits, each
  rank of a (4, 1) mesh in turn on meta tensors under a recording fake
  process group (``recorder``), and prove collective uniformity; the
  combinations ``validate`` refuses are checked against its verdict.
  Per-microbatch FSDP (masked, ``fsdp=True``) is traced on the same mesh,
  its gathers and reduce-scatters run from each unit's forward and
  backward, and must come out uniform as well.
* ``serve``  — decode steps (dense and paged cache) on every rank: the
  decode path is collective-free, hence uniform; the paged launch's
  geometry is audited.
* ``kernels`` — audit each CUDA kernel's launch at every shape the models
  run: block origins in bounds over the grid, the paged scratch-page
  sentinel, shared memory against sm_90's budget (``kernels``).
* ``specs``  — audit param/state/cache specs for every config in the
  registry against every declared mesh (``specs_audit``).
* ``protocol`` — bounded explicit-state model checking of the elastic
  membership protocol (FailureDetector/ElasticCoordinator/FaultInjector)
  and paged-KV admission (PagePool/Scheduler) over the port's own classes,
  exhaustively to the documented depth bounds; violations carry minimized
  replayable ``kind@step:spec`` counterexample scripts (``--cex-out``
  writes them).

Every invocation also runs a selftest: the known-deadlock fixture
(``fixtures.trace_deadlock_step``) must be flagged, the clean twin must
pass, and the pragma-waived twin must come back suppressed — a broken
analyzer is itself an error-severity finding.  The ``protocol`` target
checks itself against known-bad models (a rescale that remaps detector
state by position instead of survivor index; a retirement that drops the
page release; a delivery path that skips duplicate suppression): each must
yield a minimized counterexample that REPLAYS, or the run fails.  Exit
status is nonzero iff any unsuppressed error-severity finding exists.
Full-target runs also flag stale pragmas (waivers that suppressed
nothing).

The report is byte-deterministic (no timestamps, sorted findings, sorted
keys); CI runs this twice and byte-compares.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys

import torch

from repro_torch.analysis.collectives import check_collective_uniformity
from repro_torch.analysis.costmodel import estimate_cost
from repro_torch.analysis.findings import Finding, build_report, dump_report
from repro_torch.analysis.kernels import audit_launch, audit_paged_sentinel, model_cases, paged_launch
from repro_torch.analysis.recorder import trace_ranks
from repro_torch.analysis.specs_audit import audit_all_specs

TARGETS = ("train", "serve", "kernels", "specs", "protocol")
# the JAX package's targets: the stale-pragma audit needs every one of them
REFERENCE_TARGETS = ("train", "serve", "kernels", "specs", "protocol")

# the reference's legal smoke-scale combos (src/repro/analysis/cli.py); the
# train target takes every (mode, fsdp, collective) combination
TRAIN_COMBOS = (
    ("while", False, "psum"),
    ("while", False, "ring"),
    ("while", "gather", "psum"),
    ("while", "gather", "ring"),
    ("masked", False, "psum"),
    ("masked", True, "psum"),
)
ALL_COMBOS = tuple(itertools.product(("while", "masked"), (False, True, "gather"), ("psum", "ring")))

SMOKE_ARCH = "smollm-360m"
MESH = (4, 1)  # ("data", "model"): four allocation ranks
AXES = ("data", "model")
TRAIN_ALLOC = (3, 2, 2, 1)  # rank r trains on alloc[r] microbatches: divergent trip counts
META = torch.device("meta")

# documented exploration bounds: the clean models' FULL reachable graphs to
# these depths fit comfortably in the explorer's state ceiling, and every
# seeded bug class is found well inside them
PROTOCOL_DEPTHS = {"elastic": 7, "serve": 12, "serve-faults": 12}


def _smoke_cfg():
    from repro_torch.configs import smoke_config

    return smoke_config(SMOKE_ARCH, seq=32)


def _train_body(cfg, scfg, costs: list):
    """One rank's train step of ``scfg`` on meta tensors (this rank's shards where the state is sharded)."""
    from repro_torch.dist.hetero_step import build_train_step, shard_train_state
    from repro_torch.dist.sharding import param_specs
    from repro_torch.models import transformer
    from repro_torch.optim import AdamWConfig, adamw_init

    def body(mesh):
        sizes = {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}
        params = transformer.Transformer(cfg, META).requires_grad_(True)
        state = {"params": params, "opt": adamw_init(list(params.parameters()), AdamWConfig()),
                 "step": torch.zeros((), dtype=torch.int32, device=META)}
        if scfg.fsdp in ("gather", True):
            shard_train_state(state, param_specs(params, sizes, cfg, fsdp=True, fsdp_axes=scfg.fsdp_axes), mesh)
        R = sizes[scfg.alloc_axis]
        x = torch.empty((R, scfg.w_max, scfg.micro_bs, scfg.seq_len), dtype=torch.int32, device=META)
        batch = {"inputs": x, "targets": x, "alloc": list(TRAIN_ALLOC)}
        step = build_train_step(cfg, scfg, opt_cfg=AdamWConfig(), mesh=mesh)
        est = estimate_cost(step, state, batch)
        costs.append({"flops": est["flops"], "bytes": est["bytes"]})

    return body


def analyze_train() -> tuple[list[Finding], dict]:
    """Every (mode, fsdp, collective) combination: built and run on each rank
    where ``validate`` admits it, its verdict held to ``validate``'s otherwise."""
    from repro_torch.analysis import fixtures
    from repro_torch.dist.hetero_step import HeteroStepConfig

    cfg = _smoke_cfg()
    findings: list[Finding] = []
    meta: dict = {}
    for mode, fsdp, collective in ALL_COMBOS:
        name = f"train:{mode}-fsdp={fsdp}-{collective}"
        kw = dict(w_max=3, micro_bs=2, seq_len=32, mode=mode, alloc_axis="data", fsdp=fsdp, fsdp_axes=("data",),
                  collective=collective)
        try:
            scfg = HeteroStepConfig(**kw)
        except ValueError as e:  # masked + gather: gather mode only pairs with while-mode loops
            meta[name] = {"validate": f"rejected at construction: {e}", "verdict": "not built",
                          "reference_combo": (mode, fsdp, collective) in TRAIN_COMBOS}
            continue
        try:
            scfg.validate(AXES)
        except ValueError as e:  # while + per-microbatch FSDP: the deadlock class
            f, m = check_collective_uniformity(fixtures.trace_deadlock_step(), name)
            if m["verdict"] != "divergent":
                findings.append(Finding(
                    rule="analysis-selftest", severity="error", target=name, path="",
                    message="validate() refuses this combination as a deadlock, but the deadlock fixture "
                            "of its class is not flagged",
                ))
            meta[name] = {"validate": f"rejected: {e}", "verdict": f"{m['verdict']} (the deadlock fixture)",
                          "reference_combo": (mode, fsdp, collective) in TRAIN_COMBOS}
            continue
        costs: list = []
        f, m = check_collective_uniformity(trace_ranks(_train_body(cfg, scfg, costs), MESH, AXES), name)
        findings.extend(f)
        m.update(validate="legal", mesh=list(MESH), alloc=list(TRAIN_ALLOC), cost=costs[0],
                 reference_combo=(mode, fsdp, collective) in TRAIN_COMBOS)
        meta[name] = m
    return findings, meta


def analyze_serve() -> tuple[list[Finding], dict]:
    """Decode steps on a dense and a paged cache, each rank's rows in turn."""
    from repro_torch.models import transformer
    from repro_torch.models.attention import PagedLayout

    cfg = _smoke_cfg()
    findings: list[Finding] = []
    meta: dict = {}
    B, S = 4, 64
    layout = PagedLayout(page_size=8, n_pages=16, pages_per_slot=8)
    for vname, paged in (("dense", None), ("paged", layout)):
        name = f"serve:decode-{vname}"
        costs: list = []

        def body(mesh, paged=paged, costs=costs):
            rows = B // mesh.size(0)
            params = transformer.Transformer(cfg, META)
            cache = transformer.init_cache(cfg, rows, S, paged=paged, device=META)
            toks = torch.empty((rows,), dtype=torch.int32, device=META)
            est = estimate_cost(transformer.decode_step, params, cache, toks, cfg)
            costs.append({"flops": est["flops"], "bytes": est["bytes"]})

        f, m = check_collective_uniformity(trace_ranks(body, MESH, AXES), name)
        findings.extend(f)
        m["cost"] = costs[0]
        if paged is not None:  # the decode's paged launch: every slot's table full
            rows = B // MESH[0]
            table = [[r * layout.pages_per_slot + j for j in range(layout.pages_per_slot)] for r in range(rows)]
            kf, km = audit_launch(paged_launch([S] * rows, table, rows * layout.pages_per_slot + 1,
                                               layout.page_size, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 4),
                                  name)
            findings.extend(kf)
            m["kernel"] = km
        meta[name] = m
    return findings, meta


def analyze_kernels() -> tuple[list[Finding], dict]:
    """Every kernel launch shape the models run, and the paged scratch page's intent."""
    findings: list[Finding] = []
    meta: dict = {}
    for label, launch in sorted(model_cases().items()):
        f, m = audit_launch(launch, f"kernels:{label}")
        findings.extend(f)
        meta[label] = m
    # the reference's sentinel case (6 pages of 8, 3 slots of 2 rows), and smollm's heads at page 16
    for label, (n_pages, page, slots, B, H, Hkv, Dh) in {
        "reference": (6, 8, 3, 2, 4, 2, 16), "smollm-360m": (20, 16, 10, 2, 15, 5, 64),
    }.items():
        live = [[b * slots + j for j in range(slots)] for b in range(B)]
        f, m = audit_paged_sentinel([slots * page] * B, live, page, n_pages, H, Hkv, Dh,
                                    f"kernels:paged sentinel {label}")
        findings.extend(f)
        meta[f"paged sentinel {label}"] = m
    return findings, meta


def analyze_specs() -> tuple[list[Finding], dict]:
    return audit_all_specs()


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


def selftest(used_pragmas: set | None = None) -> tuple[list[Finding], dict]:
    """Prove the checker catches the deadlock class it exists for.  The
    fixtures' own findings never enter the report — only meta-findings about
    whether detection worked."""
    from repro_torch.analysis import fixtures
    from repro_torch.analysis.findings import apply_pragmas

    findings: list[Finding] = []
    bad, bad_meta = check_collective_uniformity(fixtures.trace_deadlock_step(), "selftest:deadlock")
    flagged = [f for f in bad if f.rule == "divergent-collective" and f.severity == "error"]
    if not flagged:
        findings.append(Finding(
            rule="analysis-selftest", severity="error", target="selftest:deadlock", path="",
            message=("the known-deadlock fixture (all_reduce inside a loop of rank-varying trip count) was "
                     "NOT flagged — the checker is broken"),
        ))
    clean, _ = check_collective_uniformity(fixtures.trace_clean_step(), "selftest:clean")
    if any(f.severity == "error" for f in clean):
        findings.append(Finding(
            rule="analysis-selftest", severity="error", target="selftest:clean", path="",
            message="the known-good fixture (collective hoisted out of the loop) was flagged",
        ))
    supp, _ = check_collective_uniformity(fixtures.trace_suppressed_step(), "selftest:suppressed")
    supp = apply_pragmas(supp, used=used_pragmas)
    if not any(f.suppressed for f in supp):
        findings.append(Finding(
            rule="analysis-selftest", severity="error", target="selftest:suppressed", path="",
            message="the '# analysis: ignore[...]' pragma did not suppress the fixture finding",
        ))
    meta = {
        "deadlock_flagged_at": sorted(f.path for f in flagged),
        "deadlock_verdict": bad_meta["verdict"],
        "clean_errors": sum(1 for f in clean if f.severity == "error"),
        "pragma_suppressed": sum(1 for f in supp if f.suppressed),
    }
    return findings, meta


def run(targets: list[str]) -> dict:
    findings: list[Finding] = []
    metas: dict = {"mesh": dict(zip(AXES, MESH))}
    used_pragmas: set = set()
    f, m = selftest(used_pragmas=used_pragmas)
    findings += f
    metas["selftest"] = m
    for name, analyze in (("train", analyze_train), ("serve", analyze_serve),
                          ("kernels", analyze_kernels), ("specs", analyze_specs)):
        if name in targets:
            f, m = analyze()
            findings += f
            metas[name] = m
    if "protocol" in targets:
        f, m = analyze_protocol()
        findings += f
        metas["protocol"] = m
        f, m = selftest_protocol()
        findings += f
        metas["selftest_protocol"] = m
    return build_report(findings, metas, used_pragmas=used_pragmas, pragma_scan_root=_pragma_scan_root(targets))


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
