"""The port's analysis targets (``repro_torch.analysis``: ``specs``, ``train``,
``serve``, ``kernels``, the fixtures and the CLI) on the CPU.

The ``specs`` audit is held to the JAX package's ``audit_arch`` dict for
dict (findings and metas equal) for every arch on every declared mesh.  The
reference's collective and Pallas audits fail under the installed JAX (its
shard_map equations carry no ``in_names``), so the ``train`` verdicts are
held to the ones ``tests/test_analysis.py`` documents: every combination
``HeteroStepConfig.validate`` admits is collective-uniform, and while mode
with per-microbatch FSDP is the deadlock class.  The kernel audit's
negative controls are the counterparts of the reference's Pallas ones.
Every comparison is exact.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro.analysis.specs_audit import DECLARED_MESHES as JAX_MESHES
from repro.analysis.specs_audit import audit_arch as jax_audit_arch
from repro_torch.analysis import cli, fixtures
from repro_torch.analysis import kernels as kaudit
from repro_torch.analysis.collectives import check_collective_uniformity
from repro_torch.analysis.findings import apply_pragmas, severity_counts
from repro_torch.analysis.recorder import Record
from repro_torch.analysis.specs_audit import DECLARED_MESHES, audit_arch, audit_leaves
from repro_torch.configs import list_archs
from repro_torch.launch.mesh import StandinMesh
from repro_torch.launch.specs import Leaf


def _errors(findings):
    return [f for f in findings if f.severity == "error" and not f.suppressed]


def _dicts(findings):
    return sorted((f.rule, f.severity, f.target, f.path, f.message) for f in findings)


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_name", sorted(JAX_MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_specs_audit_equals_the_reference(arch, mesh_name):
    """Findings and metas (partition, leaf counts, sharded counts,
    replicated bytes) equal the reference's, leaf names included."""
    want_f, want_m = jax_audit_arch(arch, mesh_name, JAX_MESHES[mesh_name])
    got_f, got_m = audit_arch(arch, mesh_name, DECLARED_MESHES[mesh_name])
    assert got_m == want_m
    assert _dicts(got_f) == _dicts(want_f)
    assert not _errors(got_f)


def test_specs_audit_flags_bad_axis_and_indivisible():
    """Negative control: a hand-broken spec trips the error rules."""
    mesh = StandinMesh((("data", 4), ("model", 2)))

    def audit(spec):
        return audit_leaves([Leaf(("params", "w"), (6, 8), torch.float32, spec)], mesh, "t", "params")[0]

    assert any(f.rule == "specs-bad-axis" for f in _errors(audit(("nope", None))))
    assert any(f.rule == "specs-indivisible" for f in _errors(audit(("data", None))))
    assert any(f.rule == "specs-axis-reuse" for f in _errors(audit(("model", "model"))))
    assert not _errors(audit((None, "model")))


def test_specs_replicated_large_judges_the_stacked_leaf():
    """A 32-layer stack of 1.5 MiB leaves is one 48 MiB reference leaf: it warns."""
    mesh = StandinMesh((("data", 16), ("model", 16)))
    leaf = Leaf(("params", "body", "layer0", "g"), (32, 3 * 2**18 // 2), torch.float32, (None, None))
    findings, meta = audit_leaves([leaf], mesh, "t", "params")
    assert [f.rule for f in findings] == ["specs-replicated-large"]
    assert meta["replicated_large_bytes"] == 48 * 2**20


# ---------------------------------------------------------------------------
# collective uniformity: the fixtures and every train combination
# ---------------------------------------------------------------------------


def test_deadlock_fixture_flagged_at_its_collective():
    findings, meta = check_collective_uniformity(fixtures.trace_deadlock_step(), "fixture")
    errs = _errors(findings)
    assert meta["verdict"] == "divergent" and meta["n_collectives"] == [1, 2, 3, 4]
    assert errs and errs[0].rule == "divergent-collective"
    assert errs[0].src.endswith("analysis/fixtures.py:" + errs[0].src.rsplit(":", 1)[1])
    assert "deadlock" in errs[0].message and errs[0].path.endswith(":all_reduce")


def test_clean_fixture_passes():
    findings, meta = check_collective_uniformity(fixtures.trace_clean_step(), "fixture")
    assert meta["verdict"] == "uniform" and not _errors(findings)
    assert [(c["op"], c["axis"], c["count"]) for c in meta["collectives"]] == [("all_reduce", "data", 1)]


def test_pragma_suppresses_fixture_finding():
    findings, _ = check_collective_uniformity(fixtures.trace_suppressed_step(), "fixture")
    findings = apply_pragmas(findings)
    assert findings and all(f.suppressed for f in findings if f.rule == "divergent-collective")
    counts = severity_counts(findings)
    assert counts["n_error"] == 0 and counts["n_suppressed"] >= 1


def test_divergent_branch_detection():
    """Ranks that run different collectives at the same point (a rank-varying branch)."""
    a = [Record("all_reduce", "data", (4,), "float32", 16, "x.py:1")]
    b = [Record("all_gather", "data", (4,), "float32", 16, "x.py:2")]
    findings, meta = check_collective_uniformity([a, b], "t")
    assert meta["verdict"] == "divergent" and [f.rule for f in findings] == ["divergent-branch"]
    same = [Record("all_reduce", "data", (4,), "float32", 16, "x.py:3")]
    assert check_collective_uniformity([a, same], "t")[1]["verdict"] == "uniform"  # the same op, other lines


@pytest.mark.parametrize("n_ranks", [0, 1])
def test_fewer_than_two_ranks_is_never_reported_uniform(n_ranks):
    """One rank's sequence, even one a deadlock would show on more, has nothing to be compared with."""
    traces = fixtures.trace_deadlock_step()[-1:] if n_ranks else []
    findings, meta = check_collective_uniformity(traces, "t")
    assert meta["verdict"] == "not checked" and meta["n_ranks"] == n_ranks and not findings


@pytest.mark.parametrize("mode,fsdp,collective", cli.ALL_COMBOS)
def test_train_combo_verdict_agrees_with_validate(mode, fsdp, collective, monkeypatch):
    """Every combination ``validate`` admits runs collective-uniform on every
    rank of the (4, 1) mesh under divergent allocations, masked + fsdp=True
    too (its per-unit gathers and reduce-scatters run every slot on every
    rank); while + fsdp=True is refused as the deadlock class its fixture
    shows; masked + gather is refused at construction."""
    monkeypatch.setattr(cli, "ALL_COMBOS", ((mode, fsdp, collective),))
    findings, meta = cli.analyze_train()
    (m,) = meta.values()
    assert not _errors(findings)
    if mode == "masked" and fsdp == "gather":
        assert m["verdict"] == "not built" and m["validate"].startswith("rejected at construction")
    elif mode == "while" and fsdp is True:
        assert m["validate"].startswith("rejected") and "deadlock" in m["validate"]
        assert m["verdict"] == "divergent (the deadlock fixture)"
    elif fsdp is True:
        assert m["validate"] == "legal" and m["verdict"] == "uniform" and m["n_ranks"] == 4
        assert m["mesh"] == [4, 1] and len(set(m["n_collectives"])) == 1 and m["cost"]["flops"] > 0
        assert {c["op"] for c in m["collectives"]} >= {"all_gather", "reduce_scatter", "all_reduce"}
    else:
        assert m["validate"] == "legal" and m["verdict"] == "uniform"
        assert len(set(m["n_collectives"])) == 1 and m["cost"]["flops"] > 0
        assert m["mesh"] == [4, 1] and m["n_collectives"][0] > 0  # the gradient reduction
        if mode == "while" and fsdp == "gather":
            assert {c["op"] for c in m["collectives"]} >= {"all_gather" if collective == "psum" else "sendrecv"}


def test_serve_decode_is_collective_free_and_audits_the_paged_launch():
    findings, meta = cli.analyze_serve()
    assert not _errors(findings)
    assert all(m["verdict"] == "uniform" and m["n_collectives"] == [0, 0, 0, 0] for m in meta.values())
    assert meta["serve:decode-paged"]["kernel"]["grid"][0] > 0


def test_selftest_passes_on_the_healthy_checker():
    findings, meta = cli.selftest()
    assert not findings
    assert meta["deadlock_verdict"] == "divergent" and meta["clean_errors"] == 0 and meta["pragma_suppressed"] == 1


# ---------------------------------------------------------------------------
# the kernel audit
# ---------------------------------------------------------------------------


def test_oob_block_origin_flagged():
    """A toy launch whose blocks read one tile past the array (off by one)."""
    launch = kaudit.KernelLaunch("toy", (4, 1, 1), (128, 1, 1), 0, 0, {"x": (32,)},
                                 lambda idx: [("x", ((idx[0] + 1) * 8,))])
    findings, meta = kaudit.audit_launch(launch, "toy")
    errs = _errors(findings)
    assert [f.rule for f in errs] == ["kernel-oob-block"] and "outside [0, 32)" in errs[0].message
    assert meta["n_origin_evals"] == 4


def test_smem_budget_flagged():
    launch = kaudit.flash_launch(1, 128, 128, 2, 2, 256, "bfloat16")
    findings, _ = kaudit.audit_launch(launch, "flash", smem_budget=1024)
    assert any(f.rule == "kernel-smem-budget" for f in _errors(findings))
    findings, meta = kaudit.audit_launch(launch, "flash")  # the card's budget: fits
    assert not _errors(findings) and 0 < meta["shared_memory"] <= kaudit.SMEM_BUDGET


def _paged_case(n_pages=6, page_size=8, slots=3, B=2):
    live = np.arange(B * slots, dtype=np.int64).reshape(B, slots)
    return [slots * page_size] * B, live, page_size, n_pages


def test_paged_sentinel_intent_holds():
    """A live table never reads the scratch page; ids past the pool always do; dead ids read nothing."""
    lengths, live, page, n_pages = _paged_case()
    findings, meta = kaudit.audit_paged_sentinel(lengths, live, page, n_pages, 4, 2, 16, "paged")
    assert not _errors(findings), [f.message for f in findings]
    assert meta["live_reads"] > 0 and meta["past_pool_reads"] == meta["live_reads"] and meta["dead_reads"] == 0


def test_paged_sentinel_leak_detected():
    """A 'live' page table that names the scratch page is a leak."""
    lengths, live, page, n_pages = _paged_case()
    live[0, 0] = n_pages
    findings, _ = kaudit.audit_paged_sentinel(lengths, live, page, n_pages, 4, 2, 16, "paged")
    assert any(f.rule == "kernel-sentinel-leak" for f in _errors(findings))


def test_paged_sentinel_miss_detected():
    """Claiming the wrong reserved page makes the past-pool path a miss."""
    lengths, live, page, n_pages = _paged_case()
    findings, _ = kaudit.audit_paged_sentinel(lengths, live, page, n_pages, 4, 2, 16, "paged", reserved=2)
    errs = _errors(findings)
    assert any(f.rule == "kernel-sentinel-miss" for f in errs)
    # the page claimed as reserved is read by the live table: that reads as a leak too
    assert any(f.rule == "kernel-sentinel-leak" for f in errs)


@pytest.mark.parametrize("kernel", ["flash", "paged", "rwkv6", "weighted_accum"])
def test_real_launchers_pass_at_every_model_shape(kernel):
    cases = {k: v for k, v in kaudit.model_cases().items() if k.split()[0] == kernel}
    assert cases
    for label, launch in cases.items():
        findings, meta = kaudit.audit_launch(launch, label)
        assert not findings, (label, [f.message for f in findings])
        assert meta["n_origin_evals"] > 0


def test_launch_geometry_mirrors_the_launchers():
    """Spot values of the mirror against the launchers' arithmetic."""
    f = kaudit.flash_launch(1, 2048, 2048, 15, 5, 64, "bfloat16")
    assert f.geometry() == {"grid": [32, 15, 1], "block": [128, 1, 1], "shared_memory": 5 * 64 * 64 * 2 + 1024}
    f32 = kaudit.flash_launch(2, 100, 100, 4, 2, 64, "float32")
    assert f32.grid == (4, 8, 1) and (f32.smem_static, f32.smem_dynamic) == (2 * 64 * 64 * 4, 0)
    r = kaudit.rwkv_launch(1, 256, 32, 64, 32)
    assert r.grid == (128, 1, 1) and r.block == (256, 1, 1) and r.smem_dynamic == 78976
    (a,) = kaudit.accum_launches([4096 * 3, 10])
    assert a.grid == (2 + 1, 1, 1) and a.block == (256, 1, 1)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_targets_equal_the_references_and_the_stale_pragma_audit_runs_on_full_runs_only():
    assert cli.TARGETS == cli.REFERENCE_TARGETS == ("train", "serve", "kernels", "specs", "protocol")
    assert cli._pragma_scan_root(list(cli.TARGETS)) is not None
    for target in cli.TARGETS:
        assert cli._pragma_scan_root([target]) is None


def test_report_is_deterministic_and_partial_runs_skip_the_stale_pragma_audit(tmp_path):
    outs = []
    for i in range(2):
        path = tmp_path / f"r{i}.json"
        assert cli.main(["--target", "kernels", "--json-out", str(path)]) == 0
        outs.append(path.read_bytes())
    assert outs[0] == outs[1]
    report = json.loads(outs[0])
    assert report["summary"]["n_error"] == 0 and "kernels" in report["targets"]
    assert not any(f["rule"] == "stale-pragma" for f in report["findings"])


def test_full_run_finds_no_stale_pragma(monkeypatch):
    """The stale-pragma audit over ``src/repro_torch``: the fixture's waiver is
    consumed by the selftest, and no other waiver is in the tree (the long
    targets stubbed: the audit reads only what the selftest consumed)."""
    for name in ("analyze_train", "analyze_serve", "analyze_kernels", "analyze_specs", "analyze_protocol",
                 "selftest_protocol"):
        monkeypatch.setattr(cli, name, lambda *a, **k: ([], {}))
    report = cli.run(list(cli.TARGETS))
    assert not any(f["rule"] == "stale-pragma" for f in report["findings"])
    assert report["summary"]["n_error"] == 0
