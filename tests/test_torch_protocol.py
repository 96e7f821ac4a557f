"""The port's protocol model checker (``repro_torch.analysis``) against the
JAX package's (``repro.analysis``): the explorer, the script grammar, the
elastic and serve models over the port's own classes with their buggy
variants, the CLI's report, and the engine twin held to real paged
``ServeEngine`` instances of smoke smollm on the CPU."""

from __future__ import annotations

import dataclasses
import functools
import json
import random

import numpy as np
import pytest
from repro_torch.analysis.protocol import (
    ElasticModel,
    ServeFaultModel,
    ServeModel,
    engine_kwargs,
    explore,
    format_script,
    leaf_scripts,
    parse_script,
    replay,
    replay_on_engines,
    shrink,
    solo_tokens,
)
from repro_torch.analysis.protocol.explorer import Violation

# the JAX package's report (its CLI's protocol target, run on the CPU): states, transitions, depth reached
REFERENCE_COUNTS = {"elastic": (11144, 44305, 7), "serve": (498, 1387, 10), "serve-faults": (3810, 9588, 12)}
# the port's: the serve model's twin ensures every slot's page before a tick's retirements, as the engine does
PORT_COUNTS = {"elastic": (11144, 44305, 7), "serve": (518, 1421, 11), "serve-faults": (3810, 9588, 12)}
SELFTEST_SCRIPTS = {
    "elastic-remap-identity": "hb@0:1,outage@1:0+2,tick@2,hb@3:1,tick@4",
    "serve-drop-release": "submit@0:5x1,admit@1",
    "serve-faults-double-deliver": "submit@0:2x1,retry@1:0,hedge@2:1,admit@3:0,admit@4:1",
}


def _counts(meta: dict) -> dict:
    return {name: (m["n_states"], m["n_transitions"], m["max_depth_reached"]) for name, m in meta.items()}


# ---------------------------------------------------------------------------
# the generic explorer, on a toy counter model
# ---------------------------------------------------------------------------


class _Counter:
    """Toy model: inc/dec/noise on a counter, invariant n <= limit, optional
    trap state with no exits."""

    def __init__(self, limit=3, trap_at=None):
        self.limit = limit
        self.trap_at = trap_at

    def initial(self):
        return {"n": 0, "noise": 0}

    def actions(self, s):
        if self.trap_at is not None and s["n"] == self.trap_at:
            return []
        acts = ["inc", "noise"]
        if s["n"] > 0:
            acts.append("dec")
        return sorted(acts)

    def apply(self, s, a):
        s = dict(s)
        if a == "inc":
            s["n"] += 1
        elif a == "dec":
            s["n"] -= 1
        elif a == "noise":
            s["noise"] = (s["noise"] + 1) % 2
        return s

    def fingerprint(self, s):
        return (s["n"], s["noise"])

    def invariants(self, s):
        return [f"counter exceeded limit: {s['n']} > {self.limit}"] if s["n"] > self.limit else []

    def quiescent(self, s):
        return False


def test_explorer_finds_shortest_and_shrinks():
    res = explore(_Counter(limit=3), max_depth=10, max_violations=1)
    v = res.violations[0]
    assert v.kind == "invariant"
    assert v.script == ("inc", "inc", "inc", "inc") and v.depth == 4


def test_explorer_detects_deadlock():
    res = explore(_Counter(limit=99, trap_at=2), max_depth=10, max_violations=1)
    assert res.violations[0].kind == "deadlock"
    assert res.violations[0].script == ("inc", "inc")


def test_explorer_exhausts_bounded_model():
    res = explore(_Counter(limit=99), max_depth=5)
    assert res.exhausted and res.truncated_by is None
    assert res.n_states > 5 and res.max_depth_reached == 5
    assert not res.violations


def test_explorer_truncates_at_the_state_ceiling():
    res = explore(_Counter(limit=99), max_depth=50, max_states=7)
    assert not res.exhausted and res.truncated_by == "max_states" and res.n_states == 7


def test_explorer_action_error_is_a_finding():
    class Crasher(_Counter):
        def apply(self, s, a):
            if s["n"] == 2 and a == "inc":
                raise RuntimeError("boom")
            return super().apply(s, a)

    v = explore(Crasher(limit=99), max_depth=6, max_violations=1).violations[0]
    assert v.kind == "action-error" and "boom" in v.message
    assert v.script == ("inc", "inc", "inc")


def test_replay_reproduces_and_rejects_disabled_actions():
    m = _Counter(limit=3)
    assert replay(m, ("inc",) * 4).kind == "invariant"
    assert replay(m, ("inc",) * 3) is None
    assert replay(m, ("dec",)) is None


def test_shrink_drops_noncausal_actions():
    m = _Counter(limit=3)
    noisy = ("noise", "inc", "inc", "noise", "inc", "inc")
    assert replay(m, noisy) is not None
    assert shrink(m, noisy, "invariant") == ("inc", "inc", "inc", "inc")


def test_script_grammar_roundtrip_and_equals_the_reference():
    from repro.analysis.protocol import format_script as ref_format
    from repro.analysis.protocol import parse_script as ref_parse

    actions = ["hb:1", "outage:0+2", "tick", "slow:1*2", "add:v100", "ckpt", "resume", "submit:5x1", "retry:0"]
    script = format_script(actions)
    assert script == "hb@0:1,outage@1:0+2,tick@2,slow@3:1*2,add@4:v100,ckpt@5,resume@6,submit@7:5x1,retry@8:0"
    assert script == ref_format(actions)
    assert parse_script(script) == actions == ref_parse(script)
    assert parse_script("tick@1,hb@0:1") == ["hb:1", "tick"]
    with pytest.raises(ValueError):
        parse_script("not-a-term")


def test_violation_to_dict_is_json_shaped():
    v = Violation(kind="invariant", message="m", script=("a", "b"), depth=2)
    assert v.to_dict() == {"kind": "invariant", "message": "m", "script": ["a", "b"], "depth": 2}


# ---------------------------------------------------------------------------
# the three models: clean, buggy, pure
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "make, depth, min_states",
    [(ElasticModel, 5, 500), (ServeModel, 12, 300), (ServeFaultModel, 12, 1000)],
    ids=["elastic", "serve", "serve-faults"],
)
def test_clean_model_exhausts_with_zero_violations(make, depth, min_states):
    res = explore(make(), max_depth=depth)
    assert res.exhausted and not res.violations
    assert res.n_states > min_states and res.max_depth_reached <= depth


def test_serve_faults_full_graph_closes():
    res = explore(ServeFaultModel(), max_depth=40)
    assert res.exhausted and not res.violations
    assert res.max_depth_reached < 40


BUGGY = {
    "elastic-remap-identity": (functools.partial(ElasticModel, buggy="remap-identity"), ElasticModel, 6, ""),
    "elastic-skip-detector-remap": (
        functools.partial(ElasticModel, buggy="skip-detector-remap"), ElasticModel, 6, ""),
    "elastic-skip-injector-remap": (
        functools.partial(ElasticModel, buggy="skip-injector-remap"), ElasticModel, 6, ""),
    "serve-drop-release": (functools.partial(ServeModel, buggy="drop-release"), ServeModel, 8, "leak"),
    "serve-faults-double-deliver": (
        functools.partial(ServeFaultModel, buggy="double-deliver"), ServeFaultModel, 6, "completed twice"),
}


@pytest.mark.parametrize("name", list(BUGGY))
def test_buggy_variant_yields_a_replayable_counterexample_the_clean_model_passes(name):
    make, clean, depth, words = BUGGY[name]
    res = explore(make(), max_depth=depth, max_violations=1)
    assert res.violations, f"{name}: the checker missed the seeded bug"
    v = res.violations[0]
    assert words in v.message
    script = parse_script(format_script(v.script))
    rv = replay(make(), script)
    assert rv is not None and rv.kind == v.kind
    assert replay(clean(), script) is None


@pytest.mark.parametrize("name", ["elastic", "serve", "serve-faults"])
def test_apply_does_not_mutate_its_input_state(name):
    m = {"elastic": ElasticModel, "serve": ServeModel, "serve-faults": ServeFaultModel}[name]()
    s = m.initial()
    if name != "elastic":
        s = m.apply(s, "submit:1x3")
    fp = m.fingerprint(s)
    for a in m.actions(s):
        m.apply(s, a)
    assert m.fingerprint(s) == fp
    assert m.fingerprint(m.initial()) != fp or name == "elastic"


def test_elastic_remap_counterexample_is_minimal():
    make = functools.partial(ElasticModel, buggy="remap-identity")
    v = explore(make(), max_depth=6, max_violations=1).violations[0]
    kinds = {a.partition(":")[0] for a in v.script}
    assert "tick" in kinds and kinds & {"fail", "outage"}
    for i in range(len(v.script)):
        rv = replay(make(), v.script[:i] + v.script[i + 1:])
        assert rv is None or rv.kind != v.kind, "shrunk script is not 1-minimal"


def test_elastic_resume_reconverges():
    m = ElasticModel()
    s = m.initial()
    for a in ["ckpt", "hb:0", "hb:1", "fail:2", "tick", "hb:0", "hb:1", "tick"]:
        assert a in m.actions(s), f"{a} not enabled"
        s = m.apply(s, a)
    assert len(s.ids) == 2
    s = m.apply(s, "resume")
    assert s.ids == ["w0", "w1", "w2"] and sorted(s.up) == ["w0", "w1", "w2"]
    assert not m.invariants(s)
    assert s.fd.n_workers == s.ctl.config.n_workers == s.injector.n_workers == 3


def test_serve_backpressure_never_deadlocks_within_bound():
    res = explore(ServeModel(shapes=((3, 2), (5, 1), (1, 4)), submits=4, resets=0), max_depth=14)
    assert res.exhausted and not res.violations


def test_serve_eos_retires_early_and_frees_pages():
    m = ServeModel()
    s = m.initial()
    for a in ["submit:1x3", "admit", "eos:0"]:
        s = m.apply(s, a)
    assert s.engine.slots[0].eos
    s = m.apply(s, "tick")
    assert not s.engine.slots and s.engine.pool.free_pages == m.layout.n_pages
    assert not m.invariants(s)


def test_serve_faults_replica_die_orphans_rejoin_pool():
    m = ServeFaultModel()
    s = m.initial()
    for a in ["submit:1x3", "retry:0", "admit:0", "replica_die:0"]:
        s = m.apply(s, a)
    assert not s.alive[0] and not s.engines[0].has_active and s.pending == [0]
    assert "retry:1" in m.actions(s) and "replica_die:1" not in m.actions(s)
    for a in ["retry:1", "admit:1"]:
        s = m.apply(s, a)
    while s.engines[1].has_active:
        s = m.apply(s, "tick:1")
    assert s.delivered == {0: 1} and not m.invariants(s)


def test_serve_faults_preempt_restore_roundtrip_is_exact():
    m = ServeFaultModel()
    s = m.initial()
    for a in ["submit:1x3", "retry:0", "admit:0", "tick:0", "preempt:0"]:
        s = m.apply(s, a)
    assert s.stash[0] and not s.engines[0].has_active
    assert s.engines[0].pool.free_pages == m.layout.n_pages
    saved = dict(s.stash[0][0])
    s = m.apply(s, "restore:0")
    t = (saved["pos"], saved["generated"], saved["max_gen"])
    assert s.restored_log == [(t, t)] and not m.invariants(s)


# ---------------------------------------------------------------------------
# seeded random walks, far past the BFS depth bounds
# ---------------------------------------------------------------------------


def _walk(model, seed: int, steps: int):
    rng = random.Random(seed)
    s = model.initial()
    trail = []
    for _ in range(steps):
        acts = model.actions(s)
        if not acts:
            if model.quiescent(s):
                break
            return f"deadlock: no enabled action after {len(trail)} steps", trail
        a = rng.choice(acts)
        trail.append(a)
        try:
            s = model.apply(s, a)
        except Exception as e:  # noqa: BLE001 — an action crash is a finding
            return f"action {a!r} raised {type(e).__name__}: {e}", trail
        msgs = model.invariants(s)
        if msgs:
            return msgs[0], trail
    return None, trail


WALKS = {
    "elastic": (lambda: ElasticModel(adds=4, slows=3, ckpts=3, resumes=3), 250),
    "serve": (lambda: ServeModel(submits=12, resets=3), 12),
}


@pytest.mark.parametrize("model, seed", [(m, seed) for m in WALKS for seed in range(5)])
def test_random_walks_stay_invariant(model, seed):
    make, min_len = WALKS[model]
    bad, trail = _walk(make(), seed, steps=250)
    assert bad is None, f"{bad}\nscript: {format_script(trail)}"
    assert len(trail) >= min_len


def test_fuzzer_has_teeth_on_drop_release():
    bad, _ = _walk(ServeModel(buggy="drop-release"), seed=0, steps=250)
    assert bad is not None and "leak" in bad


def test_fuzzer_has_teeth_on_remap_identity():
    for seed in range(10):
        bad, _ = _walk(ElasticModel(buggy="remap-identity"), seed=seed, steps=250)
        if bad is not None:
            assert "mapped to the wrong workers" in bad or "mismatch" in bad or "lost" in bad
            return
    pytest.fail("no walk tripped the seeded remap bug within 10 seeds x 250 steps")


# ---------------------------------------------------------------------------
# the CLI, and its report against the JAX package's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_cli(tmp_path_factory):
    """One run of ``repro_torch.analysis --target protocol --json-out --cex-out``."""
    from repro_torch.analysis.cli import main

    d = tmp_path_factory.mktemp("protocol")
    rc = main(["--target", "protocol", "--json-out", str(d / "r1.json"), "--cex-out", str(d / "cex")])
    return rc, d


@pytest.fixture(scope="module")
def reference_protocol():
    """The JAX package's protocol target and selftest, called directly (its
    full CLI also runs a JAX selftest)."""
    from repro.analysis import cli

    return cli.analyze_protocol(), cli.selftest_protocol()


def test_cli_exits_0_with_no_findings_and_the_documented_counts(port_cli):
    rc, d = port_cli
    rep = json.loads((d / "r1.json").read_text())
    assert rc == 0 and rep["findings"] == [] and rep["summary"]["n_error"] == 0
    # as the reference's CLI: every run also runs the collective selftest and records the mesh
    assert rep["summary"]["targets_run"] == ["mesh", "protocol", "selftest", "selftest_protocol"]
    assert _counts(rep["targets"]["protocol"]) == PORT_COUNTS
    for m in rep["targets"]["protocol"].values():
        assert m["exhausted"] and m["n_violations"] == 0 and m["truncated_by"] is None
    st = rep["targets"]["selftest_protocol"]
    assert {k: v["counterexample"] for k, v in st.items()} == SELFTEST_SCRIPTS
    assert all(v["replayed"] for v in st.values())


def _engine_order_tick(self):
    """The port's twin tick (every slot's page, then the retirements), put on
    the JAX package's twin so the two models compare like for like."""
    for b in sorted(self.slots):
        self.pool.ensure(b, self.slots[b].pos)
    finished = []
    for b in sorted(self.slots):
        st = self.slots[b]
        st.pos += 1
        st.generated += 1
        if st.eos or st.generated >= st.max_gen:
            del self.slots[b]
            self._retire(b)
            finished.append((st.rid, st.generated))
    return finished


def test_report_equals_the_reference_dict_for_dict(port_cli, reference_protocol, monkeypatch):
    """Elastic, serve-faults and the three selftests equal the JAX package's
    dict for dict.  The serve model equals the JAX package's once its twin
    ticks as the engine does; as it stands the JAX package's twin gives
    498 states (``src/repro/analysis/protocol/serve_model.py:105-116``)."""
    from repro.analysis.protocol import ServeModel as RefServeModel
    from repro.analysis.protocol import explore as ref_explore
    from repro.analysis.protocol import serve_model as ref_serve_model

    _, d = port_cli
    rep = json.loads((d / "r1.json").read_text())
    (ref_findings, ref_meta), (ref_self_findings, ref_self_meta) = reference_protocol
    assert ref_findings == [] and ref_self_findings == []
    assert _counts(ref_meta) == REFERENCE_COUNTS
    port_meta = rep["targets"]["protocol"]
    for name in ("elastic", "serve-faults"):
        assert port_meta[name] == ref_meta[name]
    assert rep["targets"]["selftest_protocol"] == ref_self_meta
    monkeypatch.setattr(ref_serve_model._ModelEngine, "tick", _engine_order_tick)
    ref_serve = ref_explore(RefServeModel(), max_depth=12)
    assert port_meta["serve"] == dict(ref_serve.stats(), max_depth=12)


def test_cli_report_is_byte_identical_across_runs(port_cli):
    from repro_torch.analysis.cli import main

    _, d = port_cli
    assert main(["--target", "protocol", "--json-out", str(d / "r2.json")]) == 0
    assert (d / "r1.json").read_bytes() == (d / "r2.json").read_bytes()


def test_cli_cex_out_writes_the_three_selftest_scripts(port_cli):
    _, d = port_cli
    files = sorted(p.name for p in (d / "cex").iterdir())
    assert files == [f"selftest-{name}.txt" for name in sorted(SELFTEST_SCRIPTS)]
    for name, script in SELFTEST_SCRIPTS.items():
        body = (d / "cex" / f"selftest-{name}.txt").read_text()
        assert body == f"# selftest counterexample (replayed=True)\n{script}\n"


def test_cli_selftest_fails_run_when_checker_broken(monkeypatch):
    from repro_torch.analysis import cli
    from repro_torch.analysis.protocol.explorer import ExploreResult

    def no_bugs(model, **kw):
        return ExploreResult(violations=[], n_states=1, n_transitions=0, max_depth_reached=0, exhausted=True,
                             truncated_by=None)

    import repro_torch.analysis.protocol as proto

    monkeypatch.setattr(proto, "explore", no_bugs)
    findings, meta = cli.selftest_protocol()
    assert len([f for f in findings if f.rule == "analysis-selftest" and f.severity == "error"]) == 3
    assert not any(m["replayed"] for m in meta.values())


def test_cli_exit_status_follows_unsuppressed_errors(monkeypatch, tmp_path):
    from repro_torch.analysis import cli
    from repro_torch.analysis.findings import Finding

    bad = Finding(rule="protocol-invariant", severity="error", target="protocol:serve", path="submit@0:1x3",
                  message="m")
    monkeypatch.setattr(cli, "analyze_protocol", lambda: ([bad], {}))
    monkeypatch.setattr(cli, "selftest_protocol", lambda: ([], {}))
    assert cli.main(["--target", "all", "--cex-out", str(tmp_path)]) == 1
    assert (tmp_path / "protocol-serve-01.txt").read_text().endswith("submit@0:1x3\n")
    monkeypatch.setattr(cli, "analyze_protocol", lambda: ([dataclasses.replace(bad, severity="warning")], {}))
    assert cli.main(["--target", "protocol"]) == 0
    # the stale-pragma audit runs once every reference target runs: on "all", not on one target
    assert cli._pragma_scan_root(cli.TARGETS) is not None and cli._pragma_scan_root(["protocol"]) is None


# ---------------------------------------------------------------------------
# the twin against real paged engines (smoke smollm on the CPU)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke_engines():
    from repro_torch.configs import smoke_config
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine

    cfg = smoke_config("smollm-360m", seq=16)
    params = init_params(cfg, seed=0, device="cpu")

    def maker(model):
        return lambda: ServeEngine(cfg, params, device="cpu", seed=0, **engine_kwargs(model))

    return maker


def test_engine_kwargs_mirror_the_twins():
    assert engine_kwargs(ServeModel()) == dict(attn_impl="paged", page_size=2, pool_pages=4, n_slots=2, max_seq=8)
    assert engine_kwargs(ServeFaultModel()) == dict(attn_impl="paged", page_size=2, pool_pages=2, n_slots=1,
                                                    max_seq=4)


def test_serve_model_twin_equals_the_real_engine_on_every_leaf_script(smoke_engines):
    m = ServeModel()
    scripts = leaf_scripts(m, 12)
    assert len(scripts) == 174 and not any(a.startswith("eos") for sc in scripts for a in sc)
    finished = 0
    for sc in scripts:
        finished += len(replay_on_engines(m, sc, smoke_engines(m))["finished"])
    assert finished == 162


def test_serve_fault_model_twin_equals_real_engines_on_every_leaf_script(smoke_engines):
    """Every leaf (1,347, 635 with a restore): pools, slots and resume tokens
    after every action; every delivery's tokens equal the request run alone."""
    m = ServeFaultModel()
    make = smoke_engines(m)
    solo_engine = make()
    scripts = leaf_scripts(m, 12)
    assert len(scripts) == 1347
    solo: dict = {}
    restored = with_restore = 0
    for sc in scripts:
        run = replay_on_engines(m, sc, make)
        with_restore += any(a.startswith("restore") for a in sc)
        for _, _, rid, toks in run["finished"]:
            key = (tuple(run["prompts"][rid]), len(toks))
            if key not in solo:
                solo[key] = solo_tokens(solo_engine, run["prompts"][rid], len(toks))
            assert toks == solo[key], (format_script(sc), rid)
            restored += rid in run["restored"]
    assert with_restore == 635 and restored > 0


def test_reference_twin_parts_from_the_engine_where_a_page_is_freed_and_taken_in_one_tick(smoke_engines):
    """Two slots each cross into a new page on the tick that retires both: the
    JAX package's twin releases slot 0's pages before slot 1 takes its page,
    which the engine cannot do (both slots write this tick's K/V first)."""
    from repro.analysis.protocol import ServeModel as RefServeModel

    script = ("submit:1x3", "submit:1x3", "admit", "admit", "tick", "tick")
    ref = RefServeModel()
    s = ref.initial()
    for a in script:
        s = ref.apply(s, a)
    m = ServeModel()
    run = replay_on_engines(m, script, smoke_engines(m))  # the port's twin equals the engine throughout
    assert [f[2] for f in run["finished"]] == [0, 1]
    t = m.initial()
    for a in script:
        t = m.apply(t, a)
    assert t.engine.pool.fingerprint()[1] == (2, 0, 3, 1)
    assert s.engine.pool.fingerprint()[1] == (3, 2, 0, 1)


def test_replay_refuses_eos_and_disabled_actions(smoke_engines):
    m = ServeModel()
    with pytest.raises(ValueError, match="eos"):
        replay_on_engines(m, ("submit:1x3", "admit", "eos:0"), smoke_engines(m))
    with pytest.raises(ValueError, match="not enabled"):
        replay_on_engines(m, ("tick",), smoke_engines(m))


def test_replay_catches_an_engine_that_parts_from_the_twin(smoke_engines):
    """The check has teeth: an engine whose pool skips allocate-on-write is
    caught at the first tick that crosses into a new page."""
    m = ServeModel(shapes=((1, 4),))
    make = smoke_engines(m)

    def broken():
        eng = make()
        eng.pool.ensure = lambda slot, position: None
        return eng

    replay_on_engines(m, ("submit:1x4", "admit", "tick"), broken)
    with pytest.raises(AssertionError, match="after action 3 'tick'"):
        replay_on_engines(m, ("submit:1x4", "admit", "tick", "tick"), broken)


def test_analysis_module_imports_no_jax_in_a_fresh_process():
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = (
        "import sys\n"
        "import repro_torch.analysis, repro_torch.analysis.cli, repro_torch.analysis.protocol\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=root, timeout=120)


def test_solo_tokens_is_the_engine_run_alone(smoke_engines):
    m = ServeFaultModel()
    eng = smoke_engines(m)()
    prompt = np.array([3, 7], np.int32)
    toks = solo_tokens(eng, prompt, 2)
    _, fin = eng.admit(5, prompt, 1)
    assert len(toks) == 2 and fin[1] == toks[:1]
