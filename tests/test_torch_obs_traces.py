"""The port's traces, fault injection and observability against the JAX package's, on the CPU.

* The numpy-only modules the port copies (``obs.metrics``, ``obs.tracer``,
  ``traces.schema``, ``traces.faults``, ``checkpoint.manager``) are the
  reference's with the port's imports, less the hunks listed as departures
  (the port's prompts are token ids only, so no ``embed_dim``); the port's
  ``serve.workload.from_trace`` gives the reference's requests.
* ``parse_faults``/``faults_spec``/``sample_faults``, the ``FaultInjector``'s
  state and the bundled trace's adapters (``to_requests``, ``to_fleet``,
  ``to_events``) equal the reference's on the same specs and seeds; so do
  the synthesized trace and a fault campaign's trial.
* The train and serve CLIs' ``--trace-out``/``--metrics-out`` files equal
  the JAX package's key for key, at a fixed seed under simulated timing and
  on the tick clock.  Under ``--preempt`` the metrics' ``serve.prefills``
  (admissions) is equal too; the engine's own ``prefills`` differs by the
  restores, which the port makes without a prefill.
"""

import dataclasses
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.checkpoint.manager
import repro.obs.metrics
import repro.obs.tracer
import repro.serve.workload
import repro.traces
import repro.traces.faults
import repro.traces.schema
import repro_torch.checkpoint.manager
import repro_torch.obs.metrics
import repro_torch.obs.tracer
import repro_torch.serve.workload
import repro_torch.traces
import repro_torch.traces.faults
import repro_torch.traces.schema
from repro.traces.campaign import CampaignConfig as JCampaignConfig
from repro.traces.campaign import run_trial as jax_run_trial
from repro.traces.synth import TraceSynthConfig as JTraceSynthConfig
from repro.traces.synth import synthesize_trace as jax_synthesize_trace
from repro_torch.traces.campaign import CampaignConfig, run_trial
from repro_torch.traces.synth import TraceSynthConfig, synthesize_trace

ROOT = Path(__file__).resolve().parents[1]

# (reference module, port module, [(the reference's text, the port's), ...]): each
# departure names a hunk the port drops; since the port takes embedding prompts (llava),
# the copies have none
COPIES = [
    (repro.obs.metrics, repro_torch.obs.metrics, []),
    (repro.obs.tracer, repro_torch.obs.tracer, []),
    (repro.traces.schema, repro_torch.traces.schema, []),
    (repro.serve.workload, repro_torch.serve.workload, []),
    (repro.traces.faults, repro_torch.traces.faults, []),
    (repro.checkpoint.manager, repro_torch.checkpoint.manager, []),
]


@pytest.mark.parametrize("copy", COPIES, ids=lambda c: c[0].__name__)
def test_copied_modules_are_the_reference_with_the_port_s_imports(copy):
    jmod, tmod, departures = copy
    want = inspect.getsource(jmod)
    for theirs, ours in departures:
        assert want.count(theirs) == 1, theirs
        want = want.replace(theirs, ours)
    assert inspect.getsource(tmod).replace("repro_torch.", "repro.") == want


def _trace_records(seed, n=24):
    rng = np.random.default_rng(seed)
    return [{"arrival": float(a), "prompt_len": int(p), "gen_len": int(g)}
            for a, p, g in zip(np.cumsum(rng.exponential(2.0, n)), rng.integers(1, 40, n), rng.integers(1, 30, n))]


@pytest.mark.parametrize("seed,time_scale", [(0, 1.0), (5, 0.25), (9, 3.0)])
def test_from_trace_matches_jax(seed, time_scale):
    records = _trace_records(seed)
    ours = repro_torch.serve.workload.from_trace(records, vocab_size=300, seed=seed, time_scale=time_scale)
    theirs = repro.serve.workload.from_trace(records, vocab_size=300, seed=seed, time_scale=time_scale)
    assert len(ours) == len(theirs) == len(records)
    for a, b in zip(ours, theirs, strict=True):
        assert (a.rid, a.max_gen, a.arrival) == (b.rid, b.max_gen, b.arrival)
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert a.prompt.dtype == b.prompt.dtype == np.int32


@pytest.mark.parametrize("edit,kw", [
    (lambda r: r[::-1], {}),  # arrivals out of order
    (lambda r: [{**r[0], "gen_len": 0}] + r[1:], {}),
    (lambda r: r, {"time_scale": 0.0}),
])
def test_from_trace_refuses_what_the_reference_refuses(edit, kw):
    records = edit(_trace_records(1))
    with pytest.raises(ValueError) as ours:
        repro_torch.serve.workload.from_trace(records, **kw)
    with pytest.raises(ValueError) as theirs:
        repro.serve.workload.from_trace(records, **kw)
    assert str(ours.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# faults and traces
# ---------------------------------------------------------------------------

SPECS = [
    "slow@8:2*3~6,netdeg@20:4~8,outage@30:1+2~5",
    "fail@8:3,add@16:v100,replace@24:0=v100,slow@9:0*2.5",
    "netdeg@3:1.5,outage@12:0~2",
]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_faults_and_faults_spec_match(spec):
    ours, theirs = repro_torch.traces.parse_faults(spec), repro.traces.parse_faults(spec)
    assert [dataclasses.asdict(e) for e in ours] == [dataclasses.asdict(e) for e in theirs]
    assert repro_torch.traces.faults_spec(ours) == repro.traces.faults_spec(theirs)


@pytest.mark.parametrize("n_workers,steps,seed,n_faults", [(4, 40, 0, 3), (4, 40, 7, 5), (3, 16, 2, 4), (6, 100, 11, 8)])
def test_sample_faults_match(n_workers, steps, seed, n_faults):
    ours = repro_torch.traces.sample_faults(n_workers, steps, seed, n_faults=n_faults)
    theirs = repro.traces.sample_faults(n_workers, steps, seed, n_faults=n_faults)
    assert [e.spec() for e in ours] == [e.spec() for e in theirs]


def test_fault_injector_state_matches_through_applies_and_rescales():
    def drive(mod):
        inj = mod.FaultInjector(4)
        states = []
        for ev in mod.parse_faults("slow@2:1*3~4,slow@3:3*2,netdeg@5:2~3"):
            inj.apply(ev)
            states.append(inj.state_dict())
        inj.rescale([0, 1, 3], 1)
        states.append(inj.state_dict())
        inj.gc(7)
        states.append(inj.state_dict())
        scales = [(inj.compute_scale(s).tolist(), inj.collective_scale(s)) for s in range(10)]
        return states, scales, mod.FaultInjector.from_state_dict(states[-1]).state_dict()

    assert drive(repro_torch.traces) == drive(repro.traces)


@pytest.mark.parametrize("time_scale,limit", [(1.0, None), (0.5, 12)])
def test_bundled_trace_requests_match(time_scale, limit):
    ours = repro_torch.traces.to_requests(repro_torch.traces.bundled_trace(), vocab_size=512, seed=3,
                                          time_scale=time_scale, limit=limit)
    theirs = repro.traces.to_requests(repro.traces.bundled_trace(), vocab_size=512, seed=3, time_scale=time_scale,
                                      limit=limit)
    assert len(ours) == len(theirs) == (limit or 64)
    for a, b in zip(ours, theirs, strict=True):
        assert (a.rid, a.max_gen, a.arrival) == (b.rid, b.max_gen, b.arrival)
        np.testing.assert_array_equal(a.prompt, b.prompt)


@pytest.mark.parametrize("n_steps", [8, 40, 96])
def test_bundled_trace_fleet_and_events_match(n_steps):
    ours, theirs = repro_torch.traces.bundled_trace(), repro.traces.bundled_trace()
    assert ours.to_dict() == theirs.to_dict()
    assert repro_torch.traces.to_fleet(ours) == repro.traces.to_fleet(theirs)
    assert repro_torch.traces.to_events(ours, n_steps) == repro.traces.to_events(theirs, n_steps)


def test_synthesized_trace_matches_and_regenerates_the_bundled_one():
    for cfg in ({}, {"seed": 4, "max_tasks": 20, "horizon": 50.0}):
        ours = synthesize_trace(TraceSynthConfig(**cfg)).to_dict()
        theirs = jax_synthesize_trace(JTraceSynthConfig(**cfg)).to_dict()
        assert ours["meta"].pop("generator") == "repro_torch.traces.synth"
        assert theirs["meta"].pop("generator") == "repro.traces.synth"
        assert ours == theirs
    bundled = repro_torch.traces.bundled_trace().to_dict()
    made = synthesize_trace(TraceSynthConfig()).to_dict()
    assert (made["machines"], made["tasks"]) == (bundled["machines"], bundled["tasks"])


def test_campaign_trial_matches():
    """One straggler trial over the port's driver scores as over the reference's."""
    kw = dict(scenarios=("straggler",), seeds=(1,), steps=12, steps_per_epoch=3, total_micro=8)
    ours = run_trial(CampaignConfig(**kw, device="cpu"), "straggler", 1)
    theirs = jax_run_trial(JCampaignConfig(**kw), "straggler", 1)
    assert ours == theirs


# ---------------------------------------------------------------------------
# the CLIs' trace and metrics files
# ---------------------------------------------------------------------------

TRAIN_ARGS = ["--arch", "smollm-360m", "--smoke", "--seq", "16", "--total-micro", "8", "--micro-bs",
              "1", "--mode", "while", "--steps-per-epoch", "3", "--hetero-gpus", "v100,rtx2080ti,rtx2080ti,gtx1080ti",
              "--events", "replace@8:3=v100", "--faults", "slow@2:1*3~3,outage@4:2~2,netdeg@7:2~2"]
SERVE_ARGS = ["--arch", "smollm-360m", "--smoke", "--attn-impl", "paged", "--page-size", "4", "--trace", "pai_small",
              "--requests", "16", "--slots", "3", "--preempt", "--pool-pages", "12"]


def _outputs(main, args, tmp_path, tag):
    trace, metrics = str(tmp_path / f"{tag}_trace.json"), str(tmp_path / f"{tag}_metrics.json")
    result = main(args + ["--trace-out", trace, "--metrics-out", metrics])
    with open(trace) as f, open(metrics) as g:
        return result, json.load(f), json.load(g)


def test_train_cli_trace_and_metrics_files_match_jax(tmp_path):
    from repro.launch.train import main as jax_main
    from repro_torch.launch.train import main

    args = TRAIN_ARGS + ["--steps", "9"]
    _, jtrace, jmetrics = _outputs(jax_main, args, tmp_path, "jax")
    res, trace, metrics = _outputs(main, args + ["--device", "cpu"], tmp_path, "port")
    assert metrics == jmetrics and trace == jtrace
    assert metrics["schema"] == "repro.obs.metrics/v1"
    assert metrics["counters"]["train.fault_windows"] == 3 and metrics["counters"]["train.membership_events"] == 3
    assert len(res["fault_log"]) == 3  # the two windows and the outage's scheduled recovery


def test_serve_cli_trace_and_metrics_files_match_jax(tmp_path):
    from repro.launch.serve import main as jax_main
    from repro_torch.launch.serve import main

    jres, jtrace, jmetrics = _outputs(jax_main, SERVE_ARGS, tmp_path, "jax")
    res, trace, metrics = _outputs(main, SERVE_ARGS + ["--device", "cpu"], tmp_path, "port")
    assert metrics == jmetrics and trace == jtrace and res["latency"] == jres["latency"]
    c = metrics["counters"]
    assert c["serve.completed"] == 16 and c["serve.preemptions"] == c["serve.restores"] == res["preemptions"] > 0
    assert c["serve.prefills"] == res["prefills"] == 16
    assert jres["prefills"] - res["prefills"] == res["evicted_restored"]


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src")}


def test_train_cli_kill_and_resume_in_subprocesses(tmp_path):
    """The port's CLI killed after 4 steps and resumed to 9 with the same
    flags: its metrics count the checkpoints and fault windows each process
    scheduled, and the resumed run ends where the uninterrupted one does."""
    ck, metrics = str(tmp_path / "ck"), str(tmp_path / "m.json")
    base = [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_ARGS, "--device", "cpu", "--ckpt-dir", ck,
            "--ckpt-every", "2"]

    def run(steps, *extra):
        argv = base + ["--steps", str(steps), "--metrics-out", metrics, *extra]
        out = subprocess.run(argv, env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
        with open(metrics) as f:
            return json.loads(out.stdout[out.stdout.index("{\n"):]), json.load(f)["counters"]

    first, c1 = run(4)
    resumed, c2 = run(9, "--resume")
    assert first["steps"] == 4 and resumed["steps"] == 9
    # first: the periodic saves at steps 2 and 4 and the terminal one; the slow window
    assert c1["train.checkpoints"] == 3 and c1["train.fault_windows"] == 1
    # resumed: barriers before the outage (4), the recovery add (6) and the replace (8), the
    # periodic saves at 6 and 8 and the terminal one; the outage and netdeg windows
    assert c2["train.checkpoints"] == 6 and c2["train.fault_windows"] == 2
    assert c2["train.membership_events"] == 3
