"""The port's traffic router and serving fault campaign against the JAX package's, on the CPU.

The router is host logic on virtual clocks, so the comparison is exact: the
port's ``run_router`` over ``ModelReplica`` fleets must give the reference's
summary key for key, ``shares_history`` bit for bit, over the scenarios of
``tests/test_serve.py`` and ``tests/test_serve_faults.py`` (convergence to the
speed ratio, replace/add/remove events, outages with a rejoin, ``fail``,
``slow`` with hedging, a kill with a hedge in flight, a remove that
redistributes a backlog).  Fleets of real engines (``EngineReplica``, the
smollm-360m smoke config in float32, weights carried across by
``params_from_jax``) give the JAX fleets' summaries and greedy tokens, fault
free and with ``fail@3:1``.  ``run_serve_campaign`` gives the reference's
JSON, and ``RouterObs`` the reference's metrics and trace files.
"""

import ast
import dataclasses
import inspect
import json

import jax
import numpy as np
import pytest

import repro.serve.router
import repro_torch.serve.router
from repro.configs import smoke_config as jax_smoke_config
from repro.models import init_params as jax_init_params
from repro.obs import RouterObs as JRouterObs
from repro.serve import EngineReplica as JEngineReplica
from repro.serve import ModelReplica as JModelReplica
from repro.serve import Request as JRequest
from repro.serve import RouterConfig as JRouterConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import TrafficRouter as JTrafficRouter
from repro.serve import WorkloadConfig as JWorkloadConfig
from repro.serve import run_router as jax_run_router
from repro.serve import synthesize as jax_synthesize
from repro.traces.serve_campaign import ServeCampaignConfig as JServeCampaignConfig
from repro.traces.serve_campaign import run_serve_campaign as jax_run_serve_campaign
from repro_torch.configs import smoke_config
from repro_torch.models.convert import params_from_jax
from repro_torch.obs import RouterObs
from repro_torch.serve import (
    EngineReplica,
    ModelReplica,
    Request,
    RouterConfig,
    ServeEngine,
    TrafficRouter,
    WorkloadConfig,
    run_router,
    synthesize,
)
from repro_torch.traces import ServeCampaignConfig, run_serve_campaign, serve_scenario_faults

# the two sides' classes, so one scenario builds either fleet
JAX = dict(Model=JModelReplica, Engine=JEngineReplica, Request=JRequest, RouterConfig=JRouterConfig,
           WorkloadConfig=JWorkloadConfig, synthesize=jax_synthesize, run_router=jax_run_router)
PORT = dict(Model=ModelReplica, Engine=EngineReplica, Request=Request, RouterConfig=RouterConfig,
            WorkloadConfig=WorkloadConfig, synthesize=synthesize, run_router=run_router)


def _code(module) -> str:
    """The module's code without its docstrings and comments, the port's imports read as the reference's."""
    tree = ast.parse(inspect.getsource(module).replace("repro_torch.", "repro."))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return ast.unparse(tree)


def test_router_code_is_the_reference_s():
    """The port's router is the reference's code line for line (its docstrings say more)."""
    assert _code(repro_torch.serve.router) == _code(repro.serve.router)


# ---------------------------------------------------------------------------
# ModelReplica fleets: the reference's scenarios, dict for dict
# ---------------------------------------------------------------------------


def _fault_workload(side, n=24, seed=0, rate=1.5):
    """``tests/test_serve_faults.py``'s workload, built with one side's Request."""
    rng = np.random.default_rng(seed)
    arr = np.cumsum(rng.exponential(1.0 / rate, n))
    return [side["Request"](rid=i, prompt=np.zeros(int(rng.integers(4, 10)), np.int32),
                            max_gen=int(rng.integers(6, 16)), arrival=float(arr[i])) for i in range(n)]


def _synth(side, **kw):
    return side["synthesize"](side["WorkloadConfig"](**kw))


def _slot_list_replica(base):
    """``tests/test_serve_faults.py``'s ``_SlotListReplica`` over one side's
    ModelReplica: list-backed slots, so two copies of one rid would both retire."""

    class SlotList(base):
        def __init__(self, name, speed=1.0, n_slots=2, prefill_cost_per_token=0.05):
            super().__init__(name, speed, n_slots, prefill_cost_per_token)
            self._slots = []

        def _has_active(self):
            return bool(self._slots)

        def _can_admit(self):
            return len(self._slots) < self.n_slots

        def _admit(self, req):
            if req.max_gen <= 1:
                self.tokens_done += 1
                return [(req.rid, 1)]
            self._slots.append([req.rid, req.max_gen - 1, req.max_gen])
            self.tokens_done += 1
            return []

        def _tick(self):
            made, fins = len(self._slots), []
            for s in list(self._slots):
                s[1] -= 1
                if s[1] <= 0:
                    self._slots.remove(s)
                    fins.append((s[0], s[2]))
            return made, fins

        def _abort_active(self):
            self._slots.clear()

    return SlotList


def _converge(s):
    reps = [s["Model"](f"r{i}", sp, n_slots=4) for i, sp in enumerate([1.0, 2.0])]
    return s["run_router"](reps, _synth(s, n_requests=96, rate=0.5, gen_len=(8, 16), seed=3),
                           s["RouterConfig"](window=8, total_shares=64))


def _replace(s):
    reps = [s["Model"]("slow", 1.0, n_slots=4), s["Model"]("base", 2.0, n_slots=4)]
    return s["run_router"](
        reps, _synth(s, n_requests=160, rate=0.5, gen_len=(8, 16), seed=4), s["RouterConfig"](window=8, total_shares=64),
        events=[{"at": 80, "kind": "replace", "index": 0, "speed": 6.0, "name": "fast"}],
        make_replica=lambda name, speed: s["Model"](name, speed, n_slots=4))


def _add_remove(s):
    reps = [s["Model"]("a", 1.0, n_slots=4), s["Model"]("b", 1.0, n_slots=4)]
    return s["run_router"](
        reps, _synth(s, n_requests=120, rate=0.5, gen_len=(8, 16), seed=5), s["RouterConfig"](window=8, total_shares=64),
        events=[{"at": 40, "kind": "add", "speed": 2.0, "name": "c"}, {"at": 80, "kind": "remove", "index": 0}],
        make_replica=lambda name, speed: s["Model"](name, speed, n_slots=4))


def _policy(policy):
    def run(s):
        reps = [s["Model"]("slow", 1.0, 2), s["Model"]("fast", 2.1, 2)]
        wl = _synth(s, n_requests=48, rate=0.9, prompt_len=(4, 12), gen_len=(6, 20), seed=1)
        return s["run_router"](reps, wl, s["RouterConfig"](policy=policy, window=6))

    return run


def _outage(faults, hedge=None, slot_list=False):
    def run(s):
        cls = _slot_list_replica(s["Model"]) if slot_list else s["Model"]
        make = lambda name, speed: cls(name, speed=speed, n_slots=2)  # noqa: E731
        reps = [make(f"r{i}", 1.0) for i in range(3)]
        return s["run_router"](reps, _fault_workload(s), make_replica=make, faults=faults, hedge_timeout=hedge)

    return run


def _hedged_slow(s):
    reps = [s["Model"](f"r{i}", speed=1.0, n_slots=2) for i in range(2)]
    return s["run_router"](reps, _fault_workload(s), faults="slow@2:0*40~90", hedge_timeout=6.0)


def _kill_with_hedge(s):
    cls = _slot_list_replica(s["Model"])
    reps = [cls(f"r{i}", speed=1.0, n_slots=2) for i in range(2)]
    return s["run_router"](reps, _fault_workload(s), faults="slow@2:0*40~90,fail@12:0",
                           make_replica=lambda name, speed: cls(name, speed=speed, n_slots=2), hedge_timeout=4.0)


def _fail(s):
    make = lambda name, speed: s["Model"](name, speed=speed, n_slots=2)  # noqa: E731
    return s["run_router"]([make(f"r{i}", 1.0) for i in range(3)], _fault_workload(s), faults="fail@5:2")


def _remove_backlog(s):
    make = lambda name, speed: s["Model"](name, speed=speed, n_slots=1)  # noqa: E731
    return s["run_router"]([make(f"r{i}", 1.0) for i in range(3)], _fault_workload(s), make_replica=make,
                           events=[{"at": 6, "kind": "remove", "index": 2}])


def _joins(s):
    """add and replace through the fault grammar (speeds from the GPU table)."""
    make = lambda name, speed: s["Model"](name, speed=speed, n_slots=2)  # noqa: E731
    return s["run_router"]([make(f"r{i}", 1.0) for i in range(2)], _fault_workload(s), make_replica=make,
                           faults="add@4:v100,replace@10:0=gtx1080ti")


SCENARIOS = {
    "converge_to_speed_ratio": _converge,
    "replace_event": _replace,
    "add_and_remove_events": _add_remove,
    "adaptive": _policy("adaptive"),
    "equal": _policy("equal"),
    "outage_rejoins": _outage("outage@8:1~6"),
    "outage_outlives_schedule": _outage("outage@20:1~999"),
    "outage_with_hedging": _outage("outage@8:1~6", hedge=4.0, slot_list=True),
    "fail": _fail,
    "slow_with_hedging": _hedged_slow,
    "kill_with_hedge_in_flight": _kill_with_hedge,
    "remove_redistributes_backlog": _remove_backlog,
    "add_and_replace_faults": _joins,
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_run_router_equals_the_reference(scenario):
    want, got = SCENARIOS[scenario](JAX), SCENARIOS[scenario](PORT)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key
    assert got["completed"] > 0 and got["duplicates"] == 0


def test_adaptive_beats_equal_as_in_the_reference():
    adaptive, equal = _policy("adaptive")(PORT), _policy("equal")(PORT)
    assert adaptive["makespan"] < equal["makespan"] and adaptive["latency_p95"] < equal["latency_p95"]
    target = np.array([1.0, 2.1]) / 3.1
    assert np.abs(np.array(_converge(PORT)["final_shares"]) - np.array([1.0, 2.0]) / 3.0).max() < 0.07
    assert np.abs(np.array(adaptive["final_shares"]) - target).max() < 0.2


def test_traffic_router_observe_and_resize_equal_the_reference():
    """The controller hand-over, call by call: no measurement, a measurement,
    an idle replica's last speed, a shrink with carried speeds, routing after it."""
    mine, theirs = TrafficRouter(3, RouterConfig()), JTrafficRouter(3, JRouterConfig())
    for r in (mine, theirs):
        r.observe([None, None, None])
        r.observe([4.0, 2.0, 1.0])
        r.observe([None, 2.0, 1.5])
        r.resize(2, carry_tok_per_s=[4.0, 2.0])
        r.observe([4.0, None])
    assert mine.shares_history == theirs.shares_history
    assert [mine.route() for _ in range(20)] == [theirs.route() for _ in range(20)]
    with pytest.raises(ValueError):
        RouterConfig(policy="nope")
    with pytest.raises(ValueError):
        RouterConfig(window=0)


def test_replica_lifecycle_equals_the_reference():
    """take_queue, kill and the drain bound on one side's replica, then the other's."""
    out = {}
    for name, s in (("jax", JAX), ("port", PORT)):
        rep = s["Model"]("r", n_slots=1)
        reqs = [s["Request"](rid=i, prompt=np.zeros(4, np.int32), max_gen=8) for i in range(3)]
        for r in reqs:
            rep.submit(r)
        rep._step()
        taken = [r.rid for r in rep.take_queue()]
        rep.submit(reqs[2])
        orphans = sorted(r.rid for r in rep.kill())
        out[name] = (taken, orphans, rep.clock, rep.busy, rep.tokens_done, rep.harvest_window())
    assert out["port"] == out["jax"]

    class Stuck(ModelReplica):
        def _tick(self):
            return 0, []

    rep = Stuck("wedged")
    rep.submit(Request(rid=7, prompt=np.zeros(4, np.int32), max_gen=8))
    with pytest.raises(RuntimeError, match=r"wedged.*\[7\]"):
        rep.drain(max_ticks=50)
    with pytest.raises(ValueError, match="entire fleet"):
        run_router([ModelReplica("only")], _fault_workload(PORT, n=4), faults="fail@0:0")


# ---------------------------------------------------------------------------
# EngineReplica fleets: real engines, greedy tokens
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smol():
    """The reference test's float32 smoke model (seq 48), carried across."""
    jcfg = dataclasses.replace(jax_smoke_config("smollm-360m", seq=48), param_dtype="float32", compute_dtype="float32")
    tcfg = dataclasses.replace(smoke_config("smollm-360m", seq=48), param_dtype="float32", compute_dtype="float32")
    jp = jax_init_params(jcfg, jax.random.PRNGKey(1))
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.mark.parametrize("faults", [None, "fail@3:1"])
def test_engine_fleets_equal_the_reference(smol, faults):
    """``tests/test_serve_faults.py:353`` on both sides: two engines of 2 slots,
    8 requests; with ``fail@3:1`` every request still completes exactly once,
    token-identical to the fault-free run, and both sides agree on everything."""
    jcfg, tcfg, jp, tp = smol
    wl = dict(n_requests=8, rate=2.0, prompt_len=(4, 10), gen_len=(6, 12), vocab_size=tcfg.vocab_size, seed=3)
    fleets = {
        "jax": lambda: [JEngineReplica(f"e{i}", JServeEngine(jcfg, jp, n_slots=2, max_seq=48, seed=0)) for i in range(2)],
        "port": lambda: [EngineReplica(f"e{i}", ServeEngine(tcfg, tp, n_slots=2, max_seq=48, seed=0, device="cpu"))
                         for i in range(2)],
    }
    out, tokens = {}, {}
    for name, s in (("jax", JAX), ("port", PORT)):
        reqs = _synth(s, **wl)
        out[name] = s["run_router"](fleets[name](), reqs, faults=faults)
        tokens[name] = {r.rid: r.output for r in reqs}
    assert out["port"] == out["jax"]
    assert tokens["port"] == tokens["jax"]
    assert out["port"]["completed"] == 8 and out["port"]["duplicates"] == 0
    if faults:
        assert out["port"]["replica_deaths"] == 1 and out["port"]["retries"] >= 1
        reqs = _synth(PORT, **wl)
        run_router(fleets["port"](), reqs)
        assert tokens["port"] == {r.rid: r.output for r in reqs}  # the prompt is the checkpoint


def test_engine_reset_seed_reseeds_sampling(smol):
    """``reset(seed)`` (the reference's API): the new seed's sampling stream."""
    _, tcfg, _, tp = smol
    prompt = np.arange(5, dtype=np.int32)

    def sample(eng):
        eng.admit(0, prompt, 6)
        while eng.has_active:
            fin = eng.tick()
        return fin[0][1]

    eng = ServeEngine(tcfg, tp, n_slots=1, max_seq=48, temperature=1.0, seed=0, device="cpu")
    sample(eng)
    eng.reset(seed=5)
    reseeded = sample(eng)
    other = ServeEngine(tcfg, tp, n_slots=1, max_seq=48, temperature=1.0, seed=5, device="cpu")
    assert eng.seed == 5 and reseeded == sample(other)
    eng.reset()
    assert sample(eng) == reseeded  # the seed stays until the next reset(seed)


# ---------------------------------------------------------------------------
# the serving fault campaign and RouterObs
# ---------------------------------------------------------------------------


def test_serve_campaign_equals_the_reference():
    """Every scored quantity is virtual or in ticks, so the JSON is equal
    whole; the pool-pressure trial's engine runs on the CPU here."""
    got = run_serve_campaign(ServeCampaignConfig(), device="cpu")
    want = jax_run_serve_campaign(JServeCampaignConfig())
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got["summary"]["total_duplicates"] == 0 and got["summary"]["preempt_tokens_identical"]
    assert [serve_scenario_faults(sc, seed, 3, 48) for sc in ("replica-outage", "slow-replica") for seed in (0, 1)] \
        == [want["trials"][i]["faults"] for i in range(4)]


def test_router_obs_files_equal_the_reference(tmp_path):
    """One routed run with an outage, hedging and RouterObs writing both files."""
    files = {}
    for name, s, obs_cls in (("jax", JAX, JRouterObs), ("port", PORT, RouterObs)):
        paths = tmp_path / f"{name}_trace.json", tmp_path / f"{name}_metrics.json"
        obs = obs_cls(trace_out=str(paths[0]), metrics_out=str(paths[1]))
        make = lambda n, sp, s=s: s["Model"](n, speed=sp, n_slots=2)  # noqa: E731
        s["run_router"]([make(f"r{i}", sp) for i, sp in enumerate((1.0, 0.8, 1.25))], _fault_workload(s, n=32),
                        s["RouterConfig"](window=6), make_replica=make, obs=obs, faults="outage@10:1~6",
                        hedge_timeout=8.0)
        obs.close()
        files[name] = [json.loads(p.read_text()) for p in paths]
    assert files["port"] == files["jax"]
    trace, metrics = files["port"]
    assert metrics["counters"]["router.replica_deaths"] == 1 and len(trace["traceEvents"]) > 32
