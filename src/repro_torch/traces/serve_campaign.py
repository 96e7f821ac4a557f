"""Seeded fault campaigns for the SERVING stack — the inference mirror of
:mod:`repro_torch.traces.campaign` (the port of ``repro.traces.serve_campaign``;
its JSON equals the reference's).

Three scenarios, swept over seeds, every scored quantity derived from
seeded virtual-clock timing (so the BENCH json is bit-identical across
reruns and CI gates on it):

* ``replica-outage`` — a replica is killed mid-run through the fault
  grammar (``outage@k:i~d``) and later rejoins; its in-flight and queued
  requests are re-dispatched to survivors (the prompt is the checkpoint),
  with hedging armed so the outage+hedge interaction (orphaned copies of
  hedged rids are dropped, never co-located) is exercised under CI.
  Scored on completion (every request must finish exactly once), retries,
  recovery ticks (virtual time from fault onset until the last retried
  request completes), goodput retention, and p99-TTFT inflation vs the
  same-seed fault-free baseline.
* ``slow-replica`` — a replica's virtual tick cost is scaled up
  (``slow@k:i*f~d``) and stalled dispatches are hedged onto a second
  replica after ``hedge_timeout``; first completion wins, the duplicate is
  suppressed by request id.  Scored on hedges fired/won and the same
  latency/goodput reductions — with ``duplicates`` required to be 0.
* ``pool-pressure`` — a REAL paged :class:`~repro_torch.serve.engine.ServeEngine`
  under page-pool pressure: a batch hog occupies the pool when interactive
  requests arrive; with ``SchedulerConfig(preempt=True)`` the hog is
  evicted (pages are the checkpoint) and restored token-identically once
  pressure clears.  Scored on preemptions, interactive wait reduction vs
  the no-preemption run, and exact token identity between the two runs.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import torch

from repro_torch.serve.router import ModelReplica, RouterConfig, run_router
from repro_torch.serve.scheduler import Request

__all__ = [
    "ServeCampaignConfig",
    "serve_scenario_faults",
    "run_serve_trial",
    "run_serve_campaign",
    "SERVE_SCENARIOS",
]

SERVE_SCENARIOS = ("replica-outage", "slow-replica", "pool-pressure")


@dataclasses.dataclass(frozen=True)
class ServeCampaignConfig:
    """One serving campaign: scenarios x seeds and the trial shape.

    The routed trials run :class:`ModelReplica` fleets (pure virtual-clock
    speed models — traffic dynamics only, no device), so a full sweep is
    sub-second; ``pool-pressure`` builds one real smoke-scale paged engine
    on the campaign's device.
    ``ttft_inflation_max`` is the gate width CI asserts against.
    """

    scenarios: tuple[str, ...] = SERVE_SCENARIOS
    seeds: tuple[int, ...] = (0, 1)
    n_requests: int = 48
    n_replicas: int = 3
    speeds: tuple[float, ...] = (1.0, 0.8, 1.25)
    rate: float = 1.2  # arrivals per virtual second (sustained load)
    prompt_len: tuple[int, int] = (4, 12)
    gen_len: tuple[int, int] = (6, 20)
    window: int = 8
    hedge_timeout: float = 30.0
    ttft_inflation_max: float = 4.0  # p99 TTFT may grow at most this factor

    def __post_init__(self) -> None:
        unknown = [s for s in self.scenarios if s not in SERVE_SCENARIOS]
        if unknown:
            raise ValueError(f"unknown scenarios {unknown}; have {list(SERVE_SCENARIOS)}")
        if not self.seeds:
            raise ValueError("campaign needs at least one seed")
        if len(self.speeds) != self.n_replicas:
            raise ValueError("speeds must list one entry per replica")


def serve_scenario_faults(scenario: str, seed: int, n_replicas: int, n_requests: int) -> str:
    """The fault schedule for one routed (scenario, seed) trial — steps are
    ASSIGNMENT indices (the router applies a fault just before dispatching
    that request), seeded parameters pick the victim and severity."""
    rng = np.random.default_rng(seed)
    onset = n_requests // 3
    dur = max(n_requests // 4, 2)
    if scenario == "replica-outage":
        victim = int(rng.integers(0, n_replicas))
        return f"outage@{onset}:{victim}~{dur}"
    if scenario == "slow-replica":
        victim = int(rng.integers(0, n_replicas))
        factor = round(float(rng.uniform(4.0, 8.0)), 2)
        return f"slow@{onset}:{victim}*{factor}~{dur}"
    raise ValueError(f"no fault schedule for scenario {scenario!r}")


class _TrialProbe:
    """Minimal RouterObs stand-in: records which rids were retried/hedged
    (the campaign needs identities, not just counts, to score recovery)."""

    def __init__(self) -> None:
        self.retried: list[int] = []
        self.hedged: list[int] = []
        self.deaths: list[str] = []

    def on_retry(self, rid: int, to_name: str, step: int, retry: bool = True) -> None:
        if retry:
            self.retried.append(rid)

    def on_hedge(self, rid: int, to_name: str, step: int) -> None:
        self.hedged.append(rid)

    def on_death(self, name: str, step: int) -> None:
        self.deaths.append(name)

    def on_shares(self, idx: int, shares) -> None:
        pass

    def on_done(self, fleet) -> None:
        pass


def _synth(cfg: ServeCampaignConfig, seed: int) -> list[Request]:
    """Seeded open-loop workload.  Regenerated for every run because the
    serving stack mutates requests in place (outputs, timestamps)."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / cfg.rate, cfg.n_requests))
    reqs = []
    for i in range(cfg.n_requests):
        L = int(rng.integers(cfg.prompt_len[0], cfg.prompt_len[1] + 1))
        G = int(rng.integers(cfg.gen_len[0], cfg.gen_len[1] + 1))
        reqs.append(
            Request(rid=i, prompt=np.zeros(L, np.int32), max_gen=G, arrival=float(arrivals[i]))
        )
    return reqs


def _fleet(cfg: ServeCampaignConfig) -> list[ModelReplica]:
    return [ModelReplica(f"r{i}", speed=s, n_slots=2) for i, s in enumerate(cfg.speeds)]


def _p99_wait(requests: list[Request]) -> float:
    waits = np.array([r.wait for r in requests if r.wait is not None], np.float64)
    return float(np.percentile(waits, 99)) if waits.size else 0.0


def _routed_trial(cfg: ServeCampaignConfig, scenario: str, seed: int) -> dict:
    """One routed (scenario, seed) trial vs its same-seed fault-free
    baseline.  p99-TTFT inflation divides faulted by baseline queueing
    delay (floored at one virtual second so an empty-queue baseline cannot
    blow the ratio up); recovery is the virtual time from fault onset until
    the last re-dispatched (or hedged) request completes."""
    faults = serve_scenario_faults(scenario, seed, cfg.n_replicas, cfg.n_requests)
    rcfg = RouterConfig(policy="adaptive", window=cfg.window)
    make = lambda name, speed: ModelReplica(name, speed=speed, n_slots=2)  # noqa: E731

    base_reqs = _synth(cfg, seed)
    base = run_router(_fleet(cfg), base_reqs, rcfg, make_replica=make)

    probe = _TrialProbe()
    reqs = _synth(cfg, seed)
    # hedging is armed for EVERY routed scenario: outage + hedging is the
    # protocol's hardest combination (an orphaned copy of an already-hedged
    # rid must be dropped, not re-dispatched), so CI must exercise it
    run = run_router(
        _fleet(cfg), reqs, rcfg, make_replica=make, obs=probe, faults=faults,
        hedge_timeout=cfg.hedge_timeout,
    )

    onset_idx = min(cfg.n_requests // 3, cfg.n_requests - 1)
    onset_t = float(sorted(r.arrival for r in reqs)[onset_idx])
    touched = sorted(set(probe.retried) | set(probe.hedged))
    by_rid = {r.rid: r for r in reqs}
    recovery_ticks = (
        round(max(by_rid[rid].t_finish for rid in touched) - onset_t, 6)
        if touched and all(by_rid[rid].t_finish is not None for rid in touched)
        else None
    )
    p99_base = _p99_wait(base_reqs)
    p99_fault = _p99_wait(reqs)
    return {
        "scenario": scenario,
        "seed": seed,
        "faults": faults,
        "completed": run["completed"],
        "requests": cfg.n_requests,
        "duplicates": run["duplicates"],
        "suppressed": run["suppressed"],
        "retries": run["retries"],
        "replica_deaths": run["replica_deaths"],
        "hedges": run["hedges"],
        "hedges_won": run["hedges_won"],
        "hedges_lost": run["hedges_lost"],
        "recovery_ticks": recovery_ticks,
        "makespan_base": base["makespan"],
        "makespan_fault": run["makespan"],
        "goodput_frac": round(base["makespan"] / run["makespan"], 6) if run["makespan"] else None,
        "p99_ttft_base": round(p99_base, 6),
        "p99_ttft_fault": round(p99_fault, 6),
        "p99_ttft_inflation": round(p99_fault / max(p99_base, 1.0), 6),
    }


def _pool_pressure_trial(seed: int, device: str | torch.device = "cuda") -> dict:
    """One real-engine preemption trial: a batch hog holds the page pool
    when three interactive requests arrive; the preempting scheduler evicts
    it, serves them, and restores it token-identically (compared against
    the no-preemption run of the SAME requests on the same engine).  The
    engine's weights are the port's seeded init (seed 0) on ``device``;
    every scored quantity is in ticks, so the trial's row does not depend on
    the weights."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import init_params
    from repro_torch.serve import SchedulerConfig, ServeEngine, serve_loop

    max_seq = 48
    cfg = smoke_config("smollm-360m", seq=max_seq)
    cfg = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    params = init_params(cfg, seed=0, device=device)
    # 3 slots but only 9 pool pages: the hog (worst case 8 pages) leaves the
    # pool unable to cover an interactive reservation even though a slot is
    # free — exactly the pressure `preempt` exists to relieve
    engine = ServeEngine(
        cfg, params, n_slots=3, max_seq=max_seq, seed=0,
        attn_impl="paged", page_size=4, pool_pages=9, device=device,
    )

    rng = np.random.default_rng(seed)

    def requests() -> list[Request]:
        r = np.random.default_rng(seed)  # fresh objects, same seeded content
        hog = Request(rid=0, prompt=r.integers(0, cfg.vocab_size, 6).astype(np.int32), max_gen=24)
        inter = [
            Request(
                rid=i,
                prompt=r.integers(0, cfg.vocab_size, 4).astype(np.int32),
                max_gen=int(r.integers(3, 6)),
                arrival=float(2 + i),
            )
            for i in (1, 2, 3)
        ]
        return [hog, *inter]

    del rng
    runs, outputs, waits = {}, {}, {}
    for mode, preempt in (("preempt", True), ("fifo", False)):
        engine.reset()
        reqs = requests()
        s = serve_loop(engine, reqs, SchedulerConfig(max_waiting_prefill=2, preempt=preempt))
        runs[mode] = s
        outputs[mode] = {r.rid: r.output for r in reqs}
        waits[mode] = [r.wait for r in reqs if r.rid != 0]
    return {
        "scenario": "pool-pressure",
        "seed": seed,
        "arch": cfg.name,
        "pool_pages": 9,
        "completed": runs["preempt"]["completed"],
        "requests": 4,
        "duplicates": 0,
        "preemptions": runs["preempt"]["preemptions"],
        "evicted_restored": runs["preempt"]["evicted_restored"],
        "tokens_identical": outputs["preempt"] == outputs["fifo"],
        "interactive_wait_preempt": waits["preempt"],
        "interactive_wait_fifo": waits["fifo"],
        "interactive_wait_max_preempt": max(waits["preempt"]),
        "interactive_wait_max_fifo": max(waits["fifo"]),
    }


def run_serve_trial(
    cfg: ServeCampaignConfig, scenario: str, seed: int, device: str | torch.device = "cuda"
) -> dict:
    """One (scenario, seed) trial; ``device`` carries the pool-pressure trial's engine."""
    if scenario == "pool-pressure":
        return _pool_pressure_trial(seed, device)
    return _routed_trial(cfg, scenario, seed)


def run_serve_campaign(cfg: ServeCampaignConfig, device: str | torch.device = "cuda") -> dict:
    """Sweep scenarios x seeds; returns the BENCH payload CI gates on.

    The summary carries the gateable aggregates: ``total_duplicates`` (must
    be 0 — exactly-once delivery), ``all_completed`` (no request lost),
    worst p99-TTFT inflation, minimum goodput fraction, and the preemption
    trial's token-identity verdict."""
    trials = [run_serve_trial(cfg, sc, seed, device) for sc in cfg.scenarios for seed in cfg.seeds]
    routed = [t for t in trials if t["scenario"] != "pool-pressure"]
    pooled = [t for t in trials if t["scenario"] == "pool-pressure"]
    summary = {
        "n_trials": len(trials),
        "total_duplicates": sum(t["duplicates"] for t in trials),
        "all_completed": all(t["completed"] == t["requests"] for t in trials),
        "total_retries": sum(t.get("retries", 0) for t in trials),
        "total_hedges": sum(t.get("hedges", 0) for t in trials),
        "total_hedges_won": sum(t.get("hedges_won", 0) for t in trials),
        "total_preemptions": sum(t.get("preemptions", 0) for t in trials),
        "max_recovery_ticks": max(
            (t["recovery_ticks"] for t in routed if t.get("recovery_ticks") is not None),
            default=None,
        ),
        "min_goodput_frac": (
            round(min(t["goodput_frac"] for t in routed), 6) if routed else None
        ),
        "max_p99_ttft_inflation": (
            round(max(t["p99_ttft_inflation"] for t in routed), 6) if routed else None
        ),
        "preempt_tokens_identical": all(t["tokens_identical"] for t in pooled) if pooled else None,
    }
    return {
        "scenario": "serve-faults",
        "config": {
            "scenarios": list(cfg.scenarios),
            "seeds": list(cfg.seeds),
            "n_requests": cfg.n_requests,
            "speeds": list(cfg.speeds),
            "rate": cfg.rate,
            "hedge_timeout": cfg.hedge_timeout,
            "ttft_inflation_max": cfg.ttft_inflation_max,
        },
        "trials": trials,
        "summary": summary,
    }
