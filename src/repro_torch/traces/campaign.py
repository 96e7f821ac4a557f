"""Seeded fault campaigns — sweep scenarios x seeds, score the recovery.

A *campaign* runs the elastic trainer under scripted fault scenarios
(:mod:`repro_torch.traces.faults`) across a seed sweep and reduces each trial to
three recovery-centric scores:

* ``recovery_ticks`` — steps from fault onset until the first completed
  epoch AFTER every fault window has cleared whose per-aggregation makespan
  is back within ``recovery_tol`` of the pre-fault baseline.
* ``goodput_frac`` — samples per simulated second over the whole run,
  relative to the pre-fault baseline rate (1.0 = the faults cost nothing).
* ``reconverged`` — whether the final allocation shares match the
  speed-proportional shares for the final fleet (paper eq. 10) within
  ``share_tol`` L1 — i.e. the controller found its way back after the
  perturbation instead of sticking to a mid-fault allocation.

Every input is seeded and every scored quantity is derived from SIMULATED
timing (the ``hetero_gpus`` path), so a campaign's BENCH json is
bit-identical across reruns at a fixed seed — which is exactly what lets
CI gate on it.  Wall-clock and losses are deliberately excluded.

The port's copy runs its trials on ``CampaignConfig.device`` (the port's
entry points default to ``cuda``; pass ``device="cpu"`` for the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.hetero import GPU_RELATIVE_THROUGHPUT, normalize_gpu
from repro_torch.traces.faults import faults_spec, parse_faults, sample_faults

__all__ = ["CampaignConfig", "scenario_faults", "run_trial", "run_campaign", "SCENARIOS"]

SCENARIOS = ("straggler", "netdeg", "outage", "mixed", "random")


@dataclasses.dataclass(frozen=True)
class CampaignConfig:
    """One campaign: which scenarios, which seeds, and the trial shape.

    The trial is the smoke-scale simulated heterogeneous run the elastic
    benchmark uses (tiny model, ``hetero_gpus`` fleet, simulated timing);
    ``recovery_tol``/``share_tol`` are the gate widths CI asserts against.
    """

    scenarios: tuple[str, ...] = ("straggler", "netdeg", "outage")
    seeds: tuple[int, ...] = (0, 1)
    arch: str = "smollm-360m"
    steps: int = 36
    steps_per_epoch: int = 3
    total_micro: int = 12
    micro_bs: int = 1
    seq: int = 16
    fleet: str = "rtx2080ti,rtx2080ti,gtx1080ti,v100"
    recovery_tol: float = 0.15  # agg_s within (1+tol) x baseline counts as recovered
    share_tol: float = 0.25  # L1 distance of final shares from speed-proportional
    device: str = "cuda"  # where the trials train

    def __post_init__(self) -> None:
        unknown = [s for s in self.scenarios if s not in SCENARIOS]
        if unknown:
            raise ValueError(f"unknown scenarios {unknown}; have {list(SCENARIOS)}")
        if not self.seeds:
            raise ValueError("campaign needs at least one seed")


def scenario_faults(scenario: str, seed: int, n_workers: int, steps: int) -> str:
    """The fault schedule for one (scenario, seed) trial.

    Templates place one canonical fault mid-run with seeded parameters
    (which worker, how hard, how long); ``mixed`` layers one of each;
    ``random`` delegates to :func:`~repro_torch.traces.faults.sample_faults`.
    """
    rng = np.random.default_rng(seed)
    onset = steps // 3
    dur = max(steps // 4, 2)
    if scenario == "straggler":
        worker = int(rng.integers(0, n_workers))
        factor = round(float(rng.uniform(2.5, 4.0)), 2)
        return f"slow@{onset}:{worker}*{factor}~{dur}"
    if scenario == "netdeg":
        factor = round(float(rng.uniform(3.0, 6.0)), 2)
        return f"netdeg@{onset}:{factor}~{dur}"
    if scenario == "outage":
        k = 2 if n_workers > 3 else 1
        workers = sorted(int(w) for w in rng.choice(np.arange(n_workers), size=k, replace=False))
        return f"outage@{onset}:{'+'.join(str(w) for w in workers)}~{dur}"
    if scenario == "mixed":
        worker = int(rng.integers(0, n_workers))
        victim = int(rng.integers(0, n_workers - 1))
        sdur = max(dur // 2, 2)
        return ",".join(
            [
                f"slow@{onset}:{worker}*{round(float(rng.uniform(2.5, 4.0)), 2)}~{sdur}",
                f"netdeg@{onset + sdur + 1}:{round(float(rng.uniform(3.0, 5.0)), 2)}~{sdur}",
                f"outage@{onset + 2 * (sdur + 1)}:{victim}~{sdur}",
            ]
        )
    if scenario == "random":
        return faults_spec(sample_faults(n_workers, steps, seed))
    raise ValueError(f"unknown scenario {scenario!r}")


def _expected_shares(gpus: Sequence[str]) -> np.ndarray:
    """Speed-proportional allocation shares for a fleet (paper eq. 10)."""
    v = np.array([GPU_RELATIVE_THROUGHPUT[normalize_gpu(g)] for g in gpus], dtype=np.float64)
    return v / v.sum()


def _transient(events) -> bool:
    """True when the schedule returns to the starting fleet size (every
    membership change is a healing outage) — only then is the post-fault
    makespan comparable against the pre-fault baseline."""
    return all(e.kind in ("slow", "netdeg") or (e.kind == "outage" and e.duration is not None) for e in events)


def run_trial(cfg: CampaignConfig, scenario: str, seed: int) -> dict:
    """One (scenario, seed) trial: run the elastic trainer under the fault
    schedule and reduce its epoch log to the recovery scores."""
    from repro_torch.runtime.driver import DriverConfig, ElasticTrainer

    fleet = cfg.fleet.split(",")
    faults = scenario_faults(scenario, seed, len(fleet), cfg.steps)
    events = parse_faults(faults)
    dcfg = DriverConfig(
        arch=cfg.arch,
        smoke=True,
        steps=cfg.steps,
        seq=cfg.seq,
        n_workers=len(fleet),
        micro_bs=cfg.micro_bs,
        total_micro=cfg.total_micro,
        policy="adaptive",
        hetero_gpus=cfg.fleet,
        steps_per_epoch=cfg.steps_per_epoch,
        faults=faults,
        seed=seed,
        verbose=False,
        device=cfg.device,
    )
    result = ElasticTrainer(dcfg).run()
    epochs = result["epoch_log"]

    onset = min(e.step for e in events)
    clear = max((e.step + (e.duration or 0)) for e in events)
    samples_per_agg = cfg.total_micro * cfg.micro_bs

    pre = [e for e in epochs if e["step_end"] <= onset]
    baseline_agg_s = float(np.mean([e["agg_s"] for e in pre])) if pre else float(epochs[0]["agg_s"])

    # recovery: first post-clear epoch back inside the tolerance band.
    # Only meaningful when the faults are transient (fleet returns to its
    # starting size); a permanent fail/add changes what "recovered" means.
    recovery_ticks = None
    recovered = None
    if _transient(events):
        recovered = False
        for e in epochs:
            if e["step_end"] >= clear and e["agg_s"] <= baseline_agg_s * (1.0 + cfg.recovery_tol):
                recovery_ticks = int(e["step_end"] - onset)
                recovered = True
                break

    # goodput over the whole run, vs the no-fault baseline rate
    total_aggs = sum(e["steps"] for e in epochs)
    total_sim_s = float(sum(e["steps"] * e["agg_s"] for e in epochs))
    goodput = samples_per_agg * total_aggs / total_sim_s if total_sim_s > 0 else 0.0
    goodput_frac = goodput / (samples_per_agg / baseline_agg_s) if baseline_agg_s > 0 else 0.0

    # allocation re-convergence on the FINAL fleet
    final_alloc = np.asarray(result["final_allocation"], dtype=np.float64)
    shares = final_alloc / final_alloc.sum()
    share_l1 = float(np.abs(shares - _expected_shares(result["gpus"])).sum())

    return {
        "scenario": scenario,
        "seed": seed,
        "faults": faults,
        "onset": onset,
        "clear": clear,
        "recovered": recovered,
        "recovery_ticks": recovery_ticks,
        "baseline_agg_s": round(baseline_agg_s, 6),
        "goodput": round(goodput, 6),
        "goodput_frac": round(goodput_frac, 6),
        "share_l1": round(share_l1, 6),
        "reconverged": share_l1 <= cfg.share_tol,
        "final_allocation": result["final_allocation"],
        "final_gpus": result["gpus"],
        "straggler_flags": result["straggler_flags"],
        "memberships": len(result["memberships"]),
    }


def run_campaign(cfg: CampaignConfig) -> dict:
    """Sweep scenarios x seeds; returns the BENCH payload CI gates on.

    The summary carries the gateable floor values across trials (worst-case
    recovery, minimum goodput fraction, re-convergence count) so a CI lane
    can assert once against the aggregate instead of parsing every trial.
    """
    trials = [run_trial(cfg, sc, seed) for sc in cfg.scenarios for seed in cfg.seeds]
    scored = [t for t in trials if t["recovered"] is not None]
    summary = {
        "n_trials": len(trials),
        "n_recovered": sum(1 for t in scored if t["recovered"]),
        "n_recovery_scored": len(scored),
        "max_recovery_ticks": max(
            (t["recovery_ticks"] for t in scored if t["recovery_ticks"] is not None), default=None
        ),
        "min_goodput_frac": round(min(t["goodput_frac"] for t in trials), 6),
        "n_reconverged": sum(1 for t in trials if t["reconverged"]),
        "total_straggler_flags": sum(t["straggler_flags"] for t in trials),
    }
    return {
        "scenario": "faults",
        "config": {
            "scenarios": list(cfg.scenarios),
            "seeds": list(cfg.seeds),
            "steps": cfg.steps,
            "fleet": cfg.fleet,
            "recovery_tol": cfg.recovery_tol,
            "share_tol": cfg.share_tol,
        },
        "trials": trials,
        "summary": summary,
    }
