"""Seeded trace synthesis — diurnal/bursty arrivals + machine churn.

Derives :class:`~repro_torch.traces.schema.Trace` artifacts with the arrival
statistics real GPU-cluster traces show (Alibaba PAI-style): a diurnal
sinusoid on the base arrival rate, short high-rate bursts on top, and a
heterogeneous machine mix with mid-trace joins/leaves.  The generator is a
thinned non-homogeneous Poisson process, fully determined by the config
(including the seed), so a trace can be regenerated bit-identically:

    PYTHONPATH=src python -m repro_torch.traces.synth --out src/repro_torch/traces/data/pai_small.json

gives the checked-in ``pai_small`` trace's machines and tasks (the file is a
copy of the JAX package's, whose ``meta.generator`` names that package).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math

import numpy as np

from repro_torch.traces.schema import Trace, TraceMachine, TraceTask, save_trace

__all__ = ["TraceSynthConfig", "synthesize_trace", "rate_at"]


@dataclasses.dataclass(frozen=True)
class TraceSynthConfig:
    name: str = "pai_small"
    horizon: float = 96.0  # trace time units (ticks)
    max_tasks: int = 64  # hard cap on arrivals (thinning stops here)
    base_rate: float = 0.8  # mean arrivals per tick before modulation
    diurnal_amplitude: float = 0.6  # 0..1: peak/trough swing of the daily cycle
    diurnal_period: float = 48.0  # ticks per "day"
    n_bursts: int = 2  # high-rate windows layered on the diurnal curve
    burst_mult: float = 4.0  # rate multiplier inside a burst
    burst_len: float = 4.0  # ticks per burst
    prompt_len: tuple[int, int] = (4, 16)  # inclusive range
    gen_len: tuple[int, int] = (4, 24)  # inclusive range
    # (gpu, join, leave) membership windows; leave=None stays for the trace
    machines: tuple[tuple[str, float, float | None], ...] = (
        ("v100", 0.0, None),
        ("rtx2080ti", 0.0, None),
        ("rtx2080ti", 0.0, None),
        ("gtx1080ti", 0.0, 64.0),  # the weak card is decommissioned late
        ("v100", 32.0, None),  # a strong card joins mid-trace
    )
    seed: int = 0

    def __post_init__(self) -> None:
        if not (0.0 <= self.diurnal_amplitude < 1.0):
            raise ValueError("diurnal_amplitude in [0, 1)")
        if self.base_rate <= 0 or self.horizon <= 0:
            raise ValueError("base_rate and horizon must be positive")
        if self.burst_mult < 1.0:
            raise ValueError("burst_mult must be >= 1 (bursts raise the rate)")


def rate_at(cfg: TraceSynthConfig, t: float, bursts: list[tuple[float, float]]) -> float:
    """Instantaneous arrival rate: diurnal sinusoid x burst windows."""
    lam = cfg.base_rate * (1.0 + cfg.diurnal_amplitude * math.sin(2 * math.pi * t / cfg.diurnal_period))
    for b0, b1 in bursts:
        if b0 <= t < b1:
            lam *= cfg.burst_mult
    return lam


def synthesize_trace(cfg: TraceSynthConfig) -> Trace:
    rng = np.random.default_rng(cfg.seed)

    # burst windows: starts drawn uniformly, clipped to the horizon
    bursts = []
    for _ in range(cfg.n_bursts):
        b0 = float(rng.uniform(0.0, max(cfg.horizon - cfg.burst_len, 0.0)))
        bursts.append((b0, min(b0 + cfg.burst_len, cfg.horizon)))
    bursts.sort()

    # thinned non-homogeneous Poisson arrivals
    lam_max = cfg.base_rate * (1.0 + cfg.diurnal_amplitude) * cfg.burst_mult
    tasks = []
    t = 0.0
    while len(tasks) < cfg.max_tasks:
        t += float(rng.exponential(1.0 / lam_max))
        if t >= cfg.horizon:
            break
        if rng.uniform() > rate_at(cfg, t, bursts) / lam_max:
            continue  # thinned out
        i = len(tasks)
        tasks.append(
            TraceTask(
                job=f"job{i // 4}",  # ~4 instances per job, PAI-style grouping
                task=f"t{i % 4}",
                arrival=round(t, 3),
                prompt_len=int(rng.integers(cfg.prompt_len[0], cfg.prompt_len[1] + 1)),
                gen_len=int(rng.integers(cfg.gen_len[0], cfg.gen_len[1] + 1)),
            )
        )

    machines = tuple(
        TraceMachine(machine=f"m{i}", gpu=gpu, join=join, leave=leave)
        for i, (gpu, join, leave) in enumerate(cfg.machines)
    )
    # json-native meta (tuples -> lists) so Trace.to_dict/from_dict and a
    # disk roundtrip compare equal to the in-memory object
    meta = json.loads(
        json.dumps(
            {
                "generator": "repro_torch.traces.synth",
                "config": dataclasses.asdict(cfg),
                "bursts": [[round(b0, 3), round(b1, 3)] for b0, b1 in bursts],
            }
        )
    )
    return Trace(name=cfg.name, horizon=cfg.horizon, machines=machines, tasks=tuple(tasks), meta=meta)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True, help="output trace json path")
    ap.add_argument("--name", default="pai_small")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-tasks", type=int, default=64)
    ap.add_argument("--horizon", type=float, default=96.0)
    args = ap.parse_args(argv)
    cfg = TraceSynthConfig(name=args.name, seed=args.seed, max_tasks=args.max_tasks, horizon=args.horizon)
    trace = synthesize_trace(cfg)
    save_trace(trace, args.out)
    print(f"wrote {trace.name}: {trace.n_tasks} tasks, {len(trace.machines)} machines -> {args.out}")


if __name__ == "__main__":
    main()
