"""Request-traffic synthesis: Poisson arrivals, mixed lengths (a copy of
``repro.serve.workload``; trace replay waits for the port's traces slice).

All randomness is seeded from numpy, in the reference's order, so a seed
gives the JAX side's exact requests.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serve.scheduler import Request

__all__ = ["WorkloadConfig", "synthesize"]


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    n_requests: int = 16
    rate: float = 0.0  # mean arrivals per tick (Poisson); 0 = closed (all at t=0)
    prompt_len: tuple[int, int] = (4, 16)  # inclusive range
    gen_len: tuple[int, int] = (4, 32)  # inclusive range
    vocab_size: int = 256
    seed: int = 0

    def __post_init__(self) -> None:
        if self.n_requests < 1:
            raise ValueError("need at least one request")
        if self.prompt_len[0] < 1 or self.prompt_len[0] > self.prompt_len[1]:
            raise ValueError(f"bad prompt_len range {self.prompt_len}")
        if self.gen_len[0] < 1 or self.gen_len[0] > self.gen_len[1]:
            raise ValueError(f"bad gen_len range {self.gen_len}")
        if self.rate < 0:
            raise ValueError("rate must be >= 0")


def synthesize(cfg: WorkloadConfig) -> list[Request]:
    """Generate ``n_requests`` with Poisson inter-arrival times (exponential
    gaps at ``rate`` per tick) and uniform mixed prompt/generation lengths."""
    rng = np.random.default_rng(cfg.seed)
    if cfg.rate > 0:
        arrivals = np.cumsum(rng.exponential(1.0 / cfg.rate, cfg.n_requests))
    else:
        arrivals = np.zeros(cfg.n_requests)
    reqs = []
    for i in range(cfg.n_requests):
        L = int(rng.integers(cfg.prompt_len[0], cfg.prompt_len[1] + 1))
        G = int(rng.integers(cfg.gen_len[0], cfg.gen_len[1] + 1))
        prompt = rng.integers(0, cfg.vocab_size, L).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_gen=G, arrival=float(arrivals[i])))
    return reqs
