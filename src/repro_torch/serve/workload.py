"""Request-traffic synthesis: Poisson arrivals, mixed lengths, traces.

All randomness is seeded; the same config always yields the same workload,
so engine/router comparisons (continuous vs static, adaptive vs equal) run
on identical traffic.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serve.scheduler import Request

__all__ = ["WorkloadConfig", "synthesize", "from_trace"]


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


def synthesize(cfg: WorkloadConfig, embed_dim: int | None = None) -> list[Request]:
    """Generate ``n_requests`` with Poisson inter-arrival times (exponential
    gaps at ``rate`` per tick) and uniform mixed prompt/generation lengths.
    ``embed_dim``: produce (L, d) float32 embedding prompts instead of token
    ids (embeds-input archs)."""
    rng = np.random.default_rng(cfg.seed)
    if cfg.rate > 0:
        arrivals = np.cumsum(rng.exponential(1.0 / cfg.rate, cfg.n_requests))
    else:
        arrivals = np.zeros(cfg.n_requests)
    reqs = []
    for i in range(cfg.n_requests):
        L = int(rng.integers(cfg.prompt_len[0], cfg.prompt_len[1] + 1))
        G = int(rng.integers(cfg.gen_len[0], cfg.gen_len[1] + 1))
        if embed_dim is not None:
            prompt = rng.standard_normal((L, embed_dim)).astype(np.float32)
        else:
            prompt = rng.integers(0, cfg.vocab_size, L).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_gen=G, arrival=float(arrivals[i])))
    return reqs


def from_trace(
    records: list[dict],
    vocab_size: int = 256,
    seed: int = 0,
    embed_dim: int | None = None,
    time_scale: float = 1.0,
) -> list[Request]:
    """Build requests from a trace: [{"arrival": t, "prompt_len": L,
    "gen_len": G}, ...].  Token contents are synthesized deterministically
    (``embed_dim`` switches to (L, d) float32 embedding prompts, mirroring
    :func:`synthesize`); ``time_scale`` maps trace time onto engine ticks.
    Arrivals must be non-decreasing — the scheduler admits in arrival order,
    so a shuffled trace would silently serve a different workload."""
    if time_scale <= 0:
        raise ValueError("time_scale must be positive")
    rng = np.random.default_rng(seed)
    reqs = []
    prev = float("-inf")
    for i, rec in enumerate(records):
        L, G = int(rec["prompt_len"]), int(rec["gen_len"])
        if L < 1 or G < 1:
            raise ValueError(f"trace record {i}: prompt_len/gen_len must be >= 1")
        arrival = float(rec.get("arrival", 0.0)) * time_scale
        if arrival < prev:
            raise ValueError(f"trace record {i}: arrivals must be non-decreasing")
        prev = arrival
        if embed_dim is not None:
            prompt = rng.standard_normal((L, embed_dim)).astype(np.float32)
        else:
            prompt = rng.integers(0, vocab_size, L).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_gen=G, arrival=arrival))
    return reqs
