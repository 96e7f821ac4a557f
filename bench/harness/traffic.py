"""Traffic made from ``--seed`` by general generators that read a mix's file.

* :func:`synthesize` is a copy of ``repro_torch.serve.workload.synthesize``
  (Poisson arrivals, uniform lengths; ``bench/tests/test_bench_traffic.py``
  holds the two to the same draws), returning plain dicts.
* :class:`Backlog` extends it to a closed loop: a fixed set of ``sizes``
  (prompt, generation) pairs on quantiles of the mix's distributions, the same
  set for every seed, served in an order drawn from the seed and drawn again
  each time the set is used up; prompt tokens come from (seed, request id).
* :class:`EpochRows` is the training data: the rows of an epoch, each drawn
  from (seed, epoch, index), so no two epochs share a row; it logs which rows
  each batch took.
"""

from __future__ import annotations

import math

import numpy as np


def synthesize(n_requests: int, rate: float, prompt_len: tuple, gen_len: tuple, vocab_size: int,
               seed: int) -> list[dict]:
    """Requests with exponential gaps at ``rate`` a tick (all at 0 if 0) and
    uniform prompt and generation lengths, inclusive."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n_requests)) if rate > 0 else np.zeros(n_requests)
    out = []
    for i in range(n_requests):
        L = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        G = int(rng.integers(gen_len[0], gen_len[1] + 1))
        prompt = rng.integers(0, vocab_size, L).astype(np.int32)
        out.append({"rid": i, "prompt": prompt, "max_gen": G, "arrival": float(arrivals[i])})
    return out


def _quantiles(lo: int, hi: int, n: int, dist: str) -> list[int]:
    qs = [(i + 0.5) / n for i in range(n)]
    if dist == "loguniform":
        return [min(hi, max(lo, int(math.exp(math.log(lo) + q * (math.log(hi + 1) - math.log(lo)))))) for q in qs]
    if dist == "uniform":
        return [min(hi, max(lo, int(lo + q * (hi + 1 - lo)))) for q in qs]
    raise ValueError(f"unknown length distribution {dist!r}")


class Backlog:
    """The closed backlog's request stream: ``next()`` gives (rid, prompt, max_gen)."""

    def __init__(self, mix: dict, vocab_size: int, seed: int) -> None:
        n = mix["sizes"]
        prompts = _quantiles(*mix["prompt_len"], n, mix["prompt_dist"])
        gens = _quantiles(*mix["gen_len"], n, mix["gen_dist"])
        pairing = np.random.default_rng(0).permutation(n)  # one fixed set of pairs for every seed
        self.sizes = [(prompts[i], gens[pairing[i]]) for i in range(n)]
        self.vocab_size, self.seed = vocab_size, seed
        self._order: list[int] = []
        self._round = 0
        self.rid = 0

    def next(self) -> tuple[int, np.ndarray, int]:
        if not self._order:
            self._order = list(np.random.default_rng([self.seed, self._round]).permutation(len(self.sizes)))
            self._round += 1
        L, G = self.sizes[self._order.pop()]
        rid, self.rid = self.rid, self.rid + 1
        return rid, self.prompt(rid, L), G

    def prompt(self, rid: int, length: int) -> np.ndarray:
        return np.random.default_rng([self.seed, 1, rid]).integers(0, self.vocab_size, length).astype(np.int32)


class EpochRows:
    """A dataset of ``n_sequences`` rows of ``seq_len + 1`` tokens whose rows
    change with ``epoch``, which the harness sets before each epoch; ``log``
    keeps (epoch, indices) of every batch asked for."""

    def __init__(self, vocab_size: int, seq_len: int, n_sequences: int, seed: int) -> None:
        self.vocab_size, self.seq_len, self.n_sequences, self.seed = vocab_size, seq_len, n_sequences, seed
        self.epoch = 0
        self.log: list[tuple[int, list[int]]] = []

    def __len__(self) -> int:
        return self.n_sequences

    def row(self, epoch: int, index: int) -> np.ndarray:
        return np.random.default_rng([self.seed, epoch, index]).integers(0, self.vocab_size, self.seq_len + 1)

    def batch(self, indices) -> dict[str, np.ndarray]:
        idx = [int(i) for i in indices]
        self.log.append((self.epoch, idx))
        seqs = np.stack([self.row(self.epoch, i) for i in idx]).astype(np.int32)
        return {"inputs": seqs[:, :-1], "targets": seqs[:, 1:]}
