"""Deterministic synthetic datasets (offline container — no downloads).

* ``SyntheticLM`` — token sequences with learnable structure (a random
  bigram process), so small models show a *decreasing* loss, not noise:
  the convergence benchmarks need a learnable signal.
* ``SyntheticImages`` — MNIST/CIFAR-shaped class-conditional blobs for the
  paper's ConvNet/VGG/ResNet experiments.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticLM", "SyntheticImages"]


@dataclasses.dataclass
class SyntheticLM:
    """Bigram-process LM data: next token ~ P(. | current), fixed random P."""

    vocab_size: int
    seq_len: int
    n_sequences: int = 4096
    seed: int = 0
    concentration: float = 0.25  # lower = more predictable = faster loss drop

    def __post_init__(self) -> None:
        rng = np.random.default_rng(self.seed)
        # sparse-ish transition matrix: each token has ~8 likely successors
        k = min(8, self.vocab_size)
        self._succ = rng.integers(0, self.vocab_size, size=(self.vocab_size, k))
        self._probs = rng.dirichlet(np.full(k, self.concentration), size=self.vocab_size)

    def sequence(self, index: int) -> np.ndarray:
        """Deterministic per-index sequence of length seq_len + 1."""
        rng = np.random.default_rng(self.seed * 1_000_003 + index)
        toks = np.empty(self.seq_len + 1, np.int32)
        toks[0] = rng.integers(0, self.vocab_size)
        for t in range(1, self.seq_len + 1):
            succ = self._succ[toks[t - 1]]
            toks[t] = succ[rng.choice(len(succ), p=self._probs[toks[t - 1]])]
        return toks

    def batch(self, indices: np.ndarray) -> dict[str, np.ndarray]:
        seqs = np.stack([self.sequence(int(i) % self.n_sequences) for i in indices])
        return {"inputs": seqs[:, :-1], "targets": seqs[:, 1:]}

    def __len__(self) -> int:
        return self.n_sequences


@dataclasses.dataclass
class SyntheticImages:
    """Class-conditional Gaussian blobs at image shape (H, W, C)."""

    shape: tuple[int, int, int] = (28, 28, 1)
    n_classes: int = 10
    n_samples: int = 4096
    seed: int = 0
    noise: float = 0.35

    def __post_init__(self) -> None:
        rng = np.random.default_rng(self.seed)
        self._prototypes = rng.normal(size=(self.n_classes, *self.shape)).astype(np.float32)

    def batch(self, indices: np.ndarray) -> dict[str, np.ndarray]:
        labels = (np.asarray(indices) % self.n_classes).astype(np.int32)
        imgs = np.empty((len(indices), *self.shape), np.float32)
        for j, (i, c) in enumerate(zip(indices, labels)):
            rng = np.random.default_rng(self.seed * 999_983 + int(i))
            imgs[j] = self._prototypes[c] + self.noise * rng.normal(size=self.shape)
        return {"images": imgs, "labels": labels}

    def __len__(self) -> int:
        return self.n_samples
