"""Proportional task sampler — Algorithm 1 step 3 ("redistribute the
subdataset of each worker according to the sample ratio").

Given an allocation ``w`` (microbatches per worker per aggregation), the
sampler partitions each epoch's shuffled index stream so worker *i* draws
exactly ``w_i`` microbatches per aggregation, and *every* sample is used
exactly once per epoch (the paper's "no remaining samples" requirement —
property-tested).  When the controller reallocates between epochs, the next
epoch's partition follows the new ratio; no sample is lost or duplicated.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.allocation import largest_remainder_round

__all__ = ["ProportionalSampler"]


class ProportionalSampler:
    def __init__(self, dataset_size: int, micro_batch: int, seed: int = 0) -> None:
        if dataset_size % micro_batch:
            raise ValueError("dataset_size must be a multiple of micro_batch")
        self.dataset_size = dataset_size
        self.micro_batch = micro_batch
        self.seed = seed

    def epoch_plan(self, epoch: int, alloc: np.ndarray) -> list[list[np.ndarray]]:
        """Partition one epoch for allocation ``alloc``.

        Returns ``plan[worker][aggregation]`` = int array of sample indices:
        ``alloc[worker] * micro_batch`` of them in every full aggregation,
        and — when ``dataset_size`` is not a multiple of one aggregation —
        a final PARTIAL aggregation whose leftover microbatches are split
        proportionally to ``alloc`` (largest-remainder, so shares still sum
        to the tail exactly; a worker's final share may be empty).  Every
        index in ``range(dataset_size)`` appears exactly once per epoch —
        the paper's "no remaining samples without training after one epoch".
        """
        alloc = np.asarray(alloc, dtype=np.int64)
        if np.any(alloc < 1):
            raise ValueError("every worker needs at least one microbatch")
        C = int(alloc.sum())
        agg_samples = C * self.micro_batch
        n_full = self.dataset_size // agg_samples
        if n_full == 0:
            raise ValueError(
                f"dataset ({self.dataset_size}) smaller than one aggregation ({agg_samples})"
            )
        rng = np.random.default_rng(self.seed * 7_368_787 + epoch)
        perm = rng.permutation(self.dataset_size)

        plan: list[list[np.ndarray]] = [[] for _ in alloc]
        cursor = 0
        bounds = np.concatenate([[0], np.cumsum(alloc)]) * self.micro_batch
        for _ in range(n_full):
            block = perm[cursor : cursor + agg_samples]
            for i in range(len(alloc)):
                plan[i].append(block[bounds[i] : bounds[i + 1]])
            cursor += agg_samples
        if cursor < self.dataset_size:
            # tail microbatches (dataset_size and agg_samples are both
            # multiples of micro_batch, so the remainder is too)
            tail = (self.dataset_size - cursor) // self.micro_batch
            share = largest_remainder_round(alloc * (tail / C), tail, w_min=0)
            tb = np.concatenate([[0], np.cumsum(share)]) * self.micro_batch
            block = perm[cursor:]
            for i in range(len(alloc)):
                plan[i].append(block[tb[i] : tb[i + 1]])
        return plan

    def aggregations_per_epoch(self, alloc: np.ndarray) -> int:
        """Full aggregations plus the final partial one (if any)."""
        agg_samples = int(np.sum(alloc)) * self.micro_batch
        n_full, rem = divmod(self.dataset_size, agg_samples)
        return n_full + (1 if rem else 0)
