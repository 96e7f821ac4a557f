"""Host-side batch assembly for the allocation-aware SPMD step.

The hetero train step (``dist/hetero_step.py``) consumes, per global step:

* ``inputs/targets``: (n_ranks, W_max, micro_bs, seq) — rank-major padded
  microbatch buffers.  Rank *i* reads only its first ``w_i`` microbatches
  (the variable-trip-count loop); the padding rows are never touched but
  keep SPMD shapes static.
* ``alloc``: (n_ranks,) int32 — the per-rank trip counts from the
  controller.

``HeteroBatcher`` builds these from the :class:`ProportionalSampler` plan so
the data semantics match the paper exactly (disjoint proportional shares,
every sample once per epoch).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.data.sampler import ProportionalSampler
from repro_torch.data.synthetic import SyntheticLM

__all__ = ["HeteroBatcher"]


class HeteroBatcher:
    def __init__(
        self,
        dataset: SyntheticLM,
        n_ranks: int,
        micro_batch: int,
        w_max: int,
        seed: int = 0,
    ) -> None:
        self.dataset = dataset
        self.n_ranks = n_ranks
        self.micro_batch = micro_batch
        self.w_max = w_max
        self.sampler = ProportionalSampler(len(dataset), micro_batch, seed=seed)

    def epoch(self, epoch: int, alloc: np.ndarray, start: int = 0) -> Iterator[dict[str, np.ndarray]]:
        """Yield one dict per aggregation (global step).

        The final aggregation of an epoch may be PARTIAL (the sampler splits
        the dataset tail proportionally rather than dropping it), so each
        yielded ``alloc`` is derived from that aggregation's actual shares —
        a rank may even get 0 microbatches in the last step of an epoch.

        ``start`` skips the first ``start`` aggregations without assembling
        their batches — how a resumed run fast-forwards to its checkpointed
        position inside an epoch instead of replaying (or re-materializing)
        data it already trained on.
        """
        alloc = np.asarray(alloc, dtype=np.int32)
        if alloc.max() > self.w_max:
            raise ValueError(f"allocation {alloc.max()} exceeds W_max={self.w_max}")
        plan = self.sampler.epoch_plan(epoch, alloc)
        n_agg = len(plan[0])
        if start < 0 or start > n_agg:
            raise ValueError(f"start={start} outside this epoch's {n_agg} aggregations")
        S = self.dataset.seq_len
        for a in range(start, n_agg):
            inputs = np.zeros((self.n_ranks, self.w_max, self.micro_batch, S), np.int32)
            targets = np.zeros_like(inputs)
            alloc_a = np.array([len(plan[i][a]) // self.micro_batch for i in range(self.n_ranks)], np.int32)
            for i in range(self.n_ranks):
                w = alloc_a[i]
                if w == 0:
                    continue
                b = self.dataset.batch(plan[i][a])
                inputs[i, :w] = b["inputs"].reshape(w, self.micro_batch, S)
                targets[i, :w] = b["targets"].reshape(w, self.micro_batch, S)
            yield {"inputs": inputs, "targets": targets, "alloc": alloc_a}

    def aggregations_per_epoch(self, alloc: np.ndarray) -> int:
        return self.sampler.aggregations_per_epoch(alloc)
