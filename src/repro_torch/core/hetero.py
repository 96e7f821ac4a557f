"""Worker speed models — the heterogeneous "hardware" for CPU validation.

The paper measures wall-clock per-worker gradient-compute time on real mixed
GPU clusters (1080ti / 2080ti / V100).  This container is a single CPU, so
heterogeneity is *modeled*: a :class:`WorkerSpeed` produces the time worker
*i* needs to compute ``k`` microbatches in epoch ``e``.  The adaptive
controller consumes timings through exactly the same interface it would use
with real profiler measurements, so the models here are swappable for real
hardware clocks (see ``runtime/monitor.py``).

Speed models compose: base throughput x slow drift x lognormal jitter x
transient straggler events.  All randomness is seeded and reproducible.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

__all__ = [
    "GPU_RELATIVE_THROUGHPUT",
    "normalize_gpu",
    "StragglerEvent",
    "WorkerSpeed",
    "ClusterSpec",
]

# Relative microbatch throughput of the GPUs the paper uses (ResNet-class
# training, fp32).  Normalized to GTX 1080 Ti == 1.  These are coarse public
# numbers — the whole point of the paper is that the controller does NOT need
# them to be accurate; they only seed the simulation.
GPU_RELATIVE_THROUGHPUT: Mapping[str, float] = {
    "gtx1080ti": 1.00,
    "rtx1080ti": 1.00,  # paper uses both namings for the same card
    "rtx2080ti": 1.45,
    "v100": 2.10,
    "a100": 4.4,
    # TPU-fleet entries for multi-pod heterogeneity scenarios (per-chip,
    # bf16 dense-matmul relative to 1080ti fp32 — coarse).
    "tpu_v4": 6.0,
    "tpu_v5e": 4.3,
    "tpu_v5p": 10.0,
}


def normalize_gpu(name: str) -> str:
    """Canonical GPU key for the throughput table; raises on typos.  The one
    normalization rule shared by cluster construction, the elastic event
    grammar, and the driver's fleet flags."""
    key = name.strip().lower().replace(" ", "")
    if key not in GPU_RELATIVE_THROUGHPUT:
        raise ValueError(f"unknown GPU {name!r}; known: {sorted(GPU_RELATIVE_THROUGHPUT)}")
    return key


@dataclasses.dataclass(frozen=True)
class StragglerEvent:
    """Transient slowdown: worker runs at ``factor`` x speed in [start, stop) epochs."""

    start_epoch: int
    stop_epoch: int
    factor: float  # 0 < factor <= 1, e.g. 0.2 == 5x slower

    def active(self, epoch: int) -> bool:
        return self.start_epoch <= epoch < self.stop_epoch


@dataclasses.dataclass
class WorkerSpeed:
    """Speed model for one worker.

    throughput      microbatches/second at epoch 0 (deterministic part)
    drift_per_epoch multiplicative drift, e.g. -0.01 == 1 % slower each epoch
                    (models thermal throttling / co-tenant buildup)
    jitter          sigma of lognormal noise applied per measurement
    events          transient straggler events
    """

    name: str
    throughput: float
    drift_per_epoch: float = 0.0
    jitter: float = 0.0
    events: Sequence[StragglerEvent] = ()

    def mean_speed(self, epoch: int) -> float:
        """Deterministic speed (microbatches/s) at ``epoch`` — no jitter."""
        s = self.throughput * (1.0 + self.drift_per_epoch) ** epoch
        for ev in self.events:
            if ev.active(epoch):
                s *= ev.factor
        return max(s, 1e-12)

    def compute_time(self, n_micro: int, epoch: int, rng: np.random.Generator | None = None) -> float:
        """Wall-clock seconds to compute ``n_micro`` microbatches in ``epoch``."""
        s = self.mean_speed(epoch)
        if rng is not None and self.jitter > 0.0:
            s *= float(rng.lognormal(mean=0.0, sigma=self.jitter))
        return n_micro / s


@dataclasses.dataclass
class ClusterSpec:
    """A named set of workers (the paper's 'group 1/2/3' machines)."""

    workers: list[WorkerSpeed]
    seed: int = 0

    def __post_init__(self) -> None:
        if not self.workers:
            raise ValueError("cluster needs at least one worker")
        self._rng = np.random.default_rng(self.seed)

    @property
    def n(self) -> int:
        return len(self.workers)

    @property
    def names(self) -> list[str]:
        return [w.name for w in self.workers]

    def mean_speeds(self, epoch: int = 0) -> np.ndarray:
        return np.array([w.mean_speed(epoch) for w in self.workers])

    def compute_times(self, alloc: Sequence[int], epoch: int, jitter: bool = True) -> np.ndarray:
        """Per-worker t_s for allocation ``alloc`` at ``epoch`` (vector)."""
        rng = self._rng if jitter else None
        return np.array(
            [w.compute_time(int(k), epoch, rng) for w, k in zip(self.workers, alloc, strict=True)]
        )

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_gpus(
        cls,
        gpus: Sequence[str],
        jitter: float = 0.02,
        seed: int = 0,
        base_throughput: float = 10.0,
    ) -> "ClusterSpec":
        """Build a cluster from GPU names, e.g. ``["v100", "rtx2080ti"]``.

        ``base_throughput`` is microbatches/s for a 1080ti-class card; only
        ratios matter for the allocation algorithm.
        """
        workers = []
        for i, g in enumerate(gpus):
            key = normalize_gpu(g)
            workers.append(
                WorkerSpeed(
                    name=f"{key}:{i}",
                    throughput=base_throughput * GPU_RELATIVE_THROUGHPUT[key],
                    jitter=jitter,
                )
            )
        return cls(workers=workers, seed=seed)

    # -- elastic operations (paper fig. 11) --------------------------------

    def with_added(self, worker: WorkerSpeed) -> "ClusterSpec":
        return ClusterSpec(workers=[*self.workers, worker], seed=self.seed)

    def with_replaced(self, index: int, worker: WorkerSpeed) -> "ClusterSpec":
        ws = list(self.workers)
        ws[index] = worker
        return ClusterSpec(workers=ws, seed=self.seed)

    def with_removed(self, index: int) -> "ClusterSpec":
        ws = list(self.workers)
        del ws[index]
        return ClusterSpec(workers=ws, seed=self.seed)
