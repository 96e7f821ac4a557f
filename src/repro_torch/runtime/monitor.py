"""Per-worker timing collection + straggler detection.

The adaptive controller needs one number per worker per epoch: gradient
compute time ``t_s`` (paper Alg. 1 step 1).  This module defines the
collection interface and two providers:

* :class:`SimulatedTimingSource` — wraps a :class:`ClusterSpec` speed model
  (CPU validation; deterministic).
* :class:`MeasuredTimingSource` — wall-clock measurement hooks for real
  deployments: per-rank device-time deltas (``block_until_ready`` fences
  around the compute segment).  On a multi-controller TPU deployment each
  host times its own ranks and the vectors are all-gathered host-side —
  exactly the paper's "broadcast your own t_s" step.

``StragglerMonitor`` adds the beyond-paper watchdog statistics: per-worker
z-scores of recent compute times, persistent-straggler flags, and the
imbalance signal the controller's reopen logic consumes.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.core.hetero import ClusterSpec

__all__ = ["TimingSource", "SimulatedTimingSource", "MeasuredTimingSource", "StragglerMonitor"]


@runtime_checkable
class TimingSource(Protocol):
    """What the elastic driver feeds the controller: one t_s vector per epoch.

    ``record_step`` is called once per global step with the step's wall time
    and allocation; ``epoch_times`` drains the accumulated epoch measurement.
    ``ready`` says whether every rank has reported compute time; ``reset``
    discards a partial accumulation (e.g. an epoch the driver decides not to
    measure) so it cannot leak into the next epoch's reading.  Whether the
    accumulation COVERS the whole epoch is the driver's call — a source only
    sees the steps it was fed.
    """

    def record_step(self, wall_s: float, alloc: Sequence[int]) -> None: ...

    def epoch_times(self, alloc: Sequence[int], epoch: int) -> np.ndarray: ...

    def reset(self) -> None: ...

    @property
    def ready(self) -> bool: ...


class SimulatedTimingSource:
    """t_s from a ClusterSpec speed model (validation mode).

    Times are derived from the speed model, not measured, so ``record_step``
    is a no-op and the source is always ``ready``.
    """

    def __init__(self, cluster: ClusterSpec, jitter: bool = True) -> None:
        self.cluster = cluster
        self.jitter = jitter

    def record_step(self, wall_s: float, alloc: Sequence[int]) -> None:
        del wall_s, alloc  # model-derived: nothing to accumulate

    def epoch_times(self, alloc: Sequence[int], epoch: int) -> np.ndarray:
        return self.cluster.compute_times(np.asarray(alloc), epoch, jitter=self.jitter)

    def reset(self) -> None:
        pass  # nothing accumulated

    @property
    def ready(self) -> bool:
        return True


class MeasuredTimingSource:
    """Wall-clock timing: call ``start(rank)``/``stop(rank)`` around compute.

    Start timestamps are kept PER RANK, so timing windows of different ranks
    may overlap freely (the normal case when one host times several local
    ranks whose compute segments interleave); ``stop(rank)`` always closes
    the window ``start(rank)`` opened.  ``start()`` without a rank opens one
    anonymous window, consumed by the next ``stop`` of a rank that has no
    open window of its own (the legacy single-rank-at-a-time pattern).
    """

    def __init__(self, n_ranks: int, clock: Callable[[], float] = time.perf_counter) -> None:
        self.n_ranks = n_ranks
        self._clock = clock
        self._starts: dict[int | None, float] = {}
        self._acc = np.zeros(n_ranks)

    def start(self, rank: int | None = None) -> None:
        self._starts[rank] = self._clock()

    def stop(self, rank: int) -> None:
        t0 = self._starts.pop(rank, None)
        if t0 is None:
            t0 = self._starts.pop(None, None)
        if t0 is None:
            raise RuntimeError("stop() before start()")
        self._acc[rank] += self._clock() - t0

    def record_step(self, wall_s: float, alloc: Sequence[int]) -> None:
        """Credit one SPMD step's wall time to the ranks, weighted by the
        microbatches each computed.

        This is the single-process attribution: one host runs every rank in
        one fused step, so per-rank device clocks are unavailable and the
        best unbiased split of the measured wall time is proportional to
        work done (equal per-microbatch speed — exactly true on one device).
        On a real mixed fleet each host fences its own ranks with
        ``start(rank)``/``stop(rank)`` instead and this method goes unused.
        """
        a = np.asarray(alloc, dtype=np.float64)
        if a.shape != (self.n_ranks,):
            raise ValueError(f"alloc must have length {self.n_ranks}")
        total = a.sum()
        if wall_s <= 0 or total <= 0:
            return
        self._acc += wall_s * a / total

    def reset(self) -> None:
        """Discard the current accumulation (and any open windows)."""
        self._acc[:] = 0.0
        self._starts.clear()

    @property
    def ready(self) -> bool:
        """True once every rank has accumulated compute time this epoch."""
        return bool(np.all(self._acc > 0))

    def epoch_times(self, alloc: Sequence[int] | None = None, epoch: int | None = None) -> np.ndarray:
        out = self._acc.copy()
        self._acc[:] = 0.0
        if np.any(out <= 0):
            raise RuntimeError("epoch_times read before all ranks reported")
        return out


@dataclasses.dataclass
class StragglerFlag:
    worker: int
    z_score: float
    persistent: bool
    observed: float = 0.0  # this observation's per-microbatch seconds
    baseline: float = 0.0  # the worker's own rolling-baseline mean


class StragglerMonitor:
    """Rolling PER-WORKER compute-time statistics.

    Each worker is z-scored against its OWN rolling baseline (mean/std of
    its recent non-flagged observations), never against the fleet: a
    stable-but-heterogeneous cluster — a 3x slower GTX in a V100 fleet that
    is ALWAYS 3x slower — is exactly what the allocation controller handles
    and must produce no flags.  A flag means a worker got slower than *its
    own* history.  Flagged observations are not absorbed into the baseline,
    so a worker that degrades for good keeps flagging (``persistent=True``)
    instead of normalizing its own slowdown away.
    """

    def __init__(self, n_workers: int, window: int = 8, z_threshold: float = 2.5) -> None:
        self.n_workers = n_workers
        self.window = window
        self.z_threshold = z_threshold
        self._hist: deque[np.ndarray] = deque(maxlen=window)  # raw observations
        self._base: list[deque[float]] = [deque(maxlen=window) for _ in range(n_workers)]
        self.flag_log: list[dict] = []  # every flag ever raised, with the epoch tag

    def observe(
        self, per_sample_time: Sequence[float], epoch: int | None = None, step: int | None = None
    ) -> list[StragglerFlag]:
        """Feed normalized (per-microbatch) compute times; returns flags.

        ``epoch``/``step`` (optional) tag the entries appended to
        :attr:`flag_log`, the monitor's full flag history — the
        fault-injection campaigns score straggler onset/recovery from it,
        where the return value only carries the CURRENT observation's flags.
        Each flag carries the observed and baseline times that produced its
        z-score, so consumers can attribute it without re-deriving the
        rolling statistics.
        """
        t = np.asarray(per_sample_time, dtype=np.float64)
        self._hist.append(t)
        if len(self._hist) < 4:  # warmup: seed each worker's baseline
            for i in range(self.n_workers):
                self._base[i].append(float(t[i]))
            return []
        flags = []
        for i in range(self.n_workers):
            base = np.asarray(self._base[i])
            mean = base.mean()
            # std floor: a short or jitter-free baseline must not turn normal
            # measurement noise into huge z-scores — 2% of the worker's own
            # mean (so the default z_threshold=2.5 needs a >5% deviation)
            std = max(base.std(), 2e-2 * abs(mean), 1e-12)
            z = (t[i] - mean) / std
            if z > self.z_threshold:
                recent = np.array([h[i] for h in list(self._hist)[-3:]])
                persistent = bool(np.all((recent - mean) / std > self.z_threshold))
                flags.append(
                    StragglerFlag(
                        worker=i,
                        z_score=float(z),
                        persistent=persistent,
                        observed=float(t[i]),
                        baseline=float(mean),
                    )
                )
            else:
                self._base[i].append(float(t[i]))
        for f in flags:
            self.flag_log.append(
                {
                    "epoch": epoch,
                    "step": step,
                    "worker": f.worker,
                    "z": round(f.z_score, 2),
                    "persistent": f.persistent,
                    "observed": round(f.observed, 6),
                    "baseline": round(f.baseline, 6),
                }
            )
        return flags

    def imbalance(self) -> float:
        if not self._hist:
            return 0.0
        t = self._hist[-1]
        return float((t.max() - t.min()) / max(t.max(), 1e-12))

    def fingerprint(self) -> tuple:
        """Canonical hashable state for the protocol model checker
        (the JAX package's ``repro.analysis.protocol``): shape parameters plus the rolling
        observation/baseline windows.  The elastic harness uses it to prove
        the monitor is rebuilt for the post-rescale membership (a stale
        monitor z-scores the wrong workers)."""
        return (
            self.n_workers,
            self.window,
            self.z_threshold,
            tuple(tuple(round(float(x), 9) for x in h) for h in self._hist),
            tuple(tuple(round(float(x), 9) for x in b) for b in self._base),
        )
