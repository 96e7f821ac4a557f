"""Discrete-event cluster simulator for the paper's baselines.

Reproduces the timing comparisons of figs. 7–13 without real heterogeneous
hardware.  Four systems share the same :class:`~repro_torch.core.hetero.ClusterSpec`
speed traces:

* ``simulate_sync``   — synchronous (Ring-)AllReduce data parallelism with an
  allocation policy: ``equal`` (classic), ``static`` (paper §III.A, fixed
  ratios), ``adaptive`` (paper §III.B, Algorithm 1 via the controller).
* ``simulate_ps``     — centralized parameter server: all workers compute an
  equal share, then push/pull the full model through the server NIC (the
  communication bottleneck the paper cites from Li et al.).
* ``simulate_adpsgd`` — AD-PSGD-style asynchronous pairwise gossip, event
  driven: a worker computes at its own speed, then blocks until a randomly
  chosen partner is free for the pairwise average (reproduces the paper's
  observation that with 2 workers AD-PSGD degenerates to AllReduce speed).

The "model" being trained is abstracted to a gradient byte count; collective
times follow the standard ring cost 2 (n-1)/n * bytes / bw.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Sequence

import numpy as np

from repro_torch.core import allocation as alloc_lib
from repro_torch.core.controller import AdaptiveAllocationController, ControllerConfig
from repro_torch.core.hetero import ClusterSpec
from repro_torch.core.timing import EpochTiming, TimingLog

__all__ = [
    "CommModel",
    "simulate_sync",
    "simulate_ps",
    "simulate_adpsgd",
    "speedup",
]


@dataclasses.dataclass(frozen=True)
class CommModel:
    """Byte-counting communication model (paper uses 1 GbE; we default to it)."""

    grad_bytes: float = 100e6  # ~25M fp32 params (ResNet50-class)
    bandwidth: float = 125e6  # bytes/s (1 Gbit Ethernet)
    latency: float = 1e-3  # per collective step

    def ring_allreduce(self, n: int) -> float:
        """Ring allreduce: 2(n-1) steps, each moving bytes/n."""
        if n == 1:
            return 0.0
        return 2 * (n - 1) * (self.grad_bytes / n / self.bandwidth + self.latency)

    def ps_roundtrip(self, n: int) -> float:
        """PS: n pushes + n pulls serialized through the server NIC."""
        return 2 * n * (self.grad_bytes / self.bandwidth + self.latency)

    def pairwise(self) -> float:
        """One AD-PSGD pairwise model average (full model both ways)."""
        return 2 * (self.grad_bytes / self.bandwidth + self.latency)


# ---------------------------------------------------------------------------
# Synchronous AllReduce family (equal / static / adaptive allocation)
# ---------------------------------------------------------------------------


def simulate_sync(
    cluster: ClusterSpec,
    epochs: int,
    total_micro: int,
    comm: CommModel | None = None,
    policy: str = "equal",
    static_ratios: Sequence[float] | None = None,
    controller: AdaptiveAllocationController | None = None,
    aggregations_per_epoch: int = 1,
    jitter: bool = True,
) -> TimingLog:
    """Run ``epochs`` of synchronous training; returns the per-epoch timing log.

    ``total_micro`` is the paper's C (microbatches per aggregation, constant).
    ``aggregations_per_epoch`` scales one aggregation's makespan to a full
    epoch (dataset_size / (C * minibatch)).
    """
    comm = comm or CommModel()
    n = cluster.n
    t_c = comm.ring_allreduce(n)

    if policy == "equal":
        w = alloc_lib.equal_allocation(n, total_micro)
        get_alloc = lambda: w  # noqa: E731
        observe = lambda t_s: None  # noqa: E731
    elif policy == "static":
        if static_ratios is None:
            raise ValueError("static policy needs static_ratios")
        w = alloc_lib.static_allocation(static_ratios, total_micro)
        get_alloc = lambda: w  # noqa: E731
        observe = lambda t_s: None  # noqa: E731
    elif policy == "adaptive":
        ctl = controller or AdaptiveAllocationController(
            ControllerConfig(total=total_micro, n_workers=n)
        )
        get_alloc = lambda: ctl.allocation  # noqa: E731
        observe = lambda t_s: ctl.observe(t_s, t_c=t_c)  # noqa: E731
    else:
        raise ValueError(f"unknown policy {policy!r}")

    log = TimingLog()
    for epoch in range(epochs):
        alloc = get_alloc()
        t_s = cluster.compute_times(alloc, epoch, jitter=jitter) * aggregations_per_epoch
        log.append(
            EpochTiming(
                epoch=epoch,
                alloc=np.asarray(alloc),
                t_s=t_s,
                t_c=t_c * aggregations_per_epoch,
            )
        )
        observe(t_s)
    return log


# ---------------------------------------------------------------------------
# Parameter server baseline
# ---------------------------------------------------------------------------


def simulate_ps(
    cluster: ClusterSpec,
    epochs: int,
    total_micro: int,
    comm: CommModel | None = None,
    aggregations_per_epoch: int = 1,
    jitter: bool = True,
) -> TimingLog:
    """Synchronous PS: equal split + serialized server communication."""
    comm = comm or CommModel()
    n = cluster.n
    w = alloc_lib.equal_allocation(n, total_micro)
    t_c = comm.ps_roundtrip(n)
    log = TimingLog()
    for epoch in range(epochs):
        t_s = cluster.compute_times(w, epoch, jitter=jitter) * aggregations_per_epoch
        log.append(EpochTiming(epoch=epoch, alloc=w.copy(), t_s=t_s, t_c=t_c * aggregations_per_epoch))
    return log


# ---------------------------------------------------------------------------
# AD-PSGD baseline (event-driven)
# ---------------------------------------------------------------------------


def simulate_adpsgd(
    cluster: ClusterSpec,
    target_samples: int,
    micro_per_iter: int = 1,
    comm: CommModel | None = None,
    seed: int = 0,
    max_events: int = 2_000_000,
) -> dict:
    """Event-driven AD-PSGD: returns wall-clock to process ``target_samples``.

    Each worker loops: compute ``micro_per_iter`` microbatches at its own
    speed, then pairwise-average with a uniformly random other worker.  The
    average requires both endpoints: the initiator blocks until the partner
    finishes its current compute (this coupling is why 2-worker AD-PSGD is no
    faster than AllReduce — the paper's fig. 12 observation).
    """
    comm = comm or CommModel()
    rng = np.random.default_rng(seed)
    n = cluster.n
    t_pair = comm.pairwise()

    busy_until = np.zeros(n)  # wall-clock when worker becomes free
    samples = 0
    clock = 0.0
    # Event queue: (time_ready_for_gossip, worker)
    pq: list[tuple[float, int]] = []
    for i in range(n):
        dt = cluster.workers[i].compute_time(micro_per_iter, 0)
        heapq.heappush(pq, (dt, i))
        busy_until[i] = dt

    events = 0
    while samples < target_samples and events < max_events:
        events += 1
        t_ready, i = heapq.heappop(pq)
        clock = max(clock, t_ready)
        samples += micro_per_iter
        if n > 1:
            j = int(rng.integers(0, n - 1))
            j = j if j < i else j + 1
            # pairwise average: both must be free
            start = max(t_ready, busy_until[j])
            done = start + t_pair
            busy_until[j] = done  # partner is held during the average
        else:
            done = t_ready
        # next compute for worker i
        epoch_idx = int(samples // max(target_samples // 10, 1))  # coarse drift index
        dt = cluster.workers[i].compute_time(micro_per_iter, epoch_idx)
        busy_until[i] = done + dt
        heapq.heappush(pq, (busy_until[i], i))

    return {
        "wall_clock_s": float(max(clock, busy_until.max()) if samples >= target_samples else np.inf),
        "samples": int(samples),
        "events": events,
    }


def speedup(baseline_total_s: float, system_total_s: float) -> float:
    """Paper fig. 13 metric: baseline time / system time."""
    if system_total_s <= 0:
        return float("inf")
    return baseline_total_s / system_total_s
