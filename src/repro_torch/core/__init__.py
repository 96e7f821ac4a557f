"""Core of the reproduction: the paper's task-allocation algorithms.

* :mod:`repro_torch.core.allocation` — static + self-adaptive allocation math
  (paper §III, eq. 8–10, Appendix A).
* :mod:`repro_torch.core.controller` — Algorithm 1 as a host-side state machine
  (timing in, allocation out) with freeze / drift-reopen / elastic resize.
* :mod:`repro_torch.core.hetero` — worker speed models (the simulated heterogeneous
  hardware used for CPU validation).
* :mod:`repro_torch.core.simulator` — discrete-event baselines (equal/static/
  adaptive AllReduce, parameter server, AD-PSGD) for the paper's figures.
* :mod:`repro_torch.core.timing` — shared epoch timing records.
"""

from repro_torch.core.allocation import (
    AllocationResult,
    adaptive_update,
    allocation_imbalance,
    appendix_solve,
    closed_form_target,
    equal_allocation,
    largest_remainder_round,
    makespan,
    speeds,
    static_allocation,
    waiting_times,
)
from repro_torch.core.controller import AdaptiveAllocationController, ControllerConfig
from repro_torch.core.hetero import GPU_RELATIVE_THROUGHPUT, ClusterSpec, StragglerEvent, WorkerSpeed
from repro_torch.core.simulator import CommModel, simulate_adpsgd, simulate_ps, simulate_sync, speedup
from repro_torch.core.timing import EpochTiming, TimingLog

__all__ = [
    "AllocationResult",
    "adaptive_update",
    "allocation_imbalance",
    "appendix_solve",
    "closed_form_target",
    "equal_allocation",
    "largest_remainder_round",
    "makespan",
    "speeds",
    "static_allocation",
    "waiting_times",
    "AdaptiveAllocationController",
    "ControllerConfig",
    "GPU_RELATIVE_THROUGHPUT",
    "ClusterSpec",
    "StragglerEvent",
    "WorkerSpeed",
    "CommModel",
    "simulate_adpsgd",
    "simulate_ps",
    "simulate_sync",
    "speedup",
    "EpochTiming",
    "TimingLog",
]
