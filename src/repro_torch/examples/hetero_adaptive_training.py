"""The paper's core experiment, end to end: heterogeneous cluster, equal vs
static vs self-adaptive allocation, training speed + convergence.

    PYTHONPATH=src python -m repro_torch.examples.hetero_adaptive_training

Reproduces the shape of figs. 7-10: equal allocation wastes fast-worker
cycles; the right static ratio helps; the adaptive controller finds that
ratio automatically in a few epochs and matches it without knowing the
hardware. Also demonstrates fig. 11 (add a worker at runtime).  Everything
here runs on the host (the simulator and the controller), so ``--device``
is accepted for symmetry with the other examples and changes nothing.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import (
    AdaptiveAllocationController,
    ClusterSpec,
    CommModel,
    ControllerConfig,
    WorkerSpeed,
    simulate_sync,
)
from repro_torch.examples._args import parse_device
from repro_torch.runtime import ElasticCoordinator


def main(argv=None) -> dict:
    parse_device(argv, __doc__)
    # a 4-worker cluster: V100 + 2x RTX2080ti + GTX1080ti (paper's hardware)
    cluster = ClusterSpec.from_gpus(["v100", "rtx2080ti", "rtx2080ti", "gtx1080ti"], jitter=0.02)
    comm = CommModel(grad_bytes=25e6)  # ResNet18-class grads over 1 GbE
    C, epochs = 40, 12

    print("=== equal vs static vs adaptive (epoch makespans, seconds) ===")
    runs = {
        "equal 10:10:10:10": simulate_sync(cluster, epochs, C, comm, policy="equal"),
        "static 14:9:9:8": simulate_sync(
            cluster, epochs, C, comm, policy="static", static_ratios=[14, 9, 9, 8]
        ),
        "adaptive": simulate_sync(cluster, epochs, C, comm, policy="adaptive"),
    }
    for name, log in runs.items():
        m = log.makespans
        print(f"{name:22s} first {m[0]:.3f}s  last {m[-1]:.3f}s  total {m.sum():.2f}s")

    adaptive = runs["adaptive"]
    print("\nadaptive allocation trajectory (w per worker):")
    for e, alloc in enumerate(adaptive.allocations):
        print(f"  epoch {e:2d}: {alloc.tolist()}  makespan {adaptive.makespans[e]:.3f}s")
    gain = 1 - adaptive.makespans[-1] / runs["equal 10:10:10:10"].makespans[-1]
    print(f"\nsteady-state epoch-time reduction vs equal: {gain:.1%} (paper: 20-40%)")

    # fig. 11: elastically add another 2080ti mid-training
    print("\n=== elastic: add a worker (paper fig. 11) ===")
    ctl = AdaptiveAllocationController(ControllerConfig(total=C, n_workers=4))
    log1 = simulate_sync(cluster, 6, C, comm, policy="adaptive", controller=ctl)
    coord = ElasticCoordinator(ctl)
    plan = coord.add(1, est_speed=float(np.mean(log1[-1].speeds)))
    bigger = cluster.with_added(WorkerSpeed(name="joiner-2080ti", throughput=14.5))
    log2 = simulate_sync(bigger, 6, C, comm, policy="adaptive", controller=ctl)
    print(f"before add: makespan {log1.makespans[-1]:.3f}s (4 workers)")
    print(f"after  add: makespan {log2.makespans[-1]:.3f}s (5 workers, warm-started {plan.allocation.tolist()})")
    return {
        "makespans": {name: log.makespans.tolist() for name, log in runs.items()},
        "adaptive_allocations": [a.tolist() for a in adaptive.allocations],
        "gain_vs_equal": float(gain),
        "elastic": {
            "before_add": float(log1.makespans[-1]),
            "after_add": float(log2.makespans[-1]),
            "warm_start": plan.allocation.tolist(),
        },
    }


if __name__ == "__main__":
    main()
