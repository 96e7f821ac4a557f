"""Quickstart: train a reduced smollm on synthetic data with the public API.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Walks the three core objects: a ModelConfig (from the arch registry), the
allocation-aware train step, and the adaptive controller — on one device
(no mesh: one process holds all four logical workers' rows).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.core import AdaptiveAllocationController, ControllerConfig
from repro_torch.core.hetero import ClusterSpec
from repro_torch.data import HeteroBatcher, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.dist import HeteroStepConfig, build_train_step, init_train_state
from repro_torch.examples._args import parse_device
from repro_torch.runtime import SimulatedTimingSource


def main(argv=None) -> dict:
    device = resolve_device(parse_device(argv, __doc__))
    # 1. pick an architecture (any of the 10 assigned ids works)
    cfg = smoke_config("smollm-360m", seq=64)

    # 2. build the allocation-aware train step: 4 logical workers, C=8
    #    microbatches per aggregation, buffer headroom W_max=4
    n_workers, C, micro_bs = 4, 8, 2
    scfg = HeteroStepConfig(w_max=4, micro_bs=micro_bs, seq_len=64, mode="masked")
    step = build_train_step(cfg, scfg)
    state = init_train_state(cfg, scfg, seed=0, device=device)

    # 3. heterogeneous "cluster" (simulated speeds) + the paper's controller
    cluster = ClusterSpec.from_gpus(["v100", "rtx2080ti", "rtx2080ti", "gtx1080ti"])
    timing = SimulatedTimingSource(cluster)
    ctl = AdaptiveAllocationController(ControllerConfig(total=C, n_workers=n_workers))

    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=64, n_sequences=512)
    batcher = HeteroBatcher(data, n_workers, micro_bs, w_max=4)

    alloc = ctl.allocation
    trajectory = [alloc.tolist()]
    losses = []
    print(f"initial allocation: {alloc.tolist()}  (equal, classic Ring-AllReduce)")
    for epoch in range(4):
        for batch in batcher.epoch(epoch, alloc):
            batch = {k: (v if k == "alloc" else torch.from_numpy(v).to(device)) for k, v in batch.items()}
            state, metrics = step(state, batch)
        t_s = timing.epoch_times(alloc, epoch)
        alloc = ctl.observe(t_s)
        trajectory.append(alloc.tolist())
        losses.append(float(metrics["loss"]))
        print(
            f"epoch {epoch}: loss {losses[-1]:.4f}  measured t_s {np.round(t_s, 3)}"
            f"  -> next allocation {alloc.tolist()}"
        )
    print(f"controller frozen: {ctl.frozen} (ratio stabilized, reverts to static allocation)")
    return {"allocations": trajectory, "losses": losses, "frozen": bool(ctl.frozen)}


if __name__ == "__main__":
    main()
