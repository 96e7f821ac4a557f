"""The heterogeneous train step for one process holding every rank (``repro.dist``'s step)."""

from repro_torch.dist.hetero_step import HeteroStepConfig, build_train_step, init_train_state

__all__ = ["HeteroStepConfig", "build_train_step", "init_train_state"]
