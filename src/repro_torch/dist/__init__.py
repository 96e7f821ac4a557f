"""``repro_torch.dist`` — the heterogeneous-allocation distribution layer (``repro.dist``'s port).

* :mod:`repro_torch.dist.hetero_step` — the per-rank variable-microbatch
  train step, on one process or one process per rank of a mesh.
* :mod:`repro_torch.dist.collectives` — the ring collectives over
  ``torch.distributed`` process groups, gathered FSDP, error-feedback
  compression.
* :mod:`repro_torch.dist.sharding` — divisibility-gated spec assignment.
"""

from repro_torch.dist.collectives import (
    all_gather_params,
    compress_error_feedback,
    decompress_update,
    init_error_state,
    reduce_scatter_tree,
    ring_all_gather,
    ring_allreduce,
    ring_allreduce_tree,
    ring_reduce_scatter,
)
from repro_torch.dist.hetero_step import HeteroStepConfig, build_train_step, init_train_state
from repro_torch.dist.sharding import cache_specs, param_specs, state_specs

__all__ = [
    "HeteroStepConfig",
    "build_train_step",
    "init_train_state",
    "ring_allreduce",
    "ring_allreduce_tree",
    "ring_all_gather",
    "ring_reduce_scatter",
    "all_gather_params",
    "reduce_scatter_tree",
    "init_error_state",
    "compress_error_feedback",
    "decompress_update",
    "param_specs",
    "state_specs",
    "cache_specs",
]
