"""Optimizers, clipping and learning-rate schedules over lists of tensors.

The port of ``repro.optim``: the same configs and arithmetic (float32 math,
moments in ``moment_dtype``), written as plain functions over matching lists
of tensors.  Updates happen in place, parameters and moments alike, so a step
holds no second copy of the state; the functions return what they updated,
as the reference's return new trees.
"""

from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.clipping import clip_by_global_norm, global_norm
from repro_torch.optim.schedule import constant, warmup_cosine, warmup_linear
from repro_torch.optim.sgd import SGDConfig, sgd_init, sgd_update

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "global_norm",
    "constant",
    "warmup_cosine",
    "warmup_linear",
    "SGDConfig",
    "sgd_init",
    "sgd_update",
]
