"""Momentum SGD over lists of tensors, updated in place (``repro.optim.sgd``):
the paper's optimizer (lr=1e-2, weight_decay=1e-4).  Weight decay follows
the reference's rank rule, as in ``adamw``."""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["SGDConfig", "sgd_init", "sgd_update"]


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    momentum: float = 0.9
    weight_decay: float = 1e-4
    nesterov: bool = False


def sgd_init(params: list[torch.Tensor]) -> dict:
    return {"velocity": [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]}


@torch.no_grad()
def sgd_update(
    grads: list[torch.Tensor],
    state: dict,
    params: list[torch.Tensor],
    lr: torch.Tensor | float,
    cfg: SGDConfig = SGDConfig(),
    ndims: list[int] | None = None,
) -> tuple[list[torch.Tensor], dict]:
    """One step in float32; ``params`` and the velocities are updated in place."""
    ndims = ndims if ndims is not None else [p.ndim for p in params]
    for g, v, p, nd in zip(grads, state["velocity"], params, ndims, strict=True):
        g32 = g.float()
        if cfg.weight_decay > 0.0 and nd >= 2:
            g32 = g32 + cfg.weight_decay * p.float()
        v.copy_(cfg.momentum * v + g32)
        step = g32 + cfg.momentum * v if cfg.nesterov else v
        p.copy_(p.float() - lr * step)
    return params, state
