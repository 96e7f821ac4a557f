"""AdamW over lists of tensors, updated in place (``repro.optim.adamw``).

Reduced-precision moments (``moment_dtype="bfloat16"``) as in the reference.
Weight decay applies to leaves of rank >= 2 *in the reference's tree*: pass
``ndims``, the rank each parameter has there.  The reference stacks the
repeating body's layers on a leading axis, so a body layer's norm gain has
rank 2 there and is decayed, while ``final_norm`` (rank 1) is not; the port
keeps one tensor per layer, where both gains have rank 1
(``models.convert.reference_ndims`` gives the reference's ranks).
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "float32"


def adamw_init(params: list[torch.Tensor], cfg: AdamWConfig = AdamWConfig()) -> dict:
    """{"mu", "nu": zeros like each parameter in ``moment_dtype``, "count": int32 0 on the parameters' device}."""
    dt = getattr(torch, cfg.moment_dtype)
    device = params[0].device if params else None
    return {
        "mu": [torch.zeros(p.shape, dtype=dt, device=p.device) for p in params],
        "nu": [torch.zeros(p.shape, dtype=dt, device=p.device) for p in params],
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


@torch.no_grad()
def adamw_update(
    grads: list[torch.Tensor],
    state: dict,
    params: list[torch.Tensor],
    lr: torch.Tensor | float,
    cfg: AdamWConfig = AdamWConfig(),
    ndims: list[int] | None = None,
) -> tuple[list[torch.Tensor], dict]:
    """One AdamW step, all math in float32; ``params``, ``mu`` and ``nu`` are
    updated in place and returned with the new count.  ``ndims``: each
    parameter's rank in the reference's tree (default: the tensor's own)."""
    count = state["count"] + 1
    cf = count.float()
    c1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=cf.device), cf)
    c2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=cf.device), cf)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=cf.device)
    ndims = ndims if ndims is not None else [p.ndim for p in params]
    for g, mu, nu, p, nd in zip(grads, state["mu"], state["nu"], params, ndims, strict=True):
        g32 = g.float()
        mu32 = cfg.b1 * mu.float() + (1 - cfg.b1) * g32
        nu32 = cfg.b2 * nu.float() + (1 - cfg.b2) * (g32 * g32)
        step = (mu32 / c1) / (torch.sqrt(nu32 / c2) + cfg.eps)
        if cfg.weight_decay > 0.0 and nd >= 2:
            step = step + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step)
        mu.copy_(mu32)
        nu.copy_(nu32)
    return params, {"mu": state["mu"], "nu": state["nu"], "count": count}
