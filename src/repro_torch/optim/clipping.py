"""Global-norm gradient clipping (float32 norm accumulation), ``repro.optim.clipping``."""

from __future__ import annotations

import torch

__all__ = ["global_norm", "clip_by_global_norm"]


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over tensors of each one's sum of squares, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tensors))


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Scale every gradient by ``min(1, max_norm / norm)``; returns (new gradients, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return [(g.float() * scale).to(g.dtype) for g in grads], norm
